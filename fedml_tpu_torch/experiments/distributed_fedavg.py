"""Real multi-process federated training over the TCP hub (port of
``fedml_tpu/experiments/distributed_fedavg.py``).

The reference's flagship mode launches N+1 OS processes under mpirun
(``fedml_experiments/distributed/fedavg/run_fedavg_distributed_pytorch.sh:19-37``:
``PROCESS_NUM = WORKER_NUM + 1``, rank 0 = server).  Here the same
shape runs over the zero-dependency TCP hub (``comm/tcp.py``): one hub
process routes frames, one server process coordinates, N client
processes train with the SAME local-update operator the simulation
uses — so the distributed result equals the in-process simulation's.

Roles (one process each; ``--device cpu`` runs it on the CPU, the
default is the CUDA card and a process without one raises):

    python -m fedml_tpu_torch.experiments.distributed_fedavg --role hub \
        --port 0 --device cpu
    python -m fedml_tpu_torch.experiments.distributed_fedavg --role server \
        --port P --num-clients 3 --rounds 2 --out final.npz --device cpu
    python -m fedml_tpu_torch.experiments.distributed_fedavg --role client \
        --port P --node-id 1 --device cpu

plus ``muxer`` (many virtual clients over one connection) and
``edge_hub`` (the tree topology's middle tier).  The frames are the JAX
package's byte for byte, so any role may face a JAX peer on one hub.
``FEDML_TPU_FORCE_CPU=1`` in a process's environment means ``--device
cpu``.  Every process builds the same synthetic dataset
deterministically from ``--seed`` (the reference likewise has every
rank load all partitions, ``main_fedavg.py:108-214``).  ``launch()``
spawns the whole federation as subprocesses.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from typing import Optional


MESH_REFUSAL = ("--mesh/--partition-rules (a muxer cohort on a device mesh) "
                "is not ported to fedml_tpu_torch yet (ROADMAP.md, queue A "
                "item 6: transformer and parallel)")


def _device(args) -> Optional[str]:
    """The device a role runs on: ``--device cpu`` (or
    ``FEDML_TPU_FORCE_CPU=1`` in the environment, the JAX launcher's
    contract) means the CPU; otherwise None, the card, which raises where
    there is none."""
    if args.device == "cpu" or os.environ.get("FEDML_TPU_FORCE_CPU") == "1":
        return "cpu"
    return args.device or None


def _build_problem(seed: int, num_clients: int, input_dim: int = 8,
                   train_samples: int = 60, device=None):
    """``input_dim`` scales the model (logistic_regression(input_dim, 2))
    so byte-accounting runs can measure compression on a payload large
    enough that the frame envelope is noise (the default 18-param model
    is all envelope); ``train_samples`` (per client) scales local
    compute, so latency runs can pick a comm-dominant regime.  The model's
    variables live on ``device``; its init is flax's bit for bit."""
    from fedml_tpu_torch.core.client import make_client_optimizer, make_local_update
    from fedml_tpu_torch.core.rng import PRNGKey
    from fedml_tpu_torch.data.synthetic import synthetic_classification
    from fedml_tpu_torch.models.linear import logistic_regression

    ds = synthetic_classification(
        num_train=train_samples * num_clients, num_test=30,
        input_shape=(input_dim,),
        num_classes=2, num_clients=num_clients, partition="homo", seed=seed,
    )
    bundle = logistic_regression(input_dim, 2, device=device)
    init = bundle.init(PRNGKey(seed))
    lu = make_local_update(bundle, make_client_optimizer("sgd", 0.1), 1)
    return ds, bundle, init, lu


def _dial_with_retry(factory, retries: int = 50):
    """The hub may still be binding when a worker starts: retry the
    backend constructor — ONE retry policy for every dialing role."""
    for attempt in range(retries):
        try:
            return factory()
        except (ConnectionError, OSError):
            if attempt == retries - 1:
                raise
            time.sleep(0.1)


def _lane_kwargs(args) -> dict:
    """Transport-lane knobs shared by every dialing role: ``--lane shm``
    creates a per-connection shared-memory slab (payload bytes ride its
    rings, headers stay on TCP; automatic per-frame TCP fallback)."""
    return {
        "lane": args.lane,
        "shm_data_bytes": args.shm_mib << 20,
        "shm_min_bytes": args.shm_min_bytes,
    }


def _connect_backend(node_id: int, host: str, port: int, retries: int = 50,
                     auto_reconnect: int = 0, wire: int = 2, **lane_kw):
    from fedml_tpu_torch.comm.tcp import TcpBackend

    return _dial_with_retry(
        lambda: TcpBackend(node_id, host, port,
                           auto_reconnect=auto_reconnect, wire=wire,
                           **lane_kw),
        retries)


def _connect_mux_backend(node_ids, host: str, port: int, retries: int = 50,
                         auto_reconnect: int = 0, wire: int = 2, **lane_kw):
    """Muxed twin of ``_connect_backend``: one hello-v2 dial registers
    the whole virtual-client range."""
    from fedml_tpu_torch.comm.mux import TcpMuxBackend

    return _dial_with_retry(
        lambda: TcpMuxBackend(node_ids, host, port,
                              auto_reconnect=auto_reconnect, wire=wire,
                              **lane_kw),
        retries)


def _chaos_plan():
    from fedml_tpu_torch.faults import FaultPlan

    return FaultPlan.from_env()


def _traffic_model(role: str):
    """Open-loop traffic model for this worker, or None: ``launch()``
    ships ``TrafficModel`` JSON through ``FEDML_TPU_TRAFFIC`` (same
    shape as the chaos plan's env ride), and the model's ``roles``
    field gates which worker kinds draw from it."""
    from fedml_tpu_torch.faults.traffic import TrafficModel

    tm = TrafficModel.from_env()
    if tm is None or role not in tm.roles or not tm.any_traffic():
        return None
    return tm


def _maybe_chaos(backend, role: str, plan=None):
    """Wrap the transport in a ``ChaosBackend`` when a fault plan rides
    the ``FEDML_TPU_CHAOS`` env var and names this role — how a chaos
    driver injects message faults into worker subprocesses without new
    plumbing on every entry point."""
    from fedml_tpu_torch.faults import ChaosBackend

    plan = plan if plan is not None else _chaos_plan()
    if plan is None or role not in plan.roles:
        return backend
    return ChaosBackend(backend, plan)


def _collect_json_lines(stream, info: dict) -> None:
    """Fold every parseable JSON line of a finished process's stdout
    into ``info`` (server fault counters, hub stats, per-client upload
    digests).  ``stream`` may also be already-read text (the muxer
    path drains via ``communicate`` — see ``launch``)."""
    if stream is None:
        return
    text = stream if isinstance(stream, str) else stream.read()
    for line in text.splitlines():
        try:
            info.update(json.loads(line))
        except json.JSONDecodeError:
            continue


def _resolve_crash_round(flag_value: int, plan, node_id: int):
    """Crash schedule precedence: an explicit ``--crash-at-round`` flag
    wins; otherwise the env-shipped plan's ``crash_at_round`` map is
    consulted for this node (the FaultPlan knob is live, not just
    serialized)."""
    if flag_value >= 0:
        return flag_value
    if plan is not None:
        return plan.crash_at_round.get(node_id)
    return None


def _node_metrics_logger(run_dir: str, tag):
    """Per-process metrics sink: each federation participant appends to
    its OWN ``metrics-<tag>.jsonl`` inside the shared run_dir, so
    concurrent processes never interleave into one file and a timeline
    tool can merge the set.  Returns None when no
    run_dir was requested (the legacy stdout-only mode)."""
    if not run_dir:
        return None
    from fedml_tpu_torch.core.metrics import MetricsLogger

    return MetricsLogger(run_dir=run_dir, filename=f"metrics-{tag}.jsonl")


def _install_flight(run_dir: str, tag) -> None:
    """Arm this process's flight recorder (``obs/flight.py``): dump
    destination ``flight-<tag>.json`` beside the metrics files, SIGUSR2
    snapshot handler, unhandled-exception hooks, and the faulthandler
    crash log.  Recording itself is always on; without a run_dir the
    triggers only mark history."""
    from fedml_tpu_torch.obs import flight

    flight.install(run_dir or None, str(tag))


def _start_event_flusher(mlog, interval: float = 1.0):
    """Periodically drain the telemetry event ring into this process's
    metrics file while the main thread is blocked in ``backend.run()``.
    The ring holds 4096 events and a traced run emits ~participants
    ``trace_hop`` events per round, so exit-time-only draining evicts
    the earliest chains (the one ``clock_sync`` event first) on long
    runs.  Returns a stop callable; call it BEFORE the final
    ``log_telemetry`` so only one thread ever writes at a time."""
    if mlog is None:
        return lambda: None
    import threading

    stop = threading.Event()

    def _loop():
        while not stop.wait(interval):
            mlog.flush_events()

    t = threading.Thread(target=_loop, daemon=True)
    t.start()

    def _stop():
        stop.set()
        t.join(timeout=5)

    return _stop


def _start_stats_reporter(args, backend, mgr, nodes):
    """Attach + start a DigestReporter when the stats plane is on: one
    delta-digest frame per report interval, through the SAME (possibly
    chaos-wrapped) backend the manager sends on — so a telemetry_loss
    fault plan drops digest frames exactly where it would on a
    dedicated process.  The manager stops it at FINISH with a final
    flush; the returned handle is the entry point's belt-and-braces
    stop for runs that end without one (killed hub, crash)."""
    if args.stats_plane != "on":
        return None
    from fedml_tpu_torch.obs.digest import DigestReporter

    reporter = DigestReporter(backend, interval=args.report_interval,
                              nodes=nodes)
    mgr.stats_reporter = reporter
    return reporter.start()


def run_hub(host: str, port: int, run_dir: str = "",
            stats_interval: float = 1.0, fanout: str = "striped",
            stripe_kib: int = 256, stripe_pace: int = 8,
            shm_min_bytes: int = 1024) -> None:
    from fedml_tpu_torch.comm.tcp import TcpHub

    # striped fan-out is the DEFAULT hub mode: multicast payloads split
    # into fixed-size crc'd stripes, every receiver's stripe 0
    # head-started before any tail, so the last of K receivers no
    # longer waits behind K-1 whole-frame sends to START receiving.
    # --fanout whole restores whole-frame sends — the measurement
    # baseline arm.
    hub = TcpHub(host, port,
                 stripe_bytes=(stripe_kib << 10) if fanout == "striped"
                 else 0,
                 max_inflight_stripes=stripe_pace,
                 shm_min_bytes=shm_min_bytes)
    # announce the bound port on stdout for the launcher
    print(json.dumps({"hub_port": hub.port}), flush=True)
    from fedml_tpu_torch.obs.telemetry import get_telemetry

    get_telemetry().gauge_set("hub.tier", 0)
    stop = {"flag": False}

    def _stop(*_):
        stop["flag"] = True

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    mlog = _node_metrics_logger(run_dir, "hub")
    _install_flight(run_dir, "hub")
    last_sample = time.monotonic()
    try:
        while not stop["flag"]:
            time.sleep(0.1)
            if mlog is not None and (
                time.monotonic() - last_sample >= stats_interval
            ):
                # periodic snapshot INTO THE FILE, not just the exit
                # print: a crashed/SIGKILLed hub still leaves its
                # queue-depth / backpressure time series behind
                last_sample = time.monotonic()
                hub.sample_telemetry()
                mlog.log_telemetry()
    finally:
        hub.stop()
        if mlog is not None:
            hub.sample_telemetry()
            mlog.log_telemetry()
            mlog.close()
        # hub-side fault accounting for the launcher (dropped frames by
        # message type — chaos runs reconcile these against injections)
        print(json.dumps({"hub_stats": hub.stats()}), flush=True)


def _defense_from_args(args):
    """Build the DefenseConfig (or None = the exact undefended path)
    from the CLI knobs — shared by the root server and the edge-hub
    tier, which must screen uploads with the IDENTICAL configuration
    for the tree-vs-flat byte-identity pin to hold."""
    if args.trim_frac != 0.2 and args.defense != "trimmed_mean":
        # DefenseConfig cannot tell an explicit 0.2 from the default,
        # so the only layer that knows the flag was TYPED is this one —
        # a trim fraction without its mode must not be silently inert
        raise SystemExit(
            "--trim-frac only applies with --defense trimmed_mean "
            f"(got --defense {args.defense})"
        )
    if (args.defense != "none" or args.dp_clip > 0 or args.dp_noise > 0
            or args.norm_bound > 0 or args.outlier_mult > 0
            or args.conn_cap > 0):
        # ANY defense knob constructs the config, so a knob that needs
        # a mode it wasn't given fails DefenseConfig validation loudly
        # instead of running a silently-undefended federation
        from fedml_tpu_torch.robust import DefenseConfig

        return DefenseConfig(
            defense=args.defense, norm_bound=args.norm_bound,
            outlier_mult=args.outlier_mult, conn_cap=args.conn_cap,
            dp_clip=args.dp_clip, dp_noise=args.dp_noise,
            trim_frac=args.trim_frac,
        )
    return None


def run_server(args) -> None:
    import numpy as np

    from fedml_tpu_torch.algorithms.fedavg_cross_device import FedAvgServerManager
    from fedml_tpu_torch.compress.codecs import jax_leaves
    from fedml_tpu_torch.core.tree import host_array

    # the server's model, decode and fold are host numpy: its problem is
    # built on the host (the init is the same bits on either device), and
    # it never holds the card
    ds, bundle, init, lu = _build_problem(args.seed, args.num_clients,
                                          args.input_dim, args.train_samples,
                                          "cpu")
    backend = _maybe_chaos(
        _connect_backend(0, args.host, args.port,
                         auto_reconnect=max(args.auto_reconnect, 0),
                         wire=args.wire, **_lane_kwargs(args)),
        "server",
    )
    # cohort-wide pack geometry (fedavg_cross_device.py:62-66): each
    # client's single-client pack must match its slice of the
    # simulation's cohort pack even with heterogeneous client sizes
    from fedml_tpu_torch.core.types import cohort_steps_per_epoch

    steps = cohort_steps_per_epoch(ds, args.batch_size)
    if not args.round_timeout:
        # clients dial with auto_reconnect (run_client below): frames
        # routed while a client is disconnected are LOST, so a SYNC that
        # lands in a reconnect window leaves the server waiting forever
        # for an upload the client never saw.  Reconnect tolerance
        # relies on the round deadline to move on without it — run
        # without one only if clients never drop.
        print("WARNING: no --round-timeout with auto-reconnecting "
              "clients: a SYNC lost during a client's reconnect window "
              "deadlocks the round; set --round-timeout to tolerate "
              "connection drops", file=sys.stderr, flush=True)
    # stats plane: declared SLO objectives (--slo: inline JSON or a
    # file path); an empty spec still produces the full health report
    slo_spec = None
    if args.slo:
        from fedml_tpu_torch.obs.slo import SloSpec

        slo_spec = SloSpec.from_arg(args.slo)
    # robust aggregation (robust/): --defense picks the mode,
    # the numeric knobs parametrize it; all-defaults = None = the exact
    # undefended code path
    defense = _defense_from_args(args)
    server = FedAvgServerManager(
        backend, init, num_clients=args.num_clients,
        clients_per_round=args.clients_per_round or args.num_clients,
        comm_rounds=args.rounds, seed=args.seed,
        steps_per_epoch=steps,
        round_timeout=args.round_timeout or None,
        spares=args.spares,
        codec=args.codec,
        multicast=args.hotpath == "fast",
        streaming_agg=args.hotpath == "fast",
        # decode/fold pipeline + double-buffered broadcast encode: fast
        # hotpath only (the legacy arm is the fully serial baseline)
        decode_workers=(args.decode_workers
                        if args.hotpath == "fast" else 0),
        # in-band stats plane (obs/digest + obs/slo): rollup of the
        # cohort's digest frames + per-round SLO evaluation; with a
        # run_dir the live status.json and final slo_report.json land
        # there (--stats-plane off = the A/B measurement baseline arm)
        stats_plane=args.stats_plane == "on",
        slo_spec=slo_spec,
        status_dir=args.run_dir or None,
        stats_interval=args.report_interval,
        defense=defense,
        # delta/dedup broadcast (--bcast delta): sync ships the int8
        # chain update against each node's last-acked round; --bcast-
        # codec "" resolves to qsgd8 in delta mode / none (legacy) in
        # full mode, and an explicit codec on a full run turns on the
        # same quantized chain for the delta-vs-full digest pin
        bcast=args.bcast,
        bcast_codec=args.bcast_codec,
        delta_base_window=args.delta_base_window,
        # async buffered rounds (--round-mode async): fold-on-arrival,
        # cut every --cut-size arrivals (or the round deadline), stale
        # uploads in the --max-staleness window folded at the
        # --stale-policy/--stale-alpha discount instead of rejected
        round_mode=args.round_mode,
        cut_size=args.cut_size,
        max_staleness=args.max_staleness,
        stale_policy=args.stale_policy,
        stale_alpha=args.stale_alpha,
    )
    # startup barrier: the hub drops frames to unregistered receivers,
    # so broadcasting before every client registered would hang
    # registration barrier budget scales with the federation size: on
    # a 1-core host N client processes SERIALIZE their imports, so a
    # fixed 60 s cap spuriously fails at large N
    backend.await_peers(range(1, args.num_clients + 1),
                        timeout=60 + 15 * args.num_clients)
    # the metrics sink opens BEFORE the round loop and a flusher thread
    # drains the bounded event ring on a timer: a long traced run would
    # otherwise evict clock_sync + early trace_hop chains before the
    # exit-time drain (deque maxlen=4096)
    mlog = _node_metrics_logger(args.run_dir, "node0")
    _install_flight(args.run_dir, "node0")
    stop_flusher = _start_event_flusher(mlog)
    server.start()
    backend.run()  # returns when finish() closes the socket
    if args.out:
        # the server's model is host numpy; leaves in JAX's leaf order
        leaves = [l for _, l in jax_leaves(server.variables)]
        np.savez(
            args.out,
            **{f"leaf_{i}": host_array(l) for i, l in enumerate(leaves)},
            rounds=server.round_idx,
            round_log=json.dumps(server.round_log),
        )
    # final drain: stop the flusher first so only one thread writes,
    # then the full registry (remaining events + counter/histogram
    # snapshot) lands in the server's own metrics file — the
    # per-process record fed_timeline merges
    stop_flusher()
    if mlog is not None:
        mlog.log_telemetry()
        mlog.close()
    # fault accounting alongside the round count: the process-local
    # telemetry registry dies with this process, so surface the chaos
    # counters on stdout where the launcher/chaos driver collects them
    from fedml_tpu_torch.obs.telemetry import get_telemetry

    snap = get_telemetry().snapshot()["counters"]
    print(json.dumps({
        "rounds": server.round_idx,
        "zero_participant_rounds": server.zero_participant_rounds,
        "rejected_uploads": server.rejected_uploads,
        "rounds_degraded": snap.get("rounds.degraded", 0),
        # stats-plane outcome: digest streams ingested (== CONNECTIONS
        # under muxing, not clients), frames/rejects, SLO verdict — the
        # health campaign asserts on this line
        "stats_plane": server.stats_summary(),
        "faults": {k: v for k, v in snap.items()
                   if k.startswith(("faults.", "robust.", "comm.unhandled",
                                    "comm.send_retries", "comm.send_failed",
                                    "comm.reconnects", "comm.shm_",
                                    "comm.delta_"))},
        # exact server-side wire accounting (TcpBackend counts header +
        # binary payload): the compression measurement reads C2S bytes
        # off this line across baseline/compressed federations
        "comm_bytes": {k: v for k, v in snap.items()
                       if k.startswith(("comm.recv_bytes",
                                        "comm.sent_bytes",
                                        "comm.recv_msgs",
                                        "comm.sent_msgs"))},
    }), flush=True)
    if server.zero_participant_rounds >= server.comm_rounds:
        # every round aggregated nobody (deadline shorter than client
        # train time): the "final" model is the init model — fail loudly
        # instead of handing back rc=0
        print("ERROR: all rounds closed with zero participants; the "
              "model was never updated (round_timeout too short?)",
              file=sys.stderr, flush=True)
        sys.exit(2)


def run_client(args) -> None:
    from fedml_tpu_torch.algorithms.fedavg_cross_device import FedAvgClientManager

    device = _device(args)
    ds, bundle, init, lu = _build_problem(args.seed, args.num_clients,
                                          args.input_dim, args.train_samples,
                                          device)
    # clients ride out transient hub-connection drops: re-dial +
    # re-register, rejoining as a straggler for the missed round (the
    # server's round deadline covers the gap)
    plan = _chaos_plan()
    # -1 = role default (3): `or 3` would silently promote an EXPLICIT
    # --auto-reconnect 0 (fail-fast) back to reconnecting
    reconnect = args.auto_reconnect if args.auto_reconnect >= 0 else 3
    backend = _maybe_chaos(
        _connect_backend(args.node_id, args.host, args.port,
                         auto_reconnect=reconnect, wire=args.wire,
                         **_lane_kwargs(args)),
        "client", plan,
    )
    mgr = FedAvgClientManager(
        backend, lu, ds, batch_size=args.batch_size,
        template_variables=init, seed=args.seed,
        train_delay=args.train_delay,
        crash_at_round=_resolve_crash_round(
            args.crash_at_round, plan, args.node_id
        ),
        traffic=_traffic_model("client"),
        device=device,
    )
    # the client's registry used to die here with nothing but a stdout
    # counter dump — now the whole thing (trace_hop chains, clock_sync,
    # comm counters, handle-latency histograms) lands in this process's
    # own metrics-node<id>.jsonl for the timeline merger; the flusher
    # thread keeps the bounded event ring from evicting early chains
    # on long runs
    mlog = _node_metrics_logger(args.run_dir, f"node{args.node_id}")
    _install_flight(args.run_dir, f"node{args.node_id}")
    stop_flusher = _start_event_flusher(mlog)
    reporter = _start_stats_reporter(args, backend, mgr,
                                     nodes=[args.node_id])
    backend.run()  # returns on FINISH
    if reporter is not None:
        reporter.stop(final_flush=False)  # idempotent; FINISH flushed
    stop_flusher()
    if mlog is not None:
        mlog.log_telemetry()
        mlog.close()
    # reproducibility probe: the accumulated sha256 of every encoded
    # upload — two runs at the same seed must print identical digests
    # (the launcher collects these when asked)
    print(json.dumps({
        f"client_{args.node_id}_upload_digest": mgr.upload_digest,
        f"client_{args.node_id}_rounds_trained": mgr.rounds_trained,
    }), flush=True)


def run_muxer(args) -> None:
    """ONE process driving ``--virtual-clients`` virtual clients over
    ONE hub connection (node ids ``--node-id .. --node-id + N - 1``):
    hello-v2 registration, local demux of per-connection broadcast
    copies, and one training pass over each round's co-located cohort —
    client count and process count decouple."""
    from fedml_tpu_torch.algorithms.fedavg_mux import FedAvgMuxClientManager

    device = _device(args)
    ds, bundle, init, lu = _build_problem(args.seed, args.num_clients,
                                          args.input_dim, args.train_samples,
                                          device)
    node_ids = list(range(args.node_id,
                          args.node_id + max(1, args.virtual_clients)))
    plan = _chaos_plan()
    reconnect = args.auto_reconnect if args.auto_reconnect >= 0 else 3
    mux = _connect_mux_backend(node_ids, args.host, args.port,
                               auto_reconnect=reconnect, wire=args.wire,
                               **_lane_kwargs(args))
    # chaos parity: the plan wraps each VIRTUAL node's backend, so
    # fault decisions are keyed by virtual node id — the exact per-node
    # streams the one-process-per-client topology would draw
    wrap = None
    if plan is not None and "client" in plan.roles:
        from fedml_tpu_torch.faults import ChaosBackend

        wrap = lambda vb: ChaosBackend(vb, plan)  # noqa: E731
    # crash schedule: the flag wins; otherwise ANY virtual id with a
    # plan-scheduled crash takes the whole muxer down at the EARLIEST
    # such round — a process crash is process-granular, so one virtual
    # client's schedule costs its co-located peers too (the honest
    # muxer blast radius; chaos_run's muxer_crash scenario)
    crash_rounds = [
        r for r in (_resolve_crash_round(args.crash_at_round, plan, n)
                    for n in node_ids)
        if r is not None
    ]
    mgr = FedAvgMuxClientManager(
        mux, lu, ds, batch_size=args.batch_size,
        template_variables=init, seed=args.seed,
        train_delay=args.train_delay,
        crash_at_round=min(crash_rounds) if crash_rounds else None,
        wrap_backend=wrap,
        rejoin_every_round=args.rejoin_every_round,
        traffic=_traffic_model("muxer"),
        device=device,
    )
    mlog = _node_metrics_logger(args.run_dir, f"mux{args.node_id}")
    _install_flight(args.run_dir, f"mux{args.node_id}")
    if mlog is not None:
        # timeline grouping evidence: fed_timeline parks every virtual
        # client's track under this muxer's process
        from fedml_tpu_torch.obs.telemetry import get_telemetry

        get_telemetry().event("mux_members", muxer=args.node_id,
                              nodes=node_ids)
    stop_flusher = _start_event_flusher(mlog)
    # the muxer's ONE reporter pre-merges the whole virtual cohort:
    # its digest covers every co-located node id, so the hub/server
    # ingests one stream per connection (not per client) — the O(conns)
    # stats-plane cost model.  It sends through the primary virtual
    # node's chaos-wrapped endpoint (fault-plan parity).
    reporter = _start_stats_reporter(args, mgr.reporter_backend(), mgr,
                                     nodes=node_ids)
    mgr.run()  # returns on FINISH
    if reporter is not None:
        reporter.stop(final_flush=False)  # idempotent; FINISH flushed
    stop_flusher()
    if mlog is not None:
        mlog.log_telemetry()
        mlog.close()
    # the same per-client reproducibility probes the single-process
    # role prints — one line per virtual client, so digest comparisons
    # are topology-blind
    digests = mgr.upload_digests
    for n in node_ids:
        print(json.dumps({
            f"client_{n}_upload_digest": digests[n],
            f"client_{n}_rounds_trained": mgr.rounds_trained[n],
        }), flush=True)


def run_edge_hub(args) -> None:
    """ONE edge tier of the hierarchical aggregation tree: a LOCAL hub
    terminating the downstream cohort (node ids ``--node-id ..
    --node-id + --virtual-clients - 1``), the streaming partial fold,
    and one uplink connection to the root — the root's connection and
    fold load both shrink from O(clients) to O(edges)."""
    from fedml_tpu_torch.algorithms.edge_hub import EdgeHubManager
    from fedml_tpu_torch.comm.edge import EdgeUplinkBackend
    from fedml_tpu_torch.comm.tcp import TcpHub
    from fedml_tpu_torch.obs.telemetry import get_telemetry

    # the edge's decode base and fold live on the host, as the server's do
    ds, bundle, init, lu = _build_problem(args.seed, args.num_clients,
                                          args.input_dim, args.train_samples,
                                          "cpu")
    node_ids = list(range(args.node_id,
                          args.node_id + max(1, args.virtual_clients)))
    # the local tier is a full hub: stripes/shm lanes are PER-TIER
    # decisions, so each broadcast crosses each leg's wire exactly once
    # with that leg's own fan-out machinery
    hub = TcpHub("127.0.0.1", 0,
                 stripe_bytes=(args.stripe_kib << 10)
                 if args.fanout == "striped" else 0,
                 max_inflight_stripes=args.stripe_pace,
                 shm_min_bytes=args.shm_min_bytes)
    # announce the local port for the launcher's downstream workers
    print(json.dumps({"edge_port": hub.port}), flush=True)
    get_telemetry().gauge_set("hub.tier", 1)
    local = _connect_backend(0, "127.0.0.1", hub.port, wire=args.wire,
                             **_lane_kwargs(args))
    # downstream barrier BEFORE dialing the root: the uplink hello
    # claims the whole cohort's ids, which satisfies the root server's
    # startup barrier — so the cohort must actually be registered down
    # here first, or INIT would re-fan into dropped frames
    local.await_peers(node_ids, timeout=60 + 15 * len(node_ids))
    reconnect = args.auto_reconnect if args.auto_reconnect >= 0 else 3
    uplink = _dial_with_retry(
        lambda: EdgeUplinkBackend(node_ids, args.host, args.port,
                                  auto_reconnect=reconnect, wire=args.wire,
                                  **_lane_kwargs(args)))
    mgr = EdgeHubManager(
        uplink, local, hub, init,
        round_timeout=args.round_timeout or None,
        decode_workers=(args.decode_workers
                        if args.hotpath == "fast" else 0),
        defense=_defense_from_args(args), seed=args.seed,
        delta_base_window=args.delta_base_window,
        crash_at_round=(args.crash_at_round
                        if args.crash_at_round >= 0 else None),
    )
    mlog = _node_metrics_logger(args.run_dir, f"edge{args.node_id}")
    _install_flight(args.run_dir, f"edge{args.node_id}")
    stop_flusher = _start_event_flusher(mlog)
    mgr.start()
    mgr.run()  # blocks until FINISH drains + tears the tier down
    stop_flusher()
    if mlog is not None:
        mlog.log_telemetry()
        mlog.close()
    # per-edge accounting for the launcher/campaign (folded vs
    # forwarded-raw is the tree's composition evidence; peak RSS and
    # the local hub's churn counters let fed_tree_run/fed_scale_run
    # attribute memory and rebinds to the correct tier)
    import resource

    stats = mgr.stats()
    stats["peak_rss_kb"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss
    try:
        stats["local_hub"] = hub.stats()
    except Exception:
        pass
    print(json.dumps({f"edge_{args.node_id}_stats": stats}),
          flush=True)


def launch(
    num_clients: int = 3,
    rounds: int = 2,
    *,
    seed: int = 0,
    batch_size: int = 16,
    out_path: str,
    extra_idle_clients: int = 0,
    kill_idle_after: float = 0.0,
    round_timeout: float = 0.0,
    slow_client_delay: float = 0.0,
    kill_slow_client_after: float = 0.0,
    crash_client_at_round: int = -1,
    restart_hub_after: float = 0.0,
    clients_per_round: int = 0,
    spares: int = 0,
    auto_reconnect: int = 0,
    muxers: int = 0,
    muxed_clients: int = 0,
    crash_muxer_at_round: int = -1,
    topology: str = "flat",
    edge_hubs: int = 0,
    crash_edge_hub_at_round: int = -1,
    chaos_plan: str = "",
    codec: str = "none",
    wire: int = 2,
    mesh: str = "",
    partition_rules: str = "",
    input_dim: int = 8,
    lane: str = "tcp",
    shm_mib: int = 64,
    shm_min_bytes: int = 1024,
    bcast: str = "full",
    bcast_codec: str = "",
    delta_base_window: int = 4,
    round_mode: str = "sync",
    cut_size: int = 0,
    max_staleness: int = 2,
    stale_policy: str = "poly",
    stale_alpha: float = 0.5,
    traffic_plan: str = "",
    mux_rejoin_every_round: bool = False,
    hotpath: str = "fast",
    fanout: str = "striped",
    stripe_kib: int = 256,
    stripe_pace: int = 8,
    decode_workers: int = 2,
    train_samples: int = 60,
    run_dir: str = "",
    trace: bool = False,
    stats_plane: str = "on",
    report_interval: float = 1.0,
    slo: str = "",
    defense: str = "none",
    norm_bound: float = 0.0,
    outlier_mult: float = 0.0,
    conn_cap: float = 0.0,
    dp_clip: float = 0.0,
    dp_noise: float = 0.0,
    trim_frac: float = 0.2,
    device: str = "",
    info=None,
    env=None,
    server_env=None,
    timeout: float = 180.0,
):
    """Spawn hub + server + clients as OS processes and wait for the
    federation to finish; returns the server's exit code (0 = the
    configured rounds completed and ``out_path`` was written).

    ``extra_idle_clients`` registers clients beyond ``num_clients`` that
    the server never samples — one is SIGKILLed once the launcher has
    CONFIRMED its hub registration (``await_peers``), exercising the
    hub's dead-peer handling mid-run without wedging the round.

    ``slow_client_delay`` makes the LAST sampled client (node id
    ``num_clients``) sleep that long before each local update;
    ``kill_slow_client_after`` SIGKILLs it mid-sleep — i.e. a SAMPLED
    client dies mid-round.  With ``round_timeout`` set the server's
    deadline aggregates without it and logs the dropout.

    Chaos knobs:

    - ``crash_client_at_round``: the LAST sampled client hard-exits
      (``os._exit``) when that round's sync arrives — deterministic
      SIGKILL-at-round-r;
    - ``restart_hub_after``: SIGKILL the hub that long after the whole
      federation registered, then restart it on the SAME port — workers
      must auto-reconnect (pass ``auto_reconnect``) and the deadline
      must absorb the frames lost in the outage;
    - ``chaos_plan``: ``FaultPlan`` JSON shipped to workers via the
      ``FEDML_TPU_CHAOS`` env var (message-level drop/corrupt/...);
    - ``info``: optional dict the launcher fills with the server's
      final stdout JSON (fault counters) and the hub's shutdown stats.

    Virtual-client multiplexing: with ``muxers=M`` the first
    ``muxed_clients`` client ids (default: ALL of them) are driven by M
    muxer processes instead of one process each — client count and
    process count decouple, which is how a 10,000-client federation
    fits on one box.  Remaining ids still get dedicated client
    processes (a MIXED cohort: muxed + per-process + old hello-v1
    dialers on one hub).  ``crash_muxer_at_round`` hard-exits the FIRST
    muxer when that round's sync arrives — hundreds of virtual clients
    vanish at once (the ``muxer_crash`` chaos scenario).

    Hierarchical aggregation (``topology="tree"``, ``edge_hubs=E``):
    the sampled id space is partitioned contiguously into E edge-hub
    cohorts — WHOLE worker processes (a muxer and its full virtual
    range, or a per-process client) are assigned to exactly one edge —
    and each cohort's workers dial their edge's LOCAL hub instead of
    the root.  The edge folds its cohort's uploads into one partial
    aggregate per round (``algorithms/edge_hub``), so the root sees E
    connections and E folds instead of O(clients); the fp64 num/den
    partials compose exactly, so the final model is byte-identical to
    the flat run's.  Idle clients stay on the root hub (they are never
    sampled — pure connection load, which is the root's job to carry).
    ``crash_edge_hub_at_round`` hard-exits the FIRST edge hub when that
    round's sync arrives — a whole cohort orphaned at once (the
    ``edge_hub_crash`` chaos scenario; the round degrades visibly and
    the federation finishes NaN-free on the survivors).

    ``device`` is every child's ``--device``: "" runs them on the card
    (the kernels are built here once, before any child starts, so N
    children never start N compilers), "cpu" on the CPU.  ``mesh`` and
    ``partition_rules`` raise (ROADMAP queue A item 6).
    """
    if mesh or partition_rules:
        raise NotImplementedError(MESH_REFUSAL)
    env = dict(env or os.environ)
    if device != "cpu" and env.get("FEDML_TPU_FORCE_CPU") != "1":
        from fedml_tpu_torch.ops.build import CSRC, build_all

        build_all(sorted(p.stem for p in CSRC.glob("*.cu")))
    if server_env is not None:
        server_env = dict(server_env)
    if chaos_plan:
        env["FEDML_TPU_CHAOS"] = chaos_plan
        if server_env is not None:
            server_env["FEDML_TPU_CHAOS"] = chaos_plan
    if traffic_plan:
        # open-loop traffic rides the env exactly like the chaos plan:
        # workers parse TrafficModel JSON at startup
        env["FEDML_TPU_TRAFFIC"] = traffic_plan
        if server_env is not None:
            server_env["FEDML_TPU_TRAFFIC"] = traffic_plan
    if trace:
        # distributed tracing rides the env: every process (hub,
        # server, clients) stamps hops and shares one run id so the
        # merged timeline is self-correlating
        extra = {"FEDML_TPU_TRACE": "1",
                 "FEDML_TPU_RUN_ID": f"fed-s{seed}-n{num_clients}"}
        env.update(extra)
        if server_env is not None:
            server_env.update(extra)
    me = [sys.executable, "-m", "fedml_tpu_torch.experiments.distributed_fedavg"]
    rd_flags = ["--run-dir", run_dir] if run_dir else []
    if device:
        rd_flags += ["--device", device]
    hub = None
    hubs = []
    procs = []
    killed_registered_peer = False
    try:
        hub_flags = rd_flags + ["--fanout", fanout,
                                "--stripe-kib", str(stripe_kib),
                                "--stripe-pace", str(stripe_pace)]
        if shm_min_bytes != 1024:
            hub_flags += ["--shm-min-bytes", str(shm_min_bytes)]
        hub = subprocess.Popen(
            me + ["--role", "hub", "--port", "0"] + hub_flags,
            stdout=subprocess.PIPE, text=True, env=env,
        )
        hubs.append(hub)
        port_line = hub.stdout.readline()
        if not port_line:
            raise RuntimeError("hub died before announcing its port")
        port = json.loads(port_line)["hub_port"]
        common = ["--host", "127.0.0.1", "--port", str(port),
                  "--num-clients", str(num_clients), "--rounds", str(rounds),
                  "--seed", str(seed), "--batch-size", str(batch_size)] \
            + rd_flags
        if codec and codec != "none":
            common += ["--codec", codec]
        if wire != 2:
            common += ["--wire", str(wire)]
        if input_dim != 8:
            common += ["--input-dim", str(input_dim)]
        if lane != "tcp":
            common += ["--lane", lane]
        if shm_mib != 64:
            common += ["--shm-mib", str(shm_mib)]
        if shm_min_bytes != 1024:
            common += ["--shm-min-bytes", str(shm_min_bytes)]
        if bcast != "full":
            common += ["--bcast", bcast]
        if bcast_codec:
            common += ["--bcast-codec", bcast_codec]
        if delta_base_window != 4:
            common += ["--delta-base-window", str(delta_base_window)]
        if round_mode != "sync":
            common += ["--round-mode", round_mode]
        if cut_size:
            common += ["--cut-size", str(cut_size)]
        if max_staleness != 2:
            common += ["--max-staleness", str(max_staleness)]
        if stale_policy != "poly":
            common += ["--stale-policy", stale_policy]
        if stale_alpha != 0.5:
            common += ["--stale-alpha", str(stale_alpha)]
        if hotpath != "fast":
            common += ["--hotpath", hotpath]
        if decode_workers != 2:
            common += ["--decode-workers", str(decode_workers)]
        if train_samples != 60:
            common += ["--train-samples", str(train_samples)]
        if stats_plane != "on":
            common += ["--stats-plane", stats_plane]
        if report_interval != 1.0:
            common += ["--report-interval", str(report_interval)]
        if slo:
            common += ["--slo", slo]
        if round_timeout:
            common += ["--round-timeout", str(round_timeout)]
        if clients_per_round:
            # required for spares to bite: with the default (everyone
            # sampled) broadcast_size = min(K+S, num_clients) collapses
            # back to K and over-sampling is a no-op
            common += ["--clients-per-round", str(clients_per_round)]
        if spares:
            common += ["--spares", str(spares)]
        if auto_reconnect:
            common += ["--auto-reconnect", str(auto_reconnect)]
        # robust-aggregation knobs: the server's decision — and in tree
        # topology ALSO each edge hub's, because per-upload screening
        # runs at the edge with the identical config (clients stay
        # oblivious either way)
        defense_flags = []
        if defense != "none":
            defense_flags += ["--defense", defense]
        for flag, val, dflt in (("--norm-bound", norm_bound, 0.0),
                                ("--outlier-mult", outlier_mult, 0.0),
                                ("--conn-cap", conn_cap, 0.0),
                                ("--dp-clip", dp_clip, 0.0),
                                ("--dp-noise", dp_noise, 0.0),
                                ("--trim-frac", trim_frac, 0.2)):
            if val != dflt:
                defense_flags += [flag, str(val)]
        # worker units in node-id order: each is an indivisible PROCESS
        # (a muxer owns its whole contiguous virtual-id range), which
        # is the granularity the tree partition assigns to edges
        muxed = 0
        mux_specs = []
        if muxers:
            muxed = min(muxed_clients or num_clients, num_clients)
            base_sz, rem = divmod(muxed, muxers)
            start = 1
            for j in range(muxers):
                size = base_sz + (1 if j < rem else 0)
                if size > 0:
                    mux_specs.append((start, size))
                    start += size
        units = [("muxer", s, sz) for s, sz in mux_specs] \
            + [("client", i + 1, 1) for i in range(muxed, num_clients)]
        use_tree = topology == "tree" and edge_hubs > 0
        if use_tree:
            # contiguous partition balanced by client count: a unit
            # lands in the group whose proportional share its ids fall
            # into, so whole muxers never straddle an edge boundary
            tree_groups = [[] for _ in range(edge_hubs)]
            acc, gi = 0, 0
            for u in units:
                tree_groups[gi].append(u)
                acc += u[2]
                if (gi < edge_hubs - 1
                        and acc >= (gi + 1) * num_clients / edge_hubs):
                    gi += 1
            groups = [g for g in tree_groups if g]
        else:
            groups = [units] if units else []
        mux_procs = []
        clients = []
        edge_procs = []
        tier_flags = ["--fanout", fanout,
                      "--stripe-kib", str(stripe_kib),
                      "--stripe-pace", str(stripe_pace)]
        edge_ports = []
        if use_tree:
            # every edge hub starts before any is waited on, so their
            # start-ups overlap; each is in ``procs`` (killed on the way
            # out) from the moment it exists
            for gi, group in enumerate(groups):
                ep = subprocess.Popen(
                    me + ["--role", "edge_hub", "--node-id", str(group[0][1]),
                          "--virtual-clients", str(sum(u[2] for u in group))]
                    + common + defense_flags + tier_flags
                    + (["--crash-at-round", str(crash_edge_hub_at_round)]
                       if crash_edge_hub_at_round >= 0 and gi == 0
                       else []),
                    stdout=subprocess.PIPE, text=True, env=env,
                )
                edge_procs.append(ep)
                procs.append(ep)
            for gi, ep in enumerate(edge_procs):
                line = ep.stdout.readline()
                if not line:
                    raise RuntimeError(
                        f"edge hub {gi} died before announcing its port")
                edge_ports.append(json.loads(line)["edge_port"])
        for gi, group in enumerate(groups):
            wport = edge_ports[gi] if use_tree else port
            # the cohort dials ITS tier's hub: a trailing --port
            # overrides the root port baked into `common` (argparse
            # keeps the last occurrence)
            port_override = ([] if wport == port
                             else ["--port", str(wport)])
            for kind, start, size in group:
                if kind == "muxer":
                    mux_procs.append(subprocess.Popen(
                        me + ["--role", "muxer", "--node-id", str(start),
                              "--virtual-clients", str(size)] + common
                        + port_override
                        + (["--rejoin-every-round"]
                           if mux_rejoin_every_round else [])
                        + (["--crash-at-round", str(crash_muxer_at_round)]
                           if crash_muxer_at_round >= 0 and mux_specs
                           and (start, size) == mux_specs[0] else []),
                        env=env,
                        # muxer stdout carries one upload-digest JSON
                        # line PER virtual client — digest comparisons
                        # against a per-process run are topology-blind
                        stdout=(subprocess.PIPE if info is not None
                                else None),
                        text=True if info is not None else None,
                    ))
                else:
                    clients.append(subprocess.Popen(
                        me + ["--role", "client",
                              "--node-id", str(start)] + common
                        + port_override
                        + (["--train-delay", str(slow_client_delay)]
                           if slow_client_delay and start == num_clients
                           else [])
                        + (["--crash-at-round",
                            str(crash_client_at_round)]
                           if crash_client_at_round >= 0
                           and start == num_clients else []),
                        env=env,
                        # client stdout carries the upload-digest JSON
                        # line the compression measurement compares
                        # across re-runs
                        stdout=(subprocess.PIPE if info is not None
                                else None),
                        text=True if info is not None else None,
                    ))
        procs += mux_procs + clients
        idle = [
            subprocess.Popen(
                me + ["--role", "client",
                      "--node-id", str(num_clients + 1 + j)] + common,
                env=env,
            )
            for j in range(extra_idle_clients)
        ]
        procs += idle
        # server_env lets the SERVER run with another environment than
        # the clients (its own chaos plan, its own device variables)
        server = subprocess.Popen(
            me + ["--role", "server", "--out", out_path] + common
            + defense_flags,
            env=dict(server_env) if server_env is not None else env,
            stdout=subprocess.PIPE if info is not None else None,
            text=True if info is not None else None,
        )
        procs.append(server)
        if restart_hub_after:
            # wait until the WHOLE federation registered (the startup
            # barrier passed), let a round get going, then SIGKILL the
            # hub and restart it on the same port: every worker must
            # re-dial + re-register, and frames lost in the outage are
            # absorbed by the round deadline
            from fedml_tpu_torch.comm.tcp import TcpBackend

            mon = TcpBackend(9997, "127.0.0.1", port)
            mon.await_peers([0] + list(range(1, num_clients + 1)),
                            timeout=60 + 15 * num_clients)
            mon.stop()
            time.sleep(restart_hub_after)
            hub.kill()  # SIGKILL: no sentinel, no graceful close
            hub.wait(timeout=10)
            time.sleep(0.5)  # a beat of real downtime
            hub = subprocess.Popen(
                me + ["--role", "hub", "--port", str(port)] + hub_flags,
                stdout=subprocess.PIPE, text=True, env=env,
            )
            hubs.append(hub)
            if not hub.stdout.readline():
                raise RuntimeError("restarted hub died before binding")
        if kill_slow_client_after and slow_client_delay and clients:
            # wait until EVERYONE (clients + server) is registered — the
            # server's await_peers barrier has then passed, so killing
            # the slow client can no longer wedge startup; by now it is
            # asleep in its first local update (train_delay) — a SAMPLED
            # client dying mid-round
            from fedml_tpu_torch.comm.tcp import TcpBackend

            mon = TcpBackend(9998, "127.0.0.1", port)
            mon.await_peers([0] + list(range(1, num_clients + 1)),
                            timeout=60 + 15 * num_clients)
            mon.stop()
            time.sleep(kill_slow_client_after)
            clients[-1].kill()
        if idle:
            # monitor connection: wait until the doomed peer is actually
            # registered, so the kill exercises hub dead-peer cleanup
            # rather than landing on a process that never connected
            from fedml_tpu_torch.comm.tcp import TcpBackend

            monitor = TcpBackend(9999, "127.0.0.1", port)
            monitor.await_peers([num_clients + 1],
                                timeout=60 + 15 * num_clients)
            if kill_idle_after:
                time.sleep(kill_idle_after)
            idle[0].kill()
            killed_registered_peer = True
            monitor.stop()
        rc = server.wait(timeout=timeout)
        if info is not None:
            _collect_json_lines(server.stdout, info)
        for c in clients + mux_procs + edge_procs:
            out = None
            try:
                if c.stdout is not None:
                    # communicate DRAINS stdout while waiting: a muxer
                    # prints one digest line per virtual client, which
                    # overruns the 64 KB pipe at a few hundred virtual
                    # clients — a bare wait() would deadlock against
                    # the child's blocked write and then kill it
                    out, _ = c.communicate(timeout=30)
                else:
                    c.wait(timeout=30)
            except subprocess.TimeoutExpired:
                # a wedged client must not fail the launcher: under
                # chaos a client whose FINISH was lost blocks forever —
                # reap it (the server outcome is what the caller asserts)
                c.kill()
                if c.stdout is not None:
                    try:
                        out, _ = c.communicate(timeout=5)
                    except Exception:
                        out = None
            if info is not None and out:
                _collect_json_lines(out, info)
        if extra_idle_clients:
            assert killed_registered_peer
        return rc
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        if hub is not None and hub.poll() is None:
            hub.terminate()
            hub.wait(timeout=10)
            if info is not None:
                _collect_json_lines(hub.stdout, info)
        for h in hubs:
            if h.poll() is None:
                h.kill()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--role",
                   choices=["hub", "server", "client", "muxer",
                            "edge_hub"],
                   required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--node-id", type=int, default=0)
    # muxer role: ONE process drives this many virtual clients (node
    # ids --node-id .. --node-id + N - 1) over ONE hub connection,
    # training each round's cohort in one pass — client count and
    # process count decouple
    p.add_argument("--virtual-clients", type=int, default=1)
    p.add_argument("--num-clients", type=int, default=3)
    p.add_argument("--clients-per-round", type=int, default=0)
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--out", default="")
    # straggler knobs: server-side round deadline (s; 0 = wait forever,
    # the reference's behavior) and client-side artificial train delay
    p.add_argument("--round-timeout", type=float, default=0.0)
    p.add_argument("--train-delay", type=float, default=0.0)
    # fault-tolerance knobs (chaos layer): over-sampled spare clients,
    # reconnect budget (-1 = role default: 0 for the server — legacy
    # fail-fast — and 3 for clients; an explicit 0 means 0 for both),
    # deterministic client crash
    p.add_argument("--spares", type=int, default=0)
    p.add_argument("--auto-reconnect", type=int, default=-1)
    p.add_argument("--crash-at-round", type=int, default=-1)
    # update-compression knobs (compress/): the server
    # announces --codec on every sync; clients encode their delta with
    # it.  --wire 1 forces legacy JSON/base64 frames (the baseline arm
    # of the bytes measurement); --input-dim scales the model so byte
    # ratios measure payload, not envelope.
    p.add_argument("--codec", default="none")
    # rule-driven sharding of a muxer's cohort over a device mesh: not
    # ported (ROADMAP queue A item 6), so any role given them raises
    p.add_argument("--mesh", default="")
    p.add_argument("--partition-rules", default="")
    p.add_argument("--wire", type=int, choices=[1, 2], default=2)
    p.add_argument("--input-dim", type=int, default=8)
    # raw-speed transport knobs (comm/shm.py +
    # fedavg_cross_device delta mode): --lane shm moves same-box
    # payload bytes through a per-connection shared-memory ring slab
    # (--shm-mib sized, payloads under --shm-min-bytes stay inline;
    # cross-host peers / full rings fall back to TCP per frame,
    # counted); --bcast delta ships each sync as the int8-encoded
    # chain update against the receiver's last-acked round
    # (--bcast-codec overrides the chain codec, --delta-base-window
    # bounds the per-round delta log — older bases get a full resend)
    p.add_argument("--lane", choices=["tcp", "shm"], default="tcp")
    p.add_argument("--shm-mib", type=int, default=64)
    p.add_argument("--shm-min-bytes", type=int, default=1024)
    p.add_argument("--bcast", choices=["full", "delta"], default="full")
    p.add_argument("--bcast-codec", default="")
    p.add_argument("--delta-base-window", type=int, default=4)
    # churn-soak knob (muxer role): drop + re-hello the hub connection
    # and forget delta bases after every trained round
    p.add_argument("--rejoin-every-round", action="store_true")
    # async buffered rounds (server role): fold-on-arrival with cuts
    # every --cut-size arrivals (0 = clients_per_round) instead of the
    # synchronous barrier; in-window stale uploads (base round within
    # --max-staleness of current) fold at the --stale-policy discount
    # w(r-b) — poly: (1+d)^-alpha, const: 1 inside the window — while
    # out-of-window ones still hit the reject firewall.  --stale-alpha 0
    # is the byte-identity arm (w == 1 exactly).
    p.add_argument("--round-mode", choices=["sync", "async"],
                   default="sync")
    p.add_argument("--cut-size", type=int, default=0)
    p.add_argument("--max-staleness", type=int, default=2)
    p.add_argument("--stale-policy", choices=["poly", "const"],
                   default="poly")
    p.add_argument("--stale-alpha", type=float, default=0.5)
    # wire hot-path knobs: --hotpath legacy reverts the server to
    # per-node unicast broadcast + buffered close-time aggregation (the
    # pre-multicast behavior — the latency measurement's baseline arm
    # and the interop mode for peers that can't derive identity from
    # their node id); --train-samples scales per-client local compute
    # so latency runs can pick a comm-dominant regime
    p.add_argument("--hotpath", choices=["fast", "legacy"], default="fast")
    # fan-out/pipeline knobs: --fanout striped splits hub multicast
    # payloads into --stripe-kib KiB crc'd stripes, head-starts every
    # receiver's stripe 0, then drains tails at --stripe-pace frames
    # per connection per drain quantum (small pace = fair round-robin
    # streaming, large = staggered-completion locality; whole = the
    # whole-frame baseline); --decode-workers sizes the server's
    # off-reader-thread upload decode pool (0 = serial decode on the
    # reader thread, the pre-pipeline behavior)
    p.add_argument("--fanout", choices=["striped", "whole"],
                   default="striped")
    p.add_argument("--stripe-kib", type=int, default=256)
    p.add_argument("--stripe-pace", type=int, default=8)
    p.add_argument("--decode-workers", type=int, default=2)
    p.add_argument("--train-samples", type=int, default=60)
    # observability knobs: --run-dir makes EVERY process (hub included)
    # append its telemetry registry to its own metrics-<tag>.jsonl in
    # the shared directory; --trace turns on per-hop distributed trace
    # stamping (equivalent to FEDML_TPU_TRACE=1 in the environment);
    # --stats-interval paces the hub's periodic gauge snapshot
    p.add_argument("--run-dir", default="")
    p.add_argument("--trace", action="store_true")
    p.add_argument("--stats-interval", type=float, default=1.0)
    # in-band stats plane (obs/digest + obs/slo): clients and
    # muxers ship one mergeable telemetry-digest frame per
    # --report-interval per CONNECTION; the server merges the rollup,
    # evaluates --slo objectives per round, and (with --run-dir) writes
    # the live status.json + final slo_report.json.  --stats-plane off is the overhead-measurement baseline.
    p.add_argument("--stats-plane", choices=["on", "off"], default="on")
    p.add_argument("--report-interval", type=float, default=1.0)
    p.add_argument("--slo", default="",
                   help="SLO spec: inline JSON or a path to a JSON file "
                        "(obs/slo.SloSpec fields)")
    # robust-aggregation knobs (robust/; server role):
    # --defense streaming = per-upload norm clip (--norm-bound) +
    # outlier-score reject (--outlier-mult, in units of the bound) +
    # per-connection contribution caps (--conn-cap, fraction of round
    # weight — the anti-Sybil lever for muxed cohorts); --defense
    # median|trimmed_mean = buffered coordinate-wise Byzantine
    # estimators (--trim-frac per side).  --dp-clip/--dp-noise layer
    # client-level DP (delta clip + seeded gaussian noise) on any mode.
    p.add_argument("--defense",
                   choices=["none", "streaming", "median", "trimmed_mean"],
                   default="none")
    p.add_argument("--norm-bound", type=float, default=0.0)
    p.add_argument("--outlier-mult", type=float, default=0.0)
    p.add_argument("--conn-cap", type=float, default=0.0)
    p.add_argument("--dp-clip", type=float, default=0.0)
    p.add_argument("--dp-noise", type=float, default=0.0)
    p.add_argument("--trim-frac", type=float, default=0.2)
    # "" = the CUDA card (the process raises without one), "cpu" = the CPU
    p.add_argument("--device", choices=["", "cpu", "cuda"], default="")
    args = p.parse_args(argv)
    if args.mesh or args.partition_rules:
        raise NotImplementedError(MESH_REFUSAL)
    from fedml_tpu_torch.utils.device import resolve_device

    # every role, the hub included, runs where it is told to: without a
    # card and without --device cpu, it raises before any work
    resolve_device(_device(args))
    if args.trace:
        # before any comm import reads (and caches) the switch
        os.environ["FEDML_TPU_TRACE"] = "1"
    if args.role == "hub":
        run_hub(args.host, args.port, args.run_dir, args.stats_interval,
                fanout=args.fanout, stripe_kib=args.stripe_kib,
                stripe_pace=args.stripe_pace,
                shm_min_bytes=args.shm_min_bytes)
    elif args.role == "server":
        run_server(args)
    elif args.role == "muxer":
        run_muxer(args)
    elif args.role == "edge_hub":
        run_edge_hub(args)
    else:
        run_client(args)


if __name__ == "__main__":
    main()
