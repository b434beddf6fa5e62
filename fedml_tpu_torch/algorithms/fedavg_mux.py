"""Muxer-side FedAvg: N virtual clients over ONE connection, in one
process (port of ``fedml_tpu/algorithms/fedavg_mux.py``).

The wire half of virtual-client multiplexing lives in ``comm/mux.py``
(hello v2, per-connection broadcast dedup, local demux).  This module
is the compute half: a cohort manager that collects the co-located sync
deliveries of one broadcast and trains them together, then uploads K
encoded updates whose bytes are those of the one-process-per-client
path, byte for byte:

- each virtual client's ``client_idx``/``slot``/rng stream is derived
  exactly as ``FedAvgClientManager._on_sync`` derives them (client =
  node - 1, slot defaults to client_idx, rng =
  ``fold_in(fold_in(fold_in(PRNGKey(seed), round), 0), slot)`` in the
  port's threefry);
- per-client packs are id-keyed (``pack_clients``), so a cohort pack's
  row k IS the single-client pack for that id;
- the cohort is a loop: one call of the SAME local update the
  per-process client runs, per virtual client in node order, on the
  manager's device.  The JAX module vmaps that call; here a loop keeps
  the uploads the per-process path's by construction (and the conv
  kernel's ``autograd.Function`` has no batching rule);
- uploads go through the SHARED ``encode_client_upload``
  (``fedavg_cross_device``) with a per-virtual-client error-feedback
  store — encoded bytes are a pure function of (seed, round, slot).

Chaos/trace/obs parity: every virtual client sits behind its own
``VirtualNodeBackend`` (optionally chaos-wrapped per node), so
FaultRule decisions, trace hop chains, and telemetry identities match
the per-process topology — a drop rule for virtual node 3 drops only
node 3's sync copy, and node 3 simply isn't in that round's cohort.

The same wrap is the MALICIOUS-MUXER attack surface (``robust/``
threat model): Byzantine FaultRules (``sign_flip`` / ``scale_grad``)
covering this muxer's virtual ids mutate every co-located upload on its
way out — one compromised process speaking for a whole cohort through
one connection, which is exactly what the server's per-connection
contribution caps exist to bound.
"""

from __future__ import annotations

import hashlib
import logging
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from fedml_tpu_torch.algorithms.fedavg_cross_device import (
    MSG_ARG_KEY_CODEC,
    SERVER,
    encode_client_upload,
    ef_for,
    reconstruct_sync_model,
    request_resync,
)
from fedml_tpu_torch.analysis.locks import make_lock
from fedml_tpu_torch.comm.backend import CommBackend, NodeManager
from fedml_tpu_torch.comm.message import (
    MSG_ARG_KEY_CLIENT_INDEX,
    MSG_ARG_KEY_LOCAL_METRICS,
    MSG_ARG_KEY_MODEL_PARAMS,
    MSG_ARG_KEY_NUM_SAMPLES,
    MSG_ARG_KEY_ROUND_INDEX,
    MSG_TYPE_C2S_SEND_MODEL,
    MSG_TYPE_S2C_FINISH,
    MSG_TYPE_S2C_INIT_CONFIG,
    MSG_TYPE_S2C_SYNC_MODEL,
    Message,
)
from fedml_tpu_torch.comm.mux import TcpMuxBackend
from fedml_tpu_torch.core import rng as rnglib
from fedml_tpu_torch.core import tree as treelib
from fedml_tpu_torch.core.client import LocalUpdateFn
from fedml_tpu_torch.core.types import FedDataset, pack_clients
from fedml_tpu_torch.obs import flight
from fedml_tpu_torch.obs.telemetry import get_telemetry
from fedml_tpu_torch.utils.device import DeviceLike, resolve_device

MESH_REFUSAL = ("a muxer cohort on a device mesh (mesh=/partition_rules=) is "
                "not ported to fedml_tpu_torch yet (ROADMAP.md, queue A item 6: "
                "transformer and parallel)")


class _VirtualEndpoint(NodeManager):
    """One virtual client's protocol endpoint: registers the standard
    client-side handlers on its (possibly chaos-wrapped) virtual
    backend and forwards into the shared cohort collector.  Keeping a
    real ``NodeManager`` per virtual node preserves the per-node
    handler-latency telemetry and the trace 'done' stamps the
    per-process topology emits."""

    def __init__(self, backend: CommBackend,
                 cohort: "FedAvgMuxClientManager"):
        self.cohort = cohort
        super().__init__(backend)

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(
            MSG_TYPE_S2C_INIT_CONFIG, self._on_sync)
        self.register_message_receive_handler(
            MSG_TYPE_S2C_SYNC_MODEL, self._on_sync)
        self.register_message_receive_handler(
            MSG_TYPE_S2C_FINISH, self._on_finish)

    def _on_sync(self, msg: Message) -> None:
        self.cohort._enqueue_sync(self.backend.node_id, msg)

    def _on_finish(self, msg: Message) -> None:
        self.cohort._on_finish(self.backend.node_id, msg)


class FedAvgMuxClientManager:
    """Drives every virtual client of one muxed connection.

    Collection contract: sync handlers only ENQUEUE (cheap — the trace
    'done' stamp marks delivery, not training); the mux backend's
    post-dispatch flush hook then trains everyone the physical frame
    reached as one cohort.  A sync arriving OUTSIDE a dispatch (a
    chaos-delayed copy re-injected from a timer thread) trains
    immediately as its own — possibly singleton — cohort: late copies
    behave like the late stragglers they are.

    Syncs carrying DIFFERENT payloads (a chaos-corrupted copy, mixed
    rounds after a delay) group by payload identity and train as
    separate cohorts: a NaN-corrupted sync NaN-poisons exactly its own
    virtual client's upload, which the server's corrupt-upload firewall
    then rejects — the same blast radius as the per-process path.
    """

    # reader-thread dispatch flushes vs chaos-timer-thread flushes:
    # the enqueue list rides its own lock; everything a flush TOUCHES
    # (pack cache, EF stores, digests) is serialized by _train_lock
    _GUARDED_BY = {
        "_pending": "_plock",
        "_bases": "_train_lock",
        "_pack_key": "_train_lock",
        "_pack_ids": "_train_lock",
        "_pack_index": "_train_lock",
        "_pack_host": "_train_lock",
        "_pack_dev": "_train_lock",
    }

    def __init__(
        self,
        mux: TcpMuxBackend,
        local_update: LocalUpdateFn,
        dataset: FedDataset,
        *,
        batch_size: int,
        template_variables,
        seed: int = 0,
        error_feedback: bool = True,
        train_delay: float = 0.0,
        crash_at_round: Optional[int] = None,
        wrap_backend: Optional[Callable[[CommBackend], CommBackend]] = None,
        rejoin_every_round: bool = False,
        traffic=None,
        mesh=None,
        partition_rules=None,
        device: DeviceLike = None,
    ):
        if mesh is not None or partition_rules:
            raise NotImplementedError(MESH_REFUSAL)
        self.mux = mux
        # open-loop traffic model (faults/traffic.TrafficModel): every
        # virtual client gets its own seeded per-round arrival decision
        # — offline (churn), per-upload delay (speed class + jitter +
        # heavy-tailed straggler), and a connection-level flap draw.
        # None = the closed-loop behavior, byte-identical to before.
        self.traffic = traffic
        self._last_traffic_round = -1
        # connection-churn soak knob: after every trained round this
        # muxer drops its hub connection (auto_reconnect re-dials and
        # re-helloes — the hub's rebind counters grow) AND forgets its
        # delta base cache, so the next delta broadcast finds a
        # rejoiner that must be walked back to a full model (resync).
        self.rejoin_every_round = bool(rejoin_every_round)
        # once-per-round guard for the churn rebind: a round's resync
        # walkback delivers per-node unicast fulls (one flush each),
        # and rebinding on every one of those would orphan the rest of
        # the walkback in the displaced connection's queues
        self._last_rebind_round = -1
        # the cohort trains on this device (the card unless the caller
        # asks for the CPU); syncs decode onto it, as the per-process
        # client's do
        self.device = resolve_device(device)
        self.local_update = local_update.fn
        self.dataset = dataset
        self.batch_size = batch_size
        self.template = treelib.tree_map(
            lambda l: (l.detach() if isinstance(l, torch.Tensor)
                       else torch.from_numpy(np.array(l))).to(self.device),
            template_variables,
        )
        self.seed = seed
        self.error_feedback = error_feedback
        self.train_delay = train_delay
        self.crash_at_round = crash_at_round
        self._pending: List[tuple] = []
        self._plock = make_lock("FedAvgMuxClientManager._plock")
        # serializes whole flushes: the reader thread's dispatch flush
        # and a chaos-delayed copy's timer-thread flush share the pack
        # cache, the per-node EF stores, and the digest hashes — an
        # interleaved train would swap the pack out from under the
        # bigger cohort (or tear an EF residual) mid-step
        self._train_lock = make_lock("FedAvgMuxClientManager._train_lock")
        self._finished = threading.Event()
        # cohort pack cache: packs are round-independent (the local
        # update re-permutes per epoch from the (seed, round, slot)
        # stream) and per-client id-keyed, so row k of any cohort pack
        # is bit-identical to client k's single-client pack.  The cache
        # holds ONE pack covering the superset of ids seen (seeded with
        # this muxer's default client range) and every cohort —
        # including a per-round SAMPLED subset — row-slices it; the
        # device copy of the whole pack is made once.
        self._pack_key = None        # (steps_per_epoch, batch_size)
        self._pack_ids = None        # ids the cached pack covers, in order
        self._pack_index = None      # client id -> row
        self._pack_host = None       # (x, y, mask, num_samples) numpy
        self._pack_dev = None        # (x, y, mask) tensors on the device
        # delta-broadcast base cache, shared by the whole co-located
        # cohort (chain models are globally identical): round -> OWNED
        # copy of the reconstructed model — same two contracts as the
        # per-process client's cache (in-window bases on hand; nothing
        # cached aliases a transport buffer)
        self._bases: "OrderedDict[int, object]" = OrderedDict()
        self._base_window = 4
        self._ef: Dict[int, object] = {}
        self._hash = {n: hashlib.sha256() for n in mux.node_ids}
        self.rounds_trained = {n: 0 for n in mux.node_ids}
        # in-band stats plane: ONE reporter per muxer process IS the
        # pre-merge — every virtual client shares this process registry,
        # so one digest frame per interval covers the whole co-located
        # cohort and the hub ingests one stream per CONNECTION.  The
        # entry point attaches it; FINISH stops it with a final flush
        # before the shared connection closes.
        self.stats_reporter = None
        self._endpoints: Dict[int, _VirtualEndpoint] = {}
        for n in mux.node_ids:
            vb = mux.virtual(n)
            backend = wrap_backend(vb) if wrap_backend is not None else vb
            self._endpoints[n] = _VirtualEndpoint(backend, self)
        mux.add_flush_hook(self._flush)

    # -- collection ---------------------------------------------------------
    def _enqueue_sync(self, node: int, msg: Message) -> None:
        with self._plock:
            self._pending.append((node, msg))
        if not self.mux.in_dispatch():
            # delayed/re-injected copy on a timer thread: no dispatch
            # flush is coming — train it now as its own cohort
            self._flush()

    def _on_finish(self, node: int, msg: Message) -> None:
        if not self._finished.is_set():
            self._finished.set()
            if self.stats_reporter is not None:
                self.stats_reporter.stop()  # final flush, conn still open
            self.mux.stop()

    def reporter_backend(self):
        """The backend a DigestReporter should send through: the PRIMARY
        virtual node's (possibly chaos-wrapped) endpoint, so a fault
        plan targeting that node's telemetry frames applies exactly as
        it would on a dedicated process."""
        return self._endpoints[self.mux.node_ids[0]].backend

    # -- cohort training ----------------------------------------------------
    def _flush(self) -> None:
        with self._train_lock:
            self._flush_locked()

    def _rebind(self, why: str) -> None:
        try:
            self.mux.rebind_connection()
        except (OSError, ConnectionError):
            logging.exception(
                "muxer %d: %s re-dial failed; falling back to "
                "drop_connection", self.mux.node_id, why,
            )
            self.mux.drop_connection()

    def _flush_locked(self) -> None:  # fedlint: holds=_train_lock
        with self._plock:
            pending, self._pending = self._pending, []
        if not pending:
            return
        batch_round = max(
            (m.get(MSG_ARG_KEY_ROUND_INDEX) for _, m in pending
             if m.get(MSG_ARG_KEY_ROUND_INDEX) is not None),
            default=None,
        )
        if (self.rejoin_every_round and not self._finished.is_set()
                and batch_round is not None
                and batch_round > self._last_rebind_round):
            # churn soak, step 1: ONCE per round, re-hello on a FRESH
            # connection while the old one is still registered — the
            # hub counts one rebind per virtual id, and doing it BEFORE
            # training means the connection is stable again by the time
            # this round's uploads happen
            self._last_rebind_round = batch_round
            self._rebind("churn")
        if (self.traffic is not None and not self._finished.is_set()
                and batch_round is not None
                and batch_round > self._last_traffic_round):
            # traffic-model flap: connection-granularity (one physical
            # socket per muxer), keyed by the PRIMARY virtual node so
            # the draw is independent of cohort composition.  Same
            # once-per-round guard as the churn soak.
            self._last_traffic_round = batch_round
            if self.traffic.decide(
                    self.mux.node_ids[0], batch_round)["rebind"]:
                get_telemetry().inc("traffic.rebinds")
                self._rebind("traffic flap")
        if self.crash_at_round is not None and any(
            m.get(MSG_ARG_KEY_ROUND_INDEX) == self.crash_at_round
            for _, m in pending
        ):
            import os

            # black-box flush on the way down (see the per-process
            # client manager's twin of this path)
            flight.trigger("crash", reason="crash_at_round",
                           round_idx=self.crash_at_round, force=True)
            # the muxer-process twin of the client crash_at_round knob:
            # os._exit skips cleanup, so every virtual client of this
            # process vanishes mid-protocol at once
            os._exit(137)
        if self.train_delay:
            time.sleep(self.train_delay)
        # group by payload identity: clones of one broadcast share the
        # wiretree OBJECT (decode once per group); a chaos-corrupted
        # copy is a fresh object and trains — and fails — alone
        groups: Dict[int, tuple] = {}
        order: List[int] = []
        for node, msg in pending:
            key = id(msg.get(MSG_ARG_KEY_MODEL_PARAMS))
            if key not in groups:
                groups[key] = (msg, [])
                order.append(key)
            groups[key][1].append((node, msg))
        trained = False
        for key in order:
            ref_msg, entries = groups[key]
            try:
                trained = self._train_cohort(ref_msg, entries) or trained
            except Exception:
                # one cohort's failure (undecodable sync, engine bug)
                # must not take down the other groups or the reader
                # thread: those virtual clients become stragglers this
                # round, the deadline covers them
                logging.exception(
                    "muxer %d: cohort train failed for nodes %s",
                    self.mux.node_id, [n for n, _ in entries],
                )
        if trained and self.rejoin_every_round \
                and not self._finished.is_set():
            # churn soak, step 2: this round's uploads are out — forget
            # the delta bases (fresh-process amnesia), so the next
            # delta broadcast finds a cold rejoiner
            self._bases.clear()

    def _reconstruct_sync(self, ref_msg: Message):  # fedlint: holds=_train_lock
        """The muxer side of the SHARED ``reconstruct_sync_model``
        (``fedavg_cross_device``): one cache for the whole co-located
        cohort (chain models are globally identical).  Returns None on
        a missing base — the caller then requests a resync for every
        virtual node in the cohort."""
        variables, self._base_window = reconstruct_sync_model(
            ref_msg, self.template, self._bases, self._base_window
        )
        return variables

    def _cohort_pack(self, client_ids: List[int], steps):  # fedlint: holds=_train_lock
        """(x, y, mask) per client on the device and the sample counts,
        row-sliced from the cached cohort pack (rebuilt when the
        geometry changes or an unseen id arrives)."""
        pack_key = (steps, self.batch_size)
        if (self._pack_key != pack_key
                or any(c not in self._pack_index for c in client_ids)):
            base_ids = sorted(
                set(client_ids) | {n - 1 for n in self.mux.node_ids}
            )
            pack = pack_clients(
                self.dataset, base_ids, self.batch_size,
                steps_per_epoch=steps, seed=self.seed,
            )
            self._pack_key = pack_key
            self._pack_ids = base_ids
            self._pack_index = {c: i for i, c in enumerate(base_ids)}
            self._pack_host = (
                np.asarray(pack.x), np.asarray(pack.y),
                np.asarray(pack.mask),
                np.asarray(pack.num_samples).copy(),
            )
            self._pack_dev = tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for a in self._pack_host[:3]
            )
        rows = [self._pack_index[c] for c in client_ids]
        x, y, mask = self._pack_dev
        return ([(x[r], y[r], mask[r]) for r in rows],
                self._pack_host[3][rows])

    def _train_cohort(self, ref_msg: Message, entries: List[tuple]) -> bool:  # fedlint: holds=_train_lock
        entries = sorted(entries, key=lambda e: e[0])
        round_idx = ref_msg.get(MSG_ARG_KEY_ROUND_INDEX)
        # open-loop arrivals: each virtual client draws its own seeded
        # traffic decision for this round — offline nodes drop out of
        # the cohort (the server's deadline/async cut covers them), the
        # rest carry a per-upload delay applied at send time so a slow
        # device's upload ARRIVES late without stalling the cohort.
        decisions: Dict[int, dict] = {}
        if self.traffic is not None and round_idx is not None:
            tel = get_telemetry()
            kept = []
            for node, msg in entries:
                d = self.traffic.decide(node, round_idx)
                if d["offline"]:
                    tel.inc("traffic.offline_rounds")
                    continue
                if d["straggler"]:
                    tel.inc("traffic.straggler_draws")
                decisions[node] = d
                kept.append((node, msg))
            entries = kept
            if not entries:
                return False
        variables = self._reconstruct_sync(ref_msg)
        if variables is None:
            get_telemetry().inc("comm.delta_resyncs", len(entries))
            logging.warning(
                "muxer %d: delta sync for round %s against unknown base "
                "— requesting full resync for %d virtual nodes",
                self.mux.node_id, round_idx, len(entries),
            )
            for node, _msg in entries:
                try:
                    request_resync(self._endpoints[node].send_message,
                                   node, round_idx)
                except OSError:
                    logging.warning(
                        "muxer %d: resync for virtual node %d lost",
                        self.mux.node_id, node,
                    )
            return False
        codec_name = ref_msg.get(MSG_ARG_KEY_CODEC) or "none"
        steps = ref_msg.get("steps_per_epoch")
        # exactly the single-client identity derivation
        # (FedAvgClientManager._on_sync): client = node - 1 on the
        # shared multicast envelope, slot defaults to client_idx
        client_ids: List[int] = []
        slots: List[int] = []
        for node, msg in entries:
            ci = msg.get(MSG_ARG_KEY_CLIENT_INDEX)
            if ci is None:
                ci = node - 1
            client_ids.append(int(ci))
            slots.append(int(msg.get("slot", ci)))
        data, num_samples = self._cohort_pack(client_ids, steps)
        # identical stream to the compiled round engine and the
        # single-client manager: key→round→train→slot
        k_round = rnglib.fold_in(rnglib.PRNGKey(self.seed), round_idx)
        k_train = rnglib.fold_in(k_round, 0)
        for k, (node, msg) in enumerate(entries):
            x, y, mask = data[k]
            new_vars, metrics = self.local_update(
                variables, x, y, mask, rnglib.fold_in(k_train, slots[k]))
            self._upload(node, msg, new_vars, variables, round_idx,
                         codec_name, slots[k], float(num_samples[k]),
                         {m: float(v) for m, v in metrics.items()},
                         delay_s=decisions.get(node, {}).get("delay_s",
                                                             0.0))
            self.rounds_trained[node] += 1
        return True

    def _upload(self, node: int, msg: Message, new_vars, synced_vars,
                round_idx, codec_name: str, slot: int, n_samples: float,
                metrics: dict, delay_s: float = 0.0) -> None:
        from fedml_tpu_torch.compress import wire_tree_digest
        from fedml_tpu_torch.obs import comm_obs

        # the same encode as the per-process client: the wire's leaves are
        # host copies made here, on this thread (which waits for the card)
        wire, raw, comp = encode_client_upload(
            codec_name, new_vars, synced_vars, self.template,
            seed=self.seed, round_idx=round_idx, slot=slot,
            ef=ef_for(self._ef, node, codec_name, self.error_feedback),
        )
        if raw is not None:
            comm_obs.record_compression(MSG_TYPE_C2S_SEND_MODEL, raw, comp)
        self._hash[node].update(wire_tree_digest(wire).encode())
        reply = Message(MSG_TYPE_C2S_SEND_MODEL, node, SERVER)
        reply.add_params(MSG_ARG_KEY_ROUND_INDEX, round_idx)
        reply.add_params(MSG_ARG_KEY_MODEL_PARAMS, wire)
        reply.add_params(MSG_ARG_KEY_NUM_SAMPLES, n_samples)
        reply.add_params(MSG_ARG_KEY_LOCAL_METRICS, metrics)
        if delay_s and delay_s > 0.0:
            # traffic-model arrival delay: the upload leaves on a timer
            # thread so a slow device's lateness never stalls the rest
            # of the cohort
            tel = get_telemetry()
            tel.inc("traffic.delayed_uploads")
            tel.observe("traffic.upload_delay_s", float(delay_s))
            t = threading.Timer(
                float(delay_s), self._send_upload, args=(node, reply)
            )
            t.daemon = True
            t.start()
            return
        self._send_upload(node, reply)

    def _send_upload(self, node: int, reply: Message) -> None:
        # through the per-virtual (possibly chaos-wrapped) backend:
        # per-virtual-node send fault decisions + trace origin
        try:
            self._endpoints[node].send_message(reply)
        except OSError:
            # the shared conn died mid-cohort (after the backend's own
            # bounded retries): this virtual client is a straggler this
            # round; the remaining uploads still get their attempts —
            # the reconnect path may revive the socket between them
            logging.warning(
                "muxer %d: upload for virtual node %d lost (connection "
                "error) — deadline straggler", self.mux.node_id, node,
            )

    # -- lifecycle / evidence ----------------------------------------------
    def run(self) -> None:
        """Drive the shared reader loop (returns on FINISH/stop)."""
        self.mux.run()

    @property
    def upload_digests(self) -> Dict[int, str]:
        """node id -> accumulated sha256 of every upload it sent — the
        same reproducibility probe ``FedAvgClientManager.upload_digest``
        prints, one per virtual client."""
        return {n: h.hexdigest() for n, h in self._hash.items()}
