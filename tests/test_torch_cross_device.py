"""Cross-device FedAvg of the port (``algorithms/fedavg_cross_device.py``)
over the port's ``InprocBus``, held against the JAX package's on the same
numpy data, inits and seeds:

- shared helpers: ``encode_client_upload`` (none, bf16, qsgd8, qsgd4,
  topk; with and without error feedback; 3 rounds) and
  ``encode_bcast_delta`` give JAX's frame bytes on the same float32
  trees, and ``apply_bcast_delta`` JAX's sums (tolerance: none);
- the in-process federation equals the port's ``FedAvgSimulation`` and
  JAX's federation (heterogeneous data, momentum: 1e-5);
- the server fed the same upload frames as JAX's server ends on JAX's
  model bit for bit (streaming fold, spares, stale/duplicate/NaN
  rejections, edge partials), and on the buffered legacy path;
- the modes, each against JAX's run within 1e-5 with the same round
  log: spares, a deadline with a dropped upload and a stale reply, the
  legacy hot path, a NaN upload rejected and counted, qsgd8 + EF
  uploads, delta broadcast with a forced resync (bitwise equal to the
  run without it, as JAX pins), async with ``cut_size = K`` and alpha 0
  (bitwise equal to sync), async with a delayed client, decode workers,
  a defended run under a scaled attacker, and the stats plane;
- mixed federations over frame bytes (a test-only bridge between the two
  packages' buses): a JAX server with port clients and a port server
  with JAX clients, plain and with qsgd8 + EF + delta broadcast, end
  within 1e-5 of the all-JAX run with the same rounds, sample counts
  and rejections.
"""

import json
import time
from typing import NamedTuple

import jax
import numpy as np
import pytest
import torch

import fedml_tpu.algorithms.fedavg_cross_device as jxd
import fedml_tpu.comm.inproc as jinproc
import fedml_tpu.comm.message as jmessage
import fedml_tpu.faults as jfaults
import fedml_tpu.obs.digest as jdigest
from fedml_tpu.compress import ErrorFeedback as JErrorFeedback
from fedml_tpu.core import tree as jtree
from fedml_tpu.core.client import make_client_optimizer as jmake_opt
from fedml_tpu.core.client import make_local_update as jmake_lu
from fedml_tpu.data.synthetic import synthetic_classification as jsynthetic
from fedml_tpu.models.linear import logistic_regression as jlr
from fedml_tpu.obs.telemetry import get_telemetry as jget_telemetry
from fedml_tpu.robust import DefenseConfig as JDefenseConfig
from fedml_tpu_torch import faults
from fedml_tpu_torch.algorithms import fedavg_cross_device as xd
from fedml_tpu_torch.algorithms.fedavg import FedAvgConfig, FedAvgSimulation
from fedml_tpu_torch.comm import inproc, message
from fedml_tpu_torch.compress import ErrorFeedback, jax_leaves
from fedml_tpu_torch.core import rng as rnglib
from fedml_tpu_torch.core import tree as treelib
from fedml_tpu_torch.core.client import make_client_optimizer, make_local_update
from fedml_tpu_torch.core.types import FedDataset
from fedml_tpu_torch.models.linear import logistic_regression
from fedml_tpu_torch.obs import digest
from fedml_tpu_torch.obs.telemetry import get_telemetry
from fedml_tpu_torch.robust import DefenseConfig

TOL = dict(rtol=1e-5, atol=1e-5)
SEND = "C2S_SEND_MODEL"


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# -- problems and federations on both sides -------------------------------------------

class Problem(NamedTuple):
    jds: object
    ds: FedDataset
    jinit: dict
    tinit: dict
    jlu: object
    tlu: object
    steps: int
    bundle: object


def _problem(seed=0, num_clients=3, partition="hetero", momentum=0.9, n=240):
    jds = jsynthetic(num_train=n, num_test=60, input_shape=(16,), num_classes=4,
                     num_clients=num_clients, partition=partition, partition_alpha=0.4,
                     seed=seed)
    ds = FedDataset(
        train_x=np.asarray(jds.train_x), train_y=np.asarray(jds.train_y),
        test_x=np.asarray(jds.test_x), test_y=np.asarray(jds.test_y),
        train_client_idx={int(k): np.asarray(v) for k, v in jds.train_client_idx.items()},
        test_client_idx=None, num_classes=jds.num_classes, name=jds.name)
    jb = jlr(16, 4)
    tb = logistic_regression(16, 4, device="cpu")
    return Problem(
        jds, ds, jb.init(jax.random.PRNGKey(seed)), tb.init(rnglib.PRNGKey(seed)),
        jmake_lu(jb, jmake_opt("sgd", 0.1, momentum=momentum), 1),
        make_local_update(tb, make_client_optimizer("sgd", 0.1, momentum=momentum), 1),
        int(np.ceil(ds.client_sample_counts().max() / 16)), tb)


def _side(side):
    if side == "jax":
        return dict(S=jxd.FedAvgServerManager, C=jxd.FedAvgClientManager, bus=jinproc.InprocBus,
                    faults=jfaults, msg=jmessage, tel=jget_telemetry(), ckw={})
    return dict(S=xd.FedAvgServerManager, C=xd.FedAvgClientManager, bus=inproc.InprocBus,
                faults=faults, msg=message, tel=get_telemetry(), ckw={"device": "cpu"})


def _drive(buses, server, rounds, timeout_s=30.0):
    """Drain until the federation ends (deadline timers and decode
    workers enqueue from their own threads, so the drain polls)."""
    deadline = time.monotonic() + timeout_s
    while server.round_idx < rounds and time.monotonic() < deadline:
        while sum(b.drain() for b in buses):
            pass
        time.sleep(0.01)
    while sum(b.drain() for b in buses):
        pass


def _federation(side, p, *, rounds=3, num_clients=3, plan_for=None, client_kw=None,
                seed=0, wrap_client=None, **server_kw):
    s = _side(side)
    init, lu, ds = (p.jinit, p.jlu, p.jds) if side == "jax" else (p.tinit, p.tlu, p.ds)
    bus = s["bus"]()
    server_kw.setdefault("clients_per_round", num_clients)
    server = s["S"](bus.register(0), init, num_clients=num_clients, comm_rounds=rounds,
                    seed=seed, steps_per_epoch=p.steps, **server_kw)
    clients = []
    for i in range(num_clients):
        b = bus.register(i + 1)
        plan = plan_for(s["faults"], i + 1) if plan_for else None
        if plan is not None:
            b = s["faults"].ChaosBackend(b, plan)
        kw = {**s["ckw"], **(client_kw(i + 1) if client_kw else {})}
        c = s["C"](b, lu, ds, batch_size=16, template_variables=init, seed=seed, **kw)
        if wrap_client:
            wrap_client(c)
        clients.append(c)
    server.start()
    _drive([bus], server, rounds)
    assert server.round_idx == rounds
    return server, clients


def _leaves(tree):
    """Host leaves in JAX's order, from the port's dotted-key tree or a
    nested one (``jax_leaves`` sorts both by flax path)."""
    return [np.asarray(treelib.host_array(l)) for _, l in jax_leaves(tree)]


def _assert_close(a, b, tol=TOL):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.shape == y.shape
        np.testing.assert_allclose(x, y, **tol)


def _assert_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


LOG_KEYS = ("round", "participants", "dropped", "spared", "stale_from", "stale_round",
            "rejected_from", "kind")


def _log(server):
    return [{k: r[k] for k in LOG_KEYS if k in r} for r in server.round_log]


def _compare_runs(tserver, jserver, tol=TOL):
    _assert_close(tserver.variables, jserver.variables, tol)
    assert _log(tserver) == _log(jserver)
    assert tserver.rejected_uploads == jserver.rejected_uploads
    assert tserver.zero_participant_rounds == jserver.zero_participant_rounds
    for leaf in _leaves(tserver.variables):
        assert np.isfinite(leaf).all()


# -- shared helpers: the wire byte for byte --------------------------------------------

_RNG = np.random.RandomState(11)


def _rand_tree(scale=1.0):
    return {"params": {"Conv_0": {"kernel": (scale * _RNG.randn(3, 3, 3, 8)).astype(np.float32)},
                       "Dense_0": {"bias": (scale * _RNG.randn(10)).astype(np.float32),
                                   "kernel": (scale * _RNG.randn(40, 10)).astype(np.float32)}},
            "batch_stats": {"BatchNorm_0": {"mean": _RNG.randn(8).astype(np.float32),
                                            "var": _RNG.rand(8).astype(np.float32)}}}


def _frame(mod, wire):
    m = mod.Message(SEND, 2, 0)
    m.add_params(mod.MSG_ARG_KEY_MODEL_PARAMS, wire)
    return m.to_frame()


def _torch_tree(tree):
    return treelib.tree_map(lambda l: torch.from_numpy(np.array(l)), tree)


@pytest.mark.parametrize("ef", [False, True])
@pytest.mark.parametrize("codec", ["none", "bf16", "qsgd8", "qsgd4", "topk0.1"])
def test_encode_client_upload_bytes_match_jax(codec, ef):
    """Tolerance: none.  Three rounds of the same (trained, synced) trees
    through each package's encode (the port's trees as CPU tensors, as
    the client holds them after training); the frames, the byte counts
    and the EF residuals agree."""
    store, jstore = {}, {}
    for r in range(3):
        synced = _rand_tree()
        new = treelib.tree_map(lambda l: l + 0.05 * _RNG.randn(*l.shape).astype(np.float32),
                               synced)
        wire, raw, comp = xd.encode_client_upload(
            codec, _torch_tree(new), _torch_tree(synced), _torch_tree(synced), seed=3,
            round_idx=r, slot=2, ef=xd.ef_for(store, 0, codec, ef))
        jwire, jraw, jcomp = jxd.encode_client_upload(
            codec, new, synced, synced, seed=3, round_idx=r, slot=2,
            ef=jxd.ef_for(jstore, 0, codec, ef))
        assert _frame(message, wire) == _frame(jmessage, jwire)
        assert (raw, comp) == (jraw, jcomp)
        assert (0 in store) == (0 in jstore) == (ef and codec != "none")
        if 0 in store:
            _assert_equal(treelib.tree_map(lambda t: t.numpy(), store[0]._residual),
                          jstore[0]._residual)
            assert isinstance(store[0], ErrorFeedback) and isinstance(jstore[0], JErrorFeedback)


@pytest.mark.parametrize("codec", ["none", "bf16", "qsgd8", "qsgd4", "topk0.1"])
def test_encode_bcast_delta_and_apply_match_jax(codec):
    """Tolerance: none.  The broadcast chain's wire and ``base + delta``
    (on a numpy base and on a tensor base) over three rounds."""
    base = _rand_tree()
    for r in range(1, 4):
        update = _rand_tree(0.01)
        wire = xd.encode_bcast_delta(codec, update, seed=4, round_idx=r)
        jwire = jxd.encode_bcast_delta(codec, update, seed=4, round_idx=r)
        assert _frame(message, wire) == _frame(jmessage, jwire)
        assert xd.bcast_wire_nbytes(wire) == jxd.bcast_wire_nbytes(jwire)
        dec = message.tree_from_wire(wire, base)
        jdec = jmessage.tree_from_wire(jwire, base)
        nxt, jnxt = xd.apply_bcast_delta(base, dec), jxd.apply_bcast_delta(base, jdec)
        _assert_equal(nxt, jnxt)
        on_tensors = xd.apply_bcast_delta(_torch_tree(base), dec)
        _assert_equal(treelib.tree_map(lambda t: t.numpy(), on_tensors), jnxt)
        base = jnxt


# -- federations --------------------------------------------------------------------------

def test_federation_matches_simulation_and_jax():
    """Tolerance: 1e-5.  The heterogeneous momentum case of the JAX
    package's in-process federation test: full participation, 3 rounds."""
    p = _problem()
    tserver, tclients = _federation("torch", p)
    jserver, _ = _federation("jax", p)
    _compare_runs(tserver, jserver)
    assert all(c.rounds_trained == 3 for c in tclients)
    cfg = FedAvgConfig(num_clients=3, clients_per_round=3, comm_rounds=3, epochs=1,
                       batch_size=16, lr=0.1, momentum=0.9, frequency_of_the_test=100, seed=0)
    sim = FedAvgSimulation(p.bundle, p.ds, cfg, device="cpu")
    sim.run()
    _assert_close(tserver.variables, sim.state.variables)


def _upload_msg(mod, sender, tree, n, round_idx=0):
    m = mod.Message(SEND, sender, 0)
    m.add_params(mod.MSG_ARG_KEY_ROUND_INDEX, round_idx)
    m.add_params(mod.MSG_ARG_KEY_MODEL_PARAMS, mod.tree_to_wire(tree))
    m.add_params(mod.MSG_ARG_KEY_NUM_SAMPLES, float(n))
    return m


def _script_server(side, script, **kw):
    """A server fed scripted upload frames (each parsed from the same
    bytes on both sides)."""
    s = _side(side)
    bus = s["bus"]()
    server = s["S"](bus.register(0), {"params": {"w": np.ones((4, 3), np.float32),
                                                 "b": np.zeros((3,), np.float32)}},
                    num_clients=5, clients_per_round=3, comm_rounds=2, seed=0, spares=2,
                    stats_plane=False, **kw)
    for i in range(1, 6):
        bus.register(i)
    for frame in script:
        server._on_model(s["msg"].Message.from_frame_bytes(frame))
    return server


def test_server_on_scripted_frames_is_jaxs_bitwise():
    """Tolerance: none.  The JAX package's streaming-fold pin: a NaN
    upload rejected, a stale one discarded, a duplicate ignored, three
    uneven weights folded, the spares left out, and a late spare
    stale-rejected — the port's server ends on JAX's bits, equal to
    ``tree_weighted_mean``; the buffered legacy path agrees with JAX's
    legacy path bit for bit too."""
    rng = np.random.RandomState(7)

    def rand_tree():
        return {"params": {"w": rng.randn(4, 3).astype(np.float32),
                           "b": rng.randn(3).astype(np.float32)}}

    bad = {"params": {"w": np.full((4, 3), np.nan, np.float32), "b": np.zeros(3, np.float32)}}
    trees, ns = [rand_tree() for _ in range(3)], [3.0, 5.0, 11.0]
    script = [_upload_msg(jmessage, 4, bad, 7.0), _upload_msg(jmessage, 5, rand_tree(), 5.0, 3)]
    for sender, (t, n) in enumerate(zip(trees, ns), 1):
        script.append(_upload_msg(jmessage, sender, t, n))
        if sender == 1:
            script.append(_upload_msg(jmessage, 1, t, n))
    script.append(_upload_msg(jmessage, 4, rand_tree(), 2.0, 0))
    frames = [m.to_frame() for m in script]
    corrupt = get_telemetry().counter_value("faults.observed", kind="corrupt_upload",
                                            msg_type=SEND)
    for streaming in (True, False):
        t = _script_server("torch", frames, streaming_agg=streaming)
        j = _script_server("jax", frames, streaming_agg=streaming)
        assert t.round_idx == j.round_idx == 1
        _assert_equal(t.variables, j.variables)
        assert _log(t) == _log(j) and t.rejected_uploads == 1
        assert [r["participants"] for r in t.round_log if "participants" in r] == [[1, 2, 3]]
        assert t.round_log[-1] == {"round": 1, "stale_from": 4, "stale_round": 0}
        if streaming:
            _assert_equal(t.variables, jtree.tree_weighted_mean(trees, ns))
    assert get_telemetry().counter_value("faults.observed", kind="corrupt_upload",
                                         msg_type=SEND) == corrupt + 2


def test_edge_partial_folds_as_the_uploads_would():
    """Tolerance: none.  An E2S_PARTIAL frame carrying the float64
    (sum n·model, sum n) of two uploads, plus a third upload direct,
    closes on the same bits as the three uploads direct, on both
    packages."""
    rng = np.random.RandomState(9)
    trees = [{"params": {"w": rng.randn(4, 3).astype(np.float32),
                         "b": rng.randn(3).astype(np.float32)}} for _ in range(3)]
    ns = [4.0, 9.0, 2.5]
    num = None
    for t, n in zip(trees[:2], ns[:2]):
        num = jtree.tree_fold_weighted(num, t, n)
    partial = jmessage.Message(jmessage.MSG_TYPE_E2S_PARTIAL, 7, 0)
    partial.add_params(jmessage.MSG_ARG_KEY_ROUND_INDEX, 0)
    partial.add_params(jmessage.MSG_ARG_KEY_MODEL_PARAMS, jmessage.tree_to_wire(num))
    partial.add_params(jmessage.MSG_ARG_KEY_NUM_SAMPLES, ns[0] + ns[1])
    partial.add_params(jmessage.MSG_ARG_KEY_CONTRIBUTORS, {"1": ns[0], "2": ns[1]})
    direct = [_upload_msg(jmessage, i + 1, t, n).to_frame()
              for i, (t, n) in enumerate(zip(trees, ns))]
    out = {}
    for side in ("torch", "jax"):
        s = _side(side)
        for how in ("partial", "direct"):
            bus = s["bus"]()
            server = s["S"](bus.register(0), {"params": {"w": np.zeros((4, 3), np.float32),
                                                         "b": np.zeros(3, np.float32)}},
                            num_clients=3, clients_per_round=3, comm_rounds=1, seed=0,
                            stats_plane=False)
            for i in range(1, 8):
                bus.register(i)
            frames = ([partial.to_frame(), direct[2]] if how == "partial" else direct)
            for f in frames:
                m = s["msg"].Message.from_frame_bytes(f)
                (server._on_partial if m.type == jmessage.MSG_TYPE_E2S_PARTIAL
                 else server._on_model)(m)
            assert server.round_idx == 1
            assert server.round_log[-1]["participants"] == [1, 2, 3]
            out[side, how] = server.variables
    _assert_equal(out["torch", "partial"], out["torch", "direct"])
    _assert_equal(out["torch", "partial"], out["jax", "partial"])
    _assert_equal(out["jax", "partial"], out["jax", "direct"])


def test_spares_close_on_first_k_like_jax():
    """Tolerance: 1e-5.  clients_per_round 2 + 2 spares of 4 over 3 rounds:
    the same reporters, spared nodes and stale spare uploads."""
    p = _problem(num_clients=4, n=320)
    kw = dict(num_clients=4, clients_per_round=2, spares=2)
    t, _ = _federation("torch", p, **kw)
    j, _ = _federation("jax", p, **kw)
    _compare_runs(t, j)
    assert all(len(r.get("spared", [])) == 2 for r in t.round_log if "participants" in r)


def test_deadline_drop_and_stale_reply_like_jax():
    """Tolerance: 1e-5.  Client 2's round-0 upload is held by the chaos
    layer past the bus's quiescence; the 1.5 s deadline closes round 0
    without it, its late upload is stale-rejected, and later rounds
    recover: the same round log and model as JAX's."""

    def plan_for(mod, node):
        if node != 2:
            return None
        return mod.FaultPlan(0, rules=[mod.FaultRule(action="drop", node=2, msg_type=SEND,
                                                     round=0)])

    p = _problem()
    runs = {}
    for side in ("torch", "jax"):
        runs[side], _ = _federation(side, p, plan_for=plan_for, round_timeout=1.5)
        rec = runs[side].round_log[0]
        assert rec["participants"] == [1, 3] and rec["dropped"] == [2]
    _compare_runs(runs["torch"], runs["jax"])
    # a straggler's reply stamped with a closed round
    for side, server in runs.items():
        msg = _side(side)["msg"]
        before = len(server.round_log)
        server._on_model(msg.Message.from_frame_bytes(_upload_msg(
            jmessage, 1, {"params": {"Dense_0": {
                "bias": np.zeros(4, np.float32),
                "kernel": np.full((16, 4), 99.0, np.float32)}}}, 5.0, 0).to_frame()))
        assert server.round_log[before:] == [{"round": 3, "stale_from": 1, "stale_round": 0}]
    _compare_runs(runs["torch"], runs["jax"])


def test_legacy_hot_path_matches_fast_and_jax():
    """Tolerance: 1e-5.  Per-node unicast + buffered aggregation against
    multicast + streaming fold, and against JAX's legacy run."""
    p = _problem(seed=3, partition="homo", momentum=0.0, n=120)
    fast, _ = _federation("torch", p, seed=3)
    legacy, _ = _federation("torch", p, seed=3, multicast=False, streaming_agg=False)
    jlegacy, _ = _federation("jax", p, seed=3, multicast=False, streaming_agg=False)
    _assert_close(fast.variables, legacy.variables)
    _compare_runs(legacy, jlegacy)


def test_nan_upload_rejected_and_counted_like_jax():
    """Tolerance: 1e-5.  The chaos layer NaN-fills client 2's uploads every
    round; each is rejected before the fold and counted."""

    def plan_for(mod, node):
        return (mod.FaultPlan(0, rules=[mod.FaultRule(action="corrupt", node=2,
                                                      msg_type=SEND)])
                if node == 2 else None)

    p = _problem()
    before = get_telemetry().counter_value("faults.observed", kind="corrupt_upload",
                                           msg_type=SEND)
    t, _ = _federation("torch", p, rounds=2, plan_for=plan_for, round_timeout=1.5)
    j, _ = _federation("jax", p, rounds=2, plan_for=plan_for, round_timeout=1.5)
    assert t.rejected_uploads == 2
    assert get_telemetry().counter_value("faults.observed", kind="corrupt_upload",
                                         msg_type=SEND) == before + 2
    _compare_runs(t, j)


def test_qsgd8_ef_uploads_like_jax_and_repeatable():
    """Tolerance: 1e-5 against JAX; none between two port runs (the
    upload digests repeat bit for bit)."""
    p = _problem()
    t, tc = _federation("torch", p, codec="qsgd8")
    t2, tc2 = _federation("torch", p, codec="qsgd8")
    j, _ = _federation("jax", p, codec="qsgd8")
    _compare_runs(t, j)
    assert [c.upload_digest for c in tc] == [c.upload_digest for c in tc2]
    _assert_equal(t.variables, t2.variables)
    assert all(0 in c._ef for c in tc)


def _amnesia_at(round_idx):
    """Wrap a client so it forgets its delta-base cache when the sync of
    ``round_idx`` arrives (the shape of a rejoining process)."""

    def wrap(client):
        if client.backend.node_id != 2:
            return
        handler = client._handlers["S2C_SYNC_MODEL"]
        fired = []

        def forgetful(msg):
            if msg.get("round_idx") == round_idx and not fired:
                fired.append(True)
                client._bases.clear()
            handler(msg)

        client._handlers["S2C_SYNC_MODEL"] = forgetful

    return wrap


def test_delta_broadcast_with_forced_resync_like_jax():
    """Tolerance: none between the port's runs (delta with a resync ==
    delta without == full broadcast on the same qsgd8 chain, JAX's
    pins), 1e-5 against JAX's delta run with the same resync."""
    p = _problem()
    resyncs = get_telemetry().counter_value("comm.delta_resyncs")
    t, _ = _federation("torch", p, rounds=4, bcast="delta", stats_plane=False,
                       wrap_client=_amnesia_at(2))
    assert get_telemetry().counter_value("comm.delta_resyncs") == resyncs + 1
    clean, _ = _federation("torch", p, rounds=4, bcast="delta", stats_plane=False)
    full, _ = _federation("torch", p, rounds=4, bcast_codec="qsgd8", stats_plane=False)
    _assert_equal(t.variables, clean.variables)
    _assert_equal(t.variables, full.variables)
    j, _ = _federation("jax", p, rounds=4, bcast="delta", stats_plane=False,
                       wrap_client=_amnesia_at(2))
    _compare_runs(t, j)


@pytest.mark.parametrize("codec", ["none", "qsgd8"])
def test_async_cut_k_alpha_zero_equals_sync_bitwise(codec):
    """Tolerance: none between the port's async and sync runs; 1e-5
    against JAX's async run."""
    p = _problem()
    sync, _ = _federation("torch", p, codec=codec)
    asyn, _ = _federation("torch", p, codec=codec, round_mode="async", stale_alpha=0.0,
                          cut_size=3)
    _assert_equal(sync.variables, asyn.variables)
    j, _ = _federation("jax", p, codec=codec, round_mode="async", stale_alpha=0.0, cut_size=3)
    _compare_runs(asyn, j)


def test_async_with_a_delayed_client_like_jax():
    """Tolerance: 1e-5.  Cut 2 of 3, max staleness 2, poly alpha 0.5;
    the chaos layer holds each of client 3's uploads until its next one
    is sent, so uploads land one and two rounds stale and fold at weight
    w(d)·n."""

    def plan_for(mod, node):
        return (mod.FaultPlan(0, rules=[mod.FaultRule(action="delay", node=3, msg_type=SEND,
                                                      delay_msgs=1)])
                if node == 3 else None)

    p = _problem()
    tel = get_telemetry()
    before = tel.counter_value("async.stale_weighted_uploads")
    kw = dict(rounds=4, plan_for=plan_for, round_mode="async", cut_size=2, max_staleness=2,
              stale_alpha=0.5, round_timeout=10.0)
    t, _ = _federation("torch", p, **kw)
    j, _ = _federation("jax", p, **kw)
    assert tel.counter_value("async.stale_weighted_uploads") > before
    _compare_runs(t, j)


def test_decode_workers_match_inline():
    """Tolerance: 1e-6 against the inline decode (the fold order may
    differ by a float64 rounding), 1e-5 against JAX's."""
    p = _problem()
    t, _ = _federation("torch", p, decode_workers=2, round_timeout=10.0)
    inline, _ = _federation("torch", p)
    _assert_close(t.variables, inline.variables, dict(rtol=1e-6, atol=1e-6))
    j, _ = _federation("jax", p, decode_workers=2, round_timeout=10.0)
    _assert_close(t.variables, j.variables)
    assert t._decode_pool is not None


def test_defended_run_under_a_scaled_attacker_like_jax():
    """Tolerance: 1e-5.  Client 3 multiplies its uploads by 10 (the chaos
    layer's scale_grad); the streaming defense clips them to the norm
    bound and counts it."""

    def plan_for(mod, node):
        return (mod.FaultPlan(0, rules=[mod.FaultRule(action="scale_grad", node=3,
                                                      msg_type=SEND, attack_scale=10.0)])
                if node == 3 else None)

    p = _problem()
    tel = get_telemetry()
    before = tel.counter_value("robust.clipped_uploads")
    t, _ = _federation("torch", p, plan_for=plan_for,
                       defense=DefenseConfig(defense="streaming", norm_bound=0.5))
    j, _ = _federation("jax", p, plan_for=plan_for,
                       defense=JDefenseConfig(defense="streaming", norm_bound=0.5))
    assert tel.counter_value("robust.clipped_uploads") - before >= 3
    assert [r["defense"] for r in t.round_log] == [r["defense"] for r in j.round_log]
    _compare_runs(t, j)
    tm, _ = _federation("torch", p, plan_for=plan_for, defense={"defense": "median"})
    jm, _ = _federation("jax", p, plan_for=plan_for, defense={"defense": "median"})
    _compare_runs(tm, jm)


def test_stats_plane_status_and_summary_like_jax(tmp_path):
    """Tolerance: none for the summary; the status and report files carry
    JAX's keys.  A client ships a digest frame through ``_on_telemetry``."""
    p = _problem()
    out = {}
    for side in ("torch", "jax"):
        d = tmp_path / side
        dmod = digest if side == "torch" else jdigest

        def wrap(client, dmod=dmod):
            if client.backend.node_id != 1:
                return
            handler = client._handlers["S2C_SYNC_MODEL"]

            def sync_then_report(msg):
                handler(msg)
                dmod.send_digest(client.backend, dmod.registry_digest(
                    node=1, seq=msg.get("round_idx"), t=5.0 + msg.get("round_idx")))

            client._handlers["S2C_SYNC_MODEL"] = sync_then_report

        server, _ = _federation(side, p, status_dir=str(d), slo_spec={"p99_round_wall_s": 60.0},
                                stats_interval=0.1, wrap_client=wrap)
        out[side] = (server.stats_summary(), json.loads((d / "status.json").read_text()),
                     json.loads((d / "slo_report.json").read_text()))
    (ts, tstatus, treport), (js, jstatus, jreport) = out["torch"], out["jax"]
    timing = ("frames",)  # status-loop folds: one per interval, on the wall clock
    assert {k: v for k, v in ts.items() if k not in timing} == \
        {k: v for k, v in js.items() if k not in timing}
    assert ts["enabled"] and ts["streams_remote"] == 1
    assert sorted(tstatus) == sorted(jstatus) and tstatus["finished"] is True
    assert sorted(treport) == sorted(jreport)


# -- mixed federations over frame bytes ----------------------------------------------

def _bridge_backend(base_cls, node_id, bus, foreign_bus, foreign_msg):
    """A backend of one package's bus that owns ``node_id`` there and
    delivers every frame addressed to it onto the other package's bus,
    parsed from its ``to_frame()`` bytes."""

    class Bridge(base_cls):
        def _notify(self, msg, nbytes=None):
            foreign_bus.route(foreign_msg.Message.from_frame_bytes(msg.to_frame()))

    bus.register(node_id)
    return Bridge(node_id, bus)


def _mixed(server_side, p, rounds=3, **server_kw):
    """One side's server, the other side's clients, bridged by frames."""
    client_side = "torch" if server_side == "jax" else "jax"
    ss, cs = _side(server_side), _side(client_side)
    sbus, cbus = ss["bus"](), cs["bus"]()
    server = ss["S"](sbus.register(0), p.jinit if server_side == "jax" else p.tinit,
                     num_clients=3, clients_per_round=3, comm_rounds=rounds, seed=0,
                     steps_per_epoch=p.steps, **server_kw)
    sinproc = jinproc if server_side == "jax" else inproc
    cinproc = jinproc if client_side == "jax" else inproc
    for i in range(1, 4):
        _bridge_backend(sinproc.InprocBackend, i, sbus, cbus, cs["msg"])
    _bridge_backend(cinproc.InprocBackend, 0, cbus, sbus, ss["msg"])
    init, lu, ds = (p.jinit, p.jlu, p.jds) if client_side == "jax" else (p.tinit, p.tlu, p.ds)
    clients = [cs["C"](cbus.register(i), lu, ds, batch_size=16, template_variables=init,
                       seed=0, **cs["ckw"]) for i in range(1, 4)]
    server.start()
    _drive([sbus, cbus], server, rounds)
    assert server.round_idx == rounds
    return server, clients


@pytest.mark.parametrize("server_side", ["jax", "torch"])
@pytest.mark.parametrize("mode", ["plain", "qsgd8_ef_delta"])
def test_mixed_federation_over_frames(server_side, mode):
    """Tolerance: 1e-5 against the all-JAX federation, with the same round
    log (participants), rejections and client round counts."""
    p = _problem()
    kw = {} if mode == "plain" else dict(codec="qsgd8", bcast="delta")
    server, clients = _mixed(server_side, p, **kw)
    ref, ref_clients = _federation("jax", p, **kw)
    _compare_runs(server, ref)
    assert [c.rounds_trained for c in clients] == [c.rounds_trained for c in ref_clients]
