"""The port's message core (``fedml_tpu_torch/comm/{message,backend,inproc,
shm}.py``, ``obs/{telemetry,trace_ctx,comm_obs,flight}.py``,
``analysis/locks.py``) held against the JAX package's:

- ``Message`` JSON lines and binary frames byte for byte on the same
  params, both ways (the port's frame parsed by JAX's ``from_frame_bytes``
  and JAX's by the port's): fp32, int and bf16 leaves (numpy's, JAX's and
  torch's), nested arrays, 0-d leaves (shape ``[1]`` on a frame, as JAX's
  ``ascontiguousarray`` writes them) and numpy scalars;
- wiretrees v1, v2 and codec-encoded (qsgd8 with a key and ``delta``, and
  bf16, qsgd4 and topk), byte for byte, ``wire_tree_digest`` equal, and
  each side decoding the other's;
- ResNet-56's variables (flax's init carried across by ``models/convert``)
  on the wire in JAX's leaf order: the port's frame is JAX's, and each side
  decodes the other's into its own tree exactly;
- ``tensor_to_list``/``list_to_tensor`` round trips, with and without a
  template; ``from_frame_bytes`` refusing a truncated frame;
- the ``InprocBus`` under the same scripted traffic in both packages, a
  quiesce hook re-enqueueing held messages: the same deliveries in the
  same order, the same telemetry counters (``message_nbytes``); trace
  stamping on the bus; the flight recorder's comm ring;
- ``parse_metric_key``, ``make_lock``/``assert_held``, the lock-order graph.
"""

import hashlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import fedml_tpu.analysis.locks as jlocks
import fedml_tpu.comm.backend as jbackend
import fedml_tpu.comm.inproc as jinproc
import fedml_tpu.comm.message as jmessage
import fedml_tpu.obs.comm_obs as jcomm_obs
import fedml_tpu.obs.telemetry as jtelemetry
from fedml_tpu.compress import get_codec as jget_codec
from fedml_tpu.compress import wire_tree_digest as jwire_tree_digest
from fedml_tpu.models.resnet import resnet56 as jresnet56
from fedml_tpu_torch.analysis import locks
from fedml_tpu_torch.comm import backend, inproc, message
from fedml_tpu_torch.compress import get_codec, wire_tree_digest
from fedml_tpu_torch.core.rng import PRNGKey
from fedml_tpu_torch.models.convert import from_jax_variables
from fedml_tpu_torch.obs import comm_obs, flight, telemetry, trace_ctx

_RNG = np.random.RandomState(0)
_F32 = _RNG.randn(3, 4).astype(np.float32)
_I32 = _RNG.randint(-9, 9, (5,)).astype(np.int32)
_BF = _RNG.randn(2, 3).astype(np.float32)


def _params(side):
    """The same message params as the JAX package (``"jax"``) and the port
    (``"torch"``) hold them: leaves as JAX arrays or torch tensors."""
    if side == "jax":
        f32, i32, bf, zero = (jnp.asarray(_F32), jnp.asarray(_I32),
                              jnp.asarray(_BF).astype(jnp.bfloat16), jnp.asarray(2.5))
    else:
        f32, i32, bf, zero = (torch.from_numpy(_F32), torch.from_numpy(_I32),
                              torch.from_numpy(_BF).to(torch.bfloat16), torch.tensor(2.5))
    return {
        "fp32": f32, "int": i32, "bf16": bf, "zero_d": zero,
        "nested": {"a": [np.arange(3.0), {"b": np.int64(4)}], "c": np.zeros((), np.float32),
                   "d": [f32, (i32, "text")]},
        "scalars": [np.float32(0.5), np.int32(3), 1.25, True, None],
        "numpy_bf16": np.asarray(_BF).astype(ml_dtypes.bfloat16) if side == "jax" else bf,
    }


_KEYS = ["fp32", "int", "bf16", "zero_d", "nested", "scalars", "numpy_bf16"]


def _msg(mod, side, key):
    return mod.Message("T", 2, 0).add_params(key, _params(side)[key]).add_params(
        mod.MSG_ARG_KEY_ROUND_INDEX, 3)


@pytest.mark.parametrize("key", _KEYS)
def test_frames_and_json_are_jaxs(key):
    jm, pm = _msg(jmessage, "jax", key), _msg(message, "torch", key)
    assert pm.to_frame() == jm.to_frame()
    assert pm.to_json() == jm.to_json()


def _leaves_equal(a, b):
    """A decoded leaf of each side (numpy, JAX's ml_dtypes bf16, torch bf16)
    equal in value, dtype name and shape."""
    if isinstance(a, torch.Tensor):
        assert a.dtype == torch.bfloat16 and str(np.asarray(b).dtype) == "bfloat16"
        a = a.float().numpy()
    b = np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b.astype(np.float32) if b.dtype.name == "bfloat16" else b)


def _tree_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _tree_equal(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _tree_equal(x, y)
    elif isinstance(a, (np.ndarray, torch.Tensor)) or hasattr(b, "dtype"):
        _leaves_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("key", _KEYS)
@pytest.mark.parametrize("path", ["frame", "json"])
def test_each_side_parses_the_others(key, path):
    jm, pm = _msg(jmessage, "jax", key), _msg(message, "torch", key)
    if path == "frame":
        got = message.Message.from_frame_bytes(jm.to_frame())
        want = jmessage.Message.from_frame_bytes(pm.to_frame())
    else:
        got = message.Message.from_json(jm.to_json())
        want = jmessage.Message.from_json(pm.to_json())
    _tree_equal(got.params, want.params)


def _trees():
    jtree = {"params": {"Dense_0": {"kernel": jnp.asarray(_F32), "bias": jnp.asarray(_I32)},
                        "A": {"x": jnp.asarray(_BF).astype(jnp.bfloat16)}},
             "batch_stats": {"B": {"mean": jnp.asarray(_F32[0])}}}
    ptree = {"params": {"Dense_0.kernel": torch.from_numpy(_F32),
                        "Dense_0.bias": torch.from_numpy(_I32),
                        "A.x": torch.from_numpy(_BF).to(torch.bfloat16)},
             "batch_stats": {"B.mean": torch.from_numpy(_F32[0].copy())}}
    return jtree, ptree


_WIRES = [
    ("v1", dict(version=1), dict(version=1)),
    ("v2", {}, {}),
    ("qsgd8_delta", dict(codec="qsgd8", key=3, delta=True), dict(codec="qsgd8", key=3,
                                                                  delta=True)),
    ("qsgd4", dict(codec="qsgd4", key=5), dict(codec="qsgd4", key=5)),
    ("bf16", dict(codec="bf16", key=0), dict(codec="bf16", key=0)),
    ("topk", dict(codec="topk0.5", key=1), dict(codec="topk0.5", key=1)),
]


def _wire(mod, tree, kw):
    kw = dict(kw)
    if "codec" in kw:
        jax_side = mod is jmessage
        kw["codec"] = (jget_codec if jax_side else get_codec)(kw["codec"])
        kw["key"] = jax.random.PRNGKey(kw["key"]) if jax_side else PRNGKey(kw["key"])
    return mod.tree_to_wire(tree, **kw)


@pytest.mark.parametrize("name,jkw,pkw", _WIRES, ids=[w[0] for w in _WIRES])
def test_wiretrees_are_jaxs_both_ways(name, jkw, pkw):
    jtree, ptree = _trees()
    jw, pw = _wire(jmessage, jtree, jkw), _wire(message, ptree, pkw)
    assert wire_tree_digest(pw) == jwire_tree_digest(jw)
    jf = jmessage.Message("U", 1, 0).add_params("model_params", jw).to_frame()
    pf = message.Message("U", 1, 0).add_params("model_params", pw).to_frame()
    assert pf == jf
    assert (message.Message("U", 1, 0).add_params("model_params", pw).to_json()
            == jmessage.Message("U", 1, 0).add_params("model_params", jw).to_json())
    got = message.tree_from_wire(message.Message.from_frame_bytes(jf).get("model_params"),
                                 ptree)
    want = jmessage.tree_from_wire(jmessage.Message.from_frame_bytes(pf).get("model_params"),
                                   jtree)
    assert message.tree_is_delta(pw) == jmessage.tree_is_delta(jw) == ("delta" in name)
    assert message.tree_codec_name(pw) == jmessage.tree_codec_name(jw)
    flat = {"params.Dense_0.kernel": want["params"]["Dense_0"]["kernel"],
            "params.Dense_0.bias": want["params"]["Dense_0"]["bias"],
            "params.A.x": want["params"]["A"]["x"],
            "batch_stats.B.mean": want["batch_stats"]["B"]["mean"]}
    for key, w in flat.items():
        c, k = key.split(".", 1)
        g = got[c][k]
        assert isinstance(g, torch.Tensor) and g.shape == tuple(np.shape(w))
        if "codec" in pkw:  # decoded updates are fp32 in both packages
            assert g.dtype == torch.float32 and np.asarray(w).dtype == np.float32
        else:  # the template's dtype
            assert g.dtype == ptree[c][k].dtype
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32))


def test_tree_from_wire_takes_the_templates_device_dtype_and_numpy_leaves():
    _, ptree = _trees()
    wire = message.tree_to_wire(ptree)
    like = {c: {k: v.to(torch.float64) for k, v in sub.items()} for c, sub in ptree.items()}
    back = message.tree_from_wire(wire, like)
    assert all(v.dtype == torch.float64 for sub in back.values() for v in sub.values())
    np_like = {c: {k: np.zeros(tuple(v.shape), np.float32) for k, v in sub.items()}
               for c, sub in ptree.items()}
    back = message.tree_from_wire(wire, np_like)
    np.testing.assert_array_equal(back["params"]["A.x"],
                                  ptree["params"]["A.x"].float().numpy())
    # a single array is a one-leaf tree
    one = message.tree_from_wire(message.tree_to_wire(torch.arange(4)), torch.zeros(4))
    assert torch.equal(one, torch.arange(4.0))


@pytest.fixture(scope="module")
def resnet_variables():
    jvars = jresnet56(10).init(jax.random.PRNGKey(0))
    host = jax.tree_util.tree_map(np.asarray, jvars)
    return jvars, from_jax_variables(host, device="cpu")


@pytest.mark.parametrize("version", [1, 2])
def test_resnet56_travels_in_jaxs_leaf_order(resnet_variables, version):
    jvars, pvars = resnet_variables
    jw, pw = jmessage.tree_to_wire(jvars, version=version), message.tree_to_wire(
        pvars, version=version)
    jf = jmessage.Message("U", 1, 0).add_params("model_params", jw).to_frame()
    pf = message.Message("U", 1, 0).add_params("model_params", pw).to_frame()
    assert hashlib.sha256(pf).digest() == hashlib.sha256(jf).digest()
    assert wire_tree_digest(pw) == jwire_tree_digest(jw)
    got = message.tree_from_wire(message.Message.from_frame_bytes(jf).get("model_params"),
                                 pvars)
    for c, sub in pvars.items():
        for k, v in sub.items():
            assert torch.equal(got[c][k], v), (c, k)
    want = jmessage.tree_from_wire(jmessage.Message.from_frame_bytes(pf).get("model_params"),
                                   jvars)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree_util.tree_leaves(jvars)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))


def test_tensor_to_list_round_trips():
    _, ptree = _trees()
    lists = message.tensor_to_list(ptree)
    assert lists["params"]["Dense_0.bias"] == _I32.tolist()
    back = message.list_to_tensor(lists, like=ptree)
    for c, sub in ptree.items():
        for k, v in sub.items():
            assert back[c][k].dtype == v.dtype and torch.equal(back[c][k], v)
    # without a template: float32 numpy arrays, as the JAX package's
    jtree, _ = _trees()
    jlists = jmessage.tensor_to_list(jtree)
    assert jlists["params"]["Dense_0"]["kernel"] == lists["params"]["Dense_0.kernel"]
    plain = message.list_to_tensor(lists)
    want = jmessage.list_to_tensor(jlists)
    np.testing.assert_array_equal(plain["params"]["A.x"], want["params"]["A"]["x"])
    assert plain["params"]["A.x"].dtype == np.float32


def test_from_frame_bytes_refuses_a_truncated_frame():
    frame = _msg(message, "torch", "fp32").to_frame()
    for mod in (message, jmessage):
        with pytest.raises(ValueError, match="truncated"):
            mod.Message.from_frame_bytes(frame[:-1])
        with pytest.raises(ValueError, match="no header line"):
            mod.Message.from_frame_bytes(b'{"msg_type": "T"}')
        # a memoryview frame decodes as bytes do
        got = mod.Message.from_frame_bytes(memoryview(frame))
        np.testing.assert_array_equal(np.asarray(got.get("fp32")), _F32)


# --- the in-process bus ------------------------------------------------------

def _scripted(b, ip, m, tel, nodes=4, rounds=3):
    """Scripted traffic on one package's bus: the server pings every client
    each round; a client answers the server and gossips to its neighbour;
    the server starts the next round when every answer is in.  A quiesce
    hook holds client 2's answers and releases them one drain later.
    Returns the delivery log and the bus's comm counters."""
    tel.get_telemetry().reset()
    log = []
    bus = ip.InprocBus()

    class Server(b.NodeManager):
        def __init__(self, backend):
            self.round, self.got = 0, set()
            super().__init__(backend)

        def register_message_receive_handlers(self):
            self.register_message_receive_handler("PONG", self.on_pong)

        def start(self):
            for n in range(1, nodes):
                self.send_message(m.Message("PING", 0, n).add_params("round_idx", self.round))

        def on_pong(self, msg):
            log.append((0, msg.type, msg.sender, msg.get("round_idx")))
            self.got.add(msg.sender)
            if len(self.got) == nodes - 1:
                self.got.clear()
                self.round += 1
                if self.round < rounds:
                    self.start()
                else:
                    for n in range(1, nodes):
                        self.send_message(m.Message("STOP", 0, n))
                    self.finish()

    class Client(b.NodeManager):
        def register_message_receive_handlers(self):
            self.register_message_receive_handler("PING", self.on_ping)
            self.register_message_receive_handler("GOSSIP", self.on_gossip)
            self.register_message_receive_handler("STOP", lambda msg: self.finish())

        def on_ping(self, msg):
            me, r = self.backend.node_id, msg.get("round_idx")
            log.append((me, msg.type, msg.sender, r))
            pong = m.Message("PONG", me, 0).add_params("round_idx", r).add_params(
                "payload", np.full((me, 2), r, np.float32))
            if me == 2:
                held.append(pong)
            else:
                self.send_message(pong)
            self.send_message(m.Message("GOSSIP", me, me % (nodes - 1) + 1)
                              .add_params("round_idx", r))

        def on_gossip(self, msg):
            log.append((self.backend.node_id, msg.type, msg.sender, msg.get("round_idx")))

    held = []
    server = Server(bus.register(0))
    clients = [Client(bus.register(n)) for n in range(1, nodes)]

    def release():
        if not held:
            return False
        clients[1].send_message(held.pop(0))
        return True

    bus.add_quiesce_hook(release)
    server.start()
    delivered = bus.drain()
    return log, delivered, {k: v for k, v in tel.get_telemetry().snapshot()["counters"].items()
                            if k.startswith("comm.")}


def test_inproc_bus_delivers_jaxs_order():
    got = _scripted(backend, inproc, message, telemetry)
    want = _scripted(jbackend, jinproc, jmessage, jtelemetry)
    assert got == want
    log, delivered, counters = got
    # every logged delivery, and the three STOPs
    assert delivered == len(log) + 3 and counters["comm.recv_msgs{msg_type=PONG}"] == 9.0
    # the held answers arrive after the round's gossip, one drain later
    assert log.index((0, "PONG", 2, 0)) > log.index((1, "GOSSIP", 3, 0))


def test_message_nbytes_is_jaxs():
    for key in _KEYS:
        for version in (1, 2):
            assert (comm_obs.message_nbytes(_msg(message, "torch", key), version)
                    == jcomm_obs.message_nbytes(_msg(jmessage, "jax", key), version)), key
    _, ptree = _trees()
    jtree, _ = _trees()
    pm = message.Message("U", 1, 0).add_params("model_params", message.tree_to_wire(ptree))
    jm = jmessage.Message("U", 1, 0).add_params("model_params", jmessage.tree_to_wire(jtree))
    assert comm_obs.message_nbytes(pm) == jcomm_obs.message_nbytes(jm)


def test_trace_stamps_and_flight_ring_on_the_bus():
    trace_ctx.set_enabled(True)
    try:
        telemetry.get_telemetry().reset()
        rec = flight.get_recorder()
        before = len(rec._rings["comm"])
        bus = inproc.InprocBus()
        seen = []

        class Sink(backend.NodeManager):
            def register_message_receive_handlers(self):
                self.register_message_receive_handler("X", seen.append)

        Sink(bus.register(1))
        sender = bus.register(0)
        sender.send_message(message.Message("X", 0, 1).add_params("round_idx", 4))
        bus.drain()
        ctx = seen[0].get(trace_ctx.TRACE_KEY)
        assert [h[1] for h in ctx["hops"]] == ["send", "recv", "done"]
        assert (ctx["org"], ctx["rnd"]) == (0, 4)
        hops = [e for e in telemetry.get_telemetry().drain_events() if e["kind"] == "trace_hop"]
        assert len(hops) == 1 and hops[0]["msg_type"] == "X"
        assert len(rec._rings["comm"]) >= min(before + 2, rec._rings["comm"].maxlen)
    finally:
        trace_ctx.set_enabled(None)


# --- telemetry keys and locks -------------------------------------------------

@pytest.mark.parametrize("key", ["span.round_s", "comm.sent_bytes{msg_type=S2C_SYNC_MODEL}",
                                 "a.b{k=v,z=1}", "odd{", "x{novalue}"])
def test_parse_metric_key_is_jaxs(key):
    assert telemetry.parse_metric_key(key) == jtelemetry.parse_metric_key(key)
    name, labels = telemetry.parse_metric_key(key)
    if labels:
        assert telemetry.metric_key(name, labels) == key


def test_checked_locks_record_order_and_ownership():
    locks.set_enabled(True)
    jlocks.set_enabled(True)
    try:
        locks.reset()
        a, b = locks.make_lock("A"), locks.make_lock("B")
        assert isinstance(a, locks.CheckedLock)
        with pytest.raises(locks.LockDisciplineError, match="without holding"):
            locks.assert_held(a, "the fold")
        with a:
            locks.assert_held(a)
            with pytest.raises(locks.LockDisciplineError, match="recursive"):
                a.acquire()
            with b:
                pass
        assert locks.lock_order_edges() == {("A", "B")}
        locks.assert_acyclic()
        with b:
            with a:
                pass
        assert locks.find_cycle() in (["A", "B", "A"], ["B", "A", "B"])
        with pytest.raises(locks.LockDisciplineError, match="cycle"):
            locks.assert_acyclic()
        with pytest.raises(locks.LockDisciplineError, match="does not hold"):
            a.release()
    finally:
        locks.reset()
        locks.set_enabled(None)
        jlocks.set_enabled(None)
    plain = locks.make_lock("C")
    assert not isinstance(plain, locks.CheckedLock)
    locks.assert_held(plain)  # a plain lock: a no-op, as in JAX
