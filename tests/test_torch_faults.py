"""The port's chaos layer (``fedml_tpu_torch/faults``) held against the
JAX package's:

- ``FaultPlan`` and ``TrafficModel`` draw from ``random.Random``: for
  seeds 0-2 they give JAX's decisions, per-message corrupt streams,
  speed classes, digests and JSON exactly;
- ``corrupt_message`` and ``attack_message`` mutate the port's upload
  frames into JAX's bytes (``Message.to_frame``) for fp32 and bf16 raw
  leaves, v1 base64 leaves (fp32 and bf16) and the bf16, qsgd8 and
  topk codec payloads; the original message stays untouched;
- ``ChaosBackend`` on the port's ``InprocBus`` drops, duplicates, delays,
  reorders and corrupts as JAX's does on JAX's bus: the same delivery
  order, the same decision trace, the same ``faults.injected`` counts,
  and per-receiver multicast rules.

Tolerance everywhere: none (exact decisions and bytes).
"""

import random

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import fedml_tpu.comm.inproc as jinproc
import fedml_tpu.comm.message as jmessage
import fedml_tpu.faults as jfaults
import fedml_tpu.faults.traffic as jtraffic
from fedml_tpu.compress import get_codec as jget_codec
from fedml_tpu.obs.telemetry import get_telemetry as jget_telemetry
from fedml_tpu_torch import faults
from fedml_tpu_torch.comm import inproc, message
from fedml_tpu_torch.compress import get_codec
from fedml_tpu_torch.core.rng import PRNGKey
from fedml_tpu_torch.faults import traffic
from fedml_tpu_torch.obs.telemetry import get_telemetry

SEND = "C2S_SEND_MODEL"
SYNC = "S2C_SYNC_MODEL"


def _plan(mod, seed):
    return mod.FaultPlan(
        seed,
        send_spec=mod.FaultSpec(drop_prob=0.2, corrupt_prob=0.1, duplicate_prob=0.15,
                                delay_prob=0.2, reorder_prob=0.05, delay_msgs=2),
        recv_spec=mod.FaultSpec(drop_prob=0.1, delay_prob=0.2),
        rules=[mod.FaultRule(action="drop", node=2, msg_type=SEND, round=1),
               mod.FaultRule(action="scale_grad", node=3, msg_type=SEND,
                             attack_scale=4.0),
               mod.FaultRule(action="corrupt", receiver=2, msg_type=SYNC)],
        crash_at_round={3: 2},
        straggler_sleep_s=0.25,
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fault_plan_decisions_match_jax(seed):
    plan, jplan = _plan(faults, seed), _plan(jfaults, seed)
    assert plan.to_json() == jplan.to_json()
    for node in (0, 1, 2, 3):
        for direction in ("send", "recv"):
            for mt in (SEND, SYNC, "S2C_FINISH", "C2S_TELEMETRY"):
                for seq in range(25):
                    kw = dict(receiver=seq % 4)
                    assert (plan.decide(node, direction, mt, seq, seq % 3, **kw)
                            == jplan.decide(node, direction, mt, seq, seq % 3, **kw))
                assert plan.applies_to(mt) == jplan.applies_to(mt)
    a = plan.rng_for(1, "send", SEND, 7, salt="corrupt")
    b = jplan.rng_for(1, "send", SEND, 7, salt="corrupt")
    assert [a.random() for _ in range(5)] == [b.random() for _ in range(5)]
    back = faults.FaultPlan.from_json(jplan.to_json())
    assert back.to_json() == jplan.to_json()
    assert back.crash_at_round == jplan.crash_at_round == {3: 2}


def _traffic(mod, seed):
    return mod.TrafficModel(seed=seed, jitter_s=0.05, straggler_prob=0.3,
                            straggler_shape=1.1, straggler_scale_s=0.3,
                            straggler_cap_s=2.0, churn_prob=0.1, flap_prob=0.05,
                            diurnal_amplitude=0.5, diurnal_period_rounds=4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_traffic_model_decisions_match_jax(seed):
    tm, jtm = _traffic(traffic, seed), _traffic(jtraffic, seed)
    assert tm.to_json() == jtm.to_json()
    nodes = list(range(1, 17))
    for r in range(6):
        assert tm.diurnal_factor(r) == jtm.diurnal_factor(r)
        for n in nodes:
            assert tm.decide(n, r) == jtm.decide(n, r)
    assert [tm.speed_class(n) for n in nodes] == [jtm.speed_class(n) for n in nodes]
    assert tm.schedule_digest(nodes, 6) == jtm.schedule_digest(nodes, 6)
    assert traffic.TrafficModel.from_json(jtm.to_json()).to_json() == jtm.to_json()
    assert tm.any_traffic() == jtm.any_traffic()


# -- corrupt_message / attack_message on upload frames ------------------------------

_RNG = np.random.RandomState(3)
_TREE = {"params": {"Dense_0": {"bias": _RNG.randn(7).astype(np.float32),
                                "kernel": _RNG.randn(300, 7).astype(np.float32)}},
         "batch_stats": {"BatchNorm_0": {"mean": _RNG.randn(7).astype(np.float32)}},
         "step": np.arange(3, dtype=np.int32)}
_FLOAT_TREE = {k: v for k, v in _TREE.items() if k != "step"}


def _upload_wires(kind):
    """(JAX wire, port wire) of the same upload."""
    if kind == "fp32":
        return (jmessage.tree_to_wire(_TREE),
                message.tree_to_wire(jax.tree_util.tree_map(torch.from_numpy, _TREE)))
    if kind == "bf16":
        jt = jax.tree_util.tree_map(
            lambda l: l.astype(ml_dtypes.bfloat16) if l.dtype == np.float32 else l, _TREE)
        tt = jax.tree_util.tree_map(
            lambda l: torch.from_numpy(l).to(torch.bfloat16) if l.dtype == np.float32
            else torch.from_numpy(l), _TREE)
        return jmessage.tree_to_wire(jt), message.tree_to_wire(tt)
    if kind in ("v1_fp32", "v1_bf16"):
        src = _TREE if kind == "v1_fp32" else jax.tree_util.tree_map(
            lambda l: l.astype(ml_dtypes.bfloat16) if l.dtype == np.float32 else l, _TREE)
        tsrc = jax.tree_util.tree_map(
            lambda l: torch.from_numpy(l) if l.dtype != ml_dtypes.bfloat16
            else torch.from_numpy(l.view(np.int16).copy()).view(torch.bfloat16), src)
        return jmessage.tree_to_wire(src, version=1), message.tree_to_wire(tsrc, version=1)
    name = "bf16" if kind == "bf16_codec" else kind
    return (jmessage.tree_to_wire(_FLOAT_TREE, codec=jget_codec(name),
                                  key=jax.random.PRNGKey(5), delta=True),
            message.tree_to_wire(jax.tree_util.tree_map(torch.from_numpy, _FLOAT_TREE),
                                 codec=get_codec(name), key=PRNGKey(5), delta=True))


KINDS = ["fp32", "bf16", "v1_fp32", "v1_bf16", "bf16_codec", "qsgd8", "topk0.1"]


def _upload_msgs(kind):
    jw, tw = _upload_wires(kind)
    out = []
    for mod, wire in ((jmessage, jw), (message, tw)):
        m = mod.Message(SEND, 3, 0)
        m.add_params(mod.MSG_ARG_KEY_ROUND_INDEX, 2)
        m.add_params(mod.MSG_ARG_KEY_MODEL_PARAMS, wire)
        m.add_params(mod.MSG_ARG_KEY_NUM_SAMPLES, 40.0)
        out.append(m)
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_corrupt_and_attack_give_jax_frames(kind):
    jm, tm = _upload_msgs(kind)
    before = tm.to_frame()
    assert before == jm.to_frame()
    for seed in (0, 1, 2):
        jt = jfaults.corrupt_message(jm, random.Random(seed))
        tt = faults.corrupt_message(tm, random.Random(seed))
        assert (jt is None) == (tt is None)
        if jt is not None:
            assert tt.to_frame() == jt.to_frame()
    for factor in (-1.0, 10.0, 0.3):
        ja, ta = jfaults.attack_message(jm, factor), faults.attack_message(tm, factor)
        assert (ja is None) == (ta is None)
        if ja is not None:
            assert ta.to_frame() == ja.to_frame()
    tm._frame_parts = None
    assert tm.to_frame() == before  # the original payload untouched


def test_corrupted_upload_decodes_non_finite():
    _, tm = _upload_msgs("qsgd8")
    twin = faults.corrupt_message(tm, random.Random(0))
    got = message.tree_from_wire(twin.get(message.MSG_ARG_KEY_MODEL_PARAMS),
                                 jax.tree_util.tree_map(torch.from_numpy, _FLOAT_TREE))
    assert any(not torch.isfinite(l).all() for l in jax.tree_util.tree_leaves(got))


# -- ChaosBackend on the in-process bus ----------------------------------------------

def _exchange(side, seed, n_msgs=30, recv_plan=None):
    """One chaos-wrapped sender, one receiver (itself chaos-wrapped on the
    recv path when ``recv_plan``); returns (delivered ids, trace, injected)."""
    mod, bus_mod, tel = ((jfaults, jinproc, jget_telemetry()) if side == "jax"
                         else (faults, inproc, get_telemetry()))
    msg_mod = jmessage if side == "jax" else message
    bus = bus_mod.InprocBus()
    sender = mod.ChaosBackend(bus.register(1), mod.FaultPlan(seed, send_spec=mod.FaultSpec(
        drop_prob=0.25, duplicate_prob=0.2, delay_prob=0.25, delay_msgs=2,
        reorder_prob=0.1)))
    receiver = bus.register(0)
    if recv_plan:
        receiver = mod.ChaosBackend(receiver, mod.FaultPlan(seed + 7, recv_spec=mod.FaultSpec(
            drop_prob=0.1, delay_prob=0.3, delay_msgs=3)))
    got = []

    class Obs:
        def receive_message(self, t, m):
            got.append(m.get("i"))

    receiver.add_observer(Obs())
    before = {a: tel.counter_value("faults.injected", action=a, msg_type=SEND)
              for a in ("drop", "duplicate", "delay", "reorder")}
    for i in range(n_msgs):
        m = msg_mod.Message(SEND, 1, 0)
        m.add_params("i", i)
        m.add_params("round_idx", i // 5)
        sender.send_message(m)
    bus.drain()
    injected = {a: tel.counter_value("faults.injected", action=a, msg_type=SEND) - v
                for a, v in before.items()}
    traces = list(sender.trace) + (list(receiver.trace) if recv_plan else [])
    return got, traces, injected


@pytest.mark.parametrize("seed,recv", [(0, False), (1, False), (2, True), (13, True)])
def test_chaos_backend_inproc_matches_jax(seed, recv):
    t = _exchange("torch", seed, recv_plan=recv)
    j = _exchange("jax", seed, recv_plan=recv)
    assert t == j
    actions = {a for (_, _, _, acts) in t[1] for a in acts}
    assert "drop" in actions


def _mcast(side, rule_kw):
    mod, bus_mod, msg_mod = ((jfaults, jinproc, jmessage) if side == "jax"
                             else (faults, inproc, message))
    bus = bus_mod.InprocBus()
    inner = bus.register(0)
    got = {1: [], 2: [], 3: []}

    class Obs:
        def __init__(self, i):
            self.i = i

        def receive_message(self, t, m):
            got[self.i].append(m.to_frame())

    for i in (1, 2, 3):
        bus.register(i).add_observer(Obs(i))
    chaos = mod.ChaosBackend(inner, mod.FaultPlan(seed=0, rules=[mod.FaultRule(**rule_kw)],
                                                  roles=("server",)))
    m = msg_mod.Message(SYNC, 0, -1)
    w = np.linspace(-1, 1, 6, dtype=np.float32).reshape(2, 3)
    tree = {"w": w} if side == "jax" else {"w": torch.from_numpy(w)}
    m.add_params(msg_mod.MSG_ARG_KEY_MODEL_PARAMS, msg_mod.tree_to_wire(tree))
    m.add_params(msg_mod.MSG_ARG_KEY_ROUND_INDEX, 0)
    chaos.send_multicast(m, [1, 2, 3])
    bus.drain()
    return got, list(chaos.trace)


@pytest.mark.parametrize("action", ["drop", "corrupt", "duplicate", "scale_grad"])
def test_chaos_multicast_rule_hits_only_its_receiver(action):
    kw = dict(action=action, receiver=2, msg_type=SYNC, direction="send")
    t, j = _mcast("torch", kw), _mcast("jax", kw)
    assert t == j
    counts = {i: len(v) for i, v in t[0].items()}
    assert counts[1] == counts[3] == 1
    assert counts[2] == {"drop": 0, "duplicate": 2}.get(action, 1)
