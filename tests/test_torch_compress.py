"""Update compression in the port (``fedml_tpu_torch/compress`` and the
round engine's codec stage), held against the JAX package
(``fedml_tpu/compress``, ``tests/test_compress.py``) in the same process.

- Codecs, bitwise on ResNet-56's 292 leaves (``resnet56_tpu`` variables,
  a random delta per leaf): per-leaf wire entries, ``wire_tree_digest``,
  ``encoded_nbytes`` and the decoded trees for qsgd8, qsgd4, topk0.01 and
  bf16; the fused ``[M, 256]`` form equals the per-leaf form bitwise.
- Engine: the four engine tests of ``tests/test_compress.py`` (fused =
  dispatch, sampled = dispatch, close to fp32 plus counters,
  checkpoint/resume), bitwise within the port; the port against the JAX
  engine on the same problem, within one quantum per element, with the
  number of elements whose quantized level differs counted and bounded.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu.algorithms.fedavg as jfedavg
import fedml_tpu.compress as jcomp
from fedml_tpu.core.metrics import MetricsLogger as JMetricsLogger
from fedml_tpu.compress import error_feedback as jef
from fedml_tpu.data.synthetic import synthetic_classification as jsynthetic
from fedml_tpu.models.linear import logistic_regression as jlogistic
from fedml_tpu.models.resnet_tpu import resnet56_tpu as jresnet56_tpu
from fedml_tpu.obs.telemetry import Telemetry as JTelemetry
from fedml_tpu_torch import compress as tcomp
from fedml_tpu_torch.algorithms.fedavg import (
    FedAvgConfig,
    FedAvgSimulation,
    make_round_fn,
)
from fedml_tpu_torch.core import rng as rnglib
from fedml_tpu_torch.core.checkpoint import CheckpointManager
from fedml_tpu_torch.core.client import make_client_optimizer, make_local_update
from fedml_tpu_torch.core.metrics import MetricsLogger
from fedml_tpu_torch.data.synthetic import synthetic_classification
from fedml_tpu_torch.experiments import run
from fedml_tpu_torch.models.convert import from_jax_variables
from fedml_tpu_torch.models.linear import logistic_regression
from fedml_tpu_torch.models.resnet_tpu import resnet56_tpu
from fedml_tpu_torch.obs.telemetry import Telemetry

CODECS = ["int8", "int4", "topk0.01", "bf16"]
# ResNet-56's uplink bytes per codec (the JAX package's numbers)
RESNET56_NBYTES = {None: 2_401_256, "int8": 610_346, "int4": 312_525,
                   "topk0.01": 48_904, "bf16": 1_200_628}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes at once, and the tensors here gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def resnet_delta():
    """A random fp32 update shaped like ResNet-56's variables: the flax
    tree (numpy) and the port's tree of the same values."""
    jvars = jax.tree_util.tree_map(np.asarray, jresnet56_tpu().init(jax.random.PRNGKey(0)))
    r = np.random.RandomState(0)
    jd = jax.tree_util.tree_map(
        lambda a: (r.standard_normal(a.shape) * 1e-3).astype(np.float32), jvars)
    return jd, from_jax_variables(jd, device="cpu")


def _flax_paths(tree):
    return [tuple(str(p.key) for p in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_leaf_order_is_jax_tree_leaves_order(resnet_delta):
    """The port's flat dicts are in module order; the codec walks them in
    ``jax.tree_util.tree_leaves`` order (sorted keys at every level)."""
    jd, td = resnet_delta
    order = [p for p, _ in tcomp.jax_leaves(td)]
    assert len(order) == 292
    assert order == _flax_paths(jd)
    assert order[0] == ("batch_stats", "BatchNorm_0", "mean")
    names = [".".join(p) for p in order]
    assert names.index("params.Bottleneck_10.Conv_0.kernel") < \
        names.index("params.Bottleneck_2.Conv_0.kernel")
    # the port's own variables come in module order: walking the dict
    # would feed the leaves the wrong keys
    own = resnet56_tpu(device="cpu").init(rnglib.PRNGKey(0))
    assert [p for p, _ in tcomp.jax_leaves(own)] == order
    assert list(own["params"]) != [".".join(p[1:]) for p in order if p[0] == "params"]


@pytest.mark.parametrize("name", CODECS)
def test_wire_entries_digest_and_nbytes_equal_jax(resnet_delta, name):
    jd, td = resnet_delta
    jw = jcomp.wire_encode_tree(jcomp.get_codec(name), jd, jax.random.PRNGKey(12345))
    tw = tcomp.wire_encode_tree(tcomp.get_codec(name), td, rnglib.PRNGKey(12345))
    assert len(jw) == len(tw) == 292
    for a, b in zip(jw, tw):
        assert a["shape"] == b["shape"] and a["dtype"] == b["dtype"]
        assert sorted(a["enc"]) == sorted(b["enc"])
        for k in a["enc"]:
            ja, ta = np.asarray(a["enc"][k]), np.asarray(b["enc"][k])
            assert ja.shape == ta.shape and ja.dtype.itemsize == ta.dtype.itemsize
            assert ja.tobytes() == ta.tobytes(), (name, k)
    assert jcomp.wire_tree_digest({"leaves": jw}) == tcomp.wire_tree_digest({"leaves": tw})
    nbytes = tcomp.encoded_nbytes(tcomp.get_codec(name), td)
    assert nbytes == jcomp.encoded_nbytes(jcomp.get_codec(name), jd) == RESNET56_NBYTES[name]
    assert sum(np.asarray(v).nbytes for e in tw for v in e["enc"].values()) == nbytes


def test_uncompressed_nbytes_equal_jax(resnet_delta):
    jd, td = resnet_delta
    assert tcomp.encoded_nbytes(None, td) == jcomp.encoded_nbytes(None, jd) \
        == RESNET56_NBYTES[None]


@pytest.mark.parametrize("name", CODECS)
def test_fused_and_per_leaf_roundtrips_equal_jax(resnet_delta, name):
    """``roundtrip_flat`` over the [M, 256] grid = the per-leaf
    ``roundtrip_tree`` = JAX's ``roundtrip_tree`` = the port's decode of
    JAX's wire entries, bit for bit."""
    jd, td = resnet_delta
    tcod, key = tcomp.get_codec(name), rnglib.PRNGKey(777)
    layout = tcomp.FlatLayout(td)
    fused = tcomp.roundtrip_flat(tcod, layout.flatten(td), key, layout)
    per_leaf = layout.flatten(tcomp.roundtrip_tree(tcod, td, key))
    assert torch.equal(fused, per_leaf)
    jrt = jcomp.roundtrip_tree(jcomp.get_codec(name), jd, jax.random.PRNGKey(777))
    want = np.concatenate([np.asarray(v).reshape(-1) for v in jax.tree_util.tree_leaves(jrt)])
    assert np.array_equal(fused.numpy(), want)
    jw = jcomp.wire_encode_tree(jcomp.get_codec(name), jd, jax.random.PRNGKey(777))
    assert torch.equal(layout.flatten(tcomp.wire_decode_tree(tcod, jw, td)), fused)


@pytest.mark.parametrize("n", [1, 7, 255, 256, 257, 1000])
def test_int4_nibble_packing_equals_jax(n):
    x = np.random.RandomState(n).standard_normal(n).astype(np.float32)
    jw = jcomp.wire_encode_tree(jcomp.get_codec("int4"), {"w": x}, jax.random.PRNGKey(1))
    tw = tcomp.wire_encode_tree(tcomp.get_codec("int4"), {"w": torch.from_numpy(x)},
                                rnglib.PRNGKey(1))
    for k in ("q4", "scale", "qn"):
        assert np.asarray(jw[0]["enc"][k]).tobytes() == tw[0]["enc"][k].tobytes()
    dec = tcomp.wire_decode_tree(tcomp.get_codec("int4"), tw, {"w": torch.from_numpy(x)})
    want = jcomp.wire_decode_tree(jcomp.get_codec("int4"), jw, {"w": x})
    assert np.array_equal(dec["w"].numpy(), np.asarray(want["w"]))


def test_topk_ties_keep_the_lower_index_as_jax():
    """Equal magnitudes across the k-th place: JAX's top_k keeps the lower
    index, and so does the port (``torch.topk`` leaves it open)."""
    x = np.array([0.5, -2.0, 1.0, -1.0, 1.0, 2.0, -1.0, 0.25], np.float32)
    for rate in (0.25, 0.5, 0.75):
        jenc = jcomp.get_codec(f"topk{rate}").encode(jnp.asarray(x), None)
        tenc = tcomp.get_codec(f"topk{rate}").encode(torch.from_numpy(x), None)
        assert np.array_equal(np.asarray(jenc["idx"]), tenc["idx"].numpy()), rate
        assert np.array_equal(np.asarray(jenc["val"]), tenc["val"].numpy())


def test_get_codec_registry():
    assert tcomp.get_codec(None) is None and tcomp.get_codec("") is None
    assert tcomp.get_codec("none") is None and tcomp.get_codec("fp32") is None
    for name, want in (("int8", "qsgd8"), ("qsgd8", "qsgd8"), ("int4", "qsgd4"),
                       ("bf16", "bf16"), ("topk", "topk0.01"), ("topk0.1", "topk0.1")):
        assert tcomp.get_codec(name).name == jcomp.get_codec(name).name == want
    with pytest.raises(ValueError, match="unknown codec"):
        tcomp.get_codec("int3")
    with pytest.raises(ValueError, match="topk rate"):
        tcomp.get_codec("topk2")
    assert (tcomp.COMPRESS_STREAM, tcomp.BCAST_STREAM, tcomp.NDARRAY_KEY) == (
        jcomp.COMPRESS_STREAM, jcomp.BCAST_STREAM, "__ndarray__")


def test_error_feedback_equals_jax():
    r = np.random.RandomState(4)
    deltas = [{"a": r.standard_normal((3, 5)).astype(np.float32),
               "b": {"c": r.standard_normal(300).astype(np.float32)}} for _ in range(3)]
    jcod, tcod = jcomp.get_codec("int8"), tcomp.get_codec("int8")
    je, te = jef.ErrorFeedback(), tcomp.ErrorFeedback()
    for i, d in enumerate(deltas):
        jf = je.fold_in(d)
        tf = te.fold_in(jax.tree_util.tree_map(torch.from_numpy, d))
        jdec = jcomp.roundtrip_tree(jcod, jf, jax.random.PRNGKey(i))
        tdec = tcomp.roundtrip_tree(tcod, tf, rnglib.PRNGKey(i))
        je.absorb(jf, jdec)
        te.absorb(tf, tdec)
        for jl, tl in zip(jax.tree_util.tree_leaves(je._residual),
                          [v for _, v in tcomp.jax_leaves(te._residual)]):
            assert np.array_equal(np.asarray(jl), tl.numpy())
    te.reset()
    assert torch.equal(te.fold_in({"a": torch.ones(2)})["a"], torch.ones(2))


# --- the round engine --------------------------------------------------------------

def _problem(num_clients=3, partition="hetero"):
    kw = dict(num_train=80 * num_clients, num_test=40, input_shape=(16,),
              num_classes=4, num_clients=num_clients, partition=partition,
              partition_alpha=0.4, seed=0)
    return (synthetic_classification(**kw), logistic_regression(16, 4, device="cpu"),
            jsynthetic(**kw), jlogistic(16, 4))


def _cfg(num_clients=3, **kw):
    return dict(num_clients=num_clients, clients_per_round=num_clients,
                comm_rounds=3, epochs=1, batch_size=16, lr=0.1, seed=0,
                frequency_of_the_test=100, **kw)


def _sim(ds, bundle, cfg, **kw):
    return FedAvgSimulation(bundle, ds, FedAvgConfig(**cfg), device="cpu",
                            metrics=MetricsLogger(telemetry=Telemetry()), **kw)


def _maxerr(a, b):
    return max((x.float() - y.float()).abs().max().item()
               for (_, x), (_, y) in zip(tcomp.jax_leaves(a), tcomp.jax_leaves(b)))


def test_engine_codec_fused_matches_dispatch():
    ds, bundle, _, _ = _problem()
    cfg = _cfg(compress_codec="int8", compress_ef=True)
    a = _sim(ds, bundle, cfg)
    a.run()
    b = _sim(ds, bundle, cfg)
    b.run_fused()
    assert _maxerr(a.state.variables, b.state.variables) == 0
    assert _maxerr(a.state.residuals, b.state.residuals) == 0
    assert _maxerr(a.state.residuals, {"params": {k: torch.zeros_like(v) for k, v in
                                                  a.state.residuals["params"].items()}}) > 0


def test_engine_codec_sampled_driver_matches_dispatch():
    ds, bundle, _, _ = _problem(num_clients=6, partition="homo")
    cfg = dict(_cfg(num_clients=6, compress_codec="topk0.25", compress_ef=True),
               clients_per_round=2, comm_rounds=5)
    a = _sim(ds, bundle, cfg)
    a.run()
    b = _sim(ds, bundle, cfg)
    b.run_fused_sampled()
    assert _maxerr(a.state.variables, b.state.variables) == 0
    assert _maxerr(a.state.residuals, b.state.residuals) == 0


def test_engine_codec_close_to_fp32_and_counters():
    ds, bundle, _, _ = _problem()
    plain = _sim(ds, bundle, _cfg())
    plain.run()
    comp = _sim(ds, bundle, _cfg(compress_codec="int8", compress_ef=True))
    comp.run()
    d = _maxerr(plain.state.variables, comp.state.variables)
    assert 0 < d < 0.05  # lossy but close
    snap = comp.metrics.telemetry.snapshot()["counters"]
    raw = snap["comm.raw_bytes{msg_type=C2S_SEND_MODEL}"]
    enc = snap["comm.compressed_bytes{msg_type=C2S_SEND_MODEL}"]
    # LR(16,4): 272 raw vs 76 encoded bytes per upload, 3 uploads x 3 rounds
    assert (raw, enc) == (272 * 9, 76 * 9)
    assert enc == snap["comm.recv_bytes{msg_type=C2S_SEND_MODEL}"]
    psnap = plain.metrics.telemetry.snapshot()["counters"]
    assert not any("raw_bytes" in k for k in psnap)


def test_engine_codec_checkpoint_resume_bit_identical(tmp_path):
    """The EF residual store rides ServerState: crash/resume under
    compression continues bit-identically."""
    ds, bundle, _, _ = _problem()
    cfg = _cfg(compress_codec="int8", compress_ef=True)
    full = _sim(ds, bundle, cfg)
    full.run(rounds=4)
    part = _sim(ds, bundle, cfg)
    part.attach_checkpointing(CheckpointManager(str(tmp_path), max_to_keep=2), every=1)
    part.run(rounds=2)
    resumed = _sim(ds, bundle, cfg)
    resumed.attach_checkpointing(CheckpointManager(str(tmp_path)), every=1)
    assert resumed.resume() == 2
    resumed.run(rounds=2)
    assert _maxerr(full.state.variables, resumed.state.variables) == 0
    assert _maxerr(full.state.residuals, resumed.state.residuals) == 0


@pytest.mark.parametrize("codec,ef", [("int8", True), ("int4", False), ("topk0.25", True),
                                      ("bf16", False)])
def test_engine_matches_jax_engine(codec, ef):
    """Three compressed rounds of the port's engine against the JAX
    engine's from the same seed (the same initial model, the same codec
    streams).  The local updates agree to float32 rounding, and a rounding
    difference can move a quantized value by one level, so the variables
    and residuals agree within one quantum (the largest |Δ| per element is
    ``max_scale / levels``; top-k and bf16 within 1e-5), and the number of
    elements that moved is counted and bounded."""
    ds, bundle, jds, jbundle = _problem()
    cfg = _cfg(compress_codec=codec, compress_ef=ef)
    port = _sim(ds, bundle, cfg)
    port.run()
    ref = jfedavg.FedAvgSimulation(jbundle, jds, jfedavg.FedAvgConfig(**cfg),
                                   metrics=JMetricsLogger(telemetry=JTelemetry()))
    ref.run()
    got = [v for _, v in tcomp.jax_leaves(port.state.variables)]
    want = [np.asarray(v) for v in jax.tree_util.tree_leaves(ref.state.variables)]
    levels = {"int8": 127, "int4": 7}.get(codec)
    moved = 0
    for g, w in zip(got, want):
        diff = np.abs(g.numpy() - w)
        if levels:
            quantum = float(np.abs(w).max()) * 2 / levels
            assert diff.max() <= quantum
            moved += int((diff > 1e-5).sum())
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5)
    print(f"{codec}: {moved} of 68 values moved by a quantum")
    assert moved <= 2  # of 68 values; 0 in the runs so far
    if ef:
        for g, w in zip([v for _, v in tcomp.jax_leaves(port.state.residuals)],
                        jax.tree_util.tree_leaves(ref.state.residuals)):
            bound = 2 * float(np.abs(np.asarray(w)).max()) / (levels or 1) + 1e-5
            assert np.abs(g.numpy() - np.asarray(w)).max() <= bound
    pc = port.metrics.telemetry.snapshot()["counters"]
    jc = ref.metrics.telemetry.snapshot()["counters"]
    for k in ("comm.recv_bytes", "comm.raw_bytes", "comm.compressed_bytes"):
        key = k + "{msg_type=C2S_SEND_MODEL}"
        assert pc[key] == jc[key] > 0


def test_round_fn_codec_arguments():
    bundle = logistic_regression(4, 2, device="cpu")
    lu = make_local_update(bundle, make_client_optimizer(), 1)
    with pytest.raises(ValueError, match="needs a codec"):
        make_round_fn(lu, device="cpu", error_feedback=True)
    with pytest.raises(NotImplementedError, match="axis_name"):
        make_round_fn(lu, device="cpu", codec=tcomp.get_codec("int8"), axis_name="dp")


def test_subclass_with_its_own_round_kernel_refuses_compression():
    ds, bundle, _, _ = _problem()

    class OwnKernel(FedAvgSimulation):
        def _build_round_fn(self):
            return make_round_fn(self.local_update, device=self.device)

    with pytest.raises(ValueError, match="own round kernel"):
        OwnKernel(bundle, ds, FedAvgConfig(**_cfg(compress_codec="int8")), device="cpu")
    OwnKernel(bundle, ds, FedAvgConfig(**_cfg()), device="cpu")  # no codec: fine


def test_run_trains_resnet56_with_int8_and_error_feedback(tmp_path):
    """``run.py --compress int8 --compress_ef 1`` end to end on ResNet-56
    (the library-conv baseline) at the smoke cut."""
    out = run.main(["--algorithm", "fedavg", "--dataset", "cifar10", "--ci", "1",
                    "--compress", "int8", "--compress_ef", "1", "--device", "cpu",
                    "--data_augmentation", "0", "--run_dir", str(tmp_path)])
    final = out["final"]
    assert len(out["history"]) == 2 and np.isfinite(final["train_loss"])
    assert np.isfinite(final["test_loss"])
