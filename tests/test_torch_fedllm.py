"""The port's fedllm slice held against the JAX package: FedAvg rounds of
the transformer, the shakespeare data, the experiment entry point and the
``build_fedllm`` workload.

FedAvg setup: a 1-layer transformer (vocab 32, width 16, 2 heads of 8,
L 16), 3 clients x 2 steps x batch 2, fp32, SGD lr 0.05 + momentum 0.9 +
wd 1e-3, ``shuffle=False`` (so client 1's second batch stays pad-only)
and client 2 sits out.  The JAX side
runs ``flash_attn_fn(interpret=True)``, the Pallas kernel's own
arithmetic.  Tolerance rtol/atol 1e-4; the measured max abs difference on
any variable after two rounds is 1.2e-7.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu.algorithms.fedavg as jfedavg
import fedml_tpu.core.client as jclient
import fedml_tpu.data.shakespeare as jshakespeare
from fedml_tpu.models.transformer import transformer_lm as jtransformer_lm
from fedml_tpu.ops.flash_attention import flash_attn_fn as jflash_attn_fn
from fedml_tpu_torch.algorithms.fedavg import ServerState, make_round_fn
from fedml_tpu_torch.core.client import make_client_optimizer, make_local_update
from fedml_tpu_torch.core.rng import PRNGKey
from fedml_tpu_torch.data import shakespeare
from fedml_tpu_torch.experiments import run
from fedml_tpu_torch.models.convert import from_jax_variables, to_jax_variables
from fedml_tpu_torch.models.transformer import transformer_lm

K, STEPS, B, L, V = 3, 2, 2, 16, 32
TOL = {"rtol": 1e-4, "atol": 1e-4}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes at once, and the tiny tensors here gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_rounds():
    jb = jtransformer_lm(vocab_size=V, embed_dim=16, num_heads=2, num_layers=1,
                         seq_len=L, attn_fn=jflash_attn_fn(8, 8, interpret=True))
    jvars = jax.tree_util.tree_map(np.asarray, jb.init(jax.random.PRNGKey(0)))
    rng = np.random.RandomState(0)
    x = rng.randint(0, V, (K, STEPS, B, L)).astype(np.int32)
    y = np.roll(x, -1, axis=-1)
    mask = np.ones((K, STEPS, B), np.float32)
    mask[1, 1] = 0.0                                  # pad-only batch
    ns = mask.sum((1, 2)) * L
    part = np.array([1.0, 1.0, 0.0], np.float32)      # client 2 sits out
    ids = np.arange(K, dtype=np.int32)
    data = (x, y, mask, ns, part, ids)
    jopt = jclient.make_client_optimizer("sgd", 0.05, momentum=0.9,
                                         weight_decay=1e-3)
    jlu = jclient.make_local_update(jb, jopt, 1, shuffle=False)
    state = jfedavg.ServerState(variables=jvars, opt_state=(),
                                round_idx=jnp.zeros((), jnp.int32),
                                key=jax.random.PRNGKey(0))
    round_fn = jax.jit(jfedavg.make_round_fn(jlu))
    rows = []
    for _ in range(2):
        state, m = round_fn(state, *(jnp.asarray(a) for a in data))
        rows.append({k: float(v) for k, v in m.items()})
    return {"jvars": jvars, "data": data, "state": state, "rows": rows}


def test_two_fedavg_rounds_match_jax(jax_rounds):
    bundle = transformer_lm(vocab_size=V, embed_dim=16, num_heads=2,
                            num_layers=1, seq_len=L, device="cpu")
    opt = make_client_optimizer("sgd", 0.05, momentum=0.9, weight_decay=1e-3)
    rf = make_round_fn(make_local_update(bundle, opt, 1, shuffle=False), device="cpu")
    state = ServerState(from_jax_variables(jax_rounds["jvars"], device="cpu"), (), 0,
                        PRNGKey(0))
    data = jax_rounds["data"]
    args = tuple(torch.from_numpy(np.asarray(a)) for a in data[:5]) + (data[5],)
    for r in range(2):
        state, m = rf(state, *args)
        for k, v in jax_rounds["rows"][r].items():
            np.testing.assert_allclose(float(m[k]), v, err_msg=k, **TOL)
    got = jax.tree_util.tree_flatten_with_path(to_jax_variables(state.variables))[0]
    want = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(np.asarray, jax_rounds["state"].variables))[0])
    assert len(got) == len(want)
    for path, leaf in got:
        np.testing.assert_allclose(leaf, want[path], err_msg=str(path), **TOL)
    init = dict(jax.tree_util.tree_flatten_with_path(jax_rounds["jvars"])[0])
    assert max(np.abs(leaf - init[path]).max() for path, leaf in got) > 0


@pytest.mark.parametrize("loader,kw", [
    ("load_shakespeare", {"num_clients": 3, "seed": 1}),
    ("load_shakespeare", {"num_clients": 4, "seed": 2, "standin_peak_eta": 0.2,
                          "standin_test_windows": 20}),
    ("load_fed_shakespeare", {"num_clients": 3, "seed": 3, "windows_per_client": 5}),
])
def test_shakespeare_standins_are_byte_equal_to_jax(tmp_path, loader, kw):
    want = getattr(jshakespeare, loader)(str(tmp_path / "none"), **kw)
    got = getattr(shakespeare, loader)(str(tmp_path / "none"), **kw)
    assert got.name == want.name and got.num_classes == want.num_classes == 90
    for field in ("train_x", "train_y", "test_x", "test_y"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), field
    assert got.test_client_idx is None and want.test_client_idx is None
    assert sorted(got.train_client_idx) == sorted(want.train_client_idx)
    for c in want.train_client_idx:
        assert np.array_equal(got.train_client_idx[c], want.train_client_idx[c])
    assert np.array_equal(shakespeare.encode_text("To be, or not\n"),
                          jshakespeare.encode_text("To be, or not\n"))


def _rows(run_dir):
    with open(run_dir / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("argv", [
    ["--algorithm", "fedllm", "--dataset", "fed_shakespeare"],
    ["--algorithm", "fedavg", "--dataset", "cifar10", "--model", "resnet56",
     "--data_augmentation", "0"],
], ids=["fedllm", "fedavg"])
def test_run_main_on_cpu(tmp_path, argv):
    out = run.main([*argv, "--device", "cpu", "--ci", "1",
                    "--run_dir", str(tmp_path)])
    assert len(out["history"]) == 2
    final = out["final"]
    assert math.isfinite(final["train_loss"]) and math.isfinite(final["test_loss"])
    kinds = [r.get("kind") for r in _rows(tmp_path)]
    assert kinds[0] == "config" and kinds[-1] == "telemetry"
    assert kinds.count(None) == 2  # one row per round


_NOT_PORTED = (NotImplementedError, "ROADMAP")


def _base_framework_runs(tmp_path, monkeypatch, extra):
    """base_framework runs through the entry point (--ci 1: 3 workers, 2
    rounds), its history the template's series."""
    out = run.main([*extra, "--device", "cpu", "--ci", "1", "--run_dir", str(tmp_path)])
    g, want = 0.0, []
    for _ in range(2):
        g = sum(0.5 * g / (i + 1) + (i + 1) * 0.01 for i in range(3))
        want.append(g)
    assert out["history"] == want


def _rule_engine_runs(tmp_path, monkeypatch, extra):
    """fedllm through the rule engine on a 1 x 1 (dp, mp) mesh: finite
    metrics every round."""
    out = run.main([*extra, "--device", "cpu", "--ci", "1", "--run_dir", str(tmp_path)])
    assert out["mesh"] == {"dp": 1, "mp": 1}
    assert all(np.isfinite(row["train_loss"]) for row in out["history"])


def _routes_the_loader(tmp_path, monkeypatch, extra):
    """The dataset loads through the registry (its 224-px stand-in's
    geometry asked of the loader), the model is the JAX registry's for it,
    and it trains unaugmented, as in the JAX entry point."""
    from fedml_tpu.experiments import registry as jregistry
    from fedml_tpu_torch.data import imagenet
    from fedml_tpu_torch.experiments import registry
    from test_torch_imagenet_data import _Recorder

    cfg = run.ExperimentConfig(**dict(zip((a[2:] for a in extra[::2]), extra[1::2])))
    rec = _Recorder()
    monkeypatch.setattr(imagenet, "synthetic_classification", rec)
    ds = registry.load_data(cfg.dataset, "no-such-dir", 3)
    want = {"ILSVRC2012": (1000, 3), "gld23k": (203, 50)}[cfg.dataset]
    assert (ds.num_classes, ds.num_clients) == want
    assert rec.calls[0]["input_shape"] == (224, 224, 3)
    assert run._augment_fn(cfg, ds) is None
    shape = (224, 224, 3)
    bundle = registry.create_model(cfg.model, cfg.dataset, ds.num_classes, input_shape=shape,
                                   device="meta")
    jbundle = jregistry.create_model(cfg.model, cfg.dataset, ds.num_classes, input_shape=shape)
    assert type(bundle.module).__name__ == type(jbundle.module).__name__
    assert tuple(bundle.input_shape) == tuple(jbundle.input_shape) == shape


@pytest.mark.parametrize("extra,refusal", [
    # the whole algorithm family is ported, base_framework (the cross-device
    # runtime's tutorial template) the last of it
    (["--algorithm", "base_framework"], _base_framework_runs),
    # tensor parallelism runs on ranks (tests/test_torch_gspmd.py); a lone
    # process is one rank, and JAX's ValueError says the degree does not fit
    (["--algorithm", "fedllm", "--dataset", "fed_shakespeare", "--tp_degree", "2"],
     (ValueError, "parallel degree 2 does not divide device count 1")),
    # the rule engine runs, on a 1 x 1 mesh in a lone process too
    (["--algorithm", "fedllm", "--dataset", "fed_shakespeare", "--mesh", "1,1"],
     _rule_engine_runs),
    # fedavg compresses now; one-device fedllm does not (nor in JAX, which
    # ignores the flag there)
    (["--algorithm", "fedllm", "--dataset", "fed_shakespeare", "--compress", "int8"],
     _NOT_PORTED),
    # fedavg checkpoints now; fedllm has no checkpoint wiring (nor in JAX)
    (["--algorithm", "fedllm", "--dataset", "fed_shakespeare",
      "--checkpoint_every", "1"], (SystemExit, "no checkpoint wiring")),
    # ImageNet's loader is ported, and ImageNet trains unaugmented
    (["--algorithm", "fedavg", "--dataset", "ILSVRC2012"], _routes_the_loader),
    # every model is routed, on the Landmarks loader too
    (["--algorithm", "fedavg", "--dataset", "gld23k", "--model", "mobilenet"],
     _routes_the_loader),
], ids=["fedprox", "tp", "mesh", "compress", "checkpoint", "augment", "mnist"])
def test_run_refuses_what_is_not_ported(tmp_path, monkeypatch, extra, refusal):
    """Each case a refusal (exception, match), or a route that runs now (a
    check of it)."""
    if callable(refusal):
        refusal(tmp_path, monkeypatch, extra)
        return
    exc, match = refusal
    with pytest.raises(exc, match=match):
        run.main([*extra, "--device", "cpu", "--ci", "1", "--run_dir", str(tmp_path)])


def test_build_fedllm_runs_on_cpu_and_counts_like_the_jax_bench():
    import bench as jbench
    from fedml_tpu_torch.bench import build_fedllm

    kw = dict(clients=2, batch=2, steps=2, seq_len=16, vocab=32, embed_dim=16,
              num_heads=2, num_layers=1, rounds_per_call=2)
    round_fn, state, args, tokens, fpt = build_fedllm(**kw, device="cpu")
    *_, jtokens, jfpt = jbench.build_fedllm(**kw)
    assert (tokens, fpt) == (jtokens, jfpt) == (2 * 2 * 2 * 16 * 2, jfpt)
    before = {k: v.clone() for k, v in state.variables["params"].items()}
    state, metrics = round_fn(state, *args)
    loss = (metrics["loss_sum"] / metrics["count"]).numpy()
    assert loss.shape == (2,) and np.all(np.isfinite(loss))
    assert metrics["count"][0].item() == 2 * 2 * 2 * 16
    assert state.round_idx == 2
    assert max((state.variables["params"][k] - before[k]).abs().max().item()
               for k in before) > 0
