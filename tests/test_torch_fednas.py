"""FedNAS (``fedml_tpu_torch/algorithms/fednas.py``, ``models/darts/``) held
against the JAX package on the CPU, on the same numpy data and seeds, at
the JAX tests' small geometry (DARTS C 4, 2 layers, 8×8 images, 2 steps;
the search network over 3 layers, so that a normal cell runs too).  The
unrolled gradient, the rounds and the entry point run one reduction cell
of one step (``ROUND_NET``): XLA's compile of a JAX search round grows
with the cell count: on an 8-core x86 CPU ~70 s at the JAX tests'
geometry for ``arch_order`` 2, ~10 s at this one.

- Every DARTS op and ``MixedOp``: flax's init bit for bit, and the forward
  in train and eval mode, with the updated ``batch_stats``, within 1e-5.
- ``SearchNetwork`` (init and alphas bit for bit) and ``NetworkCIFAR``
  forwards within 1e-5; ``genotype_from_alphas`` equal.
- ``darts_unrolled_alpha_grad`` on one batch within 1e-5 (and apart from
  the first-order gradient).
- One search round at ``arch_order`` 1 (a sampled cohort, a pad-only
  batch) and 2 (2 epochs on the cosine schedule, per-client test shards
  as the valid queue): variables, alphas and metrics within 1e-4.
- ``fednas_train_stage`` for one round, and ``run.main --algorithm fednas
  --stage train`` with both packages' search net cut to this geometry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms import fedavg as jfedavg
from fedml_tpu.algorithms import fednas as jfednas
from fedml_tpu.core.losses import masked_softmax_ce as jce
from fedml_tpu.core.types import FedDataset as JFedDataset
from fedml_tpu.data.synthetic import synthetic_classification as jsynthetic
from fedml_tpu.experiments import run as jrun
from fedml_tpu.models.darts import genotypes as jgeno
from fedml_tpu.models.darts import ops as jops
from fedml_tpu.models.darts import search as jsearch
from fedml_tpu_torch.algorithms import fednas
from fedml_tpu_torch.algorithms.fedavg import FedAvgConfig
from fedml_tpu_torch.core import rng
from fedml_tpu_torch.core.losses import masked_softmax_ce
from fedml_tpu_torch.core.types import FedDataset
from fedml_tpu_torch.experiments import run
from fedml_tpu_torch.models.base import ModelBundle
from fedml_tpu_torch.models.convert import from_jax_variables, to_jax_variables
from fedml_tpu_torch.models.darts import genotypes, ops, search
from fedml_tpu_torch.models.darts.network import darts_network
from fedml_tpu_torch.models.darts.search import darts_search

CPU = torch.device("cpu")
TOL = {"rtol": 1e-5, "atol": 1e-5}
ROUND_TOL = {"rtol": 1e-4, "atol": 1e-4}
TINY = dict(C=4, num_classes=3, layers=2, image_size=8, steps=2, multiplier=2)
ROUND_NET = dict(TINY, layers=1, steps=1, multiplier=1)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_tree_close(got, want, tol=TOL, exact=False):
    flat_t, flat_j = _flat(got), _flat(want)
    assert sorted(flat_t) == sorted(flat_j) and flat_j
    for path, leaf in flat_j.items():
        if exact:
            np.testing.assert_array_equal(flat_t[path], leaf, err_msg=path)
        else:
            np.testing.assert_allclose(flat_t[path], leaf, err_msg=path, **tol)


def _alphas_np(alphas):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in alphas.items()}


def _x(shape, seed=0):
    return np.random.RandomState(seed).normal(size=shape).astype(np.float32)


# -- the ops ---------------------------------------------------------------------------

_OP_CASES = ([(name, stride) for name in ops.PRIMITIVES for stride in (1, 2)]
             + [("mixed", 1), ("mixed", 2), ("factorized_reduce", 2), ("relu_conv_bn", 1)])


def _op_pair(name, stride, C):
    if name == "mixed":
        return jsearch.MixedOp(C, stride), search.MixedOp(C, stride)
    if name == "factorized_reduce":
        return jops.FactorizedReduce(C, affine=False), ops.FactorizedReduce(C, C, affine=False)
    if name == "relu_conv_bn":
        return jops.ReLUConvBN(C, 1, 1), ops.ReLUConvBN(C, C, 1, 1)
    return jops.OPS[name](C, stride, True), ops.OPS[name](C, stride, True)


@pytest.mark.parametrize("name,stride", _OP_CASES, ids=[f"{n}-s{s}" for n, s in _OP_CASES])
def test_darts_op_matches_flax(name, stride):
    """Train and eval forward on flax's variables (running stats moved off
    their init so eval mode normalizes by them), and the new batch_stats."""
    C = 4
    jmod, tmod = _op_pair(name, stride, C)
    x = _x((3, 8, 8, C))
    args = (jnp.asarray(_x((len(ops.PRIMITIVES),), 1)),) if name == "mixed" else ()
    targs = tuple(torch.from_numpy(np.array(a)) for a in args)
    jv = jax.tree_util.tree_map(np.asarray, jmod.init(jax.random.PRNGKey(5), jnp.asarray(x),
                                                       *args, train=False))
    bundle = ModelBundle(tmod, (8, 8, C), CPU)
    if jv:
        _assert_tree_close(to_jax_variables(bundle.init(rng.PRNGKey(5))), jv, exact=True)
    if "batch_stats" in jv:  # move the running stats off (0, 1)
        jv["batch_stats"] = jax.tree_util.tree_map(
            lambda a: (a + 0.3 * np.abs(_x(a.shape, 2))).astype(np.float32),
            jv["batch_stats"])
    tv = from_jax_variables(jv, device=CPU) if jv else {}

    def port(train):
        updates = {}
        state = {**tv.get("params", {}), **tv.get("batch_stats", {})}
        out = torch.func.functional_call(tmod, state, (torch.from_numpy(x), *targs),
                                         {"train": train, "updates": updates})
        return out, updates

    jout, jnew = jmod.apply(jv, jnp.asarray(x), *args, train=True, mutable=["batch_stats"])
    tout, tnew = port(True)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), **TOL)
    if "batch_stats" in jv:
        _assert_tree_close(to_jax_variables({"batch_stats": tnew}),
                           {"batch_stats": jnew["batch_stats"]})
    else:
        assert not tnew
    np.testing.assert_allclose(port(False)[0].detach().numpy(),
                               np.asarray(jmod.apply(jv, jnp.asarray(x), *args, train=False)),
                               **TOL)


# -- the networks --------------------------------------------------------------------

def test_search_network_matches_flax():
    """Over 3 layers: a normal cell, then two reduction cells."""
    net = dict(TINY, layers=3)
    jb, tb = jsearch.darts_search(**net), darts_search(**net, device=CPU)
    jv = jb.init(jax.random.PRNGKey(0))
    tv = tb.init(rng.PRNGKey(0))
    _assert_tree_close(to_jax_variables(tv), jv, exact=True)
    ja = jb.init_alphas(jax.random.fold_in(jax.random.PRNGKey(0), 1))
    ta = tb.init_alphas(rng.fold_in(rng.PRNGKey(0), 1))
    _assert_tree_close(_alphas_np(ta), ja, exact=True)
    assert ta["alphas_normal"].shape == (search.num_edges(2), len(ops.PRIMITIVES))
    x = _x((4, 8, 8, 3))
    jl, jn = jb.apply_train(jv, ja, jnp.asarray(x))
    tl, tn = tb.apply_train(tv, ta, torch.from_numpy(x))
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **TOL)
    _assert_tree_close(to_jax_variables(tn), jn)
    np.testing.assert_allclose(tb.apply_eval(tn, ta, torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jb.apply_eval(jn, ja, jnp.asarray(x))), **TOL)


def test_fixed_network_matches_flax():
    """DARTS-V2 over 3 layers: a normal cell, then two reduction cells, so
    every preprocessing path and both cell kinds run."""
    from fedml_tpu.models.darts.network import darts_network as jnetwork

    jb = jnetwork(jgeno.DARTS_V2, C=4, num_classes=3, layers=3, image_size=8)
    tb = darts_network(genotypes.DARTS_V2, C=4, num_classes=3, layers=3, image_size=8,
                       device=CPU)
    jv, tv = jb.init(jax.random.PRNGKey(1)), tb.init(rng.PRNGKey(1))
    _assert_tree_close(to_jax_variables(tv), jv, exact=True)
    x = _x((4, 8, 8, 3))
    jl, jn = jb.apply_train(jv, jnp.asarray(x))
    tl, tn = tb.apply_train(tv, torch.from_numpy(x))
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **TOL)
    _assert_tree_close(to_jax_variables(tn), jn)
    np.testing.assert_allclose(tb.apply_eval(tn, torch.from_numpy(x)).numpy(),
                               np.asarray(jb.apply_eval(jn, jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("steps,multiplier", [(2, 2), (4, 4), (3, 2)])
def test_genotype_from_alphas_equals_jax(steps, multiplier):
    r = np.random.RandomState(steps)
    n = search.num_edges(steps)
    an, ar = (r.normal(size=(n, len(ops.PRIMITIVES))).astype(np.float32) for _ in range(2))
    an[0, 0] = 9.0  # a strong 'none', which the parse never picks
    got = genotypes.genotype_from_alphas(an, ar, steps, multiplier)
    want = jgeno.genotype_from_alphas(an, ar, steps, multiplier)
    assert [list(f) for f in got] == [list(f) for f in want]
    assert all(op != "none" for op, _ in got.normal + got.reduce)


# -- the second-order architect gradient ----------------------------------------------

def test_unrolled_alpha_grad_matches_jax():
    """One train and one valid batch, a live momentum buffer, η 0.05."""
    jb, tb = jsearch.darts_search(**ROUND_NET), darts_search(**ROUND_NET, device=CPU)
    jv = jax.tree_util.tree_map(np.asarray, jb.init(jax.random.PRNGKey(2)))
    ja = jb.init_alphas(jax.random.PRNGKey(3))
    r = np.random.RandomState(0)
    buf = {k: (0.01 * r.normal(size=v.shape)).astype(np.float32) for k, v in
           _flat(jv["params"]).items()}
    (bx, vx) = (_x((6, 8, 8, 3), s) for s in (4, 5))
    by, vy = r.randint(0, 3, 6).astype(np.int32), r.randint(0, 3, 6).astype(np.int32)
    bm = np.array([1, 1, 1, 1, 0, 0], np.float32)
    vm = np.ones(6, np.float32)
    kw = dict(eta=0.05, momentum=0.9, weight_decay=3e-4)

    def jgrad(params, alphas, jbuf):
        others = {"batch_stats": jv["batch_stats"]}
        tl = lambda p, a: jce(jb.apply_train({**others, "params": p}, a, bx)[0], by, bm)[0]
        vl = lambda p, a: jce(jb.apply_train({**others, "params": p}, a, vx)[0], vy, vm)[0]
        return jfednas.darts_unrolled_alpha_grad(tl, vl, params, alphas, buf=jbuf, **kw)

    want = jax.jit(jgrad)(jv["params"], ja, _unflatten_like(jv["params"], buf))

    tv = from_jax_variables(jv, device=CPU)
    ta = {k: torch.from_numpy(np.asarray(v)) for k, v in ja.items()}
    tbuf = {k.replace("/", "."): torch.from_numpy(v) for k, v in buf.items()}
    others = {"batch_stats": tv["batch_stats"]}
    t = {k: torch.from_numpy(a) for k, a in (("bx", bx), ("by", by), ("bm", bm), ("vx", vx),
                                              ("vy", vy), ("vm", vm))}
    got = fednas.darts_unrolled_alpha_grad(
        lambda p, a: masked_softmax_ce(tb.apply_train({**others, "params": p}, a, t["bx"])[0],
                                       t["by"], t["bm"])[0],
        lambda p, a: masked_softmax_ce(tb.apply_train({**others, "params": p}, a, t["vx"])[0],
                                       t["vy"], t["vm"])[0],
        tv["params"], ta, buf=tbuf, **kw)
    _assert_tree_close(_alphas_np(got), want)
    # the implicit term is there: the first-order gradient differs
    with torch.enable_grad():
        a = {k: v.clone().requires_grad_(True) for k, v in ta.items()}
        loss = masked_softmax_ce(tb.apply_train(tv, a, t["vx"])[0], t["vy"], t["vm"])[0]
        direct = torch.autograd.grad(loss, list(a.values()), allow_unused=True,
                                     materialize_grads=True)
    gap = max(float((g - d).abs().max()) for g, d in zip(got.values(), direct))
    assert gap > 1e-4


def _unflatten_like(tree, flat, prefix=""):
    return {k: (_unflatten_like(v, flat, f"{prefix}{k}/") if isinstance(v, dict)
                else flat[prefix + k]) for k, v in tree.items()}


# -- the search round ----------------------------------------------------------------

def _round_dataset(per_client_test: bool):
    """Three clients of 10, 5 and 9 samples at batch 6: 2 steps a round,
    client 1's second batch all padding."""
    jds = jsynthetic(num_train=24, num_test=18, input_shape=(8, 8, 3), num_classes=3,
                     num_clients=3, partition="homo", seed=0)
    idx = {0: np.arange(0, 10), 1: np.arange(10, 15), 2: np.arange(15, 24)}
    test_idx = {0: np.arange(0, 6), 1: np.arange(6, 12), 2: np.arange(12, 18)}
    arrays = dict(train_x=np.asarray(jds.train_x), train_y=np.asarray(jds.train_y),
                  test_x=np.asarray(jds.test_x), test_y=np.asarray(jds.test_y),
                  train_client_idx=idx, num_classes=3,
                  test_client_idx=test_idx if per_client_test else None)
    return JFedDataset(**arrays), FedDataset(**arrays)


_ROUND_CASES = {
    1: dict(num_clients=3, clients_per_round=2, epochs=1, per_client_test=False),
    2: dict(num_clients=3, clients_per_round=3, epochs=2, per_client_test=True),
}


@pytest.fixture(scope="module", params=[1, 2], ids=["order1", "order2"])
def search_round(request):
    """One search round of both packages from the same init."""
    order = request.param
    case = dict(_ROUND_CASES[order])
    jds, tds = _round_dataset(case.pop("per_client_test"))
    cfg = dict(comm_rounds=1, batch_size=6, lr=0.05, lr_min=0.01, arch_lr=3e-3,
               arch_order=order, seed=1, **case)
    js = jfednas.FedNASSearch(jsearch.darts_search(**ROUND_NET), jds,
                              jfednas.FedNASConfig(**cfg))
    ts = fednas.FedNASSearch(darts_search(**ROUND_NET, device=CPU), tds,
                             fednas.FedNASConfig(**cfg), device=CPU)
    init = (to_jax_variables(ts.variables), _alphas_np(ts.alphas))
    jinit = (js.state.variables, js.state.alphas)
    return {"order": order, "ts": ts, "js": js, "init": init, "jinit": jinit,
            "trow": ts.run_round(), "jrow": js.run_round(),
            "teval": ts.evaluate_global(), "jeval": js.evaluate_global()}


def test_search_round_matches_jax(search_round):
    ts, js = search_round["ts"], search_round["js"]
    # the weights and the alphas start as flax's, bit for bit
    _assert_tree_close(search_round["init"][0], search_round["jinit"][0], exact=True)
    _assert_tree_close(search_round["init"][1], search_round["jinit"][1], exact=True)
    _assert_tree_close(to_jax_variables(ts.variables), js.state.variables, ROUND_TOL)
    _assert_tree_close(_alphas_np(ts.alphas), js.state.alphas, ROUND_TOL)
    trow, jrow = search_round["trow"], search_round["jrow"]
    assert sorted(trow) == sorted(jrow)
    for k in jrow:
        np.testing.assert_allclose(trow[k], jrow[k], err_msg=k, **ROUND_TOL)
    for k, v in search_round["jeval"].items():
        np.testing.assert_allclose(search_round["teval"][k], v, err_msg=k, **ROUND_TOL)
    assert ts.genotype() == tuple(genotypes.Genotype(*js.genotype()))
    # the alphas of the net's one (reduction) cell moved
    assert not np.allclose(_alphas_np(ts.alphas)["alphas_reduce"],
                           search_round["init"][1]["alphas_reduce"])


def test_search_refuses_an_unknown_arch_order():
    _, tds = _round_dataset(False)
    with pytest.raises(ValueError, match="arch_order"):
        fednas.FedNASSearch(darts_search(**TINY, device=CPU), tds,
                            fednas.FedNASConfig(arch_order=3), device=CPU)


def test_cosine_epoch_schedule_equals_jax():
    want = jfednas.cosine_epoch_schedule(0.05, 0.01, 3, 4)
    got = fednas.cosine_epoch_schedule(0.05, 0.01, 3, 4)
    for count in range(14):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-7)
    assert fednas.cosine_epoch_schedule(0.05, 0.01, 1, 4) == 0.05


# -- the train stage and the entry point ----------------------------------------------

def test_train_stage_matches_jax():
    """DARTS-V2 at C 4 over 2 layers, 2 clients, 2 epochs on the cosine
    schedule, one round."""
    jds, tds = _round_dataset(False)
    kw = dict(num_clients=3, clients_per_round=3, comm_rounds=1, epochs=2, batch_size=6,
              lr=0.05, momentum=0.9, weight_decay=3e-4, grad_clip=5.0, seed=2,
              frequency_of_the_test=1)
    geo = dict(C=4, layers=2, image_size=8, lr_min=0.01)
    jsim = jfednas.fednas_train_stage(jgeno.DARTS_V2, jds, jfedavg.FedAvgConfig(**kw), **geo)
    tsim = fednas.fednas_train_stage(genotypes.DARTS_V2, tds, FedAvgConfig(**kw), device=CPU,
                                     **geo)
    _assert_tree_close(to_jax_variables(tsim.state.variables), jsim.state.variables,
                       exact=True)
    trow, jrow = tsim.run()[-1], jsim.run()[-1]
    for k in ("train_loss", "train_acc", "test_acc", "test_loss"):
        np.testing.assert_allclose(trow[k], jrow[k], err_msg=k, **ROUND_TOL)
    _assert_tree_close(to_jax_variables(tsim.state.variables), jsim.state.variables, ROUND_TOL)


def test_run_main_fednas_matches_jax(tmp_path, monkeypatch):
    """Both stages through both entry points on the CIFAR-10 stand-in
    (--ci 1: 3 clients of 16, batch 8, 2 rounds), the search net of both
    packages cut to ``ROUND_NET`` and the train-stage net to C 4 over 2
    layers (the entry point's C 8 over 4 layers runs on the card)."""
    geo = dict(C=4, layers=ROUND_NET["layers"], steps=ROUND_NET["steps"],
               multiplier=ROUND_NET["multiplier"])
    monkeypatch.setattr(jsearch, "darts_search",
                        lambda num_classes=10, image_size=32, in_channels=3, **_:
                        jsearch.SearchBundle(
                            jsearch.SearchNetwork(num_classes=num_classes, **geo),
                            (image_size, image_size, in_channels)))
    monkeypatch.setattr(search, "darts_search",
                        lambda num_classes=10, image_size=32, in_channels=3, device=None, **_:
                        darts_search(num_classes=num_classes, image_size=image_size,
                                     in_channels=in_channels, device=device, **geo))
    jnet, tnet = jfednas.darts_network, fednas.darts_network
    monkeypatch.setattr(jfednas, "darts_network",
                        lambda genotype, **kw: jnet(genotype, **{**kw, "C": 4, "layers": 2}))
    monkeypatch.setattr(fednas, "darts_network",
                        lambda genotype, **kw: tnet(genotype, **{**kw, "C": 4, "layers": 2}))
    argv = ["--algorithm", "fednas", "--stage", "train", "--ci", "1", "--lr", "0.02"]
    want = jrun.main([*argv, "--run_dir", str(tmp_path / "jax")])
    got = run.main([*argv, "--device", "cpu", "--run_dir", str(tmp_path / "port")])
    assert got["genotype"] == want["genotype"]
    for key in ("history", "train_history"):
        assert len(got[key]) == len(want[key]) == 2
        for r, (t, j) in enumerate(zip(got[key], want[key])):
            for k in j:
                if not k.startswith("time_"):
                    np.testing.assert_allclose(t[k], j[k], err_msg=f"{key} {r} {k}",
                                               **ROUND_TOL)
