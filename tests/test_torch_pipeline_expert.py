"""The port's pipeline and expert parallelism (``fedml_tpu_torch/parallel/
{pipeline,expert}.py``) and ``compat.all_to_all`` on 4 gloo CPU ranks, held
against the JAX package on the faked 8-device mesh at
``tests/test_tensor_pipeline.py``'s sizes and tolerances:

- ``make_gpipe`` over ``_mlp_stage``: the forward at 1e-5 against JAX's
  pipeline and ``serial_reference``, the stage gradients of an MSE loss at
  rtol 1e-4 / atol 1e-5 against ``jax.grad`` through JAX's pipeline;
- a pipeline of stages of two narrow ``Block``s (width 32, 4 heads)
  against JAX's ``make_gpipe`` over flax ``Block``s, forward and backward,
  the parameters carried over by ``models/convert.py``;
- the MoE with no drops at rtol 1e-5 / atol 1e-6; the capacity-drop case
  (rows {0, 8, 16, 24} survive); its gradients (gate, ``w_in``, ``w_out``,
  tokens) against ``jax.grad`` of JAX's ``make_moe_ffn``;
- ``init_moe_params`` bit for bit JAX's from the same key;
- both ``ValueError``s of each module, with JAX's messages;
- the dryrun's pp and ep parts (``dryrun.check_parts``), and the port's
  dryrun pipeline gradient against JAX's on the same draws;
- ``compat.all_to_all``'s value and backward against ``lax.all_to_all``
  under ``shard_map``.

One launch of 4 ranks serves every case.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from fedml_tpu.models.transformer import Block as JBlock
from fedml_tpu.parallel import expert as jexpert
from fedml_tpu.parallel import pipeline as jpipe
from fedml_tpu.parallel.compat import shard_map as jshard_map
from fedml_tpu_torch.models.convert import from_jax_tree, to_jax_tree
from fedml_tpu_torch.parallel.compat import launch
from fedml_tpu_torch.parallel.dryrun import check_parts, dryrun_cases, run_cases

RANKS = 4
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
MOE_TOL = dict(rtol=1e-5, atol=1e-6)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _mlp_stage(params, x):  # tests/test_tensor_pipeline.py's
    h = jnp.tanh(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"] + x


def _random_stages(key, num_stages, feat, hidden):
    stages = []
    for s in range(num_stages):
        k1, k2, key = jax.random.split(jax.random.fold_in(key, s), 3)
        stages.append({"w1": jax.random.normal(k1, (feat, hidden)) * 0.3,
                       "b1": jnp.zeros((hidden,)),
                       "w2": jax.random.normal(k2, (hidden, feat)) * 0.3,
                       "b2": jnp.zeros((feat,))})
    return stages


class _JStage(fnn.Module):
    """Two flax ``Block``s: the JAX side of the port's ``BlockStage``."""

    @fnn.compact
    def __call__(self, x):
        for _ in range(2):
            x = JBlock(num_heads=4)(x)
        return x


MLP_FWD = jpipe.stack_stage_params(_random_stages(jax.random.PRNGKey(0), RANKS, 8, 16))
MLP_X = jax.random.normal(jax.random.PRNGKey(1), (6, 3, 8))
MLP_GRAD = jpipe.stack_stage_params(_random_stages(jax.random.PRNGKey(2), RANKS, 8, 16))
MLP_GX = jax.random.normal(jax.random.PRNGKey(3), (5, 2, 8))
MLP_TARGET = jax.random.normal(jax.random.PRNGKey(4), (5, 2, 8))
BLOCK_X = jax.random.normal(jax.random.PRNGKey(5), (3, 2, 8, 32)) * 0.5
BLOCK_TARGET = jax.random.normal(jax.random.PRNGKey(6), (3, 2, 8, 32))
BLOCK_STACKED = jpipe.stack_stage_params([
    _JStage().init(jax.random.fold_in(jax.random.PRNGKey(7), s), BLOCK_X[0])["params"]
    for s in range(RANKS)])

MOE = jexpert.init_moe_params(jax.random.PRNGKey(0), RANKS, d_model=8, d_hidden=16)
MOE_X = jax.random.normal(jax.random.PRNGKey(1), (32, 8))
# every token steered to expert 0 (positive inputs, a gate whose column 0
# is 50): with capacity 1 only each rank's first local token survives
DROP_GATE = jnp.zeros((8, 4)).at[:, 0].set(50.0)
DROP_X = jnp.abs(jax.random.normal(jax.random.PRNGKey(1), (32, 8))) + 0.1
GRAD_CAP = 3
MOE_COT = jax.random.normal(jax.random.PRNGKey(8), (32, 8))

A2A_X = np.arange(16 * 8 * 4, dtype=np.float32).reshape(16, 8, 4) / 100.0
A2A_AXES = [(0, 0), (1, 2), (2, 0), (1, 1)]


def _a2a_out_shape(split_axis, concat_axis):
    shape = [4, 8, 4]  # a rank's block
    shape[split_axis] //= RANKS
    shape[concat_axis] *= RANKS
    shape[0] *= RANKS  # the blocks along dimension 0
    return shape


A2A_COTS = [np.random.RandomState(9 + i).randn(*_a2a_out_shape(*ax)).astype(np.float32)
            for i, ax in enumerate(A2A_AXES)]

DRYRUN = [c for c in dryrun_cases(RANKS, "cpu") if c[0] in ("pp", "ep")]

CASES = {
    "mlp_fwd": ("pp", dict(stage="mlp", stacked=_np(MLP_FWD), x=np.asarray(MLP_X),
                           reference=True, refusal=True)),
    "mlp_grad": ("pp", dict(stage="mlp", stacked=_np(MLP_GRAD), x=np.asarray(MLP_GX),
                            target=np.asarray(MLP_TARGET), grads=True, reference=True)),
    "blocks": ("pp", dict(stage="blocks", blocks=(32, 4, 2),
                          stacked={k: v.numpy() for k, v in
                                   from_jax_tree(_np(BLOCK_STACKED), "cpu").items()},
                          x=np.asarray(BLOCK_X), target=np.asarray(BLOCK_TARGET),
                          grads=True, reference=True)),
    "moe": ("ep", dict(params=_np(MOE), x=np.asarray(MOE_X), capacity=8, reference=True,
                       refusals=True)),
    "moe_drop": ("ep", dict(params={**_np(MOE), "gate": np.asarray(DROP_GATE)},
                            x=np.asarray(DROP_X), capacity=1)),
    "moe_grad": ("ep", dict(params=_np(MOE), x=np.asarray(MOE_X), capacity=GRAD_CAP,
                            cot=np.asarray(MOE_COT))),
    "moe_init": ("ep", dict(key=0, d_model=8, d_hidden=16, x=np.asarray(MOE_X), capacity=8)),
    "a2a": ("a2a", dict(x=A2A_X, axes=A2A_AXES, cots=A2A_COTS)),
}


@pytest.fixture(scope="module")
def ranks():
    cases = [(kind, dict(device="cpu", **spec)) for kind, spec in CASES.values()]
    return launch(run_cases, RANKS, cases + DRYRUN, device="cpu", timeout=240.0)


def _case(ranks, name, rank=0):
    return ranks[rank][list(CASES).index(name)]


@pytest.fixture(scope="module")
def pp_mesh():
    return jpipe.make_pp_mesh(RANKS)


@pytest.fixture(scope="module")
def ep_mesh():
    return jexpert.make_ep_mesh(RANKS)


def _jax_stage_grads(mesh, stage_fn, stacked, x, target):
    apply = jpipe.make_gpipe(mesh, stage_fn)

    def loss(p):
        return jnp.mean((apply(p, x) - target) ** 2)

    return _np(jax.grad(loss)(jpipe.shard_stage_params(mesh, stacked)))


def test_gpipe_forward_matches_jax_and_serial(ranks, pp_mesh):
    want = np.asarray(jpipe.make_gpipe(pp_mesh, _mlp_stage)(
        jpipe.shard_stage_params(pp_mesh, MLP_FWD), MLP_X))
    np.testing.assert_allclose(want, np.asarray(jpipe.serial_reference(
        _mlp_stage, MLP_FWD, MLP_X)), **FWD_TOL)
    for r in range(RANKS):
        np.testing.assert_allclose(_case(ranks, "mlp_fwd", r)["out"], want, **FWD_TOL)
    np.testing.assert_allclose(_case(ranks, "mlp_fwd")["reference"]["out"], want, **FWD_TOL)


def test_gpipe_backward_matches_jax_grad(ranks, pp_mesh):
    want = _jax_stage_grads(pp_mesh, _mlp_stage, MLP_GRAD, MLP_GX, MLP_TARGET)
    for r in range(RANKS):
        got = _case(ranks, "mlp_grad", r)["grads"]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k][r], err_msg=f"{k} stage {r}", **GRAD_TOL)
    serial = _case(ranks, "mlp_grad")["reference"]["grads"]
    for k in want:
        np.testing.assert_allclose(serial[k], want[k], err_msg=k, **GRAD_TOL)


def test_gpipe_of_transformer_blocks_matches_jax(ranks, pp_mesh):
    def stage_fn(p, h):
        return _JStage().apply({"params": p}, h)

    want_out = np.asarray(jpipe.make_gpipe(pp_mesh, stage_fn)(
        jpipe.shard_stage_params(pp_mesh, BLOCK_STACKED), BLOCK_X))
    want = _jax_stage_grads(pp_mesh, stage_fn, BLOCK_STACKED, BLOCK_X, BLOCK_TARGET)
    want = {k: v.numpy() for k, v in from_jax_tree(want, "cpu").items()}
    for r in range(RANKS):
        res = _case(ranks, "blocks", r)
        np.testing.assert_allclose(res["out"], want_out, rtol=1e-4, atol=1e-5)
        assert set(res["grads"]) == set(want) and len(want) == 20
        for k in want:
            np.testing.assert_allclose(res["grads"][k], want[k][r], err_msg=f"{k} stage {r}",
                                       **GRAD_TOL)
    # the converter's way back gives flax's tree
    back = to_jax_tree(from_jax_tree(_np(BLOCK_STACKED), "cpu"))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(
        _np(BLOCK_STACKED))


def test_gpipe_stage_count_refusal_is_jax_s(ranks, pp_mesh):
    apply = jpipe.make_gpipe(pp_mesh, _mlp_stage)
    extra = jax.tree_util.tree_map(lambda a: jnp.concatenate([a, a]), MLP_FWD)
    with pytest.raises(ValueError) as jerr:
        apply(extra, MLP_X)
    for r in range(RANKS):
        assert _case(ranks, "mlp_fwd", r)["refusal"] == str(jerr.value)


def _moe_global(ranks, name):
    return np.concatenate([_case(ranks, name, r)["out"] for r in range(RANKS)])


def test_moe_matches_jax_and_serial_when_no_drops(ranks, ep_mesh):
    apply = jexpert.make_moe_ffn(ep_mesh, capacity=8)
    want = np.asarray(apply(jexpert.shard_moe_params(ep_mesh, MOE), MOE_X))
    got = _moe_global(ranks, "moe")
    np.testing.assert_allclose(got, want, **MOE_TOL)
    np.testing.assert_allclose(got, np.asarray(jexpert.moe_reference(MOE, MOE_X)), **MOE_TOL)
    np.testing.assert_allclose(_case(ranks, "moe")["reference"], want, **MOE_TOL)
    np.testing.assert_allclose(_case(ranks, "moe")["dense"], want, **MOE_TOL)


def test_moe_capacity_drops_zero_out(ranks):
    out = _moe_global(ranks, "moe_drop")
    nonzero_rows = (np.abs(out) > 1e-9).any(axis=1)
    assert nonzero_rows.sum() == 4  # one surviving token per rank
    assert set(np.where(nonzero_rows)[0]) == {0, 8, 16, 24}


def test_moe_gradients_match_jax_grad(ranks, ep_mesh):
    apply = jexpert.make_moe_ffn(ep_mesh, capacity=GRAD_CAP)

    def loss(params, x):
        return (apply(params, x) * MOE_COT).sum()

    gp, gx = jax.grad(loss, argnums=(0, 1))(jexpert.shard_moe_params(ep_mesh, MOE), MOE_X)
    gp, gx = _np(gp), np.asarray(gx)
    # capacity 3 of 8 local tokens drops some: the drop path is in the check
    assert (np.abs(_moe_global(ranks, "moe_grad")) < 1e-9).all(axis=1).any()
    for r in range(RANKS):
        got = _case(ranks, "moe_grad", r)["grads"]
        np.testing.assert_allclose(got["gate"], gp["gate"], **GRAD_TOL)
        np.testing.assert_allclose(got["w_in"][0], gp["w_in"][r], **GRAD_TOL)
        np.testing.assert_allclose(got["w_out"][0], gp["w_out"][r], **GRAD_TOL)
        np.testing.assert_allclose(got["x"], gx[r * 8:(r + 1) * 8], **GRAD_TOL)


def test_init_moe_params_is_jax_s_bit_for_bit(ranks):
    got = _case(ranks, "moe_init")["params"]
    assert set(got) == set(MOE)
    for k, v in _np(MOE).items():
        assert got[k].dtype == v.dtype and got[k].tobytes() == v.tobytes(), k


def test_moe_refusals_are_jax_s(ranks, ep_mesh):
    apply = jexpert.make_moe_ffn(ep_mesh, capacity=8)
    extra = {k: (v if k == "gate" else jnp.concatenate([v, v])) for k, v in MOE.items()}
    want = []
    for args in ((extra, MOE_X), (MOE, MOE_X[:-1])):
        with pytest.raises(ValueError) as jerr:
            apply(*args)
        want.append(str(jerr.value))
    for r in range(RANKS):
        assert _case(ranks, "moe", r)["refusals"] == want


def test_dryrun_pp_and_ep_parts(ranks):
    n = len(CASES)
    summary = check_parts(DRYRUN, [rank[n:] for rank in ranks])
    assert summary["parts"] == ["pp", "ep"]
    # the dryrun draws JAX's numbers (``__graft_entry__.py``'s pp part)
    stages = [{"w": jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(2), s), (8, 8))
               * 0.2} for s in range(RANKS)]
    xmb = jax.random.normal(jax.random.PRNGKey(3), (RANKS + 2, 2, 8))
    mesh = jpipe.make_pp_mesh(RANKS)
    apply = jpipe.make_gpipe(mesh, lambda p, h: jnp.tanh(h @ p["w"]) + h)
    want = jax.grad(lambda p: (apply(p, xmb) ** 2).mean())(
        jpipe.shard_stage_params(mesh, jpipe.stack_stage_params(stages)))["w"]
    np.testing.assert_array_equal(DRYRUN[0][1]["x"], np.asarray(xmb))
    for r in range(RANKS):
        np.testing.assert_allclose(ranks[r][n]["grads"]["w"], np.asarray(want[r]), **GRAD_TOL)


def test_all_to_all_value_and_backward_match_lax(ranks):
    mesh = Mesh(np.array(jax.devices()[:RANKS]), ("x",))
    for i, (split_axis, concat_axis) in enumerate(A2A_AXES):
        fn = jshard_map(lambda b: lax.all_to_all(b, "x", split_axis, concat_axis, tiled=True),
                        mesh=mesh, in_specs=P("x"), out_specs=P("x"))
        want = np.asarray(fn(A2A_X))
        want_g = np.asarray(jax.grad(lambda x: (fn(x) * A2A_COTS[i]).sum())(A2A_X))
        got = np.concatenate([ranks[r][list(CASES).index("a2a")]["pairs"][i]["y"]
                              for r in range(RANKS)])
        got_g = np.concatenate([ranks[r][list(CASES).index("a2a")]["pairs"][i]["grad"]
                                for r in range(RANKS)])
        np.testing.assert_array_equal(got, want, err_msg=str((split_axis, concat_axis)))
        np.testing.assert_array_equal(got_g, want_g, err_msg=str((split_axis, concat_axis)))
