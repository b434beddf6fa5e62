"""The port's tensor parallelism (``fedml_tpu_torch/parallel/tensor.py``) on
4 gloo CPU ranks, held against the JAX package on the faked 8-device mesh
at ``tests/test_tensor_pipeline.py``'s sizes and tolerances:

- the TP forward against JAX's ``tensor_parallel_lm`` and the plain
  ``bundle.apply_eval`` (1e-4);
- each rank's qkv and MLP-down block equal, in shape and bytes, to the
  ``addressable_shards`` data of JAX's laid-out array at the same mesh
  position (``{(32, 24)}`` for qkv);
- five ``train_step``s against the same five steps of JAX's
  ``tensor_parallel_lm`` and of its single-device oracle
  (``__graft_entry__.py``'s), the loss falling and the layout kept; the
  same with 2 heads on 4 ranks (every rank computes every head); the
  ranks' own gradients of the replicated leaves equal before their mean
  over the axis, and apart when each rank is fed other tokens;
- the divisibility error, JAX's message;
- ``compat.all_gather`` along dimension 1 and ``compat.psum_scatter``
  against closed forms, and the gather's backward: JAX's transpose, the
  cotangents summed over the axis and the rank's chunk kept;
- the gradients of one TP block against closed forms: autograd through the
  whole plain block on one rank, sliced to the rank's chunk, for every
  parameter and the input; a row-parallel sum whose backward psums the
  cotangent (``compat.psum``) multiplies them and fails the same check.

One launch of 4 ranks serves every case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fedml_tpu.parallel.tensor import make_tp_mesh as jtp_mesh
from fedml_tpu.parallel.tensor import tensor_parallel_lm as jtp_lm
from fedml_tpu_torch.parallel.compat import launch
from fedml_tpu_torch.parallel.dryrun import run_cases

RANKS = 4
FWD_TOL = dict(rtol=1e-4, atol=1e-4)
STEP_TOL = dict(rtol=2e-4, atol=2e-5)
QKV = "Block_0.MultiHeadAttention_0.Dense_0.kernel"
DOWN = "Block_0.Dense_1.kernel"
DIMS = dict(vocab_size=64, embed_dim=32, num_layers=1, seq_len=16)
FWD_TOKENS = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0, 64), np.int32)
STEP_TOKENS = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 16), 0, 64), np.int32)
STEPS, LR = 5, 0.5
CASES = {
    "forward": dict(DIMS, num_heads=4, num_layers=2, key=0, tokens=FWD_TOKENS,
                    blocks=[QKV, DOWN]),
    "steps": dict(DIMS, num_heads=4, key=0, tokens=STEP_TOKENS,
                  targets=np.roll(STEP_TOKENS, -1, axis=1), steps=STEPS, lr=LR, single=True),
    "heads2": dict(DIMS, num_heads=2, key=0, tokens=STEP_TOKENS,
                   targets=np.roll(STEP_TOKENS, -1, axis=1), steps=STEPS, lr=LR, single=True),
    "indivisible": dict(DIMS, embed_dim=30, num_heads=5, key=0, tokens=FWD_TOKENS),
    # each rank's tokens rolled by its rank: the ranks' replicated gradients differ
    "skewed": dict(DIMS, num_heads=4, key=0, tokens=STEP_TOKENS, skew=True,
                   targets=np.roll(STEP_TOKENS, -1, axis=1), steps=1, lr=LR),
}
BLOCK_NAMES = ["LayerNorm_0.scale", "LayerNorm_0.bias", "MultiHeadAttention_0.Dense_0.kernel",
               "MultiHeadAttention_0.Dense_1.kernel", "LayerNorm_1.scale", "LayerNorm_1.bias",
               "Dense_0.kernel", "Dense_0.bias", "Dense_1.kernel", "Dense_1.bias"]


def _block_problem(E, seed):
    r = np.random.RandomState(seed)
    shapes = {"LayerNorm_0.scale": (E,), "LayerNorm_0.bias": (E,),
              "MultiHeadAttention_0.Dense_0.kernel": (E, 3 * E),
              "MultiHeadAttention_0.Dense_1.kernel": (E, E), "LayerNorm_1.scale": (E,),
              "LayerNorm_1.bias": (E,), "Dense_0.kernel": (E, 4 * E), "Dense_0.bias": (4 * E,),
              "Dense_1.kernel": (4 * E, E), "Dense_1.bias": (E,)}
    params = {k: (1.0 + 0.1 * r.randn(*s) if k.endswith("scale") else 0.2 * r.randn(*s))
              .astype(np.float32) for k, s in shapes.items()}
    return dict(params=params, x=r.randn(2, 8, E).astype(np.float32),
                cot=r.randn(2, 8, E).astype(np.float32))


GRAD_CASES = {"heads4": dict(embed_dim=32, num_heads=4, **_block_problem(32, 3)),
              "heads2": dict(embed_dim=32, num_heads=2, **_block_problem(32, 4))}


BASE = np.arange(2 * RANKS * 3, dtype=np.float32).reshape(2, RANKS, 3) / 7.0
GATHER_COT = np.random.RandomState(5).randn(2, RANKS * RANKS, 3).astype(np.float32)


@pytest.fixture(scope="module")
def ranks():
    cases = [("tp", dict(device="cpu", **spec)) for spec in CASES.values()]
    cases += [("tp_grads", dict(device="cpu", **spec)) for spec in GRAD_CASES.values()]
    cases.append(("collectives", dict(device="cpu", base=BASE, cot=GATHER_COT)))
    return launch(run_cases, RANKS, cases, device="cpu", timeout=240.0)


def _case(ranks, name, rank=0):
    return ranks[rank][list(CASES).index(name)]


def _jax(name):
    spec = CASES[name]
    mesh = jtp_mesh(RANKS)
    bundle, shard, apply, step = jtp_lm(
        mesh, **{k: spec[k] for k in ("vocab_size", "embed_dim", "num_heads", "num_layers",
                                      "seq_len")})
    return mesh, bundle, shard, apply, step, bundle.init(jax.random.PRNGKey(spec["key"]))


def _by_path(port_vars):
    """A port variables tree (numpy) keyed by JAX's flax paths."""
    return {(c, *k.split(".")): np.asarray(v) for c, sub in port_vars.items()
            for k, v in sub.items()}


def _jax_by_path(tree):
    return {tuple(p.key for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_tp_forward_matches_jax_and_the_plain_model(ranks):
    mesh, bundle, shard, apply, _, variables = _jax("forward")
    want_tp = np.asarray(apply(shard(variables), jnp.asarray(FWD_TOKENS)))
    want = np.asarray(bundle.apply_eval(variables, jnp.asarray(FWD_TOKENS)))
    for r in range(RANKS):
        got = _case(ranks, "forward", r)["logits"]
        np.testing.assert_allclose(got, want, **FWD_TOL)
        np.testing.assert_allclose(got, want_tp, **FWD_TOL)


@pytest.mark.parametrize("name", [QKV, DOWN])
def test_tp_blocks_equal_jax_addressable_shards(ranks, name):
    mesh, _, shard, _, _, variables = _jax("forward")
    leaf = shard(variables)["params"]
    for part in ("Block_0",) + tuple(name.split(".")[1:]):
        leaf = leaf[part]
    devices = list(mesh.devices.flat)
    data = {devices.index(s.device): np.asarray(s.data) for s in leaf.addressable_shards}
    shapes = {tuple(_case(ranks, "forward", r)["blocks"][name].shape) for r in range(RANKS)}
    assert shapes == {d.shape for d in data.values()}
    if name == QKV:
        assert shapes == {(32, 96 // 4)}
    for r in range(RANKS):
        got = _case(ranks, "forward", r)["blocks"][name]
        assert got.dtype == data[r].dtype and got.tobytes() == data[r].tobytes(), r
    assert _case(ranks, "forward")["specs"][QKV] == (None, "tp")
    assert _case(ranks, "forward")["specs"][DOWN] == ("tp", None)


def _jax_steps(name):
    """JAX's five TP train steps and five steps of its single-device oracle."""
    spec = CASES[name]
    _, bundle, shard, _, step, variables = _jax(name)
    tokens, targets = jnp.asarray(spec["tokens"]), jnp.asarray(spec["targets"])

    def oracle_step(v):
        def loss_fn(v):
            logp = jax.nn.log_softmax(bundle.apply_eval(v, tokens).astype(jnp.float32), -1)
            return -jnp.take_along_axis(logp, targets[..., None], axis=-1)[..., 0].mean()

        loss, grads = jax.value_and_grad(loss_fn)(v)
        return jax.tree_util.tree_map(lambda p, g: p - LR * g, v, grads), loss

    tp_vars, oracle_vars, tp_losses, oracle_losses = shard(variables), variables, [], []
    for _ in range(STEPS):
        tp_vars, loss = step(tp_vars, tokens, targets, LR)
        tp_losses.append(float(loss))
        oracle_vars, loss = oracle_step(oracle_vars)
        oracle_losses.append(float(loss))
    return (tp_vars, tp_losses), (oracle_vars, oracle_losses)


@pytest.mark.parametrize("name", ["steps", "heads2"])
def test_tp_train_steps_match_jax_and_its_oracle(ranks, name):
    (tp_vars, tp_losses), (oracle_vars, oracle_losses) = _jax_steps(name)
    qkv_spec = tp_vars["params"]["Block_0"]["MultiHeadAttention_0"]["Dense_0"]["kernel"]
    for r in range(RANKS):
        got = _case(ranks, name, r)
        assert all(np.isfinite(got["losses"])) and got["losses"][-1] < got["losses"][0]
        np.testing.assert_allclose(got["losses"], tp_losses, rtol=1e-4)
        np.testing.assert_allclose(got["losses"], oracle_losses, rtol=1e-4)
        np.testing.assert_allclose(got["losses"], _case(ranks, name)["single"]["losses"],
                                   rtol=1e-4)
        assert got["specs_after"] == got["specs"]
        assert got["specs_after"][QKV] == tuple(qkv_spec.sharding.spec)
        assert got["spread"] == 0.0  # the ranks' replicated gradients agree
        port = _by_path(got["variables"])
        for path, want in _jax_by_path(oracle_vars).items():
            np.testing.assert_allclose(port[path], want, err_msg=str(path), **STEP_TOL)
        for path, want in _jax_by_path(tp_vars).items():
            np.testing.assert_allclose(port[path], want, err_msg=str(path), **STEP_TOL)


def test_tp_replica_spread_sees_ranks_that_disagree(ranks):
    """The control for the spread that the train steps read as 0: ranks
    fed different tokens compute different replicated gradients, which the
    mean over the axis hides and ``REPLICA_SPREAD`` shows."""
    for r in range(RANKS):
        assert _case(ranks, "skewed", r)["spread"] > 0.1


def test_tp_divisibility_error_is_jax_s(ranks):
    _, _, shard, _, _, variables = _jax("indivisible")
    with pytest.raises(ValueError) as jerr:
        shard(variables)
    tail = "should be divisible by 4, but it is equal to 90 (full shape: (30, 90))"
    assert tail in str(jerr.value)
    for r in range(RANKS):
        assert tail in _case(ranks, "indivisible", r)["error"]


@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_tp_block_gradients_equal_the_whole_block_s(ranks, name):
    i = len(CASES) + list(GRAD_CASES).index(name)
    for r in range(RANKS):
        res = ranks[r][i]
        assert set(res["got"]) == set(BLOCK_NAMES)
        for k in BLOCK_NAMES:
            np.testing.assert_allclose(res["got"][k], res["want"][k], rtol=1e-4, atol=1e-5,
                                       err_msg=k)
        np.testing.assert_allclose(res["got_dx"], res["want_dx"], rtol=1e-4, atol=1e-5)
        # the control: a psum-backward row-parallel sum multiplies the
        # gradients behind it by the axis size, and the check catches it
        wrong = [k for k in BLOCK_NAMES
                 if not np.allclose(res["wrong"][k], res["want"][k], rtol=1e-4, atol=1e-5)]
        assert "MultiHeadAttention_0.Dense_0.kernel" in wrong and "Dense_0.kernel" in wrong
        assert not np.allclose(res["wrong_dx"], res["want_dx"], rtol=1e-4, atol=1e-5)


def test_all_gather_along_a_dimension_and_psum_scatter(ranks):
    parts = [(r + 1) * BASE for r in range(RANKS)]
    total = sum(parts)
    for r in range(RANKS):
        res = ranks[r][-1]
        np.testing.assert_array_equal(res["tiled"], np.concatenate(parts, axis=1))
        np.testing.assert_array_equal(res["stacked"], np.stack(parts, axis=1))
        np.testing.assert_allclose(res["scatter"], total[:, r:r + 1], rtol=1e-6)
        np.testing.assert_allclose(res["scatter_untiled"], total[:, r], rtol=1e-6)
        # every rank's loss reads the gathered x with the same cotangent: the
        # psum_scatter transpose hands rank r the axis size times its chunk
        np.testing.assert_allclose(res["grad"], RANKS * GATHER_COT[:, r * RANKS:(r + 1) * RANKS],
                                   rtol=1e-6)
