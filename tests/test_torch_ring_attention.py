"""The port's ring attention and sequence parallelism
(``fedml_tpu_torch/parallel/{ring_attention,sequence}.py``, ``TransformerLM``'s
``pos_offset_fn``) held against the JAX package on the CPU, with JAX's
tolerances (``tests/test_ring_attention.py``):

- ``blockwise_attention`` causal and not, with ragged blocks, and
  ``dense_attention`` (2e-5), in one process;
- ``ring_attention`` on 8 gloo ranks and with ragged shards on 4, and
  ``ring_flash_attention`` on 8 with ``block=8`` (the flash op's plain
  version on a CPU tensor), against JAX's rings on the faked 8-device mesh
  (the flash ring in interpret mode) and dense attention (2e-5);
- the gradients of both rings on 4 ranks against each other and against
  JAX's (rtol 3e-4, atol 3e-5): the K/V cotangents cross the ring through
  ``compat.ppermute``'s backward;
- ``sequence_parallel_lm``, lax and flash, against JAX's and the plain
  module (3e-4), every rank holding the same gathered logits; its three
  ValueErrors; ``ring_flash_attention``'s refusal of a shard with no block;
- ``TransformerLM`` with a ``pos_offset_fn`` against JAX's, in one process.

One launch of 8 ranks and one of 4 (``compat.launch``) serve the ring cases.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from fedml_tpu.models.transformer import TransformerLM as JTransformerLM
from fedml_tpu.parallel import ring_attention as jring
from fedml_tpu.parallel.compat import shard_map as jshard_map
from fedml_tpu.parallel.sequence import make_sequence_mesh as jseq_mesh
from fedml_tpu.parallel.sequence import sequence_parallel_lm as jsp_lm
from fedml_tpu_torch.core.rng import PRNGKey
from fedml_tpu_torch.models.convert import from_jax_variables
from fedml_tpu_torch.models.transformer import transformer_lm
from fedml_tpu_torch.parallel import ring_attention as ring
from fedml_tpu_torch.parallel.compat import launch, single_rank_group, use_mesh
from fedml_tpu_torch.parallel.dryrun import run_cases
from fedml_tpu_torch.parallel.sequence import make_sequence_mesh, sequence_parallel_lm

TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=3e-4, atol=3e-5)
LM_TOL = dict(rtol=3e-4, atol=3e-4)
CAUSAL = [False, True]


def _qkv(L=64, H=2, D=8, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(L, H, D).astype(np.float32) for _ in range(3))


def _cot(L=64, H=2, D=8):
    return np.random.RandomState(9).randn(L, H, D).astype(np.float32)


LM8 = dict(vocab_size=50, embed_dim=32, num_heads=2, num_layers=2, max_len=256)
LM4 = dict(vocab_size=32, embed_dim=16, num_heads=2, num_layers=1, max_len=64)
TOKENS8 = np.random.RandomState(0).randint(0, 50, (2, 64)).astype(np.int32)
TOKENS4 = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (1, 64), 0, 32), np.int32)


def _ring_spec(impl, causal, block, qkv, cot=None):
    q, k, v = qkv
    return ("ring", dict(device="cpu", impl=impl, causal=causal, block=block, q=q, k=k,
                         v=v, cot=cot))


CASES8 = ([_ring_spec("lax", c, 8, _qkv(seed=1)) for c in CAUSAL]
          + [_ring_spec("flash", c, 8, _qkv(L=128, seed=3)) for c in CAUSAL]
          + [("sp", dict(device="cpu", **LM8, attn_impl="lax", block_size=8, key=0,
                         tokens=TOKENS8, reference=True))])
CASES4 = ([_ring_spec("lax", c, 8, _qkv(L=48, seed=5)) for c in CAUSAL]
          + [_ring_spec(impl, c, 8, _qkv(seed=5), _cot()) for impl in ("lax", "flash")
             for c in CAUSAL]
          + [("sp", dict(device="cpu", **LM4, attn_impl=impl, key=0, tokens=TOKENS4,
                         **({"block_size": 8} if impl == "lax" else {"flash_block": 8})))
             for impl in ("lax", "flash")])


@pytest.fixture(scope="module")
def ranks8():
    return launch(run_cases, 8, CASES8, device="cpu", timeout=240.0)


@pytest.fixture(scope="module")
def ranks4():
    return launch(run_cases, 4, CASES4, device="cpu", timeout=240.0)


def _gathered(ranks, i, key="out"):
    return np.concatenate([r[i][key] for r in ranks])


def _jax_ring(fn, n, qkv, **kw):
    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    mapped = jshard_map(functools.partial(fn, axis_name="sp", **kw), mesh=mesh,
                        in_specs=(P("sp"),) * 3, out_specs=P("sp"), check_vma=False)
    return mapped, [jnp.asarray(a) for a in qkv]


# --- one process -----------------------------------------------------------


@pytest.mark.parametrize("causal", CAUSAL)
def test_blockwise_and_dense_match_jax(causal):
    q, k, v = _qkv()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    want = np.asarray(jring.dense_attention(jq, jk, jv, causal=causal))
    np.testing.assert_allclose(ring.dense_attention(tq, tk, tv, causal=causal).numpy(),
                               want, **TOL)
    got = ring.blockwise_attention(tq, tk, tv, causal=causal, block_size=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(jring.blockwise_attention(
        jq, jk, jv, causal=causal, block_size=16)), **TOL)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the batched layout is the same function per row
    batched = ring.blockwise_attention(tq[None], tk[None], tv[None], causal=causal,
                                       block_size=16)
    np.testing.assert_array_equal(batched[0].numpy(), got.numpy())


def test_blockwise_ragged_blocks():
    q, k, v = _qkv(L=48)
    want = np.asarray(jring.blockwise_attention(*map(jnp.asarray, (q, k, v)),
                                                causal=True, block_size=20))
    got = ring.blockwise_attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                                   block_size=20)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jring.dense_attention(
        *map(jnp.asarray, (q, k, v)), causal=True)), **TOL)


def test_transformer_pos_offset_is_jaxs():
    """A shard at global offset 5: the positional rows [5, 5 + L) are added,
    as in JAX; an offset past max_len raises in both."""
    kw = dict(vocab_size=32, embed_dim=16, num_heads=2, num_layers=1, max_len=32)
    toks = np.random.RandomState(2).randint(0, 32, (2, 16)).astype(np.int32)
    jvars = JTransformerLM(**kw).init({"params": jax.random.PRNGKey(0)},
                                      jnp.zeros((1, 32), jnp.int32), train=False)
    want = JTransformerLM(**kw, pos_offset_fn=lambda L: 5).apply(jvars, jnp.asarray(toks),
                                                                train=False)
    bundle = transformer_lm(**{k: v for k, v in kw.items() if k != "max_len"}, seq_len=32,
                            device="cpu")
    bundle.module.pos_offset_fn = lambda L: 5
    variables = from_jax_variables(jax.tree_util.tree_map(np.asarray, jvars), "cpu")
    got = bundle.apply_eval(variables, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the port's init draws flax's variables for the same key
    for k, leaf in bundle.init(PRNGKey(0))["params"].items():
        np.testing.assert_array_equal(leaf.numpy(), variables["params"][k].numpy())
    bundle.module.pos_offset_fn = lambda L: 17
    with pytest.raises(ValueError, match="exceeds max_len 32"):
        bundle.apply_eval(variables, torch.from_numpy(toks))
    with pytest.raises(ValueError, match="exceeds max_len 32"):
        JTransformerLM(**kw, pos_offset_fn=lambda L: 17).apply(jvars, jnp.asarray(toks),
                                                               train=False)


def test_sequence_parallel_lm_errors_are_jaxs():
    """JAX's guards: an unknown ``attn_impl``, ``block_size`` under
    ``flash``, a sequence past ``max_len``; and ``ring_flash_attention`` on
    a shard no block of at least 128 divides, with no ``block``."""
    jmesh = jseq_mesh(4)
    with single_rank_group("cpu"):
        mesh = make_sequence_mesh(device="cpu")
        for kw in (dict(attn_impl="pallas"), dict(attn_impl="flash", block_size=8)):
            with pytest.raises(ValueError) as port:
                sequence_parallel_lm(mesh, **LM4, **kw)
            with pytest.raises(ValueError) as jaxs:
                jsp_lm(jmesh, **LM4, **kw)
            assert str(port.value) == str(jaxs.value)
        _, init, apply = sequence_parallel_lm(mesh, **LM4, block_size=8)
        with pytest.raises(ValueError, match="sequence length 65 exceeds max_len 64"):
            apply(init(PRNGKey(0)), np.zeros((1, 65), np.int32))
        q = torch.zeros(1, 24, 2, 8)
        with use_mesh(mesh), pytest.raises(ValueError, match="shard length 24 has no"):
            ring.ring_flash_attention(q, q, q, "sp")
    _, jinit, japply = jsp_lm(jmesh, **LM4, block_size=8)
    with pytest.raises(ValueError, match="sequence length 65 exceeds max_len 64"):
        japply(jinit(jax.random.PRNGKey(0), sample_len=16), jnp.zeros((1, 65), jnp.int32))


# --- 8 ranks ---------------------------------------------------------------


@pytest.mark.parametrize("causal", CAUSAL)
def test_ring_attention_matches_jax_on_8_ranks(ranks8, causal):
    i = CAUSAL.index(causal)
    qkv = _qkv(seed=1)
    fn, args = _jax_ring(jring.ring_attention, 8, qkv, causal=causal, block_size=8)
    got = _gathered(ranks8, i)
    np.testing.assert_allclose(got, np.asarray(jax.jit(fn)(*args)), **TOL)
    np.testing.assert_allclose(got, np.asarray(jring.dense_attention(*args, causal=causal)),
                               **TOL)


@pytest.mark.parametrize("causal", CAUSAL)
def test_ring_flash_attention_matches_jax_on_8_ranks(ranks8, causal):
    i = 2 + CAUSAL.index(causal)
    qkv = _qkv(L=128, seed=3)
    fn, args = _jax_ring(jring.ring_flash_attention, 8, qkv, causal=causal, block=8,
                         interpret=True)
    got = _gathered(ranks8, i)
    np.testing.assert_allclose(got, np.asarray(jax.jit(fn)(*args)), **TOL)
    np.testing.assert_allclose(got, np.asarray(jring.dense_attention(*args, causal=causal)),
                               **TOL)


def test_sequence_parallel_lm_matches_jax_on_8_ranks(ranks8):
    mesh = jseq_mesh(8)
    _, init, apply = jsp_lm(mesh, **LM8, block_size=8)
    variables = init(jax.random.PRNGKey(0))
    want = np.asarray(apply(variables, jnp.asarray(TOKENS8)))
    plain = np.asarray(JTransformerLM(**LM8).apply(variables, jnp.asarray(TOKENS8),
                                                   train=False))
    first = ranks8[0][4]["logits"]
    assert first.shape == (2, 64, 50)
    np.testing.assert_allclose(first, want, **LM_TOL)
    np.testing.assert_allclose(first, plain, **LM_TOL)
    np.testing.assert_allclose(first, ranks8[0][4]["reference"], **LM_TOL)
    for r in ranks8:
        np.testing.assert_array_equal(r[4]["logits"], first)


# --- 4 ranks ---------------------------------------------------------------


@pytest.mark.parametrize("causal", CAUSAL)
def test_ring_attention_ragged_shards(ranks4, causal):
    """Shards of 12 with blocks of 8: the padded tail is masked."""
    i = CAUSAL.index(causal)
    qkv = _qkv(L=48, seed=5)
    fn, args = _jax_ring(jring.ring_attention, 4, qkv, causal=causal, block_size=8)
    got = _gathered(ranks4, i)
    np.testing.assert_allclose(got, np.asarray(jax.jit(fn)(*args)), **TOL)
    np.testing.assert_allclose(got, np.asarray(jring.dense_attention(*args, causal=causal)),
                               **TOL)


def _jax_grads(impl, causal, qkv):
    fn, args = (_jax_ring(jring.ring_flash_attention, 4, qkv, causal=causal, block=8,
                          interpret=True) if impl == "flash"
                else _jax_ring(jring.ring_attention, 4, qkv, causal=causal, block_size=8))
    cot = jnp.asarray(_cot())
    return jax.grad(lambda q, k, v: (fn(q, k, v) * cot).sum(), argnums=(0, 1, 2))(*args)


@pytest.mark.parametrize("causal", CAUSAL)
def test_ring_gradients_match_each_other_and_jax(ranks4, causal):
    """The flash ring's gradients (the merge differentiates through the flash
    op's o and LSE) against the lax ring's and JAX's flash and lax rings',
    on 4 ranks: wrong transposes of ``ppermute`` or ``psum`` fail here."""
    qkv = _qkv(seed=5)
    got = {impl: [np.concatenate([r[2 + 2 * j + CAUSAL.index(causal)]["grads"][g]
                                  for r in ranks4]) for g in range(3)]
           for j, impl in enumerate(("lax", "flash"))}
    for impl in ("lax", "flash"):
        want = _jax_grads(impl, causal, qkv)
        for name, a, b in zip(("dq", "dk", "dv"), got[impl], want):
            np.testing.assert_allclose(a, np.asarray(b), err_msg=f"{impl} {name}",
                                       **GRAD_TOL)
    for name, a, b in zip(("dq", "dk", "dv"), got["flash"], got["lax"]):
        np.testing.assert_allclose(a, b, err_msg=f"flash vs lax {name}", **GRAD_TOL)
    # the forwards agree too
    out = {impl: _gathered(ranks4, 2 + 2 * j + CAUSAL.index(causal))
           for j, impl in enumerate(("lax", "flash"))}
    np.testing.assert_allclose(out["flash"], out["lax"], **TOL)


def test_sequence_parallel_lm_flash_impl_matches_jax(ranks4):
    """attn_impl='flash' against the lax ring through a full LM forward, and
    against JAX's flash path (interpret mode) on the 4-device mesh."""
    mesh = jseq_mesh(4)
    _, init, apply_flash = jsp_lm(mesh, **LM4, attn_impl="flash", flash_block=8,
                                  flash_interpret=True)
    want = np.asarray(apply_flash(init(jax.random.PRNGKey(0), sample_len=16),
                                  jnp.asarray(TOKENS4)))
    lax_out, flash_out = ranks4[0][6]["logits"], ranks4[0][7]["logits"]
    np.testing.assert_allclose(flash_out, lax_out, **LM_TOL)
    np.testing.assert_allclose(flash_out, want, **LM_TOL)
    for r in ranks4:
        np.testing.assert_array_equal(r[7]["logits"], flash_out)
