"""The port's flash attention (``fedml_tpu_torch/ops/flash_attention.py``)
held against the JAX package's on the same numpy inputs.

On the CPU the port's forward is its plain version (dense fp32), so this
pins the function the CUDA kernel is held to on the card; the JAX side is
the Pallas kernel in interpret mode and ``dense_attention``.  The backward
is the port's blockwise fp32 backward either way.  Tolerances are the JAX
package's own (``tests/test_flash_attention.py``): forward 2e-5, gradients
rtol 2e-4 / atol 2e-5; bf16 5e-2 (``tests/test_conv_mxu.py``'s bf16
tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.ops import flash_attention as jflash
from fedml_tpu.parallel.ring_attention import dense_attention
from fedml_tpu_torch.ops.flash_attention import (
    attention_plain,
    flash_attention,
    flash_attention_fwd,
    flash_attention_with_lse,
    flash_attn_fn,
    pick_block,
)

FWD = {"rtol": 2e-5, "atol": 2e-5}


def _qkv(L=64, H=2, D=16, seed=0, B=None):
    rng = np.random.RandomState(seed)
    shape = (L, H, D) if B is None else (B, L, H, D)
    return tuple(rng.randn(*shape).astype(np.float32) for _ in range(3))


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("L,H,D,bq,bk", [(64, 2, 16, 16, 16), (96, 1, 8, 32, 16)],
                         ids=["one_block_pair", "multi_block_carry"])
def test_forward_matches_jax_kernel_and_dense(causal, L, H, D, bq, bk):
    q, k, v = _qkv(L, H, D, seed=L)
    want = np.asarray(jflash.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=bq, block_k=bk, interpret=True))
    dense = np.asarray(dense_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal=causal))
    got = flash_attention(*_t(q, k, v), causal=causal, block_q=bq, block_k=bk)
    assert got.shape == (L, H, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **FWD)
    np.testing.assert_allclose(got.numpy(), dense, **FWD)


@pytest.mark.parametrize("causal", [False, True])
def test_lse_matches_jax(causal):
    q, k, v = _qkv(64, 2, 16, seed=5)
    jo, jl = jflash.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, 32, 16, True)
    o, lse = flash_attention_with_lse(*_t(q, k, v), causal, 32, 16)
    assert lse.shape == (2, 64) and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **FWD)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), **FWD)


def test_batched_form_is_the_vmapped_jax_function():
    q, k, v = _qkv(32, 2, 8, seed=6, B=3)
    run = lambda a, b, c: jflash.flash_attention_with_lse(  # noqa: E731
        a, b, c, True, 16, 16, True)
    jo, jl = jax.vmap(run)(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    o, lse = flash_attention_with_lse(*_t(q, k, v), True, 16, 16)
    assert o.shape == (3, 32, 2, 8) and lse.shape == (3, 2, 32)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **FWD)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), **FWD)
    o2, lse2 = flash_attention_fwd(*_t(q, k, v), causal=True)
    torch.testing.assert_close(o2, o, rtol=0, atol=0)
    torch.testing.assert_close(lse2, lse, rtol=0, atol=0)


def test_rejects_ragged_as_jax_does():
    q, k, v = _qkv(L=60)
    with pytest.raises(ValueError):
        jflash.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               block_q=16, block_k=16, interpret=True)
    with pytest.raises(ValueError, match="divide"):
        flash_attention(*_t(q, k, v), block_q=16, block_k=16)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("use_lse", [False, True], ids=["o_only", "o_and_lse"])
def test_gradients_match_jax(causal, use_lse):
    """dq/dk/dv of the port's backward against ``jax.grad`` through the
    JAX package's custom VJP, including the LSE cotangent."""
    L, H, D = 32, 2, 8
    q, k, v = _qkv(L, H, D, seed=3)
    rng = np.random.RandomState(4)
    cot = rng.randn(L, H, D).astype(np.float32)
    w = rng.randn(H, L).astype(np.float32) if use_lse else np.zeros((H, L), np.float32)

    def jloss(a, b, c):
        o, lse = jflash.flash_attention_with_lse(a, b, c, causal, 8, 8, True)
        return (o * cot).sum() + (lse * w).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(v))
    leaves = [t.requires_grad_(True) for t in _t(q, k, v)]
    o, lse = flash_attention_with_lse(*leaves, causal, 8, 8)
    loss = (o * torch.from_numpy(cot)).sum()
    if use_lse:
        loss = loss + (lse * torch.from_numpy(w)).sum()
    got = torch.autograd.grad(loss, leaves)
    for g, r, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-4, atol=2e-5,
                                   err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_backward_matches_autograd_through_plain(causal):
    q, k, v = _qkv(48, 2, 8, seed=7, B=2)
    cot = torch.from_numpy(np.random.RandomState(8).randn(2, 48, 2, 8).astype(np.float32))

    def grads(fn):
        leaves = [t.requires_grad_(True) for t in _t(q, k, v)]
        o, lse = fn(*leaves)
        return torch.autograd.grad((o * cot).sum() + lse.sum(), leaves)

    got = grads(lambda a, b, c: flash_attention_with_lse(a, b, c, causal, 16, 16))
    want = grads(lambda a, b, c: attention_plain(a, b, c, causal))
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_matches_jax_kernel(causal):
    q, k, v = _qkv(64, 2, 16, seed=9)
    want = jflash.flash_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal=causal,
        block_q=32, block_k=32, interpret=True)
    got = flash_attention(*(t.to(torch.bfloat16) for t in _t(q, k, v)),
                          causal=causal, block_q=32, block_k=32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=5e-2, atol=5e-2)


def test_attn_fn_and_pick_block_mirror_jax():
    q, k, v = _qkv(32, 2, 8, seed=10, B=2)
    attn = flash_attn_fn(block_q=16, block_k=16)
    want = flash_attention(*_t(q, k, v), causal=True, block_q=16, block_k=16)
    torch.testing.assert_close(attn(*_t(q, k, v), True), want, rtol=0, atol=0)
    for n in (80, 128, 1000, 1024, 1536, 4096, 8192, 3 * 128):
        assert pick_block(n) == jflash.pick_block(n)
        assert pick_block(n, 256) == jflash.pick_block(n, 256)
