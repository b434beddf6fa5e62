"""The hand-written sm_90a flash-attention kernel held against its plain
version on the card.  Needs a CUDA GPU and skips without one; imports no
JAX, so it runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_flash_attention_gpu.py

Tolerances: fp32 (TF32 off) 1e-4 on O; bf16 2e-2 on O (the kernel casts
the unnormalized p to bf16 before P·V, the plain version keeps fp32);
LSE 1e-3 (fp32 in both, exp2/log2 against exp/logsumexp).
"""

import numpy as np
import pytest
import torch

from fedml_tpu_torch.ops.flash_attention import (
    attention_plain,
    flash_attention,
    flash_attention_fwd,
)

# (B, Lq, Lk, H, D): every head width the kernel takes, ragged tails
# (L 80, 200), several KV tiles, and Lq != Lk
SHAPES = [(2, 128, 128, 2, 8), (2, 80, 80, 4, 16), (1, 200, 200, 3, 32),
          (2, 256, 256, 2, 64), (2, 192, 192, 2, 128), (1, 64, 160, 2, 64)]
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the sm_90a kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(b, lq, lk, h, d, dtype, device, fused=False, seed=0):
    """q, k, v from numpy; ``fused`` makes them the strided column blocks
    of one [B, L, 3, H, D] projection, as the transformer hands them."""
    rng = np.random.RandomState(seed)
    if fused:
        qkv = torch.from_numpy(rng.standard_normal((b, lq, 3, h, d)).astype(np.float32))
        return qkv.to(device, dtype).unbind(2)
    mk = lambda L: torch.from_numpy(  # noqa: E731
        rng.standard_normal((b, L, h, d)).astype(np.float32)).to(device, dtype)
    return mk(lq), mk(lk), mk(lk)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain_on_card(cuda, shape, dtype, causal):
    b, lq, lk, h, d = shape
    q, k, v = _qkv(b, lq, lk, h, d, dtype, cuda)
    before = flash_attention_fwd.launches
    o, lse = flash_attention_fwd(q, k, v, causal=causal)
    ro, rlse = attention_plain(q, k, v, causal)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    assert o.dtype == dtype and o.shape == (b, lq, h, d) and lse.shape == (b, h, lq)
    tol = TOL[dtype]
    torch.testing.assert_close(o.float(), ro.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, rlse, rtol=1e-3, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_reads_fused_qkv_views_in_place(cuda, dtype):
    q, k, v = _qkv(2, 96, 96, 4, 32, dtype, cuda, fused=True, seed=1)
    assert not q.is_contiguous()
    o, lse = flash_attention_fwd(q, k, v, causal=True)
    ro, rlse = attention_plain(q.contiguous(), k.contiguous(), v.contiguous(), True)
    torch.testing.assert_close(o.float(), ro.float(), rtol=TOL[dtype], atol=TOL[dtype])
    torch.testing.assert_close(lse, rlse, rtol=1e-3, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
def test_gradients_on_card_match_autograd_through_plain(cuda, causal):
    """dq/dk/dv of the autograd Function (kernel forward, blockwise fp32
    backward) against autograd through the plain version, with a loss
    that also uses the LSE."""
    q, k, v = _qkv(2, 128, 128, 2, 64, torch.float32, cuda, seed=2)
    rng = np.random.RandomState(3)
    cot = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32)).to(cuda)
    w = torch.from_numpy(rng.standard_normal((2, 2, 128)).astype(np.float32)).to(cuda)

    def grads(fn):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o, lse = fn(*leaves)
        return torch.autograd.grad((o * cot).sum() + (lse * w).sum(), leaves)

    from fedml_tpu_torch.ops.flash_attention import flash_attention_with_lse

    got = grads(lambda a, b, c: flash_attention_with_lse(a, b, c, causal, 64, 32))
    want = grads(lambda a, b, c: attention_plain(a, b, c, causal))
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _qkv(1, 64, 64, 2, 48, torch.float32, cuda)
    with pytest.raises(ValueError, match="head width"):
        flash_attention_fwd(q, k, v)
    q, k, v = _qkv(1, 64, 64, 2, 16, torch.float16, cuda)
    with pytest.raises(TypeError):
        flash_attention_fwd(q, k, v)
    x = torch.zeros(1, 64, 2, 17, device=cuda)[..., 1:]  # rows off 16-byte alignment
    with pytest.raises(ValueError, match="aligned"):
        flash_attention_fwd(x, x, x)
    x = torch.zeros(1, 64, 16, 2, device=cuda).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_fwd(x, x, x)
    with pytest.raises(ValueError, match="divide"):
        flash_attention(*_qkv(1, 60, 60, 1, 16, torch.float32, cuda),
                        block_q=16, block_k=16)
