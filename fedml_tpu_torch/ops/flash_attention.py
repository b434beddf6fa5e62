"""Flash attention: the hand-written Hopper kernel and its plain version.

Port of ``fedml_tpu/ops/flash_attention.py``.  Per (batch, head) slice,
``softmax(q kᵀ / √D) v`` with an optional causal mask ``kpos <= qpos``
(masked scores are ``NEG_INF = -1e30``), fp32 scores, O in the input
dtype and an fp32 per-row log-sum-exp.  The layout is the JAX package's,
``[L, H, D]`` per example; the batched form ``[B, L, H, D]`` is the JAX
``vmap`` written out as a leading axis.

On a CUDA tensor ``flash_attention_fwd`` launches the sm_90a kernel of
``csrc/flash_attention.cu`` (built at first use, see ``ops/build.py``) or
raises; it reads q/k/v in place through their strides, so the column
blocks of a fused QKV projection need no copy.  On a CPU tensor it runs
``attention_plain``, dense fp32 attention; the tests hold both against
the JAX package and ``chip_smoke.py`` holds the kernel against the plain
version on the card.

The backward, like the JAX package's (``_flash_bwd_single``, a
``lax.scan`` left to XLA), is not a hand-written kernel: it recomputes
``p`` per KV block of ``block_k`` from the saved LSE in fp32 with
``torch.matmul``, batched over every (batch, head), and carries the LSE
cotangent (``ds = p·(dp − D + dlse)``).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

NEG_INF = -1e30
_KERNEL_D = (8, 16, 32, 64, 128)
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_lib: Optional[ctypes.CDLL] = None


def _check(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("need [B, L, H, D] q, k, v, got shapes "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if k.shape != v.shape or q.shape[0] != k.shape[0] or q.shape[2:] != k.shape[2:]:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)}, "
                         f"{tuple(v.shape)} disagree on batch, heads or width")


def attention_plain(q, k, v, causal: bool = False):
    """The kernel's function in plain PyTorch over ``[B, L, H, D]``: dense
    fp32 scores, the ``NEG_INF`` mask, LSE by ``logsumexp``, O cast to the
    input dtype.  Returns ``(o, lse [B, H, Lq])``."""
    _check(q, k, v)
    lq, lk, d = q.shape[1], k.shape[1], q.shape[3]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / math.sqrt(d))
    if causal:
        keep = (torch.arange(lk, device=q.device)[None, :]
                <= torch.arange(lq, device=q.device)[:, None])
        s = s.masked_fill(~keep, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype), lse


def _load():
    global _lib
    if _lib is None:
        from fedml_tpu_torch.ops import build

        lib = build.load("flash_attention")
        lib.flash_attention_fwd.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
            + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        lib.flash_attention_fwd.restype = ctypes.c_int
        _lib = lib
    return _lib


def _flash_cuda(q, k, v, causal):
    _check(q, k, v)
    b, lq, h, d = q.shape
    lk = k.shape[1]
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention kernel takes q, k, v all fp32 or all "
                        f"bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in _KERNEL_D:
        raise ValueError(f"flash_attention kernel takes head width D in {_KERNEL_D}, got {d}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        # rows are fetched as 16-byte vectors straight from the strided view
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention kernel needs {name}'s D axis contiguous, "
                             f"got strides {t.stride()}")
        if t.data_ptr() % 16 or any(s * t.element_size() % 16 for s in t.stride()[:3]):
            raise ValueError(f"flash_attention kernel reads 16-byte aligned rows: {name} "
                             f"at {t.data_ptr():#x} with strides {t.stride()} is not")
    o = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    lib = _load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            b, h, lq, lk, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], int(causal), int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    flash_attention_fwd.launches += 1
    return o, lse


def flash_attention_fwd(q, k, v, *, causal: bool = False):
    """Raw (non-differentiable) attention over ``[B, L, H, D]`` →
    ``(o [B, Lq, H, D], lse [B, H, Lq])``.  A CUDA tensor launches the
    kernel (``flash_attention_fwd.launches`` counts the launches); a CPU
    tensor runs ``attention_plain``."""
    if q.device.type == "cuda":
        return _flash_cuda(q, k, v, causal)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention runs on cuda or cpu, got {q.device}")
    return attention_plain(q, k, v, causal)


flash_attention_fwd.launches = 0


def _flash_bwd(q, k, v, o, lse, do, dlse, causal: bool, block_k: int):
    """Exact backward in KV blocks, fp32, over ``[B, H, L, D]`` at once
    (``_flash_bwd_single`` vmapped over batch and heads):

        p = exp(s − lse), dv = pᵀ dO, dp = dO vᵀ,
        ds = p (dp − D + dlse) with D = rowsum(dO ∘ O),
        dq = scale Σ ds k, dk = scale dsᵀ q.

    As in JAX, causal blocks above the diagonal run too (their p is 0)."""
    lq, lk, d = q.shape[1], k.shape[1], q.shape[3]
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, of, dof = (t.float().transpose(1, 2) for t in (q, k, v, o, do))
    drow = (dof * of).sum(-1)                                 # [B, H, Lq]
    dlse = dlse.float()
    dq = torch.zeros_like(qf)
    dk = torch.empty_like(kf)
    dv = torch.empty_like(vf)
    qpos = torch.arange(lq, device=q.device)
    bs = min(block_k, lk)
    for j in range(0, lk, bs):
        kb, vb = kf[:, :, j:j + bs], vf[:, :, j:j + bs]
        s = (qf @ kb.transpose(-1, -2)) * scale               # [B, H, Lq, bs]
        if causal:
            keep = (j + torch.arange(bs, device=q.device))[None, :] <= qpos[:, None]
            s = s.masked_fill(~keep, NEG_INF)
        p = torch.exp(s - lse[..., None])
        dv[:, :, j:j + bs] = p.transpose(-1, -2) @ dof
        dp = dof @ vb.transpose(-1, -2)
        ds = p * (dp - drow[..., None] + dlse[..., None])
        dq += (ds @ kb) * scale
        dk[:, :, j:j + bs] = (ds.transpose(-1, -2) @ qf) * scale
    return tuple(g.transpose(1, 2).to(t.dtype)
                 for g, t in ((dq, q), (dk, k), (dv, v)))


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, block_k):
        o, lse = flash_attention_fwd(q, k, v, causal=causal)
        ctx.causal, ctx.block_k = causal, block_k
        ctx.save_for_backward(q, k, v, o, lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):  # an unused output's cotangent arrives as zeros
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, o, lse, do, dlse, ctx.causal, ctx.block_k)
        return dq, dk, dv, None, None


def flash_attention_with_lse(q, k, v, causal: bool = False,
                             block_q: int = 128, block_k: int = 128):
    """Differentiable ``(o, lse)``: q ``[Lq, H, D]``, k/v ``[Lk, H, D]`` →
    o ``[Lq, H, D]``, lse ``[H, Lq]``; or the batched ``[B, L, H, D]`` →
    o ``[B, Lq, H, D]``, lse ``[B, H, Lq]``.  The backward carries the
    LSE cotangent.  ``block_q``/``block_k`` are the JAX kernel's blocks:
    the sequence must divide them, as there (the CUDA kernel tiles by 64
    and masks its own tail); ``block_k`` is the backward's KV block."""
    lq, lk = q.shape[-3], k.shape[-3]
    block_q, block_k = min(block_q, lq), min(block_k, lk)
    if lq % block_q or lk % block_k:
        raise ValueError(
            f"sequence ({lq},{lk}) must divide blocks ({block_q},{block_k})")
    if q.ndim == 3:
        o, lse = _FlashAttention.apply(q[None], k[None], v[None], causal, block_k)
        return o[0], lse[0]
    return _FlashAttention.apply(q, k, v, causal, block_k)


def flash_attention(q, k, v, *, causal: bool = False, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """Differentiable flash attention over ``[L, H, D]`` or ``[B, L, H, D]``
    (see ``flash_attention_with_lse``); returns O only."""
    o, _ = flash_attention_with_lse(q, k, v, causal, block_q, block_k)
    return o


def flash_attn_fn(block_q: int = 128, block_k: int = 128):
    """Adapter matching the ``TransformerLM`` ``attn_fn`` signature
    ``(q, k, v, causal)`` over ``[B, L, H, D]``."""

    def attn(q, k, v, causal):
        return flash_attention(q, k, v, causal=causal, block_q=block_q,
                               block_k=block_k)

    return attn


def pick_block(length: int, preferred: int = 1024) -> int:
    """Largest power-of-two block <= preferred that divides ``length``
    (0 if none >= 128 divides it)."""
    b = preferred
    while b >= 128:
        if length % b == 0:
            return b
        b //= 2
    return 0
