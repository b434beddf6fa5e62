"""Flash attention: the hand-written Hopper kernel and its plain version.

Port of ``fedml_tpu/ops/flash_attention.py``.  Per (batch, head) slice,
``softmax(q kᵀ / √D) v`` with an optional causal mask ``kpos <= qpos``
(masked scores are ``NEG_INF = -1e30``), fp32 scores, O in the input
dtype and an fp32 per-row log-sum-exp.  The layout is the JAX package's,
``[L, H, D]`` per example; the batched form ``[B, L, H, D]`` is the JAX
``vmap`` written out as a leading axis.

On a CUDA tensor ``flash_attention_fwd`` launches an sm_90a kernel of
``csrc/flash_attention.cu`` (built at first use, see ``ops/build.py``) or
raises; it reads q/k/v in place through their strides, so the column
blocks of a fused QKV projection need no copy.  ``_flash_plan`` (pure
Python, CPU-tested) picks one of three routes by one static condition:

- ``wgmma`` (v3): bf16 with D 64 or 128.  Persistent blocks (one per SM)
  of a producer warpgroup and two wgmma consumer warpgroups over
  128-query tiles, a TMA-fed K/V ring, causal q tiles heaviest first.
  ``flash_attention_fwd.wgmma_launches`` counts it.
- ``mma`` (v2): bf16 with D 8, 16 or 32.  64-query tiles on mma.sync.
- ``fma``: fp32, every D.  CUDA-core FMA in full fp32.

The plan (route, tiles, shared memory, grid and, for ``wgmma``, the
schedule: which q tiles each block runs, in which order, over how many KV
tiles) goes to the C entry point, which launches it as given and refuses
a plan that names a kernel, tile or block it was not built with; nothing
falls back to another route or to the plain version.  On a CPU tensor it runs
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
import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

NEG_INF = -1e30
_KERNEL_D = (8, 16, 32, 64, 128)
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_WGMMA_D = (64, 128)
_SMS = 132  # streaming multiprocessors of one H100
_ROUTES = ("fma", "mma", "wgmma")  # the C side's route ids, in order
_REFUSED = {-1: "the library refused the plan (built for another one)",
            -2: "libcuda has no cuTensorMapEncodeTiled",
            -3: "cuTensorMapEncodeTiled refused a q/k/v view"}
_lib: Optional[ctypes.CDLL] = None


class FlashPlan(NamedTuple):
    """One launch of the kernel; ``csrc/flash_attention.cu``'s
    ``built_for`` refuses a route, tile, block or shared-memory size that
    the library was not built with."""

    route: str                     # "wgmma", "mma" or "fma"
    bq: int                        # query rows per block
    bn: int                        # keys per KV tile
    stages: int                    # depth of the K/V ring
    threads: int                   # per block
    smem_bytes: int                # dynamic shared memory per block
    grid: Tuple[int, int, int]
    heavy_first: bool              # q tiles dispatched in descending order


def _flash_plan(dtype, d: int, lq: int, lk: int, causal: bool, *,
                batch: int = 1, heads: int = 1, sms: int = _SMS) -> FlashPlan:
    """The kernel route for ``dtype`` and head width ``d``, its tiles, its
    shared memory, its grid and its q-tile order.

    ``wgmma`` (bf16, D 64/128): 128 x 128 tiles; Q, the staged O and a
    2-stage K/V ring of 128-byte-swizzled boxes (128 rows x 64 of D each);
    384 threads.  It is persistent: ``min(q tiles of every (batch, head),
    sms)`` blocks, one per SM, run the q tiles that ``_wg_schedule`` deals
    them; under ``causal`` heaviest first.  ``mma`` (bf16, D ≤ 32) and
    ``fma`` (fp32) are v2's 64 x 64 tiles, one block each over ``(q tiles,
    H, B)``, whose kernels count their own KV tiles (``qt + 1`` under
    ``causal``: their tiles are square).  No plan depends on ``lk``: every
    route tiles the keys by its ``bn`` and masks the tail."""
    del lk
    if dtype not in _KERNEL_DTYPES:
        raise TypeError(f"flash_attention kernel takes fp32 or bf16, got {dtype}")
    if d not in _KERNEL_D:
        raise ValueError(f"flash_attention kernel takes head width D in {_KERNEL_D}, got {d}")
    if dtype == torch.bfloat16 and d in _WGMMA_D:
        box = 128 * 128                                    # bytes: 128 rows x 64 bf16
        tile = d // 64 * box
        smem = (2 + 2 * 2) * tile + 128 + 1024             # Q, O, 2 K, 2 V; barriers; alignment
        work = batch * heads * -(-lq // 128)
        return FlashPlan("wgmma", 128, 128, 2, 384, smem, (min(work, sms), 1, 1),
                         bool(causal))
    nq = -(-lq // 64)
    dp = max(d, 16)
    if dtype == torch.bfloat16:
        smem = 5 * 64 * (dp + 8) * 2                       # Q + two K + two V, padded rows
        return FlashPlan("mma", 64, 64, 2, 128, smem, (nq, heads, batch), False)
    smem = (2 * 64 * (dp + 1) + 64 * dp + 64 * 65) * 4     # Q, K, V and P in fp32
    return FlashPlan("fma", 64, 64, 1, 256, smem, (nq, heads, batch), False)


def _q_tile_order(plan: FlashPlan, lq: int):
    """A ``wgmma`` plan's q tiles in the order its schedule deals them:
    descending (heaviest first) under ``causal``."""
    n = -(-lq // plan.bq)
    return list(range(n - 1, -1, -1)) if plan.heavy_first else list(range(n))


def _kv_tiles(plan: FlashPlan, qt: int, lq: int, lk: int, causal: bool) -> int:
    """KV tiles the ``wgmma`` block of q tile ``qt`` reads: every key that a
    valid row of the tile sees (``kpos <= qpos``, top-left aligned)."""
    lim = min(lk, lq, (qt + 1) * plan.bq) if causal else lk
    return -(-lim // plan.bn)


def _wg_schedule(plan: FlashPlan, lq: int, lk: int, batch: int, heads: int,
                 causal: bool):
    """Per block of a ``wgmma`` plan, the ``(q tile, head, batch, KV tiles)``
    it runs, in order: the tiles of every (batch, head), q tile slowest in
    ``_q_tile_order``, dealt in rows of ``grid`` blocks with every other
    row reversed, so no block carries more than the mean work plus one q
    tile's."""
    order = _q_tile_order(plan, lq)
    bh, grid = batch * heads, plan.grid[0]
    n = len(order) * bh
    blocks = [[] for _ in range(grid)]
    for k in range(-(-n // grid)):
        for blk in range(grid):
            tile = k * grid + (grid - 1 - blk if k % 2 else blk)
            if tile < n:
                y, r = divmod(tile, bh)
                qt = order[y]
                blocks[blk].append((qt, r % heads, r // heads,
                                    _kv_tiles(plan, qt, lq, lk, causal)))
    return blocks


def _schedule_table(blocks) -> np.ndarray:
    """``_wg_schedule``'s lists as the kernel reads them: int32 ``[rows,
    grid, 4]``, the k-th entry of block b at ``[k, b]``, a q tile of -1
    past a block's last."""
    table = np.full((max(map(len, blocks)), len(blocks), 4), -1, np.int32)
    for b, work in enumerate(blocks):
        table[:len(work), b] = work
    return table


@functools.lru_cache(maxsize=64)
def _schedule_on(device, plan: FlashPlan, lq: int, lk: int, batch: int, heads: int,
                 causal: bool) -> torch.Tensor:
    """The schedule table on ``device``, made once per shape (a launch
    inside CUDA-graph capture then copies nothing)."""
    blocks = _wg_schedule(plan, lq, lk, batch, heads, causal)
    return torch.from_numpy(_schedule_table(blocks)).to(device)


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


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry point's signature on a loaded library."""
    lib.flash_attention_fwd.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
        + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 11
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    lib.flash_attention_fwd.restype = ctypes.c_int
    return lib


def _load():
    global _lib
    if _lib is None:
        from fedml_tpu_torch.ops import build

        _lib = _bind(build.load("flash_attention"))
    return _lib


def _flash_cuda(q, k, v, causal, lib: Optional[ctypes.CDLL] = None):
    """Launch the plan's kernel; ``lib`` is another build of the source
    (``flash_sweep``), else this tree's."""
    _check(q, k, v)
    b, lq, h, d = q.shape
    lk = k.shape[1]
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention kernel takes q, k, v all fp32 or all "
                        f"bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
    plan = _flash_plan(q.dtype, d, lq, lk, causal, batch=b, heads=h,
                       sms=torch.cuda.get_device_properties(q.device).multi_processor_count)
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
    if lib is None:
        lib = _load()
    sched, rows = None, 0
    if plan.route == "wgmma":
        table = _schedule_on(q.device, plan, lq, lk, b, h, bool(causal))
        sched, rows = table.data_ptr(), table.shape[0]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            b, h, lq, lk, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], int(causal), int(q.dtype == torch.bfloat16),
            _ROUTES.index(plan.route), plan.bq, plan.bn, plan.stages, plan.threads,
            plan.smem_bytes, *plan.grid, sched, rows, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel ({plan.route}) launch failed: "
                           + _REFUSED.get(err, f"cudaError {err}"))
    flash_attention_fwd.launches += 1
    flash_attention_fwd.wgmma_launches += int(plan.route == "wgmma")
    return o, lse


def flash_attention_fwd(q, k, v, *, causal: bool = False):
    """Raw (non-differentiable) attention over ``[B, L, H, D]`` →
    ``(o [B, Lq, H, D], lse [B, H, Lq])``.  A CUDA tensor launches the
    kernel of ``_flash_plan``'s route (``flash_attention_fwd.launches``
    counts every launch, ``flash_attention_fwd.wgmma_launches`` those of
    the wgmma route); a CPU tensor runs ``attention_plain``."""
    if q.device.type == "cuda":
        return _flash_cuda(q, k, v, causal)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention runs on cuda or cpu, got {q.device}")
    return attention_plain(q, k, v, causal)


flash_attention_fwd.launches = 0
flash_attention_fwd.wgmma_launches = 0


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
    the sequence must divide them, as there (the CUDA kernel tiles by its
    plan and masks its own tail); ``block_k`` is the backward's KV block."""
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
