"""Ring attention: sequence (context) parallelism over a mesh axis (port of
``fedml_tpu/parallel/ring_attention.py``).

Blockwise online-softmax attention with K/V shards rotating around the
ranks of a mesh axis (Liu et al. 2023):

- ``blockwise_attention``: one device, exact attention in KV blocks
  (O(L) memory).
- ``ring_attention``: each rank of ``axis_name`` holds one Q/K/V shard of
  the sequence; after its resident block, K and V rotate one position
  left (``compat.ppermute``, one call for both) for ``axis_size - 1``
  steps while the (m, l, o) online-softmax state accumulates.
- ``ring_flash_attention``: the same ring whose per-step attention is the
  flash op of ``ops/flash_attention.py`` (the hand-written kernel on a CUDA
  tensor, its plain version on a CPU tensor); per-source normalised outputs
  merge by log-sum-exp weights.
- causal masking uses GLOBAL positions (shard offset = axis index x shard
  length), so the sharded result equals dense causal attention up to the
  order of float additions.

Tensors are ``[B, L, H, D]`` (the port's ``AttnFn`` layout) or, as in the
JAX package, ``[L, H, D]``.  The ring functions run inside a bound mesh
(``compat.shard_map``/``use_mesh``), one rank per shard; they are
differentiable, the K/V cotangents travelling back around the ring.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from fedml_tpu_torch.ops.flash_attention import flash_attention_with_lse, pick_block
from fedml_tpu_torch.parallel.compat import axis_index, axis_size, ppermute

NEG_INF = -1e30


def _batched(fn):
    """``fn`` over ``[B, L, H, D]``, also taking JAX's ``[L, H, D]``."""

    @functools.wraps(fn)
    def wrapped(q, k, v, *args, **kwargs):
        if q.ndim == 3:
            return fn(q[None], k[None], v[None], *args, **kwargs)[0]
        return fn(q, k, v, *args, **kwargs)

    return wrapped


def _scale(q) -> torch.Tensor:
    return torch.tensor(math.sqrt(q.shape[-1]), dtype=q.dtype, device=q.device)


def _block_attn(q, k, v, bias):
    """One (q-block, kv-block) contribution: q ``[B, Lq, H, D]``, k/v
    ``[B, Lk, H, D]``, ``bias [Lq, Lk]`` additive (0 / ``NEG_INF``).
    Returns the online-softmax partials m, l ``[B, Lq, H]`` and o
    ``[B, Lq, H, D]``."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / _scale(q)
    s = s + bias[None, None]
    m = s.amax(dim=-1)                          # [B, H, Lq]
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return m.transpose(1, 2), l.transpose(1, 2), o


def _merge(m1, l1, o1, m2, l2, o2):
    """Merge two online-softmax partial states."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    return m, l1 * a1 + l2 * a2, o1 * a1[..., None] + o2 * a2[..., None]


def _partial_attention(q, k, v, *, causal, block_size, q_offset, kv_offset):
    """(m, l, o) partials of Q ``[B, Lq, H, D]`` against K/V ``[B, Lk, H,
    D]`` in KV blocks of ``min(block_size, Lk)``: the ragged tail is padded
    with zeros and masked.  The one inner loop of the single-device and
    ring paths; ``q_offset``/``kv_offset`` are the GLOBAL positions of the
    first query and key."""
    B, Lq, H, _ = q.shape
    Lk = k.shape[1]
    bs = min(block_size, Lk)
    n_blocks = (Lk + bs - 1) // bs
    pad = n_blocks * bs - Lk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    dev = q.device
    qpos = q_offset + torch.arange(Lq, device=dev)
    m = torch.full((B, Lq, H), NEG_INF, dtype=q.dtype, device=dev)
    l = torch.zeros((B, Lq, H), dtype=q.dtype, device=dev)
    o = torch.zeros_like(q)
    for i in range(n_blocks):
        kb, vb = k[:, i * bs:(i + 1) * bs], v[:, i * bs:(i + 1) * bs]
        # the local (unshifted) key index masks the pad; the global one, causality
        local_kpos = i * bs + torch.arange(bs, device=dev)
        bias = torch.where(local_kpos[None, :] < Lk, 0.0, NEG_INF)
        if causal:
            kpos = kv_offset + local_kpos
            bias = bias + torch.where(kpos[None, :] <= qpos[:, None], 0.0, NEG_INF)
        else:
            bias = bias.expand(Lq, bs)
        m, l, o = _merge(m, l, o, *_block_attn(q, kb, vb, bias.to(q.dtype)))
    return m, l, o


def _normalize(m, l, o):
    del m
    return o / torch.clamp_min(l, 1e-30)[..., None]


@_batched
def blockwise_attention(q, k, v, *, causal: bool = False, block_size: int = 512,
                        q_offset: int = 0, kv_offset: int = 0) -> torch.Tensor:
    """Exact attention in KV blocks (O(L) memory).  ``q_offset``/
    ``kv_offset`` are the global positions of the first query/key: how ring
    shards express causal masks."""
    return _normalize(*_partial_attention(
        q, k, v, causal=causal, block_size=block_size,
        q_offset=q_offset, kv_offset=kv_offset))


def _ring_perm(n: int):
    """Each position sends to its left neighbour: after ``i`` steps a rank
    holds the shard that started ``i`` positions to its right."""
    return [(i, (i - 1) % n) for i in range(n)]


@_batched
def ring_attention(q, k, v, axis_name: str, *, causal: bool = False,
                   block_size: int = 512) -> torch.Tensor:
    """Sequence-parallel exact attention inside a bound mesh.

    Each rank holds its shard ``[B, L_local, H, D]`` of a sequence sharded
    over ``axis_name``.  The resident K/V shard is attended first; then K
    and V rotate left for ``axis_size - 1`` steps, so every query attends
    every key with no wasted final exchange.  Returns the local output
    shard."""
    n = axis_size(axis_name)
    me = axis_index(axis_name)
    L = q.shape[1]
    perm = _ring_perm(n)
    state = _partial_attention(q, k, v, causal=causal, block_size=block_size,
                               q_offset=me * L, kv_offset=me * L)
    kc, vc = k, v
    for i in range(1, n):
        kc, vc = ppermute((kc, vc), axis_name, perm)
        src = (me + i) % n
        state = _merge(*state, *_partial_attention(
            q, kc, vc, causal=causal, block_size=block_size,
            q_offset=me * L, kv_offset=src * L))
    return _normalize(*state)


@_batched
def ring_flash_attention(q, k, v, axis_name: str, *, causal: bool = False,
                         block: Optional[int] = None) -> torch.Tensor:
    """Ring attention whose per-step local attention is the flash op
    (``flash_attention_with_lse``): the hand-written kernel on a CUDA
    tensor, its plain version on a CPU tensor.  Same rotation schedule and
    exact math as ``ring_attention``.

    Under causal masking a source shard from an EARLIER rank is fully
    visible to every local query (a non-causal step), a LATER rank's
    contributes nothing (its LSE is forced to ``NEG_INF`` before the merge;
    its kernel run is spent anyway, as the JAX package's lockstep spends
    it), and only the resident step is causal.  Per-source normalised
    outputs merge by log-sum-exp weights, in float32:

        m = max(lse_a, lse_b);  w_s = exp(lse_s - m)
        o = (w_a o_a + w_b o_b) / (w_a + w_b);  lse = m + log(w_a + w_b)

    The merge is differentiable through both ``o`` and ``lse`` (the flash
    op's backward carries the LSE cotangent).  ``block`` (default
    ``pick_block`` of the shard length) is the op's block; the result is
    returned in ``q.dtype``."""
    n = axis_size(axis_name)
    me = axis_index(axis_name)
    L = q.shape[1]
    b = block or pick_block(L)
    if not b:
        raise ValueError(
            f"shard length {L} has no >=128 power-of-two block; use the "
            "lax ring_attention")

    def flash(kk, vv, c):
        o, lse = flash_attention_with_lse(q, kk, vv, c, b, b)
        return o.float(), lse                   # o [B, L, H, D], lse [B, H, L]

    o, lse = flash(k, v, causal)                # the resident step: the only causal one
    perm = _ring_perm(n)
    kc, vc = k, v
    for i in range(1, n):
        kc, vc = ppermute((kc, vc), axis_name, perm)
        src = (me + i) % n
        o_s, lse_s = flash(kc, vc, False)
        if causal and src > me:
            # a later rank's keys are all in this query shard's future
            lse_s = torch.full_like(lse_s, NEG_INF)
        m = torch.maximum(lse, lse_s)
        wa = torch.exp(lse - m)                 # [B, H, L]
        wb = torch.exp(lse_s - m)
        den = torch.clamp_min(wa + wb, 1e-30)
        o = ((wa / den).transpose(1, 2)[..., None] * o
             + (wb / den).transpose(1, 2)[..., None] * o_s)
        lse = m + torch.log(den)
    return o.to(q.dtype)


@_batched
def dense_attention(q, k, v, *, causal: bool = False) -> torch.Tensor:
    """Reference for tests: plain ``softmax(q kᵀ / √D) v``."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / _scale(q)
    if causal:
        Lq, Lk = q.shape[1], k.shape[1]
        keep = torch.ones((Lq, Lk), dtype=torch.bool, device=q.device).tril()
        s = torch.where(keep, s, torch.tensor(NEG_INF, dtype=s.dtype, device=s.device))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
