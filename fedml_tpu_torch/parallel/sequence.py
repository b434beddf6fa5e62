"""Sequence parallelism: a transformer forward sharded over a mesh axis
(port of ``fedml_tpu/parallel/sequence.py``).

One logical sequence is split across the ranks of the ``sp`` axis:
activations and K/V shards stay on their rank, attention is the ring of
``parallel/ring_attention.py``, parameters are replicated.  Positions are
shard-global (``TransformerLM``'s ``pos_offset_fn``), so the sharded
forward equals the one-device forward up to the order of float additions.
"""

from __future__ import annotations

from typing import Optional

import torch

from fedml_tpu_torch.models.base import ModelBundle
from fedml_tpu_torch.models.transformer import TransformerLM, transformer_lm
from fedml_tpu_torch.parallel.compat import (all_gather, axis_index, axis_size,
                                             mesh_device, use_mesh)
from fedml_tpu_torch.parallel.ring_attention import ring_attention, ring_flash_attention
from fedml_tpu_torch.parallel.spmd import make_1d_mesh
from fedml_tpu_torch.utils.device import DeviceLike, resolve_device


def make_sequence_mesh(n_devices: Optional[int] = None, axis: str = "sp", *,
                       device: DeviceLike = None):
    return make_1d_mesh(n_devices, axis, device=device)


def ring_attn_fn(axis: str, attn_impl: str = "lax", block_size: int = 512,
                 flash_block: Optional[int] = None):
    """The ring over ``axis`` as a ``TransformerLM`` ``attn_fn``, with the
    JAX package's guards: ``attn_impl`` is ``"lax"`` (``ring_attention`` in
    KV blocks of ``block_size``) or ``"flash"`` (``ring_flash_attention``,
    whose block is ``flash_block``); ``block_size`` is refused under
    ``"flash"`` rather than silently ignored."""
    if attn_impl not in ("lax", "flash"):
        raise ValueError(f"attn_impl must be 'lax' or 'flash', got {attn_impl!r}")
    if attn_impl == "flash" and block_size != 512:
        raise ValueError(
            "block_size applies to attn_impl='lax' only; tune the flash "
            "path with flash_block")
    if attn_impl == "flash":
        return lambda q, k, v, causal: ring_flash_attention(
            q, k, v, axis, causal=causal, block=flash_block)
    return lambda q, k, v, causal: ring_attention(
        q, k, v, axis, causal=causal, block_size=block_size)


def shard_offset(axis: str):
    """``pos_offset_fn`` of a shard along ``axis``: axis index x shard length."""
    return lambda L: axis_index(axis) * L


def sp_transformer_bundle(
    *,
    vocab_size: int,
    embed_dim: int,
    num_heads: int,
    num_layers: int,
    max_len: int,
    axis: str = "sp",
    attn_impl: str = "lax",
    block_size: int = 512,
    flash_block: Optional[int] = None,
    remat: bool = False,
    device: DeviceLike = None,
) -> ModelBundle:
    """A ``TransformerLM`` whose attention is the ring over ``axis`` and
    whose positions are shard-global: valid only inside a bound mesh.  Its
    variables are the plain module's (draw them with ``transformer_lm``)."""
    module = TransformerLM(
        vocab_size=vocab_size, embed_dim=embed_dim, num_heads=num_heads,
        num_layers=num_layers, max_len=max_len, remat=remat,
        attn_fn=ring_attn_fn(axis, attn_impl, block_size, flash_block),
        pos_offset_fn=shard_offset(axis))
    return ModelBundle(module=module, input_shape=(max_len,),
                       device=resolve_device(device), input_dtype=torch.int32)


def sequence_parallel_lm(
    mesh,
    *,
    vocab_size: int = 256,
    embed_dim: int = 128,
    num_heads: int = 4,
    num_layers: int = 2,
    max_len: int = 2048,
    block_size: int = 512,
    axis: str = "sp",
    attn_impl: str = "lax",
    flash_block: Optional[int] = None,
    remat: bool = False,
):
    """Build ``(module, init, apply)``: ``apply(variables, tokens)`` runs the
    forward with the sequence dim sharded over ``axis``.

    Every rank of ``mesh`` calls ``apply`` with the same global tokens
    ``[B, L]`` (L divisible by the axis size); it runs its own shard
    (``axis_index(axis)``) and returns the global logits ``[B, L, V]``,
    gathered over ``axis``.  ``apply`` is an inference forward (no
    gradient crosses the gather); training runs through
    ``parallel/dp_sp.py``.  ``init(rng)`` draws the variables of the plain
    module from a threefry key, outside the mesh: the same tree, and for
    the same key the same values, as the JAX package's."""
    device = mesh_device(mesh)
    bundle = sp_transformer_bundle(
        vocab_size=vocab_size, embed_dim=embed_dim, num_heads=num_heads,
        num_layers=num_layers, max_len=max_len, axis=axis, attn_impl=attn_impl,
        block_size=block_size, flash_block=flash_block, remat=remat, device=device)

    def init(rng):
        return transformer_lm(vocab_size=vocab_size, embed_dim=embed_dim,
                              num_heads=num_heads, num_layers=num_layers,
                              seq_len=max_len, device=device).init(rng)

    @torch.no_grad()
    def apply(variables, tokens):
        if tokens.shape[1] > max_len:
            raise ValueError(
                f"sequence length {tokens.shape[1]} exceeds max_len "
                f"{max_len}: positional table would clamp silently")
        with use_mesh(mesh):
            n, i = axis_size(axis), axis_index(axis)
            L = tokens.shape[1]
            if L % n:
                raise ValueError(f"sequence length {L} not divisible by the "
                                 f"{axis!r} axis of {n}")
            shard = torch.as_tensor(tokens)[:, i * (L // n):(i + 1) * (L // n)]
            logits = bundle.apply_eval(variables, shard.to(device))
            return torch.cat(all_gather(logits, axis, tiled=False).unbind(0), dim=1)

    return bundle.module, init, apply
