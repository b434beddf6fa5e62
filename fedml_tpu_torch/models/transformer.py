"""Decoder-only transformer LM with pluggable attention (port of
``fedml_tpu/models/transformer.py``).

Pre-LN blocks, learned positional embeddings, weight-tied output head.
State names are the flax paths joined with dots (``wte.embedding``,
``Block_0.LayerNorm_0.scale``, ``Block_0.MultiHeadAttention_0.Dense_0.kernel``,
``Block_0.Dense_1.bias``, ``ln_f.bias``), so ``models/convert.py`` carries
a flax tree over unchanged.

Attention is an injected ``attn_fn(q, k, v, causal)`` over ``[B, L, H, D]``
(the JAX ``vmap`` over the batch written out as a leading axis).  The
default, ``_default_attn``, is the flash-attention op of
``ops/flash_attention.py`` for every input: its hand-written kernel on a
CUDA tensor, its plain version on a CPU tensor.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from fedml_tpu_torch.models.base import Dense, Embed, ModelBundle, functional_call, meta_param
from fedml_tpu_torch.ops.flash_attention import flash_attention, pick_block
from fedml_tpu_torch.utils.device import DeviceLike, resolve_device

# (q, k, v, causal) over [B, L, H, D] -> [B, L, H, D]
AttnFn = Callable


def _default_attn(q, k, v, causal):
    """The flash-attention op with blocks ``pick_block(L)``, or ``L`` where
    no block of at least 128 divides it.  The blocks shape only the
    backward's KV blocks; the CUDA kernel tiles by its own plan whatever L is."""
    L = q.shape[1]
    block = pick_block(L) or L
    return flash_attention(q, k, v, causal=causal, block_q=block, block_k=block)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` (epsilon 1e-6) over the last axis: fp32
    statistics with the fast variance ``max(E[x²] - E[x]², 0)`` even for
    bf16 input, normalization in fp32, output in the promoted dtype of
    (x, scale, bias)."""

    epsilon = 1e-6

    def __init__(self, features: int):
        super().__init__()
        self.scale = meta_param(features)
        self.bias = meta_param(features)

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp_min(xf.square().mean(-1, keepdim=True) - mean.square(), 0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.epsilon) * self.scale) + self.bias
        dtype = torch.promote_types(
            torch.promote_types(x.dtype, self.scale.dtype), self.bias.dtype)
        return y.to(dtype)


class MultiHeadAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int,
                 attn_fn: Optional[AttnFn] = None, causal: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.attn_fn = attn_fn
        self.causal = causal
        self.Dense_0 = Dense(embed_dim, 3 * embed_dim, use_bias=False)
        self.Dense_1 = Dense(embed_dim, embed_dim, use_bias=False)

    def forward(self, x):
        B, L, E = x.shape
        H = self.num_heads
        # the fused projection's columns are [q heads | k heads | v heads],
        # each head-major: a [B, L, 3, H, D] view, split without a copy
        q, k, v = self.Dense_0(x).view(B, L, 3, H, E // H).unbind(2)
        attn = self.attn_fn or _default_attn
        out = attn(q, k, v, self.causal)
        return self.Dense_1(out.reshape(B, L, E))


class Block(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, mlp_ratio: int = 4,
                 attn_fn: Optional[AttnFn] = None):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(embed_dim)
        self.MultiHeadAttention_0 = MultiHeadAttention(embed_dim, num_heads, attn_fn)
        self.LayerNorm_1 = LayerNorm(embed_dim)
        self.Dense_0 = Dense(embed_dim, mlp_ratio * embed_dim)
        self.Dense_1 = Dense(mlp_ratio * embed_dim, embed_dim)

    def forward(self, x):
        x = x + self.MultiHeadAttention_0(self.LayerNorm_0(x))
        h = F.gelu(self.Dense_0(self.LayerNorm_1(x)), approximate="tanh")
        return x + self.Dense_1(h)


class TransformerLM(nn.Module):
    """``remat`` checkpoints each block: its activations are recomputed in
    the backward pass (``torch.utils.checkpoint``, non-reentrant), which
    trades about a third more FLOPs for O(layers) less live memory.  The
    state names are the same either way.

    ``pos_offset_fn(L)`` gives the global position of the first of the ``L``
    tokens it is handed (a sequence shard's offset, ``parallel/
    sequence.py``): the positional rows ``[pos0, pos0 + L)`` are added; an
    offset that runs past ``max_len`` raises."""

    def __init__(self, vocab_size: int = 256, embed_dim: int = 128,
                 num_heads: int = 4, num_layers: int = 2, max_len: int = 2048,
                 attn_fn: Optional[AttnFn] = None, remat: bool = False,
                 pos_offset_fn: Optional[Callable[[int], int]] = None):
        super().__init__()
        self.max_len = max_len
        self.remat = remat
        self.pos_offset_fn = pos_offset_fn
        self.wte = Embed(vocab_size, embed_dim)
        self.wpe = Embed(max_len, embed_dim)
        self.blocks = []
        for i in range(num_layers):
            self.add_module(f"Block_{i}", Block(embed_dim, num_heads, attn_fn=attn_fn))
            self.blocks.append(f"Block_{i}")
        self.ln_f = LayerNorm(embed_dim)

    def forward(self, x, train: bool = False, updates: Optional[dict] = None):
        B, L = x.shape
        pos0 = self.pos_offset_fn(L) if self.pos_offset_fn else 0
        if pos0 + L > self.max_len:
            raise ValueError(f"sequence length {L} exceeds max_len {self.max_len}")
        h = self.wte(x) + self.wpe.embedding[pos0:pos0 + L][None]
        for name in self.blocks:
            block = getattr(self, name)
            if self.remat:
                # the recompute runs after functional_call has put the
                # placeholders back, so it is handed the block's tensors
                state = dict(block.named_parameters())
                h = checkpoint(functional_call, block, state, (h,),
                               use_reentrant=False)
            else:
                h = block(h)
        return self.wte.attend(self.ln_f(h))


def transformer_lm(
    vocab_size=256, embed_dim=128, num_heads=4, num_layers=2, seq_len=256,
    attn_fn: Optional[AttnFn] = None, max_len: Optional[int] = None,
    remat: bool = False, device: DeviceLike = None,
) -> ModelBundle:
    return ModelBundle(
        module=TransformerLM(
            vocab_size=vocab_size, embed_dim=embed_dim, num_heads=num_heads,
            num_layers=num_layers, max_len=max_len or seq_len,
            attn_fn=attn_fn, remat=remat,
        ),
        input_shape=(seq_len,),
        device=resolve_device(device),
        input_dtype=torch.int32,
    )
