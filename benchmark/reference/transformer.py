"""A GPT-2-shaped decoder (Radford et al. 2019) as the program's
``TransformerLM`` writes its equations, plain float32 PyTorch.

Pre-LN blocks: ``x + attn(LN(x))`` then ``x + W2·gelu_tanh(W1·LN(x) + b1) + b2``;
learned positional embeddings; a weight-tied head ``ln_f(h) @ wteᵀ``.
Attention is causal softmax(q kᵀ / √D) v over ``H`` heads of width
``D = d / H``, from one fused ``[d, 3d]`` projection whose columns are
``[q heads | k heads | v heads]``, each head-major, and an output projection;
neither projection has a bias.  LayerNorm uses epsilon 1e-6.  These two
departures from GPT-2 (its qkv and output projections have biases, its
epsilon is 1e-5) are the program's, and the configuration lists them.

The loss is the mean next-token cross-entropy over the real sequences of
a batch.  A batch is run in micro-batches of ``BLOCK_TOKENS`` tokens (at
least one sequence) with the gradient summed, so that the float32
attention scores fit on one card.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

LN_EPSILON = 1e-6
BLOCK_TOKENS = 1024


def variable_shapes(cfg: dict) -> Dict[str, Dict[str, Tuple[int, ...]]]:
    d, v, n = cfg["n_embd"], cfg["vocab_size"], cfg["n_layer"]
    p = {"wte.embedding": (v, d), "wpe.embedding": (cfg["n_positions"], d)}
    for i in range(n):
        b = f"Block_{i}"
        p[f"{b}.LayerNorm_0.scale"] = (d,)
        p[f"{b}.LayerNorm_0.bias"] = (d,)
        p[f"{b}.MultiHeadAttention_0.Dense_0.kernel"] = (d, 3 * d)
        p[f"{b}.MultiHeadAttention_0.Dense_1.kernel"] = (d, d)
        p[f"{b}.LayerNorm_1.scale"] = (d,)
        p[f"{b}.LayerNorm_1.bias"] = (d,)
        p[f"{b}.Dense_0.kernel"] = (d, 4 * d)
        p[f"{b}.Dense_0.bias"] = (4 * d,)
        p[f"{b}.Dense_1.kernel"] = (4 * d, d)
        p[f"{b}.Dense_1.bias"] = (d,)
    p["ln_f.scale"] = (d,)
    p["ln_f.bias"] = (d,)
    return {"params": p}


def forward_flops_per_token(cfg: dict, seq_len: int) -> float:
    """Matmul FLOPs of one token's forward (2 per multiply-add): per layer
    the qkv and output projections ``2·4d²`` and the MLP ``2·8d²``, the
    scores and values ``2·2·L·d`` (the whole square, as the count this was
    taken from writes it), and the tied head ``2·d·V``; the embedding
    lookup is free."""
    d = cfg["n_embd"]
    return cfg["n_layer"] * (2 * 12 * d * d + 4 * seq_len * d) + 2 * d * cfg["vocab_size"]


def _ln(x, scale, bias):
    return F.layer_norm(x, (x.shape[-1],), scale, bias, LN_EPSILON)


class Transformer:
    """``rounding`` (the control's) rounds every operand of a product and
    every activation: where the program holds a bf16 tensor."""

    def __init__(self, cfg: dict, rounding=None):
        self.cfg = cfg
        self.q = rounding or (lambda t: t)

    def _dense(self, x, w, b=None):
        y = self.q(x) @ self.q(w)
        return self.q(y if b is None else y + b)

    def forward(self, p, tokens):
        cfg = self.cfg
        B, L = tokens.shape
        H = cfg["n_head"]
        d = cfg["n_embd"]
        D = d // H
        q = self.q
        h = q(p["wte.embedding"][tokens.long()] + p["wpe.embedding"][:L][None])
        causal = torch.ones(L, L, dtype=torch.bool, device=tokens.device).tril()
        for i in range(cfg["n_layer"]):
            b = f"Block_{i}"
            a = q(_ln(h, p[f"{b}.LayerNorm_0.scale"], p[f"{b}.LayerNorm_0.bias"]))
            qkv = self._dense(a, p[f"{b}.MultiHeadAttention_0.Dense_0.kernel"])
            hq, hk, hv = qkv.view(B, L, 3, H, D).unbind(2)
            s = torch.einsum("bqhd,bkhd->bhqk", q(hq), q(hk)) / math.sqrt(D)
            s = s.masked_fill(~causal, float("-inf"))
            o = q(torch.einsum("bhqk,bkhd->bqhd", q(torch.softmax(s, -1)), q(hv)))
            h = q(h + self._dense(o.reshape(B, L, d),
                                  p[f"{b}.MultiHeadAttention_0.Dense_1.kernel"]))
            a = q(_ln(h, p[f"{b}.LayerNorm_1.scale"], p[f"{b}.LayerNorm_1.bias"]))
            m = q(F.gelu(self._dense(a, p[f"{b}.Dense_0.kernel"], p[f"{b}.Dense_0.bias"]),
                         approximate="tanh"))
            h = q(h + self._dense(m, p[f"{b}.Dense_1.kernel"], p[f"{b}.Dense_1.bias"]))
        h = q(_ln(h, p["ln_f.scale"], p["ln_f.bias"]))
        return q(h @ q(p["wte.embedding"]).T)

    def loss_and_grads(self, params, stats, x, y, mask):
        """Mean token cross-entropy over the real sequences; returns
        ``(loss_sum, count, grads, stats)`` with ``count`` in tokens."""
        L = x.shape[1]
        count = mask.sum() * L
        denom = count.clamp_min(1.0)
        names = list(params)
        leaves = {k: v.detach().requires_grad_(True) for k in names for v in (params[k],)}
        grads = {k: torch.zeros_like(params[k]) for k in names}
        loss_sum = torch.zeros((), device=x.device, dtype=torch.float64)
        micro = max(1, BLOCK_TOKENS // L)
        for i in range(0, x.shape[0], micro):
            sl = slice(i, i + micro)
            with torch.enable_grad():
                logits = self.forward(leaves, x[sl])
                nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                      y[sl].reshape(-1).long(), reduction="none")
                part = (nll.reshape(y[sl].shape) * mask[sl, None]).sum()
                gs = torch.autograd.grad(part / denom, [leaves[k] for k in names])
            for k, g in zip(names, gs):
                grads[k] += g
            loss_sum += part.detach()
            del logits, nll, gs
        return loss_sum, count, grads, stats
