"""Federated language models (port of ``fedml_tpu/models/rnn.py``;
reference ``fedml_api/model/nlp/rnn.py``).

- ``RNNOriginalFedAvg`` — McMahan et al. Shakespeare next-char model:
  embed(90→8) → 2-layer LSTM(256) → dense(vocab), from the final hidden
  state, or at every step with ``seq_output`` (fed_shakespeare).
- ``RNNStackOverflow`` — the Adaptive Federated Optimization NWP model:
  embed(10004→96) → LSTM(670) → dense 96 → dense 10004, per position.

The LSTM is flax's ``nn.RNN(nn.LSTMCell(H))`` over a zero carry,
written as a per-timestep loop in plain PyTorch (the same code on the
CPU and the card).  The cell's parameters keep flax's names and layout
(``LSTMCell_0.ii.kernel`` … ``LSTMCell_0.ho.bias``: input-side kernels
without bias, hidden-side kernels with one), so a flax tree carries over
unchanged and ``ModelBundle.init`` draws the hidden-side kernels
orthogonal, as flax does.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from fedml_tpu_torch.models.base import Dense, Embed, ModelBundle
from fedml_tpu_torch.utils.device import DeviceLike, resolve_device

_GATES = ("i", "f", "g", "o")


class LSTMCell(nn.Module):
    """flax ``nn.LSTMCell(hidden)`` scanned over ``[B, T, F]`` from a zero
    carry (``nn.RNN``): per step

        i = σ(x·W_ii + h·W_hi + b_hi)   f = σ(x·W_if + h·W_hf + b_hf)
        g = tanh(x·W_ig + h·W_hg + b_hg) o = σ(x·W_io + h·W_ho + b_ho)
        c' = f·c + i·g                  h' = o·tanh(c')

    The four input projections of the whole sequence are one matmul
    before the loop, and the four hidden projections one matmul per step
    (the gate kernels concatenated in i, f, g, o order); returns
    ``[B, T, H]``, every step's ``h'``."""

    def __init__(self, features: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        for gate in _GATES:
            self.add_module(f"i{gate}", Dense(features, hidden, use_bias=False))
            self.add_module(f"h{gate}", Dense(hidden, hidden))

    def forward(self, xs):
        dense = {name: getattr(self, name) for name in
                 (f"{side}{gate}" for side in "ih" for gate in _GATES)}
        w_i = torch.cat([dense[f"i{g}"].kernel for g in _GATES], 1).to(xs.dtype)
        w_h = torch.cat([dense[f"h{g}"].kernel for g in _GATES], 1).to(xs.dtype)
        b_h = torch.cat([dense[f"h{g}"].bias for g in _GATES]).to(xs.dtype)
        proj = xs @ w_i + b_h                       # [B, T, 4H]
        B, T = xs.shape[:2]
        h = c = torch.zeros(B, self.hidden, dtype=xs.dtype, device=xs.device)
        outs = []
        for t in range(T):
            gates = proj[:, t] + h @ w_h
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs.append(h)
        return torch.stack(outs, 1)


class RNNOriginalFedAvg(nn.Module):
    def __init__(self, vocab_size: int = 90, embedding_dim: int = 8,
                 hidden_size: int = 256, seq_output: bool = False):
        super().__init__()
        self.seq_output = seq_output
        self.Embed_0 = Embed(vocab_size, embedding_dim)
        self.LSTMCell_0 = LSTMCell(embedding_dim, hidden_size)
        self.LSTMCell_1 = LSTMCell(hidden_size, hidden_size)
        self.Dense_0 = Dense(hidden_size, vocab_size)

    def forward(self, x, train: bool = False, updates: Optional[dict] = None):
        del train, updates
        h = self.LSTMCell_1(self.LSTMCell_0(self.Embed_0(x)))
        if self.seq_output:
            return self.Dense_0(h)                  # [B, T, V]
        return self.Dense_0(h[:, -1])               # [B, V]


class RNNStackOverflow(nn.Module):
    def __init__(self, vocab_size: int = 10000, num_oov_buckets: int = 1,
                 embedding_size: int = 96, latent_size: int = 670,
                 num_layers: int = 1):
        super().__init__()
        extended = vocab_size + 3 + num_oov_buckets  # pad/bos/eos/oov
        self.num_layers = num_layers
        self.Embed_0 = Embed(extended, embedding_size)
        for layer in range(num_layers):
            self.add_module(f"LSTMCell_{layer}", LSTMCell(
                embedding_size if layer == 0 else latent_size, latent_size))
        self.Dense_0 = Dense(latent_size, embedding_size)
        self.Dense_1 = Dense(embedding_size, extended)

    def forward(self, x, train: bool = False, updates: Optional[dict] = None):
        del train, updates
        h = self.Embed_0(x)
        for layer in range(self.num_layers):
            h = getattr(self, f"LSTMCell_{layer}")(h)
        return self.Dense_1(self.Dense_0(h))       # [B, T, V]


def rnn_shakespeare(seq_len: int = 80, vocab_size: int = 90,
                    seq_output: bool = False,
                    device: DeviceLike = None) -> ModelBundle:
    return ModelBundle(
        module=RNNOriginalFedAvg(vocab_size=vocab_size, seq_output=seq_output),
        input_shape=(seq_len,), device=resolve_device(device),
        input_dtype=torch.int32)


def rnn_stackoverflow(seq_len: int = 20, vocab_size: int = 10000,
                      device: DeviceLike = None) -> ModelBundle:
    return ModelBundle(
        module=RNNStackOverflow(vocab_size=vocab_size),
        input_shape=(seq_len,), device=resolve_device(device),
        input_dtype=torch.int32)
