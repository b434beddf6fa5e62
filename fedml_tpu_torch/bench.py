"""Workloads for measuring the port (counterpart of the repo root's
``bench.py``; ``build_north_star`` and the CLI are not ported yet).

``build_fedllm`` is the federated-LLM workload of the ``fedllm`` family:
next-token training of a GPT-2-shaped decoder (default width 1280, GPT-2
Large's, 12 layers, 10 heads, L 1024) over a packed client axis, bf16
compute with fp32 masters, SGD 3e-4, run as ``rounds_per_call`` FedAvg
rounds per call of ``make_multi_round_fn``.  Its attention is the
hand-written flash-attention kernel, one launch per layer per forward.
"""

from __future__ import annotations

import numpy as np
import torch

from fedml_tpu_torch.utils.device import DeviceLike, resolve_device

# rounds per call of the fedllm workload (the JAX bench's default)
FEDLLM_RPC = 4


def build_fedllm(
    clients: int = 4,
    batch: int = 8,
    steps: int = 4,
    seq_len: int = 1024,
    vocab: int = 8192,
    embed_dim: int = 1280,
    num_heads: int = 10,
    num_layers: int = 12,
    epochs: int = 1,
    dtype: str = "bf16",
    rounds_per_call: int = FEDLLM_RPC,
    remat: bool = False,
    device: DeviceLike = None,
):
    """Returns ``(round_fn, state, args, tokens_per_call, flops_per_token)``:
    ``round_fn(state, *args)`` runs ``rounds_per_call`` rounds; the tokens
    are ``numpy.random.RandomState(0)`` draws (the JAX bench's), the
    variables come from seed 0."""
    from fedml_tpu_torch.algorithms.fedavg import (
        ServerState,
        make_multi_round_fn,
        resolve_compute_dtype,
    )
    from fedml_tpu_torch.core.client import make_client_optimizer, make_local_update
    from fedml_tpu_torch.models.transformer import transformer_lm

    dev = resolve_device(device)
    bundle = transformer_lm(
        vocab_size=vocab, embed_dim=embed_dim, num_heads=num_heads,
        num_layers=num_layers, seq_len=seq_len, remat=remat, device=dev,
    )
    opt = make_client_optimizer("sgd", 3e-4)
    local_update = make_local_update(
        bundle, opt, epochs=epochs, compute_dtype=resolve_compute_dtype(dtype),
    )
    round_fn = make_multi_round_fn(local_update, rounds_per_call, device=dev)
    rng = np.random.RandomState(0)
    C, S, B, L = clients, steps, batch, seq_len
    toks = rng.randint(0, vocab, (C, S, B, L)).astype(np.int32)
    args = (
        torch.from_numpy(toks).to(dev),
        torch.from_numpy(np.roll(toks, -1, axis=-1)).to(dev),
        torch.ones((C, S, B), device=dev),
        torch.full((C,), float(S * B * L), device=dev),
        torch.ones((C,), device=dev),
        np.arange(C, dtype=np.int32),
    )
    state = ServerState(bundle.init(torch.Generator().manual_seed(0)), (), 0, 0)
    # exact matmul FLOP accounting, fwd+bwd = 3x fwd (2 FLOPs per
    # multiply-add; the embedding lookup is free, the weight-tied head is a
    # [*, d] @ [d, V] matmul): per layer and token, qkv+proj 2*4d^2, mlp
    # 2*8d^2, attention scores+values 2*2*L*d
    per_token_fwd = (
        num_layers * (2 * 12 * embed_dim**2 + 4 * seq_len * embed_dim)
        + 2 * embed_dim * vocab
    )
    flops_per_token = 3 * per_token_fwd
    tokens_per_call = C * S * B * L * epochs * rounds_per_call
    return round_fn, state, args, tokens_per_call, flops_per_token
