"""Workloads for measuring the port, and their CLI (counterpart of the repo
root's ``bench.py``).

    python -m fedml_tpu_torch.bench --workload north_star [--rounds-per-call 1]
    python -m fedml_tpu_torch.bench --workload fedllm

Each run prints ONE JSON line with the JAX bench's metric names:
``{"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}``.

- ``build_north_star``: FedAvg over ResNet-56 (Bottleneck [6,6,6]) on
  CIFAR-10-shaped random data (``numpy.random.RandomState(0)``, the JAX
  bench's draws), 10 clients x 24 steps x batch 64, bf16 compute with fp32
  masters, SGD 1e-3 momentum 0.9 wd 1e-3, ``rounds_per_call`` FedAvg
  rounds per call of ``make_multi_round_fn``.  ``conv_variant="kernel"``
  runs every 3x3 conv on the hand-written Hopper conv kernel
  (``models/resnet_tpu.py``), ``"baseline"`` on the library conv
  (``models/resnet.py``), and ``"s2d1"``/``"s2d2"``/``"s2d3"``/``"pad32"``
  on ``resnet_tpu``'s space-to-depth and lane-padding variants (library
  convs, as in JAX).  Reported as samples/s, and against an
  estimated reference-GPU rate of 1500 samples/s (the JAX bench's
  ``vs_baseline``).
- ``build_fedllm``: next-token training of a GPT-2-shaped decoder (default
  width 1280, GPT-2 Large's, 12 layers, 10 heads, L 1024) over a packed
  client axis, bf16 compute, SGD 3e-4.  Its attention is the hand-written
  flash-attention kernel, one launch per layer per forward.  Reported as
  model FLOP utilization against one H100's dense bf16 peak.

Timing (``utils/timing.measure_rounds``): warm up until two consecutive
fully synced calls agree, then the median of ``--rounds`` calls.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from fedml_tpu_torch.utils.device import DeviceLike, resolve_device

# rounds per call (the JAX bench's defaults)
NORTH_STAR_RPC = 80
FEDLLM_RPC = 4
# the JAX bench's estimate of the reference's per-GPU ResNet-56 rate
# (an RTX 2080 Ti-class card, one process per client)
REFERENCE_GPU_SAMPLES_PER_SEC = 1500.0


# the s2d/padding execution variants of resnet_tpu (JAX's bench names), on
# library convs as in JAX
TPU_VARIANTS = {"s2d1": {"s2d_stages": 1}, "s2d2": {"s2d_stages": 2},
                "s2d3": {"s2d_stages": 3}, "pad32": {"pad_stage1_to": 32}}


def _unroll_refusal(flag: str) -> NotImplementedError:
    return NotImplementedError(
        f"{flag} is an unroll factor for XLA's while loop: it changes no result, so "
        "the eager port has no function to port for it; its eager counterpart, a CUDA "
        "graph over a step, is speed work (ROADMAP.md, queue A item 7)")


def build_north_star(
    clients: int = 10,
    batch: int = 64,
    steps: int = 24,
    epochs: int = 1,
    dtype: str = "bf16",
    rounds_per_call: int = NORTH_STAR_RPC,
    conv_variant: str = "kernel",
    device: DeviceLike = None,
):
    """The canonical bench workload.  Returns ``(round_fn, state, args,
    samples_per_call)``: ``round_fn(state, *args)`` runs
    ``rounds_per_call`` rounds; the variables come from seed 0, the key
    is ``PRNGKey(0)``."""
    from fedml_tpu_torch.algorithms.fedavg import (
        ServerState,
        make_multi_round_fn,
        resolve_compute_dtype,
    )
    from fedml_tpu_torch.core.client import make_client_optimizer, make_local_update
    from fedml_tpu_torch.core.rng import PRNGKey

    dev = resolve_device(device)
    if conv_variant == "kernel":
        from fedml_tpu_torch.models.resnet_tpu import resnet56_tpu

        bundle = resnet56_tpu(num_classes=10, device=dev)
    elif conv_variant == "baseline":
        from fedml_tpu_torch.models.resnet import resnet56

        bundle = resnet56(num_classes=10, device=dev)
    elif conv_variant in TPU_VARIANTS:
        from fedml_tpu_torch.models.resnet_tpu import resnet56_tpu

        bundle = resnet56_tpu(num_classes=10, conv_variant="xla", device=dev,
                              **TPU_VARIANTS[conv_variant])
    else:
        raise ValueError(f"conv_variant must be one of "
                         f"{['kernel', 'baseline', *TPU_VARIANTS]}, got {conv_variant!r}")
    opt = make_client_optimizer("sgd", 0.001, momentum=0.9, weight_decay=0.001)
    local_update = make_local_update(
        bundle, opt, epochs=epochs, compute_dtype=resolve_compute_dtype(dtype))
    round_fn = make_multi_round_fn(local_update, rounds_per_call, device=dev)
    rng = np.random.RandomState(0)
    C, S, B = clients, steps, batch
    args = (
        torch.from_numpy(rng.rand(C, S, B, 32, 32, 3).astype(np.float32)).to(dev),
        torch.from_numpy(rng.randint(0, 10, (C, S, B)).astype(np.int32)).to(dev),
        torch.ones((C, S, B), device=dev),
        torch.full((C,), float(S * B), device=dev),
        torch.ones((C,), device=dev),
        np.arange(C, dtype=np.int32),
    )
    state = ServerState(bundle.init(PRNGKey(0)), (), 0,
                        PRNGKey(0))
    return round_fn, state, args, C * S * B * epochs * rounds_per_call


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
    from fedml_tpu_torch.core.rng import PRNGKey
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
    state = ServerState(bundle.init(PRNGKey(0)), (), 0,
                        PRNGKey(0))
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


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="FedAvg local-training throughput of the port (one JSON line)")
    p.add_argument("--workload", choices=["north_star", "fedllm"],
                   default="north_star")
    p.add_argument("--clients", type=int, default=None,
                   help="default: 10 (north_star) / 4 (fedllm)")
    p.add_argument("--batch", type=int, default=None,
                   help="default: 64 (north_star) / 8 (fedllm)")
    p.add_argument("--steps", type=int, default=None,
                   help="default: 24 (north_star) / 4 (fedllm)")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--rounds", type=int, default=4,
                   help="timed calls (the median is reported)")
    p.add_argument("--rounds-per-call", type=int, default=None,
                   help="FedAvg rounds per call of make_multi_round_fn; "
                   f"default {NORTH_STAR_RPC} (north_star) / {FEDLLM_RPC} (fedllm)")
    p.add_argument("--dtype", default="bf16",
                   help="compute dtype of the forward/backward (fp32 masters)")
    p.add_argument("--conv-variant", default="kernel",
                   choices=["kernel", "baseline", *TPU_VARIANTS],
                   help="north_star: kernel (the Hopper conv kernel), baseline (the "
                   "library conv), or resnet_tpu's execution variants on library "
                   "convs: s2dK folds 2x2 pixel blocks into channels through stage K, "
                   "pad32 pads stage 1's 16-wide convs to 32")
    p.add_argument("--unroll", type=int, default=None,
                   help="the JAX step-scan unroll (an XLA loop hint): raises")
    p.add_argument("--client-unroll", type=int, default=None,
                   help="the JAX client-loop unroll (an XLA loop hint): raises")
    p.add_argument("--seq-len", type=int, default=1024)
    p.add_argument("--embed-dim", type=int, default=1280)
    p.add_argument("--num-layers", type=int, default=12)
    p.add_argument("--num-heads", type=int, default=10)
    p.add_argument("--vocab", type=int, default=8192)
    p.add_argument("--remat", action="store_true",
                   help="recompute each transformer block in the backward")
    p.add_argument("--device", default="",
                   help='"" = the CUDA card (raises without one), "cpu" = the CPU')
    return p


def main(argv=None) -> dict:
    from fedml_tpu_torch.utils.timing import PEAK_FLOPS, measure_rounds

    args = _parser().parse_args(argv)
    if args.unroll is not None:
        raise _unroll_refusal("--unroll")
    if args.client_unroll is not None:
        raise _unroll_refusal("--client-unroll")
    defaults = ({"clients": 10, "batch": 64, "steps": 24,
                 "rounds_per_call": NORTH_STAR_RPC}
                if args.workload == "north_star"
                else {"clients": 4, "batch": 8, "steps": 4,
                      "rounds_per_call": FEDLLM_RPC})
    for k, v in defaults.items():
        if getattr(args, k) is None:
            setattr(args, k, v)
    device = args.device or None
    common = dict(clients=args.clients, batch=args.batch, steps=args.steps,
                  epochs=args.epochs, dtype=args.dtype,
                  rounds_per_call=args.rounds_per_call, device=device)
    if args.workload == "fedllm":
        round_fn, state, call_args, tokens_per_call, fpt = build_fedllm(
            seq_len=args.seq_len, vocab=args.vocab, embed_dim=args.embed_dim,
            num_heads=args.num_heads, num_layers=args.num_layers,
            remat=args.remat, **common)
        med, _ = measure_rounds(round_fn, state, call_args, args.rounds)
        flops = tokens_per_call * fpt / med
        mfu = flops / PEAK_FLOPS["bf16"]
        out = {
            "metric": "fedllm_transformer_local_train_mfu",
            "value": 100 * mfu,
            "unit": "percent_of_h100_bf16_peak",
            # the JAX bench's baseline is a TPU measurement; the port has none
            "vs_baseline": None,
            "detail": {
                "tokens_per_s": tokens_per_call / med,
                "model_tflops_per_s": flops / 1e12,
                "flops_per_token": fpt,
                "config": {k: getattr(args, k) for k in (
                    "embed_dim", "num_layers", "num_heads", "seq_len", "vocab",
                    "clients", "batch", "steps", "rounds_per_call", "epochs",
                    "dtype")},
            },
        }
    else:
        round_fn, state, call_args, samples_per_call = build_north_star(
            conv_variant=args.conv_variant, **common)
        med, _ = measure_rounds(round_fn, state, call_args, args.rounds)
        sps = samples_per_call / med
        out = {
            "metric": "fedavg_resnet56_cifar10_local_train_throughput",
            "value": sps,
            "unit": "samples/sec",
            "vs_baseline": sps / REFERENCE_GPU_SAMPLES_PER_SEC,
        }
    dev = resolve_device(device)
    out["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else dev.type)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
