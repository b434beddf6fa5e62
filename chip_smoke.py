#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``fedml_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out PATH]

Phases, in order; any failure exits non-zero:

1. build   — compile every CUDA kernel of the main paths from ``ops/csrc``
             (one nvcc per source, all at once) and print the build seconds.
2. kernels — call each kernel's wrapper at every shape its path gives it,
             hold each result against the plain PyTorch version on the same
             inputs and time kernel, plain version and the library call
             (CUDA-graph replays between CUDA events, so host overhead stays
             out):
             conv3x3_mxu at the 6 ResNet-56 shapes (N=64), fp32 (TF32 off)
             and bf16, with and without moments, plus one epilogue case,
             each case printed with the route it took (``tc``: the
             tensor-core kernel, bf16 past the stem; ``v2``: the CUDA-core
             kernel, fp32 and the 3-channel stem);
             flash_attention_fwd at the fedllm bench shape (B 8, L 1024,
             H 10, D 128, causal) in bf16 and fp32, non-causal once, the
             long-context range L 2048/4096/8192 at B*L = 8192, GPT-2
             small's head width (H 20, D 64), and the experiments/run.py
             shape (L 80, H 4, D 16) in fp32 and bf16, each case printed with the
             route it took (``wgmma``: bf16 with D 64/128; ``mma``: bf16
             with D <= 32; ``fma``: fp32).
3. check   — the kernel-conv ResNet-56 against the library-conv ResNet-56,
             and the flash-kernel transformer against the plain-attention
             transformer, each with the same variables on a small batch
             (fp32, TF32 off, and the transformer once more in bf16, where
             attention takes the wgmma route, against the kernel's own
             arithmetic in plain PyTorch, p rounded to bf16 before P·V,
             at a fixed limit that a planted stale V tile must exceed);
             the flash op's dq/dk/dv
             against autograd through the plain version (fp32), and in
             bf16 against the same backward fed the plain version's O and
             LSE.
4. main    — FedAvg over ResNet-56 (Bottleneck [6,6,6], full width, bf16
             compute, SGD lr 1e-3 momentum 0.9 wd 1e-3) on the CIFAR-10
             stand-in with Dirichlet(0.5) clients: two rounds of 4 clients x
             4 steps through ``make_multi_round_fn``, then one
             ``FedAvgSimulation.run`` round with ``evaluate_global``; the
             conv kernels must have run 19 times per forward, 18 of each
             bf16 training forward's (all but the stem) on the
             tensor-core route (evaluation runs in fp32, on v2).
5. fedllm  — FedAvg over the transformer LM at the bench width
             (``fedml_tpu_torch.bench.build_fedllm``: width 1280, 12 layers,
             10 heads, L 1024, vocab 8192, 4 clients x batch 8 x 4 steps,
             bf16, SGD 3e-4): one warm-up round, then two timed rounds
             through ``make_multi_round_fn``; then ``experiments.run.main``
             for fedllm at its defaults (one round through
             ``FedAvgSimulation``).  The flash kernel must have run once per
             layer per forward, at the bench width every time on the wgmma
             route.

6. rng     — every RNG_CASES draw (threefry bits, uniform, bernoulli,
             randint, permutation at n 1536 and 15360, cifar_augment on 64
             fixed images) on the card, held bitwise against the same call
             on the CPU and against jax 0.9.0's known answers
             (tests/threefry_known_answers.json).
7. north_star — ``fedml_tpu_torch.bench.build_north_star`` at its full cut
             (ResNet-56 on the conv kernel, 10 clients x 24 steps x batch 64,
             bf16), one warm-up round and one timed round; 19 conv launches
             per forward, 18 of them on the tensor-core route.
8. sim     — ``FedAvgSimulation`` over the kernel ResNet-56 (bf16,
             cifar_augment, 4 of 8 clients sampled per round, dropout 0.25,
             3 rounds) run three ways, deterministically: ``run()``; a run
             that checkpoints every round, crashes before round 2 and
             resumes; ``run_fused_sampled``.  All three must end with equal
             variables, bit for bit.  Then ``experiments.run.main`` fedavg at
             a small cut with augmentation on and ``--checkpoint_every 1``.
9. init    — the seeded init (flax's variables under ``PRNGKey(0)``) of
             ResNet-56, a small transformer and the zoo's models (the
             LSTMs' orthogonal kernels: a host QR) drawn on the card,
             bitwise against the same draw on the CPU.
10. compress — [sim]'s configuration with the int8 codec and error
             feedback: ``run()``, crash + ``resume()`` and
             ``run_fused_sampled`` end bit-identical (variables and
             residuals); one round each of int4, topk0.01 + EF and bf16;
             the uplink bytes per upload against the JAX package's; the
             qsgd8 payload of a trained update on the card against the
             CPU's (sha256); the codec stage's time and kernel launches per
             client (fused, and the per-leaf plain version), and its share
             of a 4 x 8 x 64 round, timed in turns with the same round
             without a codec.
11. pack   — the native row-gather packer must have built and loaded; the
             pack time of a 10 x 1536-image cohort, native and numpy.
12. zoo    — the cross-device zoo at full width through
             ``experiments/run.py::run_experiment`` on the card: lr on mnist,
             cnn (CNN_DropOut) on femnist, resnet18_gn on fed_cifar100, the
             2xLSTM(256) on shakespeare and fed_shakespeare, the LSTM(670)
             on stackoverflow_nwp and the multi-label lr on
             stackoverflow_lr, each with the SGD lr and batch of the JAX
             package's convergence record, 3 rounds of 10 sampled clients
             (the first a warm-up); per pair the parameter count, median
             round ms, samples/s (tokens/s for the LSTMs) and final test
             metrics (precision and recall for stackoverflow_lr), all
             finite.  Then one round of 2 clients x 2 steps per model from
             one seed on the card in fp32 (TF32 off), within 1e-4 of each
             leaf's largest magnitude of the same round on the CPU in
             float64 (the CPU's fp32 round printed beside it), and the
             dropout mask card == CPU bitwise.  No zoo path launches the
             conv or flash kernel.

Every kernel's launch counter is zeroed just before each path and read just
after it.  The line before the last is the kernels' JSON record, the line
before that the card's name and power limit; the last line is the device
record.  ``--out`` also writes every per-case number as JSON;
``--profile`` adds a ``torch.profiler`` trace of one round of each main
path (device busy time, idle share, top kernels).
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
import subprocess
import sys
import time

N = 64
# (name, spatial, Cin, Cout, stride, convs of this shape per ResNet-56 forward)
CONV_SHAPES = [
    ("stem", 32, 3, 16, 1, 1),
    ("stage1_body", 32, 16, 16, 1, 6),
    ("stage1to2", 32, 32, 32, 2, 1),
    ("stage2_body", 16, 32, 32, 1, 5),
    ("stage2to3", 16, 64, 64, 2, 1),
    ("stage3_body", 8, 64, 64, 1, 5),
]
# (name, B, L, H, D, dtype, causal): the fedllm bench shape first; B*L = 8192
# across the long-context range; run.py's fedllm defaults (width 64 / 4 heads,
# 80-char windows, batch 64), in fp32 and in bf16 (the mma route)
FLASH_CASES = [
    ("bench", 8, 1024, 10, 128, "bf16", True),
    ("bench", 8, 1024, 10, 128, "fp32", True),
    ("bench_noncausal", 8, 1024, 10, 128, "bf16", False),
    ("long2k", 4, 2048, 10, 128, "bf16", True),
    ("long4k", 2, 4096, 10, 128, "bf16", True),
    ("long8k", 1, 8192, 10, 128, "bf16", True),
    ("bench_d64", 8, 1024, 20, 64, "bf16", True),
    ("run_py", 64, 80, 4, 16, "fp32", True),
    ("run_py_bf16", 64, 80, 4, 16, "bf16", True),
]
BENCH_LAYERS = 12  # flash launches per forward at the bench width
TC_PER_FORWARD = 18  # tensor-core launches per bf16 ResNet-56 forward: every 3x3 conv but the stem
TOL = {"fp32": 1e-4, "bf16": 2e-2}
MOMENT_RTOL = 1e-3
LSE_TOL = 1e-3
# bf16 transformer logits, flash kernel vs the kernel's arithmetic in plain
# PyTorch (attention_as_kernel): at most this many bf16 spacings at the
# largest logit (the card read one; PERF.md)
BF16_LOGITS_ULPS = 2


# threefry and augment draws held bitwise against the CPU and against the
# known answers of jax 0.9.0 in tests/threefry_known_answers.json:
# (name, draw, seed of PRNGKey, arguments)
RNG_CASES = [
    ("bits_s0_4x257", "random_bits", 0, {"shape": (4, 257)}),
    ("bits_s42_3x5x7", "random_bits", 42, {"shape": (3, 5, 7)}),
    ("uniform_s1_1000", "uniform", 1, {"shape": (1000,)}),
    ("bernoulli_s2_p05", "bernoulli", 2, {"p": 0.5, "shape": (1000,)}),
    ("bernoulli_s2_p09", "bernoulli", 2, {"p": 0.9, "shape": (1000,)}),
    ("randint_s3_64x2_9", "randint", 3, {"shape": (64, 2), "lo": 0, "hi": 9}),
    ("randint_s3_1000_33", "randint", 3, {"shape": (1000,), "lo": 0, "hi": 33}),
    ("permutation_s4_1536", "permutation", 4, {"n": 1536}),      # one sort pass
    ("permutation_s5_15360", "permutation", 5, {"n": 15360}),    # two sort passes
    ("cifar_augment_s6_64", "cifar_augment", 6, {"images": 64}),
]
RNG_ANSWERS = "tests/threefry_known_answers.json"

# the cross-device zoo through experiments/run.py: (dataset, model, batch, lr,
# samples per client, tokens per sample or None, number of classes, one
# example's shape).  SGD with no weight decay at the batch and lr of the JAX
# package's convergence record for the pair (CONVERGENCE_r04_mnist_lr,
# _r04_femnist_cnn, _r05_fed_cifar100, _r04_shakespeare_rnn,
# _r05_stackoverflow_nwp); stackoverflow_lr has no record and takes
# mnist-lr's.  Shards are cut to the samples column.
ZOO = [
    ("mnist", "lr", 10, 0.03, 100, None, 10, (784,)),
    ("femnist", "cnn", 20, 0.03, 100, None, 62, (28, 28, 1)),
    ("fed_cifar100", "resnet18_gn", 20, 0.1, 100, None, 100, (24, 24, 3)),
    ("shakespeare", "rnn", 4, 1.0, 32, 80, 90, (80,)),
    ("fed_shakespeare", "rnn", 4, 1.0, 32, 80, 90, (80,)),
    ("stackoverflow_nwp", "rnn", 16, 0.31622776601683794, 64, 20, 10004, (20,)),
    ("stackoverflow_lr", "lr", 10, 0.03, 64, None, 500, (10000,)),
]
ZOO_CLIENTS, ZOO_PER_ROUND, ZOO_ROUNDS, ZOO_TEST = 100, 10, 3, 512
# the card's fp32 round against the CPU's float64 one: max |Δ| of every leaf,
# relative to the leaf's largest magnitude
ZOO_ROUND_RTOL = 1e-4


def augment_images(n: int):
    """The fixed NHWC image tensor of the augment case (numpy's legacy
    stream, stable across numpy versions)."""
    import numpy as np

    return np.random.RandomState(0).standard_normal((n, 32, 32, 3)).astype(np.float32)


def rng_case(draw: str, seed: int, kw: dict, device):
    """One RNG_CASES draw through the port on ``device``, as a numpy array
    in JAX's dtype (uint32 bits, float32, bool, int32)."""
    import numpy as np
    import torch

    from fedml_tpu_torch.core import rng
    from fedml_tpu_torch.data.augment import cifar_augment

    key = rng.PRNGKey(seed)
    if draw == "random_bits":
        return rng.random_bits(key, kw["shape"], device).cpu().numpy().astype(np.uint32)
    if draw == "uniform":
        out = rng.uniform(key, kw["shape"], device)
    elif draw == "bernoulli":
        out = rng.bernoulli(key, kw["p"], kw["shape"], device)
    elif draw == "randint":
        out = rng.randint(key, kw["shape"], kw["lo"], kw["hi"], device)
    elif draw == "permutation":
        out = rng.permutation(key, kw["n"], device).to(torch.int32)
    elif draw == "cifar_augment":
        x = torch.from_numpy(augment_images(kw["images"])).to(device)
        out = cifar_augment()(key, x)
    else:
        raise ValueError(f"unknown draw {draw!r}")
    return out.cpu().numpy()


def answer_of(arr) -> dict:
    """The known-answer record of a draw: dtype, shape, sha256 of its bytes
    and its first 8 values."""
    import hashlib

    import numpy as np

    arr = np.ascontiguousarray(arr)
    return {"dtype": str(arr.dtype), "shape": list(arr.shape),
            "sha256": hashlib.sha256(arr.tobytes()).hexdigest(),
            "head": arr.ravel()[:8].tolist()}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def conv_bound_ms(n, hw, ci, co, stride, dtype_name, moments, epilogue):
    """(ms to move the bytes, ms to do the FLOPs): each input read once and
    each output written once over HBM; FLOPs at the card's peak for the
    type.  The bound is the larger."""
    from fedml_tpu_torch.utils.timing import HBM_BYTES_PER_S, PEAK_FLOPS

    es = 2 if dtype_name == "bf16" else 4
    ho = hw // stride
    nbytes = (n * hw * hw * ci + 9 * ci * co + n * ho * ho * co) * es
    if moments:
        nbytes += 2 * co * 4
    if epilogue:
        nbytes += 2 * co * 4
    flops = 2.0 * n * ho * ho * 9 * ci * co
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / PEAK_FLOPS[dtype_name]


def phase_build():
    from fedml_tpu_torch.ops import build

    t0 = time.perf_counter()
    reports = build.build_all(["conv_mxu", "flash_attention"])
    secs = time.perf_counter() - t0
    print(f"[build] {secs:.2f} s for {sorted(reports) or 'nothing (up to date)'}")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[build] {name}: {line.strip()}")
    return secs


def phase_kernels():
    import torch
    import torch.nn.functional as F

    from fedml_tpu_torch.ops.conv_mxu import conv3x3_mxu, conv3x3_plain
    from fedml_tpu_torch.utils.timing import kernel_ms

    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(0)
    cases = []
    variants = [(d, mom, False) for d in ("fp32", "bf16") for mom in (False, True)]
    for name, hw, ci, co, stride, per_fwd in CONV_SHAPES:
        for dname, moments, epilogue in variants + (
                [("fp32", False, True)] if name == "stage1_body" else []):
            dtype = torch.float32 if dname == "fp32" else torch.bfloat16
            x = torch.randn(N, hw, hw, ci, generator=g).to(dev, dtype)
            w = (torch.randn(3, 3, ci, co, generator=g)
                 * math.sqrt(2.0 / (9 * ci))).to(dev, dtype)
            kw = dict(stride=stride, moments=moments)
            if epilogue:
                kw.update(mul=torch.linspace(0.5, 1.5, co, device=dev),
                          add=torch.linspace(-0.3, 0.3, co, device=dev), relu=True)
            tc_before = conv3x3_mxu.tc_launches
            got = conv3x3_mxu(x, w, **kw)
            route = "tc" if conv3x3_mxu.tc_launches > tc_before else "v2"
            ref = conv3x3_plain(x, w, **kw)
            torch.cuda.synchronize()
            gy, ry = (got[0], ref[0]) if moments else (got, ref)
            gy, ry = gy.float(), ry.float()
            abs_err = (gy - ry).abs().max().item()
            rel_err = ((gy - ry).abs() / ry.abs().clamp_min(1e-6)).max().item()
            tol = TOL[dname]
            if not torch.allclose(gy, ry, rtol=tol, atol=tol):
                fail(f"{name} {dname} moments={moments}: max abs err {abs_err}")
            rec = {"shape": name, "n": N, "hw": hw, "cin": ci, "cout": co,
                   "stride": stride, "dtype": dname, "moments": moments,
                   "epilogue": epilogue, "per_forward": per_fwd, "route": route,
                   "max_abs_err": abs_err, "max_rel_err": rel_err}
            if moments:
                # sum is compared against Σ|y| (its scale: a channel's sum
                # may cancel to ~0); sumsq is all-positive, so plainly relative
                scale = ry.abs().sum((0, 1, 2))
                s_err = ((got[1] - ref[1]).abs() / scale.clamp_min(1e-6)).max().item()
                sq_err = ((got[2] - ref[2]).abs() / ref[2].abs().clamp_min(1e-6)).max().item()
                if s_err > MOMENT_RTOL or sq_err > MOMENT_RTOL:
                    fail(f"{name} {dname} moments: rel err sum {s_err} sumsq {sq_err}")
                rec.update(sum_rel_err=s_err, sumsq_rel_err=sq_err)
            wn = w.permute(3, 2, 0, 1)
            xn = x.permute(0, 3, 1, 2)
            rec["ms"] = kernel_ms(lambda: conv3x3_mxu(x, w, **kw))
            rec["plain_ms"] = kernel_ms(lambda: conv3x3_plain(x, w, **kw))
            rec["library_ms"] = kernel_ms(
                lambda: F.conv2d(xn, wn, stride=stride, padding=1))
            rec["bytes_ms"], rec["ops_ms"] = conv_bound_ms(
                N, hw, ci, co, stride, dname, moments, epilogue)
            rec["bound_ms"] = max(rec["bytes_ms"], rec["ops_ms"])
            cases.append(rec)
            print(f"[kernels] {name:12s} {dname} mom={int(moments)} epi={int(epilogue)} {route} "
                  f"abs {abs_err:.3g} rel {rel_err:.3g} | kernel {rec['ms']:.4f} ms "
                  f"plain {rec['plain_ms']:.4f} library {rec['library_ms']:.4f} "
                  f"bound {rec['bound_ms']:.4f}")
    return cases


def phase_check():
    """Kernel-conv ResNet-56 vs library-conv ResNet-56, same variables."""
    import torch

    from fedml_tpu_torch.core.rng import PRNGKey
    from fedml_tpu_torch.models.resnet import resnet56
    from fedml_tpu_torch.models.resnet_tpu import resnet56_tpu

    kern, base = resnet56_tpu(conv_variant="kernel"), resnet56()
    variables = kern.init(PRNGKey(1))
    x = torch.randn(8, 32, 32, 3, generator=torch.Generator().manual_seed(2)).cuda()
    with torch.no_grad():
        le, lb = kern.apply_eval(variables, x), base.apply_eval(variables, x)
        te, nve = kern.apply_train(variables, x)
        tb, nvb = base.apply_train(variables, x)
    err_eval = (le - lb).abs().max().item()
    err_train = (te - tb).abs().max().item()
    err_stats = max((nve["batch_stats"][k] - nvb["batch_stats"][k]).abs().max().item()
                    for k in nvb["batch_stats"])
    print(f"[check] ResNet-56 kernel vs library convs: eval logits {err_eval:.3g}, "
          f"train logits {err_train:.3g}, batch_stats {err_stats:.3g}")
    if not (torch.allclose(le, lb, rtol=1e-3, atol=1e-3)
            and torch.allclose(te, tb, rtol=1e-3, atol=1e-3) and err_stats < 1e-3):
        fail("kernel-conv ResNet-56 disagrees with the library-conv model")


def phase_flash_kernels():
    import torch
    import torch.nn.functional as F

    from fedml_tpu_torch.ops.flash_attention import (
        _flash_plan, attention_plain, flash_attention_fwd)
    from fedml_tpu_torch.utils.timing import flash_bound_ms, kernel_ms

    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(1)
    cases = []
    for name, b, L, h, d, dname, causal in FLASH_CASES:
        dtype = torch.float32 if dname == "fp32" else torch.bfloat16
        # the strided column blocks of one fused QKV projection, as the
        # transformer hands them to the kernel
        qkv = torch.randn(b, L, 3, h, d, generator=g).to(dev, dtype)
        q, k, v = qkv.unbind(2)
        wg_before = flash_attention_fwd.wgmma_launches
        o, lse = flash_attention_fwd(q, k, v, causal=causal)
        route = ("wgmma" if flash_attention_fwd.wgmma_launches > wg_before
                 else "mma" if dname == "bf16" else "fma")
        if route != _flash_plan(dtype, d, L, L, causal).route:
            fail(f"flash {name} {dname}: took the {route} route")
        ro, rlse = attention_plain(q, k, v, causal)
        torch.cuda.synchronize()
        err = (o.float() - ro.float()).abs().max().item()
        lse_err = (lse - rlse).abs().max().item()
        tol = TOL[dname]
        if not (torch.allclose(o.float(), ro.float(), rtol=tol, atol=tol)
                and torch.allclose(lse, rlse, rtol=LSE_TOL, atol=LSE_TOL)):
            fail(f"flash {name} {dname}: max abs err O {err}, LSE {lse_err}")
        del ro, rlse
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        rec = {"case": name, "b": b, "l": L, "h": h, "d": d, "dtype": dname,
               "causal": causal, "route": route, "max_abs_err": err,
               "lse_max_abs_err": lse_err,
               "ms": kernel_ms(lambda: flash_attention_fwd(q, k, v, causal=causal)),
               "plain_ms": kernel_ms(lambda: attention_plain(q, k, v, causal), reps=5),
               "library_ms": kernel_ms(lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=causal))}
        rec["bytes_ms"], rec["ops_ms"] = flash_bound_ms(b, L, L, h, d, dname, causal)
        rec["bound_ms"] = max(rec["bytes_ms"], rec["ops_ms"])
        cases.append(rec)
        print(f"[kernels] flash {name:15s} B{b} L{L} H{h} D{d} {dname} causal={int(causal)} "
              f"{route} O abs {err:.3g} LSE abs {lse_err:.3g} | kernel {rec['ms']:.4f} ms "
              f"plain {rec['plain_ms']:.4f} library {rec['library_ms']:.4f} "
              f"bound {rec['bound_ms']:.4f} ({'bytes' if rec['bytes_ms'] >= rec['ops_ms'] else 'ops'})")
        del qkv, q, k, v, o, lse
        torch.cuda.empty_cache()
    return cases


def attention_as_kernel(q, k, v, causal, bn: int = 128):
    """The wgmma kernel's arithmetic in plain PyTorch over [B, L, H, D]:
    fp32 scores in the log2 domain, a running row max per ``bn``-key tile,
    p = 2^(s·log2(e)/√D − m) rounded to bf16 before P·V while the row sum
    takes fp32 p, acc rescaled per tile, O = acc / max(l, 1e-30) in the
    input dtype.  Only the fp32 summation order differs from the kernel's."""
    import torch

    from fedml_tpu_torch.ops.flash_attention import NEG_INF

    lq, lk, d = q.shape[1], k.shape[1], q.shape[3]
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))
    c = math.log2(math.e) / math.sqrt(d)
    m = torch.full(qf.shape[:3] + (1,), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    qpos = torch.arange(lq, device=q.device)[:, None]
    for j in range(0, lk, bn):
        s = qf @ kf[:, :, j:j + bn].transpose(-1, -2)
        if causal:
            s = s.masked_fill(j + torch.arange(s.shape[-1], device=q.device) > qpos, NEG_INF)
        mn = torch.maximum(m, s.amax(-1, keepdim=True) * c)
        alpha = torch.exp2(m - mn)
        p = torch.exp2(s * c - mn)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(torch.bfloat16).float() @ vf[:, :, j:j + bn]
        m = mn
    return (acc / l.clamp_min(1e-30)).transpose(1, 2).to(q.dtype)


def phase_flash_check():
    """The flash-kernel transformer against the plain-attention one (same
    variables, fp32), and the op's gradients against autograd through the
    plain version."""
    import torch

    from fedml_tpu_torch.core.rng import PRNGKey
    from fedml_tpu_torch.models.transformer import transformer_lm
    from fedml_tpu_torch.ops.flash_attention import (
        _flash_bwd, attention_plain, flash_attention_fwd, flash_attention_with_lse)

    kw = dict(vocab_size=8192, embed_dim=1280, num_heads=10, num_layers=2,
              seq_len=1024)
    kern = transformer_lm(**kw)
    plain = transformer_lm(**kw, attn_fn=lambda q, k, v, c: attention_plain(q, k, v, c)[0])
    variables = kern.init(PRNGKey(3))
    x = torch.randint(0, 8192, (2, 1024), generator=torch.Generator().manual_seed(4)).cuda()
    before = flash_attention_fwd.launches
    with torch.no_grad():
        lk, lp = kern.apply_eval(variables, x), plain.apply_eval(variables, x)
    err = (lk - lp).abs().max().item()
    print(f"[check] transformer (width 1280, 2 layers, L 1024) flash kernel vs plain "
          f"attention: logits max abs err {err:.3g}")
    if flash_attention_fwd.launches - before != 2:
        fail("the kernel transformer did not launch the flash kernel once per layer")
    if not torch.allclose(lk, lp, rtol=1e-3, atol=1e-3):
        fail("the flash-kernel transformer disagrees with the plain-attention one")
    # the same model in bf16, where attention takes the wgmma route, against
    # the kernel's arithmetic in plain PyTorch (p rounded to bf16 before P·V,
    # as the TPU kernel rounds it too); the same reference with one stale V
    # tile (keys 128-255 multiplied by keys 0-127's V: a ring stage read
    # before it was refilled) must fall outside the tolerance
    def stale_v_tile(q, k, v, c):
        v = v.clone()
        v[:, 128:256] = v[:, :128]
        return attention_as_kernel(q, k, v, c)

    as_kernel = transformer_lm(**kw, attn_fn=attention_as_kernel)
    faulty = transformer_lm(**kw, attn_fn=stale_v_tile)
    half = {"params": {n: t.to(torch.bfloat16) for n, t in variables["params"].items()}}
    before = flash_attention_fwd.wgmma_launches
    with torch.no_grad():
        lkh = kern.apply_eval(half, x).float()
        lrh, lfh, lph = (m.apply_eval(half, x).float() for m in (as_kernel, faulty, plain))
    err, fault_err, p_err = ((a - lrh).abs().max().item() for a in (lkh, lfh, lph))
    top = lrh.abs().max().item()
    limit = BF16_LOGITS_ULPS * 2.0 ** (math.floor(math.log2(top)) - 7)
    print(f"[check] transformer bf16 logits (max |logit| {top:.4g}) max abs err: flash "
          f"kernel (wgmma) vs its arithmetic in plain PyTorch {err:.4g} (limit {limit:.4g}, "
          f"{BF16_LOGITS_ULPS} bf16 spacings); a stale V tile {fault_err:.4g}; plain "
          f"attention (fp32 p) {p_err:.4g}; flash kernel vs plain attention "
          f"{(lkh - lph).abs().max().item():.4g}")
    if flash_attention_fwd.wgmma_launches - before != 2:
        fail("the bf16 transformer did not take the wgmma route once per layer")
    if not err <= limit:
        fail("the bf16 flash-kernel transformer disagrees with the kernel's arithmetic")
    if not fault_err > limit:
        fail("the bf16 transformer check cannot tell a stale V tile from the kernel")

    g = torch.Generator().manual_seed(5)
    q, k, v, cot = (torch.randn(2, 1024, 10, 128, generator=g).cuda() for _ in range(4))
    w = torch.randn(2, 10, 1024, generator=g).cuda()
    for causal in (True, False):
        def grads(fn):
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            o, lse = fn(*leaves)
            return torch.autograd.grad((o * cot).sum() + (lse * w).sum(), leaves)

        got = grads(lambda a, b, c: flash_attention_with_lse(a, b, c, causal, 1024, 1024))
        want = grads(lambda a, b, c: attention_plain(a, b, c, causal))
        errs = [(a - b).abs().max().item() for a, b in zip(got, want)]
        print(f"[check] flash dq/dk/dv vs autograd through plain (B2 L1024 H10 D128 fp32, "
              f"causal={int(causal)}, loss uses O and LSE): max abs err "
              + " ".join(f"{e:.3g}" for e in errs))
        if not all(torch.allclose(a, b, rtol=1e-3, atol=1e-3) for a, b in zip(got, want)):
            fail("flash backward disagrees with autograd through the plain version")
        # bf16: the wgmma forward's O and LSE through the backward, against
        # the same backward fed the plain version's O and LSE
        qb, kb, vb, cotb = (t.to(torch.bfloat16) for t in (q, k, v, cot))
        before = flash_attention_fwd.wgmma_launches
        leaves = [t.clone().requires_grad_(True) for t in (qb, kb, vb)]
        o, lse = flash_attention_with_lse(*leaves, causal, 1024, 1024)
        got = torch.autograd.grad((o * cotb).sum() + (lse * w).sum(), leaves)
        ro, rlse = attention_plain(qb, kb, vb, causal)
        want = _flash_bwd(qb, kb, vb, ro, rlse, cotb, w, causal, 1024)
        errs = [(a.float() - b.float()).abs().max().item() for a, b in zip(got, want)]
        print(f"[check] flash dq/dk/dv from the wgmma forward vs the plain forward (bf16, "
              f"causal={int(causal)}): max abs err " + " ".join(f"{e:.3g}" for e in errs))
        if flash_attention_fwd.wgmma_launches - before != 1:
            fail("the bf16 flash op did not take the wgmma route")
        if not all(torch.allclose(a.float(), b.float(), rtol=TOL["bf16"], atol=TOL["bf16"])
                   for a, b in zip(got, want)):
            fail("the backward of the wgmma forward disagrees with that of the plain one")


def reset_launches():
    from fedml_tpu_torch.ops.conv_mxu import conv3x3_mxu
    from fedml_tpu_torch.ops.flash_attention import flash_attention_fwd

    conv3x3_mxu.launches = 0
    conv3x3_mxu.tc_launches = 0
    flash_attention_fwd.launches = 0
    flash_attention_fwd.wgmma_launches = 0


def read_launches() -> dict:
    from fedml_tpu_torch.ops.conv_mxu import conv3x3_mxu
    from fedml_tpu_torch.ops.flash_attention import flash_attention_fwd

    return {"conv3x3_mxu": conv3x3_mxu.launches,
            "conv3x3_mxu_tc": conv3x3_mxu.tc_launches,
            "flash_attention_fwd": flash_attention_fwd.launches,
            "flash_attention_fwd_wgmma": flash_attention_fwd.wgmma_launches}


def profile_round(fn, state, args):
    """One round under ``torch.profiler``: wall time, the device time of
    every CUDA kernel, the device's idle share, and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, m = fn(state, *args)
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    own = {}  # this repo's kernels, by kernel name prefix
    for e in kernels:
        for name in ("conv3x3_tc_kernel", "conv3x3_kernel", "moments_reduce_kernel",
                     "flash_fwd"):
            if name in e.key:
                own[name] = own.get(name, 0.0) + e.self_device_time_total / 1e3
    rec = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": 1.0 - busy_ms / wall_ms, "own_kernels_ms": own,
           "kernel_launches": sum(e.count for e in kernels),
           "top_kernels": [{"name": e.key[:120], "count": e.count,
                            "device_ms": e.self_device_time_total / 1e3}
                           for e in top]}
    print(f"[profile] one round: wall {wall_ms:.1f} ms, "
          f"device busy {busy_ms:.1f} ms, idle share {rec['device_idle_share']:.3f}, "
          f"{rec['kernel_launches']} kernel launches; this repo's kernels (ms): {own}")
    for t in rec["top_kernels"]:
        print(f"[profile]   {t['device_ms']:9.3f} ms  x{t['count']:<6d} {t['name']}")
    return rec


def phase_main(profile: bool):
    import numpy as np
    import torch

    from fedml_tpu_torch.algorithms.fedavg import (
        FedAvgConfig, FedAvgSimulation, ServerState, make_multi_round_fn)
    from fedml_tpu_torch.core.client import make_client_optimizer, make_local_update
    from fedml_tpu_torch.core.rng import PRNGKey
    from fedml_tpu_torch.core.types import device_resident_pack
    from fedml_tpu_torch.data.cifar import load_cifar10
    from fedml_tpu_torch.models.resnet_tpu import resnet56_tpu

    clients, steps, rounds, batch = 4, 4, 2, 64
    ds = load_cifar10(num_clients=clients, partition="hetero",
                      partition_alpha=0.5, seed=0)
    bundle = resnet56_tpu(conv_variant="kernel")
    opt = make_client_optimizer("sgd", 0.001, momentum=0.9, weight_decay=1e-3)
    lu = make_local_update(bundle, opt, epochs=1, compute_dtype=torch.bfloat16)
    ids = np.arange(clients)
    (x, y, m, ns), _ = device_resident_pack(
        ds, ids, batch, steps_per_epoch=steps, seed=0, device=torch.device("cuda"))
    part = torch.ones(clients, device="cuda")
    state = ServerState(bundle.init(PRNGKey(0)), (), 0, PRNGKey(0))
    before = {k: v.clone() for k, v in state.variables["params"].items()}
    fused = make_multi_round_fn(lu, rounds)
    state, _ = make_multi_round_fn(lu, 1)(state, x, y, m, ns, part, ids)  # warm-up
    torch.cuda.synchronize()

    reset_launches()
    t0 = time.perf_counter()
    state, metrics = fused(state, x, y, m, ns, part, ids)
    loss = metrics["loss_sum"].cpu().numpy() / metrics["count"].cpu().numpy()
    secs = time.perf_counter() - t0
    seen1 = read_launches()
    run1, tc1 = seen1["conv3x3_mxu"], seen1["conv3x3_mxu_tc"]
    fwd1 = clients * steps * rounds
    changed = max((state.variables["params"][k] - before[k]).abs().max().item()
                  for k in before)
    sps = clients * steps * batch * rounds / secs
    print(f"[main] make_multi_round_fn: {rounds} rounds x {clients} clients x {steps} "
          f"steps x {batch}: {secs:.3f} s, {sps:.1f} samples/s, loss per round "
          f"{loss.tolist()}, max |param change| {changed:.3g}, "
          f"conv3x3_mxu launches {run1} ({tc1} tensor-core) for {fwd1} forwards")
    if not np.all(np.isfinite(loss)):
        fail(f"non-finite training loss {loss}")
    if not changed > 0:
        fail("the model did not change")
    if run1 != 19 * fwd1:
        fail(f"conv3x3_mxu launched {run1} times, expected {19 * fwd1}")
    if tc1 != TC_PER_FORWARD * fwd1:
        fail(f"conv3x3_mxu took the tensor-core route {tc1} times, "
             f"expected {TC_PER_FORWARD * fwd1}")
    prof = (profile_round(make_multi_round_fn(lu, 1), state,
                          (x, y, m, ns, part, ids)) if profile else None)

    cfg = FedAvgConfig(num_clients=clients, clients_per_round=clients,
                       comm_rounds=1, epochs=1, batch_size=batch, lr=0.001,
                       momentum=0.9, weight_decay=1e-3, frequency_of_the_test=1,
                       seed=0, compute_dtype="bf16")
    sim = FedAvgSimulation(bundle, ds, cfg)
    reset_launches()
    t0 = time.perf_counter()
    row = sim.run(1)[-1]
    secs2 = time.perf_counter() - t0
    seen2 = read_launches()
    run2, tc2 = seen2["conv3x3_mxu"], seen2["conv3x3_mxu_tc"]
    eval_steps = math.ceil(ds.test_data_num / max(batch, 64))
    train2 = clients * sim.steps_per_epoch
    fwd2 = train2 + eval_steps
    print(f"[main] FedAvgSimulation.run: 1 round, {clients} clients x "
          f"{sim.steps_per_epoch} steps + eval {eval_steps} batches: {secs2:.3f} s; "
          f"train_loss {row['train_loss']:.4f} test_acc {row['test_acc']:.4f} "
          f"test_loss {row['test_loss']:.4f}; conv3x3_mxu launches {run2} "
          f"({tc2} tensor-core) for {fwd2} forwards")
    if not (math.isfinite(row["train_loss"]) and math.isfinite(row["test_loss"])):
        fail(f"non-finite simulation metrics {row}")
    if run2 != 19 * fwd2:
        fail(f"conv3x3_mxu launched {run2} times, expected {19 * fwd2}")
    if tc2 != TC_PER_FORWARD * train2:
        fail(f"conv3x3_mxu took the tensor-core route {tc2} times, "
             f"expected {TC_PER_FORWARD * train2}")
    if seen1["flash_attention_fwd"] or seen2["flash_attention_fwd"]:
        fail("the ResNet-56 path launched the flash kernel")
    return {"launches": run1 + run2, "tc_launches": tc1 + tc2, "samples_per_s": sps,
            "multi_round_s": secs, "simulation_round_s": secs2, "profile": prof}


def phase_fedllm(profile: bool):
    import tempfile

    import numpy as np
    import torch

    from fedml_tpu_torch.algorithms.fedavg import make_multi_round_fn
    from fedml_tpu_torch.bench import build_fedllm
    from fedml_tpu_torch.core.types import cohort_steps_per_epoch
    from fedml_tpu_torch.experiments import run
    from fedml_tpu_torch.experiments.registry import load_data

    clients, steps, rounds = 4, 4, 2
    t0 = time.perf_counter()
    warm, state, args, tokens_per_round, flops_per_token = build_fedllm(
        clients=clients, steps=steps, rounds_per_call=1)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    before = {k: v.clone() for k, v in state.variables["params"].items()}
    state, _ = warm(state, *args)  # warm-up round
    torch.cuda.synchronize()
    fused = make_multi_round_fn(None, rounds, round_fn=warm, device="cuda")
    torch.cuda.reset_peak_memory_stats()

    reset_launches()
    t0 = time.perf_counter()
    state, metrics = fused(state, *args)
    loss = (metrics["loss_sum"] / metrics["count"]).cpu().numpy().ravel()
    secs = time.perf_counter() - t0
    seen = read_launches()
    fwd = clients * steps * rounds
    changed = max((state.variables["params"][k] - before[k]).abs().max().item()
                  for k in before)
    del before
    tokens = tokens_per_round * rounds
    rec = {"setup_s": setup_s, "rounds_s": secs, "tokens": tokens,
           "tokens_per_s": tokens / secs,
           "model_tflops": tokens * flops_per_token / secs / 1e12,
           "flops_per_token": flops_per_token, "loss": loss.tolist(),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": seen}
    print(f"[fedllm] build_fedllm (width 1280, 12 layers, 10 heads, L 1024, vocab 8192, "
          f"bf16): setup {setup_s:.2f} s; {rounds} rounds x {clients} clients x {steps} "
          f"steps x batch 8: {secs:.3f} s, {rec['tokens_per_s']:.1f} tokens/s, model "
          f"TFLOP/s {rec['model_tflops']:.2f}, loss per round {rec['loss']}, max |param "
          f"change| {changed:.3g}, peak memory {rec['peak_mem_gb']:.2f} GB, launches {seen} "
          f"for {fwd} forwards")
    if not np.all(np.isfinite(loss)):
        fail(f"non-finite fedllm training loss {loss}")
    if not changed > 0:
        fail("the transformer did not change")
    if seen["flash_attention_fwd"] != BENCH_LAYERS * fwd:
        fail(f"flash_attention_fwd launched {seen['flash_attention_fwd']} times, "
             f"expected {BENCH_LAYERS * fwd}")
    if seen["flash_attention_fwd_wgmma"] != BENCH_LAYERS * fwd:
        fail(f"flash_attention_fwd took the wgmma route "
             f"{seen['flash_attention_fwd_wgmma']} times, expected {BENCH_LAYERS * fwd}")
    if seen["conv3x3_mxu"]:
        fail("the fedllm path launched the conv kernel")
    rec["profile"] = profile_round(warm, state, args) if profile else None
    del state, warm, fused, args
    torch.cuda.empty_cache()

    # experiments/run.py at its fedllm defaults: the expected launches follow
    # from its data (train forwards of the sampled clients + eval batches)
    cfg = run.ExperimentConfig(algorithm="fedllm", dataset="fed_shakespeare")
    ds = load_data(cfg.dataset, cfg.data_dir, cfg.client_num_in_total,
                   cfg.partition_method, cfg.partition_alpha, cfg.seed)
    fwd2 = (cfg.client_num_per_round * cfg.epochs
            * cohort_steps_per_epoch(ds, cfg.batch_size)
            + math.ceil(ds.test_data_num / max(cfg.batch_size, 64)))
    with tempfile.TemporaryDirectory() as run_dir:
        reset_launches()
        t0 = time.perf_counter()
        out = run.main(["--algorithm", "fedllm", "--dataset", "fed_shakespeare",
                        "--comm_round", "1", "--run_dir", run_dir])
        secs2 = time.perf_counter() - t0
        seen2 = read_launches()
    final = out["final"]
    print(f"[fedllm] experiments.run.main fedllm (width {cfg.embed_dim}, {cfg.num_layers} "
          f"layers, {cfg.num_heads} heads, L {ds.train_x.shape[1]}): 1 round {secs2:.3f} s; "
          f"train_loss {final['train_loss']:.4f} test_loss {final['test_loss']:.4f}; "
          f"launches {seen2} for {fwd2} forwards")
    if not (math.isfinite(final["train_loss"]) and math.isfinite(final["test_loss"])):
        fail(f"non-finite run.main fedllm metrics {final}")
    if seen2["flash_attention_fwd"] != cfg.num_layers * fwd2:
        fail(f"run.main launched flash {seen2['flash_attention_fwd']} times, "
             f"expected {cfg.num_layers * fwd2}")
    rec.update(run_main_s=secs2, run_main_launches=seen2)
    rec["flash_launches"] = seen["flash_attention_fwd"] + seen2["flash_attention_fwd"]
    rec["flash_wgmma_launches"] = (seen["flash_attention_fwd_wgmma"]
                                   + seen2["flash_attention_fwd_wgmma"])
    return rec


def phase_rng():
    """RNG_CASES on the card against the CPU and the known answers."""
    import os

    import torch

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), RNG_ANSWERS)) as f:
        answers = json.load(f)["answers"]
    recs = []
    for name, draw, seed, kw in RNG_CASES:
        t0 = time.perf_counter()
        got = rng_case(draw, seed, kw, torch.device("cuda"))
        card_ms = 1e3 * (time.perf_counter() - t0)
        cpu = rng_case(draw, seed, kw, "cpu")
        same_cpu = got.dtype == cpu.dtype and got.tobytes() == cpu.tobytes()
        same_jax = answer_of(got) == answers[name]
        print(f"[rng] {name:22s} {draw:13s} {got.dtype} {tuple(got.shape)}: card == cpu "
              f"{same_cpu}, == jax 0.9.0 known answer {same_jax} ({card_ms:.2f} ms incl. copy)")
        if not (same_cpu and same_jax):
            fail(f"rng case {name}: the card's draw is not the CPU's and jax's bits")
        recs.append({"case": name, "draw": draw, "card_ms": card_ms})
    return recs


def phase_north_star(profile: bool):
    """build_north_star at its own cut, one warm-up and one timed round."""
    import numpy as np
    import torch

    from fedml_tpu_torch.bench import build_north_star

    clients, steps, batch = 10, 24, 64
    t0 = time.perf_counter()
    round_fn, state, args, samples = build_north_star(
        clients=clients, steps=steps, batch=batch, rounds_per_call=1,
        conv_variant="kernel")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, m = round_fn(state, *args)  # warm-up round
    float(m["loss_sum"].sum())
    warm_s = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    state, m = round_fn(state, *args)
    loss = (m["loss_sum"] / m["count"]).cpu().numpy()
    secs = time.perf_counter() - t0
    seen = read_launches()
    fwd = clients * steps
    sps = samples / secs
    rec = {"setup_s": setup_s, "warmup_round_s": warm_s, "round_s": secs,
           "samples_per_s": sps, "step_ms": 1e3 * secs / fwd, "loss": loss.tolist(),
           "launches": seen["conv3x3_mxu"], "tc_launches": seen["conv3x3_mxu_tc"],
           "forwards": fwd}
    print(f"[north_star] build_north_star(conv_variant='kernel'): {clients} clients x "
          f"{steps} steps x batch {batch}, bf16: setup {setup_s:.2f} s, warm-up round "
          f"{warm_s:.3f} s, timed round {secs:.3f} s = {sps:.1f} samples/s "
          f"({rec['step_ms']:.2f} ms per step), loss {loss.tolist()}, conv3x3_mxu "
          f"launches {seen['conv3x3_mxu']} ({seen['conv3x3_mxu_tc']} tensor-core) for "
          f"{fwd} forwards")
    if not np.all(np.isfinite(loss)):
        fail(f"non-finite north-star loss {loss}")
    if seen["conv3x3_mxu"] != 19 * fwd or seen["conv3x3_mxu_tc"] != TC_PER_FORWARD * fwd:
        fail(f"north star: conv launches {seen}, expected {19 * fwd} "
             f"({TC_PER_FORWARD * fwd} tensor-core)")
    if seen["flash_attention_fwd"]:
        fail("the north-star path launched the flash kernel")
    rec["profile"] = profile_round(round_fn, state, args) if profile else None
    del state, args, round_fn
    torch.cuda.empty_cache()
    return rec


def phase_sim(step_ms: float):
    """FedAvgSimulation with augmentation, sampled cohorts and dropout:
    run(), crash + resume, and run_fused_sampled, bit for bit.  ``step_ms``
    is the north star's step time, which the augment and threefry costs
    per client-epoch are printed beside."""
    import tempfile

    import numpy as np
    import torch

    from fedml_tpu_torch.algorithms.fedavg import (
        FedAvgConfig, FedAvgSimulation, InjectedCrash)
    from fedml_tpu_torch.core import rng
    from fedml_tpu_torch.core.checkpoint import CheckpointManager
    from fedml_tpu_torch.data.augment import cifar_augment
    from fedml_tpu_torch.data.cifar import load_cifar10
    from fedml_tpu_torch.experiments import run
    from fedml_tpu_torch.experiments.registry import shrink_dataset
    from fedml_tpu_torch.models.resnet_tpu import resnet56_tpu

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    ds = shrink_dataset(load_cifar10(num_clients=8, partition="hetero",
                                     partition_alpha=0.5, seed=0), 128, 256)
    cfg = FedAvgConfig(num_clients=8, clients_per_round=4, comm_rounds=3, epochs=1,
                       batch_size=64, lr=0.001, momentum=0.9, weight_decay=1e-3,
                       frequency_of_the_test=1, seed=0, compute_dtype="bf16",
                       drop_prob=0.25)

    def sim():
        return FedAvgSimulation(resnet56_tpu(conv_variant="kernel"), ds, cfg,
                                augment_fn=cifar_augment())

    a = sim()
    reset_launches()
    t0 = time.perf_counter()
    hist = a.run()
    run_s = time.perf_counter() - t0
    seen = read_launches()
    train_fwd = cfg.comm_rounds * cfg.clients_per_round * a.steps_per_epoch
    eval_fwd = cfg.comm_rounds * math.ceil(len(ds.test_y) / 64)
    with tempfile.TemporaryDirectory() as ck:
        b = sim()
        b.attach_checkpointing(CheckpointManager(ck), every=1)
        b.crash_at_round = 2
        try:
            b.run()
            fail("the scheduled crash did not happen")
        except InjectedCrash as crash:
            crashed_at = crash.round_idx
        saved = sorted(os.listdir(ck))
        b = sim()
        b.attach_checkpointing(CheckpointManager(ck), every=1)
        resumed_from = b.resume()
        b.run(cfg.comm_rounds - resumed_from)
    c = sim()
    c.run_fused_sampled(rounds_per_call=2)

    def max_diff(x, y):
        return max((x.state.variables[col][k].float() - y.state.variables[col][k].float())
                   .abs().max().item()
                   for col in x.state.variables for k in x.state.variables[col])

    diff_resume, diff_fused = max_diff(a, b), max_diff(a, c)
    participants = [r["participants"] for r in hist]
    # per client-epoch at the north star's cut (24 steps x 64 images): the
    # epoch's augmentation, and its threefry draws (the shuffle permutation,
    # the augment key and 24 step keys)
    n = 24 * 64
    x = torch.randn(n, 32, 32, 3, generator=torch.Generator().manual_seed(0)).cuda()
    aug = cifar_augment()
    key = rng.PRNGKey(0)

    def host_ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t) / reps

    def draws():
        ek = rng.fold_in(key, 0)
        rng.permutation(rng.fold_in(ek, 0), n, x.device)
        rng.fold_in(ek, n + 1)
        for i in range(24):
            rng.fold_in(ek, i + 1)

    rec = {"run_s": run_s, "participants": participants,
           "final_test_acc": hist[-1]["test_acc"], "crashed_at": crashed_at,
           "checkpoints_at_crash": saved, "resumed_from": resumed_from,
           "max_abs_diff_resume": diff_resume, "max_abs_diff_fused_sampled": diff_fused,
           "launches": seen["conv3x3_mxu"], "tc_launches": seen["conv3x3_mxu_tc"],
           "augment_ms_per_client_epoch": host_ms(lambda: aug(key, x)),
           "threefry_ms_per_client_epoch": host_ms(draws)}
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False
    print(f"[sim] FedAvgSimulation resnet56_tpu bf16 + cifar_augment, 8 clients (4 per "
          f"round, drop_prob 0.25), {a.steps_per_epoch} steps per client, 3 rounds: run() "
          f"{run_s:.3f} s, participants {participants}, test_acc {hist[-1]['test_acc']:.4f}; "
          f"conv3x3_mxu launches {seen['conv3x3_mxu']} ({seen['conv3x3_mxu_tc']} "
          f"tensor-core) for {train_fwd} train + {eval_fwd} eval forwards")
    print(f"[sim] crash before round {crashed_at} with {saved} on disk, resume() from "
          f"round {resumed_from}: max |variable - run()| {diff_resume:.3g}; "
          f"run_fused_sampled: max |variable - run()| {diff_fused:.3g}")
    epoch_ms = 24 * step_ms
    print(f"[sim] per client-epoch of 24 x 64 images (host clock, synced): augment "
          f"{rec['augment_ms_per_client_epoch']:.3f} ms, threefry draws "
          f"{rec['threefry_ms_per_client_epoch']:.3f} ms, beside 24 north-star steps "
          f"of {step_ms:.2f} ms = {epoch_ms:.1f} ms (augment "
          f"{100 * rec['augment_ms_per_client_epoch'] / epoch_ms:.2f}%, threefry "
          f"{100 * rec['threefry_ms_per_client_epoch'] / epoch_ms:.2f}%)")
    if seen["conv3x3_mxu"] != 19 * (train_fwd + eval_fwd) or \
            seen["conv3x3_mxu_tc"] != TC_PER_FORWARD * train_fwd:
        fail(f"sim: conv launches {seen}, expected {19 * (train_fwd + eval_fwd)} "
             f"({TC_PER_FORWARD * train_fwd} tensor-core)")
    if min(participants) >= cfg.clients_per_round:
        fail("sim: dropout took no client out; the phase does not test it")
    if not (crashed_at == 2 and resumed_from == 2):
        fail(f"sim: crashed at {crashed_at}, resumed from {resumed_from}")
    if diff_resume != 0.0 or diff_fused != 0.0:
        fail("sim: crash + resume or run_fused_sampled is not bit-identical to run()")

    # the experiment entry point with augmentation on and checkpointing
    with tempfile.TemporaryDirectory() as tmp:
        reset_launches()
        t0 = time.perf_counter()
        out = run.main(["--algorithm", "fedavg", "--dataset", "cifar10", "--ci", "1",
                        "--checkpoint_every", "1", "--checkpoint_dir",
                        os.path.join(tmp, "ck"), "--run_dir", os.path.join(tmp, "run")])
        secs = time.perf_counter() - t0
        ckpts = sorted(os.listdir(os.path.join(tmp, "ck")))
    final = out["final"]
    print(f"[sim] experiments.run.main fedavg cifar10 --ci 1 --checkpoint_every 1 "
          f"(augmentation on): {len(out['history'])} rounds {secs:.3f} s, train_loss "
          f"{final['train_loss']:.4f} test_acc {final['test_acc']:.4f}, checkpoints {ckpts}")
    if not (math.isfinite(final["train_loss"]) and ckpts == ["ckpt_1.npz", "ckpt_2.npz"]):
        fail(f"run.main fedavg: {final}, checkpoints {ckpts}")
    rec.update(run_main_s=secs, run_main_checkpoints=ckpts)
    return rec


def _zoo_bundle(dataset, model, classes, shape, device):
    from fedml_tpu_torch.experiments.registry import create_model

    return create_model(model, dataset, classes, input_shape=shape, device=device)


def _zoo_round_data(dataset, batch, classes, shape, tokens, seed=0):
    """A 2 clients x 2 steps block of the pair's geometry from a numpy seed:
    token ids, pixels or bags of words; labels, next tokens or multi-hot tags."""
    import numpy as np

    rng = np.random.RandomState(seed)
    lead = (2, 2, batch)
    if tokens:
        x = rng.randint(0, classes, (*lead, *shape)).astype(np.int32)
    else:
        x = rng.standard_normal((*lead, *shape)).astype(np.float32)
    if dataset == "stackoverflow_lr":
        y = (rng.rand(*lead, classes) < 0.01).astype(np.float32)
    elif dataset in ("fed_shakespeare", "stackoverflow_nwp"):
        y = rng.randint(0, classes, (*lead, *shape)).astype(np.int32)
    else:
        y = rng.randint(0, classes, lead).astype(np.int32)
    mask = np.ones(lead, np.float32)
    mask[1, 1, batch // 2:] = 0.0
    return x, y, mask, mask.sum((1, 2)), np.ones(2, np.float32), np.arange(2)


def _zoo_round(dataset, model, batch, lr, classes, shape, tokens, device,
               float64=False):
    """One make_round_fn round of 2 clients x 2 steps on ``device`` from
    PRNGKey(0)'s init (cast to float64 with the float inputs, the losses
    staying float32 as in JAX, with ``float64``); returns the variables,
    the metrics, the round function, its state and arguments."""
    import torch

    from fedml_tpu_torch.algorithms.fedavg import ServerState, make_round_fn
    from fedml_tpu_torch.core.client import make_client_optimizer, make_local_update
    from fedml_tpu_torch.core.rng import PRNGKey
    from fedml_tpu_torch.experiments.registry import task_loss_for_dataset

    bundle = _zoo_bundle(dataset, model, classes, shape, device)
    lu = make_local_update(bundle, make_client_optimizer("sgd", lr), 1,
                           task_loss_for_dataset(dataset))
    round_fn = make_round_fn(lu, device=device)
    data = _zoo_round_data(dataset, batch, classes, shape, tokens)
    args = tuple(torch.from_numpy(a).to(device) for a in data[:5]) + (data[5],)
    variables = bundle.init(PRNGKey(0))
    if float64:
        variables = {c: {k: v.double() for k, v in d.items()} for c, d in variables.items()}
        if args[0].is_floating_point():
            args = (args[0].double(), *args[1:])
    state = ServerState(variables, (), 0, PRNGKey(1))
    new, metrics = round_fn(state, *args)
    return new.variables, metrics, round_fn, state, args


def phase_zoo(profile: bool, device: str = "cuda"):
    """The cross-device zoo: every (dataset, model) pair of ZOO through
    ``experiments/run.py::run_experiment`` at full width on the default
    device (the card), ZOO_ROUNDS rounds of ZOO_PER_ROUND sampled clients
    (the first a warm-up); then per model one make_round_fn round on the
    card in fp32 (TF32 off) held within ZOO_ROUND_RTOL of the same round on
    the CPU in float64, and the dropout masks card == CPU bit for bit.  No zoo
    path may launch the conv or flash kernel.  ``device`` "cpu" rehearses
    the phase without a card (both sides then run on the CPU)."""
    import statistics

    import numpy as np
    import torch

    from fedml_tpu_torch.core import rng as rnglib
    from fedml_tpu_torch.experiments import run
    from fedml_tpu_torch.models.base import Dropout

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    rec = {}
    reset_launches()
    for dataset, model, batch, lr, cap, tokens, classes, shape in ZOO:
        cfg = run.ExperimentConfig(
            algorithm="fedavg", dataset=dataset, model=model, batch_size=batch, lr=lr,
            wd=0.0, client_num_in_total=ZOO_CLIENTS, client_num_per_round=ZOO_PER_ROUND,
            comm_round=ZOO_ROUNDS, frequency_of_the_test=ZOO_ROUNDS,
            max_samples_per_client=cap, max_test_samples=ZOO_TEST,
            device="" if device == "cuda" else device)
        t0 = time.perf_counter()
        out = run.run_experiment(cfg, log_fn=None)
        sync()
        secs = time.perf_counter() - t0
        hist = out["history"]
        final = hist[-1]
        round_ms = statistics.median(1e3 * r["time_round"] for r in hist[1:])
        # a per-position task counts tokens, a per-sequence one samples
        per_token = dataset in ("fed_shakespeare", "stackoverflow_nwp")
        samples = statistics.median(r["count"] / (tokens if per_token else 1)
                                    for r in hist[1:])
        params = sum(p.numel() for p in
                     _zoo_bundle(dataset, model, classes, shape, "meta").module.parameters())
        tag = f"{dataset}+{model}"
        r = {"params": params, "round_ms": round_ms, "samples_per_round": samples,
             "samples_per_s": 1e3 * samples / round_ms, "run_s": secs,
             "final": {k: v for k, v in final.items() if k.startswith(("test_", "train_"))}}
        if tokens:
            r["tokens_per_s"] = r["samples_per_s"] * tokens
        finite = all(math.isfinite(v) for v in r["final"].values())
        extra = (f", {r['tokens_per_s']:.1f} tokens/s" if tokens else "")
        pr = (f" precision {final['test_precision']:.4f} recall {final['test_recall']:.4f}"
              if "test_precision" in final else "")
        print(f"[zoo] {tag}: {params} params, {len(hist)} rounds x {cfg.client_num_per_round} "
              f"clients (batch {batch}, sgd lr {lr:g}, <= {cap} samples each) in {secs:.2f} s; "
              f"median round {round_ms:.1f} ms after a warm-up, {r['samples_per_s']:.1f} "
              f"samples/s{extra}; train_loss {final['train_loss']:.4f} test_loss "
              f"{final['test_loss']:.4f} test_acc {final['test_acc']:.4f}{pr}; finite {finite}")
        if not finite or final["test_count"] <= 0:
            fail(f"zoo {tag}: {final}")
        if dataset == "stackoverflow_lr" and "test_precision" not in final:
            fail("zoo stackoverflow_lr: no precision/recall in the evaluation record")
        rec[tag] = r
    seen = read_launches()
    if any(seen.values()):
        fail(f"a zoo path launched a kernel of the JAX package's Pallas paths: {seen}")

    # the card against the CPU, one round per model, one seed: the card in
    # fp32 is held to the CPU's float64 round, which the CPU's own fp32
    # round can miss by more than the card does (resnet18_gn at lr 0.1: the
    # CPU's fp32 round ends 2.2e-3 of a leaf's largest magnitude from
    # float64 on near-zero GroupNorm biases, the card's 7.9e-5; PERF.md)
    def rel_diff(a, b):
        worst, worst_abs = 0.0, 0.0
        for coll in b:
            for k, v in b[coll].items():
                d = (a[coll][k].cpu().double() - v.double()).abs().max().item()
                worst_abs = max(worst_abs, d)
                worst = max(worst, d / max(v.abs().max().item(), 1e-30))
        return worst, worst_abs

    models = {}
    for dataset, model, batch, lr, cap, tokens, classes, shape in ZOO:
        key = (model, dataset if model in ("rnn", "lr") else "")
        models.setdefault(key, (dataset, model, batch, lr, classes, shape, tokens))
    for dataset, model, batch, lr, classes, shape, tokens in models.values():
        spec = (dataset, model, batch, lr, classes, shape, tokens)
        card, cm, round_fn, state, args = _zoo_round(*spec, device)
        host, hm, *_ = _zoo_round(*spec, "cpu")
        ref, _, *_ = _zoo_round(*spec, "cpu", float64=True)
        worst, worst_abs = rel_diff(card, ref)
        host_ref, _ = rel_diff(host, ref)
        card_host, card_host_abs = rel_diff(card, host)
        loss_c, loss_h = float(cm["loss_sum"]), float(hm["loss_sum"])
        tag = f"{model}/{dataset}"
        print(f"[zoo] {tag}: one round of 2 clients x 2 steps (fp32, TF32 off): card vs "
              f"cpu float64 max |Δ| {worst_abs:.3g}, / max |leaf| {worst:.3g}; card vs cpu "
              f"fp32 max |Δ| {card_host_abs:.3g}, / max |leaf| {card_host:.3g}; cpu fp32 "
              f"vs float64 / max |leaf| {host_ref:.3g}; loss_sum {loss_c:.6f} vs {loss_h:.6f}")
        if not worst <= ZOO_ROUND_RTOL or not math.isfinite(loss_c):
            fail(f"zoo {tag}: the card's round is not the CPU's float64 one ({worst:.3g})")
        rec[f"round {tag}"] = {"card_vs_f64": worst, "card_vs_f64_abs": worst_abs,
                               "card_vs_cpu": card_host, "card_vs_cpu_abs": card_host_abs,
                               "cpu_vs_f64": host_ref, "loss_sum": [loss_c, loss_h]}
        if profile and device == "cuda":
            prof = profile_round(round_fn, state, args)
            prof["launches_per_step"] = prof["kernel_launches"] / 4
            if tokens:
                prof["launches_per_timestep"] = prof["launches_per_step"] / tokens
            print(f"[zoo] {tag}: {prof['launches_per_step']:.0f} kernel launches per "
                  "training step (a 2 x 2 round's launches / 4, aggregation included)"
                  + (f", {prof['launches_per_timestep']:.1f} per timestep" if tokens else ""))
            rec[f"round {tag}"]["profile"] = prof
        del card, host, state, args, round_fn
    # the CNN's dropout masks, card against CPU, bit for bit
    drop = Dropout(0.25)
    drop.state_prefix = "Dropout_0."  # CNNDropOut's first dropout scope
    x = torch.randn(20, 12, 12, 64, generator=torch.Generator().manual_seed(0)) + 3.0
    key = rnglib.fold_in(rnglib.PRNGKey(5), 1)
    a = drop(x.to(device), True, key).cpu()
    b = drop(x, True, key)
    same = torch.equal(a, b) and torch.equal(a == 0, b == 0)
    print(f"[zoo] dropout 0.25 over a [20, 12, 12, 64] activation: card == cpu bitwise "
          f"{same} (kept {(b != 0).float().mean().item():.4f})")
    if not same:
        fail("zoo: the card's dropout mask is not the CPU's")
    if device == "cuda":
        torch.cuda.empty_cache()
    return rec


def phase_init():
    """The seeded init (flax's model under PRNGKey(s)) drawn on the card
    against the same draw on the CPU, bit for bit: ResNet-56, a small
    transformer and the zoo's models (the LSTMs' orthogonal kernels
    included)."""
    import torch

    from fedml_tpu_torch.core.rng import PRNGKey
    from fedml_tpu_torch.models.resnet_tpu import resnet56_tpu
    from fedml_tpu_torch.models.transformer import transformer_lm

    rec = {}
    # the zoo's models, each once (shakespeare's LSTM is fed_shakespeare's)
    zoo = [(f"{model}/{dataset}", functools.partial(_zoo_bundle, dataset, model, c, shp))
           for dataset, model, _, _, _, _, c, shp in ZOO
           if dataset not in ("shakespeare", "mnist")]
    for name, make in (
            ("resnet56_tpu", lambda dev: resnet56_tpu(device=dev)),
            ("transformer_w256_l2", lambda dev: transformer_lm(
                vocab_size=1024, embed_dim=256, num_heads=4, num_layers=2,
                seq_len=128, device=dev)), *zoo):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = make("cuda").init(PRNGKey(0))
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        host = make("cpu").init(PRNGKey(0))
        host_s = time.perf_counter() - t0
        n = sum(v.numel() for col in host.values() for v in col.values())
        same = all(torch.equal(card[c][k].cpu(), v) for c in host for k, v in host[c].items())
        print(f"[init] {name}: {n} values, card {card_s:.3f} s, cpu {host_s:.3f} s, "
              f"card == cpu bitwise {same}")
        if not same:
            fail(f"init {name}: the card's draw is not the CPU's")
        rec[name] = {"values": n, "card_s": card_s, "cpu_s": host_s}
    return rec


def _host_profile(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: CUDA kernels launched,
    and each host op's count and self CPU time (ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    ops = {e.key: (e.count, e.self_cpu_time_total / 1e3) for e in events
           if e.device_type == torch.autograd.DeviceType.CPU}
    return {"launches": sum(e.count for e in events
                            if e.device_type == torch.autograd.DeviceType.CUDA),
            "host_ms": sum(t for _, t in ops.values()), "ops": ops}


def _sync_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def phase_compress():
    """FedAvgSimulation over the kernel ResNet-56 with the int8 codec and
    error feedback, at [sim]'s cohort geometry: run(), crash + resume()
    and run_fused_sampled, bit for bit (variables and residuals); one
    round each of qsgd4, topk0.01 + EF and bf16; the qsgd8 payload on the
    card against the CPU's; the uplink bytes; the codec stage's time and
    launches per client and its share of a round."""
    import tempfile

    import numpy as np
    import torch

    from fedml_tpu_torch import compress
    from fedml_tpu_torch.algorithms.fedavg import (
        FedAvgConfig, FedAvgSimulation, InjectedCrash, ServerState, make_round_fn)
    from fedml_tpu_torch.core import rng
    from fedml_tpu_torch.core.checkpoint import CheckpointManager
    from fedml_tpu_torch.core.client import make_client_optimizer, make_local_update
    from fedml_tpu_torch.core.metrics import MetricsLogger
    from fedml_tpu_torch.core.tree import tree_map
    from fedml_tpu_torch.data.augment import cifar_augment
    from fedml_tpu_torch.data.cifar import load_cifar10
    from fedml_tpu_torch.experiments.registry import shrink_dataset
    from fedml_tpu_torch.models.resnet_tpu import resnet56_tpu
    from fedml_tpu_torch.obs.telemetry import Telemetry

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    ds = shrink_dataset(load_cifar10(num_clients=8, partition="hetero",
                                     partition_alpha=0.5, seed=0), 128, 256)
    base = dict(num_clients=8, clients_per_round=4, comm_rounds=3, epochs=1,
                batch_size=64, lr=0.001, momentum=0.9, weight_decay=1e-3,
                frequency_of_the_test=1, seed=0, compute_dtype="bf16", drop_prob=0.25)

    def sim(codec="int8", ef=True, **kw):
        cfg = FedAvgConfig(**{**base, **kw}, compress_codec=codec, compress_ef=ef)
        return FedAvgSimulation(resnet56_tpu(conv_variant="kernel"), ds, cfg,
                                augment_fn=cifar_augment(),
                                metrics=MetricsLogger(telemetry=Telemetry()))

    a = sim()
    reset_launches()
    t0 = time.perf_counter()
    hist = a.run()
    run_s = time.perf_counter() - t0
    seen = read_launches()
    train_fwd = base["comm_rounds"] * base["clients_per_round"] * a.steps_per_epoch
    eval_fwd = base["comm_rounds"] * math.ceil(len(ds.test_y) / 64)
    with tempfile.TemporaryDirectory() as ck:
        b = sim()
        b.attach_checkpointing(CheckpointManager(ck), every=1)
        b.crash_at_round = 2
        try:
            b.run()
            fail("compress: the scheduled crash did not happen")
        except InjectedCrash as crash:
            crashed_at = crash.round_idx
        b = sim()
        b.attach_checkpointing(CheckpointManager(ck), every=1)
        resumed_from = b.resume()
        b.run(base["comm_rounds"] - resumed_from)
    c = sim()
    c.run_fused_sampled(rounds_per_call=2)

    def max_diff(x, y):
        pairs = [(x.state.variables, y.state.variables), (x.state.residuals, y.state.residuals)]
        return max((p[col][k].float() - q[col][k].float()).abs().max().item()
                   for p, q in pairs for col in p for k in p[col])

    diff_resume, diff_fused = max_diff(a, b), max_diff(a, c)
    res_norm = max(v.abs().max().item() for col in a.state.residuals.values()
                   for v in col.values())
    counters = a.metrics.telemetry.snapshot()["counters"]
    up = "{msg_type=C2S_SEND_MODEL}"
    raw, enc = counters["comm.raw_bytes" + up], counters["comm.compressed_bytes" + up]
    uploads = counters["comm.recv_msgs" + up]
    participants = [r["participants"] for r in hist]
    rec = {"run_s": run_s, "participants": participants, "crashed_at": crashed_at,
           "resumed_from": resumed_from, "max_abs_diff_resume": diff_resume,
           "max_abs_diff_fused_sampled": diff_fused, "max_abs_residual": res_norm,
           "launches": seen["conv3x3_mxu"], "tc_launches": seen["conv3x3_mxu_tc"],
           "uplink_bytes": {"fp32": raw / uploads, "int8": enc / uploads},
           "final_test_acc": hist[-1]["test_acc"]}
    print(f"[compress] FedAvgSimulation resnet56_tpu bf16 + cifar_augment, int8 + error "
          f"feedback, 8 clients (4 per round, drop_prob 0.25), {a.steps_per_epoch} steps "
          f"per client, 3 rounds: run() {run_s:.3f} s, participants {participants}, "
          f"test_acc {hist[-1]['test_acc']:.4f}, max |residual| {res_norm:.3g}; conv3x3_mxu "
          f"launches {seen['conv3x3_mxu']} ({seen['conv3x3_mxu_tc']} tensor-core) for "
          f"{train_fwd} train + {eval_fwd} eval forwards")
    print(f"[compress] crash before round {crashed_at}, resume() from round "
          f"{resumed_from}: max |variable or residual - run()| {diff_resume:.3g}; "
          f"run_fused_sampled: {diff_fused:.3g}")
    if seen["conv3x3_mxu"] != 19 * (train_fwd + eval_fwd) or \
            seen["conv3x3_mxu_tc"] != TC_PER_FORWARD * train_fwd:
        fail(f"compress: conv launches {seen}, expected {19 * (train_fwd + eval_fwd)} "
             f"({TC_PER_FORWARD * train_fwd} tensor-core)")
    if not (crashed_at == 2 and resumed_from == 2):
        fail(f"compress: crashed at {crashed_at}, resumed from {resumed_from}")
    if diff_resume != 0.0 or diff_fused != 0.0:
        fail("compress: crash + resume or run_fused_sampled is not bit-identical to run()")
    if not (res_norm > 0 and math.isfinite(hist[-1]["train_loss"])):
        fail(f"compress: residuals {res_norm}, metrics {hist[-1]}")

    # one round of each other codec; the uplink bytes per upload
    for name, ef in (("int4", False), ("topk0.01", True), ("bf16", False)):
        s = sim(name, ef, comm_rounds=1)
        row = s.run()[-1]
        cnt = s.metrics.telemetry.snapshot()["counters"]
        per = cnt["comm.compressed_bytes" + up] / cnt["comm.recv_msgs" + up]
        rec["uplink_bytes"][name] = per
        print(f"[compress] {name}{' + error feedback' if ef else ''}: 1 round, train_loss "
              f"{row['train_loss']:.4f}, test_acc {row['test_acc']:.4f}, {per:.0f} uplink "
              f"bytes per upload")
        if not math.isfinite(row["train_loss"]):
            fail(f"compress {name}: non-finite metrics {row}")
    ub = rec["uplink_bytes"]
    print(f"[compress] uplink bytes per ResNet-56 upload: fp32 {ub['fp32']:.0f}, int8 "
          f"{ub['int8']:.0f} ({ub['fp32'] / ub['int8']:.2f}x), int4 {ub['int4']:.0f}, "
          f"topk0.01 {ub['topk0.01']:.0f}, bf16 {ub['bf16']:.0f}")
    want = {"fp32": 2_401_256, "int8": 610_346, "int4": 312_525, "topk0.01": 48_904,
            "bf16": 1_200_628}
    if ub != want:
        fail(f"compress: uplink bytes {ub}, the JAX package's are {want}")
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False

    # the qsgd8 payload of a trained update, on the card and on the CPU
    g = resnet56_tpu(conv_variant="kernel").init(rng.PRNGKey(0))  # the run's start
    codec, key = compress.get_codec("int8"), rng.PRNGKey(2)
    delta = tree_map(lambda v, w: v.float() - w.float(), a.state.variables, g)
    card_wire = compress.wire_encode_tree(codec, delta, key)
    host_wire = compress.wire_encode_tree(codec, tree_map(lambda v: v.cpu(), delta), key)
    card_digest = compress.wire_tree_digest({"leaves": card_wire})
    host_digest = compress.wire_tree_digest({"leaves": host_wire})
    # and the update as the server decodes it, through the fused form
    host_delta = tree_map(lambda v: v.cpu(), delta)
    decoded = []
    for tree in (delta, host_delta):
        lay = compress.FlatLayout(tree, next(iter(tree["params"].values())).device)
        decoded.append(compress.roundtrip_flat(codec, lay.flatten(tree), key, lay).cpu())
    same_decoded = torch.equal(decoded[0], decoded[1])
    print(f"[compress] qsgd8 payload of a ResNet-56 update (sha256 over 292 leaves): "
          f"card {card_digest[:16]}, cpu {host_digest[:16]}, equal "
          f"{card_digest == host_digest}; decoded update card == cpu bitwise {same_decoded}")
    if card_digest != host_digest or not same_decoded:
        fail("compress: the card's qsgd8 payload or decoded update is not the CPU's")
    rec.update(payload_sha256_card=card_digest, payload_sha256_cpu=host_digest)

    # the codec stage per client: fused (what the round runs) and per leaf
    layout = compress.FlatLayout(g, torch.device("cuda"))
    gflat = layout.flatten(g)
    res = layout.flatten(delta) * 0.5

    def fused():
        return compress.uplink_roundtrip(codec, layout, gflat, a.state.variables, g,
                                         key, res)

    def per_leaf():
        return compress.roundtrip_tree(codec, delta, key)

    stage_ms, leaf_ms = _sync_ms(fused, 20), _sync_ms(per_leaf, 2)
    stage_launches = _host_profile(fused)["launches"]
    leaf_launches = _host_profile(per_leaf)["launches"]
    print(f"[compress] codec stage per client (int8 + EF, ResNet-56, host clock, synced): "
          f"fused {stage_ms:.3f} ms, {stage_launches} kernel launches; per leaf "
          f"{leaf_ms:.3f} ms, {leaf_launches} launches")

    # its share of a round: the same round with and without the codec
    clients, steps, batch = 4, 8, 64
    bundle = resnet56_tpu(conv_variant="kernel")
    lu = make_local_update(bundle, make_client_optimizer("sgd", 0.001, momentum=0.9,
                                                         weight_decay=1e-3),
                           1, compute_dtype=torch.bfloat16)
    host_rng = np.random.RandomState(0)
    args = (torch.from_numpy(host_rng.rand(clients, steps, batch, 32, 32, 3)
                             .astype(np.float32)).cuda(),
            torch.from_numpy(host_rng.randint(0, 10, (clients, steps, batch))
                             .astype(np.int32)).cuda(),
            torch.ones((clients, steps, batch), device="cuda"),
            torch.full((clients,), float(steps * batch), device="cuda"),
            torch.ones((clients,), device="cuda"), np.arange(clients))
    variables = bundle.init(rng.PRNGKey(0))
    zeros = tree_map(lambda v: torch.zeros((clients, *v.shape), device="cuda"), variables)
    plain_state = ServerState(variables, (), 0, rng.PRNGKey(0))
    comp_state = ServerState(variables, (), 0, rng.PRNGKey(0), zeros)
    rounds = {"plain": (make_round_fn(lu), plain_state),
              "int8_ef": (make_round_fn(lu, codec=codec, error_feedback=True), comp_state)}

    def round_s(name):
        fn, state = rounds[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = fn(state, *args)
        float(m["loss_sum"])
        return time.perf_counter() - t0

    for name in rounds:  # warm-up
        round_s(name)
    times = {name: [] for name in rounds}
    for name in ("plain", "int8_ef", "int8_ef", "plain") * 3:
        times[name].append(round_s(name))
    plain_s, comp_s = (float(np.median(times[n])) for n in ("plain", "int8_ef"))
    q1, q3 = np.percentile(times["plain"], [25, 75])
    share = (comp_s - plain_s) / comp_s
    print(f"[compress] round of {clients} clients x {steps} steps x batch {batch} (bf16, "
          f"kernel conv), 3 x in turns plain/int8+EF/int8+EF/plain: plain "
          f"{[round(t, 4) for t in times['plain']]} s, int8 + EF "
          f"{[round(t, 4) for t in times['int8_ef']]} s; medians {plain_s:.4f} / "
          f"{comp_s:.4f} s (the plain rounds' interquartile spread {q3 - q1:.4f} s): the "
          f"codec stage's share {100 * share:.2f}% ({1e3 * (comp_s - plain_s) / clients:.2f} "
          f"ms per client)")
    # where a round's extra host time goes: one profiled round of each,
    # ops ranked by how much more host time they took with the codec
    # (one step per client: the codec's cost does not depend on the steps)
    short = (args[0][:, :1], args[1][:, :1], args[2][:, :1],
             torch.full((clients,), float(batch), device="cuda"), *args[4:])
    prof = {name: _host_profile(lambda n=name: rounds[n][0](rounds[n][1], *short))
            for name in rounds}
    extra = (prof["int8_ef"]["launches"] - prof["plain"]["launches"]) / clients
    grown = sorted(prof["int8_ef"]["ops"], key=lambda op: prof["plain"]["ops"].get(
        op, (0, 0.0))[1] - prof["int8_ef"]["ops"][op][1])[:5]
    print(f"[compress] profiled rounds: plain {prof['plain']['launches']} launches, "
          f"{prof['plain']['host_ms']:.1f} ms host op time; int8 + EF "
          f"{prof['int8_ef']['launches']} launches ({extra:.0f} more per client), "
          f"{prof['int8_ef']['host_ms']:.1f} ms host op time")
    for op in grown:
        (cp, tp), (cc, tc) = prof["plain"]["ops"].get(op, (0, 0.0)), prof["int8_ef"]["ops"][op]
        print(f"[compress]   {op[:48]:48s} plain x{cp} {tp:.1f} ms, int8 + EF x{cc} "
              f"{tc:.1f} ms")
    rec.update(stage_ms_per_client=stage_ms, stage_launches_per_client=stage_launches,
               round_launches_per_client_added=extra,
               per_leaf_ms_per_client=leaf_ms, per_leaf_launches_per_client=leaf_launches,
               round_plain_s=times["plain"], round_int8_ef_s=times["int8_ef"],
               stage_share_of_round=share, round_plain_spread_s=q3 - q1)
    del rounds, plain_state, comp_state, a, b, c
    torch.cuda.empty_cache()
    return rec


def phase_pack():
    """The native row-gather packer: it must be the compiled library (no
    silent numpy fallback), byte-identical to numpy; the pack time of a
    10 x 1536-image CIFAR cohort."""
    import numpy as np

    from fedml_tpu_torch.core.types import pack_clients
    from fedml_tpu_torch.data.cifar import load_cifar10
    from fedml_tpu_torch.native import native_available
    from fedml_tpu_torch.native import packer

    if not native_available():
        fail("pack: the native packer did not build or load")
    ds = load_cifar10(num_clients=10, partition="homo", seed=0)
    ids = np.arange(10)

    def pack(**kw):
        return pack_clients(ds, ids, 64, steps_per_epoch=24, seed=0, **kw)

    def ms(fn, reps=5):
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e3 * (time.perf_counter() - t0) / reps

    native = pack()
    native_ms, reuse_ms = ms(pack), ms(lambda: pack(reuse_buffers=True))
    lib = packer._lib
    packer._lib = None  # the numpy fallback, for comparison
    try:
        numpy_pack = pack()
        numpy_ms = ms(pack)
    finally:
        packer._lib = lib
    same = all(np.asarray(getattr(native, f)).tobytes() == np.asarray(getattr(numpy_pack, f))
               .tobytes() for f in ("x", "y", "mask", "num_samples"))
    mb = native.x.nbytes / 1e6
    print(f"[pack] native packer loaded ({packer._LIB.name}); a 10 x 1536-image cohort "
          f"({mb:.1f} MB of images): native {native_ms:.2f} ms, native with reused "
          f"buffers {reuse_ms:.2f} ms, numpy {numpy_ms:.2f} ms (host clock); "
          f"byte-identical {same}")
    if not same:
        fail("pack: the native pack differs from numpy's")
    return {"native_ms": native_ms, "reuse_ms": reuse_ms, "numpy_ms": numpy_ms,
            "cohort_mb": mb}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="write every per-case number here as JSON")
    parser.add_argument("--profile", action="store_true",
                        help="also trace one main-path round with torch.profiler")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU",
              file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    build_s = phase_build()
    cases = phase_kernels()
    flash_cases = phase_flash_kernels()
    phase_check()
    phase_flash_check()
    main_rec = phase_main(args.profile)
    fedllm_rec = phase_fedllm(args.profile)
    rng_rec = phase_rng()
    north_rec = phase_north_star(args.profile)
    sim_rec = phase_sim(north_rec["step_ms"])
    init_rec = phase_init()
    compress_rec = phase_compress()
    pack_rec = phase_pack()
    zoo_rec = phase_zoo(args.profile)

    # the kernel's row: summed over the 19 convs of one training forward
    # (bf16, moments), the main path's configuration
    train = [c for c in cases if c["dtype"] == "bf16" and c["moments"]]

    def per_forward(key):
        return sum(c[key] * c["per_forward"] for c in train)

    kernels = [{
        "name": "conv3x3_mxu",
        "route": "cuda",
        "source": "fedml_tpu_torch/ops/csrc/conv_mxu.cu",
        "replaces": "fedml_tpu/ops/conv_mxu.py:72",
        "launches": (main_rec["launches"] + north_rec["launches"] + sim_rec["launches"]
                     + compress_rec["launches"]),
        "max_abs_err": max(c["max_abs_err"] for c in train),
        "ms": per_forward("ms"),
        "plain_ms": per_forward("plain_ms"),
        "bound_ms": per_forward("bound_ms"),
        "bound_by": ("bytes" if per_forward("bytes_ms") >= per_forward("ops_ms")
                     else "operations"),
        "library_ms": per_forward("library_ms"),
    }]
    # the flash kernel's row: the bench shape (bf16, causal) times the 12
    # layers of one forward, the fedllm main path's configuration
    bench = next(c for c in flash_cases if c["case"] == "bench" and c["dtype"] == "bf16")
    kernels.append({
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "fedml_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": "fedml_tpu/ops/flash_attention.py:35",
        "launches": fedllm_rec["flash_launches"],
        "wgmma_launches": fedllm_rec["flash_wgmma_launches"],
        "max_abs_err": bench["max_abs_err"],
        "ms": BENCH_LAYERS * bench["ms"],
        "plain_ms": BENCH_LAYERS * bench["plain_ms"],
        "bound_ms": BENCH_LAYERS * bench["bound_ms"],
        "bound_by": "bytes" if bench["bytes_ms"] >= bench["ops_ms"] else "operations",
        "library_ms": BENCH_LAYERS * bench["library_ms"],
    })
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"gpu": smi, "build_s": build_s, "cases": cases,
                       "flash_cases": flash_cases, "main": main_rec,
                       "fedllm": fedllm_rec, "rng": rng_rec, "north_star": north_rec,
                       "sim": sim_rec, "init": init_rec, "compress": compress_rec,
                       "pack": pack_rec, "zoo": zoo_rec, "kernels": kernels}, f, indent=1)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
