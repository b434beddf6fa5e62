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

Every kernel's launch counter is zeroed just before each path and read just
after it.  The line before the last is the kernels' JSON record, the line
before that the card's name and power limit; the last line is the device
record.  ``--out`` also writes every per-case number as JSON;
``--profile`` adds a ``torch.profiler`` trace of one round of each main
path (device busy time, idle share, top kernels).
"""

from __future__ import annotations

import argparse
import json
import math
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

    from fedml_tpu_torch.models.resnet import resnet56
    from fedml_tpu_torch.models.resnet_tpu import resnet56_tpu

    kern, base = resnet56_tpu(conv_variant="kernel"), resnet56()
    variables = kern.init(torch.Generator().manual_seed(1))
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

    from fedml_tpu_torch.models.transformer import transformer_lm
    from fedml_tpu_torch.ops.flash_attention import (
        _flash_bwd, attention_plain, flash_attention_fwd, flash_attention_with_lse)

    kw = dict(vocab_size=8192, embed_dim=1280, num_heads=10, num_layers=2,
              seq_len=1024)
    kern = transformer_lm(**kw)
    plain = transformer_lm(**kw, attn_fn=lambda q, k, v, c: attention_plain(q, k, v, c)[0])
    variables = kern.init(torch.Generator().manual_seed(3))
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
    state = ServerState(bundle.init(torch.Generator().manual_seed(0)), (), 0, 0)
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
        "launches": main_rec["launches"],
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
                       "fedllm": fedllm_rec, "kernels": kernels}, f, indent=1)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
