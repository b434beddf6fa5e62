#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``fedml_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out PATH]

Phases, in order; any failure exits non-zero:

1. build   — compile every CUDA kernel of the main path from ``ops/csrc``
             (one nvcc per source, all at once) and print the build seconds.
2. kernels — call each kernel's wrapper at every shape the main path gives
             it (ResNet-56, N=64), fp32 (TF32 off) and bf16, with and
             without moments, plus one fused-epilogue case; hold each result
             against the plain PyTorch version on the same inputs and time
             kernel, plain version and the library call (CUDA-graph replays
             between CUDA events, so host overhead stays out).
3. check   — the kernel-conv ResNet-56 against the library-conv ResNet-56
             with the same variables on a small batch (fp32, TF32 off).
4. main    — FedAvg over ResNet-56 (Bottleneck [6,6,6], full width, bf16
             compute, SGD lr 1e-3 momentum 0.9 wd 1e-3) on the CIFAR-10
             stand-in with Dirichlet(0.5) clients: two rounds of 4 clients x
             4 steps through ``make_multi_round_fn``, then one
             ``FedAvgSimulation.run`` round with ``evaluate_global``.  The
             kernels' launch counters are zeroed just before and read just
             after; each 3x3 conv kernel must have run 19 times per forward.

The line before the last is the kernels' JSON record, the line before that
the card's name and power limit; the last line is the device record.
``--out`` also writes every per-case number as JSON; ``--profile`` adds a
``torch.profiler`` trace of one main-path round (device busy time, idle
share, top kernels).
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
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}  # dense bf16 tensor core; fp32 CUDA cores
TOL = {"fp32": 1e-4, "bf16": 2e-2}
MOMENT_RTOL = 1e-3


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, reps: int = 50) -> float:
    """Device time of one ``fn()``: warm up, capture it in a CUDA graph,
    replay ``reps`` times between two CUDA events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def conv_bound_ms(n, hw, ci, co, stride, dtype_name, moments, epilogue):
    """(ms to move the bytes, ms to do the FLOPs): each input read once and
    each output written once over HBM; FLOPs at the card's peak for the
    type.  The bound is the larger."""
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
    reports = build.build_all(["conv_mxu"])
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
            got = conv3x3_mxu(x, w, **kw)
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
                   "epilogue": epilogue, "per_forward": per_fwd,
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
            rec["ms"] = time_ms(lambda: conv3x3_mxu(x, w, **kw))
            rec["plain_ms"] = time_ms(lambda: conv3x3_plain(x, w, **kw))
            rec["library_ms"] = time_ms(
                lambda: F.conv2d(xn, wn, stride=stride, padding=1))
            rec["bytes_ms"], rec["ops_ms"] = conv_bound_ms(
                N, hw, ci, co, stride, dname, moments, epilogue)
            rec["bound_ms"] = max(rec["bytes_ms"], rec["ops_ms"])
            cases.append(rec)
            print(f"[kernels] {name:12s} {dname} mom={int(moments)} epi={int(epilogue)} "
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
    rec = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": 1.0 - busy_ms / wall_ms,
           "kernel_launches": sum(e.count for e in kernels),
           "top_kernels": [{"name": e.key[:120], "count": e.count,
                            "device_ms": e.self_device_time_total / 1e3}
                           for e in top]}
    print(f"[profile] one round (4 clients x 4 steps): wall {wall_ms:.1f} ms, "
          f"device busy {busy_ms:.1f} ms, idle share {rec['device_idle_share']:.3f}, "
          f"{rec['kernel_launches']} kernel launches")
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
    from fedml_tpu_torch.ops.conv_mxu import conv3x3_mxu

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

    conv3x3_mxu.launches = 0
    t0 = time.perf_counter()
    state, metrics = fused(state, x, y, m, ns, part, ids)
    loss = metrics["loss_sum"].cpu().numpy() / metrics["count"].cpu().numpy()
    secs = time.perf_counter() - t0
    run1 = conv3x3_mxu.launches
    fwd1 = clients * steps * rounds
    changed = max((state.variables["params"][k] - before[k]).abs().max().item()
                  for k in before)
    sps = clients * steps * batch * rounds / secs
    print(f"[main] make_multi_round_fn: {rounds} rounds x {clients} clients x {steps} "
          f"steps x {batch}: {secs:.3f} s, {sps:.1f} samples/s, loss per round "
          f"{loss.tolist()}, max |param change| {changed:.3g}, "
          f"conv3x3_mxu launches {run1} for {fwd1} forwards")
    if not np.all(np.isfinite(loss)):
        fail(f"non-finite training loss {loss}")
    if not changed > 0:
        fail("the model did not change")
    if run1 != 19 * fwd1:
        fail(f"conv3x3_mxu launched {run1} times, expected {19 * fwd1}")
    prof = (profile_round(make_multi_round_fn(lu, 1), state,
                          (x, y, m, ns, part, ids)) if profile else None)

    cfg = FedAvgConfig(num_clients=clients, clients_per_round=clients,
                       comm_rounds=1, epochs=1, batch_size=batch, lr=0.001,
                       momentum=0.9, weight_decay=1e-3, frequency_of_the_test=1,
                       seed=0, compute_dtype="bf16")
    sim = FedAvgSimulation(bundle, ds, cfg)
    conv3x3_mxu.launches = 0
    t0 = time.perf_counter()
    row = sim.run(1)[-1]
    secs2 = time.perf_counter() - t0
    run2 = conv3x3_mxu.launches
    eval_steps = math.ceil(ds.test_data_num / max(batch, 64))
    fwd2 = clients * sim.steps_per_epoch + eval_steps
    print(f"[main] FedAvgSimulation.run: 1 round, {clients} clients x "
          f"{sim.steps_per_epoch} steps + eval {eval_steps} batches: {secs2:.3f} s; "
          f"train_loss {row['train_loss']:.4f} test_acc {row['test_acc']:.4f} "
          f"test_loss {row['test_loss']:.4f}; conv3x3_mxu launches {run2} for "
          f"{fwd2} forwards")
    if not (math.isfinite(row["train_loss"]) and math.isfinite(row["test_loss"])):
        fail(f"non-finite simulation metrics {row}")
    if run2 != 19 * fwd2:
        fail(f"conv3x3_mxu launched {run2} times, expected {19 * fwd2}")
    return {"launches": run1 + run2, "samples_per_s": sps,
            "multi_round_s": secs, "simulation_round_s": secs2, "profile": prof}


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
    phase_check()
    main_rec = phase_main(args.profile)

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
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"gpu": smi, "build_s": build_s, "cases": cases,
                       "main": main_rec, "kernels": kernels}, f, indent=1)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
