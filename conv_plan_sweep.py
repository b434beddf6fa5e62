#!/usr/bin/env python3
"""Time the tensor-core conv kernel under every tile plan it is built for.

    python3 conv_plan_sweep.py [--out PATH]

For each ResNet-56 3x3 conv past the stem (N=64, bf16, ``chip_smoke.CONV_SHAPES``)
and each ``(bm, k_split)`` the kernel takes, it checks the kernel against
``conv3x3_plain`` and times one call with and without moments (CUDA-graph
replays between CUDA events, ``utils.timing.kernel_ms``), marking the plan
``ops/conv_mxu.py::_tile_plan`` picks.  It is how that plan was chosen.
For the chosen plan it also reads each kernel's device time per call from
``torch.profiler``, beside the library conv's.
Needs one GPU; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys

from chip_smoke import CONV_SHAPES, N

TOL = 2e-2  # bf16, as chip_smoke's
PLANS = [(64, 1), (32, 2), (16, 4)]


def device_us(fn, reps: int = 20) -> dict:
    """Device time per call of each CUDA kernel ``fn`` launches, from
    ``torch.profiler`` over ``reps`` eager calls: the kernels' own time,
    without the launch gaps a CUDA-graph replay still pays."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key[:48]: e.self_device_time_total / reps for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="write every number here as JSON")
    args = parser.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("conv_plan_sweep: no CUDA device; this script needs one GPU", file=sys.stderr)
        return 1
    from fedml_tpu_torch.ops import conv_mxu as conv_mod
    from fedml_tpu_torch.utils.timing import kernel_ms

    chosen_plan = conv_mod._tile_plan
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(0)
    rows = []
    for name, hw, ci, co, stride, _ in CONV_SHAPES:
        if ci % 8:
            continue
        x = torch.randn(N, hw, hw, ci, generator=g).to(dev, torch.bfloat16)
        w = (torch.randn(3, 3, ci, co, generator=g) * math.sqrt(2.0 / (9 * ci))).to(
            dev, torch.bfloat16)
        m = N * (hw // stride) ** 2
        ref = conv_mod.conv3x3_plain(x, w, stride=stride).float()
        for plan in PLANS:
            conv_mod._tile_plan = lambda _m, plan=plan: plan
            try:
                got = conv_mod.conv3x3_mxu(x, w, stride=stride).float()
                err = (got - ref).abs().max().item()
                ok = torch.allclose(got, ref, rtol=TOL, atol=TOL)
                ms = kernel_ms(lambda: conv_mod.conv3x3_mxu(x, w, stride=stride))
                ms_mom = kernel_ms(lambda: conv_mod.conv3x3_mxu(x, w, stride=stride, moments=True))
            finally:
                conv_mod._tile_plan = chosen_plan
            row = {"shape": name, "bm": plan[0], "k_split": plan[1],
                   "blocks": -(-m // plan[0]), "chosen": plan == chosen_plan(m),
                   "max_abs_err": err, "ms": ms, "ms_moments": ms_mom}
            if row["chosen"]:
                row["device_us"] = device_us(
                    lambda: conv_mod.conv3x3_mxu(x, w, stride=stride, moments=True))
                xn, wn = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
                row["library_device_us"] = device_us(
                    lambda: F.conv2d(xn, wn, stride=stride, padding=1))
                print(f"[sweep] {name:12s} device us per call, kernels with moments "
                      f"{row['device_us']}; F.conv2d {row['library_device_us']}")
            rows.append(row)
            print(f"[sweep] {name:12s} bm {plan[0]:2d} k_split {plan[1]} blocks {row['blocks']:5d} "
                  f"{'*' if row['chosen'] else ' '} abs {err:.3g} | {ms:.4f} ms, "
                  f"with moments {ms_mom:.4f} ms")
            if not ok:
                print(f"conv_plan_sweep: {name} plan {plan} disagrees with the plain version",
                      file=sys.stderr)
                return 1
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"gpu": smi, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
