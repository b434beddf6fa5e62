"""Time this tree's flash-attention forward against other builds of it on one card.

    python -m fedml_tpu_torch.ops.flash_sweep [--parent-src OLD.cu]
        [--variant-src OTHER.cu ...] [--out PATH]

Builds ``csrc/flash_attention.cu`` and each other source side by side, one
``nvcc`` each, all at once.  ``--variant-src`` takes sources with this
tree's entry point (an ablated copy: one step of the design taken out);
``--parent-src`` takes a source from before the wgmma route, whose entry
point takes no plan (v2 at every width).  Then, at every bf16 case of the
wgmma route in chip_smoke's flash table (the fedllm bench shape, causal
and not, the long-context range, GPT-2 small's head width), it checks
every build against ``attention_plain`` (O 2e-2, LSE 1e-3) and times
them in turns (the others, this tree twice, the others reversed), each
time a CUDA-graph replay of 50 launches between CUDA events on L2-warm
inputs, beside SDPA and the bound.  Prints one line per case and writes
every number as JSON with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from fedml_tpu_torch.ops import build
from fedml_tpu_torch.ops import flash_attention as flash
from fedml_tpu_torch.utils.timing import flash_bound_ms, kernel_ms

CASES = [  # (name, B, L, H, D, causal), bf16
    ("bench", 8, 1024, 10, 128, True),
    ("bench_noncausal", 8, 1024, 10, 128, False),
    ("long2k", 4, 2048, 10, 128, True),
    ("long4k", 2, 4096, 10, 128, True),
    ("long8k", 1, 8192, 10, 128, True),
    ("bench_d64", 8, 1024, 20, 64, True),
]
SWEEP_DIR = build.BUILD_DIR / "sweep"


def _compile(libs):
    """``{name: source}`` -> ``{name: CDLL}``, one nvcc each, all started at
    once; prints ptxas's register and spill lines."""
    SWEEP_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in libs.items():
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(SWEEP_DIR / f"lib{name}.so"),
               str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    out = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"[build] {name}: {line.strip()}")
        lib = ctypes.CDLL(str(SWEEP_DIR / f"lib{name}.so"))
        lib.flash_attention_fwd.restype = ctypes.c_int
        out[name] = lib
    return out


def _caller(lib, planned: bool):
    """A function ``(q, k, v, causal) -> (o, lse)`` over one library:
    ``planned`` for this tree's entry point (the wrapper's own plan and
    schedule), else the entry point from before the wgmma route."""
    if planned:
        flash._bind(lib)
        return lambda q, k, v, causal: flash._flash_cuda(q, k, v, causal, lib=lib)
    lib.flash_attention_fwd.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 12
        + [ctypes.c_int] * 2 + [ctypes.c_void_p])

    def run_v2(q, k, v, causal):
        b, lq, h, d = q.shape
        o = torch.empty_like(q, memory_format=torch.contiguous_format)
        lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            b, h, lq, k.shape[1], d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], int(causal), 1, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"flash launch failed: {err}")
        return o, lse

    return run_v2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-src", help="a flash_attention.cu from before the wgmma route (no plan)")
    ap.add_argument("--variant-src", action="append", default=[],
                    help="a flash_attention.cu with this tree's entry point (repeatable)")
    ap.add_argument("--out", help="write every number here as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_sweep: needs a CUDA device", file=sys.stderr)
        return 1

    srcs = {f"variant{i}": Path(p) for i, p in enumerate(args.variant_src)}
    if args.parent_src:
        srcs = {"parent": Path(args.parent_src), **srcs}
    libs = _compile({**srcs, "new": build.CSRC / "flash_attention.cu"})
    callers = {name: _caller(lib, name != "parent") for name, lib in libs.items()}
    others = list(srcs)
    turns = others + ["new", "new"] + others[::-1]

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(smi)
    g = torch.Generator().manual_seed(1)
    rows = []
    for case, b, L, h, d, causal in CASES:
        qkv = torch.randn(b, L, 3, h, d, generator=g).to("cuda", torch.bfloat16)
        q, k, v = qkv.unbind(2)
        ro, rlse = flash.attention_plain(q, k, v, causal)
        row = {"case": case, "b": b, "l": L, "h": h, "d": d, "causal": causal,
               "bound_ms": max(flash_bound_ms(b, L, L, h, d, "bf16", causal)),
               "err": {}, "ms": {}}
        for name, run in callers.items():
            o, lse = run(q, k, v, causal)
            torch.cuda.synchronize()
            row["err"][name] = [(o.float() - ro.float()).abs().max().item(),
                                (lse - rlse).abs().max().item()]
            if not (torch.allclose(o.float(), ro.float(), rtol=2e-2, atol=2e-2)
                    and torch.allclose(lse, rlse, rtol=1e-3, atol=1e-3)):
                raise SystemExit(f"flash_sweep: {name} disagrees at {case}: {row['err'][name]}")
        del ro, rlse
        for name in turns:
            row["ms"].setdefault(name, []).append(
                kernel_ms(lambda: callers[name](q, k, v, causal)))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        row["sdpa_ms"] = kernel_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal))
        rows.append(row)
        print(f"[sweep] {case:15s} B{b} L{L} H{h} D{d} causal={int(causal)} "
              + " ".join(f"{n} {'/'.join(f'{t:.4f}' for t in row['ms'][n])}" for n in callers)
              + f" sdpa {row['sdpa_ms']:.4f} bound {row['bound_ms']:.4f} ms")
        del qkv, q, k, v
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"gpu": smi, "sources": {n: str(p) for n, p in srcs.items()},
                       "turns": turns, "cases": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
