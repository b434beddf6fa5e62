"""Readings that the limits of ``limits/<cell>.json`` are set from, at the
cell's own size on the card, several seeds in one process:

- ``program``: the program's first rounds, as a run's set-up takes them,
  against the float32 reference (the lower readings);
- ``control``: the reference computed one precision step below the
  configuration's bf16 (``reference/quant.py``; the cell's limits file
  names fp8) in the program's place (the upper readings);
- ``half_batch``, ``unchanged_state``: the program with a planted fault
  of ``faults.py``.

    python -m benchmark.calibrate --workload <cell> --seeds 11,12,13 [--what program,control,half_batch] [--out FILE]

Prints one JSON line per seed and reading (the numbers, the worst
leaves, and each leaf's change norms, the program's and the
reference's), and appends it to ``--out``.  The benchmark's own runs do
not run this."""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import correct, faults, families, generator, program, spec, weights


def readings(cell, seed: int, what, device) -> dict:
    cfg, mix = cell.cfg, cell.traffic
    family = families.load(cfg["family"])
    data = generator.generate(cfg, mix, seed, device)
    rounds = int(cell.limits["rounds_followed"])
    got = {}
    for kind in what:
        t0 = time.perf_counter()
        if kind == "control":
            got[kind] = correct.reference_readings(family, cfg, mix, data, seed, device, rounds,
                                                   precision=cell.limits["control"])
        else:
            w0 = weights.make_variables(family.variable_shapes(cfg), family.init_rule, seed, device)
            sim = program.build_simulation(family, cfg, mix, data, w0, seed, device,
                                           faults.LOSS_FAULTS.get(kind))
            if kind in faults.ROUND_FAULTS:
                sim.round_fn = faults.ROUND_FAULTS[kind](sim.round_fn)
            got[kind] = correct.program_readings(sim, w0, rounds)
            del sim, w0
        if device.type == "cuda":
            torch.cuda.empty_cache()
        print(f"{kind}: {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    ref = correct.reference_readings(family, cfg, mix, data, seed, device, rounds)
    print(f"reference: {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    return {kind: {**correct.compare(r, ref), "loss": r["loss"], "ref_loss": ref["loss"],
                   "detail": correct.leaf_detail(r, ref),
                   "norms": {f"change{n}": {k: [r["change"][n][k], q[k]] for k in q}
                             for n, q in ref["change"].items()}}
            for kind, r in got.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--what", default="program,control,half_batch")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("calibration runs on the card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        for kind, numbers in readings(cell, seed, args.what.split(","), device).items():
            line = json.dumps({"workload": cell.name, "seed": seed, "reading": kind, **numbers})
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
