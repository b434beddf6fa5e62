"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (everything before the window, from the process's start): the
clients' data and the initial variables from ``--seed``, the program's
``FedAvgSimulation`` built as ``experiments/run.py`` builds it, and its
first rounds, which build the kernels, warm every shape and give the
readings that ``correct`` compares.  The window then calls
``FedAvgSimulation.run_round`` back to back, whole rounds, until
``--seconds`` have passed; a rate is all the work of those rounds over the
time from the first round's start to the last one's end.  With
``--trace 1`` one more round runs under the profiler and the per-layer
metrics are reported instead of the end-to-end ones.  After the window
the program is freed and the float32 reference follows the first rounds
(``correct.py``).

The last line of standard output is the result (JSON); the numbers
compared and their limits close standard error.  Without a CUDA card,
or with JAX or the JAX package loaded in the process, the run exits
non-zero and prints no result.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from typing import Callable, Optional  # noqa: E402

BANNED = ("jax", "jaxlib", "flax", "optax", "fedml_tpu")


def banned_modules() -> list:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's (compared whole: ``fedml_tpu_torch`` is not ``fedml_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


class Context:
    """What the metric readers read (``metrics/<name>.py``)."""

    def __init__(self, cell, family, rows, spans, window_s, setup_s, packed_steps,
                 trace=None):
        self.cell = cell
        self.cfg = cell.cfg
        self.traffic = cell.traffic
        self.family = family
        self.rows = rows                  # the window's round rows
        self.spans = spans                # the program's spans of each window round
        self.window_s = window_s
        self.setup_s = setup_s
        self.packed_steps = packed_steps
        self.trace = trace                # benchmark.trace.Trace of one round, or None
        # real samples or tokens trained: a row counts its last epoch's
        self.units = int(cell.traffic["epochs"]) * sum(r["count"] for r in rows)
        self.count_unit = family.COUNT_UNIT

    @property
    def steps_per_round(self) -> int:
        """Optimizer steps computed in a round, padding included."""
        t = self.traffic
        return t["clients"] * self.packed_steps * t["epochs"]


def run_cell(cell, seed: int, seconds: float, trace: bool, device, *, t0: float = _T0,
             loss_wrap: Optional[Callable] = None,
             round_wrap: Optional[Callable] = None) -> dict:
    """One run of ``cell``; returns the result dict (``checks`` last).
    ``loss_wrap`` and ``round_wrap`` break the program underneath, for the
    tests that show a broken run is not ``correct``."""
    import torch

    from benchmark import correct, families, generator, program, spec, weights
    from benchmark.trace import profile_call

    cfg, mix = cell.cfg, cell.traffic
    family = families.load(cfg["family"])
    data = generator.generate(cfg, mix, seed, device)
    steps = generator.packed_steps(data, mix["batch_size"])
    w0 = weights.make_variables(family.variable_shapes(cfg), family.init_rule, seed, device)
    sim = program.build_simulation(family, cfg, mix, data, w0, seed, device, loss_wrap)
    if round_wrap is not None:
        sim.round_fn = round_wrap(sim.round_fn)

    def synced():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # the first rounds: kernel builds and warm-up, and the program's readings
    followed = int(cell.limits["rounds_followed"])
    prog = correct.program_readings(sim, w0, followed)
    del w0
    synced()
    setup_s = time.perf_counter() - t0

    rows, spans = [], []
    start = time.perf_counter()
    while True:
        rows.append(sim.run_round())
        spans.append(sim.metrics.pop_spans())
        log(f"round {len(rows)}: {time.perf_counter() - start:.3f} s into the window")
        if time.perf_counter() - start >= seconds:
            break
    synced()
    window_s = time.perf_counter() - start
    failed = sum(1 for r in rows if not math.isfinite(r.get("train_loss", math.nan)))

    tr = None
    if trace and device.type == "cuda":
        _, tr = profile_call(sim.run_round)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    ctx = Context(cell, family, rows, spans, window_s, setup_s, steps, tr)
    chosen = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in chosen:
        v = spec.reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": False, "attempted": len(rows), "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.top_gaps()}

    # the program is done: free it, then the reference follows its first rounds
    del sim, ctx, tr
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = correct.reference_readings(family, cfg, mix, data, seed, device, followed)
    numbers = correct.compare(prog, ref)
    checks = correct.checks(numbers, cell.limits["limits"])
    log(f"reference: {followed} rounds in {time.perf_counter() - t_ref:.1f} s")
    result["correct"] = failed == 0 and correct.passed(checks)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark import spec

    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA card(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), device)
    found = banned_modules()
    if found:
        log(f"refused: modules of JAX or the JAX package are loaded: {found}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
