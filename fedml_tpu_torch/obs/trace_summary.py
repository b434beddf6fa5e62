"""The port's spans in a run's ``metrics.jsonl``: host clock, device clock
and counts per span, and each profiler capture's idle time by span.

    python -m fedml_tpu_torch.obs.trace_summary <run_dir> [<run_dir> ...]
    python -m fedml_tpu_torch.obs.trace_summary --json <run_dir> ...

Reads the round rows' ``time_<name>`` (host seconds), ``device_<name>``
(the CUDA stream's clock between the span's two timing events) and
``calls_<name>`` (times closed), and prints each span's mean a round.
For each ``kind=trace`` record that ``core/metrics.trace`` wrote
(``--profile_round``) it prints the device's idle time under each span
(``idle_by_span``) and each span's parent, calls, total and self time.
``tools/trace_summary.py`` prints the rest of the stream (comm tables,
telemetry, gauges); this reader adds what only the port's rows carry.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional

_CLOCKS = ("time_", "device_", "calls_")


def load_records(path: str) -> List[dict]:
    """The records of ``path`` (a run dir or its ``metrics.jsonl``); a
    partial last line of a crashed run is skipped."""
    if os.path.isdir(path):
        path = os.path.join(path, "metrics.jsonl")
    records = []
    with open(path) as fh:
        for line in fh:
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return records


def summarize(records: List[dict]) -> dict:
    """``spans`` {name: {host_s, device_s, calls}}, each the mean a round
    over the round rows that carry it (``None`` where none does), and
    ``traces``, the ``kind=trace`` records with an ``idle_by_span``."""
    rounds = [r for r in records if "round" in r and "kind" not in r]
    names = sorted({k[len(p):] for r in rounds for k in r for p in _CLOCKS
                    if k.startswith(p)})

    def mean(key: str) -> Optional[float]:
        vals = [r[key] for r in rounds if isinstance(r.get(key), (int, float))]
        return sum(vals) / len(vals) if vals else None

    spans = {n: {"host_s": mean(f"time_{n}"), "device_s": mean(f"device_{n}"),
                 "calls": mean(f"calls_{n}")} for n in names}
    traces = [r for r in records if r.get("kind") == "trace" and "idle_by_span" in r]
    return {"num_rounds": len(rounds), "spans": spans, "traces": traces}


def _s(v: Optional[float]) -> str:
    if v is None:
        return "-"
    return f"{v * 1e3:.2f}ms" if v < 1 else f"{v:.2f}s"


def render_text(path: str, s: dict) -> None:
    print(f"== {path}  rounds: {s['num_rounds']}")
    if s["spans"]:
        print("\n  spans (mean a round: host, device clock, times closed):")
        print(f"    {'span':<16}{'host':>12}{'device':>12}{'calls':>10}")
        for name, row in s["spans"].items():
            calls = "-" if row["calls"] is None else f"{row['calls']:g}"
            print(f"    {name:<16}{_s(row['host_s']):>12}{_s(row['device_s']):>12}"
                  f"{calls:>10}")
    for t in s["traces"]:
        window, busy = t["window_s"], t["busy_s"]
        print(f"\n  idle by span ({t.get('trace_path')}): window {_s(window)}, "
              f"device busy {_s(busy)}, idle {_s(window - busy)}")
        for name, secs in sorted(t["idle_by_span"].items(), key=lambda kv: -kv[1]):
            share = 100.0 * secs / window if window else 0.0
            print(f"    {name:<28}{_s(secs):>12}{share:>8.1f}%")
        if t.get("spans"):
            print(f"    {'span':<16}{'parent':<16}{'calls':>8}{'total':>12}{'self':>12}")
            for name, row in sorted(t["spans"].items(), key=lambda kv: -kv[1]["self_s"]):
                print(f"    {name:<16}{str(row.get('parent') or '-'):<16}{row['calls']:>8}"
                      f"{_s(row['total_s']):>12}{_s(row['self_s']):>12}")
    print()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("paths", nargs="+", help="run dirs or metrics.jsonl files")
    p.add_argument("--json", action="store_true", help="one JSON object, keyed by path")
    args = p.parse_args(argv)
    out: Dict[str, dict] = {}
    for path in args.paths:
        try:
            out[path] = summarize(load_records(path))
        except OSError as e:
            print(f"{path}: {e}", file=sys.stderr)
            return 1
    if args.json:
        print(json.dumps(out, indent=2, default=float))
    else:
        for path, s in out.items():
            render_text(path, s)
    return 0


if __name__ == "__main__":
    sys.exit(main())
