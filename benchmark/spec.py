"""``BENCHMARK.json`` and the files it names.

A cell (``workloads`` entry) names a configuration, found at
``configs/<config>.json``, and a traffic mix, at ``traffic/<traffic>.json``;
its correctness limits are at ``limits/<cell>.json``; each metric, end to
end or per layer, is read by ``metrics/<metric name>.py``, whose
``read(ctx)`` returns the value or ``None`` where it finds nothing to
read.  Adding a cell or a metric adds files and entries, and edits none."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    def __init__(self, bench: dict, name: str):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
        self.entry = cells[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        self.cfg = load_json(HERE / "configs" / f"{self.entry['config']}.json")
        self.traffic = load_json(HERE / "traffic" / f"{self.entry['traffic']}.json")
        self.limits = load_json(HERE / "limits" / f"{name}.json")
        self.end_to_end = _metrics_of(bench["end_to_end"], name)
        self.per_layer = _metrics_of(bench["per_layer"], name, bench["end_to_end"])


def _metrics_of(entries: List[dict], cell: str, e2e: List[dict] = None) -> List[dict]:
    """The metrics a cell reports: those that list it, or, without a list,
    every cell (a per-layer metric without a list: every cell that
    reports the end-to-end metric it moves)."""
    out = []
    for m in entries:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif e2e is None:
            out.append(m)
        elif any(x["name"] == m["moves"] and cell in x.get("workloads", [cell]) for x in e2e):
            out.append(m)
    return out


def load_cell(name: str, bench_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    return Cell(load_json(bench_path), name)


def reader(metric_name: str) -> Callable:
    """``read(ctx)`` of ``metrics/<metric_name>.py``."""
    path = HERE / "metrics" / f"{metric_name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric_name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
