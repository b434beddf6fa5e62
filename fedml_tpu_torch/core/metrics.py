"""Structured metrics, named timing spans, and the profiler hook.

Port of ``fedml_tpu/core/metrics.py`` (without wandb):

- ``MetricsLogger``: ``log(dict)`` → JSON-lines file + python logging,
  with pending ``span`` timings attached to round rows; each span also
  feeds the ``span.<name>_s`` telemetry histogram.
- ``trace(dir)``: a ``torch.profiler`` context (CPU and, when present,
  CUDA activity) that writes a chrome trace into ``dir``;
- ``setup_logging``: the per-process log format.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Any, Dict, Optional

from fedml_tpu_torch.obs.telemetry import Telemetry, get_telemetry

logger = logging.getLogger("fedml_tpu_torch")


class MetricsLogger:
    def __init__(
        self,
        run_dir: Optional[str] = None,
        telemetry: Optional[Telemetry] = None,
        filename: str = "metrics.jsonl",
    ):
        self.run_dir = run_dir
        self.telemetry = telemetry or get_telemetry()
        self._fh = None
        if run_dir:
            os.makedirs(run_dir, exist_ok=True)
            self._fh = open(os.path.join(run_dir, filename), "a")
        self.spans: Dict[str, float] = {}

    def _write(self, record: dict) -> None:
        # serialize only when someone is listening
        if self._fh is None and not logger.isEnabledFor(logging.INFO):
            return
        line = json.dumps(record, default=float)
        logger.info("metrics %s", line)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> dict:
        record = dict(metrics)
        if step is not None:
            record.setdefault("round", step)
        # pending spans attach to ROUND rows only, never to event records
        if self.spans and "kind" not in record:
            record.update(self.pop_spans())
        record.setdefault("ts", time.time())  # fedlint: disable=determinism -- MetricsLogger IS the obs layer's writer (lives in core/ for import-order reasons); ts is record metadata
        self._write(record)
        return record

    def log_telemetry(self) -> dict:
        """Drain pending telemetry events into the record stream, then
        write one ``kind=telemetry`` snapshot of every series."""
        for ev in self.telemetry.drain_events():
            self._write(ev)
        record = {"kind": "telemetry", "ts": time.time(),  # fedlint: disable=determinism -- snapshot-record wall stamp (obs-role module); nothing replays it
                  **self.telemetry.snapshot()}
        self._write(record)
        return record

    @contextlib.contextmanager
    def span(self, name: str):
        """Named wall-clock span, attached to the next ``log`` call.
        Repeated spans of one name accumulate until popped."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.spans[name] = self.spans.get(name, 0.0) + dt
            self.telemetry.observe(f"span.{name}_s", dt)

    def pop_spans(self) -> Dict[str, float]:
        """Pending spans as ``time_<name>`` keys; clears the accumulator."""
        out = {f"time_{k}": v for k, v in self.spans.items()}
        self.spans = {}
        return out

    def close(self) -> None:
        """Idempotent: safe to call twice, safe after ``with`` exit."""
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False


def setup_logging(rank: Optional[int] = None, level=logging.INFO) -> None:
    """Per-process format including the process rank."""
    tag = f"[rank {rank}] " if rank is not None else ""
    logging.basicConfig(
        level=level,
        format=f"%(asctime)s {tag}%(name)s %(levelname)s: %(message)s",
    )


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None,
          logger: Optional[MetricsLogger] = None):
    """``torch.profiler`` trace context; yields the profiler.

    ``log_dir`` defaults to ``<logger.run_dir>/trace``; the chrome trace
    is written there on exit and its path logged into the metrics
    stream.  ``key_averages()`` on the yielded profiler gives the time
    by kernel."""
    import torch

    if log_dir is None:
        if logger is None or not logger.run_dir:
            raise ValueError("trace() needs a log_dir or a logger with a run_dir")
        log_dir = os.path.join(logger.run_dir, "trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    if logger is not None:
        logger.log({"kind": "trace", "trace_path": path})
