"""Structured metrics, named timing spans, and the profiler capture.

Port of ``fedml_tpu/core/metrics.py`` (without wandb):

- ``MetricsLogger``: ``log(dict)`` → JSON-lines file + python logging,
  with pending ``span`` timings attached to round rows: host seconds,
  counts, and on a CUDA device the device clock's seconds of the spans
  opened with ``device=True``.  An
  outermost span also feeds the ``span.<name>_s`` telemetry histogram.
- ``span(name)``: a span on the active logger (``MetricsLogger.activate``,
  which ``FedAvgSimulation`` holds around each round-function call), a
  no-op without one; code inside a round opens its spans here.
- ``trace(dir)``: a ``torch.profiler`` capture of device activity and the
  spans' ranges on one timeline, written as a chrome trace and reduced to
  busy time and the idle time under each span (``reduce_capture``);
- ``setup_logging``: the per-process log format.
"""

from __future__ import annotations

import contextlib
import heapq
import json
import logging
import os
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch

from fedml_tpu_torch.obs.telemetry import Telemetry, get_telemetry

logger = logging.getLogger("fedml_tpu_torch")

# the logger ``span`` opens spans on, and the capture ``trace`` runs
_ACTIVE: Optional["MetricsLogger"] = None
_CAPTURE: Optional["Capture"] = None
_NO_SPAN = contextlib.nullcontext()
# pending device-clock pairs are resolved at an outermost span's close
# past this many, so a caller that never pops keeps the event pool bounded
_FOLD_AT = 1 << 14
# the capture's own range (its window), and the name of idle time under no span
_WINDOW = "capture_window"
OUTSIDE = "(outside program spans)"

_profiler_enabled = torch._C._autograd._profiler_enabled


def span(name: str, device: bool = False):
    """``name``'s span on the active logger (``MetricsLogger.activate``);
    without one a no-op that costs one global read."""
    lg = _ACTIVE
    return _NO_SPAN if lg is None else lg.span(name, device)


class _Span:
    """One open ``MetricsLogger.span``."""

    __slots__ = ("lg", "name", "device", "t0", "start", "rf")

    def __init__(self, lg: "MetricsLogger", name: str, device: bool):
        self.lg = lg
        self.name = name
        self.device = device

    def __enter__(self):
        lg = self.lg
        self.rf = None
        if _profiler_enabled():
            self.rf = torch.autograd.profiler.record_function(self.name)
            self.rf.__enter__()
        with lg._lock:
            if self.rf is not None and _CAPTURE is not None:
                _CAPTURE.parents.setdefault(self.name,
                                            lg._open[-1].name if lg._open else None)
            if lg._cuda and not lg._open:
                lg._stream = torch.cuda.current_stream()
            lg._open.append(self)
            self.start = lg._mark() if self.device and lg._cuda else None
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        lg, name = self.lg, self.name
        with lg._lock:
            if self.start is not None:
                lg._pairs.append((name, self.start, lg._mark()))
            lg.spans[name] = lg.spans.get(name, 0.0) + dt
            lg._calls[name] = lg._calls.get(name, 0) + 1
            lg._open.remove(self)
            outermost = not lg._open
            if outermost and len(lg._pairs) > _FOLD_AT:
                lg._fold_pairs()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        if outermost:
            lg.telemetry.observe(f"span.{name}_s", dt)
        return False


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
        # pending spans: host seconds, times closed, device seconds of the
        # resolved pairs and the (name, start, end) event pairs not yet read
        self.spans: Dict[str, float] = {}
        self._calls: Dict[str, int] = {}
        self._device: Dict[str, float] = {}
        self._pairs: List[tuple] = []
        # timing events, reused once the pairs that hold them are resolved
        self._events: List[torch.cuda.Event] = []
        self._used = 0
        self._open: List[_Span] = []  # open spans, outermost first
        self._cuda = False
        self._stream = None  # the current stream as the outermost span opened
        self._lock = threading.Lock()

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

    def use_device(self, device) -> None:
        """Time spans on the device clock as well when ``device`` is a CUDA
        device (``FedAvgSimulation`` passes its own)."""
        self._cuda = torch.device(device).type == "cuda"

    @contextlib.contextmanager
    def activate(self):
        """Make this the logger that ``span(name)`` opens spans on, for the
        block.  Process-wide, not per thread: autograd runs a CUDA
        backward on a thread of its own."""
        global _ACTIVE
        prev, _ACTIVE = _ACTIVE, self
        try:
            yield self
        finally:
            _ACTIVE = prev

    def span(self, name: str, device: bool = False) -> _Span:
        """Named span, attached to the next ``log`` call; spans of one name
        accumulate until popped, and spans nest.

        - Host clock: ``time.perf_counter`` seconds.
        - Device clock (``device=True`` on a CUDA ``use_device``): a
          timing event at the span's start and end on the stream that was
          current when the outermost open span opened.  That is the
          stream's time from one marker to the other, idle included:
          device time where the device sets the pace, the host's pace
          where the host does.  Only the spans whose device time is read
          ask for it: the events and their resolution in ``pop_spans``
          cost host time in every round.
        - While a profiler runs, a ``record_function`` range of the same
          name, so the spans and the device's activity share a timeline
          (``trace``).
        - An outermost span (none other open) also feeds the
          ``span.<name>_s`` histogram; a nested one lives in the row only.

        Closing a span is thread-safe."""
        return _Span(self, name, device)

    def _mark(self) -> torch.cuda.Event:
        """A pooled timing event, recorded now (under ``_lock``)."""
        if self._used == len(self._events):
            self._events.append(torch.cuda.Event(enable_timing=True))
        ev = self._events[self._used]
        self._used += 1
        ev.record(self._stream)
        return ev

    def _fold_pairs(self) -> None:
        """Resolve the pending pairs into device seconds (under ``_lock``),
        waiting on an end event not yet reached; with no span open the
        pool is free again."""
        for name, start, end in self._pairs:
            if not end.query():
                end.synchronize()
            self._device[name] = self._device.get(name, 0.0) + 1e-3 * start.elapsed_time(end)
        self._pairs = []
        if not self._open:
            self._used = 0

    def pop_spans(self) -> Dict[str, float]:
        """Pending spans, cleared: ``time_<name>`` (host seconds, summed),
        ``device_<name>`` (device-clock seconds: CUDA, ``device=True``) and
        ``calls_<name>`` (times closed).  Called after a round's read-back,
        the device clock's events are complete."""
        with self._lock:
            self._fold_pairs()
            host, device, calls = self.spans, self._device, self._calls
            self.spans, self._device, self._calls = {}, {}, {}
        out: Dict[str, float] = {f"time_{k}": v for k, v in host.items()}
        out.update({f"device_{k}": v for k, v in device.items()})
        out.update({f"calls_{k}": v for k, v in calls.items()})
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


class Capture:
    """What ``trace`` recorded: each span's parent as it opened, and, once
    the block has exited, the chrome trace's ``path`` and the ``summary``
    (``reduce_capture``'s)."""

    def __init__(self):
        self.parents: Dict[str, Optional[str]] = {}
        self.path: Optional[str] = None
        self.summary: dict = {}


def _union(intervals: Iterable[Tuple[int, int]]) -> List[list]:
    """Merged, sorted intervals of ``[(start, end)]``."""
    merged: List[list] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce_capture(device: List[Tuple[int, int]], spans: List[Tuple[int, int, str]],
                   window: Tuple[int, int],
                   parents: Optional[Dict[str, Optional[str]]] = None) -> dict:
    """A capture's intervals (ns: the device's activity, the spans'
    ranges and the capture's window) reduced to

    - ``window_s`` and ``busy_s``, the union of the device's activity
      inside the window;
    - ``idle_by_span`` {span: seconds}: each gap in the device's activity,
      the window's head and tail included, under the innermost span
      running at the gap's midpoint (the latest-starting one not yet
      ended), else ``OUTSIDE``; the gaps sum to ``window_s − busy_s``;
    - ``spans`` {name: parent, calls, total_s, self_s}: a span's self time
      is its time less what the spans inside it cover."""
    w0, w1 = window
    busy = _union((max(s, w0), min(e, w1)) for s, e in device if e > w0 and s < w1)
    edges = [w0] + [t for b in busy for t in b] + [w1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    ranges = sorted(spans)
    idle: Dict[str, float] = {}
    heap: list = []
    j = 0
    for a, b in gaps:
        mid = (a + b) // 2
        while j < len(ranges) and ranges[j][0] <= mid:
            s, e, name = ranges[j]
            heapq.heappush(heap, (-s, e, name))
            j += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        name = heap[0][2] if heap else OUTSIDE
        idle[name] = idle.get(name, 0.0) + (b - a) * 1e-9
    # self time: each range less the ranges directly inside it, found by a
    # sweep in start order with a stack of the ranges still open
    table: Dict[str, dict] = {}
    stack: List[Tuple[int, str]] = []  # (end, name)
    for s, e, name in sorted(spans, key=lambda r: (r[0], -r[1])):
        while stack and stack[-1][0] <= s:
            stack.pop()
        if stack:
            table[stack[-1][1]]["self_s"] -= (min(e, stack[-1][0]) - s) * 1e-9
        row = table.setdefault(name, {"parent": (parents or {}).get(name), "calls": 0,
                                      "total_s": 0.0, "self_s": 0.0})
        row["calls"] += 1
        row["total_s"] += (e - s) * 1e-9
        row["self_s"] += (e - s) * 1e-9
        stack.append((e, name))
    busy_ns = sum(e - s for s, e in busy)
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": busy_ns * 1e-9,
            "idle_by_span": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
            "spans": table}


def _reduce_events(events, parents: Dict[str, Optional[str]]) -> dict:
    """``reduce_capture`` over the profiler's events: device activity,
    the capture's window and the ranges of the spans that opened in it.
    The profiler also projects each range onto the device's timeline
    (under the range's name, from its first kernel to its last): those
    are not activity."""
    cuda = torch.autograd.DeviceType.CUDA
    device, spans, window = [], [], None
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == cuda:
            if e.name() != _WINDOW and e.name() not in parents:
                device.append((s, s + d))
        elif e.name() == _WINDOW:
            window = (s, s + d)
        elif e.name() in parents:
            spans.append((s, s + d, e.name()))
    if window is None:
        raise RuntimeError("the profiler recorded no capture window")
    return reduce_capture(device, spans, window, parents)


def _start_capture(cuda: bool):
    """Start the profiler with CUDA activity and the CPU side limited to
    user scopes; where this torch's profiler internals differ, the public
    ``torch.profiler.profile`` with every host operator.  Returns the
    function that stops it and returns its results, and which host
    operators it records."""
    try:
        from torch._C._autograd import _disable_profiler, _enable_profiler, _prepare_profiler
        from torch._C._profiler import (
            ProfilerActivity,
            ProfilerConfig,
            ProfilerState,
            RecordScope,
            _ExperimentalConfig,
        )

        activities = {ProfilerActivity.CPU}
        if cuda:
            activities.add(ProfilerActivity.CUDA)
        config = ProfilerConfig(
            state=ProfilerState.KINETO, report_input_shapes=False, profile_memory=False,
            with_stack=False, with_flops=False, with_modules=False,
            experimental_config=_ExperimentalConfig())
        _prepare_profiler(config, activities)
        _enable_profiler(config, activities, {RecordScope.USER_SCOPE})
        return _disable_profiler, "user_scopes"
    except (ImportError, AttributeError, TypeError):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()

        def stop():
            prof.stop()
            return prof.profiler.kineto_results

        return stop, "all"


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None,
          logger: Optional[MetricsLogger] = None):
    """A ``torch.profiler`` capture of the block; yields a ``Capture``.

    It records the device's activity, the host's CUDA calls and the
    spans' ``record_function`` ranges on one timeline, with the device
    synchronised before and after.  Host operators are left out (user
    scopes only): recording each would slow a host-bound round by a
    further quarter.  Where this torch's profiler internals do not take
    that, every host operator is recorded, and the summary's
    ``host_ops`` says ``all`` (else ``user_scopes``).  On exit the chrome
    trace is written to ``log_dir`` (default ``<logger.run_dir>/trace``),
    the events are reduced (``reduce_capture``: ``window_s``, ``busy_s``,
    ``idle_by_span``, ``spans``) into ``Capture.summary``, and a
    ``kind=trace`` record of the path and the summary goes into the
    logger's stream."""
    global _CAPTURE
    if log_dir is None:
        if logger is None or not logger.run_dir:
            raise ValueError("trace() needs a log_dir or a logger with a run_dir")
        log_dir = os.path.join(logger.run_dir, "trace")
    os.makedirs(log_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize()
    cap = Capture()
    stop, host_ops = _start_capture(cuda)
    prev, _CAPTURE = _CAPTURE, cap
    try:
        with torch.autograd.profiler.record_function(_WINDOW):
            yield cap
            if cuda:
                torch.cuda.synchronize()
    finally:
        _CAPTURE = prev
        result = stop()
    cap.path = os.path.join(log_dir, "trace.json")
    result.save(cap.path)
    cap.summary = {**_reduce_events(result.events(), cap.parents), "host_ops": host_ops}
    if logger is not None:
        logger.log({"kind": "trace", "trace_path": cap.path, **cap.summary})
