"""Process-wide telemetry registry: counters, gauges, histograms, events.

Stdlib copy of ``fedml_tpu/obs/telemetry.py``: one registry owns every
host-side counter, so any layer can report without plumbing a handle
through the call stack.

Naming convention: ``<namespace>.<metric>{label=value,label2=value2}``,
e.g. ``comm.sent_bytes{msg_type=S2C_SYNC_MODEL}``, ``rounds.degraded``,
``span.round_s``.  Labels are sorted, so a (name, labels) pair always
renders to the same key.

Histograms are log-scale bucketed (powers of two): an observation ``v``
lands in the bucket with upper bound ``2**ceil(log2(v))``; ``v == 0``
gets its own ``0`` bucket.  NaN/inf/negative observations are rejected
(``ValueError``) — a NaN folded into ``sum`` would silently poison every
later mean.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional


def metric_key(name: str, labels: Optional[Dict[str, Any]] = None) -> str:
    """``name{k=v,...}`` with sorted labels (stable across call sites)."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


def parse_metric_key(key: str):
    """Inverse of ``metric_key``: ``(name, labels dict)``."""
    if not key.endswith("}") or "{" not in key:
        return key, {}
    name, _, inner = key.partition("{")
    labels = {}
    for part in inner[:-1].split(","):
        if "=" in part:
            k, _, v = part.partition("=")
            labels[k] = v
    return name, labels


class Histogram:
    """Log2-bucketed histogram: O(1) memory per decade of dynamic range."""

    __slots__ = ("count", "sum", "min", "max", "buckets")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.buckets: Dict[float, int] = {}  # upper bound -> count

    def observe(self, value: float) -> None:
        v = float(value)
        if math.isnan(v) or math.isinf(v):
            raise ValueError(f"histogram rejects non-finite observation: {v}")
        if v < 0:
            raise ValueError(f"histogram rejects negative observation: {v}")
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        le = 0.0 if v == 0.0 else 2.0 ** math.ceil(math.log2(v))
        self.buckets[le] = self.buckets.get(le, 0) + 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def snapshot(self) -> dict:
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
            "mean": self.mean,
            # string keys: JSON objects can't have float keys
            "buckets": {repr(le): n for le, n in sorted(self.buckets.items())},
        }


class Telemetry:
    """Thread-safe registry; the lock is leaf-level (never held across
    another acquire)."""

    def __init__(self, max_events: int = 4096):
        self._lock = threading.Lock()
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.hists: Dict[str, Histogram] = {}
        self._events: deque = deque(maxlen=max_events)
        # taps: single callbacks run outside the lock after an event or an
        # observation lands, the flight recorder's feed (``obs/flight.py``);
        # a plain attribute swap, so readers see the old tap or the new one
        self._event_tap = None
        self._observe_tap = None

    # -- taps ---------------------------------------------------------------
    def set_event_tap(self, fn) -> None:
        """Install the single event tap (``fn(record_dict)``), called after
        every ``event()`` append outside the lock; its exceptions are
        swallowed.  ``None`` uninstalls."""
        self._event_tap = fn

    def set_observe_tap(self, fn) -> None:
        """Install the single histogram tap (``fn(name, value, labels)``),
        called after every accepted ``observe()``, as the event tap."""
        self._observe_tap = fn

    # -- counters -----------------------------------------------------------
    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        key = metric_key(name, labels)
        with self._lock:
            self.counters[key] = self.counters.get(key, 0.0) + value

    # -- gauges -------------------------------------------------------------
    def gauge_set(self, name: str, value: float, **labels) -> None:
        with self._lock:
            self.gauges[metric_key(name, labels)] = float(value)

    def gauge_max(self, name: str, value: float, **labels) -> None:
        """High-water gauge: keeps the max ever seen (device peak bytes)."""
        key = metric_key(name, labels)
        with self._lock:
            self.gauges[key] = max(self.gauges.get(key, -math.inf), float(value))

    # -- histograms ---------------------------------------------------------
    def observe(self, name: str, value: float, **labels) -> None:
        key = metric_key(name, labels)
        with self._lock:
            h = self.hists.get(key)
            if h is None:
                h = self.hists[key] = Histogram()
            h.observe(value)
        tap = self._observe_tap
        if tap is not None:
            try:
                tap(name, value, labels)
            except Exception:
                pass  # the tap must never break the emitter

    # -- events -------------------------------------------------------------
    def event(self, kind: str, **fields) -> dict:
        """Append a timestamped event (compile, trace, ...) to the bounded
        ring; ``MetricsLogger.log_telemetry`` drains these into the
        metrics.jsonl record stream."""
        rec = {"kind": kind, "ts": time.time(), **fields}
        with self._lock:
            self._events.append(rec)
        tap = self._event_tap
        if tap is not None:
            try:
                tap(rec)
            except Exception:
                pass  # the tap must never break the emitter
        return rec

    def drain_events(self) -> List[dict]:
        with self._lock:
            out = list(self._events)
            self._events.clear()
        return out

    # -- export -------------------------------------------------------------
    def snapshot(self) -> dict:
        """JSONL-able point-in-time copy of every series."""
        with self._lock:
            return {
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "hists": {k: h.snapshot() for k, h in self.hists.items()},
            }

    def counter_value(self, name: str, **labels) -> float:
        """One counter's current value (0.0 when it was never bumped)."""
        with self._lock:
            return self.counters.get(metric_key(name, labels), 0.0)

    def reset(self) -> None:
        with self._lock:
            self.counters.clear()
            self.gauges.clear()
            self.hists.clear()
            self._events.clear()


_GLOBAL = Telemetry()


def get_telemetry() -> Telemetry:
    """The process-wide registry (one per process, like the root logger)."""
    return _GLOBAL
