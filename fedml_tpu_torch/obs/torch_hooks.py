"""PyTorch runtime hooks: call-signature tracking, device memory gauges,
profiler traces (port of ``fedml_tpu/obs/jax_hooks.py``).

- ``instrument_signatures`` wraps a round or eval function and tracks the
  abstract signature (structure + shape/dtype per tensor leaf, Python
  scalars by type) of every call.  The first call under a new signature
  counts on ``calls.new_signature{fn=...}`` with its wall seconds.  Eager
  PyTorch compiles nothing, so this counts what the JAX package's
  ``jax.compiles`` counts there, new shapes, without the compile: a
  driver that varies a shape per round shows the counter climbing with
  the round index instead of sitting at 1.  The bookkeeping is host-side
  dict lookups.
- ``record_device_memory`` snapshots ``torch.cuda.memory_stats`` into
  high-water gauges; on the CPU it records nothing.
- ``trace_rounds`` wraps N fully synced rounds in a ``torch.profiler``
  trace.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from fedml_tpu_torch.obs.telemetry import Telemetry, get_telemetry


def abstract_signature(args, kwargs=None) -> Optional[Tuple]:
    """Hashable call key: the nesting of dicts/sequences, (shape, dtype)
    per tensor or array leaf, Python scalars by TYPE (a per-round int
    such as the round index is not a new signature); None when a leaf is
    unhashable (the call is then not tracked)."""

    def walk(node):
        if isinstance(node, dict):  # key order is not structure
            return ("dict", tuple((k, walk(node[k])) for k in sorted(node, key=str)))
        if isinstance(node, (list, tuple)):
            return (type(node).__name__, tuple(walk(v) for v in node))
        if isinstance(node, (torch.Tensor, np.ndarray)):
            return (tuple(node.shape), str(node.dtype))
        if isinstance(node, (bool, int, float, complex)):
            return (type(node).__name__,)
        hash(node)  # TypeError for an unhashable static leaf
        return (type(node).__name__, node)

    try:
        return walk((args, kwargs or {}))
    except TypeError:
        return None


def instrument_signatures(fn: Callable, name: str,
                          telemetry: Optional[Telemetry] = None) -> Callable:
    """Wrap ``fn`` with host-side new-signature tracking.

    Per NEW signature: ``calls.new_signature{fn=name}`` += 1, the call's
    wall seconds land in ``calls.new_signature_s{fn=name}`` and a
    ``new_signature`` event (drained into metrics.jsonl by
    ``MetricsLogger.log_telemetry``)."""
    seen: dict = {}

    def wrapped(*args, **kwargs):
        t = telemetry or get_telemetry()
        sig = abstract_signature(args, kwargs)
        if sig is None or sig in seen:
            return fn(*args, **kwargs)
        seen[sig] = len(seen)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        dt = time.perf_counter() - t0
        t.inc("calls.new_signature", 1, fn=name)
        t.observe("calls.new_signature_s", dt, fn=name)
        t.event("new_signature", fn=name, signature=seen[sig],
                n_signatures=len(seen), seconds=round(dt, 6))
        return out

    wrapped.__name__ = f"instrumented[{name}]"
    wrapped.__wrapped__ = fn
    return wrapped


def record_device_memory(telemetry: Optional[Telemetry] = None) -> dict:
    """Snapshot each CUDA device's allocator statistics into gauges;
    returns {device index: stats}.  ``torch.device_mem_peak_bytes`` is a
    high-water gauge (the max over every snapshot in this process),
    ``torch.device_mem_bytes`` the bytes allocated now.  Without a CUDA
    device nothing is recorded."""
    t = telemetry or get_telemetry()
    out = {}
    if not torch.cuda.is_available():
        return out
    for d in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(d)
        if not stats:
            continue
        out[d] = stats
        t.gauge_max("torch.device_mem_peak_bytes",
                    stats.get("allocated_bytes.all.peak", 0), device=d)
        t.gauge_set("torch.device_mem_bytes",
                    stats.get("allocated_bytes.all.current", 0), device=d)
    return out


def trace_rounds(
    round_fn: Callable,
    state: Any,
    args: Tuple,
    rounds: int = 2,
    *,
    log_dir: Optional[str] = None,
    logger=None,
    telemetry: Optional[Telemetry] = None,
) -> Tuple[Any, list]:
    """Run ``rounds`` fully synced rounds inside a ``torch.profiler`` trace
    (``core.metrics.trace``; ``log_dir`` defaults to the logger's
    ``run_dir``).  Each round ends in ``utils/timing.sync_round``, so the
    trace spans the device work, not the enqueue.  The trace path and
    per-round seconds go into the metrics stream.  Returns
    ``(final_state, per_round_seconds)``."""
    from fedml_tpu_torch.core.metrics import trace
    from fedml_tpu_torch.utils.timing import sync_round

    t = telemetry or get_telemetry()
    times = []
    resolved = log_dir
    if resolved is None and logger is not None and logger.run_dir:
        resolved = os.path.join(logger.run_dir, "trace")
    with trace(resolved, logger=logger):
        for _ in range(rounds):
            t0 = time.perf_counter()
            state, metrics = round_fn(state, *args)
            sync_round(metrics)
            dt = time.perf_counter() - t0
            times.append(dt)
            t.observe("span.traced_round_s", dt)
    rec = {"trace_dir": resolved, "rounds": rounds,
           "round_s": [round(x, 6) for x in times]}
    if logger is not None:
        logger.log({"kind": "trace_rounds", **rec})
    else:
        t.event("trace_rounds", **rec)
    return state, times
