"""One call under ``torch.profiler``, reduced to what the per-layer
metrics read: the device's busy time (the union of every device
activity's interval), kernel time and launches by name, and the idle gaps
by the host's CUDA call beneath them.

The profiler records device activity and the host's CUDA runtime calls
only: recording every host operator as well slows a host-bound round by a
further quarter (ResNet-56 at batch 1024 on an H100: 17.2 s a round with
CUDA activity alone, 21.4 s with host operators, 11.5 s unprofiled) and
triples the time to read the events.  A gap under no CUDA call is host
time in Python and the framework."""

from __future__ import annotations

import heapq
import time
from typing import Callable, Dict, List, Tuple

import torch


class Trace:
    """What one profiled call left: ``window_s`` (host clock around the
    synced call), ``busy_s``, ``kernels`` {name: [seconds, launches]} (memory
    copies and sets left out) and ``idle_by_host`` {host call: idle
    seconds}."""

    def __init__(self, window_s: float, busy_s: float, kernels: Dict[str, list],
                 idle_by_host: Dict[str, float]):
        self.window_s = window_s
        self.busy_s = busy_s
        self.kernels = kernels
        self.idle_by_host = idle_by_host

    def kernel_time(self, *parts: str) -> Tuple[float, int]:
        """Seconds and launches of the kernels whose name holds any of ``parts``."""
        secs, n = 0.0, 0
        for name, (s, c) in self.kernels.items():
            if any(p in name for p in parts):
                secs += s
                n += c
        return secs, n

    def launches(self) -> int:
        return sum(c for _, c in self.kernels.values())

    def top_ops(self, k: int = 10) -> List[list]:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:k]
        return [[name, s] for name, (s, _) in ops]

    def top_gaps(self, k: int = 10) -> List[list]:
        return [[n, s] for n, s in sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:k]]


def profile_call(fn: Callable[[], object]) -> Tuple[object, Trace]:
    """Run ``fn()`` under the profiler (device activity and CUDA calls),
    with a device synchronisation before and after, and reduce the events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    return out, reduce_events(prof.profiler.kineto_results.events(), window_s)


def _union(intervals):
    """Merged, sorted intervals of ``[(start, end)]``."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def reduce_events(events, window_s: float) -> Trace:
    """Reduce kineto events (``start_ns``/``duration_ns``/``name``/
    ``device_type``) to a ``Trace``."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    kernels: Dict[str, list] = {}
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == cuda:
            name = e.name()
            dev.append((s, s + d))
            if not name.startswith(("Memcpy", "Memset")):
                k = kernels.setdefault(name, [0.0, 0])
                k[0] += d * 1e-9
                k[1] += 1
        elif d > 0:
            host.append((s, s + d, e.name()))
    busy = _union(dev)
    busy_ns = sum(e - s for s, e in busy)
    # each gap between device activity is named by the innermost host call
    # (the latest-starting one) still running at its midpoint: a sweep over
    # the gaps in time order with a heap of the host calls begun so far
    host.sort()
    idle: Dict[str, float] = {}
    heap: list = []
    j = 0
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = (a + b) // 2
        while j < len(host) and host[j][0] <= mid:
            heapq.heappush(heap, (-host[j][0], host[j][1], host[j][2]))
            j += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        name = heap[0][2] if heap else "(host outside CUDA calls)"
        idle[name] = idle.get(name, 0.0) + (b - a) * 1e-9
    return Trace(window_s, busy_ns * 1e-9, kernels, idle)
