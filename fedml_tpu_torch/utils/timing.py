"""Round timing (port of ``fedml_tpu/utils/timing.py``), and the kernel
timing and H100 bounds that ``chip_smoke.py`` and the kernel sweeps share.

PyTorch returns before the device finishes, so every timed region ends
with ``torch.cuda.synchronize()`` AND a scalar read-back of the metrics
(which also surfaces a NaN).  Warm-up runs until two consecutive synced
rounds agree, so the first calls (kernel build, cuDNN autotuning,
allocator growth) stay out of the median.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Tuple

import numpy as np
import torch

from fedml_tpu_torch.core.tree import tree_leaves


def sync_round(metrics: Any) -> float:
    """Wait for the device and read every metric back; returns their sum,
    so a NaN/inf in any metric poisons the result."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return float(sum(float(leaf.sum()) for leaf in tree_leaves(metrics)))


def measure_rounds(
    round_fn: Callable,
    state: Any,
    args_dev: Tuple,
    rounds: int,
    *,
    max_warmup: int = 6,
    agree_rtol: float = 0.2,
) -> Tuple[float, Any]:
    """(median seconds per fully-synced call, final state)."""
    prev = None
    for i in range(max_warmup):
        t0 = time.perf_counter()
        state, m = round_fn(state, *args_dev)
        sync_round(m)
        dt = time.perf_counter() - t0
        if i >= 1 and prev is not None and abs(dt - prev) / max(dt, prev) < agree_rtol:
            break
        prev = dt
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        state, m = round_fn(state, *args_dev)
        scalar = sync_round(m)
        times.append(time.perf_counter() - t0)
        if not np.isfinite(scalar):
            raise FloatingPointError(
                f"benchmark round produced non-finite metrics: {scalar}")
    return float(np.median(times)), state


# One H100 SXM: HBM3 rate and dense peaks (bf16 tensor cores; fp32 CUDA cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}


def kernel_ms(fn: Callable, reps: int = 50) -> float:
    """Device time of one ``fn()``: warm up on a side stream, capture one
    call in a CUDA graph, replay it ``reps`` times between two CUDA events
    (so host launch overhead stays out)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def flash_bound_ms(b: int, lq: int, lk: int, h: int, d: int, dtype_name: str,
                   causal: bool) -> Tuple[float, float]:
    """(ms to move the bytes, ms to do the FLOPs) of one flash forward: q,
    k, v read once, o and the fp32 LSE written once; the two products over
    the score pairs the mask leaves visible, at the peak for the type.  The
    bound is the larger."""
    es = 2 if dtype_name == "bf16" else 4
    nbytes = (2 * b * lq * h * d + 2 * b * lk * h * d) * es + b * h * lq * 4
    pairs = lq * (lq + 1) // 2 if causal else lq * lk
    flops = 4.0 * b * h * d * pairs
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / PEAK_FLOPS[dtype_name]
