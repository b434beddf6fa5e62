"""Round timing (port of ``fedml_tpu/utils/timing.py``).

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
