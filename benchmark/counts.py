"""The yardstick's arithmetic: one H100's published peaks and the least
time a kernel call could take.

Peaks are NVIDIA's data sheet for the H100 SXM at its full 700 W: dense
bf16 989 TFLOP/s, float32 outside the tensor cores 67 TFLOP/s, HBM3
3.35 TB/s.  A bound counts each input byte read once and each output byte
written once; the least time is the larger of bytes over the HBM rate and
FLOPs over the peak for the type."""

from __future__ import annotations

from typing import Tuple

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}


def _bytes_per(dtype_name: str) -> int:
    return 2 if dtype_name == "bf16" else 4


def conv_bound_ms(n: int, hw: int, ci: int, co: int, stride: int, dtype_name: str,
                  moments: bool, epilogue: bool) -> Tuple[float, float]:
    """(ms to move the bytes, ms to do the FLOPs) of one implicit-GEMM 3x3
    conv with padding 1: the ``[n, hw, hw, ci]`` input and ``[3, 3, ci, co]``
    weights read, the ``[n, hw/s, hw/s, co]`` output written, plus the fp32
    per-channel moments (``sum``, ``sumsq``) or epilogue vectors where
    present; ``2·n·ho²·9·ci·co`` FLOPs."""
    es = _bytes_per(dtype_name)
    ho = hw // stride
    nbytes = (n * hw * hw * ci + 9 * ci * co + n * ho * ho * co) * es
    if moments:
        nbytes += 2 * co * 4
    if epilogue:
        nbytes += 2 * co * 4
    flops = 2.0 * n * ho * ho * 9 * ci * co
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / PEAK_FLOPS[dtype_name]


def flash_bound_ms(b: int, lq: int, lk: int, h: int, d: int, dtype_name: str,
                   causal: bool) -> Tuple[float, float]:
    """(ms to move the bytes, ms to do the FLOPs) of one flash-attention
    forward over ``[b, L, h, d]``: q, k, v read once, o and the fp32
    log-sum-exp written once; the two products over the score pairs the
    mask leaves visible (``lq(lq+1)/2`` under ``causal``)."""
    es = _bytes_per(dtype_name)
    nbytes = (2 * b * lq * h * d + 2 * b * lk * h * d) * es + b * h * lq * 4
    pairs = lq * (lq + 1) // 2 if causal else lq * lk
    flops = 4.0 * b * h * d * pairs
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / PEAK_FLOPS[dtype_name]
