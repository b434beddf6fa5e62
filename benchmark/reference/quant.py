"""Operand rounding for the reference's control runs.

``fp8`` computes in FP8 where the program computes in bf16: every tensor
the program holds in bf16 (the operands of its convolutions and products,
their outputs, the activations between them) is rounded to float8 e4m3
in the forward, and the gradient that reaches it to float8 e5m2 in the
backward (FP8 training's formats, Micikevicius et al. 2022,
arXiv:2209.05433), each under a per-tensor scale that puts its largest
magnitude on the format's largest (448 and 57344).  Products and
statistics run in float32 on the rounded values, as the program's run in
fp32 on bf16 ones."""

from __future__ import annotations

from typing import Callable, Optional

import torch

_FORMATS = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def _round(t: torch.Tensor, fmt: torch.dtype) -> torch.Tensor:
    amax = t.abs().amax().clamp_min(1e-30)
    scale = _FORMATS[fmt] / amax
    return (t * scale).to(fmt).to(t.dtype) / scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2)


def fp8(t: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(t)


def operand_rounding(precision: str) -> Optional[Callable]:
    """``None`` for float32, else the rounding applied to every operand."""
    if precision == "fp32":
        return None
    if precision == "fp8":
        return fp8
    raise ValueError(f"unknown reference precision {precision!r}")
