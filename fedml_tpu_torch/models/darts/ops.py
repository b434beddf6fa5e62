"""DARTS primitive operations (port of ``fedml_tpu/models/darts/ops.py``).

Reference ``fedml_api/model/cv/darts/operations.py``: the 8-primitive OPS
table, ReLUConvBN, SepConv, DilConv, Zero and FactorizedReduce.  NHWC
activations and flax's module and parameter names; the depthwise steps
are grouped convolutions (``groups`` = channels) with symmetric integer
padding.  Search-stage BatchNorms are affine-free (``affine=False``: flax's
``use_scale=use_bias=False``), with the port's flax-exact BatchNorm (biased
batch variance in the running average).

Unlike flax, a torch module is built before it sees its input, so every
op takes its channel counts; submodules are named by class and per-class
counter in creation order (``Namer``), as flax's compact modules name
them.  A forward walks its submodules through plain lists, so each is
registered once, under its flax name.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.resnet import BatchNorm, Conv

PRIMITIVES = (
    "none",
    "max_pool_3x3",
    "avg_pool_3x3",
    "skip_connect",
    "sep_conv_3x3",
    "sep_conv_5x5",
    "dil_conv_3x3",
    "dil_conv_5x5",
)


class Namer:
    """Registers submodules on ``owner`` under flax's auto-names:
    ``<ClassName>_<n>``, counted per class in creation order."""

    def __init__(self, owner: nn.Module):
        self.owner, self.counts = owner, {}

    def __call__(self, module: nn.Module) -> nn.Module:
        cls = type(module).__name__
        n = self.counts.get(cls, 0)
        self.counts[cls] = n + 1
        setattr(self.owner, f"{cls}_{n}", module)
        return module


class ReLUConvBN(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int = 1, stride: int = 1,
                 affine: bool = True):
        super().__init__()
        self.Conv_0 = Conv(cin, cout, kernel, stride, padding=kernel // 2)
        self.BatchNorm_0 = BatchNorm(cout, affine)

    def forward(self, x, train: bool, updates: dict):
        return self.BatchNorm_0(self.Conv_0(torch.relu(x)), train, updates)


class SepConv(nn.Module):
    """Twice: ReLU → depthwise k×k (the first at ``stride``) → 1×1 → BN;
    the first 1×1 keeps ``cin``, the second maps to ``cout``."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int, affine: bool = True):
        super().__init__()
        pad = kernel // 2
        self.Conv_0 = Conv(cin, cin, kernel, stride, pad, groups=cin)
        self.Conv_1 = Conv(cin, cin, 1)
        self.BatchNorm_0 = BatchNorm(cin, affine)
        self.Conv_2 = Conv(cin, cin, kernel, 1, pad, groups=cin)
        self.Conv_3 = Conv(cin, cout, 1)
        self.BatchNorm_1 = BatchNorm(cout, affine)

    def forward(self, x, train: bool, updates: dict):
        x = self.BatchNorm_0(self.Conv_1(self.Conv_0(torch.relu(x))), train, updates)
        return self.BatchNorm_1(self.Conv_3(self.Conv_2(torch.relu(x))), train, updates)


class DilConv(nn.Module):
    """ReLU → depthwise k×k dilated → 1×1 → BN."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int, dilation: int = 2,
                 affine: bool = True):
        super().__init__()
        self.Conv_0 = Conv(cin, cin, kernel, stride, (kernel - 1) * dilation // 2,
                           groups=cin, dilation=dilation)
        self.Conv_1 = Conv(cin, cout, 1)
        self.BatchNorm_0 = BatchNorm(cout, affine)

    def forward(self, x, train: bool, updates: dict):
        return self.BatchNorm_0(self.Conv_1(self.Conv_0(torch.relu(x))), train, updates)


class FactorizedReduce(nn.Module):
    """Two stride-2 1×1 convs, on ``x`` and on ``x[:, 1:, 1:]`` (flax's SAME
    pads a 1×1 kernel by nothing), concatenated, then BN."""

    def __init__(self, cin: int, cout: int, affine: bool = True):
        super().__init__()
        self.Conv_0 = Conv(cin, cout // 2, 1, 2)
        self.Conv_1 = Conv(cin, cout - cout // 2, 1, 2)
        self.BatchNorm_0 = BatchNorm(cout, affine)

    def forward(self, x, train: bool, updates: dict):
        x = torch.relu(x)
        out = torch.cat([self.Conv_0(x), self.Conv_1(x[:, 1:, 1:, :])], dim=-1)
        return self.BatchNorm_0(out, train, updates)


class Pool(nn.Module):
    """3×3 pooling with padding 1: max pads with −inf, avg counts only the
    real elements (torch's ``count_include_pad=False``).

    The avg pool runs on a contiguous NCHW copy: on a CUDA tensor whose
    memory is channels-last (the NHWC activation seen as NCHW),
    ``avg_pool2d``'s backward returned gradients as far from the CPU's as
    the gradients are large (PyTorch 2.11), while the contiguous path
    agrees with the CPU (``tests/test_torch_darts_gpu.py``)."""

    def __init__(self, kind: str, stride: int):
        super().__init__()
        self.kind, self.stride = kind, stride

    def forward(self, x, train: bool, updates: dict):
        del train, updates
        x = x.permute(0, 3, 1, 2)
        if self.kind == "max":
            y = F.max_pool2d(x, 3, self.stride, 1)
        else:
            y = F.avg_pool2d(x.contiguous(), 3, self.stride, 1, count_include_pad=False)
        return y.permute(0, 2, 3, 1)


class Zero(nn.Module):
    """Zeros of the op's output shape (the stride's, on a reduction edge)."""

    def __init__(self, stride: int):
        super().__init__()
        self.stride = stride

    def forward(self, x, train: bool, updates: dict):
        del train, updates
        if self.stride == 1:
            return torch.zeros_like(x)
        return torch.zeros_like(x[:, ::self.stride, ::self.stride, :])


class SkipConnect(nn.Module):
    """The identity, or at stride 2 a ``FactorizedReduce``."""

    def __init__(self, cin: int, cout: int, stride: int, affine: bool = True):
        super().__init__()
        self.stride = stride
        if stride != 1:
            self.FactorizedReduce_0 = FactorizedReduce(cin, cout, affine)

    def forward(self, x, train: bool, updates: dict):
        if self.stride == 1:
            return x
        return self.FactorizedReduce_0(x, train, updates)


# primitive name -> module factory(C, stride, affine) over C channels
# (operations.py:4-21)
OPS: Dict[str, Callable[[int, int, bool], nn.Module]] = {
    "none": lambda C, stride, affine: Zero(stride),
    "max_pool_3x3": lambda C, stride, affine: Pool("max", stride),
    "avg_pool_3x3": lambda C, stride, affine: Pool("avg", stride),
    "skip_connect": lambda C, stride, affine: SkipConnect(C, C, stride, affine),
    "sep_conv_3x3": lambda C, stride, affine: SepConv(C, C, 3, stride, affine),
    "sep_conv_5x5": lambda C, stride, affine: SepConv(C, C, 5, stride, affine),
    "dil_conv_3x3": lambda C, stride, affine: DilConv(C, C, 3, stride, 2, affine),
    "dil_conv_5x5": lambda C, stride, affine: DilConv(C, C, 5, stride, 2, affine),
}
