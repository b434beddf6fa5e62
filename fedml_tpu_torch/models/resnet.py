"""CIFAR ResNets with BatchNorm (port of ``fedml_tpu/models/resnet.py``).

3x3/16 CIFAR stem, three stages at 16/32/64 planes with stride-2
transitions, global average pool, linear head; Bottleneck [6,6,6] /
[12,12,12] for resnet56/resnet110, BasicBlock for resnet20/32/44.

This is the plain baseline: its convolutions are the library's
(``F.conv2d``), the role XLA's convolution plays in the JAX package.
Layouts and names are the flax module's: NHWC activations, HWIO conv
kernels, ``[in, out]`` dense kernels, and state names equal to the flax
paths (``Bottleneck_3.Conv_1.kernel``, ``BatchNorm_0.mean``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Type, Union

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.base import Dense, ModelBundle, meta_param
from fedml_tpu_torch.utils.device import DeviceLike, resolve_device


def same_pads(size: int, k: int, stride: int, dilation: int = 1):
    """flax's (lax's) ``padding="SAME"`` along one axis: the output is
    ``ceil(size / stride)`` long and the padding it needs is split with
    the odd element at the end, ``(pad // 2, pad − pad // 2)``; at stride
    2 that is (0, 1) for k 3 and (1, 2) for k 5 at an even size."""
    window = (k - 1) * dilation + 1
    out = -(-size // stride)
    pad = max((out - 1) * stride + window - size, 0)
    return pad // 2, pad - pad // 2


class Conv(nn.Module):
    """flax ``nn.Conv``: NHWC input, HWIO ``kernel``, symmetric padding
    ``padding`` (default ``k // 2``: flax's ``SAME`` at stride 1, and the
    explicit ``k // 2`` of the ResNets at stride 2) or flax's
    ``padding="SAME"`` (``same_pads``, asymmetric where the stride leaves
    an odd remainder), a ``bias`` with ``use_bias``; ``groups`` is flax's
    ``feature_group_count`` (the kernel is ``[k, k, cin // groups,
    cout]``) and ``dilation`` its ``kernel_dilation``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: Union[int, str, None] = None, use_bias: bool = False,
                 groups: int = 1, dilation: int = 1):
        super().__init__()
        self.k = k
        self.stride = stride
        self.padding = k // 2 if padding is None else padding
        self.groups = groups
        self.dilation = dilation
        self.kernel = meta_param(k, k, cin // groups, cout)
        self.bias = meta_param(cout) if use_bias else None

    def forward(self, x):
        w = self.kernel.to(x.dtype).permute(3, 2, 0, 1)
        b = None if self.bias is None else self.bias.to(x.dtype)
        x = x.permute(0, 3, 1, 2)
        padding = self.padding
        if padding == "SAME":
            (top, bottom), (left, right) = (
                same_pads(n, self.k, self.stride, self.dilation) for n in x.shape[2:])
            if top == bottom and left == right:
                padding = (top, left)
            else:
                x, padding = F.pad(x, (left, right, top, bottom)), 0
        y = F.conv2d(x, w, b, stride=self.stride, padding=padding,
                     dilation=self.dilation, groups=self.groups)
        return y.permute(0, 2, 3, 1)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum, epsilon)`` over NHWC (the ResNets'
    0.9 and 1e-5 by default; EfficientNet's 0.99 and 1e-3).

    Train mode: statistics in at least fp32 (float64 stays float64, as in
    flax) with the fast variance ``max(E[x²] - E[x]², 0)``; running stats
    become ``m·ra + (1 − m)·batch`` with the BIASED variance and are
    written to ``updates``.  The normalization runs in the statistics'
    dtype and is cast to the promoted dtype of (x, scale, bias), as flax's
    ``_normalize`` does.
    ``affine=False`` is flax's ``use_scale=use_bias=False``: no
    parameters, only the statistics."""

    def __init__(self, c: int, affine: bool = True, momentum: float = 0.9,
                 epsilon: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.scale = meta_param(c) if affine else None
        self.bias = meta_param(c) if affine else None
        self.register_buffer("mean", torch.empty(c, device="meta"))
        self.register_buffer("var", torch.empty(c, device="meta"))

    def forward(self, x, train: bool, updates: dict):
        if train:
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            mean = xf.mean((0, 1, 2))
            mean2 = xf.square().mean((0, 1, 2))
            var = torch.clamp_min(mean2 - mean.square(), 0.0)
            m = self.momentum
            updates[self.state_prefix + "mean"] = m * self.mean + (1 - m) * mean
            updates[self.state_prefix + "var"] = m * self.var + (1 - m) * var
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon)
        if self.scale is None:
            return ((x - mean) * mul).to(x.dtype)
        y = (x - mean) * (mul * self.scale) + self.bias
        dtype = torch.promote_types(
            torch.promote_types(x.dtype, self.scale.dtype), self.bias.dtype)
        return y.to(dtype)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, planes: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = Conv(in_ch, planes, 3, stride)
        self.BatchNorm_0 = BatchNorm(planes)
        self.Conv_1 = Conv(planes, planes, 3)
        self.BatchNorm_1 = BatchNorm(planes)
        self.shortcut = in_ch != planes or stride != 1
        if self.shortcut:
            self.Conv_2 = Conv(in_ch, planes, 1, stride)
            self.BatchNorm_2 = BatchNorm(planes)

    def forward(self, x, train: bool, updates: dict):
        y = torch.relu(self.BatchNorm_0(self.Conv_0(x), train, updates))
        y = self.BatchNorm_1(self.Conv_1(y), train, updates)
        identity = x
        if self.shortcut:
            identity = self.BatchNorm_2(self.Conv_2(x), train, updates)
        return torch.relu(y + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, planes: int, stride: int = 1):
        super().__init__()
        out_ch = planes * self.expansion
        self.Conv_0 = Conv(in_ch, planes, 1)
        self.BatchNorm_0 = BatchNorm(planes)
        self.Conv_1 = Conv(planes, planes, 3, stride)
        self.BatchNorm_1 = BatchNorm(planes)
        self.Conv_2 = Conv(planes, out_ch, 1)
        self.BatchNorm_2 = BatchNorm(out_ch)
        self.shortcut = in_ch != out_ch or stride != 1
        if self.shortcut:
            self.Conv_3 = Conv(in_ch, out_ch, 1, stride)
            self.BatchNorm_3 = BatchNorm(out_ch)

    def forward(self, x, train: bool, updates: dict):
        y = torch.relu(self.BatchNorm_0(self.Conv_0(x), train, updates))
        y = torch.relu(self.BatchNorm_1(self.Conv_1(y), train, updates))
        y = self.BatchNorm_2(self.Conv_2(y), train, updates)
        identity = x
        if self.shortcut:
            identity = self.BatchNorm_3(self.Conv_3(x), train, updates)
        return torch.relu(y + identity)


class CifarResNet(nn.Module):
    def __init__(self, block: Type[nn.Module], layers: Sequence[int],
                 num_classes: int = 10):
        super().__init__()
        self.Conv_0 = Conv(3, 16, 3)
        self.BatchNorm_0 = BatchNorm(16)
        self.blocks = []
        in_ch, j = 16, 0
        for stage, (planes, n_blocks) in enumerate(zip((16, 32, 64), layers)):
            for i in range(n_blocks):
                stride = 2 if (stage > 0 and i == 0) else 1
                name = f"{block.__name__}_{j}"
                self.add_module(name, block(in_ch, planes, stride))
                self.blocks.append(name)
                in_ch, j = planes * block.expansion, j + 1
        self.Dense_0 = Dense(in_ch, num_classes)

    def forward(self, x, train: bool = False, updates: Optional[dict] = None):
        updates = {} if updates is None else updates
        x = torch.relu(self.BatchNorm_0(self.Conv_0(x), train, updates))
        for name in self.blocks:
            x = getattr(self, name)(x, train, updates)
        return self.Dense_0(x.mean((1, 2)))


def _bundle(block, layers, num_classes, image_size=32,
            device: DeviceLike = None) -> ModelBundle:
    return ModelBundle(
        module=CifarResNet(block, layers, num_classes),
        input_shape=(image_size, image_size, 3),
        device=resolve_device(device),
    )


def resnet20(num_classes=10, **kw):
    return _bundle(BasicBlock, (3, 3, 3), num_classes, **kw)


def resnet32(num_classes=10, **kw):
    return _bundle(BasicBlock, (5, 5, 5), num_classes, **kw)


def resnet44(num_classes=10, **kw):
    return _bundle(BasicBlock, (7, 7, 7), num_classes, **kw)


def resnet56(num_classes=10, **kw):
    """Reference factory: ResNet(Bottleneck, [6,6,6])."""
    return _bundle(Bottleneck, (6, 6, 6), num_classes, **kw)


def resnet110(num_classes=10, **kw):
    """Reference factory: ResNet(Bottleneck, [12,12,12])."""
    return _bundle(Bottleneck, (12, 12, 12), num_classes, **kw)
