"""The CIFAR ResNet with every 3x3 conv on the hand-written kernel.

Port of the ``conv_variant="pallas"`` path of
``fedml_tpu/models/resnet_tpu.py``; here the variant is called
``conv_variant="kernel"``.  Same variable tree and same function as
``models/resnet.CifarResNet`` (Bottleneck form): every 3x3 conv runs
through ``ops/conv_mxu.conv3x3`` (the implicit-GEMM CUDA kernel), 1x1
convs stay plain matrix products, and in train mode the 3x3 conv also
emits the per-channel moments of its output, so the BatchNorm after it
takes its batch statistics from the kernel instead of a second pass over
the activations.

The JAX module's other execution variants (``s2d_stages``
space-to-depth and ``pad_stage1_to`` lane padding) are tilings for the
TPU's 128-lane matrix unit; they raise ``ValueError`` here.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from fedml_tpu_torch.models.base import Dense, ModelBundle, meta_param
from fedml_tpu_torch.ops.conv_mxu import conv3x3, conv3x3_moments
from fedml_tpu_torch.utils.device import DeviceLike, resolve_device


class _XConv(nn.Module):
    """Conv with the baseline's parameter (``kernel`` HWIO).  3x3 → the
    kernel; with ``moments=True`` it returns ``(y, (sum, sumsq, count))``
    for the moment-fed BatchNorm.  1x1 → a matrix product (padding 0,
    so stride 2 reads every other pixel)."""

    def __init__(self, features: int, in_features: int, kernel: int,
                 stride: int = 1):
        super().__init__()
        self.stride = stride
        self.kernel = meta_param(kernel, kernel, in_features, features)

    def forward(self, x, moments: bool = False):
        w = self.kernel.to(x.dtype)
        s = self.stride
        if w.shape[0] == 3:
            if moments:
                y, total, sq = conv3x3_moments(x, w, s)
                count = float(x.shape[0] * (x.shape[1] // s) * (x.shape[2] // s))
                return y, (total, sq, count)
            return conv3x3(x, w, s)
        return torch.matmul(x[:, ::s, ::s, :], w[0, 0])


class _XBatchNorm(nn.Module):
    """BatchNorm with the baseline's parameters and statistics, in the
    JAX ``_XBatchNorm`` form: fast variance ``max(E[x²]−E[x]², 0)`` (from
    the kernel's moments when given: ``mean = sum/count``), running
    stats ``0.9·ra + 0.1·batch`` with the biased variance, and the
    affine ``x*mul + add`` applied in ``x.dtype``."""

    momentum = 0.9
    epsilon = 1e-5

    def __init__(self, c: int):
        super().__init__()
        self.scale = meta_param(c)
        self.bias = meta_param(c)
        self.register_buffer("mean", torch.empty(c, device="meta"))
        self.register_buffer("var", torch.empty(c, device="meta"))

    def forward(self, x, train: bool, updates: dict, moments=None):
        if train:
            if moments is not None:
                s, sq, count = moments
                mean, mean2 = s / count, sq / count
            else:
                xf = x.float()
                mean = xf.mean((0, 1, 2))
                mean2 = xf.square().mean((0, 1, 2))
            var = torch.clamp_min(mean2 - mean.square(), 0.0)
            m = self.momentum
            updates[self.state_prefix + "mean"] = m * self.mean + (1 - m) * mean
            updates[self.state_prefix + "var"] = m * self.var + (1 - m) * var
        else:
            mean, var = self.mean, self.var
        mul = self.scale * torch.rsqrt(var + self.epsilon)
        add = self.bias - mean * mul
        return x * mul.to(x.dtype) + add.to(x.dtype)


class BottleneckTPU(nn.Module):
    """Bottleneck whose 3x3 (``Conv_1``) runs on the kernel; names and
    shapes mirror ``resnet.Bottleneck`` exactly."""

    expansion = 4

    def __init__(self, in_ch: int, planes: int, stride: int = 1):
        super().__init__()
        out_ch = planes * self.expansion
        self.Conv_0 = _XConv(planes, in_ch, 1)
        self.BatchNorm_0 = _XBatchNorm(planes)
        self.Conv_1 = _XConv(planes, planes, 3, stride)
        self.BatchNorm_1 = _XBatchNorm(planes)
        self.Conv_2 = _XConv(out_ch, planes, 1)
        self.BatchNorm_2 = _XBatchNorm(out_ch)
        self.shortcut = in_ch != out_ch or stride != 1
        if self.shortcut:
            self.Conv_3 = _XConv(out_ch, in_ch, 1, stride)
            self.BatchNorm_3 = _XBatchNorm(out_ch)

    def forward(self, x, train: bool, updates: dict):
        y = torch.relu(self.BatchNorm_0(self.Conv_0(x), train, updates))
        # the 3x3 is the kernel's; in train mode it also emits the
        # moments the next BatchNorm consumes
        y = self.Conv_1(y, moments=train)
        y, mom = y if train else (y, None)
        y = torch.relu(self.BatchNorm_1(y, train, updates, moments=mom))
        y = self.BatchNorm_2(self.Conv_2(y), train, updates)
        identity = x
        if self.shortcut:
            identity = self.BatchNorm_3(self.Conv_3(x), train, updates)
        return torch.relu(y + identity)


class CifarResNetTPU(nn.Module):
    """``resnet.CifarResNet`` (Bottleneck form) with kernel convs:
    identical variable tree, identical function."""

    def __init__(self, layers: Sequence[int], num_classes: int = 10,
                 s2d_stages: int = 0, pad_stage1_to: int = 0,
                 conv_variant: str = "kernel"):
        super().__init__()
        if s2d_stages or pad_stage1_to:
            raise ValueError(
                "s2d_stages/pad_stage1_to are TPU lane tilings and are not "
                "ported; the kernel runs normal-space NHWC")
        if conv_variant != "kernel":
            raise ValueError(
                f"conv_variant must be 'kernel', got {conv_variant!r} (the "
                "library-conv baseline is models.resnet.CifarResNet)")
        self.Conv_0 = _XConv(16, 3, 3, 1)
        self.BatchNorm_0 = _XBatchNorm(16)
        self.blocks = []
        in_ch, j = 16, 0
        for stage, (planes, n_blocks) in enumerate(zip((16, 32, 64), layers)):
            for i in range(n_blocks):
                stride = 2 if (stage > 0 and i == 0) else 1
                name = f"Bottleneck_{j}"
                self.add_module(name, BottleneckTPU(in_ch, planes, stride))
                self.blocks.append(name)
                in_ch, j = planes * 4, j + 1
        self.Dense_0 = Dense(in_ch, num_classes)

    def forward(self, x, train: bool = False, updates: Optional[dict] = None):
        updates = {} if updates is None else updates
        x = self.Conv_0(x, moments=train)
        x, mom = x if train else (x, None)
        x = torch.relu(self.BatchNorm_0(x, train, updates, moments=mom))
        for name in self.blocks:
            x = getattr(self, name)(x, train, updates)
        return self.Dense_0(x.mean((1, 2)))


def resnet56_tpu(num_classes: int = 10, image_size: int = 32,
                 s2d_stages: int = 0, pad_stage1_to: int = 0,
                 conv_variant: str = "kernel",
                 device: DeviceLike = None) -> ModelBundle:
    """ResNet-56 (Bottleneck [6,6,6]) with all 19 of its 3x3 convs on the
    implicit-GEMM kernel and moment-fed train-mode BatchNorm."""
    return ModelBundle(
        module=CifarResNetTPU((6, 6, 6), num_classes, s2d_stages,
                              pad_stage1_to, conv_variant),
        input_shape=(image_size, image_size, 3),
        device=resolve_device(device),
    )
