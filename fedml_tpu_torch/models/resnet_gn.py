"""ImageNet-style ResNets with GroupNorm (port of
``fedml_tpu/models/resnet_gn.py``; reference
``fedml_api/model/cv/resnet_gn.py`` + ``group_normalization.py``).

GroupNorm replaces BatchNorm, so the model has no running statistics:
``resnet18_gn`` is the benchmark model for fed_CIFAR100.  Each norm layer
has ``max(1, C // 32)`` groups (the reference's 32 channels per group),
ε 1e-5.  NHWC activations, HWIO kernels, library convolutions
(``F.conv2d``) and state names equal to the flax paths
(``BasicBlockGN_3.GroupNorm_1.scale``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Type

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.base import Dense, ModelBundle, meta_param
from fedml_tpu_torch.models.resnet import Conv
from fedml_tpu_torch.utils.device import DeviceLike, resolve_device


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups, epsilon)`` over NHWC, in flax's
    arithmetic: per sample and group, statistics in at least float32
    with the fast variance ``max(0, E[x²] − E[x]²)`` (``F.group_norm``'s two-pass
    variance drifts from it), then ``(x − mean) · (rsqrt(var + ε) ·
    scale) + bias``, cast to the promoted dtype of (x, scale, bias)."""

    def __init__(self, channels: int, num_groups: int, epsilon: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.epsilon = epsilon
        self.scale = meta_param(channels)
        self.bias = meta_param(channels)

    def forward(self, x):
        g = self.num_groups
        grouped = (*x.shape[:-1], g, x.shape[-1] // g)
        xg = x.reshape(grouped)
        xf = xg.to(torch.promote_types(xg.dtype, torch.float32))
        axes = (*range(1, xf.ndim - 2), xf.ndim - 1)
        mean = xf.mean(axes, keepdim=True)
        mean2 = xf.square().mean(axes, keepdim=True)
        var = torch.clamp_min(mean2 - mean.square(), 0.0)
        mul = torch.rsqrt(var + self.epsilon) * self.scale.reshape(g, -1)
        y = (xg - mean) * mul + self.bias.reshape(g, -1)
        dtype = torch.promote_types(
            torch.promote_types(x.dtype, self.scale.dtype), self.bias.dtype)
        return y.reshape(x.shape).to(dtype)


def _gn(channels: int, channels_per_group: int = 32) -> GroupNorm:
    return GroupNorm(channels, max(1, channels // channels_per_group))


class BasicBlockGN(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, planes: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = Conv(in_ch, planes, 3, stride)
        self.GroupNorm_0 = _gn(planes)
        self.Conv_1 = Conv(planes, planes, 3)
        self.GroupNorm_1 = _gn(planes)
        # flax projects the identity when its shape differs from the output's
        self.shortcut = in_ch != planes or stride != 1
        if self.shortcut:
            self.Conv_2 = Conv(in_ch, planes, 1, stride)
            self.GroupNorm_2 = _gn(planes)

    def forward(self, x):
        y = torch.relu(self.GroupNorm_0(self.Conv_0(x)))
        y = self.GroupNorm_1(self.Conv_1(y))
        identity = self.GroupNorm_2(self.Conv_2(x)) if self.shortcut else x
        return torch.relu(y + identity)


class BottleneckGN(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, planes: int, stride: int = 1):
        super().__init__()
        out_ch = planes * self.expansion
        self.Conv_0 = Conv(in_ch, planes, 1)
        self.GroupNorm_0 = _gn(planes)
        self.Conv_1 = Conv(planes, planes, 3, stride)
        self.GroupNorm_1 = _gn(planes)
        self.Conv_2 = Conv(planes, out_ch, 1)
        self.GroupNorm_2 = _gn(out_ch)
        self.shortcut = in_ch != out_ch or stride != 1
        if self.shortcut:
            self.Conv_3 = Conv(in_ch, out_ch, 1, stride)
            self.GroupNorm_3 = _gn(out_ch)

    def forward(self, x):
        y = torch.relu(self.GroupNorm_0(self.Conv_0(x)))
        y = torch.relu(self.GroupNorm_1(self.Conv_1(y)))
        y = self.GroupNorm_2(self.Conv_2(y))
        identity = self.GroupNorm_3(self.Conv_3(x)) if self.shortcut else x
        return torch.relu(y + identity)


class ResNetGN(nn.Module):
    """Stem, four stages at 64/128/256/512 planes (stride 2 into stages
    2–4), global average pool, dense head.  ``small_input``: the 3×3
    stem of 32×32 federated images, no max-pool; otherwise the ImageNet
    stem (7×7 stride 2, 3×3 max-pool stride 2)."""

    def __init__(self, block: Type[nn.Module], layers: Sequence[int],
                 num_classes: int = 100, small_input: bool = True):
        super().__init__()
        self.small_input = small_input
        self.Conv_0 = Conv(3, 64, 3) if small_input else Conv(3, 64, 7, 2)
        self.GroupNorm_0 = _gn(64)
        self.blocks = []
        in_ch, j = 64, 0
        for stage, (planes, n_blocks) in enumerate(zip((64, 128, 256, 512), layers)):
            for i in range(n_blocks):
                stride = 2 if (stage > 0 and i == 0) else 1
                name = f"{block.__name__}_{j}"
                self.add_module(name, block(in_ch, planes, stride))
                self.blocks.append(name)
                in_ch, j = planes * block.expansion, j + 1
        self.Dense_0 = Dense(in_ch, num_classes)

    def forward(self, x, train: bool = False, updates: Optional[dict] = None):
        del train, updates
        x = torch.relu(self.GroupNorm_0(self.Conv_0(x)))
        if not self.small_input:
            x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, padding=1).permute(0, 2, 3, 1)
        for name in self.blocks:
            x = getattr(self, name)(x)
        return self.Dense_0(x.mean((1, 2)))


def _bundle(block, layers, num_classes, image_size=32, small_input=True,
            device: DeviceLike = None) -> ModelBundle:
    return ModelBundle(
        module=ResNetGN(block, layers, num_classes, small_input),
        input_shape=(image_size, image_size, 3),
        device=resolve_device(device),
    )


def resnet18_gn(num_classes=100, **kw):
    return _bundle(BasicBlockGN, (2, 2, 2, 2), num_classes, **kw)


def resnet34_gn(num_classes=100, **kw):
    return _bundle(BasicBlockGN, (3, 4, 6, 3), num_classes, **kw)


def resnet50_gn(num_classes=100, **kw):
    return _bundle(BottleneckGN, (3, 4, 6, 3), num_classes, **kw)


def resnet101_gn(num_classes=100, **kw):
    return _bundle(BottleneckGN, (3, 4, 23, 3), num_classes, **kw)


def resnet152_gn(num_classes=100, **kw):
    return _bundle(BottleneckGN, (3, 8, 36, 3), num_classes, **kw)
