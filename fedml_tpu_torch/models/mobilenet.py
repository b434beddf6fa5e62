"""MobileNet-v1 with a width multiplier (port of
``fedml_tpu/models/mobilenet.py``; reference
``fedml_api/model/cv/mobilenet.py``).

Stem 3x3 conv(32α) + BN + ReLU and a depthwise-separable block (64α),
then four downsampling stages 128α/256α/512α(x6)/1024α, global average
pool, linear head.  Every conv has no bias and padding 1; the depthwise
3x3 is a grouped conv (``groups = C``, kernel ``[3, 3, 1, C]``), a
library conv as XLA's is in the JAX package.  Names: ``ConvBN_0`` and
``DepthwiseSeparable_0..12``, each with its own ``Conv_i``/``BatchNorm_i``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from fedml_tpu_torch.models.base import Dense, ModelBundle
from fedml_tpu_torch.models.resnet import BatchNorm, Conv
from fedml_tpu_torch.utils.device import DeviceLike, resolve_device


class ConvBN(nn.Module):
    def __init__(self, cin: int, features: int, kernel: int = 3, stride: int = 1):
        super().__init__()
        self.Conv_0 = Conv(cin, features, kernel, stride, padding=1)
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x, train: bool, updates: dict):
        return torch.relu(self.BatchNorm_0(self.Conv_0(x), train, updates))


class DepthwiseSeparable(nn.Module):
    """Depthwise 3x3 + BN + ReLU, pointwise 1x1 + BN + ReLU."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = Conv(cin, cin, 3, stride, padding=1, groups=cin)
        self.BatchNorm_0 = BatchNorm(cin)
        self.Conv_1 = Conv(cin, features, 1)
        self.BatchNorm_1 = BatchNorm(features)

    def forward(self, x, train: bool, updates: dict):
        x = torch.relu(self.BatchNorm_0(self.Conv_0(x), train, updates))
        return torch.relu(self.BatchNorm_1(self.Conv_1(x), train, updates))


class MobileNet(nn.Module):
    def __init__(self, width_multiplier: float = 1.0, num_classes: int = 100):
        super().__init__()

        def c(ch):
            return int(ch * width_multiplier)

        self.ConvBN_0 = ConvBN(3, c(32))
        plan = [(c(64), 1)] + [(c(planes), 2 if i == 0 else 1)
                               for planes, blocks in ((128, 2), (256, 2), (512, 6), (1024, 2))
                               for i in range(blocks)]
        cin = c(32)
        self.blocks = []
        for j, (features, stride) in enumerate(plan):
            name = f"DepthwiseSeparable_{j}"
            self.add_module(name, DepthwiseSeparable(cin, features, stride))
            self.blocks.append(name)
            cin = features
        self.Dense_0 = Dense(cin, num_classes)

    def forward(self, x, train: bool = False, updates: Optional[dict] = None):
        updates = {} if updates is None else updates
        x = self.ConvBN_0(x, train, updates)
        for name in self.blocks:
            x = getattr(self, name)(x, train, updates)
        return self.Dense_0(x.mean((1, 2)))


def mobilenet(num_classes=100, width_multiplier=1.0, image_size=32,
              device: DeviceLike = None) -> ModelBundle:
    """Reference factory ``mobilenet(class_num=...)``."""
    return ModelBundle(
        module=MobileNet(width_multiplier, num_classes),
        input_shape=(image_size, image_size, 3),
        device=resolve_device(device),
    )
