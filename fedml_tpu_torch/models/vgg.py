"""VGG-11/13/16/19, plain and BatchNorm (port of ``fedml_tpu/models/vgg.py``;
reference ``fedml_api/model/cv/vgg.py``).

torchvision-style config strings (cfgs A/B/D/E), 3x3 convs with a bias at
padding 1, 2x2 max pools, a 7x7 adaptive average pool and the
4096-4096 dropout head.  NHWC activations; the flatten before the head is
over (h, w, c), so flax's ``Dense_0`` kernel carries over unchanged.
Names are flax's auto-names, counted per class in call order:
``Conv_i``, ``BatchNorm_i``, ``Dense_0..2``, ``Dropout_0/1``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.base import Dense, Dropout, ModelBundle
from fedml_tpu_torch.models.cnn import max_pool_2x2
from fedml_tpu_torch.models.resnet import BatchNorm, Conv
from fedml_tpu_torch.utils.device import DeviceLike, resolve_device

# torchvision layer configs: reference vgg.py:73-78
CFGS = {
    "A": (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "B": (64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "D": (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
          512, 512, 512, "M"),
    "E": (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512,
          512, "M", 512, 512, 512, 512, "M"),
}


def adaptive_avg_pool(x: torch.Tensor, out_hw: int) -> torch.Tensor:
    """torch ``AdaptiveAvgPool2d`` over NHWC, the JAX function's bins: bin i
    covers ``[⌊i·H/out⌋, ⌈(i+1)·H/out⌉)``, overlapping where ``out`` does
    not divide H.  The pool runs on a contiguous NCHW copy (CUDA's
    ``avg_pool2d`` backward was wrong on a channels-last view in PyTorch
    2.11)."""
    if x.shape[1] == out_hw and x.shape[2] == out_hw:
        return x
    y = F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2).contiguous(), out_hw)
    return y.permute(0, 2, 3, 1)


class VGG(nn.Module):
    def __init__(self, cfg: Sequence[Union[int, str]], batch_norm: bool = False,
                 num_classes: int = 1000):
        super().__init__()
        self.cfg = tuple(cfg)
        self.batch_norm = batch_norm
        cin = 3
        for i, v in enumerate(c for c in self.cfg if c != "M"):
            self.add_module(f"Conv_{i}", Conv(cin, int(v), 3, padding=1, use_bias=True))
            if batch_norm:
                self.add_module(f"BatchNorm_{i}", BatchNorm(int(v)))
            cin = int(v)
        self.Dense_0 = Dense(7 * 7 * cin, 4096)
        self.Dropout_0 = Dropout(0.5)
        self.Dense_1 = Dense(4096, 4096)
        self.Dropout_1 = Dropout(0.5)
        self.Dense_2 = Dense(4096, num_classes)

    def forward(self, x, train: bool = False, updates: Optional[dict] = None,
                rng=None):
        updates = {} if updates is None else updates
        i = 0
        for v in self.cfg:
            if v == "M":
                x = max_pool_2x2(x)
                continue
            x = getattr(self, f"Conv_{i}")(x)
            if self.batch_norm:
                x = getattr(self, f"BatchNorm_{i}")(x, train, updates)
            x = torch.relu(x)
            i += 1
        x = adaptive_avg_pool(x, 7)
        x = x.reshape(x.shape[0], -1)
        x = self.Dropout_0(torch.relu(self.Dense_0(x)), train, rng)
        x = self.Dropout_1(torch.relu(self.Dense_1(x)), train, rng)
        return self.Dense_2(x)


def _bundle(cfg_key, batch_norm, num_classes, image_size,
            device: DeviceLike = None) -> ModelBundle:
    return ModelBundle(
        module=VGG(CFGS[cfg_key], batch_norm, num_classes),
        input_shape=(image_size, image_size, 3),
        device=resolve_device(device),
        needs_dropout_rng=True,
    )


def vgg11(num_classes=1000, image_size=224, device: DeviceLike = None):
    return _bundle("A", False, num_classes, image_size, device)


def vgg11_bn(num_classes=1000, image_size=224, device: DeviceLike = None):
    return _bundle("A", True, num_classes, image_size, device)


def vgg13(num_classes=1000, image_size=224, device: DeviceLike = None):
    return _bundle("B", False, num_classes, image_size, device)


def vgg13_bn(num_classes=1000, image_size=224, device: DeviceLike = None):
    return _bundle("B", True, num_classes, image_size, device)


def vgg16(num_classes=1000, image_size=224, device: DeviceLike = None):
    return _bundle("D", False, num_classes, image_size, device)


def vgg16_bn(num_classes=1000, image_size=224, device: DeviceLike = None):
    return _bundle("D", True, num_classes, image_size, device)


def vgg19(num_classes=1000, image_size=224, device: DeviceLike = None):
    return _bundle("E", False, num_classes, image_size, device)


def vgg19_bn(num_classes=1000, image_size=224, device: DeviceLike = None):
    return _bundle("E", True, num_classes, image_size, device)
