"""MobileNetV3, LARGE and SMALL (port of ``fedml_tpu/models/mobilenet_v3.py``;
reference ``fedml_api/model/cv/mobilenet_v3.py``).

Hard-sigmoid/hard-swish, a dense squeeze-excite, MobileBlock inverted
residuals and the LARGE/SMALL stage tables with a width multiplier
rounded by ``make_divisible``.  NHWC; the depthwise step is a grouped
library conv.  The stem and head convs carry a bias, the block convs do
not; the SMALL head squeezes before its BatchNorm.  Names are flax's:
``Conv_i``/``BatchNorm_i`` in call order, ``MobileBlock_j``, and
``SqueezeExcite_0`` with ``Dense_0``/``Dense_1``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.base import Dense, Dropout, ModelBundle
from fedml_tpu_torch.models.resnet import BatchNorm, Conv
from fedml_tpu_torch.utils.device import DeviceLike, resolve_device

# (in, out, kernel, stride, nonlinear, se, expansion) — mobilenet_v3.py:143-161
LARGE = (
    (16, 16, 3, 1, "RE", False, 16),
    (16, 24, 3, 2, "RE", False, 64),
    (24, 24, 3, 1, "RE", False, 72),
    (24, 40, 5, 2, "RE", True, 72),
    (40, 40, 5, 1, "RE", True, 120),
    (40, 40, 5, 1, "RE", True, 120),
    (40, 80, 3, 2, "HS", False, 240),
    (80, 80, 3, 1, "HS", False, 200),
    (80, 80, 3, 1, "HS", False, 184),
    (80, 80, 3, 1, "HS", False, 184),
    (80, 112, 3, 1, "HS", True, 480),
    (112, 112, 3, 1, "HS", True, 672),
    (112, 160, 5, 1, "HS", True, 672),
    (160, 160, 5, 2, "HS", True, 672),
    (160, 160, 5, 1, "HS", True, 960),
)
# mobilenet_v3.py:196-207
SMALL = (
    (16, 16, 3, 2, "RE", True, 16),
    (16, 24, 3, 2, "RE", False, 72),
    (24, 24, 3, 1, "RE", False, 88),
    (24, 40, 5, 2, "RE", True, 96),
    (40, 40, 5, 1, "RE", True, 240),
    (40, 40, 5, 1, "RE", True, 240),
    (40, 48, 5, 1, "HS", True, 120),
    (48, 48, 5, 1, "HS", True, 144),
    (48, 96, 5, 2, "HS", True, 288),
    (96, 96, 5, 1, "HS", True, 576),
    (96, 96, 5, 1, "HS", True, 576),
)


def make_divisible(v, divisor=8, min_value=None):
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def h_sigmoid(x):
    """``relu6(x + 3) / 6``, divided by a tensor: CUDA's division by a
    Python scalar multiplies by the reciprocal and changes bits."""
    return F.relu6(x + 3.0) / x.new_full((), 6.0)


def h_swish(x):
    return x * h_sigmoid(x)


class SqueezeExcite(nn.Module):
    """Dense SE block (reference SqueezeBlock)."""

    def __init__(self, ch: int, divide: int = 4):
        super().__init__()
        self.Dense_0 = Dense(ch, ch // divide)
        self.Dense_1 = Dense(ch // divide, ch)

    def forward(self, x):
        s = torch.relu(self.Dense_0(x.mean((1, 2))))
        s = h_sigmoid(self.Dense_1(s))
        return x * s[:, None, None, :]


class MobileBlock(nn.Module):
    def __init__(self, cin: int, out_ch: int, kernel: int, stride: int,
                 nonlinear: str, se: bool, exp_size: int):
        super().__init__()
        self.act = torch.relu if nonlinear == "RE" else h_swish
        self.residual = stride == 1 and cin == out_ch
        self.Conv_0 = Conv(cin, exp_size, 1)
        self.BatchNorm_0 = BatchNorm(exp_size)
        self.Conv_1 = Conv(exp_size, exp_size, kernel, stride, padding=kernel // 2,
                           groups=exp_size)
        self.BatchNorm_1 = BatchNorm(exp_size)
        self.SqueezeExcite_0 = SqueezeExcite(exp_size) if se else None
        self.Conv_2 = Conv(exp_size, out_ch, 1)
        self.BatchNorm_2 = BatchNorm(out_ch)

    def forward(self, x, train: bool, updates: dict):
        y = self.act(self.BatchNorm_0(self.Conv_0(x), train, updates))
        y = self.BatchNorm_1(self.Conv_1(y), train, updates)
        if self.SqueezeExcite_0 is not None:
            y = self.SqueezeExcite_0(y)
        y = self.act(y)
        y = self.act(self.BatchNorm_2(self.Conv_2(y), train, updates))
        return y + x if self.residual else y


class MobileNetV3(nn.Module):
    def __init__(self, model_mode: str = "LARGE", num_classes: int = 10,
                 multiplier: float = 1.0, dropout_rate: float = 0.0):
        super().__init__()
        m = multiplier
        stem = make_divisible(16 * m)
        self.Conv_0 = Conv(3, stem, 3, 2, padding=1, use_bias=True)
        self.BatchNorm_0 = BatchNorm(stem)
        self.blocks = []
        cin = stem
        for j, (_, out_ch, k, s, nl, se, exp) in enumerate(
                LARGE if model_mode == "LARGE" else SMALL):
            out_ch = make_divisible(out_ch * m)
            name = f"MobileBlock_{j}"
            self.add_module(name, MobileBlock(cin, out_ch, k, s, nl, se,
                                              make_divisible(exp * m)))
            self.blocks.append(name)
            cin = out_ch
        head = make_divisible((960 if model_mode == "LARGE" else 576) * m)
        self.Conv_1 = Conv(cin, head, 1, use_bias=True)
        # the reference SMALL head squeezes before its BN
        self.SqueezeExcite_0 = SqueezeExcite(head) if model_mode == "SMALL" else None
        self.BatchNorm_1 = BatchNorm(head)
        last = make_divisible(1280 * m)
        self.Conv_2 = Conv(head, last, 1, use_bias=True)
        self.Dropout_0 = Dropout(dropout_rate)
        self.Conv_3 = Conv(last, num_classes, 1, use_bias=True)

    def forward(self, x, train: bool = False, updates: Optional[dict] = None,
                rng=None):
        updates = {} if updates is None else updates
        x = h_swish(self.BatchNorm_0(self.Conv_0(x), train, updates))
        for name in self.blocks:
            x = getattr(self, name)(x, train, updates)
        x = self.Conv_1(x)
        if self.SqueezeExcite_0 is not None:
            x = self.SqueezeExcite_0(x)
        x = h_swish(self.BatchNorm_1(x, train, updates))
        x = h_swish(self.Conv_2(x.mean((1, 2), keepdim=True)))
        x = self.Conv_3(self.Dropout_0(x, train, rng))
        return x.reshape(x.shape[0], -1)


def mobilenet_v3(num_classes=10, model_mode="LARGE", multiplier=1.0,
                 image_size=224, dropout_rate=0.0,
                 device: DeviceLike = None) -> ModelBundle:
    """Reference factory."""
    return ModelBundle(
        module=MobileNetV3(model_mode, num_classes, multiplier, dropout_rate),
        input_shape=(image_size, image_size, 3),
        device=resolve_device(device),
        needs_dropout_rng=dropout_rate > 0,
    )
