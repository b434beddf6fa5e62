"""EfficientNet-B0..B8 (port of ``fedml_tpu/models/efficientnet.py``;
reference ``fedml_api/model/cv/efficientnet.py`` and its utils).

Swish activations, MBConv blocks with a 1x1-conv squeeze-excite,
drop-connect that scales linearly with block depth, stem 32 → head 1280,
the compound-scaling table b0–b8.  The stem and every depthwise conv pad
as flax's ``padding="SAME"`` (asymmetric at stride 2); BatchNorm runs at
momentum 0.99 and epsilon 1e-3.  Names are flax's: inside an
``MBConvBlock_k`` that expands, ``Conv_0`` expand, ``Conv_1`` depthwise,
``Conv_2``/``Conv_3`` squeeze-excite, ``Conv_4`` project; without the
expansion every index shifts down by one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.core import rng as rnglib
from fedml_tpu_torch.models.base import Dense, Dropout, ModelBundle, fold_in_static
from fedml_tpu_torch.models.mobilenet_v3 import make_divisible
from fedml_tpu_torch.models.resnet import BatchNorm, Conv
from fedml_tpu_torch.utils.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class BlockArgs:
    num_repeat: int
    kernel_size: int
    stride: int
    expand_ratio: int
    input_filters: int
    output_filters: int
    se_ratio: float = 0.25


# decoded form of the reference's default block strings
# (efficientnet_utils.py:469-478)
DEFAULT_BLOCKS = (
    BlockArgs(1, 3, 1, 1, 32, 16),
    BlockArgs(2, 3, 2, 6, 16, 24),
    BlockArgs(2, 5, 2, 6, 24, 40),
    BlockArgs(3, 3, 2, 6, 40, 80),
    BlockArgs(3, 5, 1, 6, 80, 112),
    BlockArgs(4, 5, 2, 6, 112, 192),
    BlockArgs(1, 3, 1, 6, 192, 320),
)

# name -> (width_coeff, depth_coeff, resolution, dropout)
# (efficientnet_utils.py:437-448)
PARAMS = {
    "efficientnet-b0": (1.0, 1.0, 224, 0.2),
    "efficientnet-b1": (1.0, 1.1, 240, 0.2),
    "efficientnet-b2": (1.1, 1.2, 260, 0.3),
    "efficientnet-b3": (1.2, 1.4, 300, 0.3),
    "efficientnet-b4": (1.4, 1.8, 380, 0.4),
    "efficientnet-b5": (1.6, 2.2, 456, 0.4),
    "efficientnet-b6": (1.8, 2.6, 528, 0.5),
    "efficientnet-b7": (2.0, 3.1, 600, 0.5),
    "efficientnet-b8": (2.2, 3.6, 672, 0.5),
}
# reference: bn momentum 0.99, eps 1e-3 (efficientnet_utils.py global params)
BN_MOMENTUM, BN_EPSILON = 0.99, 1e-3


def round_filters(filters: int, width_coeff: float, divisor: int = 8) -> int:
    """The same divisor rounding as MobileNetV3's ``make_divisible``."""
    return make_divisible(filters * width_coeff, divisor)


def round_repeats(repeats: int, depth_coeff: float) -> int:
    return int(math.ceil(depth_coeff * repeats))


def _bn(c: int) -> BatchNorm:
    return BatchNorm(c, momentum=BN_MOMENTUM, epsilon=BN_EPSILON)


def drop_connect(x, rate: float, train: bool, key):
    """Per-sample stochastic depth: ``x * mask / (1 − rate)`` with ``mask =
    bernoulli(key, 1 − rate, (N, 1, 1, 1))``, the keep probability held in
    a tensor (CUDA's division by a Python scalar multiplies by the
    reciprocal).  Off in eval mode, at rate 0 and with no key."""
    if not train or rate == 0.0 or key is None:
        return x
    keep = 1.0 - rate
    mask = rnglib.bernoulli(key, keep, (x.shape[0], 1, 1, 1), x.device)
    return x * mask.to(x.dtype) / x.new_full((), keep)


class MBConvBlock(nn.Module):
    """Mobile inverted residual bottleneck + SE."""

    def __init__(self, cin: int, kernel_size: int, stride: int, expand_ratio: int,
                 output_filters: int, se_ratio: float, drop_rate: float = 0.0):
        super().__init__()
        self.drop_rate = drop_rate
        self.expand = expand_ratio != 1
        self.se = 0 < se_ratio <= 1
        self.residual = stride == 1 and cin == output_filters
        mid = cin * expand_ratio
        convs, norms = [], []
        if self.expand:
            convs.append(Conv(cin, mid, 1))
            norms.append(_bn(mid))
        convs.append(Conv(mid, mid, kernel_size, stride, padding="SAME", groups=mid))
        norms.append(_bn(mid))
        if self.se:
            squeezed = max(1, int(cin * se_ratio))
            convs += [Conv(mid, squeezed, 1, use_bias=True),
                      Conv(squeezed, mid, 1, use_bias=True)]
        convs.append(Conv(mid, output_filters, 1))
        norms.append(_bn(output_filters))
        for i, m in enumerate(convs):
            self.add_module(f"Conv_{i}", m)
        for i, m in enumerate(norms):
            self.add_module(f"BatchNorm_{i}", m)

    def forward(self, x, train: bool, updates: dict, rng=None):
        inputs = x
        c = b = 0
        if self.expand:
            x = F.silu(self.BatchNorm_0(self.Conv_0(x), train, updates))
            c = b = 1
        x = getattr(self, f"Conv_{c}")(x)
        x = F.silu(getattr(self, f"BatchNorm_{b}")(x, train, updates))
        c, b = c + 1, b + 1
        if self.se:
            s = F.silu(getattr(self, f"Conv_{c}")(x.mean((1, 2), keepdim=True)))
            x = x * torch.sigmoid(getattr(self, f"Conv_{c + 1}")(s))
            c += 2
        x = getattr(self, f"BatchNorm_{b}")(getattr(self, f"Conv_{c}")(x), train, updates)
        if self.residual:
            # flax's make_rng("dropout") in this block's scope: counter 1
            key = (fold_in_static(rng, (*self.state_prefix[:-1].split("."), 1))
                   if train and self.drop_rate > 0 and rng is not None else None)
            x = drop_connect(x, self.drop_rate, train, key) + inputs
        return x


class EfficientNet(nn.Module):
    def __init__(self, width_coeff: float = 1.0, depth_coeff: float = 1.0,
                 dropout_rate: float = 0.2, drop_connect_rate: float = 0.2,
                 num_classes: int = 1000,
                 blocks_args: Sequence[BlockArgs] = DEFAULT_BLOCKS):
        super().__init__()
        stem = round_filters(32, width_coeff)
        self.Conv_0 = Conv(3, stem, 3, 2, padding="SAME")
        self.BatchNorm_0 = _bn(stem)
        total_blocks = sum(round_repeats(b.num_repeat, depth_coeff) for b in blocks_args)
        self.blocks = []
        cin, idx = stem, 0
        for b in blocks_args:
            out = round_filters(b.output_filters, width_coeff)
            for rep in range(round_repeats(b.num_repeat, depth_coeff)):
                name = f"MBConvBlock_{idx}"
                self.add_module(name, MBConvBlock(
                    cin, b.kernel_size, b.stride if rep == 0 else 1, b.expand_ratio,
                    out, b.se_ratio,
                    # linear depth scaling, reference efficientnet.py:193-196
                    drop_connect_rate * idx / total_blocks))
                self.blocks.append(name)
                cin, idx = out, idx + 1
        head = round_filters(1280, width_coeff)
        self.Conv_1 = Conv(cin, head, 1)
        self.BatchNorm_1 = _bn(head)
        self.Dropout_0 = Dropout(dropout_rate)
        self.Dense_0 = Dense(head, num_classes)

    def forward(self, x, train: bool = False, updates: Optional[dict] = None,
                rng=None):
        updates = {} if updates is None else updates
        x = F.silu(self.BatchNorm_0(self.Conv_0(x), train, updates))
        for name in self.blocks:
            x = getattr(self, name)(x, train, updates, rng)
        x = F.silu(self.BatchNorm_1(self.Conv_1(x), train, updates))
        return self.Dense_0(self.Dropout_0(x.mean((1, 2)), train, rng))


def efficientnet(name: str = "efficientnet-b0", num_classes: int = 1000,
                 image_size: Optional[int] = None,
                 device: DeviceLike = None) -> ModelBundle:
    """Reference factory ``EfficientNet.from_name``."""
    w, d, res, dropout = PARAMS[name]
    return ModelBundle(
        module=EfficientNet(width_coeff=w, depth_coeff=d, dropout_rate=dropout,
                            num_classes=num_classes),
        input_shape=(image_size or res, image_size or res, 3),
        device=resolve_device(device),
        needs_dropout_rng=True,
    )
