"""FedAvg benchmark CNNs (port of ``fedml_tpu/models/cnn.py``; reference
``fedml_api/model/cv/cnn.py``).

- ``CNNOriginalFedAvg`` — the McMahan et al. 2016 MNIST/FEMNIST CNN:
  2×[5×5 conv (SAME) → 2×2 maxpool] → dense 512 → head.
- ``CNNDropOut`` — the TFF baseline variant with dropout: 2×[3×3 conv
  (VALID)] → maxpool → dropout 0.25 → dense 128 → dropout 0.5 → head.

NHWC activations and HWIO kernels with a bias, as the flax modules; the
convolutions are the library's (``F.conv2d``), as XLA's are in the JAX
package.  The flatten before the dense layers is over NHWC, so a flax
``Dense_0`` kernel carries over unchanged.  ``cnn_split_pair`` cuts
the McMahan CNN at that flatten into SplitNN's client bottom and server
top.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.base import Dense, Dropout, ModelBundle
from fedml_tpu_torch.models.resnet import Conv
from fedml_tpu_torch.utils.device import DeviceLike, resolve_device


def _as_image(x):
    """A flat ``[B, side²]`` input becomes ``[B, side, side, 1]``."""
    if x.ndim == 2:
        side = int(x.shape[-1] ** 0.5)
        x = x.reshape(x.shape[0], side, side, 1)
    return x


def max_pool_2x2(x):
    """flax ``max_pool(x, (2, 2), strides=(2, 2))`` over NHWC."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


class CNNOriginalFedAvg(nn.Module):
    def __init__(self, num_classes: int = 62, only_digits: bool = False,
                 side: int = 28):
        super().__init__()
        self.Conv_0 = Conv(1, 32, 5, use_bias=True)
        self.Conv_1 = Conv(32, 64, 5, use_bias=True)
        self.Dense_0 = Dense((side // 4) * (side // 4) * 64, 512)
        self.Dense_1 = Dense(512, 10 if only_digits else num_classes)

    def forward(self, x, train: bool = False, updates: Optional[dict] = None):
        del train, updates
        x = _as_image(x)
        x = max_pool_2x2(torch.relu(self.Conv_0(x)))
        x = max_pool_2x2(torch.relu(self.Conv_1(x)))
        x = torch.relu(self.Dense_0(x.reshape(x.shape[0], -1)))
        return self.Dense_1(x)


class CNNDropOut(nn.Module):
    def __init__(self, num_classes: int = 62, only_digits: bool = False,
                 side: int = 28):
        super().__init__()
        self.Conv_0 = Conv(1, 32, 3, padding=0, use_bias=True)
        self.Conv_1 = Conv(32, 64, 3, padding=0, use_bias=True)
        self.Dropout_0 = Dropout(0.25)
        self.Dense_0 = Dense(((side - 4) // 2) ** 2 * 64, 128)
        self.Dropout_1 = Dropout(0.5)
        self.Dense_1 = Dense(128, 10 if only_digits else num_classes)

    def forward(self, x, train: bool = False, updates: Optional[dict] = None,
                rng=None):
        del updates
        x = _as_image(x)
        x = torch.relu(self.Conv_0(x))
        x = torch.relu(self.Conv_1(x))
        x = self.Dropout_0(max_pool_2x2(x), train, rng)
        x = torch.relu(self.Dense_0(x.reshape(x.shape[0], -1)))
        x = self.Dropout_1(x, train, rng)
        return self.Dense_1(x)


def cnn_original_fedavg(only_digits: bool = True, side: int = 28,
                        device: DeviceLike = None) -> ModelBundle:
    return ModelBundle(
        module=CNNOriginalFedAvg(only_digits=only_digits, side=side),
        input_shape=(side, side, 1), device=resolve_device(device))


def cnn_dropout(only_digits: bool = False, side: int = 28,
                device: DeviceLike = None) -> ModelBundle:
    return ModelBundle(
        module=CNNDropOut(only_digits=only_digits, side=side),
        input_shape=(side, side, 1), device=resolve_device(device),
        needs_dropout_rng=True)


class _CNNBottom(nn.Module):
    """Conv half of the McMahan CNN, the SplitNN client side: a flat
    ``[B, side²·c]`` input becomes ``[B, side, side, c]``; the output is
    the NHWC flatten the top's ``Dense_0`` reads."""

    def __init__(self, channels: int):
        super().__init__()
        self.Conv_0 = Conv(channels, 32, 5, use_bias=True)
        self.Conv_1 = Conv(32, 64, 5, use_bias=True)

    def forward(self, x, train: bool = False, updates: Optional[dict] = None):
        del train, updates
        if x.ndim == 2:
            side = int(x.shape[-1] ** 0.5)
            x = x.reshape(x.shape[0], side, side, -1)
        x = max_pool_2x2(torch.relu(self.Conv_0(x)))
        x = max_pool_2x2(torch.relu(self.Conv_1(x)))
        return x.reshape(x.shape[0], -1)


class _CNNTop(nn.Module):
    def __init__(self, features: int, num_classes: int = 10):
        super().__init__()
        self.Dense_0 = Dense(features, 512)
        self.Dense_1 = Dense(512, num_classes)

    def forward(self, x, train: bool = False, updates: Optional[dict] = None):
        del train, updates
        return self.Dense_1(torch.relu(self.Dense_0(x)))


def cnn_split_pair(num_classes: int, input_shape, device: DeviceLike = None) -> tuple:
    """(bottom, top) ModelBundles for SplitNN over image data: ``[side,
    side, c]`` images or flat ``[side²·c]`` rows."""
    dev = resolve_device(device)
    if len(input_shape) == 1:
        side = int(input_shape[0] ** 0.5)
        channels = input_shape[0] // (side * side)
    else:
        side, channels = input_shape[0], input_shape[-1]
    feat = (side // 4) * (side // 4) * 64
    return (ModelBundle(module=_CNNBottom(channels), input_shape=tuple(input_shape),
                        device=dev),
            ModelBundle(module=_CNNTop(feat, num_classes), input_shape=(feat,), device=dev))
