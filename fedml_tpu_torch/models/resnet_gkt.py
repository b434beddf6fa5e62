"""Split ResNets for group knowledge transfer (FedGKT) (port of
``fedml_tpu/models/resnet_gkt.py``).

Architecture of the reference ``fedml_api/model/cv/resnet56_gkt/``:

- client nets (``resnet_client.py:206-240``): the CIFAR stem (3×3 conv →
  BN → relu), whose output is the **extracted feature map** shipped to
  the server, then layer1 only, a global pool and a local head;
  ``resnet5_56`` = BasicBlock×1, ``resnet8_56`` = Bottleneck×2.
- server net (``resnet_server.py:113-190``): takes the 16-channel
  feature map directly (no stem), runs the three stages, pool, head;
  ``resnet56_server`` = Bottleneck [6,6,6], ``resnet110_server`` =
  Bottleneck [12,12,12].

The client returns ``(logits, features)``, the server ``logits``.  The
layers are ``models/resnet.py``'s, so the convs are the library's
(``F.conv2d``), the role XLA's conv plays in the JAX nets; module names
are flax's auto-names (``Conv_0``, ``BasicBlock_0``, ``Bottleneck_3``,
``Dense_0``), so ``ModelBundle.init`` draws flax's variables and
``models/convert.py`` maps the trees.
"""

from __future__ import annotations

from typing import Optional, Sequence, Type

import torch
from torch import nn

from fedml_tpu_torch.models.base import Dense, ModelBundle
from fedml_tpu_torch.models.resnet import BasicBlock, BatchNorm, Bottleneck, Conv
from fedml_tpu_torch.utils.device import DeviceLike, resolve_device


class GKTClientResNet(nn.Module):
    def __init__(self, block: Type[nn.Module], n_blocks: int, num_classes: int = 10):
        super().__init__()
        self.Conv_0 = Conv(3, 16, 3, padding=1)
        self.BatchNorm_0 = BatchNorm(16)
        self.blocks = []
        in_ch = 16
        for i in range(n_blocks):
            name = f"{block.__name__}_{i}"
            self.add_module(name, block(in_ch, 16, 1))
            self.blocks.append(name)
            in_ch = 16 * block.expansion
        self.Dense_0 = Dense(in_ch, num_classes)

    def forward(self, x, train: bool = False, updates: Optional[dict] = None):
        updates = {} if updates is None else updates
        x = torch.relu(self.BatchNorm_0(self.Conv_0(x), train, updates))
        features = x  # B×H×W×16: the FedGKT payload
        for name in self.blocks:
            x = getattr(self, name)(x, train, updates)
        return self.Dense_0(x.mean((1, 2))), features


class GKTServerResNet(nn.Module):
    def __init__(self, layers: Sequence[int], num_classes: int = 10):
        super().__init__()
        self.blocks = []
        in_ch, j = 16, 0  # the client's 16-channel feature map; no stem
        for stage, (planes, n_blocks) in enumerate(zip((16, 32, 64), layers)):
            for i in range(n_blocks):
                stride = 2 if (stage > 0 and i == 0) else 1
                name = f"Bottleneck_{j}"
                self.add_module(name, Bottleneck(in_ch, planes, stride))
                self.blocks.append(name)
                in_ch, j = planes * Bottleneck.expansion, j + 1
        self.Dense_0 = Dense(in_ch, num_classes)

    def forward(self, x, train: bool = False, updates: Optional[dict] = None):
        updates = {} if updates is None else updates
        for name in self.blocks:
            x = getattr(self, name)(x, train, updates)
        return self.Dense_0(x.mean((1, 2)))


class GKTClientBundle(ModelBundle):
    """A ModelBundle whose forward returns ``(logits, features)``:
    ``apply_train`` gives ``((logits, features), variables)`` and
    ``apply_eval`` ``(logits, features)``, through ``ModelBundle``'s own
    functional call, which hands back whatever the module returns."""


def resnet5_56(num_classes=10, image_size=32, device: DeviceLike = None) -> GKTClientBundle:
    """Reference: ResNet(BasicBlock, [1,2,2]) with only layer1 active."""
    return GKTClientBundle(GKTClientResNet(BasicBlock, 1, num_classes),
                           (image_size, image_size, 3), resolve_device(device))


def resnet8_56(num_classes=10, image_size=32, device: DeviceLike = None) -> GKTClientBundle:
    """Reference: ResNet(Bottleneck, [2,2,2]) with only layer1 active."""
    return GKTClientBundle(GKTClientResNet(Bottleneck, 2, num_classes),
                           (image_size, image_size, 3), resolve_device(device))


def _server_bundle(layers, num_classes, image_size, device) -> ModelBundle:
    # the server's input is the FEATURE map: 16 channels at stem resolution
    return ModelBundle(GKTServerResNet(layers, num_classes),
                       (image_size, image_size, 16), resolve_device(device))


def resnet56_server(num_classes=10, image_size=32, device: DeviceLike = None) -> ModelBundle:
    """Reference: ResNet(Bottleneck, [6,6,6])."""
    return _server_bundle((6, 6, 6), num_classes, image_size, device)


def resnet110_server(num_classes=10, image_size=32, device: DeviceLike = None) -> ModelBundle:
    return _server_bundle((12, 12, 12), num_classes, image_size, device)
