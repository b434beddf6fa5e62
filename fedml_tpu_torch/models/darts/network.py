"""The fixed (discrete) DARTS network built from a Genotype, FedNAS's
train-stage model (port of ``fedml_tpu/models/darts/network.py``).

Reference ``fedml_api/model/cv/darts/model.py``: a Cell compiled from
(op, input) pairs with the stride-2 ops on inputs 0/1 of reduction cells,
NetworkCIFAR with a 3C stem and reductions at layers//3 and 2·layers//3.
Drop-path and the auxiliary head are left out, as in the JAX package;
BatchNorms are affine.
"""

from __future__ import annotations

import torch
from torch import nn

from fedml_tpu_torch.models.base import Dense, ModelBundle
from fedml_tpu_torch.models.darts.genotypes import Genotype
from fedml_tpu_torch.models.darts.ops import OPS, FactorizedReduce, Namer, ReLUConvBN
from fedml_tpu_torch.models.resnet import BatchNorm, Conv
from fedml_tpu_torch.utils.device import DeviceLike, resolve_device


class FixedCell(nn.Module):
    def __init__(self, genotype: Genotype, c_pp: int, c_p: int, C: int, reduction: bool,
                 reduction_prev: bool):
        super().__init__()
        name = Namer(self)
        self._pre = [name(FactorizedReduce(c_pp, C) if reduction_prev
                          else ReLUConvBN(c_pp, C, 1, 1)),
                     name(ReLUConvBN(c_p, C, 1, 1))]
        gene = genotype.reduce if reduction else genotype.normal
        self.concat = list(genotype.reduce_concat if reduction else genotype.normal_concat)
        self._nodes = []
        for i in range(len(gene) // 2):
            (n1, i1), (n2, i2) = gene[2 * i], gene[2 * i + 1]
            op1 = name(OPS[n1](C, 2 if reduction and i1 < 2 else 1, True))
            op2 = name(OPS[n2](C, 2 if reduction and i2 < 2 else 1, True))
            self._nodes.append((op1, i1, op2, i2))

    def forward(self, s0, s1, train: bool, updates: dict):
        states = [self._pre[0](s0, train, updates), self._pre[1](s1, train, updates)]
        for op1, i1, op2, i2 in self._nodes:
            states.append(op1(states[i1], train, updates) + op2(states[i2], train, updates))
        return torch.cat([states[i] for i in self.concat], dim=-1)


class NetworkCIFAR(nn.Module):
    def __init__(self, genotype: Genotype, C: int = 36, num_classes: int = 10,
                 layers: int = 20, in_channels: int = 3):
        super().__init__()
        c_curr = 3 * C
        self.Conv_0 = Conv(in_channels, c_curr, 3, padding=1)
        self.BatchNorm_0 = BatchNorm(c_curr)
        name = Namer(self)
        c_pp, c_p, c_curr = c_curr, c_curr, C
        reduction_prev = False
        self._cells = []
        for i in range(layers):
            reduction = i in (layers // 3, 2 * layers // 3)
            if reduction:
                c_curr *= 2
            cell = name(FixedCell(genotype, c_pp, c_p, c_curr, reduction, reduction_prev))
            self._cells.append(cell)
            reduction_prev = reduction
            c_pp, c_p = c_p, len(cell.concat) * c_curr
        self.Dense_0 = Dense(c_p, num_classes)

    def forward(self, x, train: bool = False, updates=None):
        updates = {} if updates is None else updates
        s0 = s1 = self.BatchNorm_0(self.Conv_0(x), train, updates)
        for cell in self._cells:
            s0, s1 = s1, cell(s0, s1, train, updates)
        return self.Dense_0(s1.mean(dim=(1, 2)))


def darts_network(genotype: Genotype, C=36, num_classes=10, layers=20, image_size=32,
                  in_channels=3, device: DeviceLike = None) -> ModelBundle:
    """Reference factory ``NetworkCIFAR(C, num_classes, layers, auxiliary,
    genotype)`` (``model.py:111-160``)."""
    return ModelBundle(
        module=NetworkCIFAR(genotype, C=C, num_classes=num_classes, layers=layers,
                            in_channels=in_channels),
        input_shape=(image_size, image_size, in_channels), device=resolve_device(device))
