"""DARTS search network, the continuous relaxation (port of
``fedml_tpu/models/darts/search.py``).

Reference ``fedml_api/model/cv/darts/model_search.py``: MixedOp (every
primitive evaluated and weighted by the softmaxed alphas), Cell with
``steps`` intermediate nodes and stride-2 mixed ops on the first two inputs
of reduction cells, Network = 3C stem, reductions at layers//3 and
2·layers//3, global pool and a linear head.

The architecture parameters (alphas) are not module state: they are a
tree of their own, ``{"alphas_normal", "alphas_reduce"}``, handed to the
forward, so FedNAS steps and averages weights and alphas as two trees
with two optimizers.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn

from fedml_tpu_torch.core import rng as rnglib
from fedml_tpu_torch.models.base import Dense, ModelBundle, functional_call
from fedml_tpu_torch.models.darts.ops import (OPS, PRIMITIVES, FactorizedReduce, ReLUConvBN,
                                              Namer)
from fedml_tpu_torch.models.resnet import BatchNorm, Conv
from fedml_tpu_torch.utils.device import DeviceLike, resolve_device


def num_edges(steps: int = 4) -> int:
    return sum(2 + i for i in range(steps))


class MixedOp(nn.Module):
    """Every primitive over ``C`` channels, the pools each followed by an
    affine-free BatchNorm (``model_search.py:14-19``), summed with the
    edge's softmaxed weights."""

    def __init__(self, C: int, stride: int):
        super().__init__()
        name = Namer(self)
        self._branches = []
        for prim in PRIMITIVES:
            op = name(OPS[prim](C, stride, False))
            bn = name(BatchNorm(C, affine=False)) if "pool" in prim else None
            self._branches.append((op, bn))

    def forward(self, x, weights, train: bool, updates: dict):
        outs = []
        for op, bn in self._branches:
            o = op(x, train, updates)
            outs.append(o if bn is None else bn(o, train, updates))
        return sum(w * o for w, o in zip(weights, outs))


class SearchCell(nn.Module):
    def __init__(self, steps: int, multiplier: int, c_pp: int, c_p: int, C: int,
                 reduction: bool, reduction_prev: bool):
        super().__init__()
        self.steps, self.multiplier, self.reduction = steps, multiplier, reduction
        name = Namer(self)
        self._pre = [name(FactorizedReduce(c_pp, C, affine=False) if reduction_prev
                          else ReLUConvBN(c_pp, C, 1, 1, affine=False)),
                     name(ReLUConvBN(c_p, C, 1, 1, affine=False))]
        self._ops = [name(MixedOp(C, 2 if reduction and j < 2 else 1))
                     for i in range(steps) for j in range(2 + i)]

    def forward(self, s0, s1, weights, train: bool, updates: dict):
        states = [self._pre[0](s0, train, updates), self._pre[1](s1, train, updates)]
        offset = 0
        for _ in range(self.steps):
            s = sum(self._ops[offset + j](h, weights[offset + j], train, updates)
                    for j, h in enumerate(states))
            offset += len(states)
            states.append(s)
        return torch.cat(states[-self.multiplier:], dim=-1)


class SearchNetwork(nn.Module):
    def __init__(self, C: int = 16, num_classes: int = 10, layers: int = 8,
                 steps: int = 4, multiplier: int = 4, stem_multiplier: int = 3,
                 in_channels: int = 3):
        super().__init__()
        self.steps, self.multiplier = steps, multiplier
        c_curr = stem_multiplier * C
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
            self._cells.append(name(SearchCell(steps, multiplier, c_pp, c_p, c_curr,
                                               reduction, reduction_prev)))
            reduction_prev = reduction
            c_pp, c_p = c_p, multiplier * c_curr
        self.Dense_0 = Dense(c_p, num_classes)

    def forward(self, x, alphas_normal, alphas_reduce, train: bool = False,
                updates=None):
        updates = {} if updates is None else updates
        wn = torch.softmax(alphas_normal, dim=-1)
        wr = torch.softmax(alphas_reduce, dim=-1)
        s0 = s1 = self.BatchNorm_0(self.Conv_0(x), train, updates)
        for cell in self._cells:
            s0, s1 = s1, cell(s0, s1, wr if cell.reduction else wn, train, updates)
        return self.Dense_0(s1.mean(dim=(1, 2)))


@dataclasses.dataclass
class SearchBundle:
    """The search network's weights (``init``: flax's variables under the
    key, bit for bit) and its alphas (``init_alphas``), kept as two trees;
    the forwards take both."""

    module: SearchNetwork
    input_shape: Sequence[int]
    device: torch.device

    def __post_init__(self):
        self._weights = ModelBundle(self.module, self.input_shape, self.device)

    def init_alphas(self, key) -> dict:
        """``1e-3·N(0, 1)`` per edge and primitive (``model_search.py:
        232-241``), the normal cell's from ``split(key)[0]``, the
        reduction cell's from ``split(key)[1]``."""
        shape = (num_edges(self.module.steps), len(PRIMITIVES))
        ka, kb = rnglib.split(key)
        return {"alphas_normal": 1e-3 * rnglib.normal(ka, shape, self.device),
                "alphas_reduce": 1e-3 * rnglib.normal(kb, shape, self.device)}

    def init(self, key) -> dict:
        return self._weights.init(key)

    def _forward(self, variables, alphas, x, train: bool, updates: dict):
        state = {**variables["params"], **variables.get("batch_stats", {})}
        return functional_call(
            self.module, state, (x, alphas["alphas_normal"], alphas["alphas_reduce"]),
            {"train": train, "updates": updates})

    def apply_train(self, variables, alphas, x):
        """Train-mode logits and the variables with the new ``batch_stats``."""
        updates: dict = {}
        logits = self._forward(variables, alphas, x, True, updates)
        return logits, {**variables, "batch_stats": {**variables["batch_stats"], **updates}}

    def apply_eval(self, variables, alphas, x):
        return self._forward(variables, alphas, x, False, {})


def darts_search(C=16, num_classes=10, layers=8, image_size=32, steps=4, multiplier=4,
                 in_channels=3, device: DeviceLike = None) -> SearchBundle:
    """Reference factory ``Network(C, num_classes, layers, ...)``
    (``model_search.py:174``)."""
    return SearchBundle(
        module=SearchNetwork(C=C, num_classes=num_classes, layers=layers, steps=steps,
                             multiplier=multiplier, in_channels=in_channels),
        input_shape=(image_size, image_size, in_channels), device=resolve_device(device))
