"""Linear models (port of ``fedml_tpu/models/linear.py``; reference
``fedml_api/model/linear/lr.py:4-11``): logistic regression and the
two-layer perceptron ``mlp2``."""

from __future__ import annotations

import torch
from torch import nn

from fedml_tpu_torch.models.base import Dense, ModelBundle
from fedml_tpu_torch.utils.device import DeviceLike, resolve_device


class LogisticRegression(nn.Module):
    """One dense layer over the flattened input, raw logits out (the
    softmax stays inside the loss), as the JAX package's module."""

    def __init__(self, input_dim: int, num_classes: int = 10):
        super().__init__()
        self.Dense_0 = Dense(input_dim, num_classes)

    def forward(self, x, train: bool = False, updates=None):
        del train, updates
        return self.Dense_0(x.reshape(x.shape[0], -1).float())


def logistic_regression(input_dim: int = 784, num_classes: int = 10,
                        device: DeviceLike = None) -> ModelBundle:
    return ModelBundle(module=LogisticRegression(input_dim, num_classes),
                       input_shape=(input_dim,), device=resolve_device(device))


class MLP2(nn.Module):
    """Two dense layers with a ReLU between them, in float32, over the
    flattened input."""

    def __init__(self, input_dim: int, hidden: int = 32, num_classes: int = 10):
        super().__init__()
        self.Dense_0 = Dense(input_dim, hidden)
        self.Dense_1 = Dense(hidden, num_classes)

    def forward(self, x, train: bool = False, updates=None):
        del train, updates
        h = torch.relu(self.Dense_0(x.reshape(x.shape[0], -1).float()))
        return self.Dense_1(h)


def mlp2(input_dim: int, hidden: int = 32, num_classes: int = 10,
         input_shape=None, device: DeviceLike = None) -> ModelBundle:
    return ModelBundle(
        module=MLP2(input_dim, hidden, num_classes),
        input_shape=tuple(input_shape) if input_shape else (input_dim,),
        device=resolve_device(device))
