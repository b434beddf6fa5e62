"""Finance / VFL party models (port of ``fedml_tpu/models/finance.py``).

Reference: ``fedml_api/model/finance/`` — ``vfl_feature_extractor.py``
(Dense → LeakyReLU), ``vfl_classifier.py`` (one Dense logits head) and
the standalone ``DenseModel``/``LocalModel`` pair
(``vfl_models_standalone.py``).  Each party's branch is one module,
extractor then head, under flax's names
(``VFLFeatureExtractor_0.Dense_0``, ``VFLClassifier_0.Dense_0``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from fedml_tpu_torch.models.base import Dense, ModelBundle
from fedml_tpu_torch.utils.device import DeviceLike, resolve_device


class VFLFeatureExtractor(nn.Module):
    """Dense(out) → flax's ``leaky_relu`` (slope 0.01, ``x >= 0`` kept, so
    its gradient at 0 is 1 as in JAX)."""

    def __init__(self, input_dim: int, output_dim: int):
        super().__init__()
        self.Dense_0 = Dense(input_dim, output_dim)

    def forward(self, x):
        h = self.Dense_0(x)
        return torch.where(h >= 0, h, 0.01 * h)


class VFLClassifier(nn.Module):
    """One Dense logits head."""

    def __init__(self, input_dim: int, output_dim: int = 1, use_bias: bool = True):
        super().__init__()
        self.Dense_0 = Dense(input_dim, output_dim, use_bias=use_bias)

    def forward(self, x):
        return self.Dense_0(x)


class VFLPartyNet(nn.Module):
    """One vertical party's branch: its private feature slice in,
    ``[B, output_dim]`` logit components out (the guest sums them)."""

    def __init__(self, input_dim: int, feature_dim: int, output_dim: int = 1,
                 use_bias: bool = True):
        super().__init__()
        self.VFLFeatureExtractor_0 = VFLFeatureExtractor(input_dim, feature_dim)
        self.VFLClassifier_0 = VFLClassifier(feature_dim, output_dim, use_bias)

    def forward(self, x, train: bool = False, updates: Optional[dict] = None):
        del train, updates
        return self.VFLClassifier_0(self.VFLFeatureExtractor_0(x))


def vfl_party(input_dim: int, feature_dim: int, *, output_dim: int = 1,
              use_bias: bool = True, device: DeviceLike = None) -> ModelBundle:
    return ModelBundle(module=VFLPartyNet(input_dim, feature_dim, output_dim, use_bias),
                       input_shape=(input_dim,), device=resolve_device(device))
