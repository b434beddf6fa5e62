"""ModelBundle — the model contract (port of ``fedml_tpu/models/base.py``).

An ``nn.Module`` whose parameters and buffers are placeholders on the
``meta`` device, plus pure ``init`` / ``apply_train`` / ``apply_eval``
functions over an explicit variables dict

    {"params": {name: Tensor}, "batch_stats": {name: Tensor}}

keyed by the module's state names (``Bottleneck_3.Conv_1.kernel``),
which are the flax names joined with dots.  The forward runs through
``torch.func.functional_call``, so the caller owns every tensor: FedAvg
averages ``batch_stats`` as visibly as ``params``.

Train-mode BatchNorm does not mutate the module: each norm layer writes
its new running statistics into the ``updates`` dict the forward is
handed, under its own state names, and ``apply_train`` returns them as
the new ``batch_stats``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence, Tuple

import torch
from torch import nn

Variables = Dict[str, Dict[str, torch.Tensor]]

# flax's lecun_normal: variance_scaling(1, "fan_in", "truncated_normal");
# the constant is the std of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def meta_param(*shape: int) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, device="meta"))


def name_state_owners(module: nn.Module) -> None:
    """Give every submodule its state-name prefix (``Bottleneck_0.``),
    which norm layers use to key the statistics they emit."""
    for name, m in module.named_modules():
        m.state_prefix = f"{name}." if name else ""


def _init_leaf(name: str, shape, generator: torch.Generator) -> torch.Tensor:
    """flax's initializers by leaf name: conv/dense ``kernel`` lecun-normal
    (fan-in = every axis but the last), ``embedding`` flax's
    ``default_embed_init`` (an untruncated normal, variance_scaling(1,
    "fan_in", out_axis=0): fan-in = every axis but the first, so std
    ``1/√E`` for a ``[V, E]`` table), ``bias``/``mean`` zeros,
    ``scale``/``var`` ones."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "kernel":
        std = math.sqrt(1.0 / math.prod(shape[:-1])) / _TRUNC_STD
        t = torch.empty(shape)
        return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)
    if leaf == "embedding":
        std = math.sqrt(1.0 / math.prod(shape[1:]))
        return torch.randn(shape, generator=generator) * std
    if leaf in ("bias", "mean"):
        return torch.zeros(shape)
    if leaf in ("scale", "var"):
        return torch.ones(shape)
    raise ValueError(f"no initializer for variable {name!r}")


class Dense(nn.Module):
    """flax ``nn.Dense``: ``[in, out]`` kernel, plus a bias unless
    ``use_bias=False``."""

    def __init__(self, cin: int, cout: int, use_bias: bool = True):
        super().__init__()
        self.kernel = meta_param(cin, cout)
        self.bias = meta_param(cout) if use_bias else None

    def forward(self, x):
        y = x @ self.kernel.to(x.dtype)
        return y if self.bias is None else y + self.bias.to(x.dtype)


@dataclasses.dataclass
class ModelBundle:
    """An ``nn.Module`` + its input spec + the device its variables live on."""

    module: nn.Module
    input_shape: Sequence[int]  # one example's shape, no batch dim
    device: torch.device
    input_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        name_state_owners(self.module)

    def init(self, generator: torch.Generator) -> Variables:
        """Fresh variables drawn on the CPU from ``generator`` (so a seed
        gives the same model on every device), then moved to ``device``."""
        out = {"params": {
            n: _init_leaf(n, p.shape, generator).to(self.device)
            for n, p in self.module.named_parameters()}}
        stats = {n: _init_leaf(n, b.shape, generator).to(self.device)
                 for n, b in self.module.named_buffers()}
        if stats:
            out["batch_stats"] = stats
        return out

    def _call(self, variables: Variables, x: torch.Tensor, train: bool,
              updates: dict):
        state = {**variables["params"], **variables.get("batch_stats", {})}
        return torch.func.functional_call(
            self.module, state, (x,), {"train": train, "updates": updates})

    def apply_train(self, variables: Variables, x: torch.Tensor,
                    rng=None) -> Tuple[torch.Tensor, Variables]:
        """Forward in train mode; returns (logits, updated variables).
        ``rng`` is the step's threefry key (``core/rng.py``), as the JAX
        contract hands it; no ported model draws from it."""
        del rng
        updates: dict = {}
        logits = self._call(variables, x, True, updates)
        if "batch_stats" in variables:
            variables = {**variables,
                         "batch_stats": {**variables["batch_stats"], **updates}}
        return logits, variables

    def apply_eval(self, variables: Variables, x: torch.Tensor) -> torch.Tensor:
        return self._call(variables, x, False, {})
