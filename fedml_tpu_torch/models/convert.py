"""Carry model variables between the JAX package and the port.

The JAX package's variables are a flax tree, ``{"params": {...},
"batch_stats": {...}}`` nested by module name.  The port's are the same
collections flattened to the module state names, which are the flax
paths joined with dots (``params/Bottleneck_3/Conv_1/kernel`` ↔
``variables["params"]["Bottleneck_3.Conv_1.kernel"]``).  Layouts are
shared (HWIO conv kernels, ``[in, out]`` dense kernels), so a leaf is
copied as it is.  Both sides are plain numpy here: the caller turns the
flax tree into nested dicts of numpy arrays; the port never sees a JAX
object.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from fedml_tpu_torch.models.base import Variables
from fedml_tpu_torch.utils.device import DeviceLike, resolve_device


def _flatten(tree: Mapping, prefix: str, out: Dict[str, Any]) -> None:
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            _flatten(v, key, out)
        else:
            out[key] = v


def from_jax_tree(tree: Mapping, device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """One collection's nested dict of numpy arrays under flax names → a
    flat dict of tensors under the port's dotted names on ``device``.  A
    leaf is copied as it is, so the stacked stage parameters of a pipeline
    (every leaf ``[S, ...]``) and the MoE parameters (``gate``, ``w_in``,
    ``w_out``) cross over by the same call."""
    dev = resolve_device(device)
    flat: Dict[str, Any] = {}
    _flatten(tree, "", flat)
    return {k: torch.from_numpy(np.array(v, copy=True)).to(dev) for k, v in flat.items()}


def from_jax_variables(tree: Mapping, device: DeviceLike = None) -> Variables:
    """Nested dict of numpy arrays under flax names → the port's variables
    on ``device``."""
    return {collection: from_jax_tree(sub, device) for collection, sub in tree.items()}


def to_jax_tree(flat: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """A flat dict of tensors under dotted names → a nested dict of numpy
    arrays under flax names (bf16 leaves come back as fp32; numpy has no
    bf16)."""
    node: Dict[str, Any] = {}
    for name, t in flat.items():
        *path, leaf = name.split(".")
        d = node
        for p in path:
            d = d.setdefault(p, {})
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        d[leaf] = t.numpy()
    return node


def to_jax_variables(variables: Variables) -> Dict[str, Any]:
    """The port's variables → nested dict of numpy arrays under flax names
    (bf16 leaves come back as fp32; numpy has no bf16)."""
    return {collection: to_jax_tree(flat) for collection, flat in variables.items()}
