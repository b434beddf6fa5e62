"""Top-k with ``jax.lax.top_k``'s tie rule."""

from __future__ import annotations

import torch


def top_k_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest entries of the 1-D ``x``, largest
    first and, among equal values, the lower index first, as
    ``jax.lax.top_k`` orders them (``torch.topk`` leaves the order of ties
    unspecified): a stable descending sort, cut at ``k``."""
    return torch.sort(x, descending=True, stable=True).indices[:k]
