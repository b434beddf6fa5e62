"""Masked loss / metric functions (port of the softmax losses in
``fedml_tpu/core/losses.py``).

Pad-by-wrapping (``core.types.pack_clients``) means a batch may hold
duplicate "pad" samples; the losses take a ``mask`` and normalize by the
real-sample count, so padded slots contribute exactly zero gradient and
zero metric weight.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F

# A LossFn maps (logits, targets, mask) -> (mean_loss, aux_metrics)
LossFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                  Tuple[torch.Tensor, dict]]


def softmax_ce_logits(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-example cross-entropy with integer targets (no mask)."""
    return F.cross_entropy(logits.float(), y.long(), reduction="none")


def masked_softmax_ce(logits: torch.Tensor, y: torch.Tensor,
                      mask: torch.Tensor):
    """Cross-entropy with integer targets; mean over mask.

    Handles [B, C] classification and [B, T, C] sequence shapes; for
    sequences the mask is broadcast over time unless given per-token."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, y.long().unsqueeze(-1)).squeeze(-1)
    if nll.ndim > mask.ndim:
        mask = mask.unsqueeze(-1).expand(nll.shape)
    denom = torch.clamp(mask.sum(), min=1.0)
    loss_sum = (nll * mask).sum()
    pred = torch.argmax(logits, dim=-1)
    correct = ((pred == y).float() * mask).sum()
    return loss_sum / denom, {"loss_sum": loss_sum, "correct": correct,
                              "count": mask.sum()}
