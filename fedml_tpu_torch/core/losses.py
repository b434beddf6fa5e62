"""Masked loss / metric functions (port of ``fedml_tpu/core/losses.py``).

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


def _bce_elements(logits: torch.Tensor, yf: torch.Tensor) -> torch.Tensor:
    """Numerically stable per-element BCE-with-logits, with JAX's
    gradient at a zero logit: ``maximum`` splits it evenly between its
    arguments, and ``|z|``'s derivative there is +1 (``select(z >= 0)``)."""
    zero = torch.zeros_like(logits)
    abs_z = torch.where(logits >= 0, logits, -logits)
    return torch.maximum(logits, zero) - logits * yf + torch.log1p(torch.exp(-abs_z))


def masked_bce_logits(logits: torch.Tensor, y: torch.Tensor,
                      mask: torch.Tensor):
    """Binary cross-entropy on logits (binary tasks); mean over mask."""
    logits = logits.float().reshape(y.shape)
    yf = y.float()
    per = _bce_elements(logits, yf)
    denom = torch.clamp(mask.sum(), min=1.0)
    loss_sum = (per * mask).sum()
    pred = (logits > 0).to(yf.dtype)
    correct = ((pred == yf).float() * mask).sum()
    return loss_sum / denom, {"loss_sum": loss_sum, "correct": correct,
                              "count": mask.sum()}


def masked_multilabel_bce(logits: torch.Tensor, y: torch.Tensor,
                          mask: torch.Tensor):
    """Multi-label tag prediction: per-sample BCE summed over the label
    axis, averaged over the masked samples, with the reference's metrics:
    ``correct`` counts samples whose whole tag vector matches
    (``sigmoid(z) > .5`` ⇔ ``z > 0``), plus per-sample precision and
    recall summed over the mask (``1e-13`` in their denominators).

    Shapes: logits [B, C] (or [..., C]), y multi-hot [..., C] float,
    mask [...] per sample.  ``loss_sum`` is the label-summed BCE over the
    mask, the reference's ``BCELoss(reduction='sum')``."""
    logits = logits.float().reshape(y.shape)
    yf = y.float()
    per = _bce_elements(logits, yf).sum(-1)
    denom = torch.clamp(mask.sum(), min=1.0)
    loss_sum = (per * mask).sum()
    pred = (logits > 0.0).float()
    exact = (pred == yf).all(-1).float()
    tp = (yf * pred).sum(-1)
    precision = tp / (pred.sum(-1) + 1e-13)
    recall = tp / (yf.sum(-1) + 1e-13)
    return loss_sum / denom, {
        "loss_sum": loss_sum,
        "correct": (exact * mask).sum(),
        "count": mask.sum(),
        "precision_sum": (precision * mask).sum(),
        "recall_sum": (recall * mask).sum(),
    }


def masked_kd_kl(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                 mask: torch.Tensor, temperature: float = 3.0) -> torch.Tensor:
    """Knowledge-distillation KL with temperature, mean over mask:
    ``T² · KL(softmax(teacher/T) ‖ softmax(student/T))``."""
    t = temperature
    logp_s = torch.log_softmax(student_logits.float() / t, dim=-1)
    p_t = torch.softmax(teacher_logits.float() / t, dim=-1)
    logp_t = torch.log_softmax(teacher_logits.float() / t, dim=-1)
    per = (p_t * (logp_t - logp_s)).sum(-1) * (t * t)
    denom = torch.clamp(mask.sum(), min=1.0)
    return (per * mask).sum() / denom


def masked_mse(preds: torch.Tensor, y: torch.Tensor, mask: torch.Tensor):
    """Squared error; mean over mask (``correct`` is always 0)."""
    preds = preds.float().reshape(y.shape)
    per = torch.square(preds - y.float())
    denom = torch.clamp(mask.sum(), min=1.0)
    loss_sum = (per * mask).sum()
    return loss_sum / denom, {"loss_sum": loss_sum,
                              "correct": torch.zeros((), device=preds.device),
                              "count": mask.sum()}
