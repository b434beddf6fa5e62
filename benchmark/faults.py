"""Faults planted under the timed path, each of which a sound benchmark
has to catch as not ``correct``: a round that hands back its state
unchanged, and a local update that trains on half of each batch (the mean
taken over the rest).  A training cell produces no answer or token to
alter, and a one-chip cell has no exchange between chips to leave out."""

from __future__ import annotations

import torch


def unchanged_state(round_fn):
    """A round function that runs, reports its metrics and returns the
    state it was given (with the round counter moved on)."""
    def broken(state, *args):
        _, metrics = round_fn(state, *args)
        return state._replace(round_idx=state.round_idx + 1), metrics
    return broken


def half_batch(loss_fn):
    """A loss that leaves out the second half of every batch: its rows
    weigh nothing, and the mean is over the first half's real rows."""
    def broken(logits, y, mask):
        keep = (torch.arange(mask.shape[0], device=mask.device) < mask.shape[0] // 2)
        return loss_fn(logits, y, mask * keep.to(mask.dtype))
    return broken


ROUND_FAULTS = {"unchanged_state": unchanged_state}
LOSS_FAULTS = {"half_batch": half_batch}
