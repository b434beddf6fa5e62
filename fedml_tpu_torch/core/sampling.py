"""Per-round client sampling → participation masks (port of
``fedml_tpu/core/sampling.py``).

``host_sample_ids`` is the numpy cohort draw every round driver shares;
it is bit-identical to the JAX package's.  The on-device draws
(``eligible_participation_mask``, ``inject_dropout``) come from a
``torch.Generator`` seeded from (seed, round, stream tag): the same
distributions and guarantees as the JAX draws, not the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

from fedml_tpu_torch.core.rng import generator

_SAMPLE_STREAM = 0x5A11
_DROP_STREAM = 0x0D0D


def host_sample_ids(seed: int, round_idx: int, num_clients: int,
                    num_per_round: int) -> np.ndarray:
    """Seeded uniform choice of ``num_per_round`` distinct client ids,
    sorted; every client when ``num_per_round >= num_clients``."""
    if num_per_round >= num_clients:
        return np.arange(num_clients)
    rng = np.random.RandomState(seed * 100003 + round_idx)
    return np.sort(rng.choice(num_clients, num_per_round, replace=False))


def eligible_participation_mask(seed: int, round_idx: int,
                                participation: torch.Tensor,
                                num_per_round: int) -> torch.Tensor:
    """Uniform draw of ``min(num_per_round, #eligible)`` distinct clients
    among ``participation > 0``, as a mask.  Top-K over iid uniform
    scores is a uniform K-subset, and it never comes up empty while any
    client is eligible."""
    g = generator(seed, round_idx, _SAMPLE_STREAM)
    k = min(int(num_per_round), int(participation.shape[0]))
    scores = torch.rand(participation.shape, generator=g).to(participation.device)
    scores = torch.where(participation > 0, scores, torch.full_like(scores, -1.0))
    idx = torch.topk(scores, k).indices
    mask = torch.zeros_like(participation)
    mask[idx] = 1.0
    # ineligible slots can only be picked when eligible < K; strip them
    return mask * (participation > 0)


def inject_dropout(seed: int, round_idx: int, participation: torch.Tensor,
                   drop_prob: float) -> torch.Tensor:
    """Each participating client independently drops with ``drop_prob``.
    Never drops everyone: if the draw kills every participant, the first
    one is kept (a round with zero weight has no defined average)."""
    g = generator(seed, round_idx, _DROP_STREAM)
    u = torch.rand(participation.shape, generator=g).to(participation.device)
    dropped = participation * (u < 1.0 - drop_prob).to(participation.dtype)
    first = torch.argmax(participation)
    rescue = torch.zeros_like(participation)
    rescue[first] = participation[first]
    return torch.where(dropped.sum() > 0, dropped, rescue)
