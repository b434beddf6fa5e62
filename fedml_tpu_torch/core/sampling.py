"""Per-round client sampling → participation masks (port of
``fedml_tpu/core/sampling.py``).

Every draw is the JAX package's, bit for bit: the same threefry keys
(``core/rng.py``) under the same ``fold_in`` layout, so the same key and
round give the same cohort, mask and dropout pattern.  ``host_sample_ids``
is the numpy cohort draw every round driver shares.  The on-device draws
run on the device of the ``participation`` tensor they are handed.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from fedml_tpu_torch.core import rng as rnglib
from fedml_tpu_torch.utils.topk import top_k_indices

_SAMPLE_STREAM = 0x5A11
_DROP_STREAM = 0x0D0D


def sample_clients(key: rnglib.Key, round_idx: int, num_clients: int,
                   num_per_round: int, device=None) -> torch.Tensor:
    """Seeded uniform choice of ``num_per_round`` distinct client ids (the
    head of a permutation under ``fold_in(key, round)``), int32; every
    client when ``num_per_round >= num_clients``."""
    if num_per_round >= num_clients:
        return torch.arange(num_clients, dtype=torch.int32, device=device)
    perm = rnglib.permutation(rnglib.fold_in(key, round_idx), num_clients, device)
    return perm[:num_per_round].to(torch.int32)


def mask_and_ids(key: rnglib.Key, round_idx: int, num_clients: int,
                 num_per_round: int,
                 device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    ids = sample_clients(key, round_idx, num_clients, num_per_round, device)
    mask = torch.zeros(num_clients, device=device)
    mask[ids.long()] = 1.0
    return mask, ids


def participation_mask(key: rnglib.Key, round_idx: int, num_clients: int,
                       num_per_round: int, device=None) -> torch.Tensor:
    """[num_clients] float mask with exactly ``num_per_round`` ones."""
    return mask_and_ids(key, round_idx, num_clients, num_per_round, device)[0]


def host_sample_ids(seed: int, round_idx: int, num_clients: int,
                    num_per_round: int) -> np.ndarray:
    """Seeded uniform choice of ``num_per_round`` distinct client ids,
    sorted; every client when ``num_per_round >= num_clients``."""
    if num_per_round >= num_clients:
        return np.arange(num_clients)
    rng = np.random.RandomState(seed * 100003 + round_idx)
    return np.sort(rng.choice(num_clients, num_per_round, replace=False))


def eligible_participation_mask(key: rnglib.Key, round_idx: int,
                                participation: torch.Tensor,
                                num_per_round: int) -> torch.Tensor:
    """Uniform draw of ``min(num_per_round, #eligible)`` distinct clients
    among ``participation > 0``, as a mask: top-K over uniform scores
    under ``fold_in(fold_in(key, round), 0x5A11)``, the lower index first
    where scores tie (``jax.lax.top_k``'s rule).  Top-K over iid uniform
    scores is a uniform K-subset, and it never comes up empty while any
    client is eligible."""
    k = rnglib.fold_in(rnglib.fold_in(key, round_idx), _SAMPLE_STREAM)
    num = min(int(num_per_round), int(participation.shape[0]))
    scores = rnglib.uniform(k, participation.shape, participation.device)
    scores = torch.where(participation > 0, scores, torch.full_like(scores, -1.0))
    idx = top_k_indices(scores, num)
    mask = torch.zeros_like(participation)
    mask[idx] = 1.0
    # ineligible slots can only be picked when eligible < K; strip them
    return mask * (participation > 0)


def inject_dropout(key: rnglib.Key, round_idx: int, participation: torch.Tensor,
                   drop_prob: float) -> torch.Tensor:
    """Each participating client independently survives with
    ``bernoulli(1 - drop_prob)`` under ``fold_in(fold_in(key, round),
    0x0D0D)``.  Never drops everyone: if the draw kills every
    participant, the first one is kept (a round with zero weight has no
    defined average)."""
    k = rnglib.fold_in(rnglib.fold_in(key, round_idx), _DROP_STREAM)
    survive = rnglib.bernoulli(k, 1.0 - drop_prob, participation.shape,
                               participation.device)
    dropped = participation * survive.to(participation.dtype)
    first = torch.argmax(participation)
    rescue = torch.zeros_like(participation)
    rescue[first] = participation[first]
    return torch.where(dropped.sum() > 0, dropped, rescue)
