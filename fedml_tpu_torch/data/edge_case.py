"""Backdoor poisoned datasets: the pixel-trigger attack (port of
``stamp_trigger``, ``PoisonedData`` and ``make_backdoor`` of
``fedml_tpu/data/edge_case.py``, numpy only).

A 3×3 checker trigger stamped on real samples relabelled to the
attacker's target class (the BadNets shape), mixed into the attacker's
own shard; the targeted-task test set is the triggered test samples whose
true label differs from the target.  The edge-case (OOD label-flip)
loaders of the JAX module are ported with the rest of the data zoo.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from fedml_tpu_torch.core.types import FedDataset


def stamp_trigger(x: np.ndarray, intensity: float = 1.0) -> np.ndarray:
    """Stamp a 3×3 checker trigger in the bottom-right corner (image
    data [N,H,W,C]) or spike the last 3 features (flat data [N,D])."""
    x = x.copy()
    if x.ndim >= 3:
        for di in range(3):
            for dj in range(3):
                if (di + dj) % 2 == 0:
                    x[:, -1 - di, -1 - dj, ...] = intensity
    else:
        x[:, -3:] = intensity
    return x


@dataclasses.dataclass
class PoisonedData:
    train_x: np.ndarray  # attacker's mixed local training set
    train_y: np.ndarray
    backdoor_test_x: np.ndarray  # triggered held-out samples
    backdoor_test_y: np.ndarray  # all = target_label


def make_backdoor(
    dataset: FedDataset,
    attacker_client: int,
    target_label: int = 0,
    poison_fraction: float = 0.3,
    intensity: float = 1.0,
    seed: int = 0,
) -> PoisonedData:
    rng = np.random.RandomState(seed)
    idx = np.asarray(dataset.train_client_idx[attacker_client])
    honest_x = dataset.train_x[idx]
    honest_y = dataset.train_y[idx]
    n_poison = max(1, int(len(idx) * poison_fraction))
    src = rng.choice(len(idx), n_poison, replace=False)
    poison_x = stamp_trigger(honest_x[src], intensity)
    poison_y = np.full(n_poison, target_label, dtype=honest_y.dtype)

    # the mixture, shuffled: the attacker still trains on honest data too
    mix_x = np.concatenate([honest_x, poison_x])
    mix_y = np.concatenate([honest_y, poison_y])
    order = rng.permutation(len(mix_x))

    # targeted-task eval: triggered test samples whose TRUE label differs
    not_target = dataset.test_y != target_label
    bt_x = stamp_trigger(dataset.test_x[not_target], intensity)
    bt_y = np.full(int(not_target.sum()), target_label, dtype=dataset.test_y.dtype)
    return PoisonedData(train_x=mix_x[order], train_y=mix_y[order],
                        backdoor_test_x=bt_x, backdoor_test_y=bt_y)
