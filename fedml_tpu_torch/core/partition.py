"""Non-IID data partitioners (numpy copy of ``fedml_tpu/core/partition.py``).

Re-implements the semantics of the reference's partition schemes:

- Dirichlet / LDA partition with a min-size retry loop
  (reference ``fedml_core/non_iid_partition/noniid_partition.py:6-63``
  and ``fedml_api/data_preprocessing/cifar10/data_loader.py:113-163``).
- ``homo`` uniform partition (same file, ``:126-129``).
- LEAF-style power-law partition used by the MNIST benchmark
  (pre-partitioned JSON in the reference; here generated directly).

All partitioners return ``Dict[int, np.ndarray]`` of sample indices —
the ``net_dataidx_map`` of the reference — and are host-side numpy by
design: partitioning is a one-off host task, not a device op.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def record_data_stats(
    y: np.ndarray, client_idx: Dict[int, np.ndarray], num_classes: int
) -> Dict[int, Dict[int, int]]:
    """Per-client class histogram (reference ``record_data_stats``,
    ``noniid_partition.py:66-74``)."""
    stats = {}
    for c, idx in client_idx.items():
        labels, counts = np.unique(y[idx], return_counts=True)
        stats[c] = {int(l): int(n) for l, n in zip(labels, counts)}
    return stats


def homo_partition(n_samples: int, num_clients: int, seed: int = 0) -> Dict[int, np.ndarray]:
    """Uniform random equal split (reference ``partition == "homo"``)."""
    rng = np.random.RandomState(seed)
    idx = rng.permutation(n_samples)
    return {c: np.sort(part) for c, part in enumerate(np.array_split(idx, num_clients))}


def dirichlet_partition(
    y: np.ndarray,
    num_clients: int,
    alpha: float,
    *,
    min_size_bound: int = 10,
    seed: int = 0,
    max_retries: int = 1000,
) -> Dict[int, np.ndarray]:
    """Latent-Dirichlet-allocation partition with min-size retry.

    Semantics of the reference's
    ``non_iid_partition_with_dirichlet_distribution`` (noniid_partition.py:6-63):
    for each class k, draw proportions p ~ Dir(alpha) over clients, cap any
    client already holding >= N/num_clients samples to 0 before normalizing,
    then split class-k indices by the cumulative proportions; retry the whole
    draw until every client holds at least ``min_size_bound`` samples.
    """
    rng = np.random.RandomState(seed)
    n = len(y)
    classes = np.unique(y)
    min_size = 0
    retries = 0
    idx_batch = [[] for _ in range(num_clients)]
    while min_size < min_size_bound:
        if retries > max_retries:
            raise RuntimeError(
                f"dirichlet_partition: could not reach min client size "
                f"{min_size_bound} after {max_retries} retries "
                f"(alpha={alpha}, clients={num_clients}, n={n})"
            )
        retries += 1
        idx_batch = [[] for _ in range(num_clients)]
        for k in classes:
            idx_k = np.where(y == k)[0]
            rng.shuffle(idx_k)
            proportions = rng.dirichlet(np.repeat(alpha, num_clients))
            # cap clients already at their fair share (reference :46-48)
            proportions = np.array(
                [
                    p * (len(idx_j) < n / num_clients)
                    for p, idx_j in zip(proportions, idx_batch)
                ]
            )
            proportions = proportions / proportions.sum()
            splits = (np.cumsum(proportions) * len(idx_k)).astype(int)[:-1]
            for c, part in enumerate(np.split(idx_k, splits)):
                idx_batch[c].extend(part.tolist())
        min_size = min(len(b) for b in idx_batch)

    out = {}
    for c in range(num_clients):
        b = np.array(idx_batch[c], dtype=np.int64)
        rng.shuffle(b)
        out[c] = b
    return out


def powerlaw_partition(
    y: np.ndarray,
    num_clients: int,
    *,
    alpha: float = 1.5,
    min_samples: int = 10,
    seed: int = 0,
) -> Dict[int, np.ndarray]:
    """LEAF-style power-law sizes with class-skewed contents.

    The reference's MNIST benchmark consumes LEAF's pre-generated
    power-law JSON partition (``MNIST/data_loader.py:8-123``); the
    generator itself lives outside the repo.  This reproduces its shape:
    client sizes follow a power law, and each client draws predominantly
    from a small number of classes (2, LEAF's default for MNIST).
    """
    rng = np.random.RandomState(seed)
    n = len(y)
    classes = np.unique(y)
    sizes = rng.pareto(alpha, num_clients) + 1.0
    sizes = np.maximum((sizes / sizes.sum() * (n - num_clients * min_samples)).astype(int)
                       + min_samples, min_samples)

    by_class = {int(k): list(rng.permutation(np.where(y == k)[0])) for k in classes}
    out: Dict[int, np.ndarray] = {}
    for c in range(num_clients):
        picked = []
        ks = rng.choice(classes, size=min(2, len(classes)), replace=False)
        want = int(sizes[c])
        for j, k in enumerate(ks):
            take = want - len(picked) if j == len(ks) - 1 else want // len(ks)
            pool = by_class[int(k)]
            got = pool[:take]
            by_class[int(k)] = pool[take:]
            picked.extend(got)
        if len(picked) < min_samples:  # pool ran dry — top up from anything left
            leftovers = [i for pool in by_class.values() for i in pool]
            rng.shuffle(leftovers)
            need = min_samples - len(picked)
            picked.extend(leftovers[:need])
            used = set(picked[-need:])
            for k in by_class:
                by_class[k] = [i for i in by_class[k] if i not in used]
        out[c] = np.array(picked, dtype=np.int64)
    return out


def partition_data(
    y: np.ndarray,
    num_clients: int,
    method: str = "hetero",
    alpha: float = 0.5,
    seed: int = 0,
) -> Dict[int, np.ndarray]:
    """Dispatch matching the reference's ``partition_data`` switch
    (``cifar10/data_loader.py:113-163``)."""
    if method in ("homo", "iid"):
        return homo_partition(len(y), num_clients, seed=seed)
    if method in ("hetero", "noniid", "dirichlet", "lda"):
        return dirichlet_partition(y, num_clients, alpha, seed=seed)
    if method in ("power_law", "powerlaw"):
        return powerlaw_partition(y, num_clients, seed=seed)
    raise ValueError(f"unknown partition method: {method}")
