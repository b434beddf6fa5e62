"""The one generator of the benchmark's traffic: a ``traffic/<name>.json``
file of parameters and a configuration file in, the clients' data out,
made from ``--seed``.

Two kinds of data:

- ``images``: ``samples`` images of the configuration's ``image_size``,
  pixels uniform in [0, 1) normalised per channel by ``pixel_mean`` and
  ``pixel_std``, labels balanced over the classes in a fixed order, split
  over ``clients`` silos by FedML's hetero Dirichlet partition under
  ``partition.alpha`` and ``partition.seed``.  The partition seed is the
  file's, not the run's, so every run pads the same client sizes.
- ``tokens``: ``clients × sequences_per_client`` sequences of ``seq_len``
  token ids uniform over the configuration's vocabulary, each with its
  next-token targets, a contiguous block of sequences per silo.

Only the values change with the seed; every size stays."""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch


@dataclasses.dataclass
class ClientData:
    """The silos' data as the program's ``FedDataset`` holds it."""

    train_x: np.ndarray
    train_y: np.ndarray
    train_client_idx: Dict[int, np.ndarray]
    num_classes: int


def stream_seed(seed: int, stream: int) -> int:
    """The seed of one of the run's generators (data 1, weights 2)."""
    return (int(seed) * 4 + stream) % (2 ** 63)


def dirichlet_partition(y: np.ndarray, num_clients: int, alpha: float, *,
                        min_size_bound: int = 10, seed: int = 0,
                        max_retries: int = 1000) -> Dict[int, np.ndarray]:
    """FedML's ``non_iid_partition_with_dirichlet_distribution``: per class,
    proportions ~ Dir(alpha) over the clients, a client already holding
    N/clients rows gets none of the class, the class's rows are split by
    the cumulative proportions; the whole draw is retried until every
    client holds ``min_size_bound`` rows."""
    rng = np.random.RandomState(seed)
    n = len(y)
    classes = np.unique(y)
    min_size, retries = 0, 0
    idx_batch = [[] for _ in range(num_clients)]
    while min_size < min_size_bound:
        if retries > max_retries:
            raise RuntimeError(f"no partition with {min_size_bound} rows a client "
                               f"after {max_retries} draws")
        retries += 1
        idx_batch = [[] for _ in range(num_clients)]
        for k in classes:
            idx_k = np.where(y == k)[0]
            rng.shuffle(idx_k)
            p = rng.dirichlet(np.repeat(alpha, num_clients))
            p = np.array([q * (len(b) < n / num_clients) for q, b in zip(p, idx_batch)])
            p = p / p.sum()
            splits = (np.cumsum(p) * len(idx_k)).astype(int)[:-1]
            for c, part in enumerate(np.split(idx_k, splits)):
                idx_batch[c].extend(part.tolist())
        min_size = min(len(b) for b in idx_batch)
    out = {}
    for c in range(num_clients):
        b = np.array(idx_batch[c], dtype=np.int64)
        rng.shuffle(b)
        out[c] = b
    return out


def generate(cfg: dict, traffic: dict, seed: int, device: torch.device) -> ClientData:
    """The clients' data of one run, drawn on ``device`` in one call."""
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, 1))
    kind = traffic["kind"]
    if kind == "images":
        n = traffic["samples"]
        h, w, c = cfg["image_size"]
        classes = cfg["num_classes"]
        x = torch.rand((n, h, w, c), generator=g, device=device)
        mean = torch.tensor(traffic["pixel_mean"], device=device)
        std = torch.tensor(traffic["pixel_std"], device=device)
        x = ((x - mean) / std).cpu().numpy()
        y = (np.arange(n) * classes // n).astype(np.int64)
        part = traffic["partition"]
        idx = dirichlet_partition(y, traffic["clients"], part["alpha"],
                                  min_size_bound=part["min_size"], seed=part["seed"])
        return ClientData(x, y, idx, classes)
    if kind == "tokens":
        k, per, length = traffic["clients"], traffic["sequences_per_client"], traffic["seq_len"]
        vocab = cfg["vocab_size"]
        t = torch.randint(0, vocab, (k * per, length + 1), generator=g, device=device)
        t = t.to(torch.int32).cpu().numpy()
        idx = {c: np.arange(c * per, (c + 1) * per) for c in range(k)}
        return ClientData(np.ascontiguousarray(t[:, :-1]), np.ascontiguousarray(t[:, 1:]),
                          idx, vocab)
    raise ValueError(f"unknown traffic kind {kind!r}")


def packed_steps(data: ClientData, batch: int) -> int:
    """Steps per epoch of the pack: the largest silo's batches."""
    return max(1, -(-max(len(v) for v in data.train_client_idx.values()) // batch))
