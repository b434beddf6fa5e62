"""Topology managers for decentralized FL (port of
``fedml_tpu/core/topology.py``).

- ``SymmetricTopologyManager``: a ring lattice plus random symmetric
  links (``neighbor_num`` per node), row-normalized.
- ``AsymmetricTopologyManager``: the same undirected base, then randomly
  deleted directed links (ring links kept), row-normalized.
- ``BaseTopologyManager``: in/out neighbour index and weight queries.

The matrices are built on the host with numpy (one-off set-up); the
gossip round consumes them as a dense [N, N] mixing matrix.  The JAX
package builds the ring lattice with ``networkx.watts_strogatz_graph(n,
k, 0.0, seed)``; at p = 0 that is the lattice itself (each node linked to
its k/2 nearest on each side; the complete graph when k == n), built
here directly.  The random second phase keeps numpy's ``RandomState``
and ``shuffle`` over Python lists, as the JAX package does.
"""

from __future__ import annotations

from typing import List

import numpy as np


class BaseTopologyManager:
    """In/out neighbour queries over a row-stochastic mixing matrix."""

    topology: np.ndarray  # [N, N]; row i = weights node i uses to mix IN

    def get_in_neighbor_idx_list(self, node_index: int) -> List[int]:
        return [j for j in range(self.n)
                if self.topology[node_index, j] > 0 and j != node_index]

    def get_out_neighbor_idx_list(self, node_index: int) -> List[int]:
        return [i for i in range(self.n)
                if self.topology[i, node_index] > 0 and i != node_index]

    def get_in_neighbor_weights(self, node_index: int) -> List[float]:
        return self.topology[node_index].tolist()

    def get_out_neighbor_weights(self, node_index: int) -> List[float]:
        return self.topology[:, node_index].tolist()

    @property
    def n(self) -> int:
        return self.topology.shape[0]


def _ring_lattice(n: int, k: int) -> np.ndarray:
    """0/1 adjacency of ``watts_strogatz_graph(n, k, p=0)``: node i linked
    to i ± 1..k/2 (k even, k ≤ n); k == n is the complete graph."""
    if k > n:
        raise ValueError(f"ring lattice: k={k} > n={n}")
    if k == n:
        return np.ones((n, n)) - np.eye(n)
    adj = np.zeros((n, n))
    for j in range(1, k // 2 + 1):
        for i in range(n):
            adj[i, (i + j) % n] = adj[(i + j) % n, i] = 1
    return adj


def _ring_plus_random(n: int, neighbor_num: int, seed: int) -> np.ndarray:
    """Symmetric 0/1 adjacency: ring lattice + random extra symmetric
    links, self-loops included (a node always keeps its own model)."""
    if n == 1:
        return np.ones((1, 1))
    k = max(2, min(neighbor_num, n - 1))
    adj = _ring_lattice(n, k if k % 2 == 0 else k + 1)
    rng = np.random.RandomState(seed)
    extra = max(0, neighbor_num - 2)
    for i in range(n):
        candidates = [j for j in range(n) if j != i and adj[i, j] == 0]
        rng.shuffle(candidates)
        for j in candidates[:extra]:
            adj[i, j] = adj[j, i] = 1
    np.fill_diagonal(adj, 1)
    return adj


class SymmetricTopologyManager(BaseTopologyManager):
    """Undirected topology, row-normalized to uniform neighbour weights."""

    def __init__(self, n: int, neighbor_num: int = 2, seed: int = 0):
        self._n = n
        self.neighbor_num = neighbor_num
        self.seed = seed
        self.topology = np.zeros((n, n))

    def generate_topology(self):
        adj = _ring_plus_random(self._n, self.neighbor_num, self.seed)
        self.topology = adj / adj.sum(axis=1, keepdims=True)
        return self.topology


class AsymmetricTopologyManager(BaseTopologyManager):
    """Symmetric base with randomly deleted directed links, row-normalized."""

    def __init__(self, n: int, undirected_neighbor_num: int = 3,
                 out_directed_neighbor: int = 2, seed: int = 0):
        self._n = n
        self.undirected_neighbor_num = undirected_neighbor_num
        self.out_directed_neighbor = out_directed_neighbor
        self.seed = seed
        self.topology = np.zeros((n, n))

    def generate_topology(self):
        adj = _ring_plus_random(self._n, self.undirected_neighbor_num, self.seed)
        rng = np.random.RandomState(self.seed + 1)
        n = self._n
        for i in range(n):
            # ring links (i±1) are never pruned: the directed graph stays
            # strongly connected, or PushSum's weights collapse onto a sink
            ring = {(i - 1) % n, (i + 1) % n}
            extra = [j for j in range(n) if j != i and adj[i, j] > 0 and j not in ring]
            rng.shuffle(extra)
            for j in extra[self.out_directed_neighbor:]:
                adj[i, j] = 0
        np.fill_diagonal(adj, 1)
        self.topology = adj / adj.sum(axis=1, keepdims=True)
        return self.topology


def ring_topology(n: int) -> np.ndarray:
    """Plain ring mixing matrix (1/3 self, 1/3 left, 1/3 right)."""
    w = np.zeros((n, n))
    for i in range(n):
        w[i, i] = w[i, (i - 1) % n] = w[i, (i + 1) % n] = 1.0
    return w / w.sum(axis=1, keepdims=True)
