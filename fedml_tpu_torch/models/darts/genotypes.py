"""Genotype container + parse (a numpy copy of
``fedml_tpu/models/darts/genotypes.py``; reference ``darts/genotypes.py`` and
``model_search.py:258-297``)."""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np

from fedml_tpu_torch.models.darts.ops import PRIMITIVES


class Genotype(NamedTuple):
    normal: List[Tuple[str, int]]
    normal_concat: Sequence[int]
    reduce: List[Tuple[str, int]]
    reduce_concat: Sequence[int]


# the published DARTS-v2 CIFAR cell (reference genotypes.py DARTS_V2)
DARTS_V2 = Genotype(
    normal=[("sep_conv_3x3", 0), ("sep_conv_3x3", 1), ("sep_conv_3x3", 0),
            ("sep_conv_3x3", 1), ("sep_conv_3x3", 1), ("skip_connect", 0),
            ("skip_connect", 0), ("dil_conv_3x3", 2)],
    normal_concat=[2, 3, 4, 5],
    reduce=[("max_pool_3x3", 0), ("max_pool_3x3", 1), ("skip_connect", 2),
            ("max_pool_3x3", 1), ("max_pool_3x3", 0), ("skip_connect", 2),
            ("skip_connect", 2), ("max_pool_3x3", 1)],
    reduce_concat=[2, 3, 4, 5],
)


def parse_alphas(alphas: np.ndarray, steps: int = 4) -> List[Tuple[str, int]]:
    """Derive the discrete cell from softmaxed alphas [n_edges, n_ops].

    Reference ``model_search.py:263-291``: per node, keep the 2 incoming
    edges with the strongest non-'none' weight; per kept edge, the
    strongest non-'none' op.
    """
    none_idx = PRIMITIVES.index("none")
    gene = []
    offset = 0
    for i in range(steps):
        n_in = 2 + i
        w = np.asarray(alphas[offset : offset + n_in])
        edge_strength = np.max(
            np.delete(w, none_idx, axis=1), axis=1
        )
        edges = np.argsort(-edge_strength)[:2]
        for j in sorted(edges):
            ops = w[j].copy()
            ops[none_idx] = -np.inf
            gene.append((PRIMITIVES[int(np.argmax(ops))], int(j)))
        offset += n_in
    return gene


def genotype_from_alphas(
    alphas_normal: np.ndarray, alphas_reduce: np.ndarray, steps: int = 4,
    multiplier: int = 4,
) -> Genotype:
    def softmax(a):
        e = np.exp(a - a.max(axis=-1, keepdims=True))
        return e / e.sum(axis=-1, keepdims=True)

    concat = list(range(2 + steps - multiplier, steps + 2))
    return Genotype(
        normal=parse_alphas(softmax(np.asarray(alphas_normal)), steps),
        normal_concat=concat,
        reduce=parse_alphas(softmax(np.asarray(alphas_reduce)), steps),
        reduce_concat=concat,
    )
