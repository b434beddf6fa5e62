"""Variable-tree helpers over dictionaries of tensors.

Counterpart of ``fedml_tpu/core/tree.py``.  A model's variables are
``{"params": {name: Tensor}, "batch_stats": {name: Tensor}}``: one level
of collections, each a flat ``dict[str, Tensor]`` keyed by the module's
state names.  ``tree_map`` walks any such nesting of dicts.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

Tree = Any  # a Tensor, or a dict of Trees


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """Apply ``fn`` leaf-wise over trees of identical structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_sub(a: Tree, b: Tree) -> Tree:
    return tree_map(torch.sub, a, b)


def tree_sq_norm(tree: Tree) -> torch.Tensor:
    """Sum of squares of every leaf, in fp32."""
    return sum(leaf.float().square().sum() for leaf in tree_leaves(tree))


def tree_cast_floats(tree: Tree, dtype: torch.dtype) -> Tree:
    """Cast floating-point leaves only (mixed-precision compute casts;
    integer leaves pass through)."""
    return tree_map(
        lambda x: x.to(dtype) if x.is_floating_point() else x, tree)


def tree_cast_like(tree: Tree, ref: Tree) -> Tree:
    """Cast each leaf of ``tree`` to the dtype of the same leaf in ``ref``
    (restores master dtypes after a low-precision forward pass)."""
    return tree_map(lambda x, r: x.to(r.dtype), tree, ref)


def tree_fold_weighted(acc: Optional[Tree], tree: Tree, w) -> Tree:
    """One step of an fp32 weighted sum: ``acc + w * tree`` leaf-wise
    (``acc=None`` starts a new sum).  FedAvg's aggregation folds each
    client in as it finishes, so K client models are never held at once."""
    if acc is None:
        return tree_map(lambda x: w * x.float(), tree)
    return tree_map(lambda a, x: a + w * x.float(), acc, tree)


def tree_detach(tree: Tree) -> Tree:
    return tree_map(torch.Tensor.detach, tree)
