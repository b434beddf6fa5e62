"""Variable-tree helpers over dictionaries of tensors.

Counterpart of ``fedml_tpu/core/tree.py``.  A model's variables are
``{"params": {name: Tensor}, "batch_stats": {name: Tensor}}``: one level
of collections, each a flat ``dict[str, Tensor]`` keyed by the module's
state names.  ``tree_map`` walks any such nesting of dicts.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Callable, Iterable, Optional

import numpy as np
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


def tree_zeros_like(tree: Tree) -> Tree:
    return tree_map(torch.zeros_like, tree)


def tree_add(a: Tree, b: Tree) -> Tree:
    return tree_map(torch.add, a, b)


def tree_sub(a: Tree, b: Tree) -> Tree:
    return tree_map(torch.sub, a, b)


def tree_scale(tree: Tree, s) -> Tree:
    return tree_map(lambda x: x * s, tree)


def tree_weighted_sum(trees, weights) -> Tree:
    """``sum_i w_i * tree_i``, folded left to right as the JAX package
    folds it (hierarchical FedAvg's group tier)."""
    acc = tree_scale(trees[0], weights[0])
    for t, w in zip(trees[1:], weights[1:]):
        acc = tree_map(lambda a, x, w=w: a + x * w, acc, t)
    return acc


def tree_sq_norm(tree: Tree) -> torch.Tensor:
    """Sum of squares of every leaf, in fp32."""
    return sum(leaf.float().square().sum() for leaf in tree_leaves(tree))


_SHARDED: contextvars.ContextVar = contextvars.ContextVar("fedml_tpu_torch_sharded_leaves",
                                                          default=None)


@contextlib.contextmanager
def sharded_leaves(names: Iterable[str], reduce: Callable):
    """Inside the block, ``global_sq_norm`` reads the leaves under
    ``names`` as this rank's blocks of leaves split over a mesh axis, and
    ``reduce`` (the sum over that axis) completes their partial sums: the
    tensor- and rule-parallel engines bind it around the local and server
    updates (``parallel/{tensor,partition}.py``).  With no names it binds
    nothing."""
    names = frozenset(names)
    token = _SHARDED.set((names, reduce) if names else None)
    try:
        yield
    finally:
        _SHARDED.reset(token)


def global_sq_norm(tree: Tree) -> torch.Tensor:
    """``tree_sq_norm`` of the whole model whose leaves ``tree`` holds:
    under ``sharded_leaves`` a flat ``{name: Tensor}`` tree's sharded
    leaves' squares are summed here and reduced over their axis, and the
    replicated leaves' added once (the global-norm clip and FedProx's
    proximal term read it)."""
    sharded = _SHARDED.get()
    if sharded is None:
        return tree_sq_norm(tree)
    names, reduce = sharded
    part = [leaf.float().square().sum() for k, leaf in tree.items() if k in names]
    whole = [leaf.float().square().sum() for k, leaf in tree.items() if k not in names]
    total = reduce(sum(part)) if part else 0.0
    return total + sum(whole) if whole else total


def tree_norm(tree: Tree) -> torch.Tensor:
    """The global L2 norm of every leaf, in fp32 (optax's ``global_norm``)."""
    return torch.sqrt(tree_sq_norm(tree))


def tree_cast_floats(tree: Tree, dtype: torch.dtype) -> Tree:
    """Cast floating-point leaves only (mixed-precision compute casts;
    integer leaves pass through)."""
    return tree_map(
        lambda x: x.to(dtype) if x.is_floating_point() else x, tree)


def tree_cast_like(tree: Tree, ref: Tree) -> Tree:
    """Cast each leaf of ``tree`` to the dtype of the same leaf in ``ref``
    (restores master dtypes after a low-precision forward pass)."""
    return tree_map(lambda x, r: x.to(r.dtype), tree, ref)


def tree_fold_weighted_f32(acc: Optional[Tree], tree: Tree, w) -> Tree:
    """One step of an fp32 weighted sum on the tensors' device:
    ``acc + w * tree`` leaf-wise (``acc=None`` starts a new sum).  The
    simulation engine's aggregation folds each client in as it finishes,
    so K client models are never held at once.  (The cross-device
    server's fold is the float64 host pair below.)"""
    if acc is None:
        return tree_map(lambda x: w * x.float(), tree)
    return tree_map(lambda a, x: a + w * x.float(), acc, tree)


def host_array(x) -> np.ndarray:
    """A leaf as a host numpy array; a bfloat16 tensor as float32 (exact)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(x)


def cast_host_like(x: np.ndarray, like):
    """``x`` cast to the dtype of the template leaf ``like``: numpy for a
    numpy template, a tensor on its device for a tensor template."""
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(x)).to(
            device=like.device, dtype=like.dtype)
    return x.astype(np.asarray(like).dtype)


def tree_fold_weighted(acc: Optional[Tree], tree: Tree, w) -> Tree:
    """One step of a streaming weighted sum, ``acc + w * tree`` per leaf,
    accumulated on the host in numpy float64 (``acc=None`` starts a new
    accumulator), as ``fedml_tpu/core/tree.py`` folds it.  This is the
    cross-device server's O(model)-memory aggregation: uploads fold in as
    they arrive instead of being buffered until the round closes.  Numpy
    on purpose: the fold runs under the server's round lock, and a host
    memcpy-bound add must not pay a device dispatch."""
    w64 = np.float64(w)
    if acc is None:
        return tree_map(lambda x: w64 * np.asarray(host_array(x), np.float64), tree)
    return tree_map(lambda a, x: a + w64 * np.asarray(host_array(x), np.float64),
                    acc, tree)


def tree_finalize_weighted_mean(acc: Tree, total, like: Tree) -> Tree:
    """Close a ``tree_fold_weighted`` accumulator: ``acc / total`` in
    float64, cast back to each leaf dtype of ``like`` (the model
    template)."""
    t64 = np.float64(total)
    return tree_map(lambda a, l: cast_host_like(a / t64, l), acc, like)


def tree_weighted_mean(trees, weights) -> Tree:
    """Buffered form of the streaming pair above: fold every tree with its
    raw weight, then normalize by ``sum(weights)`` — the same ops in the
    same order, so a streaming server is bit-identical to this."""
    acc = None
    for t, w in zip(trees, weights):
        acc = tree_fold_weighted(acc, t, w)
    return tree_finalize_weighted_mean(acc, sum(float(w) for w in weights),
                                       trees[0])


def tree_vdot(a: Tree, b: Tree) -> torch.Tensor:
    """``sum_leaves <a, b>`` in fp32, the leaves summed in JAX's leaf
    order (``compress.codecs.jax_leaves``)."""
    from fedml_tpu_torch.compress.codecs import jax_leaves

    dots = tree_map(lambda x, y: torch.dot(x.float().reshape(-1),
                                           y.float().reshape(-1)), a, b)
    total = None
    for _, d in jax_leaves(dots):
        total = d if total is None else total + d
    return total


def tree_cast(tree: Tree, dtype: torch.dtype) -> Tree:
    """Cast every leaf to ``dtype``."""
    return tree_map(lambda x: x.to(dtype), tree)


def tree_detach(tree: Tree) -> Tree:
    return tree_map(torch.Tensor.detach, tree)


def tree_size(tree: Tree) -> int:
    """The number of elements over every leaf (tensors or arrays)."""
    return sum(int(np.prod(np.shape(x))) for x in tree_leaves(tree))


def tree_ravel(tree: Tree) -> torch.Tensor:
    """Every leaf cast to float32 and flattened into one vector, in
    ``tree_leaves`` order: the dict order (collection, then the module's
    state names in creation order), not flax's sorted path order.  Whole
    per-element operations (the secure aggregate) do not depend on the
    order; which element a random share lands on does."""
    return torch.cat([leaf.reshape(-1).float() for leaf in tree_leaves(tree)])


def tree_unravel(tree_like: Tree, vec: torch.Tensor) -> Tree:
    """Inverse of ``tree_ravel``: slices of ``vec`` in the same leaf order,
    reshaped and cast back to each leaf's dtype."""
    off = 0

    def take(leaf):
        nonlocal off
        n = leaf.numel()
        out = vec[off:off + n].reshape(leaf.shape).to(leaf.dtype)
        off += n
        return out

    return tree_map(take, tree_like)


def tree_stack(trees) -> Tree:
    """Stack identically-shaped trees along a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def tree_index(tree: Tree, i) -> Tree:
    """Slice ``i`` of the leading axis of every leaf."""
    return tree_map(lambda x: x[i], tree)
