"""Sharded leaves: a leaf laid out over a mesh of ranks by a spec (the
port's counterpart of a ``jax.Array`` with a ``NamedSharding``).

A spec is a ``PartitionSpec`` as a plain tuple (``(None, "mp")``): entry
``d`` names the mesh axis that dimension ``d`` splits over (or a tuple of
axes, split row-major), or is None; entries past the tuple's end are None,
and ``()`` replicates.  JAX holds one logical array whose blocks live on
the devices; here each mesh position is a rank that holds only its block,
so a laid-out leaf is a ``Shard``: the rank's block, the leaf's global
shape, the block's index (``(lo, hi)`` per dimension) and the spec.  Every
tensor of a laid-out tree is a ``Shard``, a replicated one included (its
block is the whole leaf), so the layout of any leaf reads as ``.spec``, as
JAX's reads as ``.sharding.spec``.  A ``Placement`` is the port's
``NamedSharding``: a spec on a mesh, before there is a leaf.

Nothing here pads: a dimension that its axes do not divide raises.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from fedml_tpu_torch.parallel.compat import _AllGather, _gather_leaf, current_mesh, mesh_device

Index = Tuple[Tuple[int, int], ...]


class Shard(NamedTuple):
    block: Any            # this rank's block (a tensor on its device)
    shape: Tuple[int, ...]  # the global shape
    index: Index          # where the block sits in the global leaf
    spec: Tuple           # the PartitionSpec as a tuple


class Placement(NamedTuple):
    mesh: Any
    spec: Tuple


def axis_sizes(mesh) -> Dict[str, int]:
    return {name: int(mesh.size(i)) for i, name in enumerate(mesh.mesh_dim_names)}


def mesh_coords(mesh) -> Dict[str, int]:
    """This rank's coordinate along every axis of ``mesh``."""
    return {name: int(mesh.get_local_rank(name)) for name in mesh.mesh_dim_names}


def entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec) -> Tuple[str, ...]:
    """Every mesh axis a spec names."""
    return tuple(a for entry in spec for a in entry_axes(entry))


def is_sharded(spec) -> bool:
    return bool(spec_axes(spec))


def check_divisible(leaves, sizes: Dict[str, int],
                    message: Optional[Callable[..., str]] = None) -> None:
    """Refuse a layout whose mesh axes do not divide a leaf: ``leaves`` are
    ``(name, shape, spec)`` in the order to check.  The first dimension
    that its axes do not divide raises ``ValueError(message(name, shape,
    spec, dim, entry, factor))`` (by default the partition engine's text,
    JAX's); a spec longer than its leaf, or naming an axis ``sizes`` lacks,
    raises too.  Nothing pads."""
    message = message or _not_divisible
    for name, shape, spec in leaves:
        shape = tuple(int(n) for n in shape)
        where = f"leaf {name!r}: " if name is not None else ""
        if len(spec) > len(shape):
            raise ValueError(f"{where}{len(spec)}-dim spec {tuple(spec)} for a "
                             f"{len(shape)}-dim leaf")
        for d, entry in enumerate(spec):
            factor = 1
            for a in entry_axes(entry):
                if a not in sizes:
                    raise ValueError(f"{where}spec names mesh axis {a!r}, mesh has "
                                     f"{sorted(sizes)}")
                factor *= int(sizes[a])
            if shape[d] % factor:
                raise ValueError(message(name, shape, tuple(spec), d, entry, factor))


def _not_divisible(name, shape, spec, d, entry, factor) -> str:
    where = f"leaf {name!r}: " if name is not None else ""
    return (f"{where}dim {d} of shape {shape} not divisible by mesh axes "
            f"{entry_axes(entry)} (size {factor})")


def block_index(shape, spec, sizes: Dict[str, int], coords: Dict[str, int]) -> Index:
    """The ``(lo, hi)`` bounds, per dimension, of the block that mesh
    position ``coords`` holds of a ``shape`` leaf under ``spec``."""
    shape = tuple(int(n) for n in shape)
    check_divisible([(None, shape, spec)], sizes)
    out = []
    for d, n in enumerate(shape):
        factor, pos = 1, 0
        for a in entry_axes(spec[d] if d < len(spec) else None):
            factor, pos = factor * sizes[a], pos * sizes[a] + coords[a]
        out.append((pos * (n // factor), (pos + 1) * (n // factor)))
    return tuple(out)


def all_block_indices(shape, spec, sizes: Dict[str, int]) -> List[Index]:
    """Every distinct block of a ``shape`` leaf under ``spec`` over the
    mesh, sorted by slice start (JAX's shard order)."""
    names = list(sizes)
    grid = np.indices([sizes[a] for a in names]).reshape(len(names), -1).T
    return sorted({block_index(shape, spec, sizes, dict(zip(names, map(int, c))))
                   for c in grid})


def owns_block(spec, coords: Dict[str, int]) -> bool:
    """Whether this position is the one of a block's holders that speaks
    for it: coordinate 0 along every axis the spec does not name (the
    lowest ``dp`` index for a leaf replicated over ``dp``)."""
    used = set(spec_axes(spec))
    return all(c == 0 for a, c in coords.items() if a not in used)


def shard_slice(leaf, spec, sizes: Dict[str, int], coords: Dict[str, int]):
    """Mesh position ``coords``'s slice of a full ``leaf`` (a tensor or a
    numpy array) under ``spec``: what that position holds, as JAX's array
    holds it in the ``addressable_shards`` entry of that device."""
    index = block_index(tuple(leaf.shape), spec, sizes, coords)
    return leaf[tuple(slice(lo, hi) for lo, hi in index)]


def shard_leaf(mesh, leaf, spec) -> Shard:
    """This rank's ``Shard`` of a full leaf under ``spec``, on its device."""
    sizes, coords = axis_sizes(mesh), mesh_coords(mesh)
    full = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(np.asarray(leaf))
    block = shard_slice(full, spec, sizes, coords)
    return Shard(block.to(mesh_device(mesh)).clone().contiguous(),
                 tuple(int(n) for n in full.shape),
                 block_index(tuple(full.shape), spec, sizes, coords), tuple(spec))


def zeros_placed(placement: Placement, shape, dtype=torch.float32) -> Shard:
    """This rank's ``Shard`` of an all-zero ``shape`` leaf under
    ``placement``: only the block is made, never the whole leaf."""
    mesh, spec = placement.mesh, tuple(placement.spec)
    index = block_index(shape, spec, axis_sizes(mesh), mesh_coords(mesh))
    block = torch.zeros([hi - lo for lo, hi in index], dtype=dtype, device=mesh_device(mesh))
    return Shard(block, tuple(int(n) for n in shape), index, spec)


def _is_leaf(x) -> bool:
    return isinstance(x, (Shard, Placement)) or not isinstance(x, (dict, list, tuple))


def map_tree(fn: Callable, tree, *rest):
    """``fn`` over the leaves of trees of identical structure (dicts,
    lists, tuples, named tuples; a ``Shard`` or ``Placement`` is a leaf)."""
    if _is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    items = [map_tree(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    if hasattr(tree, "_fields"):
        return type(tree)(*items)
    return type(tree)(items)


def place(tree, placements):
    """Lay a tree of full leaves out by a tree of ``Placement``s of the same
    structure (or one ``Placement`` for every leaf): each tensor or numpy
    leaf becomes this rank's ``Shard``; a ``Shard`` already laid out so,
    and anything else, stays as it is."""
    if isinstance(placements, Placement):
        return map_tree(lambda leaf: _place_leaf(leaf, placements), tree)
    return map_tree(_place_leaf, tree, placements)


def _place_leaf(leaf, placement: Placement):
    if isinstance(leaf, (torch.Tensor, np.ndarray)):
        return shard_leaf(placement.mesh, leaf, placement.spec)
    if isinstance(leaf, Shard) and leaf.spec != tuple(placement.spec):
        raise ValueError(f"a leaf laid out as {leaf.spec} was given the placement "
                         f"{tuple(placement.spec)}")
    return leaf


def blocks(tree):
    """The tree with each ``Shard`` replaced by its block."""
    return map_tree(lambda x: x.block if isinstance(x, Shard) else x, tree)


def specs_of(tree):
    """The tree of the ``Shard``s' specs."""
    return map_tree(lambda x: x.spec if isinstance(x, Shard) else (), tree)


def rewrap(new_blocks, like):
    """Blocks back into ``Shard``s laid out as ``like``'s."""
    return map_tree(lambda b, ref: ref._replace(block=b) if isinstance(ref, Shard) else b,
                    new_blocks, like)


class _GatherKeep(torch.autograd.Function):
    """``all_gather`` along a dimension whose backward keeps this rank's
    chunk of the cotangent (no sum): for a gather whose every rank goes on
    to compute the same function of the same whole leaf, so that each
    rank's cotangent already is the whole gradient."""

    @staticmethod
    def forward(ctx, mesh, axis_name, dim, leaf):
        ctx.chunk = (dim, int(mesh.get_local_rank(axis_name)), leaf.shape[dim])
        return _gather_leaf(mesh, leaf, axis_name, dim, True)

    @staticmethod
    def backward(ctx, grad):
        dim, i, n = ctx.chunk
        return None, None, None, grad.narrow(dim, i * n, n)


def unshard(block, spec, *, backward: str = "psum_scatter"):
    """The whole leaf from this rank's ``block`` under ``spec``, gathered
    over the bound mesh.  Under autograd its backward is, per gathered
    axis, ``"psum_scatter"`` (JAX's transpose of ``all_gather``: the
    cotangents are summed over the axis) or ``"keep"`` (this rank's chunk
    of its own cotangent, ``_GatherKeep``)."""
    if backward not in ("psum_scatter", "keep"):
        raise ValueError(f"backward must be 'psum_scatter' or 'keep', got {backward!r}")
    mesh = current_mesh()
    grad = torch.is_grad_enabled() and block.requires_grad
    for d, entry in enumerate(spec):
        # a tuple of axes splits row-major: the last axis is the innermost
        for a in reversed(entry_axes(entry)):
            if not grad:
                block = _gather_leaf(mesh, block, a, d, True)
            elif backward == "keep":
                block = _GatherKeep.apply(mesh, a, d, block)
            else:
                block = _AllGather.apply(mesh, a, d, True, block)
    return block


def unshard_tree(tree):
    """A tree of ``Shard``s as whole leaves (no autograd), over the bound
    mesh; other leaves as they are."""
    with torch.no_grad():
        return map_tree(lambda x: unshard(x.block, x.spec) if isinstance(x, Shard) else x,
                        tree)
