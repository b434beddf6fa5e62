"""Per-shard wire encode: compress a laid-out update WITHOUT gathering it
(port of ``fedml_tpu/compress/sharded.py``).

The plain wire path (``codecs.wire_encode_tree``) flattens each leaf; for
a model laid out over a mesh of ranks (``parallel/partition.py``) that
flatten would be a gather.  Here each block is encoded where it lives:

- a leaf's shards are its distinct blocks over the mesh (replicas over
  ``dp`` are one shard), sorted by slice start, as JAX orders a leaf's
  ``addressable_shards``;
- shard ``j`` of leaf ``i`` (leaves in ``jax_leaves`` order) draws its
  codec randomness from ``fold_in(fold_in(key, i), j)``, so a shard's
  bytes are a single-device encode of that slice under the same key, and
  no two shards share a stream;
- each rank encodes only the shards it speaks for (``layout.owns_block``:
  the lowest ``dp`` index for a replicated one), then the entries are
  gathered over the mesh, so every rank returns the same list: JAX's.

A tensor or numpy leaf (not a ``Shard``) is one full-cover pseudo-shard,
encoded on every rank, so the encoder is total over both worlds.  Wire
format per leaf: ``{"shards": [{"enc", "index": [[lo, hi], ..], "shape"},
..], "shape", "dtype"}``, JAX's, decodable shard by shard into a zeros
canvas (``wire_decode_tree_sharded``).
"""

from __future__ import annotations

import hashlib
from typing import Any, List, Tuple

import numpy as np
import torch
import torch.distributed as dist

from fedml_tpu_torch.compress.codecs import (LeafCodec, _dtype_name, _leaf_keys, _to_numpy,
                                             _to_tensor, jax_leaves, unflatten_like)
from fedml_tpu_torch.core import rng as rnglib
from fedml_tpu_torch.parallel.compat import current_mesh
from fedml_tpu_torch.parallel.layout import (Shard, all_block_indices, axis_sizes,
                                             mesh_coords, owns_block)

PyTree = Any


def _norm_index(index, shape) -> Tuple[Tuple[int, int], ...]:
    """A shard's index (slices, possibly open, or ``(lo, hi)`` pairs) as
    concrete ``(lo, hi)`` bounds."""
    out = []
    for sl, n in zip(index, shape):
        if isinstance(sl, slice):
            lo = 0 if sl.start is None else int(sl.start)
            hi = int(n) if sl.stop is None else int(sl.stop)
        else:
            lo, hi = (int(v) for v in sl)
        out.append((lo, hi))
    return tuple(out)


def shard_slices(arr) -> List[Tuple[Tuple[Tuple[int, int], ...], Any]]:
    """``(bounds, data)`` of what this rank holds of one leaf: a ``Shard``'s
    block, or a tensor or numpy array as one full-cover pseudo-shard."""
    if isinstance(arr, Shard):
        return [(_norm_index(arr.index, arr.shape), arr.block)]
    return [(tuple((0, int(n)) for n in np.shape(arr)), arr)]


def _encode(codec: LeafCodec, data, bounds, key) -> dict:
    x = data if isinstance(data, torch.Tensor) else torch.from_numpy(np.asarray(data))
    enc = codec.encode(x, key)
    return {"enc": codec.wire_pack({name: _to_numpy(v) for name, v in enc.items()}),
            "index": [[lo, hi] for lo, hi in bounds],
            "shape": [hi - lo for lo, hi in bounds]}


def _gather_objects(mesh, items: list) -> list:
    """Every rank's ``items`` over the whole mesh, one axis at a time."""
    for name in mesh.mesh_dim_names:
        parts: list = [None] * int(mesh.size(mesh.mesh_dim_names.index(name)))
        dist.all_gather_object(parts, items, group=mesh.get_group(name))
        items = [x for part in parts for x in part]
    return items


def wire_encode_tree_sharded(codec: LeafCodec, tree: PyTree, key) -> List[dict]:
    """Per-leaf sharded wire entries.  Leaf ``i``'s shard ``j`` encodes
    under ``fold_in(fold_in(key, i), j)`` over the block that holds it: no
    gather of a leaf, and bytes pinned to the single-device encode of the
    same slice.  ``Shard`` leaves need their mesh bound (``use_mesh``);
    every rank of it calls this and gets the whole list."""
    leaves = [leaf for _, leaf in jax_leaves(tree)]
    out, mine, mesh = [], [], None
    for i, (leaf, k_leaf) in enumerate(zip(leaves, _leaf_keys(key, len(leaves)))):
        if isinstance(leaf, Shard):
            mesh = mesh or current_mesh()
            order = all_block_indices(leaf.shape, leaf.spec, axis_sizes(mesh))
            j = order.index(_norm_index(leaf.index, leaf.shape))
            if owns_block(leaf.spec, mesh_coords(mesh)):
                mine.append((i, j, _encode(codec, leaf.block, order[j],
                                           rnglib.fold_in(k_leaf, j))))
            shards, shape, dtype = [None] * len(order), leaf.shape, leaf.block
        else:
            (bounds, data), = shard_slices(leaf)
            shards = [_encode(codec, data, bounds, rnglib.fold_in(k_leaf, 0))]
            shape, dtype = np.shape(leaf), leaf
        out.append({"shards": shards, "shape": [int(n) for n in shape],
                    "dtype": (_dtype_name(dtype) if isinstance(dtype, torch.Tensor)
                              else str(np.asarray(dtype).dtype))})
    if mesh is not None:
        for i, j, entry in _gather_objects(mesh, mine):
            out[i]["shards"][j] = entry
    return out


def wire_decode_tree_sharded(codec: LeafCodec, entries: List[dict], like: PyTree) -> PyTree:
    """Decode sharded entries into whole fp32 leaves on the host (CPU
    tensors in ``like``'s structure): each shard decodes into its slice of
    a zeros canvas."""
    leaves_like = [leaf for _, leaf in jax_leaves(like)]
    assert len(entries) == len(leaves_like), "sharded wire/treedef leaf count mismatch"
    out = []
    for e, ref in zip(entries, leaves_like):
        shape = tuple(e.get("shape") or (ref.shape if isinstance(ref, Shard) else np.shape(ref)))
        canvas = torch.zeros(shape, dtype=torch.float32)
        for sh in e["shards"]:
            bounds = [tuple(b) for b in sh["index"]]
            sub_shape = tuple(hi - lo for lo, hi in bounds)
            enc = codec.wire_unpack({name: np.asarray(v) for name, v in sh["enc"].items()},
                                    sub_shape)
            dec = codec.decode({k: _to_tensor(v) for k, v in enc.items()}, sub_shape)
            canvas[tuple(slice(lo, hi) for lo, hi in bounds)] = dec.float().cpu()
        out.append(canvas)
    return unflatten_like(like, out)


def sharded_entry_nbytes(entry: dict) -> List[int]:
    """Wire payload bytes per shard of one leaf entry (buffers only)."""
    return [sum(int(np.asarray(v).nbytes) for v in sh["enc"].values())
            for sh in entry["shards"]]


def sharded_wire_digest(entries: List[dict]) -> str:
    """sha256 over every shard's payload buffers in (leaf, shard) order:
    the sharded sibling of ``codecs.wire_tree_digest``."""
    h = hashlib.sha256()
    for e in entries:
        for sh in e["shards"]:
            for name in sorted(sh["enc"]):
                h.update(np.ascontiguousarray(np.asarray(sh["enc"][name])).tobytes())
    return h.hexdigest()

