"""Pipeline parallelism: GPipe-style microbatched stage pipeline over a
``pp`` mesh axis (port of ``fedml_tpu/parallel/pipeline.py``).

Each rank of the axis owns one stage's parameters; activations hop stage
→ stage + 1 over the ring with ``compat.ppermute`` and microbatches keep
every stage busy outside the fill/drain bubble.  The schedule is JAX's
masked-tick loop: at tick t, stage s computes microbatch (t − s), for
``M + S − 1`` ticks, and the last stage's outputs are psum-broadcast to
every rank.  Like JAX's, every stage computes on every tick, the bubble
ticks included (on the zeros or stale activations it holds then), and
the bubble results are masked away: the masks are ``torch.where``s on a
0-dim condition, so every rank builds the same autograd graph, and every
rank makes every tick's ring hop, forward and backward.

Differentiable end to end: ``ppermute``'s backward is the reverse
permute and ``psum``'s is the psum of the cotangents, so autograd through
``apply`` on every rank yields each rank's stage gradients — pipeline-
parallel training, not just inference.  The output is replicated over the
axis (JAX's ``out_specs=P()``): each rank's loss reads the whole of it.
JAX's ``shard_map`` (``check_vma=False``) transposes such an output by
dividing its one cotangent by the axis size and the psum by psumming the
shares back, which gives every rank the whole cotangent.  The port's
boundary, ``compat.replicated_out``, passes each rank's cotangent through
unchanged: where every rank's loss reads the output alike, the only case
in which the stage gradients mean anything, that is the same cotangent,
and the backward sends nothing for it.  A microbatch input that takes
gradients (JAX's replicated ``in_specs=P()``) gets the psum of the ranks'
cotangents (``compat.replicated_in``).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from fedml_tpu_torch.parallel.compat import (axis_index, ppermute, replicated_in,
                                             replicated_out, shard_map)
from fedml_tpu_torch.parallel.layout import map_tree, shard_leaf
from fedml_tpu_torch.parallel.spmd import make_1d_mesh
from fedml_tpu_torch.utils.device import DeviceLike

PyTree = Any

# stage_fn(stage_params, x[B, ...]) -> y[B, ...]  (same activation shape
# across stage boundaries, as in equal-depth transformer stages)
StageFn = Callable[[PyTree, torch.Tensor], torch.Tensor]


def make_pp_mesh(n_devices: Optional[int] = None, axis: str = "pp", *,
                 device: DeviceLike = None):
    return make_1d_mesh(n_devices, axis, device=device)


def _leaves(tree) -> list:
    out: list = []
    map_tree(out.append, tree)
    return out


def stack_stage_params(stage_params_list) -> PyTree:
    """Stack S per-stage parameter trees along a new leading axis (the axis
    ``shard_stage_params`` lays out one stage per rank)."""
    return map_tree(lambda *xs: torch.stack(xs), *stage_params_list)


def shard_stage_params(mesh, stacked: PyTree, axis: str = "pp") -> PyTree:
    """This rank's ``Shard``s of the stacked parameters laid out on ``axis``
    (JAX's ``P(axis)``): a block of one stage, ``[1, ...]``."""
    return map_tree(lambda v: shard_leaf(mesh, v, (axis,)), stacked)


def make_gpipe(mesh, stage_fn: StageFn, axis: str = "pp"):
    """Build ``apply(stacked_stage_params, x_microbatches)``.

    - ``stacked_stage_params``: leaves ``[S, ...]`` laid out one stage per
      rank: this rank's ``Shard``s from ``shard_stage_params``.
    - ``x_microbatches``: ``[M, B, ...]``, the same on every rank; M
      microbatches.
    Returns y ``[M, B, ...]`` on every rank, equal to running the S stages
    sequentially over each microbatch.  A stacked stage count other than
    the axis size raises ``ValueError``.
    """
    S = mesh.size(mesh.mesh_dim_names.index(axis))

    def local(params, x):
        sid = axis_index(axis)
        p = map_tree(lambda a: a.block[0], params)
        x = replicated_in(x, axis)
        M = x.shape[0]
        first = torch.tensor(sid == 0, device=x.device)
        perm = [(i, (i + 1) % S) for i in range(S)]
        recv = torch.zeros_like(x[0])
        outs = [torch.zeros_like(x[0]) for _ in range(M)]
        for t in range(M + S - 1):
            # stage 0 injects fresh microbatch t; the others consume what
            # stage s - 1 computed last tick
            inp = torch.where(first, x[min(t, M - 1)], recv)
            y = stage_fn(p, inp)
            recv = ppermute(y, axis, perm)
            # the last stage emits microbatch t - (S - 1) once it is valid
            oi = t - (S - 1)
            valid = torch.tensor(sid == S - 1 and oi >= 0, device=x.device)
            oi = min(max(oi, 0), M - 1)
            outs[oi] = torch.where(valid, y, outs[oi])
        out = torch.stack(outs)
        last = torch.tensor(sid == S - 1, device=x.device)
        # outputs live on the last stage only; psum-broadcast to all
        return replicated_out(torch.where(last, out, torch.zeros_like(out)), axis)

    sharded = shard_map(local, mesh=mesh)

    def apply(stacked_stage_params, x_microbatches):
        leaf = _leaves(stacked_stage_params)[0]
        n_stages = leaf.shape[0]
        if n_stages != S:
            # a rank would hold several stages of which only one runs:
            # wrong results, no error
            raise ValueError(
                f"stacked stage count {n_stages} != pp mesh size {S}; "
                "one stage per device is required"
            )
        return sharded(stacked_stage_params, x_microbatches)

    return apply


def serial_reference(stage_fn: StageFn, stacked: PyTree, x: torch.Tensor):
    """Run the same stages sequentially over each microbatch (the
    correctness oracle); ``stacked`` holds whole stacked tensors."""
    S = _leaves(stacked)[0].shape[0]

    def one_mb(xb):
        h = xb
        for s in range(S):
            h = stage_fn(map_tree(lambda a: a[s], stacked), h)
        return h

    return torch.stack([one_mb(xb) for xb in x])
