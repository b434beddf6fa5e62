"""Expert parallelism: GShard-style mixture-of-experts FFN with
``all_to_all`` token dispatch over an ``ep`` mesh axis (port of
``fedml_tpu/parallel/expert.py``).

One expert's FFN weights live on each rank, tokens are data-sharded over
the same axis, and a pair of ``compat.all_to_all`` collectives routes
each token to its top-1 expert and back.  Shapes are static: each token
gets a position in its expert's queue from a one-hot cumsum, and tokens
past ``capacity`` are dropped (GShard's semantics: the combine weight is
zero, so a dropped token contributes its residual path only).

Dispatch and combine are einsums over one-hot masks, as JAX's; the
experts' FFN is a plain product (JAX computes it outside any Pallas
kernel).  Differentiable end to end: the gate (replicated, JAX's
``P()``: its gradient is the psum of the ranks'), each rank's expert
weights and its tokens.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from fedml_tpu_torch.core import rng
from fedml_tpu_torch.parallel.compat import all_to_all, replicated_in, shard_map
from fedml_tpu_torch.parallel.layout import Shard, shard_leaf
from fedml_tpu_torch.parallel.spmd import make_1d_mesh
from fedml_tpu_torch.utils.device import DeviceLike, resolve_device

PyTree = Any


def make_ep_mesh(n_devices: Optional[int] = None, axis: str = "ep", *,
                 device: DeviceLike = None):
    return make_1d_mesh(n_devices, axis, device=device)


def init_moe_params(key, num_experts: int, d_model: int, d_hidden: int,
                    device: DeviceLike = None) -> PyTree:
    """Per-expert FFN weights stacked on a leading experts axis, and the
    gate: JAX's draws from the same threefry key, bit for bit."""
    dev = resolve_device(device)
    k1, k2, k3 = rng.split(key, 3)
    # JAX multiplies float32 draws by the float64 scales rounded to float32
    scale_in = float(np.float32(1.0 / np.sqrt(d_model)))
    scale_out = float(np.float32(1.0 / np.sqrt(d_hidden)))
    return {
        "gate": rng.normal(k3, (d_model, num_experts), dev) * scale_in,
        "w_in": rng.normal(k1, (num_experts, d_model, d_hidden), dev) * scale_in,
        "w_out": rng.normal(k2, (num_experts, d_hidden, d_model), dev) * scale_out,
    }


def shard_moe_params(mesh, params: PyTree, axis: str = "ep") -> PyTree:
    """This rank's ``Shard``s: one expert's ``w_in``/``w_out`` (``P(axis)``),
    the gate replicated."""
    return {"gate": shard_leaf(mesh, params["gate"], ()),
            "w_in": shard_leaf(mesh, params["w_in"], (axis,)),
            "w_out": shard_leaf(mesh, params["w_out"], (axis,))}


def _expert_ffn(w_in, w_out, x):
    return torch.relu(x @ w_in) @ w_out


def _one_hot(idx, n: int, dtype):
    """``jax.nn.one_hot``: an index outside ``[0, n)`` is a row of zeros."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _gating(x, gate, num_experts: int):
    """Top-1 routing of tokens ``x`` [t, d]: each token's expert, its gate
    probability, the expert one-hot [t, E] and its queue position."""
    logits = x @ gate
    probs = torch.softmax(logits, dim=-1)
    expert = torch.argmax(logits, dim=-1)
    g = torch.take_along_dim(probs, expert[:, None], dim=1)[:, 0]
    onehot_e = _one_hot(expert, num_experts, x.dtype)
    # queue position of each token within its expert (local queue)
    pos = ((torch.cumsum(onehot_e, dim=0) - onehot_e) * onehot_e).sum(dim=1)
    return expert, g, onehot_e, pos


def make_moe_ffn(mesh, capacity: int, axis: str = "ep"):
    """Build ``apply(params, x)`` for a top-1 MoE FFN.

    - ``params`` from ``init_moe_params`` with num_experts == the axis
      size, laid out by ``shard_moe_params``: this rank's ``Shard``s.
    - ``x``: [T, d_model] tokens sharded over ``axis`` on dim 0 (T
      divisible by the axis size): this rank's ``Shard`` of spec
      ``(axis,)``, or the whole tensor, of which the rank takes its rows.
    Returns this rank's ``Shard`` of the [T, d_model] output, laid out as
    ``x``: gate_prob · FFN_{top1}(token), zeros for capacity-dropped tokens
    (callers add the residual).
    """
    E = mesh.size(mesh.mesh_dim_names.index(axis))

    def local(params, x):
        w_in, w_out = params["w_in"].block[0], params["w_out"].block[0]
        gate = replicated_in(params["gate"].block, axis)
        _, g, onehot_e, pos = _gating(x, gate, E)
        keep = (pos < capacity).to(x.dtype)
        # a token's slot in its expert's queue; ``keep`` alone decides the
        # drops (JAX's one-hot of a position past the queue is a zero row
        # as well: the two agree)
        onehot_c = _one_hot(pos.clamp(max=capacity - 1).to(torch.int32), capacity, x.dtype)
        # dispatch mask [t, E, capacity]
        dispatch = onehot_e[:, :, None] * onehot_c[:, None, :] * keep[:, None, None]
        expert_in = torch.einsum("tec,td->ecd", dispatch, x)  # [E, cap, d]
        # route: each rank sends slot e to rank e and receives [E, cap, d]
        # whose dim 0 is now the SOURCE rank
        routed = all_to_all(expert_in, axis, split_axis=0, concat_axis=0, tiled=True)
        expert_out = _expert_ffn(w_in, w_out, routed.reshape(E * capacity, -1))
        expert_out = expert_out.reshape(E, capacity, -1)
        # route back: slot s returns to source rank s
        returned = all_to_all(expert_out, axis, split_axis=0, concat_axis=0, tiled=True)
        out = torch.einsum("tec,ecd->td", dispatch, returned)
        return out * g[:, None]

    sharded = shard_map(local, mesh=mesh)

    def apply(params, x):
        n_experts = params["w_in"].shape[0]
        if n_experts != E:
            # a rank would hold several experts of which only one runs, and
            # the gate would route tokens to experts that never execute:
            # wrong results, no error
            raise ValueError(
                f"params have {n_experts} experts but ep mesh size is {E}; "
                "one expert per device is required"
            )
        T = x.shape[0]
        if T % E:
            raise ValueError(f"token count {T} not divisible by ep={E}")
        lo = mesh.get_local_rank(axis) * (T // E)
        out = sharded(params, x.block if isinstance(x, Shard) else x[lo:lo + T // E])
        return Shard(out, (T, out.shape[1]), ((lo, lo + T // E), (0, out.shape[1])),
                     (axis,))

    return apply


def moe_reference(params: PyTree, x: torch.Tensor) -> torch.Tensor:
    """Serial oracle (no capacity drops): gate_prob · FFN_{top1}(token),
    each expert's FFN over the tokens routed to it."""
    expert, g, _, _ = _gating(x, params["gate"], params["w_in"].shape[0])
    out = torch.zeros_like(x)
    for e in range(params["w_in"].shape[0]):
        rows = (expert == e).nonzero()[:, 0]
        if rows.numel():
            out = out.index_copy(0, rows, _expert_ffn(params["w_in"][e], params["w_out"][e],
                                                      x[rows]) * g[rows, None])
    return out
