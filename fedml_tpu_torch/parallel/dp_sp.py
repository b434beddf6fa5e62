"""DP×SP federated rounds: long-context clients on a ``(clients, sp)`` mesh
(port of ``fedml_tpu/parallel/dp_sp.py``).

The FedAvg ``clients`` axis (one client row per mesh row, the masked
weighted psum of ``make_round_fn(axis_name="clients")``) composed with
sequence parallelism (each client's token sequences sharded over ``sp``,
attention the ring of ``parallel/ring_attention.py``): every client's local
update runs as an sp-way SPMD program, one rank per (client row, shard).

- The parameters are replicated over ``sp``; each shard's autograd covers
  its own tokens' paths through them, so the gradients are combined over
  ``sp`` ahead of the client optimizer (``pmean_gradients``): a MEAN,
  because the loss's ``psum`` transposes to ``psum`` (``compat.psum``'s
  backward), which already scales each shard's cotangent by the axis size.
  The replicas stay identical after every step.
- The loss is globally normalised: the masked sums are psum'd over ``sp``
  before the division (``make_sp_loss_fn``).
- Positions are shard-global (``TransformerLM``'s ``pos_offset_fn``).
- Each client's random stream is keyed by its slot, never by the shard:
  every sp rank of a client draws the same epoch shuffle.
"""

from __future__ import annotations

from typing import Optional

import torch

from fedml_tpu_torch.algorithms.fedavg import make_round_fn
from fedml_tpu_torch.core.client import Optimizer, Transform, make_local_update
from fedml_tpu_torch.core.losses import LossFn, masked_softmax_ce
from fedml_tpu_torch.models.transformer import transformer_lm
from fedml_tpu_torch.parallel.compat import axis_size, mesh_device, psum, use_mesh
from fedml_tpu_torch.parallel.mesh import named_mesh
from fedml_tpu_torch.parallel.sequence import sp_transformer_bundle
from fedml_tpu_torch.parallel.spmd import CLIENTS, shard_client_block
from fedml_tpu_torch.utils.device import DeviceLike

SP = "sp"


def make_dp_sp_mesh(n_clients_axis: int, n_sp: int, *, devices=None,
                    device: DeviceLike = None):
    """A ``(clients, sp)`` mesh over the first ``n_clients_axis * n_sp``
    ranks (of ``devices``, a list of ranks, or of the world)."""
    return named_mesh((n_clients_axis, n_sp), (CLIENTS, SP), devices=devices,
                      device=device)


def pmean_gradients(axis: str) -> Transform:
    """A gradient transform that averages the gradients over ``axis``,
    placed first in the client optimizer's chain.  A mean, not a sum: the
    psum'd loss's backward already hands every shard an axis-size-scaled
    cotangent, which the mean cancels (a psum here inflates the gradient
    uniformly by the axis size)."""

    def update(grads, state, params):
        del params
        n = axis_size(axis)
        return {k: g / n for k, g in psum(grads, axis).items()}, state

    return (lambda params: (), update)


def make_sp_loss_fn(axis: str, base: LossFn = masked_softmax_ce) -> LossFn:
    """A globally normalised loss over a sequence-sharded batch: the masked
    sums psum'd over ``axis``, divided once, so every shard's gradient
    carries its global weight and the metrics each shard reports are the
    full sequence's totals."""

    def loss_fn(logits, y, mask):
        _, aux = base(logits, y, mask)
        s, c, corr = psum((aux["loss_sum"], aux["count"], aux["correct"]), axis)
        return s / torch.clamp_min(c, 1.0), {"loss_sum": s, "correct": corr, "count": c}

    return loss_fn


def make_dp_sp_round_fn(
    mesh,
    *,
    vocab_size: int,
    embed_dim: int,
    num_heads: int,
    num_layers: int,
    max_len: int,
    optimizer: Optimizer,
    epochs: int = 1,
    compute_dtype: Optional[torch.dtype] = None,
    attn_impl: str = "lax",
    block_size: int = 512,
    flash_block: Optional[int] = None,
):
    """The DP×SP FedAvg round; returns ``(round_fn, shard_data, init_fn)``.

    ``round_fn(state, x, y, mask, num_samples, participation, slot_ids)``
    runs on every rank of ``mesh`` over the rank's block from
    ``shard_data``, and every rank ends with the same state.
    ``shard_data(arrays)`` takes the global ``(x, y, mask, num_samples,
    participation, slot_ids)`` (x/y ``[C, steps, B, L]`` with L divisible by
    the ``sp`` axis, mask ``[C, steps, B]`` per sequence) and returns this
    rank's block on its device: its client rows, and its shard of L for x
    and y; the masks, sample counts, participation and slot ids are the
    clients' whole.  ``init_fn(rng)`` draws the plain full-length module's
    variables (the same tree)."""
    device = mesh_device(mesh)
    bundle = sp_transformer_bundle(
        vocab_size=vocab_size, embed_dim=embed_dim, num_heads=num_heads,
        num_layers=num_layers, max_len=max_len, attn_impl=attn_impl,
        block_size=block_size, flash_block=flash_block, device=device)
    # the gradient mean over sp comes BEFORE the client optimizer
    opt = Optimizer([pmean_gradients(SP), *optimizer.transforms])
    local_update = make_local_update(bundle, opt, epochs, make_sp_loss_fn(SP),
                                     compute_dtype=compute_dtype)
    inner = make_round_fn(local_update, axis_name=CLIENTS, device=device)

    def round_fn(state, x, y, mask, num_samples, participation, slot_ids):
        with use_mesh(mesh):
            return inner(state, x, y, mask, num_samples, participation, slot_ids)

    round_fn.axis_name = CLIENTS

    def init_fn(rng):
        return transformer_lm(vocab_size=vocab_size, embed_dim=embed_dim,
                              num_heads=num_heads, num_layers=num_layers,
                              seq_len=max_len, device=device).init(rng)

    def shard_data(arrays):
        x, y, *rest = arrays
        n, j = mesh.size(mesh.mesh_dim_names.index(SP)), mesh.get_local_rank(SP)
        L = int(x.shape[-1])
        if L % n:
            raise ValueError(f"sequence length {L} not divisible by the sp axis of {n}")
        part = slice(j * (L // n), (j + 1) * (L // n))
        return shard_client_block(mesh, (x[..., part], y[..., part], *rest))

    return round_fn, shard_data, init_fn
