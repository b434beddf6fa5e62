"""SPMD execution of federated rounds over a device mesh (port of
``fedml_tpu/parallel/spmd.py``).

The reference's one-MPI-process-per-participant layout
(``FedAvgAPI.py:10-25`` + ``run_fedavg_distributed_pytorch.sh:19-23``)
becomes one program per rank on a ``clients`` mesh axis: model sync is
replication (every rank holds the same state, so no broadcast messages),
upload + aggregate is a masked weighted ``psum``, and subsampling is a
participation mask.  A ``model`` axis is reserved in the mesh so the
tensor and pipeline engines need no redesign.

Every function here runs on every rank of the mesh (``compat.launch``),
each with its own block: ``shard_client_block`` and
``shard_client_block_local`` give a rank its rows of the global
``[C, ...]`` arrays, on its device, and nothing else.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from fedml_tpu_torch.algorithms.fedavg import ServerState, make_round_fn
from fedml_tpu_torch.core import rng as rnglib
from fedml_tpu_torch.core import tree as treelib
from fedml_tpu_torch.core.client import LocalUpdateFn
from fedml_tpu_torch.core.types import device_resident_pack
from fedml_tpu_torch.parallel.compat import axis_index, mesh_device, psum, use_mesh
from fedml_tpu_torch.parallel.mesh import named_mesh, world_size
from fedml_tpu_torch.utils.device import DeviceLike

PyTree = Any
CLIENTS = "clients"


def make_1d_mesh(n_devices: Optional[int] = None, axis: str = "x", *,
                 device: DeviceLike = None):
    """1-D mesh over the first n ranks (shared by the tp/pp/sp/ep
    constructors)."""
    n = world_size() if n_devices is None else n_devices
    return named_mesh((n,), (axis,), device=device)


def make_client_mesh(num_devices: Optional[int] = None, *, model_axis: int = 1,
                     devices=None, device: DeviceLike = None):
    """Mesh with a ``clients`` data axis and a reserved ``model`` axis over
    the world's ranks (or ``devices``, a list of ranks)."""
    ranks = list(devices) if devices is not None else list(range(world_size()))
    if num_devices is not None:
        ranks = ranks[:num_devices]
    n = len(ranks)
    if n % model_axis:
        raise ValueError(f"{n} devices not divisible by model axis {model_axis}")
    return named_mesh((n // model_axis, model_axis), (CLIENTS, "model"),
                      devices=ranks, device=device)


def make_spmd_round_fn(
    mesh,
    local_update: LocalUpdateFn,
    *,
    server_update=None,
    aggregate_transform=None,
    donate: bool = True,
):
    """The FedAvg round over the ``clients`` mesh axis.

    Each rank runs ``make_round_fn``'s round over its local C/D clients
    (``shard_client_block``'s rows), then the weighted sums are psum'd
    across the axis.  Server state is replicated, so the returned state is
    the same on every rank: the next round's broadcast is free.  ``donate``
    is JAX's buffer donation of the state, which has no eager counterpart:
    the keyword is kept and does nothing."""
    del donate
    kwargs = {}
    if server_update is not None:
        kwargs["server_update"] = server_update
    inner = make_round_fn(local_update, aggregate_transform=aggregate_transform,
                          axis_name=CLIENTS, device=mesh_device(mesh), **kwargs)

    def spmd_round(state, x, y, mask, num_samples, participation, slot_ids):
        with use_mesh(mesh):
            return inner(state, x, y, mask, num_samples, participation, slot_ids)

    spmd_round.axis_name = CLIENTS
    return spmd_round


def _clients_block(mesh, num_slots: int):
    n_cl = mesh.size(mesh.mesh_dim_names.index(CLIENTS))
    if num_slots % n_cl:
        raise ValueError(f"{num_slots} slots not divisible by clients axis {n_cl}")
    return n_cl, num_slots // n_cl


def _as_tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def shard_client_block(mesh, pack_arrays, axis=CLIENTS):
    """This rank's rows of each global ``[C, ...]`` array, on its device:
    the block at its position along ``axis`` (a name, or a tuple of names
    for their row-major flattening, as ``P(("group", "clients"))``)."""
    arrays = list(pack_arrays)
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    n, i = 1, 0
    for name in names:
        size = mesh.size(mesh.mesh_dim_names.index(name))
        n, i = n * size, i * size + mesh.get_local_rank(name)
    rows = int(arrays[0].shape[0])
    if rows % n:
        raise ValueError(f"{rows} slots not divisible by the {names} axis of {n}")
    block = rows // n
    dev = mesh_device(mesh)
    return tuple(_as_tensor(a[i * block:(i + 1) * block], dev) for a in arrays)


def _devices_by_clients_index(mesh):
    """The mesh's ranks grouped by clients-axis index, wherever the
    ``clients`` axis sits in ``mesh.mesh_dim_names`` (positional indexing
    would silently walk the wrong axis of a ('model', 'clients') mesh)."""
    ax = mesh.mesh_dim_names.index(CLIENTS)
    moved = np.moveaxis(mesh.mesh.cpu().numpy(), ax, 0)
    return [[int(r) for r in moved[i].flat] for i in range(moved.shape[0])]


def host_client_range(
    mesh,
    num_slots: int,
    *,
    process_index: Optional[int] = None,
    host_of_device=None,
) -> range:
    """The contiguous client-slot range owned by this host's ranks.

    Slot ``k`` lives on the ranks at clients-axis index ``k // (num_slots
    / n_clients_axis)``; a host's slots are the union over its ranks: the
    per-rank partition of the reference's distributed loaders
    (``cifar10/data_loader.py:201-233``), derived from the mesh.

    ``host_of_device`` maps a rank to its host id.  By default every rank
    is its own host (each rank is a process that loads its own data) and
    ``process_index`` is this rank; tests inject a mapping to simulate
    several ranks per host."""
    if host_of_device is None:
        host_of_device = lambda r: r  # noqa: E731
    if process_index is None:
        process_index = dist.get_rank() if dist.is_initialized() else 0
    n_cl, block = _clients_block(mesh, num_slots)
    dev_rows = _devices_by_clients_index(mesh)
    mine = [
        i
        for i in range(n_cl)
        if any(host_of_device(d) == process_index for d in dev_rows[i])
    ]
    if not mine:
        return range(0)
    lo, hi = min(mine), max(mine)
    if mine != list(range(lo, hi + 1)):
        raise ValueError(
            "host's devices are not contiguous along the clients axis; "
            "reorder the mesh so each host owns one slot range"
        )
    return range(lo * block, (hi + 1) * block)


def shard_client_block_local(mesh, num_slots: int, shards_by_slot_start):
    """This rank's rows of the global ``[C, ...]`` arrays, assembled from
    its host's blocks only.

    ``shards_by_slot_start`` maps a slot start to the tuple of host arrays
    covering a contiguous slot range (a host supplies the range from its
    ``host_client_range`` and NEVER materializes the rest).  The rank takes
    its own clients-axis block from them, onto its device."""
    _, block = _clients_block(mesh, num_slots)
    if not shards_by_slot_start:
        # A host whose ranks are outside this mesh owns no slot range
        # (host_client_range -> range(0)); such a host cannot join a
        # computation over this mesh, so assembling from it is a caller
        # bug, not a degenerate case to paper over.
        raise ValueError(
            "no slot ranges supplied; a host with host_client_range() == "
            "range(0) has no devices in this mesh and must not join its "
            "computations"
        )
    covering = {}
    for start, arrays in shards_by_slot_start.items():
        rows = int(np.shape(arrays[0])[0])
        if start % block or rows % block:
            raise ValueError(
                f"range [{start}, {start + rows}) is not aligned to the "
                f"per-device block of {block} slots"
            )
        for i in range(start // block, (start + rows) // block):
            covering[i * block] = (arrays, i * block - start)
    i = mesh.get_local_rank(CLIENTS)
    entry = covering.get(i * block)
    if entry is None:
        raise ValueError(
            f"no supplied range covers this rank's slots [{i * block}, "
            f"{(i + 1) * block}); pass this host's host_client_range() blocks"
        )
    arrays, off = entry
    dev = mesh_device(mesh)
    return tuple(_as_tensor(a[off:off + block], dev) for a in arrays)


def _replicate_leaf(x, groups, device):
    def bcast(t):
        for group in groups:
            dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)
        return t

    if isinstance(x, torch.Tensor):
        return bcast(x.detach().to(device).clone())
    if isinstance(x, np.ndarray):  # as raw bytes: any dtype, any backend
        raw = bcast(torch.from_numpy(np.frombuffer(x.tobytes(), np.uint8).copy())
                    .to(device))
        return np.frombuffer(raw.cpu().numpy().tobytes(), x.dtype).reshape(x.shape).copy()
    if isinstance(x, (bool, int, float)):
        dt = torch.float64 if isinstance(x, float) else torch.int64
        return type(x)(bcast(torch.tensor(x, dtype=dt, device=device)).item())
    return x


def replicate(mesh, tree: PyTree) -> PyTree:
    """Every rank of ``mesh`` ends up holding rank 0's bytes of ``tree``
    (tensors on its device; numpy arrays and Python numbers as they came):
    one broadcast from position 0 along each mesh dimension in turn."""
    groups = [mesh.get_group(name) for name in mesh.mesh_dim_names]
    device = mesh_device(mesh)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return _replicate_leaf(node, groups, device)

    return walk(tree)


# ---------------------------------------------------------------------------
# Hierarchical (two-tier) FL on a nested (group, clients) mesh
# ---------------------------------------------------------------------------


def make_group_mesh(num_groups: int, n_devices: Optional[int] = None, *,
                    device: DeviceLike = None):
    """Nested mesh for two-tier FL: ``group`` (the slow axis, across hosts)
    × ``clients`` (the fast axis, within one)."""
    n = world_size() if n_devices is None else n_devices
    if n % num_groups:
        raise ValueError(f"{n} devices not divisible into {num_groups} groups")
    return named_mesh((num_groups, n // num_groups), ("group", CLIENTS), device=device)


def hierarchical_pack(dataset, groups, batch_size, steps_per_epoch, seed):
    """Stack per-group device-resident packs into one ``[G*C, ...]`` block
    in group-major order (the ``("group", "clients")`` layout), plus the
    matching global slot ids.  Uses the exact per-group pack the host
    simulation builds (``HierarchicalSimulation._group_pack``), so every
    rank's block is byte for byte the simulation's.  The block stays on the
    host; ``shard_client_block`` moves each rank's rows to its device."""
    sizes = {g: len(ids) for g, ids in groups.items()}
    if len(set(sizes.values())) != 1:
        raise ValueError(
            f"nested-mesh hierarchical FL needs equal group sizes, got "
            f"{sizes}; pad the grouping or drop stragglers"
        )
    blocks, all_ids = [], []
    for g in sorted(groups):
        ids = np.asarray(groups[g])
        args, _ = device_resident_pack(dataset, ids, batch_size,
                                       steps_per_epoch=steps_per_epoch, seed=seed,
                                       device=torch.device("cpu"))
        blocks.append(args)
        all_ids.append(ids)
    stacked = tuple(torch.cat([b[i] for b in blocks]) for i in range(len(blocks[0])))
    return stacked, np.concatenate(all_ids)


def make_hierarchical_spmd_round_fn(
    mesh,
    local_update: LocalUpdateFn,
    *,
    group_comm_round: int,
    server_update=None,
    aggregate_transform=None,
):
    """One GLOBAL hierarchical round on a (``group``, ``clients``) mesh:
    every group starts from the global model and runs ``group_comm_round``
    in-group FedAvg rounds whose aggregation is a masked psum over the
    ``clients`` axis ONLY; the global tier is one sample-weighted psum over
    the ``group`` axis at the end.  Reference semantics:
    ``standalone/hierarchical_fl/trainer.py:43-69`` + ``group.py:24-46``.

    With data laid out by ``hierarchical_pack`` the result equals
    ``HierarchicalSimulation.run_round`` up to the order of the sums: the
    same per-group key schedule (``fold_in(state.key, 1000 + g)``), the
    same in-group round_idx base (``round_idx * group_comm_round``), the
    same group weights (the group's total sample count).  The metrics sum
    over every in-group round of every group."""
    kwargs = {}
    if server_update is not None:
        kwargs["server_update"] = server_update
    inner = make_round_fn(local_update, aggregate_transform=aggregate_transform,
                          axis_name=CLIENTS, device=mesh_device(mesh), **kwargs)

    def hier_round(state, x, y, mask, num_samples, participation, slot_ids):
        with use_mesh(mesh):
            g = axis_index("group")
            gstate = ServerState(state.variables, state.opt_state,
                                 state.round_idx * group_comm_round,
                                 rnglib.fold_in(state.key, 1000 + g))
            rows = []
            for _ in range(group_comm_round):
                gstate, ms = inner(gstate, x, y, mask, num_samples, participation,
                                   slot_ids)
                rows.append(ms)
            # the global tier: group models weighted by the group's TOTAL
            # sample count (reference group.py aggregates the whole group)
            group_total = psum(num_samples.sum(), CLIENTS)
            num = psum(treelib.tree_map(lambda leaf: group_total * leaf.float(),
                                        gstate.variables), "group")
            den = psum(group_total, "group")
            new_vars = treelib.tree_map(
                lambda s, ref: (s / torch.clamp_min(den, 1e-12)).to(ref.dtype),
                num, state.variables)
            metrics = psum({k: torch.stack([r[k] for r in rows]).sum()
                            for k in rows[0]}, "group")
        return ServerState(new_vars, state.opt_state, state.round_idx + 1,
                           state.key), metrics

    return hier_round
