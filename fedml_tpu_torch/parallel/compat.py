"""The collective surface of the port's parallel engines, and the launcher
that brings a mesh's ranks into being (counterpart of
``fedml_tpu/parallel/compat.py``, the ``shard_map`` version shim).

JAX's SPMD model is one program over N devices in one process: inside
``shard_map`` each device sees its block and the collectives
(``lax.psum``, ``ppermute``, ``all_gather``, ``axis_index``) name a mesh
axis.  Here each mesh position is a process (a rank) running the same
Python on its own block, and the same collectives, under the same names,
run over the process group of a named ``DeviceMesh`` dimension: gloo
across CPU processes, NCCL on the card.

- ``shard_map(f, mesh=)`` binds ``mesh`` for the collectives inside
  ``f``.  Each rank already holds its own block, so nothing is split or
  gathered on the way in or out.  ``use_mesh`` is the same as a context.
- ``psum``, ``ppermute``, ``axis_index`` and ``axis_size`` take an axis
  name or a tuple of names (the flattened, row-major axis, as JAX's), over
  the bound mesh; ``all_gather`` (along any dimension; ``tiled=True``
  concatenates, as JAX's) and ``psum_scatter`` one name.  A tree of
  tensors travels as one buffer per dtype in ``psum`` and ``ppermute``.
  ``psum``, ``ppermute`` and ``all_gather`` are differentiable, with JAX's
  transposes (``psum`` of the cotangents; ``ppermute`` along the inverse
  permutation; ``psum_scatter``); every rank runs the same graph, so the
  backward's collectives meet in the same order.  Over an axis of one
  rank each is its operand, and nothing is sent.  ``BYTES`` counts what
  each collective moved, by collective and axis.
  Under gloo, ``ppermute`` stages a card buffer through host memory.
- ``single_rank_group()`` makes this process a world of one rank (a
  1-rank mesh in process, beside the single-device code it must equal).
- ``launch(fn, n, *args)`` spawns ``n`` ranks, runs ``fn(*args)`` on each
  inside an initialized process group, and returns each rank's result
  with its tensors as numpy arrays.  Rendezvous is a ``FileStore`` in a
  fresh temporary directory, so concurrent launches never share a port.
  Every launch has a deadline: a rank that raises, dies or outlives the
  deadline fails the launch, and every rank is killed.  ``fn`` is pickled
  by its import path, so it must live in a module that imports without
  JAX and without the test package.
"""

from __future__ import annotations

import contextlib
import contextvars
import datetime
import multiprocessing
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from fedml_tpu_torch.utils.device import DeviceLike, resolve_device

AxisName = Union[str, Tuple[str, ...]]

_MESH: contextvars.ContextVar = contextvars.ContextVar("fedml_tpu_torch_mesh",
                                                       default=None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Bind ``mesh`` for the collectives called inside the block."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def shard_map(f: Callable, *, mesh) -> Callable:
    """``f`` with ``mesh`` bound for its collectives (the eager counterpart
    of ``jax.shard_map``: every rank passes its own block)."""

    def mapped(*args, **kwargs):
        with use_mesh(mesh):
            return f(*args, **kwargs)

    return mapped


def current_mesh():
    mesh = _MESH.get()
    if mesh is None:
        raise RuntimeError("no device mesh is bound: call collectives inside "
                           "shard_map(f, mesh=...) or use_mesh(mesh)")
    return mesh


def mesh_device(mesh) -> torch.device:
    """This rank's device in ``mesh``: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _axes(axis_name: AxisName) -> Tuple[str, ...]:
    return tuple(axis_name) if isinstance(axis_name, (tuple, list)) else (axis_name,)


def _dim_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_size(axis_name: AxisName) -> int:
    mesh = current_mesh()
    n = 1
    for a in _axes(axis_name):
        n *= _dim_size(mesh, a)
    return n


def axis_index(axis_name: AxisName) -> int:
    """This rank's coordinate along the axis (row-major over a tuple)."""
    mesh = current_mesh()
    idx = 0
    for a in _axes(axis_name):
        idx = idx * _dim_size(mesh, a) + mesh.get_local_rank(a)
    return idx


def _leaves(tree) -> list:
    """The tensors of a tree of dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _rebuild(tree, leaves):
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return next(it)

    return walk(tree)


def _buffers(leaves) -> dict:
    """Leaves grouped by dtype, each group concatenated into one flat copy."""
    groups: dict = {}
    for i, leaf in enumerate(leaves):
        groups.setdefault(leaf.dtype, []).append(i)
    return {dt: (idx, torch.cat([leaves[i].reshape(-1) for i in idx]))
            for dt, idx in groups.items()}


def _unpack(leaves, buffers) -> list:
    out = list(leaves)
    for idx, flat in buffers.values():
        off = 0
        for i in idx:
            n = leaves[i].numel()
            out[i] = flat[off:off + n].reshape(leaves[i].shape)
            off += n
    return out


# the bytes each collective has moved in this process, by (collective, axis):
# a buffer's bytes once per all-reduce, a gather's result, a reduce-scatter's
# input (chip_smoke's [tp] reads the model axis's)
BYTES: dict = {}


def _count(kind: str, axis: str, nbytes: int) -> None:
    BYTES[(kind, axis)] = BYTES.get((kind, axis), 0) + nbytes


def _psum_leaves(mesh, leaves, axis_name: AxisName) -> list:
    for a in _axes(axis_name):
        if _dim_size(mesh, a) == 1:  # a sum over one rank is its operand
            continue
        bufs = _buffers(leaves)
        for _, flat in bufs.values():
            dist.all_reduce(flat, group=mesh.get_group(a))
            _count("psum", a, flat.numel() * flat.element_size())
        leaves = _unpack(leaves, bufs)
    return leaves


def _differentiable(leaves) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(leaf, torch.Tensor) and leaf.requires_grad for leaf in leaves)


class _PSum(torch.autograd.Function):
    """``psum`` under autograd; its transpose is ``psum`` of the cotangents
    (JAX's).  The mesh rides on the node: the backward may run on autograd's
    device thread, outside the caller's ``use_mesh``."""

    @staticmethod
    def forward(ctx, mesh, axis_name, *leaves):
        ctx.mesh, ctx.axis_name = mesh, axis_name
        out = _psum_leaves(mesh, list(leaves), axis_name)
        ctx.mark_non_differentiable(*(t for t in out if not t.is_floating_point()))
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *_psum_leaves(ctx.mesh, list(grads), ctx.axis_name))


def psum(x, axis_name: AxisName):
    """Sum ``x`` (a tensor, or dicts, lists and tuples of them) over the
    axis; every rank gets the sum.  A Python number sums to itself times
    the axis size, as ``lax.psum`` of a constant does.  Differentiable: the
    cotangents are psum'd in the backward, as JAX transposes ``psum``, so
    the gradient of a psum'd loss on each rank carries the axis size."""
    if isinstance(x, (int, float)):
        return x * axis_size(axis_name)
    mesh = current_mesh()
    leaves = _leaves(x)
    if _differentiable(leaves):
        return _rebuild(x, list(_PSum.apply(mesh, axis_name, *leaves)))
    return _rebuild(x, _psum_leaves(mesh, leaves, axis_name))



def _ppermute_leaves(mesh, leaves, axis_name: str, perm) -> list:
    group = mesh.get_group(axis_name)
    me = mesh.get_local_rank(axis_name)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    # gloo's send writes a card tensor's device pointer to its socket and the
    # rank aborts, so under gloo a card buffer crosses through host memory
    stage = dist.get_backend(group) == "gloo"
    bufs = _buffers(leaves)
    received = {}
    for dt, (idx, flat) in bufs.items():
        if dst == [me] and src == [me]:  # the identity: no transfer
            received[dt] = (idx, flat)
            continue
        staged = stage and flat.is_cuda
        out = torch.zeros_like(flat, device="cpu" if staged else flat.device)
        send = flat.cpu() if staged and dst else flat
        ops = []
        if dst:
            ops.append(dist.P2POp(dist.isend, send,
                                  dist.get_global_rank(group, dst[0]), group))
        if src:
            ops.append(dist.P2POp(dist.irecv, out,
                                  dist.get_global_rank(group, src[0]), group))
        for work in dist.batch_isend_irecv(ops) if ops else ():
            work.wait()
        if staged:
            ppermute.staged_bytes += (len(dst) + len(src)) * flat.numel() * flat.element_size()
            out = out.to(flat.device)
        received[dt] = (idx, out)
    return _unpack(leaves, received)


class _PPermute(torch.autograd.Function):
    """``ppermute`` under autograd; its transpose is ``ppermute`` of the
    cotangents under the inverse permutation (JAX's)."""

    @staticmethod
    def forward(ctx, mesh, axis_name, perm, *leaves):
        ctx.mesh, ctx.axis_name = mesh, axis_name
        ctx.inverse = [(d, s) for s, d in perm]
        out = _ppermute_leaves(mesh, list(leaves), axis_name, perm)
        ctx.mark_non_differentiable(*(t for t in out if not t.is_floating_point()))
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, None,
                *_ppermute_leaves(ctx.mesh, list(grads), ctx.axis_name, ctx.inverse))


def ppermute(x, axis_name: str, perm: Sequence[Tuple[int, int]]):
    """Send this rank's ``x`` to the axis position that ``perm`` maps it to
    and return what arrives here: ``(source, destination)`` pairs in axis
    coordinates, zeros where nothing arrives (``lax.ppermute``).  A tree
    travels as one buffer per dtype, and is one autograd node: the backward
    sends the cotangents back along the inverse permutation.

    Under gloo a card tensor is staged through host memory: the buffer is
    copied to the host, sent, received into a host buffer and copied back
    to the card (``ppermute.staged_bytes`` counts the bytes staged, sent
    and received).  NCCL moves card buffers directly."""
    mesh = current_mesh()
    leaves = _leaves(x)
    if _differentiable(leaves):
        return _rebuild(x, list(_PPermute.apply(mesh, axis_name, list(perm), *leaves)))
    return _rebuild(x, _ppermute_leaves(mesh, leaves, axis_name, perm))


ppermute.staged_bytes = 0


def _gather_leaf(mesh, leaf, axis_name: str, axis: int, tiled: bool):
    if _dim_size(mesh, axis_name) == 1:
        return leaf if tiled else leaf.unsqueeze(axis)
    leaf = leaf.contiguous()
    parts = [torch.empty_like(leaf) for _ in range(_dim_size(mesh, axis_name))]
    dist.all_gather(parts, leaf, group=mesh.get_group(axis_name))
    _count("all_gather", axis_name, len(parts) * leaf.numel() * leaf.element_size())
    return torch.cat(parts, axis) if tiled else torch.stack(parts, axis)


def _scatter_leaf(mesh, leaf, axis_name: str, dim: int, tiled: bool):
    """The sum of ``leaf`` over the axis, this rank's chunk along ``dim``
    (``tiled``) or its index there.  gloo all-reduces and slices (it has
    no reduce-scatter in every torch build; the sums are the same); NCCL
    reduce-scatters."""
    group = mesh.get_group(axis_name)
    n, i = _dim_size(mesh, axis_name), mesh.get_local_rank(axis_name)
    size = leaf.shape[dim]
    if (size % n) if tiled else size != n:
        raise ValueError(f"psum_scatter: dimension {dim} of shape {tuple(leaf.shape)} "
                         f"does not split over the {axis_name!r} axis of {n}")
    if n == 1:
        return leaf if tiled else leaf.squeeze(dim)
    _count("psum_scatter", axis_name, leaf.numel() * leaf.element_size())
    if dist.get_backend(group) == "gloo":
        total = leaf.detach().clone().contiguous()
        dist.all_reduce(total, group=group)
        out = total.narrow(dim, i * (size // n), size // n)
    else:
        front = leaf.detach().movedim(dim, 0).contiguous()
        out = front.new_empty((size // n, *front.shape[1:]))
        dist.reduce_scatter_tensor(out, front, group=group)
        out = out.movedim(0, dim)
    return out.contiguous() if tiled else out.squeeze(dim).contiguous()


class _AllGather(torch.autograd.Function):
    """``all_gather`` under autograd; its transpose is ``psum_scatter`` of
    the cotangent (JAX's): the cotangents are summed over the axis and this
    rank keeps its own chunk."""

    @staticmethod
    def forward(ctx, mesh, axis_name, axis, tiled, leaf):
        ctx.args = (mesh, axis_name, axis, tiled)
        return _gather_leaf(mesh, leaf, axis_name, axis, tiled)

    @staticmethod
    def backward(ctx, grad):
        mesh, axis_name, axis, tiled = ctx.args
        return None, None, None, None, _scatter_leaf(mesh, grad, axis_name, axis, tiled)


def all_gather(x, axis_name: str, *, axis: int = 0, tiled: bool = True):
    """Every rank's ``x`` in axis order: concatenated along dimension
    ``axis`` (``tiled=True``) or stacked on a new dimension there.
    Differentiable: the backward is ``psum_scatter`` of the cotangent along
    the same dimension (JAX's transpose)."""
    mesh = current_mesh()

    def gather(leaf):
        if torch.is_grad_enabled() and leaf.requires_grad:
            return _AllGather.apply(mesh, axis_name, axis, tiled, leaf)
        return _gather_leaf(mesh, leaf, axis_name, axis, tiled)

    return _rebuild(x, [gather(leaf) for leaf in _leaves(x)])


def psum_scatter(x, axis_name: str, *, scatter_dimension: int = 0, tiled: bool = True):
    """The sum of ``x`` over the axis, scattered: each rank gets its chunk
    of dimension ``scatter_dimension`` (``tiled=True``: the dimension
    splits evenly over the axis) or, untiled, its index along a dimension
    of the axis's size, which is dropped (``lax.psum_scatter``).  Not
    differentiable."""
    mesh = current_mesh()
    return _rebuild(x, [_scatter_leaf(mesh, leaf, axis_name, scatter_dimension, tiled)
                        for leaf in _leaves(x)])



# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def _to_host(obj):
    """A rank's result with every tensor as a numpy array (bf16 as float32,
    exact): the form that crosses back to the launching process."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to_host(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


@contextlib.contextmanager
def single_rank_group(device: DeviceLike = None):
    """This process as a world of one rank for the block's duration (NCCL
    on the card, gloo on the CPU): a 1-rank mesh runs the SPMD code in
    process, beside its single-device counterpart.  Refuses to nest in an
    existing process group."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized here")
    device_type = resolve_device(device).type
    if device_type == "cuda":
        torch.cuda.set_device(torch.cuda.current_device())
    tmp = tempfile.mkdtemp(prefix="fedml_mesh_")
    try:
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo",
            init_method="file://" + os.path.join(tmp, "store"), rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _rank_main(fn, rank: int, world_size: int, init_method: str, backend: str,
               device_type: str, timeout: float, args, results) -> None:
    try:
        # one intra-op thread a rank: N ranks share the host's cores
        torch.set_num_threads(1)
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            out = _to_host(fn(*args))
            # no rank tears its connections down while a peer still reads
            # from them (a gloo pair closed under a pending receive fails it)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the launcher, which fails the launch
        results.put((rank, False, traceback.format_exc()))
        raise


def launch(fn: Callable, world_size: int, *args, device: DeviceLike = None,
           backend: Optional[str] = None, timeout: float = 300.0) -> List[Any]:
    """Run ``fn(*args)`` on ``world_size`` spawned ranks and return their
    results in rank order (tensors as numpy arrays).

    ``device`` is where each rank computes: the card by default (rank r on
    ``cuda:r % device_count``), or ``"cpu"``.  ``backend`` defaults to
    NCCL on the card and gloo on the CPU; NCCL refuses two ranks on one
    card, so it needs a card per rank, while gloo lets ranks share one.
    Each rank runs one torch intra-op thread.  Raises ``RuntimeError``
    naming the rank and its traceback when a rank fails or dies, and
    ``TimeoutError`` when the ranks outlive ``timeout`` seconds; either way
    every rank is killed."""
    device_type = resolve_device(device).type
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    if backend == "nccl" and world_size > torch.cuda.device_count():
        raise ValueError(
            f"NCCL needs one card per rank: {world_size} ranks, "
            f"{torch.cuda.device_count()} cards")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="fedml_mesh_")
    init_method = "file://" + os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world_size, init_method, backend, device_type,
                               timeout, args, results))
             for r in range(world_size)]
    done: dict = {}
    deadline = time.monotonic() + timeout

    def failure(rank, report):
        return RuntimeError(f"rank {rank} of {world_size} failed:\n{report}")

    try:
        for p in procs:
            p.start()
        while len(done) < world_size:
            try:
                rank, ok, payload = results.get(timeout=0.2)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in done]
                if dead:
                    try:  # its report may still be in the pipe
                        rank, ok, payload = results.get(timeout=2.0)
                    except queue.Empty:
                        raise failure(dead[0], "exited with code "
                                      f"{procs[dead[0]].exitcode} before reporting") from None
                elif time.monotonic() > deadline:
                    raise TimeoutError(
                        f"launch of {world_size} ranks outlived {timeout} s; ranks "
                        f"{sorted(set(range(world_size)) - set(done))} never reported")
                else:
                    continue
            if not ok:
                # the first report may be a peer's broken connection: gather
                # what the other ranks report within a grace period
                reports = {rank: payload}
                grace = time.monotonic() + 3.0
                while time.monotonic() < grace and len(reports) + len(done) < world_size:
                    try:
                        r2, ok2, p2 = results.get(timeout=0.2)
                    except queue.Empty:
                        continue
                    if not ok2:
                        reports[r2] = p2
                raise RuntimeError("\n".join(
                    f"rank {r} of {world_size} failed:\n{reports[r]}" for r in sorted(reports)))
            done[rank] = payload
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            if p.pid is not None:
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [done[r] for r in range(world_size)]
