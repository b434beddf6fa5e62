"""One dp×mp device mesh over the federation: cohort rows on ``dp``,
model tensors on ``mp`` (port of ``fedml_tpu/parallel/mesh.py``).

The user-facing ``--mesh dp,mp`` string is parsed once here.  A mesh
position is a rank (one process per device, ``compat.launch``), so a
"device" below is a rank of the initialized process group and the device
count is its world size.

CPU howto (no card needed): ``compat.launch(fn, n, device="cpu")`` runs
``fn`` on ``n`` gloo ranks; build the mesh inside ``fn``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from fedml_tpu_torch.utils.device import DeviceLike, resolve_device

DP_AXIS = "dp"
MP_AXIS = "mp"

HOST_MESH_HINT = (
    "launch one rank per mesh position, e.g. "
    "fedml_tpu_torch.parallel.compat.launch(fn, n, device='cpu') on the CPU, "
    "or torch.distributed.init_process_group with world_size n"
)


def world_size() -> int:
    """The ranks a mesh can span: the process group's size, or 1 for a
    process outside any group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def parse_mesh_spec(
    spec: str, device_count: Optional[int] = None
) -> Tuple[int, int]:
    """Parse ``--mesh`` strings into ``(dp, mp)``.

    Accepted forms: ``"4,2"``, ``"dp=4,mp=2"`` (order-free), and
    ``"auto,2"`` / ``"-1,2"`` where the auto dimension absorbs every
    device the other doesn't claim.  At most one dimension may be
    auto.  ``device_count=None`` defers to the world size.
    """
    parts = [p.strip() for p in str(spec).split(",") if p.strip()]
    if len(parts) != 2:
        raise ValueError(
            f"mesh spec {spec!r} must have exactly two dimensions "
            "(dp,mp), e.g. '8,1' or 'dp=8,mp=1'"
        )
    dims = {}
    for i, part in enumerate(parts):
        name = (DP_AXIS, MP_AXIS)[i]
        if "=" in part:
            name, _, part = part.partition("=")
            name = name.strip()
            part = part.strip()
            if name not in (DP_AXIS, MP_AXIS):
                raise ValueError(
                    f"mesh spec {spec!r}: unknown axis {name!r} "
                    f"(want {DP_AXIS}/{MP_AXIS})"
                )
        if name in dims:
            raise ValueError(f"mesh spec {spec!r} names {name!r} twice")
        if part in ("auto", "-1"):
            dims[name] = -1
        else:
            try:
                dims[name] = int(part)
            except ValueError:
                raise ValueError(
                    f"mesh spec {spec!r}: dimension {part!r} is not an "
                    "integer (or 'auto')"
                ) from None
    if DP_AXIS not in dims or MP_AXIS not in dims:
        raise ValueError(
            f"mesh spec {spec!r} must name both {DP_AXIS} and {MP_AXIS}"
        )
    dp, mp = dims[DP_AXIS], dims[MP_AXIS]
    if dp == -1 and mp == -1:
        raise ValueError(f"mesh spec {spec!r}: only one axis may be auto")
    if dp == -1 or mp == -1:
        if device_count is None:
            device_count = world_size()
        fixed = mp if dp == -1 else dp
        if fixed <= 0 or device_count % fixed:
            raise ValueError(
                f"mesh spec {spec!r}: {device_count} devices not "
                f"divisible by fixed axis {fixed}"
            )
        auto = device_count // fixed
        dp, mp = (auto, mp) if dp == -1 else (dp, auto)
    if dp <= 0 or mp <= 0:
        raise ValueError(f"mesh spec {spec!r}: axes must be positive")
    return dp, mp


def named_mesh(shape: Sequence[int], names: Sequence[str], *,
               devices: Optional[Sequence[int]] = None, device: DeviceLike = None):
    """A ``DeviceMesh`` of ``shape`` named ``names`` over the first
    ``prod(shape)`` ranks of ``devices`` (default: every rank), on the card
    unless ``device`` says otherwise.  Every rank of the group must call
    it.  Raises with the launch hint when there are too few ranks."""
    from torch.distributed.device_mesh import DeviceMesh

    ranks = list(devices) if devices is not None else list(range(world_size()))
    n = 1
    for s in shape:
        n *= int(s)
    if n > len(ranks):
        raise ValueError(
            f"mesh {'x'.join(str(int(s)) for s in shape)} needs {n} devices, "
            f"have {len(ranks)} ({HOST_MESH_HINT})"
        )
    if not dist.is_initialized():
        raise RuntimeError(f"no process group to build a mesh over ({HOST_MESH_HINT})")
    layout = torch.tensor(ranks[:n], dtype=torch.int64).reshape(*[int(s) for s in shape])
    return DeviceMesh(resolve_device(device).type, layout, mesh_dim_names=tuple(names))


def make_dp_mp_mesh(dp: int, mp: int, *, devices: Optional[Sequence[int]] = None,
                    device: DeviceLike = None):
    """A mesh with axes ``("dp", "mp")`` over the first dp*mp ranks."""
    return named_mesh((dp, mp), (DP_AXIS, MP_AXIS), devices=devices, device=device)


def mesh_from_spec(spec: str, *, devices: Optional[Sequence[int]] = None,
                   device: DeviceLike = None):
    """``parse_mesh_spec`` + ``make_dp_mp_mesh`` in one call."""
    count = len(devices) if devices is not None else None
    dp, mp = parse_mesh_spec(spec, device_count=count)
    return make_dp_mp_mesh(dp, mp, devices=devices, device=device)


def describe_mesh(mesh) -> dict:
    """JSON-friendly summary for evidence files and logs; ``platform`` is
    ``cuda`` or ``cpu``."""
    return {
        "axes": {name: int(mesh.size(i))
                 for i, name in enumerate(mesh.mesh_dim_names)},
        "devices": int(mesh.mesh.numel()),
        "platform": str(mesh.device_type),
    }
