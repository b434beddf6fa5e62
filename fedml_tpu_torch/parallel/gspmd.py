"""DP×TP federated rounds on a 2-D ``(clients, model)`` mesh (port of
``fedml_tpu/parallel/gspmd.py``).

JAX runs the plain round under ``jit`` with sharding annotations and lets
GSPMD derive every collective.  Here one rank runs each mesh position:
the round is ``make_round_fn(axis_name="clients")`` over the rank's block
of the cohort (its sums psum'd over ``clients``), and each client's local
update runs the tensor-parallel transformer (``parallel/tensor.py``),
whose Megatron collectives run over ``model``.  The server state is laid
out as JAX lays it out: the transformer's parameters by the TP plan over
``model``, FedAdam-style moments like their parameters.

This is federated fine-tuning of a model laid out across devices: each
rank holds about ``1/model`` of the sharded matrices.
"""

from __future__ import annotations

from typing import Any, Optional

from fedml_tpu_torch.algorithms.fedavg import ServerState, make_round_fn
from fedml_tpu_torch.compress.codecs import jax_leaves
from fedml_tpu_torch.core.client import LocalUpdateFn
from fedml_tpu_torch.parallel.compat import mesh_device
from fedml_tpu_torch.parallel.layout import Placement, axis_sizes, blocks, place, rewrap
from fedml_tpu_torch.parallel.mesh import named_mesh
from fedml_tpu_torch.parallel.spmd import CLIENTS, shard_client_block
from fedml_tpu_torch.parallel.tensor import bind_tp, check_divisible, tp_bundle, tp_param_spec
from fedml_tpu_torch.utils.device import DeviceLike

PyTree = Any
MODEL = "model"


def make_dp_tp_mesh(n_clients_axis: int, n_model_axis: int, *, devices=None,
                    device: DeviceLike = None):
    """A ``(clients, model)`` mesh over the first ``n_clients_axis *
    n_model_axis`` ranks (of ``devices``, a list of ranks, or the world)."""
    return named_mesh((n_clients_axis, n_model_axis), (CLIENTS, MODEL), devices=devices,
                      device=device)


def _shape(leaf):
    return tuple(leaf.shape) if hasattr(leaf, "shape") else ()


def opt_state_sharding_like(
    mesh,
    variables_template: PyTree,
    opt_state_template: PyTree,
    axis: str = MODEL,
    *,
    pspec: Optional[PyTree] = None,
) -> PyTree:
    """Placements for server-optimizer state whose leaves mirror the
    parameters (FedAdam/FedYogi moments); everything else (counts,
    scalars) is replicated.  ``pspec`` overrides the spec tree (the rule
    engine passes its own).

    A leaf under a parameter's state name with that parameter's shape (the
    moments' dicts are keyed as ``variables["params"]``) takes that
    parameter's spec; any other leaf takes JAX's shape-matching heuristic,
    the spec of the first parameter of its shape in JAX's leaf order.  (By
    shape alone, a ``[4E, E]`` moment of the embedding of a ``4E``-token
    vocabulary would take the MLP down kernel's layout: in JAX that only
    changes the layout, but here a moment's blocks must line up with its
    parameter's.)"""
    if pspec is None:
        pspec = tp_param_spec(variables_template, axis)
    specs = dict(jax_leaves(pspec))
    shape_to_spec: dict = {}
    for path, leaf in jax_leaves(variables_template):
        shape_to_spec.setdefault(_shape(leaf), specs[path])
    by_name = {k: (_shape(v), pspec["params"][k])
               for k, v in variables_template.get("params", {}).items()}

    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)) and not isinstance(node, Placement):
            items = [walk(v, name) for v in node]
            return type(node)(*items) if hasattr(node, "_fields") else type(node)(items)
        shape = _shape(node)
        if name in by_name and by_name[name][0] == shape:
            return Placement(mesh, by_name[name][1])
        return Placement(mesh, shape_to_spec.get(shape, ()))

    return walk(opt_state_template, None)


def make_dp_tp_round_fn(
    mesh,
    local_update: LocalUpdateFn,
    variables_template: PyTree,
    *,
    server_update=None,
    aggregate_transform=None,
    opt_state_sharding: Optional[PyTree] = None,
):
    """The FedAvg round with the cohort over ``clients`` and the
    transformer's parameters over ``model``.

    ``local_update`` is ``make_local_update`` over the plain
    ``transformer_lm`` bundle (as JAX's); the round rebuilds it over the
    tensor-parallel module of the same dimensions.  ``variables_template``
    (the full variables) fixes the layout.  Returns ``(round_fn,
    shard_state, shard_data)``: ``shard_state(state)`` lays a full server
    state out on this rank (``Shard``s; ``opt_state_sharding``, from
    ``opt_state_sharding_like``, lays out parameter-sized optimizer state,
    which is otherwise replicated), ``shard_data(arrays)`` gives this rank
    its clients' rows, and ``round_fn`` returns the state in the same
    layout.  Every rank of ``mesh`` calls each.

    ``aggregate_transform`` is refused: the port's transform would see
    only the rank's block of clients and its slices of each of them."""
    if aggregate_transform is not None:
        raise ValueError("aggregate_transform is not defined on the DP×TP round: a rank "
                         "holds its block of the clients and its slices of the model")
    if local_update.rebind is None or local_update.bundle is None:
        raise ValueError("the DP×TP round rebuilds the local update over the "
                         "tensor-parallel transformer: build it with make_local_update")
    dev = mesh_device(mesh)
    pspec = tp_param_spec(variables_template, axis=MODEL)
    check_divisible(variables_template, pspec, axis_sizes(mesh))
    tp_update = local_update.rebind(tp_bundle(local_update.bundle, axis_sizes(mesh)[MODEL],
                                              MODEL, device=dev))
    kwargs = {} if server_update is None else {"server_update": server_update}
    inner = make_round_fn(tp_update, axis_name=CLIENTS, device=dev, **kwargs)
    var_sharding = {c: {k: Placement(mesh, s) for k, s in sub.items()}
                    for c, sub in pspec.items()}
    opt_sharding = Placement(mesh, ()) if opt_state_sharding is None else opt_state_sharding

    def shard_state(state: ServerState) -> ServerState:
        return state._replace(variables=place(state.variables, var_sharding),
                              opt_state=place(state.opt_state, opt_sharding))

    def shard_data(arrays):
        return shard_client_block(mesh, arrays)

    def round_fn(state, x, y, mask, num_samples, participation, slot_ids):
        with bind_tp(mesh, MODEL, pspec):
            new, metrics = inner(
                state._replace(variables=blocks(state.variables),
                               opt_state=blocks(state.opt_state)),
                x, y, mask, num_samples, participation, slot_ids)
        return new._replace(variables=rewrap(new.variables, state.variables),
                            opt_state=rewrap(new.opt_state, state.opt_state)), metrics

    round_fn.axis_name = CLIENTS
    return round_fn, shard_state, shard_data
