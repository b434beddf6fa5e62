"""Partition-rule sharding engine: ordered ``(regex → spec)`` tables matched
against the variables' path names (port of ``fedml_tpu/parallel/partition.py``).

A rule table is an ordered list of ``(pattern, spec)`` pairs; each leaf's
'/'-joined flax path (``params/Block_0/Dense_1/kernel``; the port's dotted
state names are split, so ``params`` + ``Block_0.Dense_1.kernel`` reads the
same) is matched with ``re.search`` and the FIRST matching rule wins.
Scalars (ndim 0) always replicate; ``_unmatched`` decides whether
unmatched leaves replicate or raise.  Canonical tables ship for ``fedllm``
(the transformer LM) and ``resnet``; custom tables load from JSON
(``resolve_rules``).  Specs are the tables' tuples (``(None, "mp")``).

On the matcher sit the appliers: ``shard_by_rules`` lays a tree out on a
``(dp, mp)`` mesh of ranks (``parallel/layout.py``: each rank holds its
``Shard``s); ``server_state_sharding`` extends the plan to the whole
``ServerState``: optimizer moments by shape (``gspmd.
opt_state_sharding_like``), the error-feedback residual store with its
client rows over ``dp``; ``make_rule_round_fn`` runs the FedAvg round with
the cohort over ``dp`` and the variables laid out by the table;
``cohort_shardings`` gives the layouts a muxed cohort's step takes, and
``CohortEngine`` runs that step (``algorithms/fedavg_mux.py``'s mesh).

How the round computes: each rank stores its slice of each leaf, and each
client's local update gathers the sharded leaves over ``mp`` at every
forward and trains the whole model.  Every ``mp`` rank of a ``dp`` row
trains the same clients on the same weights, so the gather's backward
keeps this rank's chunk of its own gradient (a sum would multiply it by
``mp``), and the round is bit-identical to the single-device round at
every ``mp`` (JAX's is at ``mp`` 1 only).  The ``mp`` ranks repeat each
other's compute: Megatron compute under a rule table is later speed work
(ROADMAP queue B).
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from fedml_tpu_torch.algorithms.fedavg import (ServerState, _TRAIN_STREAM,
                                               default_server_update)
from fedml_tpu_torch.compress.codecs import (COMPRESS_STREAM, FlatLayout, get_codec,
                                             jax_leaves, unflatten_like, uplink_roundtrip)
from fedml_tpu_torch.core import rng as rnglib
from fedml_tpu_torch.core import tree as treelib
from fedml_tpu_torch.parallel.compat import (all_gather, axis_index, mesh_device, psum,
                                             replicated_out, use_mesh)
from fedml_tpu_torch.parallel.layout import (Placement, axis_sizes, block_index, blocks,
                                             check_divisible, is_sharded, map_tree,
                                             mesh_coords, place, rewrap, shard_leaf,
                                             shard_slice, spec_axes, unshard, zeros_placed)
from fedml_tpu_torch.parallel.mesh import DP_AXIS, MP_AXIS
from fedml_tpu_torch.parallel.spmd import _as_tensor, shard_client_block
from fedml_tpu_torch.parallel.tensor import mean_grads_over

PyTree = Any

UNMATCHED_REPLICATE = "replicate"
UNMATCHED_RAISE = "raise"


class RuleTable(NamedTuple):
    """An ordered partition-rule table: ``rules`` are ``(pattern,
    spec_dims)`` pairs, ``spec_dims`` the spec as a tuple (``(None,
    "mp")``); ``unmatched`` is ``"replicate"`` or ``"raise"``."""

    name: str
    rules: Tuple[Tuple[str, Tuple], ...]
    unmatched: str = UNMATCHED_REPLICATE


# fedllm transformer (models/transformer.py): paths look like
#   params/wte/embedding                                  [V, E]
#   params/wpe/embedding                                  [S, E]
#   params/Block_i/MultiHeadAttention_0/Dense_0/kernel    [E, 3E] qkv
#   params/Block_i/MultiHeadAttention_0/Dense_1/kernel    [E, E]  out
#   params/Block_i/Dense_0/{kernel,bias}                  [E, 4E] mlp up
#   params/Block_i/Dense_1/kernel                         [4E, E] mlp down
#   params/Block_i/LayerNorm_{0,1}/{scale,bias}
#   params/ln_f/{scale,bias}                              final norm
# Megatron plan: qkv/up column-parallel, out/down row-parallel, the
# embedding vocab-sharded, norms replicated.
FEDLLM_RULES = RuleTable(
    name="fedllm",
    rules=(
        (r"wte/embedding", (MP_AXIS, None)),
        (r"wpe/embedding", (None, None)),
        (r"MultiHeadAttention_\d+/Dense_0/kernel", (None, MP_AXIS)),
        (r"MultiHeadAttention_\d+/Dense_1/kernel", (MP_AXIS, None)),
        (r"Block_\d+/Dense_0/kernel", (None, MP_AXIS)),
        (r"Block_\d+/Dense_0/bias", (MP_AXIS,)),
        (r"Block_\d+/Dense_1/kernel", (MP_AXIS, None)),
        # row-parallel down projection: its bias adds after the sum, so it
        # replicates
        (r"Block_\d+/Dense_1/bias", ()),
        (r"LayerNorm_\d+|ln_f", ()),
    ),
    unmatched=UNMATCHED_REPLICATE,
)

# CIFAR ResNets (models/resnet.py): output-channel-sharded convs and
# classifier, BatchNorm parameters and statistics replicated.
RESNET_RULES = RuleTable(
    name="resnet",
    rules=(
        (r"Conv_\d+/kernel", (None, None, None, MP_AXIS)),
        (r"Dense_\d+/kernel", (None, MP_AXIS)),
        (r"Dense_\d+/bias", (MP_AXIS,)),
        (r"BatchNorm_\d+|batch_stats", ()),
    ),
    unmatched=UNMATCHED_REPLICATE,
)

_NAMED_TABLES = {t.name: t for t in (FEDLLM_RULES, RESNET_RULES)}


def resolve_rules(name_or_path: str) -> RuleTable:
    """A canonical table by name (``fedllm``, ``resnet``) or a custom
    one from a JSON file::

        {"_unmatched": "raise",
         "rules": [["Dense_\\\\d+/kernel", [null, "mp"]], ...]}
    """
    if name_or_path in _NAMED_TABLES:
        return _NAMED_TABLES[name_or_path]
    try:
        with open(name_or_path) as f:
            doc = json.load(f)
    except OSError:
        raise ValueError(
            f"unknown rule table {name_or_path!r}: not a canonical name "
            f"({sorted(_NAMED_TABLES)}) and not a readable JSON file"
        ) from None
    unmatched = doc.get("_unmatched", UNMATCHED_REPLICATE)
    if unmatched not in (UNMATCHED_REPLICATE, UNMATCHED_RAISE):
        raise ValueError(
            f"rule file {name_or_path}: _unmatched must be "
            f"'{UNMATCHED_REPLICATE}' or '{UNMATCHED_RAISE}', "
            f"got {unmatched!r}"
        )
    rules = []
    for entry in doc.get("rules", ()):
        pattern, dims = entry
        re.compile(pattern)  # fail loud at load, not first match
        rules.append((str(pattern), tuple(dims)))
    return RuleTable(name=name_or_path, rules=tuple(rules), unmatched=unmatched)


def _leaves_with_path(tree: PyTree) -> List[Tuple[Tuple[str, ...], Any]]:
    """``(flax path, leaf)`` pairs of a tree of dicts in JAX's leaf order;
    dotted keys (the port's state names) split into their scopes."""
    return jax_leaves(tree)


def _leaf_path(path) -> str:
    return "/".join(path)


def _map_with_path(fn, tree: PyTree, prefix: Tuple[str, ...] = ()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, prefix + tuple(str(k).split(".")))
                for k, v in tree.items()}
    return fn(prefix, tree)


def match_partition_rules(table: RuleTable, tree: PyTree) -> PyTree:
    """The spec tree of ``tree`` under ``table``: first ``re.search`` match
    on the '/'-joined path wins; ndim-0 leaves always replicate; a matched
    spec with more dims than the leaf is a table bug and raises; unmatched
    leaves follow ``table.unmatched``."""
    compiled = [(re.compile(p), dims) for p, dims in table.rules]

    def spec_for(path, leaf):
        name = _leaf_path(path)
        ndim = np.ndim(leaf) if not isinstance(leaf, torch.Tensor) else leaf.ndim
        if ndim == 0:
            return ()
        for pat, dims in compiled:
            if pat.search(name):
                if len(dims) > ndim:
                    raise ValueError(
                        f"rule table {table.name!r}: pattern "
                        f"{pat.pattern!r} gives {len(dims)}-dim spec "
                        f"{tuple(dims)} for {ndim}-dim leaf {name!r}"
                    )
                return tuple(dims)
        if table.unmatched == UNMATCHED_RAISE:
            raise ValueError(
                f"rule table {table.name!r}: no rule matches leaf "
                f"{name!r} and _unmatched=raise"
            )
        return ()

    # JAX's leaf order, so that the first leaf to raise is JAX's
    specs = {path: spec_for(path, leaf) for path, leaf in _leaves_with_path(tree)}
    return _map_with_path(lambda path, _: specs[path], tree)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(int(n) for n in (leaf.shape if hasattr(leaf, "shape") else np.shape(leaf)))


def rule_coverage(table: RuleTable, tree: PyTree) -> Dict[str, Any]:
    """Per-rule match accounting: how many leaves (and parameters) each
    rule claimed, which paths fell through, and the sharded/replicated
    split."""
    compiled = [(re.compile(p), dims) for p, dims in table.rules]
    per_rule = [
        {"pattern": p, "spec": list(dims), "leaves": 0, "params": 0,
         "example": None}
        for p, dims in table.rules
    ]
    unmatched: List[str] = []
    sharded = replicated = 0
    leaves = _leaves_with_path(tree)
    for path, leaf in leaves:
        name = _leaf_path(path)
        shape = _shape(leaf)
        size = int(np.prod(shape, dtype=np.int64))
        if len(shape) == 0:
            replicated += 1
            continue
        for i, (pat, dims) in enumerate(compiled):
            if pat.search(name):
                per_rule[i]["leaves"] += 1
                per_rule[i]["params"] += size
                if per_rule[i]["example"] is None:
                    per_rule[i]["example"] = name
                if any(d is not None for d in dims):
                    sharded += 1
                else:
                    replicated += 1
                break
        else:
            unmatched.append(name)
            replicated += 1
    return {
        "table": table.name,
        "unmatched_policy": table.unmatched,
        "rules": per_rule,
        "unmatched_paths": unmatched,
        "leaves_total": len(leaves),
        "leaves_sharded": sharded,
        "leaves_replicated": replicated,
    }


def validate_divisibility(tree: PyTree, specs: PyTree,
                          axis_sizes: Dict[str, int]) -> None:
    """Every sharded dim must divide evenly by the product of its mesh
    axes: nothing pads, which would waste ranks and hide a wrong rule.
    Raises naming the leaf, dim and axis."""
    spec_of = dict(_leaves_with_path(specs))
    check_divisible([(_leaf_path(path), _shape(leaf), spec_of[path])
                     for path, leaf in _leaves_with_path(tree)], axis_sizes)


def named_sharding_tree(mesh, specs: PyTree) -> PyTree:
    """Spec tree → ``Placement`` tree on ``mesh`` (the port's
    ``NamedSharding`` tree)."""
    return treelib.tree_map(lambda s: Placement(mesh, tuple(s)), specs)


def shard_by_rules(mesh, tree: PyTree, table: RuleTable) -> Tuple[PyTree, PyTree]:
    """Lay ``tree`` out on ``mesh`` under ``table``: validate
    divisibility, then give this rank its ``Shard`` of each leaf.  Returns
    ``(sharded_tree, specs)``."""
    specs = match_partition_rules(table, tree)
    validate_divisibility(tree, specs, axis_sizes(mesh))
    return treelib.tree_map(lambda leaf, s: shard_leaf(mesh, leaf, s), tree, specs), specs


def jit_sharded(fn, *, in_shardings=None, out_shardings=None, **jit_kwargs):
    """The engine's entry point for a function over laid-out state: JAX's
    ``jax.jit`` with sharding annotations.  The port captures nothing (each
    rank runs ``fn`` eagerly on its blocks; the layout is the engine's own),
    so ``fn`` comes back as it is; the name stays the one place every
    function of the sharding engine goes through."""
    del in_shardings, out_shardings, jit_kwargs
    return fn


# --- ServerState / round-engine integration ---------------------------------

def server_state_sharding(mesh, variables_template: PyTree,
                          table: RuleTable, *,
                          opt_state_template: Optional[PyTree] = None,
                          error_feedback: bool = False):
    """``ServerState``-shaped placements under ``table``: variables by
    rules, optimizer moments by shape (``gspmd.opt_state_sharding_like``
    with the same rule-derived specs), the EF residuals (a leading
    ``[num_clients, ...]`` axis) with the client rows on ``dp`` and the
    parameter dims like the parameter's.  Returns ``(placements, specs)``."""
    from fedml_tpu_torch.parallel.gspmd import opt_state_sharding_like

    specs = match_partition_rules(table, variables_template)
    repl = Placement(mesh, ())
    opt = (opt_state_sharding_like(mesh, variables_template, opt_state_template,
                                   pspec=specs)
           if opt_state_template is not None else repl)
    residuals = (treelib.tree_map(lambda s: Placement(mesh, (DP_AXIS, *s)), specs)
                 if error_feedback else ())
    return ServerState(variables=named_sharding_tree(mesh, specs), opt_state=opt,
                       round_idx=repl, key=repl, residuals=residuals), specs


def residual_store(mesh, variables_template: PyTree, table: RuleTable,
                   num_clients: int) -> PyTree:
    """The EF residual store, zeros, laid out as ``server_state_sharding``
    lays it (the client rows over ``dp``, the parameter dims like the
    parameters'), made as this rank's blocks only: ``num_clients / dp`` rows
    of its parameter blocks, never the whole ``[num_clients, ...]`` store.
    ``make_rule_round_fn``'s ``shard_state`` keeps it as it is."""
    placements, _ = server_state_sharding(mesh, variables_template, table,
                                          error_feedback=True)
    return map_tree(lambda v, p: zeros_placed(p, (num_clients, *_shape(v)), v.dtype),
                    variables_template, placements.residuals)


class _GatheredBundle:
    """A model bundle over variables laid out by a rule table: each forward
    gathers the sharded leaves over the mesh and runs the whole model; the
    gather's backward keeps this rank's chunk of its own cotangent (every
    rank of the axis computes the same whole gradient).  The replicated
    parameters' gradients are averaged over ``mp`` (``tensor.
    mean_grads_over``: exact where the ranks agree, and the replicas stay
    one where a card kernel's sums are not deterministic).  New statistics
    come back as this rank's blocks."""

    def __init__(self, bundle, specs: PyTree, mesh):
        self.bundle, self.specs, self.mesh = bundle, specs, mesh
        self.module, self.device = bundle.module, bundle.device
        self.input_shape, self.input_dtype = bundle.input_shape, bundle.input_dtype
        self.needs_dropout_rng = bundle.needs_dropout_rng
        self.replicated = [k for k, s in specs.get("params", {}).items() if not is_sharded(s)]

    def _whole(self, variables):
        variables = {**variables, "params": mean_grads_over(
            variables["params"], self.replicated, MP_AXIS)}
        return {c: {k: unshard(v, self.specs[c][k], backward="keep")
                    for k, v in sub.items()} for c, sub in variables.items()}

    def apply_train(self, variables, x, rng=None):
        logits, new = self.bundle.apply_train(self._whole(variables), x, rng)
        sizes, coords = axis_sizes(self.mesh), mesh_coords(self.mesh)
        return logits, {c: (variables[c] if c == "params" else
                            {k: shard_slice(v, self.specs[c][k], sizes, coords).contiguous()
                             for k, v in sub.items()})
                        for c, sub in new.items()}

    def apply_eval(self, variables, x):
        return self.bundle.apply_eval(self._whole(variables), x)


def _flat_row(store: PyTree, r: int) -> torch.Tensor:
    """Row ``r`` of a ``[rows, ...]`` store of blocks, in JAX's leaf order."""
    return torch.cat([leaf[r].reshape(-1) for _, leaf in jax_leaves(store)])


def _row_leaves(store: PyTree, flat: torch.Tensor) -> List[torch.Tensor]:
    """A flat row of ``store`` cut back into its leaves (views), in JAX's
    leaf order."""
    out, off = [], 0
    for _, leaf in jax_leaves(store):
        n = leaf[0].numel()
        out.append(flat[off:off + n].view(leaf.shape[1:]))
        off += n
    return out


def _set_row(store: PyTree, r: int, flat: torch.Tensor) -> None:
    for (_, leaf), v in zip(jax_leaves(store), _row_leaves(store, flat)):
        leaf[r].copy_(v)


def _exchange(mesh, axis: str, sends, recvs) -> List[torch.Tensor]:
    """Point-to-point over ``axis``: each ``(peer, tensor)`` of ``sends``
    goes to that axis coordinate, and each ``(peer, like)`` of ``recvs``
    arrives from one (pairs between two ranks match in order).  Under gloo a
    card buffer crosses through host memory (gloo's send of a card tensor
    aborts the rank)."""
    group = mesh.get_group(axis)
    stage = dist.get_backend(group) == "gloo"
    ops, outs = [], []
    for peer, t in sends:
        buf = t.cpu() if stage and t.is_cuda else t.contiguous()
        ops.append(dist.P2POp(dist.isend, buf, dist.get_global_rank(group, peer), group))
    for peer, like in recvs:
        buf = torch.empty_like(like, device="cpu" if stage and like.is_cuda else like.device)
        outs.append(buf)
        ops.append(dist.P2POp(dist.irecv, buf, dist.get_global_rank(group, peer), group))
    for work in dist.batch_isend_irecv(ops) if ops else ():
        work.wait()
    return [o.to(like.device) for o, (_, like) in zip(outs, recvs)]


def make_rule_round_fn(
    mesh,
    local_update,
    variables_template: PyTree,
    table: RuleTable = FEDLLM_RULES,
    *,
    server_update=None,
    aggregate_transform=None,
    opt_state_template: Optional[PyTree] = None,
    codec=None,
    error_feedback: bool = False,
    exact_aggregation: bool = True,
):
    """The FedAvg round on a ``(dp, mp)`` mesh with the cohort over ``dp``
    and the variables laid out by ``table``.

    ``local_update`` is ``make_local_update`` over the plain bundle; the
    round rebuilds it over the gathering bundle (the module's docstring).
    ``codec`` (a name or a LeafCodec) and ``error_feedback`` run each
    client's update through the uplink as ``make_round_fn`` does, on the
    whole leaves (the update and the residual row gathered over ``mp``, so
    the codec's chunks and streams are the single-device round's); the
    residual store keeps its client rows over ``dp`` and its parameter dims
    like the parameters'.  A sampled client's row may live on another
    ``dp`` rank than the one that trains it: the rows move there before the
    round and back after it, point to point.

    ``exact_aggregation`` (default on) makes the round bit-identical to
    ``make_round_fn`` on one device at any ``dp``: the clients' weights,
    counts and slot ids stay whole on every rank, the trained variables are
    gathered over ``dp`` and every rank folds all K of them in client order
    in fp32, as ``core/tree.py::tree_fold_weighted_f32`` folds them on one
    device; the metrics likewise.  It costs an all-gather of the cohort's
    slices of the model per round.  Off, each rank folds its own clients and
    the partial sums are psum'd over ``dp`` (reassociated).

    A variable's spec may name ``mp`` only (``dp`` carries the cohort).
    ``aggregate_transform`` is refused (a rank holds its block of clients
    and its slices of the model).  Returns ``(round_fn, shard_state,
    shard_data)``; every rank of ``mesh`` calls each."""
    if aggregate_transform is not None:
        raise ValueError("aggregate_transform is not defined on the rule engine's round: "
                         "a rank holds its block of the clients and its slices of the model")
    if isinstance(codec, str):
        codec = get_codec(codec)
    if error_feedback and codec is None:
        raise ValueError("error_feedback needs a codec")
    if local_update.rebind is None or local_update.bundle is None:
        raise ValueError("the rule engine rebuilds the local update over the laid-out "
                         "model: build it with make_local_update")
    ef = codec is not None and error_feedback
    sizes, dev = axis_sizes(mesh), mesh_device(mesh)
    state_sharding, specs = server_state_sharding(
        mesh, variables_template, table, opt_state_template=opt_state_template,
        error_feedback=ef)
    validate_divisibility(variables_template, specs, sizes)
    for path, spec in _leaves_with_path(specs):
        if set(spec_axes(spec)) - {MP_AXIS}:
            raise ValueError(f"rule table {table.name!r}: leaf {_leaf_path(path)!r} has "
                             f"spec {spec}; the rule engine lays variables over "
                             f"{MP_AXIS!r} only ({DP_AXIS!r} carries the cohort)")
    lu = local_update.rebind(_GatheredBundle(local_update.bundle, specs, mesh))
    # at mp 1 every block is its whole leaf, and the norms stay tree_sq_norm's
    sharded = ([k for k, s in specs["params"].items() if is_sharded(s)]
               if sizes[MP_AXIS] > 1 else [])
    layout = FlatLayout(variables_template, dev) if codec is not None else None
    server_update = server_update or default_server_update
    coords = mesh_coords(mesh)

    def shard_state(state: ServerState) -> ServerState:
        return state._replace(
            variables=place(state.variables, state_sharding.variables),
            opt_state=place(state.opt_state, state_sharding.opt_state),
            residuals=place(state.residuals, state_sharding.residuals) if ef
            else state.residuals)

    def shard_data(arrays):
        x, y, mask, *scalars = arrays
        rows = shard_client_block(mesh, (x, y, mask), DP_AXIS)
        if exact_aggregation:
            return (*rows, *(_as_tensor(a, dev) for a in scalars))
        return (*rows, *shard_client_block(mesh, scalars, DP_AXIS))

    def whole(tree):
        return {c: {k: unshard(v, specs[c][k]) for k, v in sub.items()}
                for c, sub in tree.items()}

    def local(tree):
        return {c: {k: shard_slice(v, specs[c][k], sizes, coords).contiguous()
                    for k, v in sub.items()} for c, sub in tree.items()}

    @torch.no_grad()
    def round_fn(state, x, y, mask, num_samples, participation, slot_ids):
        with use_mesh(mesh), treelib.sharded_leaves(
                sharded, lambda t: replicated_out(t, MP_AXIS)):
            return _round(state, x, y, mask, num_samples, participation, slot_ids)

    def _round(state, x, y, mask, num_samples, participation, slot_ids):
        variables, opt_state = blocks(state.variables), blocks(state.opt_state)
        x, y, mask, num_samples, participation = (
            t.to(dev) for t in (x, y, mask, num_samples, participation))
        weights = participation * num_samples
        kl, me = int(x.shape[0]), axis_index(DP_AXIS)
        ids = torch.as_tensor(slot_ids).to(dev)
        all_ids = ids if exact_aggregation else all_gather(ids, DP_AXIS)
        all_ids = [int(i) for i in all_ids.cpu()]
        mine = range(me * kl, (me + 1) * kl)  # this rank's cohort positions
        k_round = rnglib.fold_in(state.key, state.round_idx)
        k_train = rnglib.fold_in(k_round, _TRAIN_STREAM)
        store, rows = (), {}
        if codec is not None:
            k_comp = rnglib.fold_in(k_round, COMPRESS_STREAM)
            whole_vars = whole(variables)
            global_flat = layout.flatten(whole_vars)
        if ef:
            store = treelib.tree_map(torch.clone, blocks(state.residuals))
            rows = _move_rows(store, all_ids, kl, fetch=True)
        clients, per_client = [], []
        for j, g in enumerate(mine):
            slot = all_ids[g]
            cvars, cm = lu(variables, x[j], y[j], mask[j], rnglib.fold_in(k_train, slot))
            if codec is not None:
                old = None
                if ef:
                    old = layout.flatten(whole(unflatten_like(variables,
                                                              _row_leaves(store, rows[g]))))
                server_view, new = uplink_roundtrip(codec, layout, global_flat, whole(cvars),
                                                    whole_vars, rnglib.fold_in(k_comp, slot), old)
                cvars = local(server_view)
                if ef:  # a client that did not report keeps its residual
                    kept = torch.where(participation[g if exact_aggregation else j] > 0,
                                       new, old)
                    rows[g] = torch.cat([v.reshape(-1) for _, v in jax_leaves(local(
                        unflatten_like(whole_vars, list(layout.split(kept)))))])
            clients.append(cvars)
            part = participation[g if exact_aggregation else j]
            per_client.append({name: part * v for name, v in cm.items()})
        if ef:
            _move_rows(store, all_ids, kl, fetch=False, rows=rows)
        stacked = treelib.tree_stack(clients)
        stats = {name: torch.stack([m[name] for m in per_client]) for name in per_client[0]}
        if exact_aggregation:
            stacked, stats = all_gather((stacked, stats), DP_AXIS)
            order = range(len(all_ids))
        else:
            order = range(kl)
        num, metrics = None, {}
        for k in order:
            num = treelib.tree_fold_weighted_f32(num, treelib.tree_index(stacked, k), weights[k])
            for name, v in stats.items():
                metrics[name] = metrics[name] + v[k] if name in metrics else v[k]
        den, n_participants = weights.sum(), participation.sum()
        if not exact_aggregation:
            num, den, n_participants, metrics = psum((num, den, n_participants, metrics),
                                                     DP_AXIS)
        agg = treelib.tree_map(
            lambda s, ref: torch.where(
                den > 0, (s / torch.clamp_min(den, 1e-12)).to(ref.dtype), ref),
            num, variables)
        new_vars, new_opt = server_update(variables, agg, opt_state)
        metrics["participants"] = n_participants
        return ServerState(rewrap(new_vars, state.variables), rewrap(new_opt, state.opt_state),
                           state.round_idx + 1, state.key,
                           rewrap(store, state.residuals) if ef else state.residuals), metrics

    def _move_rows(store, all_ids, kl, *, fetch: bool, rows=None):
        """Fetch the cohort's residual rows from the ``dp`` ranks that own
        them to the ones that train them (``fetch``), or send the trained
        rows back and write them (not ``fetch``).  Returns ``{cohort
        position: flat row}`` of this rank's positions."""
        per = int(next(iter(jax_leaves(store)))[1].shape[0])  # store rows this rank owns
        me = coords[DP_AXIS]
        sends, recvs, out = [], [], {}
        for g, slot in enumerate(all_ids):
            owner, trainer = slot // per, g // kl
            if fetch and owner == me:
                row = _flat_row(store, slot % per)
                if trainer == me:
                    out[g] = row
                else:
                    sends.append((trainer, row))
            elif fetch and trainer == me:
                recvs.append((g, owner))
            elif not fetch and trainer == me:
                if owner == me:
                    _set_row(store, slot % per, rows[g])
                else:
                    sends.append((owner, rows[g]))
            elif not fetch and owner == me:
                recvs.append((g, trainer))
        like = _flat_row(store, 0)
        got = _exchange(mesh, DP_AXIS, sends, [(peer, like) for _, peer in recvs])
        for (g, _), row in zip(recvs, got):
            if fetch:
                out[g] = row
            else:
                _set_row(store, all_ids[g] % per, row)
        return out

    return jit_sharded(round_fn), shard_state, shard_data


def cohort_shardings(mesh, variables_template: PyTree, table: RuleTable):
    """The layouts a muxed cohort's step takes (``CohortEngine``): the
    broadcast variables by rules over ``mp``, every per-client stacked
    array (data rows, keys, the output tree and its metrics) with the
    cohort axis on ``dp``.  Returns ``(var_in, data, var_out, stacked)``,
    where ``stacked`` is the plain ``("dp",)`` placement."""
    specs = match_partition_rules(table, variables_template)
    validate_divisibility(variables_template, specs, axis_sizes(mesh))
    var_in = named_sharding_tree(mesh, specs)
    stacked = Placement(mesh, (DP_AXIS,))
    var_out = treelib.tree_map(lambda s: Placement(mesh, (DP_AXIS, *s)), specs)
    return var_in, stacked, var_out, stacked


class CohortEngine:
    """The muxed cohort's step on a ``(dp, mp)`` mesh: JAX's
    ``jit_sharded(vmap(local_update.fn))`` under ``cohort_shardings``
    (``fedml_tpu/algorithms/fedavg_mux.py:194-222``), one rank per mesh
    position.

    A cohort of ``n`` clients (``dp`` dividing ``n``) lays its rows out as
    ``P("dp")``: the ranks of ``dp`` row ``k`` train the contiguous block of
    rows ``rows(n)``, one local update after another in row order.  The
    broadcast variables are laid out by ``table`` over ``mp``; the ``mp``
    ranks of a row gather the laid-out leaves at every forward and train the
    whole model (``_GatheredBundle``), so each row's result is bit for bit
    the single-device local update's at every ``mp``.  The trained rows come
    back laid out as ``var_out`` (rows over ``dp``, the parameter dims like
    the parameters'), and ``__call__`` gathers them over the mesh: every
    rank returns the whole cohort in row order.

    ``local_update`` is ``make_local_update`` over the plain bundle (rebuilt
    here over the gathering bundle); a variable's spec may name ``mp`` only.
    Every rank of ``mesh`` builds the engine and calls it for every cohort."""

    def __init__(self, mesh, local_update, variables_template: PyTree,
                 table: RuleTable = FEDLLM_RULES):
        if local_update.rebind is None or local_update.bundle is None:
            raise ValueError("the cohort engine rebuilds the local update over the laid-out "
                             "model: build it with make_local_update")
        self.mesh, self.sizes = mesh, axis_sizes(mesh)
        self.coords = mesh_coords(mesh)
        self.var_in, self.data, self.var_out, _ = cohort_shardings(
            mesh, variables_template, table)
        specs = treelib.tree_map(lambda p: p.spec, self.var_in)
        for path, spec in _leaves_with_path(specs):
            if set(spec_axes(spec)) - {MP_AXIS}:
                raise ValueError(f"rule table {table.name!r}: leaf {_leaf_path(path)!r} has "
                                 f"spec {spec}; the cohort engine lays variables over "
                                 f"{MP_AXIS!r} only ({DP_AXIS!r} carries the cohort)")
        self.lu = local_update.rebind(_GatheredBundle(local_update.bundle, specs, mesh))
        self.sharded = ([k for k, s in specs["params"].items() if is_sharded(s)]
                        if self.sizes[MP_AXIS] > 1 else [])

    def rows(self, n: int) -> range:
        """The rows of an ``n``-client cohort this rank trains."""
        (lo, hi), = block_index((n,), self.data.spec, self.sizes, self.coords)
        return range(lo, hi)

    def __call__(self, variables: PyTree, data, keys) -> Tuple[List[PyTree], List[Dict]]:
        """``variables``: the whole broadcast variables (the same on every
        rank); ``data``: ``(x, y, mask)`` of each of this rank's rows, and
        ``keys`` their threefry keys.  Returns the cohort's trained
        variables (whole leaves) and metrics (0-dim tensors), row by row."""
        laid = blocks(place(variables, self.var_in))
        with use_mesh(self.mesh), treelib.sharded_leaves(
                self.sharded, lambda t: replicated_out(t, MP_AXIS)):
            out = [self.lu(laid, x, y, mask, key) for (x, y, mask), key in zip(data, keys)]
            stacked = treelib.tree_stack([o[0] for o in out])
            metrics = {name: torch.stack([m[name] for _, m in out]) for name in out[0][1]}
            whole = map_tree(lambda b, p: unshard(b, p.spec), stacked, self.var_out)
            metrics = {name: unshard(v, self.data.spec) for name, v in metrics.items()}
        n = int(next(iter(jax_leaves(whole)))[1].shape[0])
        return ([treelib.tree_index(whole, k) for k in range(n)],
                [{name: v[k] for name, v in metrics.items()} for k in range(n)])
