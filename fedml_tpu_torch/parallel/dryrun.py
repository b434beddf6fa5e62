"""The multi-device check of the port (counterpart of the JAX package's
``__graft_entry__.py::dryrun_multichip``), and the rank bodies it and the
CPU parity tests launch.

``dryrun_multichip(n)`` launches ``n`` ranks (``compat.launch``) and holds
each part against its single-device oracle, computed on rank 0 from the
same inputs:

- **dp** — a full FedAvg round of ``resnet20(image_size=8)`` on a
  ``clients`` mesh (one client per rank), its block assembled through the
  host-local path: two simulated hosts, each packing ONLY its clients'
  rows (``subset_for_clients`` + ``host_client_range`` +
  ``shard_client_block_local``), equal byte for byte to the global
  block's rows; the round against ``make_round_fn`` on one device.
- **hier** (even ``n``) — the two-tier round on a ``(group, clients)``
  mesh against ``HierarchicalSimulation.run_round``.
- **gossip** — the ``ppermute`` ring against the dense ring matrix.
- **sp** — ``sequence_parallel_lm`` over a 1-D ``sp`` mesh (8 tokens a
  shard, the lax ring) against the plain full-sequence ``TransformerLM``.
- **dp_sp** (even ``n``) — a ``make_dp_sp_round_fn`` round on a ``(2,
  n/2)`` ``(clients, sp)`` mesh against ``make_round_fn`` over the plain
  transformer with ``blockwise_attention`` on one device.
- **dp_tp** (even ``n``) — a ``make_dp_tp_round_fn`` round on an ``(n/2,
  2)`` ``(clients, model)`` mesh (one client a row) against
  ``make_round_fn`` on one device.
- **tp** — one SGD step of ``tensor_parallel_lm`` over a 1-D ``tp`` mesh of
  every rank (4 heads: on 8 ranks every rank computes every head) against
  the same step of the plain transformer on one device.
- **pp** — the GPipe pipeline over a 1-D ``pp`` mesh (one ``tanh(h @ w) +
  h`` stage a rank, ``n + 2`` microbatches), forward and backward: each
  rank's stage gradient of ``mean(y²)`` against the sequential stages'.
- **ep** — the ``all_to_all`` MoE over a 1-D ``ep`` mesh (one expert a
  rank, capacity 4 of 4 local tokens) against the collective-free dense
  per-shard oracle (``moe_dense_oracle``).

The ``*_case`` functions are rank bodies: each runs on every rank of a
launch, builds its problem from a plain spec (numpy in, numpy out) and
returns this rank's results; ``run_cases`` runs several in one launch.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from fedml_tpu_torch.algorithms.decentralized import make_gossip_round_fn
from fedml_tpu_torch.algorithms.fedavg import FedAvgConfig, ServerState, make_round_fn
from fedml_tpu_torch.algorithms.base_framework import make_compiled_round
from fedml_tpu_torch.algorithms.hierarchical import HierarchicalSimulation
from fedml_tpu_torch.core import tree as treelib
from fedml_tpu_torch.core.client import make_client_optimizer, make_local_update
from fedml_tpu_torch.core.optrepo import get_server_optimizer
from fedml_tpu_torch.core import rng
from fedml_tpu_torch.core.rng import PRNGKey
from fedml_tpu_torch.core.topology import ring_topology
from fedml_tpu_torch.core.types import pack_clients
from fedml_tpu_torch.data.synthetic import synthetic_classification
from fedml_tpu_torch.models.linear import logistic_regression
from fedml_tpu_torch.models.base import functional_call
from fedml_tpu_torch.models.convert import from_jax_tree
from fedml_tpu_torch.models.transformer import Block, transformer_lm
from fedml_tpu_torch.models.resnet import resnet20
from fedml_tpu_torch.parallel.compat import (all_gather, axis_index, axis_size, launch,
                                             mesh_device, ppermute, psum, shard_map,
                                             use_mesh)
from fedml_tpu_torch.compress import get_codec, wire_decode_tree_sharded, wire_encode_tree_sharded
from fedml_tpu_torch.parallel import tensor as tensor_mod
from fedml_tpu_torch.parallel.dp_sp import make_dp_sp_mesh, make_dp_sp_round_fn
from fedml_tpu_torch.parallel.expert import (init_moe_params, make_ep_mesh, make_moe_ffn,
                                             moe_reference, shard_moe_params)
from fedml_tpu_torch.parallel.gspmd import (make_dp_tp_mesh, make_dp_tp_round_fn,
                                            opt_state_sharding_like)
from fedml_tpu_torch.parallel.layout import (Shard, axis_sizes, mesh_coords, shard_leaf,
                                             shard_slice, specs_of, unshard_tree)
from fedml_tpu_torch.parallel.mesh import describe_mesh, make_dp_mp_mesh, mesh_from_spec
from fedml_tpu_torch.parallel.pipeline import (make_gpipe, make_pp_mesh, serial_reference,
                                               shard_stage_params)
from fedml_tpu_torch.parallel.partition import (FEDLLM_RULES, CohortEngine,
                                                make_rule_round_fn, residual_store,
                                                resolve_rules, shard_by_rules)
from fedml_tpu_torch.parallel.ring_attention import (blockwise_attention, ring_attention,
                                                     ring_flash_attention)
from fedml_tpu_torch.parallel.sequence import make_sequence_mesh, sequence_parallel_lm
from fedml_tpu_torch.parallel.tensor import make_tp_mesh, tensor_parallel_lm
from fedml_tpu_torch.parallel.spmd import (
    host_client_range,
    hierarchical_pack,
    make_1d_mesh,
    make_client_mesh,
    make_group_mesh,
    make_hierarchical_spmd_round_fn,
    make_spmd_round_fn,
    replicate,
    shard_client_block,
    shard_client_block_local,
)
from fedml_tpu_torch.utils.device import DeviceLike, resolve_device

# the JAX dryrun's tolerance (``__graft_entry__.py::_assert_tree_allclose``)
RTOL, ATOL = 2e-4, 2e-5


def _bundle(model: Tuple, device):
    kind, *dims = model
    if kind == "lr":
        return logistic_regression(*dims, device=device)
    if kind == "resnet20":
        classes, side = dims
        return resnet20(num_classes=classes, image_size=side, device=device)
    raise ValueError(f"unknown model {model!r}")


def _problem(spec: Dict, device):
    ds = synthetic_classification(**spec["data"])
    bundle = _bundle(spec["model"], device)
    opt = make_client_optimizer(**spec["opt"])
    return ds, bundle, make_local_update(bundle, opt, epochs=spec["epochs"])


def _slot_args(pack, participation):
    n = pack.num_samples.shape[0]
    part = np.ones(n, np.float32) if participation is None else np.asarray(
        participation, np.float32)
    return (pack.x, pack.y, pack.mask, pack.num_samples, part,
            np.arange(n, dtype=np.int32))


def _host_of(world: int):
    return lambda r: 0 if world < 2 or r < world // 2 else 1


def spmd_case(spec: Dict) -> Dict:
    """One ``make_spmd_round_fn`` round on a ``clients`` mesh (with the
    reserved ``model`` axis of ``spec.get("model_axis", 1)``).  With
    ``hosts: 2`` each rank assembles its block from its simulated host's
    own pack (``subset_for_clients``) and reports whether it equals the
    global block's rows.  With ``single`` rank 0 also runs
    ``make_round_fn`` over every client on its device."""
    mesh = make_client_mesh(model_axis=spec.get("model_axis", 1),
                            device=spec["device"])
    dev = mesh_device(mesh)
    ds, bundle, lu = _problem(spec, dev)
    batch, seed = spec["batch"], spec.get("pack_seed", 0)
    n = ds.num_clients
    pack = pack_clients(ds, list(range(n)), batch_size=batch, seed=seed)
    raw = _slot_args(pack, spec.get("participation"))
    block = shard_client_block(mesh, raw)
    out: Dict[str, Any] = {"mesh": describe_mesh(mesh)}
    if spec.get("hosts", 1) == 2:
        world, rank = dist.get_world_size(), dist.get_rank()
        host_of = _host_of(world)
        r = host_client_range(mesh, n, process_index=host_of(rank),
                              host_of_device=host_of)
        local_ds = ds.subset_for_clients(list(r))
        local_pack = pack_clients(local_ds, list(r), batch_size=batch, seed=seed,
                                  steps_per_epoch=pack.x.shape[1])
        local = shard_client_block_local(mesh, n, {r.start: (
            local_pack.x, local_pack.y, local_pack.mask, local_pack.num_samples,
            raw[4][r.start:r.stop], raw[5][r.start:r.stop])})
        out["host_range"] = [r.start, r.stop]
        out["host_rows"] = [len(local_ds.train_x), len(ds.train_x)]
        out["local_equals_global"] = all(torch.equal(a, b) for a, b in zip(local, block))
        block = local
    key = PRNGKey(spec.get("key", 0))
    state = replicate(mesh, ServerState(bundle.init(key), (), 0, key))
    new_state, metrics = make_spmd_round_fn(mesh, lu, donate=False)(state, *block)
    out.update(variables=new_state.variables, metrics=metrics,
               round_idx=new_state.round_idx)
    if spec.get("single") and dist.get_rank() == 0:
        ref_state, ref_metrics = make_round_fn(lu, device=dev)(
            ServerState(bundle.init(key), (), 0, key),
            *(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in raw[:5]), raw[5])
        out["single"] = {"variables": ref_state.variables, "metrics": ref_metrics}
    return out


def hier_case(spec: Dict) -> Dict:
    """One global round of ``make_hierarchical_spmd_round_fn`` on a
    ``(group, clients)`` mesh over ``hierarchical_pack``'s block; with
    ``reference`` rank 0 also runs ``HierarchicalSimulation.run_round``
    from the same state."""
    groups, gcr = spec["num_groups"], spec["group_comm_round"]
    mesh = make_group_mesh(groups, device=spec["device"])
    dev = mesh_device(mesh)
    ds = synthetic_classification(**spec["data"])
    sim = HierarchicalSimulation(_bundle(spec["model"], dev), ds,
                                 FedAvgConfig(**spec["cfg"]), num_groups=groups,
                                 group_comm_round=gcr, device=dev)
    block, ids = hierarchical_pack(ds, sim.groups, sim.cfg.batch_size,
                                   sim.steps_per_epoch, sim.cfg.seed)
    args = shard_client_block(mesh, (*block, np.ones(len(ids), np.float32),
                                     np.asarray(ids, np.int32)), ("group", "clients"))
    hier = make_hierarchical_spmd_round_fn(mesh, sim.local_update, group_comm_round=gcr)
    state, metrics = hier(replicate(mesh, sim.state), *args)
    out = {"mesh": describe_mesh(mesh), "variables": state.variables,
           "metrics": metrics, "round_idx": state.round_idx}
    if spec.get("reference") and dist.get_rank() == 0:
        host = sim.run_round()
        out["reference"] = {"variables": sim.state.variables,
                            "metrics": {k: host[k] for k in ("loss_sum", "correct", "count")}}
    return out


def gossip_case(spec: Dict) -> Dict:
    """One SPMD gossip round, one client per rank of a 1-D ``clients``
    mesh: the ``ppermute`` ring (``ring``) or the ring matrix through
    ``all_gather``.  With ``reference`` rank 0 also runs the dense ring
    round over every client; the SPMD round returns this rank's row."""
    mesh = make_1d_mesh(axis="clients", device=spec["device"])
    dev = mesh_device(mesh)
    ds, bundle, lu = _problem(spec, dev)
    n = ds.num_clients
    pack = pack_clients(ds, list(range(n)), batch_size=spec["batch"],
                        seed=spec.get("pack_seed", 0))
    init = bundle.init(PRNGKey(spec["init_key"]))
    rng = PRNGKey(spec["rng_key"])
    ids = np.arange(n, dtype=np.int32)
    x, y, m, slot = shard_client_block(mesh, (pack.x, pack.y, pack.mask, ids))
    ring = spec["ring"]
    fn = shard_map(make_gossip_round_fn(lu, None if ring else ring_topology(n),
                                        axis_name="clients", ring=ring, device=dev),
                   mesh=mesh)
    mixed, metrics = fn(treelib.tree_stack([init]), x, y, m, rng, slot.cpu().numpy())
    out = {"variables": treelib.tree_index(mixed, 0), "metrics": metrics}
    if spec.get("reference") and dist.get_rank() == 0:
        dense = make_gossip_round_fn(lu, ring_topology(n), device=dev)
        ref, _ = dense(treelib.tree_stack([init] * n),
                       *(torch.from_numpy(a).to(dev) for a in (pack.x, pack.y, pack.mask)),
                       rng, ids)
        out["reference"] = ref
    return out


def compiled_case(spec: Dict) -> Dict:
    """``base_framework.make_compiled_round`` on a 1-D ``clients`` mesh."""
    mesh = make_1d_mesh(axis="clients", device=spec["device"])
    run = make_compiled_round(mesh)
    return {"history": run(spec["num_clients"], spec["comm_rounds"])}


def mesh_case(spec: Dict) -> Dict:
    """The mesh constructors and the collectives on this rank: a (clients,
    model) mesh with a reserved axis, ``mesh_from_spec("auto,2")``, the
    group mesh, a mesh larger than the world (its error), and ``psum``,
    ``all_gather`` (tiled and stacked), ``ppermute`` and ``axis_index`` of
    this rank's number."""
    dev = spec["device"]
    rank = dist.get_rank()
    out: Dict[str, Any] = {}
    mesh = make_client_mesh(model_axis=2, device=dev)
    out["client"] = describe_mesh(mesh)
    out["dp_mp"] = describe_mesh(mesh_from_spec("auto,2", device=dev))
    out["group"] = describe_mesh(make_group_mesh(2, device=dev))
    try:
        make_dp_mp_mesh(dist.get_world_size(), 2, device=dev)
    except ValueError as e:
        out["too_many"] = str(e)
    # the host-local assembly's refusals, on the (clients, model) mesh
    split = {0: 0, 1: 0, 4: 0, 5: 0}  # host 0 on clients rows 0 and 2
    refusals = [
        lambda: host_client_range(mesh, 6),
        lambda: host_client_range(mesh, 8, process_index=0,
                                  host_of_device=lambda r: split.get(r, 1)),
        lambda: shard_client_block_local(mesh, 8, {}),
        lambda: shard_client_block_local(mesh, 8, {1: (np.zeros((2, 1)),)}),
        lambda: shard_client_block_local(mesh, 8, {0: (np.zeros((2, 1)),)}),
    ]
    out["refusals"] = []
    for refusal in refusals:
        try:
            refusal()
            out["refusals"].append(None)
        except ValueError as e:
            out["refusals"].append(str(e))
    out["no_range"] = host_client_range(mesh, 8, process_index=99) == range(0)
    with use_mesh(mesh):
        mine = torch.tensor([float(rank)], device=mesh_device(mesh))
        n = axis_size("clients")
        out["index"] = [axis_index("clients"), axis_index("model"),
                        axis_index(("clients", "model")), n, axis_size(("clients", "model"))]
        out["psum"] = psum({"r": mine, "pair": (mine, 2 * mine)}, "clients")
        out["psum_both"] = psum(mine, ("clients", "model"))
        out["psum_const"] = psum(1, "clients")
        out["tiled"] = all_gather(mine, "clients")
        out["stacked"] = all_gather(mine, "clients", tiled=False)
        out["shift"] = ppermute(mine, "clients", [(i, (i + 1) % n) for i in range(n)])
        out["partial"] = ppermute(mine, "clients", [(0, 1)])
    return out


def grads_case(spec: Dict) -> Dict:
    """The collectives' backward on a 1-D ``sp`` mesh of the world: the
    gradients of ``Σ c_r · psum(w_r x_r)`` and of ``Σ c_r ·
    ppermute(w_r x_r)`` (a ring, and a permutation leaving ranks out) with
    respect to each rank's ``x_r``, where ``w_r = r + 1`` and ``c_r = r +
    10``; and the same collectives' forward bytes with and without
    autograd."""
    mesh = make_1d_mesh(axis="sp", device=spec["device"])
    dev = mesh_device(mesh)
    out: Dict[str, Any] = {}
    with use_mesh(mesh):
        r, n = axis_index("sp"), axis_size("sp")
        base = torch.arange(1.0, 4.0, device=dev) * (r + 1) + 0.5
        perms = {"psum": None, "ring": [(i, (i + 1) % n) for i in range(n)],
                 "partial": [(0, 1), (1, 3)]}
        for name, perm in perms.items():
            x = base.clone().requires_grad_(True)

            def coll(t, perm=perm):
                return psum(t, "sp") if perm is None else ppermute(t, "sp", perm)

            y = coll((r + 1) * x)
            (g,) = torch.autograd.grad((y * (r + 10)).sum(), [x])
            with torch.no_grad():
                plain = coll((r + 1) * base)
            out[name] = {"grad": g, "same_forward": torch.equal(y.detach(), plain)}
    return out


def _qkv_shard(spec, mesh, dev):
    """This rank's shards of the global q/k/v (and cotangent) along L."""
    n, i = mesh.size(0), mesh.get_local_rank(mesh.mesh_dim_names[0])
    L = spec["q"].shape[-3]

    def shard(a):
        a = np.asarray(a)
        part = a[..., i * (L // n):(i + 1) * (L // n), :, :]
        return torch.from_numpy(np.ascontiguousarray(part)).to(dev)

    return [shard(spec[k]) for k in ("q", "k", "v")], (
        shard(spec["cot"]) if spec.get("cot") is not None else None)


def ring_case(spec: Dict) -> Dict:
    """``ring_attention`` (``impl`` "lax", blocks of ``block``) or
    ``ring_flash_attention`` (``impl`` "flash") over a 1-D ``sp`` mesh of
    the world on this rank's L shard of the global ``q``/``k``/``v``
    (``[L, H, D]`` or ``[B, L, H, D]``); with ``cot``, also the gradients
    of ``Σ out · cot`` with respect to the rank's q, k and v shards."""
    mesh = make_sequence_mesh(device=spec["device"])
    dev = mesh_device(mesh)
    (q, k, v), cot = _qkv_shard(spec, mesh, dev)
    causal, block = spec["causal"], spec["block"]

    def attend(q, k, v):
        if spec["impl"] == "flash":
            return ring_flash_attention(q, k, v, "sp", causal=causal, block=block)
        return ring_attention(q, k, v, "sp", causal=causal, block_size=block)

    with use_mesh(mesh):
        if cot is None:
            return {"out": attend(q, k, v)}
        leaves = [t.requires_grad_(True) for t in (q, k, v)]
        out = attend(*leaves)
        grads = torch.autograd.grad((out * cot).sum(), leaves)
    return {"out": out.detach(), "grads": list(grads)}


def _lm_dims(spec: Dict) -> Dict:
    return {k: spec[k] for k in ("vocab_size", "embed_dim", "num_heads", "num_layers",
                                 "max_len")}


def _ring_kwargs(spec: Dict) -> Dict:
    """The ring's keywords: ``attn_impl`` and its block knob."""
    if spec["attn_impl"] == "flash":
        return {"attn_impl": "flash", "flash_block": spec.get("flash_block")}
    return {"attn_impl": spec["attn_impl"], "block_size": spec.get("block_size", 512)}


def sp_case(spec: Dict) -> Dict:
    """``sequence_parallel_lm`` over a 1-D ``sp`` mesh of the world: every
    rank's gathered logits of ``tokens`` ``[B, L]``, the variables drawn
    from ``PRNGKey(key)``; with ``reference`` rank 0 also runs the plain
    ``TransformerLM`` over the full sequence."""
    mesh = make_sequence_mesh(device=spec["device"])
    dev = mesh_device(mesh)
    _, init, apply = sequence_parallel_lm(mesh, **_lm_dims(spec), **_ring_kwargs(spec))
    variables = init(PRNGKey(spec["key"]))
    tokens = torch.from_numpy(np.asarray(spec["tokens"], np.int32))
    out = {"logits": apply(variables, tokens)}
    if spec.get("reference") and dist.get_rank() == 0:
        ref = transformer_lm(**{k: v for k, v in _lm_dims(spec).items() if k != "max_len"},
                             seq_len=spec["max_len"], device=dev)
        out["reference"] = ref.apply_eval(variables, tokens.to(dev))
    return out


def dp_sp_case(spec: Dict) -> Dict:
    """One ``make_dp_sp_round_fn`` round on a ``(clients, sp)`` mesh of
    ``spec["mesh"]`` over the global block ``spec["data"]``, SGD at
    ``lr``, the variables and key from ``PRNGKey(key)``; with ``single``
    rank 0 also runs ``make_round_fn`` over the plain full-length
    transformer with ``blockwise_attention`` (blocks of ``oracle_block``)
    on one device."""
    mesh = make_dp_sp_mesh(*spec["mesh"], device=spec["device"])
    dev = mesh_device(mesh)
    dims = _lm_dims(spec)
    opt = make_client_optimizer("sgd", spec["lr"])
    round_fn, shard_data, init_fn = make_dp_sp_round_fn(
        mesh, **dims, optimizer=opt, epochs=spec.get("epochs", 1), **_ring_kwargs(spec))
    key = PRNGKey(spec["key"])
    state = ServerState(init_fn(key), (), 0, key)
    new_state, metrics = round_fn(state, *shard_data(spec["data"]))
    out = {"mesh": describe_mesh(mesh), "variables": new_state.variables,
           "metrics": metrics, "round_idx": new_state.round_idx}
    if spec.get("single") and dist.get_rank() == 0:
        block = spec["oracle_block"]
        bundle = transformer_lm(
            **{k: v for k, v in dims.items() if k != "max_len"}, seq_len=dims["max_len"],
            attn_fn=lambda q, k, v, causal: blockwise_attention(
                q, k, v, causal=causal, block_size=block), device=dev)
        lu = make_local_update(bundle, opt, epochs=spec.get("epochs", 1))
        data = spec["data"]
        ref_state, ref_metrics = make_round_fn(lu, device=dev)(
            state, *(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in data[:5]),
            data[5])
        out["single"] = {"variables": ref_state.variables, "metrics": ref_metrics}
    return out


def run_main_case(spec: Dict) -> Dict:
    """``experiments.run.main(argv)`` on this rank, its metrics under
    ``run_dir/rank<r>``: the history, the final row and the mesh; with
    ``refused`` the ``ValueError`` it raises instead."""
    import os

    from fedml_tpu_torch.experiments import run

    argv = [*spec["argv"], "--run_dir",
            os.path.join(spec["run_dir"], f"rank{dist.get_rank()}")]
    if spec.get("refused"):
        try:
            run.main(argv)
        except ValueError as e:
            return {"error": str(e)}
        return {"error": None}
    out = run.main(argv)
    return {k: out[k] for k in ("history", "final", "mesh")}


def _tp_dims(spec: Dict) -> Dict:
    return {k: spec[k] for k in ("vocab_size", "embed_dim", "num_heads", "num_layers",
                                 "seq_len")}


def tp_case(spec: Dict) -> Dict:
    """``tensor_parallel_lm`` over a 1-D ``tp`` mesh of the world, the
    variables from ``PRNGKey(key)``: the forward of ``tokens``, this rank's
    blocks of the leaves named in ``blocks``, every leaf's spec; with
    ``steps``, that many ``train_step``s at ``lr`` on ``targets`` (the
    losses, the specs after, the whole variables gathered, and the largest
    spread of the ranks' replicated gradients, ``tensor.REPLICA_SPREAD``);
    ``skew`` rolls each rank's tokens by its rank, so that the ranks
    disagree.  A layout that does not divide returns its ``error``."""
    mesh = make_tp_mesh(device=spec["device"])
    try:
        bundle, shard_params, apply, train_step = tensor_parallel_lm(mesh, **_tp_dims(spec))
        variables = shard_params(bundle.init(PRNGKey(spec["key"])))
    except ValueError as e:
        return {"error": str(e)}
    out: Dict[str, Any] = {"logits": apply(variables, spec["tokens"]),
                           "blocks": {k: variables["params"][k].block
                                      for k in spec.get("blocks", ())},
                           "specs": specs_of(variables)["params"], "losses": []}
    tokens = (np.roll(spec["tokens"], dist.get_rank(), axis=1) if spec.get("skew")
              else spec["tokens"])
    tensor_mod.REPLICA_SPREAD.clear()
    for _ in range(spec.get("steps", 0)):
        variables, loss = train_step(variables, tokens, spec["targets"], spec["lr"])
        out["losses"].append(float(loss))
    if spec.get("steps"):
        out["spread"] = float(tensor_mod.REPLICA_SPREAD.get("tp", 0.0))
        out["specs_after"] = specs_of(variables)["params"]
        with use_mesh(mesh):
            out["variables"] = unshard_tree(variables)
    if spec.get("single") and dist.get_rank() == 0:
        out["single"] = _plain_steps(bundle, bundle.init(PRNGKey(spec["key"])), spec)
    return out


def _plain_steps(bundle, variables, spec: Dict) -> Dict:
    """``spec["steps"]`` SGD steps of the plain bundle on one device on the
    causal-LM loss of ``tensor_parallel_lm``'s ``train_step`` (its oracle)."""
    dev = bundle.device
    tokens, targets = (torch.as_tensor(np.asarray(spec[k])).to(dev)
                       for k in ("tokens", "targets"))
    losses = []
    for _ in range(spec["steps"]):
        params = {k: v.detach().requires_grad_(True) for k, v in variables["params"].items()}
        logp = torch.log_softmax(bundle.apply_eval({"params": params}, tokens).float(), -1)
        loss = -logp.gather(-1, targets.long()[..., None])[..., 0].mean()
        grads = torch.autograd.grad(loss, list(params.values()))
        variables = {"params": {k: (p - spec["lr"] * g).detach()
                                for (k, p), g in zip(params.items(), grads)}}
        losses.append(float(loss.detach()))
    return {"variables": variables, "losses": losses}


def _row_parallel_psum(x, axis):
    """A row-parallel sum whose backward psums the cotangent (``compat.psum``,
    JAX's transpose of a psum): the wrong operator at a row-parallel output."""
    return psum(x, axis)


def tp_grads_case(spec: Dict) -> Dict:
    """One ``TPBlock`` over a 1-D ``tp`` mesh of the world against the
    plain ``Block`` on this rank: the gradients of ``Σ out · cot`` with
    respect to every parameter (this rank's chunk of the whole block's) and
    to the input, from the whole parameters ``params`` (names under
    ``Block_0``); ``wrong`` the same with a psum-backward row-parallel sum."""
    mesh = make_tp_mesh(device=spec["device"])
    dev = mesh_device(mesh)
    E, H = spec["embed_dim"], spec["num_heads"]
    tp = axis_sizes(mesh)["tp"]
    whole = {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in spec["params"].items()}
    specs = tensor_mod.tp_param_spec({"params": {f"Block_0.{k}": v for k, v in whole.items()}},
                                     "tp")["params"]
    x, cot = (torch.from_numpy(np.asarray(spec[k])).to(dev) for k in ("x", "cot"))
    sizes, coords = axis_sizes(mesh), mesh_coords(mesh)

    def grads(module, params):
        leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        xin = x.clone().requires_grad_(True)
        out = functional_call(module, leaves, (xin,))
        g = torch.autograd.grad((out * cot).sum(), [*leaves.values(), xin])
        return dict(zip(leaves, g[:-1])), g[-1]

    plain_g, plain_dx = grads(Block(E, H), whole)
    mine = {k: shard_slice(v, specs[f"Block_0.{k}"], sizes, coords) for k, v in whole.items()}
    out = {"want": {k: shard_slice(g, specs[f"Block_0.{k}"], sizes, coords)
                    for k, g in plain_g.items()}, "want_dx": plain_dx}
    with use_mesh(mesh):
        out["got"], out["got_dx"] = grads(tensor_mod.TPBlock(E, H, tp, "tp"), mine)
        right = tensor_mod.replicated_out
        tensor_mod.replicated_out = _row_parallel_psum
        try:
            out["wrong"], out["wrong_dx"] = grads(tensor_mod.TPBlock(E, H, tp, "tp"), mine)
        finally:
            tensor_mod.replicated_out = right
    return out


def _lm_bundle(spec: Dict, device):
    return transformer_lm(**_tp_dims(spec), device=device)


def dp_tp_case(spec: Dict) -> Dict:
    """One ``make_dp_tp_round_fn`` round on a ``(clients, model)`` mesh of
    ``spec["mesh"]`` over the global block ``data``, the client optimizer
    ``opt`` (FedProx's ``prox_mu`` if given), the variables and key from
    ``PRNGKey(key)``; with ``fedadam`` the server runs Adam (lr 0.01) with its moments laid out
    like their parameters.  Returns the specs before and after, the whole
    variables gathered, the metrics, the optimizer state's 2-D leaves'
    (block shape, spec) and the largest spread of the ranks' replicated
    gradients; with ``single`` rank 0 also runs ``make_round_fn`` on one
    device."""
    from fedml_tpu_torch.algorithms.fedopt import make_fedopt_server_update

    mesh = make_dp_tp_mesh(*spec["mesh"], device=spec["device"])
    dev = mesh_device(mesh)
    bundle = _lm_bundle(spec, dev)
    lu = make_local_update(bundle, make_client_optimizer(**spec["opt"]), epochs=1,
                           prox_mu=spec.get("prox_mu", 0.0))
    key = PRNGKey(spec["key"])
    variables = bundle.init(key)
    opt_state, kw = (), {}
    if spec.get("fedadam"):
        server_opt = get_server_optimizer("adam", lr=0.01)
        opt_state = server_opt.init(variables["params"])
        kw = dict(server_update=make_fedopt_server_update(server_opt),
                  opt_state_sharding=opt_state_sharding_like(mesh, variables, opt_state,
                                                             axis="model"))
    round_fn, shard_state, shard_data = make_dp_tp_round_fn(mesh, lu, variables, **kw)
    state = shard_state(ServerState(variables, opt_state, 0, key))
    out: Dict[str, Any] = {"mesh": describe_mesh(mesh),
                           "specs": specs_of(state.variables)["params"]}
    tensor_mod.REPLICA_SPREAD.clear()
    new, metrics = round_fn(state, *shard_data(spec["data"]))
    out["spread"] = float(tensor_mod.REPLICA_SPREAD.get("model", 0.0))
    with use_mesh(mesh):
        out.update(specs_after=specs_of(new.variables)["params"], metrics=metrics,
                   round_idx=new.round_idx, variables=unshard_tree(new.variables))
    out["opt_leaves"] = [(tuple(leaf.block.shape), leaf.spec)
                         for leaf in _shards_of(new.opt_state) if len(leaf.shape) == 2]
    if spec.get("single") and dist.get_rank() == 0:
        ref, ref_m = make_round_fn(lu, device=dev, **({"server_update": kw["server_update"]}
                                                      if kw else {}))(
            ServerState(variables, opt_state, 0, key),
            *(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in spec["data"][:5]),
            spec["data"][5])
        out["single"] = {"variables": ref.variables, "metrics": ref_m}
    return out


def _shards_of(tree) -> list:
    """The ``Shard``s of a tree (dicts, lists, tuples)."""
    if isinstance(tree, Shard):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _shards_of(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _shards_of(v)]
    return []


def _digest(variables: Dict) -> str:
    """sha256 over a variables tree's names and bytes, in JAX's leaf order."""
    import hashlib

    from fedml_tpu_torch.compress.codecs import jax_leaves

    h = hashlib.sha256()
    for path, leaf in jax_leaves(variables):
        h.update("/".join(path).encode())
        h.update(leaf.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def rules_case(spec: Dict) -> Dict:
    """``make_rule_round_fn`` rounds on a ``(dp, mp)`` mesh of ``spec["mesh"]``
    over the first dp*mp ranks (the others return ``{"member": False}``):
    the transformer ``transformer_lm(**dims)`` from ``PRNGKey(0)``, SGD at
    ``lr``, the key ``PRNGKey(seed)``, ``rounds`` rounds over the global
    block ``data`` under ``table`` (a name or a JSON path) with ``codec``
    and ``ef``.  Returns the whole final variables gathered, their digest,
    the metrics of each round, the residual store's digest, and the bytes of
    this rank's store as it was made (``residual_store``) and after the
    rounds."""
    dp, mp = spec["mesh"]
    mesh = make_dp_mp_mesh(dp, mp, devices=list(range(dp * mp)), device=spec["device"])
    if mesh.get_coordinate() is None:
        return {"member": False}
    dev = mesh_device(mesh)
    bundle = _lm_bundle(spec, dev)
    lu = make_local_update(bundle, make_client_optimizer("sgd", spec["lr"]), epochs=1)
    variables = bundle.init(PRNGKey(0))
    codec = get_codec(spec.get("codec") or None)
    ef = bool(spec.get("ef")) and codec is not None
    clients = int(np.asarray(spec["data"][0]).shape[0])
    table = resolve_rules(spec.get("table", "fedllm"))
    residuals = (residual_store(mesh, variables, table, spec.get("num_clients", clients))
                 if ef else ())
    made = _store_bytes(residuals)
    state = ServerState(variables, (), 0, PRNGKey(spec["seed"]), residuals)
    round_fn, shard_state, shard_data = make_rule_round_fn(
        mesh, lu, variables, table, codec=codec, error_feedback=ef,
        exact_aggregation=spec.get("exact", True))
    state = shard_state(state)
    metrics = []
    for _ in range(spec["rounds"]):
        state, m = round_fn(state, *shard_data(spec["data"]))
        metrics.append(m)
    with use_mesh(mesh):
        whole = unshard_tree(state.variables)
        store = unshard_tree(state.residuals) if ef else {}
    return {"member": True, "mesh": describe_mesh(mesh), "variables": whole,
            "digest": _digest(whole), "metrics": metrics,
            "residual_digest": _digest(store) if ef else None,
            "store_bytes": {"made": made, "after": _store_bytes(state.residuals)}}


def cohort_case(spec: Dict) -> Dict:
    """A muxed cohort's step (``partition.CohortEngine``) on a ``(dp, mp)``
    mesh of ``spec["mesh"]`` over the first dp*mp ranks (the others return
    ``{"member": False}``): the transformer ``transformer_lm(**dims)`` from
    ``PRNGKey(0)``, SGD at ``lr``, under ``table``, over the cohort's
    per-client blocks ``data`` (x, y, mask), each row keyed as the muxer
    keys it (``fold_in(fold_in(fold_in(PRNGKey(seed), round), 0), slot)``
    for ``slots``).  Returns the rows this rank trained and every row's
    trained variables and metrics; with ``single`` rank 0 also runs the
    mesh-free loop (the plain local update, row by row)."""
    dp, mp = spec["mesh"]
    mesh = make_dp_mp_mesh(dp, mp, devices=list(range(dp * mp)), device=spec["device"])
    if mesh.get_coordinate() is None:
        return {"member": False}
    dev = mesh_device(mesh)
    bundle = _lm_bundle(spec, dev)
    lu = make_local_update(bundle, make_client_optimizer("sgd", spec["lr"]), epochs=1)
    variables = bundle.init(PRNGKey(0))
    engine = CohortEngine(mesh, lu, variables, resolve_rules(spec.get("table", "fedllm")))
    x, y, mask = (torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in spec["data"])
    k_train = rng.fold_in(rng.fold_in(PRNGKey(spec["seed"]), spec["round"]), 0)
    keys = [rng.fold_in(k_train, int(s)) for s in spec["slots"]]
    rows = engine.rows(int(x.shape[0]))
    trained, metrics = engine(variables, [(x[r], y[r], mask[r]) for r in rows],
                              [keys[r] for r in rows])
    out = {"member": True, "mine": list(rows), "rows": trained, "metrics": metrics}
    if spec.get("single") and dist.get_rank() == 0:
        out["single"] = [lu(variables, x[k], y[k], mask[k], keys[k])
                         for k in range(int(x.shape[0]))]
    return out


def _store_bytes(store) -> int:
    """The bytes a rank holds of a laid-out store."""
    return sum(s.block.numel() * s.block.element_size() for s in _shards_of(store))


def wire_case(spec: Dict) -> Dict:
    """``wire_encode_tree_sharded`` of the transformer from ``PRNGKey(0)``
    laid out by ``FEDLLM_RULES`` on a ``(dp, mp)`` mesh of ``spec["mesh"]``
    over the first dp*mp ranks, for each codec of ``codecs`` under
    ``PRNGKey(seed)``: the entries and, decoded, the whole leaves."""
    dp, mp = spec["mesh"]
    mesh = make_dp_mp_mesh(dp, mp, devices=list(range(dp * mp)), device=spec["device"])
    if mesh.get_coordinate() is None:
        return {"member": False}
    variables = _lm_bundle(spec, mesh_device(mesh)).init(PRNGKey(0))
    sharded, _ = shard_by_rules(mesh, variables, FEDLLM_RULES)
    out: Dict[str, Any] = {"member": True}
    with use_mesh(mesh):
        for name in spec["codecs"]:
            codec = get_codec(name)
            entries = wire_encode_tree_sharded(codec, sharded, PRNGKey(spec["seed"]))
            out[name] = {"entries": entries,
                         "decoded": wire_decode_tree_sharded(codec, entries, variables)}
    return out


def collectives_case(spec: Dict) -> Dict:
    """``all_gather`` along dimension 1 (tiled and stacked) and
    ``psum_scatter`` (tiled along dimension 1, and untiled) over a 1-D
    ``x`` mesh of the world, of ``(r + 1) * base`` on rank r (``base`` a
    ``[2, n, 3]`` array), and the gradient of ``Σ c · all_gather(x)`` with
    respect to this rank's x for ``c`` the same on every rank."""
    from fedml_tpu_torch.parallel.compat import psum_scatter

    mesh = make_1d_mesh(axis="x", device=spec["device"])
    dev = mesh_device(mesh)
    base = torch.from_numpy(np.asarray(spec["base"], np.float32)).to(dev)
    with use_mesh(mesh):
        mine = (axis_index("x") + 1) * base
        x = mine.clone().requires_grad_(True)
        gathered = all_gather(x, "x", axis=1)
        cot = torch.from_numpy(np.asarray(spec["cot"], np.float32)).to(dev)
        (grad,) = torch.autograd.grad((gathered * cot).sum(), [x])
        return {"tiled": gathered.detach(), "stacked": all_gather(mine, "x", axis=1, tiled=False),
                "scatter": psum_scatter(mine, "x", scatter_dimension=1),
                "scatter_untiled": psum_scatter(mine, "x", scatter_dimension=1, tiled=False),
                "grad": grad}


def _tanh_stage(p, h):
    return torch.tanh(h @ p["w"]) + h


def _mlp_stage(p, h):
    return torch.tanh(h @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"] + h


class BlockStage(torch.nn.Module):
    """A pipeline stage of ``depth`` transformer ``Block``s, whose
    parameters are named as flax names a module's ``Block_<i>`` children."""

    def __init__(self, embed_dim: int, num_heads: int, depth: int):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"Block_{i}", Block(embed_dim, num_heads))

    def forward(self, x):
        for i in range(self.depth):
            x = getattr(self, f"Block_{i}")(x)
        return x


def block_stage_fn(embed_dim: int, num_heads: int, depth: int):
    """``stage_fn(params, x)`` of a ``BlockStage``: its parameters are the
    stage's ``Block_<i>.<name>`` leaves."""
    stage = BlockStage(embed_dim, num_heads, depth)
    return lambda p, h: functional_call(stage, p, (h,))


def _stage_fn(spec: Dict):
    if spec["stage"] == "tanh":
        return _tanh_stage
    if spec["stage"] == "mlp":
        return _mlp_stage
    return block_stage_fn(*spec["blocks"])


def _pp_loss(y, spec: Dict, dev):
    if spec.get("target") is None:
        return (y ** 2).mean()
    return ((y - torch.from_numpy(np.asarray(spec["target"])).to(dev)) ** 2).mean()


def pp_case(spec: Dict) -> Dict:
    """``make_gpipe`` over a 1-D ``pp`` mesh of the world: stage ``stage``
    ("tanh", "mlp" or "blocks" of ``(embed_dim, num_heads, depth)``) over
    the stacked parameters ``stacked`` (numpy, ``[S, ...]``) and the
    microbatches ``x``.  Returns the forward and, with ``grads``, the loss
    (``mean((y - target)²)``, or ``mean(y²)`` without ``target``) and this
    rank's stage gradients; with ``refusal`` the ``ValueError`` of twice the
    stages; with ``reference`` rank 0 also runs ``serial_reference`` (its
    forward, and every stage's gradients)."""
    mesh = make_pp_mesh(device=spec["device"])
    dev = mesh_device(mesh)
    fn = _stage_fn(spec)
    stacked = from_jax_tree(spec["stacked"], dev)
    x = torch.from_numpy(np.asarray(spec["x"])).to(dev)
    apply = make_gpipe(mesh, fn)
    out: Dict[str, Any] = {}
    if spec.get("refusal"):
        try:
            apply(shard_stage_params(mesh, {k: torch.cat([v, v]) for k, v in stacked.items()}),
                  x)
            out["refusal"] = None
        except ValueError as e:
            out["refusal"] = str(e)
    params = shard_stage_params(mesh, stacked)
    with torch.no_grad():
        out["out"] = apply(params, x)
    if spec.get("grads"):
        leaves = {k: v._replace(block=v.block.clone().requires_grad_(True))
                  for k, v in params.items()}
        loss = _pp_loss(apply(leaves, x), spec, dev)
        grads = torch.autograd.grad(loss, [v.block for v in leaves.values()])
        out["loss"] = float(loss.detach())
        out["grads"] = {k: g[0] for k, g in zip(leaves, grads)}
    if spec.get("reference") and dist.get_rank() == 0:
        whole = {k: v.clone().requires_grad_(True) for k, v in stacked.items()}
        ys = serial_reference(fn, whole, x)
        grads = torch.autograd.grad(_pp_loss(ys, spec, dev), list(whole.values()))
        out["reference"] = {"out": ys.detach(), "grads": dict(zip(whole, grads))}
    return out


def moe_dense_oracle(params: Dict, x, n_shards: int, capacity: int):
    """Top-1 MoE with per-SHARD capacity queues, computed densely on one
    device (every expert's FFN on every token, one-hot select): independent
    of ``all_to_all`` (``__graft_entry__.py``'s oracle)."""
    t = x.shape[0] // n_shards
    outs = []
    for s in range(n_shards):
        xs = x[s * t:(s + 1) * t]
        logits = xs @ params["gate"]
        probs = torch.softmax(logits, dim=-1)
        expert = torch.argmax(logits, dim=-1)
        gate = torch.take_along_dim(probs, expert[:, None], dim=1)[:, 0]
        onehot = (expert[:, None] == torch.arange(n_shards, device=x.device)).to(x.dtype)
        pos = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(1)
        keep = (pos < capacity).to(x.dtype)
        dense = torch.stack([torch.relu(xs @ params["w_in"][e]) @ params["w_out"][e]
                             for e in range(n_shards)], 1)  # [t, E, d]
        sel = torch.einsum("te,ted->td", onehot, dense)
        outs.append(sel * (gate * keep)[:, None])
    return torch.cat(outs, 0)


def ep_case(spec: Dict) -> Dict:
    """``make_moe_ffn`` at ``capacity`` over a 1-D ``ep`` mesh of the world,
    the parameters ``params`` (numpy) or ``init_moe_params(PRNGKey(key),
    world, d_model, d_hidden)`` (returned on rank 0), the tokens ``x``
    ``[T, d]``: this rank's output block; with ``cot`` also the gradients of
    ``Σ out · cot`` with respect to the gate, this rank's expert weights and
    its token block; with ``refusals`` the two ``ValueError``s; with
    ``reference`` rank 0 also runs ``moe_reference`` and ``moe_dense_oracle``."""
    mesh = make_ep_mesh(device=spec["device"])
    dev = mesh_device(mesh)
    E, cap = axis_sizes(mesh)["ep"], spec["capacity"]
    out: Dict[str, Any] = {}
    if spec.get("params") is not None:
        params = from_jax_tree(spec["params"], dev)
    else:
        params = init_moe_params(PRNGKey(spec["key"]), E, spec["d_model"], spec["d_hidden"],
                                 device=dev)
        if dist.get_rank() == 0:
            out["params"] = params
    x = torch.from_numpy(np.asarray(spec["x"])).to(dev)
    apply = make_moe_ffn(mesh, cap)
    sharded = shard_moe_params(mesh, params)
    with torch.no_grad():
        out["out"] = apply(sharded, x).block
    if spec.get("refusals"):
        out["refusals"] = []
        extra = shard_moe_params(mesh, {k: v if k == "gate" else torch.cat([v, v])
                                        for k, v in params.items()})
        for args in ((extra, x), (sharded, x[:-1])):
            try:
                apply(*args)
                out["refusals"].append(None)
            except ValueError as e:
                out["refusals"].append(str(e))
    if spec.get("cot") is not None:
        leaves = {k: v._replace(block=v.block.clone().requires_grad_(True))
                  for k, v in sharded.items()}
        xs = shard_leaf(mesh, x, ("ep",))
        xs = xs._replace(block=xs.block.requires_grad_(True))
        y = apply(leaves, xs)
        cot = shard_slice(torch.from_numpy(np.asarray(spec["cot"])).to(dev), ("ep",),
                          axis_sizes(mesh), mesh_coords(mesh))
        grads = torch.autograd.grad((y.block * cot).sum(),
                                    [*(v.block for v in leaves.values()), xs.block])
        out["grads"] = {**dict(zip(leaves, grads[:-1])), "x": grads[-1]}
    if spec.get("reference") and dist.get_rank() == 0:
        out["reference"] = moe_reference(params, x)
        out["dense"] = moe_dense_oracle(params, x, E, cap)
    return out


def a2a_case(spec: Dict) -> Dict:
    """``compat.all_to_all`` over a 1-D ``x`` mesh of the world, for each
    ``(split_axis, concat_axis)`` of ``axes``: rank r's operand is its block
    (along dimension 0) of the global ``x``; returns the result and the
    gradient of ``Σ result · cot_r``, ``cot_r`` rank r's block of the global
    ``cot`` of that pair."""
    from fedml_tpu_torch.parallel.compat import all_to_all

    mesh = make_1d_mesh(axis="x", device=spec["device"])
    dev = mesh_device(mesh)
    sizes, coords = axis_sizes(mesh), mesh_coords(mesh)
    mine = shard_slice(torch.from_numpy(np.asarray(spec["x"])).to(dev), ("x",), sizes, coords)
    out = []
    with use_mesh(mesh):
        for (split_axis, concat_axis), cot in zip(spec["axes"], spec["cots"]):
            leaf = mine.clone().requires_grad_(True)
            y = all_to_all(leaf, "x", split_axis=split_axis, concat_axis=concat_axis)
            cot = shard_slice(torch.from_numpy(np.asarray(cot)).to(dev), ("x",), sizes, coords)
            (grad,) = torch.autograd.grad((y * cot).sum(), [leaf])
            out.append({"y": y.detach(), "grad": grad})
    return {"pairs": out}


CASES = {"mesh": mesh_case, "spmd": spmd_case, "hier": hier_case, "gossip": gossip_case,
         "compiled": compiled_case, "grads": grads_case, "ring": ring_case, "sp": sp_case,
         "dp_sp": dp_sp_case, "run_main": run_main_case, "tp": tp_case,
         "tp_grads": tp_grads_case, "dp_tp": dp_tp_case, "rules": rules_case,
         "wire": wire_case, "collectives": collectives_case, "pp": pp_case, "ep": ep_case,
         "a2a": a2a_case, "cohort": cohort_case}


def run_cases(cases: Sequence[Tuple[str, Dict]]) -> List[Dict]:
    """Rank body: each ``(kind, spec)`` of ``cases`` in turn, on this rank;
    each result also carries the case's wall ``seconds`` on this rank."""
    out = []
    for kind, spec in cases:
        t0 = time.perf_counter()
        res = CASES[kind](spec)
        res["seconds"] = time.perf_counter() - t0
        out.append(res)
    return out


def dryrun_cases(n_devices: int, device: str) -> List[Tuple[str, Dict]]:
    """The dryrun's parts for an ``n_devices`` mesh (the JAX dryrun's
    geometries)."""
    cases = [("spmd", dict(
        device=device, data=dict(num_train=n_devices * 16, num_test=16,
                                 input_shape=(8, 8, 3), num_classes=4,
                                 num_clients=n_devices, partition="homo", seed=0),
        model=("resnet20", 4, 8), opt=dict(name="sgd", lr=0.1, momentum=0.9),
        epochs=1, batch=8, hosts=2 if n_devices >= 2 else 1, single=True))]
    if n_devices % 2 == 0:
        cases.append(("hier", dict(
            device=device, data=dict(num_train=n_devices * 24, num_test=16,
                                     input_shape=(12,), num_classes=4,
                                     num_clients=n_devices, partition="homo", seed=1),
            model=("lr", 12, 4), num_groups=2, group_comm_round=2, reference=True,
            cfg=dict(num_clients=n_devices, clients_per_round=n_devices,
                     comm_rounds=1, epochs=1, batch_size=8, lr=0.2, seed=0))))
    cases.append(("gossip", dict(
        device=device, data=dict(num_train=n_devices * 24, num_test=16,
                                 input_shape=(12,), num_classes=4,
                                 num_clients=n_devices, partition="homo", seed=2),
        model=("lr", 12, 4), opt=dict(name="sgd", lr=0.1), epochs=1, batch=8,
        init_key=9, rng_key=10, ring=True, reference=True)))
    lm = dict(vocab_size=32, embed_dim=16, num_heads=2, num_layers=1)
    cases.append(("sp", dict(
        device=device, **lm, max_len=8 * n_devices, attn_impl="lax", block_size=8, key=4,
        tokens=np.random.RandomState(5).randint(0, 32, (1, 8 * n_devices)),
        reference=True)))
    if n_devices % 2 == 0:
        sp = n_devices // 2
        lg = 8 * sp  # the global sequence: 8 tokens a shard
        xs = np.random.RandomState(3).randint(0, 32, (2, 2, 2, lg)).astype(np.int32)
        cases.append(("dp_sp", dict(
            device=device, **lm, max_len=lg, mesh=(2, sp), lr=0.1, attn_impl="lax",
            block_size=8, oracle_block=8, key=12, single=True,
            data=(xs, np.roll(xs, -1, axis=-1), np.ones((2, 2, 2), np.float32),
                  np.full((2,), 2 * 2 * lg, np.float32), np.ones((2,), np.float32),
                  np.arange(2, dtype=np.int32)))))
    tlm = dict(vocab_size=32, embed_dim=16, num_heads=4, num_layers=1, seq_len=8)
    if n_devices % 2 == 0:
        n_cl = n_devices // 2  # one client a clients row
        xt = np.random.RandomState(0).randint(0, 32, (n_cl, 2, 2, 8)).astype(np.int32)
        cases.append(("dp_tp", dict(
            device=device, **tlm, mesh=(n_cl, 2), key=8, single=True,
            opt=dict(name="sgd", lr=0.1, momentum=0.9),
            data=(xt, np.roll(xt, -1, axis=-1), np.ones((n_cl, 2, 2), np.float32),
                  np.full((n_cl,), 32, np.float32), np.ones((n_cl,), np.float32),
                  np.arange(n_cl, dtype=np.int32)))))
    toks = np.random.RandomState(1).randint(0, 32, (2, 8)).astype(np.int32)
    cases.append(("tp", dict(device=device, **tlm, key=0, tokens=toks,
                             targets=np.roll(toks, -1, axis=1), steps=1, lr=0.1,
                             single=True)))
    # the JAX dryrun's draws, through the port's threefry
    stages = [rng.normal(rng.fold_in(PRNGKey(2), s), (8, 8)) * 0.2 for s in range(n_devices)]
    cases.append(("pp", dict(device=device, stage="tanh",
                             stacked={"w": torch.stack(stages).numpy()},
                             x=rng.normal(PRNGKey(3), (n_devices + 2, 2, 8)).numpy(),
                             grads=True, reference=True)))
    cases.append(("ep", dict(device=device, key=6, d_model=8, d_hidden=16, capacity=4,
                             x=rng.normal(PRNGKey(7), (4 * n_devices, 8)).numpy(),
                             reference=True)))
    return cases


def _assert_close(got, want, what: str) -> float:
    """Every leaf within the dryrun's tolerance; returns the largest |Δ|."""
    flat_g, flat_w = treelib.tree_leaves(got), treelib.tree_leaves(want)
    if len(flat_g) != len(flat_w):
        raise AssertionError(f"multi-chip {what}: {len(flat_g)} leaves, want {len(flat_w)}")
    for a, b in zip(flat_g, flat_w):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=RTOL, atol=ATOL,
            err_msg=f"multi-chip {what} diverged from single-device oracle")
    return max(float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())
               for a, b in zip(flat_g, flat_w))


def dryrun_multichip(n_devices: int, device: DeviceLike = None, *,
                     timeout: float = 600.0) -> Dict:
    """Launch ``n_devices`` ranks on ``device`` (the card by default: one
    card per rank under NCCL; ``"cpu"`` runs gloo ranks) and hold every
    part of the dryrun against its single-device oracle within the JAX
    dryrun's rtol 2e-4 / atol 2e-5.  Raises on any disagreement; returns
    the mesh, the parts run and each part's largest |Δ| over every rank."""
    dev = resolve_device(device).type
    cases = dryrun_cases(n_devices, dev)
    return check_parts(cases, launch(run_cases, n_devices, cases, device=dev, timeout=timeout))


def check_parts(cases: Sequence[Tuple[str, Dict]], ranks: List[List[Dict]]) -> Dict:
    """Hold every rank's result of each dryrun part (``ranks[r][i]`` for
    ``cases[i]``) against its oracle on rank 0; raises on any
    disagreement, returns the mesh, the parts and each part's largest |Δ|."""
    summary: Dict[str, Any] = {"mesh": ranks[0][0].get("mesh"), "parts": [], "max_gap": {}}
    for i, (kind, _) in enumerate(cases):
        ref = ranks[0][i]
        gaps = []
        for rank, res in enumerate(r[i] for r in ranks):
            if kind == "spmd":
                if res.get("local_equals_global") is False:
                    raise AssertionError(f"rank {rank}: the host-local block is not "
                                         "the global block's rows")
                if res["round_idx"] != 1 or not np.isfinite(res["metrics"]["loss_sum"]):
                    raise AssertionError(f"rank {rank}: dp round did not complete")
                gaps.append(_assert_close(res["variables"], ref["single"]["variables"],
                                          "dp round"))
                np.testing.assert_allclose(res["metrics"]["loss_sum"],
                                           ref["single"]["metrics"]["loss_sum"], rtol=1e-4)
            elif kind == "hier":
                if res["round_idx"] != 1:
                    raise AssertionError(f"rank {rank}: hier round did not complete")
                gaps.append(_assert_close(res["variables"], ref["reference"]["variables"],
                                          "hier (group, clients) round"))
                np.testing.assert_allclose(res["metrics"]["loss_sum"],
                                           ref["reference"]["metrics"]["loss_sum"],
                                           rtol=1e-4)
            elif kind == "gossip":
                gaps.append(_assert_close(res["variables"],
                                          treelib.tree_index(ref["reference"], rank),
                                          "gossip ppermute ring"))
            elif kind == "sp":
                gaps.append(_assert_close(res["logits"], ref["reference"],
                                          "sp ring-attention LM forward"))
            elif kind == "tp":
                if not np.isfinite(res["losses"]).all():
                    raise AssertionError(f"rank {rank}: tp step gave a non-finite loss")
                np.testing.assert_allclose(res["losses"], ref["single"]["losses"], rtol=1e-4)
                gaps.append(_assert_close(res["variables"], ref["single"]["variables"],
                                          "tp transformer step"))
            elif kind == "dp_tp":
                if res["round_idx"] != 1 or not np.isfinite(res["metrics"]["loss_sum"]):
                    raise AssertionError(f"rank {rank}: dp×tp round did not complete")
                gaps.append(_assert_close(res["variables"], ref["single"]["variables"],
                                          "dp×tp round"))
                np.testing.assert_allclose(res["metrics"]["loss_sum"],
                                           ref["single"]["metrics"]["loss_sum"], rtol=1e-4)
            elif kind == "pp":
                want = ref["reference"]
                gaps.append(_assert_close(res["out"], want["out"], "pp pipeline forward"))
                gaps.append(_assert_close({k: g for k, g in res["grads"].items()},
                                          {k: g[rank] for k, g in want["grads"].items()},
                                          "pp pipeline gradient"))
            elif kind == "ep":
                t = res["out"].shape[0]
                gaps.append(_assert_close(res["out"], ref["dense"][rank * t:(rank + 1) * t],
                                          "ep MoE dispatch"))
            else:
                if res["round_idx"] != 1:
                    raise AssertionError(f"rank {rank}: dp×sp round did not complete")
                gaps.append(_assert_close(res["variables"], ref["single"]["variables"],
                                          "dp×sp round"))
                np.testing.assert_allclose(res["metrics"]["loss_sum"],
                                           ref["single"]["metrics"]["loss_sum"], rtol=1e-4)
        summary["parts"].append(kind)
        summary["max_gap"][kind] = max(gaps)
    return summary
