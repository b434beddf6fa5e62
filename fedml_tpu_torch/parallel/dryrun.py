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

The JAX dryrun's dp×tp, tp, pp and ep parts need the engines of ROADMAP
queue A items 6c-6d, which are not ported yet; they are not run here.

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
from fedml_tpu_torch.core.rng import PRNGKey
from fedml_tpu_torch.core.topology import ring_topology
from fedml_tpu_torch.core.types import pack_clients
from fedml_tpu_torch.data.synthetic import synthetic_classification
from fedml_tpu_torch.models.linear import logistic_regression
from fedml_tpu_torch.models.transformer import transformer_lm
from fedml_tpu_torch.models.resnet import resnet20
from fedml_tpu_torch.parallel.compat import (all_gather, axis_index, axis_size, launch,
                                             mesh_device, ppermute, psum, shard_map,
                                             use_mesh)
from fedml_tpu_torch.parallel.dp_sp import make_dp_sp_mesh, make_dp_sp_round_fn
from fedml_tpu_torch.parallel.mesh import describe_mesh, make_dp_mp_mesh, mesh_from_spec
from fedml_tpu_torch.parallel.ring_attention import (blockwise_attention, ring_attention,
                                                     ring_flash_attention)
from fedml_tpu_torch.parallel.sequence import make_sequence_mesh, sequence_parallel_lm
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
    ``run_dir/rank<r>``: the history, the final row and the mesh."""
    import os

    from fedml_tpu_torch.experiments import run

    out = run.main([*spec["argv"], "--run_dir",
                    os.path.join(spec["run_dir"], f"rank{dist.get_rank()}")])
    return {k: out[k] for k in ("history", "final", "mesh")}


CASES = {"mesh": mesh_case, "spmd": spmd_case, "hier": hier_case, "gossip": gossip_case,
         "compiled": compiled_case, "grads": grads_case, "ring": ring_case, "sp": sp_case,
         "dp_sp": dp_sp_case, "run_main": run_main_case}


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
    ranks = launch(run_cases, n_devices, cases, device=dev, timeout=timeout)
    summary: Dict[str, Any] = {"mesh": ranks[0][0]["mesh"], "parts": [], "max_gap": {}}
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
