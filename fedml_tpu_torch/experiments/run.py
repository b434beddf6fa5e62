"""Unified experiment entry point (port of ``fedml_tpu/experiments/run.py``).

    python -m fedml_tpu_torch.experiments.run --algorithm fedllm \
        --dataset fed_shakespeare --comm_round 10

    python -m fedml_tpu_torch.experiments.main_fedavg --dataset femnist \
        --model cnn --batch_size 20 --lr 0.03 --device cpu

The config is the JAX package's ``ExperimentConfig``, flag for flag, plus
``--device`` ("" = the CUDA card, "cpu" = the CPU).  Ported so far:
the FedAvg-engine family, ``fedavg``, ``fedprox`` (``--mu``), ``fedopt``
(``--server_optimizer/--server_lr``), ``fednova`` (with no weight
decay), ``fedavg_robust`` (``--defense_type/--norm_bound/--stddev``, the
pixel-trigger backdoor on client 1) and ``hierarchical``
(``--group_num/--group_comm_round``), over every (model, dataset) pair of
``registry.py``: the cross-silo image zoo — the CIFAR ResNets,
``mobilenet``, ``mobilenet_v3``, ``efficientnet`` and ``vgg*`` on
``cifar10``, ``cifar100`` and ``cinic10`` with the reference's per-epoch
augmentation (``--data_augmentation 1`` by default: crop, flip and
Cutout(16) on the CIFARs, crop and flip on CINIC-10) — and the
cross-device zoo — ``lr`` on ``mnist`` and ``stackoverflow_lr``,
``cnn`` on ``femnist``, ``resnet18_gn`` on ``fed_cifar100``, ``rnn`` on
``shakespeare``, ``fed_shakespeare`` and ``stackoverflow_nwp`` — with the
dataset's task loss; the multi-label one adds ``test_precision`` and
``test_recall`` to the evaluation record; ``synthetic`` is the
class-prototype stand-in) and ``fedllm`` on one device
(the transformer through ``FedAvgSimulation``) or on a mesh of ranks (run
it on ranks: ``compat.launch`` or ``torchrun --nproc_per_node W -m
fedml_tpu_torch.experiments.run ...``): with ``--sp_degree N`` on a
``(clients, sp)`` mesh (each client's sequences sharded over N ranks with
the lax ring), with ``--tp_degree N`` on a ``(clients, model)`` mesh (the
Megatron transformer over N ranks), with ``--mesh dp,mp`` the rule engine
(``--partition_rules fedllm|resnet|file.json``, with
``--compress/--compress_ef`` and the residual store over ``dp``);
the standalone drivers
``centralized``, ``decentralized`` (gossip over
``SymmetricTopologyManager(n, min(2, n − 1))``, worker 0 evaluated),
``turboaggregate`` (the secure sum over the field) and ``fedgkt``
(``resnet8_56`` clients, ``resnet56_server``; ``--epochs_server``,
``--temperature``, ``--alpha_kd``); the rest of the algorithm family,
``splitnn`` (the ring over the registry dataset's clients, the McMahan
CNN cut at its flatten), ``vfl`` (a guest and a host over the
lending-club table) and ``fednas`` (the DARTS search, ``--arch_order 1|2``,
then with ``--stage train`` the FedAvg engine on the genotype); their
history logged after the run; ``base_framework``, the cross-device
runtime's tutorial template (no model, no data: scalar local results
summed over the in-process message bus, the per-round sums its
history); ``--checkpoint_every/--checkpoint_dir/--resume``
(the FedAvg-engine family), ``--crash_at_round`` with the JAX package's
semantics, ``--profile_round R`` (the port's own: round R of a
``FedAvgSimulation`` under the profiler capture, its ``kind=trace``
record in ``metrics.jsonl``), and ``--compress/--compress_ef`` (update compression with
error feedback) on the FedAvg engine's own round kernel (FedNova builds
its own and refuses it) and fedllm's rule engine.  ``--compress`` outside
those raises ``NotImplementedError`` (the JAX package ignores it there), and
the parallel knobs outside fedllm raise ``ValueError``.
``--conv_variant kernel`` (the port's own flag) runs ResNet-56 with every
3x3 conv on the Hopper kernel (centralized, decentralized and
turboaggregate too; fedgkt, splitnn, vfl and fednas build their own
models and refuse it and ``--compute_dtype``).  ``--ci 1`` shrinks
everything for smoke runs.  ``main`` writes ``<run_dir>/metrics.jsonl``
through ``MetricsLogger``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import sys
import time

from fedml_tpu_torch.core.config import config_to_json, parse_config
from fedml_tpu_torch.core.metrics import MetricsLogger, setup_logging
from fedml_tpu_torch.experiments.registry import (create_model, load_data,
                                                  shrink_dataset,
                                                  task_loss_for_dataset)
from fedml_tpu_torch.utils.device import resolve_device

ALGORITHMS = (
    "fedavg", "fedopt", "fedprox", "fednova", "fedavg_robust",
    "hierarchical", "decentralized", "fedgkt", "fednas", "centralized",
    "turboaggregate", "splitnn", "vfl", "base_framework", "fedllm",
)


@dataclasses.dataclass
class ExperimentConfig:
    """Canonical experiment flags (reference main_fedavg.py:46-105)."""

    algorithm: str = "fedavg"
    model: str = "resnet56"
    dataset: str = "cifar10"
    data_dir: str = ""
    partition_method: str = "hetero"
    partition_alpha: float = 0.5
    client_num_in_total: int = 10
    client_num_per_round: int = 4
    batch_size: int = 64
    client_optimizer: str = "sgd"
    lr: float = 0.03
    momentum: float = 0.0
    wd: float = 0.001
    epochs: int = 1
    comm_round: int = 10
    frequency_of_the_test: int = 5
    seed: int = 0
    ci: int = 0
    # fedopt
    server_optimizer: str = "sgd"
    server_lr: float = 1.0
    # fedprox
    mu: float = 0.1
    # robust
    defense_type: str = "norm_diff_clipping"
    norm_bound: float = 5.0
    stddev: float = 0.025
    # hierarchical
    group_num: int = 2
    group_comm_round: int = 2
    # fednas
    stage: str = "search"
    arch_lr: float = 3e-4
    lr_min: float = 0.001  # cosine weight-LR floor (--learning_rate_min)
    lambda_train_regularizer: float = 1.0
    arch_order: int = 1  # 2 = unrolled second-order DARTS architect
    # fedgkt
    temperature: float = 3.0
    alpha_kd: float = 1.0
    epochs_server: int = 1
    # fedllm (federated transformer fine-tuning; beyond-reference family)
    embed_dim: int = 64
    num_heads: int = 4
    num_layers: int = 2
    tp_degree: int = 1  # >1: DP x TP on a (clients, model) device mesh
    sp_degree: int = 1  # >1: DP x SP — long-context clients, ring attention
    # rule-driven sharding engine (fedml_tpu/parallel/partition.py):
    # --mesh "dp,mp" (also "dp=4,mp=2" / "auto,2") lays the cohort over
    # dp and the model over mp in ONE jit step; --partition_rules picks
    # the (regex -> PartitionSpec) table: a canonical name (fedllm,
    # resnet) or a JSON rule file.  Exclusive with tp/sp_degree;
    # composes with compress/compress_ef (the residual store shards
    # client rows over dp).
    mesh: str = ""
    partition_rules: str = ""
    # beyond-reference knobs available on the FedAvg-engine family
    compute_dtype: str = ""  # "bf16" = mixed-precision local training
    drop_prob: float = 0.0  # failure injection: P(client dies mid-round)
    # update compression (fedml_tpu/compress; FedAvg-engine family):
    # lossy uplink codec simulated inside the compiled round —
    # int8/qsgd8, int4/qsgd4, bf16, topk<rate>; "" = off.  compress_ef
    # threads the error-feedback residual store (required for topk).
    compress: str = ""
    compress_ef: int = 0
    # the reference's CIFAR-family loaders augment UNCONDITIONALLY
    # (crop+flip, +Cutout(16) for cifar10/100 — cifar10/data_loader.py:
    # 57-99, cifar100:85-91, cinic10:91-92); 0 disables for ablations
    data_augmentation: int = 1
    # smoke-tier shrink knobs (0 = unlimited): cap each client's shard /
    # the test set AFTER the real loader runs — the task is never swapped
    max_samples_per_client: int = 0
    max_test_samples: int = 0
    # observability: every main() run emits <run_dir>/metrics.jsonl
    # (per-round spans, comm counters, compile events — read it with
    # tools/trace_summary.py); "" = auto runs/<algo>-<dataset>-<stamp>
    run_dir: str = ""
    # fault tolerance (fedml_tpu/faults; FedAvg-engine family): save the
    # full (variables, opt state, round_idx, rng key) pytree every N
    # completed rounds; --resume 1 continues BIT-identically from the
    # latest readable checkpoint.  checkpoint_dir defaults to a stable
    # runs/ckpt/<algo>-<dataset>-seed<seed> path so a resumed process
    # finds its predecessor's saves without sharing a run_dir.
    checkpoint_every: int = 0
    checkpoint_dir: str = ""
    resume: int = 0
    # fault injection: hard-exit (os._exit, as a SIGKILL would) right
    # before this round trains — the crash half of the chaos layer's
    # crash-then-resume bit-identity check; -1 = off
    crash_at_round: int = -1
    # run this round (an index, as crash_at_round's) under the profiler
    # capture (core/metrics.trace): <run_dir>/trace/trace.json and a
    # kind=trace record of the device's idle time by span; -1 = off
    profile_round: int = -1
    # the port's stand-in for JAX_PLATFORMS: "" = the CUDA card (raises
    # without one), "cpu" = the CPU with every kernel's plain version
    device: str = ""
    # the port's (the JAX bench's --conv-variant): "kernel" runs every 3x3
    # conv of --model resnet56 on the Hopper implicit-GEMM kernel
    # (models/resnet_tpu.py, the JAX package's conv_variant="pallas");
    # "" = the registry's library-conv ResNet, as the JAX entry point's
    conv_variant: str = ""


def _apply_ci(cfg: ExperimentConfig) -> ExperimentConfig:
    """``--ci 1`` = shrink-only smoke preset.

    The reference's CI substitutes the task itself (its CI scripts run a
    fixed tiny config regardless of flags), which lets broken (model,
    dataset) wiring survive — the round-2 stackoverflow_lr crash lived
    in exactly that blind spot.  Here CI clamps sizes via the public
    shrink knobs and NEVER changes algorithm/model/dataset/loss.
    """
    if cfg.ci:
        if cfg.algorithm == "fedllm":  # token-sequence family: keep task,
            # shrink the transformer too
            return dataclasses.replace(
                cfg,
                client_num_in_total=min(cfg.client_num_in_total, 4),
                client_num_per_round=min(cfg.client_num_per_round, 4),
                comm_round=min(cfg.comm_round, 2),
                batch_size=min(cfg.batch_size, 4),
                embed_dim=min(cfg.embed_dim, 32), num_layers=1,
                max_samples_per_client=cfg.max_samples_per_client or 16,
                max_test_samples=cfg.max_test_samples or 32,
            )
        return dataclasses.replace(
            cfg, client_num_in_total=min(cfg.client_num_in_total, 3),
            client_num_per_round=min(cfg.client_num_per_round, 3),
            comm_round=min(cfg.comm_round, 2), batch_size=min(cfg.batch_size, 8),
            max_samples_per_client=cfg.max_samples_per_client or 16,
            max_test_samples=cfg.max_test_samples or 64,
        )
    return cfg


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to fedml_tpu_torch yet (ROADMAP.md, {item})")


# the drivers that take the observability sink themselves (the JAX
# package's set); run_experiment logs the others' history rows after the run
_METRICS_NATIVE = frozenset((
    "fedavg", "fedprox", "fedopt", "fednova", "fedavg_robust",
    "hierarchical", "fedllm",
))

# the FedAvg-engine family: the drivers wired into CheckpointManager
_RESUMABLE = frozenset((
    "fedavg", "fedprox", "fedopt", "fednova", "fedavg_robust",
    "hierarchical",
))

# the standalone drivers beside the FedAvg engine (no checkpoint wiring,
# no codec stage)
_STANDALONE = frozenset(("centralized", "decentralized", "turboaggregate", "fedgkt"))

# the drivers that build their own models (in float32, on library convs)
_OWN_MODELS = frozenset(("fedgkt", "splitnn", "vfl", "fednas"))

def _refuse_unported(cfg: ExperimentConfig) -> None:
    """Fail before any work on a knob whose machinery is not ported, and
    on the JAX fedllm path's exclusive knobs with its ValueErrors."""
    if cfg.algorithm == "fedllm" and cfg.mesh and (cfg.tp_degree > 1 or cfg.sp_degree > 1):
        raise ValueError(
            "--mesh is the rule-driven sharding engine and is exclusive "
            "with tp_degree/sp_degree (those pick the heuristic meshes)")
    if cfg.tp_degree > 1 and cfg.sp_degree > 1:
        raise ValueError(
            "tp_degree and sp_degree cannot both exceed 1 (a 3-D "
            "clients x model x sp mesh is not wired up)")
    if (cfg.tp_degree > 1 or cfg.mesh or cfg.partition_rules) and cfg.algorithm != "fedllm":
        # the JAX entry point ignores them outside fedllm (ROADMAP queue C4);
        # refusing beats training unsharded silently
        raise ValueError(f"--tp_degree/--mesh/--partition_rules lay fedllm's transformer "
                         f"out over ranks; {cfg.algorithm} has no sharded path")
    if cfg.partition_rules and not cfg.mesh:
        raise ValueError("--partition_rules picks the rule engine's table; it needs "
                         "--mesh dp,mp")
    if cfg.sp_degree > 1 and cfg.algorithm != "fedllm":
        # the JAX entry point ignores the degree outside fedllm (ROADMAP
        # queue C4); refusing beats training unsharded silently
        raise ValueError(f"--sp_degree shards fedllm's sequences; {cfg.algorithm} "
                         "has no sequence-parallel path")
    if ((cfg.compress or cfg.compress_ef) and cfg.algorithm not in _RESUMABLE
            and not (cfg.algorithm == "fedllm" and cfg.mesh)):
        # the JAX package ignores these flags outside the FedAvg engine
        # (ROADMAP queue C4); refusing beats training uncompressed silently
        raise NotImplementedError(
            f"--compress/--compress_ef on {cfg.algorithm}: only the FedAvg "
            "engine's round compresses; the JAX package's other drivers do "
            "not (ROADMAP.md, queue C4)")
    if cfg.profile_round >= 0 and (cfg.algorithm not in _METRICS_NATIVE or cfg.sp_degree > 1
                                   or cfg.tp_degree > 1 or cfg.mesh):
        raise ValueError(f"--profile_round runs a round of FedAvgSimulation.run(); "
                         f"{cfg.algorithm} does not run on it here")
    if cfg.algorithm in _OWN_MODELS and (cfg.conv_variant or cfg.compute_dtype):
        # the JAX entry point ignores --compute_dtype for these (ROADMAP C4)
        raise ValueError(
            f"{cfg.algorithm} builds its own models on library convs in float32: "
            "--conv_variant and --compute_dtype do not apply (got "
            f"{cfg.conv_variant!r}, {cfg.compute_dtype!r})")


def _fedavg_config(cfg: ExperimentConfig, ds, **override):
    from fedml_tpu_torch.algorithms.fedavg import FedAvgConfig

    return FedAvgConfig(**{**dict(
        num_clients=ds.num_clients,
        clients_per_round=min(cfg.client_num_per_round, ds.num_clients),
        comm_rounds=cfg.comm_round, epochs=cfg.epochs,
        batch_size=cfg.batch_size, client_optimizer=cfg.client_optimizer,
        lr=cfg.lr, momentum=cfg.momentum, weight_decay=cfg.wd,
        frequency_of_the_test=cfg.frequency_of_the_test, seed=cfg.seed,
        compute_dtype=cfg.compute_dtype or None, drop_prob=cfg.drop_prob,
        compress_codec=cfg.compress or None, compress_ef=bool(cfg.compress_ef),
    ), **override})


def run_experiment(cfg: ExperimentConfig, log_fn=print, metrics=None) -> dict:
    cfg = _apply_ci(cfg)
    _refuse_unported(cfg)
    if (cfg.resume or cfg.checkpoint_every) and cfg.algorithm not in _RESUMABLE:
        # before any work: a resume that silently retrained from round 0
        # would pass for a successful one
        raise SystemExit(
            f"--resume/--checkpoint_every: algorithm {cfg.algorithm!r} has "
            f"no checkpoint wiring (supported: {sorted(_RESUMABLE)})")
    t0 = time.time()
    # a file-less logger still feeds the process telemetry registry;
    # main() passes a run_dir-backed one so metrics.jsonl is emitted
    metrics = metrics if metrics is not None else MetricsLogger()
    out = _dispatch(cfg, log_fn, metrics, t0)
    if cfg.algorithm not in _METRICS_NATIVE:
        # the drivers without a metrics sink of their own: their history
        # rows are logged after the run.  fednas --stage train logged its
        # train rounds live under the search stage's round indices, so the
        # search rows go in as kind-tagged records: one plain round stream
        # per file
        search_aside = "train_history" in out
        for row in out.get("history") or []:
            if isinstance(row, dict):
                if search_aside:
                    metrics.log({"kind": "search_round", **row})
                else:
                    metrics.log(row, step=row.get("round"))
    return out


def _dispatch(cfg: ExperimentConfig, log_fn, metrics, t0) -> dict:
    """Build data, model and simulation, and run."""
    device = resolve_device(cfg.device or None)
    if cfg.algorithm == "base_framework":  # the tutorial template: no model, no data
        from fedml_tpu_torch.algorithms.base_framework import run_base_framework

        hist = run_base_framework(cfg.client_num_in_total, cfg.comm_round)
        return {"history": hist, "final": hist[-1] if hist else None,
                "wall_s": time.time() - t0}
    if cfg.algorithm == "vfl":  # vertical FL reads its own tabular data
        return _run_vfl(cfg, device, t0)
    ds = shrink_dataset(
        load_data(cfg.dataset, cfg.data_dir, cfg.client_num_in_total,
                  cfg.partition_method, cfg.partition_alpha, cfg.seed),
        cfg.max_samples_per_client, cfg.max_test_samples,
    )
    loss_fn = task_loss_for_dataset(cfg.dataset)
    if cfg.algorithm == "fedgkt":
        return _run_fedgkt(cfg, ds, device, t0)
    if cfg.algorithm == "splitnn":
        return _run_splitnn(cfg, ds, device, t0)
    if cfg.algorithm == "fednas":
        return _run_fednas(cfg, ds, device, t0, log_fn, metrics)
    if cfg.algorithm == "fedllm":
        # federated transformer fine-tuning over token sequences
        from fedml_tpu_torch.models.transformer import transformer_lm

        seq_len = int(ds.train_x.shape[1])
        vocab = max(int(ds.num_classes), int(ds.train_x.max()) + 1)
        bundle = transformer_lm(
            vocab_size=vocab, embed_dim=cfg.embed_dim, num_heads=cfg.num_heads,
            num_layers=cfg.num_layers, seq_len=seq_len, device=device,
        )
        if cfg.sp_degree > 1:
            return _run_fedllm_sp(cfg, ds, bundle, vocab, device, t0, log_fn, metrics)
        if cfg.tp_degree > 1 or cfg.mesh:
            return _run_fedllm_sharded(cfg, ds, bundle, device, t0, log_fn, metrics)
    elif cfg.conv_variant:
        if (cfg.model, cfg.conv_variant) != ("resnet56", "kernel"):
            raise ValueError("--conv_variant kernel is ResNet-56's (--model "
                             f"resnet56); got {cfg.model!r}, {cfg.conv_variant!r}")
        from fedml_tpu_torch.models.resnet_tpu import resnet56_tpu

        bundle = resnet56_tpu(ds.num_classes, int(ds.train_x.shape[1]),
                              device=device)
    else:
        bundle = create_model(cfg.model, cfg.dataset, ds.num_classes,
                              input_shape=tuple(ds.train_x.shape[1:]),
                              device=device)
    if cfg.algorithm in _STANDALONE:
        return _run_standalone(cfg, ds, bundle, loss_fn, device, t0)
    sim = _simulation(cfg, ds, bundle, loss_fn=loss_fn, metrics=metrics,
                      device=device, augment_fn=_augment_fn(cfg, ds))
    done = _attach_checkpointing(cfg, sim)
    if cfg.crash_at_round >= 0:
        sim.crash_at_round = cfg.crash_at_round
    if cfg.profile_round >= 0:
        sim.profile_round = cfg.profile_round
    # run() already merges evaluate_global() into the final round
    hist = sim.run(rounds=max(0, cfg.comm_round - done), log_fn=log_fn)
    out = {"history": hist, "final": hist[-1] if hist else None,
           "wall_s": time.time() - t0}
    if done:
        out["resumed_rounds"] = done
    return out


@contextlib.contextmanager
def _rank_group(device):
    """The process group a rank runs in: the caller's (``compat.launch``),
    one initialized here from ``torchrun``'s environment (``WORLD_SIZE``,
    ``RANK``, ``MASTER_ADDR``/``MASTER_PORT``; NCCL on the card, one card
    per ``LOCAL_RANK``, gloo on the CPU) and torn down after, or, for a
    lone process, a world of one rank (``compat.single_rank_group``)."""
    import torch
    import torch.distributed as dist

    from fedml_tpu_torch.parallel.compat import single_rank_group

    if dist.is_initialized():
        yield
        return
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        with single_rank_group(device):
            yield
        return
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    try:
        yield
        dist.barrier()  # no rank closes its connections under a peer's receive
    finally:
        dist.destroy_process_group()


def _fedllm_rounds(cfg: ExperimentConfig, ds, bundle, device, round_fn, shard_data,
                   state, log_fn, metrics, whole=lambda variables: variables) -> list:
    """The fedllm rounds on a mesh of ranks: the one-device driver's sampler,
    pack, dropout and evaluation cadence, on every rank over its block.
    ``whole(variables)`` gives the evaluator the whole model (a laid-out
    state is gathered).  Every rank logs the same history."""
    import numpy as np
    import torch

    from fedml_tpu_torch.core.client import eval_summary, make_evaluator
    from fedml_tpu_torch.core.rng import PRNGKey
    from fedml_tpu_torch.core.sampling import host_sample_ids, inject_dropout
    from fedml_tpu_torch.core.types import (batch_eval_pack, cohort_steps_per_epoch,
                                            pack_clients, to_device)

    K = min(cfg.client_num_per_round, ds.num_clients)
    steps = cohort_steps_per_epoch(ds, cfg.batch_size)
    evaluator = make_evaluator(bundle)
    test = to_device(batch_eval_pack(ds.test_x, ds.test_y, max(cfg.batch_size, 64)), device)
    hist = []
    for r in range(cfg.comm_round):
        ids = host_sample_ids(cfg.seed, r, ds.num_clients, K)
        pack = pack_clients(ds, ids, cfg.batch_size, steps_per_epoch=steps,
                            seed=cfg.seed, reuse_buffers=True)
        participation = np.ones(K, np.float32)
        if cfg.drop_prob > 0.0:
            participation = inject_dropout(
                PRNGKey(cfg.seed), r, torch.from_numpy(participation),
                cfg.drop_prob).numpy()
        state, m = round_fn(state, *shard_data((
            pack.x, pack.y, pack.mask, pack.num_samples, participation,
            np.asarray(ids, np.int32))))
        row = {"round": r, **{k: float(v) for k, v in m.items()}}
        if row.get("count"):
            row["train_loss"] = row["loss_sum"] / row["count"]
        if r % cfg.frequency_of_the_test == 0 or r == cfg.comm_round - 1:
            row.update(eval_summary(evaluator(whole(state.variables), *test)))
        hist.append(row)
        if metrics is not None:
            metrics.log(row, step=r)
        if log_fn:
            log_fn(row)
    return hist


def _mesh_width(count: int, degree: int, K: int) -> int:
    """The cohort's width ``dp`` of ``count`` ranks at a parallel
    ``degree``, with JAX's refusals."""
    if count % degree:
        raise ValueError(f"parallel degree {degree} does not divide device count {count}")
    dp = count // degree
    if K % dp:
        raise ValueError(f"cohort {K} not divisible by dp width {dp}")
    return dp


def _run_fedllm_sp(cfg: ExperimentConfig, ds, bundle, vocab, device, t0, log_fn,
                   metrics) -> dict:
    """fedllm on a ``(clients, sp)`` mesh of every rank: each client's
    sequences sharded over ``sp_degree`` ranks with the lax ring
    (``parallel/dp_sp.py``), the cohort over the rest."""
    from fedml_tpu_torch.algorithms.fedavg import ServerState, resolve_compute_dtype
    from fedml_tpu_torch.core.client import make_client_optimizer
    from fedml_tpu_torch.core.rng import PRNGKey
    from fedml_tpu_torch.parallel.dp_sp import make_dp_sp_mesh, make_dp_sp_round_fn
    from fedml_tpu_torch.parallel.mesh import describe_mesh, world_size

    seq_len = int(ds.train_x.shape[1])
    degree = cfg.sp_degree
    with _rank_group(device):
        dp = _mesh_width(world_size(), degree, min(cfg.client_num_per_round, ds.num_clients))
        if seq_len % degree:
            raise ValueError(f"sequence length {seq_len} not divisible by sp_degree "
                             f"{degree}")
        opt = make_client_optimizer(cfg.client_optimizer, cfg.lr, momentum=cfg.momentum,
                                    weight_decay=cfg.wd)
        mesh = make_dp_sp_mesh(dp, degree, device=device)
        round_fn, shard_data, init_fn = make_dp_sp_round_fn(
            mesh, vocab_size=vocab, embed_dim=cfg.embed_dim, num_heads=cfg.num_heads,
            num_layers=cfg.num_layers, max_len=seq_len, optimizer=opt,
            epochs=cfg.epochs, compute_dtype=resolve_compute_dtype(cfg.compute_dtype or None),
            block_size=max(1, min(512, seq_len // degree)))
        key = PRNGKey(cfg.seed)
        hist = _fedllm_rounds(cfg, ds, bundle, device, round_fn, shard_data,
                              ServerState(init_fn(key), (), 0, key), log_fn, metrics)
        return {"history": hist, "final": hist[-1], "mesh": describe_mesh(mesh)["axes"],
                "wall_s": time.time() - t0}


def _run_fedllm_sharded(cfg: ExperimentConfig, ds, bundle, device, t0, log_fn,
                        metrics) -> dict:
    """fedllm with the model laid out over ranks: ``--tp_degree N`` runs the
    DP×TP round on a ``(clients, model)`` mesh of every rank
    (``parallel/gspmd.py``, the Megatron transformer over ``N`` ranks, the
    cohort over the rest); ``--mesh dp,mp`` the rule engine
    (``parallel/partition.py``) under ``--partition_rules`` (default
    ``fedllm``), with ``--compress/--compress_ef`` and the residual store's
    client rows over ``dp``.  Evaluation gathers the model on every rank."""
    from fedml_tpu_torch.algorithms.fedavg import ServerState, resolve_compute_dtype
    from fedml_tpu_torch.core.client import make_client_optimizer, make_local_update
    from fedml_tpu_torch.core.rng import PRNGKey
    from fedml_tpu_torch.parallel.compat import use_mesh
    from fedml_tpu_torch.parallel.layout import unshard_tree
    from fedml_tpu_torch.parallel.mesh import describe_mesh, mesh_from_spec, world_size

    K = min(cfg.client_num_per_round, ds.num_clients)
    with _rank_group(device):
        count = world_size()
        if cfg.mesh:
            mesh = mesh_from_spec(cfg.mesh, device=device)  # too few ranks: its ValueError
            dp, mp = (describe_mesh(mesh)["axes"][a] for a in ("dp", "mp"))
            if dp * mp != count:
                raise ValueError(f"mesh {dp}x{mp} spans {dp * mp} of the run's {count} "
                                 "ranks; launch as many ranks as the mesh has positions")
            _mesh_width(count, mp, K)
        else:
            dp = _mesh_width(count, cfg.tp_degree, K)
        opt = make_client_optimizer(cfg.client_optimizer, cfg.lr, momentum=cfg.momentum,
                                    weight_decay=cfg.wd)
        lu = make_local_update(bundle, opt, epochs=cfg.epochs,
                               compute_dtype=resolve_compute_dtype(cfg.compute_dtype or None))
        key = PRNGKey(cfg.seed)
        variables = bundle.init(key)
        if cfg.mesh:
            from fedml_tpu_torch.parallel.partition import (make_rule_round_fn,
                                                            residual_store, resolve_rules)

            codec = cfg.compress or None
            ef = bool(cfg.compress_ef) and codec is not None
            table = resolve_rules(cfg.partition_rules or "fedllm")
            residuals = ()
            if ef:
                if ds.num_clients % dp:
                    raise ValueError(
                        f"client_num_in_total {ds.num_clients} not divisible by dp width "
                        f"{dp} (the EF residual store shards its client rows over dp)")
                # this rank's rows and blocks only: the store is never whole
                residuals = residual_store(mesh, variables, table, ds.num_clients)
            round_fn, shard_state, shard_data = make_rule_round_fn(
                mesh, lu, variables, table, codec=codec, error_feedback=ef)
            state = ServerState(variables, (), 0, key, residuals)
        else:
            from fedml_tpu_torch.parallel.gspmd import make_dp_tp_mesh, make_dp_tp_round_fn

            mesh = make_dp_tp_mesh(dp, cfg.tp_degree, device=device)
            round_fn, shard_state, shard_data = make_dp_tp_round_fn(mesh, lu, variables)
            state = ServerState(variables, (), 0, key)

        def whole(laid_out):
            with use_mesh(mesh):
                return unshard_tree(laid_out)

        hist = _fedllm_rounds(cfg, ds, bundle, device, round_fn, shard_data,
                              shard_state(state), log_fn, metrics, whole)
        return {"history": hist, "final": hist[-1], "mesh": describe_mesh(mesh)["axes"],
                "wall_s": time.time() - t0}


def _run_fedgkt(cfg: ExperimentConfig, ds, device, t0) -> dict:
    """FedGKT over the reference's pair: ``resnet8_56`` on each client,
    ``resnet56_server`` on the server."""
    from fedml_tpu_torch.algorithms.fedgkt import FedGKT, FedGKTConfig
    from fedml_tpu_torch.models.resnet_gkt import resnet8_56, resnet56_server

    img = ds.train_x.shape[1]
    algo = FedGKT(
        resnet8_56(ds.num_classes, img, device=device),
        resnet56_server(ds.num_classes, img, device=device),
        ds, FedGKTConfig(
            num_clients=ds.num_clients, comm_rounds=cfg.comm_round,
            epochs_client=cfg.epochs, epochs_server=cfg.epochs_server,
            batch_size=cfg.batch_size, lr_client=cfg.lr, lr_server=cfg.lr,
            temperature=cfg.temperature, alpha=cfg.alpha_kd, seed=cfg.seed,
        ), device=device)
    hist = algo.run()
    return {"history": hist, "wall_s": time.time() - t0}


def _run_vfl(cfg: ExperimentConfig, device, t0) -> dict:
    """Vertical FL over the lending-club table (the stand-in without the
    files): a guest and a host, 16-wide branches.  The shrink knobs cap
    the table, train rows plus test rows, since the parties share rows;
    the last ``max(32, n // 5)`` rows are the test set."""
    from fedml_tpu_torch.algorithms.vfl import VerticalFederation, run_vfl
    from fedml_tpu_torch.data.tabular import load_lending_club
    from fedml_tpu_torch.models.finance import vfl_party

    x, y, splits = load_lending_club(cfg.data_dir or "./data/lending_club_loan")
    if cfg.max_samples_per_client:
        cap = (cfg.max_samples_per_client * cfg.client_num_in_total
               + (cfg.max_test_samples or 64))
        x, y = x[:cap], y[:cap]
    n_test = max(32, len(y) // 5)
    xs = [x[:, s] for s in splits]
    fed = VerticalFederation([vfl_party(xi.shape[1], 16, device=device) for xi in xs],
                             lr=cfg.lr, device=device)
    _, hist = run_vfl(fed, [xi[:-n_test] for xi in xs], y[:-n_test],
                      [xi[-n_test:] for xi in xs], y[-n_test:],
                      epochs=cfg.comm_round, batch_size=cfg.batch_size)
    return {"history": hist, "wall_s": time.time() - t0}


def _run_splitnn(cfg: ExperimentConfig, ds, device, t0) -> dict:
    """SplitNN's ring over the registry dataset's clients: the McMahan CNN
    cut at its flatten, one ring epoch per ``--comm_round``."""
    from fedml_tpu_torch.algorithms.splitnn import SplitNNSimulation
    from fedml_tpu_torch.models.cnn import cnn_split_pair

    bottom, top = cnn_split_pair(ds.num_classes, ds.train_x.shape[1:], device=device)
    parts = [(ds.train_x[idx], ds.train_y[idx]) for idx in ds.train_client_idx.values()]
    sim = SplitNNSimulation(bottom, top, parts, test_data=(ds.test_x, ds.test_y),
                            batch_size=cfg.batch_size, lr=cfg.lr, seed=cfg.seed,
                            device=device)
    hist = []
    for _ in range(cfg.comm_round):
        hist.extend(sim.run_epoch())
    return {"history": hist, "wall_s": time.time() - t0}


def _run_fednas(cfg: ExperimentConfig, ds, device, t0, log_fn, metrics) -> dict:
    """The DARTS search (``darts_search(C=8, layers=4)``), then with
    ``--stage train`` the FedAvg engine on the searched genotype, with the
    reference's train-stage SGD (momentum, wd, clip 5)."""
    from fedml_tpu_torch.algorithms.fedavg import FedAvgConfig
    from fedml_tpu_torch.algorithms.fednas import (FedNASConfig, FedNASSearch,
                                                   fednas_train_stage)
    from fedml_tpu_torch.models.darts.search import darts_search

    img = ds.train_x.shape[1]
    chans = int(ds.train_x.shape[-1])
    search = FedNASSearch(
        darts_search(C=8, num_classes=ds.num_classes, layers=4, image_size=img,
                     in_channels=chans, device=device),
        ds, FedNASConfig(
            num_clients=ds.num_clients, comm_rounds=cfg.comm_round, epochs=cfg.epochs,
            batch_size=cfg.batch_size, lr=cfg.lr, lr_min=cfg.lr_min, arch_lr=cfg.arch_lr,
            lambda_train_regularizer=cfg.lambda_train_regularizer,
            arch_order=cfg.arch_order, seed=cfg.seed), device=device)
    hist = search.run()
    genotype = search.genotype()
    out = {"history": hist, "genotype": str(genotype), "wall_s": time.time() - t0}
    if cfg.stage == "train":
        sim = fednas_train_stage(genotype, ds, FedAvgConfig(
            num_clients=ds.num_clients, clients_per_round=cfg.client_num_per_round,
            comm_rounds=cfg.comm_round, epochs=cfg.epochs, batch_size=cfg.batch_size,
            lr=cfg.lr, seed=cfg.seed, momentum=cfg.momentum or 0.9, weight_decay=cfg.wd,
            grad_clip=5.0), C=8, layers=4, image_size=img, in_channels=chans,
            lr_min=cfg.lr_min, metrics=metrics, device=device)
        out["train_history"] = sim.run(log_fn=log_fn)
    return out


def _run_standalone(cfg: ExperimentConfig, ds, bundle, loss_fn, device, t0) -> dict:
    """The centralized, decentralized and TurboAggregate drivers, built
    with the JAX package's arguments.  ``--compute_dtype`` (which the JAX
    entry point ignores for them) reaches their local update, as it does
    the FedAvg engine's."""
    from fedml_tpu_torch.algorithms.fedavg import resolve_compute_dtype

    dtype = resolve_compute_dtype(cfg.compute_dtype or None)
    if cfg.algorithm == "centralized":
        from fedml_tpu_torch.algorithms.centralized import CentralizedTrainer

        trainer = CentralizedTrainer(
            bundle, ds, batch_size=cfg.batch_size, lr=cfg.lr,
            optimizer=cfg.client_optimizer, weight_decay=cfg.wd,
            momentum=cfg.momentum, seed=cfg.seed, loss_fn=loss_fn,
            compute_dtype=dtype, device=device)
        hist = [trainer.train(epochs=cfg.epochs) for _ in range(cfg.comm_round)]
        hist[-1].update(trainer.evaluate())
        return {"history": hist, "final": hist[-1], "wall_s": time.time() - t0}
    if cfg.algorithm == "decentralized":
        from fedml_tpu_torch.algorithms.decentralized import DecentralizedSimulation
        from fedml_tpu_torch.core.topology import SymmetricTopologyManager

        tm = SymmetricTopologyManager(
            ds.num_clients, neighbor_num=min(2, ds.num_clients - 1), seed=cfg.seed)
        sim = DecentralizedSimulation(
            bundle, ds, tm.generate_topology(), epochs=cfg.epochs,
            batch_size=cfg.batch_size, lr=cfg.lr, seed=cfg.seed, loss_fn=loss_fn,
            compute_dtype=dtype, device=device)
        hist = sim.run(cfg.comm_round)
        return {"history": hist, "final": sim.evaluate_worker(0),
                "wall_s": time.time() - t0}
    from fedml_tpu_torch.algorithms.turboaggregate import (TurboAggregateConfig,
                                                           TurboAggregateSimulation)

    algo = TurboAggregateSimulation(bundle, ds, TurboAggregateConfig(
        num_clients=ds.num_clients, comm_rounds=cfg.comm_round, epochs=cfg.epochs,
        batch_size=cfg.batch_size, lr=cfg.lr, seed=cfg.seed,
    ), loss_fn=loss_fn, compute_dtype=dtype, device=device)
    hist = algo.run()
    return {"history": hist, "wall_s": time.time() - t0}


def _simulation(cfg: ExperimentConfig, ds, bundle, **engine_kw):
    """The FedAvg-engine driver of ``cfg.algorithm`` (fedllm runs on
    ``FedAvgSimulation``), as the JAX package's dispatch builds it."""
    if cfg.algorithm in ("fedavg", "fedllm"):
        from fedml_tpu_torch.algorithms.fedavg import FedAvgSimulation

        return FedAvgSimulation(bundle, ds, _fedavg_config(cfg, ds), **engine_kw)
    if cfg.algorithm == "fedprox":
        from fedml_tpu_torch.algorithms.fedprox import FedProxSimulation

        return FedProxSimulation(bundle, ds, _fedavg_config(cfg, ds), mu=cfg.mu,
                                 **engine_kw)
    if cfg.algorithm == "fedopt":
        from fedml_tpu_torch.algorithms.fedopt import FedOptSimulation

        return FedOptSimulation(bundle, ds, _fedavg_config(cfg, ds),
                                server_optimizer=cfg.server_optimizer,
                                server_lr=cfg.server_lr, **engine_kw)
    if cfg.algorithm == "fednova":
        from fedml_tpu_torch.algorithms.fednova import FedNovaSimulation

        return FedNovaSimulation(bundle, ds, _fedavg_config(cfg, ds, weight_decay=0.0),
                                 **engine_kw)
    if cfg.algorithm == "fedavg_robust":
        from fedml_tpu_torch.algorithms.fedavg_robust import FedAvgRobustSimulation

        return FedAvgRobustSimulation(
            bundle, ds, _fedavg_config(cfg, ds), defense_type=cfg.defense_type,
            norm_bound=cfg.norm_bound, stddev=cfg.stddev, **engine_kw)
    if cfg.algorithm == "hierarchical":
        from fedml_tpu_torch.algorithms.hierarchical import HierarchicalSimulation

        return HierarchicalSimulation(
            bundle, ds, _fedavg_config(cfg, ds), num_groups=cfg.group_num,
            group_comm_round=cfg.group_comm_round, **engine_kw)
    raise ValueError(f"unknown algorithm: {cfg.algorithm}")


def _augment_fn(cfg: ExperimentConfig, ds):
    """The reference's CIFAR-family loaders augment every epoch, unless
    ``--data_augmentation 0``: crop (pad 4), flip and Cutout(16) for
    CIFAR-10 and CIFAR-100, crop and flip for CINIC-10.  The other
    datasets (fed_cifar100 among them) train unaugmented, as in the JAX
    package."""
    if not (cfg.data_augmentation and ds.train_x.ndim == 4):
        return None
    from fedml_tpu_torch.data.augment import make_image_augment

    if cfg.dataset in ("cifar10", "cifar100"):
        return make_image_augment(pad=4, flip=True, cutout=16)
    if cfg.dataset == "cinic10":
        return make_image_augment(pad=4, flip=True, cutout=None)
    return None


def _attach_checkpointing(cfg: ExperimentConfig, sim) -> int:
    """Wire ``--checkpoint_every/--checkpoint_dir/--resume`` into the
    simulation; returns the rounds a resume restored (0 otherwise)."""
    if not (cfg.checkpoint_every or cfg.resume):
        return 0
    from fedml_tpu_torch.core.checkpoint import CheckpointManager

    # the default directory is stable between a run and its --resume (and
    # --comm_round extension, and another device) and unique per
    # experiment: a hash of every other flag, so two sweep arms never
    # resume from each other
    stable = {k: v for k, v in dataclasses.asdict(cfg).items()
              if k not in ("run_dir", "resume", "crash_at_round", "checkpoint_dir",
                           "checkpoint_every", "comm_round", "device", "profile_round")}
    tag = hashlib.sha1(json.dumps(stable, sort_keys=True).encode()).hexdigest()[:10]
    ckdir = cfg.checkpoint_dir or os.path.join(
        "runs", "ckpt", f"{cfg.algorithm}-{cfg.dataset}-seed{cfg.seed}-{tag}")
    sim.attach_checkpointing(CheckpointManager(ckdir), cfg.checkpoint_every or 1)
    if not cfg.resume:
        return 0
    done = sim.resume()
    if done == 0:
        # an explicit resume that restores nothing must not retrain from
        # round 0 as if it had resumed
        raise SystemExit(
            f"--resume 1: no readable checkpoint in {ckdir} (pass the "
            "original --checkpoint_dir, or drop --resume to start fresh)")
    return done


def main(argv=None):
    cfg = parse_config(ExperimentConfig, argv)
    if cfg.algorithm not in ALGORITHMS:
        raise SystemExit(f"--algorithm must be one of {ALGORITHMS}")
    print(config_to_json(cfg))
    setup_logging()
    # pid suffix: two arms of a sweep launched in the same wall-clock
    # second must not append into one metrics.jsonl
    run_dir = cfg.run_dir or os.path.join(
        "runs",
        f"{cfg.algorithm}-{cfg.dataset}-"
        f"{time.strftime('%Y%m%d-%H%M%S')}-p{os.getpid()}",
    )
    # context manager: the JSONL handle closes on every exit path
    with MetricsLogger(run_dir=run_dir) as metrics:
        metrics.log({"kind": "config",
                     **json.loads(config_to_json(cfg))})
        # log_fn=None: with INFO logging on, MetricsLogger already
        # surfaces every row on the console
        out = run_experiment(cfg, log_fn=None, metrics=metrics)
        metrics.log_telemetry()
    tail = out.get("final") or (out["history"][-1] if out.get("history") else {})
    print(json.dumps({"final": tail, "wall_s": round(out["wall_s"], 2),
                      "run_dir": run_dir}, default=str))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
