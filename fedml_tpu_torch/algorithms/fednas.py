"""FedNAS — federated DARTS architecture search (port of
``fedml_tpu/algorithms/fednas.py``).

Reference: clients alternate an architecture (alpha) step and a weight
step per batch — ``Architect.step_v2`` updates the alphas with
∇α L_valid + λ_train·∇α L_train (``darts/architect.py:58-103``), then SGD
steps the weights with a gradient clip of 5 (``FedNASTrainer.local_search``,
``FedNASTrainer.py:82-115``); the server averages weights and alphas,
sample-weighted (``FedNASAggregator.py:56-87``).  Two stages: ``search``,
then ``train`` on the derived genotype (``main_fednas.py:44-45``).

The round is a loop over the sampled clients, each a loop over epochs ×
batches with the alpha step then the weight step, as the JAX package's
``lax.map`` of scans runs them; weights and alphas are two trees, and the
server takes the float32 sample-weighted mean of each.  ``arch_order=2``
is the DARTS second-order architect through one exact unrolled step
(``darts_unrolled_alpha_grad``).  The train stage is the FedAvg engine on
the fixed network.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from fedml_tpu_torch.algorithms.fedavg import FedAvgConfig, FedAvgSimulation
from fedml_tpu_torch.core import optrepo
from fedml_tpu_torch.core import rng as rnglib
from fedml_tpu_torch.core import tree as treelib
from fedml_tpu_torch.core.client import make_client_optimizer
from fedml_tpu_torch.core.losses import masked_softmax_ce
from fedml_tpu_torch.core.types import (FedDataset, batch_eval_pack, cohort_steps_per_epoch,
                                        pack_clients, to_device)
from fedml_tpu_torch.models.darts.genotypes import Genotype, genotype_from_alphas
from fedml_tpu_torch.models.darts.network import darts_network
from fedml_tpu_torch.models.darts.search import SearchBundle
from fedml_tpu_torch.utils.device import DeviceLike, driver_device


@dataclasses.dataclass
class FedNASConfig:
    num_clients: int = 4
    clients_per_round: int = 4
    comm_rounds: int = 5
    epochs: int = 1               # local search epochs per round
    batch_size: int = 8
    lr: float = 0.025             # weight SGD (reference --learning_rate)
    lr_min: float = 0.001         # cosine floor (reference --learning_rate_min)
    momentum: float = 0.9
    weight_decay: float = 3e-4    # reference --weight_decay
    grad_clip: float = 5.0        # reference --grad_clip
    arch_lr: float = 3e-4         # reference --arch_learning_rate
    arch_weight_decay: float = 1e-3
    lambda_train_regularizer: float = 1.0   # reference --lambda_train_regularizer
    # 1 = the reference FedNAS client's Architect.step_v2 alternation
    # (∇α L_val + λ·∇α L_train); 2 = the DARTS second-order unrolled
    # architect (darts/architect.py:32-93), exact through one unrolled step
    arch_order: int = 1
    seed: int = 0


def cosine_epoch_schedule(lr: float, lr_min: float, epochs: int, steps_per_epoch: int):
    """The reference's weight-LR schedule: a fresh per-round
    ``CosineAnnealingLR(T_max=epochs, eta_min=lr_min)`` stepped once per
    local epoch (``FedNASTrainer.py:52-72``), ``lr_e = lr_min + (lr −
    lr_min)(1 + cos(π e / E)) / 2`` with ``e`` the update count's epoch;
    the constant ``lr`` when ``epochs <= 1``.  The value is float32,
    computed in the JAX package's order of float32 operations."""
    if epochs <= 1:
        return lr
    f32 = np.float32

    def schedule(count: int):
        epoch = f32(min(count // steps_per_epoch, epochs))
        arg = f32(f32(math.pi) * epoch) / f32(epochs)
        return f32(lr_min) + f32(0.5 * (lr - lr_min)) * (f32(1.0) + np.cos(arg))

    return schedule


def darts_unrolled_alpha_grad(train_loss_fn: Callable, val_loss_fn: Callable, params: dict,
                              alphas: dict, *, eta, momentum: float = 0.0,
                              weight_decay: float = 0.0, buf: Optional[dict] = None) -> dict:
    """The second-order DARTS architect gradient (paper eq. 7; reference
    ``darts/architect.py:32-93``): ∇α L_val(w′(α), α) with

        w′(α) = w − η · (momentum·buf + ∇w L_train(w, α) + wd·w),

    the reference's ``_compute_unrolled_model``.  The total derivative is
    exact: ``∇w L_train`` is taken with ``create_graph=True``, so the
    gradient of the validation loss at ``w′`` reaches the alphas through
    ``w′`` as well as directly; the reference's finite-difference
    Hessian-vector product is not used.

    ``train_loss_fn(params, alphas)`` and ``val_loss_fn(params, alphas)``
    return scalars; ``buf`` is the weight optimizer's momentum buffer
    (None = zeros, a fresh optimizer)."""
    names = list(params)
    a_names = list(alphas)
    with torch.enable_grad():
        a = {k: alphas[k].detach().requires_grad_(True) for k in a_names}
        w = {k: params[k].detach().requires_grad_(True) for k in names}
        gw = torch.autograd.grad(train_loss_fn(w, a), [w[k] for k in names],
                                 create_graph=True)
        new_p = {}
        for k, g in zip(names, gw):
            b = buf[k] if buf is not None else torch.zeros_like(params[k])
            p = params[k].detach()
            new_p[k] = p - eta * (momentum * b + g + weight_decay * p)
        ga = torch.autograd.grad(val_loss_fn(new_p, a), [a[k] for k in a_names],
                                 allow_unused=True, materialize_grads=True)
    return dict(zip(a_names, ga))


def _weighted_mean(trees, w: torch.Tensor) -> dict:
    """``Σ_k w_k · tree_k`` in float32, cast back to each leaf's dtype."""
    acc = treelib.tree_weighted_sum([treelib.tree_cast_floats(t, torch.float32)
                                     for t in trees], w)
    return treelib.tree_cast_like(acc, trees[0])


class FedNASSearch:
    """Search-stage driver: federated bilevel optimization of (weights,
    alphas).  The weights are flax's init under ``PRNGKey(seed)``, the
    alphas ``init_alphas(fold_in(PRNGKey(seed), 1))``."""

    def __init__(self, bundle: SearchBundle, dataset: FedDataset, config: FedNASConfig,
                 *, device: DeviceLike = None):
        if config.arch_order not in (1, 2):
            raise ValueError(f"arch_order must be 1 or 2, got {config.arch_order}")
        self.device = driver_device(device, bundle)
        self.bundle = bundle
        self.ds = dataset
        self.cfg = config
        key = rnglib.PRNGKey(config.seed)
        self.variables = bundle.init(key)
        self.alphas = bundle.init_alphas(rnglib.fold_in(key, 1))
        self.round_idx = 0
        self.steps = cohort_steps_per_epoch(dataset, config.batch_size)
        self.sched = cosine_epoch_schedule(config.lr, config.lr_min, config.epochs,
                                           self.steps)
        self.w_opt = make_client_optimizer(
            "sgd", self.sched, momentum=config.momentum,
            weight_decay=config.weight_decay, grad_clip=config.grad_clip)
        # the reference Architect: Adam(arch_lr, betas=(0.5, 0.999), wd)
        self.a_opt = optrepo.chain(optrepo.clip_by_global_norm(config.grad_clip),
                                   optrepo.add_decayed_weights(config.arch_weight_decay),
                                   optrepo.adam(config.arch_lr, b1=0.5, b2=0.999))
        self._test_pack = to_device(
            batch_eval_pack(dataset.test_x, dataset.test_y, max(config.batch_size, 64)),
            self.device)
        self.history = []

    # -- the losses -------------------------------------------------------
    def _w_loss(self, params, others, alphas, bx, by, bm):
        logits, new_vars = self.bundle.apply_train({**others, "params": params}, alphas, bx)
        loss, aux = masked_softmax_ce(logits, by, bm)
        return loss, new_vars, aux

    def _a_loss(self, alphas, variables, bx, by, bm):
        logits, _ = self.bundle.apply_train(variables, alphas, bx)
        return masked_softmax_ce(logits, by, bm)[0]

    def _alpha_grad(self, alphas, variables, bx, by, bm) -> dict:
        with torch.enable_grad():
            a = {k: v.detach().requires_grad_(True) for k, v in alphas.items()}
            # a net whose cells are all reduction cells leaves the normal
            # alphas unused: their gradient is zero, as in JAX
            g = torch.autograd.grad(self._a_loss(a, variables, bx, by, bm), list(a.values()),
                                    allow_unused=True, materialize_grads=True)
        return dict(zip(a, g))

    def _unrolled_alpha_grad(self, alphas, variables, w_state, batch, vbatch) -> dict:
        """``darts_unrolled_alpha_grad`` on this step's batches, with η the
        schedule's current value and the live momentum buffer, both read
        from the weight optimizer's state (torch's architect reads the
        same two from its network optimizer, ``architect.py:37-42``)."""
        cfg = self.cfg
        others = {k: v for k, v in variables.items() if k != "params"}
        # the weight chain is make_client_optimizer's sgd: [clip, wd, trace,
        # lr], the states in that order; the lr's state is the schedule's
        # count, the trace's the momentum buffer
        eta = self.sched(w_state[-1]) if callable(self.sched) else self.sched
        return darts_unrolled_alpha_grad(
            lambda p, a: self._w_loss(p, others, a, *batch)[0],
            lambda p, a: self._a_loss(a, {**others, "params": p}, *vbatch),
            variables["params"], alphas, eta=eta, momentum=cfg.momentum,
            weight_decay=cfg.weight_decay, buf=w_state[-2] if cfg.momentum else None)

    # -- one client's local search ------------------------------------------
    def _one_client(self, x, y, m, vx, vy, vm):
        cfg = self.cfg
        variables, alphas = self.variables, self.alphas
        w_state = self.w_opt.init(variables["params"])
        a_state = self.a_opt.init(alphas)
        n_valid = vx.shape[0]
        for _ in range(cfg.epochs):
            auxs = []
            for bi in range(x.shape[0]):
                batch = (x[bi], y[bi], m[bi])
                # a valid batch per train step (reference local_search:
                # next(iter(valid_queue)))
                vi = bi % n_valid
                vbatch = (vx[vi], vy[vi], vm[vi])
                if cfg.arch_order == 2:
                    g = self._unrolled_alpha_grad(alphas, variables, w_state, batch, vbatch)
                else:  # architect step_v2: g_val + λ_train · g_train
                    g_train = self._alpha_grad(alphas, variables, *batch)
                    g_val = self._alpha_grad(alphas, variables, *vbatch)
                    g = {k: g_val[k] + cfg.lambda_train_regularizer * g_train[k]
                         for k in g_val}
                with torch.no_grad():
                    a_up, a_state = self.a_opt.update(g, a_state, alphas)
                    new_alphas = optrepo.apply_updates(alphas, a_up)
                # the weight step, at the new alphas
                params = variables["params"]
                others = {k: v for k, v in variables.items() if k != "params"}
                leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
                with torch.enable_grad():
                    loss, new_vars, aux = self._w_loss(leaves, others, new_alphas, *batch)
                    gw = torch.autograd.grad(loss, list(leaves.values()))
                with torch.no_grad():
                    w_up, w_state = self.w_opt.update(dict(zip(leaves, gw)), w_state, params)
                    # a pad-only batch leaves weights and alphas as they
                    # were; its optimizer states and batch_stats advance
                    real = m[bi].sum() > 0
                    params = {k: torch.where(real, p + w_up[k], p) for k, p in params.items()}
                    alphas = {k: torch.where(real, new_alphas[k], a)
                              for k, a in alphas.items()}
                    variables = {**treelib.tree_detach(
                        {k: v for k, v in new_vars.items() if k != "params"}),
                        "params": params}
                auxs.append({k: v.detach() for k, v in aux.items()})
        metrics = {k: torch.stack([a[k] for a in auxs]).sum() for k in auxs[0]}
        return variables, alphas, metrics

    # -- the round --------------------------------------------------------
    def _packs(self, ids, round_idx):
        """The cohort's train pack and its valid pack: each client's test
        shard where the dataset has per-client test shards (the reference
        passes ``test_local`` as the valid queue), otherwise a second
        pack of its train shard."""
        cfg = self.cfg
        pack = pack_clients(self.ds, ids, cfg.batch_size, steps_per_epoch=self.steps,
                            seed=cfg.seed + round_idx)
        if self.ds.test_client_idx is not None:
            vds = FedDataset(
                train_x=self.ds.test_x, train_y=self.ds.test_y,
                test_x=self.ds.test_x, test_y=self.ds.test_y,
                train_client_idx=self.ds.test_client_idx, test_client_idx=None,
                num_classes=self.ds.num_classes)
            vpack = pack_clients(vds, ids, cfg.batch_size, seed=cfg.seed + round_idx + 7)
        else:
            vpack = pack_clients(self.ds, ids, cfg.batch_size, steps_per_epoch=self.steps,
                                 seed=cfg.seed + round_idx + 7)
        return pack, vpack

    def run_round(self) -> dict:
        cfg = self.cfg
        round_idx = self.round_idx
        if cfg.clients_per_round < cfg.num_clients:
            rng = np.random.RandomState(cfg.seed * 100003 + round_idx)
            ids = sorted(rng.choice(cfg.num_clients, cfg.clients_per_round,
                                    replace=False).tolist())
        else:
            ids = list(range(cfg.num_clients))
        pack, vpack = self._packs(ids, round_idx)
        x, y, m, ns = to_device((pack.x, pack.y, pack.mask, pack.num_samples), self.device)
        vx, vy, vm = to_device((vpack.x, vpack.y, vpack.mask), self.device)
        outs = [self._one_client(x[k], y[k], m[k], vx[k], vy[k], vm[k])
                for k in range(len(ids))]
        w = ns / torch.clamp(ns.sum(), min=1e-12)
        self.variables = _weighted_mean([o[0] for o in outs], w)
        self.alphas = _weighted_mean([o[1] for o in outs], w)
        self.round_idx += 1
        metrics = {k: torch.stack([o[2][k] for o in outs]).sum() for k in outs[0][2]}
        out = {"round": round_idx, **{k: float(v) for k, v in metrics.items()}}
        if out.get("count", 0) > 0:
            out["train_acc"] = out["correct"] / out["count"]
        return out

    @torch.no_grad()
    def evaluate_global(self) -> dict:
        tx, ty, tm = self._test_pack
        auxs = [masked_softmax_ce(self.bundle.apply_eval(self.variables, self.alphas, tx[s]),
                                  ty[s], tm[s])[1] for s in range(tx.shape[0])]
        count = max(float(sum(a["count"] for a in auxs)), 1.0)
        return {"test_acc": float(sum(a["correct"] for a in auxs)) / count,
                "test_loss": float(sum(a["loss_sum"] for a in auxs)) / count}

    def genotype(self) -> Genotype:
        """The discrete architecture of the aggregated alphas
        (reference ``model_search.py:258-297``)."""
        return genotype_from_alphas(
            self.alphas["alphas_normal"].cpu().numpy(),
            self.alphas["alphas_reduce"].cpu().numpy(),
            steps=self.bundle.module.steps, multiplier=self.bundle.module.multiplier)

    def run(self, rounds: Optional[int] = None) -> list:
        for _ in range(rounds if rounds is not None else self.cfg.comm_rounds):
            self.history.append(self.run_round())
        self.history[-1].update(self.evaluate_global())
        return self.history


def fednas_train_stage(
    genotype: Genotype, dataset: FedDataset, config: FedAvgConfig,
    *, C: int = 36, layers: int = 20, image_size: int = 32,
    in_channels: int = 3, lr_min: float = 0.001, metrics=None,
    device: DeviceLike = None,
) -> FedAvgSimulation:
    """Stage 2 (``--stage train``): the FedAvg engine on the fixed network
    of ``genotype``, with the search stage's per-epoch cosine schedule as
    the client learning rate (``FedNASTrainer.py:141-155``; the constant lr
    when ``epochs == 1``).  Every other ``FedAvgConfig`` knob applies."""
    bundle = darts_network(genotype, C=C, num_classes=dataset.num_classes, layers=layers,
                           image_size=image_size, in_channels=in_channels, device=device)
    schedule = cosine_epoch_schedule(config.lr, lr_min, config.epochs,
                                     cohort_steps_per_epoch(dataset, config.batch_size))
    return FedAvgSimulation(bundle, dataset, config, client_lr=schedule, metrics=metrics,
                            device=device)
