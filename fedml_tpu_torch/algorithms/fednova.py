"""FedNova: normalized averaging of heterogeneous local updates (port of
``fedml_tpu/algorithms/fednova.py``).

Each client's normalized gradient is recovered in closed form from its
local delta: for SGD (+momentum ρ, lr η) over τᵢ steps,
``w₀ − w_τ = η · aᵢ · dᵢ`` with

    aᵢ = τᵢ                                  (ρ = 0)
    aᵢ = (τᵢ − ρ(1 − ρ^τᵢ)/(1 − ρ)) / (1 − ρ)  (ρ > 0)

and τᵢ the optimizer steps the client took (``core/client.py``'s
``steps`` metric: pad-only batches do not count).  The server applies
``w ← w − τ_eff · η · Σ pᵢ dᵢ`` with ``τ_eff = Σ pᵢ aᵢ`` and ``pᵢ`` the
sample weights, plus optional global momentum (``gmf``, its buffer in
``ServerState.opt_state``).  Non-param collections (BatchNorm
statistics) take the plain weighted average, or stay as they were in a
round nobody took part in.

The closed form holds for plain SGD(+momentum) only, so gradient clipping
and weight decay are refused.  ``ρ^τ`` is a float64 power rounded to
float32, which XLA's float32 ``pow`` matches up to an ulp at some τ
(``core/optrepo.py``); the tests hold the round at 1e-5.

As in ``make_round_fn``, clients run one after another and each is
folded into the sums as soon as it finishes.
"""

from __future__ import annotations

import numpy as np
import torch

from fedml_tpu_torch.algorithms.fedavg import (
    FedAvgConfig,
    FedAvgSimulation,
    ServerState,
)
from fedml_tpu_torch.core import rng as rnglib
from fedml_tpu_torch.core import tree as treelib
from fedml_tpu_torch.core.losses import LossFn, masked_softmax_ce
from fedml_tpu_torch.core.optrepo import f32_pow
from fedml_tpu_torch.core.types import FedDataset
from fedml_tpu_torch.models.base import ModelBundle
from fedml_tpu_torch.utils.device import DeviceLike, resolve_device


def nova_coefficient(tau: torch.Tensor, rho: float) -> torch.Tensor:
    """aᵢ for SGD(+momentum): Wang et al. 2020, the momentum case."""
    tau = tau.float()
    if rho == 0.0:
        return torch.clamp_min(tau, 1.0)
    geom = (1.0 - f32_pow(rho, tau)) / (1.0 - rho)
    return torch.clamp_min((tau - rho * geom) / (1.0 - rho), 1.0)


def make_fednova_round_fn(local_update, *, lr: float, momentum: float,
                          gmf: float = 0.0, device: DeviceLike = None):
    """The FedNova round kernel, with ``make_round_fn``'s signature and
    random streams (``fold_in(fold_in(fold_in(key, round), 0), slot)``
    per client)."""
    dev = resolve_device(device)

    @torch.no_grad()
    def round_fn(state: ServerState, x, y, mask, num_samples, participation,
                 slot_ids):
        x, y, mask, num_samples, participation = (
            t.to(dev) for t in (x, y, mask, num_samples, participation))
        ids = [int(i) for i in np.asarray(torch.as_tensor(slot_ids).cpu())]
        k_train = rnglib.fold_in(rnglib.fold_in(state.key, state.round_idx), 0)
        w0 = state.variables["params"]
        weights = participation * num_samples
        total = weights.sum()
        p = weights / torch.clamp_min(total, 1e-12)  # sums to 1
        d_sum = None  # Σ pᵢ dᵢ with dᵢ = (w₀ − wᵢ) / (η aᵢ)
        others = {coll: None for coll in state.variables if coll != "params"}
        tau_eff = torch.zeros((), device=dev)
        train_metrics: dict = {}
        for k, slot in enumerate(ids):
            cvars, cm = local_update(state.variables, x[k], y[k], mask[k],
                                     rnglib.fold_in(k_train, slot))
            a = nova_coefficient(cm["steps"], momentum)
            c = p[k] / (lr * a)
            delta = treelib.tree_map(lambda g, w: g.float() - w.float(), w0,
                                     cvars["params"])
            d_sum = treelib.tree_fold_weighted(d_sum, delta, c)
            tau_eff = tau_eff + p[k] * a
            for coll in others:
                others[coll] = treelib.tree_fold_weighted(others[coll], cvars[coll], p[k])
            for name, v in cm.items():
                w = participation[k] * v
                train_metrics[name] = train_metrics[name] + w if name in train_metrics else w

        opt_state = state.opt_state
        step_dir = d_sum
        if gmf > 0.0:
            step_dir = opt_state = treelib.tree_add(treelib.tree_scale(opt_state, gmf),
                                                    d_sum)
        step = tau_eff * lr
        new_vars = {"params": treelib.tree_map(
            lambda w, d: (w.float() - step * d).to(w.dtype), w0, step_dir)}
        # a round with no participant keeps the old statistics (the
        # p-weighted sum would be all zeros)
        for coll, summed in others.items():
            new_vars[coll] = treelib.tree_map(
                lambda s, ref: torch.where(total > 0, s.to(ref.dtype), ref),
                summed, state.variables[coll])
        train_metrics["participants"] = participation.sum()
        return ServerState(new_vars, opt_state, state.round_idx + 1, state.key,
                           state.residuals), train_metrics

    return round_fn


class FedNovaSimulation(FedAvgSimulation):
    """Standalone FedNova driver (reference ``standalone/fednova/``): the
    FedAvg simulation loop with the FedNova round kernel."""

    def __init__(
        self,
        bundle: ModelBundle,
        dataset: FedDataset,
        config: FedAvgConfig,
        *,
        gmf: float = 0.0,
        loss_fn: LossFn = masked_softmax_ce,
        **kwargs,
    ):
        if config.client_optimizer != "sgd":
            raise ValueError("FedNova requires the SGD client optimizer")
        if config.grad_clip is not None or config.weight_decay:
            raise ValueError(
                "FedNova's closed-form normalization assumes vanilla "
                "SGD(+momentum); grad_clip/weight_decay are unsupported")
        self._gmf = gmf
        super().__init__(bundle, dataset, config, loss_fn=loss_fn, **kwargs)
        if gmf > 0.0:
            self.state = self.state._replace(
                opt_state=treelib.tree_zeros_like(self.state.variables["params"]))

    def _build_round_fn(self):
        return make_fednova_round_fn(self.local_update, lr=self.cfg.lr,
                                     momentum=self.cfg.momentum, gmf=self._gmf,
                                     device=self.device)
