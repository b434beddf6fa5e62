"""FedAvg under a backdoor attack with robust aggregation defenses (port
of ``fedml_tpu/algorithms/fedavg_robust.py``).

Reference ``fedml_api/distributed/fedavg_robust/``: one client (rank 1
by default) trains on a poisoned mixture every ``attack_freq`` rounds
(``FedAvgRobustTrainer.py:14-25``); the server clips or noises the
updates (``FedAvgRobustAggregator.py:166-220``) and reports the main
task's and the backdoor's accuracy.

Here the defense is the round's ``aggregate_transform`` hook
(``core/robust.py``), the attack swaps the attacker's slot of the
device-resident cohort block for the poisoned rows (built once, on the
device) in attack rounds, each history row says whether the round was
attacked, and every evaluation adds ``backdoor_acc``.  ``run_fused``
refuses this driver (its block changes per round); ``run()`` and
``run_fused_sampled`` run it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from fedml_tpu_torch.algorithms.fedavg import FedAvgConfig, FedAvgSimulation
from fedml_tpu_torch.core.losses import LossFn, masked_softmax_ce
from fedml_tpu_torch.core.robust import make_robust_transform
from fedml_tpu_torch.core.types import FedDataset, batch_eval_pack
from fedml_tpu_torch.data.edge_case import PoisonedData, make_backdoor
from fedml_tpu_torch.models.base import ModelBundle


def _on(device, arrays) -> tuple:
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays)


class FedAvgRobustSimulation(FedAvgSimulation):
    def __init__(
        self,
        bundle: ModelBundle,
        dataset: FedDataset,
        config: FedAvgConfig,
        *,
        defense_type: str = "norm_diff_clipping",  # or "weak_dp" / "median" / ... / "none"
        norm_bound: float = 30.0,
        stddev: float = 0.025,
        attacker_client: int = 1,  # reference: rank 1 is the attacker
        attack_freq: int = 1,
        target_label: int = 0,
        poison_fraction: float = 0.3,
        poison: Optional[PoisonedData] = None,
        loss_fn: LossFn = masked_softmax_ce,
        **kwargs,
    ):
        transform = (None if defense_type in (None, "none") else
                     make_robust_transform(defense_type, norm_bound=norm_bound,
                                           stddev=stddev))
        super().__init__(bundle, dataset, config, loss_fn=loss_fn,
                         aggregate_transform=transform, **kwargs)
        self.attacker_client = attacker_client
        self.attack_freq = max(1, attack_freq)
        self.poison = poison or make_backdoor(
            dataset, attacker_client, target_label=target_label,
            poison_fraction=poison_fraction, seed=config.seed)
        self._backdoor_pack = _on(self.device, batch_eval_pack(
            self.poison.backdoor_test_x, self.poison.backdoor_test_y,
            max(config.batch_size, 64)))
        self._poison_slot_cache: Optional[tuple] = None

    def _attacking(self, ids, round_idx: int) -> bool:
        return round_idx % self.attack_freq == 0 and self.attacker_client in ids

    def _poison_slot_rows(self) -> tuple:
        """The attacker's poisoned slot, ``[S, B, ...]`` rows on the device
        plus its true sample count, built once (the poison is fixed for the
        run); the clean cohort block stays the base class's one copy."""
        if self._poison_slot_cache is None:
            S, B = self.steps_per_epoch, self.cfg.batch_size
            px, py, pm = batch_eval_pack(self.poison.train_x, self.poison.train_y, B)
            steps = min(S, px.shape[0])
            x = np.zeros((S, B, *px.shape[2:]), px.dtype)
            y = np.zeros((S, B, *py.shape[2:]), py.dtype)
            m = np.zeros((S, B), np.float32)
            x[:steps], y[:steps], m[:steps] = px[:steps], py[:steps], pm[:steps]
            self._poison_slot_cache = _on(self.device, (x, y, m)) + (
                float(pm[:steps].sum()),)
        return self._poison_slot_cache

    def _cohort_block(self, ids, round_idx: int) -> tuple:
        """Attack rounds swap the attacker's slot for the poisoned rows on
        the device (into a copy of the block); other rounds share the base
        class's clean block."""
        clean = super()._cohort_block(ids, round_idx)
        if not self._attacking(ids, round_idx):
            return clean
        px, py, pm, pns = self._poison_slot_rows()
        slot = int(np.where(np.asarray(ids) == self.attacker_client)[0][0])
        out = tuple(t.clone() for t in clean)
        for t, rows in zip(out, (px, py, pm, pns)):
            t[slot] = rows.to(t.dtype) if isinstance(rows, torch.Tensor) else rows
        return out

    def _annotate_round(self, out: dict, ids, round_idx: int) -> None:
        out["attacking"] = self._attacking(ids, round_idx)

    def evaluate_backdoor(self) -> dict:
        """Targeted-task accuracy: the share of triggered samples classified
        as the attacker's target label (lower is better for the defense)."""
        res = self.evaluator(self.state.variables, *self._backdoor_pack)
        return {"backdoor_acc": float(res["correct"]) / max(float(res["count"]), 1.0)}

    def _extra_eval(self) -> dict:
        return self.evaluate_backdoor()
