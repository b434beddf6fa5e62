"""Hierarchical (two-tier) federated averaging: clients → groups → global
(port of ``fedml_tpu/algorithms/hierarchical.py``).

Reference ``fedml_api/standalone/hierarchical_fl/`` (``trainer.py:43-69``,
``group.py:24-46``): every global round, each group starts from the
global model and runs ``group_comm_round`` rounds of in-group FedAvg
through the FedAvg round kernel; the global model is then the
sample-weighted average of the group models, cast back to the
variables' dtypes.  Group g's in-group rounds run from round index
``round · group_comm_round`` under the key ``fold_in(key, 1000 + g)``,
on the group's block packed once and kept on the device.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from fedml_tpu_torch.algorithms.fedavg import FedAvgConfig, FedAvgSimulation, ServerState
from fedml_tpu_torch.core import rng as rnglib
from fedml_tpu_torch.core import tree as treelib
from fedml_tpu_torch.core.losses import LossFn, masked_softmax_ce
from fedml_tpu_torch.core.types import FedDataset, device_resident_pack
from fedml_tpu_torch.models.base import ModelBundle


def assign_groups(num_clients: int, num_groups: int, method: str = "random",
                  seed: int = 0) -> Dict[int, List[int]]:
    """Reference grouping: a random equal split of the clients."""
    rng = np.random.RandomState(seed)
    ids = rng.permutation(num_clients) if method == "random" else np.arange(num_clients)
    return {g: part.tolist() for g, part in enumerate(np.array_split(ids, num_groups))}


class HierarchicalSimulation(FedAvgSimulation):
    def __init__(
        self,
        bundle: ModelBundle,
        dataset: FedDataset,
        config: FedAvgConfig,
        *,
        num_groups: int = 2,
        group_comm_round: int = 2,
        groups: Optional[Dict[int, List[int]]] = None,
        group_method: str = "random",
        loss_fn: LossFn = masked_softmax_ce,
        **kwargs,
    ):
        super().__init__(bundle, dataset, config, loss_fn=loss_fn, **kwargs)
        self.groups = groups or assign_groups(config.num_clients, num_groups,
                                              group_method, seed=config.seed)
        self.group_comm_round = group_comm_round
        self._group_pack_cache: dict = {}

    def _group_pack(self, g, ids):
        """Group g's block on the device and its total sample count,
        packed once: groups are fixed, and the local update re-permutes
        each epoch from the advancing round index."""
        hit = self._group_pack_cache.get(g)
        if hit is None:
            args, host_ns = device_resident_pack(
                self.dataset, ids, self.cfg.batch_size,
                steps_per_epoch=self.steps_per_epoch, seed=self.cfg.seed,
                device=self.device)
            hit = self._group_pack_cache[g] = (args, float(host_ns.sum()))
        return hit

    def run_round(self) -> dict:
        """One global round: ``group_comm_round`` in-group FedAvg rounds per
        group from the global model, then the weighted average of the
        groups."""
        round_idx = int(self.state.round_idx)
        group_vars, group_weights = [], []
        agg_metrics = {"loss_sum": 0.0, "correct": 0.0, "count": 0.0}
        for g, client_ids in self.groups.items():
            gstate = ServerState(self.state.variables, self.state.opt_state,
                                 round_idx * self.group_comm_round,
                                 rnglib.fold_in(self.state.key, 1000 + g))
            ids = np.asarray(client_ids)
            with self.metrics.span("pack"):
                (px, py, pm, pns), group_total = self._group_pack(g, ids)
            with self.metrics.span("round"):
                for _ in range(self.group_comm_round):
                    gstate, metrics = self.round_fn(
                        gstate, px, py, pm, pns,
                        torch.ones(len(ids), device=self.device), ids)
                    # the metrics cover every in-group round
                    for k in agg_metrics:
                        agg_metrics[k] += float(metrics[k])
            # every in-group round syncs the group model to each member
            # and collects each member's update
            self._record_sim_comm(len(ids), rounds=self.group_comm_round)
            group_vars.append(gstate.variables)
            group_weights.append(group_total)

        with self.metrics.span("agg"):
            # the hierarchy's own aggregation tier
            total = sum(group_weights)
            new_vars = treelib.tree_weighted_sum(
                group_vars, [w / total for w in group_weights])
            new_vars = treelib.tree_map(lambda s, ref: s.to(ref.dtype), new_vars,
                                        self.state.variables)
        self.state = ServerState(new_vars, self.state.opt_state, round_idx + 1,
                                 self.state.key, self.state.residuals)
        return self._train_row(agg_metrics, round_idx)
