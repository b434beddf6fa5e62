"""FedProx: FedAvg plus a proximal term on the client objective (port of
``fedml_tpu/algorithms/fedprox.py``).

The client loss gains ``(mu/2)·‖w − w_global‖²`` over the parameters
only (``core/client.py::make_local_update(prox_mu=...)``); aggregation
is FedAvg's.  ``sampling_schedule`` replaces the seeded uniform cohort
draw with a fixed list of cohorts, cycled by round (the reference's
preprocessed client-sampling lists).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from fedml_tpu_torch.algorithms.fedavg import FedAvgConfig, FedAvgSimulation
from fedml_tpu_torch.core.losses import LossFn, masked_softmax_ce
from fedml_tpu_torch.core.types import FedDataset
from fedml_tpu_torch.models.base import ModelBundle


class FedProxSimulation(FedAvgSimulation):
    def __init__(
        self,
        bundle: ModelBundle,
        dataset: FedDataset,
        config: FedAvgConfig,
        *,
        mu: float = 0.1,
        sampling_schedule: Optional[Sequence[Sequence[int]]] = None,
        loss_fn: LossFn = masked_softmax_ce,
        **kwargs,
    ):
        config = dataclasses.replace(config, prox_mu=mu)
        super().__init__(bundle, dataset, config, loss_fn=loss_fn, **kwargs)
        self._sampling_schedule = sampling_schedule

    def _sample_ids(self, round_idx: int) -> np.ndarray:
        if self._sampling_schedule is not None:
            sched = self._sampling_schedule
            return np.asarray(sched[round_idx % len(sched)])
        return super()._sample_ids(round_idx)
