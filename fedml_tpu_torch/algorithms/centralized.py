"""Centralized (non-federated) baseline trainer (port of
``fedml_tpu/algorithms/centralized.py``).

Trains on the union of all clients' data with the same data contract;
the CI equivalence oracle is FedAvg at full participation, one full
batch per client and E=1 equal to centralized SGD.  It is the same
local-update operator (``core/client.py``) applied to one "client" that
holds the whole train set, so the oracle is a structural identity.  Call
``k`` of ``train`` runs under the key ``fold_in(PRNGKey(seed), 17 + k)``.
"""

from __future__ import annotations

from typing import Optional

import torch

from fedml_tpu_torch.core import rng as rnglib
from fedml_tpu_torch.core.client import (eval_summary, make_client_optimizer,
                                         make_evaluator, make_local_update)
from fedml_tpu_torch.core.losses import LossFn, masked_softmax_ce
from fedml_tpu_torch.core.types import FedDataset, batch_eval_pack, to_device
from fedml_tpu_torch.models.base import ModelBundle
from fedml_tpu_torch.utils.device import DeviceLike, driver_device


class CentralizedTrainer:
    def __init__(
        self,
        bundle: ModelBundle,
        dataset: FedDataset,
        *,
        epochs_per_call: int = 1,
        batch_size: int = 64,
        optimizer: str = "sgd",
        lr: float = 0.03,
        momentum: float = 0.0,
        weight_decay: Optional[float] = None,
        grad_clip: Optional[float] = None,
        loss_fn: LossFn = masked_softmax_ce,
        seed: int = 0,
        shuffle: bool = True,
        compute_dtype: Optional[torch.dtype] = None,
        device: DeviceLike = None,
    ):
        self.device = driver_device(device, bundle)
        self.bundle = bundle
        self.dataset = dataset
        opt = make_client_optimizer(optimizer, lr, momentum=momentum,
                                    weight_decay=weight_decay, grad_clip=grad_clip)
        self.update = make_local_update(bundle, opt, epochs_per_call, loss_fn,
                                        shuffle=shuffle, compute_dtype=compute_dtype)
        self.evaluator = make_evaluator(bundle, loss_fn)
        self.key = rnglib.PRNGKey(seed)
        self.variables = bundle.init(self.key)
        self._train_pack = to_device(
            batch_eval_pack(dataset.train_x, dataset.train_y, batch_size), self.device)
        self._test_pack = to_device(
            batch_eval_pack(dataset.test_x, dataset.test_y, max(batch_size, 64)),
            self.device)
        self.epoch = 0

    def train(self, epochs: int = 1) -> dict:
        x, y, m = self._train_pack
        metrics = {}
        for _ in range(epochs):
            self.variables, metrics = self.update(
                self.variables, x, y, m, rnglib.fold_in(self.key, 17 + self.epoch))
            self.epoch += 1
        out = {k: float(v) for k, v in metrics.items()}
        if out.get("count"):
            out["train_acc"] = out["correct"] / out["count"]
            out["train_loss"] = out["loss_sum"] / out["count"]
        return out

    def evaluate(self) -> dict:
        res = eval_summary(self.evaluator(self.variables, *self._test_pack))
        return {"test_acc": res["test_acc"], "test_loss": res["test_loss"]}
