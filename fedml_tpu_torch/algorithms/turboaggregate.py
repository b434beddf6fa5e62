"""TurboAggregate — secure aggregation over a finite field (port of
``fedml_tpu/algorithms/turboaggregate.py``).

Clients quantize their model updates into a prime field and aggregate
through secret sharing, so the server never sees an individual update:
additive sharing, and Lagrange-coded (LCC) redundancy against
stragglers (reference ``turboaggregate/mpc_function.py``,
``TA_Aggregator.py:56-87``).  Share generation and recombination are the
int64 field ops of ``core/mpc.py`` on the vectors' device; the Lagrange
coefficients are exact host integers; local training is the shared
client operator.  Secure aggregation reproduces the plain sample-weighted
average to quantization precision (< n/(2·scale) per element).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from fedml_tpu_torch.core import mpc
from fedml_tpu_torch.core import rng as rnglib
from fedml_tpu_torch.core import tree as treelib
from fedml_tpu_torch.core.client import (make_client_optimizer, make_evaluator,
                                         make_local_update)
from fedml_tpu_torch.core.losses import LossFn, masked_softmax_ce
from fedml_tpu_torch.core.types import (FedDataset, batch_eval_pack,
                                        cohort_steps_per_epoch, device_resident_pack,
                                        to_device)
from fedml_tpu_torch.models.base import ModelBundle
from fedml_tpu_torch.utils.device import DeviceLike, driver_device


def secure_weighted_sum(vectors: Sequence[torch.Tensor], weights: Sequence[float], key, *,
                        scale: float = 2.0 ** 16, p: int = mpc.DEFAULT_PRIME) -> torch.Tensor:
    """Σ wᵢ·vᵢ (float64, on the vectors' device) via additive secret
    sharing: the server only ever sees per-holder share sums.

    Client i quantizes wᵢ·vᵢ (float64) into the field and splits it into
    N additive shares under ``fold_in(key, i)``, share j to holder j;
    each holder sums what it received; the sum of the holder sums is
    exactly Σ quant(wᵢ·vᵢ) mod p."""
    n = len(vectors)
    holder_sums = None
    for i, (v, w) in enumerate(zip(vectors, weights)):
        q = mpc.quantize(torch.as_tensor(v).double() * float(w), scale, p)
        shares = mpc.additive_shares(q, n, rnglib.fold_in(key, i), p)
        holder_sums = shares if holder_sums is None else mpc.field_sum(
            torch.stack([holder_sums, shares]), p)
    return mpc.dequantize(mpc.field_sum(holder_sums, p), scale, p)


def lcc_coded_sum(vectors: Sequence[torch.Tensor], key, *, k: int = 2, t: int = 1,
                  drop: Sequence[int] = (), scale: float = 2.0 ** 16,
                  p: int = mpc.DEFAULT_PRIME) -> torch.Tensor:
    """Straggler-resilient sum: each client LCC-encodes its quantized
    vector into N shares (K data chunks + T random) under ``fold_in(key,
    i)``; the server sums the surviving workers' shares in the field and
    decodes from any K+T of them, so dropped workers (``drop``) cost
    nothing."""
    n = len(vectors)
    d = vectors[0].numel()
    pad = (-d) % k
    enc = []
    for i, v in enumerate(vectors):
        flat = torch.as_tensor(v).double().reshape(-1)
        flat = torch.cat([flat, flat.new_zeros(pad)])
        enc.append(mpc.lcc_encode(mpc.quantize(flat, scale, p), n, k, t,
                                  rnglib.fold_in(key, i), p))
    # worker j holds Σ_i enc_i[j], computable without seeing any v_i
    share_sum = mpc.field_sum(torch.stack(enc), p)  # [n, (d + pad)/k]
    alive = [j for j in range(n) if j not in set(drop)]
    need = k + t  # decode degree: interpolation through K+T points
    if len(alive) < need:
        raise ValueError(f"too many stragglers: {len(alive)} < {need}")
    use = alive[:need]
    # interpolating through K+T α-points recovers all K+T chunk rows of the
    # SUMMED polynomial; the first K rows are the data
    decoded = mpc.lcc_decode(share_sum[use], use, n, k + t, p)
    return mpc.dequantize(decoded[: d + pad], scale, p)[:d]


@dataclasses.dataclass
class TurboAggregateConfig:
    num_clients: int = 8
    comm_rounds: int = 5
    epochs: int = 1
    batch_size: int = 10
    lr: float = 0.03
    scale: float = 2.0 ** 16
    seed: int = 0


class TurboAggregateSimulation:
    """FedAvg with the aggregation replaced by the secure path: clients
    train with the shared local-update operator from the global model
    (client i of round r under ``fold_in(fold_in(fold_in(key, r), 0),
    i)``); their weighted models travel as additive shares (under
    ``fold_in(fold_in(key, r), 1)``) over the whole variable tree,
    ``batch_stats`` included; the server reconstructs only the
    sample-weighted aggregate (reference ``TA_Aggregator.aggregate``).
    The vectors stay on the device."""

    def __init__(self, bundle: ModelBundle, dataset: FedDataset,
                 config: TurboAggregateConfig, *, loss_fn: LossFn = masked_softmax_ce,
                 compute_dtype: Optional[torch.dtype] = None, device: DeviceLike = None):
        self.device = driver_device(device, bundle)
        self.bundle = bundle
        self.dataset = dataset
        self.cfg = config
        opt = make_client_optimizer("sgd", config.lr)
        self._local = make_local_update(bundle, opt, config.epochs, loss_fn,
                                        compute_dtype=compute_dtype)
        self.evaluator = make_evaluator(bundle, loss_fn)
        key = rnglib.PRNGKey(config.seed)
        self.variables = bundle.init(key)
        self.key = key
        self.steps_per_epoch = cohort_steps_per_epoch(dataset, config.batch_size)
        self._test_pack = to_device(
            batch_eval_pack(dataset.test_x, dataset.test_y, 64), self.device)
        self.round_idx = 0
        self.history: List[dict] = []
        self._pack_cache = None

    def _device_pack(self):
        """The full cohort's block, packed once (each round's randomness is
        the local update's per-epoch permutation), with the host-side
        sample counts: the aggregation weights need no device read-back."""
        if self._pack_cache is None:
            args, host_ns = device_resident_pack(
                self.dataset, np.arange(self.cfg.num_clients), self.cfg.batch_size,
                steps_per_epoch=self.steps_per_epoch, seed=self.cfg.seed,
                device=self.device)
            self._pack_cache = (args[:3], host_ns)
        return self._pack_cache

    def run_round(self) -> dict:
        cfg = self.cfg
        (px, py, pm), host_ns = self._device_pack()
        k_round = rnglib.fold_in(rnglib.fold_in(self.key, self.round_idx), 0)
        keys = rnglib.fold_in_many(k_round, np.arange(cfg.num_clients))
        vecs, metrics = [], []
        for i in range(cfg.num_clients):
            v, m = self._local(self.variables, px[i], py[i], pm[i], keys[i])
            # raveled in the global tree's leaf order, which tree_unravel
            # reads back (the local update returns batch_stats first)
            vecs.append(treelib.tree_ravel(
                treelib.tree_map(lambda _, leaf: leaf, self.variables, v)))
            metrics.append(m)
        weights = np.asarray(host_ns, np.float64)
        weights = weights / weights.sum()
        agg_key = rnglib.fold_in(rnglib.fold_in(self.key, self.round_idx), 1)
        summed = secure_weighted_sum(vecs, weights, agg_key, scale=cfg.scale)
        self.variables = treelib.tree_unravel(self.variables, summed.float())
        out = {k: float(torch.stack([m[k] for m in metrics]).sum()) for k in metrics[0]}
        out["round"] = self.round_idx
        if out.get("count", 0) > 0:
            out["train_acc"] = out["correct"] / out["count"]
        self.round_idx += 1
        self.history.append(out)
        return out

    def evaluate_global(self) -> dict:
        res = self.evaluator(self.variables, *self._test_pack)
        count = float(res["count"])
        return {"test_acc": float(res["correct"]) / count,
                "test_loss": float(res["loss_sum"]) / count}

    def run(self, rounds: Optional[int] = None, log_fn=None) -> list:
        """``comm_rounds`` (or ``rounds``) rounds, the last row with the
        global evaluation merged in.  The JAX class has no ``run``, so its
        entry point's turboaggregate dispatch raises AttributeError
        (ROADMAP C4); this is the loop that dispatch calls."""
        for _ in range(self.cfg.comm_rounds if rounds is None else rounds):
            m = self.run_round()
            if log_fn:
                log_fn(m)
        if self.history:
            self.history[-1].update(self.evaluate_global())
        return self.history
