"""Decentralized (serverless) gossip FL (port of
``fedml_tpu/algorithms/decentralized.py``).

Reference ``fedml_api/distributed/decentralized_framework/``: each
worker trains locally, pushes its result to its out-neighbours and
aggregates what its in-neighbours sent.  One gossip round here is

    local updates on every client's OWN model (persistent, never reset
    to a global one)  →  the mixing step  P ← W·P  with the
    row-stochastic topology matrix W,

over variables stacked on a leading client axis.  The clients train one
after another (the JAX package's ``lax.map``), client i under the key
``fold_in(fold_in(key, round), slot_i)``; the mix is one einsum per leaf
in float32, ``batch_stats`` included, cast back.  The SPMD forms hold one
client per rank of a mesh axis (``parallel/``): the ring mixes with two
``ppermute`` shifts (``ring_mix``), any other matrix through an
``all_gather`` and the rank's row of W.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from fedml_tpu_torch.core import rng as rnglib
from fedml_tpu_torch.core import tree as treelib
from fedml_tpu_torch.core.client import (eval_summary, make_client_optimizer,
                                         make_evaluator, make_local_update)
from fedml_tpu_torch.core.losses import LossFn, masked_softmax_ce
from fedml_tpu_torch.core.types import (FedDataset, batch_eval_pack,
                                        cohort_steps_per_epoch, device_resident_pack,
                                        to_device)
from fedml_tpu_torch.models.base import ModelBundle
from fedml_tpu_torch.parallel.compat import all_gather, axis_index, axis_size, ppermute
from fedml_tpu_torch.utils.device import DeviceLike, driver_device

Tree = Any


def dense_mix(stacked_vars: Tree, w: torch.Tensor) -> Tree:
    """P ← W·P for every leaf with the client axis leading (float32)."""
    return treelib.tree_map(
        lambda leaf: torch.einsum("ij,j...->i...", w, leaf.float()).to(leaf.dtype),
        stacked_vars)


def ring_mix(local_vars: Tree, axis_name: str, w_self=1 / 3, w_left=1 / 3,
             w_right=1 / 3) -> Tree:
    """Ring mixing via two ``ppermute`` shifts over a mesh axis (one client
    per rank), in float32, cast back."""
    n = axis_size(axis_name)
    left = [(i, (i + 1) % n) for i in range(n)]
    right = [(i, (i - 1) % n) for i in range(n)]
    f32 = treelib.tree_map(lambda leaf: leaf.float(), local_vars)
    from_left = ppermute(f32, axis_name, left)
    from_right = ppermute(f32, axis_name, right)
    return treelib.tree_map(
        lambda leaf, a, b: (w_self * leaf.float() + w_left * a + w_right * b).to(leaf.dtype),
        local_vars, from_left, from_right)


def make_gossip_round_fn(local_update, mixing_matrix: Optional[np.ndarray] = None, *,
                         axis_name: Optional[str] = None, ring: bool = False,
                         device: DeviceLike = None):
    """Round over stacked per-client variables [K, ...]:
    ``round_fn(stacked_vars, x, y, mask, rng, slot_ids)``.

    Simulation: the dense ``mixing_matrix`` einsum.  SPMD (``axis_name``
    set, one client per rank, run inside ``compat.shard_map``):
    ``ring=True`` mixes by ``ring_mix``; otherwise the dense matrix is
    applied through ``all_gather`` and the rank's row (``axis_index``).
    The metrics are this rank's sums."""
    if mixing_matrix is None and not (axis_name and ring):
        raise ValueError(
            "make_gossip_round_fn: a mixing_matrix is required unless "
            "using the SPMD ring path (axis_name=..., ring=True)"
        )
    dev = driver_device(device)
    w = (None if mixing_matrix is None else
         torch.as_tensor(np.asarray(mixing_matrix, np.float32), device=dev))

    def mix(new_vars):
        if axis_name is None:
            return dense_mix(new_vars, w)
        if next(iter(treelib.tree_leaves(new_vars))).shape[0] != 1:
            raise ValueError("the SPMD gossip holds one client per rank")
        if ring:
            mixed = ring_mix(treelib.tree_index(new_vars, 0), axis_name)
            return treelib.tree_map(lambda leaf: leaf[None], mixed)
        gathered = all_gather(new_vars, axis_name, tiled=True)
        row = w[axis_index(axis_name)]
        return treelib.tree_map(
            lambda g: torch.einsum("j,j...->...", row, g.float()).to(g.dtype)[None],
            gathered)

    def round_fn(stacked_vars, x, y, mask, rng, slot_ids):
        keys = rnglib.fold_in_many(rng, np.asarray(torch.as_tensor(slot_ids).cpu()))
        outs, metrics = [], []
        for i in range(len(keys)):
            v, m = local_update(treelib.tree_index(stacked_vars, i),
                                x[i], y[i], mask[i], keys[i])
            outs.append(v)
            metrics.append(m)
        mixed = mix(treelib.tree_stack(outs))
        return mixed, {k: torch.stack([m[k] for m in metrics]).sum()
                       for k in metrics[0]}

    return round_fn


class DecentralizedSimulation:
    """Single-process gossip driver (reference decentralized demo and
    ``standalone/decentralized`` DSGD)."""

    def __init__(
        self,
        bundle: ModelBundle,
        dataset: FedDataset,
        mixing_matrix: np.ndarray,
        *,
        epochs: int = 1,
        batch_size: int = 20,
        lr: float = 0.1,
        momentum: float = 0.0,
        loss_fn: LossFn = masked_softmax_ce,
        seed: int = 0,
        compute_dtype: Optional[torch.dtype] = None,
        device: DeviceLike = None,
    ):
        self.device = driver_device(device, bundle)
        self.bundle = bundle
        self.dataset = dataset
        self.w = np.asarray(mixing_matrix)
        self.num_clients = self.w.shape[0]
        if dataset.num_clients != self.num_clients:
            raise ValueError(f"a {self.num_clients}-node mixing matrix for "
                             f"{dataset.num_clients} clients")
        opt = make_client_optimizer("sgd", lr, momentum=momentum)
        self.local_update = make_local_update(bundle, opt, epochs, loss_fn,
                                              compute_dtype=compute_dtype)
        self.round_fn = make_gossip_round_fn(self.local_update, self.w,
                                             device=self.device)
        self.evaluator = make_evaluator(bundle, loss_fn)
        key = rnglib.PRNGKey(seed)
        init = bundle.init(key)
        # every worker starts from the same init (reference behaviour)
        self.stacked_vars = treelib.tree_stack([init] * self.num_clients)
        self.key = key
        self.seed = seed
        self.batch_size = batch_size
        self.steps_per_epoch = cohort_steps_per_epoch(dataset, batch_size)
        self._test_pack = to_device(
            batch_eval_pack(dataset.test_x, dataset.test_y, 64), self.device)
        self.round_idx = 0
        self.history = []
        self._pack_cache = None

    def _device_pack(self):
        """The full cohort's block (every worker trains every round), packed
        once with a round-independent seed: each round's randomness is the
        local update's per-epoch permutation under ``fold_in(key, round)``."""
        if self._pack_cache is None:
            args, _ = device_resident_pack(
                self.dataset, np.arange(self.num_clients), self.batch_size,
                steps_per_epoch=self.steps_per_epoch, seed=self.seed,
                device=self.device)
            self._pack_cache = args[:3]  # gossip weights are uniform
        return self._pack_cache

    def run_round(self) -> dict:
        px, py, pm = self._device_pack()
        self.stacked_vars, metrics = self.round_fn(
            self.stacked_vars, px, py, pm, rnglib.fold_in(self.key, self.round_idx),
            np.arange(self.num_clients))
        out = {k: float(v) for k, v in metrics.items()}
        out["round"] = self.round_idx
        if out.get("count", 0) > 0:
            out["train_acc"] = out["correct"] / out["count"]
            out["train_loss"] = out["loss_sum"] / out["count"]
        self.round_idx += 1
        self.history.append(out)
        return out

    def evaluate_worker(self, worker: int) -> dict:
        variables = treelib.tree_index(self.stacked_vars, worker)
        res = eval_summary(self.evaluator(variables, *self._test_pack))
        return {"test_acc": res["test_acc"], "test_loss": res["test_loss"]}

    def consensus_distance(self) -> float:
        """Mean squared distance of the workers' variables from their
        average: the convergence diagnostic of gossip."""
        d = [torch.square(leaf - leaf.mean(dim=0, keepdim=True)).sum()
             for leaf in treelib.tree_leaves(self.stacked_vars)]
        return float(torch.stack(d).sum()) / self.num_clients

    def run(self, rounds: int, log_fn=None) -> list:
        for _ in range(rounds):
            m = self.run_round()
            if log_fn:
                log_fn(m)
        return self.history
