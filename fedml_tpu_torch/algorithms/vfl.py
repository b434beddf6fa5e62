"""Classical vertical FL, feature-split (port of ``fedml_tpu/algorithms/vfl.py``).

Reference: ``classical_vertical_fl/guest_trainer.py:74-110`` — hosts
forward their private feature slices and send logit components; the guest
adds its own, computes ``BCEWithLogitsLoss`` on the sum and returns the
common gradient dL/dU to every host (``party_models.py:56-75``); each party
backpropagates its own branch with it (SGD momentum 0.9, weight decay
0.01, ``vfl_models_standalone.py:13,46``).

In torch: one autograd graph per party.  The guest's sum ``U`` of the
detached components is a leaf; the BCE loss backpropagated to it leaves
``dU`` (the one tensor the reference sends down) in ``U.grad``, and each
party's ``out.backward(dU)`` runs it through that party's branch alone.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fedml_tpu_torch.core import optrepo
from fedml_tpu_torch.core import rng as rnglib
from fedml_tpu_torch.models.base import ModelBundle
from fedml_tpu_torch.utils.device import DeviceLike, driver_device


class PartyState(NamedTuple):
    params: dict
    opt_state: Any


def bce_with_logits(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy on logits (torch BCEWithLogitsLoss), as
    optax's ``sigmoid_binary_cross_entropy`` computes it."""
    y = y.reshape(logits.shape).to(logits.dtype)
    return (-y * F.logsigmoid(logits) - (1.0 - y) * F.logsigmoid(-logits)).mean()


def _party_optimizer(lr: float, momentum: float = 0.9, weight_decay: float = 0.01):
    """The reference party optimizer, SGD(momentum 0.9, wd 0.01)
    (``vfl_models_standalone.py:13``): optax's decayed weights, then sgd."""
    return optrepo.chain(optrepo.add_decayed_weights(weight_decay),
                         optrepo.sgd(lr, momentum=momentum))


@dataclasses.dataclass
class VerticalFederation:
    """The guest (party 0, holds the labels) and the hosts, each with a
    private feature slice (``bundles[i]`` consumes slice ``i``)."""

    bundles: Sequence[ModelBundle]
    lr: float = 0.05
    momentum: float = 0.9
    weight_decay: float = 0.01
    device: DeviceLike = None

    def __post_init__(self):
        self.device = driver_device(self.device, *self.bundles)
        self._opt = _party_optimizer(self.lr, self.momentum, self.weight_decay)

    def init(self, key) -> Tuple[PartyState, ...]:
        """Party ``i``'s branch from ``fold_in(key, i)``."""
        states = []
        for i, b in enumerate(self.bundles):
            params = b.init(rnglib.fold_in(key, i))["params"]
            states.append(PartyState(params, self._opt.init(params)))
        return tuple(states)

    def common_gradient(self, states, xs, y):
        """Every party's forward (one graph each), the guest's loss on
        their sum and its gradient ``dU``: (loss, dU, party graphs)."""
        graphs = []
        with torch.enable_grad():
            for b, st, x in zip(self.bundles, states, xs):
                leaves = {k: v.detach().requires_grad_(True) for k, v in st.params.items()}
                graphs.append((leaves, b.apply_train({"params": leaves}, x)[0]))
            U = sum(out.detach() for _, out in graphs).requires_grad_(True)
            loss = bce_with_logits(U, y)
            loss.backward()
        return loss.detach(), U.grad, graphs

    def fit(self, states, xs, y):
        """One global step on one batch; returns (new_states, loss)."""
        loss, dU, graphs = self.common_gradient(states, xs, y)
        new_states = []
        for st, (leaves, out) in zip(states, graphs):
            out.backward(dU)
            with torch.no_grad():
                grads = {k: v.grad for k, v in leaves.items()}
                updates, opt_state = self._opt.update(grads, st.opt_state, st.params)
                new_states.append(PartyState(optrepo.apply_updates(st.params, updates),
                                             opt_state))
        return tuple(new_states), loss

    @torch.no_grad()
    def predict(self, states, xs) -> torch.Tensor:
        """The reference's ``sigmoid(sum U)`` (``party_models.py:42-47``)."""
        U = sum(b.apply_eval({"params": st.params}, x)
                for b, st, x in zip(self.bundles, states, xs))
        return torch.sigmoid(U.sum(dim=1))

    def evaluate(self, states, xs, y) -> dict:
        prob = self.predict(states, xs).cpu().numpy()
        y = np.asarray(y).reshape(-1)
        pred = (prob > 0.5).astype(np.int32)
        return {"accuracy": float((pred == y).mean()), "auc": float(binary_auc(y, prob))}


def binary_auc(y_true: np.ndarray, score: np.ndarray) -> float:
    """Rank-based ROC-AUC with ties averaged (the JAX package's, which
    replaces the reference's sklearn ``roc_auc_score``)."""
    y_true = np.asarray(y_true).reshape(-1)
    score = np.asarray(score).reshape(-1)
    pos, neg = (y_true == 1).sum(), (y_true == 0).sum()
    if pos == 0 or neg == 0:
        return float("nan")
    order = np.argsort(score, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(score) + 1)
    # tie-average in O(n log n): mean rank per unique score via bincount
    _, inv = np.unique(score, return_inverse=True)
    sums = np.bincount(inv, weights=ranks)
    counts = np.bincount(inv)
    ranks = (sums / counts)[inv]
    return float((ranks[y_true == 1].sum() - pos * (pos + 1) / 2) / (pos * neg))


def run_vfl(
    federation: VerticalFederation,
    xs_train: Sequence[np.ndarray],
    y_train: np.ndarray,
    xs_test: Sequence[np.ndarray],
    y_test: np.ndarray,
    *,
    rng=None,
    epochs: int = 1,
    batch_size: int = 256,
    eval_every: int = 1,
) -> Tuple[Tuple[PartyState, ...], List[dict]]:
    """The batch-loop driver (``vfl_fixture.py:27+``): in-order batches, the
    last one partial; the tables live on the device.  ``rng`` is the
    threefry key of the parties' init (``PRNGKey(0)`` by default)."""
    rng = rng if rng is not None else rnglib.PRNGKey(0)
    dev = federation.device
    to = lambda a: torch.from_numpy(np.asarray(a)).to(dev)  # noqa: E731
    xs_train, y_dev = [to(x) for x in xs_train], to(y_train)
    xs_test = [to(x) for x in xs_test]
    states = federation.init(rng)
    n = len(y_train)
    history = []
    step = 0
    for epoch in range(epochs):
        for lo in range(0, n, batch_size):
            hi = min(lo + batch_size, n)
            states, _ = federation.fit(states, [x[lo:hi] for x in xs_train], y_dev[lo:hi])
            step += 1
        if (epoch + 1) % eval_every == 0:
            m = federation.evaluate(states, xs_test, y_test)
            m.update(epoch=epoch, step=step)
            history.append(m)
    return states, history
