"""SplitNN — ring-relay split learning (port of
``fedml_tpu/algorithms/splitnn.py``).

Reference: the client holds the bottom half of the network, the server
the top.  Per mini-batch the client sends activations
(``split_nn/client.py:24-30``), the server forwards them, computes the CE
loss, backpropagates and returns ``acts.grad`` (``server.py:40-59``); the
client finishes the backward pass (``client.py:32-34``).  One client is
active at a time and control passes around the ring; the server validates
after each client's epoch (``server.py:61-75``).  Both halves use
SGD(lr 0.1, momentum 0.9, wd 5e-4) (``client.py:18-19``).

The split is torch's own: the bottom's activations are detached and made
a leaf that requires grad, the top's CE loss is backpropagated, the
leaf's ``.grad`` is the cotangent the reference ships, and
``acts.backward(gacts)`` runs it through the bottom.  ``fused_step`` is
``bottom_forward`` → ``top_step`` → ``bottom_backward`` in one call, bit
for bit.  The message-mode managers (two processes over the comm
backend) are not ported: they wait for the cross-device runtime
(ROADMAP.md, queue A item 5).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from fedml_tpu_torch.core import rng as rnglib
from fedml_tpu_torch.core.client import Optimizer, make_client_optimizer
from fedml_tpu_torch.core.losses import softmax_ce_logits
from fedml_tpu_torch.models.base import ModelBundle
from fedml_tpu_torch.utils.device import DeviceLike, driver_device

Params = dict


def split_optimizer(lr: float = 0.1, momentum: float = 0.9,
                    weight_decay: float = 5e-4) -> Optimizer:
    """The reference optimizer of both halves (``client.py:18-19``)."""
    return make_client_optimizer("sgd", lr, momentum=momentum, weight_decay=weight_decay)


class HalfState(NamedTuple):
    params: Params
    opt_state: Any


def _apply(bundle: ModelBundle, params: Params, x: torch.Tensor, train: bool):
    variables = {"params": params}
    return bundle.apply_train(variables, x)[0] if train else bundle.apply_eval(variables, x)


def _leaves(params: Params) -> Params:
    return {k: v.detach().requires_grad_(True) for k, v in params.items()}


@torch.no_grad()
def _step(opt: Optimizer, state: HalfState, leaves: Params) -> HalfState:
    """One optimizer step from the gradients autograd left on ``leaves``."""
    grads = {k: v.grad for k, v in leaves.items()}
    updates, opt_state = opt.update(grads, state.opt_state, state.params)
    return HalfState({k: p + updates[k] for k, p in state.params.items()}, opt_state)


def _metrics(loss, logits, y) -> dict:
    return {"loss": loss.detach(), "correct": (logits.argmax(-1) == y).sum(),
            "count": torch.tensor(float(y.shape[0]), device=y.device)}


def make_split_steps(bottom: ModelBundle, top: ModelBundle,
                     opt: Optional[Optimizer] = None):
    """(fused_step, bottom_forward, top_step, bottom_backward, evaluate).

    ``top_step`` returns the activation gradient that, handed to
    ``bottom_backward``, reproduces ``fused_step`` exactly."""
    opt = opt or split_optimizer()

    def bottom_forward(bstate: HalfState, x):
        with torch.no_grad():
            return _apply(bottom, bstate.params, x, True)

    def top_step(tstate: HalfState, acts, y):
        """Server side: forward the top, CE loss, step, return the
        activations' gradient."""
        acts = acts.detach().requires_grad_(True)
        leaves = _leaves(tstate.params)
        with torch.enable_grad():
            logits = _apply(top, leaves, acts, True)
            loss = softmax_ce_logits(logits, y).mean()
            loss.backward()
        return _step(opt, tstate, leaves), acts.grad, _metrics(loss, logits, y)

    def _bottom_graph(bstate: HalfState, x):
        leaves = _leaves(bstate.params)
        with torch.enable_grad():
            return leaves, _apply(bottom, leaves, x, True)

    def bottom_backward(bstate: HalfState, x, gacts):
        """Client side: backpropagate the server's activation gradient
        through the bottom (its forward recomputed) and step."""
        leaves, acts = _bottom_graph(bstate, x)
        acts.backward(gacts)
        return _step(opt, bstate, leaves)

    def fused_step(bstate: HalfState, tstate: HalfState, x, y):
        leaves, acts = _bottom_graph(bstate, x)
        new_t, gacts, metrics = top_step(tstate, acts, y)
        acts.backward(gacts)
        return _step(opt, bstate, leaves), new_t, metrics

    @torch.no_grad()
    def evaluate(bstate: HalfState, tstate: HalfState, x, y):
        logits = _apply(top, tstate.params, _apply(bottom, bstate.params, x, False), False)
        return _metrics(softmax_ce_logits(logits, y).mean(), logits, y)

    return fused_step, bottom_forward, top_step, bottom_backward, evaluate


def init_half(bundle: ModelBundle, key, opt: Optional[Optimizer] = None) -> HalfState:
    opt = opt or split_optimizer()
    params = bundle.init(key)["params"]
    return HalfState(params, opt.init(params))


def _weighted_sums(rows: List[dict]) -> dict:
    """The JAX driver's per-batch host sums: ``Σ loss·count``, ``Σ correct``
    and ``Σ count`` in float64, over one read-back of every row."""
    if not rows:
        return {"loss": 0.0, "correct": 0.0, "count": 0.0}
    vals = torch.stack([torch.stack([r["loss"].float(), r["correct"].float(),
                                     r["count"].float()]) for r in rows]).cpu().tolist()
    out = {"loss": 0.0, "correct": 0.0, "count": 0.0}
    for loss, correct, count in vals:
        out["loss"] += loss * count
        out["correct"] += correct
        out["count"] += count
    return out


@dataclasses.dataclass
class SplitNNSimulation:
    """Single-process ring driver: each client owns a private bottom, the
    server the shared top; ring order is the client id, and the server
    validates after each client's epoch (``server.py:61-75``).  Client
    ``i``'s bottom is drawn from ``fold_in(PRNGKey(seed), i + 1)``, the top
    from ``PRNGKey(seed)``; every client's data lives on the device."""

    bottom: ModelBundle
    top: ModelBundle
    client_data: Sequence[Tuple[np.ndarray, np.ndarray]]  # per-client (x, y)
    test_data: Tuple[np.ndarray, np.ndarray]
    batch_size: int = 64
    lr: float = 0.1
    seed: int = 0
    device: DeviceLike = None

    def __post_init__(self):
        self.device = driver_device(self.device, self.bottom, self.top)
        self.opt = split_optimizer(self.lr)
        self._step, _, _, _, self._eval = make_split_steps(self.bottom, self.top, self.opt)
        key = rnglib.PRNGKey(self.seed)
        self.client_states: List[HalfState] = [
            init_half(self.bottom, rnglib.fold_in(key, i + 1), self.opt)
            for i in range(len(self.client_data))]
        self.server_state = init_half(self.top, key, self.opt)
        to = lambda a: torch.from_numpy(np.asarray(a)).to(self.device)  # noqa: E731
        self._data = [(to(x), to(y)) for x, y in self.client_data]
        self._test = (to(self.test_data[0]), to(self.test_data[1]))
        self.history: List[dict] = []
        self.epoch = 0

    def run_epoch(self) -> List[dict]:
        """One ring pass: every client trains one local epoch in turn (a
        partial last batch is dropped)."""
        out = []
        for cid, (x, y) in enumerate(self._data):
            rng = np.random.RandomState(self.seed * 7919 + self.epoch * 131 + cid)
            order = torch.from_numpy(rng.permutation(len(x))).to(self.device)
            bstate, rows = self.client_states[cid], []
            for lo in range(0, len(x) - self.batch_size + 1, self.batch_size):
                sl = order[lo:lo + self.batch_size]
                bstate, self.server_state, m = self._step(bstate, self.server_state,
                                                          x[sl], y[sl])
                rows.append(m)
            self.client_states[cid] = bstate
            tot = _weighted_sums(rows)
            val = self.validate(cid)
            rec = {"epoch": self.epoch, "client": cid,
                   "train_acc": tot["correct"] / max(tot["count"], 1),
                   "train_loss": tot["loss"] / max(tot["count"], 1),
                   **{f"val_{k}": v for k, v in val.items()}}
            out.append(rec)
            self.history.append(rec)
        self.epoch += 1
        return out

    def validate(self, cid: int) -> dict:
        """Client ``cid``'s bottom with the server's top on the test set,
        in batches of 256."""
        x, y = self._test
        m = _weighted_sums([self._eval(self.client_states[cid], self.server_state,
                                       x[lo:lo + 256], y[lo:lo + 256])
                            for lo in range(0, len(x), 256)])
        return {"acc": m["correct"] / m["count"], "loss": m["loss"] / m["count"]}
