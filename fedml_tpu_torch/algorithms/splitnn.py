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
for bit.  The message-mode managers (``SplitNNServerManager``,
``SplitNNClientManager``) run the same three pieces across a
``CommBackend``: activations up, their gradient down, the ring token
between clients.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from fedml_tpu_torch.comm.backend import CommBackend, NodeManager
from fedml_tpu_torch.comm.message import (
    MSG_TYPE_C2C_SEMAPHORE,
    MSG_TYPE_C2S_SEND_ACTS,
    MSG_TYPE_S2C_FINISH,
    MSG_TYPE_S2C_SEND_GRADS,
    Message,
    tree_from_wire,
    tree_to_wire,
)
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


# --- message-mode managers (two-process deployments over CommBackend) -------

SERVER = 0


class SplitNNServerManager(NodeManager):
    """Holds the top half; answers every C2S_SEND_ACTS with S2C_SEND_GRADS
    (reference ``server_manager.py:31-36``).  The top is drawn from
    ``PRNGKey(seed)`` on ``device``."""

    def __init__(self, backend: CommBackend, top: ModelBundle, *,
                 acts_template, lr: float = 0.1, seed: int = 0,
                 device: DeviceLike = None):
        self.device = driver_device(device, top)
        self.opt = split_optimizer(lr)
        _, _, self._top_step, _, _ = make_split_steps(_DUMMY_BOTTOM, top, self.opt)
        self.state = init_half(top, rnglib.PRNGKey(seed), self.opt)
        self.acts_template = torch.as_tensor(np.asarray(acts_template),
                                             device=self.device)
        self.batches_seen = 0
        super().__init__(backend)

    def register_message_receive_handlers(self):
        self.register_message_receive_handler(MSG_TYPE_C2S_SEND_ACTS, self._on_acts)
        self.register_message_receive_handler(MSG_TYPE_S2C_FINISH, self._on_finish)

    def _on_finish(self, msg: Message):
        self.finish()

    def _on_acts(self, msg: Message):
        acts = tree_from_wire(msg.get("acts"), self.acts_template)
        y = torch.from_numpy(np.asarray(msg.get("labels"), dtype=np.int32)).to(self.device)
        self.state, gacts, metrics = self._top_step(self.state, acts, y)
        self.batches_seen += 1
        reply = Message(MSG_TYPE_S2C_SEND_GRADS, SERVER, msg.sender)
        reply.add_params("grads", tree_to_wire(gacts))
        reply.add_params("loss", float(metrics["loss"]))
        self.send_message(reply)


class SplitNNClientManager(NodeManager):
    """Holds a bottom half + its private data; drives its epoch batch by
    batch, then passes the semaphore to the next ring node (reference
    ``client_manager.py:29-74``).  The bottom is drawn from
    ``PRNGKey(seed + node_id)``; batches go in data order."""

    def __init__(self, backend: CommBackend, bottom: ModelBundle, x, y, *,
                 node_id: int, next_node: int, batch_size: int = 64,
                 lr: float = 0.1, active: bool = False, seed: int = 0,
                 total_hops: int = 1, device: DeviceLike = None):
        self.device = driver_device(device, bottom)
        self.opt = split_optimizer(lr)
        _, self._fwd, _, self._bwd, _ = make_split_steps(bottom, _DUMMY_TOP, self.opt)
        self.state = init_half(bottom, rnglib.PRNGKey(seed + node_id), self.opt)
        self.x, self.y = x, y
        self.batch_size = batch_size
        self.next_node = next_node
        self.active_at_start = active
        self.batch_idx = 0
        # ring budget: each epoch a client runs consumes one hop; the
        # token retires when its countdown reaches zero (replaces the
        # reference's MAX_EPOCH_PER_NODE bookkeeping, client.py:16)
        self.hops_left = total_hops
        self._acts_template = None
        self._cur_x = None
        super().__init__(backend)

    def register_message_receive_handlers(self):
        self.register_message_receive_handler(MSG_TYPE_S2C_SEND_GRADS, self._on_grads)
        self.register_message_receive_handler(MSG_TYPE_C2C_SEMAPHORE, self._on_token)

    def start_if_active(self):
        if self.active_at_start:
            self._send_next_batch()

    def _on_token(self, msg: Message):
        self.hops_left = msg.get("hops_left")
        if self.hops_left <= 0:
            # retire flood: finish, and keep it circling until it reaches
            # the node that originated it, so every ring member and the
            # server get a shutdown, not just the first retiree
            origin = msg.get("origin")
            if self.next_node != origin:
                self._forward_retire(origin)
            self.finish()
            return
        self.batch_idx = 0
        self._send_next_batch()

    def _forward_retire(self, origin: int):
        token = Message(MSG_TYPE_C2C_SEMAPHORE, self.backend.node_id, self.next_node)
        token.add_params("hops_left", 0)
        token.add_params("origin", origin)
        self.send_message(token)

    def _send_next_batch(self):
        lo = self.batch_idx * self.batch_size
        if lo + self.batch_size > len(self.x):
            hops = self.hops_left - 1
            if hops <= 0:
                # token budget spent: tell the server, start the retire
                # flood around the ring, then finish ourselves
                self.send_message(
                    Message(MSG_TYPE_S2C_FINISH, self.backend.node_id, SERVER))
                if self.next_node != self.backend.node_id:
                    self._forward_retire(self.backend.node_id)
                self.finish()
                return
            # epoch done: pass the ring token (client_manager.py:72-74)
            token = Message(MSG_TYPE_C2C_SEMAPHORE, self.backend.node_id,
                            self.next_node)
            token.add_params("hops_left", hops)
            self.send_message(token)
            return
        sl = slice(lo, lo + self.batch_size)
        self._cur_x = torch.from_numpy(np.asarray(self.x[sl])).to(self.device)
        acts = self._fwd(self.state, self._cur_x)
        self._acts_template = acts
        m = Message(MSG_TYPE_C2S_SEND_ACTS, self.backend.node_id, SERVER)
        m.add_params("acts", tree_to_wire(acts))
        m.add_params("labels", np.asarray(self.y[sl]).tolist())
        self.send_message(m)

    def _on_grads(self, msg: Message):
        gacts = tree_from_wire(msg.get("grads"), self._acts_template)
        self.state = self._bwd(self.state, self._cur_x, gacts)
        self.batch_idx += 1
        self._send_next_batch()


class _Identity:
    """Placeholder half for managers that only own one side."""

    @staticmethod
    def apply_train(variables, x, rng=None):
        return x, variables

    @staticmethod
    def apply_eval(variables, x):
        return x


_DUMMY_BOTTOM = _Identity()
_DUMMY_TOP = _Identity()
