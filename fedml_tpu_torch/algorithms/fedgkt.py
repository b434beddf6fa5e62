"""FedGKT — group knowledge transfer (port of
``fedml_tpu/algorithms/fedgkt.py``).

Reference: each edge client trains a small CNN locally with CE + α·KL
against the server's last logits (``GKTClientTrainer.py:66-90``), then
records per-batch feature maps, logits and labels and ships them to the
server (``GKTClientTrainer.py:92-120``); the server trains a large CNN on
the stored features with CE + α·KL distillation from the client logits
(``GKTServerTrainer.py:233-290``) and returns per-client server logits.
Activations, not weights, are the payload.

The two phases are loops over fixed-shape packs on the device, with the
JAX package's semantics, quirks included:

- client i's model is initialised from ``fold_in(key, i)`` (stacked),
  the server's from ``fold_in(key, 10**6)``; the client and server
  optimizers (SGD, momentum, coupled weight decay, global-norm clip)
  persist across rounds;
- a batch that is all padding keeps the old params, but its optimizer
  state and its ``batch_stats`` still advance;
- the reported metrics are the last epoch's sums; KD is off in round 0;
- the server trains over the ``(client, step)`` batches flattened, in
  client-major order, then distills back per-client logits in eval mode.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from fedml_tpu_torch.core import rng as rnglib
from fedml_tpu_torch.core import tree as treelib
from fedml_tpu_torch.core.client import Optimizer, make_client_optimizer
from fedml_tpu_torch.core.losses import masked_kd_kl, masked_softmax_ce
from fedml_tpu_torch.core.types import (FedDataset, batch_eval_pack,
                                        cohort_steps_per_epoch, pack_clients, to_device)
from fedml_tpu_torch.models.base import ModelBundle
from fedml_tpu_torch.utils.device import DeviceLike, driver_device


@dataclasses.dataclass
class FedGKTConfig:
    num_clients: int = 4
    comm_rounds: int = 5
    epochs_client: int = 1
    epochs_server: int = 1
    batch_size: int = 8
    lr_client: float = 0.01
    lr_server: float = 0.01
    momentum: float = 0.9
    weight_decay: float = 5e-4
    temperature: float = 3.0   # reference --temperature default
    alpha: float = 1.0         # KD loss weight, reference --alpha
    whether_distill_on_client: bool = True
    grad_clip: Optional[float] = 5.0
    seed: int = 0


def _train_step(opt: Optimizer, variables, opt_state, loss_fn, bm: torch.Tensor):
    """One optimizer step of ``loss_fn(variables, params) -> (loss,
    new_vars, aux)``.  A batch with no real sample keeps the old params,
    while the optimizer state and the other collections advance, as in
    the JAX package's blend ``has_real·new + (1 − has_real)·old``."""
    params = variables["params"]
    names = list(params)
    leaves = {k: params[k].detach().requires_grad_(True) for k in names}
    with torch.enable_grad():
        loss, new_vars, aux = loss_fn(variables, leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
    with torch.no_grad():
        updates, opt_state = opt.update(dict(zip(names, grads)), opt_state, params)
        has_real = bm.sum() > 0
        new_params = {k: torch.where(has_real, params[k] + updates[k], params[k])
                      for k in names}
        others = treelib.tree_detach(
            {k: v for k, v in new_vars.items() if k != "params"})
    return {**others, "params": new_params}, opt_state, {k: v.detach() for k, v in aux.items()}


def _sum_metrics(auxs) -> dict:
    return {k: torch.stack([a[k] for a in auxs]).sum() for k in auxs[0]}


class FedGKT:
    """Two-net GKT driver: small client nets (one per client, stacked) +
    one large server net; the exchange is (features, logits, labels)."""

    def __init__(self, client_bundle: ModelBundle, server_bundle: ModelBundle,
                 dataset: FedDataset, config: FedGKTConfig, *, device: DeviceLike = None):
        self.device = driver_device(device, client_bundle, server_bundle)
        self.cb = client_bundle
        self.sb = server_bundle
        self.ds = dataset
        self.cfg = config

        key = rnglib.PRNGKey(config.seed)
        # K independent client models (GKT never averages them)
        self.client_vars = treelib.tree_stack(
            [client_bundle.init(rnglib.fold_in(key, i)) for i in range(config.num_clients)])
        self.server_vars = server_bundle.init(rnglib.fold_in(key, 10 ** 6))
        opt_kw = dict(momentum=config.momentum, weight_decay=config.weight_decay,
                      grad_clip=config.grad_clip)
        self.server_opt = make_client_optimizer("sgd", config.lr_server, **opt_kw)
        self.server_opt_state = self.server_opt.init(self.server_vars["params"])
        # the client optimizers persist across rounds (the reference builds
        # them once in GKTClientTrainer.__init__), one state per client
        self.client_opt = make_client_optimizer("sgd", config.lr_client, **opt_kw)
        self.client_opt_states = [
            self.client_opt.init(treelib.tree_index(self.client_vars["params"], i))
            for i in range(config.num_clients)]
        self.key = key

        # fixed pack geometry: every client padded to the largest shard
        self.steps = cohort_steps_per_epoch(dataset, config.batch_size)
        pack = pack_clients(dataset, list(range(config.num_clients)), config.batch_size,
                            steps_per_epoch=self.steps, seed=config.seed)
        self.x, self.y, self.mask = to_device((pack.x, pack.y, pack.mask), self.device)
        self.num_classes = dataset.num_classes
        # round 0 trains the clients without KD, so its zero logits are unused
        self.server_logits = torch.zeros(
            (config.num_clients, self.steps, config.batch_size, self.num_classes),
            dtype=torch.float32, device=self.device)
        self._test_pack = to_device(
            batch_eval_pack(dataset.test_x, dataset.test_y, max(config.batch_size, 64)),
            self.device)
        self.round_idx = 0
        self.history = []

    # ---- client phase -------------------------------------------------
    def _one_client(self, variables, opt_state, x, y, mask, s_logits, use_kd: float):
        cfg = self.cfg

        def loss_fn(bx, by, bm, bl):
            def fn(variables, params):
                (logits, _), new_vars = self.cb.apply_train({**variables, "params": params}, bx)
                ce, aux = masked_softmax_ce(logits, by, bm)
                kd = masked_kd_kl(logits, bl, bm, cfg.temperature)
                return ce + cfg.alpha * kd * use_kd, new_vars, aux
            return fn

        for _ in range(cfg.epochs_client):
            auxs = []
            for s in range(x.shape[0]):
                variables, opt_state, aux = _train_step(
                    self.client_opt, variables, opt_state,
                    loss_fn(x[s], y[s], mask[s], s_logits[s]), mask[s])
                auxs.append(aux)
        # extraction pass: per-batch features + logits in eval mode
        # (reference GKTClientTrainer.py:92-120 uses model.eval())
        with torch.no_grad():
            outs = [self.cb.apply_eval(variables, x[s]) for s in range(x.shape[0])]
        logits = torch.stack([o[0] for o in outs])
        feats = torch.stack([o[1] for o in outs])
        return variables, opt_state, feats, logits, _sum_metrics(auxs)

    def _client_phase(self, use_kd: float):
        outs = [self._one_client(treelib.tree_index(self.client_vars, i),
                                 self.client_opt_states[i], self.x[i], self.y[i],
                                 self.mask[i], self.server_logits[i], use_kd)
                for i in range(self.cfg.num_clients)]
        self.client_vars = treelib.tree_stack([o[0] for o in outs])
        self.client_opt_states = [o[1] for o in outs]
        feats = torch.stack([o[2] for o in outs])
        c_logits = torch.stack([o[3] for o in outs])
        metrics = {k: torch.stack([o[4][k] for o in outs]) for k in outs[0][4]}
        return feats, c_logits, metrics

    # ---- server phase -------------------------------------------------
    def _server_phase(self, feats, c_logits):
        cfg = self.cfg
        # flatten (client, step) into one sequence of batches
        K, S = self.y.shape[0], self.y.shape[1]
        ff = feats.reshape(K * S, *feats.shape[2:])
        yy = self.y.reshape(K * S, *self.y.shape[2:])
        mm = self.mask.reshape(K * S, *self.mask.shape[2:])
        ll = c_logits.reshape(K * S, *c_logits.shape[2:])

        def loss_fn(bf, by, bm, bl):
            def fn(variables, params):
                logits, new_vars = self.sb.apply_train({**variables, "params": params}, bf)
                ce, aux = masked_softmax_ce(logits, by, bm)
                kd = masked_kd_kl(logits, bl, bm, cfg.temperature)
                return ce + cfg.alpha * kd, new_vars, aux
            return fn

        variables, opt_state = self.server_vars, self.server_opt_state
        for _ in range(cfg.epochs_server):
            auxs = []
            for s in range(K * S):
                variables, opt_state, aux = _train_step(
                    self.server_opt, variables, opt_state,
                    loss_fn(ff[s], yy[s], mm[s], ll[s]), mm[s])
                auxs.append(aux)
        self.server_vars, self.server_opt_state = variables, opt_state
        # distill back: per-client server logits on the stored features
        with torch.no_grad():
            s_logits = torch.stack([self.sb.apply_eval(variables, ff[s])
                                    for s in range(K * S)])
        return s_logits.reshape(K, S, *s_logits.shape[1:]), _sum_metrics(auxs)

    # ---- end-to-end eval ----------------------------------------------
    @torch.no_grad()
    def evaluate_global(self) -> dict:
        """The server model on features from client 0's extractor (the
        reference's GKTServerTrainer eval path)."""
        cv0 = treelib.tree_index(self.client_vars, 0)
        tx, ty, tm = self._test_pack
        auxs = []
        for s in range(tx.shape[0]):
            _, feats = self.cb.apply_eval(cv0, tx[s])
            _, aux = masked_softmax_ce(self.sb.apply_eval(self.server_vars, feats),
                                       ty[s], tm[s])
            auxs.append(aux)
        res = _sum_metrics(auxs)
        count = max(float(res["count"]), 1.0)
        return {"test_acc": float(res["correct"]) / count,
                "test_loss": float(res["loss_sum"]) / count}

    # ---- driver --------------------------------------------------------
    def run_round(self) -> dict:
        cfg = self.cfg
        use_kd = 1.0 if (self.round_idx > 0 and cfg.whether_distill_on_client) else 0.0
        feats, c_logits, cm = self._client_phase(use_kd)
        self.server_logits, sm = self._server_phase(feats, c_logits)
        out = {
            "round": self.round_idx,
            "client_loss_sum": float(cm["loss_sum"].sum()),
            "server_loss_sum": float(sm["loss_sum"]),
            "server_train_acc": float(sm["correct"]) / max(float(sm["count"]), 1.0),
        }
        self.round_idx += 1
        return out

    def run(self, rounds: Optional[int] = None) -> list:
        for _ in range(rounds if rounds is not None else self.cfg.comm_rounds):
            self.history.append(self.run_round())
        self.history[-1].update(self.evaluate_global())
        return self.history
