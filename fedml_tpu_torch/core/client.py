"""The client-side local training operator (port of ``fedml_tpu/core/client.py``).

One client's local update is a Python loop over epochs × fixed-shape
batches on the device.  Semantics follow the JAX package exactly:

- the client optimizer is built fresh every round (state from ``init``);
- the JAX package's threefry streams (``core/rng.py``), bit for bit:
  epoch key ``ek = fold_in(key, epoch)``, the epoch's reshuffle
  ``permutation(fold_in(ek, 0), n)``, the epoch's augmentation key
  ``fold_in(ek, n + 1)`` (one ``augment_fn`` call over the whole shuffled
  epoch tensor) and step ``i``'s model key ``fold_in(ek, i + 1)``;
- batches that are entirely padding leave the *params* unchanged, while
  the optimizer state (momentum picks up the ``wd·p`` term) and the
  BatchNorm statistics still advance, as in the JAX scan;
- mixed precision (``compute_dtype``): params AND batch_stats are cast to
  the compute dtype for the forward/backward, gradients reach the fp32
  masters through the cast, new statistics are cast back to fp32.

The optimizers are functional over dicts of tensors (``init(params)``,
``update(grads, state, params) -> (updates, state)``), mirroring the
optax chains: SGD (+momentum, coupled weight decay) and
``torch.optim.Adam(amsgrad=True)`` semantics, with optional global-norm
clipping first.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from fedml_tpu_torch.core import rng as rnglib
from fedml_tpu_torch.core import tree as treelib
from fedml_tpu_torch.core.losses import LossFn, masked_softmax_ce
from fedml_tpu_torch.models.base import ModelBundle

Params = Dict[str, torch.Tensor]
Transform = Tuple[Callable, Callable]  # (init(params), update(g, state, params))


def _clip_by_global_norm(max_norm: float) -> Transform:
    def update(g, state, params):
        norm = torch.sqrt(treelib.global_sq_norm(g))
        keep = norm < max_norm
        return {k: torch.where(keep, v, v / norm.to(v.dtype) * max_norm)
                for k, v in g.items()}, state
    return (lambda params: (), update)


def _add_decayed_weights(wd: float) -> Transform:
    def update(g, state, params):
        return {k: g[k] + wd * params[k] for k in g}, state
    return (lambda params: (), update)


def _trace(decay: float) -> Transform:
    """optax.trace: t ← g + decay·t (heavy-ball momentum, no dampening)."""
    def update(g, state, params):
        t = {k: g[k] + decay * state[k] for k in g}
        return t, t
    return (lambda params: treelib.tree_map(torch.zeros_like, params), update)


def _scale(step: float) -> Transform:
    return (lambda params: (),
            lambda g, state, params: ({k: v * step for k, v in g.items()}, state))


def _scale_by_learning_rate(lr) -> Transform:
    """optax.scale_by_learning_rate: ``-lr``, or for a schedule (count ->
    lr) ``-lr(count)`` with the count of updates so far (from 0)."""
    if not callable(lr):
        return _scale(-lr)

    def update(g, count, params):
        step = -lr(count)
        return {k: v * step for k, v in g.items()}, count + 1
    return (lambda params: 0, update)


def _scale_by_amsgrad_torch(b1: float = 0.9, b2: float = 0.999,
                            eps: float = 1e-8) -> Transform:
    """torch.optim.Adam(amsgrad=True): the running max is over the RAW
    second moment, and bias correction divides the max."""
    def init(params):
        zeros = lambda: treelib.tree_map(torch.zeros_like, params)  # noqa: E731
        return {"count": 0, "mu": zeros(), "nu": zeros(), "nu_max": zeros()}

    def update(g, state, params):
        t = state["count"] + 1
        mu = {k: b1 * state["mu"][k] + (1 - b1) * g[k] for k in g}
        nu = {k: b2 * state["nu"][k] + (1 - b2) * g[k] * g[k] for k in g}
        nu_max = {k: torch.maximum(state["nu_max"][k], nu[k]) for k in g}
        c1, c2 = 1 - b1 ** t, 1 - b2 ** t
        out = {k: (mu[k] / c1) / (torch.sqrt(nu_max[k] / c2) + eps) for k in g}
        return out, {"count": t, "mu": mu, "nu": nu, "nu_max": nu_max}
    return init, update


@dataclasses.dataclass
class Optimizer:
    """A chain of gradient transforms; ``update`` returns the additive
    parameter updates and the new state."""

    transforms: List[Transform]

    def init(self, params: Params) -> list:
        return [init(params) for init, _ in self.transforms]

    def update(self, grads: Params, state: list, params: Params):
        new_state = []
        for (_, update), s in zip(self.transforms, state):
            grads, s = update(grads, s, params)
            new_state.append(s)
        return grads, new_state


def make_client_optimizer(
    name: str = "sgd",
    lr: float = 0.03,
    *,
    momentum: float = 0.0,
    weight_decay: Optional[float] = None,
    grad_clip: Optional[float] = None,
) -> Optimizer:
    """The reference's client optimizers: SGD (+momentum/wd) or amsgrad
    Adam; ``lr`` is a float or a schedule (count -> lr).
    ``weight_decay=None`` means the optimizer's default (0 for sgd, the
    reference's 1e-4 for adam); both decays are COUPLED L2 (``wd·p``
    added to the gradient before the update)."""
    chain: List[Transform] = []
    if grad_clip is not None:
        chain.append(_clip_by_global_norm(grad_clip))
    if name == "sgd":
        if weight_decay:
            chain.append(_add_decayed_weights(weight_decay))
        if momentum:
            chain.append(_trace(momentum))
        chain.append(_scale_by_learning_rate(lr))
    elif name == "adam":
        wd = 1e-4 if weight_decay is None else weight_decay
        if wd:
            chain.append(_add_decayed_weights(wd))
        chain.append(_scale_by_amsgrad_torch())
        chain.append(_scale_by_learning_rate(lr))
    else:
        raise ValueError(f"unknown client optimizer: {name}")
    return Optimizer(chain)


@dataclasses.dataclass
class LocalUpdateFn:
    """Callable local update plus metadata the algorithms need."""

    fn: Callable  # (variables, x, y, mask, key) -> (variables, metrics)
    epochs: int
    # the bundle it trains, and the same update built over another bundle
    # (the parallel engines swap in their sharded model)
    bundle: Optional[ModelBundle] = None
    rebind: Optional[Callable[[ModelBundle], "LocalUpdateFn"]] = None

    def __call__(self, variables, x, y, mask, key):
        return self.fn(variables, x, y, mask, key)


def make_local_update(
    bundle: ModelBundle,
    optimizer: Optimizer,
    epochs: int,
    loss_fn: LossFn = masked_softmax_ce,
    *,
    prox_mu: float = 0.0,
    shuffle: bool = True,
    augment_fn: Optional[Callable] = None,
    compute_dtype: Optional[torch.dtype] = None,
) -> LocalUpdateFn:
    """Build the local-update function for one client.

    Shapes (one client): x [steps, B, ...], y [steps, B], mask [steps, B];
    ``key`` (a threefry key) keys the epoch shuffle, ``augment_fn(key,
    x)`` (``data/augment.py``) and the model's step keys.  Returns
    (new_variables, metrics) where metrics carries summed
    loss/correct/count over the final epoch and ``steps``, the optimizer
    steps taken on batches with a real sample, over all epochs."""

    def loss_and_aux(params, others, global_params, x, y, m, key):
        variables = {**others, "params": params}
        if compute_dtype is not None:
            cvars = treelib.tree_cast_floats(variables, compute_dtype)
            cx = x.to(compute_dtype) if x.is_floating_point() else x
            logits, new_vars = bundle.apply_train(cvars, cx, key)
            new_vars = treelib.tree_cast_like(new_vars, variables)
        else:
            logits, new_vars = bundle.apply_train(variables, x, key)
        loss, aux = loss_fn(logits, y, m)
        if prox_mu:
            sq = treelib.global_sq_norm(treelib.tree_sub(params, global_params))
            loss = loss + 0.5 * prox_mu * sq
        return loss, new_vars, aux

    def local_update(variables, x, y, mask, key):
        steps, bsz = x.shape[0], x.shape[1]
        n = steps * bsz
        global_params = variables["params"]
        params = variables["params"]
        others = {k: v for k, v in variables.items() if k != "params"}
        opt_state = optimizer.init(params)
        names = list(params)
        real_steps = torch.zeros((), device=x.device)
        for ep in range(epochs):
            ek = rnglib.fold_in(key, ep)
            if shuffle:
                perm = rnglib.permutation(rnglib.fold_in(ek, 0), n, x.device)
                xs = x.reshape(n, *x.shape[2:])[perm].reshape(x.shape)
                ys = y.reshape(n, *y.shape[2:])[perm].reshape(y.shape)
                ms = mask.reshape(n)[perm].reshape(mask.shape)
            else:
                xs, ys, ms = x, y, mask
            if augment_fn is not None:
                # fresh augmentation of every sample once per epoch (the
                # reference's torchvision semantics), one call per epoch
                flat = augment_fn(rnglib.fold_in(ek, n + 1),
                                  xs.reshape(n, *x.shape[2:]))
                xs = flat.reshape(x.shape)
            # the training metrics; a multi-label loss's precision/recall
            # sums are evaluation metrics, as in the JAX local update
            sums = {"loss_sum": 0.0, "correct": 0.0, "count": 0.0}
            for i in range(steps):
                leaves = {k: params[k].detach().requires_grad_(True) for k in names}
                with torch.enable_grad():
                    loss, new_vars, aux = loss_and_aux(
                        leaves, others, global_params, xs[i], ys[i], ms[i],
                        rnglib.fold_in(ek, i + 1))
                    grads = torch.autograd.grad(loss, [leaves[k] for k in names])
                with torch.no_grad():
                    grads = dict(zip(names, grads))
                    updates, opt_state = optimizer.update(grads, opt_state, params)
                    has_real = ms[i].sum() > 0
                    # a pad-only batch leaves the params where they were
                    params = {k: torch.where(has_real, params[k] + updates[k],
                                             params[k]) for k in names}
                    others = treelib.tree_detach(
                        {k: v for k, v in new_vars.items() if k != "params"})
                    for k in sums:
                        sums[k] = sums[k] + aux[k].detach()
                    real_steps = real_steps + has_real.float()
        metrics = {**sums, "steps": real_steps}
        return {**others, "params": params}, metrics

    def rebind(other: ModelBundle) -> LocalUpdateFn:
        return make_local_update(other, optimizer, epochs, loss_fn, prox_mu=prox_mu,
                                 shuffle=shuffle, augment_fn=augment_fn,
                                 compute_dtype=compute_dtype)

    return LocalUpdateFn(fn=local_update, epochs=epochs, bundle=bundle, rebind=rebind)


def make_evaluator(bundle: ModelBundle, loss_fn: LossFn = masked_softmax_ce):
    """Eval over a padded batch pack [steps, B, ...] → summed metrics.

    Evaluation stays float32 even when training uses a low-precision
    compute dtype."""

    @torch.no_grad()
    def evaluate(variables, x, y, mask):
        total: Dict[str, torch.Tensor] = {}
        for i in range(x.shape[0]):
            logits = bundle.apply_eval(variables, x[i])
            _, aux = loss_fn(logits, y[i], mask[i])
            for k, v in aux.items():
                total[k] = total[k] + v if k in total else v
        return total

    return evaluate


def eval_summary(res) -> dict:
    """Summed evaluator metrics → the test_{acc,loss,count} record, plus
    ``test_precision``/``test_recall`` for a multi-label task
    (``losses.masked_multilabel_bce``)."""
    count = float(res["count"])
    out = {
        "test_acc": float(res["correct"]) / max(count, 1.0),
        "test_loss": float(res["loss_sum"]) / max(count, 1.0),
        "test_count": count,
    }
    if "precision_sum" in res:
        out["test_precision"] = float(res["precision_sum"]) / max(count, 1.0)
        out["test_recall"] = float(res["recall_sum"]) / max(count, 1.0)
    return out
