"""Server optimizer registry (port of ``fedml_tpu/core/optrepo.py``).

The JAX package names optax constructors; here each is the same chain of
transforms computed as optax 0.2.6 computes it, on trees of tensors.  A
transform is a pair of plain functions, ``init(params) -> state`` and
``update(grads, state, params) -> (updates, state)``; a chain's state is
the tuple of its transforms' states, so a server optimizer state is a
plain tree of tensors that ``core/checkpoint.py`` saves and restores.
The state of each transform mirrors optax's named tuple as a dict
(``count``/``mu``/``nu``, ``trace``, ``sum_of_squares``; ``()`` for an
empty one).

``torch.optim`` is not used: it differs from optax exactly here (the
adagrad accumulator starts at 0.1, yogi starts at 1e-6 and has no torch
counterpart, lamb's trust ratio is 1 where a norm is 0, and
``sgd(momentum=None)`` keeps no trace at all).  The registry's defaults
(eps 1e-3 for adam, yogi and adagrad: the Adaptive-FedOpt paper's tau)
are the JAX package's, not optax's.

Float32 powers (``b1**count`` of the bias correction) are float64 powers
rounded to float32: for the registry's decays (0.9, 0.99, 0.999) XLA's
float32 ``pow`` on the CPU agrees with that at every count below 349 and
differs by one float32 ulp at some counts beyond.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

from fedml_tpu_torch.core import tree as treelib

Tree = Any


class GradientTransformation(NamedTuple):
    init: Callable[[Tree], Any]
    update: Callable[[Tree, Any, Tree], Tuple[Tree, Any]]


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    """optax.chain: the transforms in order, state = tuple of their states."""

    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new_state.append(s)
        return grads, tuple(new_state)

    return GradientTransformation(init, update)


def _empty(params):
    del params
    return ()


def f32_pow(base: float, exponent: torch.Tensor) -> torch.Tensor:
    """``float32(base) ** exponent`` in float32, through float64."""
    b = float(np.float32(base))
    return torch.pow(torch.tensor(b, dtype=torch.float64, device=exponent.device),
                     exponent.double()).float()


def _bias_correction(moment: Tree, decay: float, count: torch.Tensor) -> Tree:
    bc = 1 - f32_pow(decay, count)
    return treelib.tree_map(lambda t: t / bc.to(t.dtype), moment)


def _count0(params) -> torch.Tensor:
    leaf = treelib.tree_leaves(params)[0]
    return torch.zeros((), dtype=torch.int32, device=leaf.device)


def identity() -> GradientTransformation:
    return GradientTransformation(_empty, lambda g, s, p=None: (g, s))


def scale(step_size: float) -> GradientTransformation:
    return GradientTransformation(
        _empty, lambda g, s, p=None: (treelib.tree_map(lambda x: step_size * x, g), s))


def scale_by_learning_rate(learning_rate: float) -> GradientTransformation:
    return scale(-1 * learning_rate)


def trace(decay: float) -> GradientTransformation:
    """optax.trace: ``t ← g + decay·t``, the update is the new trace."""

    def init(params):
        return {"trace": treelib.tree_zeros_like(params)}

    def update(g, state, params=None):
        new = treelib.tree_map(lambda gi, t: gi + decay * t, g, state["trace"])
        return new, {"trace": new}

    return GradientTransformation(init, update)


def _moment(g: Tree, m: Tree, decay: float, order: int) -> Tree:
    """optax.tree.update_moment: ``(1 − decay)·g^order + decay·m``."""
    if order == 1:
        return treelib.tree_map(lambda gi, t: (1 - decay) * gi + decay * t, g, m)
    return treelib.tree_map(lambda gi, t: (1 - decay) * (gi * gi) + decay * t, g, m)


def _adam_direction(mu_hat: Tree, nu_hat: Tree, eps: float) -> Tree:
    return treelib.tree_map(lambda m, v: m / (torch.sqrt(v) + eps), mu_hat, nu_hat)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> GradientTransformation:
    def init(params):
        return {"count": _count0(params), "mu": treelib.tree_zeros_like(params),
                "nu": treelib.tree_zeros_like(params)}

    def update(g, state, params=None):
        mu = _moment(g, state["mu"], b1, 1)
        nu = _moment(g, state["nu"], b2, 2)
        count = state["count"] + 1
        out = _adam_direction(_bias_correction(mu, b1, count),
                              _bias_correction(nu, b2, count), eps)
        return out, {"count": count, "mu": mu, "nu": nu}

    return GradientTransformation(init, update)


def scale_by_yogi(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-3) -> GradientTransformation:
    def init(params):  # both moments start at optax's 1e-6
        full = lambda: treelib.tree_map(  # noqa: E731
            lambda p: torch.full_like(p, 1e-6), params)
        return {"count": _count0(params), "mu": full(), "nu": full()}

    def update(g, state, params=None):
        mu = _moment(g, state["mu"], b1, 1)
        nu = treelib.tree_map(
            lambda gi, v: v - (1 - b2) * torch.sign(v - gi * gi) * (gi * gi),
            g, state["nu"])
        count = state["count"] + 1
        out = _adam_direction(_bias_correction(mu, b1, count),
                              _bias_correction(nu, b2, count), eps)
        return out, {"count": count, "mu": mu, "nu": nu}

    return GradientTransformation(init, update)


def scale_by_rss(eps: float = 1e-7) -> GradientTransformation:
    def init(params):  # the accumulator starts at optax's 0.1
        return {"sum_of_squares": treelib.tree_map(
            lambda p: torch.full_like(p, 0.1), params)}

    def update(g, state, params=None):
        sos = treelib.tree_map(lambda gi, t: gi * gi + t, g, state["sum_of_squares"])
        out = treelib.tree_map(
            lambda t, gi: torch.where(t > 0, torch.rsqrt(t + eps),
                                      torch.zeros_like(t)) * gi, sos, g)
        return out, {"sum_of_squares": sos}

    return GradientTransformation(init, update)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """optax.clip_by_global_norm: every leaf times ``max_norm / ‖g‖`` where
    the global norm reaches ``max_norm``."""
    def update(g, state, params):
        del params
        norm = treelib.tree_norm(g)
        keep = norm < max_norm
        return treelib.tree_map(
            lambda v: torch.where(keep, v, v / norm.to(v.dtype) * max_norm), g), state

    return GradientTransformation(_empty, update)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    return GradientTransformation(
        _empty, lambda g, s, p: (treelib.tree_map(lambda gi, pi: gi + weight_decay * pi,
                                                  g, p), s))


def scale_by_trust_ratio() -> GradientTransformation:
    """``u · ‖p‖ / ‖u‖`` per leaf, 1 where either norm is 0."""

    def scale_leaf(u, p):
        pn = torch.linalg.vector_norm(p)
        un = torch.linalg.vector_norm(u)
        ratio = torch.where((pn == 0.0) | (un == 0.0),
                            torch.ones((), dtype=p.dtype, device=p.device), pn / un)
        return u * ratio

    return GradientTransformation(
        _empty, lambda g, s, p: (treelib.tree_map(scale_leaf, g, p), s))


def apply_updates(params: Tree, updates: Tree) -> Tree:
    """optax.apply_updates: ``p + u`` in the parameter's dtype."""
    return treelib.tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


# -- the optax aliases the registry names ---------------------------------------

def sgd(learning_rate: float, momentum=None) -> GradientTransformation:
    return chain(trace(momentum) if momentum is not None else identity(),
                 scale_by_learning_rate(learning_rate))


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> GradientTransformation:
    return chain(scale_by_adam(b1, b2, eps), scale_by_learning_rate(learning_rate))


def yogi(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-3) -> GradientTransformation:
    return chain(scale_by_yogi(b1, b2, eps), scale_by_learning_rate(learning_rate))


def adagrad(learning_rate: float, eps: float = 1e-7) -> GradientTransformation:
    return chain(scale_by_rss(eps), scale_by_learning_rate(learning_rate))


def lamb(learning_rate: float) -> GradientTransformation:
    """optax.lamb at its defaults (b1 0.9, b2 0.999, eps 1e-6, no decay)."""
    return chain(scale_by_adam(0.9, 0.999, 1e-6), add_decayed_weights(0.0),
                 scale_by_trust_ratio(), scale_by_learning_rate(learning_rate))


# -- the registry -----------------------------------------------------------------

_REGISTRY: Dict[str, Callable[..., GradientTransformation]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name.lower()] = fn
        return fn

    return deco


@register("sgd")
def _sgd(lr: float = 1.0, momentum: float = 0.0, **kw):
    return sgd(lr, momentum=momentum if momentum else None)


@register("avgm")
@register("fedavgm")
def _avgm(lr: float = 1.0, momentum: float = 0.9, **kw):
    return sgd(lr, momentum=momentum)


@register("adam")
@register("fedadam")
def _adam(lr: float = 1e-2, b1: float = 0.9, b2: float = 0.99, eps: float = 1e-3, **kw):
    return adam(lr, b1=b1, b2=b2, eps=eps)


@register("yogi")
@register("fedyogi")
def _yogi(lr: float = 1e-2, b1: float = 0.9, b2: float = 0.99, eps: float = 1e-3, **kw):
    return yogi(lr, b1=b1, b2=b2, eps=eps)


@register("adagrad")
@register("fedadagrad")
def _adagrad(lr: float = 1e-2, eps: float = 1e-3, **kw):
    return adagrad(lr, eps=eps)


@register("lamb")
def _lamb(lr: float = 1e-3, **kw):
    return lamb(lr)


def get_server_optimizer(name: str, **kwargs) -> GradientTransformation:
    try:
        return _REGISTRY[name.lower()](**kwargs)
    except KeyError:
        raise ValueError(
            f"unknown server optimizer {name!r}; have {sorted(_REGISTRY)}"
        ) from None


def names():
    return sorted(_REGISTRY)
