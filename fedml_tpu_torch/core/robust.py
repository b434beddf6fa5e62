"""Robust aggregation defenses on tensors (port of the torch half of
``fedml_tpu/core/robust.py``).

Reference ``fedml_core/robustness/robust_aggregation.py``: norm-difference
clipping ``w_t + clip(w_local − w_t)`` over the parameters only (BatchNorm
statistics are their own collection and never enter), weak differential
privacy (clip, then add N(0, stddev²) noise), and the coordinate-wise
median and trimmed mean (Blanchard et al. 2017, Yin et al. 2018).

A stacked tree holds K clients on a leading axis.  Noise comes from the
aggregation stream of the round key, ``fold_in(fold_in(fold_in(key,
round), AGG_STREAM), slot)``, the per-slot keys ``make_round_fn`` hands
its ``aggregate_transform``; each client's key is split into one key per
leaf in ``jax.tree_util`` leaf order (sorted flax paths,
``compress.jax_leaves``), so the noise is the JAX package's, bit for bit,
on every device.

The numpy form the cross-device server screens uploads with
(``fedml_tpu/robust/defense.py``) is ported with that server.
"""

from __future__ import annotations

from typing import Any

import torch

from fedml_tpu_torch.compress.codecs import jax_leaves, unflatten_like
from fedml_tpu_torch.core import rng as rnglib
from fedml_tpu_torch.core import tree as treelib

Tree = Any

# fold_in sub-streams under the round key: 0 = training, 1 = aggregation
# noise (this module), 2 = compression
AGG_STREAM = 1

_NORM_EPS = 1e-12


def param_delta_sq_norms(global_params: Tree, stacked_params: Tree) -> torch.Tensor:
    """[K] squared L2 norm of (w_i − w_global) over the parameters, the
    leaves summed in JAX's leaf order."""
    sq = treelib.tree_map(
        lambda g, s: (s.float() - g[None].float()).square().sum(
            dim=tuple(range(1, s.ndim))),
        global_params, stacked_params)
    return sum(leaf for _, leaf in jax_leaves(sq))


def param_delta_norms(global_params: Tree, stacked_params: Tree) -> torch.Tensor:
    return torch.sqrt(param_delta_sq_norms(global_params, stacked_params))


def clip_factor(norms: torch.Tensor, norm_bound: float) -> torch.Tensor:
    """Per-client clip scale ``min(1, bound / max(norm, eps))``."""
    return torch.clamp_max(norm_bound / torch.clamp_min(norms, _NORM_EPS), 1.0)


def clip_stacked_params(global_params: Tree, stacked_params: Tree,
                        norm_bound: float) -> Tree:
    """Norm-difference clipping over a stacked [K, ...] params tree:
    ``w_t + scale_k · (w_k − w_t)``."""
    scale = clip_factor(param_delta_norms(global_params, stacked_params), norm_bound)

    def clip(g, s):
        g32 = g[None].float()
        k = scale.reshape((-1,) + (1,) * (s.ndim - 1))
        return (g32 + k * (s.float() - g32)).to(s.dtype)

    return treelib.tree_map(clip, global_params, stacked_params)


def clip_client_updates(global_vars: Tree, stacked_client_vars: Tree,
                        norm_bound: float) -> Tree:
    clipped = clip_stacked_params(global_vars["params"],
                                  stacked_client_vars["params"], norm_bound)
    return {**stacked_client_vars, "params": clipped}


def noise_params(key: rnglib.Key, client_params: Tree, stddev: float) -> Tree:
    """Gaussian noise on ONE client's parameters: ``key`` split into one
    key per leaf in JAX's leaf order, each leaf ``l + stddev · N(0, 1)``
    in float32, on the leaf's device."""
    leaves = jax_leaves(client_params)
    keys = rnglib.split(key, len(leaves))
    noised = [(l.float() + stddev * rnglib.normal(k, l.shape, l.device)).to(l.dtype)
              for (_, l), k in zip(leaves, keys)]
    return unflatten_like(client_params, noised)


def agg_noise_key(seed_key: rnglib.Key, round_idx: int, slot: int) -> rnglib.Key:
    """The aggregation-defense key of (round, global slot): the one
    ``make_round_fn`` hands its ``aggregate_transform``."""
    k_round = rnglib.fold_in(seed_key, round_idx)
    return rnglib.fold_in(rnglib.fold_in(k_round, AGG_STREAM), slot)


def add_weak_dp_noise(stacked_client_vars: Tree, rngs, stddev: float) -> Tree:
    """Gaussian noise on each client's parameters (weak DP); ``rngs`` is
    [K, 2], one key per client slot."""
    params = stacked_client_vars["params"]
    rows = [noise_params(rngs[k], treelib.tree_map(lambda s: s[k], params), stddev)
            for k in range(len(rngs))]
    noised = treelib.tree_map(lambda *leaves: torch.stack(leaves), *rows)
    return {**stacked_client_vars, "params": noised}


def coordinate_median(stacked_params: Tree) -> Tree:
    """Coordinate-wise median over the client axis, [K, ...] → [...]: for
    an even K the mean of the two middle values, ``(lo + hi) · 0.5``, as
    ``jnp.median`` computes it (``torch.median`` returns the lower one)."""

    def one(s):
        srt = torch.sort(s.float(), dim=0).values
        k = s.shape[0]
        lo, hi = srt[(k - 1) // 2], srt[k // 2]
        return ((lo + hi) * 0.5).to(s.dtype)

    return treelib.tree_map(one, stacked_params)


def trimmed_mean(stacked_params: Tree, trim_frac: float) -> Tree:
    """Coordinate-wise trimmed mean: sort each coordinate across the K
    clients, drop ``floor(trim_frac · K)`` from each end, average the
    rest."""
    if not 0.0 <= trim_frac < 0.5:
        raise ValueError(f"trim_frac must be in [0, 0.5): {trim_frac!r}")

    def one(s):
        k = s.shape[0]
        cut = int(trim_frac * k)
        srt = torch.sort(s.float(), dim=0).values
        kept = srt[cut:k - cut] if cut else srt
        return (kept.sum(0) / kept.shape[0]).to(s.dtype)

    return treelib.tree_map(one, stacked_params)


def robust_center(defense_type: str, stacked_params: Tree, *,
                  trim_frac: float = 0.2) -> Tree:
    if defense_type == "median":
        return coordinate_median(stacked_params)
    if defense_type == "trimmed_mean":
        return trimmed_mean(stacked_params, trim_frac)
    raise ValueError(f"unknown buffered defense {defense_type!r} "
                     "(expected 'median' or 'trimmed_mean')")


DEFENSE_TYPES = ("norm_diff_clipping", "weak_dp", "median", "trimmed_mean")


def make_robust_transform(defense_type: str = "norm_diff_clipping", *,
                          norm_bound: float = 30.0, stddev: float = 0.025,
                          trim_frac: float = 0.2):
    """The ``aggregate_transform`` hook ``(old_vars, stacked, weights,
    keys[K]) -> stacked``: ``norm_diff_clipping``, ``weak_dp`` (clip, then
    noise), or the robust center (``median``/``trimmed_mean``) put in every
    client's place, so the round's weighted mean of the K equal entries
    is the center."""
    if defense_type not in DEFENSE_TYPES:
        raise ValueError(f"unknown defense_type {defense_type!r}; "
                         f"expected one of {DEFENSE_TYPES}")

    def transform(global_vars, stacked, weights, rngs):
        del weights
        if defense_type in ("median", "trimmed_mean"):
            center = robust_center(defense_type, stacked["params"], trim_frac=trim_frac)
            broadcast = treelib.tree_map(
                lambda c, s: c[None].expand(s.shape).to(s.dtype),
                center, stacked["params"])
            return {**stacked, "params": broadcast}
        stacked = clip_client_updates(global_vars, stacked, norm_bound)
        if defense_type == "weak_dp":
            stacked = add_weak_dp_noise(stacked, rngs, stddev)
        return stacked

    return transform
