"""Decentralized online learning (DOL): streaming DSGD and PushSum (port
of ``fedml_tpu/algorithms/decentralized_online.py``).

Reference ``fedml_api/standalone/decentralized/``: DSGD and PushSum
clients over a topology, streaming samples, tracking online regret.  At
step t every client predicts on its incoming sample (the loss BEFORE the
update is the regret contribution), takes a gradient step, then mixes:

- DSGD (symmetric W):      X ← W·X
- PushSum (column-stochastic P, directed links): push the numerators Z
  and weights u through P and estimate X = Z/u.

Logistic models only, as in the reference.  The JAX package's
``lax.scan`` over the stream is a loop over its steps on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from fedml_tpu_torch.utils.device import DeviceLike, resolve_device


@dataclasses.dataclass
class DOLResult:
    regret_curve: np.ndarray  # [T] running average loss
    final_params: np.ndarray  # [N, D(+1)]
    consensus_distance: float


def _logistic_loss_grad(theta: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Per-client binary logistic loss and gradient; y in {0, 1}; theta
    rows ``[w, b]``: loss ``max(z,0) − z·y + log1p(exp(−|z|))``, gradient
    ``(σ(z) − y)·[x, 1]``."""
    w, b = theta[:, :-1], theta[:, -1]
    z = (x * w).sum(dim=1) + b
    loss = torch.clamp_min(z, 0) - z * y + torch.log1p(torch.exp(-z.abs()))
    g = torch.sigmoid(z) - y
    return loss, torch.cat([g[:, None] * x, g[:, None]], dim=1)


def _result(theta: torch.Tensor, losses: torch.Tensor) -> DOLResult:
    T = losses.shape[0]
    running = torch.cumsum(losses, 0) / (torch.arange(T, device=losses.device) + 1)
    mean = theta.mean(dim=0, keepdim=True)
    return DOLResult(
        regret_curve=running.cpu().numpy(),
        final_params=theta.cpu().numpy(),
        consensus_distance=float(((theta - mean) ** 2).sum(dim=1).mean()),
    )


def _stream(xs, ys, device: DeviceLike):
    dev = resolve_device(device)
    return (torch.as_tensor(np.asarray(xs, np.float32), device=dev),
            torch.as_tensor(np.asarray(ys, np.float32), device=dev), dev)


def run_dsgd(xs: np.ndarray, ys: np.ndarray, mixing: np.ndarray, lr: float = 0.1,
             device: DeviceLike = None) -> DOLResult:
    """``xs`` [T, N, D] (client i's sample at step t), ``ys`` [T, N],
    ``mixing`` [N, N] row-stochastic and symmetric."""
    X, Y, dev = _stream(xs, ys, device)
    T, N, D = X.shape
    W = torch.as_tensor(np.asarray(mixing, np.float32), device=dev)
    theta = torch.zeros((N, D + 1), dtype=torch.float32, device=dev)
    losses = []
    for t in range(T):
        loss, grad = _logistic_loss_grad(theta, X[t], Y[t])
        theta = W @ (theta - lr * grad)  # gossip mix
        losses.append(loss.mean())
    return _result(theta, torch.stack(losses))


def run_pushsum(xs: np.ndarray, ys: np.ndarray, mixing: np.ndarray, lr: float = 0.1,
                device: DeviceLike = None) -> DOLResult:
    """As ``run_dsgd`` over a COLUMN-stochastic ``mixing`` (asymmetric
    links allowed; its columns are normalized here)."""
    X, Y, dev = _stream(xs, ys, device)
    T, N, D = X.shape
    P = torch.as_tensor(np.asarray(mixing, np.float32), device=dev)
    # column-stochastic: each node splits its mass among its out-neighbours
    P = P / torch.clamp_min(P.sum(dim=0, keepdim=True), 1e-12)
    z = torch.zeros((N, D + 1), dtype=torch.float32, device=dev)
    u = torch.ones((N,), dtype=torch.float32, device=dev)
    losses = []
    for t in range(T):
        loss, grad = _logistic_loss_grad(z / u[:, None], X[t], Y[t])
        z = P @ (z - lr * grad)
        u = P @ u
        losses.append(loss.mean())
    return _result(z / u[:, None], torch.stack(losses))


def make_stream(n_steps: int, n_clients: int, dim: int, seed: int = 0,
                noise: float = 0.1) -> Tuple[np.ndarray, np.ndarray]:
    """Synthetic linearly-separable stream (UCI-shaped offline stand-in)."""
    rng = np.random.RandomState(seed)
    w_true = rng.normal(0, 1, dim)
    xs = rng.normal(0, 1, (n_steps, n_clients, dim)).astype(np.float32)
    logits = xs @ w_true + noise * rng.normal(0, 1, (n_steps, n_clients))
    ys = (logits > 0).astype(np.float32)
    return xs, ys
