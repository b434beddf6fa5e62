"""Finite-field MPC primitives for secure aggregation (port of
``fedml_tpu/core/mpc.py``; TurboAggregate).

Coefficient generation (``modular_inv``, ``field_div``,
``gen_lagrange_coeffs``: O(N²) scalar field ops) stays on the host in
exact Python integers.  The bulk share arithmetic runs as int64 tensors
on the device of its input: with a prime p < 2³¹ every product of two
residues is below 2⁶², so a multiply-accumulate with a mod after every
term never overflows.  ``%`` on int64 tensors is the floor mod, as
``jnp``'s (``torch.fmod`` would keep the sign).  Fixed-point
quantization maps floats into the field in float64 with negatives as
p − |v|, rounding half to even (``torch.round``, as ``np.round``), so
aggregation in the field equals quantized aggregation in the reals.
Random field elements are ``rng.randint(..., dtype=torch.int64)``: the
JAX package's draws under x64, bit for bit.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from fedml_tpu_torch.core import rng as rnglib

# Mersenne prime 2^31 - 1: largest field with overflow-free int64 modmul.
DEFAULT_PRIME = (1 << 31) - 1


# --- host-side exact scalar field math (coefficient generation) -------------

def modular_inv(a: int, p: int = DEFAULT_PRIME) -> int:
    """a⁻¹ mod p (Fermat; p prime), in exact Python ints."""
    return pow(int(a) % p, p - 2, p)


def field_div(num: int, den: int, p: int = DEFAULT_PRIME) -> int:
    return (int(num) % p) * modular_inv(den, p) % p


def gen_lagrange_coeffs(alphas: Sequence[int], betas: Sequence[int],
                        p: int = DEFAULT_PRIME) -> np.ndarray:
    """U[i, j] = ∏_{o≠j} (αᵢ − β_o) / (β_j − β_o) mod p, exact ints."""
    alphas = [int(a) % p for a in alphas]
    betas = [int(b) % p for b in betas]
    U = np.zeros((len(alphas), len(betas)), dtype=np.int64)
    for i, a in enumerate(alphas):
        for j, bj in enumerate(betas):
            num, den = 1, 1
            for o in betas:
                if o != bj:
                    num = num * ((a - o) % p) % p
                    den = den * ((bj - o) % p) % p
            U[i, j] = field_div(num, den, p)
    return U


# --- device-side bulk share arithmetic --------------------------------------

def _residues(x, p: int, device=None) -> torch.Tensor:
    """``x`` (a tensor or array of integers) as int64 residues mod p on
    ``device`` (default: the tensor's own)."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t.to(device=device or t.device, dtype=torch.int64) % p


def coeff_combine(U, X, p: int = DEFAULT_PRIME) -> torch.Tensor:
    """Y[i] = Σ_j U[i, j]·X[j] mod p on X's device, overflow-free.

    U: [N, S] residues (host); X: [S, ...] residues; Y: [N, ...].  One
    term per share with a mod after it, as the JAX scan: every
    intermediate stays below 2⁶² + 2³¹."""
    X = _residues(X, p)
    U = _residues(U, p, X.device)
    acc = torch.zeros((U.shape[0],) + tuple(X.shape[1:]), dtype=torch.int64,
                      device=X.device)
    for j in range(X.shape[0]):
        u_j = U[:, j].reshape((-1,) + (1,) * (X.dim() - 1))
        acc = (acc + (u_j * X[j][None]) % p) % p
    return acc


def _lcc_grids(n: int, s: int, p: int) -> Tuple[np.ndarray, np.ndarray]:
    """(alphas[n], betas[s]) for LCC: betas = 0..s−1 are the interpolation
    points, alphas = s..s+n−1 the share points — disjoint, so no worker's
    share is a data chunk in the clear (the JAX package's fix of the
    reference's overlapping grids)."""
    betas = np.arange(0, s)
    alphas = np.arange(s, s + n)
    return (np.mod(alphas, p).astype(np.int64), np.mod(betas, p).astype(np.int64))


# --- BGW (Shamir) secret sharing --------------------------------------------

def bgw_encode(x, n: int, t: int, key, p: int = DEFAULT_PRIME) -> torch.Tensor:
    """Degree-t Shamir shares of ``x`` (field residues, any shape) for n
    parties at points α = 1..n: share_i = Σ_k R_k·αᵢᵏ with R_0 = x."""
    x = _residues(x, p)
    R = rnglib.randint(key, (t,) + tuple(x.shape), 0, p, x.device, torch.int64)
    coeffs = torch.cat([x[None], R], dim=0)  # [t+1, ...]
    alphas = np.arange(1, n + 1, dtype=np.int64) % p
    # Vandermonde α_i^k mod p, exact on the host
    V = np.ones((n, t + 1), dtype=np.int64)
    for k in range(1, t + 1):
        V[:, k] = V[:, k - 1] * alphas % p
    return coeff_combine(V, coeffs, p)


def bgw_decode(shares, worker_idx: Sequence[int], p: int = DEFAULT_PRIME) -> torch.Tensor:
    """The secret from ≥ t+1 shares, by Lagrange at 0 (``worker_idx``
    0-based)."""
    alphas = [(i + 1) % p for i in worker_idx]
    lam = gen_lagrange_coeffs([0], alphas, p)  # [1, R]
    return coeff_combine(lam, shares, p)[0]


# --- LCC (Lagrange coded computing) -----------------------------------------

def lcc_encode(x, n: int, k: int, t: int, key, p: int = DEFAULT_PRIME) -> torch.Tensor:
    """Split ``x`` (leading dim divisible by k) into k chunks + t random
    chunks, interpolate through the β-points, evaluate at n α-points.
    Returns [n, m/k, ...]."""
    x = _residues(x, p)
    m = x.shape[0]
    if m % k:
        raise ValueError(f"leading dim {m} not divisible by K={k}")
    chunks = x.reshape((k, m // k) + tuple(x.shape[1:]))
    if t > 0:
        R = rnglib.randint(key, (t,) + tuple(chunks.shape[1:]), 0, p, x.device,
                           torch.int64)
        chunks = torch.cat([chunks, R], dim=0)
    alphas, betas = _lcc_grids(n, k + t, p)
    return coeff_combine(gen_lagrange_coeffs(alphas, betas, p), chunks, p)


def lcc_decode(shares, worker_idx: Sequence[int], n: int, num_chunks: int,
               p: int = DEFAULT_PRIME) -> torch.Tensor:
    """All ``num_chunks`` = K+T interpolated chunk rows from the shares of
    ≥ num_chunks workers in ``worker_idx``; the first K rows are the data
    (pass the K+T used at encode time).  Returns [num_chunks·m', ...]."""
    alphas, betas = _lcc_grids(n, num_chunks, p)
    alpha_eval = [int(alphas[i]) for i in worker_idx]
    out = coeff_combine(gen_lagrange_coeffs(betas, alpha_eval, p), shares, p)
    return out.reshape((-1,) + tuple(out.shape[2:]))


# --- additive secret sharing -------------------------------------------------

def additive_shares(x, n: int, key, p: int = DEFAULT_PRIME) -> torch.Tensor:
    """n shares summing to x mod p."""
    x = _residues(x, p)
    r = rnglib.randint(key, (n - 1,) + tuple(x.shape), 0, p, x.device, torch.int64)
    last = (x - r.sum(dim=0) % p) % p
    return torch.cat([r, last[None]], dim=0)


def field_sum(shares, p: int = DEFAULT_PRIME) -> torch.Tensor:
    """Σ over the leading axis, mod p after every row."""
    s = _residues(shares, p)
    acc = torch.zeros(s.shape[1:], dtype=torch.int64, device=s.device)
    for row in s:
        acc = (acc + row) % p
    return acc


# --- fixed-point quantization (exact float64) --------------------------------

def quantize(x, scale: float = 2.0 ** 16, p: int = DEFAULT_PRIME) -> torch.Tensor:
    """Float → field: round(x·scale) in float64, half to even, negatives
    as p − |·|.  Values must satisfy |x|·scale·n_parties < p/2 for exact
    aggregate recovery."""
    x = torch.as_tensor(x)
    v = torch.round(x.double() * float(scale)).to(torch.int64)
    return torch.where(v < 0, v + p, v) % p


def dequantize(v, scale: float = 2.0 ** 16, p: int = DEFAULT_PRIME) -> torch.Tensor:
    """Field → float64, centered lift: residues > p/2 are negative.  The
    division is by a tensor: CUDA divides by a Python scalar as a
    reciprocal multiply."""
    v = _residues(v, p)
    signed = torch.where(v > p // 2, v - p, v)
    return signed.double() / torch.tensor(float(scale), dtype=torch.float64,
                                          device=v.device)
