"""JAX's threefry2x32 random streams, bit for bit (port of the parts of
``jax.random`` the JAX package draws from).

A key is what ``jax.random.key_data(jax.random.PRNGKey(seed))`` holds: a
numpy ``uint32`` array of shape (2,).  The variant pinned is the one the
JAX package runs, ``jax_threefry_partitionable=True`` (jax 0.9.0's
default): ``split`` hashes the ``iota_2x32_shape`` counters of the key
array's shape, ``random_bits`` returns ``bits1 ^ bits2`` over the same
counters of the output shape.

Key derivation on scalars (``PRNGKey``, ``fold_in``, ``split``) runs on
the host in Python ints, so deriving a round's, a client's or an epoch's
key never waits for the device.  Bulk draws (``random_bits`` and the
samplers over it) run on the device they are asked for, as int64 tensors
that hold uint32 words (every sum masked with 0xFFFFFFFF, every shift of
a non-negative value): the same integer arithmetic on every device, so
the CPU and the card draw the same bits.

``normal`` and ``truncated_normal`` go through ``erf_inv`` as XLA lowers
it for float32 on the CPU: Giles' polynomial with every multiply-add
rounded once, over XLA's own ``log1p`` and ``log`` polynomials.  A fused
multiply-add is computed in float64 and rounded to float32 (the product
of two float32 values is exact in float64), which every device does
alike.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_UINT32_MAX = np.iinfo(np.uint32).max

Key = np.ndarray  # uint32 [2]
Words = Union[int, torch.Tensor]  # a uint32 value: Python int or int64 tensor


def threefry2x32(k1: int, k2: int, x0: Words,
                 x1: Words) -> Tuple[Words, Words]:
    """The Threefry-2x32 block (20 rounds) of key ``(k1, k2)`` over the
    counter pair ``(x0, x1)``: Python ints, or int64 tensors of uint32
    words (``jax._src.prng._threefry2x32_lowering``)."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = x0 ^ (((x1 << r) | (x1 >> (32 - r))) & MASK)
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def _words(key) -> Tuple[int, int]:
    k = np.asarray(key, dtype=np.uint32).reshape(2)
    return int(k[0]), int(k[1])


def PRNGKey(seed: int) -> Key:  # noqa: N802 (JAX's name)
    """``jax.random.PRNGKey(seed)`` without x64: the seed's low 32 bits."""
    return np.array([0, int(seed) & MASK], dtype=np.uint32)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in``: the block of ``key`` over ``(0, data)``."""
    return np.array(threefry2x32(*_words(key), 0, int(data) & MASK),
                    dtype=np.uint32)


def fold_in_many(key: Key, data: np.ndarray) -> np.ndarray:
    """``[fold_in(key, d) for d in data]`` as one vectorised numpy pass:
    [len(data), 2] uint32 keys."""
    d = np.asarray(data, dtype=np.int64).reshape(-1) & MASK
    b1, b2 = threefry2x32(*_words(key), np.zeros_like(d), d)
    return np.stack([b1, b2], axis=1).astype(np.uint32)


def split(key: Key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: [num, 2] keys (fold-like split)."""
    k1, k2 = _words(key)
    return np.array([threefry2x32(k1, k2, i >> 32, i & MASK)
                     for i in range(num)], dtype=np.uint32).reshape(num, 2)


def random_bits(key: Key, shape: Sequence[int],
                device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 words on ``device``."""
    shape = tuple(int(s) for s in shape)
    idx = torch.arange(int(np.prod(shape, dtype=np.int64)), dtype=torch.int64,
                       device=device)
    b1, b2 = threefry2x32(*_words(key), idx >> 32, idx & MASK)
    return (b1 ^ b2).reshape(shape)


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """32-bit words → float32 in [0, 1): the top 23 bits as the mantissa
    of a float in [1, 2), minus one."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def uniform(key: Key, shape: Sequence[int], device=None, minval=None,
            maxval=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, minval=, maxval=)`` in float32;
    with a range, ``max(minval, u·(maxval − minval) + minval)`` with the
    multiply-add rounded once, as XLA's CPU code rounds it."""
    u = uniform_from_bits(random_bits(key, shape, device))
    if minval is None and maxval is None:
        return u
    lo = np.float32(0.0 if minval is None else minval)
    hi = np.float32(1.0 if maxval is None else maxval)
    return torch.clamp_min(fma(u, float(hi - lo), float(lo)), float(lo))


def fma(a, b, c) -> torch.Tensor:
    """float32 ``a·b + c`` rounded once: the exact product plus ``c`` in
    float64, then float32 (a tensor among ``a``/``b``/``c`` sets the
    device; Python floats must already be float32 values)."""
    def f64(v):
        return v.double() if isinstance(v, torch.Tensor) else v
    return (f64(a) * f64(b) + f64(c)).float()


# XLA's CPU ``log`` for float32 (the Cephes polynomial of its vectorised
# math library) and the coefficients of its ``log1p`` for |x| < √2 − 1
_LOG_P = tuple(float(np.float32(c)) for c in (
    7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1, -1.2420140846E-1,
    1.4249322787E-1, -1.6668057665E-1, 2.0000714765E-1, -2.4999993993E-1,
    3.3333331174E-1))
_LOG_Q1 = float(np.float32(-2.12194440e-4))
_LOG_Q2 = float(np.float32(0.693359375))
_LOG1P_NUM = tuple(float(np.float32(c)) for c in (
    4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
    6.5787325942061044846969E0, 2.9911919328553073277375E1,
    6.0949667980987787057556E1, 5.7112963590585538103336E1,
    2.0039553499201281259648E1))
_LOG1P_DEN = tuple(float(np.float32(c)) for c in (
    1.0, 1.5062909083469192043167E1, 8.3047565967967209469434E1,
    2.2176239823732856465394E2, 3.0909872225312059774938E2,
    2.1642788614495947685003E2, 6.0118660497603843919306E1))
# Giles' erfinv coefficients for w < 5 and w >= 5
_ERFINV_LO = tuple(float(np.float32(c)) for c in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941))
_ERFINV_HI = tuple(float(np.float32(c)) for c in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682))
_SQRT2 = float(np.float32(np.sqrt(2)))
# erf(∓2/√2) in float32 as XLA computes them: the bounds of the uniform
# draw under truncated_normal(-2, 2) (pinned against jax in the tests)
ERF_2_SQRT2 = float(np.float32(0.9544997))


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``log`` for positive normal inputs (Cephes:
    mantissa in [√½, √2) and exponent, a degree-8 polynomial)."""
    bits = x.view(torch.int32)
    e = ((bits >> 23) & 0xFF).to(torch.float32) - 126.0
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    small = m < float(np.float32(0.707106781186547524))
    t = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    e = e - small.to(torch.float32)
    x2 = t * t
    x3 = x2 * t
    y = fma(t, _LOG_P[0], _LOG_P[1])
    y1 = fma(t, _LOG_P[3], _LOG_P[4])
    y2 = fma(t, _LOG_P[6], _LOG_P[7])
    y = fma(y, t, _LOG_P[2])
    y1 = fma(y1, t, _LOG_P[5])
    y2 = fma(y2, t, _LOG_P[8])
    y = fma(y, x3, y1)
    y = fma(y, x3, y2)
    y = fma(y, x3, _LOG_Q1 * e)
    t = fma(-0.5, x2, t)
    t = t + y
    return fma(_LOG_Q2, e, t)


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    p = torch.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        p = fma(p, x, c)
    return p


def log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log1p``: a rational polynomial for |x| < √2 − 1,
    else ``log(1 + x)``."""
    x2 = x * x
    small = (x * x2) * (_horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN))
    small = x + fma(-0.5, x2, small)
    large = log_f32(torch.clamp_min(x + 1.0, float(np.finfo(np.float32).tiny)))
    return torch.where(x.abs() < float(np.float32(0.41421356237309504880)),
                       small, large)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` (Giles 2010) on x in (-1, 1): a degree-8
    polynomial in ``w − 2.5`` (w < 5) or ``√w − 3``, ``w = −log1p(−x²)``."""
    w = -log1p_f32(-x * x)
    lt = w < 5.0
    # the float32 square root correctly rounded (via float64, exact for a
    # float32 input); torch's vectorised CPU sqrt is not, everywhere
    w = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    p = torch.where(lt, torch.full_like(x, _ERFINV_LO[0]),
                    torch.full_like(x, _ERFINV_HI[0]))
    for lo, hi in zip(_ERFINV_LO[1:], _ERFINV_HI[1:]):
        p = fma(p, w, torch.where(lt, torch.full_like(x, lo),
                                  torch.full_like(x, hi)))
    out = p * x
    return torch.where(x.abs() == 1.0, x * float(np.finfo(np.float32).max), out)


def normal(key: Key, shape: Sequence[int], device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` in float32: √2·erf_inv(u), u
    uniform in [nextafter(−1, 0), 1)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    return _SQRT2 * erf_inv(uniform(key, shape, device, lo, 1.0))


def truncated_normal(key: Key, lower: float, upper: float,
                     shape: Sequence[int], device=None) -> torch.Tensor:
    """``jax.random.truncated_normal(key, lower, upper, shape)`` in float32
    for the (−2, 2) every flax ``lecun_normal`` draws: √2·erf_inv(u), u
    uniform between erf(lower/√2) and erf(upper/√2), clipped into the
    open interval."""
    if (lower, upper) != (-2.0, 2.0):
        raise ValueError("truncated_normal carries XLA's erf constants for "
                         f"(-2, 2) only, got ({lower}, {upper})")
    out = _SQRT2 * erf_inv(uniform(key, shape, device, -ERF_2_SQRT2, ERF_2_SQRT2))
    lo = float(np.nextafter(np.float32(lower), np.float32(np.inf)))
    hi = float(np.nextafter(np.float32(upper), np.float32(-np.inf)))
    return torch.clamp(out, lo, hi)


def bernoulli(key: Key, p: float, shape: Sequence[int],
              device=None) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: ``uniform < p`` in float32
    (``p`` rounded to float32 first, as JAX does)."""
    return uniform(key, shape, device) < float(np.float32(p))


def randint(key: Key, shape: Sequence[int], minval: int, maxval: int,
            device=None) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32): two
    32-bit draws under ``split(key)``, folded into the span as JAX does,
    ``(hi % span · (2^32 % span) + lo % span) % span`` in uint32
    arithmetic."""
    info = np.iinfo(np.int32)
    if not (info.min <= minval <= info.max and info.min <= maxval <= info.max):
        raise ValueError(f"randint bounds [{minval}, {maxval}) outside int32")
    k_hi, k_lo = split(key)
    hi = random_bits(k_hi, shape, device)
    lo = random_bits(k_lo, shape, device)
    span = (maxval - minval) & MASK if maxval > minval else 1
    multiplier = (2 ** 16) % span
    multiplier = (multiplier * multiplier) % span
    offset = ((((hi % span) * multiplier) & MASK) + lo % span) & MASK
    return (minval + offset % span).to(torch.int32)


def permutation(key: Key, n: int, device=None) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` (int64 here, int32 in JAX):
    ``ceil(3 ln n / ln(2^32 - 1))`` stable sorts of ``arange(n)`` by fresh
    32-bit keys, each pass under the second half of a ``split``."""
    x = torch.arange(int(n), dtype=torch.int64, device=device)
    num_rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(_UINT32_MAX)))
    for _ in range(num_rounds):
        key, subkey = split(key)
        order = torch.sort(random_bits(subkey, (n,), device), stable=True).indices
        x = x[order]
    return x
