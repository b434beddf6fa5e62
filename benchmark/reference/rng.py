"""JAX's threefry2x32 draws, in plain numpy and torch, for the reference.

The program under test keys each client's shuffle, augmentation and
step from JAX's threefry streams.  The reference works those draws out
again, from the seed, with this frozen copy of the arithmetic
(``jax.random`` with ``jax_threefry_partitionable=True``): ``PRNGKey``,
``fold_in``, ``split``, ``bits``, ``uniform``, ``bernoulli``, ``randint``
(int32) and ``permutation``.  Keys are ``uint32[2]`` numpy arrays; bulk
draws are int64 tensors that hold uint32 words.
"""

from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_UINT32_MAX = np.iinfo(np.uint32).max


def threefry2x32(k1, k2, x0, x1):
    """The 20-round Threefry-2x32 block of key ``(k1, k2)`` over the counter
    pair ``(x0, x1)`` (Python ints or int64 tensors of uint32 words)."""
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


def _words(key):
    k = np.asarray(key, dtype=np.uint32).reshape(2)
    return int(k[0]), int(k[1])


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` without x64: the seed's low 32 bits."""
    return np.array([0, int(seed) & MASK], dtype=np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    return np.array(threefry2x32(*_words(key), 0, int(data) & MASK), dtype=np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    k1, k2 = _words(key)
    return np.array([threefry2x32(k1, k2, i >> 32, i & MASK) for i in range(num)],
                    dtype=np.uint32).reshape(num, 2)


def bits(key, shape, device) -> torch.Tensor:
    shape = tuple(int(s) for s in shape)
    idx = torch.arange(int(np.prod(shape, dtype=np.int64)), dtype=torch.int64,
                       device=device)
    b1, b2 = threefry2x32(*_words(key), idx >> 32, idx & MASK)
    return (b1 ^ b2).reshape(shape)


def uniform(key, shape, device) -> torch.Tensor:
    """float32 in [0, 1): the top 23 bits as the mantissa of [1, 2), minus 1."""
    b = bits(key, shape, device)
    return ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def bernoulli(key, p: float, shape, device) -> torch.Tensor:
    return uniform(key, shape, device) < float(np.float32(p))


def randint(key, shape, minval: int, maxval: int, device) -> torch.Tensor:
    """int32 ``randint``: two 32-bit draws folded into the span."""
    span = maxval - minval if maxval > minval else 1
    k_hi, k_lo = split(key)
    hi = bits(k_hi, shape, device)
    lo = bits(k_lo, shape, device)
    mult = (2 ** 16) % span
    mult = ((mult * mult) & MASK) % span
    offset = ((((hi % span) * mult) & MASK) + lo % span) & MASK
    return (minval + offset % span).to(torch.int32)


def permutation(key, n: int, device) -> torch.Tensor:
    """``ceil(3 ln n / ln(2^32 - 1))`` stable sorts of ``arange(n)`` by fresh
    32-bit keys, each under the second half of a ``split``."""
    x = torch.arange(int(n), dtype=torch.int64, device=device)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(_UINT32_MAX)))
    for _ in range(rounds):
        key, sub = split(key)
        x = x[torch.sort(bits(sub, (n,), device), stable=True).indices]
    return x
