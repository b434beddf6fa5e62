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


def uniform(key: Key, shape: Sequence[int], device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: float32 in [0, 1), the top 23
    bits as the mantissa of a float in [1, 2), minus one."""
    bits = (random_bits(key, shape, device) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


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
