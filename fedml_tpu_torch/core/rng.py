"""Counter-style seed derivation: the port's stand-in for ``jax.random.fold_in``.

The JAX package derives every random stream from ``fold_in(key, ...)``
chains (round, sub-stream, client slot, epoch).  Here a stream is an
integer seed hashed from the same coordinates with numpy's
``SeedSequence`` and handed to a ``torch.Generator``.  The bits differ
from JAX's threefry; the structure (one independent, reproducible
stream per coordinate tuple) is the same.
"""

from __future__ import annotations

import numpy as np
import torch


def fold_in(seed: int, *data: int) -> int:
    """A 64-bit seed that depends on ``seed`` and every entry of ``data``."""
    ss = np.random.SeedSequence([int(seed) & 0xFFFFFFFFFFFFFFFF,
                                 *[int(d) & 0xFFFFFFFFFFFFFFFF for d in data]])
    return int(ss.generate_state(1, np.uint64)[0])


def generator(seed: int, *data: int) -> torch.Generator:
    """A CPU ``torch.Generator`` seeded with ``fold_in(seed, *data)``."""
    return torch.Generator().manual_seed(fold_in(seed, *data))
