"""Staleness-weight math for the async buffered server (port of
``fedml_tpu/core/staleness.py``).

The synchronous barrier's stale firewall (``FedAvgServerManager
._is_stale``) rejects any upload whose echoed round is not the current
one.  FedBuff-style async aggregation keeps honest late work instead: an
upload computed against base round ``b`` folding into round ``r`` is
discounted by ``w(r - b)``, with the reject firewall kept as the hard
outer bound (``max_staleness``).

The JAX module is polymorphic over ``xp``; the server calls it with
``xp=np`` on its host fold path, and that is the form here: numpy
float64.

Exactness contract: ``w(0) == 1.0`` for every policy, and ``alpha = 0``
gives exactly 1.0 for every delta (``x ** 0 == 1.0`` in IEEE 754), which
is what the async-equals-sync byte identity rests on.
"""

from __future__ import annotations

import numpy as np

# staleness-weight policies the server accepts:
# - poly: w(d) = (1 + d)^-alpha, the FedBuff/FedAsync polynomial family;
#   alpha = 0 degenerates to w = 1 (the byte-identity arm)
# - const: w(d) = 1 inside the window, 0 beyond it
STALENESS_POLICIES = ("poly", "const")


def staleness_weight(delta, policy: str = "poly", *, alpha: float = 0.5,
                     window: int = 0):
    """Discount weight for an upload ``delta`` rounds stale (a scalar or
    an array of round gaps); negative deltas clamp to 0.  Values in
    [0, 1], ``w(0) == 1.0`` exactly, float64."""
    if policy not in STALENESS_POLICIES:
        raise ValueError(
            f"unknown staleness policy {policy!r} "
            f"(one of {STALENESS_POLICIES})"
        )
    d = np.maximum(np.asarray(delta, np.float64), 0.0)
    if policy == "const":
        return np.where(d <= float(window), 1.0, 0.0)
    if alpha < 0:
        raise ValueError(f"poly staleness alpha must be >= 0: {alpha!r}")
    return (1.0 + d) ** (-float(alpha))


def effective_weight(n, delta, policy: str = "poly", *, alpha: float = 0.5,
                     window: int = 0):
    """The fold weight of the streaming accumulator, ``w(delta) * n``;
    at ``w == 1.0`` the product is ``1.0 * n``, fp-exact."""
    w = staleness_weight(delta, policy, alpha=alpha, window=window)
    return w * np.asarray(n, np.float64)
