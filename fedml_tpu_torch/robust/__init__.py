"""Byzantine-robust + private aggregation for the cross-device hot path
(port of ``fedml_tpu/robust``).

``defense`` holds the server-side half: ``DefenseConfig`` (the knob
set), ``RobustAggregator`` (per-upload screening + per-connection
contribution caps + buffered robust close), and the connection-cap
water-filling math.  The defense FORMULAS themselves live in
``fedml_tpu_torch.core.robust``: its numpy form (``xp=np``) here, its
torch form in the simulation layer's ``make_robust_transform`` hook.
"""

from fedml_tpu_torch.robust.defense import (
    DEFENSES,
    DefenseConfig,
    RobustAggregator,
    cap_connection_weights,
)

__all__ = [
    "DEFENSES",
    "DefenseConfig",
    "RobustAggregator",
    "cap_connection_weights",
]
