"""Error-feedback residual state, host side (port of
``fedml_tpu/compress/error_feedback.py``).

Lossy codecs bias the aggregate: the server reconstructs
``decode(encode(update))``, and each round's quantization or
sparsification error would otherwise be lost.  Error feedback (Seide et
al. 2014; Karimireddy et al. 2019) keeps it: the client carries

    residual_{t+1} = (update_t + residual_t) - decode(encode(update_t + residual_t))

and folds it into the next round's update.  This class is that
recurrence for one participant's update stream; the round engine threads
the same recurrence through ``ServerState.residuals``
(``algorithms/fedavg.py::make_round_fn``).
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from fedml_tpu_torch.core.tree import tree_map

Tree = Any


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).float()


class ErrorFeedback:
    """Residual accumulator for ONE participant's update stream."""

    def __init__(self):
        self._residual: Optional[Tree] = None

    def fold_in(self, delta: Tree) -> Tree:
        """``delta + residual`` in fp32; the identity on the first round."""
        if self._residual is None:
            return tree_map(_f32, delta)
        return tree_map(lambda d, r: _f32(d) + r, delta, self._residual)

    def absorb(self, folded: Tree, decoded: Tree) -> None:
        """Store ``folded − decoded``: the error the wire dropped."""
        self._residual = tree_map(lambda f, d: _f32(f) - _f32(d), folded, decoded)

    def reset(self) -> None:
        self._residual = None
