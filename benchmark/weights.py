"""Initial variables made from ``--seed`` on the device: one draw of
standard normals for every randomly initialised leaf, in one call, each
leaf a scaled view of it; ones and zeros where the rule says so.  The
program and the reference are handed variables made by this one
function from the same seed."""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from benchmark.generator import stream_seed

# (leaf name, shape) -> ("normal", std) | ("ones",) | ("zeros",)
InitRule = Callable[[str, Tuple[int, ...]], tuple]


def make_variables(shapes: Dict[str, Dict[str, Tuple[int, ...]]], rule: InitRule,
                   seed: int, device: torch.device) -> Dict[str, Dict[str, torch.Tensor]]:
    plan = [(group, name, tuple(shape), rule(name, tuple(shape)))
            for group in sorted(shapes) for name, shape in sorted(shapes[group].items())]
    total = sum(int(np.prod(s)) for _, _, s, r in plan if r[0] == "normal")
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, 2))
    flat = torch.randn(total, generator=g, device=device)
    out: Dict[str, Dict[str, torch.Tensor]] = {group: {} for group in shapes}
    off = 0
    for group, name, shape, r in plan:
        if r[0] == "normal":
            n = int(np.prod(shape))
            out[group][name] = flat[off:off + n].view(shape).mul_(r[1])
            off += n
        elif r[0] == "ones":
            out[group][name] = torch.ones(shape, device=device)
        else:
            out[group][name] = torch.zeros(shape, device=device)
    return out
