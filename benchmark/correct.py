"""How ``correct`` is decided: the program's first rounds against the
plain float32 reference following the same rounds from the same
variables, data and draws.

Numbers a cell may compare, each against its limit in
``limits/<cell>.json`` (the cell's file names those it compares):

- ``loss_gap``: over the rounds followed, the largest
  ``|loss_program − loss_reference| / |loss_reference|`` of a round's mean
  training loss;
- ``change<r>_gap``: the change of the global variables after round ``r``
  (round 1's is what the server's update is handed, FedAvg's
  pseudo-gradient; the other is the last round followed), by the worst
  leaf: ``|‖Δ_program‖ − ‖Δ_reference‖|`` over the larger of the
  reference's ``‖Δ‖`` of that leaf and of the median leaf;
- ``change<r>_mean_gap``: the same gap, averaged over the leaves: steady
  from seed to seed where the worst leaf swings, and it sees a shift
  spread over many small leaves, which the median leaf does not;
- ``count_gap``: over the rounds followed, the largest
  ``|count_program − count_reference| / count_reference`` of the samples
  (tokens) a round trained on, an exact comparison.

Leaves whose round-1 change in the reference is under a thousandth of the
median leaf's are left out: round-off alone moves them.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

KEEP_SHARE = 1e-3


def change_norms(new, old) -> Dict[str, float]:
    """Per leaf (``group/name``), ``‖new − old‖`` in float64."""
    out = {}
    for g, leaves in old.items():
        for n, t in leaves.items():
            out[f"{g}/{n}"] = float(torch.linalg.vector_norm(new[g][n].double() - t.double()))
    return out


def kept_leaves(ref_first: Dict[str, float]) -> List[str]:
    med = float(np.median(list(ref_first.values())))
    return [k for k, v in ref_first.items() if v >= KEEP_SHARE * med]


def leaf_detail(prog: dict, ref: dict, top: int = 6) -> Dict[str, list]:
    """Per change compared, its worst leaves ``[leaf, gap, ‖Δ_program‖,
    ‖Δ_reference‖]`` and the median leaf's gap (calibration's look)."""
    keep = kept_leaves(ref["change"][1])
    out = {}
    for r in sorted(ref["change"]):
        p, q = prog["change"][r], ref["change"][r]
        gaps = sorted(zip(leaf_gaps(p, q, keep), keep), reverse=True)
        out[f"change{r}"] = {"median_leaf_gap": float(np.median([g for g, _ in gaps])),
                             "kept": len(keep), "of": len(q),
                             "worst": [[k, g, p[k], q[k]] for g, k in gaps[:top]]}
    return out


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep: List[str]) -> List[float]:
    med = float(np.median([ref[k] for k in keep]))
    return [abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep]


def compare(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers a cell may compare, from two sets of readings
    ``{"loss": [...], "count": [...], "change": {round: {leaf: norm}}}``."""
    out = {"loss_gap": max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"])),
           "count_gap": max(abs(p - r) / r for p, r in zip(prog["count"], ref["count"]))}
    keep = kept_leaves(ref["change"][1])
    for r in sorted(ref["change"]):
        gaps = leaf_gaps(prog["change"][r], ref["change"][r], keep)
        out[f"change{r}_gap"] = max(gaps)
        out[f"change{r}_mean_gap"] = float(np.mean(gaps))
    return out


def checks(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    return {k: {"value": numbers[k], "limit": limits[k]} for k in limits}


def passed(checked: Dict[str, dict]) -> bool:
    return all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checked.values())


def program_readings(sim, w0, rounds: int) -> dict:
    """The program's losses and changes over its first ``rounds`` rounds
    (``FedAvgSimulation.run_round``, as the window calls it) from ``w0``."""
    out = {"loss": [], "count": [], "change": {}}
    for r in range(rounds):
        row = sim.run_round()
        sim.metrics.pop_spans()
        out["loss"].append(row["train_loss"])
        out["count"].append(row["count"])
        if r == 0 or r == rounds - 1:
            out["change"][r + 1] = change_norms(sim.state.variables, w0)
    return out


def reference_readings(family, cfg, traffic, data, seed: int, device, rounds: int,
                       precision: str = "fp32", dtype: torch.dtype = torch.float32) -> dict:
    """The reference's losses and changes over the first ``rounds`` rounds,
    from variables it makes itself from the seed.  Float32 with TF32 off;
    ``precision="fp8"`` is the control; ``dtype=torch.float64`` (the
    tests') computes in float64."""
    from benchmark import weights
    from benchmark.generator import packed_steps
    from benchmark.reference import fedavg, quant

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    w0 = weights.make_variables(family.variable_shapes(cfg), family.init_rule, seed, device)
    w0 = {g: {k: t.to(dtype) for k, t in leaves.items()} for g, leaves in w0.items()}
    model = family.reference_model(cfg, traffic, quant.operand_rounding(precision))
    aug = traffic.get("augment")
    augment = None
    if aug:
        def augment(key, x):
            return fedavg.image_augment(key, x, aug["pad"], aug["flip"], aug["cutout"])
    opt = cfg["optimizer"]
    from benchmark.generator import packed_steps
    steps = packed_steps(data, traffic["batch_size"])
    clients = sorted(data.train_client_idx)
    out = {"loss": [], "count": [], "change": {}}
    v = w0
    for r in range(rounds):
        v, loss, count = fedavg.fedavg_round(model, v, data, clients, r, seed,
                                             traffic["batch_size"], steps, opt,
                                             traffic["epochs"], augment)
        out["loss"].append(loss)
        out["count"].append(count)
        if r == 0 or r == rounds - 1:
            out["change"][r + 1] = change_norms(v, w0)
    return out
