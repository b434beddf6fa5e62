"""One run of each cell at toy size on the CPU, past the harness's look
for a card: the result line's shape, both with and without the trace, and
the planted faults of ``faults.py`` coming out as not ``correct``."""

import json
import math

import pytest
import torch

from benchmark import faults, spec
from benchmark.run import run_cell
from benchmark.tests.conftest import TOY_SEED, toy_cell

CELLS = [w["name"] for w in json.loads((spec.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_dry_run(name, trace):
    cell = toy_cell(name, dtype=spec.load_cell(name).cfg["compute_dtype"])
    r = run_cell(cell, TOY_SEED, 0.2, bool(trace), torch.device("cpu"))
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    # the device's readers find nothing to read on the CPU and stay silent
    assert set(r["metrics"]) <= want
    if not trace:
        assert set(r["metrics"]) == want
    for m in r["metrics"].values():
        assert math.isfinite(m["value"])
    assert set(r["checks"]) == set(cell.limits["limits"])
    json.dumps(r)


@pytest.mark.parametrize("name", CELLS)
def test_sound_float32_run_is_correct(name):
    """In float32 at toy size the program reads below every limit (the
    toy ResNet takes one step a client: its later steps are chaotic)."""
    cell = toy_cell(name)
    if cell.cfg["family"] == "resnet_cifar":
        cell.traffic.update(samples=48, batch_size=32)
    r = run_cell(cell, TOY_SEED, 0.2, False, torch.device("cpu"))
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch"])
@pytest.mark.parametrize("name", CELLS)
def test_broken_run_is_not_correct(name, fault):
    cell = toy_cell(name, dtype=spec.load_cell(name).cfg["compute_dtype"])
    r = run_cell(cell, TOY_SEED, 0.2, False, torch.device("cpu"),
                 loss_wrap=faults.LOSS_FAULTS.get(fault),
                 round_wrap=faults.ROUND_FAULTS.get(fault))
    assert not r["correct"], r["checks"]
