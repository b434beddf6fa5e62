"""The control: the reference computed one precision step below the
configuration's bf16 (fp8, as the cell's limits name), put in the program's place, is not
``correct`` under the cell's limits.  At toy size on the CPU here; at the
cell's own size on the card in the ``gpu`` test (``python -m pytest -m gpu
benchmark/tests`` on the card)."""

import json

import pytest
import torch

from benchmark import calibrate, correct, spec
from benchmark.tests.conftest import TOY_SEED, toy_cell

CELLS = [w["name"] for w in json.loads((spec.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct_at_toy_size(name):
    cell = toy_cell(name)
    numbers = calibrate.readings(cell, TOY_SEED, ["control"], torch.device("cpu"))["control"]
    assert not correct.passed(correct.checks(numbers, cell.limits["limits"])), numbers


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct_at_cell_size(name):
    if not torch.cuda.is_available():
        pytest.skip("the control at the cell's size runs on a CUDA card")
    cell = spec.load_cell(name)
    numbers = calibrate.readings(cell, 4242, ["control"], torch.device("cuda", 0))["control"]
    assert not correct.passed(correct.checks(numbers, cell.limits["limits"])), numbers
