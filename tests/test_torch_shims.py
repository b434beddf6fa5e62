"""Script mode of the port's entry shims (``fedml_tpu_torch/experiments/
main_*.py``): run as ``python fedml_tpu_torch/experiments/main_fedavg.py``
from outside the repo root, a shim finds its package through
``experiments/_bootstrap.py``, as the JAX package's shims do; every shim
carries the same ``__package__`` guard."""

import pathlib
import subprocess
import sys

import pytest

EXPERIMENTS = pathlib.Path(__file__).resolve().parents[1] / "fedml_tpu_torch" / "experiments"
SHIMS = sorted(p.name for p in EXPERIMENTS.glob("main_*.py"))
GUARD = 'if __package__ in (None, ""):  # run as a script: _bootstrap fixes sys.path\n'


def test_main_fedavg_help_from_outside_the_repo(tmp_path):
    out = subprocess.run([sys.executable, str(EXPERIMENTS / "main_fedavg.py"), "--help"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("usage: main_fedavg.py")
    assert "--client_num_in_total" in out.stdout


@pytest.mark.parametrize("shim", SHIMS)
def test_every_shim_carries_the_script_mode_guard(shim):
    text = (EXPERIMENTS / shim).read_text()
    jax_text = (EXPERIMENTS.parents[1] / "fedml_tpu" / "experiments" / shim).read_text()
    assert GUARD in text and GUARD in jax_text
    assert text.index(GUARD) < text.index("from fedml_tpu_torch.experiments.run import main")
