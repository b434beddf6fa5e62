"""What a run loads and where it runs: no module of JAX, its libraries or
the JAX package (top-level names compared whole); a reference that
imports nothing of the program; no result without a card, or without the
program beside the benchmark."""

import json
import shutil
import subprocess
import sys

from benchmark import spec

ROOT = spec.ROOT


def _python(code: str, cwd=ROOT):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True,
                          text=True, timeout=600)


def test_a_run_loads_no_jax():
    code = (
        "import sys, torch\n"
        "from benchmark.run import run_cell, banned_modules\n"
        "from benchmark.tests.conftest import toy_cell\n"
        "run_cell(toy_cell('gpt2l.silo4.l256'), 5, 0.1, True, torch.device('cpu'))\n"
        "print(banned_modules())\n")
    out = _python(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_banned_names_are_compared_whole(monkeypatch):
    import types

    from benchmark import run

    for name in ("fedml_tpu_torch.core", "jaxtyping", "flax_like"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert not set(run.banned_modules()) & {"fedml_tpu", "jax", "flax"}
    monkeypatch.setitem(sys.modules, "jax._src", types.ModuleType("jax._src"))
    assert "jax" in run.banned_modules()


def test_reference_imports_nothing_of_the_program():
    code = (
        "import sys\n"
        "import benchmark.reference.resnet, benchmark.reference.transformer\n"
        "import benchmark.reference.fedavg, benchmark.reference.quant\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & {'fedml_tpu_torch', 'fedml_tpu', 'jax'}))\n")
    out = _python(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_result_without_a_card():
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "resnet56.silo10.b1024", "--seed", "1", "--seconds", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_result_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import torch\nfrom benchmark import spec\nfrom benchmark.run import run_cell\n"
            "run_cell(spec.load_cell('gpt2l.silo4.l256'), 1, 0.1, False, torch.device('cpu'))\n")
    out = _python(code, cwd=tmp_path)
    assert out.returncode != 0 and "fedml_tpu_torch" in out.stderr
    json.loads((tmp_path / "BENCHMARK.json").read_text())
