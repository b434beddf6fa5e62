"""Package-level contracts of the port (``fedml_tpu_torch``): it never
imports JAX or the JAX package, its entry points refuse to fall back to
the CPU silently, and its variable converter round-trips the flax tree."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.models.base import ModelBundle as JBundle
from fedml_tpu.models.resnet import Bottleneck as JBottleneck
from fedml_tpu.models.resnet import CifarResNet as JCifarResNet

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "fedml_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]

_CPU_ROUND = r"""
import sys
import numpy as np
import torch
from fedml_tpu_torch.algorithms.fedavg import FedAvgConfig, FedAvgSimulation
from fedml_tpu_torch.data.cifar import load_cifar10
from fedml_tpu_torch.models.resnet_tpu import resnet56_tpu

ds = load_cifar10(data_dir="no-such-dir", num_clients=2)
for c in ds.train_client_idx:
    ds.train_client_idx[c] = ds.train_client_idx[c][:8]
ds.test_x, ds.test_y = ds.test_x[:8], ds.test_y[:8]
cfg = FedAvgConfig(num_clients=2, clients_per_round=2, comm_rounds=1,
                   batch_size=8, lr=0.01, momentum=0.9, weight_decay=1e-3,
                   compute_dtype="bf16")
row = FedAvgSimulation(resnet56_tpu(device="cpu"), ds, cfg, device="cpu").run()[-1]
assert np.isfinite(row["train_loss"]) and np.isfinite(row["test_loss"]), row
import tempfile
import fedml_tpu_torch.bench  # noqa: F401  (imported so the check below covers it)
import fedml_tpu_torch.core.checkpoint  # noqa: F401
import fedml_tpu_torch.data.augment  # noqa: F401
import fedml_tpu_torch.compress  # noqa: F401
import fedml_tpu_torch.models.linear  # noqa: F401
import fedml_tpu_torch.native  # noqa: F401
from fedml_tpu_torch.experiments import run
with tempfile.TemporaryDirectory() as d:
    out = run.main(["--algorithm", "fedllm", "--dataset", "fed_shakespeare",
                    "--device", "cpu", "--ci", "1", "--comm_round", "1", "--run_dir", d])
assert np.isfinite(out["final"]["train_loss"]), out
bad = [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "fedml_tpu."))]
assert not bad, bad
print("OK", row["train_loss"])
"""


def test_port_runs_a_round_without_jax_in_a_fresh_process():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _CPU_ROUND], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.splitlines()[-1].startswith("OK")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_port_sources_import_neither_jax_nor_the_jax_package(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax", "fedml_tpu"), (
                f"{path}: imports {name}")


def test_default_device_entry_points_raise_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    from fedml_tpu_torch.algorithms.fedavg import (
        FedAvgConfig, FedAvgSimulation, make_multi_round_fn, make_round_fn)
    from fedml_tpu_torch.core.client import make_client_optimizer, make_local_update
    from fedml_tpu_torch.data.synthetic import synthetic_classification
    from fedml_tpu_torch.models.convert import from_jax_variables
    from fedml_tpu_torch.models.resnet import resnet20, resnet56
    from fedml_tpu_torch.models.resnet_tpu import resnet56_tpu

    for factory in (resnet20, resnet56, resnet56_tpu):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            factory()
    bundle = resnet56_tpu(device="cpu")
    lu = make_local_update(bundle, make_client_optimizer(), 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_round_fn(lu)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_multi_round_fn(lu, 2)
    ds = synthetic_classification(num_train=20, num_test=4,
                                  input_shape=(32, 32, 3), num_clients=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FedAvgSimulation(bundle, ds, FedAvgConfig(num_clients=2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_jax_variables({"params": {}})

    from fedml_tpu_torch.bench import build_fedllm
    from fedml_tpu_torch.experiments import run
    from fedml_tpu_torch.models.transformer import transformer_lm

    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer_lm()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_fedllm(embed_dim=16, num_heads=2, num_layers=1, seq_len=16, vocab=32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run.run_experiment(run.ExperimentConfig(
            algorithm="fedllm", dataset="fed_shakespeare", ci=1))

    # the rest of the algorithm family: the entry point, the shims'
    # ``main`` and the model factories
    from fedml_tpu_torch.models.cnn import cnn_split_pair
    from fedml_tpu_torch.models.darts.genotypes import DARTS_V2
    from fedml_tpu_torch.models.darts.network import darts_network
    from fedml_tpu_torch.models.darts.search import darts_search
    from fedml_tpu_torch.models.finance import vfl_party

    for algo in ("splitnn", "vfl", "fednas"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run.main(["--algorithm", algo, "--ci", "1", "--run_dir", str(tmp_path)])
    for factory in (lambda: cnn_split_pair(10, (28, 28, 1)), lambda: vfl_party(4, 2),
                    lambda: darts_search(C=4, layers=2, steps=2, multiplier=2),
                    lambda: darts_network(DARTS_V2, C=4, layers=2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            factory()


def test_converter_round_trips_the_flax_tree():
    from fedml_tpu_torch.models.convert import from_jax_variables, to_jax_variables

    jb = JBundle(module=JCifarResNet(block=JBottleneck, layers=(1, 1, 1)),
                 input_shape=(8, 8, 3))
    tree = jax.tree_util.tree_map(np.asarray, jb.init(jax.random.PRNGKey(3)))
    tv = from_jax_variables(tree, device="cpu")
    assert tv["params"]["Bottleneck_2.Conv_1.kernel"].shape == (3, 3, 64, 64)
    assert tv["batch_stats"]["BatchNorm_0.mean"].shape == (16,)
    back = to_jax_variables(tv)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda a: a, tree)))
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
