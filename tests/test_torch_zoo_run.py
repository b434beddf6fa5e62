"""The zoo through the port's normal entry point: ``experiments/run.py``
``main`` at ``--ci 1 --device cpu`` for every (dataset, model) pair of
the registry, with finite metrics and the multi-label record's
precision and recall; the femnist + cnn history (dropout, shuffled
local epochs) equal to the JAX ``run.main``'s within 1e-4; the registry
accepting every zoo pair and the five CIFAR ResNets, and still refusing
every name it has not ported."""

import math

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.experiments import registry as jregistry
from fedml_tpu.experiments import run as jrun
from fedml_tpu_torch.experiments import registry, run

PAIRS = [
    ("mnist", "lr"),
    ("femnist", "cnn"),
    ("fed_cifar100", "resnet18_gn"),
    ("shakespeare", "rnn"),
    ("fed_shakespeare", "rnn"),
    ("stackoverflow_nwp", "rnn"),
    ("stackoverflow_lr", "lr"),
]
METRICS = ("loss_sum", "correct", "count", "steps", "participants", "train_acc",
           "train_loss", "test_acc", "test_loss", "test_count")


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _main(mod, dataset, model, run_dir, *extra):
    return mod.main(["--dataset", dataset, "--model", model, "--ci", "1",
                     "--run_dir", str(run_dir), *extra])


@pytest.mark.parametrize("dataset,model", PAIRS, ids=[f"{d}-{m}" for d, m in PAIRS])
def test_run_main_trains_each_zoo_pair_on_the_cpu(tmp_path, dataset, model):
    out = _main(run, dataset, model, tmp_path, "--device", "cpu")
    final = out["final"]
    assert len(out["history"]) == 2
    for k in ("train_loss", "test_loss", "test_acc"):
        assert math.isfinite(final[k]), (k, final)
    assert final["count"] > 0 and final["test_count"] > 0
    multi_label = dataset == "stackoverflow_lr"
    assert ("test_precision" in final) == ("test_recall" in final) == multi_label
    if multi_label:
        assert 0.0 <= final["test_precision"] <= 1.0 and 0.0 <= final["test_recall"] <= 1.0
    assert (tmp_path / "metrics.jsonl").exists()


def test_femnist_cnn_history_is_the_jax_run(tmp_path):
    """Dropout masks, shuffles and rounds on JAX's streams: both entry
    points' per-round records agree."""
    extra = ("--frequency_of_the_test", "1")
    want = _main(jrun, "femnist", "cnn", tmp_path / "jax", *extra)["history"]
    got = _main(run, "femnist", "cnn", tmp_path / "port", "--device", "cpu", *extra)["history"]
    assert len(got) == len(want) == 2
    for r, (g, w) in enumerate(zip(got, want)):
        for k in METRICS:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-4,
                                       err_msg=f"round {r} {k}")


def _same_model(bundle, jbundle):
    """Same module class, input spec, dropout contract and parameter count."""
    assert type(bundle.module).__name__ == type(jbundle.module).__name__
    assert tuple(bundle.input_shape) == tuple(jbundle.input_shape)
    assert bundle.needs_dropout_rng == jbundle.needs_dropout_rng
    jparams = jax.eval_shape(jbundle.init, jax.random.PRNGKey(0))["params"]
    assert (sum(p.numel() for p in bundle.module.parameters())
            == sum(int(np.prod(v.shape)) for v in jax.tree_util.tree_leaves(jparams)))


@pytest.mark.parametrize("model", ["resnet20", "resnet32", "resnet44", "resnet56", "resnet110"])
def test_registry_routes_the_cifar_resnets(model):
    _same_model(registry.create_model(model, "cifar10", 10, device="cpu"),
                jregistry.create_model(model, "cifar10", 10))


@pytest.mark.parametrize("dataset,model", PAIRS, ids=[f"{d}-{m}" for d, m in PAIRS])
def test_registry_builds_the_jax_registrys_model(dataset, model):
    """The JAX registry's choice for the pair, on the loader's shapes, and
    its task loss."""
    ds = registry.load_data(dataset, num_clients=3)
    shape = tuple(ds.train_x.shape[1:])
    _same_model(registry.create_model(model, dataset, ds.num_classes, input_shape=shape,
                                      device="cpu"),
                jregistry.create_model(model, dataset, ds.num_classes, input_shape=shape))
    assert (registry.task_loss_for_dataset(dataset).__name__
            == jregistry.task_loss_for_dataset(dataset).__name__)


@pytest.mark.parametrize("kind,name", [
    ("dataset", "cifar100"), ("dataset", "cinic10"), ("dataset", "synthetic"),
    ("model", "mobilenet"), ("model", "mobilenet_v3"), ("model", "vgg11"),
    ("model", "efficientnet"),
])
def test_registry_still_refuses_the_rest_of_the_zoo(kind, name):
    with pytest.raises(NotImplementedError, match="queue A item 3"):
        if kind == "dataset":
            registry.load_data(name, data_dir="no-such-dir")
        else:
            registry.create_model(name, "cifar10", 10, input_shape=(32, 32, 3), device="cpu")
