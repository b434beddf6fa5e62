"""The cross-silo image zoo through the port's normal entry point:
``experiments/run.py::main`` FedAvg at ``--device cpu`` for MobileNet on
CIFAR-100 (crop, flip and Cutout(16)) and ResNet-56 on CINIC-10 (crop and
flip, no Cutout), full width, 2 clients of 16 stand-in samples, one round
at SGD lr 1e-4, whose history equals the JAX ``run.main``'s within 1e-4;
and the registry's VGG and EfficientNet bundles equal to the JAX registry's
(module, input spec, dropout contract, parameter shapes on ``meta``),
kept out of ``run.main`` on the CPU because the port's CPU init of VGG's
134M values takes minutes.

Why lr 1e-4 and not the cross-silo benchmark's 1e-3: at 1e-3 the first
step of a fresh full-width BatchNorm net moves the loss by ~1.4% and the
float32 round is chaotic (ResNet-56's ``loss_sum`` parts by 2.6e-3
between the two runs, MobileNet's by 4.8e-4; at lr 0 they agree within
2e-6, so data, augmentation and shuffles are the same).  At 1e-4 they
agree within 8.2e-6 and 2.7e-5.  ``tests/test_torch_silo_models.py``
holds the port's float32 round at lr 1e-3 to JAX's float64 one.
"""

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.experiments import registry as jregistry
from fedml_tpu.experiments import run as jrun
from fedml_tpu_torch.experiments import registry, run
from test_torch_zoo_run import METRICS

SILO_ARGV = ["--client_num_in_total", "2", "--client_num_per_round", "2",
             "--comm_round", "1", "--batch_size", "8", "--max_samples_per_client", "16",
             "--max_test_samples", "32", "--lr", "0.0001", "--wd", "0.001",
             "--partition_method", "hetero", "--partition_alpha", "0.5",
             "--frequency_of_the_test", "1"]


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dataset,model", [("cifar100", "mobilenet"), ("cinic10", "resnet56")])
def test_run_main_history_is_the_jax_run(tmp_path, dataset, model):
    """Augmented, shuffled rounds on JAX's streams: both entry points'
    per-round records agree."""
    argv = ["--dataset", dataset, "--model", model, *SILO_ARGV]
    want = jrun.main([*argv, "--run_dir", str(tmp_path / "jax")])["history"]
    got = run.main([*argv, "--run_dir", str(tmp_path / "port"), "--device", "cpu"])["history"]
    assert len(got) == len(want) == 1
    for r, (g, w) in enumerate(zip(got, want)):
        assert g["test_count"] == w["test_count"] == 32
        for k in METRICS:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-4,
                                       err_msg=f"round {r} {k}")


@pytest.mark.parametrize("model", ["vgg11", "vgg16_bn", "vgg19_bn", "efficientnet",
                                   "mobilenet", "mobilenet_v3"])
@pytest.mark.parametrize("dataset", ["cifar100", "cinic10"])
def test_registry_bundles_are_jaxs(dataset, model):
    ds = registry.load_data(dataset, "no-such-dir", num_clients=2)
    shape = tuple(ds.train_x.shape[1:])
    tb = registry.create_model(model, dataset, ds.num_classes, input_shape=shape,
                               device="meta")
    jb = jregistry.create_model(model, dataset, ds.num_classes, input_shape=shape)
    assert type(tb.module).__name__ == type(jb.module).__name__
    assert tuple(tb.input_shape) == tuple(jb.input_shape) == (32, 32, 3)
    assert tb.needs_dropout_rng == jb.needs_dropout_rng
    jshapes = jax.eval_shape(jb.init, jax.random.PRNGKey(0))
    want = {"/".join(k.key for k in p): tuple(v.shape)
            for p, v in jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    got = {f"params/{n.replace('.', '/')}": tuple(p.shape)
           for n, p in tb.module.named_parameters()}
    got.update({f"batch_stats/{n.replace('.', '/')}": tuple(b.shape)
                for n, b in tb.module.named_buffers()})
    assert got == want
