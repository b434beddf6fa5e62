"""A seeded model in the port is the JAX package's model: ``normal`` and
``truncated_normal`` through XLA's float32 ``erf_inv``/``log1p``/``log``,
flax's per-parameter keys (``_fold_in_static`` over scope path and rng
counter), and ``ModelBundle.init(PRNGKey(s))`` equal to flax's
``init(PRNGKey(s))`` for ResNet-56, the baseline ResNet-56, the
transformer and logistic regression, bit for bit (no ulp bound needed),
as is the starting model of ``FedAvgSimulation(seed=s)``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import scope as flax_scope
from jax import lax

import fedml_tpu.algorithms.fedavg as jfedavg
from fedml_tpu.data.synthetic import synthetic_classification as jsynthetic
from fedml_tpu.models.linear import logistic_regression as jlogistic
from fedml_tpu.models.resnet import resnet56 as jresnet56
from fedml_tpu.models.resnet_tpu import resnet56_tpu as jresnet56_tpu
from fedml_tpu.models.transformer import transformer_lm as jtransformer_lm
from fedml_tpu_torch.algorithms.fedavg import FedAvgConfig, FedAvgSimulation
from fedml_tpu_torch.core import rng
from fedml_tpu_torch.data.synthetic import synthetic_classification
from fedml_tpu_torch.models.base import fold_in_static, param_keys
from fedml_tpu_torch.models.convert import to_jax_variables
from fedml_tpu_torch.models.linear import logistic_regression
from fedml_tpu_torch.models.resnet import resnet56
from fedml_tpu_torch.models.resnet_tpu import resnet56_tpu
from fedml_tpu_torch.models.transformer import transformer_lm

TRANSFORMER = dict(vocab_size=96, embed_dim=32, num_heads=4, num_layers=2, seq_len=16)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a) -> bytes:
    return np.ascontiguousarray(np.asarray(a, np.float32)).tobytes()


def test_erf_constants_are_xlas():
    two = jnp.float32(2.0) / jnp.float32(np.sqrt(2))
    assert np.float32(lax.erf(two)) == np.float32(rng.ERF_2_SQRT2)
    assert np.float32(lax.erf(-two)) == np.float32(-rng.ERF_2_SQRT2)


@pytest.mark.parametrize("seed", [0, 1, 12345])
@pytest.mark.parametrize("shape", [(1 << 16,), (3, 3, 16, 16), (7,)])
def test_truncated_normal_is_jaxs(seed, shape):
    want = jax.random.truncated_normal(jax.random.PRNGKey(seed), -2, 2, shape, jnp.float32)
    got = rng.truncated_normal(rng.PRNGKey(seed), -2.0, 2.0, shape)
    assert got.dtype == torch.float32 and _bits(got) == _bits(want)


@pytest.mark.parametrize("seed", [0, 1, 12345])
@pytest.mark.parametrize("shape", [(1 << 16,), (96, 32)])
def test_normal_is_jaxs(seed, shape):
    """2^16 draws reach the tail branch (|x| > ~2.98, w >= 5) some 200 times."""
    want = jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32)
    got = rng.normal(rng.PRNGKey(seed), shape)
    assert _bits(got) == _bits(want)


def test_uniform_range_is_jaxs():
    key = jax.random.PRNGKey(4)
    want = jax.random.uniform(key, (4096,), jnp.float32, -0.75, 1.5)
    assert _bits(rng.uniform(rng.PRNGKey(4), (4096,), None, -0.75, 1.5)) == _bits(want)


def test_erf_inv_log1p_and_log_are_xlas():
    x = np.linspace(-1, 1, 200_001, dtype=np.float32)[1:-1]
    got = rng.erf_inv(torch.from_numpy(x.copy()))
    assert _bits(got) == _bits(lax.erf_inv(jnp.asarray(x)))
    y = np.linspace(-0.999, 4.0, 100_001, dtype=np.float32)
    assert _bits(rng.log1p_f32(torch.from_numpy(y.copy()))) == _bits(jnp.log1p(jnp.asarray(y)))
    z = np.geomspace(1e-30, 1e30, 100_001).astype(np.float32)
    assert _bits(rng.log_f32(torch.from_numpy(z.copy()))) == _bits(jnp.log(jnp.asarray(z)))


@pytest.mark.parametrize("data", [0, 5, 2**31 - 1, 2**31, 0xDEADBEEF, 2**32 - 1])
def test_fold_in_takes_uint32_data(data):
    key = jax.random.PRNGKey(9)
    want = jax.random.fold_in(key, jnp.uint32(data))
    assert rng.fold_in(rng.PRNGKey(9), data).tobytes() == np.asarray(want).tobytes()


@pytest.mark.parametrize("parts", [("Conv_0", 1), ("Bottleneck_3", "Conv_1", 2),
                                   ("wte", 1), ("Block_0", "MultiHeadAttention_0",
                                                "Dense_1", 1), ("Dense_0", 300)])
def test_fold_in_static_is_flaxs(parts):
    want = flax_scope._fold_in_static(jax.random.PRNGKey(3), parts)
    assert fold_in_static(rng.PRNGKey(3), parts).tobytes() == np.asarray(want).tobytes()


def test_param_keys_count_in_flax_creation_order():
    """kernel before bias and scale before bias within one scope, whatever
    order the port's module registers them in."""
    names = ["BatchNorm_0.bias", "BatchNorm_0.scale", "Dense_0.kernel", "Dense_0.bias"]
    keys = param_keys(rng.PRNGKey(0), names)
    for name, parts in (("BatchNorm_0.scale", ("BatchNorm_0", 1)),
                        ("BatchNorm_0.bias", ("BatchNorm_0", 2)),
                        ("Dense_0.kernel", ("Dense_0", 1)),
                        ("Dense_0.bias", ("Dense_0", 2))):
        assert keys[name].tobytes() == fold_in_static(rng.PRNGKey(0), parts).tobytes()
    with pytest.raises(ValueError, match="creation order"):
        param_keys(rng.PRNGKey(0), ["Conv_0.weight"])


def _assert_same_variables(port_vars, flax_vars):
    got = jax.tree_util.tree_flatten_with_path(to_jax_variables(port_vars))[0]
    want = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(np.asarray, flax_vars))[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == w.shape and _bits(g) == _bits(w), jax.tree_util.keystr(path)


@pytest.mark.parametrize("seed", [0, 3])
def test_resnet56_tpu_init_is_flaxs(seed):
    _assert_same_variables(resnet56_tpu(device="cpu").init(rng.PRNGKey(seed)),
                           jresnet56_tpu().init(jax.random.PRNGKey(seed)))


def test_baseline_resnet56_init_is_flaxs():
    _assert_same_variables(resnet56(device="cpu").init(rng.PRNGKey(1)),
                           jresnet56().init(jax.random.PRNGKey(1)))


@pytest.mark.parametrize("seed", [0, 5])
def test_transformer_init_is_flaxs(seed):
    _assert_same_variables(transformer_lm(**TRANSFORMER, device="cpu").init(rng.PRNGKey(seed)),
                           jtransformer_lm(**TRANSFORMER).init(jax.random.PRNGKey(seed)))


def test_logistic_regression_init_is_flaxs():
    _assert_same_variables(logistic_regression(784, 10, device="cpu").init(rng.PRNGKey(2)),
                           jlogistic(784, 10).init(jax.random.PRNGKey(2)))


@pytest.mark.parametrize("model", ["resnet56_tpu", "transformer"])
def test_simulation_starts_from_the_jax_simulations_model(model):
    """``FedAvgSimulation(..., seed=s)`` in both packages starts from the
    same variables (and key), so a seeded run compares end to end."""
    if model == "resnet56_tpu":
        kw = dict(num_train=40, num_test=8, input_shape=(32, 32, 3), num_clients=2, seed=0)
        port_b, jax_b = resnet56_tpu(device="cpu"), jresnet56_tpu()
        jds, tds = jsynthetic(**kw), synthetic_classification(**kw)
    else:
        port_b = transformer_lm(**TRANSFORMER, device="cpu")
        jax_b = jtransformer_lm(**TRANSFORMER)
        kw = dict(num_train=40, num_test=8, input_shape=(16,), num_classes=96,
                  num_clients=2, seed=0)
        jds, tds = jsynthetic(**kw), synthetic_classification(**kw)
    cfg = dict(num_clients=2, clients_per_round=2, comm_rounds=1, batch_size=8, seed=7)
    jsim = jfedavg.FedAvgSimulation(jax_b, jds, jfedavg.FedAvgConfig(**cfg))
    sim = FedAvgSimulation(port_b, tds, FedAvgConfig(**cfg), device="cpu")
    _assert_same_variables(sim.state.variables, jsim.state.variables)
    assert sim.state.key.tobytes() == np.asarray(jsim.state.key).tobytes()
