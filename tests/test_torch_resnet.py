"""The port's ResNets (``fedml_tpu_torch/models/resnet.py`` with library
convs, ``resnet_tpu.py`` with the kernel convs and its space-to-depth and
lane-padding variants) held against the JAX package's ``CifarResNet`` and
``CifarResNetTPU`` (``conv_variant="pallas"``, Pallas in interpret mode;
``s2d_stages`` 1/2/3 and ``pad_stage1_to=32`` on XLA's convs), Bottleneck
(2,2,2), with the flax variables carried across by ``models/convert.py``;
the five s2d helpers bit for bit JAX's.

Tolerances: eval logits rtol 2e-4 / atol 2e-5, train loss rtol 1e-5 and
batch_stats rtol 2e-4 / atol 1e-5 (those of
``tests/test_resnet_tpu.py``); grads rtol/atol 1e-3, because the JAX
package's own two conv paths differ by 6.0e-4 on a gradient in fp32
summation order.  bf16 compute at ``test_conv_mxu._tols(bf16)``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.models.base import ModelBundle as JBundle
from fedml_tpu.models.resnet import BasicBlock as JBasicBlock
from fedml_tpu.models.resnet import Bottleneck as JBottleneck
from fedml_tpu.models.resnet import CifarResNet as JCifarResNet
from fedml_tpu.models import resnet_tpu as jresnet_tpu
from fedml_tpu.models.resnet_tpu import CifarResNetTPU as JCifarResNetTPU
from fedml_tpu_torch.core.rng import PRNGKey
from fedml_tpu_torch.core.tree import tree_cast_floats
from fedml_tpu_torch.models.base import ModelBundle
from fedml_tpu_torch.models.convert import from_jax_variables
from fedml_tpu_torch.models.resnet import BasicBlock, Bottleneck, CifarResNet
from fedml_tpu_torch.models import resnet_tpu
from fedml_tpu_torch.models.resnet_tpu import CifarResNetTPU, resnet56_tpu

LAYERS = (2, 2, 2)
HW = 16
CPU = torch.device("cpu")


# resnet_tpu's space-to-depth and lane-padding variants (XLA's convs in JAX,
# library convs in the port)
TPU_VARIANTS = {"s2d1": {"s2d_stages": 1}, "s2d2": {"s2d_stages": 2},
                "s2d3": {"s2d_stages": 3}, "pad32": {"pad_stage1_to": 32}}


def _models(variant):
    if variant == "baseline":
        jm = JCifarResNet(block=JBottleneck, layers=LAYERS, num_classes=10)
        tm = CifarResNet(Bottleneck, LAYERS, 10)
    elif variant == "kernel":
        jm = JCifarResNetTPU(layers=LAYERS, num_classes=10, conv_variant="pallas")
        tm = CifarResNetTPU(LAYERS, 10, conv_variant="kernel")
    else:
        kw = TPU_VARIANTS[variant]
        jm = JCifarResNetTPU(layers=LAYERS, num_classes=10, conv_variant="xla", **kw)
        tm = CifarResNetTPU(LAYERS, 10, conv_variant="xla", **kw)
    return (JBundle(module=jm, input_shape=(HW, HW, 3)),
            ModelBundle(module=tm, input_shape=(HW, HW, 3), device=CPU))


@pytest.fixture(scope="module")
def setup():
    jb, _ = _models("baseline")
    jvars = jb.init(jax.random.PRNGKey(0))
    # non-trivial BN state so eval mode exercises the running stats
    rng = np.random.RandomState(5)
    jvars = jax.tree_util.tree_map(np.array, jvars)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jvars["batch_stats"])[0]:
        leaf[...] = (rng.uniform(0.5, 1.5, leaf.shape) if path[-1].key == "var"
                     else rng.normal(0, 0.1, leaf.shape)).astype(np.float32)
    x = rng.standard_normal((4, HW, HW, 3)).astype(np.float32)
    y = np.arange(4) % 10
    return jvars, x, y


def _jax_train(jb, jvars, x, y, dtype=None):
    def f(params):
        v = {**jvars, "params": params}
        if dtype is not None:
            v = jax.tree_util.tree_map(lambda a: a.astype(dtype), v)
        logits, newv = jb.apply_train(v, jnp.asarray(x, dtype or jnp.float32))
        logp = jax.nn.log_softmax(logits.astype(jnp.float32))
        loss = -jnp.take_along_axis(logp, jnp.asarray(y)[:, None], 1).mean()
        return loss, (logits, newv)
    (loss, (logits, newv)), g = jax.value_and_grad(f, has_aux=True)(jvars["params"])
    return loss, logits, newv, g


def _torch_train(tb, tvars, x, y, dtype=None):
    params = {k: v.clone().requires_grad_(True) for k, v in tvars["params"].items()}
    v = {**tvars, "params": params}
    xt = torch.from_numpy(x)
    if dtype is not None:
        v, xt = tree_cast_floats(v, dtype), xt.to(dtype)
    logits, newv = tb.apply_train(v, xt)
    loss = torch.nn.functional.cross_entropy(logits.float(), torch.from_numpy(y))
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), logits.detach(), newv, dict(zip(params, grads))


def _flat(tree):
    return {".".join(p.key for p in path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("variant", ["baseline", "kernel"])
def test_same_variable_tree_as_flax(variant, setup):
    jvars, _, _ = setup
    _, tb = _models(variant)
    tvars = tb.init(PRNGKey(0))
    for coll in ("params", "batch_stats"):
        jflat = _flat(jvars[coll])
        assert set(tvars[coll]) == set(jflat)
        for k, v in tvars[coll].items():
            assert tuple(v.shape) == jflat[k].shape, k


@pytest.mark.parametrize("variant", ["baseline", "kernel", *TPU_VARIANTS])
def test_matches_jax_fp32(variant, setup):
    jvars, x, y = setup
    jb, tb = _models(variant)
    tvars = from_jax_variables(jvars, device="cpu")

    with torch.no_grad():
        got = tb.apply_eval(tvars, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jb.apply_eval(jvars, jnp.asarray(x))),
                               rtol=2e-4, atol=2e-5)

    jl, _, jnew, jg = _jax_train(jb, jvars, x, y)
    tl, _, tnew, tg = _torch_train(tb, tvars, x, y)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    jstats = _flat(jnew["batch_stats"])
    for k, v in tnew["batch_stats"].items():
        np.testing.assert_allclose(v.detach().numpy(), jstats[k],
                                   rtol=2e-4, atol=1e-5, err_msg=k)
    jgrads = _flat(jg)
    for k, v in tg.items():
        np.testing.assert_allclose(v.numpy(), jgrads[k], rtol=1e-3, atol=1e-3,
                                   err_msg=k)


@pytest.mark.parametrize("variant", ["baseline", "kernel"])
def test_matches_jax_bf16_compute(variant, setup):
    """Mixed precision: variables (params AND batch_stats) and input cast
    to bf16 on both sides, as the local update does."""
    jvars, x, y = setup
    jb, tb = _models(variant)
    tvars = from_jax_variables(jvars, device="cpu")
    jl, jlogits, jnew, _ = _jax_train(jb, jvars, x, y, jnp.bfloat16)
    tl, tlogits, tnew, _ = _torch_train(tb, tvars, x, y, torch.bfloat16)
    tol = {"rtol": 5e-2, "atol": 5e-2}
    assert tlogits.dtype == torch.bfloat16
    np.testing.assert_allclose(tlogits.detach().float().numpy(),
                               np.asarray(jlogits, np.float32), **tol)
    np.testing.assert_allclose(float(tl), float(jl), **tol)
    jstats = _flat(jnew["batch_stats"])
    for k, v in tnew["batch_stats"].items():
        np.testing.assert_allclose(v.detach().float().numpy(), jstats[k],
                                   err_msg=k, **tol)


def test_kernel_variant_refuses_tpu_tilings():
    """JAX's two ValueErrors (``resnet_tpu.py:355-367``): s2d with lane
    padding, and the kernel route (JAX's "pallas") with either transform;
    and a conv variant neither package has."""
    for kw in ({"s2d_stages": 1, "pad_stage1_to": 32, "conv_variant": "xla"},
               {"s2d_stages": 1, "conv_variant": "kernel"},
               {"pad_stage1_to": 32, "conv_variant": "kernel"}):
        jkw = {**kw, "conv_variant": "pallas" if kw["conv_variant"] == "kernel" else "xla"}
        jb = JBundle(module=JCifarResNetTPU(layers=(1, 1, 1), num_classes=10, **jkw),
                     input_shape=(HW, HW, 3))
        with pytest.raises(ValueError):
            jb.init(jax.random.PRNGKey(0))
        with pytest.raises(ValueError):
            resnet56_tpu(device="cpu", **kw)
    with pytest.raises(ValueError):
        resnet56_tpu(device="cpu", conv_variant="pallas")


def test_s2d_helpers_bitwise_jax():
    """``space_to_depth``, ``depth_to_space`` and the three kernel
    re-scatters equal JAX's bit for bit (they only move values)."""
    rng = np.random.RandomState(3)
    x = rng.standard_normal((2, 8, 8, 5)).astype(np.float32)
    pairs = [("space_to_depth", x), ("depth_to_space", x[..., :4]),
             ("s2d_kernel_stride1", rng.standard_normal((3, 3, 5, 7)).astype(np.float32)),
             ("s2d_kernel_stride1", rng.standard_normal((1, 1, 5, 7)).astype(np.float32)),
             ("s2d_kernel_stride2", rng.standard_normal((3, 3, 5, 7)).astype(np.float32)),
             ("s2d_kernel_stride2_1x1", rng.standard_normal((1, 1, 5, 7)).astype(np.float32))]
    for name, a in pairs:
        want = np.asarray(getattr(jresnet_tpu, name)(jnp.asarray(a)))
        got = getattr(resnet_tpu, name)(torch.from_numpy(a)).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(resnet_tpu.depth_to_space(resnet_tpu.space_to_depth(
        torch.from_numpy(x))).numpy(), x)


def test_basic_block_resnet_matches_jax():
    """The BasicBlock family (resnet20/32/44) on the same flax variables."""
    jb = JBundle(module=JCifarResNet(block=JBasicBlock, layers=(1, 1, 1)),
                 input_shape=(HW, HW, 3))
    tb = ModelBundle(CifarResNet(BasicBlock, (1, 1, 1), 10), (HW, HW, 3), CPU)
    jvars = jax.tree_util.tree_map(np.asarray, jb.init(jax.random.PRNGKey(2)))
    tvars = from_jax_variables(jvars, device="cpu")
    assert set(tvars["params"]) == set(_flat(jvars["params"]))
    x = np.random.RandomState(1).standard_normal((4, HW, HW, 3)).astype(np.float32)
    y = np.arange(4) % 10
    jl, jlogits, jnew, _ = _jax_train(jb, jvars, x, y)
    tl, tlogits, tnew, _ = _torch_train(tb, tvars, x, y)
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    jstats = _flat(jnew["batch_stats"])
    for k, v in tnew["batch_stats"].items():
        np.testing.assert_allclose(v.detach().numpy(), jstats[k],
                                   rtol=2e-4, atol=1e-5, err_msg=k)
