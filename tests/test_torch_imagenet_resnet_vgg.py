"""ResNet-56 and VGG at the ImageNet loader's 224 px, held against the JAX
package's flax modules with flax's init carried across by
``models/convert.py``, on the same numpy images:

- ResNet-56 at 1000 classes: the port's kernel model on the CPU (the
  kernel's plain version, ``conv3x3_plain``, at 224/112/56) against JAX's
  XLA conv variant (the variant ``tests/test_resnet_tpu.py`` holds to the
  Pallas kernel): eval logits, train-mode logits and the new
  ``batch_stats`` of 2 images, within ``LOGIT_TOL`` (logits) and
  ``STATS_TOL`` (each statistic over its leaf's largest magnitude);
- VGG's ``adaptive_avg_pool`` on 7x7 maps (224 px: every bin is one pixel,
  the pool is the identity) and 14x14 maps (2x2 bins) at narrow channels
  equal to JAX's within ``POOL_TOL``, and a narrow VGG-bn (five pools, a
  7x7 map) at 224 px within ``LOGIT_TOL``.

The tolerances are set from float32 (``test_torch_imagenet_models.py``).
"""

import jax
import numpy as np
import pytest
import torch

import fedml_tpu.models.vgg as jvgg
from fedml_tpu.models.base import ModelBundle as JBundle
from fedml_tpu.models.resnet_tpu import resnet56_tpu as jresnet56_tpu
from fedml_tpu_torch.models import vgg
from fedml_tpu_torch.models.base import ModelBundle
from fedml_tpu_torch.models.convert import from_jax_variables, to_jax_variables
from fedml_tpu_torch.models.resnet_tpu import resnet56_tpu
from test_torch_imagenet_models import CPU, LOGIT_TOL, SIDE, _flax_init, _images, _rel_gap

STATS_TOL = 1e-5
POOL_TOL = 1e-6


@pytest.fixture(autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_resnet56_plain_path_at_224_is_jaxs_xla_variant():
    jb = jresnet56_tpu(1000, SIDE, conv_variant="xla")
    tb = resnet56_tpu(1000, SIDE, device=CPU)
    jvars = _flax_init(jb)
    tvars = from_jax_variables(jvars, CPU)
    x = _images(2)
    want_eval = np.asarray(jax.jit(jb.apply_eval)(jvars, x))
    want_train, want_vars = jax.jit(jb.apply_train)(jvars, x)
    with torch.no_grad():
        got_eval = tb.apply_eval(tvars, torch.from_numpy(x)).numpy()
        got_train, got_vars = tb.apply_train(tvars, torch.from_numpy(x))
    assert _rel_gap(got_eval, want_eval) <= LOGIT_TOL
    assert _rel_gap(got_train.numpy(), want_train) <= LOGIT_TOL
    got_stats = to_jax_variables(got_vars)["batch_stats"]
    want_stats = jax.tree_util.tree_map(np.asarray, want_vars["batch_stats"])
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got_stats)[0])
    for path, w in jax.tree_util.tree_flatten_with_path(want_stats)[0]:
        g = flat_got[path]
        assert np.abs(g - w).max() <= STATS_TOL * max(1.0, np.abs(w).max()), path


@pytest.mark.parametrize("side", [7, 14])
def test_vgg_adaptive_pool_at_224_maps_is_jaxs(side):
    x = np.random.RandomState(side).standard_normal((2, side, side, 8)).astype(np.float32)
    want = np.asarray(jvgg.adaptive_avg_pool(jax.numpy.asarray(x), 7))
    got = vgg.adaptive_avg_pool(torch.from_numpy(x), 7).numpy()
    assert got.shape == want.shape == (2, 7, 7, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=POOL_TOL)
    if side == 7:
        assert np.array_equal(got, x)
    else:  # 2x2 bins
        np.testing.assert_allclose(got, x.reshape(2, 7, 2, 7, 2, 8).mean((2, 4)), rtol=0,
                                   atol=POOL_TOL)


def test_narrow_vgg_bn_at_224_is_jaxs():
    cfg = (8, "M", 8, "M", 16, "M", 16, "M", 16, "M")  # 224 -> a 7x7 map
    shape = (SIDE, SIDE, 3)
    jb = JBundle(module=jvgg.VGG(cfg=cfg, batch_norm=True, num_classes=10), input_shape=shape,
                 needs_dropout_rng=True)
    tb = ModelBundle(vgg.VGG(cfg, True, 10), shape, CPU, needs_dropout_rng=True)
    jvars = _flax_init(jb)
    x = _images(3)
    want = np.asarray(jax.jit(jb.apply_eval)(jvars, x))
    with torch.no_grad():
        got = tb.apply_eval(from_jax_variables(jvars, CPU), torch.from_numpy(x)).numpy()
    assert _rel_gap(got, want) <= LOGIT_TOL
