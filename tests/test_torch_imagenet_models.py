"""The registry's gld23k models at the Landmarks loader's 224 px, where
code that had run only at 32 px takes other branches, held against the
JAX package's flax modules with flax's init carried across by
``models/convert.py`` (no port draw: ROADMAP A3), on the same numpy
images: EfficientNet-b0 (``PARAMS``' resolution 224; flax's ``SAME``
padding at 224/112/56/28/14/7, asymmetric at stride 2) and
MobileNetV3-LARGE at 203 classes, the eval logits of 2 images in float32
within ``LOGIT_TOL`` of the largest logit.  ResNet-56 and VGG at 224 px:
``test_torch_imagenet_resnet_vgg.py``.  The tolerances are set from
float32: the sums of a 224-px forward run in another order in XLA and in
PyTorch.
"""

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.experiments import registry as jregistry
from fedml_tpu_torch.experiments import registry
from fedml_tpu_torch.models.convert import from_jax_variables

CPU = torch.device("cpu")
SIDE = 224
LOGIT_TOL = 1e-5


@pytest.fixture(autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _images(seed, n=2):
    return np.random.RandomState(seed).standard_normal((n, SIDE, SIDE, 3)).astype(np.float32)


def _flax_init(jbundle):
    return jax.tree_util.tree_map(np.asarray, jax.jit(jbundle.init)(jax.random.PRNGKey(0)))


def _rel_gap(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("model", ["efficientnet", "mobilenet_v3"])
def test_gld23k_models_at_224_are_jaxs(model):
    shape = (SIDE, SIDE, 3)
    jb = jregistry.create_model(model, "gld23k", 203, input_shape=shape)
    tb = registry.create_model(model, "gld23k", 203, input_shape=shape, device=CPU)
    assert tuple(tb.input_shape) == tuple(jb.input_shape) == shape
    jvars = _flax_init(jb)
    x = _images(1)
    want = np.asarray(jax.jit(jb.apply_eval)(jvars, x))
    with torch.no_grad():
        got = tb.apply_eval(from_jax_variables(jvars, CPU), torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 203)
    assert _rel_gap(got, want) <= LOGIT_TOL
