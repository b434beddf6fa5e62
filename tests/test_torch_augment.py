"""The port's image augmentation (``fedml_tpu_torch/data/augment.py``) held
bit for bit against ``fedml_tpu/data/augment.py::make_image_augment`` on
the same key and images: crop, flip and Cutout each on and off, batches
of 1, 5 and 64.  The port crops by an index gather where the JAX package
multiplies by one-hot selections; both select exactly, so every output
word must be equal (compared as uint32 bits, which also tells -0.0 from
0.0).
"""

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.data.augment import cifar_augment as jcifar_augment
from fedml_tpu.data.augment import make_image_augment as jmake_image_augment
from fedml_tpu_torch.core.rng import PRNGKey
from fedml_tpu_torch.data.augment import cifar_augment, make_image_augment

IMAGES = np.random.RandomState(0).standard_normal((64, 32, 32, 3)).astype(np.float32)

RECIPES = {
    "all": dict(pad=4, flip=True, cutout=16),
    "no_crop": dict(pad=0, flip=True, cutout=16),
    "no_flip": dict(pad=4, flip=False, cutout=16),
    "no_cutout": dict(pad=4, flip=True, cutout=None),
    "crop_only": dict(pad=4, flip=False, cutout=None),
    "none": dict(pad=0, flip=False, cutout=None),
    "pad2_cut8": dict(pad=2, flip=True, cutout=8),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes at once, and the tiny tensors here gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint32)


@pytest.mark.parametrize("batch", [1, 5, 64])
@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_augment_is_bit_identical_to_jax(recipe, batch):
    kw = RECIPES[recipe]
    x = IMAGES[:batch]
    want = np.asarray(jax.jit(jmake_image_augment(**kw))(jax.random.PRNGKey(7), x))
    got = make_image_augment(**kw)(PRNGKey(7), torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == x.shape
    assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cifar_augment_is_the_reference_recipe(seed):
    x = IMAGES[:16]
    want = np.asarray(jax.jit(jcifar_augment())(jax.random.PRNGKey(seed), x))
    got = cifar_augment()(PRNGKey(seed), torch.from_numpy(x)).numpy()
    assert np.array_equal(_bits(got), _bits(want))
    # it changes the images, and another key changes them differently
    assert not np.array_equal(got, x)
    other = cifar_augment()(PRNGKey(seed + 10), torch.from_numpy(x)).numpy()
    assert not np.array_equal(got, other)


def test_augment_keeps_dtype_and_layout_of_a_bf16_batch():
    x = torch.from_numpy(IMAGES[:4]).to(torch.bfloat16)
    out = cifar_augment()(PRNGKey(0), x)
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
