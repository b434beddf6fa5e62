"""The threefry draws, permutation and augmentation on the card held bit for
bit against the same calls on the CPU (which ``tests/test_torch_rng.py``
holds against jax) and against the known answers of jax 0.9.0.  Needs a
CUDA GPU and skips without one; imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_rng_gpu.py
"""

import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from fedml_tpu_torch.core import rng
from fedml_tpu_torch.core.sampling import eligible_participation_mask, inject_dropout
from fedml_tpu_torch.data.augment import make_image_augment

ANSWERS = os.path.join(os.path.dirname(__file__), "threefry_known_answers.json")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: this holds the card's draws against the CPU's")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name,draw,seed,kw", chip_smoke.RNG_CASES,
                         ids=[c[0] for c in chip_smoke.RNG_CASES])
def test_card_draws_equal_cpu_and_jax(cuda, name, draw, seed, kw):
    got = chip_smoke.rng_case(draw, seed, kw, cuda)
    want = chip_smoke.rng_case(draw, seed, kw, "cpu")
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    with open(ANSWERS) as f:
        assert chip_smoke.answer_of(got) == json.load(f)["answers"][name]


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 7, 1536, 1700, 100_000])
def test_card_permutation_equals_cpu(cuda, n):
    key = rng.fold_in(rng.PRNGKey(11), n)
    assert torch.equal(rng.permutation(key, n, cuda).cpu(), rng.permutation(key, n))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(), (3,), (1536, 32, 32, 3)])
def test_card_bits_equal_cpu(cuda, shape):
    key = rng.PRNGKey(2)
    assert torch.equal(rng.random_bits(key, shape, cuda).cpu(), rng.random_bits(key, shape))


@pytest.mark.gpu
@pytest.mark.parametrize("recipe", [dict(), dict(pad=0), dict(cutout=None), dict(flip=False)],
                         ids=["all", "no_crop", "no_cutout", "no_flip"])
def test_card_augment_equals_cpu(cuda, recipe):
    x = torch.from_numpy(np.random.RandomState(1).standard_normal(
        (1536, 32, 32, 3)).astype(np.float32))
    aug = make_image_augment(**recipe)
    got = aug(rng.PRNGKey(3), x.to(cuda)).cpu()
    want = aug(rng.PRNGKey(3), x)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
def test_card_cohort_and_dropout_draws_equal_cpu(cuda):
    part = torch.tensor([1.0, 0.0, 1.0, 1.0, 1.0, 0.0, 1.0, 1.0])
    key = rng.PRNGKey(4)
    for r in range(10):
        assert torch.equal(eligible_participation_mask(key, r, part.to(cuda), 4).cpu(),
                           eligible_participation_mask(key, r, part, 4))
        assert torch.equal(inject_dropout(key, r, part.to(cuda), 0.3).cpu(),
                           inject_dropout(key, r, part, 0.3))
