"""The port's threefry streams (``fedml_tpu_torch/core/rng.py``) held bit for
bit against ``jax.random`` (jax 0.9.0, ``jax_threefry_partitionable=True``)
on the CPU, and against the known answers ``chip_smoke.py`` checks the
card's draws with (``tests/threefry_known_answers.json``).  Every
comparison is exact: equal bytes, not a tolerance.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jprng

import chip_smoke
from fedml_tpu.data.augment import cifar_augment as jcifar_augment
from fedml_tpu_torch.core import rng

ANSWERS = os.path.join(os.path.dirname(__file__), "threefry_known_answers.json")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes at once, and the tiny tensors here gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def _kd(key):
    return np.asarray(jax.random.key_data(key))


def test_partitionable_threefry_is_the_variant_pinned():
    assert jax.config.jax_threefry_partitionable


def test_threefry2x32_on_random_words():
    r = np.random.RandomState(0)
    for _ in range(4):
        k1, k2 = (int(v) for v in r.randint(0, 2**32, 2, dtype=np.uint64))
        x0, x1 = (r.randint(0, 2**32, 50, dtype=np.uint64).astype(np.uint32)
                  for _ in range(2))
        want = np.asarray(jprng.threefry_2x32(
            (np.uint32(k1), np.uint32(k2)), np.concatenate([x0, x1])))
        got0, got1 = rng.threefry2x32(k1, k2, torch.from_numpy(x0.astype(np.int64)),
                                      torch.from_numpy(x1.astype(np.int64)))
        got = np.concatenate([got0.numpy(), got1.numpy()]).astype(np.uint32)
        assert got.tobytes() == want.tobytes()
        # scalar words on the host give the same block
        assert rng.threefry2x32(k1, k2, int(x0[0]), int(x1[0])) == (
            int(want[0]), int(want[50]))


@pytest.mark.parametrize("seed", [0, 5, -1, 2**31 - 1, 2**32 + 7, 12345])
def test_prng_key(seed):
    assert rng.PRNGKey(seed).tobytes() == _kd(_jkey(seed)).tobytes()


@pytest.mark.parametrize("data", [0, 1, 7, 2**31 + 5, 0x5A11, 0x0D0D, 2**32 - 1])
def test_fold_in(data):
    got = rng.fold_in(rng.PRNGKey(42), data)
    assert got.dtype == np.uint32
    assert got.tobytes() == _kd(jax.random.fold_in(_jkey(42), data)).tobytes()


@pytest.mark.parametrize("num", [2, 3])
def test_split(num):
    got = rng.split(rng.PRNGKey(42), num)
    assert got.shape == (num, 2)
    assert got.tobytes() == _kd(jax.random.split(_jkey(42), num)).tobytes()


@pytest.mark.parametrize("shape", [(), (7,), (1,), (2, 3, 4, 5)],
                         ids=["0d", "odd", "one", "4d"])
def test_random_bits(shape):
    got = rng.random_bits(rng.PRNGKey(9), shape)
    want = np.asarray(jax.random.bits(_jkey(9), shape, jnp.uint32))
    assert tuple(got.shape) == want.shape
    assert got.numpy().astype(np.uint32).tobytes() == want.tobytes()


@pytest.mark.parametrize("shape", [(), (5, 3), (1000,)])
def test_uniform(shape):
    got = rng.uniform(rng.PRNGKey(1), shape)
    want = np.asarray(jax.random.uniform(_jkey(1), shape))
    assert got.dtype == torch.float32
    assert got.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("p", [0.5, 0.9])
def test_bernoulli(p):
    got = rng.bernoulli(rng.PRNGKey(2), p, (10, 100))
    want = np.asarray(jax.random.bernoulli(_jkey(2), p, (10, 100)))
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("lo,hi", [(0, 9), (0, 10), (0, 33), (-5, 28), (4, 4)])
def test_randint(lo, hi):
    got = rng.randint(rng.PRNGKey(3), (64, 3), lo, hi)
    want = np.asarray(jax.random.randint(_jkey(3), (64, 3), lo, hi))
    assert got.dtype == torch.int32
    assert got.numpy().tobytes() == want.tobytes()


def test_randint_refuses_bounds_outside_int32():
    with pytest.raises(ValueError, match="int32"):
        rng.randint(rng.PRNGKey(0), (2,), 0, 2**31)


@pytest.mark.parametrize("n", [1, 7, 1536, 20000])
def test_permutation(n):
    got = rng.permutation(rng.PRNGKey(4), n)
    want = np.asarray(jax.random.permutation(_jkey(4), n))
    assert got.tolist() == want.tolist()


def _jax_case(draw, seed, kw):
    k = _jkey(seed)
    if draw == "random_bits":
        return np.asarray(jax.random.bits(k, kw["shape"], jnp.uint32))
    if draw == "uniform":
        return np.asarray(jax.random.uniform(k, kw["shape"]))
    if draw == "bernoulli":
        return np.asarray(jax.random.bernoulli(k, kw["p"], kw["shape"]))
    if draw == "randint":
        return np.asarray(jax.random.randint(k, kw["shape"], kw["lo"], kw["hi"]))
    if draw == "permutation":
        return np.asarray(jax.random.permutation(k, kw["n"]))
    assert draw == "cifar_augment"
    return np.asarray(jax.jit(jcifar_augment())(
        k, chip_smoke.augment_images(kw["images"])))


@pytest.mark.parametrize("name,draw,seed,kw", chip_smoke.RNG_CASES,
                         ids=[c[0] for c in chip_smoke.RNG_CASES])
def test_known_answers_are_jax_and_the_port(name, draw, seed, kw):
    """The literals chip_smoke holds the card to are jax's draws, and the
    port's CPU draws equal them."""
    with open(ANSWERS) as f:
        answer = json.load(f)["answers"][name]
    want = _jax_case(draw, seed, kw)
    got = chip_smoke.rng_case(draw, seed, kw, "cpu")
    assert chip_smoke.answer_of(want) == answer
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
