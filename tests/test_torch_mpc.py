"""The port's finite-field secure aggregation and gossip topologies held
against the JAX package on the CPU, exactly.

- ``core/rng.py::randint`` with ``dtype=torch.int64``: bit for bit
  ``jax.random.randint(..., jnp.int64)`` under x64 (64-bit threefry words,
  uint64 span arithmetic) over several spans, and the int32 draw as before.
- ``core/topology.py``: both managers and ``ring_topology`` equal JAX's
  (networkx's ring lattice) for n 1–12, every neighbour count, seeds 0–2.
- ``core/mpc.py``: every primitive equal; ``secure_weighted_sum`` and
  ``lcc_coded_sum`` (``algorithms/turboaggregate.py``) equal, and the
  secure sum within n/(2·scale) of the float64 weighted sum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms import turboaggregate as jturbo
from fedml_tpu.core import mpc as jmpc
from fedml_tpu.core import topology as jtopo
from fedml_tpu.parallel.compat import enable_x64
from fedml_tpu_torch.algorithms import turboaggregate as turbo
from fedml_tpu_torch.core import mpc
from fedml_tpu_torch.core import rng as rnglib
from fedml_tpu_torch.core import topology as topo

P = mpc.DEFAULT_PRIME


def _np(x):
    return np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _residues(shape, seed):
    return np.random.RandomState(seed).randint(0, P, size=shape).astype(np.int64)


# -- int64 randint ---------------------------------------------------------------------

@pytest.mark.parametrize("lo,hi", [
    (0, P), (0, 2 ** 31), (0, 7), (-5, 1000), (3, 2 ** 32 + 3), (0, 1), (5, 5),
    (-(2 ** 40), -(2 ** 40) + 12345), (0, 2 ** 32)])
def test_randint_int64_is_jax_bit_for_bit(lo, hi):
    for seed in (0, 1, 7):
        with enable_x64():
            want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (3, 41), lo, hi,
                                                 dtype=jnp.int64))
        got = rnglib.randint(rnglib.PRNGKey(seed), (3, 41), lo, hi, "cpu", torch.int64)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)


def test_randint_int32_unchanged_and_wide_int64_span_refused():
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(3), (64,), -9, 1 << 30,
                                         dtype=jnp.int32))
    np.testing.assert_array_equal(
        rnglib.randint(rnglib.PRNGKey(3), (64,), -9, 1 << 30, "cpu").numpy(), want)
    with pytest.raises(ValueError, match="wider than 2\\^32"):
        rnglib.randint(rnglib.PRNGKey(0), (2,), 0, 2 ** 33, "cpu", torch.int64)


# -- topologies --------------------------------------------------------------------------

@pytest.mark.parametrize("n", range(1, 13))
def test_topologies_equal_jax(n):
    np.testing.assert_array_equal(topo.ring_topology(n), jtopo.ring_topology(n))
    for k in range(0, n + 2):
        for seed in range(3):
            sym = topo.SymmetricTopologyManager(n, k, seed)
            jsym = jtopo.SymmetricTopologyManager(n, k, seed)
            np.testing.assert_array_equal(sym.generate_topology(), jsym.generate_topology())
            for out in range(0, 4):
                asym = topo.AsymmetricTopologyManager(n, k, out, seed)
                jasym = jtopo.AsymmetricTopologyManager(n, k, out, seed)
                np.testing.assert_array_equal(asym.generate_topology(),
                                              jasym.generate_topology())
                for i in range(n):
                    assert asym.get_in_neighbor_idx_list(i) == jasym.get_in_neighbor_idx_list(i)
                    assert asym.get_out_neighbor_idx_list(i) == jasym.get_out_neighbor_idx_list(i)
                    assert asym.get_in_neighbor_weights(i) == jasym.get_in_neighbor_weights(i)
                    assert asym.get_out_neighbor_weights(i) == jasym.get_out_neighbor_weights(i)


# -- mpc primitives ----------------------------------------------------------------------

def test_scalar_field_math_equals_jax():
    for a in (1, 2, 12345, P - 1, -7, 3 * P + 5):
        assert mpc.modular_inv(a) == jmpc.modular_inv(a)
        assert mpc.field_div(a, 17) == jmpc.field_div(a, 17)
    alphas, betas = [0, 5, P + 3, -2], [1, 2, 7, 11, 40]
    np.testing.assert_array_equal(mpc.gen_lagrange_coeffs(alphas, betas),
                                  jmpc.gen_lagrange_coeffs(alphas, betas))
    for n, s in ((4, 3), (7, 5)):
        for a, b in zip(mpc._lcc_grids(n, s, P), jmpc._lcc_grids(n, s, P)):
            np.testing.assert_array_equal(a, b)


def test_coeff_combine_and_field_sum_equal_jax():
    U = _residues((5, 4), 0)
    X = _residues((4, 3, 7), 1)
    X[0, 0, 0] = -3  # a negative input is reduced first, as in JAX
    np.testing.assert_array_equal(_np(mpc.coeff_combine(U, torch.from_numpy(X))),
                                  _np(jmpc.coeff_combine(U, X)))
    S = _residues((6, 50), 2)
    np.testing.assert_array_equal(_np(mpc.field_sum(torch.from_numpy(S))),
                                  _np(jmpc.field_sum(S)))


def test_bgw_shares_and_reconstruction_equal_jax():
    x = _residues((3, 8), 3)
    for n, t in ((5, 2), (4, 1)):
        got = mpc.bgw_encode(torch.from_numpy(x), n, t, rnglib.PRNGKey(9))
        want = _np(jmpc.bgw_encode(x, n, t, jax.random.PRNGKey(9)))
        np.testing.assert_array_equal(_np(got), want)
        idx = list(range(n - t - 1, n))
        dec = mpc.bgw_decode(got[idx], idx)
        np.testing.assert_array_equal(_np(dec), _np(jmpc.bgw_decode(want[idx], idx)))
        np.testing.assert_array_equal(_np(dec), x)


def test_lcc_shares_and_decode_equal_jax():
    x = _residues((12, 5), 4)
    n, k, t = 6, 3, 2
    got = mpc.lcc_encode(torch.from_numpy(x), n, k, t, rnglib.PRNGKey(4))
    want = _np(jmpc.lcc_encode(x, n, k, t, jax.random.PRNGKey(4)))
    np.testing.assert_array_equal(_np(got), want)
    use = [0, 2, 3, 4, 5]
    dec = mpc.lcc_decode(got[use], use, n, k + t)
    np.testing.assert_array_equal(_np(dec), _np(jmpc.lcc_decode(want[use], use, n, k + t)))
    np.testing.assert_array_equal(_np(dec)[:12], x)


def test_additive_shares_and_quantization_equal_jax():
    x = _residues((4, 9), 5)
    got = mpc.additive_shares(torch.from_numpy(x), 5, rnglib.PRNGKey(2))
    np.testing.assert_array_equal(_np(got), _np(jmpc.additive_shares(x, 5, jax.random.PRNGKey(2))))
    np.testing.assert_array_equal(_np(mpc.field_sum(got)), x)
    v = np.random.RandomState(6).normal(0, 3, 400)
    v[:4] = [0.5 / 2 ** 16, 1.5 / 2 ** 16, -0.5 / 2 ** 16, -2.5 / 2 ** 16]  # ties to even
    for scale in (2.0 ** 16, 1000.0):
        q = mpc.quantize(torch.from_numpy(v), scale)
        np.testing.assert_array_equal(_np(q), jmpc.quantize(v, scale))
        np.testing.assert_array_equal(_np(mpc.dequantize(q, scale)),
                                      jmpc.dequantize(_np(q), scale))


def _vectors(n, d, seed):
    r = np.random.RandomState(seed)
    return [r.normal(0, 0.5, d).astype(np.float32) for _ in range(n)]


def test_secure_weighted_sum_equals_jax_and_the_float64_sum():
    vecs = _vectors(4, 1001, 7)
    w = np.asarray([3.0, 1.0, 2.0, 4.0]) / 10.0
    got = turbo.secure_weighted_sum([torch.from_numpy(v) for v in vecs], w, rnglib.PRNGKey(1))
    want = jturbo.secure_weighted_sum(vecs, w, jax.random.PRNGKey(1))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)
    exact = sum(wi * v.astype(np.float64) for wi, v in zip(w, vecs))
    assert np.abs(got.numpy() - exact).max() <= len(vecs) / (2 * 2.0 ** 16)


@pytest.mark.parametrize("drop", [(), (1,), (0, 4)])
def test_lcc_coded_sum_equals_jax_with_stragglers(drop):
    vecs = _vectors(5, 333, 8)
    got = turbo.lcc_coded_sum([torch.from_numpy(v) for v in vecs], rnglib.PRNGKey(5),
                              k=2, t=1, drop=drop)
    want = jturbo.lcc_coded_sum(vecs, jax.random.PRNGKey(5), k=2, t=1, drop=drop)
    np.testing.assert_array_equal(got.numpy(), want)
    full = turbo.lcc_coded_sum([torch.from_numpy(v) for v in vecs], rnglib.PRNGKey(5),
                               k=2, t=1)
    np.testing.assert_array_equal(got.numpy(), full.numpy())
    with pytest.raises(ValueError, match="stragglers"):
        turbo.lcc_coded_sum([torch.from_numpy(v) for v in vecs], rnglib.PRNGKey(5),
                            k=2, t=1, drop=(0, 1, 2))
