"""The cross-device server's host math held against the JAX package's on
the same numpy inputs:

- ``core/staleness.py``: ``staleness_weight``/``effective_weight`` bit for
  bit against JAX's ``xp=np`` form, over both policies, several alphas
  and deltas that include negatives; the same refusals;
- ``core/tree.py``: the float64 host fold/finalize pair
  (``tree_fold_weighted``, ``tree_finalize_weighted_mean``,
  ``tree_weighted_mean``) bit for bit; ``tree_vdot``/``tree_cast`` within
  1e-6; the renamed fp32 device fold (``tree_fold_weighted_f32``)
  leaves the simulation engine's rounds bitwise unchanged;
- ``core/robust.py``'s host half (``xp=np``): delta norms, clipping, the
  coordinate median (even and odd K) and the trimmed mean bit for bit;
- ``robust/defense.py``: ``RobustAggregator.screen`` for norm clip,
  outlier reject, DP clip and DP noise (the noise bit for bit, the rest
  within 1e-7), ``buffered_close`` for median and trimmed mean (bit for
  bit), ``cap_connection_weights`` exactly, the same ``DefenseConfig``
  refusals, and the per-round counts.
"""

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.core import robust as jrobust
from fedml_tpu.core import staleness as jstaleness
from fedml_tpu.core import tree as jtree
from fedml_tpu.robust import DefenseConfig as JDefenseConfig
from fedml_tpu.robust import RobustAggregator as JRobustAggregator
from fedml_tpu.robust import cap_connection_weights as jcap
from fedml_tpu_torch.algorithms.fedavg import FedAvgConfig, FedAvgSimulation
from fedml_tpu_torch.core import robust, staleness
from fedml_tpu_torch.core import tree as treelib
from fedml_tpu_torch.data.synthetic import synthetic_classification
from fedml_tpu_torch.models.linear import logistic_regression
from fedml_tpu_torch.robust import DefenseConfig, RobustAggregator, cap_connection_weights


def _leaves(tree):
    """Leaves in JAX's order (both sides hold the same nested dicts)."""
    return [np.asarray(l) for l in jax.tree_util.tree_leaves(tree)]


def _assert_trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def _tree(rng, scale=1.0):
    """A flax-shaped variables tree of numpy leaves: params and BN stats."""
    return {
        "params": {"Conv_0": {"kernel": (scale * rng.randn(3, 3, 2, 4)).astype(np.float32)},
                   "Dense_0": {"bias": (scale * rng.randn(5)).astype(np.float32),
                               "kernel": (scale * rng.randn(4, 5)).astype(np.float32)}},
        "batch_stats": {"BatchNorm_0": {"mean": rng.randn(4).astype(np.float32),
                                        "var": rng.rand(4).astype(np.float32)}},
    }


# -- core/staleness.py -------------------------------------------------------------------

DELTAS = np.array([-3, -1, 0, 1, 2, 3, 7, 40])


@pytest.mark.parametrize("policy,alpha,window", [
    ("poly", 0.0, 0), ("poly", 0.5, 2), ("poly", 1.0, 2), ("poly", 2.3, 0),
    ("const", 0.5, 0), ("const", 0.5, 2), ("const", 0.0, 5)])
def test_staleness_weight_bitwise(policy, alpha, window):
    """Tolerance: none (bit for bit, float64), arrays and scalars."""
    w = staleness.staleness_weight(DELTAS, policy, alpha=alpha, window=window)
    jw = jstaleness.staleness_weight(DELTAS, policy, alpha=alpha, window=window, xp=np)
    assert w.dtype == np.float64
    np.testing.assert_array_equal(w, np.asarray(jw))
    for d in (-2, 0, 1, 3):
        assert (float(staleness.staleness_weight(d, policy, alpha=alpha, window=window))
                == float(jstaleness.staleness_weight(d, policy, alpha=alpha,
                                                     window=window, xp=np)))
    assert float(staleness.staleness_weight(0, policy, alpha=alpha, window=window)) == 1.0
    n = np.array([1.0, 3.0, 17.0, 64.0, 5.0, 2.0, 9.0, 11.0])
    np.testing.assert_array_equal(
        staleness.effective_weight(n, DELTAS, policy, alpha=alpha, window=window),
        np.asarray(jstaleness.effective_weight(n, DELTAS, policy, alpha=alpha,
                                               window=window, xp=np)))


def test_staleness_alpha_zero_is_exactly_one_and_refusals_match():
    """Tolerance: none.  alpha 0 gives exactly 1.0 at every delta (the
    async-equals-sync anchor); an unknown policy and a negative alpha are
    refused by both packages."""
    assert np.all(staleness.staleness_weight(DELTAS, "poly", alpha=0.0) == 1.0)
    assert staleness.STALENESS_POLICIES == jstaleness.STALENESS_POLICIES
    for kw in ({"policy": "linear"}, {"policy": "poly", "alpha": -0.5}):
        with pytest.raises(ValueError):
            staleness.staleness_weight(DELTAS, **kw)
        with pytest.raises(ValueError):
            jstaleness.staleness_weight(DELTAS, xp=np, **kw)


# -- core/tree.py ------------------------------------------------------------------------

def test_float64_fold_and_finalize_bitwise():
    """Tolerance: none.  The streaming fold, its finalize and the buffered
    mean over the same uploads and weights, against JAX's."""
    rng = np.random.RandomState(3)
    trees = [_tree(rng) for _ in range(4)]
    ns = [3.0, 5.0, 11.0, 0.25]
    acc = jacc = None
    for t, n in zip(trees, ns):
        acc = treelib.tree_fold_weighted(acc, t, n)
        jacc = jtree.tree_fold_weighted(jacc, t, n)
    _assert_trees_equal(acc, jacc)
    assert all(l.dtype == np.float64 for l in _leaves(acc))
    _assert_trees_equal(treelib.tree_finalize_weighted_mean(acc, sum(ns), trees[0]),
                        jtree.tree_finalize_weighted_mean(jacc, sum(ns), trees[0]))
    _assert_trees_equal(treelib.tree_weighted_mean(trees, ns),
                        jtree.tree_weighted_mean(trees, ns))
    # a tensor template casts back to a tensor of its dtype
    like = treelib.tree_map(torch.from_numpy, trees[0])
    out = treelib.tree_finalize_weighted_mean(acc, sum(ns), like)
    _assert_trees_equal(treelib.tree_map(lambda t: t.numpy(), out),
                        jtree.tree_finalize_weighted_mean(jacc, sum(ns), trees[0]))


def test_tree_vdot_and_cast_match_jax():
    """Tolerance: 1e-6 relative for the fp32 dot (a reduction in another
    order); the cast exactly."""
    rng = np.random.RandomState(4)
    a, b = _tree(rng), _tree(rng)
    ta, tb = treelib.tree_map(torch.from_numpy, a), treelib.tree_map(torch.from_numpy, b)
    np.testing.assert_allclose(float(treelib.tree_vdot(ta, tb)),
                               float(jtree.tree_vdot(a, b)), rtol=1e-6)
    cast = treelib.tree_cast(ta, torch.float64)
    _assert_trees_equal(treelib.tree_map(lambda t: t.numpy(), cast),
                        jax.tree_util.tree_map(np.asarray, jtree.tree_cast(
                            jax.tree_util.tree_map(np.float64, a), np.float64)))


def _old_device_fold(acc, tree, w):
    """The fp32 device fold as it stood before its rename."""
    if acc is None:
        return treelib.tree_map(lambda x: w * x.float(), tree)
    return treelib.tree_map(lambda a, x: a + w * x.float(), acc, tree)


def test_renamed_device_fold_leaves_engine_rounds_bitwise(monkeypatch):
    """Tolerance: none.  ``tree_fold_weighted_f32`` is the engine's old
    fp32 fold under a new name: two rounds of FedAvg on logistic
    regression give the same bits as with the old body put back."""
    rng = np.random.RandomState(5)
    trees = [treelib.tree_map(torch.from_numpy, _tree(rng)) for _ in range(3)]
    new = old = None
    for t, w in zip(trees, (0.2, 0.5, 0.3)):
        new, old = (treelib.tree_fold_weighted_f32(new, t, w),
                    _old_device_fold(old, t, w))
    for x, y in zip(treelib.tree_leaves(new), treelib.tree_leaves(old)):
        assert torch.equal(x, y)

    ds = synthetic_classification(num_train=160, num_test=40, input_shape=(8,),
                                  num_classes=3, num_clients=4, seed=1)

    def run():
        bundle = logistic_regression(8, 3, device="cpu")
        cfg = FedAvgConfig(num_clients=4, clients_per_round=4, comm_rounds=2, epochs=1,
                           batch_size=10, lr=0.1, momentum=0.9,
                           frequency_of_the_test=100, seed=1)
        sim = FedAvgSimulation(bundle, ds, cfg, device="cpu")
        sim.run()
        return sim.state.variables

    a = run()
    monkeypatch.setattr(treelib, "tree_fold_weighted_f32", _old_device_fold)
    b = run()
    for x, y in zip(treelib.tree_leaves(a), treelib.tree_leaves(b)):
        assert torch.equal(x, y)


# -- core/robust.py, host half -------------------------------------------------------

@pytest.mark.parametrize("k", [1, 4, 5])
def test_host_robust_math_bitwise(k):
    """Tolerance: none.  ``xp=np`` norms, clipping, median and trimmed mean
    on the same stacked numpy trees as JAX's numpy form."""
    rng = np.random.RandomState(10 + k)
    g = _tree(rng)["params"]
    stacked = jax.tree_util.tree_map(
        lambda l: np.stack([l + rng.randn(*l.shape).astype(np.float32) * (i + 1)
                            for i in range(k)]), g)
    np.testing.assert_array_equal(robust.param_delta_norms(g, stacked, xp=np),
                                  jrobust.param_delta_norms(g, stacked, xp=np))
    _assert_trees_equal(robust.clip_stacked_params(g, stacked, 2.5, xp=np),
                        jrobust.clip_stacked_params(g, stacked, 2.5, xp=np))
    _assert_trees_equal(robust.coordinate_median(stacked, xp=np),
                        jrobust.coordinate_median(stacked, xp=np))
    for frac in (0.0, 0.2, 0.4):
        _assert_trees_equal(robust.trimmed_mean(stacked, frac, xp=np),
                            jrobust.trimmed_mean(stacked, frac, xp=np))
        _assert_trees_equal(robust.robust_center("trimmed_mean", stacked,
                                                 trim_frac=frac, xp=np),
                            jrobust.robust_center("trimmed_mean", stacked,
                                                  trim_frac=frac, xp=np))


# -- robust/defense.py -----------------------------------------------------------------

SCREEN_CASES = {
    "norm_clip": dict(defense="streaming", norm_bound=0.5),
    "norm_clip_inside": dict(defense="streaming", norm_bound=1e6),
    "outlier": dict(defense="streaming", norm_bound=0.1, outlier_mult=2.0),
    "dp_clip": dict(dp_clip=0.3),
    "dp_noise": dict(dp_clip=0.3, dp_noise=0.05),
    "median_dp": dict(defense="median", dp_clip=1.0, dp_noise=0.01),
}


@pytest.mark.parametrize("case", sorted(SCREEN_CASES))
def test_screen_matches_jax(case):
    """Tolerance: 1e-7 absolute for clipped leaves, none for the DP noise
    and for untouched uploads (the same object comes back)."""
    cfg = SCREEN_CASES[case]
    rng = np.random.RandomState(7)
    base = _tree(rng)
    up = jax.tree_util.tree_map(lambda l: l + 0.2 * rng.randn(*l.shape).astype(np.float32),
                                base)
    ra, jra = RobustAggregator(DefenseConfig(**cfg), seed=3), \
        JRobustAggregator(JDefenseConfig(**cfg), seed=3)
    out, flags = ra.screen(up, base, round_idx=2, slot=5)
    jout, jflags = jra.screen(up, base, round_idx=2, slot=5)
    assert flags == jflags
    if jout is None:
        assert out is None and case == "outlier"
        return
    if jout is up:
        assert out is up
        return
    for x, y in zip(_leaves(out), _leaves(jout)):
        assert x.dtype == y.dtype
        if "dp_noise" in cfg:
            np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-7)
    ra.note_upload(flags)
    jra.note_upload(jflags)
    assert ra.note_round(capped=1) == jra.note_round(capped=1)


@pytest.mark.parametrize("defense,k", [("median", 4), ("median", 5), ("trimmed_mean", 5)])
def test_buffered_close_bitwise(defense, k):
    """Tolerance: none.  The robust params center and the weighted mean of
    the BN statistics over K buffered uploads."""
    rng = np.random.RandomState(20 + k)
    entries = [_tree(rng) for _ in range(k)]
    w = rng.rand(k)
    w = list(w / w.sum())
    cfg = dict(defense=defense, trim_frac=0.2)
    _assert_trees_equal(RobustAggregator(DefenseConfig(**cfg)).buffered_close(entries, w),
                        JRobustAggregator(JDefenseConfig(**cfg)).buffered_close(entries, w))


@pytest.mark.parametrize("weights,cap", [
    ({"a": 80.0, "b": 10.0, "c": 10.0}, 0.4),
    ({"a": 50.0, "b": 30.0, "c": 20.0}, 0.34),
    ({"a": 10.0, "b": 10.0}, 0.4),
    ({"a": 5.0}, 0.4),
    ({"conn1": 90.0, "conn2": 10.0, "node7": 0.0}, 0.5),
    ({"x": 3.0, "y": 3.0, "z": 3.0, "w": 40.0}, 0.3),
])
def test_cap_connection_weights_matches_jax(weights, cap):
    """Tolerance: none (the same float arithmetic)."""
    assert cap_connection_weights(weights, cap) == jcap(weights, cap)


@pytest.mark.parametrize("kw", [
    dict(defense="nope"), dict(defense="streaming", outlier_mult=2.0),
    dict(defense="median", conn_cap=0.4), dict(defense="streaming", conn_cap=1.5),
    dict(dp_noise=0.1), dict(norm_bound=1.0), dict(trim_frac=0.5),
    dict(defense="streaming", norm_bound=1.0, outlier_mult=3.0, conn_cap=0.4),
    dict(defense="trimmed_mean", trim_frac=0.1), dict(dp_clip=0.5, dp_noise=0.1), dict(),
])
def test_defense_config_refuses_what_jax_refuses(kw):
    """Tolerance: none.  Accepted configurations agree on ``enabled``,
    ``buffered`` and ``to_dict``."""
    try:
        j = JDefenseConfig(**kw)
    except ValueError:
        with pytest.raises(ValueError):
            DefenseConfig(**kw)
        return
    t = DefenseConfig(**kw)
    assert (t.enabled, t.buffered, t.to_dict()) == (j.enabled, j.buffered, j.to_dict())


def test_conn_map_attribution_matches_jax():
    ra, jra = RobustAggregator(DefenseConfig()), JRobustAggregator(JDefenseConfig())
    m = {1: [1, 2, 3], "7": [4]}
    ra.set_conn_map(m)
    jra.set_conn_map(m)
    assert [ra.conn_key(n) for n in range(6)] == [jra.conn_key(n) for n in range(6)]
