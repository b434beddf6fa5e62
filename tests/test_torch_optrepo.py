"""The port's server optimizers (``fedml_tpu_torch/core/optrepo.py``) and
FedOpt's server update held against the JAX package's optax transforms
on the same numpy parameters and pseudo-gradients.

Every registry name runs 5 steps from the registry's defaults (and sgd
once with momentum): the updates, the applied parameters and every leaf
of the optimizer state (counts included, as int32) agree with optax
0.2.6 within rtol 1e-6 / atol 1e-7.  sgd and the momentum trace are
bitwise; adam, yogi, adagrad and lamb differ from optax by at most a few
float32 ulps (measured ≤ 3e-7 relative: XLA's ``sqrt``/``rsqrt`` and
norms against torch's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fedml_tpu.algorithms.fedopt import make_fedopt_server_update as jserver_update
from fedml_tpu.core import optrepo as joptrepo
from fedml_tpu_torch.algorithms.fedopt import make_fedopt_server_update
from fedml_tpu_torch.core import optrepo

TOL = {"rtol": 1e-6, "atol": 1e-7}
SHAPES = {"Dense_0.kernel": (6, 4), "Dense_0.bias": (4,), "Conv_0.kernel": (3, 3, 2, 5),
          "zeros": (3,)}
CASES = [(name, {}) for name in joptrepo.names()] + [("sgd", {"momentum": 0.9})]


def _params(rng):
    p = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    p["zeros"] = np.zeros(SHAPES["zeros"], np.float32)  # lamb's zero-norm case
    return p


def _grads(rng, step):
    g = {k: (0.3 * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}
    if step == 0:
        g["zeros"] = np.zeros(SHAPES["zeros"], np.float32)
    return g


def _port_state_leaves(state):
    """The port's chain state in optax's leaf order: per transform, its
    fields in the named tuple's order (count, mu, nu / trace /
    sum_of_squares), each tree's leaves by sorted key."""
    out = []
    for s in state:
        for field in ("count", "mu", "nu", "trace", "sum_of_squares"):
            if field not in s:
                continue
            v = s[field]
            out += [v[k] for k in sorted(v)] if isinstance(v, dict) else [v]
    return [t.numpy() for t in out]


def test_registry_names_are_the_jax_registrys():
    assert optrepo.names() == joptrepo.names()
    with pytest.raises(ValueError, match="unknown server optimizer"):
        optrepo.get_server_optimizer("nope")


@pytest.mark.parametrize("name,kw", CASES, ids=[n + ("_m" if kw else "") for n, kw in CASES])
def test_server_optimizer_tracks_optax_for_five_steps(name, kw):
    rng = np.random.RandomState(0)
    params = _params(rng)
    jopt = joptrepo.get_server_optimizer(name, **kw)
    topt = optrepo.get_server_optimizer(name, **kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(5):
        g = _grads(rng, step)
        ju, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tu, ts = topt.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
        jp, tp = optax.apply_updates(jp, ju), optrepo.apply_updates(tp, tu)
        for k in SHAPES:
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]),
                                       err_msg=f"step {step} update {k}", **TOL)
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       err_msg=f"step {step} params {k}", **TOL)
        jleaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(js)]
        tleaves = _port_state_leaves(ts)
        assert len(tleaves) == len(jleaves)
        for i, (t, j) in enumerate(zip(tleaves, jleaves)):
            assert t.dtype == j.dtype and t.shape == j.shape, (i, t.dtype, j.dtype)
            np.testing.assert_allclose(t, j, err_msg=f"step {step} state leaf {i}", **TOL)
    if name in ("adam", "fedadam", "yogi", "fedyogi", "lamb"):
        assert int(ts[0]["count"]) == 5


@pytest.mark.parametrize("name", ["sgd", "adam", "yogi"])
def test_fedopt_server_update_matches_jax(name):
    """The pseudo-gradient is ``old − agg`` over params; batch_stats come
    from the plain average."""
    rng = np.random.RandomState(1)
    old = {"params": _params(rng), "batch_stats": {"mean": rng.rand(4).astype(np.float32)}}
    jopt = joptrepo.get_server_optimizer(name, lr=0.5)
    topt = optrepo.get_server_optimizer(name, lr=0.5)
    jold = jax.tree_util.tree_map(jnp.asarray, old)
    told = {c: {k: torch.from_numpy(v.copy()) for k, v in d.items()} for c, d in old.items()}
    js, ts = jopt.init(jold["params"]), topt.init(told["params"])
    for _ in range(3):
        agg = {c: {k: v + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
                   for k, v in d.items()} for c, d in old.items()}
        jold, js = jserver_update(jopt)(jold, jax.tree_util.tree_map(jnp.asarray, agg), js)
        told, ts = make_fedopt_server_update(topt)(
            told, {c: {k: torch.from_numpy(v) for k, v in d.items()}
                   for c, d in agg.items()}, ts)
        np.testing.assert_array_equal(told["batch_stats"]["mean"].numpy(),
                                      agg["batch_stats"]["mean"])
        for k in SHAPES:
            np.testing.assert_allclose(told["params"][k].numpy(),
                                       np.asarray(jold["params"][k]), err_msg=k, **TOL)
        old = {c: {k: np.asarray(v) for k, v in d.items()} for c, d in jold.items()}
