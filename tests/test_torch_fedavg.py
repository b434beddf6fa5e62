"""The port's FedAvg round (``fedml_tpu_torch/algorithms/fedavg.py`` over
``core/client.py``) held against the JAX package's on the same numpy
data and the same flax variables.

Setup: JAX ``CifarResNet`` Bottleneck (1,1,1) on 8x8 images, 3 clients x
2 steps x batch 4, fp32, SGD lr 0.05 + momentum 0.9 + wd 1e-3.  Client
1's second batch is pad-only (params frozen there; momentum and BN stats
still advance) and client 2 does not participate; the fixture's rounds
run ``shuffle=False`` so that batch stays in place.  The random streams
are JAX's threefry bits (``core/rng.py``); the shuffled, augmented,
sampled and dropout rounds are held against the JAX engine in
``tests/test_torch_fedavg_streams.py``.
Tolerance rtol/atol 1e-4; the measured max abs difference on any
variable after 2 rounds is 3.6e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu.algorithms.fedavg as jfedavg
import fedml_tpu.core.client as jclient
import fedml_tpu.core.sampling as jsampling
import fedml_tpu.core.types as jtypes
from fedml_tpu.data.synthetic import synthetic_classification as jsynthetic
from fedml_tpu.models.base import ModelBundle as JBundle
from fedml_tpu.models.resnet import Bottleneck as JBottleneck
from fedml_tpu.models.resnet import CifarResNet as JCifarResNet
from fedml_tpu_torch.algorithms.fedavg import (
    FedAvgConfig,
    FedAvgSimulation,
    ServerState,
    make_multi_round_fn,
    make_round_fn,
)
from fedml_tpu_torch.core.client import make_client_optimizer, make_local_update
from fedml_tpu_torch.core import rng as rnglib
from fedml_tpu_torch.core.sampling import (
    eligible_participation_mask,
    host_sample_ids,
    inject_dropout,
    mask_and_ids,
    participation_mask,
    sample_clients,
)
from fedml_tpu_torch.core.types import pack_clients
from fedml_tpu_torch.data.synthetic import synthetic_classification
from fedml_tpu_torch.models.base import ModelBundle
from fedml_tpu_torch.models.convert import from_jax_variables, to_jax_variables
from fedml_tpu_torch.models.resnet import Bottleneck, CifarResNet


CPU = torch.device("cpu")
K, STEPS, B, HW = 3, 2, 4, 8
TOL = {"rtol": 1e-4, "atol": 1e-4}


def _torch_bundle():
    return ModelBundle(CifarResNet(Bottleneck, (1, 1, 1), 10), (HW, HW, 3), CPU)


@pytest.fixture(scope="module")
def setup():
    jb = JBundle(module=JCifarResNet(block=JBottleneck, layers=(1, 1, 1),
                                     num_classes=10), input_shape=(HW, HW, 3))
    jvars = jax.tree_util.tree_map(np.asarray, jb.init(jax.random.PRNGKey(0)))
    rng = np.random.RandomState(0)
    x = rng.standard_normal((K, STEPS, B, HW, HW, 3)).astype(np.float32)
    y = rng.randint(0, 10, (K, STEPS, B)).astype(np.int32)
    mask = np.ones((K, STEPS, B), np.float32)
    mask[1, 1] = 0.0                                  # pad-only batch
    mask[2, 1, 2:] = 0.0                              # ragged last batch
    ns = mask.sum((1, 2))
    part = np.array([1.0, 1.0, 0.0], np.float32)      # client 2 sits out
    ids = np.arange(K, dtype=np.int32)
    data = (x, y, mask, ns, part, ids)

    jopt = jclient.make_client_optimizer("sgd", 0.05, momentum=0.9,
                                         weight_decay=1e-3)
    jlu = jclient.make_local_update(jb, jopt, 1, shuffle=False)
    key = jax.random.PRNGKey(0)
    jstate = jfedavg.ServerState(variables=jvars, opt_state=(),
                                 round_idx=jnp.zeros((), jnp.int32), key=key)
    jargs = tuple(jnp.asarray(a) for a in data)
    round_fn = jax.jit(jfedavg.make_round_fn(jlu))
    st, rows = jstate, []
    for _ in range(2):
        st, m = round_fn(st, *jargs)
        rows.append({k: float(v) for k, v in m.items()})
    multi_state, multi_m = jax.jit(jfedavg.make_multi_round_fn(jlu, 2))(jstate, *jargs)
    return {"jvars": jvars, "data": data, "round": (st, rows),
            "multi": (multi_state, {k: np.asarray(v) for k, v in multi_m.items()})}


def _torch_local_update(shuffle=False):
    opt = make_client_optimizer("sgd", 0.05, momentum=0.9, weight_decay=1e-3)
    return make_local_update(_torch_bundle(), opt, 1, shuffle=shuffle)


def _torch_args(data):
    return tuple(torch.from_numpy(np.asarray(a)) for a in data[:5]) + (data[5],)


def _assert_vars_close(tvars, jvars):
    tj = to_jax_variables(tvars)
    flat_t = jax.tree_util.tree_flatten_with_path(tj)[0]
    flat_j = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(np.asarray, jvars))[0])
    assert len(flat_t) == len(flat_j)
    for path, leaf in flat_t:
        np.testing.assert_allclose(leaf, flat_j[path], err_msg=str(path), **TOL)


def test_round_fn_matches_jax(setup):
    lu = _torch_local_update()
    rf = make_round_fn(lu, device="cpu")
    state = ServerState(from_jax_variables(setup["jvars"], device="cpu"), (), 0,
                        rnglib.PRNGKey(0))
    args = _torch_args(setup["data"])
    jstate, jrows = setup["round"]
    for r in range(2):
        state, m = rf(state, *args)
        for k, v in jrows[r].items():
            np.testing.assert_allclose(float(m[k]), v, err_msg=k, **TOL)
    assert state.round_idx == 2
    assert jrows[0]["steps"] == 3.0          # the pad-only batch took no step
    _assert_vars_close(state.variables, jstate.variables)


def test_multi_round_fn_matches_jax(setup):
    multi = make_multi_round_fn(_torch_local_update(), 2, device="cpu")
    state = ServerState(from_jax_variables(setup["jvars"], device="cpu"), (), 0,
                        rnglib.PRNGKey(0))
    state, m = multi(state, *_torch_args(setup["data"]))
    jstate, jm = setup["multi"]
    for k, v in jm.items():
        np.testing.assert_allclose(m[k].numpy(), v, err_msg=k, **TOL)
    _assert_vars_close(state.variables, jstate.variables)


def test_zero_participation_round_is_a_noop(setup):
    rf = make_round_fn(_torch_local_update(), device="cpu")
    variables = from_jax_variables(setup["jvars"], device="cpu")
    x, y, mask, ns, _, ids = _torch_args(setup["data"])
    new, m = rf(ServerState(variables, (), 0, rnglib.PRNGKey(0)), x, y, mask, ns,
                torch.zeros(K), ids)
    assert float(m["participants"]) == 0.0
    for coll in variables:
        for k, v in variables[coll].items():
            assert torch.equal(new.variables[coll][k], v), k


def test_pack_and_sampling_match_jax_bytes():
    kw = dict(num_train=300, num_test=50, input_shape=(4, 4, 3), num_clients=7,
              partition="hetero", partition_alpha=0.5, seed=3)
    ds, jds = synthetic_classification(**kw), jsynthetic(**kw)
    np.testing.assert_array_equal(ds.train_x, jds.train_x)
    for c in range(7):
        np.testing.assert_array_equal(ds.train_client_idx[c], jds.train_client_idx[c])
    ids = [1, 4, 6]
    got = pack_clients(ds, ids, 16, steps_per_epoch=3, seed=5)
    ref = jtypes.pack_clients(jds, ids, 16, steps_per_epoch=3, seed=5)
    for a, b in ((got.x, ref.x), (got.y, ref.y), (got.mask, ref.mask),
                 (got.num_samples, ref.num_samples)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    for r in range(5):
        assert (host_sample_ids(9, r, 20, 6).tobytes()
                == jsampling.host_sample_ids(9, r, 20, 6).tobytes())


def test_shuffle_is_a_reproducible_per_epoch_permutation(setup):
    """shuffle=True equals shuffle=False fed the same epoch permutation of
    the pack: JAX's ``permutation(fold_in(fold_in(key, epoch), 0), n)``."""
    x, y, mask, _, _, _ = _torch_args(setup["data"])
    variables = from_jax_variables(setup["jvars"], device="cpu")
    n = STEPS * B
    key = rnglib.PRNGKey(11)
    perm = rnglib.permutation(rnglib.fold_in(rnglib.fold_in(key, 0), 0), n)
    jkey = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(11), 0), 0)
    assert perm.tolist() == np.asarray(jax.random.permutation(jkey, n)).tolist()
    assert sorted(perm.tolist()) == list(range(n))
    a, ma = _torch_local_update(shuffle=True)(variables, x[0], y[0], mask[0], key)
    b, mb = _torch_local_update(shuffle=True)(variables, x[0], y[0], mask[0], key)
    xs = x[0].reshape(n, HW, HW, 3)[perm].reshape(x[0].shape)
    c, mc = _torch_local_update(shuffle=False)(
        variables, xs, y[0].reshape(n)[perm].reshape(STEPS, B),
        mask[0].reshape(n)[perm].reshape(STEPS, B), key)
    for k, v in a["params"].items():
        assert torch.equal(v, b["params"][k])
        assert torch.equal(v, c["params"][k])
    assert float(ma["loss_sum"]) == float(mc["loss_sum"])


def test_on_device_draws_keep_their_guarantees():
    """The cohort and dropout draws are JAX's bits, and keep their
    guarantees: exactly K among the eligible, never nobody."""
    elig = torch.tensor([1.0, 0.0, 1.0, 1.0, 0.0, 1.0])
    key, jkey = rnglib.PRNGKey(7), jax.random.PRNGKey(7)
    for r in range(20):
        m = eligible_participation_mask(key, r, elig, 3)
        assert float(m.sum()) == 3.0 and float((m * (1 - elig)).sum()) == 0.0
        jm = jsampling.eligible_participation_mask(jkey, r, jnp.asarray(elig.numpy()), 3)
        assert m.tolist() == np.asarray(jm).tolist()
        d = inject_dropout(key, r, elig, 0.99)
        assert float(d.sum()) >= 1.0 and float((d * (1 - elig)).sum()) == 0.0
        for p in (0.99, 0.4):
            jd = jsampling.inject_dropout(jkey, r, jnp.asarray(elig.numpy()), p)
            assert inject_dropout(key, r, elig, p).tolist() == np.asarray(jd).tolist()
        ids = sample_clients(key, r, 20, 6)
        assert ids.tolist() == np.asarray(jsampling.sample_clients(jkey, r, 20, 6)).tolist()
        mask, ids2 = mask_and_ids(key, r, 20, 6)
        jmask, _ = jsampling.mask_and_ids(jkey, r, 20, 6)
        assert torch.equal(ids, ids2) and mask.tolist() == np.asarray(jmask).tolist()
        assert torch.equal(participation_mask(key, r, 20, 6), mask)


def test_simulation_run_fused_matches_run():
    ds = synthetic_classification(num_train=96, num_test=32, input_shape=(HW, HW, 3),
                                  num_clients=3, seed=1)
    cfg = FedAvgConfig(num_clients=3, clients_per_round=3, comm_rounds=2,
                       batch_size=16, lr=0.05, momentum=0.9, weight_decay=1e-3,
                       frequency_of_the_test=2, seed=4)
    a = FedAvgSimulation(_torch_bundle(), ds, cfg, device="cpu")
    b = FedAvgSimulation(_torch_bundle(), ds, cfg, device="cpu")
    ha, hb = a.run(), b.run_fused()
    for ra, rb in zip(ha, hb):
        for k in ("loss_sum", "correct", "count", "steps", "participants"):
            assert ra[k] == rb[k], k
    assert ha[-1]["test_acc"] == hb[-1]["test_acc"]
    for k, v in a.state.variables["params"].items():
        assert torch.equal(v, b.state.variables["params"][k])


@pytest.mark.parametrize("name,kw", [
    ("sgd", {"momentum": 0.9, "weight_decay": 1e-3}),
    ("sgd", {"grad_clip": 0.5}),
    ("adam", {}),                                   # torch-amsgrad, wd 1e-4
    ("adam", {"weight_decay": 0.0, "grad_clip": 1.0}),
])
def test_client_optimizer_matches_optax_chain(name, kw):
    rng = np.random.RandomState(2)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    jopt = jclient.make_client_optimizer(name, 0.05, **kw)
    topt = make_client_optimizer(name, 0.05, **kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(4):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in params.items()}
        ju, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = {k: jp[k] + ju[k] for k in jp}
        tu, ts = topt.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
        tp = {k: tp[k] + tu[k] for k in tp}
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-6)


def test_local_update_bf16_prox_matches_jax(setup):
    """Mixed precision (bf16 params AND batch_stats in the forward, fp32
    masters) with a FedProx term, one client incl. its pad-only batch;
    at the bf16 tolerance of tests/test_conv_mxu.py."""
    jb = JBundle(module=JCifarResNet(block=JBottleneck, layers=(1, 1, 1),
                                     num_classes=10), input_shape=(HW, HW, 3))
    jopt = jclient.make_client_optimizer("sgd", 0.05, momentum=0.9, weight_decay=1e-3)
    jlu = jclient.make_local_update(jb, jopt, 2, shuffle=False, prox_mu=0.1,
                                    compute_dtype=jnp.bfloat16)
    x, y, mask = (a[1] for a in setup["data"][:3])
    jvars, jm = jax.jit(jlu.fn)(setup["jvars"], jnp.asarray(x), jnp.asarray(y),
                                jnp.asarray(mask), jax.random.PRNGKey(0))
    opt = make_client_optimizer("sgd", 0.05, momentum=0.9, weight_decay=1e-3)
    lu = make_local_update(_torch_bundle(), opt, 2, shuffle=False, prox_mu=0.1,
                           compute_dtype=torch.bfloat16)
    tvars, tm = lu(from_jax_variables(setup["jvars"], device="cpu"),
                   torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(mask),
                   rnglib.PRNGKey(0))
    assert float(tm["steps"]) == float(jm["steps"]) == 2.0   # 2 epochs x 1 real batch
    assert all(v.dtype == torch.float32 for v in tvars["batch_stats"].values())
    np.testing.assert_allclose(float(tm["loss_sum"]), float(jm["loss_sum"]),
                               rtol=5e-2, atol=5e-2)
    tj = to_jax_variables(tvars)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(tj)[0],
                            jax.tree_util.tree_leaves(jvars)):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), rtol=5e-2,
                                   atol=5e-2, err_msg=str(path))
