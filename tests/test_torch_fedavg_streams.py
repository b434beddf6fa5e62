"""The port's FedAvg on JAX's random streams, held against the JAX engine:
shuffled and augmented rounds, on-device cohort sampling with dropout, an
``aggregate_transform``, the scheduled and sampled-fused drivers, a whole
sampled, augmented ``FedAvgSimulation``, client learning-rate schedules,
and a float64 check of the one case where the JAX engine's float32
arithmetic drifts.

Setup: the fixture of ``tests/test_torch_fedavg.py`` (JAX ``CifarResNet``
Bottleneck (1,1,1) on 8x8 images, 3 clients x 2 steps x batch 4, fp32,
SGD lr 0.05 + momentum 0.9 + wd 1e-3, the same flax variables on both
sides).  Tolerance rtol/atol 1e-4 against the JAX engine; the port-only
driver equivalences are bitwise.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu.algorithms.fedavg as jfedavg
import fedml_tpu.core.client as jclient
import fedml_tpu.core.robust as jrobust
import fedml_tpu.core.sampling as jsampling
import fedml_tpu.data.augment as jaugment
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
    make_scheduled_multi_round_fn,
)
from fedml_tpu_torch.core import rng as rnglib
from fedml_tpu_torch.core.client import make_client_optimizer, make_local_update
from fedml_tpu_torch.core.sampling import eligible_participation_mask, inject_dropout
from fedml_tpu_torch.data.augment import cifar_augment, make_image_augment
from fedml_tpu_torch.data.synthetic import synthetic_classification
from fedml_tpu_torch.models.convert import from_jax_variables, to_jax_variables
from test_torch_fedavg import (
    HW,
    K,
    TOL,
    _assert_vars_close,
    _torch_args,
    _torch_bundle,
    _torch_local_update,
)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes at once, and the tiny tensors here gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """The flax variables and the numpy data of ``test_torch_fedavg.py``."""
    jvars = jax.tree_util.tree_map(np.asarray, _jax_bundle().init(jax.random.PRNGKey(0)))
    rng = np.random.RandomState(0)
    x = rng.standard_normal((K, 2, 4, HW, HW, 3)).astype(np.float32)
    y = rng.randint(0, 10, (K, 2, 4)).astype(np.int32)
    mask = np.ones((K, 2, 4), np.float32)
    mask[1, 1] = 0.0                                  # pad-only batch
    mask[2, 1, 2:] = 0.0                              # ragged last batch
    part = np.array([1.0, 1.0, 0.0], np.float32)      # client 2 sits out
    return {"jvars": jvars,
            "data": (x, y, mask, mask.sum((1, 2)), part, np.arange(K, dtype=np.int32))}


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_client_lr_schedule_matches_optax(name):
    """A learning-rate schedule (count -> lr, the ``client_lr`` of
    ``FedAvgSimulation``) is read at each update's count from 0, as
    ``optax.scale_by_learning_rate`` reads it."""
    def sched(count):
        return 0.1 / (1.0 + count)

    rng = np.random.RandomState(3)
    p0 = rng.standard_normal(6).astype(np.float32)
    jopt = jclient.make_client_optimizer(name, sched, momentum=0.9 if name == "sgd" else 0.0)
    topt = make_client_optimizer(name, sched, momentum=0.9 if name == "sgd" else 0.0)
    jp, tp = {"w": jnp.asarray(p0)}, {"w": torch.from_numpy(p0.copy())}
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(4):
        g = rng.standard_normal(6).astype(np.float32)
        ju, js = jopt.update({"w": jnp.asarray(g)}, js, jp)
        jp = {"w": jp["w"] + ju["w"]}
        tu, ts = topt.update({"w": torch.from_numpy(g)}, ts, tp)
        tp = {"w": tp["w"] + tu["w"]}
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]), rtol=1e-5, atol=1e-6)


def _jax_bundle():
    return JBundle(module=JCifarResNet(block=JBottleneck, layers=(1, 1, 1),
                                       num_classes=10), input_shape=(HW, HW, 3))


AUGMENTS = {"cifar": (jaugment.cifar_augment, cifar_augment),
            "pad2_cut4": (lambda: jaugment.make_image_augment(pad=2, cutout=4),
                          lambda: make_image_augment(pad=2, cutout=4))}


@pytest.mark.parametrize("aug", sorted(AUGMENTS))
def test_shuffled_augmented_round_matches_jax(setup, aug):
    """shuffle=True with a per-epoch augmentation: two rounds on JAX's
    shuffle and augment bits, against the JAX engine (tolerance 1e-4).
    Under key 3 instead, client 1's second epoch reaches a batch where the
    JAX engine's float32 gradient drifts from exact arithmetic and the
    port's does not (``test_local_update_tracks_float64_where_xla_float32_drifts``)."""
    jaug, taug = AUGMENTS[aug]
    jopt = jclient.make_client_optimizer("sgd", 0.05, momentum=0.9, weight_decay=1e-3)
    jlu = jclient.make_local_update(_jax_bundle(), jopt, 2, augment_fn=jaug())
    jrf = jax.jit(jfedavg.make_round_fn(jlu))
    jstate = jfedavg.ServerState(variables=setup["jvars"], opt_state=(),
                                 round_idx=jnp.zeros((), jnp.int32),
                                 key=jax.random.PRNGKey(5))
    jargs = tuple(jnp.asarray(a) for a in setup["data"])
    opt = make_client_optimizer("sgd", 0.05, momentum=0.9, weight_decay=1e-3)
    rf = make_round_fn(make_local_update(_torch_bundle(), opt, 2, augment_fn=taug()),
                       device="cpu")
    state = ServerState(from_jax_variables(setup["jvars"], device="cpu"), (), 0,
                        rnglib.PRNGKey(5))
    args = _torch_args(setup["data"])
    for _ in range(2):
        jstate, jm = jrf(jstate, *jargs)
        state, m = rf(state, *args)
        for k, v in jm.items():
            np.testing.assert_allclose(float(m[k]), float(v), err_msg=k, **TOL)
    _assert_vars_close(state.variables, jstate.variables)


def test_sampled_cohorts_with_dropout_match_jax(setup):
    """On-device cohort sampling (2 of 3 clients) and dropout (0.4) over
    three fused rounds: the same cohorts, survivors and variables as the
    JAX engine's ``make_multi_round_fn``."""
    jopt = jclient.make_client_optimizer("sgd", 0.05, momentum=0.9, weight_decay=1e-3)
    jlu = jclient.make_local_update(_jax_bundle(), jopt, 1)
    x, y, mask, ns, _, ids = setup["data"]
    part = np.ones(K, np.float32)
    jmulti = jax.jit(jfedavg.make_multi_round_fn(jlu, 3, clients_per_round=2,
                                                 drop_prob=0.4))
    jstate = jfedavg.ServerState(variables=setup["jvars"], opt_state=(),
                                 round_idx=jnp.zeros((), jnp.int32),
                                 key=jax.random.PRNGKey(5))
    jstate, jm = jmulti(jstate, *(jnp.asarray(a) for a in (x, y, mask, ns, part, ids)))
    multi = make_multi_round_fn(_torch_local_update(shuffle=True), 3,
                                clients_per_round=2, drop_prob=0.4, device="cpu")
    state = ServerState(from_jax_variables(setup["jvars"], device="cpu"), (), 0,
                        rnglib.PRNGKey(5))
    state, m = multi(state, *(torch.from_numpy(a) for a in (x, y, mask, ns, part)), ids)
    assert m["participants"].tolist() == np.asarray(jm["participants"]).tolist()
    assert 1.0 in m["participants"].tolist()  # a dropout took a client out
    for k, v in jm.items():
        np.testing.assert_allclose(m[k].numpy(), np.asarray(v), err_msg=k, **TOL)
    _assert_vars_close(state.variables, jstate.variables)


def _clip_params(bound):
    """Norm-difference clipping of each client's params delta, the port's
    counterpart of the JAX package's ``make_robust_transform``."""
    seen = {}

    def transform(old, stacked, weights, keys):
        seen["keys"] = keys
        p = stacked["params"]
        sq = sum(((p[n] - old["params"][n][None]) ** 2).flatten(1).sum(1) for n in p)
        scale = torch.clamp(bound / torch.clamp_min(sq.sqrt(), 1e-12), max=1.0)
        clipped = {n: old["params"][n][None] + scale.view(-1, *[1] * (v.ndim - 1))
                   * (v - old["params"][n][None]) for n, v in p.items()}
        return {**stacked, "params": clipped}

    return transform, seen


def test_aggregate_transform_matches_jax(setup):
    """A norm-clipping aggregate_transform (bound 0.05, below every
    client's delta) on the stacked clients, against the JAX engine with
    ``make_robust_transform``; its per-client keys are the JAX
    aggregation stream's."""
    jopt = jclient.make_client_optimizer("sgd", 0.05, momentum=0.9, weight_decay=1e-3)
    jlu = jclient.make_local_update(_jax_bundle(), jopt, 1, shuffle=False)
    jrf = jax.jit(jfedavg.make_round_fn(
        jlu, aggregate_transform=jrobust.make_robust_transform(
            "norm_diff_clipping", norm_bound=0.05)))
    jstate = jfedavg.ServerState(variables=setup["jvars"], opt_state=(),
                                 round_idx=jnp.zeros((), jnp.int32),
                                 key=jax.random.PRNGKey(0))
    jargs = tuple(jnp.asarray(a) for a in setup["data"])
    transform, seen = _clip_params(0.05)
    rf = make_round_fn(_torch_local_update(), aggregate_transform=transform, device="cpu")
    plain = make_round_fn(_torch_local_update(), device="cpu")
    state = ServerState(from_jax_variables(setup["jvars"], device="cpu"), (), 0,
                        rnglib.PRNGKey(0))
    args = _torch_args(setup["data"])
    unclipped, _ = plain(state, *args)
    for r in range(2):
        jstate, jm = jrf(jstate, *jargs)
        state, m = rf(state, *args)
        if r == 0:  # the clip moved the round's result
            name = "Dense_0.kernel"
            assert not torch.allclose(unclipped.variables["params"][name],
                                      state.variables["params"][name], **TOL)
        for k, v in jm.items():
            np.testing.assert_allclose(float(m[k]), float(v), err_msg=k, **TOL)
        k_agg = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), r), 1)
        want = np.stack([np.asarray(jax.random.fold_in(k_agg, s)) for s in range(K)])
        assert seen["keys"].tobytes() == want.tobytes()
    _assert_vars_close(state.variables, jstate.variables)


def test_scheduled_multi_round_fn_matches_the_round_loop(setup):
    """R cohort blocks stacked [R, K, ...] through one scheduled call equal
    R round-function calls with run_round's dropout draw, bit for bit."""
    x, y, mask, ns, part, ids = _torch_args(setup["data"])
    lu = _torch_local_update(shuffle=True)
    variables = from_jax_variables(setup["jvars"], device="cpu")
    order = [[0, 1, 2], [2, 0, 1], [1, 2, 0]]
    blocks = [tuple(t[o] for t in (x, y, mask, ns)) for o in order]
    sched = make_scheduled_multi_round_fn(lu, drop_prob=0.5, drop_seed=4, device="cpu")
    st_a, m_a = sched(ServerState(variables, (), 0, rnglib.PRNGKey(1)),
                      *(torch.stack([b[j] for b in blocks]) for j in range(4)),
                      torch.ones(3, K), np.array(order))
    rf = make_round_fn(lu, device="cpu")
    st_b = ServerState(variables, (), 0, rnglib.PRNGKey(1))
    rows = []
    for r, (bx, by, bm, bns) in enumerate(blocks):
        p = inject_dropout(rnglib.PRNGKey(4), r, torch.ones(K), 0.5)
        st_b, m = rf(st_b, bx, by, bm, bns, p, order[r])
        rows.append(m)
    assert st_a.round_idx == st_b.round_idx == 3
    for k in m_a:
        assert m_a[k].tolist() == [float(r[k]) for r in rows], k
    for coll in variables:
        for n in variables[coll]:
            assert torch.equal(st_a.variables[coll][n], st_b.variables[coll][n]), n


def _sim_dataset():
    return synthetic_classification(num_train=144, num_test=32,
                                    input_shape=(HW, HW, 3), num_clients=6, seed=2)


def test_run_fused_sampled_matches_run():
    """The sampled-cohort fused driver (3 of 6 clients, dropout 0.3, two
    rounds per call, augmentation) equals the dispatch loop bit for bit,
    history and variables."""
    cfg = FedAvgConfig(num_clients=6, clients_per_round=3, comm_rounds=5,
                       batch_size=8, lr=0.05, momentum=0.9, weight_decay=1e-3,
                       frequency_of_the_test=2, seed=3, drop_prob=0.3)
    aug = make_image_augment(pad=2, cutout=4)
    a = FedAvgSimulation(_torch_bundle(), _sim_dataset(), cfg, device="cpu",
                         augment_fn=aug)
    b = FedAvgSimulation(_torch_bundle(), _sim_dataset(), cfg, device="cpu",
                         augment_fn=aug)
    ha, hb = a.run(), b.run_fused_sampled(rounds_per_call=2)
    assert [r["round"] for r in ha] == [r["round"] for r in hb] == list(range(5))
    for ra, rb in zip(ha, hb):
        for k in ("loss_sum", "correct", "count", "steps", "participants"):
            assert ra[k] == rb[k], k
        assert ("test_acc" in ra) == ("test_acc" in rb)
    assert min(r["participants"] for r in ha) < 3  # dropout took clients out
    assert ha[-1]["test_acc"] == hb[-1]["test_acc"]
    for coll in a.state.variables:
        for k, v in a.state.variables[coll].items():
            assert torch.equal(v, b.state.variables[coll][k]), k


def test_simulation_sampled_augmented_run_matches_jax():
    """FedAvgSimulation end to end (host-sampled 2 of 4 clients, dropout
    0.4, per-epoch augmentation, periodic eval) against the JAX
    simulation from the same variables: the same cohorts, survivors,
    metrics and model (tolerance 1e-4).  Plain SGD: with momentum 0.9
    this 8x8 model is chaotic by round 3 (a float64 run of the JAX
    simulation ends far from both float32 engines), so no tolerance could
    tell a fault from rounding there."""
    kw = dict(num_train=96, num_test=32, input_shape=(HW, HW, 3), num_clients=4,
              seed=1)
    cfg = dict(num_clients=4, clients_per_round=2, comm_rounds=3, batch_size=8,
               lr=0.05, weight_decay=1e-3, frequency_of_the_test=2, seed=6,
               drop_prob=0.4)
    jsim = jfedavg.FedAvgSimulation(
        _jax_bundle(), jsynthetic(**kw), jfedavg.FedAvgConfig(**cfg),
        augment_fn=jaugment.make_image_augment(pad=2, cutout=4))
    sim = FedAvgSimulation(_torch_bundle(), synthetic_classification(**kw),
                           FedAvgConfig(**cfg), device="cpu",
                           augment_fn=make_image_augment(pad=2, cutout=4))
    jvars = jax.tree_util.tree_map(np.asarray, jsim.state.variables)
    sim.state = sim.state._replace(variables=from_jax_variables(jvars, device="cpu"))
    assert sim.state.key.tobytes() == np.asarray(jsim.state.key).tobytes()
    jh, th = jsim.run(), sim.run()
    for jr, tr in zip(jh, th):
        for k in ("loss_sum", "correct", "count", "steps", "participants",
                  "test_acc", "test_loss"):
            if k in jr:
                np.testing.assert_allclose(tr[k], jr[k], err_msg=k, **TOL)
    assert sorted(r["participants"] for r in th)[0] == 1.0
    _assert_vars_close(sim.state.variables, jsim.state.variables)


_F64_LOCAL_UPDATE = r"""
import sys
import jax
import jax.numpy as jnp
import numpy as np
import fedml_tpu.core.client as jclient
from fedml_tpu.models.base import ModelBundle
from fedml_tpu.models.resnet import Bottleneck, CifarResNet

z = np.load(sys.argv[1])
jb = ModelBundle(module=CifarResNet(block=Bottleneck, layers=(1, 1, 1), num_classes=10),
                 input_shape=(8, 8, 3))
treedef = jax.tree_util.tree_structure(jb.init(jax.random.PRNGKey(0)))
v = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(z[f"leaf{i}"], jnp.float64)
                                           for i in range(treedef.num_leaves)])
opt = jclient.make_client_optimizer("sgd", 0.05, momentum=0.9, weight_decay=1e-3)
lu = jclient.make_local_update(jb, opt, 2)
out, _ = jax.jit(lu.fn)(v, jnp.asarray(z["x"], jnp.float64), jnp.asarray(z["y"]),
                        jnp.asarray(z["m"], jnp.float64), jnp.asarray(z["key"]))
np.savez(sys.argv[2], *[np.asarray(a) for a in jax.tree_util.tree_leaves(out)])
"""


def test_local_update_tracks_float64_where_xla_float32_drifts(setup, tmp_path):
    """Client 1 of the fixture under the round-0 training key of
    PRNGKey(3), shuffled, 2 epochs: the JAX package run in float64 (in a
    subprocess with x64 on) is the exact answer.  The port's float32
    update stays within 1e-5 of it, while the JAX engine's float32
    update on XLA's CPU backend drifts more than 1e-3 from it (in the
    second epoch), which is why the shuffled parity rounds run key 5."""
    import subprocess
    import sys

    x, y, mask = (a[1] for a in setup["data"][:3])
    key = rnglib.fold_in(rnglib.fold_in(rnglib.fold_in(rnglib.PRNGKey(3), 0), 0), 1)
    leaves = jax.tree_util.tree_leaves(setup["jvars"])
    np.savez(tmp_path / "in.npz", x=x, y=y, m=mask, key=key,
             **{f"leaf{i}": a for i, a in enumerate(leaves)})
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(filter(None, [os.getcwd(), env.get("PYTHONPATH")])))
    subprocess.run([sys.executable, "-c", _F64_LOCAL_UPDATE, str(tmp_path / "in.npz"),
                    str(tmp_path / "out.npz")], env=env, check=True, timeout=300)
    out = np.load(tmp_path / "out.npz")
    exact = [out[f"arr_{i}"] for i in range(len(out.files))]

    opt = make_client_optimizer("sgd", 0.05, momentum=0.9, weight_decay=1e-3)
    tvars, _ = make_local_update(_torch_bundle(), opt, 2)(
        from_jax_variables(setup["jvars"], device="cpu"), torch.from_numpy(x),
        torch.from_numpy(y), torch.from_numpy(mask), key)
    jopt = jclient.make_client_optimizer("sgd", 0.05, momentum=0.9, weight_decay=1e-3)
    jvars, _ = jax.jit(jclient.make_local_update(_jax_bundle(), jopt, 2).fn)(
        setup["jvars"], jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask), jnp.asarray(key))

    def err(tree):
        return max(float(np.abs(np.asarray(a, np.float64) - b).max())
                   for a, b in zip(jax.tree_util.tree_leaves(tree), exact))

    assert err(to_jax_variables(tvars)) < 1e-5
    assert err(jvars) > 1e-3  # the drift this test documents


@pytest.mark.parametrize("round_idx", [2273, 5032, 4104])
def test_eligible_mask_breaks_score_ties_as_jax(round_idx):
    """Under ``PRNGKey(0)`` with 4096 eligible clients and K 2048, two
    uniform scores tie across the K-th place in these rounds; JAX's
    ``top_k`` keeps the lower index, and so must the port (``torch.topk``
    kept the higher one in rounds 2273 and 5032)."""
    n, k = 4096, 2048
    part = np.ones(n, np.float32)
    want = jsampling.eligible_participation_mask(jax.random.PRNGKey(0), round_idx,
                                                 jnp.asarray(part), k)
    got = eligible_participation_mask(rnglib.PRNGKey(0), round_idx,
                                      torch.from_numpy(part), k)
    key = rnglib.fold_in(rnglib.fold_in(rnglib.PRNGKey(0), round_idx), 0x5A11)
    scores = np.sort(rnglib.uniform(key, (n,)).numpy())[::-1]
    assert scores[k - 1] == scores[k]  # the tie sits on the boundary
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("driver", ["run", "run_fused", "run_fused_sampled"])
def test_comm_counters_match_jax_under_dropout(driver):
    """Both engines emit the same ``comm.*`` series at ``drop_prob > 0``:
    the dispatch loop counts the realized uploads, the fused drivers the
    expectation ``round(cohort · rounds · (1 − drop_prob))`` per chunk."""
    from fedml_tpu.core.metrics import MetricsLogger as JMetricsLogger
    from fedml_tpu.models.linear import logistic_regression as jlogistic
    from fedml_tpu.obs.telemetry import Telemetry as JTelemetry
    from fedml_tpu_torch.core.metrics import MetricsLogger
    from fedml_tpu_torch.models.linear import logistic_regression
    from fedml_tpu_torch.obs.telemetry import Telemetry

    kw = dict(num_train=240, num_test=40, input_shape=(16,), num_classes=4,
              num_clients=6, seed=0)
    per_round = 6 if driver == "run_fused" else 3
    cfg = dict(num_clients=6, clients_per_round=per_round, comm_rounds=5,
               batch_size=16, lr=0.1, frequency_of_the_test=2, seed=2, drop_prob=0.3)
    jsim = jfedavg.FedAvgSimulation(jlogistic(16, 4), jsynthetic(**kw),
                                    jfedavg.FedAvgConfig(**cfg),
                                    metrics=JMetricsLogger(telemetry=JTelemetry()))
    sim = FedAvgSimulation(logistic_regression(16, 4, device="cpu"),
                           synthetic_classification(**kw), FedAvgConfig(**cfg),
                           device="cpu", metrics=MetricsLogger(telemetry=Telemetry()))
    getattr(jsim, driver)()
    getattr(sim, driver)()

    def comm(snapshot):
        return {k: v for k, v in snapshot["counters"].items() if k.startswith("comm.")}

    got, want = comm(sim.metrics.telemetry.snapshot()), comm(jsim.metrics.telemetry.snapshot())
    assert got == want and got["comm.recv_msgs{msg_type=C2S_SEND_MODEL}"] > 0
    if driver != "run":  # the expectation, not the realized count
        assert got["comm.recv_msgs{msg_type=C2S_SEND_MODEL}"] != sum(
            r["participants"] for r in sim.history)
