"""The FedAvg-engine algorithm family of the port (FedProx, FedOpt,
FedNova, robust FedAvg, hierarchical FedAvg) held against the JAX
package on the CPU, on the same numpy data and the same seeds.

- ``core/robust.py``: clipping and the trimmed mean within 1e-6; the
  coordinate median (even and odd K) and the weak-DP noise of a
  ``(seed, round, slot)`` bit for bit.
- ``data/edge_case.py``: ``make_backdoor`` bit for bit.
- ``nova_coefficient`` within 1e-6 relative (``ρ^τ``: XLA's float32 pow
  against a float64 one rounded).
- Two rounds of each driver on logistic regression (and FedOpt/FedNova
  on a narrow BatchNorm ResNet), the final variables and every history
  row (``attacking`` and ``backdoor_acc`` included) within 1e-5; the
  entry point ``experiments/run.py`` against the JAX one on the MNIST
  stand-in within 1e-4, as the zoo's history test holds it.
- The port's own identities (FedProx at mu 0 and FedOpt sgd at lr 1 are
  FedAvg, the fused drivers equal ``run()``), crash + resume through the
  entry point bit-identical to the uninterrupted run for each driver.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms import fedavg as jfedavg
from fedml_tpu.algorithms.fedavg_robust import FedAvgRobustSimulation as JRobust
from fedml_tpu.algorithms.fednova import FedNovaSimulation as JNova
from fedml_tpu.algorithms.fednova import nova_coefficient as jnova_coefficient
from fedml_tpu.algorithms.fedopt import FedOptSimulation as JFedOpt
from fedml_tpu.algorithms.fedprox import FedProxSimulation as JFedProx
from fedml_tpu.algorithms.hierarchical import HierarchicalSimulation as JHier
from fedml_tpu.algorithms.hierarchical import assign_groups as jassign_groups
from fedml_tpu.core import robust as jrobust
from fedml_tpu.data.edge_case import make_backdoor as jmake_backdoor
from fedml_tpu.data.synthetic import synthetic_classification as jsynthetic
from fedml_tpu.experiments import run as jrun
from fedml_tpu.models.base import ModelBundle as JBundle
from fedml_tpu.models.linear import logistic_regression as jlr
from fedml_tpu.models.resnet import Bottleneck as JBottleneck
from fedml_tpu.models.resnet import CifarResNet as JCifarResNet
from fedml_tpu_torch.algorithms.fedavg import FedAvgConfig, FedAvgSimulation, InjectedCrash
from fedml_tpu_torch.algorithms.fedavg_robust import FedAvgRobustSimulation
from fedml_tpu_torch.algorithms.fednova import FedNovaSimulation, nova_coefficient
from fedml_tpu_torch.algorithms.fedopt import FedOptSimulation
from fedml_tpu_torch.algorithms.fedprox import FedProxSimulation
from fedml_tpu_torch.algorithms.hierarchical import HierarchicalSimulation, assign_groups
from fedml_tpu_torch.core import rng as rnglib
from fedml_tpu_torch.core import robust
from fedml_tpu_torch.core.checkpoint import CheckpointManager
from fedml_tpu_torch.core.types import FedDataset
from fedml_tpu_torch.data.edge_case import make_backdoor
from fedml_tpu_torch.experiments import run
from fedml_tpu_torch.models.base import ModelBundle
from fedml_tpu_torch.models.convert import from_jax_variables, to_jax_variables
from fedml_tpu_torch.models.linear import logistic_regression
from fedml_tpu_torch.models.resnet import Bottleneck, CifarResNet

CPU = torch.device("cpu")
TOL = {"rtol": 1e-5, "atol": 1e-5}
ROW_KEYS = ("loss_sum", "correct", "count", "steps", "participants", "train_acc",
            "train_loss", "test_acc", "test_loss", "test_count", "backdoor_acc")


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# -- data, models, drivers on both sides ----------------------------------------------

def _jds(num_clients=4, n=400, seed=0, partition="hetero", shape=(16,)):
    return jsynthetic(num_train=n, num_test=120, input_shape=shape, num_classes=4,
                      num_clients=num_clients, partition=partition, partition_alpha=0.5,
                      noise=0.5, seed=seed)


def _port_ds(jds):
    return FedDataset(
        train_x=np.asarray(jds.train_x), train_y=np.asarray(jds.train_y),
        test_x=np.asarray(jds.test_x), test_y=np.asarray(jds.test_y),
        train_client_idx={int(k): np.asarray(v) for k, v in jds.train_client_idx.items()},
        test_client_idx=None, num_classes=jds.num_classes, name=jds.name)


def _cfg(**kw):
    base = dict(num_clients=4, clients_per_round=4, comm_rounds=2, epochs=1,
                batch_size=20, lr=0.1, frequency_of_the_test=1)
    base.update(kw)
    return base


def _lr_bundles(shape):
    return jlr(shape[0], 4), logistic_regression(shape[0], 4, device="cpu")


def _resnet_bundles(shape):
    jb = JBundle(module=JCifarResNet(block=JBottleneck, layers=(1, 1, 1), num_classes=4),
                 input_shape=shape)
    return jb, ModelBundle(CifarResNet(Bottleneck, (1, 1, 1), 4), shape, CPU)


def _pair(jcls, tcls, jds, cfg, bundles, **kw):
    jb, tb = bundles
    return (jcls(jb, jds, jfedavg.FedAvgConfig(**cfg), **kw),
            tcls(tb, _port_ds(jds), FedAvgConfig(**cfg), device="cpu", **kw))


def _assert_vars_close(tvars, jvars, tol=TOL):
    flat_t = jax.tree_util.tree_flatten_with_path(to_jax_variables(tvars))[0]
    flat_j = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(np.asarray, jvars))[0])
    assert len(flat_t) == len(flat_j)
    for path, leaf in flat_t:
        np.testing.assert_allclose(leaf, flat_j[path], err_msg=str(path), **tol)


def _assert_rows_close(trows, jrows, tol=TOL):
    assert len(trows) == len(jrows)
    for r, (t, j) in enumerate(zip(trows, jrows)):
        assert t["round"] == j["round"]
        assert t.get("attacking") == j.get("attacking"), r
        for k in ROW_KEYS:
            assert (k in t) == (k in j), (r, k)
            if k in j:
                np.testing.assert_allclose(t[k], j[k], err_msg=f"round {r} {k}", **tol)


# -- core/robust.py ---------------------------------------------------------------------

def _resnet_params(seed=0):
    jb, _ = _resnet_bundles((8, 8, 3))
    return jax.tree_util.tree_map(np.asarray, jb.init(jax.random.PRNGKey(seed)))


def _stacked(params, k, scale, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: (p[None] + scale * rng.standard_normal((k, *p.shape))).astype(np.float32),
        params)


def _port_params(tree):
    return from_jax_variables({"params": tree}, device="cpu")["params"]


def test_clip_stacked_params_matches_jax():
    g = _resnet_params()["params"]
    # client 0 well inside the bound, the others clipped
    scales = np.array([1e-5, 0.05, 0.5], np.float32)
    rng = np.random.RandomState(1)
    stacked = jax.tree_util.tree_map(lambda p: (p[None] + scales.reshape(
        -1, *[1] * p.ndim) * rng.standard_normal((3, *p.shape))).astype(np.float32), g)
    want = jrobust.clip_stacked_params(jax.tree_util.tree_map(jnp.asarray, g),
                                       jax.tree_util.tree_map(jnp.asarray, stacked), 2.0)
    got = robust.clip_stacked_params(_port_params(g), _port_params(stacked), 2.0)
    norms = robust.param_delta_norms(_port_params(g), got)
    assert norms[0] < 2.0 and torch.allclose(norms[1:], torch.tensor(2.0), rtol=1e-5)
    np.testing.assert_allclose(
        robust.param_delta_norms(_port_params(g), _port_params(stacked)).numpy(),
        np.asarray(jrobust.param_delta_norms(g, stacked)), rtol=1e-6)
    _assert_vars_close({"params": got}, {"params": want}, {"rtol": 1e-6, "atol": 1e-7})


@pytest.mark.parametrize("k", [4, 5])
def test_coordinate_median_is_jax_bitwise(k):
    """At an even K the median is the mean of the two middle values (as
    ``jnp.median``), not ``torch.median``'s lower one."""
    g = _resnet_params()["params"]
    stacked = _stacked(g, k, 0.1, 2)
    want = jrobust.coordinate_median(jax.tree_util.tree_map(jnp.asarray, stacked))
    got = robust.coordinate_median(_port_params(stacked))
    for path, leaf in jax.tree_util.tree_flatten_with_path(to_jax_variables({"p": got}))[0]:
        np.testing.assert_array_equal(
            leaf, np.asarray(dict(jax.tree_util.tree_flatten_with_path({"p": want})[0])[path]))
    if k % 2 == 0:
        leaf = next(iter(_port_params(stacked).values()))
        assert not torch.equal(got[next(iter(got))], torch.median(leaf, dim=0).values)


def test_trimmed_mean_matches_jax():
    g = _resnet_params()["params"]
    stacked = _stacked(g, 5, 0.1, 3)
    want = jrobust.trimmed_mean(jax.tree_util.tree_map(jnp.asarray, stacked), 0.2)
    got = robust.trimmed_mean(_port_params(stacked), 0.2)
    _assert_vars_close({"params": got}, {"params": want}, {"rtol": 1e-6, "atol": 1e-7})
    with pytest.raises(ValueError, match="trim_frac"):
        robust.trimmed_mean(_port_params(stacked), 0.5)


def test_weak_dp_noise_is_jax_bitwise():
    """The noise of a (seed, round, slot) lands on the same leaves with
    the same bits: one key per leaf in JAX's sorted leaf order."""
    tree = _resnet_params()
    stacked = {c: _stacked(v, 3, 0.01, 4) for c, v in tree.items()}
    slots = [0, 5, 2]
    jkeys = jnp.stack([jrobust.agg_noise_key(jax.random.PRNGKey(7), 3, s) for s in slots])
    tkeys = np.stack([robust.agg_noise_key(rnglib.PRNGKey(7), 3, s) for s in slots])
    np.testing.assert_array_equal(tkeys, np.asarray(jax.random.key_data(jkeys)))
    want = jrobust.add_weak_dp_noise(jax.tree_util.tree_map(jnp.asarray, stacked), jkeys,
                                     0.025)
    got = robust.add_weak_dp_noise(from_jax_variables(stacked, device="cpu"), tkeys, 0.025)
    flat_j = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(np.asarray, want))[0])
    for path, leaf in jax.tree_util.tree_flatten_with_path(to_jax_variables(got))[0]:
        np.testing.assert_array_equal(leaf, flat_j[path], err_msg=str(path))
    assert not np.array_equal(flat_j[path][0], flat_j[path][1])


def test_make_robust_transform_refuses_an_unknown_defense():
    with pytest.raises(ValueError, match="unknown defense_type"):
        robust.make_robust_transform("krum")


# -- data/edge_case.py, nova_coefficient, assign_groups ----------------------------------

@pytest.mark.parametrize("shape", [(16,), (8, 8, 3)], ids=["flat", "image"])
def test_make_backdoor_is_jax_bitwise(shape):
    jds = _jds(shape=shape, seed=1)
    want = jmake_backdoor(jds, 1, target_label=2, poison_fraction=0.3, seed=5)
    got = make_backdoor(_port_ds(jds), 1, target_label=2, poison_fraction=0.3, seed=5)
    for f in ("train_x", "train_y", "backdoor_test_x", "backdoor_test_y"):
        a, b = getattr(got, f), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f


@pytest.mark.parametrize("rho", [0.0, 0.9])
def test_nova_coefficient_matches_jax(rho):
    tau = np.array([0, 1, 2, 5, 17, 40, 120], np.float32)
    want = np.asarray(jnova_coefficient(jnp.asarray(tau), rho))
    got = nova_coefficient(torch.from_numpy(tau), rho).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0] == 1.0 and (rho > 0) == (got[3] > 5.0)


def test_assign_groups_is_jax():
    for n, g in ((10, 3), (7, 2)):
        assert assign_groups(n, g, seed=4) == jassign_groups(n, g, seed=4)


# -- two rounds of each driver against the JAX one ---------------------------------------

DRIVERS = {
    "fedprox": (JFedProx, FedProxSimulation, {"mu": 0.5}, {}),
    "fedopt_adam": (JFedOpt, FedOptSimulation,
                    {"server_optimizer": "adam", "server_lr": 0.05}, {}),
    "fedopt_yogi": (JFedOpt, FedOptSimulation,
                    {"server_optimizer": "yogi", "server_lr": 0.05}, {}),
    "fednova_m09_gmf05": (JNova, FedNovaSimulation, {"gmf": 0.5}, {"momentum": 0.9}),
    "robust_attack_clip": (JRobust, FedAvgRobustSimulation,
                           {"defense_type": "norm_diff_clipping", "norm_bound": 0.3,
                            "poison_fraction": 0.8, "attack_freq": 2}, {}),
    "robust_weak_dp": (JRobust, FedAvgRobustSimulation,
                       {"defense_type": "weak_dp", "norm_bound": 1.0, "stddev": 0.01}, {}),
    "robust_median": (JRobust, FedAvgRobustSimulation, {"defense_type": "median"}, {}),
    "hierarchical": (JHier, HierarchicalSimulation,
                     {"num_groups": 2, "group_comm_round": 2}, {}),
}


@pytest.mark.parametrize("name", list(DRIVERS))
def test_two_rounds_on_lr_match_jax(name):
    jcls, tcls, kw, cfg_kw = DRIVERS[name]
    jds = _jds(partition="power_law", n=320)
    j, t = _pair(jcls, tcls, jds, _cfg(**cfg_kw), _lr_bundles((16,)), **kw)
    jrows, trows = j.run(), t.run()
    _assert_rows_close(trows, jrows)
    _assert_vars_close(t.state.variables, j.state.variables)
    if name.startswith("robust"):
        assert all("backdoor_acc" in r for r in trows)
        assert [r["attacking"] for r in trows] == (
            [True, False] if name == "robust_attack_clip" else [True, True])
    if name.startswith("fednova"):  # the gmf buffer
        _assert_vars_close({"params": t.state.opt_state}, {"params": j.state.opt_state})


@pytest.mark.parametrize("name", ["fedopt_adam", "fednova_m09_gmf05"])
def test_two_rounds_on_a_narrow_resnet_match_jax(name):
    """BatchNorm statistics ride beside the params: FedOpt's come from
    the plain average, FedNova's from its p-weighted one.  The data seed
    is one where XLA's float32 round tracks float64 (ROADMAP C4): at seed
    2, FedNova's two rounds in JAX float32 drift from a float64 JAX run
    by more than the tolerance while the port's stay within it."""
    jcls, tcls, kw, cfg_kw = DRIVERS[name]
    jds = _jds(num_clients=3, n=48, shape=(8, 8, 3), partition="homo", seed=3)
    cfg = _cfg(num_clients=3, clients_per_round=3, batch_size=8, lr=0.05, **cfg_kw)
    j, t = _pair(jcls, tcls, jds, cfg, _resnet_bundles((8, 8, 3)), **kw)
    _assert_rows_close(t.run(), j.run())
    _assert_vars_close(t.state.variables, j.state.variables)


ALGOS = {
    "fedprox": [],
    "fedopt": ["--server_optimizer", "adam", "--server_lr", "0.01"],
    "fednova": ["--momentum", "0.9"],
    "fedavg_robust": ["--norm_bound", "0.5"],
    "hierarchical": [],
}


@pytest.mark.parametrize("algo", list(ALGOS))
def test_run_main_history_matches_jax(tmp_path, algo):
    """The entry point, as a user calls it, on the MNIST stand-in."""
    argv = ["--algorithm", algo, "--dataset", "mnist", "--model", "lr", "--ci", "1",
            "--frequency_of_the_test", "1", *ALGOS[algo]]
    want = jrun.main([*argv, "--run_dir", str(tmp_path / "jax")])["history"]
    got = run.main([*argv, "--device", "cpu", "--run_dir", str(tmp_path / "port")])["history"]
    _assert_rows_close(got, want, {"rtol": 1e-4, "atol": 1e-4})
    assert math.isfinite(got[-1]["test_loss"])


@pytest.mark.parametrize("algo", list(ALGOS))
def test_run_main_crash_and_resume_equal_the_uninterrupted_run(tmp_path, algo):
    def main(ck, *extra):
        return run.main(["--algorithm", algo, "--dataset", "mnist", "--model", "lr",
                         "--ci", "1", "--device", "cpu", "--checkpoint_every", "1",
                         "--checkpoint_dir", str(tmp_path / ck), "--run_dir",
                         str(tmp_path / "runs"), *ALGOS[algo], *extra])

    full = main("a")["history"]
    with pytest.raises(InjectedCrash):
        main("b", "--crash_at_round", "1")
    resumed = main("b", "--resume", "1")
    assert resumed["resumed_rounds"] == 1
    assert resumed["history"][-1]["round"] == full[-1]["round"] == 1
    a = np.load(tmp_path / "a" / "ckpt_2.npz")
    b = np.load(tmp_path / "b" / "ckpt_2.npz")
    assert sorted(a.files) == sorted(b.files) and len(a.files) > 2
    for f in a.files:
        assert a[f].tobytes() == b[f].tobytes(), f


# -- the port's own identities -----------------------------------------------------------

def _leaves(sim):
    return [v for c in sorted(sim.state.variables)
            for _, v in sorted(sim.state.variables[c].items())]


def _ds(**kw):
    return _port_ds(_jds(**kw))


def test_fedprox_mu_zero_is_fedavg_bitwise_and_its_schedule_is_honoured():
    ds, cfg = _ds(), FedAvgConfig(**_cfg())
    a = FedAvgSimulation(logistic_regression(16, 4, device="cpu"), ds, cfg, device="cpu")
    p = FedProxSimulation(logistic_regression(16, 4, device="cpu"), ds, cfg, mu=0.0,
                          device="cpu")
    a.run(), p.run()
    assert all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(p)))
    s = FedProxSimulation(logistic_regression(16, 4, device="cpu"), ds,
                          FedAvgConfig(**_cfg(clients_per_round=2)), device="cpu",
                          sampling_schedule=[[0, 3], [1, 2]])
    assert [list(s._sample_ids(r)) for r in range(3)] == [[0, 3], [1, 2], [0, 3]]


def test_fedopt_sgd_lr1_is_fedavg():
    ds, cfg = _ds(), FedAvgConfig(**_cfg())
    a = FedAvgSimulation(logistic_regression(16, 4, device="cpu"), ds, cfg, device="cpu")
    o = FedOptSimulation(logistic_regression(16, 4, device="cpu"), ds, cfg,
                         server_optimizer="sgd", server_lr=1.0, server_momentum=0.0,
                         device="cpu")
    a.run(), o.run()
    for x, y in zip(_leaves(a), _leaves(o)):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-6)


def test_fednova_equal_steps_and_no_momentum_is_fedavg():
    ds, cfg = _ds(partition="homo"), FedAvgConfig(**_cfg())
    a = FedAvgSimulation(logistic_regression(16, 4, device="cpu"), ds, cfg, device="cpu")
    n = FedNovaSimulation(logistic_regression(16, 4, device="cpu"), ds, cfg, device="cpu")
    a.run(), n.run()
    for x, y in zip(_leaves(a), _leaves(n)):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="weight_decay"):
        FedNovaSimulation(logistic_regression(16, 4, device="cpu"), ds,
                          FedAvgConfig(**_cfg(weight_decay=1e-3)), device="cpu")
    with pytest.raises(ValueError, match="builds its own round kernel"):
        FedNovaSimulation(logistic_regression(16, 4, device="cpu"), ds,
                          FedAvgConfig(**_cfg(compress_codec="int8")), device="cpu")


def test_fused_drivers_equal_run_for_fednova_and_robust():
    """Both fused drivers run FedNova's kernel; run_fused_sampled runs the
    robust attacker's per-round block, and run_fused refuses it."""
    ds = _ds(num_clients=6, n=600, partition="power_law")

    def nova(per_round, rounds, freq):
        return FedNovaSimulation(
            logistic_regression(16, 4, device="cpu"), ds,
            FedAvgConfig(**_cfg(num_clients=6, clients_per_round=per_round,
                                comm_rounds=rounds, momentum=0.9, lr=0.05,
                                frequency_of_the_test=freq)), gmf=0.5, device="cpu")

    def robust_sim():
        return FedAvgRobustSimulation(
            logistic_regression(16, 4, device="cpu"), ds,
            FedAvgConfig(**_cfg(num_clients=6, clients_per_round=3, comm_rounds=4,
                                frequency_of_the_test=2)),
            defense_type="weak_dp", norm_bound=1.0, attack_freq=2, device="cpu")

    for make, fused in ((lambda: nova(3, 4, 2), "run_fused_sampled"),
                        (lambda: nova(6, 3, 2), "run_fused"),
                        (robust_sim, "run_fused_sampled")):
        a, b = make(), make()
        a.run()
        getattr(b, fused)(rounds_per_call=2)
        assert all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b))), fused
        assert [r["round"] for r in a.history] == [r["round"] for r in b.history]
        assert [r.get("attacking") for r in a.history] == [r.get("attacking")
                                                           for r in b.history]
        assert [r.get("backdoor_acc") for r in a.history] == [r.get("backdoor_acc")
                                                              for r in b.history]
    with pytest.raises(ValueError, match="_cohort_block"):
        FedAvgRobustSimulation(logistic_regression(16, 4, device="cpu"), ds,
                               FedAvgConfig(**_cfg(num_clients=6, clients_per_round=6)),
                               device="cpu").run_fused()


def test_checkpoint_restores_the_server_optimizer_state(tmp_path):
    ds = _ds()

    def sim():
        return FedOptSimulation(logistic_regression(16, 4, device="cpu"), ds,
                                FedAvgConfig(**_cfg(comm_rounds=3)),
                                server_optimizer="adam", device="cpu")

    a = sim()
    a.run()
    b = sim()
    b.attach_checkpointing(CheckpointManager(str(tmp_path)), every=1)
    b.crash_at_round = 2
    with pytest.raises(InjectedCrash):
        b.run()
    c = sim()
    c.attach_checkpointing(CheckpointManager(str(tmp_path)), every=1)
    assert c.resume() == 2 and int(c.state.opt_state[0]["count"]) == 2
    c.run(1)
    assert all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(c)))
    assert all(torch.equal(x, y) for x, y in zip(
        a.state.opt_state[0]["nu"].values(), c.state.opt_state[0]["nu"].values()))


def test_run_main_conv_variant_kernel_runs_resnet56_tpu(tmp_path):
    """``--conv_variant kernel`` puts ResNet-56 on the kernel-conv model
    (its plain version on the CPU); any other model refuses it."""
    argv = ["--algorithm", "fedavg_robust", "--defense_type", "weak_dp", "--ci", "1",
            "--device", "cpu", "--conv_variant", "kernel", "--run_dir", str(tmp_path)]
    final = run.main(argv)["final"]
    assert math.isfinite(final["test_loss"]) and 0.0 <= final["backdoor_acc"] <= 1.0
    with pytest.raises(ValueError, match="conv_variant"):
        run.main([*argv, "--model", "resnet20"])
