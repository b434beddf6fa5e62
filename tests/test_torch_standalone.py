"""The standalone drivers beside the FedAvg engine (centralized,
decentralized gossip with online DSGD/PushSum, TurboAggregate, FedGKT)
held against the JAX package on the CPU, on the same numpy data and the
same seeds.

- ``CentralizedTrainer`` on logistic regression and a narrow BatchNorm
  ResNet within 1e-5, and the port's own oracle: FedAvg at full
  participation, one full batch per client, E=1 == centralized SGD within
  2e-5 (the JAX package's ``tests/test_fedavg.py`` oracle).
- ``DecentralizedSimulation``: 2 rounds, the stacked variables, the
  history, ``evaluate_worker`` and ``consensus_distance`` within 1e-5 on
  logistic regression; on a narrow BatchNorm ResNet within 1e-4 (XLA's
  CPU float32 convolution gradients drift from float64 at the ~1e-5
  level over a few momentum-free steps, ROADMAP C4).
- ``run_dsgd``/``run_pushsum`` over a stream of T 200 within 1e-5.
- ``TurboAggregateSimulation``: 2 rounds within 1e-5 + n_clients/scale (a
  client value 1e-7 off can round to the next quantum).
- ``FedGKT`` with ``resnet5_56`` and a (1,1,1) server at 8×8: the stacked
  client init and the server init bit for bit, then 2 rounds of history,
  ``server_logits`` and both variable trees within 1e-4.
- ``experiments/run.py`` for each of the four against the JAX entry point
  (TurboAggregate against the JAX driver's own loop: the JAX dispatch
  calls a ``run`` its class lacks, ROADMAP C4), FedGKT at
  ``--epochs_server 2`` against a float64 JAX run (ROADMAP C7), and the
  refusals.
"""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms import fedgkt as jgkt_mod
from fedml_tpu.algorithms.centralized import CentralizedTrainer as JCentralized
from fedml_tpu.algorithms.decentralized import DecentralizedSimulation as JDecentralized
from fedml_tpu.algorithms.decentralized_online import make_stream as jmake_stream
from fedml_tpu.algorithms.decentralized_online import run_dsgd as jrun_dsgd
from fedml_tpu.algorithms.decentralized_online import run_pushsum as jrun_pushsum
from fedml_tpu.algorithms.turboaggregate import TurboAggregateConfig as JTurboConfig
from fedml_tpu.algorithms.turboaggregate import TurboAggregateSimulation as JTurbo
from fedml_tpu.core import topology as jtopo
from fedml_tpu.core.config import parse_config as jparse_config
from fedml_tpu.data.synthetic import synthetic_classification as jsynthetic
from fedml_tpu.experiments import run as jrun
from fedml_tpu.models import resnet_gkt as jresnet_gkt
from fedml_tpu.models.base import ModelBundle as JBundle
from fedml_tpu.models.linear import logistic_regression as jlr
from fedml_tpu.models.resnet import Bottleneck as JBottleneck
from fedml_tpu.models.resnet import CifarResNet as JCifarResNet
from fedml_tpu.parallel.compat import enable_x64
from fedml_tpu_torch.algorithms.centralized import CentralizedTrainer
from fedml_tpu_torch.algorithms.decentralized import (DecentralizedSimulation,
                                                      make_gossip_round_fn)
from fedml_tpu_torch.algorithms.decentralized_online import make_stream, run_dsgd, run_pushsum
from fedml_tpu_torch.algorithms.fedavg import FedAvgConfig, FedAvgSimulation
from fedml_tpu_torch.algorithms.fedgkt import FedGKT, FedGKTConfig
from fedml_tpu_torch.algorithms.turboaggregate import (TurboAggregateConfig,
                                                       TurboAggregateSimulation)
from fedml_tpu_torch.core import topology
from fedml_tpu_torch.core.types import FedDataset
from fedml_tpu_torch.experiments import run
from fedml_tpu_torch.models import resnet_gkt
from fedml_tpu_torch.models.base import ModelBundle
from fedml_tpu_torch.models.convert import to_jax_variables
from fedml_tpu_torch.models.linear import logistic_regression
from fedml_tpu_torch.models.resnet import Bottleneck, CifarResNet

CPU = torch.device("cpu")
TOL = {"rtol": 1e-5, "atol": 1e-5}


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


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


def _lr_bundles(shape=(16,)):
    return jlr(shape[0], 4), logistic_regression(shape[0], 4, device="cpu")


def _resnet_bundles(shape=(8, 8, 3)):
    jb = JBundle(module=JCifarResNet(block=JBottleneck, layers=(1, 1, 1), num_classes=4),
                 input_shape=shape)
    return jb, ModelBundle(CifarResNet(Bottleneck, (1, 1, 1), 4), shape, CPU)


def _assert_vars_close(tvars, jvars, tol=TOL, exact=False):
    flat_t = jax.tree_util.tree_flatten_with_path(to_jax_variables(tvars))[0]
    flat_j = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(np.asarray, jvars))[0])
    assert len(flat_t) == len(flat_j) > 0
    for path, leaf in flat_t:
        if exact:
            np.testing.assert_array_equal(leaf, flat_j[path], err_msg=str(path))
        else:
            np.testing.assert_allclose(leaf, flat_j[path], err_msg=str(path), **tol)


def _assert_rows_close(trows, jrows, tol=TOL):
    assert len(trows) == len(jrows) > 0
    for r, (t, j) in enumerate(zip(trows, jrows)):
        assert sorted(t) == sorted(j), r
        for k in j:
            np.testing.assert_allclose(t[k], j[k], err_msg=f"row {r} {k}", **tol)


# -- centralized ------------------------------------------------------------------------

def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


@pytest.mark.parametrize("model", ["lr", "resnet"])
def test_centralized_trainer_matches_jax(model):
    """Logistic regression against the JAX trainer.  The narrow BN ResNet
    against the JAX trainer run in float64 (x64, float64 variables and
    images): there XLA's float32 CPU run ends ~7e-3 from float64 after
    10 steps at lr 0.1 (ROADMAP C4), the port's float32 ~7e-5 (float32
    rounding over 10 steps), so the variables are held within 1e-4."""
    shape = (16,) if model == "lr" else (8, 8, 3)
    jds = _jds(n=160 if model == "resnet" else 400, shape=shape)
    jb, tb = _lr_bundles(shape) if model == "lr" else _resnet_bundles(shape)
    kw = dict(batch_size=32, lr=0.1, momentum=0.9 if model == "lr" else 0.0, seed=3)
    tt = CentralizedTrainer(tb, _port_ds(jds), device="cpu", **kw)
    rows_t = [tt.train(1), tt.train(1)]
    ev_t = tt.evaluate()
    var_tol = TOL
    if model == "lr":
        jt = JCentralized(jb, jds, **kw)
        rows_j = [jt.train(1), jt.train(1)]
        ev_j = jt.evaluate()
    else:
        drift = JCentralized(jb, jds, **kw)
        drift.train(2)
        with enable_x64():
            jt = JCentralized(jb, jds, **kw)
            jt.variables = _f64(jt.variables)
            x, y, m = jt._train_pack
            jt._train_pack = (x.astype(np.float64), y, m)
            jt._test_pack = (jt._test_pack[0].astype(np.float64), *jt._test_pack[1:])
            rows_j = [jt.train(1), jt.train(1)]
            ev_j = jt.evaluate()
        var_tol = {"rtol": 1e-4, "atol": 1e-4}
        err = max(float(np.abs(np.asarray(a, np.float64) - np.asarray(b)).max())
                  for a, b in zip(jax.tree_util.tree_leaves(drift.variables),
                                  jax.tree_util.tree_leaves(jt.variables)))
        assert err > 1e-3  # the XLA float32 drift the float64 reference avoids
    _assert_rows_close(rows_t, rows_j)
    _assert_vars_close(tt.variables, jt.variables, var_tol)
    assert sorted(ev_t) == sorted(ev_j) == ["test_acc", "test_loss"]
    np.testing.assert_allclose([ev_t[k] for k in ev_j], list(ev_j.values()), **TOL)


def test_fedavg_equals_centralized_oracle():
    """Full participation + one full batch per client + E=1: the FedAvg
    step (sample-weighted gradient average) is the centralized full-batch
    SGD step."""
    ds = _port_ds(_jds(num_clients=4, n=256))
    lr = 0.5
    big_batch = int(ds.client_sample_counts().max())  # each client: one batch
    cfg = FedAvgConfig(num_clients=4, clients_per_round=4, comm_rounds=1, epochs=1,
                       batch_size=big_batch, lr=lr, frequency_of_the_test=100, seed=7)
    sim = FedAvgSimulation(logistic_regression(16, 4, device="cpu"), ds, cfg, device="cpu")
    cent = CentralizedTrainer(logistic_regression(16, 4, device="cpu"), ds, epochs_per_call=1,
                              batch_size=len(ds.train_x), lr=lr, seed=7, shuffle=False,
                              device="cpu")
    for k, v in cent.variables["params"].items():
        assert torch.equal(sim.state.variables["params"][k], v)
    sim.run_round()
    cent.train(1)
    for k, v in cent.variables["params"].items():
        torch.testing.assert_close(sim.state.variables["params"][k], v, rtol=0, atol=2e-5)
    assert not torch.equal(sim.state.variables["params"]["Dense_0.kernel"],
                           logistic_regression(16, 4, device="cpu").init(
                               np.array([0, 7], np.uint32))["params"]["Dense_0.kernel"])


# -- decentralized ----------------------------------------------------------------------

@pytest.mark.parametrize("model", ["lr", "resnet"])
def test_decentralized_simulation_matches_jax(model):
    """The ResNet at lr 0.05: at 0.1 the two float32 runs part by 2.6e-4
    after 2 rounds while each ends 4.3e-3 from a float64 JAX run (float32
    rounding amplified by BN training, ROADMAP C4); at 0.05 they agree to
    3e-7."""
    shape = (16,) if model == "lr" else (8, 8, 3)
    tol = TOL
    jds = _jds(num_clients=6, n=400 if model == "lr" else 192, shape=shape)
    jb, tb = _lr_bundles(shape) if model == "lr" else _resnet_bundles(shape)
    # a ring lattice (±1, ±2) plus one random link per node: not complete,
    # so the workers keep apart
    w = jtopo.SymmetricTopologyManager(6, 3, seed=1).generate_topology()
    np.testing.assert_array_equal(
        w, topology.SymmetricTopologyManager(6, 3, seed=1).generate_topology())
    kw = dict(epochs=1, batch_size=16, lr=0.1 if model == "lr" else 0.05, seed=2)
    js = JDecentralized(jb, jds, w, **kw)
    ts = DecentralizedSimulation(tb, _port_ds(jds), w, device="cpu", **kw)
    _assert_vars_close(ts.stacked_vars, js.stacked_vars, exact=True)
    _assert_rows_close(ts.run(2), js.run(2), tol)
    _assert_vars_close(ts.stacked_vars, js.stacked_vars, tol)
    for worker in (0, 5):
        ev_t, ev_j = ts.evaluate_worker(worker), js.evaluate_worker(worker)
        np.testing.assert_allclose([ev_t[k] for k in ev_j], list(ev_j.values()), **tol)
    np.testing.assert_allclose(ts.consensus_distance(), js.consensus_distance(), **tol)
    assert ts.consensus_distance() > 0


def test_gossip_spmd_forms_refused():
    """The SPMD forms run (on 8 ranks against JAX: test_torch_spmd_gossip.py);
    here on a 1-rank mesh in process: the ring mixes a client with itself
    twice (w_self + w_left + w_right in float32), the dense form applies
    its 1x1 matrix, and a matrix is still required off the ring."""
    from fedml_tpu_torch.core.client import make_client_optimizer, make_local_update
    from fedml_tpu_torch.core.rng import PRNGKey
    from fedml_tpu_torch.core.types import pack_clients
    from fedml_tpu_torch.data.synthetic import synthetic_classification
    from fedml_tpu_torch.parallel.compat import shard_map, single_rank_group
    from fedml_tpu_torch.parallel.spmd import make_1d_mesh

    ds = synthetic_classification(num_train=40, num_test=8, input_shape=(8,),
                                  num_classes=2, num_clients=1, partition="homo", seed=0)
    bundle = logistic_regression(8, 2, device="cpu")
    lu = make_local_update(bundle, make_client_optimizer("sgd", 0.1), 1)
    pack = pack_clients(ds, [0], batch_size=8)
    args = [torch.from_numpy(a) for a in (pack.x, pack.y, pack.mask)]
    stacked = {c: {k: v[None] for k, v in d.items()} for c, d in
               bundle.init(PRNGKey(0)).items()}
    trained, _ = make_gossip_round_fn(lu, np.eye(1), device="cpu")(
        stacked, *args, PRNGKey(1), np.arange(1))
    with single_rank_group("cpu"):
        mesh = make_1d_mesh(axis="clients", device="cpu")
        ring, rm = shard_map(make_gossip_round_fn(lu, None, axis_name="clients", ring=True,
                                                  device="cpu"), mesh=mesh)(
            stacked, *args, PRNGKey(1), np.arange(1))
        dense, _ = shard_map(make_gossip_round_fn(lu, np.eye(1), axis_name="clients",
                                                  device="cpu"), mesh=mesh)(
            stacked, *args, PRNGKey(1), np.arange(1))
    third = 1 / 3
    for c in trained:
        for k, t in trained[c].items():
            assert torch.equal(dense[c][k], t)
            assert torch.equal(ring[c][k], third * t + third * t + third * t)
    assert float(rm["count"]) == 40.0
    with pytest.raises(ValueError, match="mixing_matrix"):
        make_gossip_round_fn(lambda *a: None, None, device="cpu")
    with pytest.raises(ValueError, match="mixing_matrix"):
        make_gossip_round_fn(lambda *a: None, None, axis_name="clients", device="cpu")


@pytest.mark.parametrize("algo", ["dsgd", "pushsum"])
def test_online_gossip_matches_jax(algo):
    xs, ys = make_stream(200, 6, 5, seed=4)
    jxs, jys = jmake_stream(200, 6, 5, seed=4)
    np.testing.assert_array_equal(xs, jxs)
    np.testing.assert_array_equal(ys, jys)
    if algo == "dsgd":
        w = topology.SymmetricTopologyManager(6, 3, seed=0).generate_topology()
        got, want = run_dsgd(xs, ys, w, 0.2, device="cpu"), jrun_dsgd(xs, ys, w, 0.2)
    else:
        w = topology.AsymmetricTopologyManager(6, 4, 2, seed=0).generate_topology()
        got, want = run_pushsum(xs, ys, w.T, 0.2, device="cpu"), jrun_pushsum(xs, ys, w.T, 0.2)
    assert got.regret_curve.shape == (200,) and got.final_params.shape == (6, 6)
    np.testing.assert_allclose(got.regret_curve, want.regret_curve, **TOL)
    np.testing.assert_allclose(got.final_params, want.final_params, **TOL)
    np.testing.assert_allclose(got.consensus_distance, want.consensus_distance, **TOL)
    assert got.regret_curve[-1] < got.regret_curve[10]


# -- TurboAggregate ---------------------------------------------------------------------

@pytest.mark.parametrize("model", ["lr", "resnet"])
def test_turboaggregate_matches_jax(model):
    """The whole tree goes through the field, BatchNorm statistics too.
    The ResNet at lr 0.02: there the two sides' aggregates part by one
    quantum (2^-16) in 15 of 128,372 values; at lr 0.05 the float32 local
    updates already part by 9e-5 in round 0 (ROADMAP C4)."""
    shape = (16,) if model == "lr" else (8, 8, 3)
    jds = _jds(n=400 if model == "lr" else 160, shape=shape)
    jb, tb = _lr_bundles(shape) if model == "lr" else _resnet_bundles(shape)
    cfg = dict(num_clients=4, comm_rounds=2, epochs=1, batch_size=20,
               lr=0.1 if model == "lr" else 0.02, seed=5)
    js = JTurbo(jb, jds, JTurboConfig(**cfg))
    ts = TurboAggregateSimulation(tb, _port_ds(jds), TurboAggregateConfig(**cfg),
                                  device="cpu")
    tol = {"rtol": 1e-5, "atol": 1e-5 + 4 / 2.0 ** 16}
    rows_j = [js.run_round() for _ in range(2)]
    rows_j[-1].update(js.evaluate_global())
    _assert_rows_close(ts.run(), rows_j, tol)
    _assert_vars_close(ts.variables, js.variables, tol)


# -- FedGKT ------------------------------------------------------------------------------

def _gkt_pair(device=CPU):
    jpair = (jresnet_gkt.resnet5_56(num_classes=3, image_size=8),
             JBundle(module=jresnet_gkt.GKTServerResNet(layers=(1, 1, 1), num_classes=3),
                     input_shape=(8, 8, 16)))
    tpair = (resnet_gkt.resnet5_56(num_classes=3, image_size=8, device=device),
             ModelBundle(resnet_gkt.GKTServerResNet((1, 1, 1), 3), (8, 8, 16), device))
    return jpair, tpair


def test_fedgkt_matches_jax():
    jds = jsynthetic(num_train=56, num_test=24, input_shape=(8, 8, 3), num_classes=3,
                     num_clients=3, partition="hetero", partition_alpha=0.5, seed=0)
    # the config's default lr 0.01: at 0.05 this cut is chaotic, JAX's own
    # float32 and float64 runs part by 0.7% in round 0 already
    cfg = dict(num_clients=3, comm_rounds=2, epochs_client=1, epochs_server=2,
               batch_size=8, lr_client=0.01, lr_server=0.01, temperature=3.0,
               alpha=0.5, seed=0)
    jpair, tpair = _gkt_pair()
    ja = jgkt_mod.FedGKT(*jpair, jds, jgkt_mod.FedGKTConfig(**cfg))
    ta = FedGKT(*tpair, _port_ds(jds), FedGKTConfig(**cfg), device="cpu")
    # the vmapped client init and the server init, bit for bit
    _assert_vars_close(ta.client_vars, ja.client_vars, exact=True)
    _assert_vars_close(ta.server_vars, ja.server_vars, exact=True)
    # uneven shards: the smaller clients' last batches are all padding
    assert (ta.mask.sum(dim=2) == 0).any()
    tol = {"rtol": 1e-4, "atol": 1e-4}
    _assert_rows_close(ta.run(), ja.run(), tol)
    np.testing.assert_allclose(ta.server_logits.numpy(), np.asarray(ja.server_logits), **tol)
    _assert_vars_close(ta.client_vars, ja.client_vars, tol)
    _assert_vars_close(ta.server_vars, ja.server_vars, tol)


def test_gkt_models_match_flax():
    """Both nets' forwards (train and eval) on flax's variables."""
    (jc, js), (tc, ts) = _gkt_pair()
    x = np.random.RandomState(0).normal(size=(4, 8, 8, 3)).astype(np.float32)
    cv = tc.init(np.array([0, 1], np.uint32))
    jcv = jc.init(jax.random.PRNGKey(1))
    _assert_vars_close(cv, jcv, exact=True)
    (logits, feats), new = tc.apply_train(cv, torch.from_numpy(x))
    (jlogits, jfeats), jnew = jc.apply_train(jcv, jnp.asarray(x))
    assert feats.shape == (4, 8, 8, 16)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(feats.detach().numpy(), np.asarray(jfeats), **TOL)
    _assert_vars_close(new, jnew)
    sv = ts.init(np.array([0, 2], np.uint32))
    jsv = js.init(jax.random.PRNGKey(2))
    _assert_vars_close(sv, jsv, exact=True)
    np.testing.assert_allclose(ts.apply_eval(sv, feats.detach()).numpy(),
                               np.asarray(js.apply_eval(jsv, jfeats)), **TOL)
    for name, fn in (("resnet8_56", resnet_gkt.resnet8_56),
                     ("resnet56_server", resnet_gkt.resnet56_server),
                     ("resnet110_server", resnet_gkt.resnet110_server)):
        n = sum(p.numel() for p in fn(device="cpu").module.parameters())
        jn = sum(int(np.prod(v.shape)) for v in jax.tree_util.tree_leaves(
            getattr(jresnet_gkt, name)().init(jax.random.PRNGKey(0))["params"]))
        assert n == jn, name


# -- the entry point ---------------------------------------------------------------------

_LR_ARGV = ["--dataset", "mnist", "--model", "lr", "--ci", "1", "--lr", "0.1"]


@pytest.mark.parametrize("algo", ["centralized", "decentralized"])
def test_run_main_matches_jax(tmp_path, algo):
    argv = ["--algorithm", algo, *_LR_ARGV]
    want = jrun.main([*argv, "--run_dir", str(tmp_path / "jax")])
    got = run.main([*argv, "--device", "cpu", "--run_dir", str(tmp_path / "port")])
    tol = {"rtol": 1e-4, "atol": 1e-4}
    _assert_rows_close(got["history"], want["history"], tol)
    _assert_rows_close([got["final"]], [want["final"]], tol)
    with open(tmp_path / "port" / "metrics.jsonl") as f:
        rows = [r for r in map(json.loads, f) if "kind" not in r]
    assert len(rows) == len(got["history"]) == 2  # logged after the run


def test_run_main_turboaggregate_matches_the_jax_driver(tmp_path):
    argv = ["--algorithm", "turboaggregate", *_LR_ARGV]
    with pytest.raises(AttributeError, match="run"):
        jrun.main([*argv, "--run_dir", str(tmp_path / "jax")])
    got = run.main([*argv, "--device", "cpu", "--run_dir", str(tmp_path / "port")])
    # what the JAX dispatch builds, driven round by round
    cfg = jrun._apply_ci(jrun.ExperimentConfig(algorithm="turboaggregate", dataset="mnist",
                                               model="lr", ci=1, lr=0.1))
    ds = jrun.shrink_dataset(
        jrun.load_data(cfg.dataset, cfg.data_dir, cfg.client_num_in_total,
                       cfg.partition_method, cfg.partition_alpha, cfg.seed),
        cfg.max_samples_per_client, cfg.max_test_samples)
    js = JTurbo(jrun.create_model(cfg.model, cfg.dataset, ds.num_classes,
                                  input_shape=tuple(ds.train_x.shape[1:])),
                ds, JTurboConfig(num_clients=ds.num_clients, comm_rounds=cfg.comm_round,
                                 epochs=cfg.epochs, batch_size=cfg.batch_size, lr=cfg.lr,
                                 seed=cfg.seed),
                loss_fn=jrun.task_loss_for_dataset(cfg.dataset))
    want = [js.run_round() for _ in range(cfg.comm_round)]
    want[-1].update(js.evaluate_global())
    n = ds.num_clients
    _assert_rows_close(got["history"], want, {"rtol": 1e-4, "atol": 1e-4 + n / 2.0 ** 16})


def _cut_gkt_servers(monkeypatch):
    """Both packages' ``resnet56_server`` at (1,1,1) depth."""
    monkeypatch.setattr(jresnet_gkt, "resnet56_server",
                        lambda num_classes=10, image_size=32: JBundle(
                            module=jresnet_gkt.GKTServerResNet(layers=(1, 1, 1),
                                                               num_classes=num_classes),
                            input_shape=(image_size, image_size, 16)))
    monkeypatch.setattr(resnet_gkt, "resnet56_server",
                        lambda num_classes=10, image_size=32, device=None: ModelBundle(
                            resnet_gkt.GKTServerResNet((1, 1, 1), num_classes),
                            (image_size, image_size, 16), torch.device(device)))


def test_run_main_fedgkt_matches_jax(tmp_path, monkeypatch):
    """The reference pair at a cut depth: the server is (1,1,1) on both
    sides (the full resnet56_server runs on the card); resnet8_56 whole."""
    _cut_gkt_servers(monkeypatch)
    argv = ["--algorithm", "fedgkt", "--ci", "1", "--client_num_in_total", "2",
            "--max_samples_per_client", "12", "--max_test_samples", "16",
            "--batch_size", "8", "--epochs_server", "1", "--temperature", "2.0",
            "--alpha_kd", "0.5", "--lr", "0.01"]
    want = jrun.main([*argv, "--run_dir", str(tmp_path / "jax")])["history"]
    got = run.main([*argv, "--device", "cpu", "--run_dir", str(tmp_path / "port")])["history"]
    _assert_rows_close(got, want, {"rtol": 1e-4, "atol": 1e-4})
    assert math.isfinite(got[-1]["test_loss"])


def _jax_fedgkt_float64(argv):
    """What the JAX entry point builds for ``argv``, run in float64 (x64,
    float64 variables, optimizer states, images and logits)."""
    cfg = jrun._apply_ci(jparse_config(jrun.ExperimentConfig, argv))
    ds = jrun.shrink_dataset(
        jrun.load_data(cfg.dataset, cfg.data_dir, cfg.client_num_in_total,
                       cfg.partition_method, cfg.partition_alpha, cfg.seed),
        cfg.max_samples_per_client, cfg.max_test_samples)
    img = ds.train_x.shape[1]
    with enable_x64():
        algo = jgkt_mod.FedGKT(
            jresnet_gkt.resnet8_56(ds.num_classes, img),
            jresnet_gkt.resnet56_server(ds.num_classes, img), ds, jgkt_mod.FedGKTConfig(
                num_clients=ds.num_clients, comm_rounds=cfg.comm_round,
                epochs_client=cfg.epochs, epochs_server=cfg.epochs_server,
                batch_size=cfg.batch_size, lr_client=cfg.lr, lr_server=cfg.lr,
                temperature=cfg.temperature, alpha=cfg.alpha_kd, seed=cfg.seed))
        for name in ("client_vars", "server_vars", "client_opt_states", "server_opt_state",
                     "server_logits"):
            setattr(algo, name, _f64(getattr(algo, name)))
        algo.pack = dataclasses.replace(algo.pack, x=algo.pack.x.astype(np.float64))
        algo._test_pack = (algo._test_pack[0].astype(np.float64), *algo._test_pack[1:])
        rows = algo.run()
        assert all(leaf.dtype == jnp.float64
                   for leaf in jax.tree_util.tree_leaves(algo.server_vars))
    return rows


def test_run_main_fedgkt_two_server_epochs_tracks_float64(tmp_path, monkeypatch):
    """``--epochs_server 2`` (ROADMAP C7): round 1's server loss of XLA's
    float32 run parts from the float64 run by 1.1e-4 relative, the port's
    by 4.4e-5 (the largest gap of any metric; the test loss 3.1e-5). So the
    port is held to the float64 run, within 1e-4, and XLA's float32 run is
    the one that strays further (C4)."""
    _cut_gkt_servers(monkeypatch)
    argv = ["--algorithm", "fedgkt", "--ci", "1", "--client_num_in_total", "2",
            "--max_samples_per_client", "12", "--max_test_samples", "16",
            "--batch_size", "8", "--epochs_server", "2", "--temperature", "2.0",
            "--alpha_kd", "0.5", "--lr", "0.01"]
    got = run.main([*argv, "--device", "cpu", "--run_dir", str(tmp_path / "port")])["history"]
    f32 = jrun.main([*argv, "--run_dir", str(tmp_path / "jax")])["history"]
    f64 = _jax_fedgkt_float64(argv)
    _assert_rows_close(got, f64, {"rtol": 1e-4, "atol": 1e-4})

    def gap(rows):
        return max(abs(r[k] - w[k]) / max(abs(w[k]), 1e-12)
                   for r, w in zip(rows, f64) for k in w)

    assert gap(f32) > gap(got)


@pytest.mark.parametrize("extra,refusal", [
    (["--algorithm", "fednas", "--arch_order", "3"], (ValueError, "arch_order")),
    (["--algorithm", "splitnn", "--compress", "int8"], (NotImplementedError, "C4")),
    (["--algorithm", "vfl", "--checkpoint_every", "1"], (SystemExit, "no checkpoint wiring")),
    # base_framework runs (tests/test_torch_base_framework.py); --mesh lays
    # fedllm's transformer out over ranks, and nothing else
    (["--algorithm", "base_framework", "--mesh", "dp,mp"],
     (ValueError, "base_framework has no sharded path")),
    (["--algorithm", "fedgkt", "--conv_variant", "kernel"], (ValueError, "conv_variant")),
    (["--algorithm", "fedgkt", "--compute_dtype", "bf16"], (ValueError, "compute_dtype")),
    (["--algorithm", "turboaggregate", "--compress", "int8"],
     (NotImplementedError, "C4")),
    (["--algorithm", "centralized", "--checkpoint_every", "1"],
     (SystemExit, "no checkpoint wiring")),
    (["--algorithm", "decentralized", "--resume", "1"], (SystemExit, "no checkpoint wiring")),
    (["--algorithm", "fedgkt", "--checkpoint_every", "1"],
     (SystemExit, "no checkpoint wiring")),
    (["--algorithm", "splitnn", "--conv_variant", "kernel"], (ValueError, "conv_variant")),
    (["--algorithm", "fednas", "--compute_dtype", "bf16"], (ValueError, "compute_dtype")),
])
def test_run_refuses(tmp_path, extra, refusal):
    exc, match = refusal
    with pytest.raises(exc, match=match):
        run.main([*extra, "--device", "cpu", "--ci", "1", "--run_dir", str(tmp_path)])


def test_entry_points_need_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run.main(["--algorithm", "centralized", *_LR_ARGV, "--run_dir", str(tmp_path)])
