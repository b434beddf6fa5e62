"""The port's DP×TP rounds and ``run.py --tp_degree/--mesh/--partition_rules``
(``fedml_tpu_torch/parallel/{gspmd,partition}.py``, ``experiments/run.py``)
on 8 gloo CPU ranks, held against the JAX package on the faked 8-device
mesh at ``tests/test_gspmd.py``'s sizes and tolerances:

- ``make_dp_tp_round_fn`` on a (2, 4) ``(clients, model)`` mesh against
  JAX's ``make_round_fn(client_axis_impl="vmap")`` on one device (rtol 2e-4,
  atol 2e-5; ``loss_sum`` rtol 1e-4) and the port's ``make_round_fn``; every
  rank the same whole model; the layout kept after the round;
- FedAdam's server moments laid out like the qkv kernel, the round finite;
- a round with the global-norm clip and FedProx's proximal term, whose
  norms sum the sharded leaves' squares over the model axis, against JAX's;
- ``run.main --algorithm fedllm`` with ``--tp_degree 2``, with ``--mesh 2,4
  --partition_rules fedllm`` and with ``--compress int8 --compress_ef 1``
  under ``--mesh`` against JAX's ``run_experiment`` (1e-4), every rank the
  same history; the refusals, against JAX's where JAX has them.

One launch of 8 ranks serves the multi-rank cases.
"""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fedml_tpu.algorithms.fedavg import ServerState as JServerState
from fedml_tpu.algorithms.fedavg import make_round_fn as jmake_round_fn
from fedml_tpu.core.client import make_client_optimizer as jopt
from fedml_tpu.core.client import make_local_update as jmake_lu
from fedml_tpu.core.types import pack_clients as jpack_clients
from fedml_tpu.data.shakespeare import load_fed_shakespeare as jload_fed_shakespeare
from fedml_tpu.experiments.run import ExperimentConfig as JConfig
from fedml_tpu.experiments.run import run_experiment as jrun_experiment
from fedml_tpu.models.transformer import transformer_lm as jtransformer_lm
from fedml_tpu_torch.experiments import run
from fedml_tpu_torch.parallel.compat import launch
from fedml_tpu_torch.parallel.dryrun import run_cases

TOL = dict(rtol=2e-4, atol=2e-5)
HIST_RTOL = 1e-4
LM = dict(vocab_size=128, embed_dim=32, num_heads=4, num_layers=2, seq_len=80)
QKV = "Block_0.MultiHeadAttention_0.Dense_0.kernel"


def _pack():
    """``tests/test_gspmd.py``'s block: the fed_shakespeare stand-in, 4
    clients x 2 steps of 4."""
    ds = jload_fed_shakespeare(data_dir="/nonexistent", num_clients=4)
    pack = jpack_clients(ds, list(range(4)), batch_size=4, steps_per_epoch=2)
    return tuple(np.asarray(a) for a in (pack.x, pack.y, pack.mask, pack.num_samples)) + (
        np.ones(4, np.float32), np.arange(4, dtype=np.int32))


DATA = _pack()
ROUNDS = {
    "fedavg": dict(**LM, mesh=(2, 4), key=0, opt=dict(name="sgd", lr=0.1), data=DATA,
                   single=True),
    "fedadam": dict(**LM, mesh=(2, 4), key=0, opt=dict(name="sgd", lr=0.1), data=DATA,
                    fedadam=True),
    # the global-norm clip and FedProx's term read the whole model's norm
    "clip_prox": dict(**LM, mesh=(2, 4), key=0, opt=dict(name="sgd", lr=0.1, grad_clip=0.5),
                      prox_mu=0.1, data=DATA),
}
CONFIG = dict(algorithm="fedllm", dataset="fed_shakespeare", comm_round=2,
              client_num_in_total=4, client_num_per_round=4, batch_size=4,
              embed_dim=32, num_heads=4, num_layers=1, lr=0.1)
# FEDLLM_RULES shards the embedding's vocabulary over mp: fed_shakespeare's
# 90 characters do not split 4 ways, stackoverflow_nwp's 10,004 words do
NWP = dict(dataset="stackoverflow_nwp")
RUNS = {
    "tp": dict(tp_degree=2),
    "mesh": dict(NWP, mesh="2,4", partition_rules="fedllm"),
    "mesh_int8_ef": dict(NWP, mesh="2,4", compress="int8", compress_ef=1),
}
REFUSED = {
    "cohort": (dict(tp_degree=2, client_num_per_round=3), "cohort 3 not divisible by dp width 4"),
    "ef_rows": (dict(NWP, mesh="2,4", compress="int8", compress_ef=1, client_num_in_total=5),
                "client_num_in_total 5 not divisible by dp width 2"),
}


def _argv(config):
    return [a for k, v in config.items() for a in (f"--{k}", str(v))]


@pytest.fixture(scope="module")
def ranks():
    cases = [("dp_tp", dict(device="cpu", **spec)) for spec in ROUNDS.values()]
    with tempfile.TemporaryDirectory() as run_dir:
        for extra in RUNS.values():
            cases.append(("run_main", dict(argv=[*_argv({**CONFIG, **extra}), "--device",
                                                 "cpu"], run_dir=run_dir)))
        for extra, _ in REFUSED.values():
            cases.append(("run_main", dict(argv=[*_argv({**CONFIG, **extra}), "--device",
                                                 "cpu"], run_dir=run_dir, refused=True)))
        return launch(run_cases, 8, cases, device="cpu", timeout=300.0)


def _by_path(port_vars):
    return {(c, *k.split(".")): np.asarray(v) for c, sub in port_vars.items()
            for k, v in sub.items()}


def _jax_single(name):
    """JAX's round on one device (``tests/test_gspmd.py``'s oracle)."""
    spec = ROUNDS[name]
    bundle = jtransformer_lm(**LM)
    key = jax.random.PRNGKey(0)
    variables = bundle.init(key)
    lu = jmake_lu(bundle, jopt(**spec["opt"]), epochs=1, prox_mu=spec.get("prox_mu", 0.0))
    fedadam = spec.get("fedadam", False)
    kw, opt_state = {}, ()
    if fedadam:
        from fedml_tpu.algorithms.fedopt import make_fedopt_server_update
        from fedml_tpu.core.optrepo import get_server_optimizer

        server_opt = get_server_optimizer("adam", lr=0.01)
        opt_state = server_opt.init(variables["params"])
        kw = {"server_update": make_fedopt_server_update(server_opt)}
    state = JServerState(variables=variables, opt_state=opt_state,
                         round_idx=jnp.zeros((), jnp.int32), key=key)
    fn = jax.jit(jmake_round_fn(lu, client_axis_impl="vmap", **kw))
    return fn(state, *[jnp.asarray(a) for a in DATA])


@pytest.mark.parametrize("name", list(ROUNDS))
def test_dp_tp_round_matches_jax_single_device(ranks, name):
    i = list(ROUNDS).index(name)
    jstate, jm = _jax_single(name)
    want = {tuple(p.key for p in path): np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(jstate.variables)[0]}
    first = ranks[0][i]
    assert first["mesh"] == {"axes": {"clients": 2, "model": 4}, "devices": 8,
                             "platform": "cpu"}
    assert first["round_idx"] == 1
    got = _by_path(first["variables"])
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        np.testing.assert_allclose(got[path], leaf, err_msg=str(path), **TOL)
    np.testing.assert_allclose(float(first["metrics"]["loss_sum"]), float(jm["loss_sum"]),
                               rtol=1e-4)
    assert np.isfinite(float(first["metrics"]["loss_sum"]))
    for r in ranks:  # every rank gathers the same whole model
        # and computed the replicated leaves' gradients as every other rank did
        assert r[i]["spread"] == 0.0
        for c, d in first["variables"].items():
            for k, v in d.items():
                np.testing.assert_array_equal(r[i]["variables"][c][k], v, err_msg=k)
    if name == "fedavg":
        single = first["single"]
        for c, d in single["variables"].items():
            for k, v in d.items():
                np.testing.assert_allclose(first["variables"][c][k], v, err_msg=k, **TOL)


def test_dp_tp_layout_kept_over_the_model_axis(ranks):
    for r in ranks:
        res = r[0]
        assert res["specs"][QKV] == (None, "model")
        assert res["specs"]["Block_0.Dense_1.kernel"] == ("model", None)
        assert res["specs"]["wte.embedding"] == ()
        assert res["specs_after"] == res["specs"]


def test_dp_tp_fedadam_moments_laid_out_like_the_qkv_kernel(ranks):
    for r in ranks:
        res = r[1]
        qkv = [spec for shape, spec in res["opt_leaves"] if shape == (32, 3 * 32 // 4)]
        assert qkv and all(spec == (None, "model") for spec in qkv)
        assert np.isfinite(float(res["metrics"]["loss_sum"])) and res["round_idx"] == 1


@pytest.fixture(scope="module")
def jax_histories():
    return {name: jrun_experiment(JConfig(**{**CONFIG, **extra}), log_fn=None)
            for name, extra in RUNS.items()}


@pytest.mark.parametrize("name", list(RUNS))
@pytest.mark.parametrize("key", ["loss_sum", "correct", "count", "participants",
                                 "train_loss", "test_loss", "test_acc", "test_count"])
def test_run_main_sharded_matches_jax(ranks, jax_histories, name, key):
    i = len(ROUNDS) + list(RUNS).index(name)
    hist = ranks[0][i]["history"]
    want = jax_histories[name]["history"]
    assert ranks[0][i]["mesh"] == ({"clients": 4, "model": 2} if name == "tp"
                                   else {"dp": 2, "mp": 4})
    assert len(hist) == len(want) == 2
    for got, w in zip(hist, want):
        assert np.isfinite(got[key])
        np.testing.assert_allclose(got[key], w[key], rtol=HIST_RTOL, err_msg=key)
    for r in ranks:
        assert r[i]["history"] == hist


@pytest.mark.parametrize("name", list(REFUSED))
def test_run_main_sharded_refusals_on_ranks(ranks, name):
    extra, message = REFUSED[name]
    i = len(ROUNDS) + len(RUNS) + list(REFUSED).index(name)
    for r in ranks:
        assert message in r[i]["error"]
    with pytest.raises(ValueError, match=message):
        jrun_experiment(JConfig(**{**CONFIG, **extra}), log_fn=None)


def test_run_main_sharded_refusals_in_process(tmp_path):
    """JAX's ValueErrors (a degree that does not divide the ranks, --mesh
    with tp or sp) and the port's own: the parallel knobs outside fedllm,
    --partition_rules without --mesh, a mesh larger than the world."""
    small = ["--algorithm", "fedllm", "--dataset", "fed_shakespeare", "--ci", "1",
             "--device", "cpu", "--run_dir", str(tmp_path)]
    with pytest.raises(ValueError, match="parallel degree 2 does not divide device count 1"):
        run.main([*small, "--tp_degree", "2"])
    with pytest.raises(ValueError, match="parallel degree 3 does not divide device count 8"):
        jrun_experiment(JConfig(**{**CONFIG, "tp_degree": 3}), log_fn=None)
    for extra in (["--tp_degree", "2"], ["--sp_degree", "2"]):
        with pytest.raises(ValueError, match="exclusive with tp_degree/sp_degree"):
            run.main([*small, "--mesh", "1,1", *extra])
    with pytest.raises(ValueError, match="exclusive with tp_degree/sp_degree"):
        jrun_experiment(JConfig(**{**CONFIG, "mesh": "1,1", "tp_degree": 2}), log_fn=None)
    with pytest.raises(ValueError, match="fedavg has no sharded path"):
        run.main(["--algorithm", "fedavg", "--tp_degree", "2", "--device", "cpu"])
    with pytest.raises(ValueError, match="needs --mesh dp,mp"):
        run.main([*small, "--partition_rules", "fedllm"])
    with pytest.raises(ValueError, match=r"mesh 2x4 needs 8 devices, have 1"):
        run.main([*small, "--mesh", "2,4"])


def test_run_main_mesh_1x1_in_one_process_equals_the_one_device_run(tmp_path):
    """``--mesh 1,1`` in a lone process (a world of one rank) runs the rule
    engine: its history is the one-device fedllm run's."""
    small = ["--algorithm", "fedllm", "--dataset", "fed_shakespeare", "--ci", "1",
             "--device", "cpu"]
    got = run.main([*small, "--mesh", "1,1", "--run_dir", str(tmp_path / "a")])
    want = run.main([*small, "--run_dir", str(tmp_path / "b")])
    assert got["mesh"] == {"dp": 1, "mp": 1}
    for g, w in zip(got["history"], want["history"]):
        for k in ("loss_sum", "count", "test_loss", "test_acc"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-6, err_msg=k)
