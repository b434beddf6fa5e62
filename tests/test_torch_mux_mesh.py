"""The muxed cohort on a mesh of ranks (``algorithms/fedavg_mux.py``'s
``mesh=``, ``parallel/partition.py::CohortEngine``, ``distributed_fedavg
--mesh/--partition-rules``) held against the JAX package:

- as processes on gloo CPU ranks, JAX's slow
  ``tests/test_shard_rules.py:228`` topology: 8 virtual clients on one
  muxer whose cohorts train on a ``4,1`` mesh (fp32) and a ``2,2`` mesh
  (int8 + error feedback): the upload digests and the final model byte for
  byte the one-process-per-client federation's, within 1e-5 of JAX's
  ``FedAvgSimulation``, the ``shard.mesh_dp``/``mesh_mp`` gauges reported;
- the cohort engine against JAX's sharded cohort step
  (``jit_sharded(vmap(local_update.fn))`` under ``cohort_shardings`` on the
  8-device CPU mesh, ``fedml_tpu/algorithms/fedavg_mux.py:204-219``) at
  meshes (2,1), (1,2) and (2,2), a 2-layer width-32 transformer under
  ``FEDLLM_RULES``: every row within ``tests/test_gspmd.py``'s tolerance of
  JAX's rows and bit for bit the port's mesh-free loop;
- a cohort that ``dp`` does not divide trains on the muxer alone, counted
  and with the same bytes; a worker rank that raises fails the muxer
  process; ``--partition-rules`` without ``--mesh`` is refused.

Children run on the CPU with one thread each; every wait has a timeout."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fedml_tpu.core.client import make_client_optimizer as jopt
from fedml_tpu.core.client import make_local_update as jmake_lu
from fedml_tpu.models.transformer import transformer_lm as jtransformer_lm
from fedml_tpu.parallel import partition as jpart
from fedml_tpu.parallel.mesh import make_dp_mp_mesh as jdp_mp_mesh

WAIT = 120.0
MOD = "fedml_tpu_torch.experiments.distributed_fedavg"


def _env():
    env = dict(os.environ)
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               XLA_FLAGS="", FEDML_TPU_FORCE_CPU="1")
    return env


def _run(tmp_path, tag, **kw):
    from fedml_tpu_torch.experiments.distributed_fedavg import launch

    out = str(tmp_path / f"{tag}.npz")
    info = {}
    rc = launch(rounds=2, seed=0, batch_size=16, out_path=out, device="cpu", env=_env(),
                info=info, timeout=WAIT, **kw)
    assert rc == 0, f"{tag} federation failed (rc={rc})"
    z = np.load(out)
    leaves = [np.asarray(z[f"leaf_{i}"]) for i in range(len(
        [k for k in z.files if k.startswith("leaf_")]))]
    digests = {k: v for k, v in sorted(info.items()) if k.endswith("_upload_digest")}
    return digests, leaves, info


def _jax_simulation(num_clients, codec):
    from fedml_tpu.algorithms.fedavg import FedAvgConfig, FedAvgSimulation
    from fedml_tpu.experiments.distributed_fedavg import _build_problem

    ds, bundle, _, _ = _build_problem(seed=0, num_clients=num_clients)
    kw = dict(compress_codec=codec, compress_ef=True) if codec != "none" else {}
    sim = FedAvgSimulation(bundle, ds, FedAvgConfig(
        num_clients=num_clients, clients_per_round=num_clients, comm_rounds=2, epochs=1,
        batch_size=16, lr=0.1, seed=0, frequency_of_the_test=100, **kw))
    sim.run()
    return [np.asarray(l) for l in jax.tree_util.tree_leaves(sim.state.variables)]


@pytest.mark.parametrize("codec,mesh", [("none", "4,1"), ("int8", "2,2")],
                         ids=["fp32_4x1", "int8_ef_2x2"])
def test_mesh_muxer_is_the_per_process_federation(tmp_path, codec, mesh):
    dig_proc, leaves_proc, _ = _run(tmp_path, "proc", num_clients=8, codec=codec)
    dig_mesh, leaves_mesh, info = _run(tmp_path, "mesh", num_clients=8, codec=codec,
                                       muxers=1, muxed_clients=8, mesh=mesh)
    assert len(dig_proc) == 8 and dig_mesh == dig_proc
    assert all(info[f"client_{i}_rounds_trained"] == 2 for i in range(1, 9))
    assert len(leaves_mesh) == len(leaves_proc)
    for a, b in zip(leaves_mesh, leaves_proc):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(leaves_mesh, _jax_simulation(8, codec)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    dp, mp = (int(v) for v in mesh.split(","))
    report = info["muxer_1_mesh"]
    assert report["gauges"] == {"shard.mesh_dp": dp, "shard.mesh_mp": mp}
    assert report["counters"] == {}  # every cohort of 8 divides over dp


def test_indivisible_cohort_falls_back_with_the_same_bytes(tmp_path):
    """Three virtual clients on dp 2: each round's cohort trains on the
    muxer alone, counted per round, and the uploads are the per-process
    ones byte for byte."""
    dig_proc, leaves_proc, _ = _run(tmp_path, "proc3", num_clients=3)
    dig_mesh, leaves_mesh, info = _run(tmp_path, "mesh3", num_clients=3, muxers=1,
                                       mesh="2,1")
    assert len(dig_proc) == 3 and dig_mesh == dig_proc
    for a, b in zip(leaves_mesh, leaves_proc):
        np.testing.assert_array_equal(a, b)
    assert info["muxer_1_mesh"]["counters"] == {
        'shard.cohort_fallbacks{reason=indivisible}': 2.0}


def test_failing_worker_rank_fails_the_muxer(tmp_path):
    """A muxer whose dataset holds 1 client drives 2 virtual clients on a
    2,1 mesh: row 1 (client 1) is rank 1's, whose pack has no such client,
    so the worker raises; the muxer exits non-zero, naming the rank."""
    me = [sys.executable, "-m", MOD]
    env = _env()
    procs = []
    try:
        hub = subprocess.Popen(me + ["--role", "hub", "--port", "0", "--device", "cpu"],
                               stdout=subprocess.PIPE, text=True, env=env)
        procs.append(hub)
        port = str(json.loads(hub.stdout.readline())["hub_port"])
        procs.append(subprocess.Popen(
            me + ["--role", "server", "--port", port, "--num-clients", "2", "--rounds", "2",
                  "--out", str(tmp_path / "f.npz"), "--round-timeout", "5", "--device", "cpu"],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))
        mux = subprocess.Popen(
            me + ["--role", "muxer", "--port", port, "--node-id", "1", "--virtual-clients",
                  "2", "--num-clients", "1", "--mesh", "2,1", "--device", "cpu"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        procs.append(mux)
        _, err = mux.communicate(timeout=90)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=10)
    assert mux.returncode not in (0, None)
    assert "rank 1 of 2 failed" in err and "KeyError" in err, err[-2000:]


def test_partition_rules_without_mesh_is_refused(tmp_path):
    from fedml_tpu_torch.algorithms.fedavg_mux import FedAvgMuxClientManager
    from fedml_tpu_torch.experiments import distributed_fedavg as df

    with pytest.raises(ValueError, match="needs mesh"):
        df.launch(out_path=str(tmp_path / "x.npz"), partition_rules="fedllm", device="cpu")
    with pytest.raises(ValueError, match="needs --mesh"):
        df.main(["--role", "muxer", "--port", "1", "--device", "cpu",
                 "--partition-rules", "fedllm"])
    with pytest.raises(ValueError, match="needs mesh"):
        FedAvgMuxClientManager(None, None, None, batch_size=16, template_variables={},
                               partition_rules="fedllm", device="cpu")
    with pytest.raises(ValueError, match="needs muxers"):
        df.launch(out_path=str(tmp_path / "x.npz"), mesh="2,1", device="cpu")
    with pytest.raises(ValueError, match="no mesh path"):
        df.main(["--role", "client", "--port", "1", "--device", "cpu", "--mesh", "2,1"])


# --- the cohort engine against JAX's sharded cohort step ----------------------------

LM = dict(vocab_size=64, embed_dim=32, num_heads=2, num_layers=2, seq_len=16)
N, STEPS, B, LR, SEED, ROUND = 4, 2, 2, 0.1, 0, 1
SLOTS = [5, 1, 6, 2]
CELLS = [(2, 1), (1, 2), (2, 2)]


def _cohort_data():
    x = np.random.RandomState(7).randint(0, LM["vocab_size"], (N, STEPS, B, LM["seq_len"]))
    x = x.astype(np.int32)
    return x, np.roll(x, -1, axis=-1), np.ones((N, STEPS, B), np.float32)


def _jax_cohort(dp, mp, data):
    """JAX's muxer step (``fedavg_mux.py:204-219``, ``:514-533``) on a
    (dp, mp) mesh of the 8 CPU devices."""
    bundle = jtransformer_lm(**LM)
    lu = jmake_lu(bundle, jopt("sgd", LR), epochs=1)
    variables = bundle.init(jax.random.PRNGKey(0))
    mesh = jdp_mp_mesh(dp, mp)
    var_in, data_sh, var_out, metrics_sh = jpart.cohort_shardings(
        mesh, variables, jpart.FEDLLM_RULES)
    step = jpart.jit_sharded(jax.vmap(lu.fn, in_axes=(None, 0, 0, 0, 0)),
                             in_shardings=(var_in, data_sh, data_sh, data_sh, data_sh),
                             out_shardings=(var_out, metrics_sh))
    k_train = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(SEED), ROUND), 0)
    rngs = jax.vmap(lambda s: jax.random.fold_in(k_train, s))(jnp.asarray(SLOTS, jnp.int32))
    new, metrics = step(variables, *(jnp.asarray(a) for a in data), rngs)
    return jax.tree_util.tree_map(np.asarray, new), {k: np.asarray(v) for k, v in metrics.items()}


def _flat(tree, prefix=()):
    """A nested tree as {flax path: leaf} (the port's dotted names split)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + tuple(str(k).split("."))))
        return out
    return {prefix: np.asarray(tree)}


@pytest.fixture(scope="module")
def cohort_ranks():
    """One launch of 4 gloo ranks serves the three cells (each on the
    first dp*mp ranks)."""
    from fedml_tpu_torch.parallel.compat import launch
    from fedml_tpu_torch.parallel.dryrun import run_cases

    data = _cohort_data()
    cases = [("cohort", dict(device="cpu", **LM, mesh=cell, lr=LR, seed=SEED, round=ROUND,
                             slots=SLOTS, data=data, single=cell == (2, 2)))
             for cell in CELLS]
    return data, launch(run_cases, 4, cases, device="cpu", timeout=240.0)


@pytest.mark.parametrize("cell", CELLS, ids=[f"{dp}x{mp}" for dp, mp in CELLS])
def test_cohort_engine_matches_jax_sharded_step(cohort_ranks, cell):
    data, ranks = cohort_ranks
    dp, mp = cell
    idx = CELLS.index(cell)
    members = [r[idx] for r in ranks if r[idx]["member"]]
    assert len(members) == dp * mp
    # P("dp"): dp row k trains the contiguous rows [k n/dp, (k+1) n/dp)
    per = N // dp
    assert sorted({tuple(m["mine"]) for m in members}) == [
        tuple(range(k * per, (k + 1) * per)) for k in range(dp)]
    jrows, jmetrics = _jax_cohort(dp, mp, data)
    want = _flat(jrows)
    single = ranks[0][CELLS.index((2, 2))]["single"]
    for m in members:
        assert len(m["rows"]) == N
        for k, row in enumerate(m["rows"]):
            got = _flat(row)
            assert set(got) == set(want)
            for path, leaf in got.items():
                # tests/test_gspmd.py's tolerance (JAX reassociates at mp > 1)
                np.testing.assert_allclose(leaf, want[path][k], rtol=2e-4, atol=2e-5,
                                           err_msg="/".join(path))
                # and the port's own mesh-free loop, bit for bit
                np.testing.assert_array_equal(leaf, _flat(single[k][0])[path],
                                              err_msg="/".join(path))
            for name, v in m["metrics"][k].items():
                np.testing.assert_allclose(v, jmetrics[name][k], rtol=2e-4, atol=2e-5)
                np.testing.assert_array_equal(v, single[k][1][name])
