"""The port's ``distributed_fedavg`` as real OS processes over the TCP hub
(the counterpart of ``tests/test_distributed_process.py``), held against
the JAX package:

- the port's ``launch()`` (hub, server, 3 clients and an idle client
  that is SIGKILLed once registered) ends within 1e-5 of JAX's
  in-process ``FedAvgSimulation``;
- a sampled client killed mid-round under a round deadline: the rounds
  close without it and equal JAX's compiled round under the matching
  participation mask;
- a JAX hub and a JAX server, spawned by their CLI, federate with port
  client processes (ROADMAP item 5's done condition across processes);
- ``--crash-at-round`` exits 137 and leaves a parseable flight bundle.

Children run on the CPU (``--device cpu``) with one thread each; every
wait has its own timeout and every child is killed in a ``finally``."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

PORT_MOD = "fedml_tpu_torch.experiments.distributed_fedavg"
JAX_MOD = "fedml_tpu.experiments.distributed_fedavg"
WAIT = 120.0


def _env():
    env = dict(os.environ)
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               XLA_FLAGS="", FEDML_TPU_FORCE_CPU="1")
    return env


def _jax_simulation(rounds: int = 2):
    """JAX's in-process FedAvgSimulation on its ``_build_problem(seed=0)``."""
    import jax

    from fedml_tpu.algorithms.fedavg import FedAvgConfig, FedAvgSimulation
    from fedml_tpu.experiments.distributed_fedavg import _build_problem

    ds, bundle, init, lu = _build_problem(seed=0, num_clients=3)
    sim = FedAvgSimulation(bundle, ds, FedAvgConfig(
        num_clients=3, clients_per_round=3, comm_rounds=rounds, epochs=1,
        batch_size=16, lr=0.1, seed=0, frequency_of_the_test=100,
    ))
    sim.run()
    return [np.asarray(l) for l in jax.tree_util.tree_leaves(sim.state.variables)]


def _npz_leaves(path, n):
    z = np.load(path)
    return z, [np.asarray(z[f"leaf_{i}"]) for i in range(n)]


def _close(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)


def test_launch_matches_jax_simulation(tmp_path):
    from fedml_tpu_torch.experiments.distributed_fedavg import launch

    out = str(tmp_path / "final.npz")
    info = {}
    rc = launch(num_clients=3, rounds=2, seed=0, batch_size=16, out_path=out,
                extra_idle_clients=1, kill_idle_after=0.5, device="cpu",
                env=_env(), info=info, timeout=WAIT)
    assert rc == 0, "server subprocess failed"
    want = _jax_simulation()
    z, got = _npz_leaves(out, len(want))
    assert int(z["rounds"]) == 2
    log = json.loads(str(z["round_log"]))
    assert [r["round"] for r in log] == [0, 1]
    assert all(sorted(r["participants"]) == [1, 2, 3] for r in log)
    _close(got, want)
    # the server's and clients' stdout lines carry the JAX launcher's keys
    assert info["rounds"] == 2 and info["zero_participant_rounds"] == 0
    assert sorted(k for k in info if k.endswith("_upload_digest")) == [
        f"client_{i}_upload_digest" for i in (1, 2, 3)]
    assert "dropped_frames" in info["hub_stats"]


def test_sampled_client_death_deadline_matches_masked_simulation(tmp_path):
    """A SAMPLED client is SIGKILLed asleep in its first local update; the
    server's deadline closes every round with the two live clients, and
    the result equals JAX's compiled round under the mask [1, 1, 0]."""
    import jax
    import jax.numpy as jnp

    from fedml_tpu.algorithms.fedavg import ServerState, make_round_fn
    from fedml_tpu.core.types import cohort_steps_per_epoch, pack_clients
    from fedml_tpu.experiments.distributed_fedavg import _build_problem
    from fedml_tpu_torch.experiments.distributed_fedavg import launch

    out = str(tmp_path / "final_straggler.npz")
    rc = launch(num_clients=3, rounds=2, seed=0, batch_size=16, out_path=out,
                round_timeout=6.0, slow_client_delay=120.0,
                kill_slow_client_after=0.5, device="cpu", env=_env(), timeout=WAIT)
    assert rc == 0, "server subprocess failed"

    ds, bundle, init, lu = _build_problem(seed=0, num_clients=3)
    pack = pack_clients(ds, [0, 1, 2], 16,
                        steps_per_epoch=cohort_steps_per_epoch(ds, 16), seed=0)
    rf = jax.jit(make_round_fn(lu))
    state = ServerState(variables=init, opt_state=(),
                        round_idx=jnp.zeros((), jnp.int32), key=jax.random.PRNGKey(0))
    for _ in range(2):
        state, _ = rf(state, jnp.asarray(pack.x), jnp.asarray(pack.y),
                      jnp.asarray(pack.mask), jnp.asarray(pack.num_samples),
                      jnp.asarray([1.0, 1.0, 0.0]), jnp.arange(3, dtype=jnp.int32))
    want = [np.asarray(l) for l in jax.tree_util.tree_leaves(state.variables)]
    z, got = _npz_leaves(out, len(want))
    rounds = [r for r in json.loads(str(z["round_log"])) if "participants" in r]
    assert [r["round"] for r in rounds] == [0, 1]
    for r in rounds:
        assert r["participants"] == [1, 2] and r["dropped"] == [3]
    _close(got, want)


def _spawn(args, env, out=subprocess.PIPE):
    return subprocess.Popen([sys.executable, "-m", *args], stdout=out, text=True, env=env)


def test_jax_hub_and_server_with_port_client_processes(tmp_path):
    """JAX's hub and server, started by their own CLI, and three port
    client processes: the federation runs across processes over one
    socket, and the JAX server's final model is JAX's simulation's within
    1e-5."""
    env = _env()
    out = str(tmp_path / "final_mixed.npz")
    procs = []
    try:
        hub = _spawn([JAX_MOD, "--role", "hub", "--port", "0"], env)
        procs.append(hub)
        port = json.loads(hub.stdout.readline())["hub_port"]
        common = ["--port", str(port), "--num-clients", "3", "--rounds", "2",
                  "--seed", "0", "--batch-size", "16"]
        clients = [_spawn([PORT_MOD, "--role", "client", "--node-id", str(i),
                           "--device", "cpu"] + common, env) for i in (1, 2, 3)]
        procs += clients
        server = _spawn([JAX_MOD, "--role", "server", "--out", out] + common, env)
        procs.append(server)
        assert server.wait(timeout=WAIT) == 0, "the JAX server failed"
        summary = json.loads(server.stdout.read().strip().splitlines()[-1])
        digests = {}
        for c in clients:
            text, _ = c.communicate(timeout=30)
            assert c.returncode == 0
            digests.update(json.loads(text.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    assert summary["rounds"] == 2 and summary["rejected_uploads"] == 0
    assert all(digests[f"client_{i}_rounds_trained"] == 2 for i in (1, 2, 3))
    want = _jax_simulation()
    z, got = _npz_leaves(out, len(want))
    rounds = json.loads(str(z["round_log"]))
    assert all(sorted(r["participants"]) == [1, 2, 3] for r in rounds)
    _close(got, want)


def test_client_crash_at_round_exits_137_with_flight_bundle(tmp_path):
    """``--crash-at-round 0`` makes the client hard-exit with 137 when
    round 0's sync arrives, after a forced flight dump into ``--run-dir``."""
    from fedml_tpu_torch.comm.message import Message
    from fedml_tpu_torch.comm.tcp import TcpBackend, TcpHub

    hub = TcpHub()
    server = client = None
    try:
        client = _spawn([PORT_MOD, "--role", "client", "--node-id", "1", "--port",
                         str(hub.port), "--num-clients", "1", "--crash-at-round", "0",
                         "--run-dir", str(tmp_path), "--device", "cpu"], _env(),
                        out=subprocess.DEVNULL)
        server = TcpBackend(0, hub.host, hub.port)
        server.await_peers([1], timeout=WAIT)
        sync = Message("S2C_SYNC_MODEL", 0, 1)
        sync.add_params("round_idx", 0)
        server.send_message(sync)
        assert client.wait(timeout=WAIT) == 137
    finally:
        if client is not None and client.poll() is None:
            client.kill()
            client.wait(timeout=10)
        if server is not None:
            server.stop()
        hub.stop()
    with open(tmp_path / "flight-node1.json") as fh:
        bundle = json.load(fh)
    assert bundle["trigger"]["kind"] == "crash"
    assert bundle["trigger"]["round"] == 0
    assert bundle["node"] == "node1"


def test_every_role_raises_without_a_card_unless_told_cpu(monkeypatch):
    """On a host with no card a role started without ``--device cpu``
    raises before it binds or dials anything."""
    import torch

    from fedml_tpu_torch.experiments import distributed_fedavg as df

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    monkeypatch.delenv("FEDML_TPU_FORCE_CPU", raising=False)
    for role in ("hub", "server", "client", "muxer", "edge_hub"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            df.main(["--role", role, "--port", "1"])


@pytest.mark.slow
def test_hub_killed_and_restarted_federation_survives(tmp_path):
    """The hub is SIGKILLed mid-run and restarted on the same port; every
    worker, the server included, re-dials and re-registers, and frames
    lost in the outage cost a degraded round, never a wedge or a NaN
    (``tests/test_distributed_process.py``'s slow case, the port's
    launcher).  The port's LR rounds take milliseconds, so the last client
    sleeps 2 s before each update: the outage lands inside the run."""
    from fedml_tpu_torch.experiments.distributed_fedavg import launch

    out = str(tmp_path / "final_hub_restart.npz")
    info = {}
    rc = launch(num_clients=3, rounds=3, seed=0, batch_size=16, out_path=out,
                round_timeout=20.0, restart_hub_after=1.0, auto_reconnect=60,
                slow_client_delay=2.0, device="cpu", env=_env(), info=info,
                timeout=240.0)
    assert rc == 0, "server did not survive the hub restart"
    z = np.load(out)
    assert int(z["rounds"]) == 3
    for k in z.files:
        if k.startswith("leaf_"):
            assert np.isfinite(z[k]).all()
    rounds = [r for r in json.loads(str(z["round_log"])) if "participants" in r]
    assert len(rounds) == 3
    assert any(r["participants"] == [1, 2, 3] for r in rounds)
    assert info.get("rounds") == 3
    assert info.get("faults", {}).get("comm.reconnects", 0) >= 1
