"""The port's TCP hub and backend against the JAX package's, in one
process over loopback, in both hub data-plane modes (``reactor`` and
``threaded``):

- the same frames sent through JAX's ``TcpHub`` and through the port's
  reach raw receivers as the same bytes (sha256), unicast and
  multicast, striped or whole, over ``wire=2`` and ``wire=1``;
- a mixed federation on each hub (port clients on JAX's hub with a JAX
  server, JAX clients on the port's hub with a port server) ends within
  1e-5 of the all-JAX federation on JAX's hub.

Every socket wait and thread join is bounded; hub ports are ephemeral."""

import hashlib
import json
import socket
import time

import numpy as np
import pytest

from fedml_tpu.comm import tcp as jtcp
from fedml_tpu_torch.comm import tcp as ptcp
from fedml_tpu_torch.comm.message import HUB_KEY, Message

TIMEOUT = 60.0


def _dial_raw(port, node_id):
    """A bare registered connection: hello v1, the hub's ack, ping_done."""
    s = socket.create_connection(("127.0.0.1", port), timeout=10)
    s.sendall((json.dumps({"node_id": node_id}) + "\n").encode())
    buf = b""
    while b"\n" not in buf:
        buf += s.recv(4096)
    assert json.loads(buf.split(b"\n")[0]).get(HUB_KEY) == "ack"
    s.sendall((json.dumps({HUB_KEY: "ping_done"}) + "\n").encode())
    return s, buf.split(b"\n", 1)[1]


def _read_until_end(s, buf: bytes) -> bytes:
    """Everything the hub routed to this connection up to and including
    the END frame the script sends last."""
    deadline = time.monotonic() + 20
    marker = b'"msg_type": "END"'
    while not (marker in buf and buf.endswith(b"\n")
               and buf.rfind(marker) > buf.rfind(b"\n", 0, len(buf) - 1)):
        assert time.monotonic() < deadline, "END frame never arrived"
        chunk = s.recv(1 << 16)
        assert chunk, "hub closed the connection"
        buf += chunk
    return buf


def _script(wire: int):
    """The frames of one routing run: (kind, message, receivers).  The
    multicast goes first: a striped fan-out head-starts every receiver's
    stripe 0, which in the threaded hub may pass a unicast frame still
    queued for that receiver (in both packages), so a unicast ahead of it
    would make the routed order a race."""
    rng = np.random.default_rng(wire)
    out = []
    b = Message("S2C_SYNC_MODEL", 0, -1)
    b.add_params("model_params", {"__wiretree__": 2, "leaves": [
        rng.standard_normal((48, 100)).astype(np.float32),
        rng.standard_normal((100,)).astype(np.float32)]})
    b.add_params("round_idx", 1)
    out.append(("mcast", b, [1, 2, 3]))
    m = Message("S2C_SYNC_MODEL", 0, 1)
    m.add_params("model_params", {"__wiretree__": 2, "leaves": [
        rng.standard_normal((64, 10)).astype(np.float32)]})
    m.add_params("round_idx", 0)
    out.append(("unicast", m, 1))
    t = Message("S2C_FINISH", 0, 3)
    t.add_params("note", "x" * 300)
    out.append(("unicast", t, 3))
    for n in (1, 2, 3):
        out.append(("unicast", Message("END", 0, n), n))
    return out


def _route(hub_mod, mode: str, wire: int, stripe_bytes: int) -> dict:
    hub = hub_mod.TcpHub(mode=mode, stripe_bytes=stripe_bytes, max_inflight_stripes=2)
    socks, sender = {}, None
    try:
        for n in (1, 2, 3):
            socks[n] = _dial_raw(hub.port, n)
        sender = ptcp.TcpBackend(0, hub.host, hub.port, wire=wire)
        sender.await_peers([1, 2, 3], timeout=TIMEOUT)
        for kind, msg, to in _script(wire):
            if kind == "mcast":
                sender.send_multicast(msg, to)
            else:
                sender.send_message(msg)
        got = {n: _read_until_end(s, rest) for n, (s, rest) in socks.items()}
        stats = hub.stats()
        return {"sha": {n: hashlib.sha256(b).hexdigest() for n, b in got.items()},
                "len": {n: len(b) for n, b in got.items()},
                "stripe_frames": stats["stripe_frames"], "mode": stats["mode"]}
    finally:
        if sender is not None:
            sender.stop()
        for s, _ in socks.values():
            s.close()
        hub.stop()


@pytest.mark.parametrize("mode", ["reactor", "threaded"])
@pytest.mark.parametrize("wire,stripe_bytes", [(2, 0), (2, 4096), (1, 0)])
def test_hubs_route_identical_bytes(mode, wire, stripe_bytes):
    want = _route(jtcp, mode, wire, stripe_bytes)
    got = _route(ptcp, mode, wire, stripe_bytes)
    assert got["mode"] == want["mode"] == mode
    assert got["sha"] == want["sha"], (got["len"], want["len"])
    if stripe_bytes:
        assert got["stripe_frames"] == want["stripe_frames"] > 0


# -- mixed federations -----------------------------------------------------------

N_CLIENTS, ROUNDS = 3, 2


def _problems():
    from fedml_tpu.experiments import distributed_fedavg as jdf
    from fedml_tpu_torch.experiments import distributed_fedavg as pdf

    return {"jax": jdf._build_problem(0, N_CLIENTS), "port": pdf._build_problem(
        0, N_CLIENTS, device="cpu")}


def _managers(pkg: str):
    if pkg == "jax":
        from fedml_tpu.algorithms import fedavg_cross_device as m
        from fedml_tpu.core.types import cohort_steps_per_epoch
        return m.FedAvgServerManager, m.FedAvgClientManager, jtcp.TcpBackend, \
            cohort_steps_per_epoch, {}
    from fedml_tpu_torch.algorithms import fedavg_cross_device as m
    from fedml_tpu_torch.core.types import cohort_steps_per_epoch
    return m.FedAvgServerManager, m.FedAvgClientManager, ptcp.TcpBackend, \
        cohort_steps_per_epoch, {"device": "cpu"}


def _leaves(pkg: str, variables):
    if pkg == "jax":
        import jax

        return [np.asarray(l) for l in jax.tree_util.tree_leaves(variables)]
    from fedml_tpu_torch.compress.codecs import jax_leaves

    return [np.asarray(l) for _, l in jax_leaves(variables)]


def _federate(problems, hub_pkg, server_pkg, client_pkg, mode="reactor", wire=2):
    """One sync federation of N_CLIENTS on ``hub_pkg``'s hub, each role's
    managers and backend from its own package; returns the global model's
    leaves in JAX's order and the hub's stats."""
    hub = (jtcp if hub_pkg == "jax" else ptcp).TcpHub(mode=mode)
    Server, _, SBackend, steps_of, _ = _managers(server_pkg)
    _, Client, CBackend, _, ckw = _managers(client_pkg)
    ds_s, _, init_s, _ = problems[server_pkg]
    ds_c, _, init_c, lu_c = problems[client_pkg]
    backends, threads = [], []
    try:
        for i in range(N_CLIENTS):
            cb = CBackend(i + 1, hub.host, hub.port, wire=wire)
            backends.append(cb)
            Client(cb, lu_c, ds_c, batch_size=16, template_variables=init_c, seed=0, **ckw)
            threads.append(cb.run_in_thread())
        sb = SBackend(0, hub.host, hub.port, wire=wire)
        backends.append(sb)
        server = Server(sb, init_s, num_clients=N_CLIENTS, clients_per_round=N_CLIENTS,
                        comm_rounds=ROUNDS, seed=0, steps_per_epoch=steps_of(ds_s, 16),
                        stats_plane=False)
        sb.await_peers(range(1, N_CLIENTS + 1), timeout=TIMEOUT)
        st = sb.run_in_thread()
        server.start()
        st.join(timeout=TIMEOUT)
        assert not st.is_alive(), "the server did not finish in time"
        assert server.round_idx == ROUNDS
        for t in threads:
            t.join(timeout=10)
            assert not t.is_alive(), "a client did not see FINISH"
        assert all(sorted(r["participants"]) == [1, 2, 3] for r in server.round_log)
        return _leaves(server_pkg, server.variables), hub.stats()
    finally:
        for b in backends:
            b.stop()
        hub.stop()


@pytest.fixture(scope="module")
def all_jax():
    problems = _problems()
    return problems, _federate(problems, "jax", "jax", "jax")[0]


@pytest.mark.parametrize("mode", ["reactor", "threaded"])
@pytest.mark.parametrize("wire", [2, 1])
@pytest.mark.parametrize("hub_pkg", ["jax", "port"])
def test_mixed_federation_matches_all_jax(all_jax, hub_pkg, wire, mode):
    """Port clients with a JAX server on JAX's hub, and JAX clients with a
    port server on the port's hub: the global model after ROUNDS rounds is
    the all-JAX federation's within 1e-5."""
    problems, want = all_jax
    server_pkg = hub_pkg
    client_pkg = "port" if hub_pkg == "jax" else "jax"
    got, stats = _federate(problems, hub_pkg, server_pkg, client_pkg, mode, wire)
    assert stats["mode"] == mode
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)


def test_port_only_federation_matches_all_jax(all_jax):
    """The all-port federation on the port's hub, for the record beside
    the mixed ones."""
    problems, want = all_jax
    got, _ = _federate(problems, "port", "port", "port")
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)


def test_clients_on_reader_threads_share_one_bundle_safely():
    """The clients of one process train on their backends' reader threads
    through one ModelBundle: ``torch.func.functional_call`` swaps the
    module's placeholders in place, so the bundle's forwards take turns
    (``models/base.py::functional_call``).  More threads than cores, with
    a short switch interval, each get exactly the sequential result."""
    import os
    import sys
    import threading

    import torch

    from fedml_tpu_torch.core.rng import PRNGKey
    from fedml_tpu_torch.models.linear import mlp2

    n = (os.cpu_count() or 4) + 4
    bundle = mlp2(16, 32, 4, device="cpu")
    variables = [bundle.init(PRNGKey(i)) for i in range(n)]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((8, 16)).astype(np.float32))
    want = [bundle.apply_train(v, x)[0] for v in variables]
    bad, errors = [], []

    def run(i):
        try:
            for _ in range(200):
                if not torch.equal(bundle.apply_train(variables[i], x)[0], want[i]):
                    bad.append(i)
        except Exception as e:  # a placeholder leaking into another thread's call
            errors.append(repr(e))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors and not bad
