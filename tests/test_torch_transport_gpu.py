"""The TCP transport on the card: a message holding a card tensor never
reaches a socket, and a client on the card federates over the port's hub
with the same uploads as a client on the CPU.  Needs a CUDA GPU and
skips without one; imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_transport_gpu.py
"""

import numpy as np
import pytest
import torch

from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.comm.tcp import TcpBackend, TcpHub


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: this sends card tensors at a socket")
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_tensor_refused_before_the_socket(cuda):
    hub = TcpHub()
    a = b = None
    got = []

    class Sink:
        def receive_message(self, t, m):
            got.append(m)

    try:
        a, b = TcpBackend(1, hub.host, hub.port), TcpBackend(2, hub.host, hub.port)
        b.add_observer(Sink())
        b.run_in_thread()
        a.await_peers([2], timeout=30)
        leaf = torch.arange(6, dtype=torch.float32, device=cuda)
        bad = Message("C2S_SEND_MODEL", 1, 2)
        bad.add_params("model_params", {"__wiretree__": 2, "leaves": [leaf]})
        with pytest.raises(TypeError, match="model_params/leaves/0"):
            a.send_message(bad)
        with pytest.raises(TypeError):
            a.send_multicast(bad, [2])
        ok = Message("C2S_SEND_MODEL", 1, 2)
        ok.add_params("model_params", {"__wiretree__": 2, "leaves": [leaf.cpu()]})
        a.send_message(ok)
        import time

        deadline = time.monotonic() + 30
        while not got and time.monotonic() < deadline:
            time.sleep(0.01)
        assert len(got) == 1
        np.testing.assert_array_equal(
            np.asarray(got[0].get("model_params")["leaves"][0]), np.arange(6, dtype=np.float32))
    finally:
        for x in (a, b):
            if x is not None:
                x.stop()
        hub.stop()


def _federate(client_device):
    """Two LR clients on ``client_device`` and a host server over the
    port's hub, 2 rounds; the upload digests and the final model."""
    from fedml_tpu_torch.algorithms.fedavg_cross_device import (FedAvgClientManager,
                                                                FedAvgServerManager)
    from fedml_tpu_torch.compress.codecs import jax_leaves
    from fedml_tpu_torch.experiments.distributed_fedavg import _build_problem

    ds, _, init, lu = _build_problem(0, 2, device=client_device)
    hub = TcpHub()
    backends, clients, threads = [], [], []
    try:
        for i in (1, 2):
            cb = TcpBackend(i, hub.host, hub.port)
            backends.append(cb)
            clients.append(FedAvgClientManager(cb, lu, ds, batch_size=16,
                                               template_variables=init, seed=0,
                                               device=client_device))
            threads.append(cb.run_in_thread())
        sb = TcpBackend(0, hub.host, hub.port)
        backends.append(sb)
        server = FedAvgServerManager(sb, init, num_clients=2, clients_per_round=2,
                                     comm_rounds=2, seed=0, stats_plane=False)
        sb.await_peers([1, 2], timeout=30)
        st = sb.run_in_thread()
        server.start()
        st.join(timeout=60)
        assert not st.is_alive() and server.round_idx == 2
        for t in threads:
            t.join(timeout=10)
        return ([c.upload_digest for c in clients],
                [np.asarray(l) for _, l in jax_leaves(server.variables)])
    finally:
        for b in backends:
            b.stop()
        hub.stop()


@pytest.mark.gpu
def test_card_clients_over_tcp_match_cpu_clients(cuda):
    """Clients training on the card upload host copies: the federation's
    final model is the CPU clients' within 1e-6 (the LR step's matmul may
    round differently on the card)."""
    _, on_card = _federate("cuda")
    _, on_cpu = _federate("cpu")
    for a, b in zip(on_card, on_cpu):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-6)
