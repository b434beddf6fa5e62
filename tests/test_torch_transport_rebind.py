"""The hub's rebind policy for frames already queued (the port's
``fedml_tpu_torch/comm/tcp.py`` ``TcpHub._register_conn`` and the drain's
straggler check), held to the JAX hub's behaviour in
``tests/test_mux.py:229-285`` (threaded plane) and
``tests/test_reactor.py:354-409`` (reactor), on both planes of both
packages:

a frame queued on a muxer's connection for node id 2, when id 2 is
re-claimed by a newer connection while the frame waits, is dropped at
drain and counted in ``dropped_frames``; neither the displaced muxer nor
the new owner receives it, while the frame for id 1 ahead of it arrives.

Every step is gated on an event or a hub counter (the blocked sender
worker, the frame sitting in the connection's queue, ``node_rebinds``,
``dropped_frames``), never on a fixed sleep: JAX's copy of the threaded
test, which sleeps, failed once on a loaded host.
"""

import threading
import time

import pytest

from fedml_tpu.comm import message as jmessage
from fedml_tpu.comm import mux as jmux
from fedml_tpu.comm import tcp as jtcp
from fedml_tpu_torch.comm import message as tmessage
from fedml_tpu_torch.comm import mux as tmux
from fedml_tpu_torch.comm import tcp as ttcp

PACKAGES = {"jax": (jtcp, jmux, jmessage), "port": (ttcp, tmux, tmessage)}
WAIT_S = 30.0


class _Collect:
    def __init__(self, sink, key):
        self.sink, self.key = sink, key

    def receive_message(self, t, m):
        self.sink.setdefault(self.key, []).append(m)


def _until(cond, what):
    deadline = time.monotonic() + WAIT_S
    while not cond():
        assert time.monotonic() < deadline, f"{what} never happened"
        time.sleep(0.01)


def _queued_qf(hub, nid) -> bool:
    with hub._lock:
        st = hub._conns.get(nid)
        return st is not None and any(e[0] == "QF" for e in st.frames)


def _gate_threaded(monkeypatch, tcp_mod, hub, gate):
    """Block the hub's single sender worker mid-write of the first QF
    frame; returns the event set once it is blocked."""
    real = tcp_mod._sendall_parts
    blocked = threading.Event()

    def gated(sock, parts):
        if (threading.current_thread() in hub._senders and b'"QF"' in bytes(parts[0])
                and not blocked.is_set()):
            blocked.set()
            gate.wait(timeout=WAIT_S)
        real(sock, parts)

    monkeypatch.setattr(tcp_mod, "_sendall_parts", gated)
    return blocked


def _gate_reactor(monkeypatch, tcp_mod, hub, gate):
    """Hold off the event loop's drain of any connection holding a QF
    frame (the loop keeps servicing everything else); returns the held
    connections."""
    real = tcp_mod.TcpHub._drain_conn
    held = []

    def gated(self, st, heads_only=False):
        if self is hub and not gate.is_set():
            with self._lock:
                holding = any(e[0] == "QF" for e in st.frames)
            if holding:
                if st not in held:
                    held.append(st)
                return
        return real(self, st, heads_only)

    monkeypatch.setattr(tcp_mod.TcpHub, "_drain_conn", gated)
    return held


@pytest.mark.parametrize("package", ["jax", "port"])
@pytest.mark.parametrize("mode", ["threaded", "reactor"])
def test_rebind_kills_already_queued_frames_for_stolen_id(monkeypatch, package, mode):
    tcp_mod, mux_mod, msg_mod = PACKAGES[package]
    gate = threading.Event()
    hub = (tcp_mod.TcpHub(senders=1, mode="threaded") if mode == "threaded"
           else tcp_mod.TcpHub(mode="reactor"))
    got = {}
    mux = claimer = sender = None
    try:
        if mode == "threaded":
            blocked = _gate_threaded(monkeypatch, tcp_mod, hub, gate)
        else:
            held = _gate_reactor(monkeypatch, tcp_mod, hub, gate)
        mux = mux_mod.TcpMuxBackend([1, 2], hub.host, hub.port)
        for i in (1, 2):
            mux.virtual(i).add_observer(_Collect(got, i))
        mux.run_in_thread()
        sender = tcp_mod.TcpBackend(9, hub.host, hub.port)
        sender.await_peers([1, 2])
        if mode == "threaded":
            sender.send_message(msg_mod.Message("QF", 9, 1).add_params("x", 1))
            assert blocked.wait(WAIT_S), "the sender worker never took the frame for 1"
        sender.send_message(msg_mod.Message("QF", 9, 2).add_params("x", 2))
        # the frame for 2 waits in the muxer connection's queue
        _until(lambda: _queued_qf(hub, 2), "the frame for 2 queued")
        if mode == "reactor":
            assert len(held) == 1
        claimer = tcp_mod.TcpBackend(2, hub.host, hub.port)  # rebinds id 2
        claimer.add_observer(_Collect(got, "claimer"))
        claimer.run_in_thread()
        _until(lambda: hub.stats()["node_rebinds"] == 1, "the rebind of 2")
        gate.set()
        if mode == "reactor":
            hub._wake(held[0], 2)  # re-offer the held connection to the loop
        _until(lambda: hub.stats()["dropped_frames"].get("QF", 0) == 1,
               "the queued frame's drop")
        if mode == "threaded":
            _until(lambda: got.get(1), "the frame for 1")
        # the dropped frame is gone: neither owner of id 2 can receive it
        assert not got.get(2)
        assert not got.get("claimer")
        stats = hub.stats()
        assert stats["dropped_frames"] == {"QF": 1} and stats["node_rebinds"] == 1
    finally:
        gate.set()
        for b in (mux, claimer, sender):
            if b is not None:
                b.stop()
        hub.stop()
