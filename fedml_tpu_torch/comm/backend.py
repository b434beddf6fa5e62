"""Communication backend protocol (copy of ``fedml_tpu/comm/backend.py``).

Reference ``fedml_core/distributed/communication/base_com_manager.py:7-27``
(+ ``observer.py:4-7``): ``send_message`` / ``add_observer`` /
``handle_receive_message`` / ``stop_receive_message``.  A ``CommBackend``
delivers ``Message`` envelopes between integer node ids; ``inproc`` is the
deterministic in-process bus (``comm/inproc.py``), and the TCP hub of the
JAX package comes later.  The reference's thread-kill-via-ctypes and
0.3 s polling loops have no counterpart: inproc is synchronous.
"""

from __future__ import annotations

import abc
import logging
import time
from typing import Callable, Dict, List, Optional

from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.obs import comm_obs, trace_ctx

Handler = Callable[[Message], None]


class Observer(abc.ABC):
    @abc.abstractmethod
    def receive_message(self, msg_type: str, msg: Message) -> None:
        ...


class CommBackend(abc.ABC):
    """Transport: deliver Message envelopes between integer node ids."""

    def __init__(self, node_id: int):
        self.node_id = node_id
        self._observers: List[Observer] = []

    @abc.abstractmethod
    def send_message(self, msg: Message) -> None:
        ...

    def send_multicast(self, msg: Message, receivers) -> None:
        """Fan ONE message out to many receivers.

        Base implementation: per-receiver shallow clones through
        ``send_message`` (payload objects shared, so nothing is
        re-encoded).  Transports with a native fan-out primitive (the
        TCP hub's ``__hub__: mcast`` frame) override this to ship the
        payload once; the chaos wrapper overrides it to apply fault
        rules per receiver — a dropped copy is one node's, not the
        whole broadcast's.
        """
        for r in receivers:
            self.send_message(msg.clone_for(int(r)))

    def set_stripe_fault_hook(self, hook) -> None:
        """Install a per-stripe fault hook (chaos layer).  Transports
        without striped delivery (inproc; tcp wire 1) have no stripes
        to fault — the base implementation ignores the hook, so a
        stripe-faulting plan degrades to a no-op instead of an
        AttributeError on those transports.  ``TcpBackend`` overrides
        with its reassembly-path hook."""

    @abc.abstractmethod
    def run(self) -> None:
        """Deliver incoming messages to observers until stopped."""

    @abc.abstractmethod
    def stop(self) -> None:
        ...

    def add_observer(self, obs: Observer) -> None:
        self._observers.append(obs)

    def remove_observer(self, obs: Observer) -> None:
        self._observers.remove(obs)

    def _record_send(self, msg: Message, nbytes: Optional[int],
                     seconds: Optional[float]) -> None:
        """Transports call this from ``send_message`` with the wire size
        (exact, or ``comm_obs.message_nbytes`` where nothing serializes)
        and the time spent serializing+writing."""
        comm_obs.record_send(msg.type, nbytes, seconds)

    def _notify(self, msg: Message, nbytes: Optional[int] = None) -> None:
        # recv-side telemetry lives in the observer-notify path, so every
        # transport and every NodeManager is measured with no changes
        comm_obs.record_recv(msg.type, nbytes)
        trace_ctx.on_recv(msg, self.node_id)
        for obs in list(self._observers):
            obs.receive_message(msg.type, msg)


class NodeManager(Observer):
    """Base for server/client managers: handler registry + event loop.

    Reference ``fedml_core/distributed/{client,server}``
    (``client_manager.py:12-65``): ``register_message_receive_handler``,
    ``send_message``, ``run``, ``finish`` — minus the
    ``MPI.COMM_WORLD.Abort()`` shutdown (a graceful FINISH message +
    backend stop instead).
    """

    def __init__(self, backend: CommBackend):
        self.backend = backend
        self.backend.add_observer(self)
        self._handlers: Dict[str, Handler] = {}
        self.register_message_receive_handlers()

    # subclasses override
    def register_message_receive_handlers(self) -> None:
        ...

    def register_message_receive_handler(self, msg_type: str, fn: Handler) -> None:
        self._handlers[msg_type] = fn

    def receive_message(self, msg_type: str, msg: Message) -> None:
        handler = self._handlers.get(msg_type)
        if handler is None:
            # the hop chain still emits: a dropped stray/late/duplicate
            # frame's full path is exactly the evidence chaos triage
            # wants in the merged timeline
            trace_ctx.on_handled(msg, self.backend.node_id)
            # A stray or late frame (a post-deadline model upload, a
            # duplicate from a chaos run, a half-upgraded peer) is an
            # EXPECTED event in a fault-tolerant federation — raising
            # here used to kill the node's reader thread and silently
            # wedge the whole run.  Log + count instead; chaos runs
            # assert the counter against their injection schedule.
            comm_obs.record_unhandled(msg_type)
            logging.warning(
                "node %d: no handler for %r from node %s — dropped",
                self.backend.node_id, msg_type, msg.sender,
            )
            return
        t0 = time.perf_counter()
        try:
            handler(msg)
        finally:
            # handler latency = the node's real work per message type
            # (server aggregate, client local train)
            comm_obs.record_handle(msg_type, time.perf_counter() - t0)
            # 'done' stamp + trace_hop emission on the RECEIVER's
            # registry: done - recv IS the handler (train/fold) time in
            # the merged timeline
            trace_ctx.on_handled(msg, self.backend.node_id)

    def send_message(self, msg: Message) -> None:
        self.backend.send_message(msg)

    def send_multicast(self, msg: Message, receivers) -> None:
        self.backend.send_multicast(msg, receivers)

    def run(self) -> None:
        self.backend.run()

    def finish(self) -> None:
        self.backend.stop()
