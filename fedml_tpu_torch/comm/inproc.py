"""In-process communication bus: the simulation backend (copy of
``fedml_tpu/comm/inproc.py``).

Replaces the reference's "multi-node without a cluster" testing mode
(localhost mpirun) with a deterministic single-threaded bus: messages
enqueue globally in send order and are drained by ``InprocBus.drain()``
(or a node's ``run()``).  No threads, no sleeps, no polling.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict

from fedml_tpu_torch.comm.backend import CommBackend
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.obs import trace_ctx
from fedml_tpu_torch.obs.comm_obs import message_nbytes


class InprocBus:
    """Shared router for any number of InprocBackend endpoints."""

    def __init__(self):
        self.stopped: Dict[int, bool] = {}
        self._registered: Dict[int, bool] = {}
        self._backends: Dict[int, "InprocBackend"] = {}
        # one global FIFO of (receiver, msg): delivery follows true
        # cross-node send order, exactly as the drain docstring promises
        self._fifo: deque = deque()
        # quiesce hooks: called when the FIFO runs dry, may enqueue more
        # (return True if they did).  This is how the chaos layer models
        # LATE delivery deterministically: a held message re-enters the
        # bus only after everything in-flight drained — the synchronous
        # twin of a post-deadline straggler frame.
        self._quiesce_hooks = []

    def register(self, node_id: int) -> "InprocBackend":
        self._registered[node_id] = True
        self.stopped[node_id] = False
        return InprocBackend(node_id, self)

    def route(self, msg: Message) -> None:
        if msg.receiver not in self._registered:
            raise KeyError(f"unknown receiver {msg.receiver}")
        self._fifo.append(msg)

    def add_quiesce_hook(self, fn) -> None:
        """Register ``fn() -> bool`` to run at drain quiescence; a True
        return means it enqueued messages and the drain continues."""
        self._quiesce_hooks.append(fn)

    def drain(self, max_steps: int = 100000) -> int:
        """Deliver queued messages in global send order until quiescent;
        handlers may enqueue more.  Messages to stopped nodes are
        discarded (the node has finished).  Returns deliveries."""
        delivered = 0
        for _ in range(max_steps):
            if not self._fifo:
                # list-comp first: EVERY hook runs even if an earlier
                # one released something (any() alone would short-circuit
                # and starve later backends' held messages)
                if any([h() for h in self._quiesce_hooks]):
                    continue
                return delivered
            msg = self._fifo.popleft()
            if self.stopped.get(msg.receiver, True):
                continue
            # wire size stamped once at send time (the bus never
            # serializes; re-estimating per delivery would double cost)
            self._backends[msg.receiver]._notify(
                msg, nbytes=getattr(msg, "wire_nbytes", None)
            )
            delivered += 1
        raise RuntimeError("inproc bus did not quiesce (message storm?)")

    def attach(self, backend: "InprocBackend"):
        self._backends[backend.node_id] = backend


class InprocBackend(CommBackend):
    def __init__(self, node_id: int, bus: InprocBus):
        super().__init__(node_id)
        self.bus = bus
        bus.attach(self)

    def send_message(self, msg: Message) -> None:
        t0 = time.perf_counter()
        # hop stamps on the simulation bus too (no hub hops): the same
        # msg OBJECT travels to the receiver, so stamping is strictly
        # copy-on-write (trace_ctx.stamp_ctx forks the hop list)
        trace_ctx.ensure(msg, self.node_id)
        trace_ctx.stamp_msg(msg, self.node_id, "send")
        msg.wire_nbytes = message_nbytes(msg)
        self.bus.route(msg)
        self._record_send(msg, msg.wire_nbytes, time.perf_counter() - t0)

    def run(self) -> None:
        # synchronous: delivery is driven by bus.drain()
        self.bus.drain()

    def stop(self) -> None:
        self.bus.stopped[self.node_id] = True
