"""Virtual-client multiplexing — many node ids over ONE hub connection
(copy of ``fedml_tpu/comm/mux.py``).

The reference's flagship distributed mode is one OS process per client
(``PROCESS_NUM = WORKER_NUM + 1``); on a small host, processes
thrashing a few cores cost more than the wire does.  This module decouples *client
count* from *process count* on the wire side:

- ``TcpMuxBackend`` dials the hub once with a **hello v2** frame
  (``{"node_ids": [...]}``), registering every virtual client id on one
  socket.  Hub routing is id-keyed, so unicast frames to any virtual id
  arrive here; broadcast copies arrive once per CONNECTION as
  ``__hub__: mux`` wrapped frames naming the co-located target ids
  (``TcpHub``'s per-conn dedup), and this backend fans them out
  locally.
- ``VirtualNodeBackend`` is one virtual client's ``CommBackend``
  endpoint on the shared connection: it has its own node id, its own
  observers, its own telemetry/trace identity — so per-virtual-node
  handlers, chaos wrappers (``faults.ChaosBackend``), and trace hop
  chains behave exactly as they would on a dedicated process — while
  every byte rides the one muxed socket.

Wire-byte accounting stays honest: a wrapped broadcast's bytes are
counted ONCE (on the first local delivery); the per-virtual fan-out
increments message counts only (``comm.mux_deliveries``).  The local
clones share payload objects by identity — stamping is copy-on-write
(``obs.trace_ctx``), so per-virtual hop lists never alias.

The cohort engine that trains the co-located deliveries (one local
update per virtual client, in node order) lives in
``algorithms/fedavg_mux.py``.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Dict, List, Optional

from fedml_tpu_torch.comm.backend import CommBackend
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.comm.tcp import TcpBackend
from fedml_tpu_torch.obs import flight, trace_ctx
from fedml_tpu_torch.obs.telemetry import get_telemetry


class VirtualNodeBackend(CommBackend):
    """One virtual client's endpoint on a shared muxed hub connection.

    Sends ride the mux's socket stamped with THIS node's identity;
    inbound frames are delivered by the mux's demux dispatch.  The
    lifetime of the physical connection is owned by the mux backend —
    ``stop()`` here is deliberately a no-op (a single virtual client
    finishing must not sever its 499 co-located peers), and ``run()``
    refuses: the muxer process drives exactly one reader loop, the
    mux's.
    """

    def __init__(self, mux: "TcpMuxBackend", node_id: int):
        super().__init__(node_id)
        self.mux = mux

    def send_message(self, msg: Message) -> None:
        self.mux._send_message_as(msg, self.node_id)

    def drop_connection(self) -> None:
        """Fault injection: a virtual client's 'disconnect' severs the
        SHARED connection — on a real muxer one flaky socket takes all
        co-located virtual clients off the hub at once, which is
        exactly the blast radius the chaos layer should exercise."""
        self.mux.drop_connection()

    def run(self) -> None:
        raise RuntimeError(
            f"virtual node {self.node_id}: run() belongs to the mux "
            "backend — a muxer process drives ONE reader loop"
        )

    def stop(self) -> None:
        """No-op by contract: the shared connection outlives any one
        virtual client (the cohort manager stops the mux backend once,
        at FINISH)."""

    def deliver(self, msg: Message, nbytes: Optional[int] = None) -> None:
        """Demux entry: hand one inbound frame to this node's
        observers (recv stamp + telemetry via the base ``_notify``)."""
        self._notify(msg, nbytes=nbytes)


class TcpMuxBackend(TcpBackend):
    """Hub connection multiplexing N virtual node ids (hello v2).

    Inbound dispatch:

    - ``__hub__: mux`` wrapped broadcast copy → the inner frame is
      parsed once and delivered to every named co-located virtual node
      as a shallow clone (payload objects shared, per-clone trace
      stamps);
    - striped broadcast → reassembled exactly as a plain backend, then
      fanned out to the stream's ``nodes`` (stripe 0 carried them);
    - unicast frame → routed to the virtual node matching its
      ``receiver``.

    ``add_flush_hook`` is the cohort-batching contract: hooks run on
    the reader thread after ALL local deliveries of one physical frame
    — the moment a cohort engine can train everyone the broadcast
    reached in one pass.  ``in_dispatch()`` tells a
    handler whether such a flush is coming (chaos-delayed re-injections
    arrive on timer threads, where it is not).
    """

    def __init__(self, node_ids, host: str, port: int, **kw):
        ids = [int(i) for i in node_ids]
        if not ids:
            raise ValueError("TcpMuxBackend needs at least one node id")
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate virtual node ids: {ids}")
        self.node_ids = ids
        self._virtual: Dict[int, VirtualNodeBackend] = {}
        self._dispatch_flag = threading.local()
        self._flush_hooks: List[Callable[[], None]] = []
        super().__init__(ids[0], host, port, **kw)
        for i in ids:
            self._virtual[i] = VirtualNodeBackend(self, i)

    # -- registration -------------------------------------------------------
    def _hello_obj(self) -> dict:
        return {"node_ids": self.node_ids}

    # -- virtual endpoints --------------------------------------------------
    def virtual(self, node_id: int) -> VirtualNodeBackend:
        return self._virtual[int(node_id)]

    def virtuals(self) -> List[VirtualNodeBackend]:
        return [self._virtual[i] for i in self.node_ids]

    def add_flush_hook(self, fn: Callable[[], None]) -> None:
        """Register a post-dispatch hook (reader thread, after every
        local delivery of one physical frame has run its handler)."""
        self._flush_hooks.append(fn)

    def in_dispatch(self) -> bool:
        return bool(getattr(self._dispatch_flag, "active", False))

    # -- demux dispatch -----------------------------------------------------
    def _run_flush_hooks(self) -> None:
        for fn in list(self._flush_hooks):
            try:
                fn()
            except Exception:
                # a cohort-engine bug must not kill the reader thread —
                # the muxer would silently stop receiving
                logging.exception("node %d: mux flush hook failed",
                                  self.node_id)

    def _fan_out_local(self, msg: Message, nodes, nbytes: Optional[int],
                       reasm_t: Optional[float] = None) -> None:
        """Deliver one physical broadcast copy to every named
        co-located virtual node: shallow clones (payload shared by
        identity), per-clone recv/done trace stamps, wire bytes counted
        exactly once (the first delivery)."""
        tel = get_telemetry()
        tel.inc("comm.mux_frames", msg_type=msg.type)
        # one flight record per PHYSICAL frame (not per local delivery):
        # the black box keeps the fan-out shape without 500x ring churn
        flight.note("comm", "mux_fanout", msg_type=msg.type,
                    nbytes=nbytes or 0, n_nodes=len(nodes or ()))
        self._dispatch_flag.active = True
        try:
            first = True
            for n in nodes or ():
                vb = self._virtual.get(int(n))
                if vb is None:
                    logging.warning(
                        "node %d: mux frame names unknown virtual node "
                        "%s — that copy dropped", self.node_id, n,
                    )
                    continue
                clone = msg.clone_for(int(n))
                if reasm_t is not None:
                    # backdated reassembly hop, per virtual chain
                    trace_ctx.stamp_msg(clone, vb.node_id, "reasm",
                                        t=reasm_t)
                tel.inc("comm.mux_deliveries", msg_type=msg.type)
                vb.deliver(clone, nbytes=nbytes if first else None)
                first = False
        finally:
            self._dispatch_flag.active = False
        self._run_flush_hooks()

    def _on_mux_frame(self, frame: dict, payload, nbytes: int,
                      region=None) -> None:
        try:
            msg = Message.from_frame_bytes(payload)
        except Exception:
            logging.warning(
                "node %d: undecodable mux-wrapped frame (%s) — broadcast "
                "copy dropped", self.node_id, frame.get("msg_type"),
            )
            return
        # slab-backed payload: the clones the local fan-out hands each
        # virtual node share this residency, so a chaos-delayed copy's
        # timer path can pin the bytes past the dispatch scope
        msg._region = region
        self._fan_out_local(msg, frame.get("nodes"), nbytes)

    def _deliver_reassembled(self, msg: Message, ent: dict) -> None:
        nodes = ent.get("nodes")
        if nodes is None:
            # a striped frame without a nodes annotation: route like a
            # unicast by its receiver (defensive — the hub annotates
            # every stripe stream to a muxed conn)
            self._notify(msg, nbytes=ent["nbytes"])
            return
        self._fan_out_local(msg, nodes, ent["nbytes"], reasm_t=ent["t0"])

    def _notify(self, msg: Message, nbytes: Optional[int] = None) -> None:
        """Unicast (or nodes-less) inbound frame: route by receiver to
        the matching virtual node; anything else falls through to the
        mux's own observers (normally none — logged as unhandled by
        the base path)."""
        vb = self._virtual.get(msg.receiver)
        if vb is None:
            super()._notify(msg, nbytes=nbytes)
            return
        self._dispatch_flag.active = True
        try:
            vb.deliver(msg, nbytes=nbytes)
        finally:
            self._dispatch_flag.active = False
        self._run_flush_hooks()
