"""Edge-hub uplink — one connection claiming a whole downstream cohort
(copy of ``fedml_tpu/comm/edge.py``).

The hierarchical aggregation tree (``algorithms/edge_hub``) puts an
edge hub between the root hub and a slice of the federation: the edge
terminates its cohort's connections on a LOCAL hub, folds their uploads
into one (sum n·model, sum n) pair, and uplinks partials over this
backend.  On the root side the uplink is indistinguishable from a muxer
connection: a **hello v2** frame registers every downstream node id on
one socket, so the root hub's routing, mcast per-conn dedup, mux wraps,
stripes, shm lanes, and the server's delta-broadcast ack grouping all
compose over the extra hop with NO root-side changes.

The delivery side is where this differs from ``TcpMuxBackend``: a muxer
clones each wrapped broadcast per co-located virtual node (500 local
deliveries), but the edge hub re-fans the frame out to its OWN
connections — it needs the inner message exactly ONCE, with the target
id list attached, never per-node clones.  Mux-wrapped and striped
inbound frames are therefore unwrapped and delivered a single time with
``msg._mux_nodes`` carrying the cohort slice the root addressed.
"""

from __future__ import annotations

import logging
from typing import Optional

from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.comm.tcp import TcpBackend


def mux_nodes(msg: Message):
    """The downstream node ids a wrapped broadcast frame addressed, or
    None for a plain unicast (attached by ``EdgeUplinkBackend``)."""
    return getattr(msg, "_mux_nodes", None)


class EdgeUplinkBackend(TcpBackend):
    """The edge hub's upstream connection to the root hub.

    Registers the whole downstream cohort's node ids (hello v2) and
    delivers each wrapped broadcast ONCE with the addressed id list
    attached — the edge tier's re-fan-out replaces the muxer's local
    clone loop.  Unicast frames (resync replies to a single downstream
    node) deliver unchanged; the edge manager forwards them down."""

    def __init__(self, node_ids, host: str, port: int, **kw):
        ids = [int(i) for i in node_ids]
        if not ids:
            raise ValueError("EdgeUplinkBackend needs at least one "
                             "downstream node id")
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate downstream node ids: {ids}")
        self.node_ids = ids
        super().__init__(ids[0], host, port, **kw)

    def _hello_obj(self) -> dict:
        ids = self.node_ids
        if len(ids) > 2 and ids == list(range(ids[0], ids[-1] + 1)):
            # contiguous cohort (the launcher partitions contiguously):
            # claim it as ONE [lo, hi] range so the root hub keeps
            # O(edges) routing state instead of an entry per virtual
            # node
            return {"node_ranges": [[ids[0], ids[-1]]]}
        return {"node_ids": ids}

    @staticmethod
    def _addressed(frame: dict):
        """The cohort slice a wrapped frame addressed: an explicit id
        list, or a compacted ``[lo, hi]`` range expanded locally (the
        root never ships 100k-id lists to a range-claim conn)."""
        nodes = frame.get("nodes")
        if nodes is not None:
            return nodes
        rng = frame.get("range")
        if rng is not None:
            lo, hi = int(rng[0]), int(rng[1])
            return list(range(lo, hi + 1))
        return None

    def _on_mux_frame(self, frame: dict, payload, nbytes: int,
                      region=None) -> None:
        try:
            msg = Message.from_frame_bytes(payload)
        except Exception:
            logging.warning(
                "edge uplink %d: undecodable mux-wrapped frame (%s) — "
                "broadcast copy dropped", self.node_id,
                frame.get("msg_type"),
            )
            return
        msg._region = region
        msg._mux_nodes = self._addressed(frame)
        self._notify(msg, nbytes=nbytes)

    def _deliver_reassembled(self, msg: Message, ent: dict) -> None:
        nodes = self._addressed(ent)
        if nodes is not None:
            msg._mux_nodes = nodes
        self._notify(msg, nbytes=ent["nbytes"])
