"""Federation-wide distributed trace context: per-hop stamps on the wire
(stdlib copy of ``fedml_tpu/obs/trace_ctx.py``).

Every traced message carries a small context dict under the reserved
``__trace__`` param: run id, round, origin node, a per-process sequence
number, a copy counter (fault-injected duplicates) and a list of
``[node, event, t_monotonic]`` hop stamps; each hop appends its own:

    ``send``     the sending backend, just before the write;
    ``hub_in``   the hub's reader, frame parsed off the stream;
    ``hub_out``  the hub's sender, frame leaving its queue;
    ``recv``     the receiving backend, frame delivered to observers;
    ``done``     the receiver's handler completed (``NodeManager``).

The receiving node emits the whole chain as one ``trace_hop`` telemetry
event.  The context lives in the frame's JSON header line only:
stamping on a stream path re-encodes just that line (``restamp_parts``)
around the message's memoized ``to_frame_parts()`` buffers.  Hop stamps
are ``time.perf_counter()``; ``estimate_offset`` maps a node's clock
onto the hub's from a ping burst.

Tracing is off by default and costs one dict lookup per message when
off.  Enable with ``FEDML_TPU_TRACE=1`` or ``set_enabled(True)``.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from fedml_tpu_torch.obs.telemetry import get_telemetry

# reserved Message param / frame-header key (never carries arrays, so it
# always serializes into the header line, never the binary payload)
TRACE_KEY = "__trace__"
HUB_NODE = "hub"  # hop node label for the hub process (nodes are ints)

ENV_ENABLE = "FEDML_TPU_TRACE"
ENV_RUN_ID = "FEDML_TPU_RUN_ID"

_enabled: Optional[bool] = None
_enabled_lock = threading.Lock()
_seq = itertools.count()


def enabled() -> bool:
    """Process-wide tracing switch (env ``FEDML_TPU_TRACE=1``), cached
    after first read; ``set_enabled`` overrides for in-process tests."""
    global _enabled
    if _enabled is None:
        with _enabled_lock:
            if _enabled is None:
                _enabled = os.environ.get(ENV_ENABLE, "") == "1"
    return _enabled


def set_enabled(flag: Optional[bool]) -> None:
    """Override the switch (True/False); ``None`` re-reads the env on
    next use — tests reset with this."""
    global _enabled
    with _enabled_lock:
        _enabled = flag


def run_id() -> str:
    return os.environ.get(ENV_RUN_ID) or f"pid{os.getpid()}"


def now() -> float:
    """The hop clock: monotonic, per-process origin (see module doc)."""
    return time.perf_counter()


# --- context construction / stamping ----------------------------------------

def new_ctx(origin: int, round_idx=None) -> dict:
    ctx = {
        "rid": run_id(),
        "org": int(origin),
        "seq": next(_seq),
        "copy": 0,
        # creation stamp, origin clock: ``ensure`` runs at send ENTRY,
        # before the frame encode, so ``send_hop.t - t0`` is the
        # serialize cost fed_timeline attributes to the origin
        "t0": now(),
        "hops": [],
    }
    if round_idx is not None:
        ctx["rnd"] = round_idx
    return ctx


def stamp_ctx(ctx: dict, node, event: str, t: Optional[float] = None) -> dict:
    """Copy-on-write: a NEW ctx dict with one more hop.  Never mutates
    ``ctx`` — on inproc the same params objects are shared between
    sender and receiver (and between chaos duplicate copies), so every
    stamp must fork the hop list instead of appending in place."""
    return {**ctx,
            "hops": list(ctx.get("hops") or ()) + [[node, event,
                                                    now() if t is None else t]]}


def ensure(msg, origin: int) -> None:
    """Attach a fresh context to ``msg`` if tracing is on and it has
    none.  Runs BEFORE the first encode, so the context lands in the
    memoized header; per-hop stamps are then header-only restamps."""
    if not enabled() or TRACE_KEY in msg.params:
        return
    msg.add_params(TRACE_KEY, new_ctx(origin, msg.get("round_idx")))


def stamp_msg(msg, node, event: str, t: Optional[float] = None) -> None:
    """Stamp a decoded/in-process message (inproc send, backend recv).
    Assigns directly into ``msg.params`` — deliberately NOT through
    ``add_params``: a hop stamp is header-only metadata and must not
    invalidate a memoized frame encoding (the tcp path restamps the
    header line instead of re-encoding the payload).  ``t`` backdates
    the stamp (stripe reassembly stamps first-stripe arrival when the
    frame finally decodes)."""
    ctx = msg.params.get(TRACE_KEY)
    if ctx is not None:
        msg.params[TRACE_KEY] = stamp_ctx(ctx, node, event, t)


def fork_copy(msg):
    """Per-copy identity for a chaos ``duplicate``: a shallow clone
    whose context carries ``copy + 1``, so the two deliveries are
    distinguishable in the merged timeline (their hop stamps are
    already distinct — each copy restamps from the shared base).
    Untraced messages pass through unchanged."""
    ctx = msg.params.get(TRACE_KEY)
    if ctx is None:
        return msg
    twin = msg.clone_for(msg.receiver)
    twin.params[TRACE_KEY] = {**ctx, "copy": int(ctx.get("copy", 0)) + 1}
    return twin


# --- zero-copy header-line restamping (tcp frame path) ----------------------

def restamp_parts(msg, parts: Sequence, node, event: str) -> List:
    """A NEW parts list whose header line carries one more hop stamp.

    ``parts`` is (typically) the message's memoized ``to_frame_parts()``
    encoding: element 0 is the JSON header line, the rest are payload
    buffers.  The returned list re-encodes ONLY the header; payload
    elements are the same objects by identity and the input list is
    never mutated — the encode-once contract survives stamping.  The
    header's ``__binlen__``/``__ndbuf__`` bookkeeping is payload-
    relative, so a header that grows by one hop stays self-consistent.
    Untraced messages return ``parts`` unchanged (no JSON work).
    """
    if TRACE_KEY not in msg.params:
        return list(parts) if not isinstance(parts, list) else parts
    hdr = json.loads(parts[0])
    ctx = hdr.get(TRACE_KEY)
    if ctx is None:
        return list(parts) if not isinstance(parts, list) else parts
    hdr[TRACE_KEY] = stamp_ctx(ctx, node, event)
    return [(json.dumps(hdr) + "\n").encode(), *parts[1:]]


def hub_stamp(hdr: dict, event: str) -> None:
    """Stamp a hub-side parsed header dict in place (the dict is
    reader-thread-local at ``hub_in`` time; the value swap is still COW
    so an mcast header shared across receiver queues never aliases hop
    lists)."""
    ctx = hdr.get(TRACE_KEY)
    if ctx is not None:
        hdr[TRACE_KEY] = stamp_ctx(ctx, HUB_NODE, event)


def hub_out_line(hdr: dict) -> bytes:
    """Encode a queued header dict as its wire line with a fresh
    ``hub_out`` stamp — called by the sender-pool worker at drain time,
    once per receiver, so every fan-out copy records its own queue
    wait.  ``hdr`` itself is never mutated (shared across an mcast's
    receiver queues)."""
    ctx = hdr.get(TRACE_KEY)
    if ctx is None:
        return (json.dumps(hdr) + "\n").encode()
    stamped = {**hdr, TRACE_KEY: stamp_ctx(ctx, HUB_NODE, "hub_out")}
    return (json.dumps(stamped) + "\n").encode()


# --- receive-side completion ------------------------------------------------

def on_recv(msg, node) -> None:
    """Transport delivery stamp (``CommBackend._notify``)."""
    if TRACE_KEY in msg.params:
        stamp_msg(msg, node, "recv")


def on_handled(msg, node, telemetry=None) -> None:
    """Handler-completion stamp + emission: the full hop chain becomes
    one ``trace_hop`` telemetry event on the RECEIVER's registry, which
    ``MetricsLogger.log_telemetry`` drains into that process's metrics
    file.  The trace never travels back over the wire."""
    ctx = msg.params.get(TRACE_KEY)
    if ctx is None:
        return
    ctx = stamp_ctx(ctx, node, "done")
    msg.params[TRACE_KEY] = ctx
    (telemetry or get_telemetry()).event(
        "trace_hop",
        rid=ctx.get("rid"),
        seq=ctx.get("seq"),
        copy=ctx.get("copy", 0),
        org=ctx.get("org"),
        round=ctx.get("rnd"),
        msg_type=msg.type,
        node=node,
        t0=ctx.get("t0"),  # send-entry stamp, ORIGIN clock (serialize)
        hops=ctx["hops"],
    )


# --- clock alignment --------------------------------------------------------

def estimate_offset(
    samples: Sequence[Tuple[float, float, float]],
) -> Tuple[Optional[float], Optional[float]]:
    """NTP-style offset from ``(t0, th, t1)`` ping samples: ``t0``/``t1``
    are the LOCAL monotonic clock around the round trip, ``th`` the
    hub's monotonic clock at reply.  The minimum-RTT sample bounds the
    asymmetry best, so its midpoint estimate wins:

        hub_clock  ~=  local_clock + offset,   |error| <= rtt / 2

    Returns ``(offset_s, rtt_s)``, or ``(None, None)`` with no usable
    sample.  Pure function — the synthetic-skew unit test's surface.
    """
    best = None
    for t0, th, t1 in samples:
        if th is None:
            continue
        rtt = t1 - t0
        if rtt < 0:
            continue
        offset = th - (t0 + t1) / 2.0
        if best is None or rtt < best[0]:
            best = (rtt, offset)
    if best is None:
        return None, None
    return best[1], best[0]


def record_clock_sync(node: int, offset_s: Optional[float],
                      rtt_s: Optional[float], samples: int,
                      telemetry=None) -> None:
    """Publish a handshake's offset estimate: a gauge pair (live
    introspection) plus a ``clock_sync`` event the metrics file keeps —
    what ``fed_timeline`` reads to map this node onto the hub clock."""
    if offset_s is None:
        return
    t = telemetry or get_telemetry()
    t.gauge_set("clock.hub_offset_s", offset_s, node=node)
    t.gauge_set("clock.hub_rtt_s", rtt_s, node=node)
    t.event("clock_sync", node=node, offset_s=offset_s, rtt_s=rtt_s,
            samples=samples)
