"""TCP hub backend — the cross-device / DCN control plane (copy of
``fedml_tpu/comm/tcp.py``; frames, registration and lanes are the JAX
package's byte for byte, so port and JAX peers share one hub).

Fills the role the reference gives MQTT
(``communication/mqtt/mqtt_comm_manager.py:14-126``: broker pub/sub with
JSON payloads for loosely-coupled mobile clients) with zero external
dependencies: a hub process accepts connections, each node registers its
integer id (hub ACKs the registration — sends before the ACK cannot
race past an unregistered receiver), and frames are routed by receiver
id.  Two frame generations share the stream:

- **v1** — one JSON line per message (arrays as base64 f32 buffers, or
  the reference's list-codec via ``tensor_to_list`` for mobile parity);
- **v2** (default) — a JSON header line whose top-level ``__binlen__``
  key announces exactly that many raw payload bytes following the
  newline (``Message.to_frame``).  Readers that see no ``__binlen__``
  treat the line as a complete v1 frame, so both generations interop on
  one hub and the 4/3x base64 inflation is gone from model traffic.

Design notes vs the reference's MPI threads: the hub
data plane runs in one of two modes (``FEDML_TPU_HUB_MODE``, or the
``mode=`` kwarg):

- **reactor** (default) — a single ``selectors``-based event-loop
  thread multiplexes every connection non-blocking: accepts, streaming
  header/payload reads (``comm/reactor.py``'s ``FrameParser``), shm
  doorbells, and writability-driven queue drains.  O(1) threads per
  hub regardless of connection count — the scaling plane for the
  512-conn-and-up regime — and inbound TCP payloads land in pooled
  refcounted buffers (``BufRegion``) that ride the send queues as
  pins, so routing is zero-copy end to end on BOTH transports.
- **threaded** — the original one-blocking-reader-thread-per-connection
  model with a sender pool; kept as the A/B byte-identity baseline
  (both modes build frame bytes through the same drain helpers, so
  federations pin sha256-identical across them).

Either way: shutdown via sentinel frame and socket close — no ctypes
thread kills, no polling sleeps.  A dead or misbehaving peer only
loses its own frames: routing errors are caught, the stale connection
is dropped, and other nodes keep flowing.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import logging
import os
import queue
import selectors
import socket
import threading
import time
import zlib
from collections import deque
from typing import Dict, List, Optional, Tuple

import torch

from fedml_tpu_torch.analysis.locks import assert_held, make_lock
from fedml_tpu_torch.comm.backend import CommBackend
from fedml_tpu_torch.comm.message import (
    FRAME_BINLEN_KEY,
    HUB_KEY,
    MCAST_STRIPE_KIND,
    MUX_KIND,
    SHM_SEQ_KEY,
    Message,
)
from fedml_tpu_torch.comm.reactor import BufPool, FrameError, FrameParser
from fedml_tpu_torch.comm.shm import (
    DEFAULT_DATA_BYTES,
    DEFAULT_MIN_BYTES,
    DEFAULT_SLOTS,
    ShmLane,
    ShmLaneError,
    split_frame_line,
)
from fedml_tpu_torch.obs import flight, trace_ctx
from fedml_tpu_torch.obs.telemetry import get_telemetry

_SENTINEL = {HUB_KEY: "stop"}
_ACK = {HUB_KEY: "ack"}

# hub data-plane selection: "reactor" (selector event loop, default) or
# "threaded" (one blocking reader thread per connection + sender pool)
ENV_HUB_MODE = "FEDML_TPU_HUB_MODE"


class _HubConnError(Exception):
    """Connection-fatal condition noticed mid-serve (lane errors,
    doorbells on lane-less conns, invalid hellos): the reactor and the
    threaded reader both translate it into 'drop this connection',
    which is the established policy for every unrecoverable per-conn
    fault — the peer pays one reconnect, the router never wedges."""


def _device_leaf(v, path: str = "") -> Optional[str]:
    """The path of the first tensor of ``v`` (a message's params) that does
    not live on the CPU, or None.  The managers copy a model to the host on
    their own thread before they encode it; a card tensor that reached the
    socket path would be copied on the sender's thread instead, behind the
    send lock."""
    if isinstance(v, torch.Tensor):
        return path or "." if v.device.type != "cpu" else None
    if isinstance(v, dict):
        items = v.items()
    elif isinstance(v, (list, tuple)):
        items = enumerate(v)
    else:
        return None
    for k, sub in items:
        found = _device_leaf(sub, f"{path}/{k}")
        if found is not None:
            return found
    return None


def _refuse_device_leaves(msg: Message) -> None:
    where = _device_leaf(msg.params)
    if where is not None:
        raise TypeError(
            f"{msg.type}: a device tensor at {where} reached the TCP "
            "backend; copy the model to the host before encoding it")


def _retry_jitter(node_id: int, attempt: int) -> float:
    """Deterministic send-retry jitter in [0, 1): a fold_in-style hash
    of (node, attempt), so two nodes backing off together still
    de-synchronize but a chaos-soak re-run reproduces the exact retry
    timing (the last seedless draw in the round path — everything else
    flows from explicit seeds)."""
    digest = hashlib.sha256(f"retry|{node_id}|{attempt}".encode()).digest()
    return int.from_bytes(digest[:8], "big") / 2.0 ** 64

# Per-socket buffer target: model frames are multi-MB, and the Linux
# defaults (~208 KiB) force many small send/recv cycles per frame even
# on loopback.  The kernel clamps to net.core.{r,w}mem_max — tuning is
# best-effort by design.
_TCP_SOCK_BUF = 4 << 20

# Striped-multicast reassembly budget — a shared contract between the
# two ends: ``TcpBackend`` buffers at most this many payload bytes
# across its in-progress stripe streams, and ``TcpHub`` refuses to
# stripe any frame larger than HALF of it (headroom for one
# interleaved stream) — an over-budget frame falls back to whole-frame
# fan-out instead of being striped into a guaranteed receiver-side
# overflow abort on every client.
_MAX_REASM_BYTES = 64 << 20


def _split_traced_mcast(frame: dict, payload: bytes):
    """For a TRACED mcast, split the inner frame at its header line,
    stamp ``hub_in``, and return ``(parsed header dict, payload-tail
    memoryview)``; ``(None, None)`` for untraced frames or an
    unparseable header (the frame then ships verbatim, unstamped).
    One definition for the whole-frame and striped fan-out paths — the
    traced-frame contract must not diverge between them."""
    if not frame.get(trace_ctx.TRACE_KEY):
        return None, None
    hdr = None
    # split_frame_line, not .find: ``payload`` may be a pinned slab
    # memoryview (zero-copy hub inbound) — only the header LINE is
    # ever materialized, the multi-MB tail stays a view
    end = split_frame_line(payload)
    if end > 0:
        try:
            hdr = json.loads(bytes(payload[:end]))
        except json.JSONDecodeError:
            hdr = None
    if hdr is None or trace_ctx.TRACE_KEY not in hdr:
        return None, None
    trace_ctx.hub_stamp(hdr, "hub_in")
    return hdr, memoryview(payload)[end:]


def _tune_socket(sock: socket.socket) -> None:
    """TCP_NODELAY + sized buffers on every hub/backend socket: frames
    are written whole (vectored), so Nagle batching only adds latency,
    and sized buffers keep a multi-MB frame moving in few syscalls."""
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, _TCP_SOCK_BUF)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, _TCP_SOCK_BUF)
    except OSError:
        pass  # exotic stacks/containers may refuse; correctness unaffected


def _iov_max() -> int:
    try:
        import os

        return os.sysconf("SC_IOV_MAX")
    except (OSError, ValueError, AttributeError):
        return 1024  # POSIX minimum is 16; Linux ships 1024


_IOV_MAX = _iov_max()


def _sendall_parts(sock: socket.socket, parts) -> None:
    """Vectored ``sendall`` of one complete frame given as a buffer
    list: multi-MB payloads are never concatenated into a fresh
    bytestring (``Message.to_frame_parts`` zero-copy contract).
    Partial ``sendmsg`` returns advance memoryviews until done; each
    call is capped at IOV_MAX buffers (a deep pytree emits one buffer
    per leaf — past the cap sendmsg would fail with EMSGSIZE)."""
    pending = [p if isinstance(p, memoryview) else memoryview(p)
               for p in parts]
    pending = [v if v.format == "B" and v.ndim == 1 else v.cast("B")
               for v in pending]
    if not hasattr(sock, "sendmsg"):  # non-POSIX fallback
        sock.sendall(b"".join(pending))
        return
    while pending:
        sent = sock.sendmsg(pending[:_IOV_MAX])
        while sent:
            head = pending[0]
            if sent >= len(head):
                sent -= len(head)
                pending.pop(0)
            else:
                pending[0] = head[sent:]
                sent = 0


class _Conn:
    """One registered CONNECTION: socket + bounded outbound frame queue.

    Since hello v2 a connection may carry MANY node ids (a muxer process
    driving hundreds of virtual clients over one socket): ``ids`` is the
    live set of node ids currently routed here (ids can be re-claimed by
    a later connection — the rebind policy in ``_serve_conn``), ``mux``
    marks a v2 registration (broadcast copies to it are wrapped in a
    ``__hub__: mux`` outer header naming the co-located target ids so
    the demuxing backend can fan out locally), ``cid`` is a small
    process-unique connection id for per-connection telemetry series,
    and ``dead`` tells a sender-pool worker to stop draining (set when
    the reader exits or every id was rebound away).

    ``scheduled`` enforces a single drainer at a time (a connection is
    only ever serviced by the one sender worker it was handed to), so
    per-connection order is FIFO and frames can never interleave
    mid-payload — the invariant the old per-conn send locks provided,
    now without serializing the fan-out behind the router thread.

    Queue entries are ``(msg_type, parts, hdr, nbytes, rids, region)``:
    for an untraced frame ``hdr`` is None and ``parts`` is the complete
    wire frame; for a TRACED frame ``hdr`` is the parsed header dict (shared
    across an mcast's receiver queues) — or a deferred ``(kind, meta,
    inner header)`` tuple — and ``parts`` holds only the payload tail:
    the sender worker re-encodes the header line with a fresh
    ``hub_out`` stamp at drain time, so ``hub_out - hub_in`` is this
    frame's real queue wait and the payload bytes are still the one
    shared immutable object.  ``rids`` is the tuple of node ids the
    entry addresses: the drain re-checks them against ``ids`` so a
    frame queued for an id that was REBOUND to a newer connection
    while waiting dies with straggler semantics instead of being
    delivered to the displaced owner (the rebind policy's "old conn
    loses it" must hold for in-flight frames too).  ``region`` is the
    refcounted slab pin (``ShmRegion``) backing a zero-copy laned
    payload, or None: every enqueue occurrence holds one retain() and
    every drain — sent, dropped, dead-conn leftover — releases exactly
    one, so the ring reclaims the bytes when the LAST queue drains them
    and never before.

    ``heads`` is a strict-priority queue in front of ``frames``: a
    striped mcast enqueues every receiver's stripe 0 there, and a
    sender worker always drains heads — across ALL connections — before
    tail frames, requeuing its connection after the last head so every
    other connection's pending head drains before any connection's
    tail.  That is the head-start contract: all K receivers START
    streaming within one head round instead of the last one waiting
    behind K-1 whole fan-outs (enqueue order alone cannot guarantee
    this — tails land while heads are still draining and a paced visit
    would drain head+tail together).

    Reactor-plane fields (``parser``..``want_write``) exist on every
    conn but are live only under ``mode="reactor"``, where they are
    touched EXCLUSIVELY by the event-loop thread (single-threaded by
    construction — the reactor's analogue of the single-drainer rule):
    ``parser`` is the conn's streaming ``FrameParser``, ``phase`` the
    handshake state machine (0 = awaiting hello, 1 = clock-sync, 2 =
    registered), ``wpend`` the partial-write continuation (memoryviews
    of the in-flight frame still to write), ``wcommit``/``wregion``
    the lane-commit token and payload pin released when that frame
    fully flushes, and ``want_write`` whether the socket is parked on
    EVENT_WRITE."""

    __slots__ = ("sock", "frames", "heads", "nbytes", "scheduled",
                 "ids", "ranges", "mux", "cid", "dead", "lane",
                 "parser", "phase", "nid0", "wpend", "wcommit",
                 "wregion", "wmsg_type", "want_write")

    def __init__(self, sock: socket.socket, ids=(), mux: bool = False,
                 lane=None, ranges=()):
        self.sock = sock
        self.frames: deque = deque()  # (msg_type, parts, hdr, nbytes, rids, region)
        self.heads: deque = deque()  # same entries, strict priority
        self.nbytes = 0
        self.scheduled = False
        self.ids = set(ids)
        # hello v2 RANGE claim (an edge-hub uplink owning a contiguous
        # cohort): inclusive (lo, hi) intervals routed here WITHOUT a
        # per-id entry in the hub's node map — the whole point of the
        # claim is that the root tier's state stays O(connections), not
        # O(virtual clients).  A range is an atom: it can only be lost
        # by the connection dying or a later claim displacing the WHOLE
        # conn (never id-by-id), so drain-time rebind filtering skips
        # per-id checks for pure-range conns.
        self.ranges = tuple((int(lo), int(hi)) for lo, hi in ranges)
        self.mux = mux
        self.cid = 0
        self.dead = False
        # shared-memory lane (comm/shm.py), attached at hello when the
        # dialer advertised a slab: large payload bytes in BOTH
        # directions ride its rings while every header stays on this
        # socket (order, control frames, and fallback are the stream's)
        self.lane = lane
        # reactor-plane state (loop-thread-only; see class docstring)
        self.parser = None
        self.phase = 0
        self.nid0 = None  # the hello's primary node id (reply target)
        self.wpend: List = []
        self.wcommit = None
        self.wregion = None
        self.wmsg_type = None
        self.want_write = False

    def covers(self, nid: int) -> bool:
        """True when this conn routes ``nid`` (per-id claim or range)."""
        if nid in self.ids:
            return True
        for lo, hi in self.ranges:
            if lo <= nid <= hi:
                return True
        return False

    def claimed(self) -> int:
        """Total node ids this conn claims (ids + range sizes)."""
        return len(self.ids) + sum(hi - lo + 1 for lo, hi in self.ranges)


class TcpHub:
    """Central router: node_id → connection. Start once per federation.

    Outbound frames ride per-connection bounded queues drained by a
    small sender pool — a reader thread only ever ENQUEUES (O(1)), so
    one slow receiver no longer stalls routing for everyone else, and a
    ``__hub__: mcast`` frame (one payload + a receiver list) fans out
    by enqueueing the SAME immutable bytes to every receiver: the
    server→hub broadcast leg carries each sync exactly once."""

    # lock-discipline contract (fedlint): reader threads, the sender
    # pool, and the accept path all share these — every touch goes
    # through self._lock (per-conn payload state lives on _Conn and is
    # protected by the same lock; the single-drainer rule serializes
    # the socket itself)
    _GUARDED_BY = {
        "_conns": "_lock",
        "_range_conns": "_lock",
        "dropped_frames": "_lock",
        "backpressure_drops": "_lock",
        "mcast_frames": "_lock",
        "mcast_copies": "_lock",
        "striped_mcasts": "_lock",
        "stripe_frames": "_lock",
        "node_rebinds": "_lock",
        "shm_frames": "_lock",
        "shm_bytes": "_lock",
        "shm_fallbacks": "_lock",
        "shm_hub_copies": "_lock",
        "zero_copy_forwards": "_lock",
        "_drainq": "_lock",
        "_reader_count": "_lock",
    }

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 senders: int = 4, max_queue_bytes: int = 256 << 20,
                 max_queue_frames: int = 4096,
                 stripe_bytes: int = 0, max_inflight_stripes: int = 8,
                 shm_min_bytes: int = DEFAULT_MIN_BYTES,
                 mode: Optional[str] = None):
        self._mode = (mode or os.environ.get(ENV_HUB_MODE)
                      or "reactor").strip().lower()
        if self._mode not in ("reactor", "threaded"):
            raise ValueError(f"unknown hub mode {self._mode!r} "
                             f"(want 'reactor' or 'threaded')")
        self._srv = socket.create_server((host, port))
        self.host, self.port = self._srv.getsockname()
        # striped fan-out: an mcast payload larger than ``stripe_bytes``
        # (0 = off, ship whole frames) is split into fixed-size
        # ``__hub__: mcast_stripe`` continuation frames that receivers
        # reassemble (TcpBackend).  ``max_inflight_stripes`` is the
        # pacing quantum: a sender-pool worker writes at most that many
        # frames to ONE connection before rotating to the back of the
        # ready queue, so all receivers stream concurrently instead of
        # the last one waiting behind K whole-frame sends.
        self._stripe_bytes = max(0, int(stripe_bytes))
        self._pace = max(1, int(max_inflight_stripes))
        self._sid = itertools.count(1)  # process-unique stripe-stream ids
        self.striped_mcasts = 0
        self.stripe_frames = 0
        # frames to unregistered/dead receivers are dropped BY DESIGN
        # (the deadline server treats the receiver as a straggler), but
        # invisibly so until now: count them per message type so chaos
        # runs can reconcile observed drops against injected ones
        self.dropped_frames: Dict[str, int] = {}
        # backpressure: a receiver whose queue exceeds the bound loses
        # the NEW frame (counted in dropped_frames too) — bounded memory
        # beats an unbounded queue wedging the hub behind a dead-slow peer
        self.backpressure_drops = 0
        self.mcast_frames = 0
        self.mcast_copies = 0
        # duplicate-registration policy (pinned): a hello claiming an
        # already-registered node id REBINDS it — the new connection
        # wins, the old one loses the id (and is closed once it holds
        # none), and every rebound id is counted here + as the
        # ``hub.node_rebinds`` telemetry series.  Covers both the
        # reconnect case (the old conn is half-dead) and a genuine
        # two-live-conns conflict (last dialer wins, visibly).
        self.node_rebinds = 0
        # shared-memory lane accounting: frames/bytes the hub moved
        # through slab rings (either direction) and payloads that fell
        # back to inline TCP (ring full, descriptor queue full,
        # oversized) — the fallback is per-frame and silent on the
        # wire, so the counter is the only evidence it happened
        self.shm_frames = 0
        self.shm_bytes = 0
        self.shm_fallbacks = 0
        # zero-copy inbound: laned payloads normally route as refcounted
        # slab PINS (ShmRegion) straight into the send queues — this
        # counts the defensive materializations (pin-pressure valve)
        # that copied instead, so the fast path's "no copies" claim is
        # testable rather than assumed
        self.shm_hub_copies = 0
        # and the fast path itself: queue entries enqueued carrying a
        # slab PIN (one retain, zero payload copies) — the positive
        # counterpart of shm_hub_copies, so the zero-copy forward rate
        # is a measurement, not an absence of evidence
        self.zero_copy_forwards = 0
        # payloads below this ride inline TCP (policy, not fallback)
        self._shm_min = max(0, int(shm_min_bytes))
        self._max_queue_bytes = max_queue_bytes
        self._max_queue_frames = max_queue_frames
        # node id -> connection; MANY-TO-ONE since hello v2 (a muxer
        # registers all its virtual node ids on one socket)
        self._conns: Dict[int, _Conn] = {}
        # connections that claimed contiguous id RANGES (edge-hub
        # uplinks): kept OUT of the per-id map so the root hub's memory
        # stays O(connections) no matter how many virtual clients live
        # behind each edge — routing falls back to a scan of this short
        # list on a per-id miss
        self._range_conns: List[_Conn] = []
        self._cids = itertools.count(1)  # per-connection telemetry ids
        self._lock = make_lock("TcpHub._lock")
        self._ready: "queue.SimpleQueue" = queue.SimpleQueue()
        self._running = True
        self._reader_count = 0  # live threaded-mode reader threads
        self._senders: List[threading.Thread] = []
        if self._mode == "threaded":
            self._senders = [
                threading.Thread(target=self._sender_loop, daemon=True)
                for _ in range(max(1, int(senders)))
            ]
            for t in self._senders:
                t.start()
            self._accept_thread = threading.Thread(
                target=self._accept_loop, daemon=True)
            self._accept_thread.start()
            return
        # reactor mode: ONE event-loop thread owns accepts, reads, and
        # writability-driven drains for every connection.  The wakeup
        # pipe is the documented off-loop entry point: stop() and any
        # cross-thread _forward tickle it so the sleeping select wakes
        # and services the drain queue (chaos timer-delayed deliveries
        # need no special path — they arrive as ordinary socket
        # readability, see README "Federation transport").
        self._srv.setblocking(False)
        self._sel = selectors.DefaultSelector()
        self._sel.register(self._srv, selectors.EVENT_READ, None)
        self._wakeup_r, self._wakeup_w = os.pipe()
        os.set_blocking(self._wakeup_r, False)
        os.set_blocking(self._wakeup_w, False)
        self._sel.register(self._wakeup_r, selectors.EVENT_READ,
                           "wakeup")
        # conns with newly-enqueued frames awaiting a drain visit
        # (scheduled=True dedups; drained at each loop batch end)
        self._drainq: deque = deque()
        self._bufpool = BufPool()
        # ONE recv scratch for every connection's parser: the loop
        # reads one socket at a time and scratch bytes never outlive a
        # consumed() call, so sharing it keeps reactor RSS flat in the
        # connection count (see FrameParser.__init__)
        self._rx_scratch = bytearray(256 << 10)
        self._loop_tid = None
        self._loop_thread = threading.Thread(
            target=self._reactor_loop, daemon=True)
        self._loop_thread.start()

    def _accept_loop(self):
        while self._running:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True
            ).start()

    @staticmethod
    def _parse_hello(hello_obj: dict):
        """Decode a hello frame into ``(ids, ranges, mux, node_id)``.
        Raises ``_HubConnError`` for an empty/inverted claim — nothing
        to route, the connection is useless by its own admission."""
        if "node_ranges" in hello_obj:
            # hello v2 RANGE claim (edge-hub uplink): the conn owns
            # whole contiguous id intervals.  No per-id entries are
            # materialized — at 100k virtual clients behind 4 edges
            # the per-id form would hold node-map and hello-parse state
            # in the ROOT hub only to say "these 25000 consecutive ids
            # live here"
            ranges = [(int(lo), int(hi))
                      for lo, hi in hello_obj["node_ranges"]]
            if not ranges or any(lo > hi for lo, hi in ranges):
                raise _HubConnError("empty/inverted range claim")
            return [], ranges, True, ranges[0][0]
        if "node_ids" in hello_obj:
            # hello v2: one connection registers MANY node ids (a
            # muxer's virtual clients); v1 dialers keep sending the
            # single node_id form and both interop on one hub
            ids = [int(i) for i in hello_obj["node_ids"]]
            if not ids:
                raise _HubConnError("empty registration")
            return ids, [], True, ids[0]  # ids[0]: peers replies, logs
        nid = int(hello_obj["node_id"])
        return [nid], [], False, nid

    @staticmethod
    def _attach_lane(hello_obj: dict, node_id):
        """shm-lane capability (hello key "shm"): the dialer created
        a slab and advertises it; attach if we can reach it (the
        same-box test IS the attach — a cross-host name simply
        doesn't exist here) and confirm in the ACK.  Any failure
        downgrades the connection to pure TCP, never an error."""
        shm_desc = hello_obj.get("shm")
        if not isinstance(shm_desc, dict):
            return None
        try:
            return ShmLane.attach(shm_desc)
        except Exception as e:
            logging.warning(
                "hub: shm attach for node %s failed (%s: %s) — "
                "connection stays pure TCP", node_id,
                type(e).__name__, e,
            )
            return None

    def _serve_conn(self, conn: socket.socket):
        node_id = None
        ids: List[int] = []
        st = None
        lane = None
        with self._lock:
            self._reader_count += 1
        try:
            _tune_socket(conn)
            f = conn.makefile("rb")
            hello = f.readline()
            if not hello:
                return
            hello_obj = json.loads(hello)
            try:
                ids, ranges, mux, node_id = self._parse_hello(hello_obj)
            except _HubConnError:
                return
            lane = self._attach_lane(hello_obj, node_id)
            # ACK BEFORE registering: once registered, the sender pool
            # may write to this conn concurrently, and an ACK
            # interleaved with a routed frame would hand the dialing
            # client garbage as its handshake line.  A frame routed in
            # the ack→register window is dropped — but nobody can have
            # observed this node as registered yet (await_peers reads
            # the registry), so that is the normal unregistered-
            # receiver drop, not a race.  Old dialers ignore the extra
            # "shm" confirmation key.
            conn.sendall((json.dumps(
                {**_ACK, "shm": lane is not None}
            ) + "\n").encode())
            # clock-sync phase: still UNREGISTERED (no sender worker can
            # touch this conn), so ping replies may be written directly
            # by this reader thread and are guaranteed to be the next
            # line the dialer reads — the request/reply RTT is pure
            # wire + scheduling, never queue wait.  The dialer ends the
            # phase with ``ping_done``; registration happens then, so
            # its min-RTT offset estimate is in hand before any routed
            # frame can arrive.
            while True:
                line = f.readline()
                if not line:
                    return
                try:
                    frame = json.loads(line)
                except json.JSONDecodeError:
                    return  # garbled handshake: connection-fatal
                kind = frame.get(HUB_KEY)
                if kind == "ping":
                    conn.sendall((json.dumps({
                        HUB_KEY: "pong",
                        "t0": frame.get("t0"),
                        "th": time.perf_counter(),
                    }) + "\n").encode())
                    continue
                if kind == "ping_done":
                    break
                # pre-handshake peers (an old dialer): fall through to
                # registration and let the main loop service this line
                break
            st = _Conn(conn, ids=ids, mux=mux, lane=lane, ranges=ranges)
            stale_conns = self._register_conn(st, ids)
            for old in stale_conns:
                # drop the fully-displaced conn: its reader sees EOF and
                # cleans up; queued frames die with it (straggler
                # semantics, same as any dead receiver)
                try:
                    old.sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    old.sock.close()
                except OSError:
                    pass
            pending = None if frame.get(HUB_KEY) == "ping_done" \
                else (line, frame)
            while True:
                if pending is not None:
                    line, frame = pending
                    pending = None
                else:
                    line = f.readline()
                    if not line:
                        break
                    try:
                        frame = json.loads(line)
                    except json.JSONDecodeError:
                        # a garbled header is fatal for the CONNECTION,
                        # not just the frame: since frames may carry
                        # binary payloads, the stream cannot
                        # resynchronize — the "bytes" that follow could
                        # be an unannounced payload whose tail would
                        # parse as bogus headers (worst case: a
                        # fabricated __binlen__ blocks this thread on
                        # bytes that never arrive).  Dropping the conn
                        # costs the peer one reconnect (its retry/
                        # auto_reconnect path), never a wedged router.
                        break
                # v2 binary frame: the header announces exactly how many
                # raw payload bytes follow — read them here so routing
                # forwards header+payload as ONE unit and the readline
                # loop never parses payload bytes as lines.  A header
                # carrying the shm doorbell key maps the payload out of
                # the connection's slab instead; a torn descriptor is
                # connection-fatal, exactly like a garbled header.
                payload = b""
                region = None
                binlen = frame.get(FRAME_BINLEN_KEY)
                sseq = frame.pop(SHM_SEQ_KEY, None)
                if binlen and sseq is not None:
                    try:
                        payload, region = self._laned_payload(
                            st, node_id, binlen, sseq)
                    except _HubConnError:
                        break
                elif binlen:
                    payload = f.read(binlen)
                    if len(payload) < binlen:
                        break  # peer died mid-payload: torn frame == EOF
                try:
                    keep = self._route_frame(st, node_id, frame, line,
                                             payload, sseq, region)
                finally:
                    if region is not None:
                        region.release()
                if not keep:
                    break
        except OSError:
            pass  # peer vanished: fall through to cleanup
        finally:
            with self._lock:
                self._reader_count -= 1
            if st is not None:
                self._conn_cleanup(st, ids)
            elif lane is not None:
                lane.close(unlink=True)
            try:
                conn.close()
            except OSError:
                pass

    def _register_conn(self, st: _Conn, ids: List[int]) -> List["_Conn"]:
        """Register a handshake-complete connection: apply the rebind
        policy (new conn wins; range claims displace as atoms), install
        the id/range routes, and return the fully-displaced stale conns
        for the caller to dispose of — the threaded reader shuts their
        sockets down (their own reader threads then clean up on EOF),
        the reactor closes them inline through ``_close_conn_r``."""
        rebound: List[int] = []
        stale_conns: List[_Conn] = []
        ranges = st.ranges
        with self._lock:
            st.cid = next(self._cids)
            # range conns are DISPLACED AS ATOMS: any overlap with a
            # new claim (id or range) kills the old conn's whole
            # claim — an edge IS its cohort; there is no id-by-id
            # partial rebind of a range.  Counted per covered id so
            # the rebind series stays comparable across claim forms.
            for rc in [c for c in self._range_conns if c is not st]:
                hit = any(rc.covers(nid) for nid in ids) or any(
                    lo <= rhi and rlo <= hi
                    for lo, hi in ranges
                    for rlo, rhi in rc.ranges)
                if hit:
                    self.node_rebinds += rc.claimed()
                    rc.dead = True
                    self._range_conns.remove(rc)
                    stale_conns.append(rc)
                    logging.warning(
                        "hub: range claim %s displaces conn cid=%s "
                        "(ranges %s) entirely — rebind",
                        ranges or ids[:8], rc.cid, rc.ranges,
                    )
            if ranges:
                # a new RANGE claim also steals any per-id claims it
                # covers (same new-conn-wins policy; the node map is
                # small wherever range claims happen — the root tier)
                for nid, old in list(self._conns.items()):
                    if old is not st and st.covers(nid):
                        self.node_rebinds += 1
                        rebound.append(nid)
                        old.ids.discard(nid)
                        del self._conns[nid]
                        if not old.ids and not old.ranges:
                            old.dead = True
                            stale_conns.append(old)
                self._range_conns.append(st)
            for nid in ids:
                old = self._conns.get(nid)
                if old is not None and old is not st:
                    # rebind policy (pinned): the NEW conn wins the
                    # id; the old conn loses it and dies entirely
                    # once it holds no ids — counted, never silent
                    self.node_rebinds += 1
                    rebound.append(nid)
                    old.ids.discard(nid)
                    if not old.ids:
                        old.dead = True
                        stale_conns.append(old)
                self._conns[nid] = st
        tel = get_telemetry()
        for nid in rebound:
            tel.inc("hub.node_rebinds")
            logging.warning(
                "hub: node %s re-registered on a new connection — "
                "the old connection loses it (rebind)", nid,
            )
        return stale_conns

    def _laned_payload(self, st: _Conn, node_id, binlen: int, sseq):
        """Resolve one shm doorbell to its payload bytes: a refcounted
        slab pin (``ShmRegion``) on the fast path, a counted
        materialization under pin pressure.  Returns ``(payload,
        region)``; raises ``_HubConnError`` for a lane-less doorbell or
        a lane protocol error — connection-fatal, exactly like a
        garbled header (the doorbell stream cannot resynchronize)."""
        if st.lane is None:
            logging.warning(
                "hub: node %s sent an shm doorbell on a "
                "lane-less connection — dropping it", node_id,
            )
            raise _HubConnError("doorbell on a lane-less connection")
        region = None
        try:
            if st.lane.inbound_backlog() * 2 >= st.lane.nslots:
                # pin-pressure valve: ring reclamation is in-order, so
                # pins parked in one slow conn's send queue hold every
                # LATER frame's bytes too.  With half the descriptor
                # slots still pinned, materialize this frame (one
                # copy, counted) instead of letting the writer's ring
                # stall into inline-TCP fallbacks.
                payload = st.lane.read_copy(sseq, binlen)
                with self._lock:
                    self.shm_hub_copies += 1
                get_telemetry().inc("comm.shm_hub_copies",
                                    reason="pin_pressure")
            else:
                # zero-copy: the routing queues hold refcounted PINS
                # into the slab — the drain plane releases each
                # entry's reference, and the reader's own reference
                # dies right after routing
                region = st.lane.read(sseq, binlen)
                payload = region.view
        except ShmLaneError as e:
            logging.warning(
                "hub: shm lane error from node %s (%s) — "
                "dropping connection", node_id, e,
            )
            raise _HubConnError(str(e)) from None
        with self._lock:
            self.shm_frames += 1
            self.shm_bytes += binlen
        return payload, region

    def _flush_conn_queues(self, st: _Conn) -> None:
        """Release every queued entry of a connection that will never
        drain again: count the drops, release each entry's payload
        pin.  The one place queued refcounts die outside the drain
        path — called on conn death (both planes) and at ``stop()``,
        so a churn soak's pin count provably returns to zero (``stop()``
        must not exit the sender workers by sentinel with pinned entries
        still queued)."""
        with self._lock:
            leftovers = [(e[0], e[4], e[5]) for e in st.heads]
            leftovers += [(e[0], e[4], e[5]) for e in st.frames]
            st.heads.clear()
            st.frames.clear()
            st.nbytes = 0
        for mt_, rids_, reg_ in leftovers:
            for r in rids_ or ():
                self._count_drop(r, mt_)
            if reg_ is not None:
                reg_.release()

    def _conn_cleanup(self, st: _Conn, ids) -> None:
        """Tear one connection down: deregister the ids/ranges still
        mapping here, flush + release its queued entries, dump the
        black box for a live death, and close the lane + socket.
        Shared by the threaded reader's ``finally`` and the reactor's
        ``_close_conn_r``."""
        lost: List[int] = []
        lost_ranges = 0
        with self._lock:
            st.dead = True
            # identity guard: a re-registered node may have
            # been rebound to a newer conn; deregister only the
            # ids still mapping HERE
            for nid in ids:
                if self._conns.get(nid) is st:
                    self._conns.pop(nid, None)
                    lost.append(nid)
            if st in self._range_conns:
                # a dying range conn takes its whole cohort
                # claim with it (displaced conns were already
                # removed at rebind time and don't reach here)
                self._range_conns.remove(st)
                lost_ranges = sum(
                    hi - lo + 1 for lo, hi in st.ranges)
        # release queued pins NOW: in threaded mode a scheduled sender
        # worker also clears dead conns (whoever pops under the lock
        # wins — never a double release), but a conn dying between
        # visits, or at stop(), must not strand its regions
        self._flush_conn_queues(st)
        if lost_ranges and self._running:
            flight.note("events", "conn_death", cid=st.cid,
                        mux=st.mux, node_ranges=list(st.ranges),
                        n_nodes=lost_ranges)
            flight.trigger(
                "conn_death",
                reason=f"hub conn cid={st.cid} died; lost "
                       f"range claim {list(st.ranges)} "
                       f"({lost_ranges} node id(s))",
            )
        if lost and self._running:
            # a live connection died while the hub is serving —
            # the black box dumps with the per-conn queue
            # gauges and hub_stats ring still warm.  A rebound
            # conn (ids already claimed elsewhere) is NOT a
            # death; ``lost`` is only the ids that went dark.
            flight.note("events", "conn_death", cid=st.cid,
                        mux=st.mux, node_ids=sorted(lost)[:64],
                        n_nodes=len(lost))
            flight.trigger(
                "conn_death",
                reason=f"hub conn cid={st.cid} died; lost "
                       f"{len(lost)} node id(s) "
                       f"{sorted(lost)[:8]}",
            )
        if st.lane is not None:
            # detach AND unlink: a gracefully-stopping dialer
            # unlinks its own slab too (double unlink is a caught
            # no-op), but a CRASHED dialer (os._exit) never will —
            # without this, every peer crash leaks a segment in
            # /dev/shm until reboot.  Mapped regions survive the
            # unlink, so a reconnecting peer's fresh slab is
            # unaffected.  To the peer this must look exactly like
            # a dropped connection, and it does: doorbells stop,
            # the socket closes, the reconnect path re-dials with
            # a fresh slab.
            st.lane.close(unlink=True)
        try:
            st.sock.close()
        except OSError:
            pass

    # -- reactor data plane --------------------------------------------------
    #
    # Everything below runs on the ONE event-loop thread (plus _wake,
    # which any thread may call).  Per-conn reactor fields (parser,
    # phase, wpend, wcommit, wregion, want_write) are loop-thread-only
    # by construction — the reactor's analogue of the single-drainer
    # rule — while the routing/queue state stays under self._lock
    # exactly as in threaded mode.

    def _reactor_loop(self):
        """The hub's event loop: one thread multiplexing accepts,
        streaming reads (header/payload/doorbell), and writability-
        driven queue drains for every connection — O(1) threads per
        hub where the threaded plane burns one reader per conn."""
        self._loop_tid = threading.get_ident()
        tel = get_telemetry()
        sel = self._sel
        while self._running:
            try:
                events = sel.select(timeout=1.0)
            except OSError:
                break
            t0 = time.perf_counter()
            for key, mask in events:
                data = key.data
                try:
                    if data is None:
                        self._on_accept()
                    elif data == "wakeup":
                        try:
                            while os.read(self._wakeup_r, 4096):
                                pass
                        except (BlockingIOError, OSError):
                            pass
                    else:
                        if data.dead:
                            continue
                        if mask & selectors.EVENT_WRITE:
                            # a parked conn's socket opened up: resume
                            # its drain this batch (scheduled stays
                            # True while parked, so _wake dedup keeps
                            # holding)
                            with self._lock:
                                self._drainq.append(data)
                        if mask & selectors.EVENT_READ:
                            self._on_readable(data)
                except Exception:
                    # last-resort backstop: an escaped event-handler
                    # error must cost ONE connection, never the loop
                    # (a dead loop wedges every conn on the hub)
                    if isinstance(data, _Conn):
                        logging.exception(
                            "hub: reactor event error on conn "
                            "cid=%s — dropping conn", data.cid)
                        self._close_conn_r(data)
                    else:
                        logging.exception("hub: reactor event error")
            self._drain_batch()
            if events:
                # loop lag: time this batch kept the loop away from
                # select — the reactor's health metric (a stall here
                # is queue wait for EVERY connection at once)
                tel.observe("hub.loop_lag_s", time.perf_counter() - t0)
        # shutdown: tear every conn down through the full cleanup path
        # so queued pins are released, then drop the selector + pipe
        for key in list(sel.get_map().values()):
            if isinstance(key.data, _Conn):
                self._close_conn_r(key.data)
        try:
            sel.close()
        except OSError:
            pass
        for fd in (self._wakeup_r, self._wakeup_w):
            try:
                os.close(fd)
            except OSError:
                pass
        try:
            self._srv.close()
        except OSError:
            pass

    def _on_accept(self):
        """Accept every pending connection (edge-triggered burst):
        non-blocking socket, a fresh streaming parser, EVENT_READ
        registration — no thread spawn, which is what keeps per-conn
        accept latency flat through a 512-connection churn storm."""
        while True:
            try:
                conn, _ = self._srv.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            _tune_socket(conn)
            conn.setblocking(False)
            st = _Conn(conn)
            st.parser = FrameParser(pool=self._bufpool,
                                    scratch=self._rx_scratch)
            try:
                self._sel.register(conn, selectors.EVENT_READ, st)
            except (ValueError, KeyError, OSError):
                try:
                    conn.close()
                except OSError:
                    pass

    def _on_readable(self, st: _Conn):
        """Service one conn's readability: recv into the parser's
        target (scratch for headers, the pooled payload region's tail
        once mid-payload), dispatch every completed frame.  Bounded to
        ~16 recvs per event so a firehose conn can't starve the cohort
        — the level-triggered select re-reports whatever is left."""
        sock = st.sock
        for _ in range(16):
            try:
                n = sock.recv_into(st.parser.recv_target())
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                self._close_conn_r(st)
                return
            if n == 0:
                self._close_conn_r(st)  # EOF
                return
            try:
                frames = st.parser.consumed(n)
            except FrameError as e:
                logging.warning(
                    "hub: conn cid=%s dropped (%s)", st.cid, e)
                self._close_conn_r(st)
                return
            except Exception:
                # never lose the LOOP to a parser bug (same contract
                # as the _on_frame catch-all below): the conn dies
                # alone, _close_conn_r's parser.close() releases any
                # in-progress pooled region
                logging.exception(
                    "hub: parser error on conn cid=%s", st.cid)
                self._close_conn_r(st)
                return
            for idx, (frame, line, payload, region) in enumerate(frames):
                try:
                    keep = self._on_frame(st, frame, line, payload,
                                          region)
                except _HubConnError:
                    keep = False
                except OSError:
                    keep = False
                except Exception:
                    # never lose the LOOP to a routing bug — that
                    # would be every connection wedged at once; the
                    # faulting conn dies alone (threaded parity: an
                    # unexpected error killed that reader thread)
                    logging.exception(
                        "hub: reactor error on conn cid=%s", st.cid)
                    keep = False
                if not keep:
                    for _f, _l, _p, r in frames[idx + 1:]:
                        if r is not None:
                            r.release()
                    self._close_conn_r(st)
                    return

    def _on_frame(self, st: _Conn, frame: dict, line: bytes, payload,
                  region) -> bool:
        """Handle ONE parsed frame: the handshake state machine
        (hello → clock-sync → registered), then the routing dispatch
        shared with the threaded reader.  Returns False when the
        connection must close.  Owns ``region`` (the parser handed the
        reader's reference over) and releases it before returning."""
        if st.phase == 0:
            if region is not None:
                region.release()  # a hello never carries a payload
            ids, ranges, mux, nid0 = self._parse_hello(frame)
            st.ids = set(ids)
            st.ranges = tuple((int(lo), int(hi)) for lo, hi in ranges)
            st.mux = mux
            st.nid0 = nid0
            st.lane = self._attach_lane(frame, nid0)
            # ACK BEFORE registering (same contract as the threaded
            # plane: nothing can be routed here until registration, so
            # the queued ACK is the next bytes the dialer reads)
            self._ctrl_reply(st, {**_ACK, "shm": st.lane is not None})
            st.phase = 1
            return True
        if st.phase == 1:
            if region is not None:
                region.release()
            kind = frame.get(HUB_KEY)
            if kind == "ping":
                # still unregistered: the queued pong is guaranteed to
                # be the dialer's next line — RTT stays pure wire +
                # one loop batch
                self._ctrl_reply(st, {
                    HUB_KEY: "pong",
                    "t0": frame.get("t0"),
                    "th": time.perf_counter(),
                })
                return True
            if kind == "ping_done":
                self._finish_register_r(st)
                return True
            # pre-handshake peers (an old dialer): register now and
            # fall through to route this very frame
            self._finish_register_r(st)
        binlen = frame.get(FRAME_BINLEN_KEY)
        sseq = frame.pop(SHM_SEQ_KEY, None)
        if binlen and sseq is not None:
            payload, region = self._laned_payload(
                st, st.nid0, binlen, sseq)
        try:
            return self._route_frame(st, st.nid0, frame, line,
                                     payload, sseq, region)
        finally:
            if region is not None:
                region.release()

    def _finish_register_r(self, st: _Conn) -> None:
        """Registration, reactor side: install the routes (shared
        rebind policy) and dispose of the displaced conns inline —
        there is no per-conn reader thread to notice their EOF."""
        stale = self._register_conn(st, sorted(st.ids))
        for old in stale:
            self._close_conn_r(old)
        st.phase = 2

    def _ctrl_reply(self, st: _Conn, obj: dict) -> None:
        """Queue a handshake control line (ACK, pong) on the conn's own
        frame queue: before registration nothing else can enqueue to
        it, so the reply is the next bytes the dialer reads — the
        threaded plane's direct-write guarantee, in queue form."""
        data = (json.dumps(obj) + "\n").encode()
        with self._lock:
            if st.dead:
                return
            st.frames.append((None, (data,), None, len(data), (), None))
            st.nbytes += len(data)
            if not st.scheduled:
                st.scheduled = True
                self._drainq.append(st)

    def _drain_batch(self):
        """Drain every conn the batch scheduled.  Head-start contract,
        reactor form: a strict-priority first pass drains queued heads
        (stripe 0s) across ALL conns before any conn's tail pass — so
        every receiver starts streaming within one batch — then tails
        drain to each socket until it would block; the kernel's socket
        buffer is the pacing, and a blocked conn parks on EVENT_WRITE
        instead of holding a worker."""
        with self._lock:
            if not self._drainq:
                return
            batch = list(dict.fromkeys(self._drainq))
            self._drainq.clear()
        for st in batch:
            self._drain_conn(st, heads_only=True)
        for st in batch:
            self._drain_conn(st, heads_only=False)

    def _drain_conn(self, st: _Conn, heads_only: bool = False) -> None:
        """Drain one conn's queues onto its non-blocking socket until
        empty (unschedule + unpark) or the socket would block (park on
        EVENT_WRITE).  Frame bytes are built by the SAME helpers as
        the threaded sender pool (``_entry_wire``/``_prepare_send``),
        so the two planes are byte-identical by construction."""
        if st.dead:
            return
        while True:
            if st.wpend and not self._flush_wpend(st):
                return  # parked (or died) mid-frame
            stale_rids = False
            live_nodes = None
            stale_subset: Tuple = ()
            popped = False
            with self._lock:
                if st.dead:
                    return
                if st.heads:
                    msg_type, parts, hdr, nbytes, rids, region = \
                        st.heads.popleft()
                    st.nbytes -= nbytes
                    popped = True
                elif not heads_only and st.frames:
                    msg_type, parts, hdr, nbytes, rids, region = \
                        st.frames.popleft()
                    st.nbytes -= nbytes
                    popped = True
                elif not heads_only:
                    # fully drained: give the conn up (a later
                    # _forward re-schedules it) and stop watching
                    # writability, or the level-triggered select
                    # would spin on the always-writable socket
                    st.scheduled = False
                if popped:
                    stale_rids, live_nodes, stale_subset = \
                        self._stale_check_locked(st, rids, hdr)
            if not popped:
                if not heads_only:
                    self._unpark(st)
                return
            if stale_rids:
                # every id this entry addressed was rebound away
                if region is not None:
                    region.release()
                for r in rids:
                    self._count_drop(r, msg_type)
                continue
            if live_nodes is not None:
                # partially-rebound mux copy: the stolen ids lose
                # this frame (counted), the live ones still get it
                for r in stale_subset:
                    self._count_drop(r, msg_type)
            try:
                hdr_dict, line, body = self._entry_wire(
                    parts, hdr, live_nodes)
                out_parts, commit = self._prepare_send(
                    st, hdr_dict, line, body)
            except Exception:
                # never lose the loop to a drain bug: the frame dies
                # (counted), the conn keeps draining — threaded-plane
                # parity with the sender worker's catch-all
                logging.exception("hub: reactor drain error for "
                                  "conn cid=%s", st.cid)
                if region is not None:
                    region.release()
                self._count_drop(rids[0] if rids else -1, msg_type)
                continue
            pend = [p if isinstance(p, memoryview) else memoryview(p)
                    for p in out_parts]
            st.wpend = [v if v.format == "B" and v.ndim == 1
                        else v.cast("B") for v in pend]
            st.wcommit = commit
            st.wregion = region
            st.wmsg_type = msg_type
            # loop: the flush at the top writes it out

    def _flush_wpend(self, st: _Conn) -> bool:
        """Write the in-flight frame's remaining bytes.  True when the
        frame fully flushed (lane doorbell committed, payload pin
        released); False when the socket would block (conn parked on
        EVENT_WRITE) or died (torn down inline)."""
        sock = st.sock
        pend = st.wpend
        try:
            while pend:
                if hasattr(sock, "sendmsg"):
                    sent = sock.sendmsg(pend[:_IOV_MAX])
                else:  # non-POSIX fallback
                    sent = sock.send(pend[0])
                while sent:
                    head = pend[0]
                    if sent >= len(head):
                        sent -= len(head)
                        pend.pop(0)
                    else:
                        pend[0] = head[sent:]
                        sent = 0
        except (BlockingIOError, InterruptedError):
            st.wpend = pend
            self._park(st)
            return False
        except OSError:
            # dead receiver: count the in-flight frame, tear the conn
            # down (cleanup flushes + releases everything queued) —
            # the sender pool's OSError contract, reactor form
            self._count_drop(st.nid0 if st.nid0 is not None else -1,
                             st.wmsg_type)
            self._close_conn_r(st)
            return False
        st.wpend = []
        if st.wcommit is not None:
            # doorbell fully on the socket AFTER the payload was fully
            # in the slab: commit announces the descriptor (a writer
            # killed in between leaves nothing deliverable)
            lane, pending, nbody = st.wcommit
            st.wcommit = None
            lane.commit(pending)
            with self._lock:
                self.shm_frames += 1
                self.shm_bytes += nbody
        if st.wregion is not None:
            # sent: this entry's pin dies here — when the LAST queue's
            # copy drains, the region's bytes are reclaimed
            st.wregion.release()
            st.wregion = None
        st.wmsg_type = None
        return True

    def _park(self, st: _Conn) -> None:
        if st.want_write or st.dead:
            return
        try:
            self._sel.modify(st.sock,
                             selectors.EVENT_READ | selectors.EVENT_WRITE,
                             st)
            st.want_write = True
        except (KeyError, ValueError, OSError):
            pass

    def _unpark(self, st: _Conn) -> None:
        if not st.want_write:
            return
        try:
            self._sel.modify(st.sock, selectors.EVENT_READ, st)
        except (KeyError, ValueError, OSError):
            pass
        st.want_write = False

    def _close_conn_r(self, st: _Conn) -> None:
        """Reactor-side conn teardown: selector deregistration, the
        parser's in-progress region, the in-flight frame's pin, then
        the shared cleanup (deregister ids, flush queued pins, flight
        triggers, lane + socket close).  Idempotent — displacement and
        a same-batch EOF may both reach here."""
        if st.parser is None and st.dead:
            return  # already torn down
        try:
            self._sel.unregister(st.sock)
        except (KeyError, ValueError, OSError):
            pass
        if st.parser is not None:
            st.parser.close()
            st.parser = None
        if st.wregion is not None:
            st.wregion.release()
            st.wregion = None
        st.wcommit = None
        st.wpend = []
        st.want_write = False
        self._conn_cleanup(st, list(st.ids))

    def _wake(self, st: _Conn, receiver) -> None:
        """Hand a newly-scheduled conn to its drain plane: the sender
        pool's ready queue (threaded), or the loop's drain queue plus
        — when called OFF the loop thread — a wakeup-pipe tickle so a
        sleeping select services it now.  That pipe is the reactor's
        one cross-thread entry point: stop() uses it too, and chaos
        timer-delayed deliveries need nothing special (they arrive as
        ordinary socket readability on the injecting backend's conn)."""
        if self._mode == "threaded":
            self._ready.put((receiver, st))
            return
        with self._lock:
            self._drainq.append(st)
        if threading.get_ident() != self._loop_tid:
            self._tickle()

    def _tickle(self) -> None:
        try:
            os.write(self._wakeup_w, b"\x00")
        except (BlockingIOError, OSError):
            pass  # pipe full: a wakeup is already pending

    def _route_frame(self, st: _Conn, node_id: int, frame: dict,
                     line: bytes, payload, sseq, region) -> bool:
        """Route ONE inbound frame (header parsed, payload in hand) —
        the body of the reader loop's dispatch.  Returns False when the
        connection must close (a ``stop`` frame), True otherwise.

        ``payload`` is bytes on the inline-TCP path and a slab
        MEMORYVIEW on the zero-copy lane path; ``region`` is the
        backing pin (or None).  The caller releases the reader's own
        reference right after this returns, so every enqueue below
        retains per entry (``_forward`` / ``_forward_stripes``) — the
        routing layer itself never copies a laned payload."""
        if frame.get(HUB_KEY) == "mcast":
            # hub multicast: ``payload`` is ONE complete inner
            # frame (header line + buffers) shipped once over
            # the server→hub leg; fan it out by enqueueing the
            # SAME immutable bytes per receiver — receivers see
            # an ordinary frame, no client-side support needed
            receivers = frame.get("receivers") or []
            mt = frame.get("msg_type")
            if not payload:
                logging.warning("hub: mcast frame without payload")
                return True
            # per-conn dedup FIRST: receivers sharing a muxed
            # connection collapse to ONE wrapped copy per
            # connection; mcast_copies counts the physical
            # copies actually enqueued (== receivers for v1
            # dialers, == connections under muxing)
            groups, unknown = self._conn_groups(receivers)
            for r in unknown:
                self._count_drop(r, mt)
            with self._lock:
                self.mcast_frames += 1
                self.mcast_copies += len(groups)
            get_telemetry().inc("hub.mcast_frames",
                                msg_type=mt or "?")
            if (self._stripe_bytes
                    and len(payload) > self._stripe_bytes
                    and len(payload) <= _MAX_REASM_BYTES // 2):
                self._fan_out_striped(frame, groups, mt, payload,
                                      region=region)
                return True
            # traced mcast (outer header flags it): split the
            # inner frame at its header line ONCE, stamp hub_in,
            # and queue (parsed header, shared payload-tail
            # view) per receiver — the sender worker re-encodes
            # the small header per copy with its own hub_out
            # stamp while the multi-MB tail stays one object.
            # Mux wraps (traced AND untraced) are DEFERRED
            # (kind, meta, hdr) entries: the worker builds the
            # outer line at drain, filtering the target nodes
            # against the conn's live id set — a rebind while
            # the copy waits must not be fanned out to the
            # stolen id by the displaced owner.
            hdr, tail = _split_traced_mcast(frame, payload)
            for cst, rids in groups:
                if not cst.mux:
                    # plain single-id conn: the pre-mux path
                    if hdr is not None:
                        self._forward(rids[0], (tail,),
                                      msg_type=mt, hdr=hdr,
                                      nbytes=len(payload),
                                      conn=cst, region=region)
                    else:
                        self._forward(rids[0], (payload,),
                                      msg_type=mt, conn=cst,
                                      region=region)
                    continue
                body = (tail,) if hdr is not None else (payload,)
                meta = self._range_meta(cst, rids) \
                    or {"nodes": rids}
                meta["msg_type"] = mt
                ok = self._forward(
                    rids[0], body, msg_type=mt,
                    hdr=(MUX_KIND, meta, hdr),
                    nbytes=len(payload), rids=rids, conn=cst,
                    region=region)
                if not ok:
                    # _forward counted the representative id;
                    # the co-located rest lost the same copy
                    for r in rids[1:]:
                        self._count_drop(r, mt)
            return True
        if frame.get(HUB_KEY) == "peers":
            # membership introspection: reply to THIS node with
            # the currently registered ids (startup barrier —
            # frames to unregistered receivers are dropped, so
            # coordinators must await their cohort first)
            with self._lock:
                peer_ids = sorted(self._conns)
                peer_ranges = sorted(
                    [list(r) for rc in self._range_conns
                     for r in rc.ranges])
            reply_obj = {HUB_KEY: "peers", "ids": peer_ids}
            if peer_ranges:
                # range-claim cohorts are present by [lo, hi], never
                # enumerated — the whole point is O(edges) state
                reply_obj["ranges"] = peer_ranges
            self._forward(
                node_id,
                ((json.dumps(reply_obj) + "\n").encode(),),
            )
            return True
        if frame.get(HUB_KEY) == "conn_map":
            # connection-attribution introspection (the robust
            # aggregator's anti-Sybil lever): the HUB is the
            # authority on which node ids share a physical
            # connection — a malicious muxer cannot lie its
            # virtual cohort into looking like independent
            # connections.  Reply {cid: [node ids]} to the
            # requester; one frame per request, no hot-path
            # cost for anyone who never asks.
            with self._lock:
                by_cid: Dict[int, list] = {}
                for nid, cst in self._conns.items():
                    by_cid.setdefault(cst.cid, []).append(nid)
                range_cids = {str(rc.cid): [list(r) for r in rc.ranges]
                              for rc in self._range_conns}
            reply = {HUB_KEY: "conn_map",
                     "conns": {str(c): sorted(v)
                               for c, v in by_cid.items()}}
            if range_cids:
                # range conns report [lo, hi] spans, not id lists —
                # the anti-Sybil contract still holds (the hub is
                # the authority on the claim either way)
                reply["conn_ranges"] = range_cids
            self._forward(
                node_id,
                ((json.dumps(reply) + "\n").encode(),),
            )
            return True
        if frame.get(HUB_KEY) == "stop":
            return False
        receiver = frame.get("receiver")
        if receiver is not None:
            if trace_ctx.TRACE_KEY in frame:
                # traced unicast: the line IS the header — stamp
                # hub_in on the parsed dict and let the sender
                # worker re-encode it with hub_out at drain
                trace_ctx.hub_stamp(frame, "hub_in")
                self._forward(receiver,
                              (payload,) if payload else (),
                              msg_type=frame.get("msg_type"),
                              hdr=frame,
                              nbytes=len(line) + len(payload),
                              region=region)
            else:
                if sseq is not None:
                    # the raw forward ships this header line:
                    # re-encode it WITHOUT the doorbell key
                    # (popped above) — the receiver must never
                    # be told to read someone else's lane.
                    # Lazy on purpose: the dominant laned
                    # shapes (mcast/control) re-encode at drain
                    # from the parsed dict and never pay this.
                    line = (json.dumps(frame) + "\n").encode()
                self._forward(receiver,
                              (line, payload) if payload else (line,),
                              msg_type=frame.get("msg_type"),
                              region=region)
        return True

    def _lookup_locked(self, receiver: int):  # fedlint: holds=_lock
        """Resolve ``receiver`` to its connection: per-id map first,
        then the (short) range-claim list."""
        assert_held(self._lock, "TcpHub._lookup_locked")
        st = self._conns.get(receiver)
        if st is not None:
            return st
        for rc in self._range_conns:
            for lo, hi in rc.ranges:
                if lo <= receiver <= hi:
                    return rc
        return None

    def _conn_groups(self, receivers):
        """Group a receiver-id list by physical connection (the mcast
        per-conn dedup): ``([(conn, [ids...]), ...], [unknown ids])`` in
        first-appearance order.  A broadcast to 500 co-located virtual
        clients then ships the shared payload once per CONNECTION, not
        once per node."""
        groups: List[tuple] = []
        by_conn: Dict[int, tuple] = {}
        unknown: List[int] = []
        with self._lock:
            for r in receivers:
                st = self._lookup_locked(r)
                if st is None:
                    unknown.append(r)
                    continue
                key = id(st)
                ent = by_conn.get(key)
                if ent is None:
                    ent = by_conn[key] = (st, [])
                    groups.append(ent)
                ent[1].append(r)
        return groups, unknown

    @staticmethod
    def _range_meta(cst, rids):
        """The compact mux-wrap target for a fully-covered single-range
        conn, or None.  A sync addressed to an edge's ENTIRE cohort is
        the common case, and naming 25k consecutive ids costs ~175 KB
        of outer-header JSON per copy — ``{"range": [lo, hi]}`` says
        the same thing in constant space.  Partial coverage (sampled
        participation) falls back to the explicit id list."""
        if (len(cst.ranges) == 1 and not cst.ids):
            lo, hi = cst.ranges[0]
            if len(rids) == hi - lo + 1:
                return {"range": [lo, hi]}
        return None

    def _forward(self, receiver: int, parts: Tuple, msg_type=None,
                 hdr=None, nbytes=None, rids=None, conn=None,
                 region=None) -> bool:
        """Enqueue one frame for ``receiver``; the sender pool writes
        it.  Untraced (``hdr=None``): ``parts`` is the COMPLETE frame
        (header line [+ payload]).  Traced: ``hdr`` is the parsed
        header dict (already ``hub_in``-stamped; shared across an
        mcast's receiver queues) — or a deferred ``(kind, meta, inner
        header)`` tuple — and ``parts`` holds only the payload tail:
        the sender worker re-encodes the header line at drain time.
        Unknown receivers and over-bound queues drop the frame —
        counted, by design (the round deadline treats the receiver as a
        straggler).  Returns False when the frame was dropped (mux-group
        callers count the co-located ids the same drop cost).

        ``conn`` pins the target connection (mcast group paths resolve
        it ONCE in ``_conn_groups``): re-resolving by id here could
        land a mux-wrapped copy on a connection that REBOUND the
        representative id in between — the wrong peer entirely.

        ``region`` is the slab pin backing a zero-copy laned payload:
        retained BEFORE the entry becomes drainable (a sender worker
        may pop and release it the instant the lock drops) and released
        back on the drop path — the entry's reference must exist
        exactly when the entry does."""
        if nbytes is None:
            nbytes = sum(len(p) for p in parts)
        wake = False
        dropped = False
        if region is not None:
            region.retain()
        with self._lock:
            st = (conn if conn is not None
                  else self._lookup_locked(receiver))
            if st is None or st.dead:
                dropped = True
            elif (len(st.frames) + len(st.heads) >= self._max_queue_frames
                    or st.nbytes + nbytes > self._max_queue_bytes):
                self.backpressure_drops += 1
                dropped = True
            else:
                st.frames.append((msg_type, parts, hdr, nbytes,
                                  tuple(rids) if rids else (receiver,),
                                  region))
                st.nbytes += nbytes
                if region is not None:
                    self.zero_copy_forwards += 1
                if not st.scheduled:
                    st.scheduled = True
                    wake = True
        if dropped:
            if region is not None:
                region.release()
            self._count_drop(receiver, msg_type)
            return False
        if region is not None:
            get_telemetry().inc("hub.zero_copy_forwards",
                                msg_type=msg_type or "?")
        if wake:
            self._wake(st, receiver)
        return True

    def _fan_out_striped(self, frame: dict, groups, mt,
                         payload, region=None) -> None:
        """Split one mcast payload into ``mcast_stripe`` frames and
        enqueue the stripe sequence to every receiver.

        Every stripe is self-describing (its own ``__binlen__`` + a
        crc32 of its chunk), so the receiver reassembles by simple
        concatenation and detects a lost/corrupted stripe without
        trusting stream position.  The chunk buffers are memoryviews
        over the ONE payload object shared by every receiver's queue —
        striping adds outer headers, never payload copies.

        Traced frames keep the per-receiver queue-wait measurement:
        stripe 0 carries the parsed inner header dict instead of bytes,
        and the sender worker re-encodes that line with a fresh
        ``hub_out`` stamp at drain time (crc computed then) — exactly
        the whole-frame traced contract, per copy.
        """
        sid = next(self._sid)
        hdr, tail = _split_traced_mcast(frame, payload)
        body = tail if hdr is not None else memoryview(payload)
        chunks = [body[i:i + self._stripe_bytes]
                  for i in range(0, len(body), self._stripe_bytes)]
        total = len(chunks) + (1 if hdr is not None else 0)
        base = 1 if hdr is not None else 0

        def chunk_entry(k: int) -> tuple:
            ch = chunks[k]
            h = {HUB_KEY: MCAST_STRIPE_KIND, "sid": sid, "i": base + k,
                 "n": total, "msg_type": mt, "crc": zlib.crc32(ch),
                 FRAME_BINLEN_KEY: len(ch)}
            outer = (json.dumps(h) + "\n").encode()
            return (mt, (outer, ch), None, len(outer) + len(ch))

        # tail entries are shared tuples across every connection's
        # queue (same immutable buffers); only stripe 0 is per-conn —
        # a muxed conn's carries the co-located ``nodes`` list the
        # demuxing backend fans the reassembled frame out to
        if hdr is not None:
            tails = [chunk_entry(k) for k in range(len(chunks))]
        else:
            tails = [chunk_entry(k) for k in range(1, len(chunks))]
        with self._lock:
            self.striped_mcasts += 1
        # head-start scheduling: EVERY connection's stripe 0 rides the
        # strict-priority head queue, so the pool drains all head
        # stripes (small) before any tail — every receiver starts
        # streaming within one head round (bcast_queue ≈ that round,
        # not K-1 whole-frame sends) — and then drains tails at
        # ``max_inflight_stripes`` locality, which staggers COMPLETION
        # times so receivers that finish early overlap their downstream
        # work with the rest of the fan-out (full round-robin equalizes
        # completion and serializes the cohort's post-receive compute
        # after the fan-out window).
        for cst, rids in groups:
            if hdr is not None:
                # deferred stripe 0: (kind, outer meta, inner header
                # dict) — the worker builds outer line + restamped
                # inner line at drain.  nbytes is the original line's
                # length (queue accounting only; the restamp grows it
                # by one hop).
                meta0 = {"sid": sid, "i": 0, "n": total, "msg_type": mt}
                if cst.mux:
                    meta0.update(self._range_meta(cst, rids)
                                 or {"nodes": rids})
                head_entry = (mt, (), (MCAST_STRIPE_KIND, meta0, hdr),
                              len(payload) - len(body) + 64)
            elif cst.mux:
                # untraced mux stripe 0 is ALSO deferred: the worker
                # re-encodes the small outer header at drain with the
                # ``nodes`` list filtered to the conn's live ids (a
                # rebind mid-queue-wait must drop the stolen id from
                # the local fan-out); the chunk rides as parts
                ch0 = chunks[0]
                meta0 = {"sid": sid, "i": 0, "n": total, "msg_type": mt,
                         "crc": zlib.crc32(ch0)}
                meta0.update(self._range_meta(cst, rids)
                             or {"nodes": rids})
                head_entry = (mt, (ch0,), (MCAST_STRIPE_KIND, meta0,
                                           None), len(ch0) + 96)
            else:
                head_entry = chunk_entry(0)
            self._forward_stripes(cst, rids, [head_entry], mt,
                                  head=True, region=region)
        for cst, rids in groups:
            self._forward_stripes(cst, rids, tails, mt, region=region)

    def _forward_stripes(self, conn: _Conn, receivers: List[int],
                         entries: List[tuple], msg_type,
                         head: bool = False, region=None) -> None:
        """Enqueue one segment of a logical frame's stripe sequence
        atomically (all or nothing) onto the PRE-RESOLVED connection
        ``receivers`` share: an over-bound queue drops the whole
        segment in one counted decision — the receiver then sees an
        index gap (tail dropped after its head) or nothing at all, and
        either way the logical frame dies with straggler semantics
        instead of wedging reassembly (a gap aborts the stream; a head
        with no tail is evicted by the bounded-stream cap).

        ``region``: the stripe chunks are views over ONE laned payload
        — each queued entry carries its own retain() (the drain
        releases per entry), so the slab bytes live exactly as long as
        the last undrained stripe anywhere."""
        nbytes = sum(e[3] for e in entries)
        wake = False
        dropped = False
        receiver = receivers[0]
        # tag the (shared-buffer) entries with this connection's target
        # ids — the drain's rebind re-check needs them; the buffers
        # themselves stay shared across connections
        rids = tuple(receivers)
        tagged = [(e[0], e[1], e[2], e[3], rids, region) for e in entries]
        if region is not None:
            for _ in entries:
                region.retain()
        with self._lock:
            st = conn
            if st.dead:
                dropped = True
            elif (len(st.frames) + len(st.heads) + len(entries)
                    > self._max_queue_frames
                    or st.nbytes + nbytes > self._max_queue_bytes):
                self.backpressure_drops += 1
                dropped = True
            else:
                (st.heads if head else st.frames).extend(tagged)
                st.nbytes += nbytes
                self.stripe_frames += len(entries)
                if not st.scheduled:
                    st.scheduled = True
                    wake = True
        if dropped:
            if region is not None:
                for _ in entries:
                    region.release()
            for r in receivers:
                self._count_drop(r, msg_type)
            return
        if wake:
            self._wake(st, receiver)

    def _sender_loop(self):
        """Sender-pool worker: drain the one connection handed to it.
        A worker only ever services the exact ``_Conn`` it was
        scheduled for (never a same-id replacement), so a reconnecting
        node can't end up with two drainers interleaving its stream.

        Pacing: after ``max_inflight_stripes`` frames to one conn the
        worker re-queues it at the BACK of the ready queue and moves
        on (``scheduled`` stays True, so there is still exactly one
        drainer).  Combined with the head-start enqueue order
        (``_fan_out_striped``) this bounds how long any receiver's
        stream can monopolize a worker: small pace = round-robin fair
        streaming (equal completion), large pace = locality draining
        (staggered completion, better when receivers share cores with
        the hub).
        """
        while True:
            item = self._ready.get()
            if item is None:
                return
            nid, st = item
            quantum = 0
            while True:
                requeue = False
                from_head = False
                stale_rids = False
                live_nodes = None  # filtered mux/stripe-0 target list
                stale_subset: Tuple = ()
                dead_leftovers = None
                region = None
                with self._lock:
                    if st.dead:
                        # replaced/deregistered: frames die with it —
                        # COUNTED, like the OSError path's leftovers
                        # (the rebind policy promises visible drops)
                        dead_leftovers = [(e[0], e[4], e[5])
                                          for e in st.heads]
                        dead_leftovers += [(e[0], e[4], e[5])
                                           for e in st.frames]
                        st.heads.clear()
                        st.frames.clear()
                        st.nbytes = 0
                    elif st.heads:
                        # strict priority, quantum-exempt: heads are
                        # small and the head-start contract wants all
                        # of them out before any conn's tail
                        msg_type, parts, hdr, nbytes, rids, region = \
                            st.heads.popleft()
                        st.nbytes -= nbytes
                        from_head = True
                    elif not st.frames:
                        st.scheduled = False
                        break
                    elif quantum >= self._pace:
                        requeue = True
                    else:
                        msg_type, parts, hdr, nbytes, rids, region = \
                            st.frames.popleft()
                        st.nbytes -= nbytes
                    if not requeue and dead_leftovers is None:
                        stale_rids, live_nodes, stale_subset = \
                            self._stale_check_locked(st, rids, hdr)
                if dead_leftovers is not None:
                    for mt_, rids_, reg_ in dead_leftovers:
                        for r in rids_ or ():
                            self._count_drop(r, mt_)
                        if reg_ is not None:
                            reg_.release()
                    break
                if requeue:
                    self._ready.put((nid, st))
                    break
                # a head send exhausts the visit's quantum: the worker
                # requeues before touching this conn's TAIL, so every
                # other conn's pending head drains first (the requeue
                # lands behind them in the FIFO ready queue)
                quantum = self._pace if from_head else quantum + 1
                if stale_rids:
                    # every id this entry addressed was rebound away
                    if region is not None:
                        region.release()
                    for r in rids:
                        self._count_drop(r, msg_type)
                    continue
                if live_nodes is not None:
                    # partially-rebound mux copy: the stolen ids lose
                    # this frame (counted), the live ones still get it
                    for r in stale_subset:
                        self._count_drop(r, msg_type)
                try:
                    hdr_dict, line, body = self._entry_wire(
                        parts, hdr, live_nodes)
                    self._conn_send(st, hdr_dict, line, body, msg_type)
                except OSError:
                    # dead receiver: count this frame + everything still
                    # queued, deregister (its reader thread finishes
                    # cleanup when it sees EOF)
                    if region is not None:
                        region.release()
                    self._count_drop(nid, msg_type)
                    with self._lock:
                        st.dead = True
                        for i in list(st.ids):
                            if self._conns.get(i) is st:
                                self._conns.pop(i, None)
                        leftovers = [(e[0], e[4], e[5])
                                     for e in st.heads]
                        leftovers += [(e[0], e[4], e[5])
                                      for e in st.frames]
                        st.heads.clear()
                        st.frames.clear()
                        st.nbytes = 0
                    for mt_, rids_, reg_ in leftovers:
                        for r in rids_ or (nid,):
                            self._count_drop(r, mt_)
                        if reg_ is not None:
                            reg_.release()
                    break
                except Exception:
                    # never lose a pool worker to an unexpected bug —
                    # the hub would silently shrink its send capacity.
                    # Count the frame lost and KEEP DRAINING: breaking
                    # here would leave st.scheduled=True with frames
                    # queued and no drainer — a permanently wedged
                    # receiver (worse than the bug being survived)
                    logging.exception("hub: sender worker error for "
                                      "node %s", nid)
                    if region is not None:
                        region.release()
                    self._count_drop(nid, msg_type)
                    continue
                if region is not None:
                    # sent: this entry's slab pin dies here — when the
                    # LAST queue's copy drains, the ring reclaims
                    region.release()

    def _stale_check_locked(self, st: _Conn, rids,
                            hdr):  # fedlint: holds=_lock
        """Drain-time rebind re-check, shared by both drain planes: any
        id a queued entry targets may have been claimed by a NEWER
        connection while the frame sat queued — the displaced owner
        must not deliver to it (straggler drop, exactly the policy's
        "old conn loses it").  Deferred mux/stripe-0 entries carry
        their target list in ``meta['nodes']`` and get it FILTERED to
        the live subset (the outer header is rebuilt at drain anyway);
        whole entries drop only when every target is gone.  Range-claim
        conns are exempt: their cohort is an atom (displacement kills
        the whole conn via ``st.dead``, never a single id), so
        ``st.ids`` being empty must not read as "everything stale".
        Returns ``(stale_rids, live_nodes, stale_subset)``."""
        assert_held(self._lock, "TcpHub._stale_check_locked")
        if not rids or st.ranges:
            return False, None, ()
        stale_subset = tuple(r for r in rids if r not in st.ids)
        if len(stale_subset) == len(rids):
            return True, None, stale_subset
        live_nodes = None
        if stale_subset and isinstance(hdr, tuple) \
                and hdr[1].get("nodes"):
            live_nodes = [r for r in rids if r in st.ids]
        return False, live_nodes, stale_subset

    @staticmethod
    def _entry_wire(parts, hdr, live_nodes):
        """Build ONE queue entry's wire form — a byte-identity
        chokepoint shared by both drain planes (the sender pool and the
        reactor build identical frames by construction).  Three entry
        shapes:

        - deferred tuple ``(kind, meta, inner_hdr)``: build the outer
          header at drain time — around the hub_out-restamped inner
          header line when traced (``inner_hdr`` set), around the raw
          body otherwise.  Two kinds: stripe 0 of a striped mcast and
          a mux wrap.  ``live_nodes`` (rebind filtering) replaces the
          meta's target list when set.
        - parsed dict: a traced frame — re-encode the (small) header
          line with THIS copy's hub_out stamp at drain time (hub_out -
          hub_in is this receiver's real queue wait); the payload tail
          stays the one shared immutable object.
        - ``None``: untraced complete frame(s) — split the header line
          off the first part so the payload tail is lane-eligible (a
          scan up to the first newline, never a payload copy).

        Returns ``(hdr_dict, line, body)`` for ``_prepare_send``:
        exactly one of ``hdr_dict``/``line`` is set."""
        if isinstance(hdr, tuple):
            kind, meta, inner_hdr = hdr
            if live_nodes is not None:
                meta = {**meta, "nodes": live_nodes}
            if inner_hdr is not None:
                line = trace_ctx.hub_out_line(inner_hdr)
                body = [line, *parts]
            else:
                line = None
                body = list(parts)
            if kind == MUX_KIND:
                out_hdr = {HUB_KEY: MUX_KIND, **meta,
                           FRAME_BINLEN_KEY: sum(len(p) for p in body)}
            else:
                out_hdr = {HUB_KEY: MCAST_STRIPE_KIND, **meta}
                if line is not None:
                    # traced stripe 0: the restamped line IS the
                    # chunk — crc what actually ships
                    out_hdr["crc"] = zlib.crc32(line)
                out_hdr[FRAME_BINLEN_KEY] = sum(len(p) for p in body)
            return out_hdr, None, body
        if hdr is not None:
            stamped = dict(hdr)
            trace_ctx.hub_stamp(stamped, "hub_out")
            return stamped, None, list(parts)
        first = parts[0]
        end = split_frame_line(first)
        if end <= 0 or end == len(first):
            # header-only first part (control frames, the
            # unicast-forward (line, payload) shape)
            return None, first, [p for p in parts[1:] if len(p)]
        # embedded header (whole-frame mcast copy): the tail view
        # shares the one payload object
        view = memoryview(first)
        return (None, bytes(view[:end]),
                [view[end:], *(p for p in parts[1:] if len(p))])

    def _prepare_send(self, st: _Conn, hdr_dict, line, body):
        """Lane-or-inline decision + final header encoding for one
        outbound frame — the second shared chokepoint: both drain
        planes ship exactly what this returns.  Exactly one of
        ``hdr_dict`` (still a dict — drain-built outer headers, traced
        restamps) and ``line`` (already-encoded bytes) is set on entry;
        ``body`` holds the payload parts.  Lane refusal (ring full,
        descriptor queue full, oversized) falls back to the inline
        write, per frame, counted — never an error and never a stall.

        Returns ``(socket_parts, lane_commit)``: ``lane_commit`` is
        ``(lane, pending, nbody)`` when the payload rode the shm ring —
        the caller commits it only AFTER the doorbell line is fully on
        the socket (a writer killed between the two leaves nothing
        deliverable; the descriptor is never announced) and then counts
        ``shm_frames``/``shm_bytes``."""
        lane = st.lane
        nbody = sum(len(p) for p in body) if body else 0
        if lane is not None and nbody >= self._shm_min and nbody:
            pending = lane.try_send(body, nbody)
            if pending is not None:
                if hdr_dict is None:
                    hdr_dict = json.loads(line)
                out = (json.dumps(
                    {**hdr_dict, SHM_SEQ_KEY: ShmLane.seq_of(pending)}
                ) + "\n").encode()
                return [out], (lane, pending, nbody)
            with self._lock:
                self.shm_fallbacks += 1
            get_telemetry().inc("comm.shm_fallbacks",
                                reason=lane.last_refusal)
        if hdr_dict is not None:
            line = (json.dumps(hdr_dict) + "\n").encode()
        return ([line, *body] if body else [line]), None

    def _conn_send(self, st: _Conn, hdr_dict, line, body, msg_type) -> None:
        """Threaded-plane frame write: blocking vectored send of
        whatever ``_prepare_send`` decided, then the lane commit.
        OSErrors propagate to the caller's dead-receiver handling."""
        parts, commit = self._prepare_send(st, hdr_dict, line, body)
        _sendall_parts(st.sock, parts)
        if commit is not None:
            lane, pending, nbody = commit
            lane.commit(pending)
            with self._lock:
                self.shm_frames += 1
                self.shm_bytes += nbody

    def _count_drop(self, receiver: int, msg_type) -> None:
        mt = msg_type or HUB_KEY
        with self._lock:
            self.dropped_frames[mt] = self.dropped_frames.get(mt, 0) + 1
        get_telemetry().inc("hub.dropped_frames", msg_type=mt)
        logging.debug("hub: dropped %s frame to unreachable node %s",
                      mt, receiver)

    def _counters_snapshot(self) -> dict:  # fedlint: holds=_lock
        assert_held(self._lock, "TcpHub._counters_snapshot")
        return {
            "dropped_frames": dict(self.dropped_frames),
            "backpressure_drops": self.backpressure_drops,
            "mcast_frames": self.mcast_frames,
            "mcast_copies": self.mcast_copies,
            "striped_mcasts": self.striped_mcasts,
            "stripe_frames": self.stripe_frames,
            "node_rebinds": self.node_rebinds,
            "shm_frames": self.shm_frames,
            "shm_bytes": self.shm_bytes,
            "shm_fallbacks": self.shm_fallbacks,
            "shm_hub_copies": self.shm_hub_copies,
            "zero_copy_forwards": self.zero_copy_forwards,
        }

    def stats(self) -> dict:
        """Hub-side fault + fan-out accounting (``run_hub`` prints this
        at shutdown so multi-process chaos drivers can collect it).
        ``nodes`` counts registered node ids, ``connections`` physical
        sockets — equal for v1 dialers, many-to-one under muxing."""
        with self._lock:
            snap = self._counters_snapshot()
            snap["nodes"] = len(self._conns) + sum(
                rc.claimed() for rc in self._range_conns)
            conns = set(map(id, self._conns.values()))
            conns.update(map(id, self._range_conns))
            snap["connections"] = len(conns)
            snap["shm_conns"] = len(
                {id(c) for c in self._conns.values()
                 if c.lane is not None}
            )
            snap["range_conns"] = len(self._range_conns)
            snap["mode"] = self._mode
            snap["threads"] = self._thread_count_locked()
            snap["open_fds"] = self._open_fds_locked()
        return snap

    def _thread_count_locked(self) -> int:  # fedlint: holds=_lock
        """Hub-owned thread count — the reactor's O(1)-in-connections
        claim as a measurement: 1 loop thread, vs the threaded plane's
        accept thread + sender pool + one reader per live conn."""
        assert_held(self._lock, "TcpHub._thread_count_locked")
        if self._mode == "reactor":
            return 1
        return 1 + len(self._senders) + self._reader_count

    def _open_fds_locked(self) -> int:  # fedlint: holds=_lock
        """Descriptors the hub holds open (reactor: everything the
        selector watches — server + wakeup pipe + conns; threaded:
        conn sockets + the server)."""
        assert_held(self._lock, "TcpHub._open_fds_locked")
        if self._mode == "reactor":
            try:
                fd_map = self._sel.get_map()
            except RuntimeError:
                fd_map = None
            # a closed selector returns None (3.11) or raises — either
            # way stop() raced the sample and the honest answer is 0
            return len(fd_map) if fd_map is not None else 0
        conns = set(map(id, self._conns.values()))
        conns.update(map(id, self._range_conns))
        return len(conns) + 1

    def sample_telemetry(self, telemetry=None) -> dict:
        """Snapshot ``stats()`` + per-CONNECTION send-queue depths into
        the telemetry registry: gauges for live introspection plus one
        ``hub_stats`` event per call.  Queue depth and backpressure are
        physical-connection properties (a muxer's 500 virtual node ids
        share ONE queue), so the series are keyed by connection id with
        a ``hub.conn_nodes`` gauge carrying each connection's node
        count and a ``hub.nodes`` total alongside — node-keyed copies
        of the same number would overstate a muxed hub's queue memory
        500x.  ``run_hub`` calls this on a timer and drains into
        ``metrics-hub.jsonl``, so a crashed or SIGKILLed hub still
        leaves queue-depth / backpressure evidence behind as a time
        series — and the per-sample ``t_m`` monotonic stamp lines queue
        depth up against the per-frame hop stamps, which share this
        clock."""
        t = telemetry or get_telemetry()
        with self._lock:
            depths = {}
            nodes_total = len(self._conns) + sum(
                rc.claimed() for rc in self._range_conns)
            shm_conns = 0
            for st in set(self._conns.values()) | set(self._range_conns):
                depths[st.cid] = (len(st.frames) + len(st.heads),
                                  st.nbytes, st.claimed())
                if st.lane is not None:
                    shm_conns += 1
            snap = self._counters_snapshot()
            hub_threads = self._thread_count_locked()
            open_fds = self._open_fds_locked()
        for cid, (nframes, nbytes, nids) in depths.items():
            t.gauge_set("hub.send_queue_frames", nframes, conn=cid)
            t.gauge_set("hub.send_queue_bytes", nbytes, conn=cid)
            t.gauge_set("hub.conn_nodes", nids, conn=cid)
        t.gauge_set("hub.connections", len(depths))
        t.gauge_set("hub.nodes", nodes_total)
        # _total suffix = cumulative monotonic counter exposed as a time
        # series (diff successive samples for a rate); un-suffixed hub
        # gauges (connections, nodes, send_queue_*) are instantaneous.
        # mcast copies lose their identity once queued, so no true
        # in-flight mcast count exists to report
        t.gauge_set("hub.backpressure_drops_total",
                    snap["backpressure_drops"])
        t.gauge_set("hub.mcast_frames_total", snap["mcast_frames"])
        t.gauge_set("hub.stripe_frames_total", snap["stripe_frames"])
        t.gauge_set("hub.node_rebinds_total", snap["node_rebinds"])
        t.gauge_set("hub.shm_conns", shm_conns)
        t.gauge_set("hub.shm_frames_total", snap["shm_frames"])
        t.gauge_set("hub.shm_bytes_total", snap["shm_bytes"])
        t.gauge_set("hub.shm_fallbacks_total", snap["shm_fallbacks"])
        # reactor-plane health: thread inventory (the O(1) claim as a
        # series) and watched-descriptor count; hub.loop_lag_s (the
        # per-batch histogram) is observed by the loop itself
        t.gauge_set("hub.threads", hub_threads)
        t.gauge_set("hub.open_fds", open_fds)
        t.event(
            "hub_stats", t_m=trace_ctx.now(),
            connections=sorted(depths),
            nodes=nodes_total,
            queue_frames={str(c): d[0] for c, d in depths.items()},
            queue_bytes={str(c): d[1] for c, d in depths.items()},
            conn_nodes={str(c): d[2] for c, d in depths.items()},
            **snap,
        )
        snap["nodes"] = nodes_total
        snap["connections"] = len(depths)
        return snap

    def stop(self):
        self._running = False
        if self._mode == "reactor":
            # wake the sleeping select; the loop's exit path tears every
            # conn down through _close_conn_r (pins flushed + released)
            self._tickle()
            self._loop_thread.join(timeout=10)
            if self._loop_thread.is_alive():
                # loop wedged (should not happen): at least release the
                # queued pins so a soak's leak accounting stays clean
                with self._lock:
                    states = (set(self._conns.values())
                              | set(self._range_conns))
                for st in states:
                    self._flush_conn_queues(st)
                    try:
                        st.sock.close()
                    except OSError:
                        pass
                try:
                    self._srv.close()
                except OSError:
                    pass
            return
        with self._lock:
            states = set(self._conns.values()) | set(self._range_conns)
        for st in states:
            try:
                st.sock.close()
            except OSError:
                pass
        for _ in self._senders:
            self._ready.put(None)
        # the workers exit via the sentinel WITHOUT visiting their
        # queues: release every still-queued payload pin here, or a
        # stop with in-flight laned frames leaks their slab/pool
        # references (the dead-receiver cleanup satellite's stop() leg)
        for st in states:
            self._flush_conn_queues(st)
        self._srv.close()


class TcpBackend(CommBackend):
    """One node's hub connection.

    ``auto_reconnect`` (attempts; 0 = off) makes ``run()`` survive a
    dropped hub connection: on EOF/reset the backend dials again,
    re-registers (the hub's identity guard swaps the live conn,
    ``TcpHub._serve_conn``), and resumes the read loop.  Frames routed
    while disconnected are lost — by design the round-deadline server
    (``fedavg_cross_device``) treats the node as a straggler for that
    round and it rejoins at the next sync.

    Striped multicast reassembly: a hub running striped fan-out delivers
    a broadcast as ``__hub__: mcast_stripe`` frames; this backend
    reassembles them per stripe-stream id into the original inner frame
    and delivers it like any whole frame (``_on_stripe``).  The buffer
    is bounded (streams + bytes) and a lost/corrupted stripe kills the
    WHOLE logical frame — counted, never a wedged reassembly: the round
    deadline treats the node as a straggler exactly as for a dropped
    whole frame.
    """

    # lock-discipline contract (fedlint): the reader thread owns
    # reassembly, but the chaos layer installs its stripe hook from the
    # construction thread — all reassembly state rides one lock
    _GUARDED_BY = {
        "_reasm": "_reasm_lock",
        "_reasm_bytes": "_reasm_lock",
        "_dead_sids": "_reasm_lock",
        "_stripe_fault_hook": "_reasm_lock",
    }

    # bounded reassembly: at most this many concurrent stripe streams
    # (two mcasts can interleave on one conn; more means lost finals
    # piling up) and this many buffered payload bytes (the hub refuses
    # to stripe frames over HALF this shared budget — see the module
    # constant — so a well-formed stream can never overflow it alone)
    _MAX_REASM_STREAMS = 8
    _MAX_REASM_BYTES = _MAX_REASM_BYTES

    def __init__(self, node_id: int, host: str, port: int,
                 timeout: float = 30.0, auto_reconnect: int = 0,
                 send_retries: int = 3, wire: int = 2,
                 lane: str = "tcp",
                 shm_data_bytes: int = DEFAULT_DATA_BYTES,
                 shm_slots: int = DEFAULT_SLOTS,
                 shm_min_bytes: int = DEFAULT_MIN_BYTES):
        super().__init__(node_id)
        self._host, self._port, self._timeout = host, port, timeout
        self.auto_reconnect = auto_reconnect
        # transport lane for payload bytes: "shm" creates a
        # shared-memory slab per dial and advertises it in the hello —
        # same-box hubs attach and both directions' payloads ride its
        # rings (headers stay on TCP); anything else (cross-host peer,
        # refused attach, full ring, oversized frame) falls back to
        # inline TCP per frame, counted.  "tcp" (default) is bitwise
        # the pre-lane transport.
        if lane not in ("tcp", "shm"):
            raise ValueError(f"unknown lane {lane!r} (tcp|shm)")
        self._lane_mode = lane
        self._shm_data = int(shm_data_bytes)
        self._shm_slots = int(shm_slots)
        self._shm_min = max(0, int(shm_min_bytes))
        self._lane: Optional[ShmLane] = None
        # wire generation for OUTBOUND frames: 2 = binary v2 frames
        # (Message.to_frame), 1 = legacy JSON lines (b64 arrays) — the
        # baseline arm of the compression measurement and the interop
        # test knob.  Inbound frames of either generation always decode.
        self.wire = int(wire)
        # bounded retry budget for send_message: a transient OSError
        # (hub restarting, conn mid-swap by the reconnect path) used to
        # be terminal for the SENDER even though the reader thread was
        # about to re-dial.  0 = fail fast (the pre-fault behavior).
        self.send_retries = max(0, int(send_retries))
        self._stopped = threading.Event()
        # the rebind path leaves its displaced socket/lane OPEN for the
        # hub to close (closing it ourselves would race the hub's
        # deferred registration of the new conn and turn the rebind
        # into a plain re-register); reaped at the next rebind or stop
        self._stale_conn = None  # (file, sock, lane) or None
        # serializes send_message against _dial's socket swap: without
        # it, a send between "socket connected" and "hello written"
        # lands BEFORE the registration line and the hub parses the
        # message frame as the hello (KeyError, conn dropped, frame lost)
        self._send_lock = make_lock("TcpBackend._send_lock")
        # striped-multicast reassembly (see class doc): sid -> entry
        self._reasm_lock = make_lock("TcpBackend._reasm_lock")
        self._reasm: Dict[int, dict] = {}
        self._reasm_bytes = 0
        self._dead_sids: deque = deque(maxlen=64)  # aborted stream ids
        self._stripe_fault_hook = None
        # latest hub conn_map reply ({cid: [node ids]}): written only by
        # the reader thread (atomic reference swap), read by the robust
        # aggregator's connection attribution — never mutated in place
        self._conn_map: Optional[dict] = None
        self._dial()

    def set_stripe_fault_hook(self, hook) -> None:
        """Install a per-stripe fault hook (chaos layer):
        ``hook(msg_type, sid, idx, chunk) -> chunk | None`` runs on
        every arriving stripe before crc verification — ``None``
        simulates a lost stripe, a mutated chunk a corrupted one (the
        crc then catches it).  The reassembly must degrade to a dropped
        logical frame either way."""
        with self._reasm_lock:
            self._stripe_fault_hook = hook

    def _hello_obj(self) -> dict:
        """Registration payload.  v1: one ``node_id``.  The muxed
        subclass overrides with the hello-v2 ``node_ids`` form
        (``comm/mux.py``); the hub accepts both on one port."""
        return {"node_id": self.node_id}

    def _hello_line(self, lane: Optional[ShmLane] = None) -> bytes:
        obj = self._hello_obj()
        if lane is not None:
            # shm capability: advertise the freshly created slab; the
            # hub attaches (same box) or ignores (cross-host / error)
            # and confirms in its ACK
            obj["shm"] = lane.describe()
        return (json.dumps(obj) + "\n").encode()

    def _dial(self, keep_stale: bool = False):
        with self._send_lock:
            sock = socket.create_connection(
                (self._host, self._port), timeout=self._timeout
            )
            _tune_socket(sock)
            # slab creation only AFTER the socket connected: the
            # startup/reconnect paths retry _dial in a loop, and a
            # pre-connect slab (2 rings, fully prefaulted) would leak
            # ~shm_data x2 of tmpfs per refused connection — the
            # cleanup below owns it from here on
            lane = None
            if self._lane_mode == "shm":
                try:
                    lane = ShmLane.create(self._shm_data, self._shm_slots)
                except Exception as e:
                    logging.warning(
                        "node %d: shm slab creation failed (%s: %s) — "
                        "dialing pure TCP", self.node_id,
                        type(e).__name__, e,
                    )
                    get_telemetry().inc("comm.shm_fallbacks",
                                        reason="create")
                    lane = None
            try:
                sock.sendall(self._hello_line(lane))
                f = sock.makefile("rb")
                # wait for the hub's registration ACK — guaranteed to be
                # the FIRST line on the conn (the hub ACKs before
                # registering, so no routed frame can precede or
                # interleave it); afterwards, any frame sent TO this
                # node can be delivered
                ack = f.readline()
                ack_obj = json.loads(ack) if ack else {}
                if ack_obj.get(HUB_KEY) != "ack":
                    raise ConnectionError(
                        f"node {self.node_id}: no hub ACK"
                    )
                if lane is not None and not ack_obj.get("shm"):
                    # hub could not (or would not) map the slab: stay
                    # pure TCP on this connection — the automatic
                    # cross-host / old-hub downgrade
                    lane.close(unlink=True)
                    lane = None
                    get_telemetry().inc("comm.shm_fallbacks",
                                        reason="attach")
                # handshake phase 2: the hub does NOT register this
                # conn until it reads ``ping_done`` (before that, its
                # reader thread can reply to clock-sync pings directly
                # with no sender-pool interleaving risk) — so EVERY
                # dialer must end the phase, even an untraced one that
                # sends no pings, or a receive-only node would never
                # register and every frame to it would drop
                if trace_ctx.enabled():
                    self._clock_sync(sock, f)  # ping burst + ping_done
                else:
                    sock.sendall(
                        (json.dumps({HUB_KEY: "ping_done"}) + "\n").encode()
                    )
            except BaseException:
                try:
                    sock.close()
                except OSError:
                    pass
                if lane is not None:
                    lane.close(unlink=True)
                raise
            sock.settimeout(None)
            if keep_stale:
                # rebind path: the OLD connection must stay registered
                # until the hub processes the new hello (that overlap
                # IS what makes it a counted rebind, and the hub then
                # closes the displaced conn itself) — park it for the
                # next rebind/stop to reap
                self._stale_conn = (getattr(self, "_file", None),
                                    getattr(self, "_sock", None),
                                    self._lane)
            else:
                # close the connection being replaced (reconnect path)
                # — without this every reconnect cycle leaks an fd (and
                # its slab: each dial advertises a FRESH lane, so the
                # old one is unlinked here)
                for stale in (getattr(self, "_file", None),
                              getattr(self, "_sock", None)):
                    if stale is not None:
                        try:
                            stale.close()
                        except OSError:
                            pass
                if self._lane is not None:
                    self._lane.close(unlink=True)
            self._sock, self._file = sock, f
            self._lane = lane

    def _clock_sync(self, sock: socket.socket, f, pings: int = 8) -> None:
        """NTP-style handshake ping burst (tracing on only): the hub is
        still in its pre-registration phase for this conn, so replies
        are written directly by its reader thread — the RTT is pure
        wire + scheduling, never sender-pool queue wait.  The min-RTT
        sample's midpoint estimates this process's monotonic-clock
        offset to the hub (``trace_ctx.estimate_offset``), recorded as
        a ``clock_sync`` telemetry event — what lets the timeline
        merger place every process on the hub's clock.  ``ping_done``
        ends the phase; only then does the hub register the conn."""
        samples = []
        for _ in range(pings):
            t0 = time.perf_counter()
            sock.sendall((json.dumps(
                {HUB_KEY: "ping", "t0": t0}
            ) + "\n").encode())
            line = f.readline()
            t1 = time.perf_counter()
            if not line:
                raise ConnectionError(
                    f"node {self.node_id}: hub closed during clock sync"
                )
            pong = json.loads(line)
            if pong.get(HUB_KEY) != "pong":
                raise ConnectionError(
                    f"node {self.node_id}: bad clock-sync reply {pong!r}"
                )
            samples.append((t0, pong.get("th"), t1))
        sock.sendall((json.dumps({HUB_KEY: "ping_done"}) + "\n").encode())
        offset, rtt = trace_ctx.estimate_offset(samples)
        trace_ctx.record_clock_sync(self.node_id, offset, rtt, len(samples))

    def _send_parts(self, parts: List, msg_type: str) -> None:
        """Bounded-retry vectored write of one complete frame.

        Exponential backoff + jitter: each attempt re-reads self._sock,
        so a reconnect (reader thread's _dial swapping the socket)
        between attempts is picked up.  A retry after a PARTIAL write
        hands the hub a garbled header line — the hub treats that as
        fatal for the CONNECTION (frames may carry binary payloads, so
        a garbled boundary cannot be resynchronized) and drops it; this
        node's reader then sees EOF and the auto_reconnect/round-
        deadline machinery covers the lost frame.  Never stream
        corruption, at worst one reconnect.  A backend killed by
        _kill_connection must not retry: the stream is desync-fatal by
        contract and callers expect OSError.  ``parts`` is immutable
        across attempts (and across broadcast receivers) — the frame is
        encoded exactly once however many times it is written.
        """
        if self._lane is not None and len(parts) > 1:
            body = parts[1:]
            nbody = sum(len(p) for p in body)
            # nbody > 0: a zero-byte body must ride inline — the
            # receiver's `binlen and sseq` gate never reads an empty
            # descriptor, so publishing one would desync the lane seq
            if (nbody and nbody >= self._shm_min
                    and self._send_parts_shm(parts, body, nbody,
                                             msg_type)):
                return
        delay = 0.05
        for attempt in range(self.send_retries + 1):
            try:
                with self._send_lock:
                    _sendall_parts(self._sock, parts)
                return
            except OSError:
                if self._stopped.is_set() or attempt >= self.send_retries:
                    raise
                get_telemetry().inc("comm.send_retries", msg_type=msg_type)
                time.sleep(delay * (1.0 + _retry_jitter(self.node_id,
                                                        attempt)))
                delay = min(delay * 2.0, 2.0)

    def _send_parts_shm(self, parts: List, body: List, nbody: int,
                        msg_type: str) -> bool:
        """Lane attempt for one frame: payload into the outbound ring,
        then the header line — with the doorbell key spliced in — over
        TCP.  Returns False (caller ships the whole frame inline) on
        any refusal: ring/descriptor-queue full, oversized payload, or
        a doorbell write error (the reserved ring space is simply never
        committed, so the rollback is free).  Counted either way."""
        tel = get_telemetry()
        with self._send_lock:
            lane = self._lane
            if lane is None:
                return False  # reconnect swapped the conn mid-call
            pending = lane.try_send(body, nbody)
            if pending is None:
                tel.inc("comm.shm_fallbacks", reason=lane.last_refusal)
                return False
            hdr = json.loads(parts[0])
            hdr[SHM_SEQ_KEY] = ShmLane.seq_of(pending)
            try:
                _sendall_parts(self._sock,
                               [(json.dumps(hdr) + "\n").encode()])
            except OSError:
                # a partial doorbell garbles the stream and the hub
                # drops the conn — same contract as any partial write;
                # the caller's retry path covers the frame
                tel.inc("comm.shm_fallbacks", reason="send_error")
                return False
            lane.commit(pending)
        tel.inc("comm.shm_frames", msg_type=msg_type)
        tel.inc("comm.shm_bytes", nbody, msg_type=msg_type)
        return True

    def send_message(self, msg: Message) -> None:
        self._send_message_as(msg, self.node_id)

    def _send_message_as(self, msg: Message, origin: int) -> None:
        """One frame onto the shared socket, trace-stamped as coming
        from ``origin`` — the node_id for a plain backend, the VIRTUAL
        node id when a muxed connection sends on a virtual client's
        behalf (``comm/mux.py``), so per-virtual-node hop chains stay
        distinguishable over one physical conn.

        v2: header line + raw buffer views (to_frame_parts, memoized
        on the message); v1: one JSON line (newlines escape inside
        JSON strings) — either way ONE complete frame, written
        atomically (vectored) under the send lock."""
        _refuse_device_leaves(msg)
        t0 = time.perf_counter()
        trace_ctx.ensure(msg, origin)
        if self.wire >= 2:
            # restamp_parts re-encodes ONLY the header line around the
            # memoized encoding (payload views shared by identity) — a
            # no-op returning the memoized list when untraced
            parts = trace_ctx.restamp_parts(
                msg, msg.to_frame_parts(), origin, "send"
            )
        else:
            trace_ctx.stamp_msg(msg, origin, "send")
            parts = [(msg.to_json() + "\n").encode()]
        self._send_parts(parts, msg.type)
        # exact wire bytes; latency covers serialize + socket write
        # (including any backoff — a retried send IS that slow)
        self._record_send(msg, sum(len(p) for p in parts),
                          time.perf_counter() - t0)

    def send_multicast(self, msg: Message, receivers) -> None:
        """Native hub fan-out: ONE ``__hub__: mcast`` control frame
        wrapping the encoded message (header line + raw buffers) plus a
        receiver list.  The hub enqueues the same immutable payload to
        every receiver, so the server→hub broadcast leg is O(model) per
        round instead of O(receivers · model)."""
        receivers = [int(r) for r in receivers]
        if not receivers:
            return
        _refuse_device_leaves(msg)
        if self.wire < 2:
            # v1 frames are legacy JSON lines with per-receiver
            # envelopes — keep the unicast loop (fallback matrix arm)
            super().send_multicast(msg, receivers)
            return
        t0 = time.perf_counter()
        trace_ctx.ensure(msg, self.node_id)
        inner = msg.to_frame_parts()  # encode ONCE for the whole cohort
        traced = trace_ctx.TRACE_KEY in msg.params
        if traced:
            # one 'send' stamp shared by the whole cohort (the frame IS
            # one object); per-copy divergence begins at the hub's
            # per-receiver hub_out restamp
            inner = trace_ctx.restamp_parts(msg, inner, self.node_id, "send")
        head = (json.dumps({
            HUB_KEY: "mcast",
            "receivers": receivers,
            "msg_type": msg.type,
            # binlen AFTER the restamp: the inner header line grew
            FRAME_BINLEN_KEY: sum(len(p) for p in inner),
            **({trace_ctx.TRACE_KEY: True} if traced else {}),
        }) + "\n").encode()
        parts = [head, *inner]
        self._send_parts(parts, msg.type)
        t = get_telemetry()
        t.inc("comm.mcast_sends", msg_type=msg.type)
        t.inc("comm.mcast_receivers", len(receivers), msg_type=msg.type)
        # ONE wire frame however many receivers — comm.sent_bytes for a
        # broadcast now counts the payload once
        self._record_send(msg, sum(len(p) for p in parts),
                          time.perf_counter() - t0)

    def request_conn_map(self) -> None:
        """Ask the hub for its node→connection grouping (replied
        asynchronously; the reader loop stores the latest map, read via
        ``conn_map``).  Best-effort: a failed request just leaves the
        previous map in place — connection caps then attribute against
        slightly stale grouping, which the rebind counters make
        visible."""
        line = (json.dumps({HUB_KEY: "conn_map"}) + "\n").encode()
        try:
            with self._send_lock:
                _sendall_parts(self._sock, [line])
        except OSError:
            logging.warning("node %d: conn_map request failed",
                            self.node_id)

    def conn_map(self) -> Optional[dict]:
        """Latest hub ``{cid: [node ids]}`` reply (None before the
        first one).  The returned object is never mutated — callers may
        identity-cache it."""
        return self._conn_map

    def _sync_hub_replies(self, kind: str, timeout: float, op: str):
        """Pre-``run()`` synchronous hub-RPC loop — the ONE
        implementation behind ``await_peers`` and ``fetch_conn_map``:
        send a ``{__hub__: kind}`` request, read frames off the shared
        socket, and yield each matching reply (the caller decides
        whether to return or poll again; resuming the generator
        re-sends the request).

        Frame discipline while waiting (the part that must not drift
        between callers): a read timing out MID-frame kills the
        connection (the buffered reader discarded partial bytes —
        frame alignment can't be trusted) and raises; other ``__hub__``
        frames are skipped (stale idempotent replies); an ORDINARY
        message frame is a genuine delivery — its binary payload is
        read and the message handed to the observers, NOT dropped (the
        stats plane's early digest frames queue here while the startup
        barrier waits on slow-importing clients; eating them would
        silently lose those intervals from the SLO rollup).  The
        generator raises ``TimeoutError`` when the budget runs dry."""
        import time as _time

        deadline = _time.monotonic() + timeout
        request = (json.dumps({HUB_KEY: kind}) + "\n").encode()
        try:
            while (remaining := deadline - _time.monotonic()) > 0:
                self._sock.settimeout(max(remaining, 0.05))
                try:
                    self._sock.sendall(request)
                except TimeoutError:
                    # a timed-out sendall may have written PART of the
                    # request line — the write side is no longer
                    # frame-aligned, so the socket must not be reused
                    # (same contract as the mid-frame read below)
                    self._kill_connection()
                    raise TimeoutError(
                        f"node {self.node_id}: hub write timed out mid-"
                        f"frame during {op}; connection closed"
                    ) from None
                except OSError as e:
                    raise ConnectionError(
                        f"node {self.node_id}: hub connection failed "
                        f"during {op}: {e}"
                    ) from e
                matched = False
                while not matched and \
                        (remaining := deadline - _time.monotonic()) > 0:
                    self._sock.settimeout(max(remaining, 0.05))
                    try:
                        line = self._file.readline()
                        frame = json.loads(line) if line else None
                        # a v2 frame announces its binary payload —
                        # consume it HERE or the next readline would
                        # parse payload bytes as headers (shm doorbells
                        # consume their slab descriptor the same way;
                        # the rare pre-run delivery takes the one-copy
                        # read — these are small early frames)
                        binlen = (frame.get(FRAME_BINLEN_KEY)
                                  if isinstance(frame, dict) else None)
                        sseq = (frame.pop(SHM_SEQ_KEY, None)
                                if isinstance(frame, dict) else None)
                        if binlen and sseq is not None:
                            if self._lane is None:
                                raise ShmLaneError("no lane attached")
                            payload = self._lane.read_copy(sseq, binlen)
                        else:
                            payload = (self._file.read(binlen)
                                       if binlen else b"")
                            if binlen and len(payload) < binlen:
                                line = b""  # torn frame == EOF
                    except TimeoutError:
                        # mid-frame timeout: the stream can no longer
                        # be trusted frame-aligned (ADVICE r2) — kill
                        # it so reuse fails loudly instead of corrupting
                        self._kill_connection()
                        raise TimeoutError(
                            f"node {self.node_id}: hub read timed out "
                            f"mid-frame during {op}; connection closed "
                            "(a resumed read could split a frame)"
                        ) from None
                    except OSError as e:
                        raise ConnectionError(
                            f"node {self.node_id}: hub connection failed "
                            f"during {op}: {e}"
                        ) from e
                    except ShmLaneError as e:
                        # lane bookkeeping untrustworthy: same contract
                        # as a mid-frame timeout — the stream dies
                        self._kill_connection()
                        raise ConnectionError(
                            f"node {self.node_id}: shm lane error during "
                            f"{op}: {e}"
                        ) from e
                    if not line:
                        raise ConnectionError(
                            f"node {self.node_id}: hub closed during {op}"
                        )
                    if frame.get(HUB_KEY) == kind:
                        matched = True
                        yield frame
                    elif HUB_KEY in frame:
                        continue  # stale idempotent reply of another kind
                    else:
                        # genuine early delivery (e.g. a digest frame):
                        # hand it to the observers on this thread — a
                        # handler error must not kill the RPC
                        try:
                            self._notify(Message.from_frame(frame, payload),
                                         nbytes=len(line) + len(payload))
                        except Exception:
                            logging.exception(
                                "node %d: early frame delivery failed "
                                "during %s", self.node_id, op,
                            )
        finally:
            try:
                self._sock.settimeout(None)
            except OSError:
                pass  # _kill_connection already closed it

    def fetch_conn_map(self, timeout: float = 10.0) -> dict:
        """SYNCHRONOUS conn_map fetch — pre-``run()`` only (the
        ``_sync_hub_replies`` contract).  The robust aggregator calls
        this before the first broadcast so connection caps are armed
        from round 0 instead of racing the async reply; later topology
        changes ride the per-round ``request_conn_map`` refresh.
        Raises on timeout — a cap the operator asked for must fail
        loudly, never silently degrade to uncapped."""
        for reply in self._sync_hub_replies("conn_map", timeout,
                                            "fetch_conn_map"):
            self._conn_map = {
                int(c): [int(n) for n in nodes]
                for c, nodes in (reply.get("conns") or {}).items()
            }
            return self._conn_map
        raise TimeoutError(
            f"node {self.node_id}: no conn_map reply within {timeout}s"
        )

    def drop_connection(self) -> None:
        """Fault injection: sever the hub connection WITHOUT stopping
        the backend — ``run()`` sees EOF and, with ``auto_reconnect``,
        re-dials and re-registers exactly as for a real network drop."""
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass

    def _reap_stale_conn(self) -> None:
        stale = self._stale_conn
        if stale is None:
            return
        self._stale_conn = None
        f, sock, lane = stale
        for closer in (f, sock):
            if closer is not None:
                try:
                    closer.close()
                except OSError:
                    pass
        if lane is not None:
            lane.close(unlink=True)  # hub already unlinked: no-op

    def rebind_connection(self) -> None:
        """Churn injection: dial a FRESH connection (new hello, new
        slab) while the old one is STILL registered — the silent-death
        shape, where the hub learns about the replacement only from
        the new hello and counts a REBIND for every id (the
        ``hub.node_rebinds`` policy).  The displaced socket is left
        open deliberately: the hub's registration of the new conn is
        deferred to its ``ping_done``, so closing the old one here
        would race that registration and sometimes demote the rebind
        to a plain re-register.  The HUB closes the displaced conn
        once every id moved; we reap the dead fd/slab at the next
        rebind or stop.  The reader resumes on the swapped stream
        without spending a reconnect retry."""
        self._reap_stale_conn()
        # a failed re-dial needs no rollback: the reader tells a
        # displaced socket's EOF from a genuine one by comparing the
        # stream it was blocked on against the live self._file —
        # if the dial never swapped it, ordinary drop semantics (the
        # auto_reconnect budget) take over on their own
        self._dial(keep_stale=True)

    def await_peers(self, ids, timeout: float = 60.0) -> None:
        """Block until every node id in ``ids`` is registered at the hub.

        MUST be called before ``run()`` (it reads replies off the
        shared socket — the ``_sync_hub_replies`` contract; ordinary
        frames arriving early are DELIVERED to the observers, not
        dropped).  This is the startup barrier: the hub drops frames to
        unregistered receivers, so a coordinator that broadcasts before
        its cohort registered would hang the federation.  A budget
        spent between full reads leaves the stream frame-aligned and
        the backend reusable; only a mid-frame timeout kills the
        connection.
        """
        import time as _time

        want = set(int(i) for i in ids)
        for reply in self._sync_hub_replies("peers", timeout,
                                            "await_peers"):
            have = set(reply.get("ids", []))
            missing = want - have
            if missing:
                # range-claim cohorts (edge uplinks) are reported as
                # [lo, hi] spans — check the remainder against them
                # without materializing the span
                for lo, hi in reply.get("ranges", ()):
                    missing = {m for m in missing
                               if not (lo <= m <= hi)}
                    if not missing:
                        break
            if not missing:
                return
            _time.sleep(0.05)  # poll: resuming re-sends the request
        raise TimeoutError(
            f"node {self.node_id}: peers {sorted(want)} not all registered "
            f"within {timeout}s"
        )

    def _kill_connection(self) -> None:
        """Mark the backend unusable and close the socket (desync-fatal
        paths): later send_message/run calls get OSError immediately."""
        self._stopped.set()
        # shutdown() disables the connection immediately even though the
        # makefile() reader still holds a reference to the fd (a bare
        # close() is deferred by that refcount and sends would still work)
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        for closer in (self._file.close, self._sock.close):
            try:
                closer()
            except OSError:
                pass
        if self._lane is not None:
            self._lane.close(unlink=True)

    def run(self) -> None:
        retries = self.auto_reconnect
        lost_at = None  # perf_counter stamp of the FIRST EOF of an outage
        while not self._stopped.is_set():
            frame = None
            payload = b""
            region = None
            try:
                # pin the stream for this whole iteration: a rebind
                # (mux flush hook, churn soak) swaps self._file while
                # this thread may be blocked right here, and the EOF
                # check below tells the two apart by identity
                f = self._file
                line = f.readline()
                if line:
                    try:
                        frame = json.loads(line)
                    except json.JSONDecodeError:
                        # same contract as the hub: a garbled header on
                        # a stream that may carry binary payloads means
                        # the frame boundary is lost — treat as EOF so
                        # the reconnect path re-dials a frame-aligned
                        # stream instead of parsing payload bytes as
                        # headers
                        logging.warning(
                            "node %d: malformed frame header — "
                            "dropping connection", self.node_id,
                        )
                        line, frame = b"", None
                    binlen = (frame.get(FRAME_BINLEN_KEY)
                              if isinstance(frame, dict) else None)
                    sseq = (frame.pop(SHM_SEQ_KEY, None)
                            if isinstance(frame, dict) else None)
                    if binlen and sseq is not None:
                        # shm doorbell: the payload lives in the slab —
                        # map it zero-copy; any descriptor skew means
                        # the lane's bookkeeping is untrustworthy
                        # (torn writer) and the CONNECTION dies, same
                        # as a garbled stream
                        try:
                            if self._lane is None:
                                raise ShmLaneError("no lane attached")
                            region = self._lane.read(sseq, binlen)
                            payload = region.view
                        except ShmLaneError as e:
                            logging.warning(
                                "node %d: shm lane error (%s) — "
                                "dropping connection", self.node_id, e,
                            )
                            get_telemetry().inc("comm.shm_fallbacks",
                                                reason="torn")
                            line, frame = b"", None
                    elif binlen:
                        payload = f.read(binlen)
                        if len(payload) < binlen:
                            # torn frame: the hub died mid-payload — the
                            # stream can't be trusted, treat as EOF (the
                            # reconnect path re-dials a fresh one)
                            line, frame = b"", None
            except OSError:
                line = b""
            if not line:
                if f is not self._file:
                    # rebind_connection swapped in a live, registered
                    # stream while this thread was blocked on the OLD
                    # socket: this EOF is the displaced conn dying —
                    # keep reading, no retry spent.  Identity (not a
                    # flag): a rebind issued ON this thread (the mux
                    # flush hook) never blocks here, so a flag set for
                    # it would mis-absorb the NEXT genuine EOF.
                    continue
                if self._stopped.is_set() or retries <= 0:
                    return
                retries -= 1
                import time as _time

                if lost_at is None:
                    lost_at = _time.perf_counter()
                    # first EOF of an outage (not the retry loop): the
                    # dialer's black box captures its own view of the
                    # death — hub restarts attribute from BOTH sides
                    flight.note("events", "conn_death",
                                node=self.node_id)
                    flight.trigger(
                        "conn_death",
                        reason=f"node {self.node_id}: hub connection "
                               f"lost ({retries} retries left)",
                    )
                _time.sleep(0.2)
                try:
                    self._dial()  # re-register; hub swaps the live conn
                    # recovery span: total time this node was off the hub
                    # (first EOF -> re-registered), the number a chaos
                    # soak reads to bound reconnect impact
                    t = get_telemetry()
                    t.inc("comm.reconnects")
                    t.observe("span.reconnect_s",
                              _time.perf_counter() - lost_at)
                    lost_at = None
                    logging.warning(
                        "node %d: hub connection lost — reconnected "
                        "(%d retries left)", self.node_id, retries,
                    )
                    continue
                except (OSError, ConnectionError, json.JSONDecodeError):
                    # JSONDecodeError: a hub that died mid-ACK leaves a
                    # partial line — that's a failed dial, not a reason
                    # to kill the reader thread with retries remaining
                    logging.exception(
                        "node %d: reconnect failed", self.node_id
                    )
                    continue  # retry until the budget runs out
            try:
                keep_going = self._dispatch_frame(
                    frame, payload, len(line) + len(payload), region
                )
            finally:
                if region is not None:
                    # the reader's reference: consumers that handed the
                    # payload to another thread pinned their own
                    # (Message.pin_payload) — the ring reclaims the
                    # bytes once the LAST reference drops
                    region.release()
            if not keep_going:
                return

    def _dispatch_frame(self, frame: dict, payload, nbytes: int,
                        region=None) -> bool:
        """Route one complete inbound frame (payload possibly a slab
        memoryview — ``region`` then owns its reclamation).  Returns
        False only for the stop sentinel."""
        if frame.get(HUB_KEY) == "stop":
            return False
        if frame.get(HUB_KEY) == MCAST_STRIPE_KIND:
            if region is not None:
                # stripe chunks are BUFFERED across frames until the
                # stream completes — unbounded retention, so this one
                # consumer materializes (one copy) instead of pinning
                # slab space for a whole logical frame
                payload = bytes(payload)
            try:
                self._on_stripe(frame, payload, nbytes=nbytes)
            except Exception:
                # reassembly bugs must degrade to a dropped logical
                # frame (straggler semantics), never a dead reader
                logging.exception("node %d: stripe reassembly failed",
                                  self.node_id)
            return True
        if frame.get(HUB_KEY) == MUX_KIND:
            try:
                self._on_mux_frame(frame, payload, nbytes=nbytes,
                                   region=region)
            except Exception:
                # a demux bug must degrade to a dropped broadcast
                # copy, never a dead reader
                logging.exception("node %d: mux demux failed",
                                  self.node_id)
            return True
        if frame.get(HUB_KEY) == "conn_map":
            # hub introspection reply (request_conn_map): atomic
            # reference swap — readers (the robust aggregator's
            # connection attribution) always see a complete map
            try:
                self._conn_map = {
                    int(c): [int(n) for n in nodes]
                    for c, nodes in (frame.get("conns") or {}).items()
                }
            except (TypeError, ValueError):
                logging.warning("node %d: malformed conn_map reply",
                                self.node_id)
            return True
        try:
            # exact wire bytes: header line + binary payload
            msg = Message.from_frame(frame, payload)
            msg._region = region
            self._notify(msg, nbytes=nbytes)
        except Exception:
            # a handler error must not kill the reader thread — the
            # node would silently stop receiving and the federation
            # would hang with no attributable cause
            logging.exception("node %d: message handler failed",
                              self.node_id)
        return True

    def _on_stripe(self, frame: dict, chunk: bytes, nbytes: int) -> None:
        """One ``mcast_stripe`` continuation frame off the wire.

        Stripes of one logical frame arrive in order (per-conn FIFO +
        single drainer), so reassembly is append-only per stream id; an
        index gap means an upstream drop (hub backpressure, chaos) and
        kills the whole stream.  crc32 mismatch = corrupted stripe,
        same fate.  Completion hands the concatenated inner frame to
        ``_notify`` exactly like a whole frame — with a backdated
        ``reasm`` hop stamp (first-stripe arrival) so the timeline can
        split fan-out delivery from reassembly wait.
        """
        sid, idx = frame.get("sid"), frame.get("i")
        total = frame.get("n")
        mt = frame.get("msg_type") or "?"
        t_now = time.perf_counter()
        with self._reasm_lock:
            hook = self._stripe_fault_hook
        if hook is not None:
            chunk = hook(mt, sid, idx, chunk)
            if chunk is None:
                return  # injected loss: the gap aborts the stream later
        tel = get_telemetry()
        tel.inc("comm.stripe_frames", msg_type=mt)
        abort_reason = None
        done = None
        with self._reasm_lock:
            if sid in self._dead_sids:
                return  # already-aborted stream: ignore the tail
            ent = self._reasm.get(sid)
            if ent is None:
                if idx != 0:
                    abort_reason = "gap"  # head stripe was lost upstream
                elif len(self._reasm) >= self._MAX_REASM_STREAMS:
                    # evict the OLDEST stream (its final stripe is
                    # presumed lost) to admit the new one
                    oldest = None
                    for s, e in self._reasm.items():
                        if oldest is None or e["t0"] < oldest_t0:
                            oldest, oldest_t0 = s, e["t0"]
                    dead = self._reasm.pop(oldest)
                    self._reasm_bytes -= dead["blen"]
                    self._dead_sids.append(oldest)
                    tel.inc("comm.stripe_aborts", reason="stale",
                            msg_type=dead["mt"])
                ent = None
            if abort_reason is None:
                if ent is None:
                    # ``nodes`` rides stripe 0's outer header on a
                    # muxed connection: the co-located virtual node ids
                    # the reassembled frame fans out to locally
                    ent = {"chunks": [], "next": 0, "total": total,
                           "t0": t_now, "nbytes": 0, "blen": 0, "mt": mt,
                           "nodes": frame.get("nodes"),
                           "range": frame.get("range")}
                    self._reasm[sid] = ent
                if idx != ent["next"] or total != ent["total"]:
                    abort_reason = "gap"
                elif zlib.crc32(chunk) != frame.get("crc"):
                    abort_reason = "crc"
                else:
                    while (self._reasm_bytes + len(chunk)
                            > self._MAX_REASM_BYTES
                            and len(self._reasm) > 1):
                        # the budget is hogged by OLDER partial streams
                        # whose finals are presumed lost (e.g. a hub
                        # reconnect killed their tails mid-broadcast):
                        # evict oldest-first so stale bytes can never
                        # permanently starve every later broadcast —
                        # the live stream wins
                        oldest = None
                        for s, e in self._reasm.items():
                            if s != sid and (oldest is None
                                             or e["t0"] < oldest_t0):
                                oldest, oldest_t0 = s, e["t0"]
                        if oldest is None:
                            break
                        dead = self._reasm.pop(oldest)
                        self._reasm_bytes -= dead["blen"]
                        self._dead_sids.append(oldest)
                        tel.inc("comm.stripe_aborts", reason="stale",
                                msg_type=dead["mt"])
                    if (self._reasm_bytes + len(chunk)
                            > self._MAX_REASM_BYTES):
                        abort_reason = "overflow"
                if abort_reason is None:
                    ent["chunks"].append(chunk)
                    ent["next"] += 1
                    ent["nbytes"] += nbytes
                    ent["blen"] += len(chunk)
                    self._reasm_bytes += len(chunk)
                    if ent["next"] == ent["total"]:
                        del self._reasm[sid]
                        self._reasm_bytes -= ent["blen"]
                        done = ent
            if abort_reason is not None:
                dead = self._reasm.pop(sid, None)
                if dead is not None:
                    self._reasm_bytes -= dead["blen"]
                self._dead_sids.append(sid)
        if abort_reason is not None:
            tel.inc("comm.stripe_aborts", reason=abort_reason, msg_type=mt)
            logging.warning(
                "node %d: striped frame sid=%s (%s) aborted at stripe "
                "%s: %s — logical frame dropped", self.node_id, sid, mt,
                idx, abort_reason,
            )
            return
        if done is None:
            return
        try:
            msg = Message.from_frame_bytes(b"".join(done["chunks"]))
        except Exception:
            tel.inc("comm.stripe_aborts", reason="undecodable", msg_type=mt)
            logging.warning(
                "node %d: reassembled frame sid=%s (%s) undecodable — "
                "dropped", self.node_id, sid, mt,
            )
            return
        tel.inc("comm.stripe_reassemblies", msg_type=mt)
        self._deliver_reassembled(msg, done)

    def _deliver_reassembled(self, msg: Message, ent: dict) -> None:
        """Hand a reassembled logical frame to the observers.  The
        muxed backend overrides to fan out per co-located virtual node
        (``ent['nodes']``); here the backdated ``reasm`` hop marks
        first-stripe arrival — recv - reasm is the reassembly/streaming
        wait on this node."""
        trace_ctx.stamp_msg(msg, self.node_id, "reasm", t=ent["t0"])
        self._notify(msg, nbytes=ent["nbytes"])

    def _on_mux_frame(self, frame: dict, payload, nbytes: int,
                      region=None) -> None:
        """A ``__hub__: mux`` wrapped broadcast copy.  Only muxed
        backends (hello v2) are ever addressed with these; a plain
        backend receiving one is a hub bug — drop it loudly (straggler
        semantics: the round deadline covers the lost sync)."""
        logging.warning(
            "node %d: unexpected mux-wrapped frame (%s) on a non-muxed "
            "connection — dropped", self.node_id, frame.get("msg_type"),
        )

    def run_in_thread(self) -> threading.Thread:
        t = threading.Thread(target=self.run, daemon=True)
        t.start()
        return t

    def stop(self) -> None:
        self._stopped.set()
        try:
            self._sock.sendall((json.dumps(_SENTINEL) + "\n").encode())
            self._sock.close()
        except OSError:
            pass
        if self._lane is not None:
            # creator-side detach + unlink; a region still pinned by a
            # late consumer keeps its mapping alive until released (the
            # segment name just disappears, which is the point)
            self._lane.close(unlink=True)
        self._reap_stale_conn()
