"""Reactor-plane primitives for the hub data plane (``comm/tcp.py``);
copy of ``fedml_tpu/comm/reactor.py``.

The selector-driven hub replaces the two-blocking-threads-per-connection
read plane with ONE event-loop thread, which needs two things a blocking
``makefile('rb')`` reader never did:

- **A streaming frame parser** (`FrameParser`): the loop reads whatever
  the kernel has — half a header, three pipelined frames, the tail of a
  payload — and the parser turns those arbitrary chunk boundaries back
  into whole v1/v2 frames, incrementally, per connection.

- **Refcounted reusable payload buffers** (`BufPool` / `BufRegion`):
  inbound TCP payload bytes land directly in a pooled buffer that
  implements the same ``retain()/release()/view`` protocol as
  ``shm.ShmRegion``, so the routing layer pins ONE buffer per enqueued
  copy and the bytes are reclaimed (for reuse) when the last send queue
  drains them — the TCP-inbound twin of the shm lane's zero-copy pins,
  closing the last materializing hop on the hub path.

Both are transport-pure and single-connection-scoped: no hub state, no
sockets, no locks beyond the pool's freelist — which is what makes them
unit-testable against torn/pipelined byte streams without a federation.
"""

from __future__ import annotations

import json
import threading
from typing import List, Optional, Tuple

from fedml_tpu_torch.comm.message import FRAME_BINLEN_KEY, SHM_SEQ_KEY

# An unterminated "header" this large is a binary flood or a garbage
# peer, never a frame: real inbound headers top out at the mcast
# receiver list (~7 bytes/id), so 64 MiB covers about 9M explicit ids —
# far past the point where range claims take over — while still killing
# a runaway accumulation long before it exhausts hub memory.
DEFAULT_MAX_HEADER = 64 << 20

# Largest ``__binlen__`` a header may announce.  The bound exists so a
# malformed (but valid-JSON) header can't drive ``pool.acquire`` into a
# multi-gigabyte ``bytearray`` allocation: anything past it is
# connection-fatal like a garbled header, never a MemoryError in the
# event loop.  4 GiB clears every real payload (full fp32 model
# broadcasts included) by a wide margin.
DEFAULT_MAX_PAYLOAD = 4 << 30

# Pool buffers below this round up to one page-friendly class; tiny
# payloads (control frames) then share a handful of hot buffers instead
# of fragmenting the freelist into dozens of size classes.
_MIN_CLASS = 1 << 12


class FrameError(Exception):
    """Connection-fatal parse failure.  Mirrors the blocking reader's
    policy: frames may carry raw binary payloads, so a stream that
    garbles one header can never resynchronize — the connection dies,
    the peer re-dials (its retry/auto_reconnect path)."""


class BufRegion:
    """One inbound TCP payload's refcounted window into a pooled buffer.

    Same contract as ``shm.ShmRegion``: created with one reference (the
    reader's delivery scope); every consumer that outlives that scope
    ``retain()``s first and ``release()``s when done — the buffer
    returns to its pool only at zero.  ``view`` is writable (the
    reactor ``recv_into``s the payload straight into it) but consumers
    treat it as immutable once the frame completes."""

    __slots__ = ("_pool", "_buf", "view", "_refs")

    def __init__(self, pool: "BufPool", buf: bytearray, nbytes: int):
        self._pool = pool
        self._buf = buf
        self.view = memoryview(buf)[:nbytes]
        self._refs = 1

    def retain(self) -> None:
        with self._pool._lock:
            self._refs += 1

    def release(self) -> None:
        pool = self._pool
        with pool._lock:
            self._refs -= 1
            if self._refs > 0:
                return
            pool.live -= 1
        try:
            self.view.release()
        except BufferError:
            # a consumer kept a numpy view alive past its release() —
            # the memoryview object survives via that reference; reuse
            # is still safe because such a consumer broke the retain
            # contract and its arrays are dead by contract
            pass
        pool._recycle(self._buf)


class BufPool:
    """Size-classed freelist of reusable payload buffers, bounded.

    ``acquire(n)`` hands out a ``BufRegion`` over a buffer of the next
    power-of-two class ≥ n (reused when the freelist has one, fresh
    otherwise); a region's final ``release()`` recycles the buffer
    unless the pool already holds ``max_pooled_bytes`` — beyond the
    bound buffers are simply dropped to the allocator, so a burst of
    giant payloads can't pin memory forever.  ``live`` counts regions
    handed out and not yet fully released — the leak-test observable
    (a churn soak must drive it back to 0)."""

    def __init__(self, max_pooled_bytes: int = 64 << 20):
        self._lock = threading.Lock()
        self._free = {}  # size class -> [bytearray, ...]
        self._pooled = 0
        self._max = int(max_pooled_bytes)
        self.live = 0      # regions out, not yet released to zero
        self.acquires = 0  # total acquire() calls
        self.reuses = 0    # acquires served from the freelist

    @staticmethod
    def _size_class(nbytes: int) -> int:
        if nbytes <= _MIN_CLASS:
            return _MIN_CLASS
        return 1 << (nbytes - 1).bit_length()

    def acquire(self, nbytes: int) -> BufRegion:
        size = self._size_class(nbytes)
        buf = None
        with self._lock:
            self.acquires += 1
            self.live += 1
            lst = self._free.get(size)
            if lst:
                buf = lst.pop()
                self._pooled -= size
                self.reuses += 1
        if buf is None:
            buf = bytearray(size)
        return BufRegion(self, buf, nbytes)

    def _recycle(self, buf: bytearray) -> None:
        size = len(buf)
        with self._lock:
            if self._pooled + size <= self._max:
                self._free.setdefault(size, []).append(buf)
                self._pooled += size

    def stats(self) -> dict:
        with self._lock:
            return {"live": self.live, "acquires": self.acquires,
                    "reuses": self.reuses, "pooled_bytes": self._pooled}


class FrameParser:
    """Incremental v1/v2 frame parser for ONE connection's byte stream.

    Two states.  In HEADER the parser accumulates bytes up to the
    newline that ends the JSON header line; in PAYLOAD it owns a pooled
    ``BufRegion`` sized to the header's ``__binlen__`` and fills it.
    The reactor drives it with a recv-into contract instead of feed():

        n = sock.recv_into(parser.recv_target())
        for hdr, line, payload, region in parser.consumed(n): ...

    ``recv_target()`` is the scratch buffer while parsing headers and
    the region's unfilled tail once in PAYLOAD — so payload bytes land
    in their final resting place in one kernel copy, with no
    intermediate buffer.  Only a payload PREFIX that arrives in the
    same chunk as its header crosses the scratch (copied once into the
    region; bounded by one scratch read).  Chunk boundaries are
    arbitrary: a header torn across reads accumulates, a payload torn
    across reads fills incrementally, and several pipelined frames in
    one read all come back from one ``consumed()`` call.

    Frames whose header carries the shm doorbell key (``__shmseq__``)
    announce payload bytes that live in the connection's slab, NOT on
    the stream — they complete immediately with no payload/region; the
    hub maps the slab bytes itself.  A garbled header (bad JSON,
    non-UTF-8 bytes, or JSON that isn't an object), a ``__binlen__``
    that isn't a non-negative int within ``max_payload_bytes``, and an
    unterminated header past ``max_header_bytes`` all raise
    ``FrameError`` — connection-fatal, the blocking reader's exact
    policy.

    Completed frames are ``(hdr, line, payload, region)``: the parsed
    header dict, the raw header line (newline included — forwarding
    paths ship it verbatim), the payload (a region view, or ``b""``
    for header-only frames), and the ``BufRegion`` backing it (or
    ``None``).  The caller owns the region's initial reference."""

    HEADER = 0
    PAYLOAD = 1

    __slots__ = ("_pool", "_scratch", "_sview", "_hdr", "_max_hdr",
                 "_max_payload", "_state", "_fhdr", "_fline", "_region",
                 "_filled", "_need")

    def __init__(self, pool: Optional[BufPool] = None,
                 scratch_bytes: int = 256 << 10,
                 max_header_bytes: int = DEFAULT_MAX_HEADER,
                 max_payload_bytes: int = DEFAULT_MAX_PAYLOAD,
                 scratch: Optional[bytearray] = None):
        self._pool = pool if pool is not None else BufPool()
        # ``scratch`` may be SHARED across every parser of one event
        # loop: scratch bytes never survive a consumed() call (partial
        # headers accumulate into the parser-owned ``_hdr``, payload
        # prefixes copy into the region inside the same ``_feed``), and
        # a single-threaded loop reads one socket at a time — so one
        # hub-wide buffer replaces a per-connection allocation that
        # would otherwise dominate reactor RSS at high fan-in
        # (512 conns x 256 KiB = 128 MB of idle scratch).
        self._scratch = (scratch if scratch is not None
                         else bytearray(scratch_bytes))
        self._sview = memoryview(self._scratch)
        self._hdr = bytearray()        # partial header across chunks
        self._max_hdr = int(max_header_bytes)
        self._max_payload = int(max_payload_bytes)
        self._state = self.HEADER
        self._fhdr: Optional[dict] = None
        self._fline: bytes = b""
        self._region: Optional[BufRegion] = None
        self._filled = 0
        self._need = 0

    def recv_target(self) -> memoryview:
        """The buffer the next ``recv_into`` should fill."""
        if self._state == self.PAYLOAD:
            return self._region.view[self._filled:]
        return self._sview

    def close(self) -> None:
        """Release the in-progress frame's region (the connection died
        mid-payload) so the pool's ``live`` accounting returns to zero
        even for torn streams."""
        if self._region is not None:
            self._region.release()
            self._region = None
        self._state = self.HEADER

    def consumed(self, n: int) -> List[Tuple]:
        """Process ``n`` bytes just written into ``recv_target()``;
        return every frame they completed (possibly none, possibly
        several)."""
        if self._state == self.PAYLOAD:
            self._filled += n
            if self._filled < self._need:
                return []
            return [self._finish()]
        return self._feed(n)

    def _fatal(self, frames: List[Tuple], msg: str):
        """Connection-fatal parse failure: release every completed-but-
        undelivered frame's region (the caller never sees them) plus
        any in-progress one, then raise."""
        for _hdr, _line, _payload, region in frames:
            if region is not None:
                region.release()
        self.close()
        raise FrameError(msg)

    def _feed(self, n: int) -> List[Tuple]:
        frames: List[Tuple] = []
        pos = 0
        while pos < n:
            if self._state == self.PAYLOAD:
                # a header earlier in this chunk opened a payload; its
                # prefix rides the same scratch read — copy it into the
                # region (the only scratch->region copy on the path)
                take = min(n - pos, self._need - self._filled)
                self._region.view[self._filled:self._filled + take] = \
                    self._sview[pos:pos + take]
                self._filled += take
                pos += take
                if self._filled >= self._need:
                    frames.append(self._finish())
                continue
            idx = self._scratch.find(b"\n", pos, n)
            if idx < 0:
                self._hdr += self._sview[pos:n]
                if len(self._hdr) > self._max_hdr:
                    self._fatal(frames,
                                f"unterminated header past "
                                f"{self._max_hdr} bytes — binary flood "
                                f"or garbage peer")
                break
            if self._hdr:
                self._hdr += self._sview[pos:idx + 1]
                line = bytes(self._hdr)
                self._hdr = bytearray()
            else:
                line = bytes(self._sview[pos:idx + 1])
            pos = idx + 1
            if len(line) > self._max_hdr:
                self._fatal(frames,
                            f"header line of {len(line)} bytes "
                            f"exceeds the {self._max_hdr} cap")
            try:
                # ValueError, not JSONDecodeError: non-UTF-8 bytes
                # raise UnicodeDecodeError (a ValueError sibling, NOT a
                # JSONDecodeError) and must hit the same fatal path —
                # otherwise one binary-garbage peer kills the loop
                hdr = json.loads(line)
            except ValueError as e:
                self._fatal(frames, f"garbled header: {e}")
            if not isinstance(hdr, dict):
                self._fatal(frames,
                            f"header is {type(hdr).__name__}, "
                            f"not an object")
            binlen = hdr.get(FRAME_BINLEN_KEY)
            if binlen and SHM_SEQ_KEY not in hdr:
                # binlen comes off the wire: a non-numeric, negative,
                # or absurd value must die as a FrameError here, never
                # escape as ValueError / broken PAYLOAD state /
                # MemoryError inside pool.acquire
                try:
                    need = int(binlen)
                except (TypeError, ValueError):
                    need = -1
                if need < 0 or need > self._max_payload:
                    self._fatal(frames,
                                f"bad {FRAME_BINLEN_KEY} {binlen!r}: "
                                f"need an int in "
                                f"[0, {self._max_payload}]")
                if need:
                    self._need = need
                    self._fhdr = hdr
                    self._fline = line
                    self._region = self._pool.acquire(need)
                    self._filled = 0
                    self._state = self.PAYLOAD
                    continue
                # truthy binlen that still parses to 0 (e.g. "0"):
                # fall through — a zero-byte payload is a header-only
                # frame, same as a falsy/absent binlen
            # header-only frame: v1 line, control frame, or an shm
            # doorbell whose bytes live in the slab
            frames.append((hdr, line, b"", None))
        return frames

    def _finish(self) -> Tuple:
        region = self._region
        out = (self._fhdr, self._fline, region.view, region)
        self._state = self.HEADER
        self._fhdr = None
        self._fline = b""
        self._region = None
        self._filled = 0
        self._need = 0
        return out
