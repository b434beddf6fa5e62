"""Shared-memory ring lanes — zero-copy payloads for same-box TCP peers
(copy of ``fedml_tpu/comm/shm.py``; the slab and descriptor layout are
the JAX package's byte for byte, so a port peer and a JAX peer share one
lane).

Over loopback TCP every multi-MB frame crosses the kernel
twice (user→kernel on send, kernel→user on recv) plus the loopback
stack's queueing.  For peers that share a box — the muxer topology's
normal case — those copies buy nothing.  This module moves the PAYLOAD
bytes of a hub connection through a ``multiprocessing.shared_memory``
slab instead, while the TCP stream keeps carrying every frame HEADER:

- the sender copies the payload into a per-direction SPSC byte ring
  inside the slab, publishes a crc-guarded frame descriptor, and sends
  the ordinary JSON header line over TCP with one extra reserved key
  (``__shmseq__``, ``comm/message.py``) naming the descriptor;
- the receiver, on reading that header, maps the payload as a
  **memoryview into the slab** — no intermediate ``bytes`` — and feeds
  it to the existing frame decode (``Message.from_frame``) exactly as
  if it had been read off the socket.

Keeping the header (and therefore frame ORDER, control frames, and the
doorbell that wakes the blocking reader) on TCP is what makes the lane
compose with everything built on the stream: per-connection FIFO is the
socket's, chaos/trace/reconnect machinery sees ordinary frames, and
**fallback is per-frame** — a full ring, an oversized payload, or a
refused attach simply ships that payload inline (counted
``comm.shm_fallbacks{reason=}``), never an error.

Failure containment:

- **peer death** looks exactly like a dropped connection: doorbells
  stop (TCP EOF) and the conn dies through the existing cleanup; the
  slab stays valid while mapped (POSIX shm survives unlink), so no
  read can ever fault on a dead writer's memory;
- **torn writer** (peer killed mid-descriptor, or doorbell/descriptor
  skew): the descriptor's crc/seq/length validation fails and the read
  raises ``ShmLaneError`` — CONNECTION-fatal for the reader (the lane's
  bookkeeping can no longer be trusted), never a partial frame
  delivered;
- **reclamation** is explicit: reads hand out refcounted
  ``ShmRegion``s; the byte ring's read cursor only advances over fully
  released frames, so a consumer that pins a payload past the delivery
  scope (the server's decode pool, a chaos-delayed copy) blocks reuse
  of exactly its own bytes and nothing else.

Memory-ordering note: descriptor and payload writes are plain stores
into a shared mmap; the doorbell crosses a TCP syscall boundary (a full
kernel round trip) before the reader ever looks, which on every
platform this targets (Linux, CPython) is a far stronger ordering
barrier than the release/acquire pair a native SPSC ring would use.
"""

from __future__ import annotations

import logging
import struct
import zlib
from typing import Dict, List, Optional

from fedml_tpu_torch.analysis.locks import make_lock
from fedml_tpu_torch.obs import flight

_MAGIC = b"FEDSHM13"
_VERSION = 1
_HDR_SIZE = 64          # slab header
_RING_HDR_SIZE = 64     # per-direction cursor block
_DESC_FMT = "<QQQQI4x"  # seq, off, ln, end_total, crc, pad
_DESC_SIZE = struct.calcsize(_DESC_FMT)
_DESC_BODY = struct.Struct("<QQQQ")  # the crc-covered prefix

DEFAULT_DATA_BYTES = 64 << 20
DEFAULT_SLOTS = 256
# payloads below this ride inline TCP by default: the descriptor +
# doorbell overhead beats the copy savings only past ~1 KiB (policy,
# not a fallback — not counted)
DEFAULT_MIN_BYTES = 1024


class ShmLaneError(RuntimeError):
    """Lane bookkeeping can no longer be trusted (torn descriptor,
    doorbell/descriptor skew, bad geometry): connection-fatal by
    contract — the caller must treat it like a garbled stream."""


# names created by THIS process: an in-process attach (hub and backend
# in one test process) must not unregister the creator's tracker entry
_LOCAL_NAMES: set = set()


def _attach_untracked(name: str):
    """Attach to an existing segment WITHOUT the resource tracker
    claiming it: on 3.8-3.12 an attaching process registers the
    segment and unlinks it at exit, destroying it under the creator
    (bpo-38119).  The creator keeps sole unlink responsibility."""
    from multiprocessing import shared_memory

    seg = shared_memory.SharedMemory(name=name)
    if name not in _LOCAL_NAMES:
        try:
            from multiprocessing import resource_tracker

            resource_tracker.unregister(seg._name, "shared_memory")
        except Exception:
            pass  # tracker layouts vary; worst case is a benign warning
    return seg


class ShmRegion:
    """One read frame's refcounted window into the slab.  Created with
    one reference (the reader's delivery scope); consumers that hand
    the payload to another thread ``retain()`` first and ``release()``
    when done — the ring reclaims the bytes only at zero."""

    __slots__ = ("_lane", "seq", "view", "_refs")

    def __init__(self, lane: "ShmLane", seq: int, view: memoryview):
        self._lane = lane
        self.seq = seq
        self.view = view
        self._refs = 1

    def retain(self) -> None:
        with self._lane._rlock:
            self._refs += 1

    def release(self) -> None:
        lane = self._lane
        with lane._rlock:
            self._refs -= 1
            if self._refs > 0:
                return
        try:
            self.view.release()
        except BufferError:
            # numpy views still alive: the memoryview object survives
            # via their references; reclamation is still safe because
            # every consumer that could outlive this scope holds a
            # retain() of its own — a released region's arrays are
            # dead by contract
            pass
        lane._release_seq(self.seq)


class _Ring:
    """One direction's SPSC frame ring: a descriptor array + a byte
    ring, each end owning its own cursor pair in the ring header.

    The WRITER keeps its cursors (wseq/wtotal) locally and mirrors them
    into the header for introspection; it reads the reader's released
    cursors to compute free space.  The READER validates descriptors
    against its own expected sequence — the doorbell stream on TCP is
    FIFO, so any skew means a torn/rolled-back writer."""

    def __init__(self, buf: memoryview, base: int, nslots: int,
                 data_bytes: int):
        self._buf = buf
        self._hdr = base
        self._desc = base + _RING_HDR_SIZE
        self._data = self._desc + nslots * _DESC_SIZE
        self.nslots = nslots
        self.data_bytes = data_bytes
        # writer-local state
        self._wseq = 0
        self._wtotal = 0
        # reader-local state
        self._expected = 0
        self._next_release = 0
        self._released: Dict[int, int] = {}  # seq -> end_total

    # -- cursor block: [0:8) rd_seq, [8:16) rd_total (reader-owned);
    #    [16:24) wr_seq, [24:32) wr_total (writer-owned, informational)
    def _read_u64(self, off: int) -> int:
        return struct.unpack_from("<Q", self._buf, self._hdr + off)[0]

    def _write_u64(self, off: int, value: int) -> None:
        struct.pack_into("<Q", self._buf, self._hdr + off, value)

    # -- writer side --------------------------------------------------------
    def try_write(self, parts, nbytes: int):
        """Reserve + copy one frame; returns ``(seq, end_total)`` or a
        refusal-reason string.  NOT committed yet: the caller sends the
        doorbell first and calls ``commit`` only on success, so a
        failed doorbell leaves the ring exactly as before (the next
        frame reuses the sequence number and the descriptor slot)."""
        if nbytes > self.data_bytes:
            return "too_big"
        rd_seq = self._read_u64(0)
        if self._wseq - rd_seq >= self.nslots:
            return "desc_full"
        rd_total = self._read_u64(8)
        head = self._wtotal % self.data_bytes
        skip = (self.data_bytes - head
                if head + nbytes > self.data_bytes else 0)
        if nbytes + skip > self.data_bytes - (self._wtotal - rd_total):
            return "ring_full"
        off = 0 if skip else head
        pos = self._data + off
        for p in parts:
            v = p if isinstance(p, memoryview) else memoryview(p)
            if v.format != "B" or v.ndim != 1:
                v = v.cast("B")
            self._buf[pos:pos + len(v)] = v
            pos += len(v)
        seq = self._wseq
        end_total = self._wtotal + skip + nbytes
        body = _DESC_BODY.pack(seq, off, nbytes, end_total)
        struct.pack_into(
            _DESC_FMT, self._buf,
            self._desc + (seq % self.nslots) * _DESC_SIZE,
            seq, off, nbytes, end_total, zlib.crc32(body),
        )
        return (seq, end_total)

    def commit(self, pending) -> None:
        seq, end_total = pending
        self._wseq = seq + 1
        self._wtotal = end_total
        self._write_u64(16, self._wseq)
        self._write_u64(24, self._wtotal)

    # -- reader side --------------------------------------------------------
    def read(self, seq: int, nbytes: int) -> memoryview:
        if seq != self._expected:
            raise ShmLaneError(
                f"doorbell/descriptor skew: expected seq {self._expected}, "
                f"got {seq}"
            )
        d_seq, off, ln, end_total, crc = struct.unpack_from(
            _DESC_FMT, self._buf,
            self._desc + (seq % self.nslots) * _DESC_SIZE,
        )
        body = _DESC_BODY.pack(d_seq, off, ln, end_total)
        if zlib.crc32(body) != crc or d_seq != seq or ln != nbytes:
            raise ShmLaneError(
                f"torn descriptor at seq {seq}: "
                f"(seq={d_seq}, ln={ln}, crc_ok={zlib.crc32(body) == crc}) "
                f"vs announced {nbytes} bytes"
            )
        self._expected = seq + 1
        start = self._data + off
        return self._buf[start:start + ln], end_total

    def release(self, seq: int, end_total: int) -> None:
        """Caller holds the lane's release lock."""
        self._released[seq] = end_total
        while self._next_release in self._released:
            total = self._released.pop(self._next_release)
            self._next_release += 1
            self._write_u64(0, self._next_release)
            self._write_u64(8, total)


class ShmLane:
    """One connection's slab: two ``_Ring``s (dialer→acceptor at
    direction 0, acceptor→dialer at 1).  The DIALER creates (and later
    unlinks) the segment and advertises it in the hello frame; the
    acceptor attaches by name — cross-host peers simply fail the attach
    and the connection stays pure TCP."""

    # release() runs on whatever thread drops the last reference (the
    # reader thread, a decode-pool worker, a chaos timer): the
    # released-frame map and region refcounts all ride one lock
    _GUARDED_BY = {
        "_released": "_rlock",
        "_outstanding": "_rlock",
    }

    def __init__(self, seg, *, creator: bool, nslots: int,
                 data_bytes: int):
        self._seg = seg
        self._creator = creator
        self.nslots = nslots
        self.data_bytes = data_bytes
        self._rlock = make_lock("ShmLane._rlock")
        self._outstanding: Dict[int, int] = {}  # seq -> end_total
        self.last_refusal = ""
        self._closed = False
        buf = seg.buf
        ring_size = _RING_HDR_SIZE + nslots * _DESC_SIZE + data_bytes
        r0 = _Ring(buf, _HDR_SIZE, nslots, data_bytes)
        r1 = _Ring(buf, _HDR_SIZE + ring_size, nslots, data_bytes)
        # creator (dialer) writes ring 0 / reads ring 1; acceptor inverse
        self._wring = r0 if creator else r1
        self._rring = r1 if creator else r0

    # -- construction -------------------------------------------------------
    @staticmethod
    def _prefault(seg, write: bool) -> None:
        """Touch every page of the slab once, up front.  Without this
        the byte ring advances through FRESH pages for every frame
        until its first wraparound, and the per-page first-touch
        faults can cost more than the copies the lane saves, and the
        lane would run slower than loopback TCP.  The creator write-touches (allocates
        the tmpfs pages); attachers read-touch (populates their own
        PTEs against the already-allocated pages)."""
        import numpy as np

        a = np.frombuffer(seg.buf, dtype=np.uint8)
        if write:
            a[::4096] = 0  # fresh segments are zero-filled already
        else:
            int(a[::4096].sum())  # read faults map the shared pages

    @classmethod
    def create(cls, data_bytes: int = DEFAULT_DATA_BYTES,
               nslots: int = DEFAULT_SLOTS) -> "ShmLane":
        from multiprocessing import shared_memory

        ring_size = _RING_HDR_SIZE + nslots * _DESC_SIZE + data_bytes
        seg = shared_memory.SharedMemory(
            create=True, size=_HDR_SIZE + 2 * ring_size
        )
        _LOCAL_NAMES.add(seg.name)
        cls._prefault(seg, write=True)
        struct.pack_into("<8sII", seg.buf, 0, _MAGIC, _VERSION, nslots)
        struct.pack_into("<Q", seg.buf, 16, data_bytes)
        return cls(seg, creator=True, nslots=nslots, data_bytes=data_bytes)

    @classmethod
    def attach(cls, desc: dict) -> "ShmLane":
        """Acceptor-side attach from the hello capability dict
        (``describe()``'s output).  Raises on any mismatch — the caller
        downgrades the connection to pure TCP."""
        seg = _attach_untracked(str(desc["name"]))
        try:
            magic, version, nslots = struct.unpack_from("<8sII", seg.buf, 0)
            (data_bytes,) = struct.unpack_from("<Q", seg.buf, 16)
            if (magic != _MAGIC or version != _VERSION
                    or nslots != int(desc["slots"])
                    or data_bytes != int(desc["data"])):
                raise ShmLaneError(
                    f"slab geometry mismatch: {magic!r} v{version} "
                    f"{nslots}x{data_bytes} vs hello {desc}"
                )
            ring_size = _RING_HDR_SIZE + nslots * _DESC_SIZE + data_bytes
            if seg.size < _HDR_SIZE + 2 * ring_size:
                raise ShmLaneError(f"slab too small: {seg.size}")
            cls._prefault(seg, write=False)
        except Exception:
            try:
                seg.close()
            except (OSError, BufferError):
                pass
            raise
        return cls(seg, creator=False, nslots=nslots,
                   data_bytes=data_bytes)

    def describe(self) -> dict:
        return {"name": self._seg.name, "data": self.data_bytes,
                "slots": self.nslots}

    # -- write side ---------------------------------------------------------
    def try_send(self, parts, nbytes: int):
        """Copy one payload into the outbound ring.  Returns an opaque
        pending handle (pass to ``commit`` after the doorbell went out)
        or None with ``last_refusal`` set — the caller ships the
        payload inline instead."""
        if self._closed:
            self.last_refusal = "closed"
            return None
        try:
            out = self._wring.try_write(parts, nbytes)
        except ValueError:
            # close() released the base memoryview under us (stop vs
            # in-flight send race): behave like a full ring — the
            # caller ships inline and the connection dies on its own
            self.last_refusal = "closed"
            return None
        if isinstance(out, str):
            self.last_refusal = out
            # flight-recorder comm ring: each lane refusal with its
            # reason and size — the forensics evidence that separates
            # "ring sized too small" from "reader stopped draining"
            flight.note("comm", "shm_refusal", reason=out, nbytes=nbytes)
            return None
        return out

    def commit(self, pending) -> int:
        """Publish a reserved frame (doorbell already on the wire);
        returns its sequence number."""
        try:
            self._wring.commit(pending)
        except ValueError:
            pass  # closed under us: the conn is dying anyway
        return pending[0]

    @staticmethod
    def seq_of(pending) -> int:
        return pending[0]

    # -- read side ----------------------------------------------------------
    def read(self, seq: int, nbytes: int) -> ShmRegion:
        """Map one announced frame.  Raises ``ShmLaneError`` on any
        descriptor/sequence mismatch (connection-fatal)."""
        if self._closed:
            raise ShmLaneError("lane closed")
        try:
            view, end_total = self._rring.read(seq, nbytes)
        except ValueError as e:
            raise ShmLaneError(f"lane closed mid-read: {e}") from e
        with self._rlock:
            self._outstanding[seq] = end_total
        return ShmRegion(self, seq, view)

    def read_copy(self, seq: int, nbytes: int) -> bytes:
        """Materialized read for consumers with unbounded retention
        (stripe reassembly buffers, the hub's pin-pressure valve): one
        copy out of the slab, region released immediately."""
        region = self.read(seq, nbytes)
        try:
            return bytes(region.view)
        finally:
            region.release()

    def live_pins(self) -> int:
        """Inbound regions read but not yet released to zero — the
        leak-test observable: after a churn/rebind soak every queued
        pin must have been released (sent, dropped, or flushed by conn
        cleanup) and this must read 0.  Same protocol + meaning as
        ``reactor.BufPool.live`` for pooled TCP payload buffers."""
        with self._rlock:
            return len(self._outstanding)

    def inbound_backlog(self) -> int:
        """``live_pins()`` under its routing-decision name: ring
        reclamation is in-order, so ONE long-lived pin holds every
        later frame's bytes too — consumers with queue-length retention
        (the hub router) use this to decide pin vs materialize."""
        return self.live_pins()

    def _release_seq(self, seq: int) -> None:
        with self._rlock:
            end_total = self._outstanding.pop(seq, None)
            if end_total is None or self._closed:
                return
            try:
                self._rring.release(seq, end_total)
            except ValueError:
                pass  # closed under us: nothing left to reclaim into

    # -- lifecycle ----------------------------------------------------------
    def close(self, unlink: Optional[bool] = None) -> None:
        """Detach (and, for the creator, unlink) the slab.  Safe to
        call twice; a mapping still pinned by live numpy views is left
        to die with the process (close would raise BufferError)."""
        if self._closed:
            return
        self._closed = True
        try:
            self._seg.close()
        except BufferError:
            # live numpy views still export the mapping: leave it to
            # die with the process, and disarm SharedMemory.__del__ so
            # it doesn't retry (and whine) at interpreter exit — the
            # exported memoryviews keep the mmap object alive
            logging.debug("shm lane: mapping still exported at close — "
                          "left to process exit")
            try:
                self._seg._mmap = None
                self._seg._buf = None
            except Exception:
                pass
        except OSError:
            pass
        if unlink if unlink is not None else self._creator:
            try:
                self._seg.unlink()
            except (OSError, FileNotFoundError):
                pass
        _LOCAL_NAMES.discard(self._seg.name)


def split_frame_line(data) -> int:
    """Offset just past the first newline of a frame held in memory
    (bytes OR a slab memoryview, searched chunk-wise so a multi-MB
    payload is never materialized); -1 if no header line."""
    if not isinstance(data, memoryview):
        nl = data.find(b"\n")
        return -1 if nl < 0 else nl + 1
    chunk = 8192
    off = 0
    n = len(data)
    while off < n:
        j = bytes(data[off:off + chunk]).find(b"\n")
        if j >= 0:
            return off + j + 1
        off += chunk
    return -1
