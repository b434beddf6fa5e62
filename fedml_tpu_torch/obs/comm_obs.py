"""Comm-layer instrumentation: per-message-type counters and latency
(copy of ``fedml_tpu/obs/comm_obs.py``, pointed at the port's
``comm/message.py``).

Wired into ``CommBackend``/``NodeManager`` (``comm/backend.py``): the
recv side records inside the base class's ``_notify`` (before observers
run) and the send side inside each transport's ``send_message``, so
managers and algorithms need no changes to be measured.

Series (naming convention in ``obs/telemetry.py``):

- ``comm.sent_msgs{msg_type=...}`` / ``comm.recv_msgs{msg_type=...}``
- ``comm.sent_bytes{msg_type=...}`` / ``comm.recv_bytes{msg_type=...}``:
  serialized wire bytes (a stream transport: the exact frame length;
  inproc: ``message_nbytes``, since the bus never serializes)
- ``comm.send_latency_s{msg_type=...}``: time spent in ``send_message``
- ``comm.handle_latency_s{msg_type=...}``: handler time in
  ``NodeManager.receive_message``
"""

from __future__ import annotations

from typing import Optional

from fedml_tpu_torch.comm.message import (
    FRAME_NDBUF_KEY,
    NDARRAY_KEY,
    WIRETREE_KEY,
)
from fedml_tpu_torch.obs import flight
from fedml_tpu_torch.obs.telemetry import Telemetry, get_telemetry

# base64 expansion of binary buffers on the wire — applies ONLY to
# legacy wiretree-v1 values (b64 leaf dicts, or raw arrays serialized
# through the v1 JSON line).  The default wire since the compression
# subsystem is the v2 binary frame codec, whose raw-array accounting is
# EXACT (length-prefixed buffers + the ~48-byte __ndbuf__ header entry);
# ``message_nbytes`` estimates that framing unless asked for version=1.
_B64_FACTOR = 4.0 / 3.0


def record_send(msg_type: str, nbytes: Optional[int], seconds: Optional[float],
                telemetry: Optional[Telemetry] = None) -> None:
    t = telemetry or get_telemetry()
    t.inc("comm.sent_msgs", 1, msg_type=msg_type)
    if nbytes:
        t.inc("comm.sent_bytes", nbytes, msg_type=msg_type)
    if seconds is not None and seconds >= 0:
        t.observe("comm.send_latency_s", seconds, msg_type=msg_type)
    # per-frame metadata for the flight recorder's comm ring — every
    # transport (tcp/shm/mux/inproc) reports through here, so the black
    # box sees each frame once regardless of how it traveled
    flight.note("comm", "send", msg_type=msg_type, nbytes=nbytes or 0)


def record_recv(msg_type: str, nbytes: Optional[int] = None,
                telemetry: Optional[Telemetry] = None) -> None:
    t = telemetry or get_telemetry()
    t.inc("comm.recv_msgs", 1, msg_type=msg_type)
    if nbytes:
        t.inc("comm.recv_bytes", nbytes, msg_type=msg_type)
    flight.note("comm", "recv", msg_type=msg_type, nbytes=nbytes or 0)


def record_handle(msg_type: str, seconds: float,
                  telemetry: Optional[Telemetry] = None) -> None:
    t = telemetry or get_telemetry()
    if seconds >= 0:
        t.observe("comm.handle_latency_s", seconds, msg_type=msg_type)


def record_compression(msg_type: str, raw_nbytes: float,
                       compressed_nbytes: float,
                       telemetry: Optional[Telemetry] = None) -> None:
    """A model payload was codec-encoded before send: ``raw_bytes`` is
    the logical fp32 size, ``compressed_bytes`` the encoded payload
    actually shipped — one counter pair, so a run's compression ratio
    is a single division."""
    t = telemetry or get_telemetry()
    t.inc("comm.raw_bytes", raw_nbytes, msg_type=msg_type)
    t.inc("comm.compressed_bytes", compressed_nbytes, msg_type=msg_type)


def record_unhandled(msg_type: str,
                     telemetry: Optional[Telemetry] = None) -> None:
    """A frame arrived for a message type the node has no handler for —
    a late/stray/duplicate frame, expected under faults.  Counted on the
    same registry chaos runs read (``faults.observed`` naming), so
    injected drops/delays can be reconciled against what nodes saw."""
    t = telemetry or get_telemetry()
    t.inc("comm.unhandled_msgs", 1, msg_type=msg_type)
    t.inc("faults.observed", 1, kind="unhandled_msg", msg_type=msg_type)
    flight.note("faults", "observed", what="unhandled_msg",
                msg_type=msg_type)


def _value_nbytes(v, binary: bool = True) -> float:
    """Approximate serialized size of one params value (see message.py
    codecs) WITHOUT encoding it — inproc skips serialization entirely,
    so its byte accounting must not pay a full ``to_json`` per message.

    ``binary`` (the default — v2 binary framing is the wire default):
    raw arrays ship as exact length-prefixed buffers
    (``Message.to_frame``), so their accounting is EXACT (nbytes + the
    ~48-byte ``__ndbuf__`` header entry).  ``binary=False`` models the
    legacy v1 JSON line, where raw arrays b64-inflate by ``_B64_FACTOR``
    — the only path the factor still applies to (already-b64
    ``__ndarray__`` dicts are length-counted directly either way)."""
    if isinstance(v, dict):
        if NDARRAY_KEY in v:  # already-encoded array: b64 string length
            return len(v[NDARRAY_KEY]) + 48
        if FRAME_NDBUF_KEY in v:  # binary buffer reference: exact
            return float(v[FRAME_NDBUF_KEY][1]) + 48
        if WIRETREE_KEY in v:  # wire pytree: sum its encoded leaves
            # a v2 tree's raw leaves are only exact when the FRAME is
            # binary too; through a v1 JSON line they b64-encode like
            # any array (the interop contract in message.py)
            exact = v.get(WIRETREE_KEY) == 2 and binary
            return sum(_value_nbytes(l, binary=exact)
                       for l in v.get("leaves", ())) + 32
        return sum(len(str(k)) + 4 + _value_nbytes(x, binary)
                   for k, x in v.items()) + 2
    if isinstance(v, (list, tuple)):
        return sum(_value_nbytes(x, binary) for x in v) + 2
    if isinstance(v, str):
        return len(v) + 2
    if isinstance(v, bool) or v is None:
        return 5
    if isinstance(v, (int, float)):
        return 12
    nbytes = getattr(v, "nbytes", None)  # numpy array / torch tensor
    if nbytes is not None:
        if binary:  # v2 frame: raw bytes + the __ndbuf__ header entry
            return float(nbytes) + 48
        return float(nbytes) * _B64_FACTOR + 48
    return len(str(v))


def message_nbytes(msg, version: int = 2) -> int:
    """Estimated wire size of a ``Message`` envelope without
    serializing it.  ``version=2`` (default): the binary frame codec —
    raw arrays counted exactly.  ``version=1``: the legacy JSON line,
    raw arrays inflated by the b64 factor."""
    binary = version >= 2
    return int(sum(len(k) + 4 + _value_nbytes(v, binary)
                   for k, v in msg.params.items()) + 2)
