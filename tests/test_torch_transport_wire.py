"""The transport's byte layer in the port against the JAX package's: the
reactor's streaming ``FrameParser`` and ``BufPool`` (``comm/reactor.py``)
on the torn, pipelined and hostile byte streams of
``tests/test_reactor.py``, and the shared-memory lanes (``comm/shm.py``):
ring mechanics, fallbacks, the torn-descriptor fault, and a port lane and
a JAX lane sharing one slab both ways.  No sockets, no processes."""

import json

import numpy as np
import pytest
import torch

from fedml_tpu.comm import reactor as jreactor
from fedml_tpu.comm import shm as jshm
from fedml_tpu.comm.message import Message as JMessage
from fedml_tpu_torch.comm import reactor as preactor
from fedml_tpu_torch.comm import shm as pshm
from fedml_tpu_torch.comm import tcp as ptcp
from fedml_tpu_torch.comm.message import FRAME_BINLEN_KEY, SHM_SEQ_KEY, Message


def _frame(hdr, payload=b""):
    h = dict(hdr)
    if payload:
        h[FRAME_BINLEN_KEY] = len(payload)
    return (json.dumps(h) + "\n").encode() + payload


def _drive(parser, stream, chunks):
    """``tests/test_reactor.py``'s driver: feed ``stream`` through the
    parser's recv_target/consumed contract in chunks of the given sizes."""
    frames, pos, i = [], 0, 0
    while pos < len(stream):
        target = parser.recv_target()
        take = min(chunks[i % len(chunks)], len(target), len(stream) - pos)
        i += 1
        target[:take] = stream[pos:pos + take]
        pos += take
        frames.extend(parser.consumed(take))
    return frames


def _binlen_line(binlen):
    return (json.dumps({"receiver": 1, FRAME_BINLEN_KEY: binlen}) + "\n").encode()


_PAYLOAD = bytes(range(256)) * 64
_CUT = _frame({"receiver": 3}, b"P" * 1000)
# (stream, chunk sizes, parser kwargs) per case of tests/test_reactor.py:69-228
PARSER_CASES = {
    "whole_frames": (_frame({"a": 1}) + _frame({"b": 2}, b"xyz"), [1 << 20], {}),
    "torn_header": (_frame({"msg_type": "T", "receiver": 7}), [1], {}),
    "torn_payload": (_frame({"receiver": 1}, _PAYLOAD), [7, 64, 4096], {}),
    "pipelined": (b"".join(_frame({"receiver": i}, bytes([i]) * (100 + i))
                           for i in range(5)), [1 << 20], {}),
    "payload_prefix": (_CUT, [_CUT.find(b"\n") + 1 + 500, 1 << 20], {}),
    "doorbell": (_frame({SHM_SEQ_KEY: 4, FRAME_BINLEN_KEY: 999})
                 + _frame({"receiver": 1}), [1 << 20], {}),
    "oversize_header": (b"x" * 4096, [512], {"max_header_bytes": 1024}),
    "garbled_header": (b"not json at all\n", [16], {}),
    "json_not_object": (b"[1, 2, 3]\n", [10], {}),
    "binary_garbage": (b"\x80\x81\x82\n", [4], {}),
    "garbage_after_payload": (_frame({"receiver": 1}, b"z" * 64) + b"\xff\xfe\n",
                              [1 << 20], {}),
    "bad_binlen_text": (_binlen_line("not-a-number"), [1 << 20], {}),
    "bad_binlen_negative": (_binlen_line(-5), [1 << 20], {}),
    "bad_binlen_list": (_binlen_line([1]), [1 << 20], {}),
    "bad_binlen_huge": (_binlen_line(1 << 62), [1 << 20], {}),
    "binlen_zero_string": (_binlen_line("0"), [1 << 20], {}),
    "fatal_after_frame": (_frame({"receiver": 1}, b"z" * 64) + b"garbage\n",
                          [1 << 20], {}),
    "partial_payload": (_frame({"receiver": 1}, b"q" * 5000)[:200], [200], {}),
}


def _parse(mod, stream, chunks, kw):
    """What one package's parser makes of a stream: the frames (header,
    line, payload bytes, pooled or not) or the FrameError, and the pool's
    live count after the frames are released and the parser closed."""
    pool = mod.BufPool()
    parser = mod.FrameParser(pool=pool, **kw)
    try:
        frames = _drive(parser, stream, chunks)
    except mod.FrameError:
        return ("FrameError", pool.live)
    out = []
    for hdr, line, payload, region in frames:
        out.append((hdr, bytes(line), bytes(payload), region is not None))
        if region is not None:
            region.release()
    live_open = pool.live
    parser.close()
    return (out, live_open, pool.live)


@pytest.mark.parametrize("case", sorted(PARSER_CASES))
def test_frame_parser_matches_jax(case):
    stream, chunks, kw = PARSER_CASES[case]
    want = _parse(jreactor, stream, chunks, kw)
    got = _parse(preactor, stream, chunks, kw)
    assert got == want
    assert got[-1] == 0  # no pooled buffer outlives the parser


def test_bufpool_reuse_matches_jax():
    seen = []
    for mod in (jreactor, preactor):
        pool = mod.BufPool()
        r1 = pool.acquire(5000)
        buf = id(r1._buf)
        r1.retain()
        r1.release()
        live_held = pool.live
        r1.release()
        r2 = pool.acquire(6000)  # same size class: a freelist hit
        seen.append((live_held, pool.live, id(r2._buf) == buf, pool.reuses))
        r2.release()
    assert seen[0] == seen[1] == (1, 1, True, 1)


# -- shared-memory lanes --------------------------------------------------------

@pytest.fixture(autouse=True)
def _one_process_names(monkeypatch):
    """Both packages' lanes live in this one process: they share the set
    of slab names the process created, so an attach from the other
    package leaves the creator's resource-tracker entry alone, as an
    attach in a second process does."""
    shared = set()
    monkeypatch.setattr(jshm, "_LOCAL_NAMES", shared)
    monkeypatch.setattr(pshm, "_LOCAL_NAMES", shared)


def _send(lane, payload: bytes):
    pending = lane.try_send([payload], len(payload))
    assert pending is not None, lane.last_refusal
    return lane.commit(pending)


def _blobs(seed: int, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=n, dtype=np.uint8).tobytes() for n in sizes]


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("port", "jax"),
                                           ("jax", "port")])
def test_lane_roundtrip_wraparound_across_packages(writer, reader):
    """A stream several times the ring's size crosses the slab byte-exact,
    whichever package created the lane and whichever attached to it: the
    slab header, ring cursors and descriptors are laid out alike."""
    mods = {"port": pshm, "jax": jshm}
    tx = mods[writer].ShmLane.create(data_bytes=1 << 14, nslots=4)
    rx = mods[reader].ShmLane.attach(tx.describe())
    try:
        assert bytes(tx._seg.buf[:64]) == bytes(rx._seg.buf[:64])
        for blob in _blobs(3, [5000 + 37 * i for i in range(40)]):
            region = rx.read(_send(tx, blob), len(blob))
            assert bytes(region.view) == blob
            region.release()
    finally:
        rx.close()
        tx.close()


def test_lane_describe_and_header_equal_jax():
    """Both packages lay out a fresh slab's header and describe it alike."""
    lanes = [mod.ShmLane.create(data_bytes=1 << 15, nslots=8) for mod in (pshm, jshm)]
    try:
        d = [dict(l.describe()) for l in lanes]
        for x in d:
            x.pop("name")
        assert d[0] == d[1]
        assert bytes(lanes[0]._seg.buf[:256]) == bytes(lanes[1]._seg.buf[:256])
    finally:
        for l in lanes:
            l.close()


def test_lane_fallback_reasons_match_jax():
    """Descriptor ring full, oversize and byte ring full refuse with the
    same reasons in the same order, and the lane recovers on release."""
    log = []
    for mod in (jshm, pshm):
        tx = mod.ShmLane.create(data_bytes=1 << 14, nslots=2)
        rx = mod.ShmLane.attach(tx.describe())
        seen = []
        try:
            regions = [rx.read(_send(tx, b"x" * 1000), 1000) for _ in range(2)]
            seen.append((tx.try_send([b"y" * 1000], 1000), tx.last_refusal))
            big = b"z" * (1 << 15)
            seen.append((tx.try_send([big], len(big)), tx.last_refusal))
            for r in regions:
                r.release()
            r = rx.read(_send(tx, b"a" * 10000), 10000)
            seen.append((tx.try_send([b"b" * 10000], 10000), tx.last_refusal))
            r.release()
            seen.append(tx.try_send([b"b" * 10000], 10000) is not None)
        finally:
            rx.close()
            tx.close()
        log.append(seen)
    assert log[0] == log[1] == [(None, "desc_full"), (None, "too_big"),
                                (None, "ring_full"), True]


def test_lane_torn_descriptor_fatal_both_ways():
    """A descriptor a port writer published and the slab then tore (a
    writer killed mid-publish) is refused by either package's reader, as
    is a doorbell/sequence skew: no partial frame is delivered."""
    for reader in (pshm, jshm):
        tx = pshm.ShmLane.create(data_bytes=1 << 16, nslots=4)
        rx = reader.ShmLane.attach(tx.describe())
        try:
            seq = _send(tx, b"q" * 2000)
            tx._seg.buf[tx._wring._desc + (seq % tx.nslots) * 40 + 8] ^= 0xFF
            with pytest.raises(reader.ShmLaneError):
                rx.read(seq, 2000)
            with pytest.raises(reader.ShmLaneError):
                rx.read(seq + 5, 100)
        finally:
            rx.close()
            tx.close()


def test_frame_through_shared_lane_decodes_in_both_packages():
    """A port frame's payload written into a port lane, read by a JAX
    lane, decodes to the JAX message (and the reverse), the slab view
    going straight into ``from_frame``."""
    rng = np.random.default_rng(11)
    w = rng.standard_normal((33, 7)).astype(np.float32)
    for (wmsg, wshm), (rmsg, rshm) in (((Message, pshm), (JMessage, jshm)),
                                       ((JMessage, jshm), (Message, pshm))):
        m = wmsg("C2S_SEND_MODEL", 2, 0)
        m.add_params("model_params", {"__wiretree__": 2, "leaves": [w]})
        head, *body = m.to_frame_parts()
        payload = b"".join(bytes(p) for p in body)
        tx = wshm.ShmLane.create(data_bytes=1 << 16, nslots=4)
        rx = rshm.ShmLane.attach(tx.describe())
        try:
            region = rx.read(_send(tx, payload), len(payload))
            got = rmsg.from_frame(json.loads(head), region.view)
            leaf = got.get("model_params")["leaves"][0]
            np.testing.assert_array_equal(np.asarray(leaf), w)
            region.release()
        finally:
            rx.close()
            tx.close()


def test_tcp_backend_refuses_device_leaves():
    """A tensor that does not live on the CPU never reaches the socket
    path: the backend names where it sits (a ``meta`` tensor stands in for
    a card tensor on a host without one; the card test uses ``cuda``)."""
    m = Message("C2S_SEND_MODEL", 1, 0)
    m.add_params("model_params", {"__wiretree__": 2,
                                  "leaves": [np.zeros(3, np.float32),
                                             torch.zeros(2, device="meta")]})
    with pytest.raises(TypeError, match="model_params/leaves/1"):
        ptcp._refuse_device_leaves(m)
    ok = Message("C2S_SEND_MODEL", 1, 0)
    ok.add_params("model_params", {"__wiretree__": 2,
                                   "leaves": [torch.zeros(2), np.ones(2)]})
    ptcp._refuse_device_leaves(ok)
