"""Mergeable telemetry digests — the in-band stats plane's algebra
(copy of ``fedml_tpu/obs/digest.py``; stdlib only).

Every observability surface before this module was post-hoc: per-process
``metrics-*.jsonl`` files merged after the run by ``tools/fed_timeline``.
That model is O(events x clients) on disk and invisible until the run
ends — exactly wrong for the 100k-1M-virtual-client direction.  This
module makes a ``Telemetry`` registry SHIPPABLE while the run is live:

- a **digest** is a plain JSON-able dict capturing counter deltas,
  last-write gauges, and the log2-histogram buckets of one registry over
  one report interval, plus a per-source ``(seq, t)`` liveness stamp;
- ``merge`` is **associative and order-insensitive** (counters and
  histogram buckets add, gauges and source stamps last-write-win by a
  total order), so muxer-side pre-merge, the hub/server rollup, and a
  future edge-hub tier all compose EXACTLY — the same argument as the
  streaming aggregation's num/den fold;
- ``serialize`` is canonical (sorted keys, minimal separators): equal
  digests are byte-identical, which is what lets tests pin
  muxer-pre-merged == flat per-client merge, as muxed and per-process
  uploads are pinned equal.

Cost model: one digest frame per report interval per CONNECTION — a
muxer's 2500 virtual clients share one process registry and therefore
one digest stream, so 10k virtual clients cost the hub 4 digest streams,
not 10k.

Stdlib-only at import time by design (mirrors ``obs/telemetry.py``): the
rollup runs inside the server process, but ``tools/fed_slo.py`` and the
hub must be able to read digests without jax; ``comm`` imports are lazy
(inside the send path only).
"""

from __future__ import annotations

import json
import logging
import math
import threading
import time
from typing import Dict, List, Optional

from fedml_tpu_torch.obs.telemetry import Telemetry, get_telemetry

# Reserved frame key carrying the digest payload on a C2S_TELEMETRY
# frame (fedlint wire-schema rule: this is the single canonical
# definition; every other module must reference the constant).
DIGEST_KEY = "__digest__"

DIGEST_VERSION = 1

# a reporter stream with no frame for this many seconds is STALE by
# default (the SLO engine's telemetry-coverage objective); the server
# resolves the effective threshold as max(this, 5 x report interval) —
# a long interval must not flag live streams stale between frames
DEFAULT_STALE_AFTER_S = 10.0


# --- digest algebra ----------------------------------------------------------


def empty_digest() -> dict:
    """The merge identity: ``merge(d, empty_digest()) == d``."""
    return {
        "v": DIGEST_VERSION,
        "counters": {},
        "gauges": {},   # key -> [t, value]  (last-write-wins by (t, value))
        "hists": {},    # key -> {count, sum, min, max, buckets{le: n}}
        "nodes": [],    # node ids this digest's sources cover
        "sources": {},  # str(origin node) -> {"seq": int, "t": wall}
    }


def _merge_hist(a: Optional[dict], b: dict) -> dict:
    if a is None:
        return {
            "count": b.get("count", 0),
            "sum": b.get("sum", 0.0),
            "min": b.get("min"),
            "max": b.get("max"),
            "buckets": dict(b.get("buckets") or {}),
        }
    buckets = dict(a.get("buckets") or {})
    for le, n in (b.get("buckets") or {}).items():
        buckets[le] = buckets.get(le, 0) + n
    mins = [m for m in (a.get("min"), b.get("min")) if m is not None]
    maxs = [m for m in (a.get("max"), b.get("max")) if m is not None]
    return {
        "count": a.get("count", 0) + b.get("count", 0),
        "sum": a.get("sum", 0.0) + b.get("sum", 0.0),
        "min": min(mins) if mins else None,
        "max": max(maxs) if maxs else None,
        "buckets": buckets,
    }


def merge(a: dict, b: dict) -> dict:
    """Combine two digests into a new one (inputs untouched).

    Associative and commutative by construction: counters and histogram
    buckets ADD (integer-exact for counts; float sums associate to ulp),
    gauges and source stamps keep the entry with the larger ``(t,
    value)`` / ``(seq, t)`` tuple — a TOTAL order, so ties at equal
    stamps still resolve identically whatever the merge order.  This is
    what lets muxer pre-merge, hub rollup, and an edge-hub tier compose
    without caring who folded first.

    ONE implementation of the algebra: this is ``merge_into`` twice
    into a fresh identity plus the canonical-``nodes`` normalization —
    the pure form and the rollup's in-place hot path cannot drift.
    """
    out = merge_into(merge_into(empty_digest(), a), b)
    out["nodes"] = sorted(out["nodes"])
    return out


def merge_all(digests) -> dict:
    out = empty_digest()
    for d in digests:
        out = merge(out, d)
    return out


def merge_into(acc: dict, b: dict) -> dict:
    """In-place fold of ``b`` into ``acc`` — the rollup's hot path.

    Same algebra as ``merge`` but O(frame) instead of O(accumulated
    series): at one digest per connection per second, rebuilding the
    whole accumulator per frame would make the reader thread's cost
    grow with run length × fleet size.  ``acc`` is mutated (its
    ``nodes`` may become a set for O(1) union); ``merge``/``snapshot``
    handle either form, so callers that need a frozen copy take one
    via ``merge(acc, empty_digest())``."""
    c = acc["counters"]
    for k, v in (b.get("counters") or {}).items():
        c[k] = c.get(k, 0.0) + v
    g = acc["gauges"]
    for k, tv in (b.get("gauges") or {}).items():
        have = g.get(k)
        if have is None or tuple(tv) > tuple(have):
            g[k] = list(tv)
    hists = acc["hists"]
    for k, h in (b.get("hists") or {}).items():
        hists[k] = _merge_hist(hists.get(k), h)
    if not isinstance(acc.get("nodes"), set):
        acc["nodes"] = set(acc.get("nodes") or ())
    acc["nodes"].update(int(n) for n in (b.get("nodes") or ()))
    srcs = acc["sources"]
    for k, st in (b.get("sources") or {}).items():
        have = srcs.get(k)
        if have is None or ((st.get("seq", 0), st.get("t", 0.0))
                            > (have.get("seq", 0), have.get("t", 0.0))):
            srcs[k] = dict(st)
    return acc


def serialize(digest: dict) -> bytes:
    """Canonical wire form: sorted keys + minimal separators, so equal
    digests are byte-identical (the reproducibility pin tests compare
    these bytes, not dict equality)."""
    return json.dumps(digest, sort_keys=True,
                      separators=(",", ":")).encode()


def deserialize(data) -> dict:
    if isinstance(data, (bytes, bytearray, memoryview)):
        data = bytes(data).decode()
    return json.loads(data)


def _finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def validate(digest) -> None:
    """Structural + finiteness check; raises ``ValueError`` on anything
    a merge could be poisoned by.  A NaN counter folded into the rollup
    would silently corrupt every later snapshot — corrupted digest
    frames must die HERE, counted, never wedge the rollup."""
    if not isinstance(digest, dict):
        raise ValueError(f"digest is not a dict: {type(digest).__name__}")
    if digest.get("v") != DIGEST_VERSION:
        raise ValueError(f"unsupported digest version: {digest.get('v')!r}")
    for k, v in (digest.get("counters") or {}).items():
        if not _finite(v):
            raise ValueError(f"non-finite counter {k!r}: {v!r}")
    for k, tv in (digest.get("gauges") or {}).items():
        if (not isinstance(tv, (list, tuple)) or len(tv) != 2
                or not _finite(tv[0]) or not _finite(tv[1])):
            raise ValueError(f"malformed gauge {k!r}: {tv!r}")
    for k, h in (digest.get("hists") or {}).items():
        if not isinstance(h, dict) or not _finite(h.get("count", 0)) \
                or not _finite(h.get("sum", 0.0)):
            raise ValueError(f"malformed histogram {k!r}")
        for le, n in (h.get("buckets") or {}).items():
            # bucket bounds are repr'd floats — and must be FINITE,
            # non-negative: a 'nan' bound merges fine and then poisons
            # every quantile downstream ('nan > threshold' is False, so
            # the gate silently stops gating)
            if not math.isfinite(float(le)) or float(le) < 0:
                raise ValueError(f"bad bucket bound {k!r}[{le!r}]")
            if not _finite(n) or n < 0:
                raise ValueError(f"bad bucket count {k!r}[{le!r}]: {n!r}")
    for k, st in (digest.get("sources") or {}).items():
        if not isinstance(st, dict) or not _finite(st.get("seq", 0)) \
                or not _finite(st.get("t", 0.0)):
            raise ValueError(f"malformed source stamp {k!r}: {st!r}")


def _hist_snapshot_digestable(h: dict) -> dict:
    """Registry ``Histogram.snapshot()`` -> digest hist form (drop the
    derived mean; keep the cumulative min/max — deltas can't know the
    interval's own extrema, and carrying the cumulative ones still
    merges to the correct global extrema)."""
    return {
        "count": h["count"],
        "sum": h["sum"],
        "min": h["min"],
        "max": h["max"],
        "buckets": dict(h["buckets"]),
    }


def registry_digest(telemetry: Optional[Telemetry] = None, *,
                    node: Optional[int] = None, nodes=None,
                    seq: int = 0, t: Optional[float] = None) -> dict:
    """Full snapshot of a registry as a digest (no delta) — what a
    fresh reporter's first frame carries, and the test fixture for the
    algebra pins."""
    snap = (telemetry or get_telemetry()).snapshot()
    if t is None:
        t = time.time()
    d = empty_digest()
    d["counters"] = {k: v for k, v in snap["counters"].items() if v}
    d["gauges"] = {k: [t, v] for k, v in snap["gauges"].items()}
    d["hists"] = {k: _hist_snapshot_digestable(h)
                  for k, h in snap["hists"].items() if h["count"]}
    if node is not None:
        d["sources"] = {str(int(node)): {"seq": int(seq), "t": t}}
    d["nodes"] = sorted(int(n) for n in (nodes or ()))
    if node is not None and int(node) not in d["nodes"]:
        d["nodes"] = sorted(d["nodes"] + [int(node)])
    return d


class DigestSource:
    """Delta emitter over one registry: each ``next()`` returns a digest
    of everything observed since the previous call (counter deltas,
    histogram bucket deltas, changed gauges) stamped with this source's
    monotonically-increasing ``seq`` — so merging every emitted delta
    reconstructs the full registry state, and the rollup can detect
    duplicated / lost frames per source.
    """

    _GUARDED_BY = {
        "_prev_counters": "_lock",
        "_prev_hists": "_lock",
        "_prev_gauges": "_lock",
        "_seq": "_lock",
    }

    def __init__(self, node: int, *, nodes=None,
                 telemetry: Optional[Telemetry] = None):
        self.node = int(node)
        self.nodes = sorted(int(n) for n in (nodes or (node,)))
        self.telemetry = telemetry or get_telemetry()
        # plain threading.Lock on purpose: this module is import-leaf
        # for tools (same stance as obs/telemetry.py); the fedlint
        # lock-discipline rule still checks the _GUARDED_BY contract
        self._lock = threading.Lock()
        self._prev_counters: Dict[str, float] = {}
        self._prev_hists: Dict[str, dict] = {}
        self._prev_gauges: Dict[str, float] = {}
        self._seq = 0

    def next(self, t: Optional[float] = None) -> dict:
        """The delta digest since the last call (always emitted, even
        when empty — the frame IS the liveness heartbeat)."""
        if t is None:
            t = time.time()
        d = empty_digest()
        d["nodes"] = list(self.nodes)
        with self._lock:
            # snapshot INSIDE the lock: two concurrent next() calls
            # must not diff an older snapshot against a newer prev
            # state (negative / duplicated deltas); the telemetry lock
            # nests leaf-level under this one
            snap = self.telemetry.snapshot()
            self._seq += 1
            d["sources"] = {str(self.node): {"seq": self._seq, "t": t}}
            for k, v in snap["counters"].items():
                dv = v - self._prev_counters.get(k, 0.0)
                if dv:
                    d["counters"][k] = dv
            self._prev_counters = dict(snap["counters"])
            for k, v in snap["gauges"].items():
                if self._prev_gauges.get(k) != v:
                    d["gauges"][k] = [t, v]
            self._prev_gauges = dict(snap["gauges"])
            for k, h in snap["hists"].items():
                prev = self._prev_hists.get(k)
                if prev is not None and prev["count"] == h["count"]:
                    continue
                buckets = dict(h["buckets"])
                if prev is not None:
                    for le, n in prev["buckets"].items():
                        left = buckets.get(le, 0) - n
                        if left:
                            buckets[le] = left
                        else:
                            buckets.pop(le, None)
                d["hists"][k] = {
                    "count": h["count"] - (prev["count"] if prev else 0),
                    "sum": h["sum"] - (prev["sum"] if prev else 0.0),
                    # cumulative extrema (see _hist_snapshot_digestable)
                    "min": h["min"],
                    "max": h["max"],
                    "buckets": buckets,
                }
            self._prev_hists = {k: _hist_snapshot_digestable(h)
                                for k, h in snap["hists"].items()}
        return d


class DigestRollup:
    """Server-side accumulator: ingests digest frames, tracks
    per-source liveness, and never lets a bad frame past validation.

    Ingest contract (the chaos ``telemetry_loss`` scenario's promise):
    a dropped frame just ages its source toward staleness; a corrupted
    or garbled frame is rejected + counted; a duplicated/stale frame
    (per-source ``seq`` not advancing) is skipped + counted.  Nothing a
    peer sends can raise out of ``ingest`` or corrupt the accumulator.
    """

    _GUARDED_BY = {
        "_acc": "_lock",
        "_seen": "_lock",
        "frames": "_lock",
        "rejected": "_lock",
        "duplicates": "_lock",
    }

    def __init__(self, telemetry: Optional[Telemetry] = None):
        self.telemetry = telemetry or get_telemetry()
        self._lock = threading.Lock()  # see DigestSource note
        self._acc = empty_digest()
        # str(source) -> {"seq", "t", "nodes", "frames", "lost"}
        self._seen: Dict[str, dict] = {}
        self.frames = 0
        self.rejected = 0
        self.duplicates = 0

    def ingest(self, digest, t: Optional[float] = None) -> bool:
        """Merge one digest frame; returns False when it was rejected
        or skipped (counted either way, never raised)."""
        if t is None:
            t = time.time()
        try:
            if isinstance(digest, (bytes, bytearray, memoryview, str)):
                digest = deserialize(digest)
            validate(digest)
        except (ValueError, TypeError, KeyError, json.JSONDecodeError) as e:
            with self._lock:
                self.rejected += 1
            self.telemetry.inc("digest.rejected", reason="malformed")
            logging.warning("digest rollup: rejected frame (%s)", e)
            return False
        sources = digest.get("sources") or {}
        with self._lock:
            for src, st in sources.items():
                have = self._seen.get(src)
                if have is not None and st.get("seq", 0) <= have["seq"]:
                    # per-source seq did not advance: a chaos duplicate
                    # or an out-of-order redelivery — merging it would
                    # double-add its counters
                    self.duplicates += 1
                    dup = True
                    break
            else:
                dup = False
            if not dup:
                for src, st in sources.items():
                    have = self._seen.get(src)
                    lost = 0
                    if have is not None:
                        lost = have["lost"] + max(
                            0, int(st.get("seq", 0)) - have["seq"] - 1)
                    elif st.get("seq", 0) > 1:
                        lost = int(st.get("seq", 0)) - 1
                    self._seen[src] = {
                        "seq": int(st.get("seq", 0)),
                        "t": float(st.get("t", t)),
                        "t_ingest": t,
                        "nodes": list(digest.get("nodes") or ()),
                        "frames": (have["frames"] + 1) if have else 1,
                        "lost": lost,
                    }
                merge_into(self._acc, digest)
                self.frames += 1
                nstreams = len(self._seen)
        if dup:
            self.telemetry.inc("digest.dup_frames")
            return False
        self.telemetry.inc("digest.frames")
        self.telemetry.gauge_set("digest.streams", nstreams)
        return True

    def snapshot(self) -> dict:
        """The merged digest (a fresh copy — callers may mutate)."""
        with self._lock:
            return merge(self._acc, empty_digest())

    def sources(self, now: Optional[float] = None,
                stale_after: float = DEFAULT_STALE_AFTER_S) -> dict:
        """Per-stream liveness: ``{source: {seq, age_s, stale, nodes,
        frames, lost}}`` — what the SLO report's telemetry-coverage
        objective and the live status view read."""
        if now is None:
            now = time.time()
        out: Dict[str, dict] = {}
        with self._lock:
            seen = {k: dict(v) for k, v in self._seen.items()}
        for src, st in seen.items():
            age = max(0.0, now - st["t_ingest"])
            out[src] = {
                "seq": st["seq"],
                "age_s": round(age, 3),
                "stale": age > stale_after,
                "nodes": len(st["nodes"]),
                "frames": st["frames"],
                "lost_frames": st["lost"],
            }
        return out

    def covered_nodes(self) -> List[int]:
        with self._lock:
            return sorted(int(n) for n in (self._acc.get("nodes") or ()))

    def stats(self) -> dict:
        with self._lock:
            return {
                "frames": self.frames,
                "rejected": self.rejected,
                "duplicates": self.duplicates,
                "streams": len(self._seen),
            }


def send_digest(backend, digest: dict, server: int = 0) -> None:
    """Ship one digest frame to the server over the existing comm plane
    (a plain ``C2S_TELEMETRY`` message — it rides ChaosBackend, the hub,
    and muxed connections like every other frame)."""
    from fedml_tpu_torch.comm.message import MSG_TYPE_C2S_TELEMETRY, Message

    m = Message(MSG_TYPE_C2S_TELEMETRY, backend.node_id, server)
    m.add_params(DIGEST_KEY, digest)
    backend.send_message(m)


class DigestReporter:
    """Client/muxer-side reporter thread: every ``interval`` seconds,
    emit this process registry's delta digest to the server.  A muxer's
    single reporter IS the pre-merge: all its virtual clients share the
    process registry, so one frame per interval covers the whole
    co-located cohort (``nodes``) — the hub ingests one stream per
    connection, not per client.

    Best-effort by contract: a send that fails (hub mid-restart, socket
    mid-reconnect) is logged and the delta is RE-FOLDED into the next
    frame (the source keeps cumulative state, so nothing is lost — the
    next successful frame carries the catch-up delta).
    """

    def __init__(self, backend, *, server: int = 0, interval: float = 1.0,
                 nodes=None, telemetry: Optional[Telemetry] = None):
        self.backend = backend
        self.server = int(server)
        self.interval = max(0.05, float(interval))
        self.telemetry = telemetry or get_telemetry()
        self.source = DigestSource(backend.node_id, nodes=nodes,
                                   telemetry=self.telemetry)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # delta consumed from the source but not yet delivered (a send
        # that failed): merged into the next frame so no interval's
        # counters ever vanish from the rollup — the seq gap the rollup
        # reports for the failed frame is honest (THAT frame never
        # arrived; its data rides the catch-up one)
        self._backlog: Optional[dict] = None

    def _tick(self) -> None:
        digest = self.source.next()
        if self._backlog is not None:
            digest = merge(self._backlog, digest)
        try:
            send_digest(self.backend, digest, self.server)
            self._backlog = None
            self.telemetry.inc("digest.sent")
        except Exception:
            # telemetry is best-effort: a lost digest frame must never
            # take the round path down with it.  The consumed delta is
            # kept as backlog — the next successful frame carries the
            # catch-up; only the liveness heartbeat is late.
            self._backlog = digest
            logging.debug("digest reporter: send failed (will retry "
                          "with the next interval)", exc_info=True)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self._tick()

    def start(self) -> "DigestReporter":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name=f"digest-reporter-{self.backend.node_id}",
            )
            self._thread.start()
        return self

    def stop(self, final_flush: bool = True) -> None:
        """Idempotent; with ``final_flush`` a last delta frame is sent
        so the rollup sees everything up to FINISH.  The flush only
        runs once the reporter thread has actually exited — a thread
        wedged inside a blocking send past the join budget must not
        race a second ``_tick`` over the unsynchronized backlog."""
        if self._stop.is_set():
            return
        self._stop.set()
        joined = True
        if self._thread is not None:
            self._thread.join(timeout=5)
            joined = not self._thread.is_alive()
        if final_flush and joined:
            self._tick()
