"""Flight recorder: the federation's black box (stdlib copy of
``fedml_tpu/obs/flight.py``).

Keeps the last seconds of everything that matters in bounded
per-category ring buffers inside every process (hub, server, clients,
muxers) and dumps them atomically to ``flight-<node>.json`` in the
run_dir when something goes wrong, so a postmortem works from what the
process itself saw.

Categories (one ring each, ``DEPTHS`` bounds memory):

- ``events``: telemetry events, fed by the registry's event tap;
- ``hops``: ``trace_hop`` per-message chains (same tap, own ring, so a
  traced run cannot evict round boundaries);
- ``spans``: every ``span.*_s`` histogram observation (the observe tap);
- ``comm``: per-frame send/recv metadata (msg_type, bytes) from
  ``obs/comm_obs.py``, which every transport reports through;
- ``faults``: fault-injection decisions and tolerance observations;
- ``locks``: ``CheckedLock`` acquisitions (``analysis/locks.py``),
  populated only when lock checking is on;
- ``notes``: anything else a subsystem wants on the record.

Recording is lock-light: the hot path is one ``deque.append`` of a small
tuple.  Only ``dump()`` takes a lock, and only against other dumpers.
Dump triggers are rate-limited per kind (``TRIGGERS``).  A process with no
configured run_dir still records; triggers then only mark history.

Bundle schema (v1):

    {"schema": 1, "node": ..., "pid": ..., "window_s": ...,
     "trigger": {"kind", "reason", "round", "t_m", "t_wall"},
     "history": [trigger records, oldest first],
     "clock_sync": <the process's dial-time offset event or null>,
     "t_m_dump": ..., "t_wall_dump": ...,
     "telemetry": <full registry snapshot>,
     "rings": {category: [{"t_m", "kind", ...fields}, ...]}}
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from fedml_tpu_torch.obs.telemetry import get_telemetry

SCHEMA = 1

ENV_DISABLE = "FEDML_TPU_FLIGHT"          # "0" switches recording off
ENV_WINDOW = "FEDML_TPU_FLIGHT_WINDOW_S"  # dump window override
ENV_LOCK_WAIT = "FEDML_TPU_FLIGHT_LOCK_WAIT_S"  # lock-ring wait threshold

DEFAULT_WINDOW_S = 60.0
DEFAULT_MIN_INTERVAL_S = 1.0  # per-trigger-kind dump rate limit
# lock acquires below this measured block time never reach the ring or
# the histogram: an uncontended CheckedLock acquire still takes ~1 us,
# and a 1024-deep ring of those evicts the contended rows forensics
# actually ranks.  1 ms keeps scheduler-quantum-scale contention and
# drops lock-free chatter.
DEFAULT_LOCK_WAIT_S = 1e-3

# ring depths: sized so the busiest category (per-frame comm metadata)
# holds several rounds of a large federation while the whole recorder
# stays a few MB of small tuples
DEPTHS = {
    "events": 2048,
    "hops": 2048,
    "spans": 4096,
    "comm": 4096,
    "faults": 2048,
    "locks": 1024,
    "notes": 512,
}

TRIGGERS = (
    "slo_violation", "deadline_overrun", "reject", "conn_death",
    "chaos_fault", "exception", "sigusr2", "crash", "manual",
)


def _snap_ring(ring: deque) -> list:
    """Copy a ring that other threads keep appending to.  ``list(deque)``
    raises RuntimeError if the deque mutates mid-iteration; retrying a
    few times is cheaper (and lock-free) than making every recording
    site take a lock for the rare dump."""
    for _ in range(8):
        try:
            return list(ring)
        except RuntimeError:
            continue
    return []


class FlightRecorder:
    """One per process (``get_recorder()``), always on unless
    ``FEDML_TPU_FLIGHT=0``.  ``record`` is the lock-free hot path;
    ``dump`` is the cold path that writes the bundle."""

    def __init__(self, window_s: Optional[float] = None,
                 depths: Optional[Dict[str, int]] = None):
        env_off = os.environ.get(ENV_DISABLE, "") == "0"
        self.enabled = not env_off
        if window_s is None:
            try:
                window_s = float(os.environ.get(ENV_WINDOW, DEFAULT_WINDOW_S))
            except ValueError:
                window_s = DEFAULT_WINDOW_S
        self.window_s = window_s
        try:
            self.lock_wait_s = float(
                os.environ.get(ENV_LOCK_WAIT, DEFAULT_LOCK_WAIT_S))
        except ValueError:
            self.lock_wait_s = DEFAULT_LOCK_WAIT_S
        d = dict(DEPTHS)
        d.update(depths or {})
        self._rings: Dict[str, deque] = {c: deque(maxlen=n)
                                         for c, n in d.items()}
        self.node: Optional[str] = None
        self.run_dir: Optional[str] = None
        self._clock_sync: Optional[dict] = None
        self._history: deque = deque(maxlen=128)  # trigger records
        self._last_dump: Dict[str, float] = {}    # trigger kind -> t_m
        self._dump_lock = threading.Lock()
        self._prev_excepthook = None
        self._prev_threading_hook = None
        self._faulthandler_fh = None
        self._atexit_installed = False

    # -- hot path -----------------------------------------------------------
    def record(self, category: str, kind: str, **fields) -> None:
        ring = self._rings.get(category)
        if ring is None:
            ring = self._rings.setdefault(category, deque(maxlen=512))
        ring.append((time.perf_counter(), kind, fields))

    # -- telemetry taps -----------------------------------------------------
    def _on_event(self, rec: dict) -> None:
        kind = rec.get("kind", "?")
        if kind == "clock_sync":
            # the one event forensics cannot live without: stamped at
            # dial time, far outside any last-seconds window — pin it
            # in its own slot so ring rotation can never evict it
            self._clock_sync = dict(rec)
            self.record("events", kind, **{k: v for k, v in rec.items()
                                           if k != "kind"})
            return
        ring = "hops" if kind == "trace_hop" else "events"
        self.record(ring, kind, **{k: v for k, v in rec.items()
                                   if k != "kind"})

    def _on_observe(self, name: str, value: float, labels: dict) -> None:
        if name.startswith("span."):
            if labels:
                self.record("spans", name, v=value, **labels)
            else:
                self.record("spans", name, v=value)

    def _on_lock(self, name: str, depth: int,
                 wait_s: float = 0.0) -> None:
        # ``wait_s`` is the CheckedLock tap's measured block time.  The
        # ring is a CONTENTION profile (fed_forensics ranks locks by
        # total/max wait), so only waits past the threshold
        # (``FEDML_TPU_FLIGHT_LOCK_WAIT_S``, default 1 ms) are kept —
        # uncontended acquires would evict the rows that matter.  Each
        # kept wait also lands in the ``lock.wait_s`` histogram so the
        # telemetry digest carries the contention shape even when no
        # dump ever fires.
        if wait_s < self.lock_wait_s:
            return
        self.record("locks", "acquire", lock=name, depth=depth,
                    wait_s=wait_s)
        try:
            get_telemetry().observe("lock.wait_s", wait_s, lock=name)
        except Exception:
            pass

    # -- configuration ------------------------------------------------------
    def configure(self, run_dir: Optional[str], node: str) -> None:
        """Point the recorder at its dump destination.  Tag convention
        follows the per-process metrics files: ``hub``, ``node0`` (the
        server), ``node<id>``, ``mux<id>``."""
        self.run_dir = run_dir
        self.node = str(node)

    def install_excepthooks(self) -> None:
        """Chain ``sys.excepthook`` + ``threading.excepthook`` so any
        unhandled exception dumps a bundle before the usual traceback."""
        if self._prev_excepthook is None:
            self._prev_excepthook = sys.excepthook

            def _hook(exc_type, exc, tb):
                self.dump("exception",
                          reason=f"{exc_type.__name__}: {exc}", force=True)
                self._prev_excepthook(exc_type, exc, tb)

            sys.excepthook = _hook
        if self._prev_threading_hook is None:
            self._prev_threading_hook = threading.excepthook

            def _thook(args):
                self.dump(
                    "exception", force=True,
                    reason=f"{args.exc_type.__name__}: {args.exc_value} "
                           f"(thread {getattr(args.thread, 'name', '?')})",
                )
                self._prev_threading_hook(args)

            threading.excepthook = _thook

    def install_signal_handlers(self) -> None:
        """SIGUSR2 → dump (operator snapshot of a live, healthy-looking
        process).  Main-thread only; silently skipped elsewhere."""
        import signal as _signal

        try:
            _signal.signal(
                _signal.SIGUSR2,
                lambda signum, frame: self.dump("sigusr2", force=True),
            )
        except (ValueError, OSError, AttributeError):
            pass  # not the main thread, or platform without SIGUSR2

    def enable_faulthandler(self) -> None:
        """Hard-crash evidence (segfault, deadlock dump via SIGABRT):
        ``faulthandler`` tracebacks into ``faulthandler-<node>.log``
        next to the bundle.  The recorder itself cannot run Python in a
        segfaulting process — this file is the crash half of the black
        box."""
        if self.run_dir is None or self._faulthandler_fh is not None:
            return
        import faulthandler

        try:
            path = os.path.join(self.run_dir,
                                f"faulthandler-{self.node or 'proc'}.log")
            self._faulthandler_fh = open(path, "w")
            faulthandler.enable(self._faulthandler_fh)
        except (OSError, ValueError):
            self._faulthandler_fh = None

    # -- dump ---------------------------------------------------------------
    def dump(self, trigger: str, reason: str = "",
             round_idx: Optional[int] = None, force: bool = False,
             min_interval_s: float = DEFAULT_MIN_INTERVAL_S,
             **fields) -> Optional[str]:
        """Write the bundle.  Returns the path, or None when recording
        is off, no run_dir is configured (the trigger still lands in
        history), the per-kind rate limit suppressed it, or another
        dump is in flight (non-blocking acquire: a dump requested from
        a signal handler must never deadlock against the main thread's
        own dump)."""
        if not self.enabled:
            return None
        t_m = time.perf_counter()
        rec = {"kind": trigger, "reason": reason, "round": round_idx,
               "t_m": t_m, "t_wall": time.time(), **fields}
        self._history.append(rec)
        tel = get_telemetry()
        if self.run_dir is None:
            return None
        last = self._last_dump.get(trigger)
        if not force and last is not None and t_m - last < min_interval_s:
            tel.inc("flight.dumps_suppressed", trigger=trigger)
            return None
        if not self._dump_lock.acquire(blocking=False):
            tel.inc("flight.dumps_suppressed", trigger=trigger)
            return None
        try:
            self._last_dump[trigger] = t_m
            t0 = time.perf_counter()
            bundle = self._build_bundle(rec)
            path = os.path.join(self.run_dir, f"flight-{self.node}.json")
            fd, tmp = tempfile.mkstemp(dir=self.run_dir,
                                       prefix=".flight-", suffix=".tmp")
            try:
                with os.fdopen(fd, "w") as fh:
                    json.dump(bundle, fh, separators=(",", ":"),
                              default=str)
                os.replace(tmp, path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
            dt = time.perf_counter() - t0
        except Exception:
            tel.inc("flight.dump_errors")
            return None
        finally:
            self._dump_lock.release()
        tel.inc("flight.dumps", trigger=trigger)
        tel.observe("flight.dump_write_s", dt)
        tel.event("flight_dump", trigger=trigger, reason=reason,
                  round=round_idx, path=path, write_s=dt)
        return path

    def _build_bundle(self, trigger_rec: dict) -> dict:
        t_m = time.perf_counter()
        horizon = t_m - self.window_s
        rings: Dict[str, List[dict]] = {}
        for cat, ring in self._rings.items():
            rows = _snap_ring(ring)
            # dict(f, ...) second: a recording site's stray "t_m"/"kind"
            # field can never mask the row's own stamp and kind
            rings[cat] = [dict(f, t_m=t, kind=k)
                          for (t, k, f) in rows if t >= horizon]
        return {
            "schema": SCHEMA,
            "node": self.node,
            "pid": os.getpid(),
            "window_s": self.window_s,
            "trigger": trigger_rec,
            "history": list(self._history),
            "clock_sync": self._clock_sync,
            "t_m_dump": t_m,
            "t_wall_dump": time.time(),
            "telemetry": get_telemetry().snapshot(),
            "rings": rings,
        }


_GLOBAL = FlightRecorder()


def get_recorder() -> FlightRecorder:
    """The process-wide recorder (one per process, like the telemetry
    registry)."""
    return _GLOBAL


def note(category: str, kind: str, **fields) -> None:
    """Module-level hot-path record on the process recorder — the form
    every instrumentation site uses (one attribute check when off)."""
    r = _GLOBAL
    if r.enabled:
        r.record(category, kind, **fields)


def trigger(kind: str, reason: str = "", round_idx: Optional[int] = None,
            **kw) -> Optional[str]:
    """Request a dump on the process recorder (rate-limited per kind)."""
    return _GLOBAL.dump(kind, reason=reason, round_idx=round_idx, **kw)


def install(run_dir: Optional[str], node: str,
            signals: bool = True) -> FlightRecorder:
    """Full per-process wiring, called by every federation entry point
    (``experiments/distributed_fedavg.py`` roles): dump destination,
    excepthooks, SIGUSR2, faulthandler, and the CheckedLock tap.  The
    telemetry taps are wired at import (below) so recording is always
    on even in library use."""
    r = _GLOBAL
    r.configure(run_dir, node)
    r.install_excepthooks()
    if signals:
        r.install_signal_handlers()
    r.enable_faulthandler()
    if run_dir and not r._atexit_installed:
        # final-state bundle on CLEAN exit too: a healthy run (or one
        # whose only anomaly never trips a trigger — every-frame shm
        # fallback, say) still leaves its black box behind, so the
        # forensics baseline and the fault-free verdict work from the
        # same evidence as the faulted arms
        import atexit

        atexit.register(
            lambda: r.dump("manual", reason="shutdown", force=True))
        r._atexit_installed = True
    try:
        from fedml_tpu_torch.analysis import locks as _locks

        _locks.set_acquire_tap(r._on_lock)
    except Exception:
        pass
    return r


def _autowire() -> None:
    # always-on contract: any process that imports the obs layer feeds
    # its event stream and span observations into the rings, whether or
    # not an entry point ever calls install()
    tel = get_telemetry()
    tel.set_event_tap(_GLOBAL._on_event)
    tel.set_observe_tap(_GLOBAL._on_observe)


_autowire()
