"""CheckedLock: runtime lock-discipline checks (stdlib copy of
``fedml_tpu/analysis/locks.py``).

Threaded modules create their locks through ``make_lock(name)``.  Off
(the default), that returns a plain ``threading.Lock``: zero overhead,
nothing recorded.  On (``FEDML_TPU_CHECKED_LOCKS=1`` or
``set_enabled(True)``), it returns a ``CheckedLock`` that

- keeps a per-thread stack of held locks;
- on every acquire, records ``held → acquiring`` edges by lock name (a
  name is the lock's role, ``TcpHub._lock``, so the graph is over lock
  classes; a cycle means two threads can wait on each other);
- raises ``LockDisciplineError`` on a recursive acquire of the same
  instance (a plain Lock would deadlock there);
- answers ``held_by_me()``, so ``assert_held`` verifies a
  caller-holds-the-lock contract at the top of such a method.

``find_cycle()``/``assert_acyclic()`` inspect the recorded graph; stress
tests call ``reset()`` first and ``assert_acyclic()`` after.  The flight
recorder (``obs/flight.py``) taps every checked acquire's wait.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Set, Tuple, Union

ENV_ENABLE = "FEDML_TPU_CHECKED_LOCKS"

_enabled: Optional[bool] = None
_enabled_lock = threading.Lock()

_registry_lock = threading.Lock()
_edges: Set[Tuple[str, str]] = set()  # (held lock name, acquired lock name)
_held_local = threading.local()

# single acquisition tap (the flight recorder's lock ring): called as
# ``fn(lock_name, held_depth, wait_s)`` after every successful
# CheckedLock acquire, where ``wait_s`` is the measured block time of
# the underlying acquire — the runtime CONTENTION probe (a hot lock
# shows up as nonzero waits in the flight ring, not as a hunch).
# Atomic ref swap, exceptions swallowed at the call site — same
# contract as the telemetry taps.  Costs nothing with checking off
# (plain Locks never reach it).
_acquire_tap = None


def set_acquire_tap(fn) -> None:
    global _acquire_tap
    _acquire_tap = fn


class LockDisciplineError(RuntimeError):
    """A lock contract was violated at runtime (recursive acquire, or a
    ``holds=`` method entered without its lock)."""


def enabled() -> bool:
    """Process-wide switch (env ``FEDML_TPU_CHECKED_LOCKS=1``), cached
    after first read; ``set_enabled`` overrides for in-process tests."""
    global _enabled
    if _enabled is None:
        with _enabled_lock:
            if _enabled is None:
                _enabled = os.environ.get(ENV_ENABLE, "") == "1"
    return _enabled


def set_enabled(flag: Optional[bool]) -> None:
    """Override the switch (True/False); ``None`` re-reads the env on
    next use.  Only affects locks created AFTER the call — existing
    plain locks stay plain."""
    global _enabled
    with _enabled_lock:
        _enabled = flag


def _stack() -> List["CheckedLock"]:
    stack = getattr(_held_local, "stack", None)
    if stack is None:
        stack = _held_local.stack = []
    return stack


class CheckedLock:
    """``threading.Lock`` wrapper that records ordering + ownership."""

    __slots__ = ("name", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        stack = _stack()
        for held in stack:
            if held is self:
                raise LockDisciplineError(
                    f"recursive acquire of non-reentrant lock {self.name!r}"
                )
        if stack:
            # record BEFORE blocking: the edge describes the wait that
            # can deadlock, not the acquisition that succeeded
            with _registry_lock:
                for held in stack:
                    if held.name != self.name:
                        _edges.add((held.name, self.name))
        t0 = time.perf_counter()
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            stack.append(self)
            tap = _acquire_tap
            if tap is not None:
                try:
                    tap(self.name, len(stack),
                        time.perf_counter() - t0)
                except Exception:
                    pass
        return ok

    def release(self) -> None:
        stack = _stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is self:
                del stack[i]
                break
        else:
            raise LockDisciplineError(
                f"release of {self.name!r} by a thread that does not hold it"
            )
        self._lock.release()

    def __enter__(self) -> "CheckedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def held_by_me(self) -> bool:
        return any(held is self for held in _stack())

    def __repr__(self) -> str:
        return f"CheckedLock({self.name!r})"


LockLike = Union[threading.Lock, CheckedLock]


def make_lock(name: str) -> LockLike:
    """The lock factory threaded modules use: a plain ``threading.Lock``
    normally, a ``CheckedLock`` when runtime checking is enabled."""
    return CheckedLock(name) if enabled() else threading.Lock()


def assert_held(lock: LockLike, what: str = "") -> None:
    """Verify a ``# fedlint: holds=<lock>`` contract at runtime.  No-op
    for plain locks (checking off) — callers sprinkle this freely at
    the top of caller-holds methods."""
    if isinstance(lock, CheckedLock) and not lock.held_by_me():
        raise LockDisciplineError(
            f"{what or 'guarded section'} entered without holding "
            f"{lock.name!r} (a '# fedlint: holds=' contract was broken)"
        )


# --- lock-order graph inspection ---------------------------------------------

def lock_order_edges() -> Set[Tuple[str, str]]:
    with _registry_lock:
        return set(_edges)


def find_cycle() -> Optional[List[str]]:
    """A cycle in the recorded order graph as ``[a, b, ..., a]``, or
    None.  Iterative DFS with the classic white/grey/black coloring."""
    edges = lock_order_edges()
    adj: Dict[str, List[str]] = {}
    for a, b in edges:
        adj.setdefault(a, []).append(b)
    color: Dict[str, int] = {}  # 1 = on stack, 2 = done
    for root in sorted(adj):
        if color.get(root):
            continue
        path: List[str] = []
        work: List[Tuple[str, int]] = [(root, 0)]
        while work:
            node, idx = work.pop()
            if idx == 0:
                color[node] = 1
                path.append(node)
            kids = adj.get(node, ())
            if idx < len(kids):
                work.append((node, idx + 1))
                kid = kids[idx]
                if color.get(kid) == 1:
                    return path[path.index(kid):] + [kid]
                if not color.get(kid):
                    work.append((kid, 0))
            else:
                color[node] = 2
                path.pop()
    return None


def assert_acyclic() -> None:
    cycle = find_cycle()
    if cycle is not None:
        raise LockDisciplineError(
            "lock-order cycle (deadlock potential): " + " -> ".join(cycle)
        )


def reset() -> None:
    """Clear the recorded graph (test isolation).  Held-lock stacks are
    thread-local and empty between well-behaved tests."""
    with _registry_lock:
        _edges.clear()
