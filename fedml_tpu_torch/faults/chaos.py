"""``ChaosBackend`` — fault-injecting ``CommBackend`` wrapper (port of
``fedml_tpu/faults/chaos.py``).

Wraps ANY transport (the deterministic inproc bus, the TCP hub's
backend, a muxer's virtual node) and applies a ``FaultPlan`` on both paths:

- **send**: ``send_message`` consults the plan before handing the frame
  to the inner transport — drop, corrupt (NaN-fill a model leaf),
  duplicate, delay/reorder, or sever the connection after sending;
- **notify (recv)**: the wrapper registers itself as the inner
  backend's observer and re-delivers to ITS observers, applying the
  plan's recv mix on the way — a delayed inbound upload is exactly the
  post-deadline straggler frame the server must stale-reject.

Delay semantics per transport:

- inproc: hold the message for ``delay_msgs`` subsequent messages on the
  same path, and flush any still-held messages when the bus quiesces
  (``InprocBus.add_quiesce_hook``) — a "late arrival" in the
  synchronous simulation, with a fully deterministic delivery trace;
- wall-clock transports: a daemon ``threading.Timer`` re-injects after
  ``delay_s`` seconds.

Leaves: the port's frames carry numpy arrays and CPU tensors, and
bfloat16 as a torch tensor (numpy has no bfloat16 without
``ml_dtypes``, which the port does not use).  A bf16 leaf is mutated
through its uint16 bits: NaN is ``0x7FC0``, the pattern ``ml_dtypes``
writes for ``np.nan``, and a scaled leaf is float32 × factor rounded to
nearest even back to bf16, as ``ml_dtypes`` casts.  The mutated frames
are the JAX package's byte for byte.

Telemetry: every injected fault increments
``faults.injected{action=...,msg_type=...}`` on the process registry, so
chaos runs can assert ``observed == injected`` against the tolerance
layer's ``faults.observed`` counters.  The wrapper does NOT double-count
``comm.*`` series: sends are recorded by the inner transport, receives
by the inner ``_notify``.
"""

from __future__ import annotations

import base64
import logging
import threading
from typing import Callable, List, Optional

import numpy as np
import torch

from fedml_tpu_torch.analysis.locks import make_lock
from fedml_tpu_torch.comm.backend import CommBackend, Observer
from fedml_tpu_torch.comm.message import NDARRAY_KEY, WIRETREE_KEY, Message
from fedml_tpu_torch.faults.plan import FaultPlan
from fedml_tpu_torch.obs import flight, trace_ctx
from fedml_tpu_torch.obs.telemetry import get_telemetry

_BF16 = "bfloat16"
# the bf16 NaN ml_dtypes writes for np.nan (float32 0x7FC00000, truncated)
_BF16_NAN_BITS = 0x7FC0


def _bf16_from_bits(bits: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(bits, np.uint16)
                            .view(np.int16).copy()).view(torch.bfloat16)


def _bf16_bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


def _scale_bf16_bits(bits: np.ndarray, factor: float) -> np.ndarray:
    """float32 × factor, rounded to nearest even back to bf16 bits."""
    f32 = _bf16_from_bits(bits).float() * factor
    return _bf16_bits(f32.to(torch.bfloat16))


def _float_kind(leaf) -> Optional[str]:
    """'bf16', 'tensor' or 'numpy' for a leaf that can hold a NaN, else
    None (integer payloads: qsgd's q, top-k's indices)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return "bf16"
        return "tensor" if leaf.is_floating_point() else None
    if hasattr(leaf, "dtype"):
        a = np.asarray(leaf)
        return "numpy" if a.dtype.kind == "f" else None
    return None


def _nan_like(leaf, kind: str):
    if kind == "bf16":
        return _bf16_from_bits(np.full(tuple(leaf.shape), _BF16_NAN_BITS,
                                       np.uint16))
    if kind == "tensor":
        return torch.full_like(leaf.detach().cpu(), float("nan"))
    return np.full_like(np.asarray(leaf), np.nan)


def _scaled(leaf, kind: str, factor: float):
    if kind == "bf16":
        return _bf16_from_bits(_scale_bf16_bits(
            _bf16_bits(leaf.detach().cpu()), factor))
    if kind == "tensor":
        t = leaf.detach().cpu()
        return (t.float() * factor).to(t.dtype)
    a = np.asarray(leaf)
    return (np.asarray(a, np.float32) * factor).astype(a.dtype)


def _b64_float_dtype(leaf: dict) -> Optional[str]:
    """A v1 base64 leaf's dtype name when it holds floats, else None."""
    name = leaf.get("dtype", "float32")
    if name == _BF16:
        return name
    try:
        return name if np.dtype(name).kind == "f" else None
    except TypeError:
        return None


def _nan_leaf_twin(leaf) -> Optional[object]:
    """NaN-filled COPY of one wiretree leaf, or None if the leaf holds
    no float payload.  Handles every wire generation: v1 b64 dicts, v2
    raw arrays, and codec entries (whose float sub-arrays — scales /
    values — NaN-fill, so the decoded update is non-finite and the
    server's corrupt-upload firewall fires exactly as for raw faults)."""
    if isinstance(leaf, dict) and NDARRAY_KEY in leaf:
        name = _b64_float_dtype(leaf)
        if name is None:
            return None
        shape = leaf.get("shape") or ()
        if name == _BF16:
            bad = np.full(shape, _BF16_NAN_BITS, np.uint16)
        else:
            bad = np.full(shape, np.nan, dtype=np.dtype(name))
        return {**leaf, NDARRAY_KEY: base64.b64encode(bad.tobytes()).decode()}
    if isinstance(leaf, dict) and "enc" in leaf:
        enc = leaf["enc"]
        for name, arr in enc.items():
            kind = _float_kind(arr)
            if kind is not None:
                return {**leaf, "enc": {**enc, name: _nan_like(arr, kind)}}
        return None
    kind = _float_kind(leaf)
    return None if kind is None else _nan_like(leaf, kind)


def _scaled_leaf_twin(leaf, factor: float) -> Optional[object]:
    """COPY of one wiretree leaf with every float payload multiplied by
    ``factor`` (the Byzantine upload mutation), or None if the leaf
    holds no float payload.  Same leaf-form coverage as
    ``_nan_leaf_twin``: v1 b64 dicts, v2 raw arrays, and codec entries
    — for codecs every float sub-array scales (decode is linear in
    each: qsgd/bf16 scales, top-k values), so the DECODED update is
    exactly ``factor ×`` the honest one."""
    if isinstance(leaf, dict) and NDARRAY_KEY in leaf:
        name = _b64_float_dtype(leaf)
        if name is None:
            return None
        shape = leaf.get("shape") or ()
        raw = base64.b64decode(leaf[NDARRAY_KEY])
        if name == _BF16:
            out = _scale_bf16_bits(
                np.frombuffer(raw, np.uint16).reshape(shape), factor)
        else:
            buf = np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape)
            out = _scaled(buf, "numpy", factor)
        return {**leaf,
                NDARRAY_KEY: base64.b64encode(out.tobytes()).decode()}
    if isinstance(leaf, dict) and "enc" in leaf:
        enc = dict(leaf["enc"])
        hit = False
        for name, arr in leaf["enc"].items():
            kind = _float_kind(arr)
            if kind is not None:
                enc[name] = _scaled(arr, kind, factor)
                hit = True
        return {**leaf, "enc": enc} if hit else None
    kind = _float_kind(leaf)
    return None if kind is None else _scaled(leaf, kind, factor)


def attack_message(msg: Message, factor: float) -> Optional[Message]:
    """Copy-on-write Byzantine mutation: multiply EVERY float leaf of
    the first wire pytree in the params (the model payload) by
    ``factor`` — ``-1`` is the sign-flip attack, ``±k`` the
    scaled-gradient attack.  Unlike ``corrupt_message`` (one NaN leaf,
    caught by the finite firewall) the result is FINITE and plausible:
    only the robust aggregation layer can bound or reject it.  Returns
    the mutated COPY, or None if nothing mutable — shared param dicts
    are never touched in place."""
    for key, value in msg.params.items():
        if not (isinstance(value, dict) and WIRETREE_KEY in value):
            continue
        leaves = value.get("leaves") or []
        new_leaves = [
            (t if t is not None else l)
            for l, t in ((l, _scaled_leaf_twin(l, factor)) for l in leaves)
        ]
        if all(t is l for t, l in zip(new_leaves, leaves)):
            continue
        twin = Message()
        twin.params = dict(msg.params)
        twin.params[key] = {**value, "leaves": new_leaves}
        # unmutated leaves are SHARED with the original — a slab-backed
        # payload's residency travels with the twin (pin machinery)
        twin._region = msg._region
        return twin
    return None


def corrupt_message(msg: Message, rng) -> Optional[Message]:
    """Copy-on-write payload corruption: NaN-fill one float leaf of the
    first wire pytree found in the params (the model payload).  Returns
    the corrupted COPY, or None if nothing corruptible — shared param
    dicts are never mutated in place (on inproc the same objects travel
    to the receiver)."""
    for key, value in msg.params.items():
        if not (isinstance(value, dict) and WIRETREE_KEY in value):
            continue
        leaves = value.get("leaves") or []
        twins = [(i, t) for i, t in
                 ((i, _nan_leaf_twin(l)) for i, l in enumerate(leaves))
                 if t is not None]
        if not twins:
            continue
        i, twin_leaf = twins[rng.randrange(len(twins))]
        new_leaves = list(leaves)
        new_leaves[i] = twin_leaf
        twin = Message()
        twin.params = dict(msg.params)
        twin.params[key] = {**value, "leaves": new_leaves}
        twin._region = msg._region  # shared uncorrupted leaves: see above
        return twin
    return None


class _Bridge(Observer):
    """Inner backend's observer: routes deliveries through the chaos
    recv path (the wrapper itself stays a CommBackend, not an
    Observer)."""

    def __init__(self, chaos: "ChaosBackend"):
        self.chaos = chaos

    def receive_message(self, msg_type: str, msg: Message) -> None:
        self.chaos._on_inner_message(msg)


class ChaosBackend(CommBackend):
    """Fault-injecting decorator around an inner ``CommBackend``.

    Node managers attach to THIS backend; the inner transport keeps its
    protocol behavior (registration, reconnect, telemetry) untouched.
    ``trace`` records every chaos decision as
    ``(direction, msg_type, seq, actions)`` tuples — the deterministic
    delivery trace ``tests/test_faults.py`` pins across runs.
    """

    # lock-discipline contract (fedlint): sends run on the caller's
    # thread, recv faults on the inner backend's reader thread, delay
    # release on Timer threads — sequence numbers, held messages, AND
    # the decision trace are all cross-thread state
    _GUARDED_BY = {
        "_seq": "_lock",
        "_held": "_lock",
        "trace": "_lock",
    }

    def __init__(self, inner: CommBackend, plan: FaultPlan,
                 telemetry=None):
        super().__init__(inner.node_id)
        self.inner = inner
        self.plan = plan
        self.telemetry = telemetry or get_telemetry()
        self.trace: List[tuple] = []
        self._seq = {}  # (direction, msg_type) -> next sequence number
        self._held = {"send": [], "recv": []}  # [remaining, msg] entries
        self._lock = make_lock("ChaosBackend._lock")
        # wall-clock transports (tcp) delay via timers; the inproc bus
        # delays via held-message ticks + a quiesce flush
        bus = getattr(inner, "bus", None)
        self._deterministic = bus is not None
        if bus is not None and hasattr(bus, "add_quiesce_hook"):
            bus.add_quiesce_hook(self.flush_held)
        # stripe-level faults (direction="stripe" rules): install the
        # per-stripe hook on the inner transport's reassembly path —
        # a dropped stripe becomes an index gap, a corrupted one a crc
        # mismatch, and EITHER kills the whole logical frame without
        # wedging reassembly (the TcpBackend contract this exercises).
        # Transports without striping accept the hook as a no-op.
        if any(r.direction == "stripe" for r in plan.rules):
            inner.set_stripe_fault_hook(self._stripe_fault)
        inner.add_observer(_Bridge(self))

    # -- fault application --------------------------------------------------
    def _decide_traced(self, direction: str, msg_type: str, round_idx,
                       receiver=None):
        """Allocate the next per-(direction, msg_type) sequence number,
        consult the plan, and append the decision to the pinned trace —
        all in ONE critical section.  Sends (caller thread) and recv
        faults (reader thread) interleave; with the seq allocated in a
        separate lock scope from the append, the thread holding seq N
        can lose the race to the thread holding N+1 and the trace
        records them out of order — nondeterministic run-to-run, which
        is exactly what the pinned-trace contract forbids.  The plan
        decision is pure computation (rule matching + a seq-derived
        rng), so holding the lock across it is cheap and lock-leaf."""
        with self._lock:
            key = (direction, msg_type)
            seq = self._seq.get(key, 0)
            self._seq[key] = seq + 1
            acts = self.plan.decide(
                self.node_id, direction, msg_type, seq, round_idx,
                receiver=receiver,
            )
            self.trace.append(
                (direction, msg_type, seq,
                 tuple(a["action"] for a in acts) or ("deliver",))
            )
        if acts:
            # flight-recorder fault ring: only the decisions that DID
            # something (deliver-only would drown the signal)
            flight.note("faults", "decision", direction=direction,
                        msg_type=msg_type, seq=seq, round=round_idx,
                        actions=[a["action"] for a in acts])
        return seq, acts

    def _inject(self, action: str, msg_type: str) -> None:
        self.telemetry.inc("faults.injected", action=action, msg_type=msg_type)
        flight.note("faults", "injected", action=action, msg_type=msg_type)
        # one bundle per injecting process per rate-limit window: chaos
        # scenarios come back with black-box evidence from BOTH sides
        # (the injector here, the tolerance layer's observed triggers)
        flight.trigger("chaos_fault", reason=action)

    def _stripe_fault(self, msg_type: str, sid, idx, chunk):
        """Per-stripe decision on the inner transport's reassembly path
        (see ``TcpBackend.set_stripe_fault_hook``): returns ``None`` to
        swallow the stripe (the reassembler sees a gap) or the —
        possibly corrupted — chunk.  Decisions ride the same seeded
        per-(direction, msg_type) sequence stream and the same pinned
        trace as message-level faults."""
        if not self.plan.applies_to(msg_type):
            return chunk
        _seq, acts = self._decide_traced("stripe", msg_type, None)
        for a in acts:
            if a["action"] == "drop":
                self._inject("drop_stripe", msg_type)
                return None
            if a["action"] == "corrupt":
                self._inject("corrupt_stripe", msg_type)
                bad = bytearray(chunk)
                if bad:
                    bad[0] ^= 0xFF  # any bit flip: the crc32 must catch it
                chunk = bytes(bad)
        return chunk

    def _apply(self, direction: str, msg: Message,
               forward: Callable[[Message], None], receiver=None) -> None:
        msg_type = msg.type
        if not self.plan.applies_to(msg_type):
            forward(msg)
            self._tick(direction)
            return
        seq, acts = self._decide_traced(direction, msg_type,
                                        msg.get("round_idx"),
                                        receiver=receiver)
        if any(a["action"] == "drop" for a in acts):
            self._inject("drop", msg_type)
            self._tick(direction)
            return
        self._route(direction, msg, forward, acts, seq)

    def _route(self, direction: str, msg: Message,
               forward: Callable[[Message], None], acts, seq: int) -> None:
        """Execute an already-decided non-drop action list on one
        message (the post-decision half of ``_apply``, shared with the
        per-receiver multicast path).  ``seq`` seeds the corrupt rng —
        the same per-message stream the decision drew from."""
        msg_type = msg.type
        disconnect = False
        delay = None
        new_hold = None
        for a in acts:
            kind = a["action"]
            if kind == "corrupt":
                twin = corrupt_message(
                    msg, self.plan.rng_for(self.node_id, direction,
                                           msg_type, seq, salt="corrupt")
                )
                if twin is not None:
                    msg = twin
                    self._inject("corrupt", msg_type)
            elif kind in ("sign_flip", "scale_grad"):
                # Byzantine upload mutation (finite, plausible — the
                # finite firewall will NOT catch it; that is the point)
                factor = (-1.0 if kind == "sign_flip"
                          else float(a.get("attack_scale", 10.0)))
                twin = attack_message(msg, factor)
                if twin is not None:
                    msg = twin
                    self._inject(kind, msg_type)
            elif kind == "duplicate":
                self._inject("duplicate", msg_type)
                # the extra copy gets its own trace identity (copy+1,
                # fresh clone => fresh frame encoding): the two
                # deliveries are distinguishable in the merged timeline
                # and neither aliases the other's hop stamps (untraced
                # messages pass through fork_copy unchanged)
                forward(trace_ctx.fork_copy(msg))
            elif kind in ("delay", "reorder"):
                delay = a
            elif kind == "disconnect":
                disconnect = True
        if delay is not None:
            self._inject(delay["action"], msg_type)
            if self._deterministic:
                new_hold = [max(1, int(delay.get("delay_msgs", 1))),
                            msg, forward]
                with self._lock:
                    self._held[direction].append(new_hold)
            else:
                # the timer outlives the transport's delivery scope: a
                # slab-backed payload (shm lane) must be pinned until
                # the re-injection ran, or the ring could reclaim the
                # bytes under the delayed consumer (no-op off-lane)
                unpin = msg.pin_payload()

                def _deliver_late(m=msg, release=unpin):
                    try:
                        forward(m)
                    finally:
                        release()

                t = threading.Timer(
                    float(delay.get("delay_s", 0.05)), _deliver_late
                )
                t.daemon = True
                t.start()
        else:
            forward(msg)
        # age PRIOR holds only: the entry added by THIS call must survive
        # its own tick, or delay_msgs=1 (reorder) would release the
        # message immediately in its original position — a silent no-op
        self._tick(direction, skip=new_hold)
        if disconnect:
            dropper = getattr(self.inner, "drop_connection", None)
            if dropper is not None:
                self._inject("disconnect", msg_type)
                dropper()

    def _tick(self, direction: str, skip=None) -> None:
        """One message moved on this path: age held messages (except
        ``skip``, the hold this very call created), release the ones
        whose delay expired.  Release runs AFTER the current message
        forwarded, so a delay_msgs=1 hold is a true swap with the next
        message — the reorder semantics."""
        release = []
        with self._lock:
            remaining = []
            for entry in self._held[direction]:
                if entry is skip:
                    remaining.append(entry)
                    continue
                entry[0] -= 1
                (release if entry[0] <= 0 else remaining).append(entry)
            self._held[direction] = remaining
        for _, msg, forward in release:
            forward(msg)

    def flush_held(self) -> bool:
        """Release every held message (the bus ran dry: a held upload
        now arrives 'late', after whatever deadline logic already ran).
        Returns True if anything was released — the quiesce-hook
        contract."""
        with self._lock:
            held = self._held["send"] + self._held["recv"]
            self._held = {"send": [], "recv": []}
        for _, msg, forward in held:
            forward(msg)
        return bool(held)

    # -- CommBackend surface ------------------------------------------------
    def send_message(self, msg: Message) -> None:
        # attach the trace ctx BEFORE fault application (the inner
        # transport would only do it at its own send): a duplicate's
        # fork_copy needs an existing ctx to give the extra copy its
        # own identity — without this both inproc deliveries would
        # share one params dict and alias their hop stamps
        trace_ctx.ensure(msg, self.node_id)
        self._apply("send", msg, self.inner.send_message,
                    receiver=msg.receiver)

    def send_multicast(self, msg: Message, receivers) -> None:
        """Per-receiver fault application on a broadcast: the plan is
        consulted once per receiver (its own sequence number, exactly
        the stream the K-unicast loop would have drawn), so a drop rule
        for node 3 drops ONLY node 3's copy.  Clean receivers still
        ride the inner transport's native fan-out in one frame; faulted
        copies peel off onto the unicast path as per-receiver clones
        (shared payload objects — nothing re-encoded)."""
        receivers = [int(r) for r in receivers]
        if not receivers:
            return
        trace_ctx.ensure(msg, self.node_id)  # see send_message
        if not self.plan.applies_to(msg.type):
            self.inner.send_multicast(msg, receivers)
            # one tick PER RECEIVER, exactly like the K-unicast loop
            # this replaced — held-message aging must not depend on
            # whether the plan happens to cover this broadcast's type
            for _ in receivers:
                self._tick("send")
            return
        clean = []
        for r in receivers:
            seq, acts = self._decide_traced("send", msg.type,
                                            msg.get("round_idx"), receiver=r)
            if any(a["action"] == "drop" for a in acts):
                self._inject("drop", msg.type)
                self._tick("send")
                continue
            if not acts:
                clean.append(r)
                self._tick("send")
                continue
            self._route("send", msg.clone_for(r),
                        self.inner.send_message, acts, seq)
        if clean:
            self.inner.send_multicast(msg, clean)

    def _deliver(self, msg: Message) -> None:
        # inner._notify already recorded comm.recv for this frame —
        # deliver straight to OUR observers without re-counting
        for obs in list(self._observers):
            obs.receive_message(msg.type, msg)

    def _on_inner_message(self, msg: Message) -> None:
        if self.plan.straggler_sleep_s > 0.0 and not self._deterministic:
            import time

            time.sleep(self.plan.straggler_sleep_s)
        if self.plan.recv_spec is None and not any(
            r.direction == "recv" for r in self.plan.rules
        ):
            self._deliver(msg)
            return
        try:
            self._apply("recv", msg, self._deliver)
        except Exception:
            # a chaos bug must degrade to delivery, not kill the reader
            logging.exception("chaos recv path failed; delivering as-is")
            self._deliver(msg)

    def run(self) -> None:
        self.inner.run()

    def run_in_thread(self):
        t = threading.Thread(target=self.run, daemon=True)
        t.start()
        return t

    def stop(self) -> None:
        self.inner.stop()

    def __getattr__(self, name):
        # transport extras (await_peers, drop_connection, bus, ...)
        # resolve against the wrapped backend; __dict__ lookup avoids
        # recursing before __init__ assigned self.inner
        inner = self.__dict__.get("inner")
        if inner is None:
            raise AttributeError(name)
        return getattr(inner, name)
