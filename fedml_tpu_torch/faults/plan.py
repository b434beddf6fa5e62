"""Deterministic fault schedules — the chaos layer's source of truth
(copy of ``fedml_tpu/faults/plan.py``: a seed gives the JAX package's
decisions exactly).

The reference FedML has exactly one failure behavior:
``MPI.COMM_WORLD.Abort()`` (SURVEY.md §5.2) — one dead client kills the
federation.  Real cross-device FL must treat dropouts, stragglers,
duplicated/late frames, and corrupted payloads as the COMMON case, so
this module gives the runtime something to be tolerant *of*: a seeded,
reproducible schedule of faults that ``ChaosBackend``
(``fedml_tpu/faults/chaos.py``) applies to a node's message traffic and
that ``tools/chaos_run.py`` applies at the process level (SIGKILL a
client at round r, restart the hub).

Determinism contract: a ``FaultPlan`` is a pure function of
``(seed, node, direction, msg_type, sequence_number)`` plus the explicit
``FaultRule`` schedule — NO wall clock, NO process-global RNG.  Two runs
that present the same message sequence to the same plan draw the same
faults, which is what lets ``tests/test_faults.py`` assert that a chaos
run's delivery trace is bit-reproducible and that ``observed ==
injected`` accounting closes.

Stdlib-only on purpose (mirrors ``obs/telemetry.py``): the plan is
shipped to worker subprocesses as JSON through the ``FEDML_TPU_CHAOS``
environment variable, and the hub/tools must be able to parse it without
importing jax.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
from typing import Dict, Optional, Sequence, Tuple

# actions a plan can inject on a message path.  The last two are the
# ADVERSARIAL (Byzantine) mutations, not transport faults: sign_flip
# multiplies every float leaf of a model payload by -1, scale_grad by
# ``attack_scale`` — the classic malicious-client upload mutations
# (Blanchard et al. 2017's omniscient adversary family) the robust
# aggregation layer (``fedml_tpu/robust``) defends against.  A rule set
# covering every virtual node of one muxer IS the malicious-muxer
# (Sybil) scenario: one compromised process mutating a whole cohort's
# uploads through one connection.
ACTIONS = ("drop", "delay", "duplicate", "reorder", "corrupt",
           "disconnect", "sign_flip", "scale_grad")
ATTACK_ACTIONS = ("sign_flip", "scale_grad")

# message types faultable by default: the model-bearing control plane.
# S2C_FINISH is deliberately exempt — dropping it leaves a client's
# reader thread blocked forever, which is a harness deadlock, not an
# interesting fault (a real crashed client is modeled by crash_at_round).
DEFAULT_FAULTABLE = (
    "S2C_INIT_CONFIG",
    "S2C_SYNC_MODEL",
    "C2S_SEND_MODEL",
)

ENV_VAR = "FEDML_TPU_CHAOS"


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Probabilistic fault mix, drawn independently per message.

    ``drop`` short-circuits the rest (a dropped frame can't also be
    duplicated).  ``reorder`` is delay-by-one-message; ``delay`` holds a
    message for ``delay_msgs`` subsequent messages on the deterministic
    inproc bus and for ``delay_s`` wall seconds on TCP.  ``disconnect``
    severs the node's hub socket after the send (exercising
    auto-reconnect); it is a no-op on inproc.
    """

    drop_prob: float = 0.0
    corrupt_prob: float = 0.0
    duplicate_prob: float = 0.0
    reorder_prob: float = 0.0
    delay_prob: float = 0.0
    disconnect_prob: float = 0.0
    delay_msgs: int = 1
    delay_s: float = 0.05

    def any_prob(self) -> bool:
        return any(
            p > 0.0
            for p in (
                self.drop_prob, self.corrupt_prob, self.duplicate_prob,
                self.reorder_prob, self.delay_prob, self.disconnect_prob,
            )
        )


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One scheduled fault: fires on every message matching ALL set
    fields (``None`` = wildcard).  ``round`` matches the message's
    ``round_idx`` param, so "drop client 2's upload in round 1" is
    expressible exactly.  ``receiver`` matches the message's receiver
    id — on a MULTICAST fan-out the plan is consulted once per
    receiver, so "drop node 3's copy of the sync" drops exactly that
    copy and nobody else's (``ChaosBackend.send_multicast``)."""

    action: str
    node: Optional[int] = None
    msg_type: Optional[str] = None
    round: Optional[int] = None
    direction: str = "send"
    receiver: Optional[int] = None
    delay_msgs: int = 1
    delay_s: float = 0.05
    # adversarial mutations only: the multiplier scale_grad applies to
    # every float leaf of the upload (sign_flip is a fixed -1; a
    # NEGATIVE attack_scale composes both — the "scaled sign-flip"
    # arm of the robust-aggregation evidence campaign)
    attack_scale: float = 10.0

    def __post_init__(self):
        if self.action not in ACTIONS:
            raise ValueError(
                f"unknown fault action {self.action!r} (one of {ACTIONS})"
            )
        if self.action in ATTACK_ACTIONS and self.direction == "stripe":
            raise ValueError(
                f"{self.action} is a whole-payload mutation; stripe "
                "granularity only supports drop|corrupt"
            )
        if self.direction not in ("send", "recv", "stripe"):
            raise ValueError(
                f"direction must be send|recv|stripe: {self.direction!r}"
            )
        if self.direction == "stripe" and self.action not in ("drop",
                                                              "corrupt"):
            # a stripe is a wire fragment: it can be lost or garbled,
            # but delay/duplicate/reorder/disconnect are whole-message
            # semantics — at stripe granularity they would only model
            # transports TCP cannot be (the stream is ordered)
            raise ValueError(
                f"stripe faults support drop|corrupt only: {self.action!r}"
            )
        if self.direction == "stripe" and self.round is not None:
            raise ValueError(
                "stripe rules cannot filter by round: the stripe hook "
                "runs before the inner frame (and its round_idx) is "
                "reassembled"
            )

    def matches(self, node, direction, msg_type, round_idx,
                receiver=None) -> bool:
        return (
            self.direction == direction
            and (self.node is None or self.node == node)
            and (self.msg_type is None or self.msg_type == msg_type)
            and (self.round is None or self.round == round_idx)
            and (self.receiver is None or self.receiver == receiver)
        )


class FaultPlan:
    """Seeded per-(round x node x message-type) fault schedule.

    ``send_spec``/``recv_spec`` are the probabilistic mixes applied on a
    node's send and deliver (notify) paths; ``rules`` are explicit
    scheduled faults; ``crash_at_round`` maps node id -> round at which
    the process hard-exits (``tools/chaos_run.py`` / the
    ``--crash-at-round`` client flag); ``straggler_sleep_s`` is a
    per-delivery sleep, the message-level twin of ``--train-delay``.
    ``roles`` names which process roles (client/server) wrap their
    backend when the plan arrives via the environment.
    """

    def __init__(
        self,
        seed: int = 0,
        *,
        send_spec: Optional[FaultSpec] = None,
        recv_spec: Optional[FaultSpec] = None,
        rules: Sequence[FaultRule] = (),
        msg_types: Optional[Sequence[str]] = DEFAULT_FAULTABLE,
        roles: Sequence[str] = ("client",),
        crash_at_round: Optional[Dict[int, int]] = None,
        straggler_sleep_s: float = 0.0,
    ):
        self.seed = int(seed)
        self.send_spec = send_spec
        self.recv_spec = recv_spec
        self.rules = tuple(rules)
        self.msg_types = None if msg_types is None else tuple(msg_types)
        # a rule that NAMES a message type must fire even when that type
        # is outside the plan-level spec filter (the filter guards the
        # probabilistic mix; an explicit schedule is an explicit ask).
        # Wildcard rules (msg_type=None) stay inside msg_types — they
        # must not silently reach S2C_FINISH and deadlock shutdown.
        self._rule_types = frozenset(
            r.msg_type for r in self.rules if r.msg_type is not None
        )
        self.roles = tuple(roles)
        self.crash_at_round = dict(crash_at_round or {})
        self.straggler_sleep_s = float(straggler_sleep_s)

    # -- decision -----------------------------------------------------------
    def applies_to(self, msg_type: str) -> bool:
        return (
            self.msg_types is None
            or msg_type in self.msg_types
            or msg_type in self._rule_types
        )

    def rng_for(self, node: int, direction: str, msg_type: str,
                seq: int, salt: str = "") -> random.Random:
        """Deterministic stream per message identity.  Seeding Random
        with a STRING hashes it through sha512 (stable across processes,
        unlike ``hash()`` which is salted per interpreter)."""
        return random.Random(
            f"{self.seed}|{node}|{direction}|{msg_type}|{seq}|{salt}"
        )

    def decide(self, node: int, direction: str, msg_type: str, seq: int,
               round_idx: Optional[int] = None,
               receiver: Optional[int] = None) -> list:
        """Actions for the ``seq``-th ``msg_type`` message this node
        moves in ``direction`` (``receiver`` scopes receiver-filtered
        rules; a multicast consults the plan once per receiver).
        Returns a list of action dicts, possibly empty (= deliver
        untouched)."""
        acts = []
        for rule in self.rules:
            if rule.matches(node, direction, msg_type, round_idx, receiver):
                acts.append({
                    "action": rule.action,
                    "delay_msgs": rule.delay_msgs,
                    "delay_s": rule.delay_s,
                    "attack_scale": rule.attack_scale,
                })
        # the probabilistic mixes model whole-message faults — stripe
        # decisions come from explicit stripe rules only
        if direction == "stripe":
            spec = None
        else:
            spec = self.send_spec if direction == "send" else self.recv_spec
        # the probabilistic mix stays inside msg_types even when an
        # explicit rule admitted this type past applies_to
        spec_applies = self.msg_types is None or msg_type in self.msg_types
        if spec is not None and spec.any_prob() and spec_applies:
            rng = self.rng_for(node, direction, msg_type, seq)
            # fixed draw order = reproducible stream
            if rng.random() < spec.drop_prob:
                return [{"action": "drop"}]
            if rng.random() < spec.corrupt_prob:
                acts.append({"action": "corrupt"})
            if rng.random() < spec.duplicate_prob:
                acts.append({"action": "duplicate"})
            if rng.random() < spec.reorder_prob:
                acts.append({"action": "reorder", "delay_msgs": 1,
                             "delay_s": spec.delay_s})
            elif rng.random() < spec.delay_prob:
                acts.append({"action": "delay",
                             "delay_msgs": spec.delay_msgs,
                             "delay_s": spec.delay_s})
            if rng.random() < spec.disconnect_prob:
                acts.append({"action": "disconnect"})
        # a scheduled drop still short-circuits everything else
        if any(a["action"] == "drop" for a in acts):
            return [{"action": "drop"}]
        return acts

    # -- (de)serialization --------------------------------------------------
    def to_json(self) -> str:
        def spec_dict(s):
            return None if s is None else dataclasses.asdict(s)

        return json.dumps({
            "seed": self.seed,
            "send": spec_dict(self.send_spec),
            "recv": spec_dict(self.recv_spec),
            "rules": [dataclasses.asdict(r) for r in self.rules],
            "msg_types": None if self.msg_types is None else list(self.msg_types),
            "roles": list(self.roles),
            "crash_at_round": {str(k): v for k, v in self.crash_at_round.items()},
            "straggler_sleep_s": self.straggler_sleep_s,
        })

    @classmethod
    def from_json(cls, payload: str) -> "FaultPlan":
        d = json.loads(payload)

        def spec(v):
            return None if not v else FaultSpec(**v)

        msg_types = d.get("msg_types", DEFAULT_FAULTABLE)
        return cls(
            d.get("seed", 0),
            send_spec=spec(d.get("send")),
            recv_spec=spec(d.get("recv")),
            rules=[FaultRule(**r) for r in d.get("rules", ())],
            msg_types=None if msg_types is None else tuple(msg_types),
            roles=tuple(d.get("roles", ("client",))),
            crash_at_round={int(k): int(v)
                            for k, v in (d.get("crash_at_round") or {}).items()},
            straggler_sleep_s=d.get("straggler_sleep_s", 0.0),
        )

    @classmethod
    def from_env(cls, var: str = ENV_VAR) -> Optional["FaultPlan"]:
        """The subprocess ingestion path: ``tools/chaos_run.py`` ships
        the plan to workers as JSON in ``FEDML_TPU_CHAOS``."""
        payload = os.environ.get(var)
        return cls.from_json(payload) if payload else None
