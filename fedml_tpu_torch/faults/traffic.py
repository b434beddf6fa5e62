"""Open-loop traffic models — a reproducible day of production churn
(copy of ``fedml_tpu/faults/traffic.py``: a seed gives the JAX
package's decisions exactly).

Every scenario before this one is closed-loop: clients train when the
server says so and the only timing variance is what ``FaultPlan``
injects per message.  Production cross-device traffic is open-loop —
devices arrive on their own clock, differ 100x in speed, flap
mid-round, and follow diurnal load curves — and the async buffered
server (``--round-mode async``) exists precisely to degrade gracefully
under that arrival process.  This module is the arrival process: a
seeded ``TrafficModel`` that, for every ``(node, round)`` pair, decides
the node's upload delay, whether it is offline this round, and whether
its connection flaps, so that "a day of churn" is a deterministic chaos
scenario instead of a flake.

Determinism contract (same as ``faults/plan.py``): every decision is a
pure function of ``(seed, node, round)`` plus the explicit model
parameters — NO wall clock, NO process-global RNG.  Two runs with the
same model replay the same traffic day bit-identically, which is what
``schedule_digest`` pins in tests and what makes the FEDBUFF evidence
campaign's sync-vs-async comparison a controlled experiment (both arms
see the IDENTICAL arrival trace).

Stdlib-only on purpose: the model ships to worker subprocesses as JSON
through ``FEDML_TPU_TRAFFIC``, parsed before jax imports.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import random
from typing import Optional, Sequence, Tuple

ENV_VAR = "FEDML_TPU_TRAFFIC"

# default device speed classes: (name, population_fraction, delay_mult).
# The multiplier scales the node's drawn delay — a "slow" device takes
# 4x the base compute time of a "fast" one, the order-of-magnitude
# spread cross-device measurement studies report.
DEFAULT_SPEED_CLASSES = (
    ("fast", 0.5, 1.0),
    ("mid", 0.3, 2.0),
    ("slow", 0.2, 4.0),
)


class TrafficModel:
    """Seeded per-(node x round) arrival process.

    Per-round, per-node draws (fixed order, one rng stream per
    ``(seed, node, round)`` identity — see ``decide``):

    - base delay: ``base_delay_s`` plus exponential jitter of mean
      ``jitter_s``, scaled by the node's speed class and the diurnal
      load factor for the round;
    - straggler: with ``straggler_prob``, a Pareto(shape) draw scaled
      by ``straggler_scale_s`` and capped at ``straggler_cap_s`` is
      ADDED — the heavy tail that makes a synchronous barrier's p99
      collapse while the async server just discounts the late fold;
    - offline: with ``churn_prob`` the node skips the round entirely
      (left the population; rejoins whenever a later draw says so);
    - flap: with ``flap_prob`` the node's connection drops and redials
      mid-round (the TCP backend's ``rebind_connection()`` is the primitive).

    The diurnal factor ``1 + amplitude*sin(2*pi*round/period)``
    multiplies delays AND churn/flap probabilities: at the load peak
    everything is slower and flakier at once, which is what the
    ``overload_burst`` chaos scenario spikes.
    """

    def __init__(
        self,
        seed: int = 0,
        *,
        base_delay_s: float = 0.0,
        jitter_s: float = 0.0,
        straggler_prob: float = 0.0,
        straggler_shape: float = 1.5,
        straggler_scale_s: float = 0.2,
        straggler_cap_s: float = 10.0,
        churn_prob: float = 0.0,
        flap_prob: float = 0.0,
        diurnal_amplitude: float = 0.0,
        diurnal_period_rounds: int = 24,
        speed_classes: Sequence[Tuple[str, float, float]] = DEFAULT_SPEED_CLASSES,
        roles: Sequence[str] = ("client", "muxer"),
    ):
        self.seed = int(seed)
        self.base_delay_s = float(base_delay_s)
        self.jitter_s = float(jitter_s)
        self.straggler_prob = float(straggler_prob)
        self.straggler_shape = float(straggler_shape)
        self.straggler_scale_s = float(straggler_scale_s)
        self.straggler_cap_s = float(straggler_cap_s)
        self.churn_prob = float(churn_prob)
        self.flap_prob = float(flap_prob)
        self.diurnal_amplitude = float(diurnal_amplitude)
        self.diurnal_period_rounds = int(diurnal_period_rounds)
        self.speed_classes = tuple(
            (str(n), float(f), float(m)) for n, f, m in speed_classes
        )
        self.roles = tuple(roles)
        if self.straggler_shape <= 0:
            raise ValueError(
                f"straggler_shape must be > 0: {self.straggler_shape!r}"
            )
        if self.diurnal_period_rounds <= 0:
            raise ValueError(
                f"diurnal_period_rounds must be > 0: "
                f"{self.diurnal_period_rounds!r}"
            )
        frac = sum(f for _, f, _ in self.speed_classes)
        if self.speed_classes and not 0.999 <= frac <= 1.001:
            raise ValueError(
                f"speed class fractions must sum to 1: {frac!r}"
            )

    def any_traffic(self) -> bool:
        return any(
            p > 0.0
            for p in (
                self.base_delay_s, self.jitter_s, self.straggler_prob,
                self.churn_prob, self.flap_prob,
            )
        )

    # -- decision -----------------------------------------------------------
    def rng_for(self, node: int, kind: str, seq: int) -> random.Random:
        """Deterministic stream per decision identity.  Seeding Random
        with a STRING hashes it through sha512 (stable across
        processes, unlike ``hash()`` which is salted per interpreter —
        same discipline as ``FaultPlan.rng_for``)."""
        return random.Random(f"{self.seed}|{node}|{kind}|{seq}")

    def speed_class(self, node: int) -> Tuple[str, float]:
        """A node's device class is a permanent property: one draw per
        node lifetime, not per round."""
        if not self.speed_classes:
            return ("fast", 1.0)
        u = self.rng_for(node, "class", 0).random()
        acc = 0.0
        for name, fraction, mult in self.speed_classes:
            acc += fraction
            if u < acc:
                return (name, mult)
        name, _, mult = self.speed_classes[-1]
        return (name, mult)

    def diurnal_factor(self, round_idx: int) -> float:
        if self.diurnal_amplitude <= 0.0:
            return 1.0
        phase = 2.0 * math.pi * (round_idx % self.diurnal_period_rounds) \
            / self.diurnal_period_rounds
        return max(0.0, 1.0 + self.diurnal_amplitude * math.sin(phase))

    def decide(self, node: int, round_idx: int) -> dict:
        """The arrival decision for ``node`` in ``round_idx``:
        ``{"delay_s", "offline", "rebind", "class", "straggler"}``.
        Fixed draw order on one rng stream = reproducible trace."""
        rng = self.rng_for(node, "round", round_idx)
        cls_name, cls_mult = self.speed_class(node)
        load = self.diurnal_factor(round_idx)
        # draw order: offline, flap, jitter, straggler — ALWAYS all
        # four, so a parameter change to one knob cannot shift the
        # stream another knob reads (replay stability across configs
        # with the same non-zero knobs)
        offline = rng.random() < min(1.0, self.churn_prob * load)
        rebind = rng.random() < min(1.0, self.flap_prob * load)
        delay = self.base_delay_s
        if self.jitter_s > 0.0:
            delay += rng.expovariate(1.0 / self.jitter_s)
        else:
            rng.random()
        straggler = False
        if rng.random() < self.straggler_prob:
            straggler = True
            # Pareto: heavy-tailed — the p99-destroying draw
            tail = self.straggler_scale_s * rng.paretovariate(
                self.straggler_shape)
            delay += min(tail, self.straggler_cap_s)
        delay *= cls_mult * load
        return {
            "delay_s": delay,
            "offline": offline,
            "rebind": rebind,
            "class": cls_name,
            "straggler": straggler,
        }

    def schedule_digest(self, nodes: Sequence[int], rounds: int) -> str:
        """sha256 over the full decision trace for ``nodes`` x
        ``rounds`` — the replay-determinism probe tests and the
        traffic campaign pin (same seed => same digest, byte-for-byte)."""
        h = hashlib.sha256()
        for r in range(rounds):
            for node in sorted(nodes):
                d = self.decide(node, r)
                h.update(
                    f"{node}|{r}|{d['class']}|{d['offline']}|{d['rebind']}|"
                    f"{d['straggler']}|{d['delay_s']:.12e}".encode()
                )
        return h.hexdigest()

    # -- (de)serialization --------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({
            "seed": self.seed,
            "base_delay_s": self.base_delay_s,
            "jitter_s": self.jitter_s,
            "straggler_prob": self.straggler_prob,
            "straggler_shape": self.straggler_shape,
            "straggler_scale_s": self.straggler_scale_s,
            "straggler_cap_s": self.straggler_cap_s,
            "churn_prob": self.churn_prob,
            "flap_prob": self.flap_prob,
            "diurnal_amplitude": self.diurnal_amplitude,
            "diurnal_period_rounds": self.diurnal_period_rounds,
            "speed_classes": [list(c) for c in self.speed_classes],
            "roles": list(self.roles),
        })

    @classmethod
    def from_json(cls, payload: str) -> "TrafficModel":
        d = json.loads(payload)
        return cls(
            d.get("seed", 0),
            base_delay_s=d.get("base_delay_s", 0.0),
            jitter_s=d.get("jitter_s", 0.0),
            straggler_prob=d.get("straggler_prob", 0.0),
            straggler_shape=d.get("straggler_shape", 1.5),
            straggler_scale_s=d.get("straggler_scale_s", 0.2),
            straggler_cap_s=d.get("straggler_cap_s", 10.0),
            churn_prob=d.get("churn_prob", 0.0),
            flap_prob=d.get("flap_prob", 0.0),
            diurnal_amplitude=d.get("diurnal_amplitude", 0.0),
            diurnal_period_rounds=d.get("diurnal_period_rounds", 24),
            speed_classes=[
                tuple(c) for c in d.get("speed_classes",
                                        DEFAULT_SPEED_CLASSES)
            ],
            roles=tuple(d.get("roles", ("client", "muxer"))),
        )

    @classmethod
    def from_env(cls, var: str = ENV_VAR) -> Optional["TrafficModel"]:
        """Subprocess ingestion: ``launch()`` ships the model to
        workers as JSON in ``FEDML_TPU_TRAFFIC``."""
        payload = os.environ.get(var)
        return cls.from_json(payload) if payload else None
