"""Federation SLO engine — declarative objectives evaluated live (copy
of ``fedml_tpu/obs/slo.py``; stdlib only).

ROADMAP item 2 asks for "SLO-style p99 round latency ... under load";
until this module nothing in the repo computed, declared, or gated an
objective while the federation was RUNNING.  The engine closes that
gap on top of the in-band stats plane (``obs/digest.py``):

- ``SloSpec`` is the declarative objective set (JSON / dataclass):
  p50/p99 round wall, bytes per round, participation, stale/corrupt
  upload budgets, degraded-round budget, telemetry-coverage budget;
- ``SloEngine`` is evaluated once per closed round against the merged
  rollup: percentiles come from the merged **log2 histograms**
  (``hist_quantile`` — bucket upper bound, the same estimator family
  ``tools/trace_summary`` uses), violations emit ``slo_violation``
  events + ``slo.violations{objective=}`` counters, and the final
  machine-readable ``slo_report.json`` lands in run_dir;
- ``build_status``/``write_json_atomic`` produce the live
  ``status.json`` snapshot (rollup + SLO state + per-stream liveness)
  that ``tools/fed_slo.py`` renders — a killed or wedged run leaves
  evidence mid-flight instead of nothing.

Stdlib-only (same contract as ``obs/digest.py``): the tools read these
artifacts on a bare interpreter.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import threading
import time
from typing import Dict, List, Optional

from fedml_tpu_torch.obs.telemetry import Telemetry, get_telemetry
from fedml_tpu_torch.obs import digest as digestlib


def hist_quantile(hist: Optional[dict], q: float) -> Optional[float]:
    """Quantile upper bound from a digest histogram's log2 buckets.

    Nearest-rank over bucket counts, answering with the bucket's upper
    bound — so the true quantile lies within ONE log2 bucket below the
    returned value (the acceptance contract the health campaign checks
    against ``fed_timeline``'s exact post-hoc numbers)."""
    if not hist:
        return None
    count = hist.get("count", 0)
    if not count:
        return None
    target = max(1, int(math.ceil(q * count)))
    acc = 0
    for le, n in sorted((float(k), v)
                        for k, v in (hist.get("buckets") or {}).items()):
        acc += n
        if acc >= target:
            return le
    return hist.get("max")


@dataclasses.dataclass(frozen=True)
class SloSpec:
    """Declarative federation objectives; ``None`` = not gated (the
    engine still REPORTS every observed number, so an empty spec is a
    pure health report).  Budgets are per run, percentile/participation
    objectives per evaluation."""

    p50_round_wall_s: Optional[float] = None   # slo.round_wall_s p50 <=
    p99_round_wall_s: Optional[float] = None   # slo.round_wall_s p99 <=
    round_bytes_p50: Optional[float] = None    # slo.round_bytes p50 <=
    min_participation: Optional[float] = None  # last round's arrived/target >=
    max_stale_uploads: Optional[int] = None    # cumulative stale rejects <=
    max_corrupt_uploads: Optional[int] = None  # cumulative corrupt rejects <=
    # robust-aggregation budget: outlier-score rejects (the streaming
    # defense's norm-space firewall) — a quiet ongoing attack then
    # shows up as an SLO VIOLATION, not just a counter someone has to
    # go looking for.  Counted per DELIVERED copy, like every
    # faults.observed kind (a chaos-duplicated hostile upload is two
    # hostile frames observed) — size the budget accordingly.
    max_outlier_uploads: Optional[int] = None  # cumulative outlier rejects <=
    max_degraded_rounds: Optional[int] = None  # cumulative degraded rounds <=
    max_stale_streams: Optional[int] = None    # silent/missing reporters <=
    # async buffered-round objectives (--round-mode async), evaluated at
    # each round CUT like everything else: the p99 of accepted uploads'
    # round gaps (how far behind the population is running), and the
    # fraction of arrived sample weight the staleness discount removed
    # (discarded / (discarded + folded) — a model-quality budget: high
    # discard means the cut cadence outruns the devices)
    p99_upload_staleness: Optional[float] = None   # async.upload_staleness p99 <=
    max_discarded_weight_frac: Optional[float] = None  # discarded weight frac <=
    # staleness threshold for reporter streams; None = derive it from
    # the report interval at engine construction (the server resolves
    # max(10 s, 5 x interval) — a 30 s interval must not flag every
    # live stream stale between frames)
    stale_after_s: Optional[float] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_obj(cls, obj: dict) -> "SloSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(obj) - known
        if unknown:
            raise ValueError(f"unknown SLO spec fields: {sorted(unknown)} "
                             f"(known: {sorted(known)})")
        for k, v in obj.items():
            # fail FAST on a non-numeric threshold (e.g. "5" from shell
            # templating): a TypeError inside evaluate() would be
            # swallowed by the round path's best-effort guard and the
            # final report would read ok=true with the gate silently dead
            if v is not None and (isinstance(v, bool)
                                  or not isinstance(v, (int, float))):
                raise ValueError(
                    f"SLO spec field {k!r} must be a number or null, "
                    f"got {v!r}")
        stale = obj.get("stale_after_s")
        if stale is not None and stale <= 0:
            raise ValueError(
                f"stale_after_s must be positive (or null = derived "
                f"from the report interval), got {stale!r}")
        return cls(**obj)

    @classmethod
    def from_arg(cls, arg: str) -> "SloSpec":
        """CLI form: inline JSON (``{"p99_round_wall_s": 5}``) or a
        path to a JSON file."""
        text = arg.strip()
        if not text.startswith("{") and os.path.exists(text):
            with open(text) as fh:
                text = fh.read()
        return cls.from_obj(json.loads(text))


class SloEngine:
    """Per-round objective evaluation over the merged rollup.

    ``observe_round`` feeds the two SLO histograms (round wall, bytes
    per round) into the LOCAL registry — they then travel the same
    digest plane as everything else, so an upstream tier evaluating the
    merged rollup computes the identical percentiles (the digest
    algebra's whole point).  ``evaluate`` compares spec thresholds to
    the rollup's current merged state and records violations.
    """

    _GUARDED_BY = {
        "violations": "_lock",
        "rounds_evaluated": "_lock",
        "_participation": "_lock",
    }

    def __init__(self, spec: Optional[SloSpec] = None,
                 telemetry: Optional[Telemetry] = None):
        spec = spec or SloSpec()
        if spec.stale_after_s is None:
            # unresolved staleness threshold: fall back to the module
            # default (entry points resolve it from the report interval
            # BEFORE constructing the engine) — inside the engine it is
            # always a concrete positive number
            spec = dataclasses.replace(
                spec, stale_after_s=digestlib.DEFAULT_STALE_AFTER_S)
        self.spec = spec
        self.telemetry = telemetry or get_telemetry()
        self._lock = threading.Lock()  # stdlib-leaf, see obs/digest.py
        self.violations: List[dict] = []
        self.rounds_evaluated = 0
        self._participation: List[float] = []
        # telemetry-coverage grace: a round that closes before the
        # first report interval could even elapse must not flag every
        # expected node missing (the spurious-violation class) — the
        # stale_streams objective arms only once the plane has been up
        # for one staleness threshold
        self._t_up = time.time()

    # -- per-round inputs ---------------------------------------------------
    def observe_round(self, round_idx: int, *, wall_s: float,
                      round_bytes: float, participants: int,
                      target: int) -> None:
        if wall_s >= 0 and math.isfinite(wall_s):
            self.telemetry.observe("slo.round_wall_s", wall_s)
        if round_bytes >= 0 and math.isfinite(round_bytes):
            self.telemetry.observe("slo.round_bytes", round_bytes)
        frac = participants / target if target else 1.0
        with self._lock:
            self._participation.append(frac)

    # -- evaluation ---------------------------------------------------------
    def _counter_sum(self, rollup_digest: dict, prefix: str) -> float:
        return sum(v for k, v in (rollup_digest.get("counters") or {}).items()
                   if k.startswith(prefix))

    def evaluate(self, round_idx: int, rollup_digest: dict,
                 sources: dict, expected_nodes=None) -> List[dict]:
        """One evaluation pass (called at each round close).  Returns
        the NEW violations; cumulative state rides the engine."""
        spec = self.spec
        hists = rollup_digest.get("hists") or {}
        found: List[dict] = []

        def check(objective: str, observed, threshold, *, at_most=True):
            if threshold is None or observed is None:
                return
            bad = observed > threshold if at_most else observed < threshold
            if bad:
                found.append({"round": round_idx, "objective": objective,
                              "observed": observed, "threshold": threshold})

        check("round_wall_p50",
              hist_quantile(hists.get("slo.round_wall_s"), 0.5),
              spec.p50_round_wall_s)
        check("round_wall_p99",
              hist_quantile(hists.get("slo.round_wall_s"), 0.99),
              spec.p99_round_wall_s)
        check("round_bytes_p50",
              hist_quantile(hists.get("slo.round_bytes"), 0.5),
              spec.round_bytes_p50)
        with self._lock:
            last_part = (self._participation[-1]
                         if self._participation else None)
        check("participation", last_part, spec.min_participation,
              at_most=False)
        check("stale_uploads",
              self._counter_sum(rollup_digest,
                                "faults.observed{kind=stale_upload"),
              spec.max_stale_uploads)
        check("corrupt_uploads",
              self._counter_sum(rollup_digest,
                                "faults.observed{kind=corrupt_upload"),
              spec.max_corrupt_uploads)
        check("outlier_uploads",
              self._counter_sum(rollup_digest,
                                "faults.observed{kind=outlier_upload"),
              spec.max_outlier_uploads)
        check("degraded_rounds",
              self._counter_sum(rollup_digest, "rounds.degraded"),
              spec.max_degraded_rounds)
        check("upload_staleness_p99",
              hist_quantile(hists.get("async.upload_staleness"), 0.99),
              spec.p99_upload_staleness)
        check("discarded_weight_frac",
              self._discarded_frac(rollup_digest),
              spec.max_discarded_weight_frac)
        stale, missing = self.coverage(rollup_digest, sources,
                                       expected_nodes)
        # silent streams AND never-covered nodes both count, each —
        # collapsing missing coverage to a boolean would let any
        # threshold >= 1 pass however many nodes went dark.  Armed only
        # after one staleness threshold of uptime: before the first
        # report interval has even elapsed, "everyone is missing" is
        # startup, not an outage.
        if time.time() - self._t_up >= self.spec.stale_after_s:
            check("stale_streams", len(stale) + len(missing),
                  spec.max_stale_streams)
        for v in found:
            self.telemetry.inc("slo.violations", objective=v["objective"])
            self.telemetry.event("slo_violation", **v)
            logging.warning(
                "SLO violation at round %s: %s observed=%s threshold=%s",
                round_idx, v["objective"], v["observed"], v["threshold"],
            )
        self.telemetry.inc("slo.evaluations")
        with self._lock:
            self.rounds_evaluated += 1
            self.violations.extend(found)
        if found:
            # black-box trigger: the evaluation that flagged the round
            # is the moment the evidence is still in the rings
            from fedml_tpu_torch.obs import flight

            flight.trigger(
                "slo_violation", round_idx=round_idx,
                reason=",".join(v["objective"] for v in found),
            )
        return found

    def _discarded_frac(self, rollup_digest: dict) -> Optional[float]:
        """Fraction of arrived async sample weight the staleness
        discount removed: ``discarded / (discarded + folded)``.  None
        (not 0) when nothing has folded yet, so the objective cannot
        spuriously pass/fail before the first cut."""
        discarded = self._counter_sum(rollup_digest, "async.discarded_weight")
        folded = self._counter_sum(rollup_digest, "async.folded_weight")
        total = discarded + folded
        return discarded / total if total > 0 else None

    def coverage(self, rollup_digest: dict, sources: dict,
                 expected_nodes=None):
        """(stale stream ids, missing node ids): streams silent past the
        spec's staleness threshold, and expected nodes NO stream has
        ever covered — the ``telemetry_loss`` chaos scenario's flagging
        contract (counted + named, never silent)."""
        stale = sorted(s for s, st in (sources or {}).items()
                       if st.get("stale"))
        missing: List[int] = []
        if expected_nodes:
            covered = set(int(n)
                          for n in (rollup_digest.get("nodes") or ()))
            for s in (sources or {}):
                # a stream that reports at all covers at least its own
                # node id, even if its digests declare no nodes list
                try:
                    covered.add(int(s))
                except (TypeError, ValueError):
                    pass
            missing = sorted(int(n) for n in expected_nodes
                             if int(n) not in covered)
        return stale, missing

    def violation_state(self):
        """(total violations, last 10) under the engine's own lock —
        what the live status builder embeds."""
        with self._lock:
            return len(self.violations), list(self.violations[-10:])

    # -- artifacts ----------------------------------------------------------
    def report(self, rollup_digest: dict, sources: dict,
               expected_nodes=None, extra: Optional[dict] = None) -> dict:
        """The ``slo_report.json`` document (machine-readable verdict)."""
        hists = rollup_digest.get("hists") or {}
        wall = hists.get("slo.round_wall_s") or {}
        rbytes = hists.get("slo.round_bytes") or {}
        staleness = hists.get("async.upload_staleness") or {}
        stale, missing = self.coverage(rollup_digest, sources,
                                       expected_nodes)
        with self._lock:
            violations = list(self.violations)
            rounds_evaluated = self.rounds_evaluated
            participation = list(self._participation)
        by_objective: Dict[str, int] = {}
        for v in violations:
            by_objective[v["objective"]] = \
                by_objective.get(v["objective"], 0) + 1
        doc = {
            "v": 1,
            "spec": self.spec.to_dict(),
            "rounds_evaluated": rounds_evaluated,
            "ok": not violations,
            "violations_total": len(violations),
            "by_objective": by_objective,
            "violations": violations[:200],
            "observed": {
                "round_wall_s": {
                    "p50": hist_quantile(wall, 0.5),
                    "p99": hist_quantile(wall, 0.99),
                    "count": wall.get("count", 0),
                    "min": wall.get("min"),
                    "max": wall.get("max"),
                    "mean": (wall.get("sum", 0.0) / wall["count"]
                             if wall.get("count") else None),
                },
                "round_bytes": {
                    "p50": hist_quantile(rbytes, 0.5),
                    "p99": hist_quantile(rbytes, 0.99),
                    "count": rbytes.get("count", 0),
                    "max": rbytes.get("max"),
                },
                "participation": {
                    "last": participation[-1] if participation else None,
                    "min": min(participation) if participation else None,
                },
                "stale_uploads": self._counter_sum(
                    rollup_digest, "faults.observed{kind=stale_upload"),
                "corrupt_uploads": self._counter_sum(
                    rollup_digest, "faults.observed{kind=corrupt_upload"),
                "outlier_uploads": self._counter_sum(
                    rollup_digest, "faults.observed{kind=outlier_upload"),
                "degraded_rounds": self._counter_sum(
                    rollup_digest, "rounds.degraded"),
                "upload_staleness": {
                    "p99": hist_quantile(staleness, 0.99),
                    "count": staleness.get("count", 0),
                    "max": staleness.get("max"),
                },
                "discarded_weight_frac": self._discarded_frac(
                    rollup_digest),
            },
            "stats_plane": {
                "streams": len(sources or {}),
                "stale_streams": stale,
                "missing_nodes": missing[:50],
                "missing_nodes_total": len(missing),
                "nodes_covered": len(rollup_digest.get("nodes") or ()),
                "sources": sources,
            },
        }
        if extra:
            doc.update(extra)
        return doc


def write_json_atomic(path: str, obj: dict) -> None:
    """tmp-file + ``os.replace``: a reader (``fed_slo --watch``, a CI
    artifact grab mid-kill) never sees a torn document — the same
    atomicity contract as the checkpoint writer.  The tmp name comes
    from ``mkstemp`` (unique per CALL, not per process): the status
    thread and a round-close write can land concurrently, and a shared
    pid-keyed tmp would let one writer truncate the other's file
    mid-write."""
    import tempfile

    dirname = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(
        prefix=os.path.basename(path) + ".tmp.", dir=dirname)
    try:
        with os.fdopen(fd, "w") as fh:
            json.dump(obj, fh, indent=1, default=float)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def build_status(engine: SloEngine, rollup, *, round_idx: int,
                 rounds_total: int, expected_nodes=None,
                 finished: bool = False,
                 now: Optional[float] = None) -> dict:
    """The live ``status.json`` snapshot: merged rollup + SLO state +
    per-stream liveness.  Written atomically each report interval AND
    at every round close, so a killed or wedged run leaves a current
    picture behind mid-flight."""
    if now is None:
        now = time.time()
    snap = rollup.snapshot()
    sources = rollup.sources(now=now,
                             stale_after=engine.spec.stale_after_s)
    hists = snap.get("hists") or {}
    wall = hists.get("slo.round_wall_s") or {}
    stale, missing = engine.coverage(snap, sources, expected_nodes)
    violations_total, recent = engine.violation_state()
    return {
        "v": 1,
        "t": now,
        "finished": finished,
        "round": round_idx,
        "rounds_total": rounds_total,
        "slo": {
            "ok": violations_total == 0,
            "violations_total": violations_total,
            "recent_violations": recent,
        },
        "round_wall_s": {
            "p50": hist_quantile(wall, 0.5),
            "p99": hist_quantile(wall, 0.99),
            "count": wall.get("count", 0),
            "max": wall.get("max"),
        },
        "stats_plane": {
            **rollup.stats(),
            "stale_streams": stale,
            "missing_nodes_total": len(missing),
            "nodes_covered": len(snap.get("nodes") or ()),
        },
        "sources": sources,
        "rollup": {
            "counters": snap.get("counters") or {},
            "gauges": {k: v[1] for k, v in (snap.get("gauges") or {}).items()},
        },
    }
