"""Server-side robust aggregation: the cross-device defense module (port
of ``fedml_tpu/robust/defense.py``).

Virtual-client muxing makes one physical connection speak for
thousands of virtual identities — a compromised muxer IS a Sybil
attack.  This module gives ``FedAvgServerManager`` the defenses the
simulation layer has had since the seed (``core/robust``), in two modes
sharing the ONE defense-math implementation:

- **streaming** (composes with the O(1) num/den fold): per-upload
  norm-difference clipping against the broadcast base, an
  outlier-score reject on arrival (``score = ||delta|| / norm_bound``;
  ``score > outlier_mult`` ⇒ rejected, counted
  ``faults.observed{kind=outlier_upload}`` — the non-finite firewall's
  norm-space twin), and per-CONNECTION contribution caps so no single
  physical conn (muxer) can exceed ``conn_cap`` of a round's total
  weight — the anti-Sybil lever muxing demands.  Screening is pure
  numpy on the host (xp=np through ``core.robust``): order-independent
  per-upload math, so defended same-seed runs stay digest-identical
  whatever the arrival interleaving.
- **buffered** (``median`` / ``trimmed_mean``): decoded uploads are
  buffered to the round close (still through the decode-worker
  pool) and the params collection is replaced by the coordinate-wise
  robust center — ``core.robust.robust_center``, the same estimator
  ``make_robust_transform`` runs inside the compiled engine.

Client-level DP rides either mode: per-client delta clip (``dp_clip``)
+ Gaussian noise (``dp_noise``) drawn from the deterministic
``fold_in`` stream ``core.robust.agg_noise_key(seed, round, slot)`` —
the exact per-slot keys the engine's weak-DP hook uses, so DP runs are
bit-reproducible across processes and topologies.  The keys and the
noise are the port's threefry (``core/rng.py``), the JAX package's
draws bit for bit; the rest is numpy on the host, the JAX package's
``xp=np`` calls in its order.

Threat model honesty (also in README): the conn cap bounds what one
CONNECTION can contribute; an attacker who can open many connections
(conn-level Sybil) is outside this lever's reach — that requires
admission control above the hub.  And norm-clipping cannot detect a
sign-flipped update of honest magnitude; it only bounds its influence
— the buffered estimators are the defense for that shape of attack.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from fedml_tpu_torch.core import rng as rnglib
from fedml_tpu_torch.core import robust as robustlib
from fedml_tpu_torch.core import tree as treelib
from fedml_tpu_torch.obs.telemetry import get_telemetry

PyTree = Any

DEFENSES = ("none", "streaming", "median", "trimmed_mean")


@dataclasses.dataclass(frozen=True)
class DefenseConfig:
    """Cross-device defense knobs (``distributed_fedavg --defense ...``).

    ``defense`` picks the aggregation mode; ``norm_bound`` /
    ``outlier_mult`` / ``conn_cap`` are streaming-mode levers;
    ``dp_clip`` / ``dp_noise`` (client-level DP) compose with any mode;
    ``trim_frac`` parametrizes ``trimmed_mean``.  Zero = off for every
    numeric knob.
    """

    defense: str = "none"
    norm_bound: float = 0.0   # streaming: clip ||delta|| to this bound
    outlier_mult: float = 0.0  # reject ||delta|| > mult * norm_bound
    conn_cap: float = 0.0     # max fraction of round weight per conn
    dp_clip: float = 0.0      # client-level DP: per-client delta clip
    dp_noise: float = 0.0     # client-level DP: gaussian sigma
    trim_frac: float = 0.2    # trimmed_mean: fraction trimmed per side

    def __post_init__(self):
        if self.defense not in DEFENSES:
            raise ValueError(
                f"unknown defense {self.defense!r} (one of {DEFENSES})"
            )
        if self.defense != "streaming" and (self.norm_bound > 0
                                            or self.outlier_mult > 0):
            # a bound without the mode would be silently inert — the
            # operator believes clipping is on and it is not
            raise ValueError(
                "norm_bound/outlier_mult are streaming-mode knobs; "
                f"set defense='streaming' (got {self.defense!r})"
            )
        if self.outlier_mult > 0 and self.norm_bound <= 0:
            raise ValueError(
                "outlier_mult needs norm_bound: the outlier score is "
                "||delta|| / norm_bound"
            )
        if self.conn_cap and not 0.0 < self.conn_cap < 1.0:
            raise ValueError(
                f"conn_cap must be a fraction in (0, 1): {self.conn_cap!r}"
            )
        if self.conn_cap > 0 and self.defense != "streaming":
            raise ValueError(
                "conn_cap is a streaming-mode lever (the buffered "
                "estimators are weight-free); set defense='streaming'"
            )
        if not 0.0 <= self.trim_frac < 0.5:
            raise ValueError(
                f"trim_frac must be in [0, 0.5): {self.trim_frac!r}"
            )
        if self.dp_noise > 0 and self.dp_clip <= 0:
            raise ValueError(
                "dp_noise without dp_clip is noise without a sensitivity "
                "bound — set dp_clip (the clip IS the DP guarantee)"
            )

    @property
    def enabled(self) -> bool:
        return (self.defense != "none" or self.dp_clip > 0
                or self.dp_noise > 0)

    @property
    def buffered(self) -> bool:
        return self.defense in ("median", "trimmed_mean")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def cap_connection_weights(
    weights: Dict[Any, float], cap: float
) -> Tuple[Dict[Any, float], bool]:
    """Per-connection weight scales enforcing ``w'_c ≤ cap · Σ w'``.

    Water-filling fixed point: sort connections by weight (descending,
    ties broken by key string for determinism), grow the capped set
    until every capped conn lands at EXACTLY ``cap`` of the rescaled
    total ``T = W_uncapped / (1 − k·cap)`` and no uncapped conn exceeds
    it.  Returns ``(scales, infeasible)``; infeasible (every connection
    would cap — cap < 1/C with near-equal weights, or a single-conn
    federation) leaves all scales at 1.0 and is the caller's to count:
    a cap that cannot be satisfied must be visible, never silently
    half-applied.
    """
    scales = {k: 1.0 for k in weights}
    live = {k: w for k, w in weights.items() if w > 0}
    if not 0.0 < cap < 1.0 or not live:
        return scales, False
    if len(live) == 1:
        # the most hostile shape: ONE connection carried the whole
        # round (everyone else missed the deadline) — its fraction is
        # 1 > cap by definition and no rescaling can change that.
        # Infeasible, loudly: robust.cap_infeasible is the signal.
        return scales, True
    items = sorted(live.items(), key=lambda kv: (-kv[1], str(kv[0])))
    n = len(items)
    # m = size of the capped prefix; at least one connection must stay
    # uncapped or the rescaled total collapses to zero (cap < 1/C with
    # near-equal weights — no assignment can satisfy the cap)
    for m in range(n):
        if 1.0 - m * cap <= 0.0:
            return scales, True
        w_uncapped = sum(w for _, w in items[m:])
        total = w_uncapped / (1.0 - m * cap)
        # stable iff the largest uncapped conn fits under the cap and
        # the smallest capped one genuinely needed capping
        if items[m][1] > cap * total:
            continue
        if m > 0 and items[m - 1][1] <= cap * total:
            continue
        for k, w in items[:m]:
            scales[k] = (cap * total) / w
        return scales, False
    return scales, True  # every conn would cap: infeasible


def _params_of(tree: PyTree) -> PyTree:
    """The clippable/noisable collection: ``tree['params']`` when the
    variables dict has one (flax convention — BN running stats stay
    outside, the reference's ``vectorize_weight`` exclusion), else the
    whole tree."""
    if isinstance(tree, dict) and "params" in tree:
        return tree["params"]
    return tree


def _with_params(tree: PyTree, new_params: PyTree) -> PyTree:
    if isinstance(tree, dict) and "params" in tree:
        return {**tree, "params": new_params}
    return new_params


def _stack1(params: PyTree) -> PyTree:
    """One client's params as a stacked [1, ...] fp32 numpy tree — the
    host-side screening runs the SAME stacked formulas the compiled
    transform runs, at K=1."""
    return treelib.tree_map(
        lambda x: np.asarray(treelib.host_array(x), np.float32)[None], params
    )


def _cpu_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    return torch.from_numpy(np.array(x))


def _unstack1(stacked: PyTree, like: PyTree) -> PyTree:
    return treelib.tree_map(
        lambda s, l: treelib.cast_host_like(np.asarray(s[0]), l), stacked, like
    )


class RobustAggregator:
    """Per-federation defense state for ``FedAvgServerManager``.

    ``screen`` runs OUTSIDE the round lock on the decode path (pure
    numpy, O(model) — the same altitude as decode itself); the
    per-round counters it keeps are read + reset under ``note_round``
    at each close.  Connection attribution comes from the hub's
    ``conn_map`` introspection (``TcpBackend.request_conn_map``); nodes
    the map does not cover fall back to a per-node singleton connection
    — a v1 dialer IS its own physical conn.
    """

    _GUARDED_BY = {
        "_round_counts": "_lock",
        "_base_np_cache": "_lock",
    }

    def __init__(self, cfg: DefenseConfig, *, seed: int = 0):
        self.cfg = cfg
        self.seed = int(seed)
        self._seed_key = None  # built lazily: a threefry key, only if DP is on
        self._lock = threading.Lock()  # leaf lock: counters + caches
        self._round_counts = {"clipped": 0, "outliers": 0, "dp_noised": 0}
        self._conn_map: Dict[int, str] = {}
        self._conn_map_src = None  # identity of the last ingested raw map
        # (base object, fp32 numpy params) — see _base_np
        self._base_np_cache: Optional[tuple] = None

    # -- connection attribution ---------------------------------------------
    def set_conn_map(self, conns: Optional[dict]) -> None:
        """Ingest a hub ``conn_map`` reply: ``{cid: [node ids]}`` →
        node → ``conn<cid>``.  Identity-cached (the backend hands back
        the same parsed object until a fresh reply lands)."""
        if conns is None or conns is self._conn_map_src:
            return
        inv: Dict[int, str] = {}
        for cid, nodes in conns.items():
            for n in nodes:
                inv[int(n)] = f"conn{cid}"
        self._conn_map = inv
        self._conn_map_src = conns

    def conn_key(self, sender: int) -> str:
        return self._conn_map.get(int(sender), f"node{sender}")

    # -- per-upload screening (outside the round lock) ----------------------
    def screen(self, variables: PyTree, base: PyTree, *, round_idx: int,
               slot: int) -> Tuple[Optional[PyTree], dict]:
        """Clip / outlier-score / DP-transform ONE decoded upload
        against the broadcast base.  Returns ``(variables, flags)`` —
        the (possibly transformed) tree, or ``None`` for an outlier
        reject (the caller counts it through the standard reject path,
        never silently).  ``flags`` says what WOULD be counted
        (clipped/dp_noised); the caller feeds it to ``note_upload``
        AFTER its duplicate check, so a chaos-redelivered copy's screen
        work never double-counts the defense telemetry."""
        cfg = self.cfg
        tel = get_telemetry()
        flags = {"clipped": False, "dp_noised": False}
        params = _params_of(variables)
        base_params = _params_of(base)
        stacked = _stack1(params)
        base_np = self._base_np(base, base_params)
        norm = float(robustlib.param_delta_norms(
            base_np, stacked, xp=np
        )[0])
        tel.observe("robust.upload_norm", norm)
        if (cfg.outlier_mult > 0 and cfg.norm_bound > 0
                and norm > cfg.outlier_mult * cfg.norm_bound):
            with self._lock:
                self._round_counts["outliers"] += 1
            return None, flags
        changed = False
        # one clip at the TIGHTEST applicable bound (norm-difference
        # clipping composes: clip(clip(d, a), b) == clip(d, min(a, b))
        # up to a second fp multiply — one clip is the cleaner form).
        # Uploads already inside every bound pass through UNTOUCHED —
        # not even an fp32 rewrite — so an honest run under the
        # streaming defense stays byte-identical to the undefended one.
        bounds = []
        if cfg.defense == "streaming" and cfg.norm_bound > 0:
            bounds.append(cfg.norm_bound)
        if cfg.dp_clip > 0:
            # client-level DP sensitivity bound: after this clip no one
            # client's delta exceeds dp_clip in L2, so dp_noise has a
            # defined per-client sensitivity to hide
            bounds.append(cfg.dp_clip)
        if bounds and norm > min(bounds):
            stacked = robustlib.clip_stacked_params(
                base_np, stacked, min(bounds), xp=np
            )
            changed = True
            # counted whenever the clip actually FIRED — whether the
            # binding bound was the streaming norm_bound or dp_clip
            # (a mutation with zero telemetry would violate the
            # counted-never-silent discipline)
            flags["clipped"] = True
        if cfg.dp_noise > 0:
            if self._seed_key is None:
                self._seed_key = rnglib.PRNGKey(self.seed)
            key = robustlib.agg_noise_key(self._seed_key, round_idx, slot)
            # the torch noise draw on CPU tensors (JAX's draws bit for
            # bit), back to numpy for the stacked form
            noised = robustlib.noise_params(
                key, treelib.tree_map(_cpu_tensor, _unstack1(stacked, params)),
                cfg.dp_noise,
            )
            stacked = _stack1(noised)
            changed = True
            flags["dp_noised"] = True
        if not changed:
            return variables, flags
        return _with_params(variables, _unstack1(stacked, params)), flags

    def note_upload(self, flags: dict) -> None:
        """Count one ACCEPTED (non-duplicate) upload's defense activity
        — called by the server under its round lock after the duplicate
        check, so redelivered copies never inflate the telemetry."""
        tel = get_telemetry()
        with self._lock:
            if flags.get("clipped"):
                self._round_counts["clipped"] += 1
            if flags.get("dp_noised"):
                self._round_counts["dp_noised"] += 1
        if flags.get("clipped"):
            tel.inc("robust.clipped_uploads")
        if flags.get("dp_noised"):
            tel.inc("robust.dp_noised_uploads")

    def _base_np(self, base: PyTree, base_params: PyTree) -> PyTree:
        """The fp32 numpy view of the broadcast base, identity-cached
        per round: every upload of a round screens against the SAME
        base object, so K uploads share one conversion instead of
        paying K full-model copies on the decode workers."""
        with self._lock:
            if self._base_np_cache is not None \
                    and self._base_np_cache[0] is base:
                return self._base_np_cache[1]
        converted = treelib.tree_map(
            lambda x: np.asarray(treelib.host_array(x), np.float32), base_params
        )
        with self._lock:
            self._base_np_cache = (base, converted)
        return converted

    # -- round bookkeeping ---------------------------------------------------
    def note_round(self, *, capped: int = 0,
                   cap_infeasible: bool = False) -> dict:
        """Snapshot + reset this round's defense counts (called under
        the server's round lock at close); the returned dict rides the
        ``round_close`` record/event so per-round defense activity is
        visible next to participants and spans."""
        tel = get_telemetry()
        if capped:
            tel.inc("robust.capped_conns", capped)
        if cap_infeasible:
            tel.inc("robust.cap_infeasible")
        with self._lock:
            counts = dict(self._round_counts)
            for k in self._round_counts:
                self._round_counts[k] = 0
        counts["capped_conns"] = int(capped)
        if cap_infeasible:
            counts["cap_infeasible"] = True
        return counts

    # -- buffered close ------------------------------------------------------
    def buffered_center(self, entries: List[PyTree]) -> PyTree:
        """The robust params center over the buffered cohort — numpy
        host-side, same ``robust_center`` formula as the compiled
        transform (leaf-exactness vs a numpy oracle is pinned in
        ``tests/test_robust_agg.py``)."""
        stacked = treelib.tree_map(
            lambda *xs: np.stack([np.asarray(treelib.host_array(x), np.float32)
                                  for x in xs]),
            *[_params_of(v) for v in entries],
        )
        return robustlib.robust_center(
            self.cfg.defense, stacked, trim_frac=self.cfg.trim_frac, xp=np
        )

    def buffered_close(self, entries: List[PyTree],
                       norm_weights: List[float]) -> PyTree:
        """The buffered-mode aggregate: sample-weighted mean for every
        non-params collection (BN stats etc. — exactly the undefended
        close), params replaced by the robust center.  Weight-free by
        design: a Byzantine upload's fake sample count buys it nothing
        against a coordinate-wise estimator.  The weighted mean runs
        over the NON-params collections only — params would be thrown
        away in favor of the center, and for a params-only model the
        mean is the whole O(K·model) close stall."""
        center = self.buffered_center(entries)
        first = entries[0]
        cast = treelib.tree_map(
            lambda c, l: treelib.cast_host_like(np.asarray(c), l),
            center, _params_of(first),
        )
        if not (isinstance(first, dict) and "params" in first):
            return cast
        rest_keys = [k for k in first if k != "params"]
        if not rest_keys:
            return {"params": cast}
        mean_rest = treelib.tree_weighted_sum(
            [{k: e[k] for k in rest_keys} for e in entries], norm_weights
        )
        return {**mean_rest, "params": cast}
