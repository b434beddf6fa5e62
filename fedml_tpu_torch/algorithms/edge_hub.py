"""Edge-hub tier of the hierarchical aggregation tree (port of
``fedml_tpu/algorithms/edge_hub.py``).

The flat topology terminates EVERY connection on one root hub and folds
every upload on one server process: the root's work is O(connections)
on the socket side and O(uploads) on the fold side.  An
``EdgeHubManager`` splits both axes the way the reference's
``hierarchical``/``TurboAggregate`` families do: it runs a LOCAL
``TcpHub`` that terminates a slice of the federation's muxers/clients,
folds their uploads with the same O(1) streaming aggregation the root
runs (``core.tree.tree_fold_weighted`` — the identical fp64 num/den
arithmetic), and uplinks ONE pre-folded ``(sum n·model, sum n)`` pair
per round (``MSG_TYPE_E2S_PARTIAL``).  fp64 addition is exact at
training magnitudes, so the root adding partial sums reproduces the
flat fold BIT-FOR-BIT — the tree-vs-flat byte-identity pin.

Composition over the extra hop (each leg crossed exactly once per edge
link):

- **downlink**: the uplink connection registers every downstream node
  id (hello v2, ``comm/edge.EdgeUplinkBackend``), so the root hub's
  mcast dedup/mux wraps/stripes/shm lanes treat the edge like a muxer;
  the edge re-fans each broadcast to its own connections through its
  local hub, which stripes/lanes independently.
- **uplink**: model uploads fold locally; everything else (telemetry
  digests, resync requests, stats) forwards upstream verbatim with the
  origin sender preserved.  Resync replies (unicast S2C frames) forward
  downstream unchanged — recovery semantics stay root-authoritative.
- **fallback-to-flat**: an upload the edge cannot fold (no decode base
  after a restart, a stale/unknown round) forwards upstream RAW,
  counted (``edge.flat_fallbacks{reason=}``), never silently dropped —
  the root's own firewalls remain the authority on it.

Defense composition: per-upload screening (norm clip / outlier reject /
client-level DP) is a pure function of (upload, base, seed, round,
slot) and runs AT THE EDGE, identical to the flat run's screening.
Connection-cap grouping keeps the flat granularity by tagging each
partial with its edge-local connection group.  Buffered estimators
(median/trimmed-mean) need the raw per-client trees at the root and do
NOT compose — the constructor refuses them loudly.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict
from typing import Dict, Optional, Set

from fedml_tpu_torch.algorithms.fedavg_cross_device import (
    SERVER,
    UploadRejected,
    _owned,
    _to_host,
    decode_validated_upload,
    reconstruct_sync_model,
)
from fedml_tpu_torch.analysis.locks import assert_held, make_lock
from fedml_tpu_torch.comm.backend import NodeManager
from fedml_tpu_torch.comm.edge import EdgeUplinkBackend, mux_nodes
from fedml_tpu_torch.comm.message import (
    MSG_ARG_KEY_CONTRIBUTORS,
    MSG_ARG_KEY_MODEL_PARAMS,
    MSG_ARG_KEY_NUM_SAMPLES,
    MSG_ARG_KEY_ROUND_INDEX,
    MSG_TYPE_C2S_RESYNC,
    MSG_TYPE_C2S_SEND_MODEL,
    MSG_TYPE_C2S_SEND_STATS,
    MSG_TYPE_C2S_TELEMETRY,
    MSG_TYPE_E2S_PARTIAL,
    MSG_TYPE_S2C_FINISH,
    MSG_TYPE_S2C_INIT_CONFIG,
    MSG_TYPE_S2C_SYNC_MODEL,
    Message,
    tree_to_wire,
)
from fedml_tpu_torch.core import tree as treelib
from fedml_tpu_torch.obs import flight
from fedml_tpu_torch.obs.telemetry import get_telemetry


class _DownlinkIntake(NodeManager):
    """Handler shim on the UPLINK backend: broadcasts and unicast
    replies arriving from the root."""

    def __init__(self, edge: "EdgeHubManager", backend):
        self._edge = edge  # before super(): init registers handlers
        super().__init__(backend)

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(
            MSG_TYPE_S2C_INIT_CONFIG, self._edge._on_downlink_model)
        self.register_message_receive_handler(
            MSG_TYPE_S2C_SYNC_MODEL, self._edge._on_downlink_model)
        self.register_message_receive_handler(
            MSG_TYPE_S2C_FINISH, self._edge._on_finish)


class _LocalIntake(NodeManager):
    """Handler shim on the LOCAL backend (node 0 of the edge's own
    hub): the cohort's uplink traffic."""

    def __init__(self, edge: "EdgeHubManager", backend):
        self._edge = edge
        super().__init__(backend)

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(
            MSG_TYPE_C2S_SEND_MODEL, self._edge._on_upload)
        # non-model uplink traffic is transparent: forwarded upstream
        # with the origin sender preserved, so the root's stats plane
        # and resync protocol see exactly the flat topology's frames
        for mt in (MSG_TYPE_C2S_TELEMETRY, MSG_TYPE_C2S_RESYNC,
                   MSG_TYPE_C2S_SEND_STATS):
            self.register_message_receive_handler(
                mt, self._edge._forward_up)


class EdgeHubManager:
    """One edge hub: local ``TcpHub`` + local server endpoint (node 0)
    terminating a downstream cohort, an ``EdgeUplinkBackend`` to the
    root, and the partial-fold state machine between them.

    Threading: ``_on_upload``/decode-pool workers, the uplink reader
    (``_on_downlink_model``), and the local-deadline Timer share the
    round state under ``_fold_lock`` (declared in ``_GUARDED_BY``,
    enforced by fedlint's lock-discipline rule).  Partials are BUILT
    under the lock and SENT outside it, the server's send discipline.
    """

    _GUARDED_BY = {
        "_expected": "_fold_lock",
        "_reported": "_fold_lock",
        "_groups": "_fold_lock",
        "_flush_now": "_fold_lock",
        "_passthrough": "_fold_lock",
        "_inflight": "_fold_lock",
    }

    def __init__(
        self,
        uplink: EdgeUplinkBackend,
        local_backend,
        local_hub,
        template,
        *,
        round_timeout: Optional[float] = None,
        deadline_frac: float = 0.75,
        decode_workers: int = 0,
        defense=None,
        seed: int = 0,
        delta_base_window: int = 4,
        crash_at_round: Optional[int] = None,
    ):
        self._uplink = uplink
        self._local = local_backend
        self._hub = local_hub
        # the decode base lives on the host, as the root server's model
        # does: the edge's fold must be the root's flat fold bit for bit
        self._template = treelib.tree_map(_to_host, template)
        self._all_ids: Set[int] = set(uplink.node_ids)
        self.round_timeout = round_timeout
        # the edge's partial must reach the root BEFORE the root's own
        # deadline fires, so the local flush deadline is a fraction of
        # the round timeout (late locals still uplink as singleton
        # partials — the root's stale firewall is the authority)
        self.deadline_frac = max(0.1, min(0.95, float(deadline_frac)))
        self.seed = seed
        self.crash_at_round = crash_at_round
        from fedml_tpu_torch.robust import DefenseConfig, RobustAggregator

        if isinstance(defense, dict):
            defense = DefenseConfig(**defense)
        self.defense = defense if (defense is not None
                                   and defense.enabled) else None
        if self.defense is not None and self.defense.buffered:
            # median/trimmed-mean need every raw per-client tree at the
            # ROOT close; a pre-folded pair cannot feed them — refuse,
            # don't run undefended
            raise ValueError(
                "tree topology requires a streaming-composable defense "
                "(buffered median/trimmed_mean need raw uploads at the "
                "root — run those on the flat topology)"
            )
        self._robust = (RobustAggregator(self.defense, seed=seed)
                        if self.defense is not None else None)
        self._conn_cap = (self.defense.conn_cap
                          if self.defense is not None else 0.0)
        # round state (all under _fold_lock)
        self._fold_lock = make_lock("EdgeHubManager._fold_lock")
        self._round: Optional[int] = None
        self._base = None
        self._bases: "OrderedDict[int, object]" = OrderedDict()
        self._window = max(1, int(delta_base_window))
        self._passthrough = False
        self._expected: Set[int] = set()
        self._reported: Set[int] = set()
        # conn group (None = fused) -> [acc_tree, n_sum, {node: n}];
        # accumulates since the last flush — an edge may flush several
        # disjoint partials per round (ack groups, late stragglers)
        self._groups: Dict[Optional[str], list] = {}
        # dispatched-but-unsettled uploads (decode pool depth + inline
        # folds in progress).  NOT reset per round: every increment at
        # intake is balanced by exactly one decrement when the fold
        # settles (folded, stale, or rejected), even across a rollover
        self._inflight = 0
        self._flush_now = False
        self._deadline_timer: Optional[threading.Timer] = None
        self._finished = threading.Event()
        self.decode_workers = max(0, int(decode_workers))
        if self.decode_workers:
            from concurrent.futures import ThreadPoolExecutor

            self._decode_pool = ThreadPoolExecutor(
                max_workers=self.decode_workers,
                thread_name_prefix="edge-decode",
            )
        else:
            self._decode_pool = None
        self._downlink_mgr = _DownlinkIntake(self, uplink)
        self._local_mgr = _LocalIntake(self, local_backend)

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        if self._conn_cap > 0:
            # connection attribution for the cap grouping: the edge's
            # LOCAL hub is the authority on its cohort's physical
            # connections (same pre-run synchronous fetch as the root)
            fetch = getattr(self._local, "fetch_conn_map", None)
            if fetch is not None:
                self._robust.set_conn_map(fetch())
        self._local.run_in_thread()

    def run(self) -> None:
        """Block on the uplink reader until FINISH tears us down."""
        self._uplink.run()

    # -- downlink -----------------------------------------------------------
    def _on_downlink_model(self, msg: Message) -> None:
        nodes = mux_nodes(msg)
        if nodes is None and msg.receiver != -1:
            # unicast reply for one downstream node (a resync full
            # model): pure forward — recovery stays root-authoritative
            try:
                self._local.send_message(msg)
            except OSError:
                get_telemetry().inc("comm.send_failed",
                                    msg_type=msg.type)
                logging.warning(
                    "edge %d: could not forward %s down to node %d",
                    self._uplink.node_id, msg.type, msg.receiver,
                )
            return
        round_idx = msg.get(MSG_ARG_KEY_ROUND_INDEX)
        if (self.crash_at_round is not None and round_idx is not None
                and int(round_idx) == int(self.crash_at_round)):
            # chaos edge_hub_crash: die exactly like a crashed client
            # process — flight dump first (force: the black box's last
            # words ARE the point), then a hard non-zero exit
            import os

            flight.trigger("crash", round_idx=int(round_idx),
                           reason="chaos edge_hub crash", force=True)
            os._exit(137)
        leftovers = []
        with self._fold_lock:
            if round_idx is not None and round_idx != self._round:
                # round rollover: anything still unflushed belongs to
                # the PREVIOUS round — uplink it anyway (counted; the
                # root's stale firewall decides), then reset
                if any(ent[2] for ent in self._groups.values()):
                    leftovers = self._build_partials_locked("rollover")
                self._open_round_locked(msg, int(round_idx))
            self._expected.update(int(n) for n in (nodes or ()))
        # re-fan OUTSIDE the lock: the local hub stripes/lanes this to
        # the cohort independently — the broadcast crosses each tier's
        # wire exactly once
        targets = [int(n) for n in (nodes or sorted(self._all_ids))]
        try:
            self._local.send_multicast(msg, targets)
        except OSError:
            get_telemetry().inc("comm.send_failed", msg_type=msg.type)
            logging.warning(
                "edge %d: could not re-fan %s to %d local nodes (their "
                "round rides the deadlines)", self._uplink.node_id,
                msg.type, len(targets),
            )
        self._send_partials(leftovers)

    def _open_round_locked(self, msg: Message, round_idx: int) -> None:  # fedlint: holds=_fold_lock
        """Reset per-round state and reconstruct the decode base from
        the round's FIRST sync frame (later ack-group frames only
        extend ``_expected``)."""
        assert_held(self._fold_lock, "EdgeHubManager._open_round_locked")
        self._round = round_idx
        self._expected = set()
        self._reported = set()
        self._groups = {}
        self._flush_now = False
        self._passthrough = False
        try:
            variables, self._window = reconstruct_sync_model(
                msg, self._template, self._bases, self._window
            )
        except Exception:
            logging.exception("edge %d: sync reconstruction failed for "
                              "round %d", self._uplink.node_id, round_idx)
            variables = None
        if variables is None:
            # no decode base (delta against an uncached round after an
            # edge restart): this round runs in pass-through — every
            # upload forwards upstream raw, counted per upload.  The
            # base self-heals on the next full frame the root sends.
            self._base = None
            self._passthrough = True
            logging.warning(
                "edge %d: no decode base for round %d — pass-through "
                "(uploads forward upstream raw)", self._uplink.node_id,
                round_idx,
            )
        else:
            if msg.get("delta_window") is None:
                # plain full-mode frame: reconstruct returns views into
                # the transport buffer (only delta mode caches an owned
                # copy); the base must outlive this delivery scope
                variables = treelib.tree_map(_owned, variables)
            self._base = variables
        if self._robust is not None and self._conn_cap > 0:
            # refresh connection attribution once per round (async
            # reply, current by the first fold — the root's discipline)
            req = getattr(self._local, "request_conn_map", None)
            if req is not None:
                req()
        if self._deadline_timer is not None:
            self._deadline_timer.cancel()
        if self.round_timeout is not None:
            t = threading.Timer(
                self.deadline_frac * self.round_timeout,
                self._on_deadline, args=(round_idx,),
            )
            t.daemon = True
            self._deadline_timer = t
            t.start()

    def _on_deadline(self, round_gen: int) -> None:
        msgs = []
        with self._fold_lock:
            if round_gen != self._round:
                return  # stale timer: that round already rolled over
            self._flush_now = True  # late folds flush as singletons
            if any(ent[2] for ent in self._groups.values()):
                msgs = self._build_partials_locked("deadline")
        self._send_partials(msgs)

    def _on_finish(self, msg: Message) -> None:
        """Re-fan FINISH to the cohort, wait for it to drain, tear the
        tier down (runs on the uplink reader thread — blocking it is
        fine, the uplink's work is over)."""
        if self._finished.is_set():
            return
        self._finished.set()
        targets = [int(n) for n in (mux_nodes(msg)
                                    or sorted(self._all_ids))]
        try:
            self._local.send_multicast(msg, targets)
        except OSError:
            logging.warning("edge %d: could not re-fan FINISH",
                            self._uplink.node_id)
        # let the cohort receive FINISH and hang up before the local
        # hub dies under them (connections floor is our own node-0
        # endpoint); bounded — stragglers are the launcher's problem
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline:
            try:
                if self._hub.stats().get("connections", 0) <= 1:
                    break
            except Exception:
                break
            time.sleep(0.1)
        if self._deadline_timer is not None:
            self._deadline_timer.cancel()
        if self._decode_pool is not None:
            self._decode_pool.shutdown(wait=False)
        self._local.stop()
        self._hub.stop()
        self._uplink.stop()

    # -- uplink (cohort traffic) --------------------------------------------
    def _forward_up(self, msg: Message) -> None:
        """Transparent upstream forward preserving the origin sender —
        the root sees the flat topology's exact frame."""
        try:
            self._uplink._send_message_as(msg, msg.sender)
        except OSError:
            get_telemetry().inc("comm.send_failed", msg_type=msg.type)
            logging.warning(
                "edge %d: could not forward %s from node %d upstream",
                self._uplink.node_id, msg.type, msg.sender,
            )

    def _on_upload(self, msg: Message) -> None:
        reply_round = msg.get(MSG_ARG_KEY_ROUND_INDEX)
        tel = get_telemetry()
        with self._fold_lock:
            foldable = (self._round is not None
                        and reply_round is not None
                        and int(reply_round) == self._round
                        and not self._passthrough
                        and self._base is not None)
            if foldable and msg.sender in self._reported:
                # duplicate (chaos redelivery): the streaming fold
                # cannot un-fold the first copy — drop, counted, same
                # as the root's duplicate screen
                tel.inc("faults.observed", kind="duplicate_upload",
                        msg_type=MSG_TYPE_C2S_SEND_MODEL)
                return
            if foldable:
                self._reported.add(msg.sender)
                self._inflight += 1
                base = self._base
            else:
                # fallback-to-flat: counted, never silent — the raw
                # upload forwards upstream and the root's firewalls
                # (stale/corrupt/defense) remain the authority on it
                if self._round is None or reply_round is None:
                    reason = "no_round"
                elif self._passthrough or self._base is None:
                    reason = "no_base"
                else:
                    reason = "stale_round"
                self._reported.add(msg.sender)
        if not foldable:
            tel.inc("edge.flat_fallbacks", reason=reason)
            self._forward_up(msg)
            return
        if self._decode_pool is not None:
            unpin = msg.pin_payload()
            try:
                self._decode_pool.submit(
                    self._fold_upload_pinned, msg, base,
                    int(reply_round), unpin,
                )
            except RuntimeError:
                # pool already shut down (FINISH teardown raced a
                # straggler): settle the dispatch so the inflight
                # count stays balanced
                unpin()
                self._note_upload_done()
            return
        self._fold_upload(msg, base, int(reply_round))

    def _fold_upload_pinned(self, msg, base, reply_round, unpin) -> None:
        try:
            self._fold_upload(msg, base, reply_round)
        finally:
            unpin()

    def _fold_upload(self, msg: Message, base, reply_round: int) -> None:
        try:
            self._fold_upload_inner(msg, base, reply_round)
        except Exception:
            logging.exception("edge %d: upload decode/fold failed for "
                              "node %d", self._uplink.node_id, msg.sender)
            self._reject(msg.sender, "undecodable_upload")
        finally:
            # EVERY dispatched upload settles here — folded, stale, or
            # rejected — which is where the flush decision lives
            self._note_upload_done()

    def _fold_upload_inner(self, msg: Message, base,
                           reply_round: int) -> None:
        t0 = time.perf_counter()
        try:
            # THE shared intake (fedavg_cross_device): same decode,
            # same delta semantics, same non-finite firewall as the
            # root — a bad upload dies at this tier, counted the same
            variables, n = decode_validated_upload(msg, base)
        except UploadRejected as bad:
            self._reject(msg.sender, bad.kind)
            return
        defense_flags = None
        group: Optional[str] = None
        if self._robust is not None:
            # per-upload screening is a pure function of (upload, base,
            # seed, round, slot) — bit-identical to the flat run's
            screened, defense_flags = self._robust.screen(
                variables, base, round_idx=reply_round,
                slot=msg.sender - 1,
            )
            if screened is None:
                self._reject(msg.sender, "outlier_upload")
                return
            variables = screened
            if self._conn_cap > 0:
                fn = getattr(self._local, "conn_map", None)
                if callable(fn):
                    self._robust.set_conn_map(fn())
                group = self._robust.conn_key(msg.sender)
        tel = get_telemetry()
        tel.observe("span.decode_s", time.perf_counter() - t0)
        with self._fold_lock:
            if self._round != reply_round:
                # round rolled over while decoding: too late to fold —
                # counted as a stale observation, the root's deadline
                # accounting already gave up on this reporter
                tel.inc("faults.observed", kind="stale_upload",
                        msg_type=MSG_TYPE_C2S_SEND_MODEL)
                return
            ent = self._groups.setdefault(group, [None, 0.0, {}])
            t1 = time.perf_counter()
            # the SAME fp64 fold the root runs on raw uploads — this
            # accumulator IS the flat fold restricted to this cohort,
            # which is what makes the uplinked num/den compose exactly
            ent[0] = treelib.tree_fold_weighted(ent[0], variables, n)
            ent[1] += float(n)
            ent[2][msg.sender] = float(n)
            tel.observe("span.agg_fold_s", time.perf_counter() - t1)
            if self._robust is not None:
                self._robust.note_upload(defense_flags)
            tel.inc("edge.folded_uploads")

    def _note_upload_done(self) -> None:
        """Flush decision, taken when the intake PIPELINE drains — not
        at intake time.  ``_reported`` fills as fast as frames arrive
        while the decode pool is still working, so flushing on
        reported-set coverage alone emits one premature "complete"
        partial plus a singleton "late" cascade for everything still
        in the pool: O(cohort) uplink frames, the exact cost this tier
        exists to remove.  Waiting for ``_inflight == 0`` batches the
        round into O(conn groups) partials and also covers the
        last-upload-rejected case (a reject settles the pipeline and
        releases whatever DID fold)."""
        msgs = []
        with self._fold_lock:
            self._inflight -= 1
            if self._inflight > 0:
                return
            have = any(ent[2] for ent in self._groups.values())
            if self._flush_now:
                if have:
                    msgs = self._build_partials_locked("late")
            elif (have and self._expected
                    and self._reported >= self._expected):
                msgs = self._build_partials_locked("complete")
        self._send_partials(msgs)

    def _reject(self, sender: int, kind: str) -> None:
        """Edge twin of the root's ``_reject_upload``: counted on the
        same series, black-boxed, excluded from the partial."""
        get_telemetry().inc("faults.observed", kind=kind,
                            msg_type=MSG_TYPE_C2S_SEND_MODEL)
        flight.note("faults", "observed", what=kind, sender=sender)
        flight.trigger("reject", round_idx=self._round or 0,
                       reason=f"{kind} from node {sender} (edge tier)")
        logging.warning(
            "edge %d: rejected %s from node %d (excluded from the "
            "partial)", self._uplink.node_id, kind, sender,
        )

    # -- partial flush ------------------------------------------------------
    def _build_partials_locked(self, reason: str) -> list:  # fedlint: holds=_fold_lock
        """Materialize every non-empty accumulator group as one
        E2S_PARTIAL message and reset them (caller holds the fold
        lock; the SEND happens outside it)."""
        assert_held(self._fold_lock,
                    "EdgeHubManager._build_partials_locked")
        msgs = []
        for group in sorted(self._groups, key=lambda g: (g is None, g or "")):
            acc, n_sum, contrib = self._groups[group]
            if not contrib:
                continue
            m = Message(MSG_TYPE_E2S_PARTIAL, self._uplink.node_id,
                        SERVER)
            # fp64 leaves survive the v2 wiretree dtype-preserving —
            # the root decodes against an fp64 template, so the
            # accumulator crosses the wire bit-exactly
            m.add_params(MSG_ARG_KEY_MODEL_PARAMS, tree_to_wire(acc))
            m.add_params(MSG_ARG_KEY_NUM_SAMPLES, float(n_sum))
            m.add_params(MSG_ARG_KEY_ROUND_INDEX, self._round)
            m.add_params(MSG_ARG_KEY_CONTRIBUTORS,
                         {str(k): float(v)
                          for k, v in sorted(contrib.items())})
            if group is not None:
                # cap grouping at flat granularity: the root keys its
                # per-conn accumulator by this tag
                m.add_params("conn_group",
                             f"edge{self._uplink.node_id}:{group}")
            msgs.append((m, reason))
        self._groups = {}
        if reason in ("complete", "deadline"):
            # the round's main flush happened: any later local
            # straggler uplinks immediately as a singleton partial
            self._flush_now = True
        return msgs

    def _send_partials(self, msgs: list) -> None:
        if not msgs:
            return
        tel = get_telemetry()
        for m, reason in msgs:
            try:
                self._uplink.send_message(m)
            except OSError:
                tel.inc("comm.send_failed",
                        msg_type=MSG_TYPE_E2S_PARTIAL)
                logging.warning(
                    "edge %d: could not uplink partial (%s, round %s) — "
                    "the root's deadline covers the cohort",
                    self._uplink.node_id, reason,
                    m.get(MSG_ARG_KEY_ROUND_INDEX),
                )
                continue
            tel.inc("edge.uplink_frames", reason=reason)
            try:
                tel.inc("edge.uplink_bytes",
                        sum(len(p) for p in m.to_frame_parts()))
            except Exception:
                pass
            flight.note("edge", "partial_uplinked", reason=reason,
                        round_idx=m.get(MSG_ARG_KEY_ROUND_INDEX),
                        contributors=len(
                            m.get(MSG_ARG_KEY_CONTRIBUTORS) or {}))

    # -- introspection ------------------------------------------------------
    def stats(self) -> dict:
        snap = get_telemetry().snapshot()["counters"]
        return {
            "folded_uploads": sum(
                v for k, v in snap.items()
                if k.startswith("edge.folded_uploads")),
            "uplink_frames": sum(
                v for k, v in snap.items()
                if k.startswith("edge.uplink_frames")),
            "uplink_bytes": sum(
                v for k, v in snap.items()
                if k.startswith("edge.uplink_bytes")),
            "flat_fallbacks": sum(
                v for k, v in snap.items()
                if k.startswith("edge.flat_fallbacks")),
        }
