"""The checked-in telemetry naming registry (``fedml_tpu/obs/
metric_schema.py``'s names, so a digest or status file reads the same
from either package, plus the series only the port's PyTorch hooks emit).

The port's runtime hooks (``obs/torch_hooks.py``) emit
``calls.new_signature`` / ``calls.new_signature_s`` and the
``new_signature`` event where the JAX hooks emit ``jax.compiles`` /
``jax.compile_s`` and ``compile`` (eager PyTorch compiles nothing; it
counts calls under a new shape signature), and ``torch.device_mem_*``
where they emit ``jax.device_mem_*``.  The JAX-only names stay registered
(a mixed federation's digests carry both) and are listed in
``JAX_ONLY``: the port never emits them.

Every counter/gauge/histogram series and every telemetry-event kind the
package emits is declared here, with its label set and one line of
meaning.  The ``metric-name`` linter (``fedml_tpu/analysis``) verifies
at CI time that every literal (and dynamic-pattern) name in code exists
here with the matching type — so a typo'd series fails the lint instead
of silently never aggregating — and PROFILE.md's metrics appendix cites
THIS module instead of maintaining a hand-copied table that drifts.

Conventions (``obs/telemetry.py``): rendered keys are
``name{label=value,...}`` with sorted labels; histograms are
log2-bucketed; names are ``<namespace>.<metric>``, cumulative gauges
carry a ``_total`` suffix, histogram names end in their unit (``_s``,
``_bytes``).

Stdlib-only, pure literals: the lint CI executes this file on a bare
interpreter, and the analysis fixtures exec it directly.
"""

from __future__ import annotations

# --- counters (monotonic; Telemetry.inc) ------------------------------------
COUNTERS = {
    "comm.sent_msgs": "messages sent {msg_type=}",
    "comm.sent_bytes": "exact wire bytes sent (tcp) / estimator (inproc) {msg_type=}",
    "comm.recv_msgs": "messages delivered to observers {msg_type=}",
    "comm.recv_bytes": "exact wire bytes received {msg_type=}",
    "comm.raw_bytes": "logical fp32 bytes of codec-encoded payloads {msg_type=}",
    "comm.compressed_bytes": "encoded bytes actually shipped {msg_type=}",
    "comm.unhandled_msgs": "frames with no registered handler {msg_type=}",
    "comm.send_retries": "bounded send retries after transient OSError {msg_type=}",
    "comm.send_failed": "sends abandoned after the retry budget {msg_type=}",
    "comm.reconnects": "hub re-dials by the auto-reconnect path",
    "comm.mcast_sends": "native multicast frames sent {msg_type=}",
    "comm.mcast_receivers": "receivers addressed by multicast frames {msg_type=}",
    "comm.stripe_frames": "mcast_stripe continuation frames received {msg_type=}",
    "comm.stripe_reassemblies": "striped logical frames reassembled + delivered {msg_type=}",
    "comm.stripe_aborts": "striped logical frames killed (gap/crc/overflow/stale/undecodable) {reason=,msg_type=}",
    "comm.mux_frames": "muxed broadcast copies received on a shared connection {msg_type=}",
    "comm.mux_deliveries": "local fan-out deliveries to co-located virtual nodes {msg_type=}",
    "comm.shm_frames": "frames whose payload rode the shared-memory lane {msg_type=}",
    "comm.shm_bytes": "payload bytes carried through shm ring slabs {msg_type=}",
    "comm.shm_fallbacks": "lane-eligible payloads shipped inline TCP instead {reason=}",
    "comm.delta_bcast_bytes": "encoded bytes of delta-mode broadcast payloads",
    "comm.delta_full_fallbacks": "delta-mode broadcasts that shipped the full model {reason=}",
    "comm.delta_resyncs": "full-resync requests after an inapplicable delta sync",
    "comm.shm_hub_copies": "laned inbound payloads the hub materialized instead of pinning {reason=}",
    "edge.folded_uploads": "uploads an edge hub folded into its partial aggregate",
    "edge.uplink_bytes": "wire bytes of E2S_PARTIAL frames an edge hub sent upstream",
    "edge.uplink_frames": "E2S_PARTIAL frames an edge hub sent upstream {reason=}",
    "edge.flat_fallbacks": "uploads an edge hub forwarded upstream raw instead of folding {reason=}",
    "edge.partials_folded": "E2S_PARTIAL frames the root folded into the round accumulator",
    "hub.mcast_frames": "mcast control frames fanned out by the hub {msg_type=}",
    "hub.dropped_frames": "frames to unregistered/dead/over-bound receivers {msg_type=}",
    "hub.node_rebinds": "node ids re-claimed by a newer connection (new conn wins)",
    "digest.sent": "telemetry digest frames emitted by this process's reporter",
    "digest.frames": "digest frames accepted + merged by the rollup",
    "digest.rejected": "digest frames rejected pre-merge {reason=}",
    "digest.dup_frames": "digest frames skipped: per-source seq did not advance",
    "slo.violations": "SLO objective violations {objective=}",
    "slo.evaluations": "SLO evaluation passes (one per closed round)",
    "faults.injected": "chaos-layer injections {action=,msg_type=}",
    "faults.observed": "tolerance-layer observations {kind=,msg_type=}",
    "robust.clipped_uploads": "uploads clipped against the broadcast base (norm bound or DP clip)",
    "robust.dp_noised_uploads": "uploads given client-level DP clip+noise",
    "robust.capped_conns": "connections rescaled by the contribution cap",
    "robust.cap_infeasible": "rounds where the conn cap was unsatisfiable (left unapplied, loudly)",
    "rounds.degraded": "rounds closed under the aggregation target",
    "async.cut_rounds": "async-mode round cuts (K arrivals or the cut deadline)",
    "async.stale_weighted_uploads": "in-window stale uploads folded at discounted weight",
    "async.discarded_weight": "sample weight removed by staleness discounts (sum (1-w)·n)",
    "async.folded_weight": "sample weight folded into async cuts (sum w·n)",
    "traffic.offline_rounds": "node-rounds skipped by traffic-model churn draws",
    "traffic.delayed_uploads": "uploads deferred by a traffic-model delay draw",
    "traffic.rebinds": "connection flaps (drop+redial) drawn by the traffic model",
    "traffic.straggler_draws": "heavy-tailed straggler delays drawn by the traffic model",
    "flight.dumps": "flight-recorder bundles written {trigger=}",
    "flight.dumps_suppressed": "dumps skipped by the per-trigger rate limit or a dump already in flight {trigger=}",
    "flight.dump_errors": "bundle writes that failed (fs errors; recording continues)",
    "hub.zero_copy_forwards": "laned frames enqueued as refcounted slab pins (no materialize copy) {msg_type=}",
    "shard.cohort_fallbacks": "muxed cohorts trained on the unsharded path {reason=}",
    "jax.compiles": "jit compilations per instrumented fn {fn=}",
    "jax.backend_compile_events": "runtime jax.monitoring compile events {event=}",
    "calls.new_signature": "calls under a new abstract signature per instrumented fn {fn=}",
}

# --- gauges (instantaneous, or cumulative with _total; gauge_set/max) --------
GAUGES = {
    "hub.tier": "aggregation-tree tier of this process's hub (0=root, 1=edge)",
    "hub.connections": "physical hub connections (== nodes for v1 dialers)",
    "hub.nodes": "registered node ids (>= connections under muxing)",
    "hub.send_queue_frames": "per-connection outbound queue depth {conn=}",
    "hub.send_queue_bytes": "per-connection outbound queue bytes {conn=}",
    "hub.conn_nodes": "node ids registered on a connection {conn=}",
    "hub.node_rebinds_total": "cumulative id rebinds (time series form)",
    "hub.backpressure_drops_total": "cumulative over-bound queue drops",
    "hub.shm_conns": "connections with an attached shared-memory lane",
    "hub.shm_frames_total": "cumulative frames the hub moved via shm lanes",
    "hub.shm_bytes_total": "cumulative payload bytes via shm lanes",
    "hub.shm_fallbacks_total": "cumulative hub-side lane fallbacks to inline TCP",
    "hub.mcast_frames_total": "cumulative mcast frames (time series form)",
    "hub.stripe_frames_total": "cumulative enqueued mcast stripes (time series form)",
    "hub.threads": "hub-owned OS threads (reactor: 1; threaded: accept + senders + readers)",
    "hub.open_fds": "descriptors the hub holds open (reactor: selector map size)",
    "jax.device_mem_bytes": "device memory in use {device=}",
    "jax.device_mem_peak_bytes": "high-water device memory {device=}",
    "torch.device_mem_bytes": "CUDA allocator bytes allocated now {device=}",
    "torch.device_mem_peak_bytes": "high-water CUDA allocator bytes {device=}",
    "digest.streams": "distinct digest source streams the rollup has seen",
    "clock.hub_offset_s": "estimated monotonic-clock offset to the hub {node=}",
    "clock.hub_rtt_s": "min round-trip of the clock-sync burst {node=}",
    "shard.mesh_dp": "dp (cohort) axis width of the partition-rule mesh",
    "shard.mesh_mp": "mp (model) axis width of the partition-rule mesh",
}

# --- histograms (log2-bucketed; Telemetry.observe) ---------------------------
HISTOGRAMS = {
    "comm.send_latency_s": "time inside send_message (serialize + write) {msg_type=}",
    "comm.handle_latency_s": "NodeManager handler time {msg_type=}",
    "span.agg_fold_s": "per-arrival streaming-aggregation fold",
    "span.decode_wait_s": "upload decode queue wait, reader submit -> pool pickup",
    "span.decode_s": "upload decode + finite-firewall scan (off the reader thread)",
    "span.encode_overlap_s": "next broadcast's off-thread encode+send span",
    "span.agg_s": "close-time aggregation (buffered mode / normalize)",
    "span.server_round_s": "server round wall time, open to close",
    "span.reconnect_s": "outage span, first EOF to re-registered",
    "robust.upload_norm": "L2 norm of each decoded upload's delta vs the broadcast base",
    "span.traced_round_s": "per-round synced seconds under trace_rounds",
    "slo.round_wall_s": "server round wall (open->close) — the SLO percentile source",
    "slo.round_bytes": "server-visible comm bytes folded per round (sent+recv delta)",
    "async.upload_staleness": "round gap r-b of each accepted async upload (0 = current)",
    "traffic.upload_delay_s": "per-upload delay the traffic model imposed",
    "jax.compile_s": "wall time of compile-triggering calls {fn=}",
    "jax.backend_compile_s": "runtime-reported compile durations {event=}",
    "flight.dump_write_s": "atomic flight-bundle write (snapshot + json + replace)",
    "lock.wait_s": "CheckedLock acquire block time past the flight threshold {lock=}",
    "hub.loop_lag_s": "reactor event-loop batch service time (time away from select)",
    "calls.new_signature_s": "wall time of calls under a new signature {fn=}",
}

# --- dynamic-name patterns ---------------------------------------------------
# an outermost MetricsLogger.span(name) emits f"span.{name}_s" for
# driver-defined span names (sample/pack/round/eval/...): any span.*_s
# is a histogram.  Spans nested in another (those inside a round) feed
# the round rows only.
METRIC_PATTERNS = {
    "span.*_s": "histogram",
}

# --- telemetry event kinds (Telemetry.event + MetricsLogger records) ---------
EVENTS = {
    "compile": "one jit compilation {fn, signature, seconds}",
    "new_signature": "first call under a new signature {fn, signature, n_signatures, seconds}",
    "trace": "profiler trace written {trace_dir}",
    "trace_rounds": "profiler round bracketing {trace_dir, per-round seconds}",
    "config": "the full experiment dataclass (MetricsLogger record)",
    "telemetry": "registry snapshot record (MetricsLogger.log_telemetry)",
    "resume": "checkpoint resume {round}",
    "degraded_round": "round closed under target {round, arrived, dropped}",
    "round_close": "round boundary {round, participants, t_open_m, t_close_m}",
    "hub_stats": "hub queue-depth/backpressure snapshot (1 s timer)",
    "clock_sync": "dial-handshake offset estimate {node, offset_s, rtt_s}",
    "trace_hop": "full per-message hop chain (receiver-side emission)",
    "mux_members": "muxer membership {muxer, nodes} — timeline track grouping",
    "slo_violation": "one failed SLO objective {round, objective, observed, threshold}",
    "flight_dump": "flight-recorder bundle written {trigger, reason, round, path, write_s}",
}

# registered for the JAX package's digests; the port never emits these
JAX_ONLY = {
    "series": frozenset({
        "jax.compiles", "jax.backend_compile_events", "jax.device_mem_bytes",
        "jax.device_mem_peak_bytes", "jax.compile_s", "jax.backend_compile_s",
    }),
    "events": frozenset({"compile"}),
}

# flat view used by the linter and by tools that just need existence
METRICS = {
    **{name: "counter" for name in COUNTERS},
    **{name: "gauge" for name in GAUGES},
    **{name: "histogram" for name in HISTOGRAMS},
}


def metric_type(name: str) -> str:
    """'counter' | 'gauge' | 'histogram' | '' for a series name (exact
    match first, then the dynamic patterns)."""
    kind = METRICS.get(name)
    if kind:
        return kind
    import fnmatch

    for pat, ptype in METRIC_PATTERNS.items():
        if fnmatch.fnmatchcase(name, pat):
            return ptype
    return ""
