"""Cross-device FedAvg over the host message plane (port of
``fedml_tpu/algorithms/fedavg_cross_device.py``).

This is the rebuild of the reference's distributed FedAvg
choreography (SURVEY.md §3.1): ``FedAvgServerManager`` /
``FedAvgClientManager`` exchanging INIT_CONFIG / SEND_MODEL /
SYNC_MODEL messages (``FedAvgServerManager.py:20-103``,
``FedAvgClientManager.py:18-75``) — for the loosely-coupled setting
where participants are NOT chips on one slice (the MQTT/mobile role).
Compute still runs through the same local-update operator as the
simulation (``core/client.py``, on the client's device: ResNet-56 with
``conv_variant="kernel"`` runs the Hopper conv on every step); only
coordination travels as messages, over any ``CommBackend`` (the
in-process bus, or the TCP hub of ``comm/tcp.py``; as processes,
``experiments/distributed_fedavg.py``).

Where the numbers live:

- the server's model, its float64 streaming accumulator, the decode of
  uploads, the robust screening and the broadcast chain are host numpy,
  as in the JAX package (``core/tree.py::tree_fold_weighted``: a host
  add must not pay a device dispatch).  The server never holds a card
  tensor, so its decode workers, deadline timer and encode thread read
  no tensor another thread made;
- a client decodes its sync onto its device, trains there, and copies
  the trained model to the host (``.cpu()`` on its own handler thread,
  which waits for the card) before it encodes the upload.  The delta
  ``new - synced`` is float32 on the host, and the codecs' keys are the
  port's threefry in JAX's order, so the encoded wire is the JAX
  package's byte for byte given the same trees.

Trees are the port's variable dicts (a dotted key is a flax path) or
nested dicts; every wire, sum over leaves and per-leaf key follows JAX's
leaf order (``compress.codecs.jax_leaves``).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from fedml_tpu_torch.analysis.locks import assert_held, make_lock
from fedml_tpu_torch.comm.backend import CommBackend, NodeManager
from fedml_tpu_torch.comm.message import (
    MSG_ARG_KEY_CLIENT_INDEX,
    MSG_ARG_KEY_CONTRIBUTORS,
    MSG_ARG_KEY_DELTA_BASE,
    MSG_ARG_KEY_LOCAL_METRICS,
    MSG_ARG_KEY_MODEL_PARAMS,
    MSG_ARG_KEY_NUM_SAMPLES,
    MSG_ARG_KEY_ROUND_INDEX,
    MSG_TYPE_C2S_RESYNC,
    MSG_TYPE_C2S_SEND_MODEL,
    MSG_TYPE_C2S_TELEMETRY,
    MSG_TYPE_E2S_PARTIAL,
    MSG_TYPE_S2C_FINISH,
    MSG_TYPE_S2C_INIT_CONFIG,
    MSG_TYPE_S2C_SYNC_MODEL,
    WIRETREE_KEY,
    Message,
    tree_from_wire,
    tree_is_delta,
    tree_to_wire,
)
from fedml_tpu_torch.core import rng as rnglib
from fedml_tpu_torch.core import tree as treelib

# envelope key for codec negotiation: the server announces the uplink
# codec on S2C_INIT_CONFIG/S2C_SYNC_MODEL; clients echo it on their
# C2S_SEND_MODEL wiretree ("codec" + "delta" inside the wire pytree).
# Absent key = legacy fp32 full-model uploads — old peers interop.
MSG_ARG_KEY_CODEC = "codec"
from fedml_tpu_torch.compress.codecs import jax_leaves
from fedml_tpu_torch.core.client import LocalUpdateFn
from fedml_tpu_torch.core.staleness import STALENESS_POLICIES, staleness_weight
from fedml_tpu_torch.core.types import FedDataset, pack_clients
from fedml_tpu_torch.obs import flight
from fedml_tpu_torch.obs.telemetry import get_telemetry
from fedml_tpu_torch.utils.device import DeviceLike, resolve_device

SERVER = 0


# --- host views of leaves -----------------------------------------------------

def _host_f32(x) -> np.ndarray:
    """A leaf as a float32 host array (what ``np.asarray(x, np.float32)``
    gives in the JAX package); a card tensor is copied on the calling
    thread, which waits for the card."""
    return np.asarray(treelib.host_array(x), np.float32)


def _to_host(x):
    """A leaf as the server keeps it: a numpy array, or a CPU tensor for a
    bfloat16 leaf (numpy has no bfloat16)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        return t if t.dtype == torch.bfloat16 else t.numpy()
    return np.asarray(x)


def _owned(x):
    """An owned copy of a leaf (a decoded numpy leaf is a read-only view
    into its frame)."""
    return x.clone() if isinstance(x, torch.Tensor) else np.array(x, copy=True)


def _nbytes(v) -> int:
    if isinstance(v, torch.Tensor):
        return v.numel() * v.element_size()
    return int(np.asarray(v).nbytes)


def _all_finite(tree) -> bool:
    return all(np.isfinite(treelib.host_array(l)).all()
               for _, l in jax_leaves(tree))


def encode_client_upload(codec_name: str, new_vars, synced_vars, template,
                         *, seed: int, round_idx: int, slot: int, ef=None):
    """Build one client's upload wiretree — THE shared encode for the
    single-process client manager and the muxer's vmapped cohort engine
    (``algorithms/fedavg_mux``), so the two paths cannot drift and
    muxed-vs-per-process uploads stay byte-identical by construction.

    No codec: the full-precision v2 wiretree.  With a codec: the
    codec-encoded DELTA (trained - synced), the error-feedback residual
    folded in and the new quantization error absorbed back into ``ef``.
    The encode key is the engine's exact compression stream —
    ``fold_in(fold_in(fold_in(seed_key, round), COMPRESS_STREAM),
    slot)`` — so encoded bytes are a pure function of
    (seed, round, slot): bit-identical across processes, muxers, and
    re-runs.

    Returns ``(wire, raw_nbytes, encoded_nbytes)`` — the byte pair is
    ``(None, None)`` on the uncompressed path (nothing was encoded).
    ``template`` keeps JAX's signature: the EF decode here runs against
    the host delta, whose structure it shares.
    """
    from fedml_tpu_torch.compress import COMPRESS_STREAM, get_codec

    codec = get_codec(codec_name)
    if codec is None:
        return tree_to_wire(new_vars), None, None
    # the float32 delta on the host (CPU tensors: the codecs' input)
    delta = treelib.tree_map(
        lambda n, s: torch.from_numpy(_host_f32(n) - _host_f32(s)),
        new_vars, synced_vars,
    )
    if ef is not None:
        delta = ef.fold_in(delta)
    k_round = rnglib.fold_in(rnglib.PRNGKey(seed), round_idx)
    key = rnglib.fold_in(rnglib.fold_in(k_round, COMPRESS_STREAM), slot)
    wire = tree_to_wire(delta, codec=codec, key=key, delta=True)
    if ef is not None:
        # decoded against the host delta (the template's structure; a
        # codec decodes to float32 whatever the template's dtype)
        ef.absorb(delta, tree_from_wire(wire, delta))
    raw = sum(l.numel() * 4 for _, l in jax_leaves(delta))
    comp = sum(_nbytes(v) for leaf in wire["leaves"] for v in leaf["enc"].values())
    return wire, raw, comp


def ef_for(store: dict, key, codec_name: str, enabled: bool):
    """One error-feedback residual per uplink stream (client / virtual
    client), created lazily and ONLY when a lossy codec is negotiated —
    the single gating rule both the per-process manager and the muxer
    use.  Gating drift between the two call sites would silently break
    muxed-vs-per-process byte-identity, so it lives here, next to the
    shared encode."""
    from fedml_tpu_torch.compress import ErrorFeedback, get_codec

    if not enabled or get_codec(codec_name) is None:
        return None
    ef = store.get(key)
    if ef is None:
        ef = store[key] = ErrorFeedback()
    return ef


def apply_bcast_delta(base_tree, delta_tree):
    """ONE addition formula for the delta-broadcast chain, shared by
    the server (advancing its canonical model), the per-process client,
    and the muxer's cohort manager.  The chain's byte-identity claim —
    every receiver reconstructs EXACTLY the model the server holds,
    and a delta run's final model equals a full-broadcast run's at the
    same chain codec — rests on all ends computing ``base + delta``
    with the same ops in the same order, so the formula lives here,
    once: fp32 add, cast back to the base leaf's dtype.  A tensor base
    (a client's model on its device) adds on its device; IEEE addition
    rounds the same there as numpy does on the host."""

    def add(b, d):
        if isinstance(b, torch.Tensor):
            d = d if isinstance(d, torch.Tensor) else torch.from_numpy(np.asarray(d))
            return (b.float() + d.to(b.device).float()).to(b.dtype)
        return np.asarray(np.asarray(b, np.float32) + _host_f32(d),
                          np.asarray(b).dtype)

    return treelib.tree_map(add, base_tree, delta_tree)


def encode_bcast_delta(codec_name: str, update_tree, *, seed: int,
                       round_idx: int) -> dict:
    """Encode one chain update as a delta-flagged wiretree.  ``qsgd8``
    (the default) is the int8 lever; ``none`` ships raw fp32 leaves
    (the lossless arm — same bytes as full, proves the protocol).  The
    encode key is the dedicated broadcast stream
    ``fold_in(fold_in(seed_key, round), BCAST_STREAM)`` — disjoint from
    every per-client upload stream, and a pure function of
    (seed, round): the encoded bytes are bit-identical across re-runs,
    which is what lets the server decode ITS OWN encoding and adopt the
    reconstruction as the canonical next model."""
    from fedml_tpu_torch.compress import BCAST_STREAM, get_codec

    codec = get_codec(codec_name)
    if codec is None:
        return {
            WIRETREE_KEY: 2, "codec": "none", "delta": True,
            "leaves": [np.ascontiguousarray(_host_f32(l))
                       for _, l in jax_leaves(update_tree)],
        }
    k_round = rnglib.fold_in(rnglib.PRNGKey(seed), round_idx)
    key = rnglib.fold_in(k_round, BCAST_STREAM)
    # the codec encodes CPU tensors; tree_to_wire's codec form is the
    # same {wiretree, codec, delta, leaves} envelope, bf16 payloads named
    # "bfloat16" as JAX ships them
    update = treelib.tree_map(lambda l: torch.from_numpy(_host_f32(l)),
                              update_tree)
    return tree_to_wire(update, codec=codec, key=key, delta=True)


def reconstruct_sync_model(msg: Message, template, bases,
                           window: int):
    """THE shared receive-side half of the delta broadcast — used by
    the per-process client AND the muxer's cohort manager, so the
    reconstruction/caching steps (like the addition formula above)
    cannot drift between topologies.

    Full frames decode directly; delta frames apply the shipped chain
    updates in order onto the cached base.  When the server announces
    delta mode (``delta_window`` param), the round's model is cached in
    ``bases`` (ordered round -> model, evicted beyond window+1) as
    OWNED arrays: the full-frame decode yields views into a transport
    buffer (an shm slab region is reclaimed when delivery ends), so
    that path copies; the delta path's ``apply_bcast_delta`` output is
    freshly allocated already and is cached as-is.

    Returns ``(variables, window)`` — ``variables`` is None when the
    delta's base is not cached (the caller requests a resync), and
    ``window`` echoes the announced cache depth (or the one passed
    in)."""
    base_round = msg.get(MSG_ARG_KEY_DELTA_BASE)
    round_idx = msg.get(MSG_ARG_KEY_ROUND_INDEX)
    payload = msg.get(MSG_ARG_KEY_MODEL_PARAMS)
    if base_round is None:
        variables = tree_from_wire(payload, template)
        aliased = True  # np views into the frame's transport buffer
    else:
        base = bases.get(base_round)
        if base is None:
            return None, window
        variables = base
        for wire in payload or []:
            variables = apply_bcast_delta(
                variables, tree_from_wire(wire, template)
            )
        # fp32 add + cast allocated fresh arrays (an empty delta list
        # degenerates to the cached — already owned — base itself)
        aliased = False
    announced = msg.get("delta_window")
    if announced is not None:
        window = max(int(announced), 1)
        if aliased:
            variables = treelib.tree_map(_owned, variables)
        bases[round_idx] = variables
        while len(bases) > window + 1:
            bases.popitem(last=False)
    return variables, window


def request_resync(send, node_id: int, round_idx) -> None:
    """THE shared resync request (the send-side twin of
    ``reconstruct_sync_model``'s None return): one C2S_RESYNC frame
    echoing the round whose delta base was missing.  Per-process
    clients and the muxer's cohort walkback both build the request
    HERE, so a protocol change (an extra param, a renamed key) cannot
    desynchronize the two topologies' recovery paths."""
    resync = Message(MSG_TYPE_C2S_RESYNC, node_id, SERVER)
    resync.add_params(MSG_ARG_KEY_ROUND_INDEX, round_idx)
    send(resync)


class UploadRejected(Exception):
    """A client upload failed the decode or the non-finite firewall.
    ``kind`` is the canonical ``faults.observed{kind=}`` label."""

    def __init__(self, kind: str):
        super().__init__(kind)
        self.kind = kind


def decode_validated_upload(msg: Message, base):
    """THE shared upload intake — the root server's decode path AND the
    edge hub's (``algorithms/edge_hub``), so the two tiers cannot drift:
    an upload the root would have rejected must never survive by hiding
    inside an edge partial, and vice versa.

    Decodes the wire payload against ``base`` (applying delta-upload
    semantics), then runs the corrupt-payload firewall: one NaN leaf
    folded into the weighted sum would poison the global model for
    every round after, at either tier.

    Returns ``(variables, n)``; raises :class:`UploadRejected` with the
    canonical fault kind on any bad upload."""
    try:
        payload = msg.get(MSG_ARG_KEY_MODEL_PARAMS)
        variables = tree_from_wire(payload, base)
        if tree_is_delta(payload):
            # codec-encoded UPDATE: decoded leaves are fp32 deltas; the
            # upload's model is base + delta (what the client's
            # error-feedback recurrence assumes the aggregator sees)
            variables = treelib.tree_map(
                lambda b, d: _host_f32(b) + _host_f32(d), base, variables,
            )
    except Exception as e:
        # an undecodable payload (truncated/garbled frame) is a fault
        # observation, not an aggregator crash
        raise UploadRejected("undecodable_upload") from e
    n = msg.get(MSG_ARG_KEY_NUM_SAMPLES)
    if n is None or not np.isfinite(n) or n <= 0 or not _all_finite(variables):
        raise UploadRejected("corrupt_upload")
    return variables, float(n)


def bcast_wire_nbytes(wire: dict) -> int:
    """Encoded payload bytes of one broadcast wire (codec enc arrays,
    or raw leaves for the ``none`` arm) — what
    ``comm.delta_bcast_bytes`` counts."""
    total = 0
    for leaf in wire.get("leaves") or []:
        if isinstance(leaf, dict) and "enc" in leaf:
            total += sum(_nbytes(v) for v in leaf["enc"].values())
        else:
            total += _nbytes(leaf)
    return total


class FedAvgServerManager(NodeManager):
    """Rank-0 coordinator: sample → broadcast → collect → aggregate.

    Straggler tolerance (beyond the reference, whose server waits
    forever and whose only failure path is ``MPI.COMM_WORLD.Abort()``,
    ``server_manager.py:55-58``): with ``round_timeout`` set, a round
    that hasn't gathered its full cohort by the deadline aggregates
    with whoever arrived — the sample-weighted average is well-defined
    over any non-empty subset, exactly the compiled engine's
    participation-mask semantics (``core/sampling.py inject_dropout``) —
    and the dropouts are logged.  Replies carry their round index, so a
    straggler's late upload from a closed round is discarded instead of
    corrupting the next aggregation.

    Threading: ``_on_model`` runs on the backend reader thread, the
    deadline on a Timer thread, ``start`` on the caller's — the round
    state they share is declared in ``_GUARDED_BY`` below and enforced
    by the fedlint lock-discipline rule (methods the callers enter with
    the lock already held carry ``# fedlint: holds=_round_lock`` and
    verify it at runtime via ``locks.assert_held``).

    Fault tolerance on top of that (the chaos-layer contract,
    ``fedml_tpu/faults``):

    - ``spares`` over-samples the cohort: ``clients_per_round + spares``
      nodes get the sync and the round closes at the FIRST
      ``clients_per_round`` uploads (or at the deadline with whoever
      arrived).  The sample-weighted average renormalizes over the
      realized reporters, so no weight correction is needed — spares
      that report after the close are stale-rejected like any late
      frame.
    - uploads carrying non-finite parameters or weights (a corrupted
      payload) are rejected BEFORE aggregation and counted
      (``faults.observed{kind=corrupt_upload}``) — one flipped frame
      must not NaN-poison the global model.
    - degraded rounds (closed by deadline missing reporters, or with
      nobody at all) increment the same ``rounds.degraded`` counter the
      simulation drivers use — ONE series for both transports and both
      execution modes (the unified deadline semantics).

    These semantics are transport-independent: the deadline timer,
    stale rejection, and degraded accounting behave identically over
    the inproc bus and the TCP hub (pinned by ``tests/test_comm.py``
    and ``tests/test_faults.py``).
    """

    # reader-thread / timer-thread shared round state.  round_idx and
    # variables are deliberately NOT listed: both are written only
    # under the lock, but read on pre-thread paths (start) and in
    # lock-held helper chains the lexical checker cannot follow — the
    # holds= contracts on the mutating methods cover them.
    _GUARDED_BY = {
        "pending": "_round_lock",
        "_acked": "_ack_lock",
        "_delta_log": "_ack_lock",
        "_model_log": "_round_lock",
        "_agg_acc": "_round_lock",
        "_agg_n": "_round_lock",
        "_conn_acc": "_round_lock",
        "_conn_n": "_round_lock",
        "round_log": "_round_lock",
        "rejected_uploads": "_round_lock",
        "zero_participant_rounds": "_round_lock",
        "_last_decode_wait_s": "_round_lock",
        "_last_decode_s": "_round_lock",
        "_bcast_task_s": "_round_lock",
        "_bytes_mark": "_round_lock",
    }

    def __init__(
        self,
        backend: CommBackend,
        init_variables,
        *,
        num_clients: int,
        clients_per_round: int,
        comm_rounds: int,
        seed: int = 0,
        steps_per_epoch: Optional[int] = None,
        round_timeout: Optional[float] = None,
        spares: int = 0,
        codec: str = "none",
        multicast: bool = True,
        streaming_agg: bool = True,
        decode_workers: int = 0,
        stats_plane: bool = True,
        slo_spec=None,
        status_dir: Optional[str] = None,
        stats_interval: float = 1.0,
        defense=None,
        bcast: str = "full",
        bcast_codec: str = "",
        delta_base_window: int = 4,
        round_mode: str = "sync",
        cut_size: int = 0,
        max_staleness: int = 2,
        stale_policy: str = "poly",
        stale_alpha: float = 0.5,
    ):
        from fedml_tpu_torch.compress import get_codec

        # the model stays on the host (numpy; a bf16 leaf as a CPU tensor)
        init_variables = treelib.tree_map(_to_host, init_variables)
        # uplink compression negotiation: broadcast messages carry the
        # codec name; clients encode their update delta with it and the
        # server decodes before the exact fp32 weighted average (the
        # renormalization over realized reporters is unchanged — decode
        # happens BEFORE aggregation, so the average itself stays exact)
        self.codec_name = codec or "none"
        self._codec = get_codec(self.codec_name)

        # cohort-wide pack geometry: shipped to clients so a client's
        # fixed-shape pack is IDENTICAL to its slice of the simulation's
        # cohort pack (heterogeneous sizes would otherwise change batch
        # counts and, with stateful optimizers, the trajectory)
        self.steps_per_epoch = steps_per_epoch
        self.variables = init_variables
        self.num_clients = num_clients
        self.clients_per_round = min(clients_per_round, num_clients)
        # over-sampling: broadcast to K + spares nodes, aggregate the
        # first K reporters (or whoever beat the deadline) — the
        # FL-at-scale system design's straggler hedge
        self.spares = max(0, int(spares))
        self.broadcast_size = min(
            self.clients_per_round + self.spares, num_clients
        )
        self.comm_rounds = comm_rounds
        self.seed = seed
        self.round_idx = 0
        # wire hot-path knobs (both default ON; the legacy settings are
        # the measurement baseline arm and the old-peer compat mode):
        # - multicast: ONE shared sync envelope per round fanned out by
        #   the transport (hub mcast frame on tcp, per-receiver clones
        #   elsewhere) instead of K per-node re-encoded unicasts;
        # - streaming_agg: uploads fold into a running (sum n·model,
        #   sum n) accumulator on arrival — pending holds metadata
        #   only, peak memory O(model) instead of O(K·model), and the
        #   close-time aggregation stall collapses to one normalize.
        self.multicast = bool(multicast)
        self.streaming_agg = bool(streaming_agg)
        # robust aggregation (fedml_tpu/robust): per-upload screening
        # (norm clip / outlier reject / client-level DP) on the decode
        # path, per-CONNECTION contribution caps on the streaming fold,
        # and the buffered median/trimmed-mean close.  ``defense`` is a
        # DefenseConfig (or its dict form, or None = undefended — the
        # exact pre-defense code path, byte-identical).
        from fedml_tpu_torch.robust import DefenseConfig, RobustAggregator

        if isinstance(defense, dict):
            defense = DefenseConfig(**defense)
        self.defense = defense if (defense is not None
                                   and defense.enabled) else None
        self._robust = (RobustAggregator(self.defense, seed=seed)
                        if self.defense is not None else None)
        # buffered estimators need ALL K uploads at close — they buffer
        # decoded trees like the legacy path even when streaming_agg is
        # on (memory O(K·model) is inherent to a coordinate-wise
        # estimator; the streaming defenses exist for the O(1) fold)
        self._defense_buffered = (self.defense is not None
                                  and self.defense.buffered)
        self._conn_cap = (self.defense.conn_cap
                          if self.defense is not None else 0.0)
        if self._conn_cap > 0 and not self.streaming_agg:
            # the cap is enforced by the streaming fold's per-conn
            # accumulators; on the legacy buffered path it would be
            # silently inert — refuse, don't run undefended
            raise ValueError(
                "conn_cap requires the streaming hot path "
                "(streaming_agg=True / --hotpath fast)"
            )
        # async buffered rounds (``--round-mode async``): FedBuff-style
        # fold-on-arrival — the round is CUT at every ``cut_size``
        # arrivals (or the cut deadline) instead of barrier-closed, and
        # an upload computed against base round b < r folds in at
        # weight w(r-b)·n (``core/staleness``) instead of being
        # stale-rejected.  ``max_staleness`` keeps the reject firewall
        # as the hard outer bound.  Requires the streaming fold: the
        # O(1) accumulator is WHAT arrivals fold into mid-round — the
        # legacy buffered path and buffered robust estimators have no
        # partial-round state to discount into.
        if round_mode not in ("sync", "async"):
            raise ValueError(
                f"unknown round_mode {round_mode!r} (sync|async)"
            )
        self.round_mode = round_mode
        self._async = round_mode == "async"
        if self._async and (not self.streaming_agg
                            or self._defense_buffered):
            raise ValueError(
                "round_mode='async' requires the streaming fold "
                "(streaming_agg=True and a streaming-composable "
                "defense) — buffered closes cannot discount a "
                "partial-round accumulator"
            )
        if stale_policy not in STALENESS_POLICIES:
            raise ValueError(
                f"unknown stale_policy {stale_policy!r} "
                f"(one of {STALENESS_POLICIES})"
            )
        self.max_staleness = max(0, int(max_staleness))
        self.stale_policy = stale_policy
        self.stale_alpha = float(stale_alpha)
        # cut target: K arrivals per round cut (0 = the sync cohort
        # size).  Capped at the broadcast size — a larger cut could
        # never fill before the deadline.
        if self._async and cut_size > 0:
            self._cut_target = min(int(cut_size), self.broadcast_size)
        else:
            self._cut_target = self.clients_per_round
        # delta/dedup broadcast (``--bcast delta``): consecutive rounds'
        # models differ by exactly one aggregated update, so the sync
        # ships the int8-encoded UPDATE against each connection's
        # last-acked round instead of the full model.  The server
        # maintains the broadcast model as a QUANTIZED CHAIN: at every
        # close it encodes the aggregate update with ``bcast_codec``
        # (default qsgd8 in delta mode), decodes its own encoding, and
        # adopts base + decode as the canonical next model — the
        # quantization error rides an EF residual into the next round's
        # update (the uplink's EF recurrence, downlink edition).  Every receiver
        # applying the same decoded deltas in the same order holds the
        # server's model BIT-FOR-BIT, and a ``--bcast full`` run at the
        # same chain codec broadcasts the identical model sequence —
        # the delta-vs-full byte-identity pin.  ``--bcast full`` with
        # no explicit chain codec is the exact legacy path.
        if bcast not in ("full", "delta"):
            raise ValueError(f"unknown bcast mode {bcast!r} (full|delta)")
        if bcast == "delta" and not self.multicast:
            # delta envelopes are shared multicast frames (receivers
            # derive identity from their node id); the legacy per-node
            # unicast arm has no delta form — refuse, don't run full
            raise ValueError(
                "bcast='delta' requires the multicast hot path "
                "(--hotpath fast)"
            )
        self.bcast = bcast
        self.bcast_codec_name = (
            bcast_codec or ("qsgd8" if bcast == "delta" else "none")
        )
        # chain quantization is a property of the CLOSE, independent of
        # the wire form: on whenever delta mode is on, or when a chain
        # codec was explicitly requested for a full-broadcast arm (the
        # digest-pin comparison arm)
        self._chain = (bcast == "delta"
                       or self.bcast_codec_name not in ("", "none"))
        self.delta_base_window = max(1, int(delta_base_window))
        self._chain_resid = None  # downlink EF residual (fp32 tree)
        # node id -> last round whose sync the node provably received
        # (it echoed the round index on an upload); the delta log maps
        # round r -> the encoded update taking M_{r-1} to M_r, bounded
        # to the last ``delta_base_window`` rounds
        from collections import OrderedDict

        self._acked: Dict[int, int] = {}
        self._delta_log: "OrderedDict[int, dict]" = OrderedDict()
        # async mode's base-model log: round r -> the model round r
        # BROADCAST, bounded to the staleness window — a stale upload
        # decodes (and robust-screens) against the base its client
        # actually trained from, not the current model.  Round 0's
        # base is the init.
        self._model_log: "OrderedDict[int, object]" = OrderedDict()
        if self._async:
            self._model_log[0] = init_variables
        # ((round_idx, id(variables)), wire): the current model encoded
        # at most once per round however many full sends need it
        self._full_wire_cache = None
        # reader threads update acks while the (possibly off-thread)
        # broadcast groups by them: leaf lock, ordered round_lock ->
        # _ack_lock at every site that holds both
        self._ack_lock = make_lock("FedAvgServerManager._ack_lock")
        # deferred chain advance (encode thread): set while no advance
        # is pending; cleared at a close that hands the advance to
        # _broadcast_async, re-set there.  Off-thread readers of the
        # post-advance model (_on_resync's _full_wire) wait on it
        # OUTSIDE the round lock.
        self._chain_done = threading.Event()
        self._chain_done.set()
        self._agg_acc = None
        self._agg_n = 0.0
        # edge-partial decode template: tree_from_wire casts decoded
        # leaves to the template's dtype, and a partial's num tree IS
        # the edge's fp64 streaming accumulator — decoding against the
        # fp32 model would downcast mid-wire and break the tree-vs-flat
        # byte-identity pin
        self._f64_template = treelib.tree_map(
            lambda l: np.asarray(treelib.host_array(l), np.float64), init_variables
        )
        # per-connection num/den accumulators (conn caps only):
        # O(connections · model) — connections, not clients, is the
        # muxed federation's small axis
        self._conn_acc: Dict[str, object] = {}
        self._conn_n: Dict[str, float] = {}
        self.pending: Dict[int, dict] = {}
        self.round_log = []
        self.round_timeout = round_timeout
        self.zero_participant_rounds = 0
        self.rejected_uploads = 0  # non-finite (corrupt) models/weights
        self._round_open_t = time.perf_counter()
        # _on_model runs on the backend reader thread, the deadline on a
        # Timer thread: one lock serializes round completion, and the
        # timer is generation-checked so a stale deadline (its round
        # completed normally) is a no-op
        self._round_lock = make_lock("FedAvgServerManager._round_lock")
        self._deadline_timer: Optional[threading.Timer] = None
        # decode/fold pipeline (``decode_workers > 0``): upload decode +
        # the finite firewall move OFF the backend reader thread onto a
        # small worker pool feeding the streaming fold, so decode of
        # client i's upload overlaps the wire receive of client i+1 —
        # and the next broadcast's encode+send runs on its own thread
        # (double-buffered) so stale/spare uploads never queue behind an
        # O(model) serialize.  0 (default) = the synchronous path: the
        # inproc bus's deterministic drain contract requires handlers to
        # complete inline, so only the real TCP entry points turn this
        # on (``distributed_fedavg --decode-workers``).
        self.decode_workers = max(0, int(decode_workers))
        if self.decode_workers:
            from concurrent.futures import ThreadPoolExecutor

            self._decode_pool = ThreadPoolExecutor(
                max_workers=self.decode_workers,
                thread_name_prefix="fed-decode",
            )
            self._encode_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="fed-bcast"
            )
        else:
            self._decode_pool = None
            self._encode_pool = None
        # per-round pipeline evidence, surfaced on the round_close
        # event/record: the CLOSING upload's decode queue wait + decode
        # time, and the previous broadcast's off-thread encode+send span
        self._last_decode_wait_s = 0.0
        self._last_decode_s = 0.0
        self._bcast_task_s = 0.0
        # in-band stats plane (obs/digest + obs/slo): the server is the
        # rollup point — clients/muxers ship one digest frame per report
        # interval per CONNECTION, the rollup merges them (associative
        # digest algebra), and the SLO engine evaluates the declared
        # objectives at every round close.  ``status_dir`` additionally
        # turns on the live ``status.json`` snapshot (atomic write each
        # interval + each close) and the final ``slo_report.json`` — a
        # killed or wedged run leaves evidence mid-flight.
        self.stats_plane = bool(stats_plane)
        self.status_dir = status_dir
        self.stats_interval = max(0.1, float(stats_interval))
        self._stats_done = threading.Event()
        self._status_thread: Optional[threading.Thread] = None
        self._bytes_mark = 0.0
        if self.stats_plane:
            from fedml_tpu_torch.obs.digest import DigestRollup, DigestSource
            from fedml_tpu_torch.obs.slo import SloEngine, SloSpec

            if isinstance(slo_spec, dict):
                slo_spec = SloSpec.from_obj(slo_spec)
            slo_spec = slo_spec or SloSpec()
            if slo_spec.stale_after_s is None:
                # unset staleness threshold: scale it from the report
                # interval (5 missed heartbeats), floored at the module
                # default — a 30 s interval must not flag every live
                # stream stale between frames
                import dataclasses

                from fedml_tpu_torch.obs.digest import DEFAULT_STALE_AFTER_S

                slo_spec = dataclasses.replace(
                    slo_spec,
                    stale_after_s=max(DEFAULT_STALE_AFTER_S,
                                      5.0 * max(0.1, float(stats_interval))),
                )
            self.slo = SloEngine(slo_spec)
            self.rollup = DigestRollup()
            # the server's own registry is just another digest source —
            # folded locally (no frame to itself) so the merged rollup
            # covers the whole federation including rank 0
            self._local_digests = DigestSource(SERVER)
            # serializes next()+ingest as ONE step: the status thread
            # and a round-close fold interleaving between the two calls
            # would hand the rollup a newer seq first and the older
            # delta (possibly the closing round's wall sample) would be
            # skipped as a duplicate.  Leaf lock: nothing is acquired
            # inside the guarded region except the source's and
            # rollup's own internal locks.
            self._local_fold_lock = make_lock(
                "FedAvgServerManager._local_fold_lock")
        else:
            self.slo = self.rollup = self._local_digests = None
        super().__init__(backend)

    def register_message_receive_handlers(self):
        self.register_message_receive_handler(
            MSG_TYPE_C2S_SEND_MODEL, self._on_model
        )
        # hierarchical aggregation: an edge hub's pre-folded
        # (sum n·model, sum n) pair for the current round
        self.register_message_receive_handler(
            MSG_TYPE_E2S_PARTIAL, self._on_partial
        )
        # registered even with the stats plane OFF: a half-configured
        # federation (clients reporting, server arm disabled) must drop
        # digest frames quietly, not spam unhandled-frame warnings
        self.register_message_receive_handler(
            MSG_TYPE_C2S_TELEMETRY, self._on_telemetry
        )
        # delta-broadcast recovery: a rejoining client asking for a
        # full-model resend (registered unconditionally for the same
        # quiet-interop reason)
        self.register_message_receive_handler(
            MSG_TYPE_C2S_RESYNC, self._on_resync
        )

    # -- stats plane --------------------------------------------------------
    def _on_telemetry(self, msg: Message) -> None:
        """One digest frame off the wire → the rollup.  ``ingest``
        validates + counts and never raises, so a corrupted digest can
        cost at most its own frame — never a reader thread, never a
        round."""
        if self.rollup is None:
            return
        from fedml_tpu_torch.obs.digest import DIGEST_KEY

        self.rollup.ingest(msg.get(DIGEST_KEY))

    def _expected_nodes(self):
        return list(range(1, self.num_clients + 1))

    def _comm_bytes_total(self) -> float:
        snap = get_telemetry().snapshot()["counters"]
        return sum(v for k, v in snap.items()
                   if k.startswith(("comm.sent_bytes", "comm.recv_bytes")))

    def _fold_local_digest(self) -> None:
        if self.rollup is not None:
            with self._local_fold_lock:
                self.rollup.ingest(self._local_digests.next())

    def _write_status(self, finished: bool = False) -> None:
        if self.rollup is None or not self.status_dir:
            return
        import os

        from fedml_tpu_torch.obs import slo as slolib

        try:
            os.makedirs(self.status_dir, exist_ok=True)
            status = slolib.build_status(
                self.slo, self.rollup, round_idx=self.round_idx,
                rounds_total=self.comm_rounds,
                expected_nodes=self._expected_nodes(), finished=finished,
            )
            slolib.write_json_atomic(
                os.path.join(self.status_dir, "status.json"), status
            )
        except OSError:
            logging.exception("status.json write failed")

    def _status_loop(self) -> None:
        while not self._stats_done.wait(self.stats_interval):
            try:
                self._fold_local_digest()
                self._write_status()
            except Exception:
                # the health plane is best-effort: a snapshot bug must
                # not silently kill the only thread writing status.json
                logging.exception("status snapshot failed")

    def _slo_close(self, t_close: float) -> None:  # fedlint: holds=_round_lock
        """Round-close half of the stats plane (caller holds the round
        lock): feed the SLO histograms, fold the local registry delta
        into the rollup so the evaluation sees CURRENT numbers, then
        evaluate every declared objective."""
        wall = max(0.0, t_close - self._round_open_t)
        total_bytes = self._comm_bytes_total()
        round_bytes = max(0.0, total_bytes - self._bytes_mark)
        self._bytes_mark = total_bytes
        self.slo.observe_round(
            self.round_idx, wall_s=wall, round_bytes=round_bytes,
            participants=len(self.pending), target=self._cut_target,
        )
        self._fold_local_digest()
        self.slo.evaluate(
            self.round_idx, self.rollup.snapshot(),
            self.rollup.sources(stale_after=self.slo.spec.stale_after_s),
            expected_nodes=self._expected_nodes(),
        )
        self._write_status()

    def _stats_finish(self) -> None:
        """Final fold + ``slo_report.json`` + terminal ``status.json``
        (idempotent — finish can be reached from the last close AND the
        fail-fast broadcast path)."""
        if self.rollup is None or self._stats_done.is_set():
            return
        self._stats_done.set()
        if self._status_thread is not None:
            self._status_thread.join(timeout=5)
        self._fold_local_digest()
        if self.status_dir:
            import os

            from fedml_tpu_torch.obs import slo as slolib

            try:
                report = self.slo.report(
                    self.rollup.snapshot(),
                    self.rollup.sources(
                        stale_after=self.slo.spec.stale_after_s),
                    expected_nodes=self._expected_nodes(),
                    extra={"rounds_completed": self.round_idx,
                           "clients": self.num_clients,
                           "clients_per_round": self.clients_per_round},
                )
                slolib.write_json_atomic(
                    os.path.join(self.status_dir, "slo_report.json"), report
                )
            except Exception:
                # finish() must complete whatever the health plane's
                # state — a report bug losing the FINISH broadcast
                # would be worse than a missing report
                logging.exception("slo_report.json write failed")
            self._write_status(finished=True)

    def stats_summary(self) -> dict:
        """Machine-readable stats-plane outcome for the entry point's
        stdout JSON (what campaigns assert streams == connections on)."""
        if self.rollup is None:
            return {"enabled": False}
        snap = self.rollup.stats()
        sources = self.rollup.sources(
            stale_after=self.slo.spec.stale_after_s)
        _, missing = self.slo.coverage(
            self.rollup.snapshot(), sources, self._expected_nodes())
        violations_total, _ = self.slo.violation_state()
        return {
            "enabled": True,
            "streams": snap["streams"],
            # hub-ingested streams: every source EXCEPT the server's own
            # locally-folded registry — under muxing this equals the
            # number of client-side CONNECTIONS, never the client count
            # (the stats plane's O(connections) cost-model assertion)
            "streams_remote": snap["streams"]
            - (1 if str(SERVER) in sources else 0),
            "frames": snap["frames"],
            "rejected": snap["rejected"],
            "duplicates": snap["duplicates"],
            "stale_streams": sorted(
                s for s, st in sources.items() if st.get("stale")),
            "missing_nodes_total": len(missing),
            "slo_violations": violations_total,
            "slo_ok": violations_total == 0,
        }

    # -- protocol --
    def start(self):
        if self._conn_cap > 0:
            # arm connection attribution BEFORE the first broadcast
            # (synchronous pre-run fetch): without it, round 0's
            # uploads would race the async conn_map reply and a fast
            # cohort could fold as unmapped singletons — exactly the
            # window a malicious muxer wants.  Raises on a hub that
            # cannot answer: a cap the operator configured must never
            # silently degrade to uncapped.
            fetch = getattr(self.backend, "fetch_conn_map", None)
            if fetch is not None:
                self._robust.set_conn_map(fetch())
        self._round_open_t = time.perf_counter()
        if self.rollup is not None:
            with self._round_lock:
                self._bytes_mark = self._comm_bytes_total()
            if self.status_dir and self._status_thread is None:
                self._status_thread = threading.Thread(
                    target=self._status_loop, daemon=True,
                    name="fed-status",
                )
                self._status_thread.start()
        self._broadcast_model(MSG_TYPE_S2C_INIT_CONFIG)
        self._arm_deadline()

    def _broadcast_model(self, msg_type: str) -> None:
        """Ship this round's model to the sampled cohort.

        Multicast (default): ONE shared envelope — per-node identity
        (client_idx/slot) is derived by each receiver from its node id,
        so the frame bytes are identical for every node and the
        transport serializes them exactly once (``send_multicast``;
        native hub fan-out on tcp wire>=2, per-receiver clones of the
        same payload objects elsewhere).  A transport error after the
        backend's own bounded retries makes the WHOLE cohort stragglers
        for this round — the deadline covers it, same contract as the
        per-node ``_send_or_log``.

        Legacy (``multicast=False``): the per-node unicast loop with
        explicit client_idx/slot params — the measurement baseline and
        the interop mode for pre-multicast peers that cannot derive
        identity from their node id.
        """
        nodes = self._sampled_nodes()
        if self._conn_cap > 0:
            # refresh connection attribution once per round (async
            # reply; uploads take a client-train time to come back, so
            # the map is current by the first fold).  Best-effort —
            # unattributed nodes degrade to singleton connections.
            req = getattr(self.backend, "request_conn_map", None)
            if req is not None:
                req()
        if self.bcast == "delta":
            self._broadcast_delta(msg_type, nodes)
            return
        wire = self._full_wire()  # encode once per (round, model)
        if not self.multicast:
            for node in nodes:
                self._send_or_log(
                    self._model_msg(msg_type, node, node - 1, wire)
                )
            return
        msg = self._model_msg(msg_type, None, None, wire)
        try:
            self.backend.send_multicast(msg, nodes)
        except OSError:
            if self.round_timeout is None:
                raise  # no deadline to cover the lost round: fail fast
            get_telemetry().inc("comm.send_failed", msg_type=msg_type)
            logging.warning(
                "round %d: could not deliver %s multicast to %s (will "
                "rely on the round deadline)", self.round_idx, msg_type,
                nodes,
            )

    def _broadcast_delta(self, msg_type: str, nodes) -> None:
        """Delta-mode fan-out: group the cohort by last-acked round and
        ship each group the encoded chain updates it is missing (acked
        b ⇒ deltas b+1..r, applied in order — the telescoped sum IS the
        current model, bit-for-bit).  Nodes with no ack, or whose base
        aged past the window, get the full model — counted, the
        rejoin/behind fallback the protocol promises."""
        r = self.round_idx
        with self._ack_lock:
            acked = dict(self._acked)
            log = dict(self._delta_log)
        tel = get_telemetry()
        groups: Dict[int, list] = {}
        full_nodes: list = []
        for node in nodes:
            b = acked.get(node)
            if b is None or b >= r:
                # no ack yet (cold start / post-resync) — or an ack at
                # or past this round (an empty-delta no-op we ship as
                # full for simplicity; only reachable in teardown races)
                if b is None:
                    tel.inc("comm.delta_full_fallbacks", reason="no_ack")
                full_nodes.append(node)
            elif all(k in log for k in range(b + 1, r + 1)):
                groups.setdefault(b, []).append(node)
            else:
                # the base aged out of the bounded delta log: stale-base
                # eviction forces a full resend
                tel.inc("comm.delta_full_fallbacks", reason="window")
                full_nodes.append(node)
        for b in sorted(groups):
            wires = [log[k] for k in range(b + 1, r + 1)]
            # the shared multicast sync envelope (_model_msg) with the
            # params swapped for the chain wires + their base round —
            # one envelope builder, delta and full frames cannot drift
            msg = self._model_msg(msg_type, None, None, wires)
            msg.add_params(MSG_ARG_KEY_DELTA_BASE, b)
            tel.inc("comm.delta_bcast_bytes",
                    sum(bcast_wire_nbytes(w) for w in wires))
            self._mcast_or_log(msg, groups[b], msg_type)
        if full_nodes:
            msg = self._model_msg(msg_type, None, None, self._full_wire())
            self._mcast_or_log(msg, full_nodes, msg_type)

    def _mcast_or_log(self, msg: Message, receivers, msg_type: str) -> None:
        """One multicast with the broadcast path's failure contract: a
        transport error after the backend's bounded retries makes these
        receivers deadline stragglers (or fails fast with no deadline)."""
        try:
            self.backend.send_multicast(msg, receivers)
        except OSError:
            if self.round_timeout is None:
                raise
            get_telemetry().inc("comm.send_failed", msg_type=msg_type)
            logging.warning(
                "round %d: could not deliver %s multicast to %s (will "
                "rely on the round deadline)", self.round_idx, msg_type,
                receivers,
            )

    def _full_wire(self):
        """The current model's wire form, encoded at most once per
        (round, model) pair — shared by the full-broadcast path, the
        delta mode's full-fallback group, and every resync unicast in
        the round (a rejoined muxer's whole cohort resyncs at once;
        without the memo that is O(cohort x model) encode work under
        the round lock).  Callable with OR without ``_round_lock``
        (the encode thread broadcasts unlocked): the key re-derives
        per call and the cache swap is one atomic tuple assignment, so
        a racing caller at worst duplicates one encode — never serves
        a stale wire for a different (round, model)."""
        key = (self.round_idx, id(self.variables))
        cached = self._full_wire_cache
        if cached is None or cached[0] != key:
            cached = (key, tree_to_wire(self.variables))
            self._full_wire_cache = cached
        return cached[1]

    def _advance_chain(self, prev_model,  # fedlint: holds=_round_lock
                       next_round: Optional[int] = None) -> None:
        """Close-time half of the delta broadcast (caller holds the
        round lock): U = aggregate − M_r + residual, encoded on the
        seeded broadcast stream; M_{r+1} := M_r + decode(encode(U));
        residual := U − decode(encode(U)).  The encoded wire lands in
        the bounded delta log under round r+1 (the sync that ships it
        first).  ``next_round`` must be passed EXPLICITLY when the call
        is deferred past the close's ``round_idx`` increment (the
        encode-thread path): deriving it from ``self.round_idx`` there
        would land the wire one slot too high AND shift the encode
        seed — the server's chain state then silently skews from every
        receiver's."""
        assert_held(self._round_lock, "FedAvgServerManager._advance_chain")
        if next_round is None:
            next_round = self.round_idx + 1
        raw = treelib.tree_map(
            lambda a, b: _host_f32(a) - _host_f32(b), self.variables, prev_model,
        )
        if self._chain_resid is not None:
            raw = treelib.tree_map(lambda u, r: u + r, raw, self._chain_resid)
        wire = encode_bcast_delta(
            self.bcast_codec_name, raw, seed=self.seed,
            round_idx=next_round,
        )
        decoded = tree_from_wire(wire, self.variables)
        self._chain_resid = treelib.tree_map(
            lambda u, d: u - _host_f32(d), raw, decoded
        )
        self.variables = apply_bcast_delta(prev_model, decoded)
        if self._async:
            # chain mode's model-log record: the advanced model IS what
            # round next_round broadcasts (the close-path record is
            # skipped when a chain is on — a deferred advance would
            # otherwise log the pre-advance model)
            self._model_log[next_round] = self.variables
            while len(self._model_log) > self.max_staleness + 1:
                self._model_log.popitem(last=False)
        with self._ack_lock:
            self._delta_log[next_round] = wire
            while len(self._delta_log) > self.delta_base_window:
                self._delta_log.popitem(last=False)

    def _arm_deadline(self):
        if self.round_timeout is None:
            return
        t = threading.Timer(
            self.round_timeout, self._on_deadline, args=(self.round_idx,)
        )
        t.daemon = True
        self._deadline_timer = t
        t.start()

    def _on_deadline(self, round_gen: int):
        try:
            arrived = None
            with self._round_lock:
                if round_gen != self.round_idx or self.round_idx >= self.comm_rounds:
                    return  # stale timer: that round already closed
                arrived = len(self.pending)
                if not self.pending:
                    # nobody arrived: the global model is unchanged, the
                    # round still closes (an all-dropped round under the
                    # mask semantics is a no-op update)
                    self._close_round(dropped_all=True)
                else:
                    self._close_round()
            # black-box trigger outside the round lock (the dump does
            # file IO): a deadline firing IS the overrun — the timer
            # only exists while the round is still open
            flight.trigger("deadline_overrun", round_idx=round_gen,
                           reason=f"arrived={arrived}")
        except Exception:
            # a Timer-thread exception dies silently; without the
            # re-arm below the round would stay open forever (no later
            # timer exists).  Re-arm UNCONDITIONALLY: if _close_round
            # raised after round_idx += 1 (mid-broadcast), the timer it
            # never reached must cover the NEW round — and a duplicate
            # timer for an already-closed round is generation-checked
            # into a no-op anyway.
            logging.exception("round %d deadline close failed", round_gen)
            with self._round_lock:
                self._arm_deadline()

    def _sampled_nodes(self):
        """Seeded uniform sampling every round (the fork's hardcoded
        formula, FedAvgServerManager.py:66-75, is deliberately absent).
        With ``spares`` the draw is ``clients_per_round + spares`` wide —
        the extra nodes hedge stragglers; aggregation still targets the
        first ``clients_per_round`` reporters."""
        if self.broadcast_size >= self.num_clients:
            ids = np.arange(self.num_clients)
        else:
            rng = np.random.RandomState(self.seed * 100003 + self.round_idx)
            ids = np.sort(
                rng.choice(self.num_clients, self.broadcast_size, replace=False)
            )
        return [int(i) + 1 for i in ids]  # node id = client id + 1

    def _model_msg(self, msg_type: str, node, slot, wire) -> Message:
        """Sync envelope.  ``node=None`` builds the SHARED multicast
        form: receiver -1, no client_idx/slot params — each client
        derives both from its own node id (node = client + 1 and slot
        always equaled node - 1), so one immutable frame serves the
        whole cohort."""
        m = Message(msg_type, SERVER, -1 if node is None else node)
        m.add_params(MSG_ARG_KEY_MODEL_PARAMS, wire)
        if node is not None:
            m.add_params(MSG_ARG_KEY_CLIENT_INDEX, node - 1)
            m.add_params("slot", slot)  # global client id → rng stream id (matches SPMD slot_ids)
        m.add_params(MSG_ARG_KEY_ROUND_INDEX, self.round_idx)
        if self._codec is not None:
            m.add_params(MSG_ARG_KEY_CODEC, self.codec_name)
        if self.steps_per_epoch is not None:
            m.add_params("steps_per_epoch", self.steps_per_epoch)
        if self.bcast == "delta":
            # full frames in delta mode still announce the cache depth:
            # the receiver starts (or keeps) caching reconstructed
            # rounds so later deltas have their base on hand
            m.add_params("delta_window", self.delta_base_window)
        return m

    def _is_stale(self, msg: Message, reply_round) -> bool:  # fedlint: holds=_round_lock
        """Caller holds the round lock.  Discard a straggler's upload
        from an already-closed round: aggregating it into the CURRENT
        round would double-count its stale parameters (missing round
        index = legacy client, accepted as current).

        Async mode keeps this as the hard OUTER bound only: an upload
        up to ``max_staleness`` rounds behind folds in discounted
        (``_stale_weight``); beyond the window — or claiming a FUTURE
        round — it is rejected exactly like the sync barrier would."""
        assert_held(self._round_lock, "FedAvgServerManager._is_stale")
        if (self._async and reply_round is not None
                and reply_round != self.round_idx):
            d = self.round_idx - int(reply_round)
            if 0 < d <= self.max_staleness:
                return False  # in-window: discounted at fold, not dropped
        if reply_round is not None and reply_round != self.round_idx:
            self.round_log.append(
                {"round": self.round_idx, "stale_from": msg.sender,
                 "stale_round": reply_round}
            )
            # counted (not just logged) so the SLO engine's stale-upload
            # budget reads one series instead of parsing the round_log
            get_telemetry().inc("faults.observed", kind="stale_upload",
                                msg_type=MSG_TYPE_C2S_SEND_MODEL)
            return True
        return False

    def _stale_weight(self, delta: int) -> float:
        """w(r-b) for an in-window async upload (``core/staleness``, numpy
        float64 on the host fold path).  delta<=0 short-circuits to
        exactly 1.0 so the current-round fast path never even builds an
        array."""
        if delta <= 0:
            return 1.0
        return float(staleness_weight(
            delta, self.stale_policy, alpha=self.stale_alpha,
            window=self.max_staleness,
        ))

    def _staleness_delta(self, reply_round) -> int:  # fedlint: holds=_round_lock
        """Round gap of an accepted upload (0 = current / legacy
        no-echo), read under the round lock so it is consistent with
        the cut this fold lands in."""
        assert_held(self._round_lock,
                    "FedAvgServerManager._staleness_delta")
        if not self._async or reply_round is None:
            return 0
        return max(0, self.round_idx - int(reply_round))

    def _on_resync(self, msg: Message) -> None:
        """A client received a delta against a base it no longer holds
        (fresh process, rejoined muxer, cache aged out): clear its ack
        so the NEXT broadcast goes full, and unicast the current
        round's full model right away so it can still make this round.
        The wire is the memoized per-round encode (``_full_wire``) —
        a rejoined muxer's whole cohort resyncs at once, and per-node
        encodes under the round lock would serialize O(cohort x model)
        work in front of upload folding."""
        # deferred chain advance: _full_wire below must serve the
        # ADVANCED model.  Wait OUTSIDE the round lock — the encode
        # thread takes it for the advance, so waiting inside would
        # deadlock the very thread we are waiting on.
        if not self._chain_done.wait(timeout=30.0):
            logging.warning(
                "resync from node %d: deferred chain advance still "
                "pending after 30s — serving the current model",
                msg.sender,
            )
        with self._round_lock:
            with self._ack_lock:
                self._acked.pop(msg.sender, None)
            if self.bcast != "delta" or self.round_idx >= self.comm_rounds:
                return
            get_telemetry().inc("comm.delta_full_fallbacks",
                                reason="resync")
            m = self._model_msg(
                MSG_TYPE_S2C_SYNC_MODEL, msg.sender, msg.sender - 1,
                self._full_wire(),
            )
        # send OUTSIDE the round lock (every other model send does):
        # the socket write plus its bounded retry backoffs would
        # otherwise stall upload folding and the deadline timer for
        # the whole cohort's resync walkback.  If the round closes
        # between build and send the client just gets last round's
        # sync — its upload is stale-rejected and the cleared ack
        # makes the next broadcast full, same as any in-flight sync
        # racing a close.
        self._send_or_log(m)

    def _on_model(self, msg: Message):
        reply_round = msg.get(MSG_ARG_KEY_ROUND_INDEX)
        with self._round_lock:
            if self.bcast == "delta" and reply_round is not None:
                # implicit ack: an upload echoing round r proves the
                # node RECEIVED round r's sync, i.e. holds the chain
                # model M_r — even a stale or later-rejected upload
                # proves that much (a lying ack only costs the liar a
                # resync round trip)
                with self._ack_lock:
                    prev = self._acked.get(msg.sender)
                    if prev is None or int(reply_round) > prev:
                        self._acked[msg.sender] = int(reply_round)
            if self._is_stale(msg, reply_round):
                return
            # delta uploads reconstruct against the model THIS round
            # broadcast — capture it under the lock (a concurrent round
            # close would swap self.variables; the post-decode stale
            # re-check then discards anything decoded against it).
            # Async: an in-window stale upload decodes against the base
            # its client trained from (the model log keeps the last
            # max_staleness+1 broadcast models).
            if self._async and reply_round is not None:
                base = self._model_log.get(int(reply_round),
                                           self.variables)
            else:
                base = self.variables
        if self._decode_pool is not None:
            # pipeline: hand decode+fold to the worker pool and free
            # the reader thread for the next frame — decode of upload i
            # overlaps the wire receive of upload i+1.  A slab-backed
            # payload (shm lane) is pinned across the thread handoff so
            # the ring cannot reclaim it before the decode ran.
            unpin = msg.pin_payload()
            self._decode_pool.submit(
                self._decode_and_fold_pinned, msg, base, reply_round,
                time.perf_counter(), unpin,
            )
            return
        self._decode_and_fold(msg, base, reply_round, None)

    def _decode_and_fold_pinned(self, msg, base, reply_round, t_submit,
                                unpin) -> None:
        try:
            self._decode_and_fold(msg, base, reply_round, t_submit)
        finally:
            unpin()

    def _decode_and_fold(self, msg: Message, base, reply_round,
                         t_submit: Optional[float]) -> None:
        try:
            self._decode_and_fold_inner(msg, base, reply_round, t_submit)
        except Exception:
            # a pool task's exception dies in its Future — the upload
            # would silently vanish and the round hang to its deadline
            # with no attributable cause.  Log + count like any other
            # bad upload.
            logging.exception("upload decode/fold failed for node %d",
                              msg.sender)
            self._reject_upload(msg.sender, "undecodable_upload")

    def _decode_and_fold_inner(self, msg: Message, base, reply_round,
                               t_submit: Optional[float]) -> None:
        wait_s = 0.0
        t_start = time.perf_counter()
        if t_submit is not None:
            # decode queue wait: reader-thread submit -> pool pickup —
            # the pipeline's backpressure signal (grows when K uploads
            # outpace the decode workers)
            wait_s = t_start - t_submit
            get_telemetry().observe("span.decode_wait_s", wait_s)
        # decode + validate OUTSIDE the round lock: both are O(model)
        # (multi-MB decode, full-tree finite scan) and K near-
        # simultaneous uploads would otherwise serialize behind one
        # lock with the deadline timer blocked at the back of the queue
        try:
            # shared decode + corrupt-payload firewall (the edge hub
            # runs the identical intake on its tier)
            variables, n = decode_validated_upload(msg, base)
        except UploadRejected as bad:
            self._reject_upload(msg.sender, bad.kind)
            return
        conn_key = None
        if self._robust is not None:
            # robust screening — the norm-space extension of the
            # non-finite firewall above, same altitude (O(model), host
            # numpy, OUTSIDE the round lock): outlier-score reject,
            # norm clip against the broadcast base, client-level DP.
            # Per-upload math depends only on (upload, base, seed,
            # round, slot) — never on arrival order — so defended
            # same-seed runs agree whatever the interleaving.
            screened, defense_flags = self._robust.screen(
                variables, base,
                round_idx=(reply_round if reply_round is not None
                           else self.round_idx),
                slot=msg.sender - 1,
            )
            if screened is None:
                self._reject_upload(msg.sender, "outlier_upload")
                return
            variables = screened
            if self._conn_cap > 0:
                # connection attribution for the contribution cap: the
                # hub's conn_map introspection is the authority (a
                # muxer cannot claim independent connections for its
                # virtual cohort); nodes outside the map count as their
                # own singleton connection
                fn = getattr(self.backend, "conn_map", None)
                if callable(fn):
                    self._robust.set_conn_map(fn())
                conn_key = self._robust.conn_key(msg.sender)
        decode_s = time.perf_counter() - t_start
        get_telemetry().observe("span.decode_s", decode_s)
        with self._round_lock:
            # re-check: the round may have closed (deadline, or the
            # K-th other reporter) while this upload was decoding
            if self._is_stale(msg, reply_round):
                return
            # pipeline evidence for the round that this upload counts
            # toward: the LAST accepted upload's numbers are the
            # closing chain's (round_close reads them under this lock)
            self._last_decode_wait_s = wait_s
            self._last_decode_s = decode_s
            if msg.sender in self.pending:
                # duplicate upload (chaos duplicate / redelivery): the
                # buffered path overwrote the entry idempotently, but a
                # streaming fold cannot un-fold the first copy — ignore
                # the dupe (copies are byte-identical, so ignore ==
                # overwrite) and count the observation in both modes
                get_telemetry().inc("faults.observed",
                                    kind="duplicate_upload",
                                    msg_type=MSG_TYPE_C2S_SEND_MODEL)
                return
            # async staleness discount (post-duplicate-check, so a
            # redelivered copy never double-counts the async series):
            # an in-window upload d rounds behind folds at weight
            # w(d)·n.  d==0 keeps n UNTOUCHED (no multiply) — the
            # fp-exactness the async≡sync byte-identity pin rests on.
            d = self._staleness_delta(reply_round)
            if self._async:
                tel = get_telemetry()
                tel.observe("async.upload_staleness", float(d))
                if d > 0:
                    w = self._stale_weight(d)
                    tel.inc("async.stale_weighted_uploads")
                    if w != 1.0:
                        n_w = float(np.float64(w) * np.float64(n))
                        tel.inc("async.discarded_weight", n - n_w)
                        n = n_w
                tel.inc("async.folded_weight", n)
            meta = {"n": n,
                    "metrics": msg.get(MSG_ARG_KEY_LOCAL_METRICS) or {}}
            if self._robust is not None:
                # defense telemetry counts ACCEPTED uploads only —
                # after the duplicate check above, so a redelivered
                # copy's screening never double-counts
                self._robust.note_upload(defense_flags)
            if self.streaming_agg and not self._defense_buffered:
                # fold NOW, under the round lock (a concurrent close
                # swaps the accumulator; the stale re-check above makes
                # this fold belong to the open round): pending keeps
                # METADATA only, so peak memory stays O(model) however
                # large the cohort, and the close-time aggregation
                # stall collapses into these per-arrival folds
                t0 = time.perf_counter()
                if conn_key is not None:
                    # contribution caps: one num/den accumulator per
                    # PHYSICAL connection (O(conns · model)); the close
                    # rescales any conn over its weight-fraction cap
                    self._conn_acc[conn_key] = treelib.tree_fold_weighted(
                        self._conn_acc.get(conn_key), variables, n
                    )
                    self._conn_n[conn_key] = (
                        self._conn_n.get(conn_key, 0.0) + float(n)
                    )
                else:
                    self._agg_acc = treelib.tree_fold_weighted(
                        self._agg_acc, variables, n
                    )
                self._agg_n += float(n)
                get_telemetry().observe("span.agg_fold_s",
                                        time.perf_counter() - t0)
            else:
                # buffered: the legacy baseline arm, or a robust
                # estimator (median/trimmed-mean) that needs all K
                # decoded trees at close.  A slab-backed upload's
                # decoded views would outlive its pin (the close can be
                # a whole deadline away) — own the bytes here.
                if msg._region is not None:
                    variables = treelib.tree_map(_owned, variables)
                meta["variables"] = variables
            self.pending[msg.sender] = meta
            if len(self.pending) < self._cut_target:
                return
            try:
                self._close_round()
            except Exception:
                # same wedge prevention as _on_deadline: a close that
                # raised mid-broadcast (round_idx already advanced, no
                # deadline armed) must leave a timer behind, or nothing
                # ever closes the new round
                logging.exception("round close from upload path failed")
                self._arm_deadline()

    def _reject_upload(self, sender: int, kind: str) -> None:
        """Log + count a bad upload (takes the round lock itself); the
        round stays open — the deadline/other reporters close it."""
        get_telemetry().inc("faults.observed", kind=kind,
                            msg_type=MSG_TYPE_C2S_SEND_MODEL)
        flight.note("faults", "observed", what=kind, sender=sender)
        with self._round_lock:
            self.rejected_uploads += 1
            round_idx = self.round_idx
            self.round_log.append(
                {"round": round_idx, "rejected_from": sender,
                 "kind": kind}
            )
        # dump outside the round lock (file IO): a corrupt/outlier/
        # undecodable upload is exactly the moment the black box must
        # preserve — the offending frame's metadata is still in the ring
        flight.trigger("reject", round_idx=round_idx,
                       reason=f"{kind} from node {sender}")
        logging.warning(
            "round %d: rejected %s from node %d (excluded from "
            "aggregation)", round_idx, kind, sender,
        )

    def _on_partial(self, msg: Message) -> None:
        """One edge hub's pre-folded (sum n·model, sum n) pair
        (``MSG_TYPE_E2S_PARTIAL``, from ``algorithms/edge_hub``).

        The num/den formulation composes exactly with the flat
        streaming fold: the edge's accumulator is the same fp64
        ``tree_fold_weighted`` sum the root would have built from the
        raw uploads, and fp64 addition of those partial sums is exact
        at training magnitudes — so a tree run's final model is
        byte-identical to the same-seed flat run's (the tiered twin of
        the muxed-vs-per-process pin).

        An edge may flush MORE than one partial per round: ack-group
        sync frames can extend its expected cohort after a first flush,
        and late local stragglers flush as singletons after its local
        deadline.  Contributor sets must be disjoint — an overlap with
        already-counted reporters drops the whole partial, counted."""
        reply_round = msg.get(MSG_ARG_KEY_ROUND_INDEX)
        if not self.streaming_agg or self._defense_buffered:
            # a buffered estimator (median/trimmed-mean) needs the
            # per-client trees; a pre-folded pair cannot feed it, and
            # silently folding would undefend the round.  Refuse loudly.
            get_telemetry().inc("faults.observed",
                                kind="partial_unsupported",
                                msg_type=MSG_TYPE_E2S_PARTIAL)
            logging.warning(
                "E2S_PARTIAL from node %d dropped: root is not on the "
                "streaming fold (legacy hotpath or buffered defense) — "
                "the tree topology requires --hotpath fast and a "
                "streaming-composable defense", msg.sender,
            )
            return
        with self._round_lock:
            if self.bcast == "delta" and reply_round is not None:
                # implicit acks for every contributor: a partial
                # echoing round r proves those nodes received round r's
                # sync (same inference as _on_model's — the edge only
                # folds uploads that echoed its current round)
                contrib_keys = msg.get(MSG_ARG_KEY_CONTRIBUTORS) or {}
                with self._ack_lock:
                    for node_s in contrib_keys:
                        try:
                            node = int(node_s)
                        except (TypeError, ValueError):
                            continue
                        prev = self._acked.get(node)
                        if prev is None or int(reply_round) > prev:
                            self._acked[node] = int(reply_round)
            if self._is_stale(msg, reply_round):
                return
        if self._decode_pool is not None:
            # same pipeline as raw uploads: decode + validation off the
            # reader thread, slab-backed payloads pinned across the
            # handoff
            unpin = msg.pin_payload()
            self._decode_pool.submit(
                self._fold_partial_pinned, msg, reply_round,
                time.perf_counter(), unpin,
            )
            return
        self._fold_partial(msg, reply_round, None)

    def _fold_partial_pinned(self, msg, reply_round, t_submit,
                             unpin) -> None:
        try:
            self._fold_partial(msg, reply_round, t_submit)
        finally:
            unpin()

    def _fold_partial(self, msg: Message, reply_round,
                      t_submit: Optional[float]) -> None:
        try:
            self._fold_partial_inner(msg, reply_round, t_submit)
        except Exception:
            # same contract as _decode_and_fold: a pool task's
            # exception dies in its Future — log + count, never hang
            # the round silently
            logging.exception("partial decode/fold failed for edge "
                              "uplink %d", msg.sender)
            self._reject_upload(msg.sender, "undecodable_partial")

    def _fold_partial_inner(self, msg: Message, reply_round,
                            t_submit: Optional[float]) -> None:
        wait_s = 0.0
        t_start = time.perf_counter()
        if t_submit is not None:
            wait_s = t_start - t_submit
            get_telemetry().observe("span.decode_wait_s", wait_s)
        try:
            # decode against the fp64 template (NOT self.variables):
            # the num tree is the edge's fp64 accumulator and must stay
            # fp64 through the wire for the exact composition
            num = tree_from_wire(msg.get(MSG_ARG_KEY_MODEL_PARAMS),
                                 self._f64_template)
        except Exception:
            self._reject_upload(msg.sender, "undecodable_partial")
            return
        den = msg.get(MSG_ARG_KEY_NUM_SAMPLES)
        contrib: Dict[int, float] = {}
        ok = den is not None and np.isfinite(den) and den > 0
        try:
            for node_s, n_i in (msg.get(MSG_ARG_KEY_CONTRIBUTORS)
                                or {}).items():
                w = float(n_i)
                ok = ok and bool(np.isfinite(w)) and w > 0
                contrib[int(node_s)] = w
        except (TypeError, ValueError):
            ok = False
        # the corrupt-payload firewall, tier-2 edition: the edge
        # screened each upload, but the partial itself crossed a wire
        if not ok or not contrib or not _all_finite(num):
            self._reject_upload(msg.sender, "corrupt_partial")
            return
        if msg._region is not None:
            # slab-backed frame: decoded fp64 leaves are views into the
            # shm ring; adopted directly as the accumulator (first
            # partial of the round) they would outlive the pin — own
            # the bytes here
            num = treelib.tree_map(_owned, num)
        decode_s = time.perf_counter() - t_start
        tel = get_telemetry()
        tel.observe("span.decode_s", decode_s)
        with self._round_lock:
            # re-check: the round may have closed while decoding
            if self._is_stale(msg, reply_round):
                return
            self._last_decode_wait_s = wait_s
            self._last_decode_s = decode_s
            if any(n in self.pending for n in contrib):
                # contributor overlap with already-counted reporters
                # (edge redelivery after a reconnect): the streaming
                # fold cannot un-fold the first copy — drop the whole
                # partial, counted
                tel.inc("faults.observed", kind="duplicate_upload",
                        msg_type=MSG_TYPE_E2S_PARTIAL)
                return
            # async per-tier discount: the edge tagged this partial
            # with ITS base round, so a partial d rounds behind scales
            # num AND den by w(d) — the num/den ratio (the models) is
            # untouched; only this tier's vote shrinks.  Gated on
            # w != 1.0 so the current-round path stays fp-exact.
            d = self._staleness_delta(reply_round)
            if self._async:
                tel.observe("async.upload_staleness", float(d))
                if d > 0:
                    w = self._stale_weight(d)
                    tel.inc("async.stale_weighted_uploads", len(contrib))
                    if w != 1.0:
                        w64 = np.float64(w)
                        num = treelib.tree_map(lambda l: l * w64, num)
                        den_w = float(w64 * np.float64(den))
                        tel.inc("async.discarded_weight", den - den_w)
                        den = den_w
                        contrib = {k: float(w64 * np.float64(v))
                                   for k, v in contrib.items()}
                tel.inc("async.folded_weight", den)
            t0 = time.perf_counter()
            if self._conn_cap > 0:
                # contribution caps over the tree: each partial carries
                # its edge-LOCAL connection group, so the cap keeps the
                # flat run's granularity (physical client/muxer conns).
                # An untagged partial degrades to one group per edge —
                # the whole edge link capped as a unit, never uncapped.
                key = msg.get("conn_group")
                key = str(key) if key else f"edge:{msg.sender}"
                acc = self._conn_acc.get(key)
                self._conn_acc[key] = (
                    num if acc is None
                    else treelib.tree_map(np.add, acc, num)
                )
                self._conn_n[key] = (self._conn_n.get(key, 0.0)
                                     + float(den))
            else:
                # numpy fp64 add — the same arithmetic domain as
                # tree_fold_weighted's accumulator, NOT a device add (that
                # would leave the exact-composition contract)
                self._agg_acc = (
                    num if self._agg_acc is None
                    else treelib.tree_map(np.add, self._agg_acc, num)
                )
            self._agg_n += float(den)
            tel.observe("span.agg_fold_s", time.perf_counter() - t0)
            tel.inc("edge.partials_folded")
            for node in sorted(contrib):
                self.pending[node] = {"n": contrib[node], "metrics": {}}
            if len(self.pending) < self._cut_target:
                return
            try:
                self._close_round()
            except Exception:
                # same wedge prevention as the upload path
                logging.exception("round close from partial path failed")
                self._arm_deadline()

    def _close_round(self, dropped_all: bool = False):  # fedlint: holds=_round_lock
        """Aggregate whatever arrived and advance (caller holds the
        round lock).  Weighted average over any non-empty subset ==
        the compiled round's participation-mask aggregation."""
        assert_held(self._round_lock, "FedAvgServerManager._close_round")
        if self._deadline_timer is not None:
            self._deadline_timer.cancel()
        # the model this round BROADCAST (M_r): the chain advance below
        # and the delta log are defined against it — capture before the
        # aggregation overwrites self.variables
        prev_model = self.variables
        sampled = set(self._sampled_nodes())
        time_agg = 0.0
        capped_conns = 0
        cap_infeasible = False
        streaming_close = self.streaming_agg and not self._defense_buffered
        entries = list(self.pending.values())
        total = (self._agg_n if streaming_close
                 else sum(e["n"] for e in entries))
        if total <= 0:
            # every reporter was rejected or weightless: same no-op
            # semantics as nobody arriving (a 0-weight average is
            # undefined — the compiled engine's den>0 guard, host-side)
            dropped_all = True
        if not dropped_all:
            # aggregate: sample-weighted average (FedAVGAggregator.py:58-87);
            # renormalization over the REALIZED reporters is the weight
            # correction over-sampled/deadline-cut cohorts need — each
            # weight is n_i / sum(n_arrived), never n_i / sum(n_sampled)
            t0 = time.perf_counter()
            if streaming_close and self._conn_n:
                # contribution-capped close: rescale any connection
                # over its weight-fraction cap (water-filling — capped
                # conns land at EXACTLY conn_cap of the rescaled
                # total), then combine the per-conn num/den pairs in
                # sorted-key order (arrival-order independent)
                from fedml_tpu_torch.robust import cap_connection_weights

                scales, cap_infeasible = cap_connection_weights(
                    self._conn_n, self._conn_cap
                )
                num, den = None, 0.0
                for key in sorted(self._conn_acc):
                    scaled = treelib.tree_scale(self._conn_acc[key],
                                                scales[key])
                    # numpy float64 throughout (JAX's tree_add is jnp.add,
                    # which rounds these sums to float32 with x64 off;
                    # the two agree to that rounding)
                    num = scaled if num is None else treelib.tree_map(
                        np.add, num, scaled)
                    den += scales[key] * self._conn_n[key]
                capped_conns = sum(1 for v in scales.values() if v < 1.0)
                self.variables = treelib.tree_finalize_weighted_mean(
                    num, den, self.variables
                )
            elif streaming_close:
                # the whole cohort already folded in on arrival — the
                # close "stall" is one O(model) normalize, the engine's
                # exact num/den formulation (sum n·x then /sum n)
                self.variables = treelib.tree_finalize_weighted_mean(
                    self._agg_acc, total, self.variables
                )
            elif self._defense_buffered:
                # buffered robust close: the usual weighted mean for
                # the non-params collections, with the params
                # collection replaced by the coordinate-wise robust
                # center over the decoded cohort (core.robust's
                # estimator, numpy host-side — same formula the
                # compiled transform runs)
                self.variables = self._robust.buffered_close(
                    [e["variables"] for e in entries],
                    [e["n"] / total for e in entries],
                )
            else:
                self.variables = treelib.tree_weighted_sum(
                    [e["variables"] for e in entries],
                    [e["n"] / total for e in entries],
                )
            time_agg = time.perf_counter() - t0
            # same span series the simulation drivers feed (obs layer):
            # the reference's FedAVGAggregator.py:59,85-86 aggregate timer
            get_telemetry().observe("span.agg_s", time_agg)
        # quantized-chain advance (delta mode, and the full-mode
        # digest-pin arm at an explicit chain codec): encode the
        # aggregate update (+ the EF residual), decode OUR OWN
        # encoding, and adopt base + decode as the canonical next
        # model — every receiver of the delta reconstructs exactly
        # this, and the quantization error is carried, not lost.
        # On a dropped_all round the update is just the pending
        # residual (the chain still advances deterministically).
        # With the encode thread available AND a broadcast still to
        # come, the O(model) encode+decode moves OFF the round lock
        # onto _broadcast_async — ordering stays
        # safe because the next round's uploads reconstruct against
        # the model that broadcast ships, and the broadcast runs on
        # the same thread AFTER the advance.  The FINAL close has no
        # broadcast to ride, so it advances synchronously (the final
        # model must adopt the last quantization step either way).
        defer_chain = (self._chain and self._encode_pool is not None
                       and self.round_idx + 1 < self.comm_rounds)
        if self._chain and not defer_chain:
            self._advance_chain(prev_model)
        # wall-clock close stamp: deltas between consecutive recs are
        # the per-round wall time a federation artifact reports; the
        # monotonic open/close pair shares the hop-stamp clock
        # (perf_counter), so fed_timeline can place round boundaries on
        # the merged timeline without touching time.time at all
        t_close_m = time.perf_counter()
        rec = {"round": self.round_idx, "participants": sorted(self.pending),
               "time_agg": round(time_agg, 6),
               # observability stamp for run artifacts, never read by any
               # decision path (round logic runs on perf_counter spans)
               "t": round(time.time(), 3),  # fedlint: disable=determinism -- wall stamp in the round_log artifact record only; no control flow reads it
               "t_open_m": round(self._round_open_t, 6),
               "t_close_m": round(t_close_m, 6)}
        missing = sorted(sampled - set(self.pending))
        if len(self.pending) >= self._cut_target:
            # the round closed at its K-report target: unreported nodes
            # are over-sampled spares whose hedge wasn't needed — NOT
            # dropouts (logging them as 'dropped' would make a healthy
            # spared run indistinguishable from a mild drop fault)
            dropped = []
            if missing:
                rec["spared"] = missing
        else:
            dropped = missing
            if dropped:
                rec["dropped"] = dropped  # deadline expired without them
        tel = get_telemetry()
        # server-side round wall time (open -> close): the recovery-span
        # series a chaos soak reads next to span.reconnect_s
        tel.observe("span.server_round_s",
                    max(0.0, time.perf_counter() - self._round_open_t))
        if self._async:
            # every async close is a CUT (K arrivals or the cut
            # deadline) — the series fed_timeline/fed_slo read the
            # cut cadence from
            tel.inc("async.cut_rounds")
        if len(self.pending) < self._cut_target:
            # degraded: fewer reporters than the aggregation target
            # (deadline cut, crashes, dropped frames) — same counter
            # series the simulation drivers increment, so one number
            # covers both transports (unified deadline semantics)
            tel.inc("rounds.degraded")
            tel.event("degraded_round", round=self.round_idx,
                      arrived=len(self.pending), dropped=dropped)
        if not self.pending:
            # a zero-participant round is a silent no-op update; a run
            # where EVERY round is one (deadline shorter than client
            # train time — all uploads arrive a round late and are
            # stale-rejected) would otherwise "finish" with the init
            # model and rc=0.  Count them so callers can fail loudly.
            self.zero_participant_rounds += 1
            logging.warning(
                "round %d closed with ZERO participants (deadline %.1fs; "
                "sampled %s) — global model unchanged this round",
                self.round_idx, self.round_timeout or -1.0, sorted(sampled),
            )
        # pipeline evidence riding the round boundary: the closing
        # upload's decode queue wait + decode span, and the PREVIOUS
        # broadcast's off-thread encode+send span (it opened this
        # round) — what fed_timeline reads for its decode_wait /
        # encode_overlap phases
        rec["decode_wait_s"] = round(self._last_decode_wait_s, 6)
        rec["decode_s"] = round(self._last_decode_s, 6)
        rec["encode_overlap_s"] = round(self._bcast_task_s, 6)
        if self._robust is not None:
            # per-round defense activity (clipped / outlier-rejected /
            # DP-noised / capped conns) next to participants and spans
            # — what trace_summary's defense section and fed_slo read
            rec["defense"] = self._robust.note_round(
                capped=capped_conns, cap_infeasible=cap_infeasible
            )
        # the same record as a telemetry event: the server's
        # metrics-node0.jsonl then carries round boundaries next to its
        # trace_hop chains, so the timeline merger reads ONE stream
        tel.event("round_close", round=self.round_idx,
                  participants=len(self.pending), time_agg=rec["time_agg"],
                  t_open_m=rec["t_open_m"], t_close_m=rec["t_close_m"],
                  decode_wait_s=rec["decode_wait_s"],
                  decode_s=rec["decode_s"],
                  encode_overlap_s=rec["encode_overlap_s"],
                  **({"defense": rec["defense"]} if "defense" in rec
                     else {}))
        if self.slo is not None:
            # stats plane: SLO histograms + evaluation against the
            # merged rollup, while this round's state is still in hand
            try:
                self._slo_close(t_close_m)
            except Exception:
                # the health plane must never be able to fail a round
                logging.exception("SLO close-evaluation failed")
        self.round_log.append(rec)
        self.pending.clear()
        self._agg_acc, self._agg_n = None, 0.0
        self._conn_acc, self._conn_n = {}, {}
        self._last_decode_wait_s = self._last_decode_s = 0.0
        self.round_idx += 1
        if self._async and not self._chain:
            # base-model log for the new round's broadcast (chain mode
            # records inside _advance_chain — see there)
            self._model_log[self.round_idx] = self.variables
            while len(self._model_log) > self.max_staleness + 1:
                self._model_log.popitem(last=False)
        if self.round_idx >= self.comm_rounds:
            nodes = list(range(1, self.num_clients + 1))
            if self.multicast:
                try:
                    self.backend.send_multicast(
                        Message(MSG_TYPE_S2C_FINISH, SERVER, -1), nodes
                    )
                except OSError:
                    # the federation is over either way; undelivered
                    # FINISH frames only leave clients to their own
                    # timeouts (same stance as _send_or_log)
                    get_telemetry().inc("comm.send_failed",
                                        msg_type=MSG_TYPE_S2C_FINISH)
            else:
                for node in nodes:
                    self._send_or_log(
                        Message(MSG_TYPE_S2C_FINISH, SERVER, node)
                    )
            self.finish()
            return
        self._round_open_t = time.perf_counter()
        if self._encode_pool is not None:
            # double-buffered broadcast: the O(model) wire encode + hub
            # write runs on the dedicated encode thread so the caller
            # (a decode worker or the deadline timer) releases the
            # round lock immediately — residual/stale uploads decode
            # while the next sync serializes.  Safe lock-free reads:
            # self.variables/round_idx only change at the NEXT close,
            # which cannot happen before this broadcast reaches clients.
            if defer_chain:
                self._chain_done.clear()
            self._encode_pool.submit(
                self._broadcast_async, self.round_idx,
                prev_model if defer_chain else None,
            )
        else:
            self._broadcast_model(MSG_TYPE_S2C_SYNC_MODEL)
            self._arm_deadline()

    def _broadcast_async(self, round_gen: int, chain_prev=None) -> None:
        """Encode-thread body: (optionally) run the deferred chain
        advance, broadcast the new round's sync, record the overlapped
        span, then arm the deadline (the deadline must not start
        ticking before the sync is on the wire — same ordering as the
        synchronous path)."""
        if chain_prev is not None:
            # deferred _advance_chain (close handed us M_r): takes the
            # round lock itself — the close-path caller released it
            # when it submitted this task.  _chain_done gates the rare
            # off-thread readers of the post-advance model (resync
            # unicasts) that can run in the close→advance gap.
            try:
                # round_gen is the post-increment round index — exactly
                # the next_round this advance is producing the wire for
                with self._round_lock:
                    self._advance_chain(chain_prev, round_gen)
            except Exception:
                logging.exception(
                    "round %d: deferred chain advance failed "
                    "(broadcasting the unadvanced model)", round_gen,
                )
            finally:
                self._chain_done.set()
        t0 = time.perf_counter()
        try:
            self._broadcast_model(MSG_TYPE_S2C_SYNC_MODEL)
        except Exception:
            # _broadcast_model already downgrades OSError under a
            # deadline; anything else must still not kill the encode
            # thread — the deadline below keeps the federation moving
            logging.exception("round %d: async broadcast failed",
                              round_gen)
            if self.round_timeout is None:
                # fail-fast contract (_broadcast_model's own
                # no-deadline branch): with no deadline nothing can
                # ever recover a lost sync, and an exception on this
                # pool thread dies in its Future — re-raising would be
                # a SILENT permanent hang.  Tear the federation down
                # visibly instead.
                logging.critical(
                    "round %d: broadcast lost with no round deadline — "
                    "shutting the federation down (fail-fast)", round_gen,
                )
                self.finish()
                return
        dt = time.perf_counter() - t0
        get_telemetry().observe("span.encode_overlap_s", dt)
        with self._round_lock:
            self._bcast_task_s = dt
            if round_gen == self.round_idx:
                self._arm_deadline()

    def finish(self) -> None:
        # stats plane last words: final local fold, slo_report.json +
        # terminal status.json (idempotent — the fail-fast broadcast
        # path reaches here too)
        self._stats_finish()
        # non-blocking shutdown: the final _close_round runs ON a
        # decode worker when pipelining, and a wait=True here would
        # join the thread into itself.  Workers drain naturally; any
        # still-queued stale decode lands on a stopped backend's
        # rejection path.
        for pool in (self._decode_pool, self._encode_pool):
            if pool is not None:
                pool.shutdown(wait=False)
        super().finish()

    def _send_or_log(self, msg: Message) -> None:
        """Broadcast sends must not abort the round loop: a sync the
        transport cannot deliver right now (hub restarting, socket
        mid-reconnect — AFTER the backend's own bounded retries) just
        makes that node a straggler this round; the deadline covers it.

        Swallowing is only safe when a deadline EXISTS to cover the
        lost frame (or the federation is already over — FINISH): with
        ``round_timeout=None`` a dropped sync would hang the round
        forever, so there the legacy fail-fast raise is preserved."""
        try:
            self.send_message(msg)
        except OSError:
            if self.round_timeout is None and msg.type != MSG_TYPE_S2C_FINISH:
                raise
            get_telemetry().inc("comm.send_failed", msg_type=msg.type)
            logging.warning(
                "round %d: could not deliver %s to node %d (will rely "
                "on the round deadline)", self.round_idx, msg.type,
                msg.receiver,
            )


class FedAvgClientManager(NodeManager):
    """One federated participant: train on INIT/SYNC, upload, repeat."""

    def __init__(
        self,
        backend: CommBackend,
        local_update: LocalUpdateFn,
        dataset: FedDataset,
        *,
        batch_size: int,
        template_variables,
        seed: int = 0,
        train_delay: float = 0.0,
        crash_at_round: Optional[int] = None,
        error_feedback: bool = True,
        traffic=None,
        device: DeviceLike = None,
    ):
        # open-loop traffic model (faults/traffic.TrafficModel): this
        # client draws a seeded per-round arrival decision — offline
        # rounds are skipped (churn), delays sleep before training so
        # the upload arrives on the device's own clock.  None = the
        # closed-loop behavior, unchanged.
        self.traffic = traffic
        # the local update runs on this client's device (the card unless
        # the caller asks for the CPU); the sync decodes onto it
        self.device = resolve_device(device)
        self.local_update = local_update.fn
        self.dataset = dataset
        self.batch_size = batch_size
        self.template = treelib.tree_map(
            lambda l: (l.detach() if isinstance(l, torch.Tensor)
                       else torch.from_numpy(np.array(l))).to(self.device),
            template_variables,
        )
        self.seed = seed
        self.rounds_trained = 0
        # uplink compression (server-negotiated via the sync's codec
        # key): EF keeps the per-round quantization error and folds it
        # into the next update — on by default for lossy codecs
        self.error_feedback = error_feedback
        self._ef = {}  # ef_for store; one entry (this client's stream)
        # delta-broadcast base cache: round -> OWNED copy of the
        # reconstructed chain model (populated only when the server
        # announces delta mode via the sync's delta_window param).
        # Owned copies serve two contracts at once: any in-window delta
        # base is on hand across rounds, and nothing cached can alias a
        # transport buffer (an shm slab region is reclaimed the moment
        # delivery ends)
        from collections import OrderedDict

        self._bases: "OrderedDict[int, object]" = OrderedDict()
        self._base_window = 4
        # sha256 over every encoded upload's payload buffers, in send
        # order — the reproducibility probe a federation re-run compares
        # (same seed => identical digest)
        import hashlib

        self._upload_hash = hashlib.sha256()
        # artificial pre-training sleep: straggler injection for the
        # server's round-deadline path (tests/test_distributed_process)
        self.train_delay = train_delay
        # deterministic process crash: hard-exit (no cleanup, no FINISH)
        # when the sync for THIS round arrives — the chaos layer's
        # SIGKILL-at-round-r, reproducible across runs
        self.crash_at_round = crash_at_round
        # in-band stats plane: the entry point attaches a DigestReporter
        # here so FINISH stops it with one final delta flush (the
        # rollup then covers this client's whole run)
        self.stats_reporter = None
        super().__init__(backend)

    def register_message_receive_handlers(self):
        self.register_message_receive_handler(MSG_TYPE_S2C_INIT_CONFIG, self._on_sync)
        self.register_message_receive_handler(MSG_TYPE_S2C_SYNC_MODEL, self._on_sync)
        self.register_message_receive_handler(MSG_TYPE_S2C_FINISH, self._on_finish)

    def _on_sync(self, msg: Message):
        if (
            self.crash_at_round is not None
            and msg.get(MSG_ARG_KEY_ROUND_INDEX) == self.crash_at_round
        ):
            import os

            # the black box flushes on the way down (forced, bypassing
            # the rate limit) — a REAL SIGKILL leaves only the
            # faulthandler log, but this injected crash models a
            # process that still gets its last instruction through
            flight.trigger("crash", reason="crash_at_round",
                           round_idx=self.crash_at_round, force=True)
            # os._exit: skip atexit/finally — the process dies exactly
            # like a SIGKILL'd one, mid-protocol, socket left dangling
            os._exit(137)
        if self.train_delay:
            import time

            time.sleep(self.train_delay)
        if self.traffic is not None:
            r = msg.get(MSG_ARG_KEY_ROUND_INDEX)
            if r is not None:
                tel = get_telemetry()
                d = self.traffic.decide(self.backend.node_id, int(r))
                if d["offline"]:
                    # churned out this round: no training, no upload —
                    # the server's deadline (or async cut) covers it
                    tel.inc("traffic.offline_rounds")
                    return
                if d["straggler"]:
                    tel.inc("traffic.straggler_draws")
                if d["delay_s"] > 0.0:
                    import time

                    tel.inc("traffic.delayed_uploads")
                    tel.observe("traffic.upload_delay_s", d["delay_s"])
                    time.sleep(d["delay_s"])
        variables = self._reconstruct_sync(msg)
        if variables is None:
            return  # inapplicable delta: resync requested, round skipped
        client_idx = msg.get(MSG_ARG_KEY_CLIENT_INDEX)
        if client_idx is None:
            # multicast sync: ONE shared envelope for the whole cohort —
            # identity is derived from the node id (node = client + 1),
            # exactly what the per-node unicast params always carried
            client_idx = self.backend.node_id - 1
        round_idx = msg.get(MSG_ARG_KEY_ROUND_INDEX)
        # round-independent pack seed, matching FedAvgSimulation's
        # device-resident cohort blocks: the pack base order carries no
        # stochasticity (the local update re-permutes per epoch from the
        # (key, round, slot) stream), and per-client pack seeding is
        # id-keyed, so this single-client pack is bit-identical to the
        # client's row in the simulation's cohort pack
        pack = pack_clients(
            self.dataset, [client_idx], self.batch_size,
            steps_per_epoch=msg.get("steps_per_epoch"),
            seed=self.seed,
        )
        # identical stream to the compiled round engine: key→round→train→slot
        slot = msg.get("slot", client_idx)
        k_round = rnglib.fold_in(rnglib.PRNGKey(self.seed), round_idx)
        rng = rnglib.fold_in(rnglib.fold_in(k_round, 0), slot)

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        new_vars, metrics = self.local_update(
            variables, dev(pack.x[0]), dev(pack.y[0]), dev(pack.mask[0]), rng,
        )
        self.rounds_trained += 1
        reply = Message(MSG_TYPE_C2S_SEND_MODEL, self.backend.node_id, SERVER)
        # echo the round: the server rejects uploads from closed rounds
        reply.add_params(MSG_ARG_KEY_ROUND_INDEX, round_idx)
        codec_name = msg.get(MSG_ARG_KEY_CODEC) or "none"
        wire = self._encode_upload(
            codec_name, new_vars, variables, round_idx, slot
        )
        reply.add_params(MSG_ARG_KEY_MODEL_PARAMS, wire)
        reply.add_params(MSG_ARG_KEY_NUM_SAMPLES, float(pack.num_samples[0]))
        reply.add_params(
            MSG_ARG_KEY_LOCAL_METRICS, {k: float(v) for k, v in metrics.items()}
        )
        self.send_message(reply)

    def _reconstruct_sync(self, msg: Message):
        """One sync envelope → this round's model, via the SHARED
        ``reconstruct_sync_model`` (the muxer uses the same function —
        reconstruction cannot drift between topologies).  A delta whose
        base is not cached (fresh process, aged-out round) triggers a
        RESYNC request and returns None: this round is skipped and the
        server's unicast full resend (or the next full fallback)
        re-seeds the cache."""
        variables, self._base_window = reconstruct_sync_model(
            msg, self.template, self._bases, self._base_window
        )
        if variables is None:
            get_telemetry().inc("comm.delta_resyncs")
            logging.warning(
                "node %d: delta sync for round %s against unknown "
                "base %s — requesting full resync",
                self.backend.node_id, msg.get(MSG_ARG_KEY_ROUND_INDEX),
                msg.get(MSG_ARG_KEY_DELTA_BASE),
            )
            request_resync(self.send_message, self.backend.node_id,
                           msg.get(MSG_ARG_KEY_ROUND_INDEX))
        return variables

    def _encode_upload(self, codec_name: str, new_vars, synced_vars,
                       round_idx: int, slot: int):
        """Encode this client's upload via the SHARED
        ``encode_client_upload`` (the muxer's cohort engine calls the
        same function — byte-identity by construction) and fold it into
        the reproducibility digest.  Since the muxer landed, the digest
        covers EVERY upload — full-precision wiretrees included — so a
        same-seed muxed-vs-per-process comparison pins the fp32 path
        too, not just the codec one."""
        from fedml_tpu_torch.compress import wire_tree_digest
        from fedml_tpu_torch.obs import comm_obs

        wire, raw, comp = encode_client_upload(
            codec_name, new_vars, synced_vars, self.template,
            seed=self.seed, round_idx=round_idx, slot=slot,
            ef=ef_for(self._ef, 0, codec_name, self.error_feedback),
        )
        if raw is not None:
            comm_obs.record_compression(MSG_TYPE_C2S_SEND_MODEL, raw, comp)
        self._upload_hash.update(wire_tree_digest(wire).encode())
        return wire

    @property
    def upload_digest(self) -> str:
        """Accumulated sha256 of every encoded upload this client sent."""
        return self._upload_hash.hexdigest()

    def _on_finish(self, msg: Message):
        if self.stats_reporter is not None:
            # final flush BEFORE the backend stops: the last digest
            # frame rides the still-open connection
            self.stats_reporter.stop()
        self.finish()
