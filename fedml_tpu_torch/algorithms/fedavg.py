"""FedAvg on one GPU (port of ``fedml_tpu/algorithms/fedavg.py``).

One round: each client of the packed cohort runs its local update, one
after another (the JAX package's ``lax.map``; nothing is vmapped), and is
folded into an fp32 sample-weighted sum of EVERY variable, ``batch_stats``
included, as soon as it finishes; then ``agg = num / den``.  Client
subsampling and dropout are a participation mask folded into the
weights.  A round whose weights sum to zero (every client dropped) is a
no-op, not a division.  With an ``aggregate_transform`` (robust
aggregation's hook) the clients' variables are stacked first, transformed
together, then folded in the same order.

With a ``codec`` (``compress/``) each client's update goes through the
lossy uplink before it is folded in: the server aggregates
``g + decode(encode(c − g))``, with the error-feedback residual of the
client's slot added to the update first and the new quantization error
kept in ``ServerState.residuals``.

Randomness is the JAX package's, bit for bit (``core/rng.py``): the round
key ``k_round = fold_in(state.key, round)``, the training stream
``fold_in(k_round, 0)`` with one key per client slot, the aggregation
stream ``fold_in(k_round, 1)``, the compression stream
``fold_in(k_round, 2)``.  So R rounds of a fused driver equal R calls of
the round function, and a checkpoint of the state resumes
bit-identically.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from fedml_tpu_torch.compress.codecs import (
    COMPRESS_STREAM,
    FlatLayout,
    encoded_nbytes,
    get_codec,
    uplink_roundtrip,
)
from fedml_tpu_torch.core import rng as rnglib
from fedml_tpu_torch.core import tree as treelib
from fedml_tpu_torch.core.client import (
    LocalUpdateFn,
    eval_summary,
    make_client_optimizer,
    make_evaluator,
    make_local_update,
)
from fedml_tpu_torch.core.losses import LossFn, masked_softmax_ce
from fedml_tpu_torch.core.metrics import MetricsLogger
from fedml_tpu_torch.core.sampling import (
    eligible_participation_mask,
    host_sample_ids,
    inject_dropout,
)
from fedml_tpu_torch.core.types import (
    FedDataset,
    batch_eval_pack,
    cohort_steps_per_epoch,
    device_resident_pack,
)
from fedml_tpu_torch.models.base import ModelBundle, Variables
from fedml_tpu_torch.obs.torch_hooks import instrument_signatures, record_device_memory
from fedml_tpu_torch.parallel.compat import psum
from fedml_tpu_torch.utils.device import DeviceLike, resolve_device

# (old_variables, aggregated_variables, opt_state) -> (new_variables, opt_state)
ServerUpdateFn = Callable[[Variables, Variables, Any], Tuple[Variables, Any]]

_TRAIN_STREAM = 0
_AGG_STREAM = 1


class ServerState(NamedTuple):
    variables: Variables
    opt_state: Any
    round_idx: int
    key: rnglib.Key
    # error-feedback residual store of update compression: the variables'
    # tree with a leading [num_clients] axis, fp32, () when EF is off
    residuals: Any = ()


class InjectedCrash(SystemExit):
    """The crash ``crash_at_round`` schedules: exits the process with 137,
    as the JAX package's ``os._exit(137)`` does, unless a caller catches
    this type.  No checkpoint is written on the way out."""

    def __init__(self, round_idx: int):
        super().__init__(137)
        self.round_idx = round_idx


def default_server_update(old, agg, opt_state):
    """Plain FedAvg: the aggregate replaces the global model."""
    del old
    return agg, opt_state


def resolve_compute_dtype(name) -> Optional[torch.dtype]:
    """'bf16'/'bfloat16'/'fp32'/None → torch dtype or None (fp32 = off)."""
    if name is None or name in ("fp32", "float32"):
        return None
    if name in ("bf16", "bfloat16"):
        return torch.bfloat16
    if name in ("fp16", "float16"):
        raise ValueError(
            "float16 compute needs loss scaling, which this path does not "
            "implement; use bf16"
        )
    raise ValueError(f"unknown compute dtype: {name!r}")


def make_round_fn(
    local_update: LocalUpdateFn,
    *,
    server_update: ServerUpdateFn = default_server_update,
    aggregate_transform: Optional[Callable] = None,
    device: DeviceLike = None,
    codec=None,
    error_feedback: bool = False,
    axis_name: Optional[str] = None,
    aggregate_impl: Optional[Callable] = None,
):
    """Build the per-round function over a packed client block.

    ``round_fn(state, x, y, mask, num_samples, participation, slot_ids)``
    with the client axis K leading the data args; ``participation`` is
    the [K] 0/1 mask and ``slot_ids`` the clients' global slot ids (they
    key each client's random stream).  Returns ``(new_state, metrics)``
    with participation-weighted sums of the clients' metrics plus
    ``participants``.

    ``aggregate_transform(old_variables, stacked_client_variables,
    weights, keys) -> stacked_client_variables`` runs on the clients'
    variables stacked on a leading K axis, with one aggregation-stream key
    per client (``keys`` [K, 2]), before the weighted sum.

    ``codec`` (a ``compress`` LeafCodec) runs each client's update
    ``delta = c − g`` (fp32) through ``decode(encode(delta))`` under
    ``fold_in(fold_in(k_round, 2), slot)`` before aggregation: what a
    real transport would reconstruct.  ``error_feedback`` adds the slot's
    row of ``state.residuals`` to ``delta`` first and keeps ``delta −
    decoded`` there for the next round, for participating clients only.

    ``aggregate_impl(weights, stacked_client_variables) -> num`` replaces
    the weighted fold: the clients' variables are stacked on a leading K
    axis and it returns the fp32 weighted sum.

    With ``axis_name`` the block is this rank's share of a mesh axis
    (``parallel/spmd.py``): ``num``, ``den``, ``participants`` and every
    participation-weighted metric are ``psum``'d over that axis of the
    bound mesh, so every rank ends the round with the same state.  The
    clients' streams stay keyed by their global slot ids, whichever rank
    holds them."""
    if error_feedback and axis_name is not None:
        raise ValueError(
            "error_feedback is not defined under shard_map (axis_name="
            f"{axis_name!r}): the residual store is gathered by GLOBAL "
            "slot id, which a device-local block cannot index; compress "
            "on the host path instead"
        )
    if error_feedback and codec is None:
        raise ValueError("error_feedback needs a codec")
    dev = resolve_device(device)
    layout: Optional[FlatLayout] = None  # the model's, built at the first round

    @torch.no_grad()
    def round_fn(state: ServerState, x, y, mask, num_samples, participation,
                 slot_ids):
        nonlocal layout
        x, y, mask, num_samples, participation = (
            t.to(dev) for t in (x, y, mask, num_samples, participation))
        weights = participation * num_samples  # sample-weighted, masked
        ids = [int(i) for i in np.asarray(torch.as_tensor(slot_ids).cpu())]
        k_round = rnglib.fold_in(state.key, state.round_idx)
        k_train = rnglib.fold_in(k_round, _TRAIN_STREAM)
        residuals = state.residuals
        if codec is not None:
            k_comp = rnglib.fold_in(k_round, COMPRESS_STREAM)
            if layout is None:
                layout = FlatLayout(state.variables, dev)
            global_flat = layout.flatten(state.variables)
            if error_feedback:
                if not isinstance(residuals, dict):
                    raise ValueError("error_feedback needs the residual store "
                                     "in state.residuals")
                residuals = treelib.tree_map(torch.clone, residuals)
        num = None
        clients = []
        train_metrics: dict = {}
        for k, slot in enumerate(ids):
            cvars, cm = local_update(state.variables, x[k], y[k], mask[k],
                                     rnglib.fold_in(k_train, slot))
            if codec is not None:
                old = layout.row(residuals, slot) if error_feedback else None
                cvars, new = uplink_roundtrip(
                    codec, layout, global_flat, cvars, state.variables,
                    rnglib.fold_in(k_comp, slot), old)
                if error_feedback:
                    # a client that did not report keeps its residual
                    layout.set_row(residuals, slot,
                                   torch.where(participation[k] > 0, new, old))
            if aggregate_transform is None and aggregate_impl is None:
                num = treelib.tree_fold_weighted_f32(num, cvars, weights[k])
            else:
                clients.append(cvars)
            for name, v in cm.items():
                w = participation[k] * v
                train_metrics[name] = train_metrics[name] + w if name in train_metrics else w
        if clients:
            stacked = treelib.tree_stack(clients)
            if aggregate_transform is not None:
                k_agg = rnglib.fold_in(k_round, _AGG_STREAM)
                keys = np.stack([rnglib.fold_in(k_agg, slot) for slot in ids])
                stacked = aggregate_transform(state.variables, stacked, weights, keys)
            if aggregate_impl is not None:
                num = aggregate_impl(weights, stacked)
            else:
                for k in range(len(ids)):
                    num = treelib.tree_fold_weighted_f32(
                        num, treelib.tree_index(stacked, k), weights[k])
        den = weights.sum()
        n_participants = participation.sum()
        if axis_name is not None:
            num, den, n_participants, train_metrics = psum(
                (num, den, n_participants, train_metrics), axis_name)
        # zero-participation guard: with den == 0 the weighted average is
        # undefined, so the round leaves the model untouched
        agg = treelib.tree_map(
            lambda s, ref: torch.where(
                den > 0, (s / torch.clamp_min(den, 1e-12)).to(ref.dtype), ref),
            num, state.variables)
        new_vars, new_opt = server_update(state.variables, agg, state.opt_state)
        train_metrics["participants"] = n_participants
        return ServerState(new_vars, new_opt, state.round_idx + 1, state.key,
                           residuals), train_metrics

    # the mesh axis travels with the kernel, so a fused driver handed a
    # pre-built SPMD kernel still refuses on-device sampling
    round_fn.axis_name = axis_name
    return round_fn


def _resolve_round_fn(local_update, round_fn, round_kw, device,
                      on_device_sampling: bool = False):
    """A pre-built round kernel (kernel-shaping kwargs must then be baked
    into it), or a new ``make_round_fn`` kernel.

    ``on_device_sampling`` marks a caller that draws each round's
    participation mask itself (clients_per_round / drop_prob): under a
    mesh axis each rank sees only its block, so such a draw would be
    rank-local.  The axis is read from ``round_kw`` or from the tag
    ``make_round_fn`` stamps on its kernels."""
    baked_axis = round_kw.get("axis_name") or getattr(round_fn, "axis_name", None)
    if on_device_sampling and baked_axis:
        raise ValueError(
            "on-device clients_per_round/drop_prob are not defined under "
            f"shard_map (axis_name={baked_axis!r}: local block != global "
            "client axis); pass per-round masks from the host instead"
        )
    if round_fn is None:
        return make_round_fn(local_update, device=device, **round_kw)
    if round_kw:
        raise ValueError(
            "round_fn is a pre-built kernel; kernel-shaping kwargs "
            f"{sorted(round_kw)} must be baked into it")
    return round_fn


def _stack_metrics(rows):
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


def make_multi_round_fn(
    local_update: Optional[LocalUpdateFn],
    rounds_per_call: int,
    *,
    clients_per_round: Optional[int] = None,
    drop_prob: float = 0.0,
    round_fn: Optional[Callable] = None,
    device: DeviceLike = None,
    **round_kw,
):
    """Run ``rounds_per_call`` rounds over a resident cohort in one call,
    with no host read-back between rounds.  ``clients_per_round``
    re-draws a uniform participation mask among the eligible clients each
    round and ``drop_prob`` composes ``inject_dropout`` on top, both under
    ``(state.key, round)``.  Returns ``(final_state, metrics)`` with each
    metric stacked ``[rounds_per_call]``."""
    if clients_per_round is not None and clients_per_round < 1:
        raise ValueError(
            f"clients_per_round must be >= 1, got {clients_per_round}")
    dev = resolve_device(device)
    rf = _resolve_round_fn(local_update, round_fn, round_kw, dev,
                           on_device_sampling=clients_per_round is not None
                           or bool(drop_prob))

    def multi_round_fn(state: ServerState, x, y, mask, num_samples,
                       participation, slot_ids):
        participation = participation.to(dev)
        num_clients = participation.shape[0]
        rows = []
        for _ in range(rounds_per_call):
            part = participation
            if clients_per_round is not None and clients_per_round < num_clients:
                part = eligible_participation_mask(
                    state.key, state.round_idx, participation, clients_per_round)
            if drop_prob:
                part = inject_dropout(state.key, state.round_idx, part, drop_prob)
            state, m = rf(state, x, y, mask, num_samples, part, slot_ids)
            rows.append(m)
        return state, _stack_metrics(rows)

    return multi_round_fn


def make_scheduled_multi_round_fn(
    local_update: Optional[LocalUpdateFn],
    *,
    drop_prob: float = 0.0,
    drop_seed: int = 0,
    round_fn: Optional[Callable] = None,
    device: DeviceLike = None,
    **round_kw,
):
    """Run R rounds whose cohorts differ per round in one call: every data
    arg carries a leading ``[R]`` round axis, one cohort block per round
    (the host pre-samples and packs them).  ``drop_prob`` reproduces
    ``FedAvgSimulation.run_round``'s draw, ``inject_dropout(
    PRNGKey(drop_seed), round, ...)``, so the rounds equal the dispatch
    loop's.  Returns ``(final_state, metrics)`` stacked ``[R]``."""
    dev = resolve_device(device)
    rf = _resolve_round_fn(local_update, round_fn, round_kw, dev,
                           on_device_sampling=bool(drop_prob))
    drop_key = rnglib.PRNGKey(drop_seed)

    def scheduled_fn(state: ServerState, x, y, mask, num_samples,
                     participation, slot_ids):
        rows = []
        for r in range(x.shape[0]):
            part = participation[r].to(dev)
            if drop_prob:
                part = inject_dropout(drop_key, state.round_idx, part, drop_prob)
            state, m = rf(state, x[r], y[r], mask[r], num_samples[r], part,
                          slot_ids[r])
            rows.append(m)
        return state, _stack_metrics(rows)

    return scheduled_fn


@dataclasses.dataclass
class FedAvgConfig:
    num_clients: int = 10
    clients_per_round: int = 10
    comm_rounds: int = 10
    epochs: int = 1
    batch_size: int = 10
    client_optimizer: str = "sgd"
    lr: float = 0.03
    momentum: float = 0.0
    # None = optimizer default (0 for sgd, 1e-4 for adam)
    weight_decay: Optional[float] = None
    grad_clip: Optional[float] = None
    frequency_of_the_test: int = 5
    seed: int = 0
    prox_mu: float = 0.0  # FedProx is FedAvg with mu > 0
    # "bf16": forward/backward in bfloat16, fp32 masters and aggregation
    compute_dtype: Optional[str] = None
    # each sampled client independently drops mid-round with this probability
    drop_prob: float = 0.0
    # update compression: the uplink codec simulated inside the round,
    # "int8"/"qsgd8", "int4"/"qsgd4", "bf16", "topk<rate>"; None/"" = off.
    # compress_ef threads the error-feedback residual store through
    # ServerState (needed for topk, recommended for the quantizers)
    compress_codec: Optional[str] = None
    compress_ef: bool = False


class FedAvgSimulation:
    """Single-process simulation driver (the reference's standalone mode).

    Per round: seeded uniform sampling of K clients on the host, their
    shards packed to fixed shape and kept on the device, one round
    function call, periodic evaluation.  ``augment_fn`` is the per-epoch
    augmentation of the local update; ``aggregate_transform`` the round's
    hook (``make_round_fn``); ``server_opt_init(variables)`` the initial
    server optimizer state ``server_update`` reads; ``client_lr`` a float
    or schedule (count -> lr) in place of ``config.lr``.
    ``config.compress_codec`` runs the uplink codec inside the round, with
    a zero residual store per client at round 0 under ``compress_ef``.
    ``local_update`` replaces the one built from the config.  The initial
    variables are flax's under ``PRNGKey(config.seed)``.

    Subclasses (the algorithm family) override ``_build_round_fn`` (their
    own round kernel), ``_sample_ids`` (the cohort), ``_cohort_block`` (the
    cohort's device block), ``_annotate_round`` (fields of a history row)
    and ``_extra_eval`` (metrics beside ``evaluate_global``)."""

    def __init__(
        self,
        bundle: ModelBundle,
        dataset: FedDataset,
        config: FedAvgConfig,
        *,
        loss_fn: LossFn = masked_softmax_ce,
        server_update: ServerUpdateFn = default_server_update,
        server_opt_init: Optional[Callable[[Variables], Any]] = None,
        aggregate_transform: Optional[Callable] = None,
        local_update: Optional[LocalUpdateFn] = None,
        augment_fn: Optional[Callable] = None,
        client_lr: Optional[Any] = None,
        metrics: Optional[MetricsLogger] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        if bundle.device != self.device:
            raise ValueError(
                f"model variables live on {bundle.device}, simulation on "
                f"{self.device}")
        self.bundle = bundle
        self.dataset = dataset
        self.cfg = config
        self.metrics = metrics or MetricsLogger()
        optimizer = make_client_optimizer(
            config.client_optimizer, config.lr if client_lr is None else client_lr,
            momentum=config.momentum, weight_decay=config.weight_decay,
            grad_clip=config.grad_clip,
        )
        self.local_update = local_update or make_local_update(
            bundle, optimizer, config.epochs, loss_fn,
            prox_mu=config.prox_mu, augment_fn=augment_fn,
            compute_dtype=resolve_compute_dtype(config.compute_dtype),
        )
        self._server_update = server_update
        self._aggregate_transform = aggregate_transform
        self._codec = get_codec(config.compress_codec)
        self._codec_ef = bool(config.compress_ef) and self._codec is not None
        if (self._codec is not None and type(self)._build_round_fn
                is not FedAvgSimulation._build_round_fn):
            # a subclass's own round kernel has no compression stage:
            # refuse rather than silently train uncompressed
            raise ValueError(
                f"{type(self).__name__} builds its own round kernel; "
                "compress_codec is only wired through the base FedAvg "
                "kernel (make_round_fn)")
        # new-signature tracking (obs layer): a cohort geometry that varies
        # per round shows as calls.new_signature{fn=round_fn} climbing
        tel = self.metrics.telemetry
        self.round_fn = instrument_signatures(self._build_round_fn(),
                                              "round_fn", telemetry=tel)
        self.evaluator = instrument_signatures(make_evaluator(bundle, loss_fn),
                                               "evaluator", telemetry=tel)
        variables = bundle.init(rnglib.PRNGKey(config.seed))
        opt_state = server_opt_init(variables) if server_opt_init else ()
        # EF residual store: one fp32 row per client of the whole
        # population, so sampled cohorts gather/scatter rows by slot id
        residuals = ()
        if self._codec_ef:
            residuals = treelib.tree_map(
                lambda t: torch.zeros((config.num_clients, *t.shape),
                                      dtype=torch.float32, device=self.device),
                variables)
        self.state = ServerState(variables, opt_state, 0,
                                 rnglib.PRNGKey(config.seed), residuals)
        self.steps_per_epoch = cohort_steps_per_epoch(dataset, config.batch_size)
        self._test_pack = None  # (x, y, mask) on device, built at first eval
        self.history = []
        self._pack_cache: Optional[tuple] = None
        # checkpoint/resume (attach_checkpointing) and crash injection
        self._ckpt_mgr = None
        self._ckpt_every = 0
        self._ckpt_last: Optional[int] = None
        self.crash_at_round: Optional[int] = None
        # model payload per participant per direction (fp32 wire bytes)
        self._model_nbytes = sum(
            t.numel() * t.element_size()
            for t in treelib.tree_leaves(variables))
        # exact encoded bytes per upload (static given the shapes)
        self._enc_nbytes = (encoded_nbytes(self._codec, variables)
                            if self._codec is not None else self._model_nbytes)

    def _build_round_fn(self):
        """Subclass hook: the round kernel (FedNova and FedNAS build their
        own; those refuse ``compress_codec``)."""
        return make_round_fn(
            self.local_update, server_update=self._server_update,
            aggregate_transform=self._aggregate_transform, device=self.device,
            codec=self._codec, error_feedback=self._codec_ef)

    # -- checkpoint/resume --------------------------------------------------
    def attach_checkpointing(self, manager, every: int = 1) -> None:
        """Save the full round state (variables, server optimizer state,
        round index, key, EF residuals) every ``every`` completed rounds
        and at the end of each run call.  Every random stream derives from
        ``(state.key, state.round_idx)``, so a restored state continues
        bit-identically."""
        self._ckpt_mgr = manager
        self._ckpt_every = max(1, int(every))

    def resume(self) -> int:
        """Restore the latest readable checkpoint into ``self.state`` (onto
        this simulation's device); returns the number of completed rounds
        (0 = nothing to restore)."""
        if self._ckpt_mgr is None or self._ckpt_mgr.latest_step() is None:
            return 0
        self.state = self._ckpt_mgr.restore(like=self.state)
        done = int(self.state.round_idx)
        self._ckpt_last = done
        self.metrics.telemetry.event("resume", round=done)
        return done

    def _maybe_checkpoint(self, final: bool = False) -> None:
        if self._ckpt_mgr is None:
            return
        step = int(self.state.round_idx)
        if step == self._ckpt_last:  # this step is already on disk
            return
        if final or step % self._ckpt_every == 0:
            with self.metrics.span("checkpoint"):
                self._ckpt_mgr.save(step, self.state)
            self._ckpt_last = step

    def _crash_if_scheduled(self) -> None:
        """Fault injection: raise ``InjectedCrash`` right before the
        scheduled round trains (the crash half of crash-then-resume)."""
        if (self.crash_at_round is not None
                and int(self.state.round_idx) == self.crash_at_round):
            raise InjectedCrash(self.crash_at_round)

    # -- rounds ---------------------------------------------------------------
    def _count_degraded(self, row: dict) -> None:
        """A round with an empty realized cohort left the model untouched."""
        if row.get("participants", 1.0) <= 0:
            self.metrics.telemetry.inc("rounds.degraded")

    def _sample_ids(self, round_idx: int) -> np.ndarray:
        return host_sample_ids(self.cfg.seed, round_idx, self.cfg.num_clients,
                               self.cfg.clients_per_round)

    def _device_pack(self, ids) -> tuple:
        """The cohort's packed block, kept on the device while the cohort
        stays the same (always, under full participation)."""
        key = tuple(int(i) for i in ids)
        if self._pack_cache is not None and self._pack_cache[0] == key:
            return self._pack_cache[1]
        args, _ = device_resident_pack(
            self.dataset, ids, self.cfg.batch_size,
            steps_per_epoch=self.steps_per_epoch, seed=self.cfg.seed,
            device=self.device,
        )
        self._pack_cache = (key, args)
        return args

    def _cohort_block(self, ids, round_idx: int) -> tuple:
        """Subclass hook: the (x, y, mask, num_samples) device block of
        this round's cohort."""
        del round_idx
        return self._device_pack(ids)

    def _annotate_round(self, out: dict, ids, round_idx: int) -> None:
        """Subclass hook: add per-round fields to the history row."""

    def _extra_eval(self) -> dict:
        """Subclass hook: metrics added at each evaluation (e.g. the
        robust driver's backdoor accuracy)."""
        return {}

    def _record_sim_comm(self, cohort: int, rounds: int = 1,
                         uploads: Optional[int] = None) -> None:
        """The federation traffic a real transport would move for the
        simulated rounds: the model down to each participant and one
        update back from each survivor, on the comm counter series.
        Uplink bytes follow the codec (its exact encoded size), and a
        compressed run also counts ``comm.raw_bytes`` (fp32) beside
        ``comm.compressed_bytes``.  ``uploads`` defaults to the cohort;
        dispatch rounds pass the realized count, the fused drivers the
        expectation, as the JAX package does."""
        t = self.metrics.telemetry
        down = cohort * rounds
        up = down if uploads is None else uploads
        t.inc("comm.sent_msgs", down, msg_type="S2C_SYNC_MODEL")
        t.inc("comm.sent_bytes", self._model_nbytes * down,
              msg_type="S2C_SYNC_MODEL")
        t.inc("comm.recv_msgs", up, msg_type="C2S_SEND_MODEL")
        t.inc("comm.recv_bytes", self._enc_nbytes * up,
              msg_type="C2S_SEND_MODEL")
        if self._codec is not None:
            t.inc("comm.raw_bytes", self._model_nbytes * up,
                  msg_type="C2S_SEND_MODEL")
            t.inc("comm.compressed_bytes", self._enc_nbytes * up,
                  msg_type="C2S_SEND_MODEL")

    @staticmethod
    def _train_row(metrics: dict, round_idx: int) -> dict:
        out = dict(metrics, round=round_idx)
        if out.get("count", 0) > 0:
            out["train_acc"] = out["correct"] / out["count"]
            out["train_loss"] = out["loss_sum"] / out["count"]
        return out

    def run_round(self) -> dict:
        round_idx = int(self.state.round_idx)
        with self.metrics.span("sample"):
            ids = self._sample_ids(round_idx)
        with self.metrics.span("pack"):
            x, y, mask, num_samples = self._cohort_block(ids, round_idx)
        participation = torch.ones(len(ids), device=self.device)
        if self.cfg.drop_prob > 0.0:
            participation = inject_dropout(
                rnglib.PRNGKey(self.cfg.seed), round_idx, participation,
                self.cfg.drop_prob)
        with self.metrics.span("round"):
            self.state, metrics = self.round_fn(
                self.state, x, y, mask, num_samples, participation, ids)
            # the float() read-backs wait for the device, so the span
            # measures the round, not the enqueue
            out = {k: float(v) for k, v in metrics.items()}
        self._record_sim_comm(len(ids), uploads=int(round(out["participants"])))
        out = self._train_row(out, round_idx)
        self._annotate_round(out, ids, round_idx)
        return out

    def evaluate_global(self) -> dict:
        if self._test_pack is None:
            pack = batch_eval_pack(self.dataset.test_x, self.dataset.test_y,
                                   max(self.cfg.batch_size, 64))
            self._test_pack = tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for a in pack)
        res = self.evaluator(self.state.variables, *self._test_pack)
        return eval_summary(res)

    def run(self, rounds: Optional[int] = None, log_fn=None) -> list:
        rounds = rounds if rounds is not None else self.cfg.comm_rounds
        for i in range(rounds):
            self._crash_if_scheduled()
            metrics = self.run_round()
            self._count_degraded(metrics)
            r = metrics["round"]
            # the final eval keys on this call's last round, so run(rounds=N)
            # and resumed runs end with test metrics too
            if r % self.cfg.frequency_of_the_test == 0 or i == rounds - 1:
                with self.metrics.span("eval"):
                    metrics.update(self.evaluate_global())
                metrics.update(self._extra_eval())
                record_device_memory(self.metrics.telemetry)
            metrics.update(self.metrics.pop_spans())
            self.metrics.log(metrics, step=r)
            self.history.append(metrics)
            if log_fn:
                log_fn(metrics)
            self._maybe_checkpoint()
        self._maybe_checkpoint(final=True)
        return self.history

    def run_fused(self, rounds: Optional[int] = None, log_fn=None,
                  rounds_per_call: Optional[int] = None) -> list:
        """Full-participation driver: the rounds BETWEEN evals run as one
        ``make_multi_round_fn`` call with no host read-back in between.
        Equal to ``run()`` round for round (same random streams, same
        resident cohort block).  A subclass's ``_build_round_fn`` is
        honoured; a ``_cohort_block`` override (a block that changes per
        round) is refused, since the resident block is packed once."""
        cfg = self.cfg
        if cfg.clients_per_round < cfg.num_clients:
            raise ValueError(
                "run_fused is the full-participation driver "
                f"(clients_per_round={cfg.clients_per_round} < "
                f"num_clients={cfg.num_clients}); use run()")
        if type(self)._cohort_block is not FedAvgSimulation._cohort_block:
            raise ValueError(
                "run_fused cannot honor the _cohort_block override of "
                f"{type(self).__name__}; use run()")
        rounds = rounds if rounds is not None else cfg.comm_rounds
        ids = np.arange(cfg.num_clients)
        x, y, mask, num_samples = self._cohort_block(ids, 0)
        participation = torch.ones(len(ids), device=self.device)

        def run_chunk(base, n, chunk_ids):
            del base, chunk_ids
            fused = make_multi_round_fn(None, n, drop_prob=cfg.drop_prob,
                                        round_fn=self.round_fn, device=self.device)
            with self.metrics.span("round"):
                self.state, stacked = fused(self.state, x, y, mask,
                                            num_samples, participation, ids)
            return stacked

        return self._drive_chunks(rounds, rounds_per_call, run_chunk,
                                  ids_for_round=lambda r: ids, log_fn=log_fn)

    def run_fused_sampled(self, rounds: Optional[int] = None, log_fn=None,
                          rounds_per_call: int = 25) -> list:
        """Sampled-cohort driver: the host pre-draws the next chunk's
        cohorts from the same ``host_sample_ids`` stream ``run()`` uses,
        stacks their blocks ``[R, K, ...]``, and one
        ``make_scheduled_multi_round_fn`` call runs the chunk.  Equal to
        ``run()`` round for round, dropout included.  Both subclass hooks
        are honoured: each round's block comes through ``_cohort_block``
        (the robust attacker's swap) and the chunk runs the subclass's
        round kernel (FedNova's)."""
        cfg = self.cfg
        rounds = rounds if rounds is not None else cfg.comm_rounds
        fused = instrument_signatures(make_scheduled_multi_round_fn(
            None, drop_prob=cfg.drop_prob, drop_seed=cfg.seed,
            round_fn=self.round_fn, device=self.device),
            "scheduled_round_fn", telemetry=self.metrics.telemetry)

        def run_chunk(base, n, chunk_ids):
            with self.metrics.span("pack"):
                blocks = [self._cohort_block(ids, base + i)
                          for i, ids in enumerate(chunk_ids)]
                stacked_args = tuple(torch.stack([b[j] for b in blocks])
                                     for j in range(4))
            part = torch.ones((n, len(chunk_ids[0])), device=self.device)
            with self.metrics.span("round"):
                self.state, stacked = fused(self.state, *stacked_args, part,
                                            np.stack(chunk_ids))
            return stacked

        return self._drive_chunks(rounds, rounds_per_call, run_chunk,
                                  ids_for_round=self._sample_ids, log_fn=log_fn)

    def _drive_chunks(self, rounds, rounds_per_call, run_chunk, *,
                      ids_for_round, log_fn):
        """The fused drivers' chunking: chunks end exactly on ``run()``'s
        eval rounds (``r % freq == 0``, plus the last round) so the history
        matches the dispatch loop row for row; ``rounds_per_call`` caps a
        chunk (0/None = uncapped).  Chunk boundaries are the checkpoint
        cadence (no mid-chunk state exists on the host)."""
        freq = self.cfg.frequency_of_the_test
        base0 = int(self.state.round_idx)
        eval_rounds = sorted(
            {r for r in range(base0, base0 + rounds) if r % freq == 0}
            | {base0 + rounds - 1})
        done = 0
        while done < rounds:
            base = base0 + done
            n = next(r for r in eval_rounds if r >= base) - base + 1
            if rounds_per_call:
                n = min(n, rounds_per_call)
            with self.metrics.span("sample"):
                chunk_ids = [ids_for_round(base + i) for i in range(n)]
            # run_chunk spans its own round (the sampled driver packs first);
            # the float() read-backs wait for the chunk's device work
            stacked = run_chunk(base, n, chunk_ids)
            with self.metrics.span("round"):
                rows = []
                for i in range(n):
                    out = self._train_row(
                        {k: float(v[i]) for k, v in stacked.items()}, base + i)
                    self._annotate_round(out, chunk_ids[i], base + i)
                    self._count_degraded(out)
                    rows.append(out)
            # the JAX engine draws a fused chunk's dropout on the device,
            # out of the host's sight, and counts the expected uploads
            cohort = len(chunk_ids[0])
            self._record_sim_comm(
                cohort, rounds=n,
                uploads=int(round(cohort * n * (1.0 - self.cfg.drop_prob))))
            if base + n - 1 in eval_rounds:
                with self.metrics.span("eval"):
                    rows[-1].update(self.evaluate_global())
                rows[-1].update(self._extra_eval())
                record_device_memory(self.metrics.telemetry)
            # chunk-level spans ride the chunk's last row
            rows[-1].update(self.metrics.pop_spans())
            self.history.extend(rows)
            for r in rows:
                self.metrics.log(r, step=r["round"])
                if log_fn:
                    log_fn(r)
            done += n
            self._maybe_checkpoint()
        self._maybe_checkpoint(final=True)
        return self.history
