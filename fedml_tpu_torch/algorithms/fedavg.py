"""FedAvg on one GPU (port of ``fedml_tpu/algorithms/fedavg.py``).

One round: each client of the packed cohort runs its local update, one
after another (the JAX package's ``lax.map``; nothing is vmapped), and is
folded into an fp32 sample-weighted sum of EVERY variable, ``batch_stats``
included, as soon as it finishes; then ``agg = num / den``.  Client
subsampling and dropout are a participation mask folded into the
weights.  A round whose weights sum to zero (every client dropped) is a
no-op, not a division.

Randomness: every stream derives from ``fold_in(state.seed, round, ...)``
(``core/rng.py``), so R rounds of ``make_multi_round_fn`` equal R calls
of the round function.  The streams are not JAX's bits.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

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
from fedml_tpu_torch.core.rng import fold_in
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
from fedml_tpu_torch.utils.device import DeviceLike, resolve_device

# (old_variables, aggregated_variables, opt_state) -> (new_variables, opt_state)
ServerUpdateFn = Callable[[Variables, Variables, Any], Tuple[Variables, Any]]

_TRAIN_STREAM = 0


class ServerState(NamedTuple):
    variables: Variables
    opt_state: Any
    round_idx: int
    seed: int


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
    device: DeviceLike = None,
    codec=None,
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

    ``codec``, ``axis_name`` and ``aggregate_impl`` (lossy uplink, the
    multi-device mesh, pluggable aggregation) are not ported yet."""
    for name, value in (("codec", codec), ("axis_name", axis_name),
                        ("aggregate_impl", aggregate_impl)):
        if value is not None:
            raise NotImplementedError(f"make_round_fn({name}=...) is not ported yet")
    dev = resolve_device(device)

    @torch.no_grad()
    def round_fn(state: ServerState, x, y, mask, num_samples, participation,
                 slot_ids):
        x, y, mask, num_samples, participation = (
            t.to(dev) for t in (x, y, mask, num_samples, participation))
        weights = participation * num_samples  # sample-weighted, masked
        ids = torch.as_tensor(slot_ids).tolist()
        num = None
        train_metrics: dict = {}
        for k, slot in enumerate(ids):
            seed = fold_in(state.seed, state.round_idx, _TRAIN_STREAM, slot)
            cvars, cm = local_update(state.variables, x[k], y[k], mask[k], seed)
            num = treelib.tree_fold_weighted(num, cvars, weights[k])
            for name, v in cm.items():
                w = participation[k] * v
                train_metrics[name] = train_metrics[name] + w if name in train_metrics else w
        den = weights.sum()
        # zero-participation guard: with den == 0 the weighted average is
        # undefined, so the round leaves the model untouched
        agg = treelib.tree_map(
            lambda s, ref: torch.where(
                den > 0, (s / torch.clamp_min(den, 1e-12)).to(ref.dtype), ref),
            num, state.variables)
        new_vars, new_opt = server_update(state.variables, agg, state.opt_state)
        train_metrics["participants"] = participation.sum()
        return ServerState(new_vars, new_opt, state.round_idx + 1,
                           state.seed), train_metrics

    return round_fn


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
    round and ``drop_prob`` composes ``inject_dropout`` on top, both from
    (state.seed, round).  Returns ``(final_state, metrics)`` with each
    metric stacked ``[rounds_per_call]``.  ``round_fn`` is a pre-built
    round kernel (kernel-shaping kwargs must then be baked into it)."""
    if clients_per_round is not None and clients_per_round < 1:
        raise ValueError(
            f"clients_per_round must be >= 1, got {clients_per_round}")
    dev = resolve_device(device)
    if round_fn is not None:
        if round_kw:
            raise ValueError(
                "round_fn is a pre-built kernel; kernel-shaping kwargs "
                f"{sorted(round_kw)} must be baked into it")
        rf = round_fn
    else:
        rf = make_round_fn(local_update, device=dev, **round_kw)

    def multi_round_fn(state: ServerState, x, y, mask, num_samples,
                       participation, slot_ids):
        participation = participation.to(dev)
        num_clients = participation.shape[0]
        rows = []
        for _ in range(rounds_per_call):
            part = participation
            if clients_per_round is not None and clients_per_round < num_clients:
                part = eligible_participation_mask(
                    state.seed, state.round_idx, participation, clients_per_round)
            if drop_prob:
                part = inject_dropout(state.seed, state.round_idx, part, drop_prob)
            state, m = rf(state, x, y, mask, num_samples, part, slot_ids)
            rows.append(m)
        return state, {k: torch.stack([r[k] for r in rows]) for k in rows[0]}

    return multi_round_fn


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


class FedAvgSimulation:
    """Single-process simulation driver (the reference's standalone mode).

    Per round: seeded uniform sampling of K clients on the host, their
    shards packed to fixed shape and kept on the device, one round
    function call, periodic evaluation."""

    def __init__(
        self,
        bundle: ModelBundle,
        dataset: FedDataset,
        config: FedAvgConfig,
        *,
        loss_fn: LossFn = masked_softmax_ce,
        server_update: ServerUpdateFn = default_server_update,
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
            config.client_optimizer, config.lr, momentum=config.momentum,
            weight_decay=config.weight_decay, grad_clip=config.grad_clip,
        )
        self.local_update = make_local_update(
            bundle, optimizer, config.epochs, loss_fn,
            prox_mu=config.prox_mu,
            compute_dtype=resolve_compute_dtype(config.compute_dtype),
        )
        self.round_fn = make_round_fn(self.local_update,
                                      server_update=server_update,
                                      device=self.device)
        self.evaluator = make_evaluator(bundle, loss_fn)
        variables = bundle.init(torch.Generator().manual_seed(config.seed))
        self.state = ServerState(variables, (), 0, config.seed)
        self.steps_per_epoch = cohort_steps_per_epoch(dataset, config.batch_size)
        self._test_pack = None  # (x, y, mask) on device, built at first eval
        self.history = []
        self._pack_cache: Optional[tuple] = None
        # model payload per participant per direction (fp32 wire bytes)
        self._model_nbytes = sum(
            t.numel() * t.element_size()
            for t in treelib.tree_leaves(variables))

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

    def _record_sim_comm(self, cohort: int, rounds: int = 1,
                         uploads: Optional[int] = None) -> None:
        """The federation traffic a real transport would move for the
        simulated rounds: the model down to each participant and one
        update back from each survivor, on the comm counter series."""
        t = self.metrics.telemetry
        down = cohort * rounds
        up = down if uploads is None else uploads
        t.inc("comm.sent_msgs", down, msg_type="S2C_SYNC_MODEL")
        t.inc("comm.sent_bytes", self._model_nbytes * down,
              msg_type="S2C_SYNC_MODEL")
        t.inc("comm.recv_msgs", up, msg_type="C2S_SEND_MODEL")
        t.inc("comm.recv_bytes", self._model_nbytes * up,
              msg_type="C2S_SEND_MODEL")

    def run_round(self) -> dict:
        round_idx = self.state.round_idx
        with self.metrics.span("sample"):
            ids = self._sample_ids(round_idx)
        with self.metrics.span("pack"):
            x, y, mask, num_samples = self._device_pack(ids)
        participation = torch.ones(len(ids), device=self.device)
        if self.cfg.drop_prob > 0.0:
            participation = inject_dropout(
                self.cfg.seed, round_idx, participation, self.cfg.drop_prob)
        with self.metrics.span("round"):
            self.state, metrics = self.round_fn(
                self.state, x, y, mask, num_samples, participation, ids)
            # the float() read-backs wait for the device, so the span
            # measures the round, not the enqueue
            out = {k: float(v) for k, v in metrics.items()}
        self._record_sim_comm(len(ids), uploads=int(round(out["participants"])))
        out["round"] = round_idx
        if out.get("count", 0) > 0:
            out["train_acc"] = out["correct"] / out["count"]
            out["train_loss"] = out["loss_sum"] / out["count"]
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
            metrics = self.run_round()
            self._count_degraded(metrics)
            r = metrics["round"]
            if r % self.cfg.frequency_of_the_test == 0 or i == rounds - 1:
                with self.metrics.span("eval"):
                    metrics.update(self.evaluate_global())
            metrics.update(self.metrics.pop_spans())
            self.metrics.log(metrics, step=r)
            self.history.append(metrics)
            if log_fn:
                log_fn(metrics)
        return self.history

    def run_fused(self, rounds: Optional[int] = None, log_fn=None,
                  rounds_per_call: Optional[int] = None) -> list:
        """Full-participation driver: the rounds BETWEEN evals run as one
        ``make_multi_round_fn`` call with no host read-back in between.
        Equal to ``run()`` round for round (same random streams, same
        resident cohort block)."""
        cfg = self.cfg
        if cfg.clients_per_round < cfg.num_clients:
            raise ValueError(
                "run_fused is the full-participation driver "
                f"(clients_per_round={cfg.clients_per_round} < "
                f"num_clients={cfg.num_clients}); use run()")
        rounds = rounds if rounds is not None else cfg.comm_rounds
        ids = np.arange(cfg.num_clients)
        x, y, mask, num_samples = self._device_pack(ids)
        participation = torch.ones(len(ids), device=self.device)
        freq = cfg.frequency_of_the_test
        base0 = self.state.round_idx
        eval_rounds = sorted(
            {r for r in range(base0, base0 + rounds) if r % freq == 0}
            | {base0 + rounds - 1})
        done = 0
        while done < rounds:
            base = base0 + done
            n = next(r for r in eval_rounds if r >= base) - base + 1
            if rounds_per_call:
                n = min(n, rounds_per_call)
            fused = make_multi_round_fn(None, n, drop_prob=cfg.drop_prob,
                                        round_fn=self.round_fn, device=self.device)
            with self.metrics.span("round"):
                self.state, stacked = fused(self.state, x, y, mask,
                                            num_samples, participation, ids)
                rows = []
                for i in range(n):
                    out = {k: float(v[i]) for k, v in stacked.items()}
                    out["round"] = base + i
                    if out.get("count", 0) > 0:
                        out["train_acc"] = out["correct"] / out["count"]
                        out["train_loss"] = out["loss_sum"] / out["count"]
                    self._count_degraded(out)
                    rows.append(out)
            self._record_sim_comm(
                len(ids), rounds=n,
                uploads=int(sum(r["participants"] for r in rows)))
            if base + n - 1 in eval_rounds:
                with self.metrics.span("eval"):
                    rows[-1].update(self.evaluate_global())
            # chunk-level spans ride the chunk's last row
            rows[-1].update(self.metrics.pop_spans())
            self.history.extend(rows)
            for r in rows:
                self.metrics.log(r, step=r["round"])
                if log_fn:
                    log_fn(r)
            done += n
        return self.history
