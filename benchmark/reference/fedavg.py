"""FedAvg rounds in plain PyTorch (McMahan et al. 2017, arXiv:1602.05629),
following the program's rounds draw for draw.

A round trains every client of the cohort from the global variables and
folds the results into their sample-weighted mean, every variable
(BatchNorm's running statistics too).  A client's data is its shard
packed to ``steps × batch`` rows, the shard's rows permuted under
``RandomState((seed·1000003 + client·7919 + 1) mod 2³¹)`` and repeated
to fill the pack; the first ``n`` rows are real, the rest weigh nothing in
the loss.  Each epoch permutes the pack's rows, augments the whole epoch
once, and takes one SGD step per batch: ``t ← g + wd·p + momentum·t``,
``p ← p − lr·t``, except that a batch with no real row leaves ``p`` where
it was (its statistics and ``t`` still move).  The draws are JAX's
threefry streams (``rng.py``): the round's key ``fold_in(PRNGKey(seed),
round)``, the client's ``fold_in(fold_in(that, 0), client)``, the epoch's
``fold_in(client key, epoch)``, its permutation under ``fold_in(epoch
key, 0)`` and its augmentation under ``fold_in(epoch key, n + 1)``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from benchmark.reference import rng


def pack_indices(client_idx: np.ndarray, client: int, total: int, seed: int):
    """The client's row indices into the dataset and its real-row mask."""
    r = np.random.RandomState((seed * 1000003 + int(client) * 7919 + 1) % (2 ** 31))
    idx = np.asarray(client_idx)
    n = len(idx)
    wrapped = np.resize(r.permutation(idx), total) if n else np.zeros(total, np.int64)
    mask = np.zeros(total, np.float32)
    mask[:min(n, total)] = 1.0
    return wrapped, mask, float(min(n, total))


def image_augment(key, x: torch.Tensor, pad: int, flip: bool, cutout: int) -> torch.Tensor:
    """Random crop of a ``pad``-padded image, a horizontal flip with
    probability 1/2 and a zeroed ``cutout``-square (DeVries and Taylor
    2017) centred anywhere on the image, per image of ``x`` [B, H, W, C]."""
    b, h, w, _ = x.shape
    dev = x.device
    k_crop, k_flip, k_cut = rng.split(key, 3)
    if pad:
        xp = torch.nn.functional.pad(x, (0, 0, pad, pad, pad, pad))
        offs = rng.randint(k_crop, (b, 2), 0, 2 * pad + 1, dev).long()
        rows = offs[:, 0, None] + torch.arange(h, device=dev)
        cols = offs[:, 1, None] + torch.arange(w, device=dev)
        x = xp[torch.arange(b, device=dev)[:, None, None], rows[:, :, None], cols[:, None, :]]
    if flip:
        x = torch.where(rng.bernoulli(k_flip, 0.5, (b, 1, 1, 1), dev), x.flip(2), x)
    if cutout:
        cy = rng.randint(k_cut, (b,), 0, h, dev)[:, None, None]
        cx = rng.randint(rng.fold_in(k_cut, 1), (b,), 0, w, dev)[:, None, None]
        ys = torch.arange(h, device=dev)[None, :, None]
        xs = torch.arange(w, device=dev)[None, None, :]
        half = cutout // 2
        inside = (ys >= cy - half) & (ys < cy + half) & (xs >= cx - half) & (xs < cx + half)
        x = x * (1.0 - inside[..., None].to(x.dtype))
    return x


def local_train(model, variables: Dict[str, Dict[str, torch.Tensor]], x, y, mask, key,
                opt: dict, epochs: int, augment: Optional[Callable]):
    """One client's local SGD from ``variables`` over its pack ``x`` [S, B,
    ...]; returns the new variables and ``(loss_sum, count)`` of the last
    epoch."""
    params = dict(variables["params"])
    stats = dict(variables.get("batch_stats", {}))
    steps, bsz = x.shape[0], x.shape[1]
    n = steps * bsz
    trace = {k: torch.zeros_like(v) for k, v in params.items()}
    lr, mom, wd = opt["lr"], opt.get("momentum", 0.0), opt.get("weight_decay", 0.0)
    for ep in range(epochs):
        ek = rng.fold_in(key, ep)
        perm = rng.permutation(rng.fold_in(ek, 0), n, x.device)
        xs = x.reshape(n, *x.shape[2:])[perm]
        ys = y.reshape(n, *y.shape[2:])[perm].reshape(y.shape)
        ms = mask.reshape(n)[perm].reshape(mask.shape)
        if augment is not None:
            xs = augment(rng.fold_in(ek, n + 1), xs)
        xs = xs.reshape(x.shape)
        loss_sum = torch.zeros((), device=x.device, dtype=torch.float64)
        count = torch.zeros((), device=x.device, dtype=torch.float64)
        for i in range(steps):
            ls, cnt, grads, new_stats = model.loss_and_grads(params, stats, xs[i], ys[i], ms[i])
            with torch.no_grad():
                real = ms[i].sum() > 0
                for k in params:
                    g = grads[k] + wd * params[k] if wd else grads[k]
                    trace[k] = g + mom * trace[k] if mom else g
                    params[k] = torch.where(real, params[k] - lr * trace[k], params[k])
                stats = {k: v.detach() for k, v in new_stats.items()}
            loss_sum += ls
            count += cnt
    out = {"params": params}
    if stats:
        out["batch_stats"] = stats
    return out, (loss_sum, count)


def fedavg_round(model, variables, dataset, client_ids, round_idx: int, seed: int,
                 batch: int, steps: int, opt: dict, epochs: int, augment=None):
    """One FedAvg round over ``client_ids`` from ``variables``: returns the
    new variables, the round's mean training loss over its last epoch and
    the real samples (tokens) that loss is over."""
    k_train = rng.fold_in(rng.fold_in(rng.prng_key(seed), round_idx), 0)
    first = next(iter(variables["params"].values()))
    dev, dtype = first.device, first.dtype
    total = steps * batch
    num = None
    den = 0.0
    loss_sum = torch.zeros((), device=dev, dtype=torch.float64)
    count = torch.zeros((), device=dev, dtype=torch.float64)
    for c in client_ids:
        rows, mask, n_real = pack_indices(dataset.train_client_idx[c], c, total, seed)
        x = torch.from_numpy(dataset.train_x[rows]).to(dev).reshape(steps, batch, *dataset.train_x.shape[1:])
        if x.is_floating_point():
            x = x.to(dtype)
        y = torch.from_numpy(dataset.train_y[rows]).to(dev).reshape(steps, batch, *dataset.train_y.shape[1:])
        m = torch.from_numpy(mask).to(dev, dtype).reshape(steps, batch)
        new, (ls, cnt) = local_train(model, variables, x, y, m, rng.fold_in(k_train, int(c)),
                                     opt, epochs, augment)
        del x, y, m
        with torch.no_grad():
            if num is None:
                num = {g: {k: n_real * v for k, v in leaves.items()} for g, leaves in new.items()}
            else:
                for g, leaves in new.items():
                    for k, v in leaves.items():
                        num[g][k] += n_real * v
        den += n_real
        loss_sum += ls.double()
        count += cnt.double()
        del new
    agg = {g: {k: v / den for k, v in leaves.items()} for g, leaves in num.items()}
    return agg, float(loss_sum / count), float(count)
