"""Federated EMNIST (FEMNIST) and fed_CIFAR100 — TFF h5 natural-user
partitions (numpy copy of ``fedml_tpu/data/emnist.py``).

Reference: ``fedml_api/data_preprocessing/FederatedEMNIST/data_loader.py``
(h5 files ``fed_emnist_train.h5``/``fed_emnist_test.h5`` with an
``examples/<client_id>/{pixels,label}`` group per writer, 3400 clients,
62 classes) and ``fed_cifar100/data_loader.py:17-21`` (500 train / 100
test clients, ``image``/``label`` keys).  Natural partition = one h5
group per client; no synthetic re-partitioning is applied when real
files exist.  Offline fallback: synthetic stand-ins with the same
shapes and client counts (scaled down).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from fedml_tpu_torch.core.types import FedDataset
from fedml_tpu_torch.data.synthetic import (
    match_pixel_moments,
    synthetic_classification,
)


def _load_h5_clients(path: str, x_key: str, y_key: str):
    import h5py

    xs, ys, idx = [], [], {}
    off = 0
    with h5py.File(path, "r") as f:
        ex = f["examples"]
        for c, cid in enumerate(sorted(ex.keys())):
            g = ex[cid]
            x = np.asarray(g[x_key])
            y = np.asarray(g[y_key], np.int32)
            xs.append(x)
            ys.append(y)
            idx[c] = np.arange(off, off + len(y))
            off += len(y)
    return np.concatenate(xs), np.concatenate(ys), idx


def load_femnist(
    data_dir: str = "./data/FederatedEMNIST/datasets",
    num_clients: int = 3400,
    only_digits: bool = False,
    seed: int = 0,
    standin_label_noise: float = 0.0,
    standin_max_clients: int = 100,
) -> FedDataset:
    """``standin_label_noise`` / ``standin_max_clients`` apply ONLY to
    the offline synthetic stand-in (the label-noise ceiling makes
    convergence evidence non-saturating, and the benchmark row's full
    3400-client population needs the cap lifted); real TFF h5 data is
    never modified."""
    tr = os.path.join(data_dir, "fed_emnist_train.h5")
    te = os.path.join(data_dir, "fed_emnist_test.h5")
    classes = 10 if only_digits else 62
    if os.path.exists(tr) and os.path.exists(te):
        train_x, train_y, train_idx = _load_h5_clients(tr, "pixels", "label")
        test_x, test_y, test_idx = _load_h5_clients(te, "pixels", "label")
        if train_x.ndim == 3:
            train_x, test_x = train_x[..., None], test_x[..., None]
        return FedDataset(
            train_x=train_x.astype(np.float32), train_y=train_y,
            test_x=test_x.astype(np.float32), test_y=test_y,
            train_client_idx=train_idx, test_client_idx=test_idx,
            num_classes=classes, name="femnist",
        )
    n_cl = min(num_clients, standin_max_clients)
    ds = synthetic_classification(
        num_train=n_cl * 60,
        num_test=min(n_cl * 10, 20000),
        input_shape=(28, 28, 1), num_classes=classes,
        num_clients=n_cl, partition="power_law", seed=seed,
        label_noise=standin_label_noise,
        name="femnist(synthetic-standin)",
    )
    # real LEAF FEMNIST shards span ~10-450 samples/user; the lognormal
    # power-law tail can mint a 4000-sample monster client, and the
    # fixed pack geometry (steps = the GLOBAL max shard / batch, one
    # compile for the whole run) would pad every sampled cohort block to
    # that outlier — ~99% padding compute.  Cap shards at the real
    # distribution's scale.
    cap = 450
    ds.train_client_idx = {
        c: idx[:cap] for c, idx in ds.train_client_idx.items()
    }
    # real FEMNIST pixel moments: the reference feeds TFF h5 "pixels"
    # straight into training with no normalization
    # (fedml_api/data_preprocessing/FederatedEMNIST/data_loader.py),
    # and TFF federated EMNIST stores [0,1] floats in the WHITE-
    # background convention (x = 1 - ink) — mean 1-.1736 = .8264,
    # std .3317 from the published EMNIST ink constants.  Matching the
    # second moment alone NaN'd at the reference lr=.1 (the DC mean
    # carries ~86% of E[x²]; see synthetic.match_pixel_moments).
    return match_pixel_moments(ds, 1.0 - 0.1736, 0.3317)


def load_fed_cifar100(
    data_dir: str = "./data/fed_cifar100/datasets",
    seed: int = 0,
    num_clients: int = 50,
    standin_label_noise: float = 0.0,
    standin_natural_stats: bool = False,
) -> FedDataset:
    """``num_clients`` / ``standin_label_noise`` shape ONLY the offline
    synthetic stand-in (TFF fed-CIFAR100 brings its own natural
    500-client partition of ~100 samples each); real h5 data is never
    modified.  The stand-in's unit-variance features already match the
    reference's normalized pixels (``fed_cifar100/utils.py:16``
    Normalize(mean, std) ⇒ E[x²] ≈ 1) — no pixel-scale correction.
    ``standin_natural_stats`` gives the prototypes the smooth /
    flip-symmetric statistics that keep the reference's crop+flip train
    transform (``utils.py:13-16``) label-preserving, as for the
    CIFAR-10 stand-in."""
    tr = os.path.join(data_dir, "fed_cifar100_train.h5")
    te = os.path.join(data_dir, "fed_cifar100_test.h5")
    if os.path.exists(tr) and os.path.exists(te):
        train_x, train_y, train_idx = _load_h5_clients(tr, "image", "label")
        test_x, test_y, test_idx = _load_h5_clients(te, "image", "label")
        return FedDataset(
            train_x=train_x.astype(np.float32) / 255.0, train_y=train_y,
            test_x=test_x.astype(np.float32) / 255.0, test_y=test_y,
            train_client_idx=train_idx, test_client_idx=test_idx,
            num_classes=100, name="fed_cifar100",
        )
    return synthetic_classification(
        num_train=num_clients * 100, num_test=min(num_clients * 20, 10000),
        input_shape=(24, 24, 3),
        num_classes=100, num_clients=num_clients, partition="homo",
        seed=seed, label_noise=standin_label_noise,
        smooth_sigma=2.0 if standin_natural_stats else 0.0,
        flip_symmetric=standin_natural_stats,
        name="fed_cifar100(synthetic-standin)",
    )
