"""MNIST federated loader (numpy copy of ``fedml_tpu/data/mnist.py``).

Reference: ``fedml_api/data_preprocessing/MNIST/data_loader.py:8-123``
reads LEAF's pre-partitioned power-law JSON (1000 users).  Here the
loader reads, in order of preference: LEAF ``train/``+``test/`` JSON
directories (the reference's format — users become the natural client
partition), raw MNIST IDX, or ``mnist.npz``, partitioning the raw
formats with the power-law partitioner
(``core/partition.py::powerlaw_partition``); with no files on disk
(an offline run) it falls back to a matched-shape
synthetic stand-in so every pipeline stays runnable end-to-end.
"""

from __future__ import annotations

import gzip
import json
import os
import struct
from typing import Optional

import numpy as np

from fedml_tpu_torch.core.partition import partition_data
from fedml_tpu_torch.core.types import FedDataset
from fedml_tpu_torch.data.synthetic import (
    match_pixel_moments,
    synthetic_classification,
)


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        zero, dtype, ndim = struct.unpack(">HBB", f.read(4))
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)


def _find(data_dir: str, names) -> Optional[str]:
    for n in names:
        for cand in (os.path.join(data_dir, n), os.path.join(data_dir, n + ".gz")):
            if os.path.exists(cand):
                return cand
    return None


def _leaf_json_dir(d: str):
    if not os.path.isdir(d):
        return None
    files = sorted(f for f in os.listdir(d) if f.endswith(".json"))
    return [os.path.join(d, f) for f in files] or None


def _read_leaf_users(paths):
    """LEAF JSON: {"users": [...], "user_data": {u: {"x": [[784 floats
    in 0..1]], "y": [labels]}}} (reference MNIST/data_loader.py:8-43).
    Returns {user_id: (x, y)} in file-then-user order."""
    users = {}
    for p in paths:
        with open(p) as f:
            data = json.load(f)
        for user in data["users"]:
            ud = data["user_data"][user]
            users[user] = (
                np.asarray(ud["x"], np.float32),
                np.asarray(ud["y"], np.int32),
            )
    if not users:
        raise ValueError("no users in LEAF files")
    return users


def _stack_leaf(users, order, flatten: bool):
    """Concatenate the given users' shards in ``order``; users absent
    from ``users`` get an empty index set so train/test client slots
    always refer to the SAME user id."""
    xs, ys, idx = [], [], {}
    off = 0
    for c, user in enumerate(order):
        if user not in users:
            idx[c] = np.arange(0)
            continue
        ux, uy = users[user]
        if not flatten:
            ux = ux.reshape(len(uy), 28, 28, 1)
        xs.append(ux)
        ys.append(uy)
        idx[c] = np.arange(off, off + len(uy))
        off += len(uy)
    shape = (0, 784) if flatten else (0, 28, 28, 1)
    x = np.concatenate(xs) if xs else np.zeros(shape, np.float32)
    y = np.concatenate(ys) if ys else np.zeros((0,), np.int32)
    return x, y, idx


def load_mnist(
    data_dir: str = "./data/mnist",
    num_clients: int = 1000,
    partition: str = "power_law",
    partition_alpha: float = 0.5,
    flatten: bool = True,
    seed: int = 0,
    standin_label_noise: float = 0.0,
) -> FedDataset:
    """``standin_label_noise`` applies ONLY to the offline synthetic
    stand-in (an irreducible-error ceiling so convergence evidence
    cannot saturate); real LEAF/IDX/npz data is
    never modified."""
    leaf_tr = _leaf_json_dir(os.path.join(data_dir, "train"))
    leaf_te = _leaf_json_dir(os.path.join(data_dir, "test"))
    if leaf_tr and leaf_te:
        try:
            tr_users = _read_leaf_users(leaf_tr)
            te_users = _read_leaf_users(leaf_te)
        except (KeyError, ValueError, json.JSONDecodeError):
            # not actually LEAF-format json — fall through to IDX/npz
            pass
        else:
            # client slots keyed by TRAIN user order; the test split is
            # matched by user id (a user with no test file entry gets an
            # empty test partition, never another user's data)
            order = list(tr_users.keys())
            train_x, train_y, train_idx = _stack_leaf(tr_users, order, flatten)
            test_x, test_y, test_idx = _stack_leaf(te_users, order, flatten)
            return FedDataset(
                train_x=train_x, train_y=train_y,
                test_x=test_x, test_y=test_y,
                train_client_idx=train_idx, test_client_idx=test_idx,
                num_classes=10, name="mnist",
            )

    tr_x = _find(data_dir, ["train-images-idx3-ubyte", "train-images.idx3-ubyte"])
    tr_y = _find(data_dir, ["train-labels-idx1-ubyte", "train-labels.idx1-ubyte"])
    te_x = _find(data_dir, ["t10k-images-idx3-ubyte", "t10k-images.idx3-ubyte"])
    te_y = _find(data_dir, ["t10k-labels-idx1-ubyte", "t10k-labels.idx1-ubyte"])
    npz = _find(data_dir, ["mnist.npz"])

    if tr_x and tr_y and te_x and te_y:
        train_x = _read_idx(tr_x).astype(np.float32) / 255.0
        train_y = _read_idx(tr_y).astype(np.int32)
        test_x = _read_idx(te_x).astype(np.float32) / 255.0
        test_y = _read_idx(te_y).astype(np.int32)
        train_x = train_x[..., None]
        test_x = test_x[..., None]
    elif npz:
        z = np.load(npz)
        train_x = z["x_train"].astype(np.float32) / 255.0
        train_y = z["y_train"].astype(np.int32)
        test_x = z["x_test"].astype(np.float32) / 255.0
        test_y = z["y_test"].astype(np.int32)
        if train_x.ndim == 3:
            train_x, test_x = train_x[..., None], test_x[..., None]
    else:
        ds = synthetic_classification(
            num_train=60000 if num_clients >= 100 else 6000,
            num_test=10000 if num_clients >= 100 else 1000,
            input_shape=(28, 28, 1),
            num_classes=10,
            num_clients=num_clients,
            partition=partition,
            partition_alpha=partition_alpha,
            label_noise=standin_label_noise,
            seed=seed,
            name="mnist(synthetic-standin)",
        )
        if partition == "power_law":
            # real LEAF MNIST power-law shards are tens-to-hundreds of
            # samples; the lognormal tail can mint a ~2700-sample
            # client, and the fixed pack geometry (steps = the GLOBAL
            # max shard) would pad every sampled cohort block to that
            # outlier — ~95% padding compute + an ~85 MB/round transfer
            # (measured; see data/emnist.py for the same fix)
            cap = 500
            ds.train_client_idx = {
                c: idx[:cap] for c, idx in ds.train_client_idx.items()
            }
        # real MNIST pixel moments (mean .1307 / std .3081, the
        # published torchvision normalization constants) so the
        # reference row's lr transfers — see match_pixel_moments
        ds = match_pixel_moments(ds, 0.1307, 0.3081)
        if flatten:
            ds.train_x = ds.train_x.reshape(len(ds.train_x), -1)
            ds.test_x = ds.test_x.reshape(len(ds.test_x), -1)
        return ds

    if flatten:
        train_x = train_x.reshape(len(train_x), -1)
        test_x = test_x.reshape(len(test_x), -1)

    client_idx = partition_data(train_y, num_clients, partition, partition_alpha, seed)
    return FedDataset(
        train_x=train_x,
        train_y=train_y,
        test_x=test_x,
        test_y=test_y,
        train_client_idx=client_idx,
        test_client_idx=None,
        num_classes=10,
        name="mnist",
    )
