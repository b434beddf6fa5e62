"""CIFAR-10 federated loader (numpy copy of ``load_cifar10`` in
``fedml_tpu/data/cifar.py``).

Reads the standard python pickles (or a ``cifar10.npz`` with
x_train/y_train/x_test/y_test) from ``data_dir`` when present, and
otherwise returns a matched-shape synthetic stand-in (5000 train / 1000
test images of 32x32x3, 10 classes), partitioned the same way.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional, Tuple

import numpy as np

from fedml_tpu_torch.core.partition import partition_data
from fedml_tpu_torch.core.types import FedDataset
from fedml_tpu_torch.data.synthetic import synthetic_classification

# reference normalization constants (cifar10/data_loader.py:60-63)
CIFAR10_MEAN, CIFAR10_STD = (0.4914, 0.4822, 0.4465), (0.2470, 0.2435, 0.2616)


def _normalize(x: np.ndarray, mean, std) -> np.ndarray:
    return ((x / 255.0) - np.asarray(mean, np.float32)) / np.asarray(
        std, np.float32
    )


def _load_cifar10_pickles(d: str):
    def batch(name):
        with open(os.path.join(d, name), "rb") as f:
            z = pickle.load(f, encoding="latin1")
        x = z["data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return x.astype(np.float32), np.asarray(z["labels"], np.int32)

    xs, ys = zip(*[batch(f"data_batch_{i}") for i in range(1, 6)])
    tx, ty = batch("test_batch")
    return np.concatenate(xs), np.concatenate(ys), tx, ty


def _load_generic(data_dir: str, name: str):
    """npz layout: {name}.npz with x_train/y_train/x_test/y_test."""
    p = os.path.join(data_dir, f"{name}.npz")
    if os.path.exists(p):
        z = np.load(p)
        return (z["x_train"].astype(np.float32), z["y_train"].astype(np.int32),
                z["x_test"].astype(np.float32), z["y_test"].astype(np.int32))
    return None


def _build(
    arrays: Optional[Tuple], mean, std, num_classes: int, name: str,
    num_clients: int, partition: str, partition_alpha: float, seed: int,
    synthetic_size: Tuple[int, int],
) -> FedDataset:
    if arrays is None:
        return synthetic_classification(
            num_train=synthetic_size[0], num_test=synthetic_size[1],
            input_shape=(32, 32, 3), num_classes=num_classes,
            num_clients=num_clients, partition=partition,
            partition_alpha=partition_alpha, seed=seed,
            name=f"{name}(synthetic-standin)",
        )
    train_x, train_y, test_x, test_y = arrays
    train_x = _normalize(train_x, mean, std)
    test_x = _normalize(test_x, mean, std)
    client_idx = partition_data(
        train_y, num_clients, partition, partition_alpha, seed
    )
    return FedDataset(
        train_x=train_x, train_y=train_y, test_x=test_x, test_y=test_y,
        train_client_idx=client_idx, test_client_idx=None,
        num_classes=num_classes, name=name,
    )


def load_cifar10(
    data_dir: str = "./data/cifar10", num_clients: int = 10,
    partition: str = "hetero", partition_alpha: float = 0.5, seed: int = 0,
) -> FedDataset:
    sub = os.path.join(data_dir, "cifar-10-batches-py")
    d = sub if os.path.isdir(sub) else data_dir
    if os.path.exists(os.path.join(d, "data_batch_1")):
        arrays = _load_cifar10_pickles(d)
    else:
        arrays = _load_generic(data_dir, "cifar10")
    return _build(arrays, CIFAR10_MEAN, CIFAR10_STD, 10, "cifar10",
                  num_clients, partition, partition_alpha, seed,
                  (50000, 10000) if arrays else (5000, 1000))
