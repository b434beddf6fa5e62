"""CIFAR-10 / CIFAR-100 / CINIC-10 federated loaders (numpy copy of
``fedml_tpu/data/cifar.py``).

Each reads its standard files from ``data_dir`` when present (the python
pickles; CINIC-10's ``train/<class>/*.png`` folder tree, decoded with
PIL; or a ``<name>.npz`` with x_train/y_train/x_test/y_test), and
otherwise returns a matched-shape synthetic stand-in (5000 train / 1000
test images of 32x32x3, 10 or 100 classes), partitioned the same way.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional, Tuple

import numpy as np

from fedml_tpu_torch.core.partition import partition_data
from fedml_tpu_torch.core.types import FedDataset
from fedml_tpu_torch.data.synthetic import synthetic_classification

# reference normalization constants (cifar10/data_loader.py:60-63 etc.)
CIFAR10_MEAN, CIFAR10_STD = (0.4914, 0.4822, 0.4465), (0.2470, 0.2435, 0.2616)
CIFAR100_MEAN, CIFAR100_STD = (0.5071, 0.4865, 0.4409), (0.2673, 0.2564, 0.2762)
CINIC10_MEAN, CINIC10_STD = (0.47889522, 0.47227842, 0.43047404), (
    0.24205776, 0.23828046, 0.25874835)


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


def _load_cifar100_pickles(d: str):
    def batch(name):
        with open(os.path.join(d, name), "rb") as f:
            z = pickle.load(f, encoding="latin1")
        x = z["data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return x.astype(np.float32), np.asarray(z["fine_labels"], np.int32)

    x, y = batch("train")
    tx, ty = batch("test")
    return x, y, tx, ty


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
    synthetic_size: Tuple[int, int], normalized: bool = False,
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
    if not normalized:
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


def load_cifar100(
    data_dir: str = "./data/cifar100", num_clients: int = 10,
    partition: str = "hetero", partition_alpha: float = 0.5, seed: int = 0,
) -> FedDataset:
    sub = os.path.join(data_dir, "cifar-100-python")
    d = sub if os.path.isdir(sub) else data_dir
    if os.path.exists(os.path.join(d, "train")):
        arrays = _load_cifar100_pickles(d)
    else:
        arrays = _load_generic(data_dir, "cifar100")
    return _build(arrays, CIFAR100_MEAN, CIFAR100_STD, 100, "cifar100",
                  num_clients, partition, partition_alpha, seed,
                  (50000, 10000) if arrays else (5000, 1000))


def load_cinic10(
    data_dir: str = "./data/cinic10", num_clients: int = 10,
    partition: str = "hetero", partition_alpha: float = 0.5, seed: int = 0,
) -> FedDataset:
    """CINIC-10 ships as an ImageFolder tree (``train/<class>/*.png`` +
    ``test/<class>/*.png``), decoded with PIL and normalized with the
    CINIC constants in the same pass.  With no ``test/`` directory the
    test set is 64 rows strided across the class-grouped train walk (a
    prefix would hold one class).  Fallbacks: the npz layout, then the
    synthetic stand-in."""
    if os.path.isdir(os.path.join(data_dir, "train")):
        from fedml_tpu_torch.data.imagefolder import decode_images, scan_class_tree

        tr_paths, tr_y, _ = scan_class_tree(os.path.join(data_dir, "train"))
        tr_x = decode_images(tr_paths, 32, CINIC10_MEAN, CINIC10_STD)
        te_dir = os.path.join(data_dir, "test")
        if os.path.isdir(te_dir):
            te_paths, te_y, _ = scan_class_tree(te_dir)
            te_x = decode_images(te_paths, 32, CINIC10_MEAN, CINIC10_STD)
        else:
            sel = np.linspace(0, len(tr_y) - 1, min(64, len(tr_y))).astype(int)
            te_x, te_y = tr_x[sel], tr_y[sel]
        return _build((tr_x, tr_y, te_x, te_y), CINIC10_MEAN, CINIC10_STD, 10,
                      "cinic10", num_clients, partition, partition_alpha, seed,
                      (5000, 1000), normalized=True)
    arrays = _load_generic(data_dir, "cinic10")
    return _build(arrays, CINIC10_MEAN, CINIC10_STD, 10, "cinic10",
                  num_clients, partition, partition_alpha, seed,
                  (90000, 90000) if arrays else (5000, 1000))
