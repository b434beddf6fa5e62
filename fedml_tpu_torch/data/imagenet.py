"""ImageNet (ILSVRC2012) and Google Landmarks (gld23k/gld160k) federated
loaders (numpy copy of ``fedml_tpu/data/imagenet.py``).

Reference: ``fedml_api/data_preprocessing/ImageNet/data_loader.py``
(JPEG folder tree ``train/<class>/`` + ``val/<class>/``, 1000 classes,
clients = contiguous class blocks) and ``Landmarks/data_loader.py`` (CSV
rows ``user_id,image_id,class`` → ``<image_id>.jpg`` files: the natural
per-photographer partition, 233 clients for gld23k).  Both on-disk formats
are parsed with PIL through ``data/imagefolder.py``; PIL is imported only
there, when a JPEG is decoded.  Fallbacks, in order: a preprocessed
``.npz`` (``x_train/y_train/x_test/y_test`` [+ ``user_train`` client
ids]), then a synthetic stand-in with the dataset's geometry (224 px).
"""

from __future__ import annotations

import csv
import os
from typing import Optional

import numpy as np

from fedml_tpu_torch.core.partition import partition_data
from fedml_tpu_torch.core.types import FedDataset
from fedml_tpu_torch.data.synthetic import synthetic_classification

# reference ImageNet/data_loader.py:41-43
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# reference Landmarks/data_loader.py:98-100
LANDMARKS_MEAN = (0.5, 0.5, 0.5)
LANDMARKS_STD = (0.5, 0.5, 0.5)


def _from_npz(path: str, num_classes: int, num_clients: int, name: str,
              seed: int) -> FedDataset:
    z = np.load(path)
    train_x = z["x_train"].astype(np.float32)
    train_y = z["y_train"].astype(np.int32)
    test_x = z["x_test"].astype(np.float32)
    test_y = z["y_test"].astype(np.int32)
    if "user_train" in z:
        users = np.asarray(z["user_train"])
        idx = {c: np.where(users == u)[0] for c, u in enumerate(np.unique(users))}
    else:
        idx = partition_data(train_y, num_clients, "homo", 0.5, seed)
    return FedDataset(
        train_x=train_x, train_y=train_y, test_x=test_x, test_y=test_y,
        train_client_idx=idx, test_client_idx=None,
        num_classes=num_classes, name=name,
    )


def _from_folder_tree(
    data_dir: str, num_clients: int, image_size: int, name: str,
    mean, std, test_subdir: str = "val", max_per_class: int = 0,
) -> FedDataset:
    """The reference's ImageNet on-disk format: ``train/<class>/*.jpg`` +
    ``val/<class>/*.jpg`` (``ImageNet/datasets.py:92-97``), clients =
    contiguous class blocks (``data_loader.py:154-162``).  Decoded images
    land in one host float32 array, so full ILSVRC2012 at 224² (~770 GB)
    must come capped (``max_per_class``), at a smaller ``image_size`` or
    through the npz route."""
    from fedml_tpu_torch.data.imagefolder import (contiguous_class_clients,
                                                  decode_images, scan_class_tree)

    train_paths, train_y, classes = scan_class_tree(
        os.path.join(data_dir, "train"), max_per_class=max_per_class)
    train_x = decode_images(train_paths, image_size, mean, std)
    test_root = os.path.join(data_dir, test_subdir)
    if os.path.isdir(test_root):
        test_paths, test_y, _ = scan_class_tree(test_root, max_per_class=max_per_class)
        test_x = decode_images(test_paths, image_size, mean, std)
    else:
        # no val/ tree: a strided slice of the class-grouped train walk
        # (the first 64 rows would be one class), reusing decoded rows
        sel = np.linspace(0, len(train_y) - 1, min(64, len(train_y))).astype(int)
        test_x, test_y = train_x[sel], train_y[sel]
    num_classes = len(classes)
    return FedDataset(
        train_x=train_x, train_y=train_y, test_x=test_x, test_y=test_y,
        train_client_idx=contiguous_class_clients(
            train_y, num_classes, min(num_clients, num_classes)),
        test_client_idx=None, num_classes=num_classes, name=name,
    )


def load_imagenet(
    data_dir: str = "./data/ImageNet",
    num_clients: int = 100,
    image_size: int = 224,
    seed: int = 0,
    max_per_class: int = 0,
) -> FedDataset:
    if os.path.isdir(os.path.join(data_dir, "train")):
        return _from_folder_tree(data_dir, num_clients, image_size, "imagenet",
                                 IMAGENET_MEAN, IMAGENET_STD,
                                 max_per_class=max_per_class)
    path = os.path.join(data_dir, "imagenet_federated.npz")
    if os.path.exists(path):
        return _from_npz(path, 1000, num_clients, "imagenet", seed)
    return synthetic_classification(
        num_train=num_clients * 16, num_test=64,
        input_shape=(image_size, image_size, 3), num_classes=1000,
        num_clients=num_clients, partition="homo", seed=seed,
        name="imagenet(synthetic-standin)",
    )


def _from_user_map_csv(
    data_dir: str, train_map: str, test_map: str, image_size: int,
    num_classes: int, name: str,
) -> FedDataset:
    """The reference's Landmarks on-disk format: CSV rows
    ``user_id,image_id,class`` mapped to ``<data_dir>/<image_id>.jpg``
    (``Landmarks/data_loader.py:125-161``, ``datasets.py:46-49``)."""
    from fedml_tpu_torch.data.imagefolder import (decode_images, group_rows_per_user,
                                                  read_user_map_csv)

    rows, client_idx = group_rows_per_user(read_user_map_csv(train_map))
    if os.path.exists(test_map):
        # the test split is not user-partitioned: the reference reads only
        # its image_id and class columns (data_loader.py:206)
        with open(test_map, "r") as f:
            test_rows = list(csv.DictReader(f))
        if test_rows and not all(c in test_rows[0] for c in ("image_id", "class")):
            raise ValueError("test mapping must contain image_id and class columns; "
                             f"got {','.join(test_rows[0])}")
    else:
        test_rows = rows[:64]

    def arrays(rs):
        paths = [os.path.join(data_dir, f"{r['image_id']}.jpg") for r in rs]
        y = np.asarray([int(r["class"]) for r in rs], np.int32)
        return decode_images(paths, image_size, LANDMARKS_MEAN, LANDMARKS_STD), y

    train_x, train_y = arrays(rows)
    test_x, test_y = arrays(test_rows)
    classes = int(max(train_y.max(initial=0), test_y.max(initial=0))) + 1
    return FedDataset(
        train_x=train_x, train_y=train_y, test_x=test_x, test_y=test_y,
        train_client_idx=client_idx, test_client_idx=None,
        num_classes=max(num_classes, classes), name=name,
    )


def load_landmarks(
    data_dir: str = "./data/gld",
    variant: str = "gld23k",   # 233 clients / 203 classes (reference)
    image_size: int = 224,
    seed: int = 0,
    train_map: Optional[str] = None,
    test_map: Optional[str] = None,
) -> FedDataset:
    num_clients, num_classes = (233, 203) if variant == "gld23k" else (1262, 2028)
    # reference map-file names (main_fedavg.py:170-171 gld23k, :185-186
    # gld160k); images live under <data_dir>/images
    trn, tst = (("mini_gld_train_split.csv", "mini_gld_test.csv")
                if variant == "gld23k" else ("federated_train.csv", "test.csv"))
    train_map = train_map or os.path.join(data_dir, trn)
    test_map = test_map or os.path.join(data_dir, tst)
    if os.path.exists(train_map):
        return _from_user_map_csv(os.path.join(data_dir, "images"), train_map, test_map,
                                  image_size, num_classes, variant)
    path = os.path.join(data_dir, f"{variant}_federated.npz")
    if os.path.exists(path):
        return _from_npz(path, num_classes, num_clients, variant, seed)
    small = min(num_clients, 50)
    return synthetic_classification(
        num_train=small * 12, num_test=48,
        input_shape=(image_size, image_size, 3), num_classes=num_classes,
        num_clients=small, partition="power_law", seed=seed,
        name=f"{variant}(synthetic-standin)",
    )
