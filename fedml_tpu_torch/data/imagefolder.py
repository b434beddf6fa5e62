"""PIL-backed image-folder parsing for the folder-tree loaders (numpy
copy of ``fedml_tpu/data/imagefolder.py``): CINIC-10's and the ImageNet
and Landmarks loaders' (``data/imagenet.py``).

Reference semantics reproduced here:

- class-per-subdirectory trees with alphabetically sorted class names
  and sorted file walks (``fedml_api/data_preprocessing/ImageNet/
  datasets.py:21-54`` ``find_classes``/``make_dataset``), so a given
  tree yields the same (path, label) order as the reference;
- CSV user→image maps with ``user_id,image_id,class`` columns, rows
  grouped per user in first-appearance order and concatenated into one
  contiguous array per user (``Landmarks/data_loader.py:125-161``
  ``get_mapping_per_user``), images at ``<data_dir>/<image_id>.jpg``
  (``Landmarks/datasets.py:46-49``).

Decoding departs from the reference deliberately: torchvision's
per-sample ``RandomResizedCrop``/``RandomHorizontalFlip``/``Cutout``
transforms are AUGMENTATION, not parsing — here they run on the device
inside the local update (``data/augment.py``), so host-side decode is a
deterministic resize + normalize producing fixed [N, H, W, C] float32
arrays the packers can ship to the device once.  PIL is imported only
inside ``decode_images``.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif",
                  ".tiff", ".webp")


def find_classes(root: str) -> Tuple[List[str], Dict[str, int]]:
    """Sorted subdirectory names → class indices (reference
    ``datasets.py:21-25``)."""
    classes = sorted(
        d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
    )
    return classes, {c: i for i, c in enumerate(classes)}


def scan_class_tree(
    root: str, max_per_class: int = 0
) -> Tuple[List[str], np.ndarray, List[str]]:
    """Walk ``root/<class>/**`` in sorted order (reference
    ``datasets.py:28-54`` ``make_dataset``): returns (paths, labels,
    classes) with samples grouped per class in class order — the
    contiguous layout the reference's ``net_dataidx_map`` ranges rely
    on.  ``max_per_class`` (0 = all) bounds decode volume: the loaders
    materialize decoded images as one host array (the packers ship
    arrays to the device), so full-size ImageNet (~770 GB at 224²) must
    come in capped, pre-resized, or via the npz route."""
    classes, class_to_idx = find_classes(root)
    paths: List[str] = []
    labels: List[int] = []
    for target in classes:
        d = os.path.join(root, target)
        kept = 0
        for sub, _, fnames in sorted(os.walk(d)):
            for fname in sorted(fnames):
                if fname.lower().endswith(IMG_EXTENSIONS):
                    if max_per_class and kept >= max_per_class:
                        break
                    paths.append(os.path.join(sub, fname))
                    labels.append(class_to_idx[target])
                    kept += 1
    return paths, np.asarray(labels, np.int32), classes


def decode_images(
    paths: Sequence[str],
    image_size: int,
    mean: Sequence[float],
    std: Sequence[float],
) -> np.ndarray:
    """PIL-decode + RGB-convert (reference ``pil_loader``,
    ``datasets.py:57-61``) + deterministic resize + normalize →
    [N, H, W, 3] float32."""
    from PIL import Image

    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    out = np.empty((len(paths), image_size, image_size, 3), np.float32)
    for i, p in enumerate(paths):
        with open(p, "rb") as f:
            img = Image.open(f).convert("RGB")
        if img.size != (image_size, image_size):
            img = img.resize((image_size, image_size), Image.BILINEAR)
        out[i] = np.asarray(img, np.float32) / 255.0
    return (out - mean) / std


def contiguous_class_clients(
    labels: np.ndarray, num_classes: int, num_clients: int
) -> Dict[int, np.ndarray]:
    """The reference's ImageNet federated split: clients own contiguous
    class blocks (``data_loader.py:154-162``: client_number=1000 → one
    class each, 100 → ten classes each).  Generalized to any
    ``num_clients`` dividing into near-equal class blocks."""
    per = max(1, num_classes // num_clients)
    return {
        c: np.where(
            (labels >= c * per)
            & (labels < ((c + 1) * per if c < num_clients - 1 else num_classes))
        )[0]
        for c in range(num_clients)
    }


def read_user_map_csv(path: str) -> List[Dict[str, str]]:
    """The reference's ``_read_csv`` (``Landmarks/data_loader.py:20-29``)
    with its column contract enforced."""
    with open(path, "r") as f:
        rows = list(csv.DictReader(f))
    expected = ("user_id", "image_id", "class")
    if rows and not all(col in rows[0] for col in expected):
        raise ValueError(
            "The mapping file must contain user_id, image_id and class "
            f"columns. The existing columns are {','.join(rows[0])}"
        )
    return rows


def group_rows_per_user(
    rows: List[Dict[str, str]],
) -> Tuple[List[Dict[str, str]], Dict[int, np.ndarray]]:
    """``get_mapping_per_user`` semantics (``Landmarks/data_loader.py:
    125-161``): group rows by user in first-appearance order, concatenate
    per-user blocks, return (flat rows, client → contiguous indices)."""
    per_user: Dict[str, List[Dict[str, str]]] = {}
    for row in rows:
        per_user.setdefault(row["user_id"], []).append(row)
    flat: List[Dict[str, str]] = []
    client_idx: Dict[int, np.ndarray] = {}
    off = 0
    for user_id, items in per_user.items():
        client_idx[int(user_id)] = np.arange(off, off + len(items))
        off += len(items)
        flat.extend(items)
    return flat, client_idx
