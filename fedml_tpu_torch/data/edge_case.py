"""Backdoor and edge-case poisoned datasets (port of
``fedml_tpu/data/edge_case.py``, numpy only; ``torch.load`` reads the
ARDIS archive).

Two attack shapes:

- **Pixel-trigger backdoor** (``make_backdoor``): a 3×3 checker trigger
  stamped on real samples relabelled to the attacker's target class (the
  BadNets shape), mixed into the attacker's own shard; the targeted-task
  test set is the triggered test samples whose true label differs from
  the target.
- **Edge-case / OOD label-flip** (``make_edge_case_backdoor``), the
  reference's ``edge_case_examples/data_loader.py:380-440``: N
  out-of-distribution images labelled ``target_label``, mixed with M
  downsampled clean samples; the targeted test set is the OOD test images.
  ``make_poisoned_dataset`` switches over the reference's five families
  (``southwest``, ``southwest-da``, ``ardis``, ``howto``,
  ``greencar-neo``; ``data_loader.py:283-713``), reading the pickled and
  torch-saved archives when present and a seeded OOD stand-in otherwise.
  Every ``np.random.RandomState`` draw is the JAX module's, in its order.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Optional, Tuple

import numpy as np

from fedml_tpu_torch.core.types import FedDataset


def stamp_trigger(x: np.ndarray, intensity: float = 1.0) -> np.ndarray:
    """Stamp a 3×3 checker trigger in the bottom-right corner (image
    data [N,H,W,C]) or spike the last 3 features (flat data [N,D])."""
    x = x.copy()
    if x.ndim >= 3:
        for di in range(3):
            for dj in range(3):
                if (di + dj) % 2 == 0:
                    x[:, -1 - di, -1 - dj, ...] = intensity
    else:
        x[:, -3:] = intensity
    return x


@dataclasses.dataclass
class PoisonedData:
    train_x: np.ndarray  # attacker's mixed local training set
    train_y: np.ndarray
    backdoor_test_x: np.ndarray  # triggered held-out samples
    backdoor_test_y: np.ndarray  # all = target_label


def make_backdoor(
    dataset: FedDataset,
    attacker_client: int,
    target_label: int = 0,
    poison_fraction: float = 0.3,
    intensity: float = 1.0,
    seed: int = 0,
) -> PoisonedData:
    rng = np.random.RandomState(seed)
    idx = np.asarray(dataset.train_client_idx[attacker_client])
    honest_x = dataset.train_x[idx]
    honest_y = dataset.train_y[idx]
    n_poison = max(1, int(len(idx) * poison_fraction))
    src = rng.choice(len(idx), n_poison, replace=False)
    poison_x = stamp_trigger(honest_x[src], intensity)
    poison_y = np.full(n_poison, target_label, dtype=honest_y.dtype)

    # the mixture, shuffled: the attacker still trains on honest data too
    mix_x = np.concatenate([honest_x, poison_x])
    mix_y = np.concatenate([honest_y, poison_y])
    order = rng.permutation(len(mix_x))

    # targeted-task eval: triggered test samples whose TRUE label differs
    not_target = dataset.test_y != target_label
    bt_x = stamp_trigger(dataset.test_x[not_target], intensity)
    bt_y = np.full(int(not_target.sum()), target_label, dtype=dataset.test_y.dtype)
    return PoisonedData(train_x=mix_x[order], train_y=mix_y[order],
                        backdoor_test_x=bt_x, backdoor_test_y=bt_y)


# --- edge-case (OOD label-flip) attack: the reference's southwest semantics ---

_TRAIN_PKL = "southwest_images_new_train.pkl"
_TEST_PKL = "southwest_images_new_test.pkl"


def load_edge_case_images(
    data_dir: str,
    train_name: str = _TRAIN_PKL,
    test_name: str = _TEST_PKL,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """The reference's edge-case archives when present: each .pkl a pickled
    uint8 image array ``[N, 32, 32, 3]`` (``data_loader.py:355-360``),
    returned as float32 in [0, 1]; None when either file is absent."""
    tr, te = os.path.join(data_dir, train_name), os.path.join(data_dir, test_name)
    if not (os.path.exists(tr) and os.path.exists(te)):
        return None
    with open(tr, "rb") as f:
        train = pickle.load(f)
    with open(te, "rb") as f:
        test = pickle.load(f)

    def norm(a):
        a = np.asarray(a)
        return a.astype(np.float32) / 255.0 if a.dtype == np.uint8 else a.astype(np.float32)

    return norm(train), norm(test)


def synthetic_ood_images(
    shape: Tuple[int, ...],
    num_train: int = 200,
    num_test: int = 100,
    seed: int = 7,
) -> Tuple[np.ndarray, np.ndarray]:
    """Offline stand-in for the southwest archive: one out-of-distribution
    prototype (a shifted mean) plus noise, a coherent cluster far from the
    training manifold."""
    rng = np.random.RandomState(seed)
    proto = rng.normal(3.0, 1.0, shape).astype(np.float32)

    def mk(n):
        return proto + rng.normal(0, 0.3, (n, *shape)).astype(np.float32)

    return mk(num_train), mk(num_test)


def make_edge_case_backdoor(
    dataset: FedDataset,
    ood_train: np.ndarray,
    ood_test: np.ndarray,
    target_label: int = 9,
    num_poison: int = 100,
    num_clean: int = 400,
    seed: int = 0,
    shuffle: bool = True,
) -> PoisonedData:
    """The reference's edge-case attack (``data_loader.py:380-440``):
    ``num_poison`` OOD train images drawn without replacement, all labelled
    ``target_label``, after ``num_clean`` downsampled clean samples; the
    mixture shuffled (robust FedAvg truncates a mixture to its slot by
    prefix, so an unshuffled poison tail could be dropped whole);
    ``shuffle=False`` keeps the clean-then-poison layout.  The targeted
    test set is the OOD test images, all labelled ``target_label``."""
    rng = np.random.RandomState(seed)
    n_poison = min(num_poison, len(ood_train))
    pick = rng.choice(len(ood_train), n_poison, replace=False)
    poison_x = ood_train[pick]
    poison_y = np.full(n_poison, target_label, dtype=dataset.train_y.dtype)

    n_clean = min(num_clean, len(dataset.train_x))
    clean_pick = rng.choice(len(dataset.train_x), n_clean, replace=False)
    clean_x = dataset.train_x[clean_pick]
    clean_y = dataset.train_y[clean_pick]

    mix_x = np.concatenate([clean_x, poison_x]).astype(np.float32)
    mix_y = np.concatenate([clean_y, poison_y])
    if shuffle:
        order = rng.permutation(len(mix_x))
        mix_x, mix_y = mix_x[order], mix_y[order]
    return PoisonedData(
        train_x=mix_x, train_y=mix_y,
        backdoor_test_x=np.asarray(ood_test, np.float32),
        backdoor_test_y=np.full(len(ood_test), target_label, dtype=dataset.test_y.dtype),
    )


# --- the reference's five poison families, behind one switch -----------------

POISON_FAMILIES = (
    "southwest", "southwest-da", "ardis", "howto", "greencar-neo",
)

# "How To Backdoor FL" green-car samples in CIFAR-10's canonical train order
# (reference data_loader.py:563-566): the howto attack poisons the host
# dataset's own rare samples
HOWTO_GREEN_CAR_TRAIN_IDX = [
    874, 49163, 34287, 21422, 48003, 47001, 48030, 22984, 37533, 41336,
    3678, 37365, 19165, 34385, 41861, 39824, 561, 49588, 4528, 3378,
    38658, 38735, 19500, 9744, 47026, 1605, 389,
]
HOWTO_GREEN_CAR_TEST_IDX = [32941, 36005, 40138]

_GREENCAR_TRAIN_PKL = "new_green_cars_train.pkl"
_GREENCAR_TEST_PKL = "new_green_cars_test.pkl"
_GREENCAR_HOWTO_TEST_PKL = "green_car_transformed_test.pkl"
_ARDIS_TEST_PT = "ardis_test_dataset.pt"


def load_ardis_test(data_dir: str) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """The reference's ARDIS targeted-test archive when present
    (``data_loader.py:319-321``): a ``torch.load``-able dataset with
    ``.data``/``.targets`` or a raw image tensor/array.  Images come back
    float32 ``[N, 28, 28, 1]`` in [0, 1], targets int64."""
    path = os.path.join(data_dir, _ARDIS_TEST_PT)
    if not os.path.exists(path):
        return None
    import torch

    obj = torch.load(path, weights_only=False)
    if hasattr(obj, "data"):
        data = np.asarray(obj.data)
        targets = np.asarray(getattr(obj, "targets", np.ones(len(data))))
    else:
        data = np.asarray(obj)
        targets = np.ones(len(data))
    if data.dtype == np.uint8:
        data = data.astype(np.float32) / 255.0
    if data.ndim == 3:
        data = data[..., None]
    return data.astype(np.float32), targets.astype(np.int64)


def make_poisoned_dataset(
    dataset: FedDataset,
    poison_type: str = "southwest",
    data_dir: str = "",
    *,
    seed: int = 0,
    num_poison: Optional[int] = None,
    num_clean: Optional[int] = None,
    shuffle: bool = True,
) -> PoisonedData:
    """One switch over the reference's five poison families
    (``load_poisoned_dataset``, ``data_loader.py:283-713``): the attacker's
    mixed training set and the targeted-task test set.  Archives are read
    from ``data_dir`` when present, the seeded OOD stand-in fills in
    otherwise.  As in the JAX module, ``southwest-da``'s Gaussian noise
    (the reference's per-draw ``AddGaussianNoise(0, .05)``) is stamped once
    at construction, and ``howto``'s fixed CIFAR-10 indices select rows
    modulo the dataset's size."""
    rng = np.random.RandomState(seed)
    img_shape = dataset.train_x.shape[1:]

    def ood_or_standin(train_pkl, test_pkl, ood_seed):
        loaded = load_edge_case_images(data_dir, train_pkl, test_pkl) if data_dir else None
        if loaded is not None:
            return loaded
        return synthetic_ood_images(img_shape, seed=ood_seed)

    def _shuffled(out):
        """One seed-deterministic permutation, shared across families at the
        same seed (southwest and southwest-da stay row-aligned)."""
        if not shuffle:
            return out
        order = np.random.RandomState(seed + 1).permutation(len(out.train_x))
        return dataclasses.replace(out, train_x=out.train_x[order],
                                   train_y=out.train_y[order])

    if poison_type in ("southwest", "southwest-da"):
        ood_train, ood_test = ood_or_standin(_TRAIN_PKL, _TEST_PKL, 7)
        out = make_edge_case_backdoor(
            dataset, ood_train, ood_test, target_label=9,
            num_poison=100 if num_poison is None else num_poison,
            num_clean=400 if num_clean is None else num_clean,
            seed=seed, shuffle=False,
        )
        if poison_type == "southwest-da":
            # the poison rows are the tail, capped by the archive's size;
            # the noise never touches a clean row
            tail = min(100 if num_poison is None else num_poison, len(ood_train))
            if tail > 0:  # [-0:] would select every row
                noisy = out.train_x.copy()
                noisy[-tail:] += rng.normal(0.0, 0.05, noisy[-tail:].shape).astype(np.float32)
                out = dataclasses.replace(out, train_x=noisy)
        return _shuffled(out)

    if poison_type == "ardis":
        # the reference ships the poisoned train set pre-built and only the
        # targeted test set as an archive; 66 = the ARDIS-7 train count
        loaded = load_ardis_test(data_dir) if data_dir else None
        ood_train, standin_test = synthetic_ood_images(img_shape, seed=11)
        ood_test = loaded[0] if loaded is not None else standin_test
        return make_edge_case_backdoor(
            dataset, ood_train, ood_test, target_label=1,
            num_poison=66 if num_poison is None else num_poison,
            num_clean=400 if num_clean is None else num_clean,
            seed=seed, shuffle=shuffle,
        )

    if poison_type == "howto":
        n = len(dataset.train_x)
        tr_idx = [i % n for i in HOWTO_GREEN_CAR_TRAIN_IDX]
        te_idx = [i % n for i in HOWTO_GREEN_CAR_TEST_IDX]
        poison_x = dataset.train_x[tr_idx]
        poison_y = np.full(len(tr_idx), 2, dtype=dataset.train_y.dtype)
        # the clean pool excludes both index lists (reference remaining_indices)
        excluded = set(tr_idx) | set(te_idx)
        remaining = np.array([i for i in range(n) if i not in excluded])
        n_clean = (500 - len(tr_idx)) if num_clean is None else num_clean
        clean_pick = rng.choice(remaining, min(n_clean, len(remaining)), replace=False)
        loaded = load_edge_case_images(
            data_dir, _GREENCAR_HOWTO_TEST_PKL, _GREENCAR_HOWTO_TEST_PKL) if data_dir else None
        # the stand-in's targeted test: the held-out green-car rows
        bt_x = loaded[1] if loaded is not None else dataset.train_x[te_idx]
        return _shuffled(PoisonedData(
            train_x=np.concatenate([dataset.train_x[clean_pick], poison_x]).astype(np.float32),
            train_y=np.concatenate([dataset.train_y[clean_pick], poison_y]),
            backdoor_test_x=np.asarray(bt_x, np.float32),
            backdoor_test_y=np.full(len(bt_x), 2, dtype=dataset.test_y.dtype),
        ))

    if poison_type == "greencar-neo":
        ood_train, ood_test = ood_or_standin(_GREENCAR_TRAIN_PKL, _GREENCAR_TEST_PKL, 13)
        return make_edge_case_backdoor(
            dataset, ood_train, ood_test, target_label=2,
            num_poison=100 if num_poison is None else num_poison,
            num_clean=400 if num_clean is None else num_clean,
            seed=seed, shuffle=shuffle,
        )

    raise ValueError(f"unknown poison_type {poison_type!r}; families: {POISON_FAMILIES}")
