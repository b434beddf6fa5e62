"""Synthetic federated datasets (numpy copy of ``fedml_tpu/data/synthetic.py``).

- ``synthetic_alpha_beta`` — the LEAF Synthetic(α,β) logistic-regression
  benchmark (reference
  ``fedml_api/data_preprocessing/synthetic_1_1/data_loader.py``):
  per-client model w_c ~ N(u_c, 1), u_c ~ N(0, α); per-client feature
  mean b_c ~ N(B_c, 1), B_c ~ N(0, β); features x ~ N(b_c, Σ) with
  Σ_jj = j^{-1.2}; labels argmax(softmax(Wx+b)).
- ``synthetic_classification`` — the offline stand-in a loader returns
  when a real dataset's files are not on disk: learnable class-prototype
  Gaussian data with the real dataset's shapes.
- ``match_pixel_moments`` — maps a stand-in's features to a real
  dataset's pixel mean and std.
"""

from __future__ import annotations

import numpy as np

from fedml_tpu_torch.core.partition import partition_data
from fedml_tpu_torch.core.types import FedDataset


def synthetic_alpha_beta(
    alpha: float = 1.0,
    beta: float = 1.0,
    num_clients: int = 30,
    dim: int = 60,
    num_classes: int = 10,
    seed: int = 0,
) -> FedDataset:
    rng = np.random.RandomState(seed)
    samples_per_client = (
        np.random.RandomState(seed + 1).lognormal(4, 2, num_clients).astype(int) + 50
    )
    diag = np.array([(j + 1) ** -1.2 for j in range(dim)])

    xs, ys, owner = [], [], []
    for c in range(num_clients):
        u_c = rng.normal(0, alpha)
        B_c = rng.normal(0, beta)
        W = rng.normal(u_c, 1, (num_classes, dim))
        b = rng.normal(u_c, 1, num_classes)
        v_c = rng.normal(B_c, 1, dim)
        n = int(samples_per_client[c])
        x = rng.multivariate_normal(v_c, np.diag(diag), n).astype(np.float32)
        y = np.argmax(x @ W.T + b, axis=1).astype(np.int32)
        xs.append(x)
        ys.append(y)
        owner.extend([c] * n)

    x = np.concatenate(xs)
    y = np.concatenate(ys)
    owner = np.array(owner)
    n_total = len(x)
    test_rng = np.random.RandomState(seed + 2)
    test_mask = np.zeros(n_total, bool)
    test_mask[test_rng.choice(n_total, n_total // 10, replace=False)] = True

    train_idx_global = np.where(~test_mask)[0]
    remap = -np.ones(n_total, np.int64)
    remap[train_idx_global] = np.arange(len(train_idx_global))
    client_idx = {
        c: remap[np.where((owner == c) & ~test_mask)[0]] for c in range(num_clients)
    }
    return FedDataset(
        train_x=x[~test_mask],
        train_y=y[~test_mask],
        test_x=x[test_mask],
        test_y=y[test_mask],
        train_client_idx=client_idx,
        test_client_idx=None,
        num_classes=num_classes,
        name=f"synthetic_{alpha}_{beta}",
    )


def match_pixel_moments(ds: FedDataset, mean: float, std: float) -> FedDataset:
    """Affinely map a stand-in's features to a real dataset's pixel
    mean AND std (one global scalar + offset on signal and noise alike,
    so the task's Bayes error and the label-noise ceiling are
    untouched).

    Why both moments matter — two failures the JAX package measured:

    - **Scale**: the raw generator emits per-pixel second moment
      ≈ 1+σ² (‖x‖ ≈ 36 for 784 dims) vs real MNIST's [0,1] pixels at
      E[x²] ≈ .112 (‖x‖ ≈ 9.4).  First-layer gradients scale with
      ‖x‖², so the reference MNIST-LR lr=.03 ran ~16× hot and
      oscillated in a .41–.56 band for 400 rounds
      (CONVERGENCE_r04_mnist_lr_unscaled_negative.json).
    - **Placement**: matching the second moment ALONE mis-places it for
      white-background datasets.  TFF FEMNIST pixels (x = 1-ink) have
      E[x²] ≈ .79, but ~86% of that is a DC mean (.826²) and only .11
      is variance; a zero-mean stand-in carrying the whole .79 as
      VARIANCE feeds ~7× the real per-pixel signal power into the
      first conv layer — the reference lr=.1 NaN'd within 75 rounds
      (femnist_cnn, first attempt).  Matching mean and std puts the
      DC where the real data has it."""
    cur_mean = float(np.mean(ds.train_x, dtype=np.float64))
    cur_std = float(np.std(ds.train_x, dtype=np.float64))
    s = np.float32(std / cur_std)
    off = np.float32(mean - cur_mean * (std / cur_std))
    ds.train_x = ds.train_x * s + off
    ds.test_x = ds.test_x * s + off
    return ds


def _gaussian_blur_hw(a: np.ndarray, sigma: float) -> np.ndarray:
    """Separable Gaussian blur over the H, W axes of [..., H, W, C]
    (reflect padding), in plain numpy — no scipy dependency."""
    if a.ndim < 4:
        # (num_classes, H, W, C) minimum: with a flat input_shape the
        # axis arithmetic below would blur the feature axis and then the
        # CLASS axis, silently collapsing class separation
        raise ValueError(
            "smooth_sigma requires an image-shaped input_shape (H, W, C); "
            f"got prototype array of shape {a.shape}"
        )
    radius = max(1, int(3.0 * sigma))
    t = np.arange(-radius, radius + 1)
    k = np.exp(-(t**2) / (2.0 * sigma**2))
    k /= k.sum()

    def conv_axis(x, axis):
        xp = np.concatenate(
            [np.flip(x.take(range(1, radius + 1), axis=axis), axis=axis),
             x,
             np.flip(x.take(range(x.shape[axis] - radius - 1,
                                  x.shape[axis] - 1), axis=axis),
                     axis=axis)],
            axis=axis,
        )
        out = np.zeros_like(x)
        for i, w in enumerate(k):
            out += w * xp.take(range(i, i + x.shape[axis]), axis=axis)
        return out

    return conv_axis(conv_axis(a, a.ndim - 3), a.ndim - 2)


def synthetic_classification(
    num_train: int = 6000,
    num_test: int = 1000,
    input_shape=(28, 28, 1),
    num_classes: int = 10,
    num_clients: int = 10,
    partition: str = "hetero",
    partition_alpha: float = 0.5,
    noise: float = 0.8,
    label_noise: float = 0.0,
    seed: int = 0,
    name: str = "synthetic",
    smooth_sigma: float = 0.0,
    flip_symmetric: bool = False,
) -> FedDataset:
    """Class-prototype Gaussian data with the same shapes as a real dataset.

    ``label_noise`` = η flips that fraction of labels (train AND test,
    independently drawn) to a uniformly random WRONG class: a model that
    perfectly learns the clean prototypes still scores only ≈ 1−η test
    accuracy, giving the task a documented irreducible-error ceiling —
    saturating trajectories can't distinguish a correct FedAvg from a
    subtly wrong one (VERDICT r2 missing #1).  Partitioning uses the
    NOISY labels, as real noisy data would.

    ``smooth_sigma`` / ``flip_symmetric`` give the class signal the two
    statistics of natural images that make the reference's augmentation
    recipe (RandomCrop + RandomHorizontalFlip + Cutout,
    ``fedml_api/data_preprocessing/cifar10/data_loader.py:57-99``)
    label-PRESERVING: spatial smoothness (a few-pixel crop shift keeps
    prototype autocorrelation exp(-d²/4σ²) instead of zero, as for iid
    pixels) and horizontal-flip invariance (p ← (p + flip_W(p))/√2, so a
    flipped sample carries the same class signal).  Measured on the real
    chip: with iid-pixel prototypes the augmented north-star run is
    pinned at chance (train acc 0.11 after 12 rounds) — the recipe
    erases an iid-pixel signal entirely.  Prototypes are post-processed
    only (re-normalized to unit per-pixel std), so the RNG stream and
    every default-parameter output are unchanged."""
    rng = np.random.RandomState(seed)
    protos = rng.normal(0, 1, (num_classes, *input_shape)).astype(np.float32)
    if smooth_sigma > 0.0:
        protos = _gaussian_blur_hw(protos, smooth_sigma)
    if flip_symmetric:
        protos = (protos + protos[:, :, ::-1, :]) / np.sqrt(2.0)
    if smooth_sigma > 0.0 or flip_symmetric:
        # restore unit per-pixel signal std so `noise` keeps meaning
        # the same signal-to-noise ratio as the unsmoothed task
        protos /= protos.std(axis=(1, 2, 3), keepdims=True)
        protos = protos.astype(np.float32)

    def make(n, sd):
        r = np.random.RandomState(sd)
        y = r.randint(0, num_classes, n).astype(np.int32)
        x = protos[y] + r.normal(0, noise, (n, *input_shape)).astype(np.float32)
        if label_noise > 0.0:
            flip = r.rand(n) < label_noise
            # uniform over the num_classes-1 WRONG classes
            y = np.where(
                flip,
                (y + 1 + r.randint(0, num_classes - 1, n)) % num_classes,
                y,
            ).astype(np.int32)
        return x.astype(np.float32), y

    train_x, train_y = make(num_train, seed + 10)
    test_x, test_y = make(num_test, seed + 11)
    client_idx = partition_data(
        train_y, num_clients, partition, partition_alpha, seed=seed
    )
    return FedDataset(
        train_x=train_x,
        train_y=train_y,
        test_x=test_x,
        test_y=test_y,
        train_client_idx=client_idx,
        test_client_idx=None,
        num_classes=num_classes,
        name=name,
    )
