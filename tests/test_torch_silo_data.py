"""The cross-silo loaders of the port (``fedml_tpu_torch/data/cifar.py``'s
``load_cifar100`` and ``load_cinic10``, ``data/imagefolder.py``, the
registry's ``synthetic``) held against the JAX package's, byte for byte:
arrays, labels and client index maps, from the python pickles, the npz
layout, CINIC-10's PNG folder tree (with and without ``test/``) and the
offline stand-ins; every ``imagefolder`` helper, the CSV user maps
included; and ``make_image_augment(cutout=None)`` (CINIC-10's recipe)
equal to JAX's for a fixed key.
"""

import csv
import os
import pickle

import jax
import numpy as np
import pytest
import torch

import fedml_tpu.data.cifar as jcifar
import fedml_tpu.data.imagefolder as jimagefolder
from fedml_tpu.data.augment import make_image_augment as jmake_image_augment
from fedml_tpu.experiments import registry as jregistry
from fedml_tpu_torch.core import rng as rnglib
from fedml_tpu_torch.data import cifar, imagefolder
from fedml_tpu_torch.data.augment import make_image_augment
from fedml_tpu_torch.experiments import registry
from test_torch_zoo_data import NO_FILES, _assert_same_dataset

CLASSES = ("airplane", "bird", "cat")


def _write_cifar100_pickles(d, n_train=40, n_test=12):
    rng = np.random.RandomState(0)
    os.makedirs(d)
    for name, n in (("train", n_train), ("test", n_test)):
        z = {"data": rng.randint(0, 256, (n, 3072)).astype(np.uint8),
             "fine_labels": rng.randint(0, 100, n).tolist(),
             "coarse_labels": rng.randint(0, 20, n).tolist()}
        with open(os.path.join(d, name), "wb") as f:
            pickle.dump(z, f)


def _write_npz(path, n_train=30, n_test=10, classes=10):
    rng = np.random.RandomState(1)
    np.savez(path, x_train=rng.randint(0, 256, (n_train, 32, 32, 3)).astype(np.uint8),
             y_train=rng.randint(0, classes, n_train),
             x_test=rng.randint(0, 256, (n_test, 32, 32, 3)).astype(np.uint8),
             y_test=rng.randint(0, classes, n_test))


def _write_png_tree(root, splits=("train", "test"), per_class=(5, 2)):
    """A CINIC-10-shaped folder tree of PNGs (one 40x40 image per class to
    exercise the resize, the rest 32x32), in a nested subdirectory too."""
    from PIL import Image

    rng = np.random.RandomState(2)
    for split, n in zip(splits, per_class):
        for ci, cls in enumerate(CLASSES):
            for i in range(n):
                sub = os.path.join(root, split, cls, "nested" if i == n - 1 else "")
                os.makedirs(sub, exist_ok=True)
                side = 40 if i == 0 else 32
                img = rng.randint(0, 256, (side, side, 3)).astype(np.uint8)
                Image.fromarray(img).save(os.path.join(sub, f"{cls}_{i:03d}.png"))
            # a file that is not an image is skipped
            with open(os.path.join(root, split, cls, "README.txt"), "w") as f:
                f.write("not an image")


@pytest.mark.parametrize("layout", ["pickles", "pickles_subdir", "npz", "standin"])
def test_load_cifar100_is_jaxs(tmp_path, layout):
    d = str(tmp_path)
    if layout == "pickles":
        os.rmdir(d)
        _write_cifar100_pickles(d)
    elif layout == "pickles_subdir":
        _write_cifar100_pickles(os.path.join(d, "cifar-100-python"))
    elif layout == "npz":
        _write_npz(os.path.join(d, "cifar100.npz"), classes=100)
    else:
        d = NO_FILES
    kw = dict(num_clients=3, partition="hetero", partition_alpha=0.5, seed=1)
    got, want = cifar.load_cifar100(d, **kw), jcifar.load_cifar100(d, **kw)
    _assert_same_dataset(got, want)
    assert got.num_classes == 100
    assert ("synthetic" in got.name) == (layout == "standin")


@pytest.mark.parametrize("layout", ["tree", "tree_no_test", "npz", "standin"])
def test_load_cinic10_is_jaxs(tmp_path, layout):
    d = str(tmp_path)
    if layout == "tree":
        _write_png_tree(d)
    elif layout == "tree_no_test":
        _write_png_tree(d, splits=("train",), per_class=(30,))
    elif layout == "npz":
        _write_npz(os.path.join(d, "cinic10.npz"))
    else:
        d = NO_FILES
    kw = dict(num_clients=2, partition="homo", seed=3)
    got, want = cifar.load_cinic10(d, **kw), jcifar.load_cinic10(d, **kw)
    _assert_same_dataset(got, want)
    if layout == "tree_no_test":
        # 64 rows strided across the class-grouped walk, not a prefix
        assert len(got.test_y) == 64 and set(got.test_y.tolist()) == {0, 1, 2}
    if layout.startswith("tree"):
        # normalized once, in the decode, with the CINIC constants
        assert abs(float(got.train_x.mean())) < 1.0 and got.train_x.dtype == np.float32


def test_imagefolder_scans_and_decodes_as_jax(tmp_path):
    _write_png_tree(str(tmp_path))
    root = os.path.join(str(tmp_path), "train")
    assert imagefolder.find_classes(root) == jimagefolder.find_classes(root)
    for cap in (0, 2):
        got, want = imagefolder.scan_class_tree(root, cap), jimagefolder.scan_class_tree(root, cap)
        assert got[0] == want[0] and got[2] == want[2]
        assert got[1].dtype == want[1].dtype and np.array_equal(got[1], want[1])
    paths = want[0]
    for size in (32, 16):
        a = imagefolder.decode_images(paths, size, cifar.CINIC10_MEAN, cifar.CINIC10_STD)
        b = jimagefolder.decode_images(paths, size, jcifar.CINIC10_MEAN, jcifar.CINIC10_STD)
        assert a.dtype == b.dtype and a.shape == b.shape == (len(paths), size, size, 3)
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("num_classes,num_clients", [(10, 3), (10, 10), (7, 4), (3, 5)])
def test_contiguous_class_clients_is_jaxs(num_classes, num_clients):
    labels = np.random.RandomState(4).randint(0, num_classes, 200).astype(np.int32)
    got = imagefolder.contiguous_class_clients(labels, num_classes, num_clients)
    want = jimagefolder.contiguous_class_clients(labels, num_classes, num_clients)
    assert list(got) == list(want)
    for c in want:
        assert got[c].tobytes() == want[c].tobytes()


def test_user_map_csv_helpers_are_jaxs(tmp_path):
    path = str(tmp_path / "map.csv")
    rows = [("7", "img_a", "3"), ("2", "img_b", "1"), ("7", "img_c", "0"),
            ("5", "img_d", "3"), ("2", "img_e", "2")]
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(("user_id", "image_id", "class"))
        w.writerows(rows)
    got, want = imagefolder.read_user_map_csv(path), jimagefolder.read_user_map_csv(path)
    assert got == want and len(got) == len(rows)
    (gflat, gidx), (wflat, widx) = (imagefolder.group_rows_per_user(got),
                                    jimagefolder.group_rows_per_user(want))
    assert gflat == wflat and list(gidx) == list(widx) == [7, 2, 5]
    for c in widx:
        assert gidx[c].tobytes() == widx[c].tobytes()
    bad = str(tmp_path / "bad.csv")
    with open(bad, "w") as f:
        f.write("user,image\n1,a\n")
    for mod in (imagefolder, jimagefolder):
        with pytest.raises(ValueError, match="user_id, image_id and class"):
            mod.read_user_map_csv(bad)


@pytest.mark.parametrize("dataset", ["synthetic", "cifar100", "cinic10"])
def test_registry_loads_the_silo_datasets_as_jax(dataset):
    kw = dict(num_clients=4, partition_method="hetero", partition_alpha=0.5, seed=2)
    _assert_same_dataset(registry.load_data(dataset, NO_FILES, **kw),
                         jregistry.load_data(dataset, NO_FILES, **kw))


def test_cinic_augment_without_cutout_is_jaxs_bit_for_bit():
    """CINIC-10's recipe (crop at pad 4 and flip, no Cutout) on a fixed
    key; Cutout's key is split off all the same and goes unused."""
    x = np.random.RandomState(5).standard_normal((16, 32, 32, 3)).astype(np.float32)
    key = jax.random.PRNGKey(12)
    want = np.asarray(jax.jit(jmake_image_augment(pad=4, flip=True, cutout=None))(key, x))
    got = make_image_augment(pad=4, flip=True, cutout=None)(
        np.asarray(jax.random.key_data(key)), torch.from_numpy(x)).numpy()
    assert got.tobytes() == want.tobytes()
    assert not np.array_equal(got, x)
    # Cutout would have zeroed a square somewhere; here no pixel of x is lost
    assert (got == 0).mean() < (make_image_augment()(rnglib.PRNGKey(12), torch.from_numpy(x))
                                == 0).float().mean().item()
