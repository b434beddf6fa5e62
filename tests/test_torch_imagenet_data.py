"""The port's ImageNet and Landmarks loaders (``fedml_tpu_torch/data/
imagenet.py``) and edge-case OOD loaders (``data/edge_case.py``) held
against the JAX package's, byte for byte:

- ``load_imagenet`` over a generated JPEG class tree, with and without
  ``val/`` (the strided 64-row test slice), with ``max_per_class``; its npz
  route; its 1000-class stand-in at a small ``image_size``;
- ``load_landmarks`` over generated CSV user maps (gld23k's
  ``mini_gld_*.csv`` and gld160k's ``federated_train.csv``/``test.csv``,
  with and without a test map), the test map's ``image_id``/``class``
  check; its npz route with and without ``user_train``; the power-law
  stand-in of ``min(num_clients, 50)`` clients;
- arrays, labels and client index maps equal; and the registry's routes
  for ``ILSVRC2012``/``imagenet``/``gld23k``/``gld160k`` asking the
  loaders for the JAX registry's geometry (224 px, 1000 / 203 / 2028
  classes, 233 → 50 and 1262 → 50 clients);
- the OOD loaders: ``load_edge_case_images`` from pickled uint8 archives,
  ``synthetic_ood_images``, ``make_edge_case_backdoor`` (shuffled and not),
  ``load_ardis_test`` from ``torch.save``d fixtures (a tensor, and a
  dataset object with ``.data``/``.targets``), and
  ``make_poisoned_dataset`` for all five families, with and without
  archives: every array bit for bit JAX's (the fixtures are
  ``tests/test_data_fixtures.py``'s formats).
"""

import argparse
import os
import pickle

import numpy as np
import pytest
import torch

import fedml_tpu.data.edge_case as jedge
import fedml_tpu.data.imagenet as jimagenet
from fedml_tpu.experiments import registry as jregistry
from fedml_tpu_torch.data import edge_case, imagenet
from fedml_tpu_torch.data.synthetic import synthetic_classification
from fedml_tpu_torch.experiments import registry, run
from test_torch_zoo_data import NO_FILES, _assert_same_dataset

SIDE = 8  # decode size of the fixture trees


def _write_jpeg(path, rgb, size):
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(np.asarray(rgb, np.uint8)).resize((size, size)).save(path, "JPEG",
                                                                          quality=95)


def _image(rng, side=16):
    return rng.randint(0, 256, (side, side, 3))


def _write_imagenet_tree(root, val: bool):
    """train/<class>/*.jpg (+ val/), classes created out of order, a nested
    subdirectory, a non-image file and one 24-px image that the decode
    resizes."""
    rng = np.random.RandomState(0)
    for cls in ("n03", "n01", "n02", "n04"):
        for i in range(5):
            sub = os.path.join(root, "train", cls, "nested" if i == 4 else "")
            _write_jpeg(os.path.join(sub, f"img_{i}.jpg"), _image(rng, 24 if i == 0 else 16),
                        24 if i == 0 else 16)
        with open(os.path.join(root, "train", cls, "notes.txt"), "w") as f:
            f.write("not an image")
        if val:
            for i in range(2):
                _write_jpeg(os.path.join(root, "val", cls, f"v_{i}.jpg"), _image(rng), 16)


@pytest.mark.parametrize("val,max_per_class,clients", [
    (True, 0, 3), (False, 0, 2), (True, 3, 4), (False, 2, 10)],
    ids=["val", "no_val", "val_capped", "no_val_capped_more_clients"])
def test_load_imagenet_folder_tree_is_jaxs(tmp_path, val, max_per_class, clients):
    root = str(tmp_path / "ImageNet")
    _write_imagenet_tree(root, val)
    kw = dict(num_clients=clients, image_size=SIDE, max_per_class=max_per_class)
    got, want = imagenet.load_imagenet(root, **kw), jimagenet.load_imagenet(root, **kw)
    _assert_same_dataset(got, want)
    assert got.num_classes == 4 and got.train_x.shape[1:] == (SIDE, SIDE, 3)


@pytest.mark.parametrize("users", [True, False], ids=["user_train", "homo"])
@pytest.mark.parametrize("which", ["imagenet", "gld23k", "gld160k"])
def test_npz_routes_are_jaxs(tmp_path, which, users):
    rng = np.random.RandomState(10)
    classes = {"imagenet": 1000, "gld23k": 203, "gld160k": 2028}[which]
    z = dict(x_train=rng.rand(12, 8, 8, 3), y_train=rng.randint(0, classes, 12),
             x_test=rng.rand(4, 8, 8, 3), y_test=rng.randint(0, classes, 4))
    if users:
        z["user_train"] = np.array([7, 7, 3, 3, 3, 9, 9, 9, 9, 1, 7, 3])
    name = "imagenet_federated.npz" if which == "imagenet" else f"{which}_federated.npz"
    np.savez(tmp_path / name, **z)
    if which == "imagenet":
        got = imagenet.load_imagenet(str(tmp_path), num_clients=3, seed=2)
        want = jimagenet.load_imagenet(str(tmp_path), num_clients=3, seed=2)
    else:
        got = imagenet.load_landmarks(str(tmp_path), variant=which, seed=2)
        want = jimagenet.load_landmarks(str(tmp_path), variant=which, seed=2)
    _assert_same_dataset(got, want)
    assert got.num_classes == classes


def _write_user_map(root, variant, test_map: bool, bad_test_columns=False):
    """A Landmarks tree: the train map's rows interleave users (grouped in
    first-appearance order), images under ``images/``."""
    rng = np.random.RandomState(1)
    trn, tst = (("mini_gld_train_split.csv", "mini_gld_test.csv") if variant == "gld23k"
                else ("federated_train.csv", "test.csv"))
    rows = [("7", "aaa", 0), ("3", "bbb", 5), ("7", "ccc", 2), ("3", "ddd", 1),
            ("11", "eee", 9), ("7", "fff", 0)]
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, trn), "w") as f:
        f.write("user_id,image_id,class\n")
        for u, img, c in rows:
            f.write(f"{u},{img},{c}\n")
    if test_map:
        with open(os.path.join(root, tst), "w") as f:
            f.write("image_id,landmark\n" if bad_test_columns else "image_id,class\n")
            f.write("ggg,3\nhhh,7\n")
    for img in ("aaa", "bbb", "ccc", "ddd", "eee", "fff", "ggg", "hhh"):
        _write_jpeg(os.path.join(root, "images", f"{img}.jpg"), _image(rng), 16)


@pytest.mark.parametrize("variant", ["gld23k", "gld160k"])
@pytest.mark.parametrize("test_map", [True, False], ids=["test_map", "no_test_map"])
def test_load_landmarks_user_maps_are_jaxs(tmp_path, variant, test_map):
    root = str(tmp_path / "gld")
    _write_user_map(root, variant, test_map)
    got = imagenet.load_landmarks(root, variant=variant, image_size=SIDE)
    want = jimagenet.load_landmarks(root, variant=variant, image_size=SIDE)
    _assert_same_dataset(got, want)
    assert list(got.train_client_idx) == [7, 3, 11]
    assert got.num_classes == (203 if variant == "gld23k" else 2028)


def test_landmarks_test_map_needs_image_id_and_class(tmp_path):
    root = str(tmp_path / "gld")
    _write_user_map(root, "gld23k", True, bad_test_columns=True)
    for mod in (imagenet, jimagenet):
        with pytest.raises(ValueError, match="image_id and class"):
            mod.load_landmarks(root, variant="gld23k", image_size=SIDE)


@pytest.mark.parametrize("load", [
    lambda m: m.load_imagenet(NO_FILES, num_clients=3, image_size=6, seed=1),
    lambda m: m.load_landmarks(NO_FILES, variant="gld23k", image_size=4, seed=2),
    lambda m: m.load_landmarks(NO_FILES, variant="gld160k", image_size=2, seed=0),
], ids=["imagenet", "gld23k", "gld160k"])
def test_standins_are_jaxs(load):
    got, want = load(imagenet), load(jimagenet)
    _assert_same_dataset(got, want)
    assert got.num_clients == (3 if got.num_classes == 1000 else 50)


class _Recorder:
    """Stands in for ``synthetic_classification`` in a loader module: records
    the geometry the loader asks for and builds it at 4 px (the 224-px
    stand-ins' class prototypes alone are 1.2-2.4 GB in float64)."""

    def __init__(self):
        self.calls = []

    def __call__(self, **kw):
        self.calls.append(dict(kw))
        return synthetic_classification(**{**kw, "input_shape": (4, 4, 3)})


@pytest.mark.parametrize("dataset,classes,clients", [
    ("imagenet", 1000, 10), ("ILSVRC2012", 1000, 10), ("gld23k", 203, 50),
    ("gld160k", 2028, 50)])
def test_registry_routes_the_loaders_at_their_geometry(monkeypatch, dataset, classes,
                                                       clients):
    """The port's registry and the JAX registry ask the loaders for the same
    stand-in: 224 x 224 x 3, the dataset's classes, ImageNet's clients as
    given (10) and Landmarks' 233 / 1262 cut to 50."""
    got, want = _Recorder(), _Recorder()
    monkeypatch.setattr(imagenet, "synthetic_classification", got)
    monkeypatch.setattr(jimagenet, "synthetic_classification", want)
    ds = registry.load_data(dataset, data_dir=NO_FILES, num_clients=10, seed=3)
    jregistry.load_data(dataset, data_dir=NO_FILES, num_clients=10, seed=3)
    assert got.calls == want.calls and len(got.calls) == 1
    assert got.calls[0]["input_shape"] == (224, 224, 3)
    assert (ds.num_classes, ds.num_clients) == (classes, clients)


@pytest.mark.parametrize("dataset", ["ILSVRC2012", "gld23k"])
def test_imagenet_and_landmarks_train_unaugmented(dataset):
    """As in the JAX entry point, only the CIFARs and CINIC-10 augment."""
    ds = synthetic_classification(num_train=8, num_test=4, input_shape=(4, 4, 3),
                                  num_classes=3, num_clients=2, partition="homo")
    assert run._augment_fn(run.ExperimentConfig(dataset=dataset), ds) is None


# --- the edge-case OOD loaders ------------------------------------------------

def _host(seed=0, side=32, channels=3, n=600):
    kw = dict(num_train=n, num_test=40, input_shape=(side, side, channels), num_classes=10,
              num_clients=4, partition="homo", seed=seed)
    from fedml_tpu.data.synthetic import synthetic_classification as jsynth

    return synthetic_classification(**kw), jsynth(**kw)


def _assert_same_poison(got, want):
    for name in ("train_x", "train_y", "backdoor_test_x", "backdoor_test_y"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name


def _write_archives(d, rng):
    for name, n, side, ch in (("southwest_images_new_train.pkl", 120, 32, 3),
                              ("southwest_images_new_test.pkl", 5, 32, 3),
                              ("new_green_cars_train.pkl", 150, 32, 3),
                              ("new_green_cars_test.pkl", 4, 32, 3),
                              ("green_car_transformed_test.pkl", 6, 32, 3)):
        with open(os.path.join(d, name), "wb") as f:
            pickle.dump(rng.randint(0, 256, (n, side, side, ch), dtype=np.uint8), f)


def test_load_edge_case_images_and_ood_standin_are_jaxs(tmp_path):
    rng = np.random.RandomState(0)
    _write_archives(str(tmp_path), rng)
    assert edge_case.load_edge_case_images(str(tmp_path / "none")) is None
    got = edge_case.load_edge_case_images(str(tmp_path))
    want = jedge.load_edge_case_images(str(tmp_path))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32 and a.tobytes() == b.tobytes()
    for shape, kw in (((32, 32, 3), {}), ((28, 28, 1), dict(num_train=9, num_test=4, seed=11))):
        for a, b in zip(edge_case.synthetic_ood_images(shape, **kw),
                        jedge.synthetic_ood_images(shape, **kw)):
            assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("n_ood", [8, 200], ids=["capped", "full"])
def test_make_edge_case_backdoor_is_jaxs(shuffle, n_ood):
    ds, jds = _host()
    tr, te = edge_case.synthetic_ood_images((32, 32, 3), num_train=n_ood, num_test=3)
    kw = dict(target_label=9, num_poison=100, num_clean=400, seed=5, shuffle=shuffle)
    got = edge_case.make_edge_case_backdoor(ds, tr, te, **kw)
    _assert_same_poison(got, jedge.make_edge_case_backdoor(jds, tr, te, **kw))
    assert len(got.train_x) == 400 + min(n_ood, 100)


@pytest.mark.parametrize("form", ["tensor", "dataset"])
def test_load_ardis_test_is_jaxs(tmp_path, form):
    rng = np.random.RandomState(4)
    data = rng.randint(0, 256, (7, 28, 28), dtype=np.uint8)
    obj = (torch.from_numpy(data) if form == "tensor"
           else argparse.Namespace(data=data, targets=np.array([7] * 7)))
    torch.save(obj, tmp_path / "ardis_test_dataset.pt")
    got, want = edge_case.load_ardis_test(str(tmp_path)), jedge.load_ardis_test(str(tmp_path))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert got[0].shape == (7, 28, 28, 1)
    assert edge_case.load_ardis_test(str(tmp_path / "none")) is None


@pytest.mark.parametrize("archives", [True, False], ids=["archives", "standins"])
@pytest.mark.parametrize("family", list(jedge.POISON_FAMILIES))
def test_make_poisoned_dataset_is_jaxs(tmp_path, family, archives):
    """All five families, both layouts and a poison count above the archive's
    (southwest-da's noise stops at the real poison tail), bit for bit."""
    assert edge_case.POISON_FAMILIES == jedge.POISON_FAMILIES
    assert edge_case.HOWTO_GREEN_CAR_TRAIN_IDX == jedge.HOWTO_GREEN_CAR_TRAIN_IDX
    assert edge_case.HOWTO_GREEN_CAR_TEST_IDX == jedge.HOWTO_GREEN_CAR_TEST_IDX
    d = ""
    if archives:
        d = str(tmp_path)
        rng = np.random.RandomState(6)
        _write_archives(d, rng)
        torch.save(torch.from_numpy(rng.randint(0, 256, (7, 28, 28), dtype=np.uint8)),
                   tmp_path / "ardis_test_dataset.pt")
    ds, jds = _host(side=28, channels=1) if family == "ardis" else _host()
    for kw in (dict(seed=1), dict(seed=1, shuffle=False), dict(seed=2, num_poison=200),
               dict(seed=3, num_clean=50, shuffle=False)):
        got = edge_case.make_poisoned_dataset(ds, family, d, **kw)
        _assert_same_poison(got, jedge.make_poisoned_dataset(jds, family, d, **kw))


def test_make_poisoned_dataset_refuses_an_unknown_family():
    ds, _ = _host(n=40)
    with pytest.raises(ValueError, match="poison_type"):
        edge_case.make_poisoned_dataset(ds, "nope")
