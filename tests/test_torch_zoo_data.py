"""The port's zoo loaders (``fedml_tpu_torch/data/{mnist,emnist,
stackoverflow,synthetic}.py``, numpy copies) held against the JAX
package's: every offline stand-in gives the same arrays and client index
maps, byte for byte, and every real-file reader (LEAF json, IDX with and
without gzip, npz, TFF h5) reads the same fixture files into the same
dataset.  The fixtures are the formats ``tests/test_data_fixtures.py``
writes, at its sizes.  ``pack_clients`` (and the native row gather
under it) carries int32 token rows and float32 multi-hot rows unchanged.
"""

import gzip
import json
import struct

import numpy as np
import pytest

import fedml_tpu.core.types as jtypes
import fedml_tpu.data.emnist as jemnist
import fedml_tpu.data.mnist as jmnist
import fedml_tpu.data.stackoverflow as jso
import fedml_tpu.data.synthetic as jsynthetic
from fedml_tpu_torch.core.types import pack_clients
from fedml_tpu_torch.data import emnist, mnist, stackoverflow, synthetic
from fedml_tpu_torch.native import packer

NO_FILES = "no-such-dir"


def _assert_same_dataset(got, want):
    for name in ("train_x", "train_y", "test_x", "test_y"):
        a, b = getattr(got, name), getattr(want, name)
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name
    assert (got.num_classes, got.name) == (want.num_classes, want.name)
    for attr in ("train_client_idx", "test_client_idx"):
        a, b = getattr(got, attr), getattr(want, attr)
        if b is None:
            assert a is None, attr
            continue
        assert list(a) == list(b), attr
        for c in b:
            np.testing.assert_array_equal(a[c], b[c], err_msg=f"{attr}[{c}]")


@pytest.mark.parametrize("load", [
    lambda m: m.load_mnist(NO_FILES, num_clients=20),
    lambda m: m.load_mnist(NO_FILES, num_clients=5, partition="hetero",
                           flatten=False, standin_label_noise=0.1),
], ids=["power_law", "hetero_images_noisy"])
def test_mnist_standin_is_jaxs(load):
    _assert_same_dataset(load(mnist), load(jmnist))


@pytest.mark.parametrize("load", [
    lambda m: m.load_femnist(NO_FILES, standin_max_clients=8),
    lambda m: m.load_fed_cifar100(NO_FILES, num_clients=4),
    lambda m: m.load_fed_cifar100(NO_FILES, num_clients=2, standin_natural_stats=True),
], ids=["femnist", "fed_cifar100", "fed_cifar100_natural"])
def test_emnist_standins_are_jaxs(load):
    _assert_same_dataset(load(emnist), load(jemnist))


@pytest.mark.parametrize("load", [
    lambda m: m.load_stackoverflow_nwp(NO_FILES, num_clients=3),
    lambda m: m.load_stackoverflow_nwp(NO_FILES, num_clients=3, standin_peak_eta=0.2,
                                       standin_test_sequences=40),
    lambda m: m.load_stackoverflow_lr(NO_FILES, num_clients=3),
], ids=["nwp", "nwp_peaked", "lr"])
def test_stackoverflow_standins_are_jaxs(load):
    got, want = load(stackoverflow), load(jso)
    _assert_same_dataset(got, want)
    assert (getattr(got, "standin_bayes_ceiling", None)
            == getattr(want, "standin_bayes_ceiling", None))


def test_stackoverflow_shapes_and_helpers_are_jaxs():
    nwp = stackoverflow.load_stackoverflow_nwp(NO_FILES, num_clients=3)
    assert nwp.train_x.dtype == np.int32 and nwp.train_x.shape[1] == stackoverflow.NWP_SEQ_LEN
    assert nwp.num_classes == stackoverflow.NWP_EXTENDED == 10004
    lr = stackoverflow.load_stackoverflow_lr(NO_FILES, num_clients=3)
    assert lr.train_x.shape[1] == 10000 and lr.train_y.shape[1] == 500
    assert lr.train_y.dtype == np.float32
    assert stackoverflow.zipf_weights(50).tobytes() == jso.zipf_weights(50).tobytes()
    assert stackoverflow.nwp_chain_ceiling(0.3) == jso.nwp_chain_ceiling(0.3)
    a, pa = stackoverflow._peaked_chain(np.random.RandomState(1), 5000, 40, 0.2, chunk=1024)
    b, pb = jso._peaked_chain(np.random.RandomState(1), 5000, 40, 0.2, chunk=1024)
    assert a.tobytes() == b.tobytes() and pa.tobytes() == pb.tobytes()


def test_synthetic_alpha_beta_and_pixel_moments_are_jaxs():
    _assert_same_dataset(synthetic.synthetic_alpha_beta(num_clients=5, seed=3),
                         jsynthetic.synthetic_alpha_beta(num_clients=5, seed=3))
    kw = dict(num_train=200, num_test=40, input_shape=(6, 6, 1), num_clients=4, seed=2)
    got = synthetic.match_pixel_moments(synthetic.synthetic_classification(**kw), 0.8264, 0.3317)
    want = jsynthetic.match_pixel_moments(jsynthetic.synthetic_classification(**kw),
                                          0.8264, 0.3317)
    _assert_same_dataset(got, want)
    assert abs(float(got.train_x.mean()) - 0.8264) < 1e-4


# ---------- real-file readers, both packages on the same files ----------

def _write_idx(path, arr, gz=False):
    arr = np.asarray(arr, np.uint8)
    header = struct.pack(">HBB", 0, 8, arr.ndim) + struct.pack(">" + "I" * arr.ndim, *arr.shape)
    opener = gzip.open if gz else open
    with opener(str(path) + (".gz" if gz else ""), "wb") as f:
        f.write(header + arr.tobytes())


def _write_idx_set(d, rng, n_train=40, n_test=8):
    _write_idx(d / "train-images-idx3-ubyte", rng.randint(0, 256, (n_train, 28, 28)), gz=True)
    _write_idx(d / "train-labels-idx1-ubyte", rng.randint(0, 10, n_train))
    _write_idx(d / "t10k-images-idx3-ubyte", rng.randint(0, 256, (n_test, 28, 28)))
    _write_idx(d / "t10k-labels-idx1-ubyte", rng.randint(0, 10, n_test))


def _leaf_blob(rng, users_counts):
    return {"users": [u for u, _ in users_counts],
            "num_samples": [n for _, n in users_counts],
            "user_data": {u: {"x": rng.rand(n, 784).round(4).tolist(),
                              "y": rng.randint(0, 10, n).tolist()}
                          for u, n in users_counts}}


def _mnist_idx(d, rng):
    _write_idx_set(d, rng)
    return dict(num_clients=4, flatten=True)


def _mnist_npz(d, rng):
    np.savez(d / "mnist.npz",
             x_train=rng.randint(0, 256, (30, 28, 28), dtype=np.uint8),
             y_train=rng.randint(0, 10, 30),
             x_test=rng.randint(0, 256, (6, 28, 28), dtype=np.uint8),
             y_test=rng.randint(0, 10, 6))
    return dict(num_clients=3, flatten=False)


def _mnist_leaf(d, rng):
    """LEAF json; the test file lists bob first and omits carol, so the
    test split is matched by user id."""
    (d / "train").mkdir()
    (d / "test").mkdir()
    (d / "train" / "a.json").write_text(json.dumps(
        _leaf_blob(rng, [("alice", 4), ("bob", 2), ("carol", 3)])))
    (d / "test" / "a.json").write_text(json.dumps(
        _leaf_blob(rng, [("bob", 1), ("alice", 2)])))
    return dict(flatten=True)


def _mnist_non_leaf_json(d, rng):
    """Stray non-LEAF json under train/ and test/ falls through to IDX."""
    (d / "train").mkdir()
    (d / "test").mkdir()
    (d / "train" / "metadata.json").write_text('{"k": 1}')
    (d / "test" / "metadata.json").write_text('{"k": 2}')
    _write_idx_set(d, rng, 20, 4)
    return dict(num_clients=2)


@pytest.mark.parametrize("write", [_mnist_idx, _mnist_npz, _mnist_leaf, _mnist_non_leaf_json],
                         ids=["idx_gz", "npz", "leaf_json", "non_leaf_json"])
def test_mnist_readers_are_jaxs(tmp_path, write):
    kw = write(tmp_path, np.random.RandomState(2))
    got = mnist.load_mnist(str(tmp_path), **kw)
    _assert_same_dataset(got, jmnist.load_mnist(str(tmp_path), **kw))
    assert got.name == "mnist"


def _h5_clients(path, rng, x_key, x_of, counts):
    import h5py

    with h5py.File(path, "w") as f:
        ex = f.create_group("examples")
        for cid, n in counts.items():
            g = ex.create_group(cid)
            g.create_dataset(x_key, data=x_of(n))
            g.create_dataset("label", data=rng.randint(0, 62, n))


def test_h5_readers_are_jaxs(tmp_path):
    h5py = pytest.importorskip("h5py")
    rng = np.random.RandomState(6)
    for name in ("fed_emnist_train.h5", "fed_emnist_test.h5"):
        _h5_clients(tmp_path / name, rng, "pixels", lambda n: rng.rand(n, 28, 28),
                    {"c01": 3, "c00": 5})
    for name in ("fed_cifar100_train.h5", "fed_cifar100_test.h5"):
        _h5_clients(tmp_path / name, rng, "image",
                    lambda n: rng.randint(0, 256, (n, 24, 24, 3)), {"u0": 4, "u1": 2})
    got = emnist.load_femnist(str(tmp_path))
    _assert_same_dataset(got, jemnist.load_femnist(str(tmp_path)))
    assert got.train_x.shape == (8, 28, 28, 1) and got.name == "femnist"
    got = emnist.load_fed_cifar100(str(tmp_path))
    _assert_same_dataset(got, jemnist.load_fed_cifar100(str(tmp_path)))
    assert got.train_x.shape == (6, 24, 24, 3) and float(got.train_x.max()) <= 1.0

    seq = stackoverflow.NWP_SEQ_LEN
    with h5py.File(tmp_path / "stackoverflow_train.h5", "w") as f:
        ex = f.create_group("examples")
        for cid, rows in (("u0", 3), ("u1", 2)):
            ex.create_group(cid).create_dataset(
                "tokens", data=rng.randint(1, 100, (rows, seq + 1)))
    got = stackoverflow.load_stackoverflow_nwp(str(tmp_path), num_clients=2)
    _assert_same_dataset(got, jso.load_stackoverflow_nwp(str(tmp_path), num_clients=2))
    assert got.test_x is None                      # no held-out file: no test split
    with h5py.File(tmp_path / "stackoverflow_test.h5", "w") as f:
        f.create_group("examples").create_group("u9").create_dataset(
            "tokens", data=rng.randint(1, 100, (2, seq + 1)))
    got = stackoverflow.load_stackoverflow_nwp(str(tmp_path), num_clients=2)
    _assert_same_dataset(got, jso.load_stackoverflow_nwp(str(tmp_path), num_clients=2))
    assert got.test_x.shape == (2, seq)

    with h5py.File(tmp_path / "stackoverflow_lr_train.h5", "w") as f:
        f.create_dataset("x", data=rng.rand(8, 50))
        f.create_dataset("y", data=(rng.rand(8, 5) > 0.7).astype(np.float32))
        f.create_dataset("client_ptr", data=np.arange(8).reshape(2, 4))
    with h5py.File(tmp_path / "stackoverflow_lr_test.h5", "w") as f:
        f.create_dataset("x", data=rng.rand(3, 50))
        f.create_dataset("y", data=(rng.rand(3, 5) > 0.7).astype(np.float32))
    got = stackoverflow.load_stackoverflow_lr(str(tmp_path), num_tags=5)
    _assert_same_dataset(got, jso.load_stackoverflow_lr(str(tmp_path), num_tags=5))
    assert got.train_y.shape == (8, 5) and got.test_x.shape == (3, 50)


# ---------- packing token and multi-hot rows ----------

@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("which", ["nwp_tokens", "lr_multi_hot"])
def test_pack_clients_carries_token_and_multi_hot_rows(monkeypatch, which, native):
    if which == "nwp_tokens":
        ds = stackoverflow.load_stackoverflow_nwp(NO_FILES, num_clients=3,
                                                  sequences_per_client=7)
        jds = jso.load_stackoverflow_nwp(NO_FILES, num_clients=3, sequences_per_client=7)
    else:
        ds = stackoverflow.load_stackoverflow_lr(NO_FILES, num_clients=3, samples_per_client=5)
        jds = jso.load_stackoverflow_lr(NO_FILES, num_clients=3, samples_per_client=5)
    if not native:
        monkeypatch.setattr(packer, "_load", lambda: None)
    elif not packer.native_available():
        pytest.skip("no C++ compiler: the native packer cannot build")
    ids = [2, 0]
    got = pack_clients(ds, ids, 4, steps_per_epoch=3, seed=1)
    want = jtypes.pack_clients(jds, ids, 4, steps_per_epoch=3, seed=1)
    assert got.x.dtype == ds.train_x.dtype and got.y.dtype == ds.train_y.dtype
    for a, b in ((got.x, want.x), (got.y, want.y), (got.mask, want.mask),
                 (got.num_samples, want.num_samples)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    # every real slot holds one of its client's rows, unchanged
    for k, c in enumerate(ids):
        rows = {ds.train_x[i].tobytes(): ds.train_y[i].tobytes()
                for i in ds.train_client_idx[c]}
        flat_x = got.x[k].reshape(-1, *ds.train_x.shape[1:])
        flat_y = got.y[k].reshape(-1, *ds.train_y.shape[1:])
        for x, y in zip(flat_x, flat_y):
            assert rows[x.tobytes()] == y.tobytes()
