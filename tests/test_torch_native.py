"""The port's native packer (``fedml_tpu_torch/native``): the gather
against numpy, the fallback path, and ``pack_clients`` byte-identical
with the library loaded, without it, with ``reuse_buffers`` and against
the JAX package's ``pack_clients`` (mirrors ``tests/test_native.py``)."""

import numpy as np
import pytest
import torch

from fedml_tpu.core.types import pack_clients as jpack_clients
from fedml_tpu.data.synthetic import synthetic_classification as jsynthetic
from fedml_tpu_torch.core.types import device_resident_pack, pack_clients
from fedml_tpu_torch.data.synthetic import synthetic_classification
from fedml_tpu_torch.native import gather_rows, native_available
from fedml_tpu_torch.native import packer as packer_mod


@pytest.fixture
def no_native(monkeypatch):
    """The numpy fallback, as on a host without a compiler."""
    monkeypatch.setattr(packer_mod, "_lib", None)
    monkeypatch.setattr(packer_mod, "_tried", True)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8, np.int64, np.float16])
def test_gather_rows_matches_numpy(dtype):
    rng = np.random.RandomState(0)
    src = (rng.rand(100, 7, 3) * 100).astype(dtype)
    idx = rng.randint(0, 100, size=257)
    np.testing.assert_array_equal(gather_rows(src, idx), src[idx])


def test_gather_rows_1d_rows_and_preallocated_out():
    rng = np.random.RandomState(1)
    src = rng.rand(50).astype(np.float32)
    idx = rng.randint(0, 50, size=33)
    out = np.empty((33,), np.float32)
    assert gather_rows(src, idx, out) is out
    np.testing.assert_array_equal(out, src[idx])


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_gather_rows_clamps_out_of_range(native, monkeypatch):
    if not native:
        monkeypatch.setattr(packer_mod, "_lib", None)
        monkeypatch.setattr(packer_mod, "_tried", True)
    src = np.arange(10, dtype=np.float32).reshape(10, 1)
    out = gather_rows(src, np.array([-5, 3, 99]))
    np.testing.assert_array_equal(out[:, 0], [0.0, 3.0, 9.0])


def test_gather_rows_large_threaded():
    rng = np.random.RandomState(2)
    src = rng.rand(2000, 512).astype(np.float32)  # > 4 MiB: the threaded path
    idx = rng.randint(0, 2000, size=4096)
    np.testing.assert_array_equal(gather_rows(src, idx), src[idx])


def test_gather_rows_rejects_a_mismatched_out():
    src = np.zeros((4, 3), np.float32)
    with pytest.raises(ValueError, match="need"):
        gather_rows(src, np.arange(2), np.empty((2, 4), np.float32))
    with pytest.raises(ValueError, match="C-contiguous"):
        gather_rows(src, np.arange(2), np.empty((3, 2), np.float32).T)


def test_native_lib_builds_here():
    """With g++ installed the native path must be live (guards against a
    silent permanent fallback), built under build/native/."""
    assert native_available()
    assert packer_mod._LIB.parent.parts[-2:] == ("build", "native")


def _datasets(**kw):
    kw = dict(num_train=300, num_test=50, input_shape=(6,), num_classes=3,
              num_clients=5, seed=0, **{"partition": "hetero", **kw})
    return synthetic_classification(**kw), jsynthetic(**kw)


def _assert_same_pack(a, b):
    for f in ("x", "y", "mask", "num_samples"):
        ga, gb = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert ga.dtype == gb.dtype and ga.shape == gb.shape
        assert ga.tobytes() == gb.tobytes(), f


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_pack_clients_equals_jax_pack(native, monkeypatch):
    if not native:
        monkeypatch.setattr(packer_mod, "_lib", None)
        monkeypatch.setattr(packer_mod, "_tried", True)
    ds, jds = _datasets()
    _assert_same_pack(pack_clients(ds, [0, 2, 4], batch_size=8, seed=3),
                      jpack_clients(jds, [0, 2, 4], batch_size=8, seed=3))


def test_pack_clients_identical_native_vs_fallback(no_native):
    ds, _ = _datasets()
    fallback = pack_clients(ds, [0, 2, 4], batch_size=8, seed=3)
    packer_mod._tried = False  # load the library again
    assert native_available()
    _assert_same_pack(pack_clients(ds, [0, 2, 4], batch_size=8, seed=3), fallback)


def test_pack_clients_reuse_buffers_identical_and_shared():
    ds, jds = _datasets(partition="homo")  # equal shards: one pack geometry
    fresh = pack_clients(ds, [0, 1], batch_size=8, seed=2)
    reused1 = pack_clients(ds, [0, 1], batch_size=8, seed=2, reuse_buffers=True)
    _assert_same_pack(fresh, reused1)
    _assert_same_pack(reused1, jpack_clients(jds, [0, 1], batch_size=8, seed=2,
                                             reuse_buffers=True))
    assert reused1.x.base is not reused1.y.base  # x and y never share a buffer
    reused2 = pack_clients(ds, [2, 3], batch_size=8, seed=2, reuse_buffers=True)
    assert reused2.x.base is reused1.x.base  # the same host buffer, overwritten
    _assert_same_pack(reused2, pack_clients(ds, [2, 3], batch_size=8, seed=2))


def test_device_resident_pack_on_the_cpu_does_not_reuse_buffers():
    """On the CPU the device block aliases the host pack, so a reused
    buffer would be overwritten under the cached block by the next pack."""
    ds, _ = _datasets()
    (x1, *_), _ = device_resident_pack(ds, [0, 1], 8, steps_per_epoch=4, seed=0,
                                       device=torch.device("cpu"))
    keep = x1.clone()
    device_resident_pack(ds, [2, 3], 8, steps_per_epoch=4, seed=0,
                         device=torch.device("cpu"))
    assert torch.equal(x1, keep)


def test_pack_clients_rejects_out_of_range_indices():
    ds, _ = _datasets()
    ds.train_client_idx[1] = np.array([0, 5, 999])  # 999 >= 300
    with pytest.raises(IndexError):
        pack_clients(ds, [0, 1], batch_size=4)
