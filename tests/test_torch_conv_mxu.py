"""The port's implicit-GEMM 3x3 conv (``fedml_tpu_torch/ops/conv_mxu.py``)
held against the JAX package's (``fedml_tpu/ops/conv_mxu.py``, Pallas in
interpret mode, and its XLA reference) on the same numpy inputs.

On the CPU the port's wrapper runs its plain version; the hand-written
CUDA kernels are held against that plain version on the card by
``tests/test_torch_conv_mxu_gpu.py`` (skipped without a GPU) and by
``chip_smoke.py``.  Tolerances are those of ``tests/test_conv_mxu.py``.
The tile plan that sizes the kernels' launches is pure Python and is
checked here."""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.ops.conv_mxu import (
    _xla_conv3x3,
    conv3x3 as jconv3x3,
    conv3x3_moments as jconv3x3_moments,
    conv3x3_mxu as jconv3x3_mxu,
)
from fedml_tpu_torch.ops import conv_mxu as conv_mod
from fedml_tpu_torch.ops.conv_mxu import (
    conv3x3,
    conv3x3_moments,
    conv3x3_mxu,
    conv3x3_plain,
)
from test_conv_mxu import STAGE_SHAPES, _tols

DTYPES = ["fp32", "bf16"]
_JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
_TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _inputs(hw, ci, co, dname, n=2):
    """Same values on both sides: fp32 numpy, cast to the working dtype
    by each framework (both round to nearest even)."""
    rng = np.random.RandomState(hw * ci + co)
    x = rng.standard_normal((n, hw, hw, ci)).astype(np.float32)
    w = (rng.standard_normal((3, 3, ci, co)) * 0.2).astype(np.float32)
    jx, jw = jnp.asarray(x).astype(_JDT[dname]), jnp.asarray(w).astype(_JDT[dname])
    tx, tw = (torch.from_numpy(x).to(_TDT[dname]),
              torch.from_numpy(w).to(_TDT[dname]))
    return jx, jw, tx, tw


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("dname", DTYPES)
@pytest.mark.parametrize("hw,ci,co,stride", STAGE_SHAPES)
def test_forward_matches_jax(hw, ci, co, stride, dname):
    jx, jw, tx, tw = _inputs(hw, ci, co, dname)
    got = conv3x3_mxu(tx, tw, stride=stride)
    assert got.dtype == _TDT[dname]
    assert tuple(got.shape) == (2, hw // stride, hw // stride, co)
    tol = _tols(_JDT[dname])
    np.testing.assert_allclose(
        _np(got), _np(jconv3x3_mxu(jx, jw, stride=stride, interpret=True)), **tol)
    np.testing.assert_allclose(_np(got), _np(_xla_conv3x3(jx, jw, stride)), **tol)


@pytest.mark.parametrize("dname", DTYPES)
@pytest.mark.parametrize("hw,ci,co,stride", [(16, 16, 16, 1), (8, 32, 32, 2)])
def test_moments_and_epilogue_match_jax(hw, ci, co, stride, dname):
    """Moments are of the EMITTED values (after the epilogue and the cast)."""
    jx, jw, tx, tw = _inputs(hw, ci, co, dname)
    mul = np.linspace(0.5, 1.5, co).astype(np.float32)
    add = np.linspace(-0.3, 0.3, co).astype(np.float32)
    for kw in ({}, {"relu": True}):
        ty, ts, tsq = conv3x3_mxu(tx, tw, stride=stride, moments=True,
                                  mul=torch.from_numpy(mul),
                                  add=torch.from_numpy(add), **kw)
        jy, js, jsq = jconv3x3_mxu(jx, jw, stride=stride, moments=True,
                                   mul=mul, add=add, interpret=True, **kw)
        np.testing.assert_allclose(_np(ty), _np(jy), **_tols(_JDT[dname]))
        yf = _np(ty)
        np.testing.assert_allclose(_np(ts), yf.sum((0, 1, 2)), rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(_np(tsq), (yf * yf).sum((0, 1, 2)),
                                   rtol=1e-4, atol=1e-3)
        if dname == "fp32":
            np.testing.assert_allclose(_np(ts), _np(js), rtol=1e-4, atol=1e-3)
            np.testing.assert_allclose(_np(tsq), _np(jsq), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("dname", DTYPES)
@pytest.mark.parametrize("hw,ci,co,stride", STAGE_SHAPES)
def test_conv3x3_grads_match_jax(hw, ci, co, stride, dname):
    """dgrad and wgrad of a non-trivial scalar loss, port autograd vs
    jax.grad through the JAX custom_vjp."""
    jx, jw, tx, tw = _inputs(hw, ci, co, dname)
    cot = np.random.RandomState(3).standard_normal(
        (2, hw // stride, hw // stride, co)).astype(np.float32)

    def jloss(x_, w_):
        y = jconv3x3(x_, w_, stride).astype(jnp.float32)
        return (y * cot).sum() + (y * y).sum() * 0.1

    rx, rw = jax.grad(jloss, argnums=(0, 1))(jx, jw)
    tx.requires_grad_(True)
    tw.requires_grad_(True)
    y = conv3x3(tx, tw, stride).float()
    ((y * torch.from_numpy(cot)).sum() + (y * y).sum() * 0.1).backward()
    tol = _tols(_JDT[dname], grad=True)
    np.testing.assert_allclose(_np(tx.grad), _np(rx), **tol)
    np.testing.assert_allclose(_np(tw.grad), _np(rw), **tol)


@pytest.mark.parametrize("dname", DTYPES)
@pytest.mark.parametrize("hw,ci,co,stride", [(16, 16, 16, 1), (8, 32, 32, 2)])
def test_conv3x3_moments_grads_match_jax(hw, ci, co, stride, dname):
    """The moment cotangents fold into dy exactly as in the JAX vjp."""
    jx, jw, tx, tw = _inputs(hw, ci, co, dname)
    ds = np.linspace(0.5, 1.5, co).astype(np.float32)
    dsq = np.linspace(-0.5, 0.5, co).astype(np.float32)

    def jloss(x_, w_):
        y_, s_, sq_ = jconv3x3_moments(x_, w_, stride)
        return y_.astype(jnp.float32).sum() + (s_ * ds).sum() + (sq_ * dsq).sum()

    rx, rw = jax.grad(jloss, argnums=(0, 1))(jx, jw)
    tx.requires_grad_(True)
    tw.requires_grad_(True)
    y, s, sq = conv3x3_moments(tx, tw, stride)
    (y.float().sum() + (s * torch.from_numpy(ds)).sum()
     + (sq * torch.from_numpy(dsq)).sum()).backward()
    tol = _tols(_JDT[dname], grad=True)
    np.testing.assert_allclose(_np(tx.grad), _np(rx), **tol)
    np.testing.assert_allclose(_np(tw.grad), _np(rw), **tol)


def test_input_validation():
    x = torch.zeros(2, 8, 8, 16)
    with pytest.raises(ValueError):
        conv3x3_mxu(x, torch.zeros(1, 1, 16, 16))       # not 3x3
    with pytest.raises(ValueError):
        conv3x3_mxu(x, torch.zeros(3, 3, 8, 16))        # Cin mismatch
    with pytest.raises(ValueError):
        conv3x3_mxu(x, torch.zeros(3, 3, 16, 16), stride=3)
    with pytest.raises(ValueError):
        conv3x3_mxu(torch.zeros(2, 9, 9, 16), torch.zeros(3, 3, 16, 16), stride=2)


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    _, _, tx, tw = _inputs(8, 16, 16, "fp32")
    before = conv3x3_mxu.launches
    np.testing.assert_array_equal(_np(conv3x3_mxu(tx, tw)), _np(conv3x3_plain(tx, tw)))
    assert conv3x3_mxu.launches == before


# ResNet-56's 3x3 convs at N=64 (spatial, Cin, Cout, stride, route): the
# stem on the CUDA-core kernel, the rest on the tensor-core kernel
RESNET56_SHAPES = [(32, 3, 16, 1, "v2"), (32, 16, 16, 1, "tc"), (32, 32, 32, 2, "tc"),
                   (16, 32, 32, 1, "tc"), (16, 64, 64, 2, "tc"), (8, 64, 64, 1, "tc")]
H100_SMS = 132
H100_SMEM_PER_BLOCK = 232448  # 227 KB


@pytest.mark.parametrize("hw,ci,co,stride,route", RESNET56_SHAPES[1:])
def test_tile_plan_fills_the_card(hw, ci, co, stride, route):
    m = 64 * (hw // stride) ** 2
    bm, k_split = conv_mod._tile_plan(m)
    assert (bm, k_split) in {(64, 1), (32, 2), (16, 4)}
    assert -(-m // bm) >= H100_SMS


@pytest.mark.parametrize("ci,co", [(16, 16), (32, 32), (64, 64), (8, 16), (128, 64)])
def test_tc_shared_memory_fits_a_block(ci, co):
    """Every (Cin, Cout) the tensor-core route takes, up to its Cin limit."""
    assert conv_mod._tc_smem_bytes(ci, co) <= H100_SMEM_PER_BLOCK


class _FakeLib:
    """Stands in for the built library: records each launch's arguments."""

    def __init__(self):
        self.calls = []

    def conv3x3_mxu_tc_fwd(self, *args):
        self.calls.append(("tc", args))
        return 0

    def conv3x3_mxu_fwd(self, *args):
        self.calls.append(("v2", args))
        return 0

    def conv3x3_mxu_moments_reduce(self, part, out, nb, co, stream):
        self.reduced_rows = nb
        return 0


@pytest.mark.parametrize("hw,ci,co,stride,route", RESNET56_SHAPES)
def test_wrapper_allocates_partials_for_the_launched_blocks(monkeypatch, hw, ci, co,
                                                            stride, route):
    """The moment partials the wrapper allocates have one row per block the
    entry point launches for the rows it is given (ceil(M / rows), the
    kernel's grid); the route and its counter follow the static condition."""
    lib = _FakeLib()
    partials = []
    empty = torch.empty

    def recording_empty(*shape, **kw):
        t = empty(*shape, **kw)
        if kw.get("dtype") == torch.float32:
            partials.append(tuple(t.shape))
        return t

    monkeypatch.setattr(conv_mod, "_load", lambda: lib)
    monkeypatch.setattr(torch, "empty", recording_empty)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    x = torch.zeros(64, hw, hw, ci, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, ci, co, dtype=torch.bfloat16)
    before = (conv3x3_mxu.launches, conv3x3_mxu.tc_launches)
    conv_mod._conv3x3_cuda(x, w, stride, None, None, False, True)
    assert (conv3x3_mxu.launches, conv3x3_mxu.tc_launches) == (
        before[0] + 1, before[1] + int(route == "tc"))
    (got_route, args), = lib.calls
    assert got_route == route
    n, h, wd, ci_, co_, stride_ = args[7:13]
    m = n * (h // stride_) * (wd // stride_)
    if route == "tc":
        bm, k_split, smem = args[14:17]
        assert (bm, k_split) == conv_mod._tile_plan(m)
        assert smem == conv_mod._tc_smem_bytes(ci_, co_)
    else:
        is_bf16, bm = args[14:16]
        assert is_bf16 == 1 and bm == 4096 // co_
    assert partials[0] == (2, -(-m // bm), co) and lib.reduced_rows == -(-m // bm)
