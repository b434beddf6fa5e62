"""Implicit-GEMM 3x3 conv: the hand-written Hopper kernel and its plain version.

Port of ``fedml_tpu/ops/conv_mxu.py``.  ``conv3x3_mxu`` computes

    patches(x) : [M = N*Ho*Wo, K = 9*Cin]   (column t*Cin + c = tap divmod(t, 3), channel c)
    out        : [M, Cout] = patches @ w.reshape(9*Cin, Cout)

with explicit padding 1, stride 1 or 2 (even-centre windows at stride 2,
i.e. torch's ``padding=1, stride=2``), fp32 accumulation, an optional fp32
per-channel ``mul``/``add`` + ReLU epilogue, a cast to the input dtype,
and optional per-channel fp32 ``(sum, sumsq)`` of the emitted output —
the batch statistics train-mode BatchNorm consumes.  Layouts are the JAX
package's: NHWC activations, HWIO weights.

On a CUDA tensor it launches the sm_90a kernel of ``csrc/conv_mxu.cu``
(built at first use, see ``ops/build.py``) or raises.  On a CPU tensor it
runs ``conv3x3_plain``, the same arithmetic in plain PyTorch; the tests
hold both against the JAX package and ``chip_smoke.py`` holds the kernel
against the plain version on the card.

``conv3x3`` / ``conv3x3_moments`` are the differentiable wrappers.  Their
backward, like the JAX package's, is not a hand-written kernel: the
moment cotangents fold into the output cotangent
(``dy + ds + 2*y*dsq``), then dgrad/wgrad come from
``torch.nn.grad.conv2d_input/conv2d_weight``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

_KERNEL_COUT = (16, 32, 64)
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_lib: Optional[ctypes.CDLL] = None


def _check(x: torch.Tensor, w: torch.Tensor, stride: int):
    if x.ndim != 4:
        raise ValueError(f"need an NHWC input, got shape {tuple(x.shape)}")
    n, h, wd, ci = x.shape
    if w.ndim != 4 or tuple(w.shape[:3]) != (3, 3, ci):
        raise ValueError(f"need a [3,3,{ci},Co] kernel, got {tuple(w.shape)}")
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    if h % stride or wd % stride:
        raise ValueError(f"spatial dims {(h, wd)} must divide stride")
    return n, h, wd, ci, w.shape[3], h // stride, wd // stride


def conv3x3_plain(x, w, *, stride: int = 1, mul=None, add=None,
                  relu: bool = False, moments: bool = False):
    """The kernel's function in plain PyTorch: pad, nine strided tap
    slices concatenated to ``[M, 9*Cin]``, one fp32 product, epilogue,
    cast, moments of the cast values."""
    n, h, wd, ci, co, ho, wo = _check(x, w, stride)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    taps = []
    for t in range(9):
        ty, tx = divmod(t, 3)
        taps.append(xp[:, ty:ty + stride * (ho - 1) + 1:stride,
                       tx:tx + stride * (wo - 1) + 1:stride, :])
    patches = torch.cat(taps, dim=-1).reshape(n * ho * wo, 9 * ci)
    y = patches.float() @ w.to(x.dtype).float().reshape(9 * ci, co)
    if mul is not None:
        y = y * mul.float()
    if add is not None:
        y = y + add.float()
    if relu:
        y = torch.clamp_min(y, 0.0)
    yc = y.to(x.dtype)
    out = yc.reshape(n, ho, wo, co)
    if moments:
        yf = yc.float()
        return out, yf.sum(0), (yf * yf).sum(0)
    return out


def _load():
    global _lib
    if _lib is None:
        from fedml_tpu_torch.ops import build

        lib = build.load("conv_mxu")
        lib.conv3x3_mxu_num_blocks.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.conv3x3_mxu_num_blocks.restype = ctypes.c_int
        lib.conv3x3_mxu_fwd.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        lib.conv3x3_mxu_fwd.restype = ctypes.c_int
        _lib = lib
    return _lib


def _channel_vec(v, co: int, device) -> Optional[torch.Tensor]:
    if v is None:
        return None
    v = torch.as_tensor(v, dtype=torch.float32, device=device).reshape(-1)
    if v.numel() != co:
        raise ValueError(f"epilogue vector needs {co} entries, got {v.numel()}")
    return v.contiguous()


def _conv3x3_cuda(x, w, stride, mul, add, relu, moments):
    n, h, wd, ci, co, ho, wo = _check(x, w, stride)
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"conv3x3_mxu kernel takes fp32/bf16, got {x.dtype}")
    if co not in _KERNEL_COUT:
        raise ValueError(f"conv3x3_mxu kernel takes Cout in {_KERNEL_COUT}, got {co}")
    if not x.is_contiguous():
        raise ValueError("conv3x3_mxu kernel needs a contiguous NHWC input")
    if w.device != x.device:
        raise ValueError(f"weights on {w.device}, input on {x.device}")
    lib = _load()
    w2 = w.to(x.dtype).reshape(9 * ci, co).contiguous()
    mul_t = _channel_vec(mul, co, x.device)
    add_t = _channel_vec(add, co, x.device)
    y = torch.empty((n, ho, wo, co), dtype=x.dtype, device=x.device)
    psum = psq = None
    if moments:
        nb = lib.conv3x3_mxu_num_blocks(n * ho * wo, co)
        psum = torch.empty((nb, co), dtype=torch.float32, device=x.device)
        psq = torch.empty((nb, co), dtype=torch.float32, device=x.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.conv3x3_mxu_fwd(
            ptr(x), ptr(w2), ptr(mul_t), ptr(add_t), ptr(y), ptr(psum),
            ptr(psq), n, h, wd, ci, co, stride, int(relu),
            int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_mxu kernel launch failed: cudaError {err}")
    conv3x3_mxu.launches += 1
    if moments:
        return y, psum.sum(0), psq.sum(0)
    return y


def conv3x3_mxu(x, w, *, stride: int = 1, mul=None, add=None,
                relu: bool = False, moments: bool = False):
    """Raw (non-differentiable) implicit-GEMM 3x3 conv.

    x [N, H, W, Cin] · w [3, 3, Cin, Cout] → out [N, H/s, W/s, Cout] in
    x's dtype, or ``(out, sum, sumsq)`` with ``moments=True``.  A CUDA
    tensor launches the kernel (``conv3x3_mxu.launches`` counts the
    launches); a CPU tensor runs ``conv3x3_plain``."""
    if x.device.type == "cuda":
        return _conv3x3_cuda(x, w, stride, mul, add, relu, moments)
    if x.device.type != "cpu":
        raise ValueError(f"conv3x3_mxu runs on cuda or cpu, got {x.device}")
    return conv3x3_plain(x, w, stride=stride, mul=mul, add=add, relu=relu,
                         moments=moments)


conv3x3_mxu.launches = 0


def _conv_vjp(x, w, stride, dy):
    """dgrad/wgrad of the conv through the library's conv-transpose."""
    wc = w.to(x.dtype).permute(3, 2, 0, 1)
    xn = x.permute(0, 3, 1, 2)
    dyn = dy.to(x.dtype).permute(0, 3, 1, 2)
    dx = torch.nn.grad.conv2d_input(xn.shape, wc, dyn, stride=stride, padding=1)
    dw = torch.nn.grad.conv2d_weight(xn, wc.shape, dyn, stride=stride, padding=1)
    return dx.permute(0, 2, 3, 1), dw.permute(2, 3, 1, 0).to(w.dtype)


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride):
        ctx.stride = stride
        ctx.save_for_backward(x, w)
        return conv3x3_mxu(x, w, stride=stride)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = _conv_vjp(x, w, ctx.stride, dy)
        return dx, dw, None


class _Conv3x3Moments(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride):
        y, s, sq = conv3x3_mxu(x, w, stride=stride, moments=True)
        ctx.stride = stride
        ctx.save_for_backward(x, w, y)
        return y, s, sq

    @staticmethod
    def backward(ctx, dy, ds, dsq):
        x, w, y = ctx.saved_tensors
        # sum_c = Σ_m y[m, c] → dy += ds[c];  sumsq_c = Σ_m y² → dy += 2·y·dsq[c];
        # accumulated in fp32, then cast where the baseline casts its cotangent
        dy_eff = (dy.float() + ds.view(1, 1, 1, -1)
                  + 2.0 * y.float() * dsq.view(1, 1, 1, -1)).to(y.dtype)
        dx, dw = _conv_vjp(x, w, ctx.stride, dy_eff)
        return dx, dw, None


def conv3x3(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Differentiable implicit-GEMM 3x3 conv (kernel forward, library
    dgrad/wgrad backward)."""
    return _Conv3x3.apply(x, w, stride)


def conv3x3_moments(x: torch.Tensor, w: torch.Tensor, stride: int = 1):
    """``conv3x3`` fused with per-channel moments of its emitted output:
    ``(out, sum, sumsq)``, differentiable in all three."""
    return _Conv3x3Moments.apply(x, w, stride)
