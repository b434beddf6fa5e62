"""Execution variants of the CIFAR ResNet (port of
``fedml_tpu/models/resnet_tpu.py``).

Every variant computes the same function with the same variable tree as
``models/resnet.CifarResNet`` (Bottleneck form); the baseline's variables
apply to each as they are.

- **The kernel route** (``conv_variant="kernel"``, the default; JAX's
  ``"pallas"``): every 3x3 conv runs through ``ops/conv_mxu.conv3x3`` (the
  implicit-GEMM CUDA kernel), 1x1 convs stay plain matrix products, and in
  train mode the 3x3 conv also emits the per-channel moments of its
  output, so the BatchNorm after it takes its batch statistics from the
  kernel instead of a second pass over the activations.
- **Library convs** (``conv_variant="xla"``, JAX's name): every conv is
  ``F.conv2d`` with JAX's explicit ``k // 2`` padding (at stride 2 the
  windows centre on even rows, unlike ``SAME``).  Two transforms of the
  computation ride on it, as in JAX:

  - **space-to-depth** (``s2d_stages=k``): stages 1..k run on
    half-resolution tensors whose 2x2 pixel blocks are folded into
    channels (``space_to_depth``); each conv's kernel is re-scattered
    inside the forward into its equivalent in that space
    (``s2d_kernel_stride1``, ``s2d_kernel_stride2``,
    ``s2d_kernel_stride2_1x1``), the BatchNorm pools each channel's four
    sub-channels, and the stage transitions consume the folded layout;
  - **lane padding** (``pad_stage1_to=p``): stage 1's 16-wide bottleneck
    convs run at width ``p`` with zero-padded kernels; the padded channels
    stay zero through conv, BatchNorm and ReLU, and the running statistics
    keep the original channels only.

  On the TPU these widen the matrix unit's lanes; here they run no kernel
  of the port (JAX runs them on XLA's convs, outside any Pallas kernel).

The transforms combine with the kernel route in neither package: s2d with
padding, and the kernel route with either, raise ``ValueError``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.base import Dense, ModelBundle, meta_param
from fedml_tpu_torch.ops.conv_mxu import conv3x3, conv3x3_moments
from fedml_tpu_torch.utils.device import DeviceLike, resolve_device

CONV_VARIANTS = ("kernel", "xla")


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) → (B, H/2, W/2, 4C); channel layout (ry, rx, c)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)


def depth_to_space(x: torch.Tensor) -> torch.Tensor:
    b, h, w, c4 = x.shape
    c = c4 // 4
    x = x.reshape(b, h, w, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, 2 * h, 2 * w, c)


def s2d_kernel_stride1(w: torch.Tensor) -> torch.Tensor:
    """Kernel (HWIO) of a stride-1 SAME conv, re-scattered so that
    ``conv(s2d(x), W') == s2d(conv(x, w))``.

    Output pixel (2i+dy, 2j+dx) reads input (2i+dy+t-p, ...); writing
    a = dy+t-p, the source lands in S2D block offset floor(a/2) at sub-row
    a mod 2, so each tap of ``w`` occupies exactly one cell of a
    (4Cin → 4Cout) kernel over S2D blocks.  SAME padding in S2D space
    supplies original rows −2..−1 while the scatter only references row
    −1: the structural zeros keep the extra padded row inert."""
    k = w.shape[0]
    p = k // 2
    ci, co = w.shape[2], w.shape[3]
    bos = sorted({(d + t - p) // 2 for d in range(2) for t in range(k)})
    nk = bos[-1] - bos[0] + 1
    out = w.new_zeros((nk, nk, 4 * ci, 4 * co))
    for dy in range(2):
        for ty in range(k):
            ay = dy + ty - p
            by, ry = ay // 2 - bos[0], ay % 2
            for dx in range(2):
                for tx in range(k):
                    ax = dx + tx - p
                    bx, rx = ax // 2 - bos[0], ax % 2
                    out[by, bx, (ry * 2 + rx) * ci:(ry * 2 + rx + 1) * ci,
                        (dy * 2 + dx) * co:(dy * 2 + dx + 1) * co] = w[ty, tx]
    return out


def s2d_kernel_stride2(w: torch.Tensor) -> torch.Tensor:
    """Stride-2 3x3 conv consuming an S2D input and emitting the
    normal-space half-resolution output: out[i] reads original rows
    2i−1..2i+1 = S2D blocks {i−1 (sub-row 1), i (sub-rows 0, 1)}, a 2x2
    kernel over S2D blocks, stride 1, pad (1, 0) in each spatial dim."""
    ci, co = w.shape[2], w.shape[3]
    out = w.new_zeros((2, 2, 4 * ci, co))
    for ty in range(3):
        ay = ty - 1
        by, ry = ay // 2 + 1, ay % 2
        for tx in range(3):
            ax = tx - 1
            bx, rx = ax // 2 + 1, ax % 2
            out[by, bx, (ry * 2 + rx) * ci:(ry * 2 + rx + 1) * ci, :] = w[ty, tx]
    return out


def s2d_kernel_stride2_1x1(w: torch.Tensor) -> torch.Tensor:
    """Stride-2 1x1 conv on an S2D input: out[i] = w·in[2i], the (0, 0)
    sub-position, i.e. the first Cin channel block."""
    ci, co = w.shape[2], w.shape[3]
    out = w.new_zeros((1, 1, 4 * ci, co))
    out[0, 0, :ci, :] = w[0, 0]
    return out


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int, pad: int) -> torch.Tensor:
    """NHWC ``x`` by HWIO ``w`` through ``F.conv2d``, ``pad`` on every side."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


class _XConv(nn.Module):
    """Conv whose parameter keeps the baseline shape (``kernel`` HWIO)
    while the compute runs in a transformed space: ``in_space`` /
    ``out_space`` in {"n", "s"} (normal / space-to-depth); ``pad_to``
    zero-pads the compute width, and ``pad_in`` says how many trailing
    input channels are structural zeros.

    ``conv_variant="kernel"``: a 3x3 runs on the kernel (with
    ``moments=True`` it returns ``(y, (sum, sumsq, count))`` for the
    moment-fed BatchNorm), a 1x1 is a matrix product (padding 0, so
    stride 2 reads every other pixel).  ``"xla"``: ``F.conv2d``."""

    def __init__(self, features: int, in_features: int, kernel: int,
                 stride: int = 1, in_space: str = "n", out_space: str = "n",
                 pad_to: int = 0, pad_in: int = 0, conv_variant: str = "kernel"):
        super().__init__()
        if conv_variant == "kernel" and ((in_space, out_space) != ("n", "n")
                                         or pad_to or pad_in):
            raise ValueError("conv_variant='kernel' composes with neither s2d spaces nor "
                             "lane padding (the kernel runs normal-space NHWC)")
        self.stride, self.features = stride, features
        self.in_space, self.out_space = in_space, out_space
        self.pad_to, self.pad_in = pad_to, pad_in
        self.conv_variant = conv_variant
        self.kernel = meta_param(kernel, kernel, in_features, features)

    def forward(self, x, moments: bool = False):
        w = self.kernel.to(x.dtype)
        k, s = w.shape[0], self.stride
        if self.conv_variant == "kernel":
            if k == 3:
                if moments:
                    y, total, sq = conv3x3_moments(x, w, s)
                    count = float(x.shape[0] * (x.shape[1] // s) * (x.shape[2] // s))
                    return y, (total, sq, count)
                return conv3x3(x, w, s)
            return torch.matmul(x[:, ::s, ::s, :], w[0, 0])
        if self.pad_to or self.pad_in:
            w = F.pad(w, (0, (self.pad_to - self.features) if self.pad_to else 0,
                          0, self.pad_in))
        if self.in_space == "n":
            return _conv(x, w, s, k // 2)
        if s == 1:
            wp = s2d_kernel_stride1(w)
            return _conv(x, wp, 1, wp.shape[0] // 2)  # SAME; stays in s2d space
        # stride-2 transition: consumes s2d, emits normal space
        if k == 1:
            y = _conv(x, s2d_kernel_stride2_1x1(w), 1, 0)
        else:
            y = _conv(F.pad(x, (0, 0, 1, 0, 1, 0)), s2d_kernel_stride2(w), 1, 0)
        return space_to_depth(y) if self.out_space == "s" else y


class _XBatchNorm(nn.Module):
    """BatchNorm with the baseline's parameters and statistics (per
    original channel), in the JAX ``_XBatchNorm`` form: fast variance
    ``max(E[x²]−E[x]², 0)`` in float32 (from the kernel's moments when
    given: ``mean = sum/count``), running stats ``0.9·ra + 0.1·batch``
    with the biased variance, and the affine ``x*mul + add`` applied in
    ``x.dtype``.  In S2D space each channel's four sub-channels pool into
    its statistics; with lane padding the trailing channels are structural
    zeros, left out of the statistics and given a zero affine."""

    momentum = 0.9
    epsilon = 1e-5

    def __init__(self, c: int, space: str = "n", pad_to: int = 0):
        super().__init__()
        self.space, self.pad_to = space, pad_to
        self.scale = meta_param(c)
        self.bias = meta_param(c)
        self.register_buffer("mean", torch.empty(c, device="meta"))
        self.register_buffer("var", torch.empty(c, device="meta"))

    def forward(self, x, train: bool, updates: dict, moments=None):
        c = self.scale.shape[0]
        if moments is not None and (self.space != "n" or self.pad_to):
            raise ValueError("pre-reduced moments need normal space and no lane padding")
        if train:
            if moments is not None:
                s, sq, count = moments
                mean, mean2 = s / count, sq / count
            elif self.space == "s":
                xr = x.reshape(*x.shape[:3], 4, c).float()
                mean = xr.mean((0, 1, 2, 3))
                mean2 = xr.square().mean((0, 1, 2, 3))
            else:
                xf = x.float()
                mean = xf.mean((0, 1, 2))
                mean2 = xf.square().mean((0, 1, 2))
                if self.pad_to:
                    mean, mean2 = mean[:c], mean2[:c]
            var = torch.clamp_min(mean2 - mean.square(), 0.0)
            m = self.momentum
            updates[self.state_prefix + "mean"] = m * self.mean + (1 - m) * mean
            updates[self.state_prefix + "var"] = m * self.var + (1 - m) * var
        else:
            mean, var = self.mean, self.var
        mul = self.scale * torch.rsqrt(var + self.epsilon)
        add = self.bias - mean * mul
        if self.space == "s":
            mul, add = mul.repeat(4), add.repeat(4)
        elif self.pad_to:
            mul, add = F.pad(mul, (0, self.pad_to - c)), F.pad(add, (0, self.pad_to - c))
        return x * mul.to(x.dtype) + add.to(x.dtype)


class BottleneckTPU(nn.Module):
    """Bottleneck with per-block spaces and padding; names and shapes
    mirror ``resnet.Bottleneck`` exactly (Conv_0/BN_0 reduce, Conv_1/BN_1
    3x3, Conv_2/BN_2 expand, Conv_3/BN_3 shortcut when shapes change)."""

    expansion = 4

    def __init__(self, in_ch: int, planes: int, stride: int = 1, in_space: str = "n",
                 out_space: str = "n", pad_to: int = 0, pad_in: int = 0,
                 conv_variant: str = "kernel"):
        super().__init__()
        out_ch = planes * self.expansion
        mid = in_space  # the 1x1 reduce keeps the input space
        post = mid if stride == 1 else out_space
        zeros = pad_to - planes if pad_to else 0
        self.moments = conv_variant == "kernel"
        self.Conv_0 = _XConv(planes, in_ch, 1, 1, in_space, mid, pad_to=pad_to,
                             pad_in=pad_in, conv_variant=conv_variant)
        self.BatchNorm_0 = _XBatchNorm(planes, mid, pad_to)
        self.Conv_1 = _XConv(planes, planes, 3, stride, mid, out_space, pad_to=pad_to,
                             pad_in=zeros, conv_variant=conv_variant)
        self.BatchNorm_1 = _XBatchNorm(planes, post, pad_to)
        self.Conv_2 = _XConv(out_ch, planes, 1, 1, post, post, pad_in=zeros,
                             conv_variant=conv_variant)
        self.BatchNorm_2 = _XBatchNorm(out_ch, post)
        self.shortcut = in_ch != out_ch or stride != 1
        if self.shortcut:
            self.Conv_3 = _XConv(out_ch, in_ch, 1, stride, in_space, out_space,
                                 pad_in=pad_in, conv_variant=conv_variant)
            self.BatchNorm_3 = _XBatchNorm(out_ch, in_space if stride == 1 else out_space)

    def forward(self, x, train: bool, updates: dict):
        y = torch.relu(self.BatchNorm_0(self.Conv_0(x), train, updates))
        # the 3x3 is the kernel's; in train mode it also emits the
        # moments the next BatchNorm consumes
        fuse = self.moments and train
        y = self.Conv_1(y, moments=fuse)
        y, mom = y if fuse else (y, None)
        y = torch.relu(self.BatchNorm_1(y, train, updates, moments=mom))
        y = self.BatchNorm_2(self.Conv_2(y), train, updates)
        identity = x
        if self.shortcut:
            identity = self.BatchNorm_3(self.Conv_3(x), train, updates)
        return torch.relu(y + identity)


class CifarResNetTPU(nn.Module):
    """Execution variant of ``resnet.CifarResNet`` (Bottleneck form):
    identical variable tree, identical function; stages 1..``s2d_stages``
    run in space-to-depth layout and/or stage 1 runs lane-padded to
    ``pad_stage1_to`` (library convs only)."""

    def __init__(self, layers: Sequence[int], num_classes: int = 10,
                 s2d_stages: int = 0, pad_stage1_to: int = 0,
                 conv_variant: str = "kernel"):
        super().__init__()
        if conv_variant not in CONV_VARIANTS:
            raise ValueError(f"conv_variant must be one of {CONV_VARIANTS}, got "
                             f"{conv_variant!r} (the library-conv baseline is "
                             "models.resnet.CifarResNet)")
        if s2d_stages and pad_stage1_to:
            # in s2d space stage 1 already computes 64-wide
            raise ValueError("s2d_stages and pad_stage1_to are exclusive")
        if conv_variant == "kernel" and (s2d_stages or pad_stage1_to):
            raise ValueError("conv_variant='kernel' excludes s2d_stages/pad_stage1_to "
                             "(the kernel runs normal-space NHWC)")
        self.s2d = s2d_stages
        self.moments = conv_variant == "kernel"
        spaces = ["s" if s < s2d_stages else "n" for s in range(3)]
        self.pool_s2d = spaces[2] == "s"
        self.Conv_0 = _XConv(16, 3, 3, 1, spaces[0], spaces[0], conv_variant=conv_variant)
        self.BatchNorm_0 = _XBatchNorm(16, spaces[0])
        self.blocks = []
        in_ch, j = 16, 0
        for stage, (planes, n_blocks) in enumerate(zip((16, 32, 64), layers)):
            pad = pad_stage1_to if stage == 0 else 0
            for i in range(n_blocks):
                first = stage > 0 and i == 0
                name = f"Bottleneck_{j}"
                self.add_module(name, BottleneckTPU(
                    in_ch, planes, 2 if first else 1,
                    in_space=spaces[stage - 1] if first else spaces[stage],
                    out_space=spaces[stage], pad_to=pad, conv_variant=conv_variant))
                self.blocks.append(name)
                in_ch, j = planes * 4, j + 1
        self.Dense_0 = Dense(in_ch, num_classes)

    def forward(self, x, train: bool = False, updates: Optional[dict] = None):
        updates = {} if updates is None else updates
        if self.s2d:
            x = space_to_depth(x)
        fuse = self.moments and train
        x = self.Conv_0(x, moments=fuse)
        x, mom = x if fuse else (x, None)
        x = torch.relu(self.BatchNorm_0(x, train, updates, moments=mom))
        for name in self.blocks:
            x = getattr(self, name)(x, train, updates)
        if self.pool_s2d:
            b, h, w, c4 = x.shape
            x = x.reshape(b, h, w, 4, c4 // 4).mean((1, 2, 3))
        else:
            x = x.mean((1, 2))
        return self.Dense_0(x)


def resnet56_tpu(num_classes: int = 10, image_size: int = 32,
                 s2d_stages: int = 0, pad_stage1_to: int = 0,
                 conv_variant: str = "kernel",
                 device: DeviceLike = None) -> ModelBundle:
    """ResNet-56 (Bottleneck [6,6,6]) in one of its execution variants: by
    default all 19 of its 3x3 convs on the implicit-GEMM kernel with
    moment-fed train-mode BatchNorm; ``conv_variant="xla"`` on library
    convs, optionally space-to-depth through ``s2d_stages`` stages or with
    stage 1 lane-padded to ``pad_stage1_to``."""
    return ModelBundle(
        module=CifarResNetTPU((6, 6, 6), num_classes, s2d_stages,
                              pad_stage1_to, conv_variant),
        input_shape=(image_size, image_size, 3),
        device=resolve_device(device),
    )
