"""ResNet-56 for CIFAR (He et al. 2016, arXiv:1512.03385 §4.2) in FedML's
Bottleneck form, plain float32 PyTorch.

A 3x3/16 stem, three stages of Bottleneck blocks at 16/32/64 planes
(expansion 4, stride 2 entering stages 2 and 3, on the 3x3 conv and the
1x1 shortcut), global average pool and a dense head.  BatchNorm after
every conv: in training the batch's mean and biased variance, the latter
as ``max(E[x²] − E[x]², 0)`` (flax's BatchNorm; the program's), normalize
(epsilon 1e-5), and the running statistics become ``0.9·old + 0.1·batch``.
Activations are NHWC, conv kernels HWIO, the dense kernel ``[in, out]``;
variables are named by their flax paths (``Bottleneck_3.Conv_1.kernel``,
``BatchNorm_0.mean``), the names the program's ResNet uses, so one dict of
initial variables serves both.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

MOMENTUM = 0.9
EPSILON = 1e-5


def _blocks(layers, widths):
    """(name, in_ch, planes, stride, shortcut) of every Bottleneck."""
    out, in_ch, j = [], widths[0], 0
    for stage, (planes, n) in enumerate(zip(widths, layers)):
        for i in range(n):
            stride = 2 if stage > 0 and i == 0 else 1
            shortcut = in_ch != planes * 4 or stride != 1
            out.append((f"Bottleneck_{j}", in_ch, planes, stride, shortcut))
            in_ch, j = planes * 4, j + 1
    return out, in_ch


def variable_shapes(cfg: dict) -> Dict[str, Dict[str, Tuple[int, ...]]]:
    """``{"params": {name: shape}, "batch_stats": {name: shape}}``."""
    widths, layers = cfg["stage_widths"], cfg["blocks_per_stage"]
    c_in = cfg["image_size"][2]
    params, stats = {}, {}

    def conv(name, k, ci, co):
        params[f"{name}.kernel"] = (k, k, ci, co)

    def bn(name, c):
        params[f"{name}.scale"] = (c,)
        params[f"{name}.bias"] = (c,)
        stats[f"{name}.mean"] = (c,)
        stats[f"{name}.var"] = (c,)

    conv("Conv_0", 3, c_in, widths[0])
    bn("BatchNorm_0", widths[0])
    blocks, final = _blocks(layers, widths)
    for name, ci, planes, _, shortcut in blocks:
        conv(f"{name}.Conv_0", 1, ci, planes)
        bn(f"{name}.BatchNorm_0", planes)
        conv(f"{name}.Conv_1", 3, planes, planes)
        bn(f"{name}.BatchNorm_1", planes)
        conv(f"{name}.Conv_2", 1, planes, planes * 4)
        bn(f"{name}.BatchNorm_2", planes * 4)
        if shortcut:
            conv(f"{name}.Conv_3", 1, ci, planes * 4)
            bn(f"{name}.BatchNorm_3", planes * 4)
    params["Dense_0.kernel"] = (final, cfg["num_classes"])
    params["Dense_0.bias"] = (cfg["num_classes"],)
    return {"params": params, "batch_stats": stats}


def conv3x3_shapes(cfg: dict, batch: int) -> List[Tuple[int, int, int, int, int]]:
    """``(n, hw_in, ci, co, stride)`` of every 3x3 conv of one forward."""
    widths, layers = cfg["stage_widths"], cfg["blocks_per_stage"]
    hw = cfg["image_size"][0]
    out = [(batch, hw, cfg["image_size"][2], widths[0], 1)]
    for _, _, planes, stride, _ in _blocks(layers, widths)[0]:
        out.append((batch, hw, planes, planes, stride))
        hw //= stride
    return out


def forward_flops_per_sample(cfg: dict) -> float:
    """Multiply-add FLOPs (2 per MAC) of the convs and the head for one
    image; BatchNorm, ReLU, the pool and the adds are left out."""
    widths, layers = cfg["stage_widths"], cfg["blocks_per_stage"]
    hw, c_in = cfg["image_size"][0], cfg["image_size"][2]
    macs = hw * hw * 9 * c_in * widths[0]
    blocks, final = _blocks(layers, widths)
    for _, ci, planes, stride, shortcut in blocks:
        ho = hw // stride
        macs += hw * hw * ci * planes            # 1x1 reduce at the input size
        macs += ho * ho * 9 * planes * planes    # 3x3
        macs += ho * ho * planes * planes * 4    # 1x1 expand
        if shortcut:
            macs += ho * ho * ci * planes * 4    # 1x1 shortcut (strided)
        hw = ho
    macs += final * cfg["num_classes"]
    return 2.0 * macs


class ResNet:
    """The model as the reference's FedAvg round drives it:
    ``loss_and_grads(params, stats, x, y, mask)`` for one batch.
    ``rounding`` (the control's) rounds every operand of a conv or product
    and every activation: where the program holds a bf16 tensor."""

    def __init__(self, cfg: dict, rounding=None):
        self.cfg = cfg
        self.blocks = _blocks(cfg["blocks_per_stage"], cfg["stage_widths"])[0]
        self.q = rounding or (lambda t: t)

    def _conv(self, x, w, stride):
        k = w.shape[0]
        return self.q(F.conv2d(self.q(x), self.q(w).permute(3, 2, 0, 1), stride=stride,
                               padding=k // 2))

    def _bn(self, x, p, name, new_stats, old_stats):
        mean = x.mean((0, 2, 3))
        # flax BatchNorm's variance (use_fast_variance), as the program computes it
        var = torch.clamp_min(x.square().mean((0, 2, 3)) - mean.square(), 0.0)
        new_stats[f"{name}.mean"] = MOMENTUM * old_stats[f"{name}.mean"] + (1 - MOMENTUM) * mean.detach()
        new_stats[f"{name}.var"] = MOMENTUM * old_stats[f"{name}.var"] + (1 - MOMENTUM) * var.detach()
        xn = (x - mean[None, :, None, None]) * torch.rsqrt(var + EPSILON)[None, :, None, None]
        return self.q(xn * p[f"{name}.scale"][None, :, None, None]
                      + p[f"{name}.bias"][None, :, None, None])

    def forward_train(self, p, stats, x_nhwc):
        """Logits and the new running statistics."""
        new = {}
        x = x_nhwc.permute(0, 3, 1, 2)
        x = F.relu(self._bn(self._conv(x, p["Conv_0.kernel"], 1), p, "BatchNorm_0", new, stats))
        for name, _, _, stride, shortcut in self.blocks:
            y = F.relu(self._bn(self._conv(x, p[f"{name}.Conv_0.kernel"], 1), p,
                                f"{name}.BatchNorm_0", new, stats))
            y = F.relu(self._bn(self._conv(y, p[f"{name}.Conv_1.kernel"], stride), p,
                                f"{name}.BatchNorm_1", new, stats))
            y = self._bn(self._conv(y, p[f"{name}.Conv_2.kernel"], 1), p,
                         f"{name}.BatchNorm_2", new, stats)
            idt = x
            if shortcut:
                idt = self._bn(self._conv(x, p[f"{name}.Conv_3.kernel"], stride), p,
                               f"{name}.BatchNorm_3", new, stats)
            x = F.relu(self.q(y + idt))
        h = self.q(x.mean((2, 3)))
        logits = self.q(h @ self.q(p["Dense_0.kernel"]) + p["Dense_0.bias"])
        return logits, new

    def loss_and_grads(self, params, stats, x, y, mask):
        """Masked mean cross-entropy over the batch; returns ``(loss_sum,
        count, grads, new_stats)``."""
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        with torch.enable_grad():
            logits, new = self.forward_train(leaves, stats, x)
            nll = F.cross_entropy(logits, y.long(), reduction="none")
            loss_sum = (nll * mask).sum()
            count = mask.sum()
            loss = loss_sum / count.clamp_min(1.0)
            names = list(leaves)
            grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        return loss_sum.detach(), count, dict(zip(names, grads)), new
