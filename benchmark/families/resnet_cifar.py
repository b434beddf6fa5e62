"""The CIFAR ResNet in Bottleneck form: the program's ``resnet56_tpu``
(every 3x3 conv on the hand-written conv kernel) and ``reference/resnet.py``."""

from __future__ import annotations

import numpy as np

from benchmark import counts
from benchmark.reference import resnet as ref

variable_shapes = ref.variable_shapes
COUNT_UNIT = "samples"


def init_rule(name, shape):
    """LeCun normal (std √(1/fan_in)) for conv and dense kernels; BatchNorm
    scales and running variances one, except the scale of each Bottleneck's
    last BatchNorm, zero (Goyal et al. 2017, arXiv:1706.02677 §5.1, the
    large-batch recipe: every residual branch starts as the identity);
    biases and running means zero."""
    leaf = name.rsplit(".", 1)[-1]
    if name.startswith("Bottleneck_") and name.endswith(".BatchNorm_2.scale"):
        return ("zeros",)
    if leaf == "kernel":
        return ("normal", float(1.0 / np.sqrt(np.prod(shape[:-1]))))
    if leaf in ("scale", "var"):
        return ("ones",)
    return ("zeros",)


def program_bundle(cfg, traffic, device):
    from fedml_tpu_torch.models.resnet_tpu import resnet56_tpu

    if tuple(cfg["blocks_per_stage"]) != (6, 6, 6) or tuple(cfg["stage_widths"]) != (16, 32, 64):
        raise ValueError("the program's resnet56_tpu is Bottleneck [6,6,6] at 16/32/64")
    return resnet56_tpu(cfg["num_classes"], cfg["image_size"][0], conv_variant="kernel",
                        device=device)


def reference_model(cfg, traffic, rounding=None):
    return ref.ResNet(cfg, rounding)


def train_flops_per_unit(cfg, traffic) -> float:
    """Model FLOPs of one real sample's step: forward and backward, 3× the forward."""
    return 3.0 * ref.forward_flops_per_sample(cfg)


def kernel_bounds(cfg, traffic):
    """The conv kernel's least time per computed step: every 3x3 conv of a
    forward at the step's batch, with its moments (train mode), in the
    compute type."""
    dtype = cfg["compute_dtype"]
    shapes = ref.conv3x3_shapes(cfg, traffic["batch_size"])
    bound = sum(max(counts.conv_bound_ms(n, hw, ci, co, s, dtype, True, False))
                for n, hw, ci, co, s in shapes)
    return {"conv": {"names": ("conv3x3_tc_kernel", "conv3x3_kernel", "moments_reduce_kernel"),
                     "launch_names": ("conv3x3_tc_kernel", "conv3x3_kernel"),
                     "launches_per_step": len(shapes), "bound_ms_per_step": bound}}
