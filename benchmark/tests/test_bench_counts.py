"""Each count of the yardstick against a hand count at one shape."""

import pytest

from benchmark import counts
from benchmark.reference import resnet, transformer

RESNET56 = {"image_size": [32, 32, 3], "num_classes": 10, "stage_widths": [16, 32, 64],
            "blocks_per_stage": [6, 6, 6]}
GPT2L = {"n_embd": 1280, "n_head": 20, "n_layer": 36, "vocab_size": 50257, "n_positions": 1024}


def test_conv_bound_hand_count():
    # n 2, 8x8, 16 -> 32 channels, stride 2, bf16, with moments
    nbytes = (2 * 64 * 16 + 9 * 16 * 32 + 2 * 16 * 32) * 2 + 2 * 32 * 4
    flops = 2 * 2 * 16 * 9 * 16 * 32
    b, f = counts.conv_bound_ms(2, 8, 16, 32, 2, "bf16", True, False)
    assert b == pytest.approx(1e3 * nbytes / 3.35e12)
    assert f == pytest.approx(1e3 * flops / 989e12)


def test_flash_bound_hand_count():
    # b 1, L 4, h 2, d 8, causal: 10 visible pairs per head
    nbytes = (2 * 4 * 2 * 8 + 2 * 4 * 2 * 8) * 2 + 2 * 4 * 4
    flops = 4 * 2 * 8 * 10
    b, f = counts.flash_bound_ms(1, 4, 4, 2, 8, "bf16", True)
    assert b == pytest.approx(1e3 * nbytes / 3.35e12)
    assert f == pytest.approx(1e3 * flops / 989e12)


def test_resnet56_flops_hand_count():
    macs = 32 * 32 * 27 * 16                                   # stem
    # stage 1 at 32x32: the first block reduces 16 -> 16, the others 64 -> 16
    macs += 1024 * (16 * 16 + 9 * 16 * 16 + 16 * 64 + 16 * 64)
    macs += 5 * 1024 * (64 * 16 + 9 * 16 * 16 + 16 * 64)
    # stage 2: the first block reduces at 32x32, the rest at 16x16
    macs += 1024 * 64 * 32 + 256 * (9 * 32 * 32 + 32 * 128 + 64 * 128)
    macs += 5 * 256 * (128 * 32 + 9 * 32 * 32 + 32 * 128)
    macs += 256 * 128 * 64 + 64 * (9 * 64 * 64 + 64 * 256 + 128 * 256)
    macs += 5 * 64 * (256 * 64 + 9 * 64 * 64 + 64 * 256)
    macs += 256 * 10
    assert resnet.forward_flops_per_sample(RESNET56) == 2 * macs


def test_resnet56_conv_shapes():
    shapes = resnet.conv3x3_shapes(RESNET56, 4)
    assert len(shapes) == 19
    assert shapes[0] == (4, 32, 3, 16, 1)
    assert shapes[7] == (4, 32, 32, 32, 2) and shapes[8] == (4, 16, 32, 32, 1)
    assert shapes[13] == (4, 16, 64, 64, 2) and shapes[18] == (4, 8, 64, 64, 1)


def test_gpt2_large_flops_hand_count():
    d, L = 1280, 1024
    per_layer = 2 * (3 * d * d + d * d + 4 * d * d + 4 * d * d) + 2 * 2 * L * d
    assert transformer.forward_flops_per_token(GPT2L, L) == 36 * per_layer + 2 * d * 50257
    # GPT-2 Large's 774M parameters: wte, wpe, and per layer 12 d^2 + 5d (MLP
    # bias) + 4d (two LayerNorms) + 2d (final LayerNorm)
    shapes = transformer.variable_shapes(GPT2L)["params"]
    n = sum(int(__import__("numpy").prod(s)) for s in shapes.values())
    assert n == 50257 * d + 1024 * d + 36 * (12 * d * d + 5 * d + 4 * d) + 2 * d
