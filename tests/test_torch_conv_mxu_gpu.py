"""The hand-written sm_90a conv kernel held against its plain version on
the card.  Needs a CUDA GPU and skips without one; imports no JAX, so it
runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_conv_mxu_gpu.py
"""

import numpy as np
import pytest
import torch

from fedml_tpu_torch.ops.conv_mxu import conv3x3, conv3x3_mxu, conv3x3_plain

# (spatial, Cin, Cout, stride): every 3x3 conv family of ResNet-56
SHAPES = [(32, 3, 16, 1), (32, 16, 16, 1), (32, 32, 32, 2), (16, 32, 32, 1),
          (16, 64, 64, 2), (8, 64, 64, 1)]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the sm_90a kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(hw, ci, co, dtype, device, n=8):
    rng = np.random.RandomState(hw * ci + co)
    x = torch.from_numpy(rng.standard_normal((n, hw, hw, ci)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((3, 3, ci, co)) * 0.2).astype(np.float32))
    return x.to(device, dtype), w.to(device, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hw,ci,co,stride", SHAPES)
def test_kernel_matches_plain_on_card(cuda, hw, ci, co, stride, dtype):
    x, w = _inputs(hw, ci, co, dtype, cuda)
    mul = torch.linspace(0.5, 1.5, co, device=cuda)
    add = torch.linspace(-0.3, 0.3, co, device=cuda)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for kw in ({}, {"mul": mul, "add": add, "relu": True}):
        before = conv3x3_mxu.launches
        y, s, sq = conv3x3_mxu(x, w, stride=stride, moments=True, **kw)
        ry, rs, rsq = conv3x3_plain(x, w, stride=stride, moments=True, **kw)
        torch.cuda.synchronize()
        assert conv3x3_mxu.launches == before + 1
        torch.testing.assert_close(y.float(), ry.float(), rtol=tol, atol=tol)
        scale = ry.float().abs().sum((0, 1, 2))
        assert ((s - rs).abs() / scale.clamp_min(1e-6)).max() < 1e-3
        torch.testing.assert_close(sq, rsq, rtol=1e-3, atol=1e-3)


@pytest.mark.gpu
def test_kernel_backward_matches_library_conv(cuda):
    x, w = _inputs(16, 32, 32, torch.float32, cuda)
    x.requires_grad_(True)
    w.requires_grad_(True)
    conv3x3(x, w, 2).square().sum().backward()
    gx, gw = x.grad.clone(), w.grad.clone()
    x.grad = w.grad = None
    y = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                                   stride=2, padding=1)
    y.square().sum().backward()
    torch.testing.assert_close(gx, x.grad, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(gw, w.grad, rtol=1e-4, atol=1e-3)


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros(2, 8, 8, 16, device=cuda)
    with pytest.raises(ValueError):
        conv3x3_mxu(x, torch.zeros(3, 3, 16, 24, device=cuda))   # Cout 24
    with pytest.raises(TypeError):
        conv3x3_mxu(x.half(), torch.zeros(3, 3, 16, 16, device=cuda))
    with pytest.raises(ValueError):
        conv3x3_mxu(x.transpose(1, 2), torch.zeros(3, 3, 16, 16, device=cuda))
