"""Every DARTS op of ``fedml_tpu_torch/models/darts/`` and the search
network on the card, held against the same calls on the CPU in fp32 (TF32
off): train-mode output, and the gradients of a fixed upstream gradient
with respect to the input, the mixing weights and every parameter, within
1e-4 of each tensor's largest magnitude.  The NHWC activations reach the
pooling and conv kernels as channels-last NCHW views, the layout in which
CUDA's ``avg_pool2d`` backward went wrong.  Needs a CUDA GPU and skips
without one; imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_darts_gpu.py
"""

import pytest
import torch

import chip_smoke
from fedml_tpu_torch.core import rng
from fedml_tpu_torch.models.base import ModelBundle
from fedml_tpu_torch.models.darts import ops, search

CASES = ([(name, stride) for name in ops.PRIMITIVES for stride in (1, 2)]
         + [("mixed", 1), ("mixed", 2), ("factorized_reduce", 2), ("relu_conv_bn", 1)])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: this holds the card's DARTS ops against the CPU's")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _module(name, stride, C):
    if name == "mixed":
        return search.MixedOp(C, stride)
    if name == "factorized_reduce":
        return ops.FactorizedReduce(C, C, affine=False)
    if name == "relu_conv_bn":
        return ops.ReLUConvBN(C, C, 1, 1, affine=False)
    return ops.OPS[name](C, stride, False)


def _forward_backward(module, device, x, extra):
    bundle = ModelBundle(module, tuple(x.shape[1:]), torch.device(device))
    variables = bundle.init(rng.PRNGKey(3))
    params = {k: t.requires_grad_(True) for k, t in variables["params"].items()}
    inputs = [t.to(device).requires_grad_(True) for t in (x, *extra)]
    state = {**params, **variables.get("batch_stats", {})}
    out = torch.func.functional_call(module, state, tuple(inputs),
                                     {"train": True, "updates": {}})
    if not out.requires_grad:  # "none": zeros
        return out.cpu(), []
    upstream = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
    grads = torch.autograd.grad(out, [*inputs, *params.values()], upstream.to(device),
                                allow_unused=True, materialize_grads=True)
    return out.detach().cpu(), [g.cpu() for g in grads]


def _rel(a, b):
    return float((a.double() - b.double()).abs().max() / max(b.abs().max().item(), 1e-30))


@pytest.mark.gpu
@pytest.mark.parametrize("name,stride", CASES, ids=[f"{n}-s{s}" for n, s in CASES])
def test_darts_op_on_the_card_equals_cpu(cuda, name, stride):
    x = torch.randn(8, 16, 16, 8, generator=torch.Generator().manual_seed(0))
    extra = (torch.softmax(torch.randn(8, generator=torch.Generator().manual_seed(2)), 0),
             ) if name == "mixed" else ()
    with chip_smoke.deterministic():
        out_c, grads_c = _forward_backward(_module(name, stride, 8), cuda, x, extra)
        out_h, grads_h = _forward_backward(_module(name, stride, 8), "cpu", x, extra)
    assert _rel(out_c, out_h) <= 1e-4
    assert len(grads_c) == len(grads_h)
    for gc, gh in zip(grads_c, grads_h):
        assert _rel(gc, gh) <= 1e-4
