"""SplitNN's CNN halves (``models/cnn.py::cnn_split_pair``) at full width
(CIFAR-10's 32×32×3 images, 32/64 channels, a 512-wide dense layer, batch
64) on the card, layer by layer, held against the same calls on the CPU in
fp32 (TF32 off): each layer gets the same input on both sides (the CPU's
output of the layer before) and the same upstream gradient, and its
output and the gradients of its input and parameters agree within 1e-4
of each tensor's largest magnitude.  The 5×5 convs and ``max_pool_2x2``
run on permuted NHWC views, as in the ring.

Layer by layer, because the two halves run whole differ by more: a max
pool whose window holds two values within fp32's rounding of each other,
or a ReLU input that close to zero, routes the gradient by the last bit
of its input, so one flipped choice moves a conv's weight gradient far
past 1e-4, on the CPU's fp32 against float64 as on the card.  Needs a CUDA GPU and skips without one; imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_splitnn_gpu.py
"""

import numpy as np
import pytest
import torch

import chip_smoke
from fedml_tpu_torch.core import rng
from fedml_tpu_torch.models.cnn import cnn_split_pair, max_pool_2x2

RTOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: this holds the card's SplitNN halves against the CPU's")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _layers():
    """([(name, module or None, fn(module_params, x))] in the halves'
    order, every parameter of both halves by its flat name)."""
    bottom, top = cnn_split_pair(10, (32, 32, 3), device="cpu")
    b, t = bottom.module, top.module

    def call(module, pre=lambda x: x):
        return lambda p, x: torch.func.functional_call(module, p, (pre(x),))

    return ([("Conv_0", b.Conv_0, call(b.Conv_0)),
             ("relu_pool_0", None, lambda p, x: max_pool_2x2(torch.relu(x))),
             ("Conv_1", b.Conv_1, call(b.Conv_1)),
             ("relu_pool_1_flatten", None,
              lambda p, x: max_pool_2x2(torch.relu(x)).reshape(x.shape[0], -1)),
             ("Dense_0", t.Dense_0, call(t.Dense_0)),
             ("Dense_1", t.Dense_1, call(t.Dense_1, torch.relu))],
            {**bottom.init(rng.PRNGKey(1))["params"], **top.init(rng.PRNGKey(0))["params"]})


def _run(fn, params, x, upstream, device):
    p = {k: v.to(device).requires_grad_(True) for k, v in params.items()}
    xi = x.to(device).requires_grad_(True)
    out = fn(p, xi)
    grads = torch.autograd.grad(out, [xi, *p.values()], upstream.to(device))
    return [t.detach().cpu() for t in (out, *grads)]


def _rel(a, b):
    return float((a.double() - b.double()).abs().max() / max(b.abs().max().item(), 1e-30))


@pytest.mark.gpu
@pytest.mark.parametrize("pinned", [True, False], ids=["deterministic", "default"])
def test_split_layers_on_the_card_equal_cpu(cuda, pinned):
    layers, params = _layers()
    r = np.random.RandomState(0)
    x = torch.from_numpy(r.normal(0.5, 0.25, (64, 32, 32, 3)).astype(np.float32))
    for name, module, fn in layers:
        own = ({k: params[f"{name}.{k}"] for k, _ in module.named_parameters()}
               if module is not None else {})
        with torch.no_grad():
            out_shape = fn(own, x).shape
        upstream = torch.from_numpy(r.normal(0, 1, tuple(out_shape)).astype(np.float32))
        host = _run(fn, own, x, upstream, "cpu")
        if pinned:
            with chip_smoke.deterministic():
                card = _run(fn, own, x, upstream, cuda)
        else:
            card = _run(fn, own, x, upstream, cuda)
        for what, c, h in zip(["output", "input grad", *own], card, host):
            assert _rel(c, h) <= RTOL, f"{name} {what}: {_rel(c, h):.3g}"
        x = host[0]
