"""The codec stage, the seeded init and the cohort draw on the card, held
bit for bit against the same calls on the CPU (which
``tests/test_torch_compress.py``, ``test_torch_init.py`` and
``test_torch_fedavg_streams.py`` hold against jax).  Needs a CUDA GPU and
skips without one; imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_compress_gpu.py
"""

import numpy as np
import pytest
import torch

from fedml_tpu_torch import compress
from fedml_tpu_torch.core import rng
from fedml_tpu_torch.core.sampling import eligible_participation_mask
from fedml_tpu_torch.models.resnet_tpu import resnet56_tpu
from fedml_tpu_torch.models.transformer import transformer_lm


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: this holds the card's results against the CPU's")
    return torch.device("cuda")


def _delta(device):
    """A ResNet-56-shaped random update (drawn on the CPU)."""
    like = resnet56_tpu(device="cpu").init(rng.PRNGKey(0))
    g = torch.Generator().manual_seed(0)
    return {c: {k: (torch.randn(v.shape, generator=g) * 1e-3).to(device)
                for k, v in col.items()} for c, col in like.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["int8", "int4", "topk0.01", "bf16"])
def test_card_roundtrip_equals_cpu(cuda, name):
    codec, key = compress.get_codec(name), rng.PRNGKey(5)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        tree = _delta(dev)
        layout = compress.FlatLayout(tree, dev)
        outs.append(compress.roundtrip_flat(codec, layout.flatten(tree), key, layout).cpu())
    assert torch.equal(outs[0], outs[1])


@pytest.mark.gpu
def test_card_qsgd8_payload_equals_cpu(cuda):
    codec, key = compress.get_codec("int8"), rng.PRNGKey(6)
    card = compress.wire_encode_tree(codec, _delta(cuda), key)
    host = compress.wire_encode_tree(codec, _delta("cpu"), key)
    assert compress.wire_tree_digest({"leaves": card}) == \
        compress.wire_tree_digest({"leaves": host})


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["resnet56_tpu", "transformer"])
def test_card_init_equals_cpu(cuda, model):
    def make(dev):
        if model == "resnet56_tpu":
            return resnet56_tpu(device=dev)
        return transformer_lm(vocab_size=512, embed_dim=128, num_heads=4,
                              num_layers=2, seq_len=64, device=dev)
    card, host = make(cuda).init(rng.PRNGKey(3)), make("cpu").init(rng.PRNGKey(3))
    for col in host:
        for k, v in host[col].items():
            assert torch.equal(card[col][k].cpu(), v), k


@pytest.mark.gpu
@pytest.mark.parametrize("draw", ["normal", "truncated_normal"])
def test_card_normal_draws_equal_cpu(cuda, draw):
    for seed in (0, 1, 12345):
        args = (rng.PRNGKey(seed),) + ((-2.0, 2.0) if draw == "truncated_normal" else ())
        fn = getattr(rng, draw)
        assert torch.equal(fn(*args, (1 << 20,), cuda).cpu(), fn(*args, (1 << 20,)))


@pytest.mark.gpu
@pytest.mark.parametrize("round_idx", [2273, 5032])
def test_card_cohort_ties_equal_cpu(cuda, round_idx):
    part = torch.ones(4096)
    host = eligible_participation_mask(rng.PRNGKey(0), round_idx, part, 2048)
    card = eligible_participation_mask(rng.PRNGKey(0), round_idx, part.to(cuda), 2048)
    assert torch.equal(card.cpu(), host)
