"""The port's transformer LM (``fedml_tpu_torch/models/transformer.py``)
held against the JAX package's ``TransformerLM`` with the same flax
variables on the same numpy tokens.

Setup: vocab 40, width 32, 2 heads (D 16), 2 layers, L 32, batch 3.  In
fp32 the JAX model runs its CPU default (blockwise attention) and the port
its plain attention: eval logits at rtol/atol 3e-4 (the JAX package's
flash-vs-default tolerance; measured max abs difference 2.1e-6), train
loss at 1e-5 (measured 4.8e-7), gradients at 1e-4 (measured 1.3e-7).
In bf16 the JAX model uses ``flash_attn_fn(interpret=True)``, whose
arithmetic (fp32 scores, p cast to bf16 before P·V) is the kernel's:
logits at 5e-2 (measured 0.031 on logits up to 3, one bf16 ulp there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.core.losses import masked_softmax_ce as jmasked_ce
from fedml_tpu.models.transformer import TransformerLM as JTransformerLM
from fedml_tpu.ops.flash_attention import flash_attn_fn as jflash_attn_fn
from fedml_tpu_torch.core.losses import masked_softmax_ce
from fedml_tpu_torch.core.rng import PRNGKey
from fedml_tpu_torch.core.tree import tree_cast_floats
from fedml_tpu_torch.models.convert import from_jax_variables, to_jax_variables
from fedml_tpu_torch.models.transformer import transformer_lm

V, E, H, NL, L, B = 40, 32, 2, 2, 32, 3


def _jmodel(attn_fn=None):
    return JTransformerLM(vocab_size=V, embed_dim=E, num_heads=H, num_layers=NL,
                          max_len=L, attn_fn=attn_fn)


def _bundle(remat=False):
    return transformer_lm(vocab_size=V, embed_dim=E, num_heads=H, num_layers=NL,
                          seq_len=L, remat=remat, device="cpu")


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(0)
    x = rng.randint(0, V, (B, L)).astype(np.int32)
    y = np.roll(x, -1, axis=-1)
    mask = np.array([1.0, 1.0, 0.0], np.float32)  # the last row is padding
    jvars = _jmodel().init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x))
    jvars = jax.tree_util.tree_map(np.asarray, jvars)
    return {"x": x, "y": y, "mask": mask, "jvars": jvars}


def test_converter_maps_the_flax_tree_leaf_for_leaf(setup):
    tv = from_jax_variables(setup["jvars"], device="cpu")
    fresh = _bundle().init(PRNGKey(0))
    assert set(tv) == {"params"}
    assert {k: tuple(t.shape) for k, t in tv["params"].items()} == {
        k: tuple(t.shape) for k, t in fresh["params"].items()}
    for name in ("wte.embedding", "wpe.embedding", "Block_0.LayerNorm_0.scale",
                 "Block_0.MultiHeadAttention_0.Dense_0.kernel",
                 "Block_0.MultiHeadAttention_0.Dense_1.kernel",
                 "Block_1.Dense_1.bias", "ln_f.bias"):
        assert name in tv["params"], name
    back = to_jax_variables(tv)
    flat_back = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_j = dict(jax.tree_util.tree_flatten_with_path(setup["jvars"])[0])
    assert len(flat_back) == len(flat_j)
    for path, leaf in flat_back:
        assert np.array_equal(leaf, flat_j[path]), path


def test_eval_logits_match_jax(setup):
    want = np.asarray(_jmodel().apply(setup["jvars"], jnp.asarray(setup["x"])))
    bundle = _bundle()
    got = bundle.apply_eval(from_jax_variables(setup["jvars"], device="cpu"),
                            torch.from_numpy(setup["x"]))
    assert got.shape == (B, L, V)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=3e-4, atol=3e-4)


def _torch_loss_and_grads(bundle, variables, x, y, mask):
    params = {k: t.clone().requires_grad_(True) for k, t in variables["params"].items()}
    logits, _ = bundle.apply_train({"params": params}, torch.from_numpy(x))
    loss, _ = masked_softmax_ce(logits, torch.from_numpy(y), torch.from_numpy(mask))
    grads = torch.autograd.grad(loss, list(params.values()))
    return logits, loss, dict(zip(params, grads))


def test_train_loss_and_grads_match_jax(setup):
    x, y, mask = setup["x"], setup["y"], setup["mask"]
    model = _jmodel()

    def jloss(params):
        logits = model.apply({"params": params}, jnp.asarray(x), train=True)
        return jmasked_ce(logits, jnp.asarray(y), jnp.asarray(mask))[0]

    jl, jg = jax.value_and_grad(jloss)(setup["jvars"]["params"])
    _, loss, grads = _torch_loss_and_grads(
        _bundle(), from_jax_variables(setup["jvars"], device="cpu"), x, y, mask)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5, atol=1e-5)
    flat = to_jax_variables({"params": grads})["params"]
    for path, leaf in jax.tree_util.tree_flatten_with_path(flat)[0]:
        ref = dict(jax.tree_util.tree_flatten_with_path(jg)[0])[path]
        np.testing.assert_allclose(leaf, np.asarray(ref), rtol=1e-4, atol=1e-4,
                                   err_msg=str(path))


def test_remat_is_the_same_function(setup):
    x, y, mask = setup["x"], setup["y"], setup["mask"]
    variables = from_jax_variables(setup["jvars"], device="cpu")
    plain = _torch_loss_and_grads(_bundle(), variables, x, y, mask)
    remat = _torch_loss_and_grads(_bundle(remat=True), variables, x, y, mask)
    torch.testing.assert_close(remat[0], plain[0], rtol=0, atol=0)
    for k in plain[2]:
        torch.testing.assert_close(remat[2][k], plain[2][k], rtol=1e-6, atol=1e-7)


def test_bf16_matches_the_jax_flash_model(setup):
    jvars16 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                     setup["jvars"])
    model = _jmodel(jflash_attn_fn(block_q=L, block_k=L, interpret=True))
    want = model.apply(jvars16, jnp.asarray(setup["x"])).astype(jnp.float32)
    tv = tree_cast_floats(from_jax_variables(setup["jvars"], device="cpu"),
                          torch.bfloat16)
    got = _bundle().apply_eval(tv, torch.from_numpy(setup["x"]))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=5e-2, atol=5e-2)


def test_sequence_longer_than_max_len_raises():
    bundle = _bundle()
    variables = bundle.init(PRNGKey(0))
    with pytest.raises(ValueError, match="max_len"):
        bundle.apply_eval(variables, torch.zeros(1, L + 1, dtype=torch.int32))


def test_embedding_init_is_flax_default_embed_init():
    """An untruncated normal with std 1/sqrt(E) (variance_scaling 1.0,
    fan_in, out_axis 0), within 5%, as flax draws it."""
    bundle = transformer_lm(vocab_size=512, embed_dim=64, num_heads=4,
                            num_layers=1, seq_len=256, device="cpu")
    params = bundle.init(PRNGKey(1))["params"]
    for name in ("wte.embedding", "wpe.embedding"):
        t = params[name]
        assert abs(float(t.std()) * np.sqrt(64) - 1.0) < 0.05, name
        assert abs(float(t.mean())) < 0.01
        assert float(t.abs().max()) > 3.0 / np.sqrt(64)  # not truncated at 2 std
    jemb = _jmodel().init({"params": jax.random.PRNGKey(2)},
                          jnp.zeros((1, L), jnp.int32))["params"]["wte"]["embedding"]
    assert abs(float(jnp.std(jemb)) * np.sqrt(E) - 1.0) < 0.05
