"""The port's zoo models (``fedml_tpu_torch/models/{cnn,linear,resnet_gn,
rnn}.py``) held against the JAX package's flax modules at full width, on
the same numpy inputs:

- ``ModelBundle.init(PRNGKey(s))`` equals flax's ``init`` bit for bit (no
  ulp bound), the orthogonal LSTM kernels and the 10004×96 NWP embedding
  included;
- eval logits within 1e-5, train logits under a given dropout key within
  1e-5, and the gradients of the masked loss within 1e-4, each relative
  to max(1, the largest reference magnitude);
- one ``make_local_update`` (shuffled, SGD) and one ``make_round_fn``
  round of 2 clients x 2 steps (padded slots, shuffled)
  against the JAX engine's within 1e-4.

``resnet18_gn`` is held to flax's init and eval logits; its gradient and
round run on a one-block-per-stage ``ResNetGN`` of the same width on 8x8
images, for time (the Bottleneck blocks and the ImageNet stem: eval
logits on 16x16).  The one-block models start from flax's jitted init,
which equals the eager one for these layers (``resnet18_gn`` is held to
the eager one).  Dropout masks are flax's bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu.algorithms.fedavg as jfedavg
import fedml_tpu.core.client as jclient
import fedml_tpu.models.cnn as jcnn
import fedml_tpu.models.linear as jlinear
import fedml_tpu.models.resnet_gn as jresnet_gn
import fedml_tpu.models.rnn as jrnn
from fedml_tpu.models.base import ModelBundle as JBundle
from fedml_tpu_torch.algorithms.fedavg import ServerState, make_round_fn
from fedml_tpu_torch.core import rng as rnglib
from fedml_tpu_torch.core.client import make_client_optimizer, make_local_update
from fedml_tpu_torch.core.losses import masked_softmax_ce
from fedml_tpu_torch.models import cnn, linear, resnet_gn, rnn
from fedml_tpu_torch.models.base import Dropout, ModelBundle, name_state_owners
from fedml_tpu_torch.models.convert import from_jax_variables, to_jax_variables

CPU = torch.device("cpu")
LOGIT_TOL = 1e-5
GRAD_TOL = 1e-4
ROUND_TOL = 1e-4


def _gn_one_block(bottleneck=False, small_input=True, side=8):
    def make(lib):
        block = lib.BottleneckGN if bottleneck else lib.BasicBlockGN
        if lib is jresnet_gn:
            return JBundle(module=lib.ResNetGN(block=block, layers=(1, 1, 1, 1),
                                               small_input=small_input),
                           input_shape=(side, side, 3))
        return ModelBundle(lib.ResNetGN(block, (1, 1, 1, 1), 100, small_input),
                           (side, side, 3), CPU)
    return make


# name: (jax factory, port factory, classes, sequence output, lr)
MODELS = {
    "cnn_original_fedavg": (lambda: jcnn.cnn_original_fedavg(),
                            lambda: cnn.cnn_original_fedavg(device=CPU), 10, False, 0.05),
    "cnn_dropout": (lambda: jcnn.cnn_dropout(), lambda: cnn.cnn_dropout(device=CPU),
                    62, False, 0.05),
    "mlp2": (lambda: jlinear.mlp2(784), lambda: linear.mlp2(784, device=CPU), 10, False, 0.05),
    "resnet18_gn": (lambda: jresnet_gn.resnet18_gn(image_size=24),
                    lambda: resnet_gn.resnet18_gn(image_size=24, device=CPU),
                    100, False, 0.05),
    "resnet_gn_1111": (lambda: _gn_one_block()(jresnet_gn), lambda: _gn_one_block()(resnet_gn),
                       100, False, 0.05),
    "resnet_gn_bottleneck_imagenet_stem": (
        lambda: _gn_one_block(True, False, 16)(jresnet_gn),
        lambda: _gn_one_block(True, False, 16)(resnet_gn), 100, False, 0.05),
    "rnn_shakespeare": (lambda: jrnn.rnn_shakespeare(),
                        lambda: rnn.rnn_shakespeare(device=CPU), 90, False, 0.5),
    "rnn_shakespeare_seq": (lambda: jrnn.rnn_shakespeare(seq_output=True),
                            lambda: rnn.rnn_shakespeare(seq_output=True, device=CPU),
                            90, True, 0.5),
    "rnn_stackoverflow": (lambda: jrnn.rnn_stackoverflow(),
                          lambda: rnn.rnn_stackoverflow(device=CPU), 10004, True, 0.3),
}
# the one-block ResNetGNs stand in for resnet18_gn's width where it trains
ONE_BLOCK = ("resnet_gn_1111", "resnet_gn_bottleneck_imagenet_stem")
INIT = [m for m in MODELS if m not in ONE_BLOCK]
TRAINED = [m for m in MODELS if m not in ("resnet18_gn", "resnet_gn_bottleneck_imagenet_stem")]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax(name):
    jb = MODELS[name][0]()
    init = jax.jit(jb.init) if name in ONE_BLOCK else jb.init
    return jb, jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0)))


def _data(name, lead, seed=0):
    jb, _ = _jax(name)
    classes, seq = MODELS[name][2], MODELS[name][3]
    rng = np.random.RandomState(seed)
    shape = tuple(jb.input_shape)
    if jb.input_dtype == jnp.int32:
        x = rng.randint(0, classes, (*lead, *shape)).astype(np.int32)
    else:
        x = rng.standard_normal((*lead, *shape)).astype(np.float32)
    y = rng.randint(0, classes, (*lead, *shape) if seq else lead).astype(np.int32)
    return x, y


def _close(got, want, tol, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())), err_msg=msg)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_vars_close(tvars, jvars, tol):
    got, want = _leaves(to_jax_variables(tvars)), _leaves(jvars)
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k], tol, k)


@pytest.mark.parametrize("name", INIT)
def test_init_is_flaxs_bit_for_bit(name):
    _, jvars = _jax(name)
    tvars = MODELS[name][1]().init(rnglib.PRNGKey(0))
    got, want = _leaves(to_jax_variables(tvars)), _leaves(jvars)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k
    # the converter carries the new trees both ways unchanged
    back = to_jax_variables(from_jax_variables(jvars, device=CPU))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(jvars)


def test_recurrent_kernels_are_orthogonal_and_the_input_side_is_not():
    v = rnn.rnn_shakespeare(device=CPU).init(rnglib.PRNGKey(0))["params"]
    for gate in "ifgo":
        h = v[f"LSTMCell_1.h{gate}.kernel"]
        torch.testing.assert_close(h.T @ h, torch.eye(256), atol=1e-5, rtol=0)
        w = v[f"LSTMCell_1.i{gate}.kernel"]
        assert (w.T @ w - torch.eye(256)).abs().max() > 0.1
        assert f"LSTMCell_1.i{gate}.bias" not in v and f"LSTMCell_1.h{gate}.bias" in v
    assert v["Embed_0.embedding"].shape == (90, 8)


@pytest.mark.parametrize("name", list(MODELS))
def test_eval_logits_are_flaxs(name):
    jb, jvars = _jax(name)
    x, _ = _data(name, (3,))
    want = jb.apply_eval(jvars, jnp.asarray(x))
    got = MODELS[name][1]().apply_eval(from_jax_variables(jvars, device=CPU),
                                       torch.from_numpy(x))
    assert got.shape == want.shape
    _close(got.numpy(), want, LOGIT_TOL)


def _jax_loss(jb, x, y, m, key):
    from fedml_tpu.core.losses import masked_softmax_ce as jce

    def f(params, variables):
        logits, _ = jb.apply_train({**variables, "params": params}, x, key)
        return jce(logits, y, m)[0], logits
    return f


@pytest.mark.parametrize("name", TRAINED)
def test_train_logits_and_gradients_are_flaxs(name):
    jb, jvars = _jax(name)
    x, y = _data(name, (4,), seed=1)
    m = np.array([1, 1, 1, 0], np.float32)
    jkey = jax.random.PRNGKey(7)
    (jloss, jlogits), jgrads = jax.value_and_grad(
        _jax_loss(jb, jnp.asarray(x), jnp.asarray(y), jnp.asarray(m), jkey), has_aux=True)(
        jvars["params"], jvars)

    tb = MODELS[name][1]()
    tvars = from_jax_variables(jvars, device=CPU)
    params = {k: v.requires_grad_(True) for k, v in tvars["params"].items()}
    logits, _ = tb.apply_train({**tvars, "params": params}, torch.from_numpy(x),
                               np.asarray(jax.random.key_data(jkey)))
    loss, _ = masked_softmax_ce(logits, torch.from_numpy(y), torch.from_numpy(m))
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    _close(logits.detach().numpy(), jlogits, LOGIT_TOL, "train logits")
    _close(loss.item(), jloss, LOGIT_TOL, "loss")
    _assert_vars_close({"params": grads}, {"params": jgrads}, GRAD_TOL)


def test_dropout_masks_are_flaxs_bit_for_bit():
    """flax ``nn.Dropout`` under ``rngs={"dropout": key}``, nested one scope
    deep: the port's mask and scaled values are the same bits."""
    import flax.linen as fnn

    class JInner(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return fnn.Dropout(0.5, deterministic=False)(x)

    class JOuter(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return JInner()(fnn.Dropout(0.25, deterministic=False)(x))

    class Inner(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.Dropout_0 = Dropout(0.5)

        def forward(self, x, rng):
            return self.Dropout_0(x, True, rng)

    class Outer(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.Dropout_0 = Dropout(0.25)
            self.JInner_0 = Inner()

        def forward(self, x, rng):
            return self.JInner_0(self.Dropout_0(x, True, rng), rng)

    x = np.random.RandomState(0).standard_normal((4, 5, 6, 7)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = np.asarray(JOuter().apply({}, jnp.asarray(x), rngs={"dropout": key}))
    model = Outer()
    name_state_owners(model)
    got = model(torch.from_numpy(x), np.asarray(jax.random.key_data(key))).numpy()
    assert got.tobytes() == want.tobytes()
    assert 0 < (got == 0).mean() < 1
    with pytest.raises(ValueError, match="step key"):
        model(torch.from_numpy(x), None)


K, STEPS, B = 2, 2, 3


@functools.lru_cache(maxsize=None)
def _round_data(name):
    x, y = _data(name, (K, STEPS, B), seed=2)
    mask = np.ones((K, STEPS, B), np.float32)
    mask[0, 1, 2] = 0.0                    # a padded slot
    mask[1, 1] = 0.0                       # a pad-only batch (after the shuffle: pad slots)
    return x, y, mask, mask.sum((1, 2)), np.ones(K, np.float32), np.arange(K, dtype=np.int32)


@pytest.mark.parametrize("name", TRAINED)
def test_local_update_and_round_are_the_jax_engines(name):
    jb, jvars = _jax(name)
    lr = MODELS[name][4]
    x, y, mask, ns, part, ids = _round_data(name)
    jlu = jclient.make_local_update(jb, jclient.make_client_optimizer("sgd", lr), 1)
    tlu = make_local_update(MODELS[name][1](), make_client_optimizer("sgd", lr), 1)
    key = jax.random.PRNGKey(3)
    tkey = np.asarray(jax.random.key_data(key))

    jv, jm = jax.jit(jlu.fn)(jvars, x[0], y[0], mask[0], key)
    tv, tm = tlu(from_jax_variables(jvars, device=CPU), *(torch.from_numpy(a) for a in
                                                          (x[0], y[0], mask[0])), tkey)
    _assert_vars_close(tv, jv, ROUND_TOL)
    for k in jm:
        _close(float(tm[k]), jm[k], ROUND_TOL, k)

    jstate = jfedavg.ServerState(variables=jvars, opt_state=(),
                                 round_idx=jnp.zeros((), jnp.int32), key=key)
    jstate, jrm = jax.jit(jfedavg.make_round_fn(jlu))(
        jstate, *(jnp.asarray(a) for a in (x, y, mask, ns, part, ids)))
    tstate = ServerState(from_jax_variables(jvars, device=CPU), (), 0, tkey)
    tstate, trm = make_round_fn(tlu, device=CPU)(
        tstate, *(torch.from_numpy(a) for a in (x, y, mask, ns, part)), ids)
    _assert_vars_close(tstate.variables, jstate.variables, ROUND_TOL)
    for k in jrm:
        _close(float(trm[k]), jrm[k], ROUND_TOL, k)
