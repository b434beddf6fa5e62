"""The port's cross-silo image zoo (``fedml_tpu_torch/models/{vgg,mobilenet,
mobilenet_v3,efficientnet}.py``) held against the JAX package's flax
modules on the same numpy inputs:

- at narrow widths (``mobilenet(width_multiplier=0.25)``, MobileNetV3
  LARGE and SMALL at ``multiplier`` 0.35 with dropout 0.2,
  ``EfficientNet(width_coeff=0.25, depth_coeff=0.5)``), the port's
  ``init(PRNGKey(s))`` equals flax's bit for bit.  VGG's 4096-wide head is
  fixed in both packages, so even a narrow ``cfg`` draws 20M values: the
  port's CPU draw (~2 µs a value) is kept out of this file, and VGG's init
  is held on the card by chip_smoke's ``[init]``;
- at full width, flax's ``PRNGKey(0)`` init of the four registry models at
  100 classes and 32 px equals ``tests/silo_init_digests.json`` (the
  sha256 of each leaf's float32 bytes), the digests the card's draw is held
  to, and so does the port's CPU draw of all but VGG;
- every factory's parameter count equals JAX's (on ``meta``, no draw);
- eval logits (over the statistics a train step left) of the port in
  float32 within 1e-5 of each logit row's largest magnitude; the
  train-mode logits, loss, parameter gradients and new ``batch_stats``
  of a batch of 8 within 1e-6 of each leaf's largest magnitude, JAX and
  the port both in float64, for each family (VGG on a narrow ``cfg``
  whose 8x8 map pools to 7x7 in overlapping bins, flattened in (h, w, c)
  order);
- the dropout and drop-connect masks under a fixed step key equal flax's
  bit for bit; flax's ``padding="SAME"`` at stride 2 and
  ``adaptive_avg_pool`` equal JAX's (and a symmetric-padding control
  differs from flax's wherever SAME pads asymmetrically);
- one local update and one ``make_round_fn`` round of 2 clients x 2 steps
  of 8 (a padded slot, a pad-only batch, dropout on) at SGD lr 1e-3, the
  port in float32, within 1e-4 of the JAX engine's round in float64.

Why float64 on the JAX side (ROADMAP C4).  These BatchNorm nets end at
1x1 maps, where the statistics are over the batch alone, and their
float32 gradients are ill-conditioned: at batch 8 XLA's float32 MobileNet
gradient strays 1.2e-2 from float64 (the port's 1.4e-5), MobileNetV3
LARGE's 4.1e-4 (the port's 1.5e-4).  In float64 the port's gradients
are JAX's within 2e-7.  A fresh MobileNet's round at lr 0.05 is chaotic
in float32 (XLA's ends 0.48 from float64, the port's 1.3e-2, the port's
float64 round 5.2e-7 from JAX's); at lr 1e-3 the port's float32 round
ends within 1.2e-5 of JAX's float64 round, XLA's float32 one 3.3e-3.
x64 draws ``bernoulli``'s uniforms in float64 from other bits, so the
float64 runs draw them as in float32 (``_float64_jax``): the masks stay
the ones the port draws.
"""

import contextlib
import functools
import hashlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu.algorithms.fedavg as jfedavg
import fedml_tpu.core.client as jclient
import fedml_tpu.models.efficientnet as jefficientnet
import fedml_tpu.models.mobilenet as jmobilenet
import fedml_tpu.models.mobilenet_v3 as jmobilenet_v3
import fedml_tpu.models.vgg as jvgg
from fedml_tpu.core.losses import masked_softmax_ce as jce
from fedml_tpu.experiments import registry as jregistry
from fedml_tpu.models.base import ModelBundle as JBundle
from fedml_tpu.parallel.compat import enable_x64
from fedml_tpu_torch.algorithms.fedavg import ServerState, make_round_fn
from fedml_tpu_torch.core import rng as rnglib
from fedml_tpu_torch.core.client import make_client_optimizer, make_local_update
from fedml_tpu_torch.core.losses import masked_softmax_ce
from fedml_tpu_torch.experiments import registry
from fedml_tpu_torch.models import efficientnet, mobilenet, mobilenet_v3, vgg
from fedml_tpu_torch.models.base import ModelBundle
from fedml_tpu_torch.models.convert import from_jax_variables, to_jax_variables
from fedml_tpu_torch.models.resnet import Conv, same_pads
from test_torch_zoo_models import _assert_vars_close, _close, _leaves

CPU = torch.device("cpu")
LOGIT_TOL = 1e-5
F64_TOL = 1e-6
ROUND_TOL = 1e-4
SIDE, CLASSES = 32, 10
DIGESTS = os.path.join(os.path.dirname(__file__), "silo_init_digests.json")
VGG_CFG = (8, "M", 16, "M")  # 32 px -> an 8x8 map: 8 -> 7 pools in overlapping bins

# name: (JAX module, port module, needs_dropout_rng)
NARROW = {
    "mobilenet": (lambda: jmobilenet.MobileNet(width_multiplier=0.25, num_classes=CLASSES),
                  lambda: mobilenet.MobileNet(0.25, CLASSES), False),
    "mobilenet_v3_large": (
        lambda: jmobilenet_v3.MobileNetV3("LARGE", CLASSES, 0.35, 0.2),
        lambda: mobilenet_v3.MobileNetV3("LARGE", CLASSES, 0.35, 0.2), True),
    "mobilenet_v3_small": (
        lambda: jmobilenet_v3.MobileNetV3("SMALL", CLASSES, 0.35, 0.2),
        lambda: mobilenet_v3.MobileNetV3("SMALL", CLASSES, 0.35, 0.2), True),
    "efficientnet": (
        lambda: jefficientnet.EfficientNet(width_coeff=0.25, depth_coeff=0.5,
                                           num_classes=CLASSES),
        lambda: efficientnet.EfficientNet(width_coeff=0.25, depth_coeff=0.5,
                                          num_classes=CLASSES), True),
    "vgg_bn": (lambda: jvgg.VGG(cfg=VGG_CFG, batch_norm=True, num_classes=CLASSES),
               lambda: vgg.VGG(VGG_CFG, True, CLASSES), True),
}
PORT_INIT = [n for n in NARROW if not n.startswith("vgg")]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bundles(name):
    jmod, tmod, dropout = NARROW[name]
    shape = (SIDE, SIDE, 3)
    return (JBundle(module=jmod(), input_shape=shape, needs_dropout_rng=dropout),
            ModelBundle(tmod(), shape, CPU, needs_dropout_rng=dropout))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax(name):
    """The JAX bundle and flax's jitted PRNGKey(0) init (jit draws the
    eager init's bits; the init digests' test holds that at full width)."""
    jb, _ = _bundles(name)
    return jb, _np_tree(jax.jit(jb.init)(jax.random.PRNGKey(0)))


def _images(lead, seed):
    return np.random.RandomState(seed).standard_normal((*lead, SIDE, SIDE, 3)).astype(
        np.float32)


@pytest.mark.parametrize("name", PORT_INIT)
def test_narrow_init_is_flaxs_bit_for_bit(name):
    _, jvars = _jax(name)
    tvars = _bundles(name)[1].init(rnglib.PRNGKey(0))
    got, want = _leaves(to_jax_variables(tvars)), _leaves(jvars)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k


def _digests(variables) -> dict:
    """sha256 of each leaf's float32 bytes under its flax path
    (``params/Conv_0/kernel``), in JAX's leaf order (sorted paths)."""
    return {"/".join(k.key for k in p): hashlib.sha256(
        np.ascontiguousarray(v, np.float32).tobytes()).hexdigest()
        for p, v in jax.tree_util.tree_flatten_with_path(variables)[0]}


@pytest.mark.parametrize("model", ["vgg16_bn", "mobilenet", "mobilenet_v3", "efficientnet"])
def test_full_width_init_digests_are_flaxs(model):
    """``tests/silo_init_digests.json`` is flax's init of the registry model
    (cifar100: 100 classes, 32 px), leaf by leaf in sorted flax-path order."""
    with open(DIGESTS) as f:
        want = json.load(f)["models"][model]
    jb = jregistry.create_model(model, "cifar100", 100)
    got = _digests(jax.jit(jb.init)(jax.random.PRNGKey(0)))
    assert list(got) == list(want) == sorted(want)
    assert got == want


@pytest.mark.parametrize("model", ["mobilenet", "mobilenet_v3", "efficientnet"])
def test_port_full_width_init_equals_the_digests(model):
    """The port's own CPU draw of the registry model equals the digests of
    flax's init, leaf for leaf (vgg16_bn's is drawn on the card only)."""
    import chip_smoke

    with open(DIGESTS) as f:
        want = json.load(f)["models"][model]
    tb = registry.create_model(model, "cifar100", 100, input_shape=(32, 32, 3), device=CPU)
    assert chip_smoke.init_digests(tb.init(rnglib.PRNGKey(0))) == want


def _jax_count(jbundle) -> int:
    shapes = jax.eval_shape(jbundle.init, jax.random.PRNGKey(0))["params"]
    return sum(int(np.prod(v.shape)) for v in jax.tree_util.tree_leaves(shapes))


def _port_count(bundle) -> int:
    return sum(p.numel() for p in bundle.module.parameters())


COUNTS = ([(f"vgg{d}{bn}", c) for d in (11, 13, 16, 19) for bn in ("", "_bn")
           for c in (1000, 100)]
          + [("mobilenet", 100), ("mobilenet_v3_large", 100), ("mobilenet_v3_small", 100)]
          + [(f"efficientnet-b{i}", 1000) for i in range(9)])


@pytest.mark.parametrize("name,classes", COUNTS, ids=[f"{n}-{c}" for n, c in COUNTS])
def test_full_width_parameter_counts_are_jaxs(name, classes):
    if name.startswith("vgg"):
        pair = (getattr(jvgg, name)(classes, 32), getattr(vgg, name)(classes, 32, device="meta"))
    elif name == "mobilenet":
        pair = (jmobilenet.mobilenet(classes), mobilenet.mobilenet(classes, device="meta"))
    elif name.startswith("mobilenet_v3"):
        mode = name.rsplit("_", 1)[1].upper()
        pair = (jmobilenet_v3.mobilenet_v3(classes, mode, image_size=32),
                mobilenet_v3.mobilenet_v3(classes, mode, image_size=32, device="meta"))
    else:
        pair = (jefficientnet.efficientnet(name, classes, 32),
                efficientnet.efficientnet(name, classes, 32, device="meta"))
    jb, tb = pair
    assert tb.needs_dropout_rng == jb.needs_dropout_rng
    assert tuple(tb.input_shape) == tuple(jb.input_shape)
    assert _port_count(tb) == _jax_count(jb)


@contextlib.contextmanager
def _float64_jax():
    """JAX in float64 (x64) for a reference run, with ``jax.random.bernoulli``
    drawing as it does in float32: under x64 it would draw its uniforms in
    float64 from other bits, and every dropout mask would change."""
    bernoulli = jax.random.bernoulli
    jax.random.bernoulli = lambda key, p=0.5, shape=None, mode="low": bernoulli(
        key, jnp.float32(p), shape, mode)
    try:
        with enable_x64():
            yield
    finally:
        jax.random.bernoulli = bernoulli


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda a: a.astype(np.float64) if a.dtype == np.float32 else a, tree)


@functools.lru_cache(maxsize=None)
def _jax_train(name):
    """In float64, under one jit: JAX's train-mode logits, loss, parameter
    gradients and new batch_stats on a batch of 8 (one masked) under a
    fixed step key, and the eval logits of 3 other images over the
    variables with those new batch_stats."""
    jb, jvars = _jax(name)
    x = _images((8,), seed=1)
    x_eval = _images((3,), seed=0)
    y = np.random.RandomState(2).randint(0, CLASSES, 8).astype(np.int32)
    m = np.array([1, 1, 1, 1, 1, 1, 1, 0], np.float32)
    key = jax.random.PRNGKey(7)

    def f(params, variables):
        logits, new = jb.apply_train({**variables, "params": params},
                                     jnp.asarray(x, jnp.float64), key)
        return jce(logits, jnp.asarray(y), jnp.asarray(m))[0], (logits, new)

    def run(variables):
        (loss, (logits, new)), grads = jax.value_and_grad(f, has_aux=True)(
            variables["params"], variables)
        trained = {**variables, **{c: new[c] for c in new if c == "batch_stats"}}
        return loss, logits, grads, trained, jb.apply_eval(
            trained, jnp.asarray(x_eval, jnp.float64))

    with _float64_jax():
        out = _np_tree(jax.jit(run)(_f64(jvars)))
    return x, y, m, key, x_eval, out


@pytest.mark.parametrize("name", list(NARROW))
def test_eval_logits_are_flaxs(name):
    """The port in float32 over the running statistics a train step left
    (not the init's zeros and ones), against JAX's float64 eval."""
    *_, x, (_, _, _, trained, want) = _jax_train(name)
    trained = jax.tree_util.tree_map(lambda a: a.astype(np.float32), trained)
    got = _bundles(name)[1].apply_eval(from_jax_variables(trained, device=CPU),
                                      torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    for row_got, row_want in zip(got, want):
        _close(row_got, row_want, LOGIT_TOL)


@pytest.mark.parametrize("name", list(NARROW))
def test_train_logits_gradients_and_statistics_are_flaxs(name):
    _, jvars = _jax(name)
    x, y, m, key, _, (jloss, jlogits, jgrads, jnew, _) = _jax_train(name)
    tb = _bundles(name)[1]
    tvars = from_jax_variables(_f64(jvars), device=CPU)
    params = {k: v.requires_grad_(True) for k, v in tvars["params"].items()}
    logits, new = tb.apply_train({**tvars, "params": params},
                                 torch.from_numpy(x).double(),
                                 np.asarray(jax.random.key_data(key)))
    loss, _ = masked_softmax_ce(logits, torch.from_numpy(y), torch.from_numpy(m))
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    _close(logits.detach().numpy(), jlogits, F64_TOL, "train logits")
    _close(loss.item(), jloss, F64_TOL, "loss")
    _assert_vars_close({"params": grads}, {"params": jgrads}, F64_TOL)
    if "batch_stats" in jnew:
        _assert_vars_close({"batch_stats": {k: v.detach() for k, v in
                                            new["batch_stats"].items()}},
                           {"batch_stats": jnew["batch_stats"]}, F64_TOL)


@pytest.mark.parametrize("name,scope,rate", [("vgg_bn", "Dropout_0", 0.5),
                                             ("vgg_bn", "Dropout_1", 0.5),
                                             ("efficientnet", "Dropout_0", 0.2),
                                             ("mobilenet_v3_small", "Dropout_0", 0.2)])
def test_dropout_masks_are_flaxs_bit_for_bit(name, scope, rate):
    """The model's own top-level Dropout layer against flax's
    ``nn.Dropout`` of that name, under one step key."""
    import flax.linen as fnn

    class JTop(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return fnn.Dropout(rate, deterministic=False, name=scope)(x)

    x = np.random.RandomState(3).standard_normal((8, 96)).astype(np.float32) + 4.0
    key = jax.random.PRNGKey(11)
    want = np.asarray(JTop().apply({}, jnp.asarray(x), rngs={"dropout": key}))
    layer = getattr(_bundles(name)[1].module, scope)
    assert layer.rate == rate
    got = layer(torch.from_numpy(x), True, np.asarray(jax.random.key_data(key))).numpy()
    assert got.tobytes() == want.tobytes()
    assert 0 < (got == 0).mean() < 1


def test_drop_connect_keys_and_masks_are_flaxs_bit_for_bit(monkeypatch):
    """Every MBConvBlock's drop-connect in one train forward under a fixed
    step key: the key each block draws (flax's ``make_rng("dropout")`` in
    its scope), the rate (``0.2 · idx / total_blocks``) and the per-sample
    mask; then ``drop_connect`` itself on one input, bitwise."""
    jb, jvars = _jax("efficientnet")
    jseen, tseen = [], []
    jdrop, tdrop = jefficientnet.drop_connect, efficientnet.drop_connect

    def jrecord(x, rate, deterministic, rng):
        if rng is not None:
            jax.debug.callback(lambda k, r=rate: jseen.append((r, np.asarray(k))),
                               rng, ordered=True)
        return jdrop(x, rate, deterministic, rng)

    def trecord(x, rate, train, key):
        if key is not None:
            tseen.append((rate, np.asarray(key)))
        return tdrop(x, rate, train, key)

    monkeypatch.setattr(jefficientnet, "drop_connect", jrecord)
    monkeypatch.setattr(efficientnet, "drop_connect", trecord)
    x = _images((4,), seed=5)
    key = jax.random.PRNGKey(9)
    jax.block_until_ready(jax.jit(jb.apply_train)(jvars, jnp.asarray(x), key))
    jax.effects_barrier()
    _bundles("efficientnet")[1].apply_train(from_jax_variables(jvars, device=CPU),
                                            torch.from_numpy(x),
                                            np.asarray(jax.random.key_data(key)))
    assert len(jseen) == len(tseen) > 2
    for (jr, jk), (tr, tk) in zip(jseen, tseen):
        assert jr == tr > 0 and jk.tobytes() == tk.tobytes()
        jmask = np.asarray(jax.random.bernoulli(jnp.asarray(jk), 1 - jr, (64, 1, 1, 1)))
        tmask = rnglib.bernoulli(tk, 1 - tr, (64, 1, 1, 1)).numpy()
        assert np.array_equal(jmask, tmask) and 0 < tmask.mean() < 1
    v = np.random.RandomState(6).standard_normal((64, 2, 2, 5)).astype(np.float32)
    k = jseen[-1][1]
    want = np.asarray(jdrop(jnp.asarray(v), 0.3, False, jnp.asarray(k)))
    got = tdrop(torch.from_numpy(v), 0.3, True, k).numpy()
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("size", [32, 17, 2, 1])
@pytest.mark.parametrize("k", [3, 5])
def test_same_padding_at_stride_2_is_flaxs(size, k):
    """The port's ``Conv(padding="SAME")`` against ``flax.linen.Conv(padding=
    "SAME")`` (a depthwise conv, as EfficientNet's); the control, the
    symmetric ``k // 2`` padding, misses flax's wherever SAME pads
    asymmetrically (even sizes here) and equals it where it does not."""
    import flax.linen as fnn

    c = 6
    x = np.random.RandomState(size).standard_normal((2, size, size, c)).astype(np.float32)
    jconv = fnn.Conv(c, (k, k), strides=2, padding="SAME", feature_group_count=c,
                     use_bias=False)
    jv = _np_tree(jconv.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want = np.asarray(jconv.apply(jv, jnp.asarray(x)))
    tv = {"kernel": torch.tensor(jv["params"]["kernel"])}

    def port(padding):
        conv = Conv(c, c, k, 2, padding=padding, groups=c)
        return torch.func.functional_call(conv, tv, (torch.from_numpy(x),)).numpy()

    got = port("SAME")
    assert got.shape == want.shape == (2, -(-size // 2), -(-size // 2), c)
    _close(got, want, LOGIT_TOL)
    lo, hi = same_pads(size, k, 2)
    control = port(k // 2)
    if lo == hi:
        _close(control, want, LOGIT_TOL)
    else:
        assert size % 2 == 0
        assert control.shape != want.shape or not np.allclose(control, want, atol=1e-3)


@pytest.mark.parametrize("size", [1, 2, 8, 14])
def test_adaptive_avg_pool_is_jaxs(size):
    x = np.random.RandomState(size).standard_normal((2, size, size, 5)).astype(np.float32)
    want = np.asarray(jvgg.adaptive_avg_pool(jnp.asarray(x), 7))
    got = vgg.adaptive_avg_pool(torch.from_numpy(x), 7).numpy()
    assert got.shape == want.shape == (2, 7, 7, 5)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


K, STEPS, B = 2, 2, 8
ROUND_LR = 1e-3  # the cross-silo benchmark's SGD lr (BASELINE.md)


@functools.lru_cache(maxsize=None)
def _round_data():
    rng = np.random.RandomState(4)
    x = rng.standard_normal((K, STEPS, B, SIDE, SIDE, 3)).astype(np.float32)
    y = rng.randint(0, CLASSES, (K, STEPS, B)).astype(np.int32)
    mask = np.ones((K, STEPS, B), np.float32)
    mask[0, 1, 5] = 0.0                    # a padded slot
    mask[1, 1] = 0.0                       # a pad-only batch
    return x, y, mask, mask.sum((1, 2)), np.ones(K, np.float32), np.arange(K, dtype=np.int32)


@pytest.mark.parametrize("name", list(NARROW))
def test_local_update_and_round_are_the_jax_engines(name):
    jb, jvars = _jax(name)
    x, y, mask, ns, part, ids = _round_data()
    tb = _bundles(name)[1]
    jlu = jclient.make_local_update(jb, jclient.make_client_optimizer("sgd", ROUND_LR), 1)
    tlu = make_local_update(tb, make_client_optimizer("sgd", ROUND_LR), 1)
    key = jax.random.PRNGKey(3)
    tkey = np.asarray(jax.random.key_data(key))

    with _float64_jax():
        jv, jm = _np_tree(jax.jit(jlu.fn)(_f64(jvars), x[0].astype(np.float64), y[0],
                                          mask[0], key))
    tv, tm = tlu(from_jax_variables(jvars, device=CPU),
                 *(torch.from_numpy(a) for a in (x[0], y[0], mask[0])), tkey)
    _assert_vars_close(tv, jv, ROUND_TOL)
    for k in jm:
        _close(float(tm[k]), jm[k], ROUND_TOL, k)

    with _float64_jax():
        jstate = jfedavg.ServerState(variables=_f64(jvars), opt_state=(),
                                     round_idx=jnp.zeros((), jnp.int32), key=key)
        jstate, jrm = jax.jit(jfedavg.make_round_fn(jlu))(
            jstate, *(jnp.asarray(a) for a in (x.astype(np.float64), y, mask, ns, part, ids)))
        jvars_new, jrm = _np_tree((jstate.variables, jrm))
    tstate = ServerState(from_jax_variables(jvars, device=CPU), (), 0, tkey)
    tstate, trm = make_round_fn(tlu, device=CPU)(
        tstate, *(torch.from_numpy(a) for a in (x, y, mask, ns, part)), ids)
    _assert_vars_close(tstate.variables, jvars_new, ROUND_TOL)
    for k in jrm:
        _close(float(trm[k]), jrm[k], ROUND_TOL, k)


def write_digests(path: str = DIGESTS) -> None:
    """Recompute ``tests/silo_init_digests.json`` from flax's inits."""
    models = {}
    for model in ("vgg16_bn", "mobilenet", "mobilenet_v3", "efficientnet"):
        jb = jregistry.create_model(model, "cifar100", 100)
        models[model] = _digests(jax.jit(jb.init)(jax.random.PRNGKey(0)))
    with open(path, "w") as f:
        json.dump({"about": "sha256 of the float32 bytes of each leaf of flax's "
                            "PRNGKey(0) init of fedml_tpu.experiments.registry."
                            "create_model(model, 'cifar100', 100) under its flax "
                            f"path, jax {jax.__version__}, in sorted path order",
                   "models": models}, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu python tests/test_torch_silo_models.py
    write_digests()
