"""SplitNN (``fedml_tpu_torch/algorithms/splitnn.py``, ``models/cnn.py::
cnn_split_pair``) held against the JAX package on the CPU, on the same
numpy data and seeds.

- The halves' seeded inits equal flax's bit for bit (image and flat
  inputs), and their forwards agree within 1e-5.
- ``top_step``'s activation cotangent and three ``fused_step``s (params,
  both optimizer states, metrics) within 1e-5.
- The port's split pieces, ``bottom_forward`` → ``top_step`` →
  ``bottom_backward``, are its ``fused_step`` bit for bit.
- One ``SplitNNSimulation.run_epoch`` (uneven shards, a dropped partial
  last batch) within 1e-5, and ``run.main --algorithm splitnn`` against the
  JAX entry point.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms import splitnn as jsplit
from fedml_tpu.experiments import run as jrun
from fedml_tpu.models.cnn import cnn_split_pair as jpair
from fedml_tpu_torch.algorithms import splitnn
from fedml_tpu_torch.core import rng
from fedml_tpu_torch.experiments import run
from fedml_tpu_torch.models.cnn import cnn_split_pair
from fedml_tpu_torch.models.convert import from_jax_variables, to_jax_variables

TOL = {"rtol": 1e-5, "atol": 1e-5}
SHAPE, CLASSES = (8, 8, 3), 5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_params_close(tparams, jparams, tol=TOL, exact=False):
    flat_t = _flat(to_jax_variables({"params": tparams})["params"])
    flat_j = _flat(jparams)
    assert sorted(flat_t) == sorted(flat_j) and flat_j
    for path, leaf in flat_j.items():
        if exact:
            np.testing.assert_array_equal(flat_t[path], leaf, err_msg=str(path))
        else:
            np.testing.assert_allclose(flat_t[path], leaf, err_msg=str(path), **tol)


def _port_params(jparams):
    return from_jax_variables({"params": _np(jparams)}, device="cpu")["params"]


def _data(n, seed=0, shape=SHAPE):
    r = np.random.RandomState(seed)
    return (r.normal(size=(n, *shape)).astype(np.float32),
            r.randint(0, CLASSES, n).astype(np.int32))


@pytest.mark.parametrize("shape", [(28, 28, 1), (784,), (8, 8, 3)])
def test_split_pair_init_and_forward_match_flax(shape):
    (jb, jt), (tb, tt) = jpair(10, shape), cnn_split_pair(10, shape, device="cpu")
    key = jax.random.PRNGKey(0)
    jbp = jb.init(jax.random.fold_in(key, 1))["params"]
    jtp = jt.init(key)["params"]
    tbp = tb.init(rng.fold_in(rng.PRNGKey(0), 1))["params"]
    ttp = tt.init(rng.PRNGKey(0))["params"]
    _assert_params_close(tbp, jbp, exact=True)
    _assert_params_close(ttp, jtp, exact=True)
    x, _ = _data(4, shape=shape)
    jacts = jb.module.apply({"params": jbp}, jnp.asarray(x))
    tacts = tb.apply_eval({"params": tbp}, torch.from_numpy(x))
    assert tacts.shape == jacts.shape == (4, tt.input_shape[0])
    np.testing.assert_allclose(tacts.numpy(), np.asarray(jacts), **TOL)
    np.testing.assert_allclose(tt.apply_eval({"params": ttp}, tacts).numpy(),
                               np.asarray(jt.module.apply({"params": jtp}, jacts)), **TOL)


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX halves after ``top_step`` on one batch and after three
    ``fused_step``s, from ``init_half``'s states."""
    jb, jt = jpair(CLASSES, SHAPE)
    opt = jsplit.split_optimizer(0.1)
    fused, _, top_step, _, _ = jsplit.make_split_steps(jb, jt, opt)
    b0 = jsplit.init_half(jb, jax.random.PRNGKey(1), opt)
    t0 = jsplit.init_half(jt, jax.random.PRNGKey(2), opt)
    batches = [_data(16, seed=s) for s in range(3)]
    acts = jb.module.apply({"params": b0.params}, jnp.asarray(batches[0][0]), train=True)
    t1, gacts, m1 = top_step(t0, acts, jnp.asarray(batches[0][1]))
    b, t, rows = b0, t0, []
    for x, y in batches:
        b, t, m = jax.jit(fused)(b, t, jnp.asarray(x), jnp.asarray(y))
        rows.append(_np(m))
    return {"b0": b0, "t0": t0, "batches": batches, "acts": np.array(acts),
            "t1": t1, "gacts": np.array(gacts), "m1": _np(m1), "b": b, "t": t,
            "rows": rows}


def _port_half(jstate, opt):
    params = _port_params(jstate.params)
    return splitnn.HalfState(params, opt.init(params))


def test_top_step_cotangent_matches_jax(jax_steps):
    _, tt = cnn_split_pair(CLASSES, SHAPE, device="cpu")
    opt = splitnn.split_optimizer(0.1)
    _, _, top_step, _, _ = splitnn.make_split_steps(None, tt, opt)
    t1, gacts, m1 = top_step(_port_half(jax_steps["t0"], opt),
                             torch.from_numpy(jax_steps["acts"]),
                             torch.from_numpy(jax_steps["batches"][0][1]))
    np.testing.assert_allclose(gacts.numpy(), jax_steps["gacts"], **TOL)
    _assert_params_close(t1.params, jax_steps["t1"].params)
    for k in ("loss", "correct", "count"):
        np.testing.assert_allclose(float(m1[k]), float(jax_steps["m1"][k]), **TOL)


def test_three_fused_steps_match_jax(jax_steps):
    tb, tt = cnn_split_pair(CLASSES, SHAPE, device="cpu")
    opt = splitnn.split_optimizer(0.1)
    fused, *_ = splitnn.make_split_steps(tb, tt, opt)
    b, t = _port_half(jax_steps["b0"], opt), _port_half(jax_steps["t0"], opt)
    for (x, y), want in zip(jax_steps["batches"], jax_steps["rows"]):
        b, t, m = fused(b, t, torch.from_numpy(x), torch.from_numpy(y))
        for k in ("loss", "correct", "count"):
            np.testing.assert_allclose(float(m[k]), float(want[k]), **TOL)
    _assert_params_close(b.params, jax_steps["b"].params)
    _assert_params_close(t.params, jax_steps["t"].params)
    # the momentum traces (optax's TraceState after add_decayed_weights)
    _assert_params_close(b.opt_state[1], jax_steps["b"].opt_state[1][0].trace)
    _assert_params_close(t.opt_state[1], jax_steps["t"].opt_state[1][0].trace)


def test_split_pieces_compose_to_the_fused_step_bitwise():
    tb, tt = cnn_split_pair(CLASSES, SHAPE, device="cpu")
    opt = splitnn.split_optimizer(0.1)
    fused, bottom_forward, top_step, bottom_backward, _ = splitnn.make_split_steps(
        tb, tt, opt)
    b = s_b = splitnn.init_half(tb, rng.PRNGKey(1), opt)
    t = s_t = splitnn.init_half(tt, rng.PRNGKey(2), opt)
    for seed in range(3):
        x, y = map(torch.from_numpy, _data(16, seed=seed))
        b, t, m = fused(b, t, x, y)
        acts = bottom_forward(s_b, x)
        s_t, gacts, sm = top_step(s_t, acts, y)
        s_b = bottom_backward(s_b, x, gacts)
        for k in m:
            assert torch.equal(m[k], sm[k]), k
    for fused_state, split_state in ((b, s_b), (t, s_t)):
        for k, v in fused_state.params.items():
            assert torch.equal(v, split_state.params[k]), k
        for k, v in fused_state.opt_state[1].items():
            assert torch.equal(v, split_state.opt_state[1][k]), k


def _assert_rows_close(trows, jrows, tol=TOL):
    assert len(trows) == len(jrows) > 0
    for r, (t, j) in enumerate(zip(trows, jrows)):
        assert sorted(t) == sorted(j), r
        for k in j:
            np.testing.assert_allclose(t[k], j[k], err_msg=f"row {r} {k}", **tol)


def test_ring_epoch_matches_jax():
    """Three uneven clients (40, 27 and 16 samples at batch 8: the
    second's partial last batch is dropped), one ring epoch, validation in batches
    of 256 over 300 test samples."""
    x, y = _data(83, seed=4)
    parts = [(x[:40], y[:40]), (x[40:67], y[40:67]), (x[67:], y[67:])]
    test = _data(300, seed=5)
    kw = dict(batch_size=8, lr=0.05, seed=3)
    js = jsplit.SplitNNSimulation(*jpair(CLASSES, SHAPE), parts, test_data=test, **kw)
    ts = splitnn.SplitNNSimulation(*cnn_split_pair(CLASSES, SHAPE, device="cpu"), parts,
                                   test_data=test, device="cpu", **kw)
    for tstate, jstate in zip(ts.client_states, js.client_states):
        _assert_params_close(tstate.params, jstate.params, exact=True)
    _assert_params_close(ts.server_state.params, js.server_state.params, exact=True)
    _assert_rows_close(ts.run_epoch(), js.run_epoch())
    for tstate, jstate in zip(ts.client_states, js.client_states):
        _assert_params_close(tstate.params, jstate.params)
    _assert_params_close(ts.server_state.params, js.server_state.params)


def test_run_main_splitnn_matches_jax(tmp_path):
    """The CIFAR-10 stand-in through both entry points: 3 clients of 16
    samples, batch 8, 2 ring epochs at lr 0.01."""
    argv = ["--algorithm", "splitnn", "--ci", "1", "--lr", "0.01"]
    want = jrun.main([*argv, "--run_dir", str(tmp_path / "jax")])["history"]
    got = run.main([*argv, "--device", "cpu", "--run_dir", str(tmp_path / "port")])["history"]
    assert len(got) == 6 and all(np.isfinite(r["val_loss"]) for r in got)
    _assert_rows_close(got, want)


def _message_mode(split_mod, bus_mod, bottom, top, x, y, acts_template, **kw):
    """One client's two ring epochs against the server over a bus; the
    client's bottom from ``PRNGKey(41 + 1)``, the top from ``PRNGKey(0)``."""
    bus = bus_mod.InprocBus()
    server = split_mod.SplitNNServerManager(bus.register(0), top, acts_template=acts_template,
                                            lr=0.1, seed=0, **kw)
    client = split_mod.SplitNNClientManager(
        bus.register(1), bottom, x, y, node_id=1, next_node=1, batch_size=16, lr=0.1,
        active=True, seed=41, total_hops=2, **kw)
    client.start_if_active()
    bus.drain()
    assert server.batches_seen == 6  # 3 batches x 2 epochs
    return client, server


def test_message_mode_equals_fused_ring_and_jax():
    """The port's message-mode managers over its ``InprocBus`` against its
    fused step on the same batches (tolerance: none), and against JAX's
    message mode on the same data (the ring's tolerance, 1e-5)."""
    from fedml_tpu.comm import inproc as jinproc
    from fedml_tpu_torch.comm import inproc

    x, y = _data(48, seed=6)
    tb, tt = cnn_split_pair(CLASSES, SHAPE, device="cpu")
    opt = splitnn.split_optimizer(0.1)
    fused, bottom_forward, *_ = splitnn.make_split_steps(tb, tt, opt)
    b = splitnn.init_half(tb, rng.PRNGKey(42), opt)
    t = splitnn.init_half(tt, rng.PRNGKey(0), opt)
    acts = bottom_forward(b, torch.from_numpy(x[:16]))
    client, server = _message_mode(splitnn, inproc, tb, tt, x, y, torch.zeros_like(acts),
                                   device="cpu")
    for _ in range(2):
        for lo in range(0, 48, 16):
            b, t, _m = fused(b, t, torch.from_numpy(x[lo:lo + 16]),
                             torch.from_numpy(y[lo:lo + 16]))
    for mine, ref in ((client.state, b), (server.state, t)):
        for k, v in ref.params.items():
            assert torch.equal(mine.params[k], v), k
    jb, jt = jpair(CLASSES, SHAPE)
    jclient, jserver = _message_mode(jsplit, jinproc, jb, jt, x, y,
                                     jnp.zeros(tuple(acts.shape), jnp.float32))
    _assert_params_close(client.state.params, jclient.state.params)
    _assert_params_close(server.state.params, jserver.state.params)
