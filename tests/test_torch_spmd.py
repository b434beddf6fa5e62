"""The port's FedAvg over a clients mesh (``fedml_tpu_torch/parallel/
spmd.py``, ``make_round_fn(axis_name=...)``) on 8 gloo CPU ranks, held
against the JAX package's ``fedml_tpu/parallel/spmd.py`` on the faked
8-device CPU mesh within 1e-5 (``tests/test_spmd.py``'s tolerance):

- the SPMD round, on a (8, 1) and a (4, 2) ``(clients, model)`` mesh,
  every rank ending with the same bytes, and within a few float32 ulps of
  the port's single-device round (only the order of the psum's terms
  differs);
- the participation mask;
- the two-simulated-host local packing, byte for byte the global block
  and the global block's round;
- the two-tier round on a (group, clients) mesh, against JAX's and the
  port's ``HierarchicalSimulation``;
- a 1-rank mesh equal to ``make_round_fn`` byte for byte;
- ``error_feedback`` under an axis and on-device sampling under an axis
  refused with JAX's messages.

One launch of 8 ranks (``compat.launch``) serves the multi-rank cases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms import fedavg as jfedavg
from fedml_tpu.algorithms.fedavg import FedAvgConfig as JConfig
from fedml_tpu.algorithms.hierarchical import HierarchicalSimulation as JHier
from fedml_tpu.compress import get_codec as jget_codec
from fedml_tpu.core.client import make_client_optimizer as jopt
from fedml_tpu.core.client import make_local_update as jmake_lu
from fedml_tpu.core.types import pack_clients as jpack
from fedml_tpu.data.synthetic import synthetic_classification as jsynth
from fedml_tpu.models.linear import logistic_regression as jlr
from fedml_tpu.parallel import spmd as jspmd
from fedml_tpu_torch.algorithms.fedavg import (ServerState, make_multi_round_fn,
                                               make_round_fn,
                                               make_scheduled_multi_round_fn)
from fedml_tpu_torch.compress.codecs import get_codec
from fedml_tpu_torch.core.client import make_client_optimizer, make_local_update
from fedml_tpu_torch.core.rng import PRNGKey
from fedml_tpu_torch.core.types import pack_clients
from fedml_tpu_torch.data.synthetic import synthetic_classification
from fedml_tpu_torch.models.convert import to_jax_variables
from fedml_tpu_torch.models.linear import logistic_regression
from fedml_tpu_torch.models.resnet import resnet20
from fedml_tpu_torch.parallel.compat import launch, single_rank_group
from fedml_tpu_torch.parallel.dryrun import run_cases
from fedml_tpu_torch.parallel.spmd import (hierarchical_pack, make_client_mesh,
                                           make_spmd_round_fn, shard_client_block)

TOL = dict(rtol=1e-5, atol=1e-5)
# N ranks against one device: the same fp32 terms summed in another order,
# so each leaf within this many float32 spacings of its largest magnitude
ULPS = 8

DATA = dict(num_train=800, num_test=100, input_shape=(12,), num_classes=4,
            num_clients=8, partition="hetero", partition_alpha=0.5, seed=0)
LR = dict(device="cpu", data=DATA, model=("lr", 12, 4), opt=dict(name="sgd", lr=0.2),
          epochs=2, batch=16)
MASK = [1, 0, 1, 0, 1, 0, 1, 0]
HIER = dict(device="cpu", data=DATA, model=("lr", 12, 4), num_groups=2,
            group_comm_round=3, reference=True,
            cfg=dict(num_clients=8, clients_per_round=8, comm_rounds=2, epochs=2,
                     batch_size=16, lr=0.2, seed=0))
CASES = [
    ("spmd", {**LR, "single": True}),
    ("spmd", {**LR, "participation": MASK, "single": True}),
    ("spmd", {**LR, "hosts": 2}),
    ("spmd", {**LR, "model_axis": 2}),
    ("hier", HIER),
]


@pytest.fixture(scope="module")
def ranks():
    """Every case's results on each of 8 gloo ranks: ranks[rank][case]."""
    return launch(run_cases, 8, CASES, device="cpu", timeout=240.0)


def _jax_layout(variables):
    return to_jax_variables({c: {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
                             for c, d in variables.items()})


def _assert_close_to_jax(port_vars, jax_vars, **tol):
    flat_p = jax.tree_util.tree_flatten_with_path(_jax_layout(port_vars))[0]
    flat_j = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(np.asarray, jax_vars))[0])
    assert len(flat_p) == len(flat_j) > 0
    for path, leaf in flat_p:
        np.testing.assert_allclose(leaf, flat_j[path], err_msg=str(path), **(tol or TOL))


def _assert_same_bytes(a, b):
    assert a.keys() == b.keys()
    for c in a:
        assert a[c].keys() == b[c].keys()
        for k in a[c]:
            np.testing.assert_array_equal(a[c][k], b[c][k], err_msg=f"{c}/{k}")


def _assert_within_ulps(got, want):
    for c in want:
        for k, w in want[c].items():
            w = np.asarray(w, np.float32)
            bound = ULPS * np.spacing(np.float32(np.abs(w).max()))
            assert np.abs(np.asarray(got[c][k]) - w).max() <= bound, (c, k)


def _jax_problem():
    ds = jsynth(**DATA)
    lu = jmake_lu(jlr(12, 4), jopt("sgd", 0.2), epochs=2)
    pack = jpack(ds, list(range(8)), batch_size=16, seed=0)
    key = jax.random.PRNGKey(0)
    state = jfedavg.ServerState(variables=jlr(12, 4).init(key), opt_state=(),
                                round_idx=jnp.zeros((), jnp.int32), key=key)
    return ds, lu, pack, state


def _jax_spmd(participation=None, model_axis=1):
    _, lu, pack, state = _jax_problem()
    part = jnp.ones(8, jnp.float32) if participation is None else jnp.asarray(
        participation, jnp.float32)
    args = (jnp.asarray(pack.x), jnp.asarray(pack.y), jnp.asarray(pack.mask),
            jnp.asarray(pack.num_samples), part, jnp.arange(8, dtype=jnp.int32))
    mesh = jspmd.make_client_mesh(8, model_axis=model_axis)
    fn = jspmd.make_spmd_round_fn(mesh, lu, donate=False)
    return fn(jspmd.replicate(mesh, state), *jspmd.shard_client_block(mesh, args))


def _assert_replicated(ranks, case):
    for r in range(1, 8):
        _assert_same_bytes(ranks[r][case]["variables"], ranks[0][case]["variables"])


def test_spmd_round_matches_jax(ranks):
    _assert_replicated(ranks, 0)
    got = ranks[0][0]
    assert got["mesh"] == {"axes": {"clients": 8, "model": 1}, "devices": 8,
                           "platform": "cpu"}
    assert got["round_idx"] == 1
    jstate, jmetrics = _jax_spmd()
    _assert_close_to_jax(got["variables"], jstate.variables)
    for k in ("count", "correct", "participants"):
        assert float(got["metrics"][k]) == float(jmetrics[k]), k
    np.testing.assert_allclose(got["metrics"]["loss_sum"], jmetrics["loss_sum"], rtol=1e-5)
    _assert_within_ulps(got["variables"], got["single"]["variables"])


def test_spmd_round_on_a_mesh_with_a_model_axis_matches_jax(ranks):
    _assert_replicated(ranks, 3)
    got = ranks[0][3]
    assert got["mesh"]["axes"] == {"clients": 4, "model": 2}
    jstate, _ = _jax_spmd(model_axis=2)
    _assert_close_to_jax(got["variables"], jstate.variables)
    # the same clients' sums over 4 ranks instead of 8
    _assert_within_ulps(got["variables"], ranks[0][0]["single"]["variables"])


def test_spmd_participation_mask(ranks):
    """Unsampled clients contribute exactly zero: the masked round is
    JAX's masked round, and its counts are the sampled clients' only."""
    _assert_replicated(ranks, 1)
    got = ranks[0][1]
    jstate, jmetrics = _jax_spmd(MASK)
    _assert_close_to_jax(got["variables"], jstate.variables)
    assert float(got["metrics"]["participants"]) == 4.0
    assert float(got["metrics"]["count"]) == float(jmetrics["count"])
    _assert_within_ulps(got["variables"], got["single"]["variables"])
    # the mask changed the round
    assert any(np.abs(got["variables"]["params"][k]
                      - ranks[0][0]["variables"]["params"][k]).max() > 1e-4
               for k in got["variables"]["params"])


def test_host_sharded_packing_matches_single_host(ranks):
    """Two simulated hosts (ranks 0-3 and 4-7), each packing ONLY its
    clients' rows (``subset_for_clients``): every rank's block equals its
    rows of the global block byte for byte, and so does the round."""
    ds = synthetic_classification(**DATA)
    for r in range(8):
        got = ranks[r][2]
        assert got["local_equals_global"]
        assert got["host_range"] == ([0, 4] if r < 4 else [4, 8])
        lo, hi = got["host_range"]
        want_rows = sum(len(ds.train_client_idx[c]) for c in range(lo, hi))
        assert got["host_rows"] == [want_rows, len(ds.train_x)] and want_rows < len(ds.train_x)
        _assert_same_bytes(got["variables"], ranks[0][0]["variables"])
    assert float(ranks[0][2]["metrics"]["loss_sum"]) == float(ranks[0][0]["metrics"]["loss_sum"])
    jstate, _ = _jax_spmd()
    _assert_close_to_jax(ranks[0][2]["variables"], jstate.variables)


def test_hierarchical_spmd_matches_jax_and_host_simulation(ranks):
    """The (group, clients) round: psum over clients per in-group round,
    the sample-weighted psum over groups, metrics over every in-group round
    of every group (``tests/test_spmd.py:182``)."""
    _assert_replicated(ranks, 4)
    got = ranks[0][4]
    assert got["mesh"]["axes"] == {"group": 2, "clients": 4}
    assert got["round_idx"] == 1
    host = got["reference"]
    for c in host["variables"]:
        for k in host["variables"][c]:
            np.testing.assert_allclose(got["variables"][c][k], host["variables"][c][k], **TOL)
    assert float(got["metrics"]["count"]) == pytest.approx(host["metrics"]["count"])
    assert float(got["metrics"]["loss_sum"]) == pytest.approx(host["metrics"]["loss_sum"],
                                                              rel=1e-5)

    ds = jsynth(**DATA)
    sim = JHier(jlr(12, 4), ds, JConfig(**HIER["cfg"]), num_groups=2, group_comm_round=3)
    mesh = jspmd.make_group_mesh(2, 8)
    block, ids = jspmd.hierarchical_pack(ds, sim.groups, 16, sim.steps_per_epoch, 0)
    jstate, jmetrics = jspmd.make_hierarchical_spmd_round_fn(
        mesh, sim.local_update, group_comm_round=3)(
        jspmd.replicate(mesh, sim.state), *block, jnp.ones(len(ids), jnp.float32),
        jnp.asarray(ids, jnp.int32))
    _assert_close_to_jax(got["variables"], jstate.variables)
    assert float(got["metrics"]["count"]) == float(jmetrics["count"])
    np.testing.assert_allclose(got["metrics"]["loss_sum"], jmetrics["loss_sum"], rtol=1e-5)

    with pytest.raises(ValueError, match="equal group sizes"):
        hierarchical_pack(synthetic_classification(**DATA), {0: [0, 1, 2], 1: [3, 4]}, 16,
                          sim.steps_per_epoch, 0)


@pytest.mark.parametrize("model", ["lr", "resnet20"])
def test_one_rank_mesh_equals_make_round_fn_bytewise(model):
    """On a 1-rank mesh the psum is the identity, so the SPMD round is
    ``make_round_fn``'s, byte for byte (variables and metrics)."""
    if model == "lr":
        ds = synthetic_classification(**DATA)
        bundle = logistic_regression(12, 4, device="cpu")
        opt = make_client_optimizer("sgd", 0.2)
    else:
        ds = synthetic_classification(num_train=64, num_test=16, input_shape=(8, 8, 3),
                                      num_classes=4, num_clients=4, partition="homo",
                                      seed=0)
        bundle = resnet20(num_classes=4, image_size=8, device="cpu")
        opt = make_client_optimizer("sgd", 0.1, momentum=0.9)
    lu = make_local_update(bundle, opt, epochs=1)
    n = ds.num_clients
    pack = pack_clients(ds, list(range(n)), batch_size=8, seed=0)
    raw = (pack.x, pack.y, pack.mask, pack.num_samples, np.ones(n, np.float32),
           np.arange(n, dtype=np.int32))
    key = PRNGKey(0)
    with single_rank_group("cpu"):
        mesh = make_client_mesh(device="cpu")
        block = shard_client_block(mesh, raw)
        got, gm = make_spmd_round_fn(mesh, lu)(ServerState(bundle.init(key), (), 0, key),
                                               *block)
    want, wm = make_round_fn(lu, device="cpu")(ServerState(bundle.init(key), (), 0, key),
                                               *block)
    for c in want.variables:
        for k in want.variables[c]:
            assert torch.equal(got.variables[c][k], want.variables[c][k]), (c, k)
    assert all(torch.equal(gm[k], wm[k]) for k in wm) and gm.keys() == wm.keys()


def _jax_message(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


def test_axis_refusals_are_jaxs():
    """``error_feedback`` under a mesh axis, and a fused driver drawing
    participation on the device under one (whether the axis comes as a
    kwarg or baked into a pre-built kernel), raise JAX's ValueErrors."""
    lu = make_local_update(logistic_regression(4, 2, device="cpu"),
                           make_client_optimizer(), 1)
    jlu = jmake_lu(jlr(4, 2), jopt(), 1)
    want = _jax_message(lambda: jfedavg.make_round_fn(
        jlu, codec=jget_codec("int8"), error_feedback=True, axis_name="clients"))
    got = _jax_message(lambda: make_round_fn(
        lu, device="cpu", codec=get_codec("int8"), error_feedback=True, axis_name="clients"))
    assert got == want and "error_feedback is not defined under shard_map" in got
    make_round_fn(lu, device="cpu", codec=get_codec("int8"), axis_name="clients")

    kernel = make_round_fn(lu, device="cpu", axis_name="clients")
    assert kernel.axis_name == "clients"
    assert make_round_fn(lu, device="cpu").axis_name is None
    jkernel = jfedavg.make_round_fn(jlu, axis_name="clients")
    for kw in (dict(clients_per_round=2), dict(drop_prob=0.5)):
        want = _jax_message(lambda: jfedavg.make_multi_round_fn(None, 2, round_fn=jkernel, **kw))
        got = _jax_message(lambda: make_multi_round_fn(None, 2, round_fn=kernel,
                                                       device="cpu", **kw))
        assert got == want and "not defined under shard_map" in got
        want = _jax_message(lambda: jfedavg.make_multi_round_fn(jlu, 2, axis_name="clients",
                                                                **kw))
        got = _jax_message(lambda: make_multi_round_fn(lu, 2, axis_name="clients",
                                                       device="cpu", **kw))
        assert got == want
    want = _jax_message(lambda: jfedavg.make_scheduled_multi_round_fn(
        None, drop_prob=0.5, round_fn=jkernel))
    got = _jax_message(lambda: make_scheduled_multi_round_fn(
        None, drop_prob=0.5, round_fn=kernel, device="cpu"))
    assert got == want
    # host-drawn masks stay allowed under an axis
    make_multi_round_fn(None, 2, round_fn=kernel, device="cpu")


def test_aggregate_impl_replaces_the_fold_as_in_jax():
    """``aggregate_impl(weights, stacked)`` computes the weighted sum in
    place of the fold: a sequential fold equals the default round's bytes,
    a reversed one JAX's round with the same kernel within 1e-5."""
    ds = synthetic_classification(**DATA)
    lu = make_local_update(logistic_regression(12, 4, device="cpu"),
                           make_client_optimizer("sgd", 0.2), 2)
    pack = pack_clients(ds, list(range(8)), batch_size=16, seed=0)
    args = [torch.from_numpy(a) for a in (pack.x, pack.y, pack.mask, pack.num_samples)]
    args += [torch.ones(8), np.arange(8)]
    key = PRNGKey(0)
    state = ServerState(logistic_regression(12, 4, device="cpu").init(key), (), 0, key)

    def in_order(weights, stacked):
        return {c: {k: sum(weights[i] * v[i].float() for i in range(len(weights)))
                    for k, v in d.items()} for c, d in stacked.items()}

    def reversed_order(weights, stacked):
        return {c: {k: sum(weights[i] * v[i].float() for i in reversed(range(len(weights))))
                    for k, v in d.items()} for c, d in stacked.items()}

    want, _ = make_round_fn(lu, device="cpu")(state, *args)
    got, _ = make_round_fn(lu, device="cpu", aggregate_impl=in_order)(state, *args)
    for c in want.variables:
        for k in want.variables[c]:
            assert torch.equal(got.variables[c][k], want.variables[c][k]), (c, k)
    rev, _ = make_round_fn(lu, device="cpu", aggregate_impl=reversed_order)(state, *args)

    _, jlu, jpk, jstate = _jax_problem()

    def jax_reversed(weights, stacked):
        return jax.tree_util.tree_map(
            lambda leaf: sum(weights[i] * leaf[i].astype(jnp.float32)
                             for i in reversed(range(leaf.shape[0]))), stacked)

    jargs = (jnp.asarray(jpk.x), jnp.asarray(jpk.y), jnp.asarray(jpk.mask),
             jnp.asarray(jpk.num_samples), jnp.ones(8, jnp.float32),
             jnp.arange(8, dtype=jnp.int32))
    jgot, _ = jfedavg.make_round_fn(jlu, aggregate_impl=jax_reversed)(jstate, *jargs)
    _assert_close_to_jax({c: {k: v.numpy() for k, v in d.items()}
                          for c, d in rev.variables.items()}, jgot.variables)
