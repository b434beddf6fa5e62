"""The port's SPMD gossip and compiled template round on 8 gloo CPU ranks,
and its ``dryrun_multichip``, held against the JAX package:

- the gossip ring (``ring_mix``: two ``ppermute`` shifts, one client per
  rank) against the port's dense ring round and JAX's ``shard_map`` ring
  (``tests/test_decentralized.py:78``), within 1e-5;
- the dense SPMD form (``all_gather`` + the rank's row of W) against JAX's
  and the dense round;
- ``base_framework.make_compiled_round`` against JAX's compiled form and
  the port's message form (``tests/test_base_framework.py:33``);
- ``dryrun_multichip(8, device="cpu")`` passing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from fedml_tpu.algorithms.base_framework import make_compiled_round as jcompiled
from fedml_tpu.algorithms.decentralized import make_gossip_round_fn as jgossip
from fedml_tpu.core.client import make_client_optimizer as jopt
from fedml_tpu.core.client import make_local_update as jmake_lu
from fedml_tpu.core.topology import ring_topology as jring
from fedml_tpu.core.types import pack_clients as jpack
from fedml_tpu.data.synthetic import synthetic_classification as jsynth
from fedml_tpu.models.linear import logistic_regression as jlr
from fedml_tpu.parallel.compat import shard_map as jshard_map
from fedml_tpu_torch.algorithms.base_framework import run_base_framework
from fedml_tpu_torch.models.convert import to_jax_variables
from fedml_tpu_torch.parallel.compat import launch
from fedml_tpu_torch.parallel.dryrun import dryrun_multichip, run_cases

N = 8
TOL = dict(rtol=1e-5, atol=1e-5)
DATA = dict(num_train=400, num_test=50, input_shape=(8,), num_classes=2, num_clients=N,
            partition="homo", seed=0)
GOSSIP = dict(device="cpu", data=DATA, model=("lr", 8, 2), opt=dict(name="sgd", lr=0.1),
              epochs=1, batch=16, init_key=0, rng_key=1, reference=True)
CASES = [
    ("gossip", {**GOSSIP, "ring": True}),
    ("gossip", {**GOSSIP, "ring": False}),
    ("compiled", dict(device="cpu", num_clients=N, comm_rounds=4)),
    ("compiled", dict(device="cpu", num_clients=2 * N, comm_rounds=3)),
]


@pytest.fixture(scope="module")
def ranks():
    return launch(run_cases, N, CASES, device="cpu", timeout=240.0)


def _jax_layout(variables):
    return to_jax_variables({c: {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
                             for c, d in variables.items()})


def _assert_close(got, want):
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_w = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(np.asarray, want))[0])
    assert len(flat_g) == len(flat_w) > 0
    for path, leaf in flat_g:
        np.testing.assert_allclose(np.asarray(leaf), flat_w[path], err_msg=str(path), **TOL)


def _jax_gossip(ring: bool):
    """JAX's SPMD gossip round on the faked 8-device mesh, stacked [N, ...]."""
    ds = jsynth(**DATA)
    lu = jmake_lu(jlr(8, 2), jopt("sgd", 0.1), epochs=1)
    pack = jpack(ds, list(range(N)), batch_size=16, seed=0)
    init = jlr(8, 2).init(jax.random.PRNGKey(0))
    stacked = jax.tree_util.tree_map(lambda leaf: jnp.stack([leaf] * N), init)
    rng = jax.random.PRNGKey(1)
    ids = jnp.arange(N, dtype=jnp.int32)
    args = (jnp.asarray(pack.x), jnp.asarray(pack.y), jnp.asarray(pack.mask))
    mesh = Mesh(np.array(jax.devices()[:N]), ("clients",))
    fn = jax.jit(jshard_map(
        jgossip(lu, None if ring else jring(N), axis_name="clients", ring=ring),
        mesh=mesh,
        in_specs=(P("clients"), P("clients"), P("clients"), P("clients"), P(),
                  P("clients")),
        out_specs=(P("clients"), P()), check_vma=False))
    shard = NamedSharding(mesh, P("clients"))
    got, _ = fn(jax.device_put(stacked, shard), *(jax.device_put(a, shard) for a in args),
                jax.device_put(rng, NamedSharding(mesh, P())), jax.device_put(ids, shard))
    return got


def _row(tree, i):
    return jax.tree_util.tree_map(lambda leaf: np.asarray(leaf)[i], tree)


@pytest.mark.parametrize("case,ring", [(0, True), (1, False)], ids=["ring", "dense"])
def test_spmd_gossip_matches_dense_ring_and_jax(ranks, case, ring):
    """One client per rank: rank i's mixed model equals row i of the dense
    ring round (the port's, on rank 0) and of JAX's shard_map round."""
    jax_rows = _jax_gossip(ring)
    dense = ranks[0][case]["reference"]
    moved = 0.0
    for r in range(N):
        got = _jax_layout(ranks[r][case]["variables"])
        _assert_close(got, _jax_layout({c: {k: v[r] for k, v in d.items()}
                                        for c, d in dense.items()}))
        _assert_close(got, _row(jax_rows, r))
        moved = max(moved, max(np.abs(np.asarray(a) - np.asarray(b)).max() for a, b in zip(
            jax.tree_util.tree_leaves(got),
            jax.tree_util.tree_leaves(_jax_layout(ranks[(r + 1) % N][case]["variables"])))))
        assert float(ranks[r][case]["metrics"]["count"]) == 50.0  # this rank's client
    assert moved > 1e-4  # the workers differ after a round


@pytest.mark.parametrize("case,clients,rounds", [(2, N, 4), (3, 2 * N, 3)],
                         ids=["8x4", "16x3"])
def test_compiled_round_matches_jax_and_message_form(ranks, case, clients, rounds):
    got = [ranks[r][case]["history"] for r in range(N)]
    for h in got[1:]:
        np.testing.assert_array_equal(h, got[0])
    assert got[0].dtype == np.float32 and got[0].shape == (rounds,)
    jrun = jcompiled(Mesh(np.array(jax.devices()[:N]), ("clients",)))
    np.testing.assert_allclose(got[0], jrun(num_clients=clients, comm_rounds=rounds),
                               rtol=1e-6)
    np.testing.assert_allclose(got[0], run_base_framework(clients, rounds), rtol=1e-6)


def test_dryrun_multichip_on_8_cpu_ranks():
    summary = dryrun_multichip(8, device="cpu", timeout=240.0)
    assert summary["mesh"] == {"axes": {"clients": 8, "model": 1}, "devices": 8,
                               "platform": "cpu"}
    assert summary["parts"] == ["spmd", "hier", "gossip", "sp", "dp_sp", "dp_tp", "tp"]
