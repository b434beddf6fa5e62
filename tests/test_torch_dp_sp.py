"""The port's DP×SP rounds and ``run.py --sp_degree``
(``fedml_tpu_torch/parallel/dp_sp.py``, ``experiments/run.py``) on 8 gloo
CPU ranks, held against the JAX package on the faked 8-device mesh at
``tests/test_dp_sp.py``'s sizes and tolerances:

- ``make_dp_sp_round_fn`` on a (2, 4) ``(clients, sp)`` mesh, the lax ring
  and the flash ring, and with a participation mask, against JAX's
  ``make_dp_sp_round_fn`` and its single-device oracle (rtol 2e-4, atol
  2e-5; ``loss_sum`` rtol 1e-4), and against the port's own single-device
  round; every rank ends with the same bytes.  The gradient mean over
  ``sp`` is right only because ``compat.psum`` transposes to ``psum``: a
  wrong transpose would put every update off by a uniform factor of 4;
- ``run.main --algorithm fedllm --sp_degree 4`` on 8 ranks against JAX's
  ``run_experiment`` with the same config (``tests/test_experiments.py``):
  finite, within 1e-4, every rank the same history; its refusals.

One launch of 8 ranks serves the multi-rank cases.
"""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.fedavg import ServerState as JServerState
from fedml_tpu.algorithms.fedavg import make_round_fn as jmake_round_fn
from fedml_tpu.core.client import make_client_optimizer as jopt
from fedml_tpu.core.client import make_local_update as jmake_lu
from fedml_tpu.experiments.run import ExperimentConfig as JConfig
from fedml_tpu.experiments.run import run_experiment as jrun_experiment
from fedml_tpu.models.transformer import transformer_lm as jtransformer_lm
from fedml_tpu.parallel.dp_sp import make_dp_sp_mesh as jdp_sp_mesh
from fedml_tpu.parallel.dp_sp import make_dp_sp_round_fn as jdp_sp_round_fn
from fedml_tpu.parallel.ring_attention import blockwise_attention as jblockwise
from fedml_tpu_torch.experiments import run
from fedml_tpu_torch.models.convert import to_jax_variables
from fedml_tpu_torch.parallel.compat import launch, single_rank_group
from fedml_tpu_torch.parallel.dp_sp import make_dp_sp_mesh
from fedml_tpu_torch.parallel.dryrun import run_cases

V, E, H, NL, L = 32, 16, 2, 1, 32
C, S, B = 2, 2, 2
TOL = dict(rtol=2e-4, atol=2e-5)
# the two packages' histories after two rounds on the same data and weights
HIST_RTOL = 1e-4
LM = dict(vocab_size=V, embed_dim=E, num_heads=H, num_layers=NL, max_len=L)


def _data(seed=0, part=(1.0, 1.0)):
    r = np.random.RandomState(seed)
    x = r.randint(0, V, (C, S, B, L)).astype(np.int32)
    return (x, np.roll(x, -1, axis=-1), np.ones((C, S, B), np.float32),
            np.full((C,), S * B * L, np.float32), np.asarray(part, np.float32),
            np.arange(C, dtype=np.int32))


ROUNDS = {
    "lax": dict(attn_impl="lax", block_size=8, data=_data()),
    "flash": dict(attn_impl="flash", flash_block=8, data=_data()),
    "mask": dict(attn_impl="lax", block_size=8, data=_data(seed=1, part=(1.0, 0.0))),
}
CONFIG = dict(algorithm="fedllm", dataset="fed_shakespeare", comm_round=2,
              client_num_in_total=4, client_num_per_round=4, batch_size=4,
              embed_dim=32, num_heads=4, num_layers=1, lr=0.1, sp_degree=4)


def _argv(config):
    return [a for k, v in config.items() for a in (f"--{k}", str(v))]


@pytest.fixture(scope="module")
def ranks():
    cases = [("dp_sp", dict(device="cpu", **LM, mesh=(2, 4), lr=0.1, key=0, single=True,
                            oracle_block=512, **spec)) for spec in ROUNDS.values()]
    with tempfile.TemporaryDirectory() as run_dir:
        cases.append(("run_main", dict(argv=[*_argv(CONFIG), "--device", "cpu"],
                                       run_dir=run_dir)))
        return launch(run_cases, 8, cases, device="cpu", timeout=240.0)


def _jax_state():
    key = jax.random.PRNGKey(0)
    variables = jtransformer_lm(vocab_size=V, embed_dim=E, num_heads=H, num_layers=NL,
                                seq_len=L).init(key)
    return JServerState(variables=variables, opt_state=(),
                        round_idx=jnp.zeros((), jnp.int32), key=key)


def _jax_rounds(name):
    """JAX's DP×SP round on the (2, 4) faked mesh and its single-device
    oracle (``tests/test_dp_sp.py``), from the same state and block."""
    spec = ROUNDS[name]
    extra = ({"flash_block": 8, "flash_interpret": True} if spec["attn_impl"] == "flash"
             else {"block_size": 8})
    rf, shard_data, _ = jdp_sp_round_fn(
        jdp_sp_mesh(2, 4), **LM, optimizer=jopt("sgd", 0.1), epochs=1,
        attn_impl=spec["attn_impl"], donate=False, **extra)
    state = _jax_state()
    got = rf(state, *shard_data(spec["data"]))
    bundle = jtransformer_lm(vocab_size=V, embed_dim=E, num_heads=H, num_layers=NL,
                             seq_len=L, attn_fn=lambda q, k, v, causal: jblockwise(
                                 q, k, v, causal=causal, block_size=512))
    oracle = jax.jit(jmake_round_fn(jmake_lu(bundle, jopt("sgd", 0.1), 1),
                                    client_axis_impl="vmap"))
    return got, oracle(state, *[jnp.asarray(a) for a in spec["data"]])


def _flat(variables):
    return dict(jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(np.asarray, variables))[0])


def _assert_tree_close(port_vars, jax_vars, **tol):
    got = _flat(to_jax_variables({c: {k: torch.from_numpy(np.asarray(v))
                                      for k, v in d.items()}
                                  for c, d in port_vars.items()}))
    want = _flat(jax_vars)
    assert got.keys() == want.keys() and got
    for path, leaf in got.items():
        np.testing.assert_allclose(leaf, want[path], err_msg=str(path), **(tol or TOL))


@pytest.mark.parametrize("name", list(ROUNDS))
def test_dp_sp_round_matches_jax_and_its_oracle(ranks, name):
    i = list(ROUNDS).index(name)
    (jstate, jm), (ostate, om) = _jax_rounds(name)
    first = ranks[0][i]
    assert first["mesh"] == {"axes": {"clients": 2, "sp": 4}, "devices": 8,
                             "platform": "cpu"}
    assert first["round_idx"] == 1
    _assert_tree_close(first["variables"], jstate.variables)
    _assert_tree_close(first["variables"], ostate.variables)
    for got, want in ((first["metrics"], jm), (first["metrics"], om)):
        np.testing.assert_allclose(float(got["loss_sum"]), float(want["loss_sum"]),
                                   rtol=1e-4)
        assert float(got["count"]) == pytest.approx(float(want["count"]))
    if name == "mask":  # the masked-out client contributes nothing on either axis
        assert float(first["metrics"]["participants"]) == 1.0
    for r in ranks:
        for c, d in first["variables"].items():
            for k, v in d.items():
                np.testing.assert_array_equal(r[i]["variables"][c][k], v, err_msg=k)


@pytest.mark.parametrize("name", list(ROUNDS))
def test_dp_sp_round_matches_the_ports_single_device_round(ranks, name):
    i = list(ROUNDS).index(name)
    got, single = ranks[0][i], ranks[0][i]["single"]
    for c, d in single["variables"].items():
        for k, v in d.items():
            np.testing.assert_allclose(got["variables"][c][k], v, err_msg=k, **TOL)
    np.testing.assert_allclose(got["metrics"]["loss_sum"], single["metrics"]["loss_sum"],
                               rtol=1e-4)


@pytest.fixture(scope="module")
def jax_history():
    return jrun_experiment(JConfig(**CONFIG), log_fn=None)


@pytest.mark.parametrize("key", ["loss_sum", "correct", "count", "participants",
                                 "train_loss", "test_loss", "test_acc", "test_count"])
def test_run_main_sp_degree_matches_jax(ranks, jax_history, key):
    hist = ranks[0][-1]["history"]
    assert ranks[0][-1]["mesh"] == {"clients": 2, "sp": 4}
    assert len(hist) == len(jax_history["history"]) == 2
    for got, want in zip(hist, jax_history["history"]):
        assert np.isfinite(got[key])
        np.testing.assert_allclose(got[key], want[key], rtol=HIST_RTOL, err_msg=key)
    for r in ranks:
        assert r[-1]["history"] == hist


def test_run_main_sp_degree_refusals():
    """JAX's ValueErrors (tp and sp together, a degree that does not divide
    the ranks, for --tp_degree as for --sp_degree); --sp_degree outside
    fedllm refused; a mesh larger than the world."""
    small = ["--algorithm", "fedllm", "--dataset", "fed_shakespeare", "--ci", "1",
             "--device", "cpu", "--run_dir", tempfile.mkdtemp()]
    with pytest.raises(ValueError, match="tp_degree and sp_degree cannot both exceed 1"):
        run.main([*small, "--tp_degree", "2", "--sp_degree", "2"])
    with pytest.raises(ValueError, match="tp_degree and sp_degree cannot both exceed 1"):
        jrun_experiment(JConfig(**{**CONFIG, "comm_round": 1, "tp_degree": 2,
                                   "sp_degree": 2}), log_fn=None)
    with pytest.raises(ValueError, match="parallel degree 2 does not divide device count 1"):
        run.main([*small, "--tp_degree", "2"])
    with pytest.raises(ValueError, match="parallel degree 2 does not divide device count 1"):
        run.main([*small, "--sp_degree", "2"])
    with pytest.raises(ValueError, match="parallel degree 3 does not divide device count 8"):
        jrun_experiment(JConfig(**{**CONFIG, "sp_degree": 3}), log_fn=None)
    with pytest.raises(ValueError, match="--sp_degree shards fedllm"):
        run.main(["--algorithm", "fedavg", "--sp_degree", "2", "--device", "cpu"])
    with pytest.raises(ValueError, match=r"mesh 2x4 needs 8 devices, have 1"):
        with single_rank_group("cpu"):
            make_dp_sp_mesh(2, 4, device="cpu")
