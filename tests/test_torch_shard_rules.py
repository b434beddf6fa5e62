"""The port's partition-rule engine and per-shard wire encode
(``fedml_tpu_torch/parallel/partition.py``, ``compress/sharded.py``) held
against the JAX package (``tests/test_shard_rules.py``):

- in process, every rule-table case of JAX's tests: the specs and the
  messages equal JAX's; ``match_partition_rules`` on the port's variables
  equal to JAX's on the flax tree, leaf by leaf, for ``FEDLLM_RULES`` on the
  transformer and ``RESNET_RULES`` on ResNet-20, and ``rule_coverage``
  likewise; ``server_state_sharding``'s and ``cohort_shardings``' layouts;
- the digest matrix on gloo CPU ranks: 16 clients, 2 rounds, fp32 and
  int8 + EF, the cohort in a shuffled slot order (so that EF rows cross
  ``dp`` ranks both ways): the rule engine's final model has one sha256 at
  ``dp`` 1, 2 and 8 (``mp`` 1), at ``dp`` 2 x ``mp`` 2 and at ``dp`` 1 x
  ``mp`` 4, equal to the port's ``make_round_fn`` on one device, and so
  does its residual store; it is within 1e-5 of JAX's single-device
  engine at the same seed;
- ``exact_aggregation=False`` on the 2 x 2 mesh within 1e-5 of it;
- the per-shard wire bytes on a ``dp`` 2 x ``mp`` 2 mesh, int8 and int4:
  every entry equal byte for byte to JAX's ``wire_encode_tree_sharded`` on
  a 2 x 2 JAX mesh of the same tree and key, ``sharded_wire_digest``
  equal, each element visited once, at least one leaf split, the decode
  equal to JAX's.

One launch of 8 ranks serves the multi-rank cases (a cell's mesh spans the
first dp*mp ranks).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from fedml_tpu.algorithms.fedavg import ServerState as JServerState
from fedml_tpu.algorithms.fedavg import make_round_fn as jmake_round_fn
from fedml_tpu.compress import get_codec as jget_codec
from fedml_tpu.compress.sharded import sharded_wire_digest as jsharded_wire_digest
from fedml_tpu.compress.sharded import wire_decode_tree_sharded as jwire_decode
from fedml_tpu.compress.sharded import wire_encode_tree_sharded as jwire_encode
from fedml_tpu.core.client import make_client_optimizer as jopt
from fedml_tpu.core.client import make_local_update as jmake_lu
from fedml_tpu.models.resnet import resnet20 as jresnet20
from fedml_tpu.models.transformer import transformer_lm as jtransformer_lm
from fedml_tpu.parallel import partition as jpart
from fedml_tpu.parallel.mesh import make_dp_mp_mesh as jdp_mp_mesh
from fedml_tpu_torch.algorithms.fedavg import ServerState, make_round_fn
from fedml_tpu_torch.compress import get_codec, sharded_wire_digest
from fedml_tpu_torch.core.client import make_client_optimizer, make_local_update
from fedml_tpu_torch.core.rng import PRNGKey
from fedml_tpu_torch.models.resnet import resnet20
from fedml_tpu_torch.models.transformer import transformer_lm
from fedml_tpu_torch.parallel import partition as part
from fedml_tpu_torch.parallel.compat import launch, single_rank_group
from fedml_tpu_torch.parallel.dryrun import _digest, run_cases
from fedml_tpu_torch.parallel.layout import Placement
from fedml_tpu_torch.parallel.mesh import make_dp_mp_mesh

LM = dict(vocab_size=64, embed_dim=32, num_heads=2, num_layers=1, seq_len=16)
CLIENTS, ROUNDS, LR, SEED = 16, 2, 0.1, 0
CELLS = [(1, 1), (2, 1), (8, 1), (2, 2), (1, 4)]
CODECS = {"fp32": ("", 0), "int8_ef": ("int8", 1)}


# --- rule-table semantics, in process ----------------------------------------

def _tree():
    return {
        "params": {
            "Dense_0": {"kernel": np.zeros((4, 8), np.float32),
                        "bias": np.zeros((8,), np.float32)},
            "LayerNorm_0": {"scale": np.zeros((8,), np.float32)},
            "step": np.zeros((), np.int32),
        }
    }


def _flat_specs(specs):
    """A port spec tree (tuples) or a JAX one (PartitionSpecs) by flax path."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + tuple(str(k).split(".")))
        else:
            out[path] = tuple(node)

    walk(specs, ())
    return out


def _raises_same(port_call, jax_call):
    with pytest.raises(ValueError) as want:
        jax_call()
    with pytest.raises(ValueError) as got:
        port_call()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("order", ["specific_first", "generic_first"])
def test_first_match_wins_ordering(order):
    rules = ((r"Dense_0/kernel", ("mp", None)), (r"kernel", (None, "mp")))
    if order == "generic_first":
        rules = rules[::-1]
    got = part.match_partition_rules(part.RuleTable("t", rules), _tree())
    want = jpart.match_partition_rules(jpart.RuleTable("t", rules), _tree())
    assert _flat_specs(got) == _flat_specs(want)
    assert got["params"]["Dense_0"]["kernel"] == (("mp", None) if order == "specific_first"
                                                  else (None, "mp"))


def test_unmatched_policy_replicate_vs_raise():
    rules = ((r"kernel", (None, "mp")),)
    got = part.match_partition_rules(part.RuleTable("t", rules), _tree())
    assert got["params"]["LayerNorm_0"]["scale"] == ()
    assert _flat_specs(got) == _flat_specs(
        jpart.match_partition_rules(jpart.RuleTable("t", rules), _tree()))
    _raises_same(
        lambda: part.match_partition_rules(
            part.RuleTable("t", rules, unmatched=part.UNMATCHED_RAISE), _tree()),
        lambda: jpart.match_partition_rules(
            jpart.RuleTable("t", rules, unmatched=jpart.UNMATCHED_RAISE), _tree()))


def test_scalars_always_replicate_even_under_raise():
    tree = {"step": np.zeros((), np.int32)}
    got = part.match_partition_rules(
        part.RuleTable("t", ((r".", (None,)),), unmatched=part.UNMATCHED_RAISE), tree)
    want = jpart.match_partition_rules(
        jpart.RuleTable("t", ((r".", (None,)),), unmatched=jpart.UNMATCHED_RAISE), tree)
    assert got["step"] == () == tuple(want["step"])


def test_overlong_spec_is_a_table_bug():
    rules = ((r"bias", (None, "mp")),)
    _raises_same(lambda: part.match_partition_rules(part.RuleTable("t", rules), _tree()),
                 lambda: jpart.match_partition_rules(jpart.RuleTable("t", rules), _tree()))


@pytest.mark.parametrize("sizes", [{"dp": 1, "mp": 3}, {"dp": 1}, {"dp": 1, "mp": 2}])
def test_validate_divisibility_names_leaf_dim_axis(sizes):
    rules = ((r"Dense_0/kernel", (None, "mp")),)
    got_specs = part.match_partition_rules(part.RuleTable("t", rules), _tree())
    want_specs = jpart.match_partition_rules(jpart.RuleTable("t", rules), _tree())
    if sizes.get("mp") == 2:  # clean
        part.validate_divisibility(_tree(), got_specs, sizes)
        jpart.validate_divisibility(_tree(), want_specs, sizes)
        return
    _raises_same(lambda: part.validate_divisibility(_tree(), got_specs, sizes),
                 lambda: jpart.validate_divisibility(_tree(), want_specs, sizes))


def test_resolve_rules_canonical_json_and_errors(tmp_path):
    assert part.resolve_rules("fedllm") is part.FEDLLM_RULES
    assert part.resolve_rules("resnet") is part.RESNET_RULES
    assert part.FEDLLM_RULES.rules == jpart.FEDLLM_RULES.rules
    assert part.RESNET_RULES.rules == jpart.RESNET_RULES.rules
    doc = {"_unmatched": "raise", "rules": [["Dense_\\d+/kernel", [None, "mp"]]]}
    p = tmp_path / "custom.json"
    p.write_text(json.dumps(doc))
    table = part.resolve_rules(str(p))
    assert table == tuple(jpart.resolve_rules(str(p)))
    assert table.unmatched == part.UNMATCHED_RAISE
    assert table.rules == (("Dense_\\d+/kernel", (None, "mp")),)
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"_unmatched": "explode", "rules": []}))
    for arg in ("no_such_table", str(bad)):
        _raises_same(lambda: part.resolve_rules(arg), lambda: jpart.resolve_rules(arg))
    badre = tmp_path / "badre.json"
    badre.write_text(json.dumps({"rules": [["([unclosed", [None]]]}))
    with pytest.raises(Exception):  # re.error at load, not first match
        part.resolve_rules(str(badre))


def _port_and_jax(model):
    if model == "transformer":
        port = transformer_lm(vocab_size=64, embed_dim=32, num_heads=2, num_layers=2,
                              seq_len=16, device="cpu").init(PRNGKey(0))
        want = jtransformer_lm(vocab_size=64, embed_dim=32, num_heads=2, num_layers=2,
                               seq_len=16).init(jax.random.PRNGKey(0))
        return port, want, "fedllm"
    return (resnet20(num_classes=10, device="cpu").init(PRNGKey(0)),
            jresnet20(num_classes=10).init(jax.random.PRNGKey(0)), "resnet")


@pytest.mark.parametrize("model", ["transformer", "resnet20"])
def test_match_and_coverage_equal_jax_leaf_by_leaf(model):
    port, want, name = _port_and_jax(model)
    got_specs = _flat_specs(part.match_partition_rules(part.resolve_rules(name), port))
    want_specs = {tuple(p.key for p in path): tuple(spec) for path, spec in
                  jax.tree_util.tree_flatten_with_path(
                      jpart.match_partition_rules(jpart.resolve_rules(name), want),
                      is_leaf=lambda x: isinstance(x, P))[0]}
    assert got_specs == want_specs and len(got_specs) > 10
    cov = part.rule_coverage(part.resolve_rules(name), port)
    assert cov == jpart.rule_coverage(jpart.resolve_rules(name), want)
    assert cov["unmatched_paths"] == [] and cov["leaves_sharded"] > 0
    assert all(r["leaves"] > 0 for r in cov["rules"]), cov["rules"]
    strict = part.resolve_rules(name)._replace(unmatched=part.UNMATCHED_RAISE)
    part.match_partition_rules(strict, port)


def test_server_state_and_cohort_layouts():
    port, _, _ = _port_and_jax("transformer")
    with single_rank_group("cpu"):
        mesh = make_dp_mp_mesh(1, 1, device="cpu")
        placements, specs = part.server_state_sharding(mesh, port, part.FEDLLM_RULES,
                                                       error_feedback=True)
        qkv = "Block_0.MultiHeadAttention_0.Dense_0.kernel"
        assert specs["params"][qkv] == (None, "mp")
        assert placements.variables["params"][qkv] == Placement(mesh, (None, "mp"))
        assert placements.residuals["params"][qkv].spec == ("dp", None, "mp")
        assert placements.opt_state.spec == () and placements.key.spec == ()
        var_in, data, var_out, stacked = part.cohort_shardings(mesh, port, part.FEDLLM_RULES)
        assert var_in["params"]["wte.embedding"].spec == ("mp", None)
        assert data.spec == stacked.spec == ("dp",)
        assert var_out["params"]["wte.embedding"].spec == ("dp", "mp", None)
        assert part.jit_sharded(len, in_shardings=var_in) is len


# --- the digest matrix and the per-shard wire bytes, on 8 ranks ---------------

def _synthetic():
    """``tools/fed_shard_run.py``'s federation (x [K, 2, 2, 16] tokens,
    next-token targets), its cohort in a shuffled slot order."""
    rng = np.random.default_rng(SEED)
    toks = rng.integers(0, LM["vocab_size"], size=(CLIENTS, 2, 2, LM["seq_len"] + 1),
                        dtype=np.int64)
    return (toks[..., :-1].astype(np.int32), toks[..., 1:].astype(np.int32),
            np.ones((CLIENTS, 2, 2), np.float32), np.full((CLIENTS,), 4, np.float32),
            np.ones((CLIENTS,), np.float32),
            np.random.RandomState(SEED).permutation(CLIENTS).astype(np.int32))


DATA = _synthetic()


def _cell_cases():
    return [("rules", dict(device="cpu", **LM, mesh=cell, lr=LR, seed=SEED, codec=codec,
                           ef=ef, rounds=ROUNDS, data=DATA))
            for codec, ef in CODECS.values() for cell in CELLS]


def _reassociated_cases():
    """The (2, 2) cell with ``exact_aggregation=False``: each rank folds its
    own clients and the partial sums are psum'd over dp."""
    return [("rules", dict(device="cpu", **LM, mesh=(2, 2), lr=LR, seed=SEED, codec=codec,
                           ef=ef, rounds=ROUNDS, data=DATA, exact=False))
            for codec, ef in CODECS.values()]


@pytest.fixture(scope="module")
def ranks():
    cases = _cell_cases() + [("wire", dict(device="cpu", **LM, mesh=(2, 2), seed=SEED,
                                           codecs=["int8", "int4"]))] + _reassociated_cases()
    return launch(run_cases, 8, cases, device="cpu", timeout=300.0)


def _single(codec, ef):
    """The port's ``make_round_fn`` on one device over the same rounds."""
    bundle = transformer_lm(**LM, device="cpu")
    lu = make_local_update(bundle, make_client_optimizer("sgd", LR), epochs=1)
    variables = bundle.init(PRNGKey(0))
    residuals = ({c: {k: torch.zeros((CLIENTS, *v.shape)) for k, v in sub.items()}
                  for c, sub in variables.items()} if ef else ())
    state = ServerState(variables, (), 0, PRNGKey(SEED), residuals)
    fn = make_round_fn(lu, device="cpu", codec=get_codec(codec or None), error_feedback=bool(ef))
    for _ in range(ROUNDS):
        state, _ = fn(state, *(torch.from_numpy(a) for a in DATA[:5]), DATA[5])
    return state


def _jax_single(codec, ef):
    bundle = jtransformer_lm(**LM)
    lu = jmake_lu(bundle, jopt("sgd", LR), epochs=1)
    variables = bundle.init(jax.random.PRNGKey(0))
    residuals = (jax.tree_util.tree_map(lambda l: jnp.zeros((CLIENTS,) + l.shape), variables)
                 if ef else ())
    state = JServerState(variables=variables, opt_state=(), round_idx=jnp.zeros((), jnp.int32),
                         key=jax.random.PRNGKey(SEED), residuals=residuals)
    fn = jax.jit(jmake_round_fn(lu, client_axis_impl="vmap", codec=jget_codec(codec or None),
                                error_feedback=bool(ef)))
    for _ in range(ROUNDS):
        state, _ = fn(state, *[jnp.asarray(a) for a in DATA])
    return state


@pytest.mark.parametrize("name", list(CODECS))
def test_rule_engine_digest_matrix_equals_the_one_device_round(ranks, name):
    codec, ef = CODECS[name]
    i0 = list(CODECS).index(name) * len(CELLS)
    single = _single(codec, ef)
    want = _digest(single.variables)
    for j, (dp, mp) in enumerate(CELLS):
        members = [r[i0 + j] for r in ranks if r[i0 + j]["member"]]
        assert len(members) == dp * mp
        assert members[0]["mesh"]["axes"] == {"dp": dp, "mp": mp}
        for cell in members:
            assert cell["digest"] == want, (dp, mp)
            if ef:
                assert cell["residual_digest"] == _digest(single.residuals), (dp, mp)
            assert all(np.isfinite(float(m["loss_sum"])) for m in cell["metrics"])


def test_rule_engine_residual_store_holds_only_the_rank_s_share(ranks):
    """Under EF each rank makes and keeps only its share of the residual
    store: ``CLIENTS / dp`` rows of each leaf, its block along ``mp`` where
    the table splits the leaf."""
    variables = transformer_lm(**LM, device="cpu").init(PRNGKey(0))
    specs = part.match_partition_rules(part.FEDLLM_RULES, variables)
    i0 = list(CODECS).index("int8_ef") * len(CELLS)
    for j, (dp, mp) in enumerate(CELLS):
        share = sum(CLIENTS * v.numel() * v.element_size() // (
            dp * (mp if "mp" in specs[c][k] else 1)) for c, sub in variables.items()
            for k, v in sub.items())
        members = [r[i0 + j] for r in ranks if r[i0 + j]["member"]]
        assert len(members) == dp * mp
        for cell in members:
            assert cell["store_bytes"] == {"made": share, "after": share}, (dp, mp)


@pytest.mark.parametrize("name", list(CODECS))
def test_rule_engine_round_within_1e5_of_jax_single_device(ranks, name):
    codec, ef = CODECS[name]
    got = ranks[0][list(CODECS).index(name) * len(CELLS) + CELLS.index((2, 2))]["variables"]
    want = _jax_single(codec, ef).variables
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        c, *names = (p.key for p in path)
        diff = np.abs(np.asarray(got[c][".".join(names)]) - np.asarray(leaf))
        assert diff.max() <= 1e-5, path


def _jax_wire(codec):
    variables = jtransformer_lm(**LM).init(jax.random.PRNGKey(0))
    sharded, _ = jpart.shard_by_rules(jdp_mp_mesh(2, 2), variables, jpart.FEDLLM_RULES)
    c = jget_codec(codec)
    entries = jwire_encode(c, sharded, jax.random.PRNGKey(SEED))
    return entries, jwire_decode(c, entries, variables)


@pytest.mark.parametrize("codec", ["int8", "int4"])
def test_per_shard_wire_bytes_equal_jax(ranks, codec):
    want, want_dec = _jax_wire(codec)
    wire = len(CODECS) * len(CELLS)
    members = [r[wire] for r in ranks if r[wire]["member"]]
    assert len(members) == 4
    split = 0
    for res in members:
        got = res[codec]["entries"]
        assert sharded_wire_digest(got) == jsharded_wire_digest(want)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g["shape"] == w["shape"] and g["dtype"] == w["dtype"]
            assert len(g["shards"]) == len(w["shards"])
            elems = 0
            for gs, ws in zip(g["shards"], w["shards"]):
                assert gs["index"] == ws["index"] and gs["shape"] == ws["shape"]
                assert sorted(gs["enc"]) == sorted(ws["enc"])
                for k in ws["enc"]:
                    a, b = np.asarray(gs["enc"][k]), np.asarray(ws["enc"][k])
                    assert a.dtype == b.dtype and a.shape == b.shape
                    assert a.tobytes() == b.tobytes()
                elems += int(np.prod(gs["shape"]))
            assert elems == int(np.prod(g["shape"]))  # each element visited once
            split += len(g["shards"]) > 1
        dec = res[codec]["decoded"]
        for path, leaf in jax.tree_util.tree_flatten_with_path(want_dec)[0]:
            c, *names = (p.key for p in path)
            np.testing.assert_array_equal(dec[c][".".join(names)], np.asarray(leaf))
    assert split > 0  # the mesh really split leaves


@pytest.mark.parametrize("name", list(CODECS))
def test_rule_engine_reassociated_aggregation_within_1e5(ranks, name):
    """``exact_aggregation=False`` reassociates the cross-client sum (and,
    under EF, the residual rows stay exact): within 1e-5 of the one-device
    round, every rank the same model."""
    codec, ef = CODECS[name]
    i = len(CODECS) * len(CELLS) + 1 + list(CODECS).index(name)
    single = _single(codec, ef)
    members = [r[i] for r in ranks if r[i]["member"]]
    assert len(members) == 4 and len({m["digest"] for m in members}) == 1
    for c, sub in single.variables.items():
        for k, v in sub.items():
            np.testing.assert_allclose(members[0]["variables"][c][k], v.numpy(), rtol=0,
                                       atol=1e-5, err_msg=k)
