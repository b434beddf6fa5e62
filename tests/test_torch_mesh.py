"""The port's mesh substrate (``fedml_tpu_torch/parallel/{compat,mesh}.py``)
and item-9 leftovers, held against the JAX package:

- ``parse_mesh_spec`` on every form and every error of JAX's
  (``fedml_tpu/parallel/mesh.py``), result or message equal;
- the host-local assembly's refusals (JAX's ValueErrors);
- the meshes on 8 gloo CPU ranks: ``make_client_mesh``'s reserved
  ``model`` axis (``tests/test_spmd.py:109``), ``mesh_from_spec``, the
  group mesh, ``describe_mesh`` (``platform`` ``cpu``), a mesh larger than
  the world refused with the launch hint; the collectives (``psum`` over
  one axis, over a tuple and of a constant, ``all_gather`` tiled and
  stacked, ``ppermute`` as a ring and with ranks left out, ``axis_index``)
  against their definitions;
- the collectives' backward on 4 gloo ranks against JAX's transposes
  written out by hand (``psum``'s is ``psum``, ``ppermute``'s the inverse
  permutation, zeros for a rank that sends nowhere), and their forward
  bytes the same with and without autograd;
- the launcher: a rank that raises fails the launch with its traceback,
  a rank that hangs fails it at the deadline;
- ``tree_size`` against JAX's;
- ``FedDataset.subset_for_clients``: the subset's pack byte for byte the
  full set's rows for the same clients.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fedml_tpu.core.tree import tree_size as jtree_size
from fedml_tpu.models.linear import logistic_regression as jlr
from fedml_tpu.models.resnet import resnet20 as jresnet20
from fedml_tpu.parallel import mesh as jmesh
from fedml_tpu_torch.core.rng import PRNGKey
from fedml_tpu_torch.core.tree import tree_size
from fedml_tpu_torch.core.types import pack_clients
from fedml_tpu_torch.data.synthetic import synthetic_classification
from fedml_tpu_torch.models.linear import logistic_regression
from fedml_tpu_torch.models.resnet import resnet20
from fedml_tpu_torch.parallel import mesh
from fedml_tpu_torch.parallel.compat import launch, single_rank_group
from fedml_tpu_torch.parallel.dryrun import run_cases

SPECS = [
    ("8,1", 8), ("dp=2,mp=4", 8), ("mp=4,dp=2", 8), ("auto,2", 8), ("-1,2", 8),
    ("2,auto", 8), ("dp=auto,mp=1", 8), (" 4 , 2 ", 8), ("4,2,", 8), ("2,-1", 6),
    ("2", 8), ("0,2", 8), ("a,b", 8), ("auto,auto", 8), ("dp=2,dp=2", 8),
    ("auto,3", 8), ("4,2,1", 8), ("dp=2,xx=4", 8), ("2,dp=4", 8), ("-2,2", 8),
    ("2,0", 8), ("auto,0", 8), ("", 8), ("dp=,mp=2", 8),
]


def _outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("spec,count", SPECS, ids=[repr(s) for s, _ in SPECS])
def test_parse_mesh_spec_is_jaxs(spec, count):
    got = _outcome(mesh.parse_mesh_spec, spec, device_count=count)
    assert got == _outcome(jmesh.parse_mesh_spec, spec, device_count=count)


def test_parse_mesh_spec_defaults_to_the_world():
    """``device_count=None`` is the process group's size: 1 outside one."""
    assert mesh.parse_mesh_spec("auto,1") == (1, 1)
    with pytest.raises(ValueError, match="not divisible by fixed axis 2"):
        mesh.parse_mesh_spec("auto,2")
    with single_rank_group("cpu"):
        assert mesh.parse_mesh_spec("-1,1") == (1, 1)
        one = mesh.mesh_from_spec("1,1", device="cpu")
        assert mesh.describe_mesh(one) == {"axes": {"dp": 1, "mp": 1}, "devices": 1,
                                           "platform": "cpu"}
        with pytest.raises(ValueError, match="needs 2 devices, have 1 .*launch one rank"):
            mesh.make_dp_mp_mesh(2, 1, device="cpu")


@pytest.fixture(scope="module")
def ranks():
    return launch(run_cases, 8, [("mesh", {"device": "cpu"})], device="cpu",
                  timeout=180.0)


def test_client_mesh_reserves_model_axis(ranks):
    for r, (got,) in enumerate(ranks):
        assert got["client"] == {"axes": {"clients": 4, "model": 2}, "devices": 8,
                                 "platform": "cpu"}
        clients, model, flat, n, both = got["index"]
        assert (clients, model, flat, n, both) == (r // 2, r % 2, r, 4, 8)


def test_mesh_constructors_and_describe(ranks):
    for got, in ranks:
        assert got["dp_mp"] == {"axes": {"dp": 4, "mp": 2}, "devices": 8,
                                "platform": "cpu"}
        assert got["group"] == {"axes": {"group": 2, "clients": 4}, "devices": 8,
                                "platform": "cpu"}
        assert got["too_many"].startswith("mesh 8x2 needs 16 devices, have 8")
        assert mesh.HOST_MESH_HINT in got["too_many"]


def test_host_local_assembly_refusals(ranks):
    """JAX's ValueErrors of ``host_client_range`` (slots not divisible by the
    clients axis, a host's ranks not contiguous along it) and of
    ``shard_client_block_local`` (no range supplied, a range off the
    per-rank block); a rank whose block no supplied range covers refused
    too; a host with no rank in the mesh owns ``range(0)``."""
    for r, (got,) in enumerate(ranks):
        divisible, contiguous, empty, aligned, covers = got["refusals"]
        assert divisible == "6 slots not divisible by clients axis 4"
        assert contiguous.startswith("host's devices are not contiguous along the clients axis")
        assert empty.startswith("no slot ranges supplied")
        assert aligned == "range [1, 3) is not aligned to the per-device block of 2 slots"
        # rows 0-1 cover clients block 0 only: ranks 0 and 1 take theirs
        assert (covers is None) == (r < 2)
        if r >= 2:
            assert covers.startswith("no supplied range covers this rank's slots")
        assert got["no_range"]


def test_collectives_over_named_axes(ranks):
    for r, (got,) in enumerate(ranks):
        model = r % 2
        column = [float(c * 2 + model) for c in range(4)]  # this rank's clients axis
        assert got["psum"]["r"].tolist() == [sum(column)]
        assert [p.tolist() for p in got["psum"]["pair"]] == [[sum(column)],
                                                            [2 * sum(column)]]
        assert got["psum_both"].tolist() == [float(sum(range(8)))]
        assert got["psum_const"] == 4
        assert got["tiled"].tolist() == column
        assert got["stacked"].tolist() == [[c] for c in column]
        i = r // 2
        assert got["shift"].tolist() == [column[(i - 1) % 4]]
        # only position 0 sends, to position 1: the others receive zeros
        assert got["partial"].tolist() == [column[0] if i == 1 else 0.0]


@pytest.fixture(scope="module")
def grad_ranks():
    return launch(run_cases, 4, [("grads", {"device": "cpu"})], device="cpu",
                  timeout=120.0)


@pytest.mark.parametrize("name", ["psum", "ring", "partial"])
def test_collective_gradients_are_jaxs_transposes(grad_ranks, name):
    """Rank r computes ``Σ c_r · coll(w_r x_r)`` with ``w_r = r + 1``, ``c_r =
    r + 10``; the gradient with respect to its ``x_r`` is ``w_r`` times the
    transposed collective applied to the cotangents ``c``: their psum, or
    the ``c`` of the rank its ``x_r`` went to (0 if it went nowhere)."""
    n = len(grad_ranks)
    c = [r + 10 for r in range(n)]
    dest = {"ring": {r: (r + 1) % n for r in range(n)}, "partial": {0: 1, 1: 3},
            "psum": {}}[name]
    for r, (got,) in enumerate(grad_ranks):
        ct = sum(c) if name == "psum" else (c[dest[r]] if r in dest else 0.0)
        np.testing.assert_array_equal(got[name]["grad"], np.full(3, (r + 1) * ct,
                                                                 np.float32))
        assert got[name]["same_forward"]


def test_launcher_fails_on_a_failing_or_hung_rank():
    """Rank bodies are pickled by import path (builtins here): a result per
    rank; a body that raises fails the launch with the rank's traceback;
    ranks that outlive the deadline fail it with a TimeoutError."""
    assert launch(abs, 2, -3, device="cpu", timeout=60.0) == [3, 3]
    with pytest.raises(RuntimeError, match="rank 0 of 2 failed:(.|\n)*KeyError: 'nope'"):
        launch(run_cases, 2, [("nope", {})], device="cpu", timeout=60.0)
    with pytest.raises(TimeoutError, match=r"ranks \[0, 1\] never reported"):
        launch(time.sleep, 2, 60, device="cpu", timeout=8.0)


def test_tree_size_is_jaxs():
    key = PRNGKey(0)
    for port, jax_bundle in ((logistic_regression(12, 4, device="cpu"), jlr(12, 4)),
                             (resnet20(num_classes=4, image_size=8, device="cpu"),
                              jresnet20(num_classes=4, image_size=8))):
        variables = port.init(key)
        assert tree_size(variables) == jtree_size(jax_bundle.init(jax.random.PRNGKey(0)))
        assert tree_size(variables) == sum(t.numel() for c in variables.values()
                                           for t in c.values())
    assert tree_size({"a": np.zeros((2, 3)), "b": {"c": jnp.zeros(5)}}) == 11
    assert tree_size({}) == 0


def test_subset_pack_equals_the_full_sets_rows():
    ds = synthetic_classification(num_train=800, num_test=100, input_shape=(12,),
                                  num_classes=4, num_clients=8, partition="hetero",
                                  partition_alpha=0.5, seed=0)
    full = pack_clients(ds, list(range(8)), batch_size=16, seed=0)
    for ids in ([4, 5, 6, 7], [1, 6], []):
        sub = ds.subset_for_clients(ids)
        assert sorted(sub.train_client_idx) == sorted(ids)
        if ids:
            local = pack_clients(sub, ids, batch_size=16, seed=0,
                                 steps_per_epoch=full.x.shape[1])
            for a, b in ((local.x, full.x), (local.y, full.y), (local.mask, full.mask),
                         (local.num_samples, full.num_samples)):
                np.testing.assert_array_equal(a, b[ids])
    with pytest.raises(KeyError, match="clients not in dataset"):
        ds.subset_for_clients([8])
