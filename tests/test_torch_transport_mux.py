"""The port's muxer (``comm/mux.py`` + ``algorithms/fedavg_mux.py``) and
edge-hub tier (``comm/edge.py`` + ``algorithms/edge_hub.py``), the
counterparts of ``tests/test_mux.py:351`` and ``tests/test_edge_tree.py``:

- muxed uploads are byte for byte the one-process-per-client uploads
  (upload digests and final models equal), fp32 and int8 with error
  feedback;
- a two-edge tree federation is byte for byte the flat one;
- the float64 partial fold composes bitwise with the flat fold, and is
  JAX's fold bit for bit.

The muxer's cohort on a mesh of ranks is ``tests/test_torch_mux_mesh.py``'s.

Federations run as real processes on the CPU with one thread each, each
with its own timeout."""

import os

import numpy as np
import pytest

WAIT = 120.0


def _env():
    env = dict(os.environ)
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", FEDML_TPU_FORCE_CPU="1")
    return env


def _run(tmp_path, tag, **kw):
    from fedml_tpu_torch.experiments.distributed_fedavg import launch

    out = str(tmp_path / f"final_{tag}.npz")
    info = {}
    rc = launch(seed=0, batch_size=16, out_path=out, device="cpu", env=_env(),
                info=info, timeout=WAIT, **kw)
    assert rc == 0, f"{tag} federation failed (rc={rc})"
    z = np.load(out)
    leaves = [np.asarray(z[k]) for k in sorted(z.files) if k.startswith("leaf_")]
    digests = {k: v for k, v in sorted(info.items()) if k.endswith("_upload_digest")}
    return digests, leaves, info


@pytest.mark.parametrize("codec", ["none", "int8"])
def test_muxed_uploads_byte_identical_to_per_process(tmp_path, codec):
    """Same seed, same codec: one muxer process driving all three virtual
    clients uploads exactly the bytes three client processes upload, and
    the final global models are bit-equal."""
    dig_proc, leaves_proc, _ = _run(tmp_path, f"proc_{codec}", num_clients=3,
                                    rounds=2, codec=codec)
    dig_mux, leaves_mux, info = _run(tmp_path, f"mux_{codec}", num_clients=3,
                                     rounds=2, codec=codec, muxers=1)
    assert len(dig_proc) == 3 and dig_proc == dig_mux
    assert all(info[f"client_{i}_rounds_trained"] == 2 for i in (1, 2, 3))
    for a, b in zip(leaves_proc, leaves_mux):
        np.testing.assert_array_equal(a, b)


def _assert_tree_matches_flat(tmp_path, codec, muxers):
    base = dict(num_clients=6, rounds=2, codec=codec, muxers=muxers)
    dig_flat, leaves_flat, _ = _run(tmp_path, f"flat_{codec}", **base)
    dig_tree, leaves_tree, info = _run(tmp_path, f"tree_{codec}", topology="tree",
                                       edge_hubs=2, **base)
    assert len(dig_flat) == 6 and dig_flat == dig_tree
    for a, b in zip(leaves_flat, leaves_tree):
        np.testing.assert_array_equal(a, b)
    stats = [v for k, v in info.items() if k.startswith("edge_") and k.endswith("_stats")]
    assert len(stats) == 2
    for s in stats:
        assert s["folded_uploads"] == 6 and s["flat_fallbacks"] == 0


def test_tree_vs_flat_byte_identical(tmp_path):
    """Six int8+EF virtual clients on two muxers, flat against behind two
    edge hubs: upload digests and the final model are byte for byte equal,
    and both edges folded every upload of their cohort."""
    _assert_tree_matches_flat(tmp_path, "int8", 2)


@pytest.mark.slow
@pytest.mark.parametrize("codec,muxers", [("none", 2), ("int8", 0)])
def test_tree_vs_flat_byte_identical_cross(tmp_path, codec, muxers):
    """The other codec and process shapes of the tree-vs-flat pin (slow,
    as ``tests/test_edge_tree.py``'s cross pairs)."""
    _assert_tree_matches_flat(tmp_path, codec, muxers)


def _rand_tree(rng):
    return {"w": rng.standard_normal((5, 3)).astype(np.float32),
            "b": rng.standard_normal((3,)).astype(np.float32)}


def test_tiered_fold_composes_bitwise_and_matches_jax():
    """Edge partials folded at the root equal the flat fold bit for bit,
    for every split of the cohort, and the port's fold and mean are
    JAX's ``tree_fold_weighted``/``tree_finalize_weighted_mean`` bit for
    bit (``tests/test_edge_tree.py:54``'s algebra)."""
    from fedml_tpu.core import tree as jtree
    from fedml_tpu_torch.core import tree as ptree

    rng = np.random.default_rng(17)
    uploads = [(_rand_tree(rng), float(w)) for w in rng.integers(1, 90, size=12)]

    def fold(lib, pairs):
        acc, total = None, 0.0
        for t, w in pairs:
            acc = lib.tree_fold_weighted(acc, t, w)
            total += w
        return acc, total

    flat_acc, flat_n = fold(ptree, uploads)
    jax_acc, jax_n = fold(jtree, uploads)
    assert flat_n == jax_n
    for k in flat_acc:
        np.testing.assert_array_equal(np.asarray(flat_acc[k]), np.asarray(jax_acc[k]))
    flat_mean = ptree.tree_finalize_weighted_mean(flat_acc, flat_n, uploads[0][0])
    jax_mean = jtree.tree_finalize_weighted_mean(jax_acc, jax_n, uploads[0][0])
    for k in flat_mean:
        np.testing.assert_array_equal(np.asarray(flat_mean[k]), np.asarray(jax_mean[k]))
    for split in (1, 4, 7, 11):
        root_acc, root_n = None, 0.0
        for g in (uploads[:split], uploads[split:]):
            part_acc, part_n = fold(ptree, g)
            root_acc = ptree.tree_fold_weighted(root_acc, part_acc, 1.0)
            root_n += part_n
        assert root_n == flat_n
        for k in flat_acc:
            np.testing.assert_array_equal(np.asarray(root_acc[k]), np.asarray(flat_acc[k]))
        tree_mean = ptree.tree_finalize_weighted_mean(root_acc, root_n, uploads[0][0])
        for k in flat_mean:
            np.testing.assert_array_equal(np.asarray(tree_mean[k]), np.asarray(flat_mean[k]))
