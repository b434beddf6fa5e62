"""Vertical FL (``fedml_tpu_torch/algorithms/vfl.py``, ``models/finance.py``,
``data/tabular.py``) held against the JAX package on the CPU, on the same
numpy data and seeds.

- The party branches' inits (``fold_in(key, i)``) equal flax's bit for bit.
- The guest's common gradient ``dU`` and the party states after 5 steps
  (params and momentum traces) within 1e-5.
- ``binary_auc`` with tied scores equals JAX's.
- The tabular loaders' arrays equal JAX's bit for bit: the stand-ins, a
  UCI csv, a ``loan_processed.npz``, a small raw ``loan.csv`` and a raw
  NUS-WIDE tree.
- ``run.main --algorithm vfl`` on the 512 x 24 stand-in: equal accuracy,
  AUC within 1e-6.
"""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms import vfl as jvfl
from fedml_tpu.data import tabular as jtab
from fedml_tpu.experiments import run as jrun
from fedml_tpu.models.finance import vfl_party as jparty
from fedml_tpu_torch.algorithms import vfl
from fedml_tpu_torch.core import rng
from fedml_tpu_torch.data import tabular
from fedml_tpu_torch.experiments import run
from fedml_tpu_torch.models.convert import to_jax_variables
from fedml_tpu_torch.models.finance import vfl_party

TOL = {"rtol": 1e-5, "atol": 1e-5}
DIMS = (6, 4, 5)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_params_close(tparams, jparams, tol=TOL, exact=False):
    flat_t = _flat(to_jax_variables({"p": tparams})["p"])
    flat_j = _flat(jparams)
    assert sorted(flat_t) == sorted(flat_j) and flat_j
    for path, leaf in flat_j.items():
        if exact:
            np.testing.assert_array_equal(flat_t[path], leaf, err_msg=path)
        else:
            np.testing.assert_allclose(flat_t[path], leaf, err_msg=path, **tol)


def _vertical(n=64, seed=0):
    r = np.random.RandomState(seed)
    xs = [r.randn(n, d).astype(np.float32) for d in DIMS]
    score = sum(x @ r.randn(d) for x, d in zip(xs, DIMS))
    return xs, (score > 0).astype(np.int32)


def _federations(**kw):
    jfed = jvfl.VerticalFederation([jparty(d, 5, use_bias=i == 0) for i, d in enumerate(DIMS)],
                                   **kw)
    tfed = vfl.VerticalFederation(
        [vfl_party(d, 5, use_bias=i == 0, device="cpu") for i, d in enumerate(DIMS)],
        device="cpu", **kw)
    return jfed, tfed


def test_party_inits_match_flax():
    jfed, tfed = _federations()
    tstates = tfed.init(rng.PRNGKey(3))
    for js, ts in zip(jfed.init(jax.random.PRNGKey(3)), tstates):
        _assert_params_close(ts.params, js.params, exact=True)
    # the guest's head has a bias, the hosts' do not
    assert [("VFLClassifier_0.Dense_0.bias" in ts.params) for ts in tstates] == [
        True, False, False]


def test_common_gradient_and_five_steps_match_jax():
    jfed, tfed = _federations(lr=0.1)
    xs, y = _vertical()
    jstates, tstates = jfed.init(jax.random.PRNGKey(0)), tfed.init(rng.PRNGKey(0))
    # the guest's dU on the first batch
    U = sum(b.module.apply({"params": st.params}, jnp.asarray(x[:16]), train=True)
            for b, st, x in zip(jfed.bundles, jstates, xs))
    want_du = jax.grad(jvfl.bce_with_logits)(U, jnp.asarray(y[:16]))
    _, du, _ = tfed.common_gradient(tstates, [torch.from_numpy(x[:16]) for x in xs],
                                    torch.from_numpy(y[:16]))
    assert du.shape == (16, 1)
    np.testing.assert_allclose(du.numpy(), np.asarray(want_du), **TOL)
    for lo in range(0, 80, 16):
        sl = slice(lo % 64, lo % 64 + 16)
        jstates, jloss = jfed.fit(jstates, [jnp.asarray(x[sl]) for x in xs], jnp.asarray(y[sl]))
        tstates, tloss = tfed.fit(tstates, [torch.from_numpy(x[sl]) for x in xs],
                                  torch.from_numpy(y[sl]))
        np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    for js, ts in zip(jstates, tstates):
        _assert_params_close(ts.params, js.params)
        # (add_decayed_weights (), sgd's (trace, scale)) in both packages
        _assert_params_close(ts.opt_state[1][0]["trace"], js.opt_state[1][0].trace)
    xt = [x[:32] for x in xs]
    np.testing.assert_allclose(
        tfed.predict(tstates, [torch.from_numpy(x) for x in xt]).numpy(),
        np.asarray(jfed.predict(jstates, [jnp.asarray(x) for x in xt])), **TOL)


def test_binary_auc_with_ties_equals_jax():
    r = np.random.RandomState(1)
    y = r.randint(0, 2, 200)
    score = np.round(r.rand(200), 1)  # 11 distinct values: many ties
    assert vfl.binary_auc(y, score) == jvfl.binary_auc(y, score)
    assert vfl.binary_auc(np.array([1, 0, 1, 0]), np.array([0.5, 0.5, 0.9, 0.1])) == 0.875
    assert np.isnan(vfl.binary_auc(np.ones(3), np.arange(3.0)))


def _assert_same_table(got, want):
    (x, y, splits), (jx, jy, jsplits) = got, want
    assert x.dtype == jx.dtype and y.dtype == jy.dtype
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    assert splits == jsplits


def _loan_csv(path, n=40, seed=0):
    """A raw ``loan.csv`` with every column the pipeline reads: numbers,
    the categorical maps (one unknown category), blanks, joint incomes and
    issue years on both sides of the 2018 filter."""
    r = np.random.RandomState(seed)
    cols = sorted(set(tabular.LOAN_ALL_FEATURES) - {"annual_inc_comp"}
                  | {"annual_inc", "annual_inc_joint", "verification_status_joint",
                     "loan_status", "issue_d"})
    statuses = ["Fully Paid", "Charged Off", "Current", "Late (31-120 days)", "Default"]
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=cols)
        w.writeheader()
        for i in range(n):
            row = {c: f"{r.normal(50, 20):.3f}" if r.rand() > 0.1 else "" for c in cols}
            for c, m in tabular.LOAN_CATEGORY_MAPS.items():
                row[c] = r.choice(list(m) + ["unheard-of"])
            row["verification_status_joint"] = r.choice(
                ["", "Verified", "Not Verified", "Source Verified"])
            row["loan_status"] = statuses[i % len(statuses)]
            row["issue_d"] = r.choice(["Dec-2018", "Mar-2018", "Jan-2017", ""])
            w.writerow(row)


def test_tabular_loaders_equal_jax(tmp_path):
    # the stand-ins
    _assert_same_table(tabular.load_lending_club(str(tmp_path / "none"), num_hosts=2, seed=4),
                       jtab.load_lending_club(str(tmp_path / "none"), num_hosts=2, seed=4))
    _assert_same_table(tabular.load_nus_wide(str(tmp_path / "none"), seed=2),
                       jtab.load_nus_wide(str(tmp_path / "none"), seed=2))
    for name in ("SUSY", "occupancy"):
        got = tabular.load_uci_stream(name, str(tmp_path), num_clients=3,
                                      samples_per_client=10, seed=1)
        want = jtab.load_uci_stream(name, str(tmp_path), num_clients=3,
                                    samples_per_client=10, seed=1)
        for f in ("train_x", "train_y", "test_x", "test_y"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert got.name == want.name and got.num_classes == want.num_classes == 2
        assert {c: v.tolist() for c, v in got.train_client_idx.items()} == {
            c: v.tolist() for c, v in want.train_client_idx.items()}
    # a UCI csv (label column first)
    r = np.random.RandomState(0)
    np.savetxt(tmp_path / "SUSY.csv", np.c_[r.randint(0, 2, 90), r.randn(90, 5)],
               fmt="%.6f", delimiter=",")
    got, want = (load_uci_stream("SUSY", str(tmp_path), num_clients=4)
                 for load_uci_stream in (tabular.load_uci_stream, jtab.load_uci_stream))
    for f in ("train_x", "train_y", "test_x", "test_y"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    # a preprocessed npz
    npz = tmp_path / "npz"
    npz.mkdir()
    np.savez(npz / "loan_processed.npz", x=r.randn(50, 30), y=r.randint(0, 2, 50))
    _assert_same_table(tabular.load_lending_club(str(npz)), jtab.load_lending_club(str(npz)))
    # a raw loan.csv through the reference's feature engineering
    raw = tmp_path / "raw"
    raw.mkdir()
    _loan_csv(raw / "loan.csv")
    got = tabular.load_lending_club(str(raw), num_hosts=2)
    _assert_same_table(got, jtab.load_lending_club(str(raw), num_hosts=2))
    assert got[0].shape[1] == len(tabular.LOAN_ALL_FEATURES) and 0 < len(got[1]) < 40
    # a raw NUS-WIDE tree: two labels, two feature blocks, the tags
    nus = tmp_path / "nus"
    for d in ("Groundtruth/AllLabels", "Groundtruth/TrainTestLabels", "Low_Level_Features",
              "NUS_WID_Tags"):
        (nus / d).mkdir(parents=True)
    n = 30
    for label in ("sky", "water", "grass"):
        np.savetxt(nus / f"Groundtruth/AllLabels/Labels_{label}.txt", r.randint(0, 2, 50),
                   fmt="%d")
        np.savetxt(nus / f"Groundtruth/TrainTestLabels/Labels_{label}_Train.txt",
                   r.randint(0, 2, n), fmt="%d")
    for block, dim in (("CH", 4), ("EDH", 3)):
        np.savetxt(nus / f"Low_Level_Features/Train_Normalized_{block}.dat",
                   r.rand(n, dim), fmt="%.5f", delimiter=" ")
    np.savetxt(nus / "NUS_WID_Tags/Train_Tags1k.dat", r.randint(0, 2, (n, 6)), fmt="%d",
               delimiter="\t")
    _assert_same_table(tabular.load_nus_wide(str(nus)), jtab.load_nus_wide(str(nus)))


def test_run_main_vfl_matches_jax(tmp_path):
    """The 512 x 24 lending-club stand-in (guest and host, 12 columns
    each), 2 epochs at batch 64: the last 102 rows are the test set."""
    argv = ["--algorithm", "vfl", "--data_dir", str(tmp_path / "no-table"),
            "--batch_size", "64", "--comm_round", "2", "--lr", "0.05"]
    want = jrun.main([*argv, "--run_dir", str(tmp_path / "jax")])["history"]
    got = run.main([*argv, "--device", "cpu", "--run_dir", str(tmp_path / "port")])["history"]
    assert len(got) == len(want) == 2
    for t, j in zip(got, want):
        assert sorted(t) == sorted(j)
        assert t["accuracy"] == j["accuracy"] and t["step"] == j["step"] == 7 * (t["epoch"] + 1)
        assert abs(t["auc"] - j["auc"]) <= 1e-6
