"""Tabular datasets (a numpy copy of ``fedml_tpu/data/tabular.py``): UCI
streams (decentralized online learning), lending-club loan and NUS-WIDE
(vertical FL).

Reference: ``fedml_api/data_preprocessing/UCI/`` (SUSY, room-occupancy
CSV streams consumed by ``standalone/decentralized``),
``lending_club_loan/`` and ``NUS_WIDE/`` (guest/host feature-split
tables for classical VFL).  Loaders read CSVs when present, otherwise
emit synthetic stand-ins with the reference's shapes.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from fedml_tpu_torch.core.types import FedDataset


def _read_csv(path: str, label_col: int = 0, skip_header: int = 0):
    data = np.genfromtxt(path, delimiter=",", skip_header=skip_header)
    y = data[:, label_col]
    x = np.delete(data, label_col, axis=1)
    return x.astype(np.float32), y.astype(np.int32)


def load_uci_stream(
    name: str = "SUSY",
    data_dir: str = "./data/UCI",
    num_clients: int = 8,
    samples_per_client: int = 64,
    seed: int = 0,
) -> FedDataset:
    """Streaming binary-classification rows for DOL (reference
    ``standalone/decentralized`` SUSY/room-occupancy).  Row order is
    preserved — DOL consumes it as a stream and reports regret."""
    path = os.path.join(data_dir, f"{name}.csv")
    if os.path.exists(path):
        x, y = _read_csv(path, label_col=0)
        y = (y > 0).astype(np.int32)
        # small real files: shrink the holdout so the split stays valid
        holdout = min(64, max(1, len(x) // 5))
    else:
        rng = np.random.RandomState(seed)
        dim = 18 if name.upper() == "SUSY" else 5
        n = num_clients * samples_per_client + 64
        w = rng.randn(dim).astype(np.float32)
        x = rng.randn(n, dim).astype(np.float32)
        y = (x @ w + 0.3 * rng.randn(n) > 0).astype(np.int32)
        name = f"{name}(synthetic-standin)"
        holdout = 64  # n was sized for exactly this, keeping
        # samples_per_client contractual on the synthetic path
    n_train = len(x) - holdout
    per = n_train // num_clients
    idx = {c: np.arange(c * per, (c + 1) * per) for c in range(num_clients)}
    return FedDataset(
        train_x=x[:n_train], train_y=y[:n_train],
        test_x=x[n_train:], test_y=y[n_train:],
        train_client_idx=idx, test_client_idx=None,
        num_classes=2, name=f"uci_{name}",
    )


# ---------------------------------------------------------------------------
# Lending-club raw-CSV pipeline — the reference's full feature
# engineering (``lending_club_loan/lending_club_dataset.py:10-123``).
# The categorical→ordinal maps and feature groups below are dataset
# constants copied from the reference (``lending_club_dataset.py:10-31``,
# ``lending_club_feature_group.py``) — the pipeline code is original.
# ---------------------------------------------------------------------------

LOAN_BAD_STATUS = frozenset([
    "Charged Off", "Default",
    "Does not meet the credit policy. Status:Charged Off",
    "In Grace Period", "Late (16-30 days)", "Late (31-120 days)",
])  # loan_condition(), lending_club_dataset.py:48-55
LOAN_CATEGORY_MAPS: Dict[str, Dict[str, float]] = {
    "grade": {"A": 6, "B": 5, "C": 4, "D": 3, "E": 2, "F": 1, "G": 0},
    "emp_length": {"": 0, "< 1 year": 1, "1 year": 2, "2 years": 2,
                   "3 years": 2, "4 years": 3, "5 years": 3, "6 years": 3,
                   "7 years": 4, "8 years": 4, "9 years": 4, "10+ years": 5},
    "home_ownership": {"RENT": 0, "MORTGAGE": 1, "OWN": 2, "ANY": 3,
                       "NONE": 3, "OTHER": 3},
    "verification_status": {"Not Verified": 0, "Source Verified": 1,
                            "Verified": 2},
    "term": {" 36 months": 0, " 60 months": 1},
    "initial_list_status": {"w": 0, "f": 1},
    "purpose": {"debt_consolidation": 0, "credit_card": 0,
                "small_business": 1, "educational": 2, "car": 3, "other": 3,
                "vacation": 3, "house": 3, "home_improvement": 3,
                "major_purchase": 3, "medical": 3, "renewable_energy": 3,
                "moving": 3, "wedding": 3},
    "application_type": {"Individual": 0, "Joint App": 1},
    "disbursement_method": {"Cash": 0, "DirectPay": 1},
}
LOAN_QUALIFICATION_FEAT = [
    "grade", "emp_length", "home_ownership", "annual_inc_comp",
    "verification_status", "total_rev_hi_lim", "tot_hi_cred_lim",
    "total_bc_limit", "total_il_high_credit_limit",
]
LOAN_LOAN_FEAT = ["loan_amnt", "term", "initial_list_status", "purpose",
                  "application_type", "disbursement_method"]
LOAN_DEBT_FEAT = [
    "int_rate", "installment", "revol_bal", "revol_util", "out_prncp",
    "recoveries", "dti", "dti_joint", "tot_coll_amt", "mths_since_rcnt_il",
    "total_bal_il", "il_util", "max_bal_bc", "all_util", "bc_util",
    "total_bal_ex_mort", "revol_bal_joint", "mo_sin_old_il_acct",
    "mo_sin_old_rev_tl_op", "mo_sin_rcnt_rev_tl_op", "mort_acc",
    "num_rev_tl_bal_gt_0", "percent_bc_gt_75",
]
LOAN_REPAYMENT_FEAT = [
    "num_sats", "num_bc_sats", "pct_tl_nvr_dlq", "bc_open_to_buy",
    "last_pymnt_amnt", "total_pymnt", "total_pymnt_inv", "total_rec_prncp",
    "total_rec_int", "total_rec_late_fee", "tot_cur_bal", "avg_cur_bal",
]
LOAN_MULTI_ACC_FEAT = [
    "num_il_tl", "num_op_rev_tl", "num_rev_accts", "num_actv_rev_tl",
    "num_tl_op_past_12m", "open_rv_12m", "open_rv_24m", "open_acc_6m",
    "open_act_il", "open_il_12m", "open_il_24m", "total_acc",
    "inq_last_6mths", "open_acc", "inq_fi", "inq_last_12m",
    "acc_open_past_24mths",
]
LOAN_MAL_BEHAVIOR_FEAT = [
    "num_tl_120dpd_2m", "num_tl_30dpd", "num_tl_90g_dpd_24m",
    "pub_rec_bankruptcies", "mths_since_recent_revol_delinq",
    "num_accts_ever_120_pd", "mths_since_recent_bc_dlq",
    "chargeoff_within_12_mths", "collections_12_mths_ex_med",
    "mths_since_last_major_derog", "acc_now_delinq", "pub_rec",
    "mths_since_last_delinq", "delinq_2yrs", "delinq_amnt", "tax_liens",
]
LOAN_ALL_FEATURES = (LOAN_QUALIFICATION_FEAT + LOAN_LOAN_FEAT
                     + LOAN_DEBT_FEAT + LOAN_REPAYMENT_FEAT
                     + LOAN_MULTI_ACC_FEAT + LOAN_MAL_BEHAVIOR_FEAT)
# party A (guest) owns qualification+loan features, party B the rest
# (loan_load_two_party_data, lending_club_dataset.py:144-145); because
# LOAN_ALL_FEATURES lists A's features first, A is a column PREFIX
LOAN_PARTY_A_DIM = len(LOAN_QUALIFICATION_FEAT) + len(LOAN_LOAN_FEAT)


def standardize_columns(x: np.ndarray) -> np.ndarray:
    """sklearn StandardScaler semantics (population std, zero-variance
    columns scale by 1) — ``normalize()``, lending_club_dataset.py:34-37."""
    mean = x.mean(axis=0)
    std = x.std(axis=0)
    std = np.where(std == 0, 1.0, std)
    return ((x - mean) / std).astype(np.float32)


def _loan_field(row: Dict[str, str], col: str) -> float:
    """One engineered cell: categorical→ordinal via the maps, numeric
    parse otherwise, NaN for missing (filled with -99 downstream,
    ``process_data``, lending_club_dataset.py:115-118)."""
    if col == "annual_inc_comp":
        # compute_annual_income (lending_club_dataset.py:57-60): joint
        # income when the joint verification status matches.  A missing
        # joint status is NaN in pandas and NaN == anything is False,
        # so empty never matches.
        joint = row.get("verification_status_joint") or None
        if joint is not None and row.get("verification_status", "") == joint:
            raw = row.get("annual_inc_joint", "")
        else:
            raw = row.get("annual_inc", "")
    else:
        raw = row.get(col, "")
    m = LOAN_CATEGORY_MAPS.get(col)
    if m is not None:
        return float(m.get(raw if raw is not None else "", np.nan))
    try:
        return float(raw)
    except (TypeError, ValueError):
        return np.nan


def load_lending_club_raw(csv_path: str) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's ``prepare_data`` + ``process_data`` pipeline
    (lending_club_dataset.py:100-123): loan.csv → good/bad target from
    loan_status, composite annual income, issue_year==2018 filter,
    categorical digitization, the 81-column feature selection,
    fillna(-99), per-column standardization.  Returns (x [N, 81],
    y [N] int 0=Good/1=Bad)."""
    import csv as _csv
    import re as _re

    xs, ys = [], []
    with open(csv_path, newline="") as f:
        for row in _csv.DictReader(f):
            m = _re.search(r"(\d{4})", row.get("issue_d", "") or "")
            if m is None or int(m.group(1)) != 2018:  # issue_year filter
                continue
            ys.append(1 if row.get("loan_status") in LOAN_BAD_STATUS else 0)
            xs.append([_loan_field(row, c) for c in LOAN_ALL_FEATURES])
    x = np.asarray(xs, np.float64)
    x = np.where(np.isnan(x), -99.0, x)  # fillna(-99)
    return standardize_columns(x), np.asarray(ys, np.int32)


def load_lending_club(
    data_dir: str = "./data/lending_club_loan",
    num_hosts: int = 1,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, list]:
    """VFL table: returns (X, y, feature_splits) where feature_splits
    gives each party's column slice (guest first) — the reference splits
    loan features between one guest (with labels) and hosts
    (``lending_club_loan/lending_club_dataset.py:141-162``).

    Formats, in order: raw ``loan.csv`` (full reference feature
    engineering, ``load_lending_club_raw``), preprocessed
    ``loan_processed.npz``, synthetic stand-in."""
    raw = os.path.join(data_dir, "loan.csv")
    path = os.path.join(data_dir, "loan_processed.npz")
    if os.path.exists(raw):
        x, y = load_lending_club_raw(raw)
        # reference party split: A = qualification+loan prefix, B = rest;
        # extra hosts subdivide B (three-party mode halves it,
        # loan_load_three_party_data)
        d = x.shape[1]
        cuts = np.linspace(LOAN_PARTY_A_DIM, d, num_hosts + 1).astype(int)
        splits = [slice(0, LOAN_PARTY_A_DIM)] + [
            slice(cuts[i], cuts[i + 1]) for i in range(num_hosts)
        ]
        return x, y, splits
    if os.path.exists(path):
        z = np.load(path)
        x, y = z["x"].astype(np.float32), z["y"].astype(np.int32)
    else:
        rng = np.random.RandomState(seed)
        n, d = 512, 24
        w = rng.randn(d).astype(np.float32)
        x = rng.randn(n, d).astype(np.float32)
        y = (x @ w > 0).astype(np.int32)
    d = x.shape[1]
    parties = num_hosts + 1
    cuts = np.linspace(0, d, parties + 1).astype(int)
    splits = [slice(cuts[i], cuts[i + 1]) for i in range(parties)]
    return x, y, splits


def load_nus_wide_raw(
    data_dir: str,
    selected_labels: Optional[list] = None,
    top_k: int = 2,
    dtype: str = "Train",
) -> Tuple[np.ndarray, np.ndarray, int]:
    """The reference's raw NUS-WIDE parsing
    (``NUS_WIDE/nus_wide_dataset.py:8-62``):

    - ``Groundtruth/AllLabels/Labels_<label>.txt`` → per-label positive
      counts, top-k selection (``get_top_k_labels``);
    - ``Groundtruth/TrainTestLabels/Labels_<label>_<dtype>.txt`` → 0/1
      rows; with >1 labels keep rows where EXACTLY one fires;
    - ``Low_Level_Features/<dtype>_Normalized_*`` (space-separated,
      trailing-blank column dropped) concatenated → guest's 634-d image
      features;
    - ``NUS_WID_Tags/<dtype>_Tags1k.dat`` (tab-separated) → host's
      1000-d tag features;
    - y = 1 where the FIRST selected label fires, else 0 (the
      reference's two-party loader, ``:84-94``, with neg_label=0 —
      our BCE losses take {0,1} rather than its {-1,1}).

    Returns (x = [guest | host] columns standardized per party,
    y, guest_dim)."""
    gt = os.path.join(data_dir, "Groundtruth")
    if selected_labels is None:
        counts = {}
        all_dir = os.path.join(gt, "AllLabels")
        for fname in sorted(os.listdir(all_dir)):
            label = fname[:-4].split("_")[-1]
            vals = np.loadtxt(os.path.join(all_dir, fname), dtype=np.int64,
                              ndmin=1)
            counts[label] = int((vals == 1).sum())
        selected_labels = [
            k for k, _ in sorted(counts.items(), key=lambda kv: kv[1],
                                 reverse=True)[:top_k]
        ]
    cols = [
        np.loadtxt(
            os.path.join(gt, "TrainTestLabels",
                         f"Labels_{label}_{dtype}.txt"),
            dtype=np.int64, ndmin=1,
        )
        for label in selected_labels
    ]
    labels = np.stack(cols, axis=1)  # [N, k]
    keep = (labels.sum(axis=1) == 1) if labels.shape[1] > 1 \
        else np.ones(len(labels), bool)

    feat_dir = os.path.join(data_dir, "Low_Level_Features")
    feats = []
    for fname in sorted(os.listdir(feat_dir)):
        if fname.startswith(f"{dtype}_Normalized"):
            block = np.genfromtxt(os.path.join(feat_dir, fname),
                                  dtype=np.float64, ndmin=2)
            # trailing separator yields an all-NaN column (reference
            # dropna(axis=1)); drop any fully-NaN columns
            block = block[:, ~np.all(np.isnan(block), axis=0)]
            feats.append(block)
    xa = np.concatenate(feats, axis=1)[keep]
    tags = np.genfromtxt(
        os.path.join(data_dir, "NUS_WID_Tags", f"{dtype}_Tags1k.dat"),
        delimiter="\t", dtype=np.float64, ndmin=2,
    )
    tags = tags[:, ~np.all(np.isnan(tags), axis=0)][keep]
    y = (labels[keep][:, 0] == 1).astype(np.int32)
    x = np.concatenate(
        [standardize_columns(xa), standardize_columns(tags)], axis=1
    )
    return x, y, xa.shape[1]


def load_nus_wide(
    data_dir: str = "./data/NUS_WIDE",
    binary_label: int = 1,
    seed: int = 0,
    selected_labels: Optional[list] = None,
) -> Tuple[np.ndarray, np.ndarray, list]:
    """NUS-WIDE VFL split: guest = 634-d low-level image features,
    host = 1000-d tag features (reference ``NUS_WIDE/nus_wide_dataset.py``).
    Formats, in order: the raw Groundtruth/Low_Level_Features/Tags tree
    (``load_nus_wide_raw``), preprocessed npz, synthetic stand-in."""
    if os.path.isdir(os.path.join(data_dir, "Groundtruth")):
        x, y, guest_dim = load_nus_wide_raw(
            data_dir, selected_labels=selected_labels
        )
        return x, y, [slice(0, guest_dim), slice(guest_dim, x.shape[1])]
    path = os.path.join(data_dir, "nus_wide_processed.npz")
    if os.path.exists(path):
        z = np.load(path)
        x, y = z["x"].astype(np.float32), z["y"].astype(np.int32)
        guest_dim = int(z.get("guest_dim", 634))
    else:
        rng = np.random.RandomState(seed)
        n, guest_dim, host_dim = 256, 64, 100
        x = rng.randn(n, guest_dim + host_dim).astype(np.float32)
        w = rng.randn(guest_dim + host_dim).astype(np.float32)
        y = (x @ w > 0).astype(np.int32)
    return x, y, [slice(0, guest_dim), slice(guest_dim, x.shape[1])]
