"""Shakespeare next-character datasets (LEAF json + TFF h5 variants).

numpy copy of ``fedml_tpu/data/shakespeare.py``: the same vocabulary,
windows, readers and synthetic stand-in, byte for byte.

Reference: ``fedml_api/data_preprocessing/shakespeare/data_loader.py``
(LEAF ``all_data_*.json`` with per-user 80-char windows, char vocab from
``language_utils.py``) and ``fed_shakespeare/data_loader.py`` (TFF h5,
``snippets`` per client, sequence targets).  The 90-symbol vocabulary
(86 chars + pad/OOV/BOS/EOS) follows ``language_utils.py:11-20``.

Outputs: LEAF variant → x [N, 80] int32, y [N] (final next char);
TFF variant → x [N, 80], y [N, 80] (per-position next char, matching
``RNNOriginalFedAvg(seq_output=True)``).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from fedml_tpu_torch.core.types import FedDataset

# language_utils.py:11-17 — the TFF text-generation tutorial vocabulary
CHAR_VOCAB = (
    "dhlptx@DHLPTX $(,048cgkoswCGKOSW[_#'/37;?bfjnrvzBFJNRVZ\"&*.26:"
    "\naeimquyAEIMQUY]!%)-159\r"
)
PAD, OOV, BOS, EOS = 0, len(CHAR_VOCAB) + 1, len(CHAR_VOCAB) + 2, len(CHAR_VOCAB) + 3
VOCAB_SIZE = len(CHAR_VOCAB) + 4  # 90
SEQ_LEN = 80

_CHAR_TO_ID = {c: i + 1 for i, c in enumerate(CHAR_VOCAB)}


def encode_text(s: str) -> np.ndarray:
    return np.asarray([_CHAR_TO_ID.get(c, OOV) for c in s], np.int32)


def _windows(text_ids: np.ndarray, seq_len: int = SEQ_LEN):
    """Non-overlapping (x, y) next-char windows over one client's text."""
    n = (len(text_ids) - 1) // seq_len
    xs, ys = [], []
    for i in range(n):
        xs.append(text_ids[i * seq_len : (i + 1) * seq_len])
        ys.append(text_ids[i * seq_len + 1 : (i + 1) * seq_len + 1])
    return xs, ys


def _from_leaf_json(train_path: str, test_path: str) -> FedDataset:
    def load(path):
        xs, ys, idx = [], [], {}
        off = 0
        with open(path) as f:
            data = json.load(f)
        for c, user in enumerate(data["users"]):
            ux = [encode_text(s) for s in data["user_data"][user]["x"]]
            # LEAF y: single next char per 80-char window
            uy = [
                _CHAR_TO_ID.get(s[0], OOV) if s else OOV
                for s in data["user_data"][user]["y"]
            ]
            xs.extend(ux)
            ys.extend(uy)
            idx[c] = np.arange(off, off + len(uy))
            off += len(uy)
        x = np.stack([np.pad(v[:SEQ_LEN], (0, max(0, SEQ_LEN - len(v))))
                      for v in xs]).astype(np.int32)
        return x, np.asarray(ys, np.int32), idx

    tx, ty, tidx = load(train_path)
    ex, ey, eidx = load(test_path)
    return FedDataset(
        train_x=tx, train_y=ty, test_x=ex, test_y=ey,
        train_client_idx=tidx, test_client_idx=eidx,
        num_classes=VOCAB_SIZE, name="shakespeare",
    )


def _synthetic_text(num_clients: int, windows_per_client: int, seq: bool,
                    seed: int, name: str,
                    peak_eta: Optional[float] = None,
                    test_windows: Optional[int] = None) -> FedDataset:
    rng = np.random.RandomState(seed)
    nchars = VOCAB_SIZE - 4  # the real char ids 1..86 (pad/OOV/BOS/EOS out)
    if peak_eta is not None:
        # Peaked first-order Markov chain for CONVERGENCE evidence: with
        # prob 1-η the next char is a fixed random permutation σ(prev),
        # else uniform over the vocab.  Bayes-optimal next-char accuracy
        # is exactly (1-η) + η/nchars — the same documented-ceiling
        # methodology as the label-noise image stand-ins
        # (data/synthetic.py), for a sequence task where "flip the
        # label" has no direct analogue.
        perm = rng.permutation(nchars)

        def sample(n):
            # vectorized over jump segments: between jumps the chain is
            # deterministic (ids[s+k] = perm^k(ids[s])), so build a
            # perm-power table up to the longest segment and index it —
            # equivalent to walking the chain per character over the
            # same pre-drawn jump/uniform arrays
            first = rng.randint(nchars)
            jump = rng.rand(n) < peak_eta
            unif = rng.randint(0, nchars, size=n)
            starts = np.concatenate(
                [[0], np.flatnonzero(jump[1:]) + 1])
            start_val = np.concatenate([[first], unif[starts[1:]]])
            seg = np.zeros(n, np.int64)
            seg[starts[1:]] = 1
            seg = np.cumsum(seg)
            k = np.arange(n) - starts[seg]
            ptab = np.empty((int(k.max()) + 1, nchars), np.int64)
            ptab[0] = np.arange(nchars)
            for t in range(1, len(ptab)):
                ptab[t] = perm[ptab[t - 1]]
            ids = ptab[k, start_val[seg]]
            return (ids + 1).astype(np.int32)
    else:
        # Markov-ish synthetic text: random walk over the vocab keeps
        # next-char structure learnable, unlike iid noise
        def sample(n):
            steps = rng.randint(-3, 4, size=n)
            ids = np.clip(np.cumsum(steps) % nchars, 0,
                          nchars - 1) + 1
            return ids.astype(np.int32)

    def block(n_windows):
        text = sample(n_windows * SEQ_LEN + 1)
        xs, ys = _windows(text)
        x = np.stack(xs)
        if seq:
            y = np.stack(ys)
        else:
            y = np.asarray([w[-1] for w in ys], np.int32)
        return x, y

    if peak_eta is not None:
        # LEAF's realistic partition is heterogeneous in SHARD SIZE
        # (roles speak wildly different amounts of text); mirror that
        # with lognormal window counts clipped to [4, windows_per_client]
        # — the distributional signal itself stays one shared chain
        # (documented as iid across clients in the convergence artifact)
        sizes = np.clip(
            np.exp(rng.normal(np.log(max(windows_per_client // 3, 4)),
                              0.8, num_clients)),
            4, windows_per_client).astype(int)
    else:
        sizes = np.full(num_clients, windows_per_client)
    xs, ys, idx = [], [], {}
    off = 0
    for c in range(num_clients):
        x, y = block(int(sizes[c]))
        xs.append(x)
        ys.append(y)
        idx[c] = np.arange(off, off + len(y))
        off += len(y)
    tx, t_y = block(test_windows if test_windows is not None
                    else max(windows_per_client, 8))
    return FedDataset(
        train_x=np.concatenate(xs), train_y=np.concatenate(ys),
        test_x=tx, test_y=t_y, train_client_idx=idx, test_client_idx=None,
        num_classes=VOCAB_SIZE, name=name,
    )


def load_shakespeare(
    data_dir: str = "./data/shakespeare",
    num_clients: int = 10,
    windows_per_client: int = 16,
    seed: int = 0,
    standin_peak_eta: Optional[float] = None,
    standin_test_windows: Optional[int] = None,
) -> FedDataset:
    """LEAF variant: y = one next char per window.

    ``standin_peak_eta`` / ``standin_test_windows`` apply ONLY to the
    offline synthetic stand-in: the former switches the random-walk
    text to the peaked Markov chain with a documented Bayes ceiling
    (see ``_synthetic_text``), the latter sizes the held-out window set
    (convergence evidence needs more than the default handful); real
    LEAF json is never modified."""
    tr = os.path.join(data_dir, "train")
    te = os.path.join(data_dir, "test")
    if os.path.isdir(tr) and os.path.isdir(te):
        trj = [os.path.join(tr, f) for f in sorted(os.listdir(tr))
               if f.endswith(".json")]
        tej = [os.path.join(te, f) for f in sorted(os.listdir(te))
               if f.endswith(".json")]
        if trj and tej:
            return _from_leaf_json(trj[0], tej[0])
    return _synthetic_text(num_clients, windows_per_client, seq=False,
                           seed=seed, name="shakespeare(synthetic-standin)",
                           peak_eta=standin_peak_eta,
                           test_windows=standin_test_windows)


def load_fed_shakespeare(
    data_dir: str = "./data/fed_shakespeare/datasets",
    num_clients: int = 10,
    windows_per_client: int = 16,
    seed: int = 0,
) -> FedDataset:
    """TFF variant: y = per-position next char [N, 80]."""
    tr = os.path.join(data_dir, "shakespeare_train.h5")
    te = os.path.join(data_dir, "shakespeare_test.h5")
    if os.path.exists(tr) and os.path.exists(te):
        import h5py

        def load(path):
            xs, ys, idx = [], [], {}
            off = 0
            with h5py.File(path, "r") as f:
                ex = f["examples"]
                for c, cid in enumerate(sorted(ex.keys())):
                    text = b"".join(np.asarray(ex[cid]["snippets"]).tolist())
                    ids = encode_text(text.decode("utf-8", "ignore"))
                    wx, wy = _windows(ids)
                    if not wx:
                        continue
                    xs.extend(wx)
                    ys.extend(wy)
                    idx[len(idx)] = np.arange(off, off + len(wx))
                    off += len(wx)
            return (np.stack(xs).astype(np.int32),
                    np.stack(ys).astype(np.int32), idx)

        tx, ty, tidx = load(tr)
        ex_, ey, eidx = load(te)
        return FedDataset(
            train_x=tx, train_y=ty, test_x=ex_, test_y=ey,
            train_client_idx=tidx, test_client_idx=eidx,
            num_classes=VOCAB_SIZE, name="fed_shakespeare",
        )
    return _synthetic_text(num_clients, windows_per_client, seq=True,
                           seed=seed,
                           name="fed_shakespeare(synthetic-standin)")
