"""StackOverflow federated datasets: next-word prediction (NWP) and
tag prediction (logistic regression, LR) (numpy copy of
``fedml_tpu/data/stackoverflow.py``).

Reference: ``fedml_api/data_preprocessing/stackoverflow_nwp/data_loader.py``
(h5, 342 477 users, 10 000-word vocab + pad/bos/eos/oov → 10 004,
20-token windows) and ``stackoverflow_lr/data_loader.py`` (bag-of-words
10 000 features, 500 tags, multi-label).  Offline fallback: synthetic
stand-ins with matching shapes; the NWP stand-in uses a vocab random
walk so next-token structure is learnable.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from fedml_tpu_torch.core.types import FedDataset

NWP_VOCAB = 10000
NWP_EXTENDED = NWP_VOCAB + 4  # pad/bos/eos/oov, reference rnn.py:39-47
NWP_SEQ_LEN = 20
LR_FEATURES = 10000
LR_TAGS = 500


def zipf_weights(vocab: int, s: float = 1.1) -> np.ndarray:
    """Zipf(s) unigram distribution over token ids (rank = id).  Real
    text is zipfian; a UNIFORM-unigram chain was measured unlearnable
    at the reference row's SGD lr (a JAX-package pilot: loss 9.211→9.207 over 100
    rounds at lr 10^-0.5, 3x faster at lr 1.0 but still glacial, NaN
    at 3.0) — every one of the 10k classes needs its own averaged-over
    -clients signal.  Zipf jumps give the head words the same
    many-sightings-per-round head start real NWP training has."""
    q = 1.0 / np.arange(1, vocab + 1, dtype=np.float64) ** s
    return q / q.sum()


def _peaked_chain(rng, n: int, vocab: int, eta: float,
                  chunk: int = 1 << 25,
                  jump_q: "np.ndarray | None" = None,
                  ) -> "tuple[np.ndarray, np.ndarray]":
    """Length-n peaked Markov chain over [0, vocab): follow a fixed
    permutation with prob 1−η, jump uniform with prob η — the
    calibrated-text methodology of ``data/shakespeare.py``.  Returns
    ``(chain, perm)`` — the permutation is the Bayes predictor, with
    accuracy ceiling (1−η) + η·E[q(perm(cur))] (= (1−η) + η/vocab for
    uniform jumps; ``jump_q`` draws jump targets from a given unigram
    distribution instead, e.g. ``zipf_weights``).
    (Shakespeare's in-place sampler is deliberately NOT refactored onto
    this helper: its exact RNG stream is what the rev'd stand-in data
    and the JAX package's convergence records were produced from — changing its draw order would
    silently invalidate them.  The two ceilings are pinned by separate
    tests.)

    Vectorized over jump segments — within a segment the chain is
    deterministic (ids[s+k] = perm^k(ids[s])), so a perm-power table up
    to the longest segment resolves every position at once — and
    generated in ``chunk``-sized pieces whose first element continues
    the previous chunk's walk, keeping transient host memory O(chunk)
    instead of several full-length float64/int64 temporaries (the
    342k-client preset's ~1e9 positions would otherwise peak
    tens of GB over the ~3.7 GB result)."""
    if eta <= 0.0:
        # a jump-free chain is one global permutation cycle: the
        # perm-power table would be O(n · vocab), and the "ceiling"
        # would be 1.0 — not a calibrated task
        raise ValueError(f"peaked chain needs jump rate eta > 0, got {eta}")
    perm = rng.permutation(vocab).astype(np.int32)
    cdf = None if jump_q is None else np.cumsum(jump_q)
    out = np.empty(n, np.int32)
    carry = None
    done = 0
    while done < n:
        m = min(chunk, n - done)
        jump = rng.rand(m) < eta
        if cdf is None:
            unif = rng.randint(0, vocab, size=m).astype(np.int32)
        else:  # jump targets ~ jump_q (zipf): inverse-CDF sampling
            unif = np.searchsorted(cdf, rng.rand(m)).astype(np.int32)
            np.clip(unif, 0, vocab - 1, out=unif)
        # chunk boundary: index 0 is always a segment start for the
        # bookkeeping, but its VALUE follows the chain dynamics — the
        # drawn jump[0] decides uniform (keep unif[0]) vs continue the
        # previous chunk's walk (perm[carry]); the very first chunk has
        # no carry and starts with a uniform draw
        if carry is not None and not bool(jump[0]):
            unif[0] = perm[carry]
        jump[0] = True
        starts = np.flatnonzero(jump)
        seg_start = starts[np.cumsum(jump) - 1]
        k = (np.arange(m, dtype=np.int64) - seg_start).astype(np.int32)
        powers = np.empty((int(k.max()) + 1, vocab), np.int32)
        powers[0] = np.arange(vocab, dtype=np.int32)
        for p in range(1, powers.shape[0]):
            powers[p] = perm[powers[p - 1]]
        out[done:done + m] = powers[k, unif[seg_start]]
        carry = out[done + m - 1]
        done += m
    return out, perm


def nwp_chain_ceiling(eta: float, vocab: int = NWP_VOCAB) -> float:
    """Bayes next-token accuracy of the peaked chain: predict
    perm(cur); right when the chain followed the permutation (1−η) or
    when a jump landed there by chance (η/vocab)."""
    return (1.0 - eta) + eta / vocab


def _parse_nwp_h5(path: str, num_clients: int):
    """Windows + per-client index from one TFF-layout h5 (``examples/
    <client>/tokens``) — shared by the train and test splits."""
    import h5py

    xs, ys, idx = [], [], {}
    off = 0
    with h5py.File(path, "r") as f:
        ex = f["examples"]
        for c, cid in enumerate(sorted(ex.keys())[: num_clients or None]):
            toks = np.asarray(ex[cid]["tokens"])  # already int windows
            kept = 0
            for row in toks:
                row = np.asarray(row, np.int32)[: NWP_SEQ_LEN + 1]
                if len(row) < 2:
                    continue
                pad = NWP_SEQ_LEN + 1 - len(row)
                row = np.pad(row, (0, pad))
                xs.append(row[:-1])
                ys.append(row[1:])
                kept += 1
            idx[c] = np.arange(off, off + kept)
            off += kept
    return xs, ys, idx


def load_stackoverflow_nwp(
    data_dir: str = "./data/stackoverflow/datasets",
    num_clients: int = 10,
    sequences_per_client: int = 32,
    seed: int = 0,
    standin_peak_eta: float = None,
    standin_test_sequences: int = 2000,
    standin_zipf_s: float = 1.1,
) -> FedDataset:
    h5path = os.path.join(data_dir, "stackoverflow_nwp.pkl")
    tr = os.path.join(data_dir, "stackoverflow_train.h5")
    if os.path.exists(tr):
        xs, ys, idx = _parse_nwp_h5(tr, num_clients)
        # the reference evaluates on the SEPARATE held-out split
        # (stackoverflow_test.h5); evaluating on the first 64 training
        # windows would silently report train accuracy as test accuracy
        # — with no test file present the test arrays are
        # None so any eval attempt fails loudly instead
        te = os.path.join(data_dir, "stackoverflow_test.h5")
        test_x = test_y = None
        if os.path.exists(te):
            txs, tys, _ = _parse_nwp_h5(te, num_clients)
            if txs:  # an empty/unusable split stays None (same refusal)
                test_x = np.stack(txs).astype(np.int32)
                test_y = np.stack(tys).astype(np.int32)
        return FedDataset(
            train_x=np.stack(xs).astype(np.int32),
            train_y=np.stack(ys).astype(np.int32),
            test_x=test_x,
            test_y=test_y,
            train_client_idx=idx, test_client_idx=None,
            num_classes=NWP_EXTENDED, name="stackoverflow_nwp",
        )
    del h5path
    rng = np.random.RandomState(seed)

    if standin_peak_eta is not None:
        # benchmark-grade stand-in (reference row README.md:57 —
        # 342,477 clients): a SHARED peaked chain over the 10k real-word
        # ids (+4 offset past pad/bos/eos/oov) sliced into 21-token
        # windows; shard sizes are clipped-lognormal (LEAF-style
        # heterogeneity in size, iid in distribution — same honesty
        # note as the shakespeare stand-in).  Size scale: median ~100,
        # mean ~130 — the real TFF partition averages ~397
        # sequences/client (135.8M examples / 342 477 users), so the
        # stand-in's per-round token volume is ~1/3 of the real row's;
        # going full-scale would cost ~13 GB of host generation per
        # run for no extra signal (recorded as a deviation in the
        # convergence artifact).  Stored int16 (vocab 10 004 < 2^15):
        # the full 342k-client population is ~3.7 GB instead of ~7.4.
        sizes = np.clip(
            rng.lognormal(mean=4.6, sigma=0.8, size=num_clients), 16, 512
        ).astype(np.int64)
        total = int(sizes.sum()) + standin_test_sequences
        q = (zipf_weights(NWP_VOCAB, standin_zipf_s)
             if standin_zipf_s else None)
        chain, perm = _peaked_chain(
            rng, total * (NWP_SEQ_LEN + 1), NWP_VOCAB, standin_peak_eta,
            jump_q=q,
        )
        # Bayes next-token accuracy of THIS chain (predict perm(cur)):
        # right when the chain followed the permutation (1−η) plus the
        # chance a jump landed there — η·q(perm(cur)) averaged over the
        # chain's own stationary distribution (empirical over a 1M-token
        # sample; exactly η/V when jumps are uniform)
        eta = standin_peak_eta
        if q is None:
            ceiling = (1.0 - eta) + eta / NWP_VOCAB
        else:
            cur = chain[: 1 << 20]
            ceiling = float((1.0 - eta) + eta * np.mean(q[perm[cur]]))
        win = (chain + 4).reshape(total, NWP_SEQ_LEN + 1).astype(np.int16)
        bounds = np.concatenate([[0], np.cumsum(sizes)])
        idx = {c: np.arange(bounds[c], bounds[c + 1])
               for c in range(num_clients)}
        test = win[bounds[-1]:]
        ds = FedDataset(
            train_x=win[:bounds[-1], :-1], train_y=win[:bounds[-1], 1:],
            test_x=test[:, :-1], test_y=test[:, 1:],
            train_client_idx=idx, test_client_idx=None,
            num_classes=NWP_EXTENDED,
            name="stackoverflow_nwp(synthetic-standin)",
        )
        ds.standin_bayes_ceiling = round(ceiling, 6)
        return ds

    def block(n):
        steps = rng.randint(-50, 51, size=n * (NWP_SEQ_LEN + 1))
        ids = (np.cumsum(steps) % NWP_VOCAB + 4).astype(np.int32)
        ids = ids.reshape(n, NWP_SEQ_LEN + 1)
        return ids[:, :-1], ids[:, 1:]

    xs, ys, idx = [], [], {}
    off = 0
    for c in range(num_clients):
        x, y = block(sequences_per_client)
        xs.append(x)
        ys.append(y)
        idx[c] = np.arange(off, off + len(x))
        off += len(x)
    tx, ty = block(64)
    return FedDataset(
        train_x=np.concatenate(xs), train_y=np.concatenate(ys),
        test_x=tx, test_y=ty, train_client_idx=idx, test_client_idx=None,
        num_classes=NWP_EXTENDED, name="stackoverflow_nwp(synthetic-standin)",
    )


def load_stackoverflow_lr(
    data_dir: str = "./data/stackoverflow_lr/datasets",
    num_clients: int = 10,
    samples_per_client: int = 32,
    num_features: int = LR_FEATURES,
    num_tags: int = LR_TAGS,
    seed: int = 0,
) -> FedDataset:
    """Multi-label tag prediction: x = normalized bag-of-words
    [N, num_features], y = multi-hot tags [N, num_tags].  Task loss:
    ``losses.masked_multilabel_bce`` (exact-match/precision/recall
    metrics) — ``registry.task_loss_for_dataset`` wires it for every
    training engine."""
    tr = os.path.join(data_dir, "stackoverflow_lr_train.h5")
    if os.path.exists(tr):
        import h5py

        with h5py.File(tr, "r") as f:
            x = np.asarray(f["x"], np.float32)
            y = np.asarray(f["y"], np.float32)
            idx = {
                int(c): np.asarray(v)
                for c, v in enumerate(np.asarray(f["client_ptr"]))
            }
        # held-out split only (the first-64-training-rows
        # fallback was eval-on-train); None test arrays make an eval
        # without the real test h5 fail loudly
        te = os.path.join(data_dir, "stackoverflow_lr_test.h5")
        test_x = test_y = None
        if os.path.exists(te):
            with h5py.File(te, "r") as f:
                test_x = np.asarray(f["x"], np.float32)
                test_y = np.asarray(f["y"], np.float32)
        return FedDataset(
            train_x=x, train_y=y, test_x=test_x, test_y=test_y,
            train_client_idx=idx, test_client_idx=None,
            num_classes=num_tags, name="stackoverflow_lr",
        )
    rng = np.random.RandomState(seed)
    n = num_clients * samples_per_client
    # sparse bags-of-words + tags correlated with the strongest features
    x = np.zeros((n + 64, num_features), np.float32)
    y = np.zeros((n + 64, num_tags), np.float32)
    w = rng.randn(num_features, num_tags).astype(np.float32) * 0.3
    for i in range(n + 64):
        nz = rng.randint(3, 12)
        feats = rng.randint(0, num_features, nz)
        x[i, feats] = 1.0 / nz
        logits = x[i] @ w
        y[i, np.argsort(-logits)[: rng.randint(1, 4)]] = 1.0
    idx = {
        c: np.arange(c * samples_per_client, (c + 1) * samples_per_client)
        for c in range(num_clients)
    }
    return FedDataset(
        train_x=x[:n], train_y=y[:n], test_x=x[n:], test_y=y[n:],
        train_client_idx=idx, test_client_idx=None,
        num_classes=num_tags, name="stackoverflow_lr(synthetic-standin)",
    )
