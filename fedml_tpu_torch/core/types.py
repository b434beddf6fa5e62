"""Typed federated data contract (port of ``fedml_tpu/core/types.py``).

``FedDataset`` holds numpy arrays on the host plus per-client index
lists.  ``pack_clients`` packs K clients into fixed-shape
``[K, steps, batch, ...]`` arrays with a sample mask (pad-by-wrapping,
so BatchNorm statistics never see zero images; the mask zeroes the
duplicates out of losses and counts).  ``device_resident_pack`` puts a
pack on a torch device once for a whole run.

The packed bytes are identical to the JAX package's for the same
inputs.  The row gather is the threaded C++ one of ``native/packer.cpp``
(numpy's ``take`` where no compiler exists; the bytes are the same).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class FedDataset:
    """Host-side federated dataset: global arrays + per-client partitions."""

    train_x: np.ndarray
    train_y: np.ndarray
    test_x: Optional[np.ndarray]
    test_y: Optional[np.ndarray]
    # client id -> indices into train_x / test_x
    train_client_idx: Dict[int, np.ndarray]
    test_client_idx: Optional[Dict[int, np.ndarray]]
    num_classes: int
    name: str = "dataset"

    @property
    def num_clients(self) -> int:
        return len(self.train_client_idx)

    @property
    def train_data_num(self) -> int:
        return int(self.train_x.shape[0])

    @property
    def test_data_num(self) -> int:
        return 0 if self.test_x is None else int(self.test_x.shape[0])

    def client_sample_counts(self) -> np.ndarray:
        """[num_clients] number of training samples per client."""
        return np.array(
            [len(self.train_client_idx[c]) for c in range(self.num_clients)],
            dtype=np.int32,
        )

    def subset_for_clients(self, client_ids: Sequence[int]) -> "FedDataset":
        """A host-local view holding ONLY the named clients' rows.

        The reference's distributed loaders materialize just the local
        rank's partition (``cifar10/data_loader.py:201-233``); a mesh rank
        calls ``subset_for_clients(host_client_range(...))`` and never
        holds the other hosts' data.  Client keys KEEP their original ids
        (only the row indices are compacted), so ``pack_clients`` on the
        subset is byte for byte the pack of the same clients from the
        full dataset (its per-client seeding is id-keyed).  Test rows are
        kept whole when there is no per-client test split (every host
        evaluates the global test set), and subset per client otherwise.
        """
        client_ids = list(client_ids)
        missing = [c for c in client_ids if c not in self.train_client_idx]
        if missing:
            raise KeyError(f"clients not in dataset: {missing}")

        def compact(index):
            order = np.concatenate(
                [np.asarray(index[c], np.int64) for c in client_ids]
            ) if client_ids else np.zeros((0,), np.int64)
            new_idx, off = {}, 0
            for c in client_ids:
                n = len(index[c])
                new_idx[c] = np.arange(off, off + n)
                off += n
            return order, new_idx

        order, new_idx = compact(self.train_client_idx)
        if self.test_client_idx is None:
            test_x, test_y, new_test_idx = self.test_x, self.test_y, None
        else:
            t_order, new_test_idx = compact(self.test_client_idx)
            test_x, test_y = self.test_x[t_order], self.test_y[t_order]
        return FedDataset(
            train_x=self.train_x[order], train_y=self.train_y[order],
            test_x=test_x, test_y=test_y, train_client_idx=new_idx,
            test_client_idx=new_test_idx, num_classes=self.num_classes,
            name=self.name)


@dataclasses.dataclass
class ClientBatches:
    """Fixed-shape pack of K clients' local training data.

    x:    [K, steps, batch, ...feature]
    y:    [K, steps, batch]
    mask: [K, steps, batch]  1.0 for a real sample, 0.0 for a wrapped pad
    num_samples: [K] true (unpadded) per-client sample counts
    """

    x: np.ndarray
    y: np.ndarray
    mask: np.ndarray
    num_samples: np.ndarray


# reusable gather targets for fixed-geometry round loops: one buffer per
# role tag per thread, replaced when the requested geometry changes
_pack_buffer_cache = threading.local()


def _gather_target(tag: str, shape, dtype, reuse: bool) -> Optional[np.ndarray]:
    """The cached host buffer for ``tag`` (x and y never share one) at
    this shape and dtype, or None without ``reuse``.  Thread-local, so
    two threads packing at once get distinct buffers."""
    if not reuse:
        return None
    cache = getattr(_pack_buffer_cache, "bufs", None)
    if cache is None:
        cache = _pack_buffer_cache.bufs = {}
    shape, dtype = tuple(shape), np.dtype(dtype)
    buf = cache.get(tag)
    if buf is None or buf.shape != shape or buf.dtype != dtype:
        buf = cache[tag] = np.empty(shape, dtype)
    return buf


def pack_clients(
    dataset: FedDataset,
    client_ids: Sequence[int],
    batch_size: int,
    *,
    steps_per_epoch: Optional[int] = None,
    seed: int = 0,
    reuse_buffers: bool = False,
) -> ClientBatches:
    """Pack the named clients' train shards into one fixed-shape block.

    Heterogeneous client sizes are resolved by wrapping indices
    (np.resize) up to a common ``steps_per_epoch * batch_size`` length;
    the mask marks only the first ``n_c`` slots per client as real.

    ``reuse_buffers=True`` gathers into cached host buffers instead of
    fresh allocations.  Only safe when the caller has consumed the pack
    (copied it to the device) before the next same-shape call: that call
    OVERWRITES the arrays returned here.
    """
    from fedml_tpu_torch.native import gather_rows

    counts = [len(dataset.train_client_idx[c]) for c in client_ids]
    if steps_per_epoch is None:
        steps_per_epoch = max(1, int(np.ceil(max(max(counts), 1) / batch_size)))
    total = steps_per_epoch * batch_size
    K = len(client_ids)

    wrapped_all = np.zeros((K, total), dtype=np.int64)
    mask = np.zeros((K, total), dtype=np.float32)
    ns = np.zeros(K, dtype=np.float32)
    for k, c in enumerate(client_ids):
        # per-client seeding: a client's pack is identical whether packed
        # alone or in a cohort
        rng = np.random.RandomState((seed * 1000003 + int(c) * 7919 + 1) % (2**31))
        idx = np.asarray(dataset.train_client_idx[c])
        n = len(idx)
        if n:
            lo, hi = int(idx.min()), int(idx.max())
            if lo < 0 or hi >= len(dataset.train_x):
                raise IndexError(
                    f"client {c} sample indices [{lo}, {hi}] out of range "
                    f"for train_x with {len(dataset.train_x)} rows"
                )
            # empty clients keep sample 0 / mask 0 and contribute nothing
            wrapped_all[k] = np.resize(rng.permutation(idx), total)
            mask[k, : min(n, total)] = 1.0
            ns[k] = min(n, total)

    # one row gather per array straight into the packed block
    feat_shape = dataset.train_x.shape[1:]
    x_out = _gather_target("x", (K * total, *feat_shape), dataset.train_x.dtype,
                           reuse_buffers)
    x = gather_rows(dataset.train_x, wrapped_all, x_out).reshape(
        K, steps_per_epoch, batch_size, *feat_shape)
    y_out = _gather_target("y", (K * total, *dataset.train_y.shape[1:]),
                           dataset.train_y.dtype, reuse_buffers)
    y = gather_rows(dataset.train_y, wrapped_all, y_out).reshape(
        K, steps_per_epoch, batch_size, *dataset.train_y.shape[1:])
    return ClientBatches(
        x=x, y=y, mask=mask.reshape(K, steps_per_epoch, batch_size),
        num_samples=ns,
    )


def device_resident_pack(
    dataset: FedDataset,
    ids,
    batch_size: int,
    *,
    steps_per_epoch: int,
    seed: int,
    device: torch.device,
) -> Tuple[Tuple[torch.Tensor, ...], np.ndarray]:
    """Pack a cohort ONCE and put it on ``device`` for the whole run.

    Returns ``((x, y, mask, num_samples) tensors on device, host
    num_samples)``.  The pack's base order carries no randomness (the
    local update re-permutes every epoch), so one copy serves every
    round of a resident cohort.

    Off the CPU the host buffers are reused (``reuse_buffers``): the copy
    to the card has finished with them when ``.to`` returns.  On the CPU
    ``torch.from_numpy`` aliases the pack, so a reused buffer would be
    overwritten under a cached block."""
    pack = pack_clients(dataset, ids, batch_size,
                        steps_per_epoch=steps_per_epoch, seed=seed,
                        reuse_buffers=torch.device(device).type != "cpu")
    args = tuple(
        torch.from_numpy(np.ascontiguousarray(a)).to(device)
        for a in (pack.x, pack.y, pack.mask, pack.num_samples)
    )
    return args, pack.num_samples.copy()


def to_device(pack, device) -> Tuple[torch.Tensor, ...]:
    """A host pack (a tuple of numpy arrays, e.g. ``batch_eval_pack``'s)
    as tensors on ``device``."""
    return tuple(torch.as_tensor(a).to(device) for a in pack)


def cohort_steps_per_epoch(dataset: FedDataset, batch_size: int) -> int:
    """Steps to cover the LARGEST client at ``batch_size`` (smaller
    clients pad-by-wrapping): the pack geometry every driver shares."""
    counts = dataset.client_sample_counts()
    return max(1, int(np.ceil(max(int(counts.max()), 1) / batch_size)))


def batch_eval_pack(
    x: np.ndarray, y: np.ndarray, batch_size: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad (by wrapping) an eval set to a whole number of batches.

    Returns (x_batched [steps, B, ...], y_batched [steps, B], mask).
    """
    if x is None or y is None:
        raise ValueError(
            "dataset has no test split (test arrays are None): evaluate on "
            "a dataset that ships one — training data is not a fallback"
        )
    n = len(x)
    steps = max(1, int(np.ceil(n / batch_size)))
    total = steps * batch_size
    idx = np.resize(np.arange(n), total)
    mask = np.zeros(total, dtype=np.float32)
    mask[:n] = 1.0
    return (
        x[idx].reshape(steps, batch_size, *x.shape[1:]),
        y[idx].reshape(steps, batch_size, *y.shape[1:]),
        mask.reshape(steps, batch_size),
    )
