"""Checkpoint/resume for federated training state (port of the npz path of
``fedml_tpu/core/checkpoint.py``).

The full round state (global variables, server optimizer state, round
index, threefry key) is one explicit tree of dicts, tuples, tensors,
numpy arrays and Python numbers, so persistence is an npz of its leaves
plus a description of its structure: resume = load + continue,
bit-identical.  Orbax is the JAX package's and has no counterpart here.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

Tree = Any


class UnreadableCheckpoint(Exception):
    """An on-disk checkpoint that cannot be decoded (truncated by a crash,
    garbage bytes), as distinct from a template mismatch, which is a
    caller error and always raises."""


def _flatten(tree: Tree) -> Tuple[List[Tuple[str, Any]], str]:
    """(leaves as (path, value), structure string).  Each leaf's tag in
    the structure names its kind and dtype."""
    leaves: List[Tuple[str, Any]] = []

    def walk(node, path):
        if isinstance(node, dict):  # key order is not structure
            return "{" + ",".join(f"{k!r}:{walk(node[k], f'{path}/{k}')}"
                                  for k in sorted(node, key=str)) + "}"
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            inner = ",".join(f"{f}={walk(v, f'{path}/{f}')}"
                             for f, v in zip(node._fields, node))
            return f"{type(node).__name__}({inner})"
        if isinstance(node, (tuple, list)):
            inner = ",".join(walk(v, f"{path}/{i}") for i, v in enumerate(node))
            return ("(" + inner + ")") if isinstance(node, tuple) else ("[" + inner + "]")
        if node is None:
            return "None"
        if isinstance(node, torch.Tensor):
            tag = f"T:{str(node.dtype).split('.')[-1]}"
        elif isinstance(node, np.ndarray):
            tag = f"N:{node.dtype}"
        elif isinstance(node, (bool, int, float)):
            tag = type(node).__name__
        else:
            raise TypeError(f"cannot checkpoint a {type(node).__name__} at {path}")
        leaves.append((path, node))
        return tag

    return leaves, walk(tree, "")


def _to_numpy(leaf) -> np.ndarray:
    """The leaf on the host; a bf16 tensor as its int16 bits (numpy has no
    bfloat16)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy()
    return np.asarray(leaf)


def _like(template, value: np.ndarray):
    """``value`` as the template leaf's type, dtype and device."""
    if isinstance(template, torch.Tensor):
        t = torch.from_numpy(np.ascontiguousarray(value))
        if template.dtype == torch.bfloat16:
            t = t.view(torch.bfloat16)
        return t.to(device=template.device, dtype=template.dtype)
    if isinstance(template, np.ndarray):
        return np.asarray(value, dtype=template.dtype)
    return type(template)(value.item())


def _rebuild(template: Tree, values: List) -> Tree:
    it = iter(values)

    def walk(node):
        if isinstance(node, dict):
            built = {k: walk(node[k]) for k in sorted(node, key=str)}
            return {k: built[k] for k in node}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(v) for v in node))
        if isinstance(node, (tuple, list)):
            return type(node)(walk(v) for v in node)
        if node is None:
            return None
        return _like(node, next(it))

    return walk(template)


class CheckpointManager:
    """``ckpt_<step>.npz`` files in one directory.

    Usage::

        mgr = CheckpointManager(dir, max_to_keep=3)
        mgr.save(step, state)            # state: ServerState or any tree
        state = mgr.restore(like=state)  # latest readable step
        mgr.latest_step()
    """

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep

    def save(self, step: int, state: Tree) -> None:
        leaves, structure = _flatten(state)
        arrays = {f"leaf_{i}": _to_numpy(v) for i, (_, v) in enumerate(leaves)}
        arrays["__treedef__"] = np.frombuffer(structure.encode(), dtype=np.uint8)
        # write-then-rename: a crash mid-save leaves a .tmp that no step
        # listing matches, never a truncated ckpt_<step>.npz
        final = os.path.join(self.directory, f"ckpt_{step}.npz")
        tmp = final + ".tmp"
        try:
            with open(tmp, "wb") as fh:
                np.savez(fh, **arrays)
            os.replace(tmp, final)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        for s in sorted(self._steps())[: -self.max_to_keep]:
            os.remove(os.path.join(self.directory, f"ckpt_{s}.npz"))

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return max(steps) if steps else None

    def restore(self, like: Tree, step: Optional[int] = None) -> Tree:
        """Restore ``step`` (default: the latest READABLE one) with ``like``
        as the template for structure, dtypes and devices.

        With no ``step``, an unreadable checkpoint is skipped with a
        warning and the next older one tried.  A checkpoint whose
        structure or leaf shapes differ from the template's (another
        model) raises ``ValueError``.  An explicit ``step`` raises on any
        failure."""
        if step is not None:
            return self._restore_step(step, like)
        steps = sorted(self._steps(), reverse=True)
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        last_err: Optional[Exception] = None
        for s in steps:
            try:
                return self._restore_step(s, like)
            except UnreadableCheckpoint as e:
                last_err = e
                logging.warning("checkpoint step %d in %s is unreadable (%s); "
                                "trying the previous one", s, self.directory,
                                e.__cause__ or e)
        raise FileNotFoundError(
            f"no readable checkpoint in {self.directory} (steps tried: {steps})"
        ) from last_err

    def _restore_step(self, step: int, like: Tree) -> Tree:
        leaves, structure = _flatten(like)
        path = os.path.join(self.directory, f"ckpt_{step}.npz")
        try:
            with np.load(path) as z:
                saved = bytes(z["__treedef__"]).decode()
                raw = None
                if saved == structure:
                    raw = [np.array(z[f"leaf_{i}"]) for i in range(len(leaves))]
        except Exception as e:  # any decode failure: a damaged file
            raise UnreadableCheckpoint(f"npz step {step} unreadable") from e
        if raw is None:
            raise ValueError(
                "checkpoint tree structure does not match the restore "
                f"template:\n saved: {saved}\n template: {structure}")
        bad = [f"{p}: saved {v.shape} vs template {np.shape(t)}"
               for (p, t), v in zip(leaves, raw) if tuple(np.shape(t)) != v.shape]
        if bad:
            raise ValueError(
                "checkpoint leaf shapes do not match the restore template "
                "(was the model built with other hyperparameters?):\n "
                + "\n ".join(bad))
        return _rebuild(like, raw)

    def _steps(self) -> List[int]:
        # strict ckpt_<int>.npz: a stray file or a leftover .tmp is no step
        return [int(m.group(1)) for f in os.listdir(self.directory)
                if (m := re.fullmatch(r"ckpt_(\d+)\.npz", f))]
