"""ModelBundle — the model contract (port of ``fedml_tpu/models/base.py``).

An ``nn.Module`` whose parameters and buffers are placeholders on the
``meta`` device, plus pure ``init`` / ``apply_train`` / ``apply_eval``
functions over an explicit variables dict

    {"params": {name: Tensor}, "batch_stats": {name: Tensor}}

keyed by the module's state names (``Bottleneck_3.Conv_1.kernel``),
which are the flax names joined with dots.  The forward runs through
``torch.func.functional_call``, so the caller owns every tensor: FedAvg
averages ``batch_stats`` as visibly as ``params``.

Train-mode BatchNorm does not mutate the module: each norm layer writes
its new running statistics into the ``updates`` dict the forward is
handed, under its own state names, and ``apply_train`` returns them as
the new ``batch_stats``.  A model with dropout (``needs_dropout_rng``)
is also handed the step's threefry key, and each ``Dropout`` draws its
mask from that key folded with its own scope name, as flax does.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import threading
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.core import rng as rnglib

Variables = Dict[str, Dict[str, torch.Tensor]]

# ``torch.func.functional_call`` swaps the module's placeholders for the
# given tensors for the length of the call, in place: two threads calling it
# on one module (the clients of one process, each on its transport's reader
# thread) would each run on the other's tensors.  Every call goes through
# ``functional_call`` below, one at a time (reentrant: a model may call a
# sub-module's functional form inside its own forward).
_CALL_LOCK = threading.RLock()


def functional_call(module: nn.Module, state: dict, args: tuple, kwargs=None):
    """``torch.func.functional_call`` under the process's call lock."""
    with _CALL_LOCK:
        return torch.func.functional_call(module, state, args, kwargs)


# flax's lecun_normal: variance_scaling(1, "fan_in", "truncated_normal");
# the constant is the std of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978
# the order in which flax modules create their parameters in one scope
# (Dense/Conv: kernel, bias; BatchNorm/LayerNorm: scale, bias)
_CREATION_ORDER = {"kernel": 0, "embedding": 0, "scale": 0, "bias": 1}
# the hidden-side Dense scopes of flax's LSTMCell, whose kernels flax draws
# with ``orthogonal()`` (the input side ``ii``/``if``/``ig``/``io`` is
# lecun-normal like any Dense kernel)
_RECURRENT_SCOPES = frozenset(("hi", "hf", "hg", "ho"))


def meta_param(*shape: int) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, device="meta"))


def name_state_owners(module: nn.Module) -> None:
    """Give every submodule its state-name prefix (``Bottleneck_0.``),
    which norm layers use to key the statistics they emit."""
    for name, m in module.named_modules():
        m.state_prefix = f"{name}." if name else ""


def fold_in_static(key: rnglib.Key, parts: Sequence) -> rnglib.Key:
    """flax's ``_fold_in_static``: fold the first 4 bytes (big-endian) of
    the SHA-1 of the scope names and rng counter into ``key`` (no
    separators: ``flax_fix_rng_separator`` is off by default)."""
    if not parts:
        return key
    m = hashlib.sha1()
    for x in parts:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(int(x).to_bytes((int(x).bit_length() + 7) // 8, "big"))
    return rnglib.fold_in(key, int.from_bytes(m.digest()[:4], "big"))


def param_keys(key: rnglib.Key, names: Sequence[str]) -> Dict[str, rnglib.Key]:
    """The key flax's ``init`` hands each parameter's initializer: the
    root key folded with the parameter's scope path (``Bottleneck_3``,
    ``Conv_1``) and that scope's ``params`` counter, which counts the
    scope's parameters in creation order from 1."""
    scopes: Dict[Tuple[str, ...], list] = {}
    for name in names:
        *path, leaf = name.split(".")
        if leaf not in _CREATION_ORDER:
            raise ValueError(f"no flax creation order for parameter {name!r}")
        scopes.setdefault(tuple(path), []).append(name)
    keys = {}
    for path, members in scopes.items():
        members.sort(key=lambda n: _CREATION_ORDER[n.rsplit(".", 1)[-1]])
        for counter, name in enumerate(members, start=1):
            keys[name] = fold_in_static(key, (*path, counter))
    return keys


def _fan_in(shape, in_axis: int, out_axis: int) -> float:
    """``jax.nn.initializers._compute_fans``'s fan-in, in its float steps."""
    receptive = math.prod(shape) / shape[in_axis] / shape[out_axis]
    return shape[in_axis] * receptive


def _orthogonal(key, shape, device) -> torch.Tensor:
    """``jax.nn.initializers.orthogonal()`` for a ``[rows, cols]`` kernel:
    Q of the QR of a ``normal`` draw, times ``sign(diag(R))``.  The draw
    runs on ``device``; the QR runs on the host in float32 through
    scipy's LAPACK (``geqrf``/``orgqr``), the routines jax's CPU QR calls
    through scipy, so Q is jax's bit for bit and the card's init is the
    CPU's.  ``torch.linalg.qr`` is not used: it misses jax's Q by up to
    ~1e-6 on the CPU, and on the card it would be cuSOLVER's."""
    import scipy.linalg

    rows, cols = shape
    a = rnglib.normal(key, (cols, rows) if rows < cols else (rows, cols), device)
    q, r = scipy.linalg.qr(a.cpu().numpy(), mode="economic")
    q = (q * np.sign(np.diag(r))).astype(np.float32)
    if rows < cols:
        q = q.T
    return torch.from_numpy(np.ascontiguousarray(q)).to(device)


def _init_leaf(name: str, shape, key, device) -> torch.Tensor:
    """flax's initializers by leaf name, in float32 on ``device``: conv/dense
    ``kernel`` lecun-normal (``truncated_normal(-2, 2)`` times
    ``√(1/fan_in)/0.8796…``, fan-in = every axis but the last), except an
    LSTM cell's hidden-side kernels (scope ``hi``/``hf``/``hg``/``ho``),
    which are orthogonal; ``embedding`` flax's ``default_embed_init``
    (``normal`` times ``√(1/fan_in)``, with in and out axis 0: fan-in =
    every axis but the first), ``bias``/``mean`` zeros, ``scale``/``var``
    ones."""
    *path, leaf = name.split(".")
    f32 = np.float32
    shape = tuple(int(s) for s in shape)
    if leaf == "kernel" and path and path[-1] in _RECURRENT_SCOPES:
        return _orthogonal(key, shape, device)
    if leaf == "kernel":
        variance = f32(1.0 / _fan_in(shape, -2, -1))
        std = f32(np.sqrt(variance)) / f32(_TRUNC_STD)
        return rnglib.truncated_normal(key, -2.0, 2.0, shape, device) * float(std)
    if leaf == "embedding":
        variance = f32(1.0 / _fan_in(shape, 0, 0))
        return rnglib.normal(key, shape, device) * float(f32(np.sqrt(variance)))
    if leaf in ("bias", "mean"):
        return torch.zeros(shape, device=device)
    if leaf in ("scale", "var"):
        return torch.ones(shape, device=device)
    raise ValueError(f"no initializer for variable {name!r}")


class Dense(nn.Module):
    """flax ``nn.Dense``: ``[in, out]`` kernel, plus a bias unless
    ``use_bias=False``."""

    def __init__(self, cin: int, cout: int, use_bias: bool = True):
        super().__init__()
        self.kernel = meta_param(cin, cout)
        self.bias = meta_param(cout) if use_bias else None

    def forward(self, x):
        y = x @ self.kernel.to(x.dtype)
        return y if self.bias is None else y + self.bias.to(x.dtype)


class Embed(nn.Module):
    """flax ``nn.Embed``: a ``[num_embeddings, features]`` table."""

    def __init__(self, num_embeddings: int, features: int):
        super().__init__()
        self.embedding = meta_param(num_embeddings, features)

    def forward(self, ids):
        return F.embedding(ids.long(), self.embedding)

    def attend(self, h):
        """The weight-tied head: ``h @ embeddingᵀ``."""
        return h @ self.embedding.to(h.dtype).T


class Dropout(nn.Module):
    """flax ``nn.Dropout(rate)``: in train mode, keep each element with
    probability ``1 − rate`` and scale the kept ones by ``1/(1 − rate)``.

    The mask is ``bernoulli(key, 1 − rate)`` (``core/rng.py``) under the
    key flax's ``make_rng("dropout")`` gives this scope: the step key
    folded with the scope path and the scope's rng counter 1.  The kept
    values are divided by ``1 − rate`` held in a tensor: CUDA's division
    by a Python scalar multiplies by the reciprocal and changes bits."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, train: bool, rng):
        if not train or self.rate == 0.0:
            return x
        if rng is None:
            raise ValueError(f"{self.state_prefix}Dropout in train mode needs "
                             "the step key (ModelBundle.apply_train's rng)")
        key = fold_in_static(rng, (*self.state_prefix[:-1].split("."), 1))
        keep = 1.0 - self.rate
        mask = rnglib.bernoulli(key, keep, x.shape, x.device)
        return torch.where(mask, x / torch.tensor(keep, dtype=x.dtype, device=x.device),
                           torch.zeros((), dtype=x.dtype, device=x.device))


@dataclasses.dataclass
class ModelBundle:
    """An ``nn.Module`` + its input spec + the device its variables live on."""

    module: nn.Module
    input_shape: Sequence[int]  # one example's shape, no batch dim
    device: torch.device
    input_dtype: torch.dtype = torch.float32
    # the forward takes the step key (``rng=``) for its Dropout layers
    needs_dropout_rng: bool = False

    def __post_init__(self):
        name_state_owners(self.module)

    def init(self, key: rnglib.Key) -> Variables:
        """The variables ``flax`` ``init`` draws from the threefry ``key``
        (``PRNGKey(seed)``) for the same module, bit for bit: each
        parameter from its own key (``param_keys``).  Drawn on ``device``:
        the draws are integer and correctly rounded float arithmetic, the
        same bits on the CPU and the card, and the card draws the bench
        transformer's 236M values far faster than the CPU."""
        names = [n for n, _ in self.module.named_parameters()]
        keys = param_keys(key, names)
        out = {"params": {
            n: _init_leaf(n, p.shape, keys[n], self.device)
            for n, p in self.module.named_parameters()}}
        stats = {n: _init_leaf(n, b.shape, None, self.device)
                 for n, b in self.module.named_buffers()}
        if stats:
            out["batch_stats"] = stats
        return out

    def _call(self, variables: Variables, x: torch.Tensor, train: bool,
              updates: dict, rng=None):
        state = {**variables["params"], **variables.get("batch_stats", {})}
        kwargs = {"train": train, "updates": updates}
        if self.needs_dropout_rng:
            kwargs["rng"] = rng
        return functional_call(self.module, state, (x,), kwargs)

    def apply_train(self, variables: Variables, x: torch.Tensor,
                    rng=None) -> Tuple[torch.Tensor, Variables]:
        """Forward in train mode; returns (logits, updated variables).
        ``rng`` is the step's threefry key (``core/rng.py``), as the JAX
        contract hands it; a model with ``needs_dropout_rng`` draws its
        dropout masks from it, the others ignore it."""
        updates: dict = {}
        logits = self._call(variables, x, True, updates, rng)
        if "batch_stats" in variables:
            variables = {**variables,
                         "batch_stats": {**variables["batch_stats"], **updates}}
        return logits, variables

    def apply_eval(self, variables: Variables, x: torch.Tensor) -> torch.Tensor:
        return self._call(variables, x, False, {})
