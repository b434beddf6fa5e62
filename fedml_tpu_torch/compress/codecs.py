"""Deterministic update codecs: quantization, sparsification, bf16 (port
of ``fedml_tpu/compress/codecs.py``).

- ``qsgd8`` / ``qsgd4`` (aliases ``int8`` / ``int4``): QSGD stochastic
  uniform quantization with a max-abs scale per 256-value chunk; unbiased
  per element, worst-case error ``chunk_max / levels``.
- ``topk<rate>`` (e.g. ``topk0.01``): magnitude top-k, int32 indices and
  exact fp32 values, zeros elsewhere.  Biased: run it with error feedback.
- ``bf16``: a bfloat16 cast (deterministic, 2x, no rng).
- ``none``: identity (the fp32 control arm).

Every draw is the JAX package's, bit for bit: leaf ``i`` of a tree is
encoded under ``fold_in(key, i)`` (``core/rng.py``), and the leaves are
numbered in ``jax.tree_util.tree_leaves`` order, which sorts the keys at
every level of the flax tree: ``batch_stats`` before ``params``,
``Bottleneck_10`` before ``Bottleneck_2``.  The port's variables are flat
dicts keyed by dotted flax paths in module order, so the order is
derived from the paths (``jax_leaves``), never from the dict.

Two forms compute the same bits:

- per leaf: ``LeafCodec.encode`` / ``decode`` and the tree functions over
  them (``encode_tree``, ``roundtrip_tree``, the wire forms).  This is
  the plain version and the wire path;
- fused (``FlatLayout`` + ``roundtrip_flat``): every leaf laid end to end
  in one fp32 vector and, for QSGD, padded to whole chunks in one
  ``[M, 256]`` grid (no chunk spans two leaves), so one threefry pass
  draws every leaf's uniforms (each chunk carries its leaf's key words,
  the counter is the element's index within its leaf) and one
  scale/divide/floor/clip quantises them all.  This is what the round
  runs: a few hundred kernel launches per client where the per-leaf
  form takes some fifty thousand on ResNet-56's 292 leaves.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fedml_tpu_torch.core import rng as rnglib
from fedml_tpu_torch.utils.topk import top_k_indices

Tree = Any

# the v1 wire format's base64 array leaf (``fedml_tpu/comm/message.py``)
NDARRAY_KEY = "__ndarray__"
# sub-streams under the round key: fold_in(k_round, 0) = training, 1 =
# aggregation noise, 2 = update compression (per-client keys then fold in
# the GLOBAL slot id), 3 = the cross-device server's downlink broadcast
COMPRESS_STREAM = 2
BCAST_STREAM = 3

_CHUNK = 256  # one fp32 scale per 256 values


# --- leaf order --------------------------------------------------------------

def _paths(tree: Tree, prefix: Tuple[str, ...] = ()) -> Iterator:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + tuple(str(k).split(".")))
    else:
        yield prefix, tree


def jax_leaves(tree: Tree) -> List[Tuple[Tuple[str, ...], Any]]:
    """``(flax path, leaf)`` pairs in ``jax.tree_util.tree_leaves`` order:
    a dotted key (``Bottleneck_3.Conv_1.kernel``) is its flax path."""
    return sorted(_paths(tree), key=lambda item: item[0])


def unflatten_like(like: Tree, leaves: Sequence) -> Tree:
    """``leaves`` (in ``jax_leaves(like)`` order) in ``like``'s structure."""
    by_path = dict(zip((p for p, _ in jax_leaves(like)), leaves))

    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(v, prefix + tuple(str(k).split(".")))
                    for k, v in node.items()}
        return by_path[prefix]

    return walk(like, ())


def _numel(shape) -> int:
    return int(np.prod(shape, dtype=np.int64))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A payload tensor as numpy; bf16 as its uint16 bit pattern (numpy
    has no bfloat16; the bytes are the same)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _to_tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))  # a writable copy


# --- codecs --------------------------------------------------------------------

class LeafCodec:
    """One leaf's encode/decode pair.  ``encode(x, key)`` returns a flat
    dict of tensors (the payload), ``decode(enc, shape)`` the fp32 leaf;
    ``payload_nbytes(n)`` is the exact wire size of an n-element leaf."""

    name: str = "?"
    stochastic: bool = False  # True: encode consumes the key

    def encode(self, x: torch.Tensor, key) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def decode(self, enc: Dict[str, torch.Tensor], shape) -> torch.Tensor:
        raise NotImplementedError

    def payload_nbytes(self, n: int) -> int:
        raise NotImplementedError

    # wire hooks: pack/unpack numpy payloads (default: passthrough)
    def wire_pack(self, enc: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        return enc

    def wire_unpack(self, enc: Dict[str, np.ndarray], shape) -> Dict[str, np.ndarray]:
        return enc


class IdentityCodec(LeafCodec):
    name = "none"

    def encode(self, x, key):
        del key
        return {"v": x.float().reshape(-1)}

    def decode(self, enc, shape):
        return enc["v"].float().reshape(shape)

    def payload_nbytes(self, n):
        return 4 * n


class Bf16Codec(LeafCodec):
    name = "bf16"

    def encode(self, x, key):
        del key
        return {"v": x.float().reshape(-1).to(torch.bfloat16)}

    def decode(self, enc, shape):
        v = enc["v"]
        if v.dtype != torch.bfloat16:  # a wire payload: the uint16 bits
            v = v.view(torch.bfloat16)
        return v.float().reshape(shape)

    def payload_nbytes(self, n):
        return 2 * n

    def wire_unpack(self, enc, shape):
        # the bits as int16, which torch can reinterpret as bfloat16
        return {"v": np.asarray(enc["v"]).view(np.int16)}


class QsgdCodec(LeafCodec):
    """QSGD stochastic uniform quantization, per-chunk max-abs scale:
    ``q = clip(floor(x / scale · L + u), −L, L)`` with ``u ~ U[0, 1)``
    over the zero-padded ``[m, 256]`` chunks, shipped as int8 (int4 packs
    two per byte on the wire).  A zero chunk encodes to zeros."""

    stochastic = True

    def __init__(self, bits: int):
        assert bits in (4, 8)
        self.bits = bits
        self.name = f"qsgd{bits}"
        self.levels = 7 if bits == 4 else 127

    def quantize(self, chunks: torch.Tensor, u: torch.Tensor):
        """``(q, scale)`` of ``[m, 256]`` chunks under uniforms ``u``, in
        JAX's op order."""
        scale = chunks.abs().amax(dim=1)
        safe = torch.where(scale > 0, scale, torch.ones_like(scale))
        y = chunks / safe[:, None] * self.levels
        return torch.clamp(torch.floor(y + u), -self.levels, self.levels), scale

    def dequantize(self, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        # divide by a tensor: PyTorch's CUDA division by a Python scalar
        # multiplies by its reciprocal, which is not IEEE division
        levels = torch.full_like(scale, self.levels)
        return q * (scale / levels)[:, None]

    def encode(self, x, key):
        flat = x.float().reshape(-1)
        n = flat.shape[0]
        m = -(-n // _CHUNK)
        chunks = F.pad(flat, (0, m * _CHUNK - n)).reshape(m, _CHUNK)
        u = rnglib.uniform(key, chunks.shape, chunks.device)
        q, scale = self.quantize(chunks, u)
        # the padded tail is not shipped
        return {"q": q.to(torch.int8).reshape(-1)[:n], "scale": scale}

    def decode(self, enc, shape):
        n = _numel(shape)
        m = -(-n // _CHUNK)
        q = F.pad(enc["q"].float(), (0, m * _CHUNK - n)).reshape(m, _CHUNK)
        out = self.dequantize(q, enc["scale"].float())
        return out.reshape(-1)[:n].reshape(shape)

    def payload_nbytes(self, n):
        m = -(-n // _CHUNK)
        if self.bits == 8:
            return n + 4 * m
        return (n + 1) // 2 + 4 * m + 8  # packed nibbles, scales, qn

    # -- int4 wire packing: two values per byte ------------------------------
    def wire_pack(self, enc):
        if self.bits != 4:
            return enc
        q = np.asarray(enc["q"], np.int8)
        u = (q.astype(np.int16) + 8).astype(np.uint8)  # [-7, 7] -> [1, 15]
        if u.size % 2:
            u = np.concatenate([u, np.zeros(1, np.uint8)])
        packed = ((u[0::2] << 4) | u[1::2]).astype(np.uint8)
        return {"q4": packed, "scale": np.asarray(enc["scale"]),
                "qn": np.asarray(q.size, np.int64)}

    def wire_unpack(self, enc, shape):
        if self.bits != 4 or "q4" not in enc:
            return enc
        packed = np.asarray(enc["q4"], np.uint8)
        qn = int(enc["qn"])
        u = np.empty(packed.size * 2, np.uint8)
        u[0::2] = packed >> 4
        u[1::2] = packed & 0x0F
        q = (u[:qn].astype(np.int16) - 8).astype(np.int8)
        return {"q": q, "scale": np.asarray(enc["scale"])}


class TopKCodec(LeafCodec):
    """Magnitude top-k: ``k = max(1, round(rate · size))`` largest-|x|
    entries (the lower index first among equal magnitudes, as
    ``jax.lax.top_k``), shipped in index order as (int32 index, fp32
    value); decode scatters them into zeros.  Deterministic (no rng)."""

    def __init__(self, rate: float):
        if not 0.0 < rate <= 1.0:
            raise ValueError(f"topk rate must be in (0, 1], got {rate}")
        self.rate = rate
        self.name = f"topk{rate:g}"

    def _k(self, n: int) -> int:
        return max(1, min(n, int(round(self.rate * n))))

    def encode(self, x, key):
        del key
        flat = x.float().reshape(-1)
        idx = torch.sort(top_k_indices(flat.abs(), self._k(flat.shape[0]))).values
        return {"idx": idx.to(torch.int32), "val": flat[idx]}

    def decode(self, enc, shape):
        out = torch.zeros(_numel(shape), dtype=torch.float32,
                          device=enc["val"].device)
        out[enc["idx"].long()] = enc["val"].float()
        return out.reshape(shape)

    def payload_nbytes(self, n):
        return 8 * self._k(n)


def get_codec(name: Optional[str]) -> Optional[LeafCodec]:
    """Codec registry: ``none``/''/None, ``bf16``, ``int8``/``qsgd8``,
    ``int4``/``qsgd4``, ``topk<rate>`` (default rate 0.01)."""
    if name is None or name in ("", "none", "fp32"):
        return None
    if name == "bf16":
        return Bf16Codec()
    if name in ("int8", "qsgd8"):
        return QsgdCodec(8)
    if name in ("int4", "qsgd4"):
        return QsgdCodec(4)
    if name.startswith("topk"):
        rate = name[len("topk"):]
        return TopKCodec(float(rate) if rate else 0.01)
    raise ValueError(
        f"unknown codec {name!r} (known: none, bf16, int8/qsgd8, "
        "int4/qsgd4, topk<rate>)")


# --- tree-level plumbing: the per-leaf (plain) form ----------------------------

def _leaf_keys(key, num_leaves: int) -> np.ndarray:
    return rnglib.fold_in_many(key, np.arange(num_leaves))


def encode_tree(codec: LeafCodec, tree: Tree, key) -> List[Dict[str, torch.Tensor]]:
    """Encode every leaf; encodings in ``jax_leaves(tree)`` order."""
    leaves = [leaf for _, leaf in jax_leaves(tree)]
    return [codec.encode(leaf, k)
            for leaf, k in zip(leaves, _leaf_keys(key, len(leaves)))]


def decode_tree(codec: LeafCodec, encs: List[Dict[str, torch.Tensor]],
                like: Tree) -> Tree:
    """Decode against a structural template; every leaf comes back fp32."""
    leaves_like = [leaf for _, leaf in jax_leaves(like)]
    assert len(encs) == len(leaves_like), "codec/tree leaf count mismatch"
    return unflatten_like(like, [codec.decode(e, tuple(ref.shape))
                                 for e, ref in zip(encs, leaves_like)])


def roundtrip_tree(codec: LeafCodec, tree: Tree, key) -> Tree:
    """``decode(encode(tree))`` leaf by leaf: the server's view of an
    update, the plain version ``roundtrip_flat`` is held to."""
    return decode_tree(codec, encode_tree(codec, tree, key), tree)


# --- wire forms (numpy payloads) --------------------------------------------------

def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).split(".")[-1]


def wire_encode_tree(codec: LeafCodec, tree: Tree, key) -> List[dict]:
    """Per-leaf wire entries ``{"enc": {name: np.ndarray}, "shape",
    "dtype"}`` with raw numpy payloads, in ``jax_leaves`` order."""
    out = []
    for (_, leaf), enc in zip(jax_leaves(tree), encode_tree(codec, tree, key)):
        out.append({
            "enc": codec.wire_pack({k: _to_numpy(v) for k, v in enc.items()}),
            "shape": list(leaf.shape),
            "dtype": _dtype_name(leaf),
        })
    return out


def wire_decode_tree(codec: LeafCodec, entries: List[dict], like: Tree) -> Tree:
    """Inverse of ``wire_encode_tree`` on the host: fp32 CPU tensors in
    the template's structure."""
    leaves_like = [leaf for _, leaf in jax_leaves(like)]
    assert len(entries) == len(leaves_like), "wire/tree leaf count mismatch"
    out = []
    for e, ref in zip(entries, leaves_like):
        shape = tuple(e.get("shape") or ref.shape)
        enc = codec.wire_unpack({k: np.asarray(v) for k, v in e["enc"].items()},
                                shape)
        out.append(codec.decode({k: _to_tensor(v) for k, v in enc.items()},
                                shape).float())
    return unflatten_like(like, out)


def encoded_nbytes(codec: Optional[LeafCodec], tree: Tree) -> int:
    """Exact wire payload bytes of the encoded tree (buffers only, no
    envelope), from the shapes alone; fp32 for no codec."""
    sizes = [_numel(leaf.shape) for _, leaf in jax_leaves(tree)]
    if codec is None:
        return sum(4 * n for n in sizes)
    return sum(codec.payload_nbytes(n) for n in sizes)


def wire_tree_digest(wire_obj: dict) -> str:
    """sha256 over a wiretree's payload buffers in leaf order: two runs
    at the same seed must produce identical encoded uploads, and this
    digest proves it without keeping the frames."""
    h = hashlib.sha256()
    for leaf in wire_obj.get("leaves", ()):
        if isinstance(leaf, dict) and "enc" in leaf:
            for name in sorted(leaf["enc"]):
                h.update(_leaf_bytes(leaf["enc"][name]))
        elif isinstance(leaf, dict) and NDARRAY_KEY in leaf:
            h.update(str(leaf[NDARRAY_KEY]).encode())
        else:
            h.update(_leaf_bytes(leaf))
    return h.hexdigest()


def _leaf_bytes(x) -> bytes:
    """A payload's bytes in C order: a tensor's from the host (bf16 as its
    bit pattern, as JAX's ``ml_dtypes`` array holds it), numpy's as is."""
    if isinstance(x, torch.Tensor):
        return _to_numpy(x).tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


# --- the fused form ---------------------------------------------------------------

class FlatLayout:
    """A tree's leaves in ``jax_leaves`` order laid end to end in one fp32
    vector of ``numel`` values, and every leaf padded to whole 256-value
    chunks in one ``[num_chunks, 256]`` grid, built once per tree shape.

    ``pos`` places each flat value in the grid, ``counter`` holds each
    grid cell's index within its leaf (the threefry counter of JAX's
    per-leaf draw) and ``chunk_leaf`` each chunk's leaf."""

    def __init__(self, like: Tree, device=None):
        leaves = [leaf for _, leaf in jax_leaves(like)]
        self.shapes = [tuple(leaf.shape) for leaf in leaves]
        self.dtypes = [leaf.dtype for leaf in leaves]
        self.sizes = [_numel(s) for s in self.shapes]
        self.offsets = np.concatenate([[0], np.cumsum(self.sizes)]).astype(np.int64)
        self.numel = int(self.offsets[-1])
        chunks = np.array([-(-n // _CHUNK) for n in self.sizes], np.int64)
        chunk_off = np.concatenate([[0], np.cumsum(chunks)])
        self.num_chunks = int(chunk_off[-1])
        self.chunk_leaf = np.repeat(np.arange(len(leaves)), chunks)
        self.device = device
        pos = np.concatenate([chunk_off[i] * _CHUNK + np.arange(n)
                              for i, n in enumerate(self.sizes)])
        counter = np.concatenate([np.arange(m * _CHUNK) for m in chunks])
        self.pos = torch.from_numpy(pos.astype(np.int64)).to(device)
        self.counter = torch.from_numpy(counter.astype(np.int64)).to(device).reshape(
            self.num_chunks, _CHUNK)

    def flatten(self, tree: Tree) -> torch.Tensor:
        """The tree's leaves as one fp32 vector."""
        return torch.cat([leaf.reshape(-1).float() for _, leaf in jax_leaves(tree)])

    def split(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """``flat`` cut back into fp32 leaves (views)."""
        return [flat[self.offsets[i]:self.offsets[i + 1]].view(shape)
                for i, shape in enumerate(self.shapes)]

    def unflatten(self, flat: torch.Tensor, like: Tree) -> Tree:
        """``flat`` as a tree of ``like``'s structure and leaf dtypes."""
        return unflatten_like(like, [v.to(dt) for v, dt in
                                     zip(self.split(flat), self.dtypes)])

    def row(self, store: Tree, slot: int) -> torch.Tensor:
        """Row ``slot`` of a ``[num_clients, ...]`` store as one vector."""
        return torch.cat([leaf[slot].reshape(-1) for _, leaf in jax_leaves(store)])

    def set_row(self, store: Tree, slot: int, flat: torch.Tensor) -> None:
        """Write ``flat`` into row ``slot`` of the store, in place."""
        for (_, leaf), v in zip(jax_leaves(store), self.split(flat)):
            leaf[slot].copy_(v)

    def grid(self, flat: torch.Tensor) -> torch.Tensor:
        """``flat`` zero-padded leaf by leaf into the ``[M, 256]`` grid."""
        g = flat.new_zeros(self.num_chunks * _CHUNK)
        g[self.pos] = flat
        return g.view(self.num_chunks, _CHUNK)

    def uniforms(self, key) -> torch.Tensor:
        """Every leaf's ``uniform(fold_in(key, i), [m_i, 256])`` over the
        grid, in one threefry pass."""
        words = _leaf_keys(key, len(self.shapes))[self.chunk_leaf].astype(np.int64)
        words = torch.from_numpy(words).to(self.counter.device)
        b1, b2 = rnglib.threefry2x32(words[:, :1], words[:, 1:], 0, self.counter)
        return rnglib.uniform_from_bits(b1 ^ b2)


def roundtrip_flat(codec: LeafCodec, flat: torch.Tensor, key,
                   layout: FlatLayout) -> torch.Tensor:
    """``roundtrip_tree`` over the flat vector of a tree: the same bits,
    QSGD in one pass over the chunk grid (top-k stays per leaf: each leaf
    keeps its own k)."""
    if isinstance(codec, IdentityCodec):
        return flat
    if isinstance(codec, Bf16Codec):
        return flat.to(torch.bfloat16).float()
    if isinstance(codec, QsgdCodec):
        q, scale = codec.quantize(layout.grid(flat), layout.uniforms(key))
        return codec.dequantize(q, scale).view(-1)[layout.pos]
    leaves = layout.split(flat)
    return torch.cat([codec.decode(codec.encode(v, k), v.shape).reshape(-1)
                      for v, k in zip(leaves, _leaf_keys(key, len(leaves)))])


def uplink_roundtrip(codec: LeafCodec, layout: FlatLayout, global_flat: torch.Tensor,
                     client_vars: Tree, like: Tree, key,
                     residual: Optional[torch.Tensor] = None):
    """One client's update through the lossy uplink: ``delta = c − g`` in
    fp32 (plus the error-feedback ``residual``), its decoded form, and
    what the server reconstructs, ``g + decode(encode(delta))`` in each
    leaf's dtype.  Returns ``(server_view_vars, delta − decoded)``: the
    second is the new residual."""
    delta = layout.flatten(client_vars) - global_flat
    if residual is not None:
        delta = delta + residual
    dec = roundtrip_flat(codec, delta, key, layout)
    return layout.unflatten(global_flat + dec, like), delta - dec
