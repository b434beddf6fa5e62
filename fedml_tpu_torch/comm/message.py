"""Message envelope and the FL control-plane vocabulary (port of
``fedml_tpu/comm/message.py``).

Reference ``fedml_core/distributed/communication/message.py:5-74``: a typed
key-value envelope with reserved keys for type/sender/receiver and a JSON
codec; model weights travel inside the dict (``MSG_ARG_KEY_MODEL_PARAMS``).
The semantic message types come from
``fedml_api/distributed/fedavg/message_define.py:6-31``.

Arrays travel as nested lists (``tensor_to_list``, the reference's mobile
codec), as base64 buffers (wiretree v1), or as **wiretree v2**: raw
leaves that the frame codec (``to_frame``/``from_frame``) ships as
length-prefixed binary buffers after a one-line JSON header.  A v2
wiretree may carry a ``codec`` name (``compress`` registry) and a
``delta`` flag: its leaves are then per-leaf codec encodings of a model
update.

The wire is the JAX package's, byte for byte, so a torch peer and a JAX
peer read each other's frames:

- a leaf may be a numpy array or a torch tensor on any device; it travels
  as host bytes under its numpy dtype name (``"float32"``,
  ``"bfloat16"``, ...), never torch's (``"torch.float32"``);
- numpy has no bfloat16 without ``ml_dtypes``, which the port does not
  use: a ``"bfloat16"`` buffer is written from, and decoded to, a torch
  ``bfloat16`` tensor through its uint16 bit pattern; every other dtype
  decodes to a numpy array (read-only views into the frame, as in JAX);
- a tree's leaves are flattened in ``jax.tree_util`` order
  (``compress.codecs.jax_leaves``: sorted flax paths, a dotted key of the
  port's variables is its path) and unflattened into the template's
  structure (``unflatten_like``); ``tree_from_wire`` returns tensors in
  the template leaf's dtype, shape and device.
"""

from __future__ import annotations

import base64
import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from fedml_tpu_torch.core.tree import host_array

# --- reserved wire-format keys ---------------------------------------------
# Protocol vocabulary, defined ONCE (the fedlint wire-schema rule bans
# literal copies elsewhere — a second copy keeps "working" while the
# canonical one evolves).  ``TRACE_KEY`` (= "__trace__") lives in
# ``obs/trace_ctx.py`` with the same contract.
HUB_KEY = "__hub__"  # hub control frames (register/ack/ping/mcast/stop)
# __hub__ kind of a striped-multicast continuation frame: the hub splits
# a large mcast payload into fixed-size stripes fanned round-robin
# across connections; receivers reassemble (comm/tcp.py)
MCAST_STRIPE_KIND = "mcast_stripe"
# __hub__ kind of a muxed-delivery wrapper: a broadcast copy addressed
# to SEVERAL virtual node ids that share one physical connection (hello
# v2 registration).  The outer header names the target ids; the payload
# is ONE complete inner frame the demuxing backend fans out locally
# (comm/mux.py) — the shared payload crosses the wire once per
# CONNECTION, never once per virtual node.
MUX_KIND = "mux"
# shared-memory lane doorbell (comm/shm.py): a frame header carrying
# this key announces that its ``__binlen__`` payload bytes live in the
# connection's shm slab at this descriptor sequence number instead of
# following on the socket — the header (and frame ORDER) stays on TCP,
# only the payload bytes move through the ring
SHM_SEQ_KEY = "__shmseq__"
FRAME_BINLEN_KEY = "__binlen__"  # header: raw payload bytes that follow
FRAME_NDBUF_KEY = "__ndbuf__"  # header entry: [offset, nbytes] buffer ref
WIRETREE_KEY = "__wiretree__"  # wire pytree envelope (version tag)
NDARRAY_KEY = "__ndarray__"  # v1 b64 array leaf

# --- reserved keys ---------------------------------------------------------
MSG_ARG_KEY_TYPE = "msg_type"
MSG_ARG_KEY_SENDER = "sender"
MSG_ARG_KEY_RECEIVER = "receiver"
MSG_ARG_KEY_MODEL_PARAMS = "model_params"
MSG_ARG_KEY_NUM_SAMPLES = "num_samples"
MSG_ARG_KEY_CLIENT_INDEX = "client_idx"
MSG_ARG_KEY_ROUND_INDEX = "round_idx"
MSG_ARG_KEY_LOCAL_METRICS = "local_metrics"

# --- message types (semantic vocabulary) -----------------------------------
MSG_TYPE_S2C_INIT_CONFIG = "S2C_INIT_CONFIG"
MSG_TYPE_S2C_SYNC_MODEL = "S2C_SYNC_MODEL"
MSG_TYPE_C2S_SEND_MODEL = "C2S_SEND_MODEL"
MSG_TYPE_C2S_SEND_STATS = "C2S_SEND_STATS"
MSG_TYPE_S2C_FINISH = "S2C_FINISH"
# in-band stats plane (fedml_tpu/obs/digest.py): one mergeable
# telemetry-digest frame per report interval per CONNECTION — the
# payload rides the reserved ``__digest__`` key (DIGEST_KEY, defined
# there), and the frame is deliberately outside faults.DEFAULT_FAULTABLE
# (observability loss must be injected explicitly, never as a side
# effect of a model-frame fault mix)
MSG_TYPE_C2S_TELEMETRY = "C2S_TELEMETRY"
# delta-broadcast resync (fedavg_cross_device): a client that received
# a delta sync against a base round it no longer caches (fresh process,
# rejoined muxer) asks the server for a full-model resend; the server
# clears the node's ack and unicasts the current round's full sync
MSG_TYPE_C2S_RESYNC = "C2S_RESYNC"
# sync-envelope param naming the base round a delta broadcast applies
# to (the receiver reconstructs base + the shipped per-round deltas)
MSG_ARG_KEY_DELTA_BASE = "delta_base"
# hierarchical aggregation (fedml_tpu/algorithms/edge_hub.py): an edge
# hub terminates its cohort's connections, folds their uploads with the
# same O(1) streaming aggregation the root runs, and uplinks ONE
# pre-folded (sum n·model, sum n) pair per round.  The num/den
# formulation composes exactly (fp64 sums are order-independent at
# training magnitudes), so a tree run's final model is byte-identical
# to the flat run's.  Registered in analysis/wire_schema.py: a literal
# copy of this tag in a second module is wire-format drift.
MSG_TYPE_E2S_PARTIAL = "E2S_PARTIAL"
# E2S_PARTIAL param: {node_id (str): num_samples} for every upload the
# edge folded into this frame — the root materializes them as this
# round's reporters (participation accounting, delta-broadcast acks,
# duplicate screening) without ever seeing the per-client models
MSG_ARG_KEY_CONTRIBUTORS = "contributors"
# split-learning extras (reference split_nn/message_define.py:6-16)
MSG_TYPE_C2S_SEND_ACTS = "C2S_SEND_ACTS"
MSG_TYPE_S2C_SEND_GRADS = "S2C_SEND_GRADS"
MSG_TYPE_C2C_SEMAPHORE = "C2C_SEMAPHORE"


class Message:
    # payload residency (shm lane): when a frame's binary payload was
    # mapped out of a shared-memory slab, the receiving backend attaches
    # the refcounted region here so consumers that hand the message to
    # ANOTHER thread (decode pools, chaos delay timers) can pin the
    # bytes past the delivery scope — see ``pin_payload``.  None (the
    # class default) = payload owns its memory, pinning is a no-op.
    _region = None

    def __init__(self, msg_type: str = "", sender: int = 0, receiver: int = 0):
        self.params: Dict[str, Any] = {
            MSG_ARG_KEY_TYPE: msg_type,
            MSG_ARG_KEY_SENDER: sender,
            MSG_ARG_KEY_RECEIVER: receiver,
        }
        # memoized to_frame_parts() encoding: broadcast fan-out and send
        # retries reuse ONE immutable buffer list instead of re-encoding
        # a multi-MB frame per receiver/attempt
        self._frame_parts = None

    # -- reference API surface --
    def add_params(self, key: str, value: Any) -> "Message":
        self.params[key] = value
        self._frame_parts = None  # invalidate any cached wire encoding
        return self

    add = add_params

    def get(self, key: str, default=None) -> Any:
        return self.params.get(key, default)

    @property
    def type(self) -> str:
        return self.params[MSG_ARG_KEY_TYPE]

    @property
    def sender(self) -> int:
        return self.params[MSG_ARG_KEY_SENDER]

    @property
    def receiver(self) -> int:
        return self.params[MSG_ARG_KEY_RECEIVER]

    def to_json(self) -> str:
        return json.dumps(self.params, default=_encode_value)

    def to_frame(self) -> bytes:
        """Binary wire frame: one JSON header line, then raw buffers.

        Every array value (at any nesting depth) is lifted out of the
        JSON into a concatenated binary payload and replaced by an
        ``{"__ndbuf__": [offset, nbytes], dtype, shape}`` reference;
        the header's top-level ``__binlen__`` key carries the payload
        length so readers (hub, backend) know exactly how many raw
        bytes follow the newline.  Messages without arrays serialize
        to a plain JSON line — readable and v1-identical.
        """
        return b"".join(self.to_frame_parts())

    def to_frame_parts(self) -> List:
        """Zero-copy form of ``to_frame``: a list of buffers (header
        line first, then raw array memoryviews) whose concatenation IS
        the frame.  Nothing multi-MB is copied: array leaves stay
        memoryviews over their backing storage, and transports write
        them with a vectored ``sendmsg`` instead of joining.

        The list is memoized on the instance (``add_params``
        invalidates), so broadcast fan-out, unicast fallback, and send
        retries all reuse ONE immutable encoding — the per-round sync
        frame is serialized exactly once however many nodes it reaches.
        """
        parts = self._frame_parts
        if parts is not None:
            return parts
        bufs: List = []
        header = _extract_buffers(self.params, bufs, [0])
        if not bufs:
            parts = [(self.to_json() + "\n").encode()]
        else:
            header[FRAME_BINLEN_KEY] = sum(len(b) for b in bufs)
            parts = [
                json.dumps(header, default=_encode_value).encode() + b"\n",
                *bufs,
            ]
        self._frame_parts = parts
        return parts

    def clone_for(self, receiver: int) -> "Message":
        """Shallow per-receiver copy (payload objects shared, nothing
        re-encoded): how the base multicast fan-out and the chaos
        layer's per-receiver faults address one node of a broadcast."""
        m = Message()
        m.params = dict(self.params)
        m.params[MSG_ARG_KEY_RECEIVER] = receiver
        # clones share the payload objects, so they share its residency:
        # a pinned clone must keep the SAME slab region alive
        m._region = self._region
        return m

    def pin_payload(self):
        """Keep a slab-resident payload alive past the delivery scope:
        returns a release callable the consumer MUST invoke when done
        (a no-op callable for ordinary heap-backed payloads).  Callers
        that defer work to another thread pin BEFORE scheduling."""
        region = self._region
        if region is None:
            return lambda: None
        region.retain()
        return region.release

    @classmethod
    def from_frame(cls, header_obj: dict, payload: bytes = b"") -> "Message":
        """Inverse of ``to_frame`` given the parsed header line and the
        raw payload bytes that followed it."""
        obj = {k: v for k, v in header_obj.items() if k != FRAME_BINLEN_KEY}
        return cls.from_obj(_inject_buffers(obj, payload))

    @classmethod
    def from_frame_bytes(cls, data: bytes) -> "Message":
        """Parse ONE complete binary frame held in memory (header line +
        raw payload): the stripe-reassembly inverse of ``to_frame``,
        where the frame arrives as buffered chunks instead of off a
        stream reader.  Raises ``ValueError`` on a frame with no header
        line or a payload shorter than its ``__binlen__`` announcement
        (a reassembly that lost bytes must surface as a dropped logical
        frame, never a half-decoded model)."""
        from fedml_tpu_torch.comm.shm import split_frame_line

        end = split_frame_line(data)  # bytes OR slab memoryview
        if end < 0:
            raise ValueError("frame has no header line")
        nl = end - 1
        header = json.loads(bytes(data[:nl + 1])
                            if isinstance(data, memoryview)
                            else data[:nl + 1])
        # memoryview slices: the multi-MB payload is never copied —
        # decoded arrays are read-only views into ``data`` (exactly the
        # stream-reader path's buffer-sharing contract)
        payload = memoryview(data)[nl + 1:]
        binlen = header.get(FRAME_BINLEN_KEY) or 0
        if len(payload) < binlen:
            raise ValueError(
                f"frame payload truncated: {len(payload)} < {binlen}"
            )
        return cls.from_frame(header, payload[:binlen] if binlen
                              else b"")

    @classmethod
    def from_json(cls, payload: str) -> "Message":
        return cls.from_obj(json.loads(payload))

    @classmethod
    def from_obj(cls, obj: dict) -> "Message":
        """Build from an already-parsed JSON dict (avoids re-parsing
        multi-MB frames on hot receive paths)."""
        m = cls()
        m.params = {k: _decode_value(v) for k, v in obj.items()}
        return m

    def __repr__(self):
        return f"Message({self.type}, {self.sender}->{self.receiver}, keys={list(self.params)})"


# --- host bytes of a leaf -----------------------------------------------------

_BF16 = "bfloat16"


def _host_array(v) -> Tuple[np.ndarray, str]:
    """A leaf as a host numpy array and its numpy dtype name; a bfloat16
    tensor as its uint16 bit pattern named ``"bfloat16"``."""
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        a = t.numpy()
        return a, str(a.dtype)
    a = np.asarray(v)
    return a, str(a.dtype)


def _array_from_buffer(buf, dtype: str, shape) -> Any:
    """Inverse of ``_host_array``: a numpy view of ``buf``, or a
    ``bfloat16`` tensor (a copy) for a ``"bfloat16"`` buffer."""
    if dtype == _BF16:
        bits = np.frombuffer(buf, dtype=np.uint16).reshape(shape)
        return torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    try:
        dt = np.dtype(dtype)
    except TypeError:
        raise ValueError(f"wire dtype {dtype!r} has no numpy or torch "
                         "counterpart in the port") from None
    return np.frombuffer(buf, dtype=dt).reshape(shape)


def _encode_array(a) -> dict:
    host, dtype = _host_array(a)
    return {
        NDARRAY_KEY: base64.b64encode(np.ascontiguousarray(host).tobytes()).decode(),
        "dtype": dtype,
        "shape": list(host.shape),
    }


def _decode_array(obj: dict):
    return _array_from_buffer(base64.b64decode(obj[NDARRAY_KEY]), obj["dtype"],
                              obj["shape"])


def _is_raw_array(v) -> bool:
    """A real array (numpy or torch), not a numpy scalar, which stays an
    inline JSON number."""
    if isinstance(v, np.generic):
        return False
    return isinstance(v, (np.ndarray, torch.Tensor))


def _extract_buffers(v, bufs: List, offset: List[int]):
    """Deep-copy ``v`` with every raw array replaced by an ``__ndbuf__``
    reference; a zero-copy memoryview of the host bytes appends to
    ``bufs`` (the view keeps its array alive)."""
    if _is_raw_array(v):
        a, dtype = _host_array(v)
        # as in JAX: ascontiguousarray gives a 0-d leaf shape [1] on the wire
        a = np.ascontiguousarray(a)
        # reshape(-1) is copy-free on a contiguous array and gives a 1-D
        # buffer cast("B") accepts even for 0-d leaves
        try:
            b = memoryview(a.reshape(-1)).cast("B")
        except (TypeError, ValueError, BufferError):
            b = a.tobytes()
        ref = {FRAME_NDBUF_KEY: [offset[0], len(b)], "dtype": dtype,
               "shape": list(a.shape)}
        bufs.append(b)
        offset[0] += len(b)
        return ref
    if isinstance(v, dict):
        return {k: _extract_buffers(x, bufs, offset) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_extract_buffers(x, bufs, offset) for x in v]
    return v


def _inject_buffers(v, payload: bytes):
    """Inverse of ``_extract_buffers``: ``__ndbuf__`` references become
    (read-only) numpy views into ``payload``, bfloat16 ones tensors."""
    if isinstance(v, dict):
        if FRAME_NDBUF_KEY in v:
            off, n = v[FRAME_NDBUF_KEY]
            return _array_from_buffer(payload[off:off + n], v["dtype"], v["shape"])
        return {k: _inject_buffers(x, payload) for k, x in v.items()}
    if isinstance(v, list):
        return [_inject_buffers(x, payload) for x in v]
    return v


def _encode_value(v):
    if isinstance(v, (np.ndarray, torch.Tensor)):
        return _encode_array(v)
    if isinstance(v, (np.integer, np.floating)):
        return v.item()
    raise TypeError(f"not JSON-serializable: {type(v)}")


def _decode_value(v):
    """Recursive decode: arrays survive the round trip at any nesting depth
    (encoding recurses through json.dumps' default=, so decoding must)."""
    if isinstance(v, dict):
        if NDARRAY_KEY in v:
            return _decode_array(v)
        if WIRETREE_KEY in v:
            return v  # a wire pytree: decoded by tree_from_wire (needs a template)
        return {k: _decode_value(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_decode_value(x) for x in v]
    return v


# --- pytree <-> wire codecs -------------------------------------------------


def _leaves(tree: Any) -> List:
    """A tree's leaves in ``jax.tree_util`` order; an array alone is a
    one-leaf tree."""
    # imported here: compress.codecs reads this module's NDARRAY_KEY at its top
    from fedml_tpu_torch.compress.codecs import jax_leaves

    if isinstance(tree, dict):
        return [leaf for _, leaf in jax_leaves(tree)]
    return [tree]


def _unflatten(like: Any, leaves: List) -> Any:
    from fedml_tpu_torch.compress.codecs import unflatten_like

    return unflatten_like(like, leaves) if isinstance(like, dict) else leaves[0]


def _host_leaf(leaf):
    """A v2 leaf as the JAX package ships it: a contiguous host copy (a
    tensor stays a tensor, so bfloat16 keeps its name on the wire)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().contiguous()
    return np.ascontiguousarray(np.asarray(leaf))


def _bf16_payloads(entries: List[dict]) -> List[dict]:
    """The bf16 codec's payloads as bfloat16 tensors: the port's codec
    hands back their uint16 bits (numpy has no bfloat16), and a JAX peer
    reads a ``"uint16"`` buffer as integers."""
    return [{**e, "enc": {k: torch.from_numpy(np.asarray(v).view(np.int16).copy())
                          .view(torch.bfloat16) for k, v in e["enc"].items()}}
            for e in entries]


def tree_to_wire(tree: Any, *, version: int = 2, codec=None, key=None,
                 delta: bool = False) -> Any:
    """Tree of arrays → wire structure.

    ``version=2`` (default): raw leaves, shipped as binary buffers by the
    frame codec (or base64 by the JSON path).  ``version=1``: the legacy
    base64 leaf dicts.  With ``codec`` (a ``compress`` ``LeafCodec``) the
    leaves are codec encodings of a model update, seeded by ``key``
    (always a v2 wiretree); ``delta`` marks the payload as an update to
    add to a base model (the receiver checks the flag)."""
    if codec is not None:
        from fedml_tpu_torch.compress import wire_encode_tree

        entries = wire_encode_tree(codec, tree, key)
        if codec.name == "bf16":
            entries = _bf16_payloads(entries)
        return {WIRETREE_KEY: 2, "codec": codec.name, "delta": bool(delta),
                "leaves": entries}
    leaves = _leaves(tree)
    if version == 1:
        return {WIRETREE_KEY: 1, "leaves": [_encode_array(l) for l in leaves]}
    return {WIRETREE_KEY: 2, "leaves": [_host_leaf(l) for l in leaves]}


def tree_codec_name(obj: Any) -> str:
    """Codec a wire pytree was encoded with ('' = uncompressed)."""
    return obj.get("codec", "") if isinstance(obj, dict) else ""


def tree_is_delta(obj: Any) -> bool:
    """True when the wire pytree carries a model update (add to base)."""
    return bool(obj.get("delta")) if isinstance(obj, dict) else False


def _numpy_bits(v) -> np.ndarray:
    """A decoded payload as numpy, a bfloat16 tensor as its uint16 bits."""
    return _host_array(v)[0] if isinstance(v, torch.Tensor) else np.asarray(v)


def _like_leaf(leaf, ref):
    """``leaf`` in the template leaf's dtype and shape, and its device when
    the template is a tensor."""
    if isinstance(ref, torch.Tensor):
        t = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(np.array(leaf))
        return t.to(device=ref.device, dtype=ref.dtype).reshape(ref.shape)
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.float().numpy()
    ref = np.asarray(ref)
    return np.asarray(leaf, dtype=ref.dtype).reshape(ref.shape)


def tree_from_wire(obj: Any, like: Any) -> Any:
    """Decode against a structural template ``like``.

    Handles every wire generation: v1 base64 leaf dicts, v2 raw arrays (or
    ``__ndbuf__``-injected views), a v2 tree that travelled the JSON path
    (its raw leaves base64-rewrapped), and codec-encoded v2 trees (decoded
    to fp32 through the named codec; the caller applies ``delta``)."""
    leaves_like = _leaves(like)
    name = tree_codec_name(obj)
    if name and name != "none":
        from fedml_tpu_torch.compress import get_codec, wire_decode_tree

        entries = [
            {**e, "enc": {k: _numpy_bits(_decode_array(v)
                                         if isinstance(v, dict) and NDARRAY_KEY in v
                                         else v)
                          for k, v in e["enc"].items()}}
            for e in obj["leaves"]
        ]
        template = like if isinstance(like, dict) else {"leaf": like}
        decoded = _leaves(wire_decode_tree(get_codec(name), entries, template))
        return _unflatten(like, [
            d.to(ref.device) if isinstance(ref, torch.Tensor) else d.numpy()
            for d, ref in zip(decoded, leaves_like)])
    leaves = [_decode_array(e) if isinstance(e, dict) and NDARRAY_KEY in e else e
              for e in obj["leaves"]]
    assert len(leaves) == len(leaves_like), "wire/treedef leaf count mismatch"
    return _unflatten(like, [_like_leaf(l, ref) for l, ref in zip(leaves, leaves_like)])


def _tree_map(fn, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of nested dicts, lists and tuples (a leaf
    is anything else, or whatever ``is_leaf`` accepts); ``rest`` are trees
    of the same structure."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tensor_to_list(tree: Any) -> Any:
    """The reference's mobile/MQTT codec (``fedavg/utils.py:11-14``):
    arrays become nested python lists (bfloat16 as the floats it holds)."""
    return _tree_map(lambda a: host_array(a).tolist(), tree)


def list_to_tensor(tree: Any, like: Any = None) -> Any:
    """Inverse of ``tensor_to_list``.  With ``like`` (a structural
    template) each leaf takes the template leaf's dtype and shape (and its
    device, for a tensor), so bf16 and int leaves survive a list-codec
    round trip; without it, float32 numpy arrays (the reference's mobile
    codec assumed float32 throughout)."""

    def is_list(x):
        return isinstance(x, list)

    if like is None:
        return _tree_map(lambda l: np.asarray(l, dtype=np.float32), tree, is_leaf=is_list)
    return _tree_map(lambda l, ref: _like_leaf(np.asarray(l), ref), tree, like,
                     is_leaf=is_list)
