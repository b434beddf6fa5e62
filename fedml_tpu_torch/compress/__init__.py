"""Update compression: deterministic codecs and error feedback (port of
``fedml_tpu/compress``).

``codecs.py`` holds the codec registry (qsgd8/qsgd4/topk/bf16), the
per-leaf and wire forms and the fused flat form the round engine runs
(``make_round_fn(codec=..., error_feedback=...)``); ``error_feedback.py``
the host-side EF recurrence, which the cross-device client's uploads
(``algorithms/fedavg_cross_device.py::encode_client_upload``) carry per
uplink stream.  The sharded wire forms of
``fedml_tpu/compress/sharded.py`` belong to the parallel engines and are
not ported yet (ROADMAP queue A item 6).
"""

from fedml_tpu_torch.compress.codecs import (
    BCAST_STREAM,
    COMPRESS_STREAM,
    NDARRAY_KEY,
    Bf16Codec,
    FlatLayout,
    IdentityCodec,
    LeafCodec,
    QsgdCodec,
    TopKCodec,
    decode_tree,
    encode_tree,
    encoded_nbytes,
    get_codec,
    jax_leaves,
    roundtrip_flat,
    roundtrip_tree,
    uplink_roundtrip,
    wire_decode_tree,
    wire_encode_tree,
    wire_tree_digest,
)
from fedml_tpu_torch.compress.error_feedback import ErrorFeedback

__all__ = [
    "BCAST_STREAM",
    "COMPRESS_STREAM",
    "NDARRAY_KEY",
    "Bf16Codec",
    "ErrorFeedback",
    "FlatLayout",
    "IdentityCodec",
    "LeafCodec",
    "QsgdCodec",
    "TopKCodec",
    "decode_tree",
    "encode_tree",
    "encoded_nbytes",
    "get_codec",
    "jax_leaves",
    "roundtrip_flat",
    "roundtrip_tree",
    "uplink_roundtrip",
    "wire_decode_tree",
    "wire_encode_tree",
    "wire_tree_digest",
]
