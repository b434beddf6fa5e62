"""Frame helpers of ``fedml_tpu/comm/shm.py``.

``split_frame_line`` finds the end of a frame's JSON header line in memory
(``bytes`` or a memoryview), the helper ``Message.from_frame_bytes``
reads frames with.  The shared-memory lanes of the JAX module
(``ShmLane``, ``ShmRegion``: zero-copy payloads for peers on one host)
belong to the TCP transport and come with it (ROADMAP queue A item 5).
"""

from __future__ import annotations


def split_frame_line(data) -> int:
    """Offset just past the first newline of a frame held in memory
    (bytes OR a slab memoryview, searched chunk-wise so a multi-MB
    payload is never materialized); -1 if no header line."""
    if not isinstance(data, memoryview):
        nl = data.find(b"\n")
        return -1 if nl < 0 else nl + 1
    chunk = 8192
    off = 0
    n = len(data)
    while off < n:
        j = bytes(data[off:off + chunk]).find(b"\n")
        if j >= 0:
            return off + j + 1
        off += chunk
    return -1
