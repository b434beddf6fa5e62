"""wire-schema — reserved frame-header keys are defined exactly once
(port of ``fedml_tpu/analysis/wire_schema.py``; the definition sites are
the port's own modules).

The wire format's reserved keys (``__hub__`` control frames,
``__binlen__`` payload-length announcements, ``__ndbuf__`` buffer
references, ``__wiretree__`` pytree envelopes, ``__ndarray__`` b64
leaves, ``__trace__`` hop contexts) are protocol: every reader and
writer must agree on the exact byte string.  A literal copy in a second
module is the drift class behind silent wire-format skew — rename the
canonical one (PR 6's ``hub.mcast_frames`` rename was exactly this
class, in metric space) and the copy keeps "working" while routing or
tracing quietly breaks.

Rule: each reserved key may appear as a string literal ONLY in its
defining module, and there only as the right-hand side of its canonical
constant assignment.  Every other use must reference the constant
(``from fedml_tpu_torch.comm.message import HUB_KEY``, ...).

Docstrings and comments are unaffected (the checker compares whole
string-literal VALUES, and comments never reach the AST).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Sequence, Tuple

from fedml_tpu_torch.analysis.base import PACKAGE, Finding, SourceFile

RULE = "wire-schema"

_MESSAGE = f"{PACKAGE}/comm/message.py"

# literal -> (canonical constant, defining module rel path)
RESERVED_KEYS: Dict[str, Tuple[str, str]] = {
    "__hub__": ("HUB_KEY", _MESSAGE),
    "__binlen__": ("FRAME_BINLEN_KEY", _MESSAGE),
    "__ndbuf__": ("FRAME_NDBUF_KEY", _MESSAGE),
    "__wiretree__": ("WIRETREE_KEY", _MESSAGE),
    "__ndarray__": ("NDARRAY_KEY", _MESSAGE),
    "__trace__": ("TRACE_KEY", f"{PACKAGE}/obs/trace_ctx.py"),
    "__digest__": ("DIGEST_KEY", f"{PACKAGE}/obs/digest.py"),
    "__shmseq__": ("SHM_SEQ_KEY", _MESSAGE),
    # not a frame-header key but the same drift class: the edge-hub
    # uplink's partial-aggregate message tag is protocol between two
    # tiers of aggregator — a literal copy in a second module would
    # let the tiers skew silently
    "E2S_PARTIAL": ("MSG_TYPE_E2S_PARTIAL", _MESSAGE),
}


def _definition_lines(sf: SourceFile) -> Dict[str, int]:
    """lineno of each module-level ``CONST = "literal"`` assignment."""
    out: Dict[str, int] = {}
    for node in sf.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, str):
            out[node.targets[0].id] = node.lineno
    return out


def check(files: Sequence[SourceFile]) -> List[Finding]:
    findings: List[Finding] = []
    for sf in files:
        if sf.rel.startswith(f"{PACKAGE}/analysis/"):
            # the checker's own registry (this module) names the keys
            # by necessity; analysis/ is stdlib-only and cannot import
            # the torch-backed comm.message constants
            continue
        defs = _definition_lines(sf)
        for node in ast.walk(sf.tree):
            if not (isinstance(node, ast.Constant)
                    and isinstance(node.value, str)
                    and node.value in RESERVED_KEYS):
                continue
            const, home = RESERVED_KEYS[node.value]
            if sf.rel == home and defs.get(const) == node.lineno:
                continue  # the one canonical definition
            where = (f"defined once in {home}"
                     if sf.rel != home else
                     f"this module's canonical '{const} = ...' assignment")
            findings.append(Finding(
                RULE, sf.rel, node.lineno, node.col_offset,
                f"reserved wire key '{node.value}' as a string literal — "
                f"use the constant {const} ({where}); literal copies "
                "drift when the protocol evolves",
            ))
    return findings
