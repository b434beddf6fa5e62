"""Shared fedlint infrastructure: findings, pragmas, source loading (port
of ``fedml_tpu/analysis/base.py``).

Checkers operate on ``SourceFile`` objects — parsed AST plus the raw
source lines (the AST drops comments, and both pragma forms live in
comments).  Paths are kept package-relative with forward slashes
(``fedml_tpu_torch/comm/tcp.py``) so rule scoping is platform-independent
and fixture tests can fabricate in-memory files at any virtual path.
``PACKAGE`` is the root the rules scope by: the port's package name.

Pragmas (parsed here, honored by ``analysis.run_all`` / the checkers):

- ``# fedlint: disable=<rule>[,<rule>...] -- <justification>`` —
  suppress findings of those rules on THIS line.  The justification is
  required: a bare disable is recorded as a ``pragma`` finding, which
  no pragma can suppress.
- ``# fedlint: holds=<lock>[,<lock>...]`` on a ``def`` line — the
  lock-discipline checker treats the whole function as holding those
  locks (the caller-holds-the-lock contract; ``locks.assert_held``
  verifies it at runtime when checked locks are enabled).

Stdlib-only: the lint runs on a bare interpreter, without torch.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Union

# the package whose paths the rules scope by (``<PACKAGE>/comm/...``) and
# whose modules the cross-module hops follow
PACKAGE = "fedml_tpu_torch"

PRAGMA_RE = re.compile(
    r"#\s*fedlint:\s*(disable|holds)=([\w.,-]+)"
    r"(?:\s+--\s*(\S.*?))?\s*$"
)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One linter finding, anchored to a source line."""

    rule: str
    path: str  # package-relative, forward slashes
    line: int
    col: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] {self.message}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class SourceFile:
    """Parsed module + pragma tables.

    ``rel`` is the rule-scoping path (``fedml_tpu_torch/comm/tcp.py``);
    fixture tests construct instances directly with synthetic ``rel``
    values to land in a checker's scope without touching disk.
    """

    def __init__(self, text: str, rel: str, path: Optional[str] = None):
        self.rel = rel.replace("\\", "/")
        self.path = str(path) if path is not None else self.rel
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=self.path)
        self.disables: Dict[int, Set[str]] = {}
        self.holds: Dict[int, Set[str]] = {}
        self.pragma_errors: List[Finding] = []
        for lineno, line in enumerate(self.lines, 1):
            m = PRAGMA_RE.search(line)
            if m is None:
                continue
            kind = m.group(1)
            names = {n.strip() for n in m.group(2).split(",") if n.strip()}
            justification = (m.group(3) or "").strip()
            if kind == "disable":
                if not justification:
                    self.pragma_errors.append(Finding(
                        "pragma", self.rel, lineno, m.start(),
                        "disable pragma requires a justification: "
                        "'# fedlint: disable=<rule> -- <why>'",
                    ))
                    continue
                self.disables.setdefault(lineno, set()).update(names)
            else:
                self.holds.setdefault(lineno, set()).update(names)

    @property
    def module(self) -> str:
        """Dotted module name derived from ``rel`` (for cross-module
        resolution in the jit-purity call graph)."""
        rel = self.rel[:-3] if self.rel.endswith(".py") else self.rel
        parts = [p for p in rel.split("/") if p]
        if parts and parts[-1] == "__init__":
            parts = parts[:-1]
        return ".".join(parts)


def load_files(roots: Union[str, Path, Sequence[Union[str, Path]]],
               ) -> List[SourceFile]:
    """Load every ``*.py`` under the given root(s).

    For a directory root, files get rel paths anchored at the root's
    OWN name (``fedml_tpu_torch/...`` when pointed at the package dir) so the
    checkers' path scoping matches however the tree was reached."""
    if isinstance(roots, (str, Path)):
        roots = [roots]
    out: List[SourceFile] = []
    for root in roots:
        root = Path(root).resolve()
        if root.is_file():
            paths = [(root, root.name)]
        else:
            paths = [
                (p, p.relative_to(root.parent).as_posix())
                for p in sorted(root.rglob("*.py"))
                if "__pycache__" not in p.parts
            ]
        for path, rel in paths:
            try:
                text = path.read_text(encoding="utf-8")
            except (OSError, UnicodeDecodeError) as e:
                raise RuntimeError(f"fedlint cannot read {path}: {e}") from e
            try:
                out.append(SourceFile(text, rel=rel, path=str(path)))
            except SyntaxError as e:
                raise RuntimeError(
                    f"fedlint cannot parse {path}: {e}"
                ) from e
    return out


# --- shared AST helpers ------------------------------------------------------

def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def module_aliases(tree: ast.AST) -> Dict[str, str]:
    """alias → canonical module for every ``import``/``from`` anywhere
    in the module (function-level imports included — the codebase leans
    on them for lazy loading).  ``from x import y`` maps ``y`` to
    ``x.y`` so attribute chains resolve uniformly."""
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0]
                )
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            for a in node.names:
                if a.name == "*":
                    continue
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def resolve_call_target(func: ast.AST, aliases: Dict[str, str]) -> Optional[str]:
    """Canonical dotted target of a call's ``func`` node, with the
    module-alias table applied to the chain root: ``np.random.rand``
    with ``import numpy as np`` resolves to ``numpy.random.rand``."""
    name = dotted_name(func)
    if name is None:
        return None
    head, _, tail = name.partition(".")
    head = aliases.get(head, head)
    return f"{head}.{tail}" if tail else head
