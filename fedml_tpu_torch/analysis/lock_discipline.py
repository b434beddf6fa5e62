"""lock-discipline — guarded attributes only touched under their lock
(port of ``fedml_tpu/analysis/lock_discipline.py``).

The threaded modules (hub reader threads + sender pool, the server's
reader-thread fold + deadline timer, the chaos wrapper's held-message
tables) protect shared state with per-instance locks, but nothing
enforced the association — a new code path touching ``self.pending``
without ``self._round_lock`` compiles, passes single-threaded tests,
and corrupts a round under load.

Convention this rule checks: a class declares

    _GUARDED_BY = {"pending": "_round_lock", "_agg_acc": "_round_lock"}

and every ``self.<attr>`` access (read or write) to a declared attribute
must then sit lexically inside a ``with self.<lock>:`` block.  Escapes:

- ``__init__`` is exempt (construction happens-before publication);
- a method whose ``def`` line carries ``# fedlint: holds=<lock>``
  asserts the caller-holds-the-lock contract for its whole body — a
  promise the runtime verifies via ``analysis.locks.assert_held`` when
  checked locks are enabled;
- nested functions/lambdas reset the held set (they run later, on
  whatever thread calls them — lexical nesting proves nothing).

The checker is intentionally lexical: state snapshotted under the lock
into a local and used outside (the codebase's standard pattern) passes,
because the ``self.<attr>`` access itself is inside the block.
"""

from __future__ import annotations

import ast
from typing import Dict, FrozenSet, List, Sequence

from fedml_tpu_torch.analysis.base import Finding, SourceFile

RULE = "lock-discipline"

GUARDED_DECL = "_GUARDED_BY"
EXEMPT_METHODS = ("__init__",)


def _guarded_map(cls: ast.ClassDef) -> Dict[str, str]:
    """Parse the class's ``_GUARDED_BY`` dict literal, if any."""
    for node in cls.body:
        target = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
            value = node.value
        elif isinstance(node, ast.AnnAssign):
            target = node.target
            value = node.value
        if not (isinstance(target, ast.Name) and target.id == GUARDED_DECL):
            continue
        if not isinstance(value, ast.Dict):
            return {}
        out: Dict[str, str] = {}
        for k, v in zip(value.keys, value.values):
            if isinstance(k, ast.Constant) and isinstance(k.value, str) \
                    and isinstance(v, ast.Constant) \
                    and isinstance(v.value, str):
                out[k.value] = v.value
        return out
    return {}


def _self_attr(node: ast.AST) -> str:
    """``_lock`` for a plain ``self._lock`` expression, else ''."""
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return ""


def check(files: Sequence[SourceFile]) -> List[Finding]:
    findings: List[Finding] = []
    for sf in files:
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.ClassDef):
                guarded = _guarded_map(node)
                if guarded:
                    findings.extend(_check_class(sf, node, guarded))
    return findings


def _check_class(sf: SourceFile, cls: ast.ClassDef,
                 guarded: Dict[str, str]) -> List[Finding]:
    findings: List[Finding] = []
    lock_names = frozenset(guarded.values())
    for item in cls.body:
        if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if item.name in EXEMPT_METHODS:
            continue
        held = frozenset(
            h for h in sf.holds.get(item.lineno, ()) if h in lock_names
        )
        for stmt in item.body:
            _walk(sf, cls.name, item.name, stmt, guarded, held, findings)
    return findings


def _walk(sf: SourceFile, cls_name: str, meth_name: str, node: ast.AST,
          guarded: Dict[str, str], held: FrozenSet[str],
          findings: List[Finding]) -> None:
    if isinstance(node, (ast.With, ast.AsyncWith)):
        acquired = set()
        for item in node.items:
            # the lock expression itself evaluates BEFORE the acquire
            _walk(sf, cls_name, meth_name, item.context_expr, guarded,
                  held, findings)
            name = _self_attr(item.context_expr)
            if name in guarded.values():
                acquired.add(name)
        inner = held | acquired
        for stmt in node.body:
            _walk(sf, cls_name, meth_name, stmt, guarded, inner, findings)
        return
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
        # a nested callable runs later, on an arbitrary thread: locks
        # held lexically around its DEFINITION prove nothing
        for child in ast.iter_child_nodes(node):
            _walk(sf, cls_name, meth_name, child, guarded,
                  frozenset(), findings)
        return
    attr = _self_attr(node)
    if attr and attr in guarded and guarded[attr] not in held:
        lock = guarded[attr]
        findings.append(Finding(
            RULE, sf.rel, node.lineno, node.col_offset,
            f"{cls_name}.{meth_name}: 'self.{attr}' touched outside "
            f"'with self.{lock}' (declared guarded by {GUARDED_DECL}) — "
            f"wrap the access, or annotate the method "
            f"'# fedlint: holds={lock}' if the caller holds it",
        ))
    for child in ast.iter_child_nodes(node):
        _walk(sf, cls_name, meth_name, child, guarded, held, findings)
