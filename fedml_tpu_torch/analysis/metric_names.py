"""metric-name — every emitted series/event name is in the registry (port
of ``fedml_tpu/analysis/metric_names.py``; the registry is the port's).

A typo'd metric name does not error: the registry happily creates a
fresh series that no dashboard, summary tool, or assertion ever reads —
the emission "works" and the data silently never aggregates with the
series it was meant to extend (the failure mode PROFILE.md's appendix
can only document after the fact).  This rule makes
``fedml_tpu_torch/obs/metric_schema.py`` the single checked-in source of
truth: every literal name passed to ``inc`` / ``gauge_set`` /
``gauge_max`` / ``observe`` / ``counter_value`` must be registered with
the matching type, every ``event(kind, ...)`` kind must be a registered
event, and dynamic f-string names (``f"span.{name}_s"``) must match a
registered pattern of the right type.

Schema resolution order: an ``obs/metric_schema.py`` in the scanned
file set, else one found on disk next to a scanned file (walking up to
the package root).  Execution is plain ``exec`` of the schema module —
it is stdlib-only literals by construction.
"""

from __future__ import annotations

import ast
import fnmatch
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from fedml_tpu_torch.analysis.base import PACKAGE, Finding, SourceFile

RULE = "metric-name"

EMITTERS = {
    "inc": "counter",
    "counter_value": "counter",
    "gauge_set": "gauge",
    "gauge_max": "gauge",
    "observe": "histogram",
}

SCHEMA_REL_SUFFIX = "obs/metric_schema.py"


def _load_schema(files: Sequence[SourceFile]):
    """(metrics: name->type, events: set, patterns: pattern->type) or
    None when no schema module can be found."""
    text: Optional[str] = None
    for sf in files:
        if sf.rel.endswith(SCHEMA_REL_SUFFIX):
            text = sf.text
            break
    if text is None:
        for sf in files:
            p = Path(sf.path).resolve()
            for parent in p.parents:
                cand = parent / PACKAGE / "obs" / "metric_schema.py"
                if cand.is_file():
                    text = cand.read_text(encoding="utf-8")
                    break
            if text is not None:
                break
    if text is None:
        return None
    ns: dict = {}
    exec(compile(text, SCHEMA_REL_SUFFIX, "exec"), ns)  # stdlib-only module
    metrics: Dict[str, str] = {}
    for kind, table in (("counter", "COUNTERS"), ("gauge", "GAUGES"),
                        ("histogram", "HISTOGRAMS")):
        for name in ns.get(table, {}):
            metrics[name] = kind
    events = set(ns.get("EVENTS", {}))
    patterns: Dict[str, str] = dict(ns.get("METRIC_PATTERNS", {}))
    return metrics, events, patterns


def _name_arg(call: ast.Call) -> Optional[Tuple[str, bool]]:
    """(name-or-pattern, is_pattern) from the first argument, or None
    when it is not a string (Histogram.observe(float) etc.)."""
    if not call.args:
        return None
    arg = call.args[0]
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value, False
    if isinstance(arg, ast.JoinedStr):
        parts: List[str] = []
        for piece in arg.values:
            if isinstance(piece, ast.Constant) and isinstance(piece.value, str):
                parts.append(piece.value)
            else:
                parts.append("*")
        return "".join(parts), True
    return None


def check(files: Sequence[SourceFile]) -> List[Finding]:
    schema = _load_schema(files)
    findings: List[Finding] = []
    if schema is None:
        anchor = files[0].rel if files else "?"
        return [Finding(
            RULE, anchor, 1, 0,
            f"metric registry {PACKAGE}/obs/metric_schema.py not found in "
            "or near the scanned tree — metric names cannot be checked",
        )]
    metrics, events, patterns = schema
    for sf in files:
        if sf.rel.endswith(SCHEMA_REL_SUFFIX):
            continue  # the registry itself
        for node in ast.walk(sf.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)):
                continue
            attr = node.func.attr
            if attr in EMITTERS:
                named = _name_arg(node)
                if named is None:
                    continue
                name, is_pattern = named
                findings.extend(_check_metric(
                    sf, node, name, is_pattern, EMITTERS[attr],
                    metrics, patterns,
                ))
            elif attr == "event":
                named = _name_arg(node)
                if named is None or named[1]:
                    continue
                kind = named[0]
                if kind not in events:
                    findings.append(Finding(
                        RULE, sf.rel, node.lineno, node.col_offset,
                        f"event kind '{kind}' is not registered in "
                        "obs/metric_schema.py EVENTS — unregistered "
                        "events silently vanish from every consumer",
                    ))
    return findings


def _check_metric(sf: SourceFile, node: ast.Call, name: str,
                  is_pattern: bool, want_type: str,
                  metrics: Dict[str, str],
                  patterns: Dict[str, str]) -> List[Finding]:
    if is_pattern:
        # a dynamic name must be covered by a registered pattern of the
        # right type (``f"span.{name}_s"`` -> ``span.*_s``)
        for pat, ptype in patterns.items():
            if fnmatch.fnmatchcase(name, pat) and ptype == want_type:
                return []
        return [Finding(
            RULE, sf.rel, node.lineno, node.col_offset,
            f"dynamic metric name '{name}' matches no registered "
            f"{want_type} pattern in obs/metric_schema.py "
            "METRIC_PATTERNS",
        )]
    have = metrics.get(name)
    if have == want_type:
        return []
    if have is not None:
        return [Finding(
            RULE, sf.rel, node.lineno, node.col_offset,
            f"metric '{name}' is registered as a {have} but emitted "
            f"here as a {want_type} — one of the two is wrong",
        )]
    for pat, ptype in patterns.items():
        if fnmatch.fnmatchcase(name, pat):
            if ptype == want_type:
                return []
            return [Finding(
                RULE, sf.rel, node.lineno, node.col_offset,
                f"metric '{name}' matches pattern '{pat}' registered as "
                f"a {ptype} but is emitted here as a {want_type}",
            )]
    return [Finding(
        RULE, sf.rel, node.lineno, node.col_offset,
        f"{want_type} '{name}' is not registered in "
        "obs/metric_schema.py — typo'd series silently never aggregate",
    )]
