"""Project-specific static analysis — the ``fedlint`` checker suite over
the port (counterpart of ``fedml_tpu/analysis``), and the runtime
``CheckedLock`` harness (``analysis.locks``) that the comm runtime imports.

Rules (one module per rule; ``python -m fedml_tpu_torch.analysis`` is the
CLI, with ``tools/fedlint.py``'s flags and exit codes):

- ``determinism``     — no seedless ``random.*``/``np.random.*``, no
  torch global-RNG draw without a ``generator=`` and no wall-clock
  ``time.time()`` in round-path modules; randomness must be seeded
  (``RandomState(seed)``, threefry ``fold_in``-derived streams) and
  timestamps belong to ``obs/``.
- ``jit-purity``      — functions reachable from capture roots
  (``torch.compile``, ``torch.jit``) and SPMD roots (``compat.shard_map``,
  ``partition.jit_sharded``) must not contain host side effects
  (``print``, ``time.*``, ``.item()``, numpy RNG, telemetry).
- ``wire-schema``     — reserved frame-header keys (``__hub__``,
  ``__trace__``, ``__binlen__``, ``__ndbuf__``, ``__wiretree__``,
  ``__ndarray__``) are defined ONCE (``comm/message.py`` /
  ``obs/trace_ctx.py``); literal duplicates elsewhere are the drift
  class behind silent wire-format skew.
- ``metric-name``     — every counter/gauge/histogram/event name used
  in code must appear in ``obs/metric_schema.py``.
- ``lock-discipline`` — attributes a class declares in ``_GUARDED_BY``
  may only be touched inside ``with self.<lock>:`` scopes (or in
  methods annotated ``# fedlint: holds=<lock>``, verified at runtime
  by ``locks.assert_held``).

Suppression: ``# fedlint: disable=<rule> -- <justification>`` on the
finding's line.  The justification is REQUIRED — a bare disable is
itself a (non-suppressible) ``pragma`` finding.

Everything in this package is stdlib-only: the lint runs on a bare
Python with neither torch nor numpy installed.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from fedml_tpu_torch.analysis.base import Finding, SourceFile, load_files

RULES = (
    "determinism",
    "jit-purity",
    "wire-schema",
    "metric-name",
    "lock-discipline",
)


def run_all(files: Sequence[SourceFile],
            rules: Optional[Sequence[str]] = None) -> List[Finding]:
    """Run the selected checkers (default: all) over ``files`` and
    return pragma-filtered findings, sorted by (path, line).  Pragma
    misuse (a ``disable`` with no justification) is appended as
    ``pragma`` findings — those are never suppressible."""
    # checker imports are function-level so importing the package (for
    # ``analysis.locks``) stays O(one small module) on hot paths
    from fedml_tpu_torch.analysis import (
        determinism,
        jit_purity,
        lock_discipline,
        metric_names,
        wire_schema,
    )

    checkers = {
        "determinism": determinism.check,
        "jit-purity": jit_purity.check,
        "wire-schema": wire_schema.check,
        "metric-name": metric_names.check,
        "lock-discipline": lock_discipline.check,
    }
    selected = list(rules) if rules else list(RULES)
    unknown = [r for r in selected if r not in checkers]
    if unknown:
        raise ValueError(f"unknown fedlint rules: {unknown} (have {RULES})")
    findings: List[Finding] = []
    by_rel = {f.rel: f for f in files}
    for rule in selected:
        for fnd in checkers[rule](files):
            sf = by_rel.get(fnd.path)
            if sf is not None and fnd.rule in sf.disables.get(fnd.line, ()):
                continue  # suppressed by a justified pragma
            findings.append(fnd)
    for sf in files:
        findings.extend(sf.pragma_errors)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


__all__ = ["Finding", "SourceFile", "load_files", "run_all", "RULES"]
