"""jit-purity — no host side effects reachable from capture or SPMD roots
(port of ``fedml_tpu/analysis/jit_purity.py``).

JAX traces a ``jax.jit`` / ``shard_map`` / ``pjit`` body ONCE, so a host
effect inside it vanishes on cache hits, forces a device→host sync or
bakes an RNG draw into the trace.  The port runs eagerly, and its roots
are the places where the same hazards live:

- **capture**: ``torch.compile``, ``torch.jit.trace``/``script`` and
  ``torch.cuda.make_graphed_callables`` run the Python body once to
  capture it, as ``jax.jit`` traces it;
- **SPMD rank bodies**: ``compat.shard_map`` (every engine's
  ``shard_map`` counterpart) and ``partition.jit_sharded`` (the rule
  engine's entry point, JAX's ``jit`` with shardings) run their function
  on every rank of a mesh, and the ranks must run the same program: a
  ``.item()`` stalls every rank's queue of collectives on a sync, a host
  RNG draw or clock read can differ between ranks (replicated values
  then diverge), and telemetry or logging runs once a rank.

JAX's own spellings (``jax.jit``, ``pjit``, ``jax.shard_map``) stay
roots too, so code written against them is checked alike.  The other
per-rank step functions (``gspmd``'s round, ``spmd``'s and ``dp_sp``'s
rounds, ``tensor``'s train step) are plain functions called inside
``use_mesh``: no transform wraps them, nothing captures them, and a host
effect in them runs on every call, as in any eager round; their seedless
draws are ``determinism``'s (``parallel/`` is a round path).
``utils/timing.py``'s CUDA-graph capture in ``kernel_ms`` captures a
callable it is handed at run time, which no static scan can resolve.

Flagged inside any reachable function body:

- ``print(...)``;
- host clocks: ``time.time/perf_counter/monotonic/sleep/...``;
- device→host sync: ``.item()``;
- untraced RNG: ``np.random.*`` and stdlib ``random.*`` draws;
- telemetry/logging: ``get_telemetry(...)`` and ``logging.*`` calls.

Root detection (resolvable cases only — a root applied to a CALL
RESULT, e.g. ``jax.jit(make_round_fn(...))``, cannot be traced
statically and is skipped):

- ``jax.jit(f)`` / ``torch.compile(f)`` / ``shard_map(f, ...)`` where
  ``f`` is a name bound to a def (module-level or nested — resolution is
  innermost-scope-first);
- decorators ``@jax.jit``, ``@torch.compile``, ``@torch.jit.script``,
  ``@jax.jit(...)``, and ``@partial(jax.jit, ...)``;
- local aliases of the transforms (``shard_map = jax.shard_map``).

Reachability follows simple-name calls, names passed as call arguments
(``lax.scan(body, ...)`` traces ``body``), and cross-module
``from fedml_tpu_torch.x import f`` / ``mod.f`` references into other
scanned files.  Scope: the whole package.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from fedml_tpu_torch.analysis.base import (
    PACKAGE,
    Finding,
    SourceFile,
    dotted_name,
    module_aliases,
    resolve_call_target,
)

RULE = "jit-purity"

JIT_TRANSFORMS = {
    "jax.jit",
    "jax.pjit",
    "jax.experimental.pjit.pjit",
    "jax.shard_map",
    "jax.experimental.shard_map.shard_map",
    # torch's capture transforms: the body runs once, at capture
    "torch.compile",
    "torch.jit.trace",
    "torch.jit.script",
    "torch.cuda.make_graphed_callables",
    # the port's shard_map counterpart: its function is a rank body, run
    # on every rank of the mesh
    f"{PACKAGE}.parallel.compat.shard_map",
    # the partition-rule engine's entry point (JAX's jit with sharding
    # annotations): every function of the sharding subsystem runs
    # through it, on every rank
    f"{PACKAGE}.parallel.partition.jit_sharded",
}

HOST_CLOCKS = {
    "time.time", "time.time_ns", "time.perf_counter",
    "time.perf_counter_ns", "time.monotonic", "time.monotonic_ns",
    "time.sleep", "time.process_time",
}


class _Scope:
    """One function body: its statements (nested defs excluded), the
    scope path for name resolution, and its source file."""

    def __init__(self, sf: SourceFile, qual: Tuple[str, ...], node: ast.AST):
        self.sf = sf
        self.qual = qual  # ("make_eval", "evaluate") etc.
        self.node = node


def _collect_defs(sf: SourceFile) -> Dict[Tuple[str, ...], _Scope]:
    defs: Dict[Tuple[str, ...], _Scope] = {}

    def walk(node: ast.AST, scope: Tuple[str, ...]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = scope + (child.name,)
                defs[qual] = _Scope(sf, qual, child)
                walk(child, qual)
            elif isinstance(child, ast.ClassDef):
                walk(child, scope + (child.name,))
            else:
                walk(child, scope)

    walk(sf.tree, ())
    return defs


def _own_body(fn: ast.AST):
    """Every node of a function body EXCLUDING nested function/class
    subtrees (those are separate call-graph nodes)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        # lambdas stay in: they are traced inline by the enclosing jit.
        # Nested def/class subtrees are separate call-graph nodes.
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
            stack.extend(ast.iter_child_nodes(node))


def _resolve_local(name: str, scope: Tuple[str, ...],
                   defs: Dict[Tuple[str, ...], _Scope],
                   ) -> Optional[Tuple[str, ...]]:
    """Innermost-first: ``evaluate`` referenced inside ``make_eval``
    finds ``("make_eval", "evaluate")`` before a module-level def."""
    for depth in range(len(scope), -1, -1):
        qual = scope[:depth] + (name,)
        if qual in defs:
            return qual
    return None


def _transform_aliases(sf: SourceFile, aliases: Dict[str, str]) -> Set[str]:
    """Names that refer to a jit-like transform in this module: the
    canonical dotted forms, plus ``from jax import jit`` aliases and
    module-level re-bindings (``shard_map = jax.shard_map``)."""
    names = set(JIT_TRANSFORMS)
    for alias, target in aliases.items():
        if target in JIT_TRANSFORMS:
            names.add(alias)
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            target = resolve_call_target(node.value, aliases) \
                if isinstance(node.value, (ast.Attribute, ast.Name)) else None
            if target in JIT_TRANSFORMS:
                names.add(node.targets[0].id)
    return names


def _is_transform(func: ast.AST, aliases: Dict[str, str],
                  transform_names: Set[str]) -> bool:
    name = dotted_name(func)
    if name is None:
        return False
    if name in transform_names:
        return True
    resolved = resolve_call_target(func, aliases)
    return resolved in JIT_TRANSFORMS


def _fn_arg(call: ast.Call) -> Optional[ast.AST]:
    """The function operand of a transform call: first positional arg,
    or the ``fun=``/``f=`` keyword."""
    if call.args:
        return call.args[0]
    for kw in call.keywords:
        if kw.arg in ("fun", "f", "func"):
            return kw.value
    return None


def check(files: Sequence[SourceFile]) -> List[Finding]:
    all_defs: Dict[Tuple[str, ...], _Scope] = {}
    per_file_defs: Dict[str, Dict[Tuple[str, ...], _Scope]] = {}
    per_file_aliases: Dict[str, Dict[str, str]] = {}
    # (module, top-level def name) -> (file rel, qual) for cross-module hops
    exported: Dict[Tuple[str, str], Tuple[str, Tuple[str, ...]]] = {}
    for sf in files:
        defs = _collect_defs(sf)
        per_file_defs[sf.rel] = defs
        per_file_aliases[sf.rel] = module_aliases(sf.tree)
        for qual in defs:
            if len(qual) == 1:
                exported[(sf.module, qual[0])] = (sf.rel, qual)

    # --- roots: (rel, qual) reachable seeds + where the root was seen
    roots: List[Tuple[str, Tuple[str, ...], str]] = []
    lambda_roots: List[Tuple[SourceFile, Tuple[str, ...], ast.Lambda, str]] = []

    for sf in files:
        defs = per_file_defs[sf.rel]
        aliases = per_file_aliases[sf.rel]
        transforms = _transform_aliases(sf, aliases)

        # decorator roots
        for qual, scope in defs.items():
            fn = scope.node
            for dec in getattr(fn, "decorator_list", ()):
                root_desc = f"{sf.rel}:{fn.lineno}"
                if _is_transform(dec, aliases, transforms):
                    roots.append((sf.rel, qual, root_desc))
                elif isinstance(dec, ast.Call):
                    if _is_transform(dec.func, aliases, transforms):
                        roots.append((sf.rel, qual, root_desc))
                    elif resolve_call_target(dec.func, aliases) in (
                            "functools.partial", "partial") and dec.args \
                            and _is_transform(dec.args[0], aliases, transforms):
                        roots.append((sf.rel, qual, root_desc))

        # call-site roots: jax.jit(f) / shard_map(f, ...) anywhere
        def scan_calls(container: ast.AST, scope_qual: Tuple[str, ...]):
            # _own_body for the module pass too: nested defs are scanned
            # with their own scope, and resolving their call sites at
            # module scope would bind local names to unrelated
            # module-level defs
            for node in _own_body(container):
                if not isinstance(node, ast.Call):
                    continue
                is_partial = (resolve_call_target(node.func, aliases)
                              in ("functools.partial", "partial")
                              and node.args
                              and _is_transform(node.args[0], aliases,
                                                transforms))
                if not (_is_transform(node.func, aliases, transforms)
                        or is_partial):
                    continue
                arg = (_fn_arg(ast.Call(func=node.func,
                                        args=node.args[1:],
                                        keywords=node.keywords))
                       if is_partial else _fn_arg(node))
                if arg is None:
                    continue
                desc = f"{sf.rel}:{node.lineno}"
                if isinstance(arg, ast.Name):
                    qual = _resolve_local(arg.id, scope_qual, defs)
                    if qual is not None:
                        roots.append((sf.rel, qual, desc))
                elif isinstance(arg, ast.Lambda):
                    lambda_roots.append((sf, scope_qual, arg, desc))

        scan_calls(sf.tree, ())
        for qual, scope in defs.items():
            scan_calls(scope.node, qual)

    # --- reachability over (rel, qual) nodes
    reached: Dict[Tuple[str, Tuple[str, ...]], str] = {}
    work = [(rel, qual, desc) for rel, qual, desc in roots]
    while work:
        rel, qual, desc = work.pop()
        key = (rel, qual)
        if key in reached:
            continue
        reached[key] = desc
        defs = per_file_defs[rel]
        scope = defs.get(qual)
        if scope is None:
            continue
        aliases = per_file_aliases[rel]
        for node in _own_body(scope.node):
            names: List[str] = []
            if isinstance(node, ast.Call):
                if isinstance(node.func, ast.Name):
                    names.append(node.func.id)
                # function-valued arguments: lax.scan(body, ...),
                # vmap(f), custom_vjp wiring — trace them all
                for arg in list(node.args) + [k.value for k in node.keywords]:
                    if isinstance(arg, ast.Name):
                        names.append(arg.id)
                target = resolve_call_target(node.func, aliases)
                if target is not None and target.startswith(f"{PACKAGE}."):
                    mod, _, leaf = target.rpartition(".")
                    hop = exported.get((mod, leaf))
                    if hop is not None:
                        work.append((hop[0], hop[1], desc))
            for name in names:
                local = _resolve_local(name, qual, defs)
                if local is not None:
                    work.append((rel, local, desc))
                    continue
                imported = aliases.get(name)
                if imported and imported.startswith(f"{PACKAGE}."):
                    mod, _, leaf = imported.rpartition(".")
                    hop = exported.get((mod, leaf))
                    if hop is not None:
                        work.append((hop[0], hop[1], desc))

    # --- impurity scan
    findings: List[Finding] = []
    by_rel = {sf.rel: sf for sf in files}
    for (rel, qual), desc in sorted(reached.items()):
        sf = by_rel[rel]
        scope = per_file_defs[rel][qual]
        aliases = per_file_aliases[rel]
        findings.extend(
            _scan_effects(sf, ".".join(qual), scope.node, aliases, desc)
        )
    for sf, scope_qual, lam, desc in lambda_roots:
        findings.extend(
            _scan_effects(sf, "<lambda>", lam,
                          per_file_aliases[sf.rel], desc, include_nested=True)
        )
    return findings


def _scan_effects(sf: SourceFile, qualname: str, fn: ast.AST,
                  aliases: Dict[str, str], root_desc: str,
                  include_nested: bool = False) -> List[Finding]:
    findings: List[Finding] = []
    nodes = ast.walk(fn) if include_nested else _own_body(fn)
    for node in nodes:
        if not isinstance(node, ast.Call):
            continue
        effect = _classify_effect(node, aliases)
        if effect is not None:
            findings.append(Finding(
                RULE, sf.rel, node.lineno, node.col_offset,
                f"{effect} inside '{qualname}', which runs under a "
                f"capture/shard_map root at {root_desc} — host effects "
                "run once at capture, or apart on every rank of a mesh",
            ))
    return findings


def _classify_effect(call: ast.Call, aliases: Dict[str, str]) -> Optional[str]:
    func = call.func
    if isinstance(func, ast.Name) and func.id == "print":
        return "host 'print()'"
    if isinstance(func, ast.Attribute) and func.attr == "item" \
            and not call.args and not call.keywords:
        return "device->host sync '.item()'"
    target = resolve_call_target(func, aliases)
    if target is None:
        return None
    if target in HOST_CLOCKS:
        return f"host clock '{target}()'"
    if target.startswith("numpy.random."):
        return f"untraced numpy RNG '{target}()'"
    head, _, tail = target.partition(".")
    if head == "random" and tail:
        return f"untraced stdlib RNG 'random.{tail}()'"
    if target.endswith("get_telemetry"):
        return "telemetry registry access 'get_telemetry()'"
    if head == "logging" and tail:
        return f"host logging call '{target}()'"
    return None
