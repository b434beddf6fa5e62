"""determinism — seedless randomness / wall-clock bans in round-path code
(port of ``fedml_tpu/analysis/determinism.py``).

The reproducibility contract (PR 4/5: byte-identical same-seed upload
digests, deterministic chaos schedules) only holds if every random draw
in the round path flows from an explicit seed — ``np.random.RandomState
(seed)``, ``random.Random(seed_string)``, or a jax ``fold_in``-derived
stream — and nothing reads the wall clock where behavior depends on it.
This rule flags, in round-path modules only:

- module-level stdlib ``random.*`` draws (the shared, seedless global
  RNG: ``random.random()``, ``randint``, ``choice``, ...);
- ``random.Random()`` constructed WITHOUT a seed;
- ``np.random.*`` draws and ``np.random.seed`` (global-state RNG);
  seeded constructors (``RandomState(seed)``, ``default_rng(seed)``)
  pass, the same constructors with no argument do not;
- torch's global-RNG draws, the port's counterpart of seedless
  ``np.random.*``: ``torch.rand``/``randn``/``randint``/``randperm``/
  ``bernoulli``/``multinomial``/``normal``/``poisson`` (and their
  ``_like`` forms) and the in-place tensor draws ``.normal_()``,
  ``.uniform_()``, ``.bernoulli_()``, ``.random_()`` and the like, each
  without a ``generator=``; ``torch.manual_seed``/``torch.seed`` (global
  state).  A draw given a seeded ``torch.Generator`` passes; the port's
  round path draws JAX's threefry streams (``core/rng.py``) instead;
- ``time.time()`` / ``time.time_ns()`` — wall-clock timestamps belong
  to the obs/ layer (monotonic ``perf_counter`` spans are fine and are
  not flagged).

Round-path scope, under ``fedml_tpu_torch/``: ``comm/``, ``algorithms/``,
``core/``, ``compress/``,
``faults/``, ``parallel/``, ``ops/``.  ``obs/`` (whose whole job is
timestamps), ``experiments/`` (driver wall-time reporting), ``data/``
and ``models/`` are out of scope.
"""

from __future__ import annotations

import ast
from typing import List, Sequence

from fedml_tpu_torch.analysis.base import (
    PACKAGE,
    Finding,
    SourceFile,
    module_aliases,
    resolve_call_target,
)

RULE = "determinism"

ROUND_PATH_PREFIXES = tuple(
    f"{PACKAGE}/{d}/" for d in ("comm", "algorithms", "core", "compress", "faults",
                                "parallel", "ops"))

# module-level functions on stdlib random's hidden global Random()
SEEDLESS_RANDOM_FNS = {
    "random", "randint", "randrange", "randbytes", "choice", "choices",
    "shuffle", "sample", "uniform", "triangular", "betavariate",
    "expovariate", "gammavariate", "gauss", "lognormvariate",
    "normalvariate", "vonmisesvariate", "paretovariate",
    "weibullvariate", "getrandbits",
}

# np.random constructors that are deterministic WHEN GIVEN a seed
NP_SEEDED_CONSTRUCTORS = {
    "RandomState", "default_rng", "Generator", "SeedSequence",
    "PCG64", "Philox", "MT19937", "SFC64", "BitGenerator",
}

WALL_CLOCK_FNS = {"time.time", "time.time_ns"}

# torch functions that draw from the global generator unless given one
TORCH_DRAWS = {
    "rand", "randn", "randint", "randperm", "rand_like", "randn_like",
    "randint_like", "bernoulli", "multinomial", "normal", "poisson",
}
# in-place tensor draws (``t.normal_()``): global generator unless given one
TORCH_INPLACE_DRAWS = {
    "normal_", "uniform_", "bernoulli_", "random_", "exponential_",
    "geometric_", "cauchy_", "log_normal_",
}
TORCH_GLOBAL_SEEDING = {"torch.manual_seed", "torch.seed"}


def in_scope(rel: str) -> bool:
    return rel.startswith(ROUND_PATH_PREFIXES)


def check(files: Sequence[SourceFile]) -> List[Finding]:
    findings: List[Finding] = []
    for sf in files:
        if not in_scope(sf.rel):
            continue
        aliases = module_aliases(sf.tree)
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            msg = _classify_inplace(node)
            target = resolve_call_target(node.func, aliases)
            if msg is None and target is not None:
                msg = _classify(target, node)
            if msg is not None:
                findings.append(
                    Finding(RULE, sf.rel, node.lineno, node.col_offset, msg)
                )
    return findings


def _has_generator(call: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in call.keywords)


def _classify_inplace(call: ast.Call):
    """The finding message of an in-place torch draw on the global
    generator (``t.normal_()`` with no ``generator=``), else None."""
    func = call.func
    if isinstance(func, ast.Attribute) and func.attr in TORCH_INPLACE_DRAWS \
            and not _has_generator(call):
        return (
            f"global-RNG torch draw '.{func.attr}()' in a round-path module "
            "— pass a seeded torch.Generator (generator=) or draw from a "
            "threefry stream (core/rng.py)"
        )
    return None


def _classify(target: str, call: ast.Call):
    """None when the call is fine; otherwise the finding message."""
    head, _, tail = target.partition(".")
    if head == "random":
        if tail in SEEDLESS_RANDOM_FNS:
            return (
                f"seedless stdlib RNG 'random.{tail}()' in a round-path "
                "module — draw from an explicitly seeded "
                "random.Random(...) or a fold_in-derived stream"
            )
        if tail == "Random" and not call.args and not call.keywords:
            return (
                "'random.Random()' without a seed — pass an explicit "
                "seed (a stable string seeds via sha512, cross-process)"
            )
        return None
    if target.startswith("numpy.random.") or head == "numpy.random":
        fn = target.split(".")[-1]
        if fn in NP_SEEDED_CONSTRUCTORS:
            if call.args or call.keywords:
                return None  # RandomState(seed), default_rng(seed): seeded
            return (
                f"'np.random.{fn}()' without a seed in a round-path "
                "module — pass the run seed (or a fold_in-derived value)"
            )
        return (
            f"seedless/global-state numpy RNG 'np.random.{fn}(...)' in a "
            "round-path module — use np.random.RandomState(seed) or a "
            "fold_in-derived stream"
        )
    if head == "torch" and tail in TORCH_DRAWS and not _has_generator(call):
        return (
            f"global-RNG torch draw 'torch.{tail}(...)' in a round-path "
            "module — pass a seeded torch.Generator (generator=) or draw "
            "from a threefry stream (core/rng.py)"
        )
    if target in TORCH_GLOBAL_SEEDING:
        return (
            f"global-state torch seeding '{target}()' in a round-path "
            "module — seed a torch.Generator of your own instead"
        )
    if target in WALL_CLOCK_FNS:
        return (
            f"wall-clock '{target}()' in a round-path module — "
            "timestamps belong to obs/ (use time.perf_counter() for "
            "spans; wall stamps only via the telemetry layer)"
        )
    return None
