"""The port's fedlint suite (``fedml_tpu_torch/analysis``) held against the
JAX package's (``fedml_tpu/analysis``):

- every fixture source of ``tests/test_analysis.py`` (read from that file's
  ``make(rel, src)`` calls, each set of files linted together), with its
  path moved from ``fedml_tpu/`` to ``fedml_tpu_torch/``, gives the port's
  checkers the findings JAX's checkers give (rule, line, column), under
  all five rules;
- pragma suppression with a justification, and the bare-pragma finding;
- the port's own cases: torch global-RNG draws under ``determinism``, the
  port's capture and SPMD roots under ``jit-purity``, a reserved key
  copied outside its definition site under ``wire-schema``;
- ``run_all`` over ``fedml_tpu_torch/`` reports 0 findings;
- ``python -m fedml_tpu_torch.analysis``: JSON output and exit codes;
- the rule modules import neither torch nor numpy (loaded in a subprocess
  that blocks both).
"""

import ast
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from fedml_tpu.analysis import run_all as jax_run_all
from fedml_tpu.analysis.base import SourceFile as JaxSourceFile
from fedml_tpu_torch.analysis import RULES, load_files, run_all
from fedml_tpu_torch.analysis.base import SourceFile

REPO = Path(__file__).resolve().parent.parent
JAX_FIXTURES = REPO / "tests" / "test_analysis.py"


def _port_rel(rel: str) -> str:
    assert rel.startswith("fedml_tpu/"), rel
    return "fedml_tpu_torch/" + rel[len("fedml_tpu/"):]


def _fixture_sets():
    """``(test name, [(rel, source), ...])`` for each list of ``make(rel,
    src)`` calls in ``tests/test_analysis.py`` (a loop over rels gives one
    set a rel), the sources dedented as its ``make`` dedents them."""
    tree = ast.parse(JAX_FIXTURES.read_text())
    consts = {n.targets[0].id: n.value.value for n in tree.body
              if isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Name)
              and isinstance(n.value, ast.Constant) and isinstance(n.value.value, str)}
    out = []
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        names = {k: [v] for k, v in consts.items()}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Constant):
                names[node.targets[0].id] = [node.value.value]
            elif isinstance(node, ast.For) and isinstance(node.target, ast.Name) \
                    and isinstance(node.iter, ast.Tuple) \
                    and all(isinstance(e, ast.Constant) for e in node.iter.elts):
                names[node.target.id] = [e.value for e in node.iter.elts]

        def values(arg):
            return [arg.value] if isinstance(arg, ast.Constant) else names[arg.id]

        for node in ast.walk(fn):
            if not (isinstance(node, ast.List) and node.elts and all(
                    isinstance(e, ast.Call) and getattr(e.func, "id", "") == "make"
                    for e in node.elts)):
                continue
            calls = [(values(e.args[0]), values(e.args[1])[0]) for e in node.elts]
            for i in range(max(len(rels) for rels, _ in calls)):
                files = [(rels[min(i, len(rels) - 1)], textwrap.dedent(src))
                         for rels, src in calls]
                out.append((f"{fn.name}-{len(out)}", files))
    return out


FIXTURE_SETS = _fixture_sets()


def _key(findings, move=False):
    return sorted((f.rule, _port_rel(f.path) if move else f.path, f.line, f.col)
                  for f in findings)


def test_fixture_sets_cover_every_rule():
    assert len(FIXTURE_SETS) >= 14
    rules = {f.rule for _, files in FIXTURE_SETS
             for f in jax_run_all([JaxSourceFile(src, rel) for rel, src in files])}
    assert rules == set(RULES) | {"pragma"}


@pytest.mark.parametrize("files", [files for _, files in FIXTURE_SETS],
                         ids=[name for name, _ in FIXTURE_SETS])
def test_port_rules_give_jax_s_findings_on_jax_s_fixtures(files):
    want = jax_run_all([JaxSourceFile(src, rel) for rel, src in files])
    got = run_all([SourceFile(src, _port_rel(rel)) for rel, src in files])
    assert _key(got) == _key(want, move=True)


def _lint(rel, src, rules=None):
    return run_all([SourceFile(textwrap.dedent(src), rel)], rules=rules)


def test_pragma_suppression_and_the_bare_pragma_finding():
    src = """
        import torch

        def draw():
            return torch.randn(3)  # fedlint: disable=determinism -- fixture: documented-unsafe path

        def bare():
            return torch.randn(3)  # fedlint: disable=determinism
    """
    findings = _lint("fedml_tpu_torch/core/fx.py", src, ["determinism"])
    assert sorted((f.rule, f.line) for f in findings) == [("determinism", 8), ("pragma", 8)]
    assert any("justification" in f.message for f in findings)


TORCH_RNG = """
    import torch
    from torch import randperm

    def draws(x, g):
        a = torch.randn(3)
        b = torch.rand(2, generator=g)
        x.normal_()
        x.uniform_(0, 1, generator=g)
        torch.manual_seed(0)
        c = randperm(5)
        d = torch.bernoulli(x, generator=g)
        return a, b, c, d
"""


def test_determinism_flags_torch_global_rng_draws():
    findings = _lint("fedml_tpu_torch/algorithms/fx.py", TORCH_RNG, ["determinism"])
    assert [f.line for f in findings] == [6, 8, 10, 11]
    assert "torch.randn" in findings[0].message and ".normal_()" in findings[1].message
    assert "manual_seed" in findings[2].message and "torch.randperm" in findings[3].message
    for rel in ("fedml_tpu_torch/obs/fx.py", "fedml_tpu_torch/models/fx.py",
                "fedml_tpu/core/fx.py"):
        assert _lint(rel, TORCH_RNG, ["determinism"]) == []


def test_jit_purity_sees_the_port_s_roots():
    src = """
        import time
        import torch
        from fedml_tpu_torch.parallel.compat import shard_map
        from fedml_tpu_torch.parallel.partition import jit_sharded

        def local(x):
            return x.sum().item()

        def make(mesh):
            return shard_map(local, mesh=mesh)

        @torch.compile
        def step(x):
            print(x)
            return x

        def round_fn(state):
            return state, time.time()

        engine = jit_sharded(round_fn)

        def eager(x):
            print(x)  # no root reaches it
            return x
    """
    findings = _lint("fedml_tpu_torch/parallel/fx.py", src, ["jit-purity"])
    assert [f.line for f in findings] == [8, 15, 19]
    assert ".item()" in findings[0].message and "print" in findings[1].message
    assert "time.time" in findings[2].message


def test_wire_schema_flags_a_copy_outside_the_definition_site():
    findings = _lint("fedml_tpu_torch/compress/codecs.py", 'NDARRAY_KEY = "__ndarray__"\n',
                     ["wire-schema"])
    assert len(findings) == 1 and "fedml_tpu_torch/comm/message.py" in findings[0].message
    assert _lint("fedml_tpu_torch/comm/message.py", 'NDARRAY_KEY = "__ndarray__"\n',
                 ["wire-schema"]) == []


def test_port_tree_is_clean():
    files = load_files(REPO / "fedml_tpu_torch")
    assert len(files) > 100
    findings = run_all(files)
    assert findings == [], "\n".join(f.format() for f in findings)


def _cli(*args):
    return subprocess.run([sys.executable, "-m", "fedml_tpu_torch.analysis", *args],
                          capture_output=True, text=True, cwd=REPO)


def test_cli_json_and_exit_codes(tmp_path):
    out = _cli("--json")
    assert out.returncode == 0, out.stdout + out.stderr
    payload = json.loads(out.stdout)
    assert payload["ok"] is True and payload["files_scanned"] > 100
    assert payload["rules"] == list(RULES)

    bad = tmp_path / "bad.py"
    bad.write_text('KEY = {"__hub__": "stop"}\nOTHER = "__hub__"\n')
    out = _cli(str(bad), "--rules", "wire-schema", "--json")
    assert out.returncode == 1
    assert json.loads(out.stdout)["counts"] == {"wire-schema": 2}
    out = _cli(str(bad), "--rules", "wire-schema")
    assert out.returncode == 1 and "2 finding(s) in 1 file(s)" in out.stderr
    assert out.stdout.count("[wire-schema]") == 2
    assert _cli(str(tmp_path / "missing.py")).returncode == 2
    assert _cli(str(bad), "--rules", "no-such-rule").returncode == 2
    out = _cli("--list-rules")
    assert out.returncode == 0 and out.stdout.split() == list(RULES)


BLOCKED = """
import json, sys

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("torch", "numpy"):
            raise ImportError(f"blocked: {name}")

sys.meta_path.insert(0, Blocker())
from fedml_tpu_torch import analysis
from fedml_tpu_torch.analysis import (base, determinism, jit_purity, lock_discipline, locks,
                                      metric_names, wire_schema)
from fedml_tpu_torch.analysis.__main__ import main

rc = main(["--rules", ",".join(analysis.RULES)])
print(json.dumps({"rc": rc, "loaded": sorted(m for m in sys.modules
                                             if m.split(".")[0] in ("torch", "numpy"))}))
"""


def test_rule_modules_import_neither_torch_nor_numpy():
    out = subprocess.run([sys.executable, "-c", BLOCKED], capture_output=True, text=True,
                         cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {"rc": 0, "loaded": []}
