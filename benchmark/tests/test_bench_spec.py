"""The harness finds every cell, configuration, traffic mix, limit file and
metric of BENCHMARK.json by its name, and the file keeps to the contract's
shape."""

import json
import re

import pytest

from benchmark import spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found(cell):
    c = spec.load_cell(cell)
    assert c.cfg["family"] and c.traffic["kind"] in ("images", "tokens")
    compared = set(c.limits["limits"])
    assert "count_gap" in compared and "change1_gap" in compared
    assert compared <= {"loss_gap", "count_gap", "change1_gap", "change2_gap",
                        "change1_mean_gap", "change2_mean_gap"}
    assert c.limits["control"] == "fp8"
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_metric_reader_found(metric):
    assert callable(spec.reader(metric))


def test_names_and_files():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in configs.values():
        assert (spec.ROOT / c["file"]).is_file()
        assert json.loads((spec.ROOT / c["file"]).read_text())["source"] == c["source"]
    for m in BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]), m["name"]
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == set(configs)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert 1 <= len(m["layer"]) <= 200
