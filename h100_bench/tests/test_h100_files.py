"""Every entry of BENCHMARK.json resolves to its files by name, and the file
keeps to the benchmark's contract on names, bounds and metrics."""

import json
import re

import pytest
from conftest import BENCH, bench

import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_workloads_resolve_to_their_files():
    b = bench()
    for w in b["workloads"]:
        cell = harness.find_cell(w["name"], b)
        assert (BENCH / "drivers" / f"{cell.traffic['driver']}.py").is_file()
        assert (BENCH / "reference" / f"{cell.config['reference']}.py").is_file()
        assert (BENCH / "work" / f"{w['config']}.py").is_file()
        assert cell.config["name"] == w["config"]
        harness.load_module("drivers", cell.traffic["driver"])
        harness.load_module("work", w["config"])


def test_configs_name_their_files():
    b = bench()
    for c in b["configs"]:
        assert c["file"] == f"h100_bench/configs/{c['name']}.json"
        cfg = json.loads((BENCH.parent / c["file"]).read_text())
        assert cfg["source"] == c["source"]
        # a cut is of depth, and the file states the value it runs
        for key in c["reduced"]:
            assert key in cfg["model"] and not key.endswith(("_dim", "_rank", "_ch")), key
        assert set(cfg["limits"]) and cfg["control"] in ("fp8", "tf32")
        assert any(w["config"] == c["name"] for w in b["workloads"])


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics_have_readers(kind):
    for m in bench()[kind]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"] != "setup_s":
            assert callable(harness.load_module("metrics", m["name"]).read)


def test_contract_shape():
    b = bench()
    assert b["command"] == ["python3", "h100_bench/run.py"] and b["paths"] == ["h100_bench"]
    cells = {w["name"]: w for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    for m in b["per_layer"]:
        assert m["moves"] in e2e and m["workloads"]
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", cells)
    for name, w in cells.items():
        assert NAME.match(name) and w["chips"] == 1 and len(w["why"]) <= 200
        mine = [m for m in e2e.values() if name in m.get("workloads", cells)]
        assert len(mine) >= 2 and any(name in m["workloads"] for m in b["per_layer"])
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
