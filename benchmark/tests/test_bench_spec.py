"""BENCHMARK.json keeps to the contract's shapes and characters, and every
cell finds its files by name."""

import json
import os
import re

import pytest

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"]
    assert 1 <= spec["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_and_units(spec):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in spec[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
            for k in ("config", "traffic"):
                if k in e:
                    assert NAME.match(e[k]), e[k]
            for k in e.get("reduced", []):
                assert NAME.match(k), k
            for k in ("why", "layer", "source"):
                if k in e and isinstance(e[k], str):
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]
    for group in ("configs", "workloads"):
        ns = [e["name"] for e in spec[group]]
        assert len(ns) == len(set(ns))
    metrics = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_every_cell_finds_its_files(spec):
    configs = {c["name"] for c in spec["configs"]}
    for w in spec["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        for part in (("traffic", w["traffic"]), ("limits", w["name"])):
            assert os.path.exists(os.path.join(BENCH, part[0], part[1] + ".json"))
    for c in spec["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert any(w["config"] == c["name"] for w in spec["workloads"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics", m["name"] + ".py"))


def test_metrics_and_cells_agree(spec):
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = [w["name"] for w in spec["workloads"]]
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        moved = e2e[m["moves"]].get("workloads", cells)
        assert set(m.get("workloads", cells)) <= set(moved)
    for w in cells:
        others = [m for m in spec["end_to_end"] if m["name"] != "setup_s"
                  and w in m.get("workloads", cells)]
        assert others, w
        assert any(w in m.get("workloads", cells) for m in spec["per_layer"]), w
