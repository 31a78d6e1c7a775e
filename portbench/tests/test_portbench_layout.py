"""BENCHMARK.json against the files the harness finds by name: every
cell has its traffic file, generator and job runner, every metric its
reader, every configuration its file; and the entries keep the shape
and the name rules the benchmark's readers expect."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
HERE = ROOT / "portbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_keep_their_keys_and_names(section):
    entries = BENCH[section]
    assert entries
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        assert set(e) - {"workloads"} == KEYS[section], e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in (
                "lower", "higher"), e["name"]
        for key in ("why", "layer"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]


def test_every_cell_finds_its_files():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and w["config"] in configs
        traffic = json.loads((HERE / "cells" / f"{w['name']}.json")
                             .read_text())
        assert (HERE / "inputs" / f"{traffic['generator']}.py").is_file()
        assert (HERE / "jobs" / f"{traffic['job']}.py").is_file()
    for c in configs.values():
        assert c["file"].startswith("portbench/")
        conf = json.loads((ROOT / c["file"]).read_text())
        for key in c["reduced"]:
            assert key in conf, (c["name"], key)


def test_every_metric_has_a_reader_and_a_cell():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file(), m["name"]
        assert set(m.get("workloads", cells)) <= cells, m["name"]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m["name"]
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        moved = next(x for x in BENCH["end_to_end"]
                     if x["name"] == m["moves"])
        assert set(m.get("workloads", cells)) <= set(
            moved.get("workloads", cells)), m["name"]


def test_every_cell_reports_enough():
    for w in BENCH["workloads"]:
        def here(m):
            return w["name"] in m.get("workloads", [w["name"]])
        e2e = [m["name"] for m in BENCH["end_to_end"] if here(m)]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert any(here(m) for m in BENCH["per_layer"]), w["name"]
