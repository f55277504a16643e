"""BENCHMARK.json against the contract's rules that a file can show: names,
units and lengths, one file for each name, and each per-layer metric
moving one end-to-end metric that all its cells report."""

from __future__ import annotations

import json
import re

from benchmark import harness

MAN = harness.read_json(harness.REPO / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_keys_and_sizes():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert len((harness.REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert MAN["paths"] == ["benchmark"] and MAN["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert 1 <= len(MAN["configs"]) <= 24 and 1 <= len(MAN["workloads"]) <= 24
    assert 1 <= len(MAN["end_to_end"]) <= 16 and 1 <= len(MAN["per_layer"]) <= 128


def test_names_units_and_lines():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in MAN[group]]
        assert len(names) == len(set(names)), group
        for e in MAN[group]:
            assert NAME.match(e["name"]), e["name"]
            for k in ("why", "layer"):
                if k in e:
                    assert LINE.match(e[k]), (e["name"], k)
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16 and LINE.match(c["source"])
        assert c["file"].startswith("benchmark/") and (harness.REPO / c["file"]).is_file()
        assert harness.read_json(harness.REPO / c["file"])["reduced"] == c["reduced"]
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))


def test_every_name_has_its_files():
    configs = {c["name"] for c in MAN["configs"]}
    pairs = set()
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        t = harness.read_json(harness.ROOT / "traffic" / f"{w['traffic']}.json")
        assert (harness.ROOT / "drivers" / f"{t['driver']}.py").is_file()
        assert (harness.ROOT / "paths" / f"{t['path']}.py").is_file()
        assert harness.read_json(harness.ROOT / "cells" / f"{w['name']}.json")["limits"]
    assert configs == {w["config"] for w in MAN["workloads"]}
    for m in MAN["per_layer"]:
        assert harness.reader(harness.ROOT, m["name"]).is_file(), m["name"]


def test_each_cell_reports_enough_and_each_layer_metric_moves_one():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    cells = [w["name"] for w in MAN["workloads"]]
    for cell in cells:
        mine = {m["name"] for m in harness.metrics_of(MAN, "end_to_end", cell)}
        assert "setup_s" in mine and len(mine) >= 2, cell
        assert harness.metrics_of(MAN, "per_layer", cell), cell
    layers = {}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        reported_by = set(e2e[m["moves"]].get("workloads", cells))
        assert set(m.get("workloads", cells)) <= reported_by, m["name"]
        layers.setdefault(m["layer"].split(" ")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


def test_run_seconds_fit_the_check_with_24_cells():
    rs = MAN["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert sum(w["chips"] == 4 for w in MAN["workloads"]) <= max(1, len(MAN["workloads"]) // 4)
    json.dumps(MAN)
