"""The result line: its keys in order, the device, the metrics of the cell
and the compared numbers last; and no line at all without a card or
without the program."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests import tiny


@pytest.mark.parametrize("cell", list(tiny.CELLS))
def test_a_cpu_run_is_correct_and_shaped(tiny_root, cell):
    root, man = tiny_root
    code, res = tiny.run(root, man, cell)
    assert code == 0
    line = json.loads(json.dumps(res))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    want = {m["name"]: m["unit"] for m in harness.metrics_of(man, "end_to_end", cell)}
    assert {k: v["unit"] for k, v in line["metrics"].items()} == want
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert set(line["checks"]) == set(harness.read_json(root / "cells" / f"{cell}.json")["limits"])
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def test_a_traced_run_gives_per_layer_metrics_and_a_breakdown(tiny_root):
    root, man = tiny_root
    code, res = tiny.run(root, man, "b.flat", trace=1)
    assert code == 0 and res["correct"]
    assert list(res)[-1] == "checks" and "breakdown" in res
    assert {"busy_s", "window_s"} <= set(res["device"])
    names = {m["name"] for m in harness.metrics_of(man, "per_layer", "b.flat")}
    assert set(res["metrics"]) <= names  # the CPU traces no device work
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_no_card_no_line():
    p = subprocess.run([sys.executable, str(harness.ROOT / "run.py"), "--workload",
                        "open1M.grid", "--seed", "3000000000", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_no_program_no_line(tmp_path):
    (tmp_path / "benchmark").mkdir()
    shutil.copytree(harness.ROOT, tmp_path / "benchmark", dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(harness.REPO / "BENCHMARK.json", tmp_path)
    code = ("import argparse, sys, torch\n"
            "from benchmark import harness\n"
            "ns = argparse.Namespace(workload='random.tick', seed=1, seconds=1, trace=0)\n"
            "print(harness.run_cell(ns, device=torch.device('cpu')))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300, env={"PATH": "/usr/bin:/bin"})
    assert p.returncode != 0 and p.stdout == ""
    assert "pedoni_tpu_torch" in p.stderr
