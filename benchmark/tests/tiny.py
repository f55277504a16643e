"""Test-sized copies of the benchmark's cells, run on the CPU through the
program's PyTorch twins: a root with the benchmark's files and four small
cells (bulk and tick, grid and flat), and a manifest naming them."""

from __future__ import annotations

import argparse
import json
import shutil
from pathlib import Path

import torch

from benchmark import harness

SRC = harness.ROOT
CELLS = {"b.grid": ("tiny", "tinyb.grid"), "b.flat": ("tiny", "tinyb.flat"),
         "t.flat": ("tinyr", "tinyt.flat"), "t.grid": ("tinyr", "tinyt.grid")}


def build(root: Path, agents: int = 3000) -> dict:
    """Lay out a benchmark root at ``root``; returns its manifest."""
    shutil.copytree(SRC, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = harness.read_json(SRC / "configs" / "open_field_1M.json")
    cfg.update(name="tiny", agents=agents)
    (root / "configs" / "tiny.json").write_text(json.dumps(cfg))
    rcfg = harness.read_json(SRC / "configs" / "random_200m.json")
    rcfg["scenario"].update(size=60, obstacles=40, freq=2)
    (root / "configs" / "tinyr.json").write_text(json.dumps(rcfg))
    for p in ("grid", "flat"):
        t = harness.read_json(SRC / "traffic" / f"tick_segments.{p}.json")
        t.update(fill_ticks=150, fill_batch=50, segment_ticks=10, trace_ticks=20)
        (root / "traffic" / f"tinyt.{p}.json").write_text(json.dumps(t))
        t = harness.read_json(SRC / "traffic" / f"segments.{p}.json")
        t.update(warmup_steps=4, segment_steps=8, fence_every=4, trace_steps=16)
        (root / "traffic" / f"tinyb.{p}.json").write_text(json.dumps(t))
    man = harness.read_json(harness.REPO / "BENCHMARK.json")
    man["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1,
                         "why": "test"} for n, (c, t) in CELLS.items()]
    for m in man["end_to_end"] + man["per_layer"]:
        if "workloads" in m:
            bulk = m["name"] == "agent_steps_per_s" or m.get("moves") == "agent_steps_per_s"
            m["workloads"] = [n for n in CELLS if n.startswith("b.") == bulk]
    for n in CELLS:  # each held to the limits of its full-size cells
        like = "open1M.grid" if n.startswith("b.") else "random.tick"
        shutil.copy(SRC / "cells" / f"{like}.json", root / "cells" / f"{n}.json")
    return man


def run(root: Path, man: dict, cell: str, seconds: float = 0.5, trace: int = 0,
        seed: int = 2**31 + 12345, device: str = "cpu"):
    ns = argparse.Namespace(workload=cell, seed=seed, seconds=seconds, trace=trace)
    return harness.run_cell(ns, root=root, manifest=man, device=torch.device(device))
