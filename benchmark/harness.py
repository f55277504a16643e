"""The benchmark's harness: finds a cell's files by name, runs its driver on
the program, judges the program's steps against the plain reference and
prints the result line.

Everything a cell is sits in files found by the names in BENCHMARK.json:

- ``configs/<config>.json``: the configuration (its sizes, source and the
  generator in ``traffic/`` that makes its problem from a seed);
- ``traffic/<traffic>.json``: the mix (the driver in ``drivers/``, the
  program path in ``paths/``, the path's domain and cell unit, lengths and
  counts);
- ``cells/<cell>.json``: the limits of the numbers compared;
- ``metrics/<metric>.py``: the reader of each per-layer metric, or
  ``metrics/<stem>.py`` for a metric ``<stem>.<part>`` whose parts are one
  quantity read alike in cells that report different end-to-end metrics.

Nothing here imports ``jax`` or the JAX package; the program is reached
only through ``paths/``.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

from .reference import compare
from .reference import field as ref_field
from .reference import step as ref_step
from .work import step_work

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pedoni_tpu")


def load(path: Path, name: str) -> types.ModuleType:
    """The module in ``path`` (a file name may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    return json.loads(path.read_text())


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def reader(root: Path, name: str) -> Path:
    """The file of the per-layer metric ``name``'s reader."""
    own = root / "metrics" / f"{name}.py"
    return own if own.is_file() else root / "metrics" / f"{name.split('.')[0]}.py"


def metrics_of(manifest: dict, kind: str, cell: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that ``cell`` reports."""
    return [m for m in manifest[kind]
            if "workloads" not in m or cell in m["workloads"]]


def card_state() -> str:
    """The card's name, power limit and draw, SM clock and temperature as
    nvidia-smi reads them, or why not."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,clocks.sm,"
             "temperature.gpu", "--format=csv,noheader"], capture_output=True,
            text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


class Window:
    def __init__(self) -> None:
        self.t0 = self.t1 = 0.0
        self.cpu_s = 0.0  # the process's CPU time in the window

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class Context:
    """What a driver is given: the cell's files, the device, the clock,
    spans and the record of the steps to check."""

    def __init__(self, cell: str, entry: dict, config: dict, traffic: dict,
                 seed: int, seconds: float, tracing: bool, device: torch.device,
                 t_start: float, root: Path) -> None:
        self.cell, self.entry, self.config, self.traffic = cell, entry, config, traffic
        self.seed, self.seconds, self.tracing = seed, seconds, tracing
        self.device, self.t_start, self.log = device, t_start, sys.stderr
        gen = load(root / "traffic" / f"{config['generator']}.py",
                   f"bench_gen_{config['generator']}")
        self.path = importlib.import_module(f"{__package__}.paths.{traffic['path']}")
        self.problem = gen.generate(config, traffic, seed)
        self.problem["outside"] = self.path.DESPAWN_OUTSIDE
        self.setup_s = None
        self.win = None
        self.prof = None
        self.counts = ({}, {})

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def span(self, name: str):
        return (torch.profiler.record_function(name) if self.tracing
                else contextlib.nullcontext())

    @contextlib.contextmanager
    def window(self):
        """The measured window; set-up ends where it starts."""
        from pedoni_tpu_torch.ops.kernels import launch_counts
        w = Window()
        if self.tracing:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
            before = launch_counts()
        self.sync()
        w.t0 = time.perf_counter()
        self.setup_s = w.t0 - self.t_start
        cpu0 = time.process_time()
        with self.span("window"):
            yield w
        w.t1 = time.perf_counter()
        w.cpu_s = time.process_time() - cpu0
        self.win = w
        if self.tracing:
            self.prof.__exit__(None, None, None)
            self.counts = (before, launch_counts())

    def memory_peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def check(self, label: str, inp: dict, out: dict, metrics: dict | None,
              judging, copy: bool = False) -> dict:
        """A step to judge once the program is gone: its input and output
        agents on the host, its metrics and how its cells hold agents."""
        return {"label": label, "inp": inp, "out": out, "metrics": metrics,
                "k_cap": getattr(judging, "k_cap", None),
                "k_cells": getattr(judging, "k_cells", None), "copy": copy}

    def work(self, rows: dict) -> dict:
        return step_work.count(rows, self.problem["geometry"],
                               self.problem["cell_unit"], str(self.device))


def _identity(agents: dict) -> dict:
    """A step that changes nothing: the reference of a copy (binning)."""
    n = len(agents["speed"])
    return {"pos": np.asarray(agents["pos"], np.float64),
            "vel": np.asarray(agents["vel"], np.float64),
            "alive": np.ones(n, bool), "unsure": np.zeros(n, bool),
            "allow": np.zeros(n), "scale": np.full(n, np.inf)}


def judge(checks: list[dict], problem: dict, device: str,
          dtype: torch.dtype = torch.float64) -> tuple[dict, list]:
    """The compared numbers over ``checks``, each the largest of its
    checks, and each check's own numbers and notes."""
    field = ref_field.fields(problem["geometry"])
    geo = problem["geometry"]
    worst: dict[str, float] = {}
    notes = []
    for c in checks:
        def reference(agents, c=c):
            return ref_step.step(field, agents, geo["size"], geo["unit"],
                                 problem["cell_unit"], c["k_cap"], dtype, device,
                                 problem["outside"])
        r = compare.judge(field, c["inp"], c["out"], c["metrics"], problem,
                          c["k_cap"], c["k_cells"],
                          _identity if c["copy"] else reference)
        notes.append((c["label"], r))
        for k, v in r["numbers"].items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst, notes


def run_cell(argv_ns, root: Path = ROOT, manifest: dict | None = None,
             device: torch.device | None = None, t_start: float | None = None
             ) -> tuple[int, dict | None]:
    """Run one cell; (exit code, result) with the result None where the
    run must print none."""
    t_start = time.perf_counter() if t_start is None else t_start
    if manifest is None:
        manifest = read_json(REPO / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if argv_ns.workload not in cells:
        print(f"unknown workload {argv_ns.workload!r}", file=sys.stderr)
        return 2, None
    entry = cells[argv_ns.workload]
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
            print(f"this cell needs {entry['chips']} CUDA device(s): "
                  f"available={torch.cuda.is_available()}, "
                  f"count={torch.cuda.device_count()}", file=sys.stderr)
            return 3, None
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    config = read_json(root / "configs" / f"{entry['config']}.json")
    traffic = read_json(root / "traffic" / f"{entry['traffic']}.json")
    limits = read_json(root / "cells" / f"{entry['name']}.json")["limits"]
    tracing = bool(argv_ns.trace)
    ctx = Context(entry["name"], entry, config, traffic, argv_ns.seed,
                  float(argv_ns.seconds), tracing, device, t_start, root)
    driver = load(root / "drivers" / f"{traffic['driver']}.py",
                  f"bench_driver_{traffic['driver']}")
    res = driver.run(ctx)
    if device.type == "cuda":
        print(f"# card after the window: {card_state()}", file=sys.stderr)
    print(f"# host: the process's CPU time {ctx.win.cpu_s / ctx.win.seconds:.3f} "
          f"of the window's {ctx.win.seconds:.4f} s; load average "
          f"{os.getloadavg()} on {os.cpu_count()} cores", file=sys.stderr)

    metrics: dict[str, dict] = {}
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
                "count": 1, "memory_peak_bytes": res["memory_peak_bytes"]}
    breakdown = None
    if tracing:
        from . import trace
        summary = trace.reduce(ctx.prof, *ctx.counts)
        ctx.prof = None
        ok = trace.launches_agree(summary["launch_check"])
        if not ok:
            print(f"# launch records differ from the program's counters "
                  f"(traced, counted): {summary['launch_check']}; the launch "
                  "metrics of this run are left out", file=sys.stderr)
        summary.update(units=res["attempted"], launches_ok=ok)
        if res.get("work"):
            bounds = [step_work.bound_seconds(w)[0] for w in res["work"]]
            summary["bound_s"] = float(np.mean(bounds))
            print(f"# needed work a step: {res['work']}, bound "
                  f"{summary['bound_s'] * 1e3:.6f} ms "
                  f"({step_work.bound_seconds(res['work'][0])[1]}) on "
                  f"{step_work.PEAKS['card']}", file=sys.stderr)
        for m in metrics_of(manifest, "per_layer", entry["name"]):
            v = load(reader(root, m["name"]),
                     f"bench_metric_{m['name']}").read(summary)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev_info["busy_s"] = summary["busy_s"]
        dev_info["window_s"] = summary["window_s"]
        breakdown = trace.breakdown(summary)
    else:
        values = dict(res["e2e"], setup_s=ctx.setup_s)
        for m in metrics_of(manifest, "end_to_end", entry["name"]):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    checks = res.pop("checks")
    attempted = res["attempted"]
    problem = ctx.problem
    del res, ctx, driver
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers, notes = judge(checks, problem, str(device))
    del checks
    for label, r in notes:
        print(f"# check {label}: {json.dumps(r)}", file=sys.stderr)
    correct = set(numbers) <= set(limits) and all(
        numbers[k] <= limits[k] for k in numbers)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 4, None
    failed = sum(1 for _, r in notes if any(
        v > limits.get(k, -1.0) for k, v in r["numbers"].items()))
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": numbers[k], "limit": limits.get(k)}
                        for k in sorted(numbers)}
    for k in sorted(numbers):
        print(f"{k} {numbers[k]!r} limit {limits.get(k)!r}", file=sys.stderr)
    return 0, result
