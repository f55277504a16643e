"""The program's spans (``pedoni_tpu_torch/utils/trace.py``) on the CPU:
the span tree a tick and a run open, with its parents; nothing in the
profile and one shared no-op context with tracing off; the grid step's
``full_rebins`` counter kept only while tracing; the CLI's ``--profile``
trace holding the spans."""

from __future__ import annotations

import collections
import json

import pytest
import torch

from pedoni_tpu_torch import cli
from pedoni_tpu_torch.scenario import loads_scenario
from pedoni_tpu_torch.sim import Simulator, SimulatorOptions
from pedoni_tpu_torch.utils import trace

# two spawning flows and a crowd placed at once, on a small field
SCENARIO = """
[field]
size = [24, 12]

[[waypoints]]
line = [[3, 2], [3, 10]]

[[waypoints]]
line = [[21, 2], [21, 10]]

[[obstacles]]
line = [[12, 0], [12, 4]]
width = 0.5

[[pedestrians]]
origin = 0
destination = 1
spawn = { kind = "once", count = 40 }

[[pedestrians]]
origin = 0
destination = 1
spawn = { kind = "periodic", frequency = 5 }

[[pedestrians]]
origin = 1
destination = 0
spawn = { kind = "periodic", frequency = 5 }
"""

FLAT_STEP = ["flat.spawn", "flat.sample", "flat.sort", "flat.scatter",
             "flat.pairs", "flat.integrate", "flat.metrics"]
GRID_STEP = ["grid.spawn", "grid.forces", "grid.rebin", "grid.metrics"]


@pytest.fixture
def tracing():
    """Tracing on for the test, off after it whatever happens."""
    trace.enable(True)
    try:
        yield
    finally:
        trace.enable(False)


def _sim(backend: str, **kw) -> Simulator:
    return Simulator(SimulatorOptions(backend=backend, device="cpu", seed=5,
                                      capacity=256, **kw),
                     loads_scenario(SCENARIO))


def _program_tree(prof) -> collections.Counter:
    """(span, the nearest enclosing program span or None) of every program
    span in the profile, counted."""
    out = collections.Counter()
    for ev in prof.events():
        if ev.name not in trace.NAMES:
            continue
        parent = ev.cpu_parent
        while parent is not None and parent.name not in trace.NAMES:
            parent = parent.cpu_parent
        out[(ev.name, None if parent is None else parent.name)] += 1
    return out


def _profiled(fn) -> collections.Counter:
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return _program_tree(prof)


def _tick_tree(step: str, phases: list[str]) -> collections.Counter:
    return collections.Counter(
        {("sim.tick", None): 1, (step, "sim.tick"): 1, ("sim.fetch", "sim.tick"): 1,
         **{(p, step): 1 for p in phases}})


@pytest.mark.parametrize("backend,step,phases", [
    ("xla", "flat.step", FLAT_STEP), ("grid", "grid.step", GRID_STEP)])
def test_a_tick_opens_each_span_once_under_its_parent(tracing, backend, step,
                                                      phases):
    sim = _sim(backend)
    sim.tick()  # the first tick places the crowd; growth is not this test's
    assert _profiled(sim.tick) == _tick_tree(step, phases)


@pytest.mark.parametrize("backend,step", [("xla", "flat.step"),
                                          ("grid", "grid.step")])
def test_a_run_opens_a_step_a_step_and_one_fetch(tracing, backend, step):
    sim = _sim(backend)
    tree = _profiled(lambda: sim.run(3, guard_every=0))
    assert tree[("sim.run", None)] == 1
    assert tree[(step, "sim.run")] == 3
    assert tree[("sim.fetch", "sim.run")] == 1


def test_growth_opens_its_span_inside_the_tick(tracing):
    sim = _sim("grid", table_capacity=2)
    k0 = sim.options.table_capacity
    tree = _profiled(sim.tick)
    assert sim.options.table_capacity > k0  # the crowd filled a cell to K - 1
    assert tree[("sim.grow", "sim.tick")] == 1
    assert tree[("grid.step", "sim.tick")] == 1


def test_tracing_off_leaves_the_profile_without_spans():
    assert not trace.enabled()
    assert trace.span("flat.step") is trace.span("sim.tick")
    for backend in ("xla", "grid"):
        sim = _sim(backend)
        assert not _profiled(lambda: (sim.tick(), sim.run(2)))


def test_span_names_are_unique_and_prefixed():
    assert len(set(trace.NAMES)) == len(trace.NAMES)
    for name in trace.NAMES:
        layer, _, phase = name.partition(".")
        assert layer in {"sim", "flat", "grid", "pallas", "tiles"} and phase


def test_full_rebins_counts_only_while_tracing():
    sim = _sim("grid", incremental_rebin=True, compact_every=1)
    step = sim._step
    sim.run(2)
    assert step.full_rebins is None  # tracing off: no counter, no launch
    trace.enable(True)
    try:
        sim.run(3)
    finally:
        trace.enable(False)
    assert int(step.full_rebins) == 3  # compact_every 1: every step is full
    sim.run(2)
    assert int(step.full_rebins) == 3


def test_cli_profile_trace_holds_the_spans(tmp_path):
    scen = tmp_path / "s.toml"
    scen.write_text(SCENARIO)
    trace_dir = tmp_path / "trace"
    assert cli.main([str(scen), "-H", "-b", "cpu", "-s", "0", "--max-steps", "3",
                     "--log-dir", str(tmp_path / "logs"),
                     "--profile", str(trace_dir)]) == 0
    assert not trace.enabled()  # off again after the run
    (path,) = trace_dir.glob("*_trace.json")
    names = collections.Counter(e.get("name") for e in
                                json.loads(path.read_text())["traceEvents"])
    assert names["sim.tick"] == 3 and names["flat.step"] == 3
    assert names["sim.fetch"] == 3
