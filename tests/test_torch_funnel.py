"""The bidirectional bottleneck (scenarios/funnel.toml) as the benchmark's
``funnel.tick_grid`` cell runs it, on the CPU:

- the benchmark's generator (``benchmark/traffic/scenario_file.py``) gives
  the file's geometry and groups as the port's loader reads them, and
  refuses a file whose SHA-256 is not the configuration's;
- a crowd packed at the pinch of the trimmed funnel (``fidelity.FUNNEL``,
  30 x 20 m) through the grid Simulator: the first tick grows the table K
  from 16, a denser crowd is then loaded at the grown K (a checkpoint
  restored, as the cell restores its segment), and every tick is judged
  against the benchmark's float64 reference (``benchmark/reference``)
  under the cell's own limits, with no agent lost or extra;
- a step that leaves out the pair forces of the slots past the old K fails
  that check;
- ``Simulator.growths`` counts the growths the Simulator logs, with
  tracing on and off, and each opens its kind's span inside ``sim.grow``.
"""

from __future__ import annotations

import hashlib
import logging

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.paths import common, grid
from benchmark.reference import compare
from benchmark.reference import field as ref_field
from benchmark.reference import step as ref_step
from benchmark.traffic import scenario_file
from pedoni_tpu_torch import fidelity
from pedoni_tpu_torch.convert import agents_from_numpy
from pedoni_tpu_torch.models import sfm_grid
from pedoni_tpu_torch.models.sfm import SimState
from pedoni_tpu_torch.scenario import loads_scenario
from pedoni_tpu_torch.sim import Simulator, SimulatorOptions
from pedoni_tpu_torch.utils import trace

torch.set_num_threads(1)

CONFIG = harness.read_json(harness.ROOT / "configs" / "funnel_180m.json")
TRAFFIC = harness.read_json(harness.ROOT / "traffic" / "tick_segments.grid.json")
LIMITS = harness.read_json(harness.ROOT / "cells" / "funnel.tick_grid.json")["limits"]
UNIT = 1.5
K0 = 16
# cells (cx, cy) of the trimmed funnel's mouth, clear of its walls, in front
# of the ~3 m pinch at x = 16
MOUTH = [(cx, cy) for cx in (7, 8, 9) for cy in (5, 6, 7)]
TICKS_AFTER = 4  # ticks judged after the denser crowd is loaded


def _seg(s) -> list:
    return [list(s.line[0]), list(s.line[1]), s.width]


def test_scenario_file_gives_the_files_geometry_and_groups():
    prob = scenario_file.generate(CONFIG, TRAFFIC, 2**31 + 5)
    path = harness.REPO / CONFIG["scenario_file"]
    sc = loads_scenario(path.read_text())
    assert prob["toml"] == path.read_text()
    assert tuple(prob["geometry"]["size"]) == sc.size == (180.0, 180.0)
    assert prob["geometry"]["waypoints"] == [_seg(s) for s in sc.waypoints]
    assert prob["geometry"]["obstacles"] == [_seg(s) for s in sc.obstacles]
    assert [(g["origin"], g["destination"], g["frequency"]) for g in prob["groups"]] \
        == [(g.origin, g.destination, g.spawn.frequency) for g in sc.pedestrians] \
        == [(0, 1, 80.0), (1, 0, 80.0)]
    assert prob["geometry"]["unit"] == 0.25 and prob["cell_unit"] == UNIT
    assert prob["table_capacity"] == K0


@pytest.mark.parametrize("change", ["file", "hash"])
def test_scenario_file_refuses_another_hash(tmp_path, change):
    text = (harness.REPO / CONFIG["scenario_file"]).read_text()
    path = tmp_path / "funnel.toml"
    path.write_text(text + ("\n# edited\n" if change == "file" else ""))
    cfg = dict(CONFIG, scenario_file=str(path))  # an absolute path wins
    if change == "hash":
        cfg["sha256"] = hashlib.sha256(b"another file").hexdigest()
    else:
        assert scenario_file.read(dict(cfg, sha256=hashlib.sha256(
            path.read_bytes()).hexdigest())) == path.read_text()
    with pytest.raises(ValueError, match="SHA-256"):
        scenario_file.generate(cfg, TRAFFIC, 1)


def _crowd(seed: int, per_cell: int, loose: int) -> SimState:
    """``per_cell`` agents in each cell of MOUTH and ``loose`` more spread
    over the funnel's open mouth, all bound for the far exit, at rest,
    with unique desired speeds (they name the agents in the check)."""
    rng = np.random.default_rng(seed)
    pos = [np.stack([(cx + rng.uniform(0.03, 0.97, per_cell)) * UNIT,
                     (cy + rng.uniform(0.03, 0.97, per_cell)) * UNIT], 1)
           for cx, cy in MOUTH]
    pos.append(np.stack([rng.uniform(3.0, 8.5, loose),
                         rng.uniform(5.0, 15.0, loose)], 1))
    pos = np.concatenate(pos)
    n = len(pos)
    return SimState(agents_from_numpy(
        pos, np.zeros((n, 2)), 1.0 + 0.001 * np.arange(n), np.ones(n),
        np.ones(n, bool), "cpu"), 0)


@pytest.fixture(scope="module")
def problem() -> dict:
    sc = loads_scenario(fidelity.FUNNEL)
    geo = {"size": list(sc.size), "unit": 0.25,
           "waypoints": [_seg(s) for s in sc.waypoints],
           "obstacles": [_seg(s) for s in sc.obstacles]}
    return {"geometry": geo, "groups": [], "cell_unit": UNIT,
            "outside": grid.DESPAWN_OUTSIDE, "field": ref_field.solve(geo)}


def _judged_tick(sim: Simulator, prob: dict) -> dict:
    """One tick of ``sim`` and its numbers against the float64 reference,
    as ``benchmark/drivers/tick.py`` checks a tick."""
    inp = grid.rows(sim.state)
    k_cells = grid.sim_judging(sim).k_cells
    sim.tick()
    geo = prob["geometry"]

    def reference(agents):
        return ref_step.step(prob["field"], agents, geo["size"], geo["unit"],
                             UNIT, None, torch.float64, "cpu", prob["outside"])

    return compare.judge(prob["field"], inp, grid.rows(sim.state),
                         common.metrics(sim.last_metrics), prob, None, k_cells,
                         reference)["numbers"]


def _jam(prob: dict) -> tuple[Simulator, list[dict]]:
    """The trimmed funnel's grid Simulator at K 16: a crowd of 15 a cell at
    the pinch ticked once (the table grows), then a crowd of 21 a cell
    loaded at the grown K and ticked TICKS_AFTER times; every tick
    judged."""
    sim = Simulator(SimulatorOptions(backend="grid", device="cpu", seed=3,
                                     table_capacity=K0),
                    loads_scenario(fidelity.FUNNEL))
    sim.load_flat_state(_crowd(1, 15, 40))
    assert sim.pedestrian_count == 15 * len(MOUTH) + 40  # none beyond K
    numbers = [_judged_tick(sim, prob)]
    assert sim.options.table_capacity > K0
    sim.load_flat_state(_crowd(2, 21, 40))
    assert sim.pedestrian_count == 21 * len(MOUTH) + 40
    numbers += [_judged_tick(sim, prob) for _ in range(TICKS_AFTER)]
    return sim, numbers


def test_a_jam_at_the_pinch_grows_k_and_passes_the_cells_check(problem):
    sim, numbers = _jam(problem)
    assert sim.growths["table"] >= 1 and sim.last_metrics.n_active > 200
    for t, n in enumerate(numbers):
        assert set(n) == set(LIMITS)
        assert all(n[k] <= LIMITS[k] for k in n), (t, n)
        assert n["lost"] == n["extra"] == 0, (t, n)


def test_a_step_without_the_pairs_past_the_old_k_fails_the_check(problem,
                                                                 monkeypatch):
    """The fault: the step kernel reads the slots past K 16 for no other
    agent's pair forces (a bound left at the old K); every slot is still
    stepped, so only the jam's forces tell."""
    kernel = sfm_grid.fused_step

    def short_sighted(d, *args, **kw):
        out = kernel(d, *args, **kw)
        if d.shape[1] <= K0:
            return out
        cut = d.clone()
        cut[:, K0:, 6, :] = 0.0  # inactive for the pair forces alone
        out[:, :K0] = kernel(cut, *args, **kw)[:, :K0]
        return out

    monkeypatch.setattr(sfm_grid, "fused_step", short_sighted)
    _sim, numbers = _jam(problem)
    assert numbers[0]["vel_gap"] <= LIMITS["vel_gap"]  # still K 16: no fault
    assert any(n["vel_gap"] > LIMITS["vel_gap"] for n in numbers[1:]), numbers


@pytest.mark.parametrize("traced", [False, True])
def test_growths_count_what_the_simulator_logs(problem, caplog, traced):
    caplog.set_level(logging.INFO, logger="pedoni_tpu_torch.sim")
    trace.enable(traced)
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            sim, _ = _jam(problem)
    finally:
        trace.enable(False)
    logged = sum("growing table_capacity" in r.getMessage() for r in caplog.records)
    assert logged >= 1
    assert sim.growths == {"capacity": 0, "table": logged, "movers": 0}
    spans = []
    for ev in prof.events():
        if ev.name.startswith("sim.grow"):
            parent = ev.cpu_parent
            while parent is not None and parent.name not in trace.NAMES:
                parent = parent.cpu_parent
            spans.append((ev.name, parent and parent.name))
    if traced:
        assert sorted(spans) == sorted([("sim.grow", "sim.tick"),
                                        ("sim.grow.table", "sim.grow")] * logged)
    else:
        assert spans == []
