"""Every shipped scenario (scenarios/*.toml) on the port's three backends,
the analog of tests/test_reference_scenarios.py over the files this
repository holds, on the CPU:

- each file through ``Simulator`` on ``xla``, ``grid`` and ``pallas`` for
  TICKS ticks: positions finite and inside the field, every ``dest`` a
  waypoint of the file, the population the ticks report equal to the
  agents listed, and some agent still active where the file has a once
  group;
- ``-m slow``: room-evac.toml (three once groups of 60 agents, five
  exits) over 600 ticks at seeds 1-3 on each backend, against the
  reference's flat step on CPU JAX at the same seeds.  The random streams
  differ, so the populations at ticks 200, 300 and 400 are compared as
  means over the seeds, within ROOM_EVAC_BAND; the population at tick 600
  must be small, not 0: at seed 3 one agent is still there in both
  packages;
- ``scripts/analyze_log.py::analyze`` reads the log that the port's CLI
  writes for gap.toml (``-b cpu``: the flat step on the CPU).
"""

import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

from pedoni_tpu import Simulator as RefSimulator
from pedoni_tpu import SimulatorOptions as RefOptions
from pedoni_tpu import load_scenario as ref_load_scenario
from pedoni_tpu_torch import Simulator, SimulatorOptions, cli, load_scenario

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCENARIOS = sorted((ROOT / "scenarios").glob("*.toml"))
BACKENDS = ("xla", "grid", "pallas")
TICKS = 5  # funnel.toml's flat step takes ~1 s a tick on the CPU
ROOM_EVAC = ROOT / "scenarios" / "room-evac.toml"
ROOM_EVAC_SEEDS = (1, 2, 3)
ROOM_EVAC_MARKS = (200, 300, 400)
# The reference's seed-to-seed standard deviation of room-evac's
# population at these ticks is 4-5 agents (seeds 1-8, CPU JAX), so the
# difference of two means over three seeds has a standard deviation of
# ~4.5 sqrt(2/3) = 3.7 agents: the band is four of them.
ROOM_EVAC_BAND = 15
ROOM_EVAC_LEFT = 9  # agents at tick 600: 5% of the 180


def test_every_shipped_scenario_is_swept():
    assert len(SCENARIOS) == 8
    assert {p.stem for p in SCENARIOS} >= {"default", "funnel", "room-evac",
                                           "wide-lanes", "zigzag"}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("path", SCENARIOS, ids=lambda p: p.stem)
def test_scenario_runs_in_bounds(path, backend):
    sc = load_scenario(path)
    sim = Simulator(SimulatorOptions(backend=backend, device="cpu", seed=1), sc)
    for _ in range(TICKS):
        rec = sim.tick()
    pos, dest = sim.list_pedestrians()
    w, h = sc.size
    assert pos.shape == (rec.active_ped_count, 2) and np.isfinite(pos).all()
    assert ((pos >= 0.0) & (pos <= np.array([w, h], np.float32))).all(), (
        f"{path.name} on {backend}: an agent outside the {w} x {h} field")
    assert ((dest >= 0) & (dest < len(sc.waypoints))).all()
    if sc.once_groups:
        assert rec.active_ped_count > 0


def _populations(make_sim, seed: int) -> dict[int, int]:
    sim = make_sim(seed)
    out = {}
    for i in range(1, 601):
        n = sim.tick().active_ped_count
        if i in (*ROOM_EVAC_MARKS, 600):
            out[i] = n
    return out


@pytest.fixture(scope="module")
def reference_room_evac():
    sc = ref_load_scenario(ROOM_EVAC)
    return [_populations(lambda s: RefSimulator(RefOptions(seed=s), sc), seed)
            for seed in ROOM_EVAC_SEEDS]


@pytest.mark.slow
@pytest.mark.parametrize("backend", BACKENDS)
def test_room_evac_tracks_the_reference(backend, reference_room_evac):
    sc = load_scenario(ROOM_EVAC)
    port = [_populations(lambda s: Simulator(SimulatorOptions(
        backend=backend, device="cpu", seed=s), sc), seed)
        for seed in ROOM_EVAC_SEEDS]
    for tick in ROOM_EVAC_MARKS:
        p = np.mean([r[tick] for r in port])
        r = np.mean([r[tick] for r in reference_room_evac])
        assert abs(p - r) <= ROOM_EVAC_BAND, (
            f"{backend} tick {tick}: {[x[tick] for x in port]} against the "
            f"reference's {[x[tick] for x in reference_room_evac]}")
    assert all(x[600] <= ROOM_EVAC_LEFT for x in port), port


def _analyze_log():
    spec = importlib.util.spec_from_file_location(
        "analyze_log", ROOT / "scripts" / "analyze_log.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.analyze


def test_analyze_log_reads_a_cli_log(tmp_path):
    assert cli.main([str(ROOT / "scenarios" / "gap.toml"), "-H", "-b", "cpu",
                     "-s", "0", "--seed", "1", "--max-steps", "300",
                     "--log-dir", str(tmp_path)]) == 0
    (log,) = tmp_path.glob("*_log.json")
    out = _analyze_log()(str(log))
    counts = json.loads(log.read_text())["step_metrics"]["active_ped_count"]
    assert out["model"] == "sfm-torch/xla"
    assert out["total_steps"] == 300 == len(counts)
    assert out["peak_agents"] == 64 and out["final_agents"] == 0
    # the first step after the peak at which nobody is left
    assert out["evacuation_step"] == counts.index(0) + 1
    assert 160 <= out["evacuation_step"] <= 340
