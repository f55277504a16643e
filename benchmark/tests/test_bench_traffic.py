"""The benchmark's generators against the program's and the repository's
own: the open field bit for bit as ``pedoni_tpu_torch.bench`` draws it,
random.toml as ``scenarios/generate.py`` printed it."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import harness
from benchmark.traffic import open_field, random_field


def _traffic(name: str) -> dict:
    return harness.read_json(harness.ROOT / "traffic" / f"{name}.json")


@pytest.mark.parametrize("path,backend,waypoints", [
    ("grid", "grid", 1), ("flat", "xla", 1), ("grid", "grid", 8)])
def test_open_field_is_the_bench_problem(path, backend, waypoints):
    from pedoni_tpu_torch.bench import build_problem
    cfg = harness.read_json(harness.ROOT / "configs" / "open_field_1M.json")
    cfg.update(agents=5000, waypoints=waypoints)
    seed = 2**31 + 977
    mine = open_field.generate(cfg, _traffic(f"segments.{path}"), seed)
    sc, _maps, scfg, st = build_problem(5000, 2.5, seed, 14, "cpu", waypoints,
                                        "auto", backend)
    assert tuple(mine["geometry"]["size"]) == sc.size
    assert mine["cell_unit"] == scfg.grid.unit
    assert mine["capacity"] == scfg.capacity
    for got, seg in zip(mine["geometry"]["waypoints"] + mine["geometry"]["obstacles"],
                        sc.waypoints + sc.obstacles):
        assert (tuple(got[0]), tuple(got[1]), got[2]) == (seg.line[0], seg.line[1], seg.width)
    a = st.agents
    for k in ("pos", "vel", "speed", "dest", "active"):
        assert np.array_equal(mine["agents"][k], getattr(a, k).numpy()), k


def test_random_field_is_random_toml():
    cfg = harness.read_json(harness.ROOT / "configs" / "random_200m.json")
    text = random_field.toml_text(**cfg["scenario"])
    assert text == (harness.REPO / "scenarios" / "random.toml").read_text()
    prob = random_field.generate(cfg, _traffic("tick_segments.grid"), 1)
    assert len(prob["geometry"]["obstacles"]) == 1000
    assert [g["frequency"] for g in prob["groups"]] == [20.0] * 4
    assert prob["cell_unit"] == 1.5
    assert random_field.generate(cfg, _traffic("tick_segments.flat"), 1)["cell_unit"] == 1.4


def test_reference_field_equals_the_programs():
    """The reference's own rasterisation and fast marching give the
    program's maps bit for bit (the same field.rs semantics, no shared
    code)."""
    from pedoni_tpu_torch.field import Field
    from benchmark.paths import common
    from benchmark.reference import field as ref_field
    cfg = harness.read_json(harness.ROOT / "configs" / "random_200m.json")
    cfg["scenario"].update(size=40, obstacles=30)
    prob = random_field.generate(cfg, _traffic("tick_segments.grid"), 1)
    from pedoni_tpu_torch.scenario import loads_scenario
    prog = Field.from_scenario(loads_scenario(prob["toml"]), 0.25)
    ref = ref_field.solve(prob["geometry"])
    assert np.array_equal(ref["dist"], prog.distance_map)
    assert np.array_equal(ref["pot"], prog.potential_maps)
    cfg = harness.read_json(harness.ROOT / "configs" / "open_field_1M.json")
    cfg.update(agents=4000)
    prob = open_field.generate(cfg, _traffic("segments.flat"), 3)
    prog = Field.from_scenario(common.scenario(prob), 0.25)
    ref = ref_field.solve(prob["geometry"])
    assert np.array_equal(ref["dist"], prog.distance_map)
    assert np.array_equal(ref["pot"], prog.potential_maps)
