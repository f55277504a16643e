"""The funnel cell's own files: its generator against the port's loader of
the shipped file, and the reader of ``step_pairs_ms.tick`` on a summary
that holds the pair pass under two kernel names."""

from __future__ import annotations

import pytest

from benchmark import harness
from benchmark.traffic import scenario_file

MAN = harness.read_json(harness.REPO / "BENCHMARK.json")


def test_scenario_file_is_the_shipped_funnel():
    from pedoni_tpu_torch.scenario import loads_scenario
    cfg = harness.read_json(harness.ROOT / "configs" / "funnel_180m.json")
    traffic = harness.read_json(harness.ROOT / "traffic" / "tick_segments.grid.json")
    prob = scenario_file.generate(cfg, traffic, 2**31 + 977)
    sc = loads_scenario(prob["toml"])
    assert prob["toml"] == (harness.REPO / "scenarios" / "funnel.toml").read_text()
    assert tuple(prob["geometry"]["size"]) == sc.size
    for got, seg in zip(prob["geometry"]["waypoints"] + prob["geometry"]["obstacles"],
                        sc.waypoints + sc.obstacles):
        assert (tuple(got[0]), tuple(got[1]), got[2]) == (seg.line[0], seg.line[1], seg.width)
    assert [g["frequency"] for g in prob["groups"]] == [80.0, 80.0]
    assert prob["cell_unit"] == 1.5 and prob["table_capacity"] == 16
    with pytest.raises(ValueError, match="SHA-256"):
        scenario_file.generate(dict(cfg, sha256="0" * 64), traffic, 1)


def _read(summary: dict):
    return harness.load(harness.reader(harness.ROOT, "step_pairs_ms.tick"),
                        "bench_metric_step_pairs_ms").read(summary)


def test_step_pairs_ms_sums_every_variant_over_the_ticks():
    by_kernel = {"step_pairs": [0.030, 100], "step_pairs_chunked": [0.010, 100],
                 "step_sample": [0.5, 100], "flat_pairwise_tile": [9.0, 100]}
    assert _read({"units": 100, "by_kernel": by_kernel}) == pytest.approx(0.4)
    assert _read({"units": 0, "by_kernel": by_kernel}) is None
    assert _read({"units": 100, "by_kernel": {"step_sample": [0.5, 100]}}) is None
    cells = {m["name"]: m for m in MAN["per_layer"]}["step_pairs_ms.tick"]["workloads"]
    assert cells == ["random.tick_grid", "funnel.tick_grid"]
