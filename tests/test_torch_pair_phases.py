"""pair_phases.py and chip_smoke.py's flat pair grids on the CPU: the cut
builds' and the variants' source edits apply, each once, to
csrc/flat_pairwise.cu as it is; every design is told apart by its first
cut; the script refuses to run without a card; ``_pair_grid`` hands back
the grid the flat step gives its pair pass.  Imports neither JAX nor the
reference package."""

import os
import pathlib
import subprocess
import sys

import pytest
import torch

import chip_smoke
import pair_phases
from pedoni_tpu_torch.field import Field, FieldMaps
from pedoni_tpu_torch.models import sfm
from pedoni_tpu_torch.ops import forcepass
from pedoni_tpu_torch.scenario import load_scenario

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCE = ROOT / pair_phases.KERNEL


def _variants():
    _cuts, variants = pair_phases.DESIGNS[pair_phases._design(SOURCE.read_text())]
    return [None, *variants]


@pytest.mark.parametrize("variant", _variants(),
                         ids=lambda v: "as it is" if v is None else v)
def test_cuts_apply_to_the_kernel(variant):
    """The kernel is a design the script knows; its cuts, then the
    variant's edits, each replace their text exactly once, and every cut
    leaves the source's PEDONI_PHASE branches balanced."""
    src = SOURCE.read_text()
    cuts, _variants = pair_phases.DESIGNS[pair_phases._design(src)]
    out = pair_phases.cut_source(src, variant)
    assert out.count("PEDONI_PHASE") >= len(cuts)
    assert out.count("#if PEDONI_PHASE") == out.count("#endif") - src.count("#endif")
    assert out != src
    if variant is not None:
        assert out != pair_phases.cut_source(src)


def test_designs_are_told_apart():
    """No design's first cut appears in another design's cuts, so a
    source is recognised as one design alone."""
    firsts = {name: cuts[0][0] for name, (cuts, _v) in pair_phases.DESIGNS.items()}
    for name, (cuts, _v) in pair_phases.DESIGNS.items():
        for other, first in firsts.items():
            if other != name:
                assert all(first not in old for old, _new in cuts), (name, other)


def test_refuses_to_run_without_a_card():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run([sys.executable, str(ROOT / "pair_phases.py")], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 2 and "no CUDA device" in r.stderr, r.stderr[-2000:]
    assert r.stdout == ""


def test_pair_grid_is_the_steps_pair_grid():
    """chip_smoke._pair_grid hands back a copy of the padded grid that one
    flat step passes to its pair pass: gap.toml's agents, binned as the
    step bins them, and the twin's forces on it those of the step."""
    sc = load_scenario(ROOT / "scenarios" / "gap.toml")
    maps = FieldMaps.from_field(Field.from_scenario(sc, unit=0.25))
    cfg = sfm.StepConfig.build(sc, capacity=256, table_capacity=8)
    gen = torch.Generator().manual_seed(3)
    st = sfm.make_initial_state(cfg, gen, "cpu")
    field, obstacles = sfm.device_inputs(cfg, maps, "cpu")
    step = sfm.make_step(cfg, generator=torch.Generator().manual_seed(4))
    for _ in range(20):
        st, _m = step(st, field.rows, obstacles)
    d = chip_smoke._pair_grid(step, st, field.rows, obstacles)
    grid = cfg.grid
    assert tuple(d.shape) == (grid.ny + 2, grid.nx + 2, 8, 8)
    assert int((d[..., 6] > 0.5).sum()) == int(st.agents.active.sum()) > 0
    got = forcepass.dense_pairwise_torch(d, grid, 8, cfg.physics)
    assert float(got.abs().max()) > 0
    assert forcepass.dense_pairwise.__name__ == "dense_pairwise"
