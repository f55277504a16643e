"""pair_phases.py and chip_smoke.py's flat pair grids on the CPU: the cut
builds' and the variants' source edits apply, each once, to
csrc/flat_pairwise.cu and to csrc/step_kernel.cu as they are (the step
kernel's common edits too: its pair pass launched alone, its shared memory
its own); every design is told apart by its first cut; the script refuses
to run without a card; ``_pair_grid`` hands back the grid the flat step
gives its pair pass.  Imports neither JAX nor the reference package."""

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


def _source(kernel: str) -> str:
    return (ROOT / pair_phases.KERNELS[kernel].path).read_text()


def _cases():
    """(kernel, variant) of each kernel's design as it is; the flat
    kernel's cases keep their ids, the step kernel's are prefixed."""
    out = []
    for kernel, spec in pair_phases.KERNELS.items():
        _cuts, variants = spec.designs[pair_phases._design(_source(kernel), kernel)]
        out += [(kernel, v) for v in (None, *variants)]
    return out


def _id(case):
    kernel, variant = case
    name = "as it is" if variant is None else variant
    return name if kernel == "flat_pairwise" else f"{kernel}: {name}"


@pytest.mark.parametrize("case", _cases(), ids=_id)
def test_cuts_apply_to_the_kernel(case):
    """The kernel is a design the script knows; its common edits, its
    cuts, then the variant's edits, each replace their text exactly once,
    and every cut leaves the source's PEDONI_PHASE branches balanced."""
    kernel, variant = case
    src = _source(kernel)
    spec = pair_phases.KERNELS[kernel]
    cuts, _variants = spec.designs[pair_phases._design(src, kernel)]
    out = pair_phases.cut_source(src, variant, kernel)
    assert out.count("PEDONI_PHASE") >= len(cuts)
    assert out.count("#if PEDONI_PHASE") == out.count("#endif") - src.count("#endif")
    assert out != src
    for _old, new in spec.common:
        assert out.count(new) == 1
    if variant is not None:
        assert out != pair_phases.cut_source(src, None, kernel)


def test_designs_are_told_apart():
    """No design's first cut appears in another design's cuts of the same
    kernel, so a source is recognised as one design alone."""
    for kernel, spec in pair_phases.KERNELS.items():
        firsts = {name: cuts[0][0] for name, (cuts, _v) in spec.designs.items()}
        for name, (cuts, _v) in spec.designs.items():
            for other, first in firsts.items():
                if other != name:
                    assert all(first not in old for old, _new in cuts), (
                        kernel, name, other)


def test_step_cuts_key_the_pair_pass():
    """The step kernel's cuts: phase 1 skips step 3's loop over the listed
    agents, phase 2 keeps the walk's hits live and runs no force body; the
    common edits add the switch that skips the sample pass and the
    shared-memory size a build works out for itself, at the arguments'
    places pair_phases.py writes them."""
    out = pair_phases.cut_source(_source("step_pairs"), None, "step_pairs")
    assert "base < (PEDONI_PHASE == 1 ? 0 : n_live)" in out
    assert "#if PEDONI_PHASE == 2" in out and "hits = 0;" in out
    assert 'extern "C" int pedoni_pairs_only = 0;' in out
    assert "if (pedoni_pairs_only) {" in out
    assert "if (smem_bytes < 0) smem_bytes = (int)pairs_smem_bytes(tile_rows, k);" in out
    argtypes = pair_phases.KERNELS["step_pairs"].argtypes
    assert len(argtypes) == 29
    assert argtypes[pair_phases.TILE_ROWS_ARG] is argtypes[pair_phases.SMEM_ARG]


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
