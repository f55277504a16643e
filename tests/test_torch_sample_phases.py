"""sample_phases.py and chip_smoke.py's flat sample yardsticks on the
CPU: the cut-down builds' source edits apply, each once, to
csrc/flat_sample.cu as it is; the script refuses to run without a card;
the taps' footprint counts what ``_tap_rows`` counts, in sectors no fewer
than rows; ``grid_sample`` of the field's planes agrees with the twin's
obstacle channels.  Imports neither JAX nor the reference package."""

import os
import pathlib
import subprocess
import sys

import pytest
import torch

import chip_smoke
import sample_phases
from pedoni_tpu_torch.field import Field, FieldMaps
from pedoni_tpu_torch.ops.neighbor import CellGrid
from pedoni_tpu_torch.ops.sampling import DeviceField
from pedoni_tpu_torch.physics import Physics
from pedoni_tpu_torch.scenario import load_scenario
from test_torch_flat_sample_cases import edge_case_agents

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCE = ROOT / "pedoni_tpu_torch" / "ops" / "kernels" / "csrc" / "flat_sample.cu"


def _variants():
    cuts, variants = sample_phases.DESIGNS[sample_phases._design(SOURCE.read_text())]
    return ["as it is", *variants]


@pytest.mark.parametrize("variant", _variants())
def test_cuts_apply_to_the_kernel(variant):
    """The kernel is a design the script knows; its cuts, then the
    variant's edits, each replace their text exactly once, and every cut
    leaves the source's PEDONI_PHASE branches balanced."""
    src = SOURCE.read_text()
    cuts, variants = sample_phases.DESIGNS[sample_phases._design(src)]
    out = sample_phases._replace(src, cuts, variant)
    out = sample_phases._replace(out, variants.get(variant, []), variant)
    assert out.count("#if PEDONI_PHASE") == len(cuts) == out.count("#endif")
    assert out != src


def test_refuses_to_run_without_a_card():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run([sys.executable, str(ROOT / "sample_phases.py")], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 2 and "no CUDA device" in r.stderr, r.stderr[-2000:]
    assert r.stdout == ""


@pytest.fixture(scope="module")
def gap_args():
    sc = load_scenario(ROOT / "scenarios" / "gap.toml")
    field = DeviceField.from_maps(FieldMaps.from_field(Field.from_scenario(sc, unit=0.25)),
                                  "cpu")
    pos, vel, speed, dest, act = (torch.from_numpy(x)
                                  for x in edge_case_agents(3000, 11))
    return (field.rows, field.hp, field.wp_cols, pos, vel, speed, dest % 2, act, 0.25,
            Physics().despawn_potential, CellGrid.for_size(sc.size, 1.4))


def test_tap_footprint_counts_the_tap_rows(gap_args):
    rows, hp, wp, pos, _vel, _speed, dest, _act, unit = gap_args[:9]
    foot = chip_smoke._tap_footprint(rows, hp, wp, pos, dest, unit)
    assert foot["texels"] == chip_smoke._tap_rows(rows, hp, wp, pos, dest, unit) > 1000
    assert foot["sectors_32"] >= foot["texels"] >= foot["pieces_64"] >= foot["lines_128"]
    assert foot["sectors_32_mb"] == foot["sectors_32"] * 32 / 1e6


def test_grid_sample_yardstick_computes_the_taps(gap_args):
    """grid_sample of the six planes at the agents' points: the obstacle
    distance and its Sobel of the alive agents within 1e-3 of the twin's,
    relative to max(1, |value|): grid_sample takes each point through
    normalised coordinates and back, a few 1e-6 of a texel, and the Sobel
    of the distance map climbs to 4e11 within a texel of an obstacle."""
    run, err = chip_smoke._grid_sample_call(gap_args)
    out = run()
    assert out.shape == (1, 6, 1, gap_args[3].shape[0])
    assert err < 1e-3
