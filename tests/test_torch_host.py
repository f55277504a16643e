"""The port's host side: its copies of the JAX-free modules equal the
reference's, the package imports and steps with JAX unavailable, and the
Simulator surface behaves (CPU twins; the CUDA path is exercised on the
card by chip_smoke.py)."""

import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import pedoni_tpu_torch
from pedoni_tpu.field import Field, FieldMaps
from pedoni_tpu.ops.pallas.fields6 import Fields6
from pedoni_tpu.physics import Physics
from pedoni_tpu.scenario import load_scenario, loads_scenario
from pedoni_tpu_torch import field as pfield
from pedoni_tpu_torch import physics as pphysics
from pedoni_tpu_torch import scenario as pscenario
from pedoni_tpu_torch.ops import fields6 as pfields6
from pedoni_tpu_torch.ops.kernels import _build
from pedoni_tpu_torch.sim import Simulator, SimulatorOptions

from test_grid_backend import SCENARIO, SPAWN_SCENARIO

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
GAP = ROOT / "scenarios" / "gap.toml"


def test_physics_and_scenarios_equal():
    assert dataclasses.astuple(pphysics.Physics()) == dataclasses.astuple(Physics())
    assert pphysics.Physics().cutoff_sq == Physics().cutoff_sq
    for src in (SCENARIO, SPAWN_SCENARIO, GAP.read_text()):
        assert (dataclasses.astuple(pscenario.loads_scenario(src))
                == dataclasses.astuple(loads_scenario(src)))
    assert (dataclasses.astuple(pscenario.load_scenario(GAP))
            == dataclasses.astuple(load_scenario(GAP)))


@pytest.mark.parametrize("which", ["gap", "test18x12"])
def test_field_maps_and_fields6_bit_equal(which):
    src = GAP.read_text() if which == "gap" else SCENARIO
    ref = FieldMaps.from_field(Field.from_scenario(loads_scenario(src), unit=0.25))
    got = pfield.FieldMaps.from_field(
        pfield.Field.from_scenario(pscenario.loads_scenario(src), unit=0.25))
    for f in dataclasses.fields(FieldMaps):
        np.testing.assert_array_equal(getattr(got, f.name), getattr(ref, f.name))
    nx = int(np.ceil(loads_scenario(src).size[0] / 1.5))
    ny_pad = -(-int(np.ceil(loads_scenario(src).size[1] / 1.5)) // 2) * 2
    for stride in (6, 3):
        a = Fields6.build(ref, nx, ny_pad, stride=stride)
        b = pfields6.Fields6.build(got, nx, ny_pad, stride=stride)
        np.testing.assert_array_equal(b.wp, a.wp)
        np.testing.assert_array_equal(b.obs, a.obs)
        assert (b.rows, b.nxl, b.nx_cells, b.stride) == (a.rows, a.nxl, a.nx_cells, a.stride)


def test_imports_and_steps_without_jax():
    """The port needs no JAX: with the module blocked it imports and runs
    one CPU step, and the reference package is never loaded."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import torch; torch.set_num_threads(1)\n"
        "import pedoni_tpu_torch as P\n"
        f"sim = P.Simulator(P.SimulatorOptions(backend='grid', device='cpu'), P.load_scenario({str(GAP)!r}))\n"
        "rec = sim.tick()\n"
        "assert rec.active_ped_count == 64, rec\n"
        "assert 'pedoni_tpu' not in sys.modules and 'jax' not in [m for m in sys.modules if sys.modules[m] is not None]\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr[-2000:]


def test_package_never_imports_jax_or_reference():
    for path in list(pathlib.Path(pedoni_tpu_torch.__file__).parent.rglob("*.py")) \
            + [ROOT / "chip_smoke.py", ROOT / "examples" / "quickstart_torch.py"]:
        text = path.read_text()
        for bad in ("import jax", "from jax", "import pedoni_tpu\n",
                    "from pedoni_tpu ", "from pedoni_tpu.", "import pedoni_tpu."):
            assert bad not in text, f"{path}: {bad!r}"


@pytest.mark.parametrize("option,message", [
    # the pallas backend runs on one device, as the reference's; an unknown
    # backend names the three
    ({"backend": "pallas", "n_devices": 4}, "requires the grid backend"),
    ({"backend": "auto"}, "'xla', 'pallas' or 'grid'"),
])
def test_unported_options_raise(option, message):
    with pytest.raises(ValueError, match=message):
        Simulator(SimulatorOptions(device="cpu", **option),
                  pscenario.load_scenario(GAP))


@pytest.mark.parametrize("name", ["renderer.py", "webview.py"])
def test_display_copies_equal(name):
    """The terminal renderer and the web view are copies of the
    reference's, line for line (neither imports JAX)."""
    port = pathlib.Path(pedoni_tpu_torch.__file__).parent / name
    assert port.read_text() == (ROOT / "pedoni_tpu" / name).read_text()


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Simulator(SimulatorOptions(backend="grid", device="cuda"), pscenario.load_scenario(GAP))


def test_kernel_build_failure_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")  # a compiler that fails
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.library()


def test_simulator_run_totals_and_growth():
    """run() keeps totals on the device and grows the table drop-free:
    gap's 64 agents start on one waypoint line, so K = 8 is short (the
    initial binning already drops the excess, as the reference's does)."""
    sim = Simulator(SimulatorOptions(backend="grid", device="cpu", table_capacity=8),
                    pscenario.load_scenario(GAP))
    n0 = sim.pedestrian_count
    assert 50 < n0 < 64
    rec = sim.run(8, guard_every=2)
    tot = sim.last_run_metrics
    assert sim.options.table_capacity > 8
    assert tot.n_overflow == 0 and tot.n_exited == 0
    assert rec.active_ped_count == tot.n_active == n0 == sim.pedestrian_count
    pos, dest = sim.list_pedestrians()
    assert pos.shape == (sim.pedestrian_count, 2) and np.isfinite(pos).all()
    assert (dest == 1).all()
    assert sim.measure_kernel_time(n=1) > 0.0
    assert sim.new_log("gap").to_dict()["model"] == "sfm-torch/grid"
