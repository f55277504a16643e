"""The port's object surface and entry points on the CPU: the flat
backend's Simulator (the default options), ``models/base.py``'s
``SocialForceModel`` against the reference's, a flat checkpoint restored
into the grid backend and back, ``examples/quickstart_torch.py``, and
``pedoni_tpu_torch.entry`` with the tile dryruns."""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from pedoni_tpu.field import Field
from pedoni_tpu.models import base as ref_base
from pedoni_tpu.scenario import loads_scenario
from pedoni_tpu_torch import Simulator, SimulatorOptions, entry
from pedoni_tpu_torch import checkpoint as port_ckpt
from pedoni_tpu_torch import convert
from pedoni_tpu_torch import field as pfield
from pedoni_tpu_torch import scenario as pscenario
from pedoni_tpu_torch.models import base as port_base
from pedoni_tpu_torch.parallel import grid_shard

from test_grid_backend import SCENARIO

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
GAP = ROOT / "scenarios" / "gap.toml"


def _rows(a):
    rows = np.concatenate([a["pos"], a["vel"], a["speed"][:, None],
                           a["dest"][:, None].astype(np.float32)], 1)[a["active"]]
    return rows[np.lexsort(rows.T[::-1])]


def test_default_options_run_the_flat_step():
    """``SimulatorOptions()`` is the reference's: the flat backend at the
    1.4 m unit; tick, counts, the log's model name, no kernel time, and
    the grid's 1.5 m only where the grid backend is asked for."""
    o = SimulatorOptions(device="cpu")
    assert o.backend == "xla" and o.resolved().neighbor_grid_unit == 1.4
    assert SimulatorOptions(backend="grid").resolved().neighbor_grid_unit == 1.5
    sim = Simulator(o, pscenario.load_scenario(GAP))
    assert sim.cfg.grid.unit == 1.4 and sim.pedestrian_count == 64
    rec = sim.tick()
    assert rec.active_ped_count == sim.pedestrian_count == 64
    pos, dest = sim.list_pedestrians()
    assert pos.shape == (64, 2) and np.isfinite(pos).all() and (dest == 1).all()
    assert sim.measure_kernel_time() is None
    assert sim.new_log("gap").to_dict()["model"] == "sfm-torch/xla"


def test_flat_tick_doubles_the_capacity_at_80_percent():
    sim = Simulator(SimulatorOptions(device="cpu", capacity=64),
                    pscenario.load_scenario(GAP))
    assert sim.cfg.capacity == 64
    sim.tick()  # 64 active > 0.8 * 64
    assert sim.cfg.capacity == 128 and sim.state.agents.pos.shape == (128, 2)
    assert sim.pedestrian_count == 64
    assert sim.tick().active_ped_count == 64


@pytest.mark.parametrize("option,message", [
    ({"n_devices": 2}, "requires the grid backend"),
    ({"backend": "spatial"}, "unknown backend"),
])
def test_flat_options_raise(option, message):
    with pytest.raises(ValueError, match=message):
        Simulator(SimulatorOptions(device="cpu", **option),
                  pscenario.load_scenario(GAP))


def test_social_force_model_matches_reference():
    """Three rounds of spawn_pedestrians + two update_states: the same
    pedestrians (order-free) within 1e-4 m, the speeds of the spawned ones
    bit-equal (both draw from np.random.default_rng(step + 1))."""
    sc = loads_scenario(SCENARIO)
    psc = pscenario.loads_scenario(SCENARIO)
    field = Field.from_scenario(sc, unit=0.25)
    pfld = pfield.Field.from_scenario(psc, unit=0.25)
    ref = ref_base.SocialForceModel(None, sc, field, capacity=256)
    port = port_base.SocialForceModel(None, psc, pfld, capacity=256, device="cpu")
    rng = np.random.default_rng(1)
    for r in range(3):
        batch = [(float(x), float(y), int(d)) for x, y, d in zip(
            rng.uniform(3.0, 15.0, 30), rng.uniform(1.0, 11.0, 30),
            rng.integers(0, 2, 30))]
        ref.spawn_pedestrians(field, [ref_base.Pedestrian((x, y), d)
                                      for x, y, d in batch])
        port.spawn_pedestrians(pfld, [port_base.Pedestrian((x, y), d)
                                      for x, y, d in batch])
        want = {k: np.asarray(v) for k, v in ref.state.agents._asdict().items()}
        np.testing.assert_array_equal(
            np.sort(convert.agents_to_numpy(port.state.agents)["speed"][
                convert.agents_to_numpy(port.state.agents)["active"]]),
            np.sort(want["speed"][want["active"]]))
        for _ in range(2):
            ref.update_states(sc, field)
            port.update_states(psc, pfld)
        assert port.get_pedestrian_count() == ref.get_pedestrian_count()
        got = sorted((p.pos[0], p.pos[1], p.destination)
                     for p in port.list_pedestrians())
        exp = sorted((p.pos[0], p.pos[1], p.destination)
                     for p in ref.list_pedestrians())
        np.testing.assert_allclose(np.array(got), np.array(exp), atol=1e-4)
    assert port.get_pedestrian_count() > 60
    assert isinstance(port, port_base.PedestrianModel)


def test_flat_checkpoint_crosses_backends(tmp_path):
    """Five flat ticks, saved; restored into the grid backend with the
    agents exact; three grid ticks, saved; restored into the flat backend
    exact again."""
    sc = pscenario.loads_scenario(SCENARIO + """
[[pedestrians]]
origin = 0
destination = 1
spawn = { kind = "once", count = 40 }
""")
    flat = Simulator(SimulatorOptions(device="cpu", seed=2), sc)
    for _ in range(5):
        flat.tick()
    port_ckpt.save(flat, tmp_path / "flat.npz")
    grid = Simulator(SimulatorOptions(backend="grid", device="cpu", seed=5,
                                      table_capacity=24), sc)
    port_ckpt.restore(grid, tmp_path / "flat.npz")
    want = _rows(convert.agents_to_numpy(flat.state.agents))
    assert want.shape[0] == 40 and grid.step_count == 5
    np.testing.assert_array_equal(
        _rows(convert.agents_to_numpy(grid.flat_state().agents)), want)
    for _ in range(3):
        grid.tick()
    port_ckpt.save(grid, tmp_path / "grid.npz")
    back = Simulator(SimulatorOptions(device="cpu", seed=7), sc)
    port_ckpt.restore(back, tmp_path / "grid.npz")
    assert back.step_count == 8 and back.state.step == 8
    np.testing.assert_array_equal(
        _rows(convert.agents_to_numpy(back.state.agents)),
        _rows(convert.agents_to_numpy(grid.flat_state().agents)))


def test_quickstart_runs_on_the_cpu(capsys, tmp_path):
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    png = tmp_path / "quickstart.png"
    sim = mod.main("cpu", n_steps=60, png=png)
    out = capsys.readouterr().out
    assert "checkpoint restored at step 60" in out
    assert f"wrote {png}" in out and png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert sim.options.backend == "xla" and sim.pedestrian_count > 40


def test_entry_and_dryruns_on_the_cpu(capsys):
    fn, args = entry.entry("cpu")
    state, metrics = fn(*args)
    assert state.step == 1 and int(metrics.n_active) >= 32
    entry.dryrun_multichip(4, device="cpu")
    grid_shard.dryrun(2, device="cpu")
    out = capsys.readouterr().out
    for tiling in ("4x1", "2x2", "2x1"):
        assert f"tile2d dryrun {tiling}: 3 steps" in out
