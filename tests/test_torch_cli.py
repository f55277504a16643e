"""The port's checkpoints and headless CLI (pedoni_tpu_torch/checkpoint.py,
cli.py), on the CPU:

- checkpoints cross between the packages with the agents exact: a port
  checkpoint loads through ``pedoni_tpu.checkpoint.load_state``, and a
  reference ``save_state`` file restores into the port's ``Simulator``
  (whose generator is then reseeded from its options);
- ``cli.main([... "-b", "cpu", "--no-distance-map", ...])`` writes a log
  with the reference's schema (tests/test_api.py:88-147), checkpoints
  every N steps, and a resumed run restores agents and generator exactly;
- the flags the port does not cover exit non-zero before any work.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pedoni_tpu import checkpoint as ref_ckpt
from pedoni_tpu.models.sfm import AgentState, SimState
from pedoni_tpu_torch import Simulator, SimulatorOptions, cli, convert
from pedoni_tpu_torch import checkpoint as port_ckpt
from pedoni_tpu_torch.scenario import loads_scenario

from test_api import SCENARIO as API_SCENARIO

torch.set_num_threads(1)

# tests/test_api.py's scenario (10 agents spawned once) with an obstacle,
# so that --no-distance-map has a segment to walk
SCENARIO = API_SCENARIO + """
[[obstacles]]
line = [[8, 0], [8, 6]]
width = 1
"""


def _active_rows(pos, vel, speed, dest, active):
    rows = np.concatenate([pos, vel, speed[:, None],
                           dest[:, None].astype(np.float32)], 1)[active]
    return rows[np.lexsort(rows.T[::-1])]


def _sim_rows(sim):
    a = convert.agents_to_numpy(sim._to_flat_state().agents)
    return _active_rows(a["pos"], a["vel"], a["speed"], a["dest"], a["active"])


def test_port_checkpoint_loads_in_reference(tmp_path):
    sim = Simulator(SimulatorOptions(device="cpu", seed=3), loads_scenario(SCENARIO))
    for _ in range(5):
        sim.tick()
    path = tmp_path / "port.npz"
    port_ckpt.save(sim, path)
    state, step_count = ref_ckpt.load_state(path)
    assert step_count == 5 and int(state.step) == 5
    assert state.key.shape == (2,) and state.key.dtype == jnp.uint32
    a = state.agents
    got = _active_rows(*(np.asarray(x) for x in (a.pos, a.vel, a.speed, a.dest,
                                                 a.active)))
    assert got.shape[0] == 10
    np.testing.assert_array_equal(got, _sim_rows(sim))


def test_reference_checkpoint_restores_in_port(tmp_path):
    rng = np.random.default_rng(5)
    n = 300  # more than the simulator's capacity below: it must grow
    pos = rng.uniform(1.0, 15.0, (n, 2)).astype(np.float32)
    vel = rng.normal(0, 0.3, (n, 2)).astype(np.float32)
    speed = rng.uniform(0.8, 1.6, n).astype(np.float32)
    dest = rng.integers(0, 2, n).astype(np.int32)
    active = rng.uniform(size=n) < 0.5
    path = tmp_path / "ref.npz"
    ref_ckpt.save_state(SimState(
        agents=AgentState(*map(jnp.asarray, (pos, vel, speed, dest, active))),
        key=jax.random.PRNGKey(9), step=jnp.int32(40)), path, step_count=40)

    sim = Simulator(SimulatorOptions(device="cpu", seed=11, capacity=256,
                                     table_capacity=32),
                    loads_scenario(SCENARIO))
    sim.generator.manual_seed(999)
    port_ckpt.restore(sim, path)
    assert sim.step_count == 40 and sim.state.step == 40
    assert sim.cfg.capacity == n
    np.testing.assert_array_equal(_sim_rows(sim),
                                  _active_rows(pos, vel, speed, dest, active))
    # no port generator state in a reference file: reseeded from options
    assert torch.equal(sim.generator.get_state(),
                       torch.Generator().manual_seed(11).get_state())


def _argv(tmp_path, *extra):
    scen = tmp_path / "s.toml"
    scen.write_text(SCENARIO)
    return [str(scen), "-H", "-b", "cpu", "-s", "0", "--capacity", "256",
            "--log-dir", str(tmp_path / "logs"), *extra]


def test_cli_headless_log_schema(tmp_path):
    assert cli.main(_argv(tmp_path, "--no-distance-map", "--max-steps", "20")) == 0
    (out,) = (tmp_path / "logs").glob("*_log.json")
    d = json.loads(out.read_text())
    assert set(d) == {"model", "scenario", "total_steps", "preprocess_metrics",
                      "step_metrics"}
    assert d["model"] == "sfm-torch/grid"
    assert d["total_steps"] == 20
    assert set(d["preprocess_metrics"]) == {"time_calc_field"}
    sm = d["step_metrics"]
    assert set(sm) == {"active_ped_count", "time_spawn", "time_calc_state",
                       "time_calc_state_kernel"}
    assert len(sm["active_ped_count"]) == 20 and sm["active_ped_count"][0] == 10
    assert sm["time_calc_state_kernel"] == [None] * 20


def test_cli_checkpoint_and_resume(tmp_path):
    ck = tmp_path / "cks"
    cli.main(_argv(tmp_path, "--no-distance-map", "--max-steps", "10",
                   "--checkpoint-every", "5", "--checkpoint-dir", str(ck)))
    cks = sorted(ck.glob("*.npz"))
    assert [p.name for p in cks] == ["step_00000005.npz", "step_00000010.npz"]
    args = cli.build_parser().parse_args(
        _argv(tmp_path, "--no-distance-map", "--resume", str(cks[0])))
    sim = cli.make_simulator(args)
    port_ckpt.restore(sim, cks[0])
    with np.load(cks[0]) as z:
        saved = _active_rows(z["pos"], z["vel"], z["speed"], z["dest"], z["active"])
        gen = torch.from_numpy(z["torch_generator"])
    assert sim.step_count == 5
    np.testing.assert_array_equal(_sim_rows(sim), saved)
    assert torch.equal(sim.generator.get_state(), gen)
    # the resumed run continues from step 5: 5 more steps reach step 10
    cli.main(_argv(tmp_path, "--no-distance-map", "--max-steps", "5",
                   "--resume", str(cks[0]), "--checkpoint-every", "5",
                   "--checkpoint-dir", str(tmp_path / "cks2")))
    with np.load(cks[1]) as a, np.load(tmp_path / "cks2" / "step_00000010.npz") as b:
        np.testing.assert_array_equal(
            _active_rows(b["pos"], b["vel"], b["speed"], b["dest"], b["active"]),
            _active_rows(a["pos"], a["vel"], a["speed"], a["dest"], a["active"]))


@pytest.mark.parametrize("extra", [
    ["-b", "xla"], ["-b", "tpu"], ["--devices", "2"], ["--tile", "2x1"],
    ["--render"], ["--render-web"], ["--record-every", "5"],
    ["--frame-every", "5"], ["--profile", "trace"], ["--no-headless"],
], ids=lambda e: e[-1].lstrip("-"))
def test_unported_flags_exit_nonzero(tmp_path, extra):
    argv = _argv(tmp_path, "--max-steps", "1")
    if extra == ["--no-headless"]:
        argv.remove("-H")
    else:
        argv += extra
    with pytest.raises(SystemExit) as exc:
        cli.main(argv)
    assert exc.value.code not in (0, None)
    assert "ROADMAP" in str(exc.value.code)
    assert not (tmp_path / "logs").exists()
