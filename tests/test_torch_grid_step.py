"""The port's grid step (pedoni_tpu_torch/models/sfm_grid.py) vs the
reference, end to end on the CPU (the kernels' PyTorch twins):

(a) 5 steps of the port's ``make_step_grid`` against the reference's
    ``make_step_grid(cfg, maps, incremental=False)`` from the same
    ``bin_state``: every StepMetrics field equal each step, active-agent
    sets within 1e-4 (as tests/test_grid_backend.py:99);
(b) the independent f64 oracle tests/oracle_sfm.py over 50 steps, within
    5e-3 m (as tests/test_oracle.py:126);
(c) ``spawn_scatter`` fed the reference's own ``_spawn_candidates`` gives
    a grid BIT-equal to the reference's scatter;
(d) the port's own spawn generator, statistically: the mean spawn count
    over many steps lies within 4 sigma of the Poisson rate.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pedoni_tpu.field import Field, FieldMaps
from pedoni_tpu.models import sfm_grid as ref_grid
from pedoni_tpu.models import sfm_pallas
from pedoni_tpu.models.sfm import AgentState, SimState, StepConfig, _spawn_candidates
from pedoni_tpu.scenario import loads_scenario
from pedoni_tpu_torch import convert
from pedoni_tpu_torch.field import Field as PField, FieldMaps as PFieldMaps
from pedoni_tpu_torch.models import sfm_grid as port_grid
from pedoni_tpu_torch.models.sfm import SimState as PSimState
from pedoni_tpu_torch.models.sfm import StepConfig as PStepConfig
from pedoni_tpu_torch.models.sfm import spawn_candidates
from pedoni_tpu_torch.scenario import loads_scenario as ploads_scenario

from oracle_sfm import oracle_step
from test_grid_backend import SCENARIO, SPAWN_SCENARIO

torch.set_num_threads(1)


def _agents(seed, n_active, cap=512):
    """The agent draw of tests/test_grid_backend.py::_setup."""
    rng = np.random.default_rng(seed)
    sc = loads_scenario(SCENARIO)
    pos = rng.uniform(0.8, np.array(sc.size) - 0.8, (cap, 2)).astype(np.float32)
    vel = rng.normal(0, 0.3, (cap, 2)).astype(np.float32)
    speed = np.clip(rng.normal(1.34, 0.26, cap), 0.3, None).astype(np.float32)
    dest = rng.integers(0, 2, cap).astype(np.int32)
    active = np.arange(cap) < n_active
    return pos, vel, speed, dest, active


def _configs(src, cap, k):
    cfg = StepConfig.build(loads_scenario(src), capacity=cap,
                           neighbor_grid_unit=1.5, table_capacity=k)
    pcfg = PStepConfig.build(ploads_scenario(src), capacity=cap,
                             neighbor_grid_unit=1.5, table_capacity=k)
    return cfg, pcfg


def _active_rows(d):
    """[n, 6] (pos, vel, speed, dest) of the active slots, sorted."""
    rows = np.transpose(d, (0, 1, 3, 2)).reshape(-1, 8)
    rows = rows[rows[:, 6] > 0.5][:, :6]
    return rows[np.lexsort((rows[:, 1], rows[:, 0]))]


@pytest.fixture(scope="module")
def grid_setup():
    """Maps of the 18 x 12 m test scenario from both packages, and the
    fields6 planes (equal arrays; the port's are asserted equal in
    test_torch_host.py)."""
    sc = loads_scenario(SCENARIO)
    maps = FieldMaps.from_field(Field.from_scenario(sc, unit=0.25))
    pmaps = PFieldMaps.from_field(PField.from_scenario(ploads_scenario(SCENARIO),
                                                       unit=0.25))
    return sc, maps, pmaps


def test_grid_step_matches_reference(grid_setup):
    _sc, maps, pmaps = grid_setup
    cfg, pcfg = _configs(SCENARIO, 512, 10)
    pos, vel, speed, dest, active = _agents(3, 160)
    st = SimState(agents=AgentState(*map(jnp.asarray, (pos, vel, speed, dest, active))),
                  key=jax.random.PRNGKey(7), step=jnp.int32(0))
    gs = ref_grid.bin_state(cfg, st)
    pgs = port_grid.bin_state(pcfg, PSimState(
        convert.agents_from_numpy(pos, vel, speed, dest, active, "cpu"), 0))
    np.testing.assert_array_equal(pgs.d.numpy(), np.asarray(gs.d))

    fwp, fobs = map(jnp.asarray, sfm_pallas.pallas_device_inputs(cfg, maps))
    pfwp, pfobs = port_grid.field_tensors(pcfg, pmaps, "cpu")
    np.testing.assert_array_equal(pfwp.numpy(), np.asarray(fwp))
    ref_step = jax.jit(ref_grid.make_step_grid(cfg, maps, incremental=False))
    port_step = port_grid.make_step_grid(pcfg, incremental=False)
    for i in range(5):
        gs, m = ref_step(gs, fwp, fobs)
        pgs, pm = port_step(pgs, pfwp, pfobs)
        want = {k: int(v) for k, v in m._asdict().items()}
        assert convert.metrics_to_dict(pm) == want, f"step {i}"
    assert want["n_active"] > 100
    a = _active_rows(np.asarray(gs.d))
    b = _active_rows(pgs.d.numpy())
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)


def test_bin_unbin_roundtrip():
    """Flat -> grid -> flat keeps every active agent's values exactly
    (unbin_state, convert.agents_to_numpy)."""
    _cfg, pcfg = _configs(SCENARIO, 512, 10)
    pos, vel, speed, dest, active = _agents(3, 160)
    gs = port_grid.bin_state(pcfg, PSimState(
        convert.agents_from_numpy(pos, vel, speed, dest, active, "cpu"), 0))
    back = convert.agents_to_numpy(port_grid.unbin_state(pcfg, gs).agents)

    def rows(p, v, s, d, a):
        r = np.concatenate([p, v, s[:, None], d[:, None].astype(np.float32)], 1)[a]
        return r[np.lexsort((r[:, 1], r[:, 0]))]

    np.testing.assert_array_equal(
        rows(back["pos"], back["vel"], back["speed"], back["dest"], back["active"]),
        rows(pos, vel, speed, dest, active))


def test_grid_step_matches_oracle(grid_setup):
    """50 steps through the port vs the f64 oracle (shares no code with
    either package), matched by unique speed tags."""
    _sc, _maps, pmaps = grid_setup
    cap, n, n_steps = 128, 100, 50
    _cfg, pcfg = _configs(SCENARIO, cap, 10)
    rng = np.random.default_rng(42)
    psc = ploads_scenario(SCENARIO)
    pos = rng.uniform(1.0, np.array(psc.size) - 1.0, (cap, 2)).astype(np.float32)
    vel = rng.normal(0, 0.2, (cap, 2)).astype(np.float32)
    speed = (1.0 + 0.002 * np.arange(cap)).astype(np.float32)
    dest = rng.integers(0, 2, cap).astype(np.int32)
    active = np.arange(cap) < n

    field = PField.from_scenario(psc, unit=0.25)
    o_pos, o_vel, o_act = pos, vel, active.copy()
    for _ in range(n_steps):
        o_pos, o_vel, o_act = oracle_step(field, o_pos, o_vel,
                                          speed.astype(np.float64), dest,
                                          o_act, psc.size, 1.5)

    gs = port_grid.bin_state(pcfg, PSimState(
        convert.agents_from_numpy(pos, vel, speed, dest, active, "cpu"), 0))
    fwp, fobs = port_grid.field_tensors(pcfg, pmaps, "cpu")
    step = port_grid.make_step_grid(pcfg)
    for _ in range(n_steps):
        gs, _m = step(gs, fwp, fobs)
    rows = _active_rows(gs.d.numpy())
    ids = {round(float(s), 6): i for i, s in enumerate(speed)}
    worst = 0.0
    for r in rows:
        oi = ids[round(float(r[4]), 6)]
        assert o_act[oi], f"agent {oi} active in the port, not the oracle"
        worst = max(worst, float(np.abs(r[0:2] - o_pos[oi]).max()))
    assert len(rows) == o_act.sum()
    assert worst < 5e-3, f"max position divergence {worst:.2e}"


@pytest.mark.parametrize("k,n_active", [(10, 160), (3, 300)])
def test_spawn_scatter_bit_equal(grid_setup, k, n_active):
    """Same candidates (the reference's own draw) into the same grid: the
    port's scatter writes the same bits, counts the same spawns and drops
    (K = 3 on a crowded grid forces drops)."""
    cfg, pcfg = _configs(SPAWN_SCENARIO, 512, k)
    pos, vel, speed, dest, active = _agents(5, n_active)
    st = SimState(agents=AgentState(*map(jnp.asarray, (pos, vel, speed, dest, active))),
                  key=jax.random.PRNGKey(0), step=jnp.int32(0))
    d0 = np.asarray(ref_grid.bin_state(cfg, st).d)
    ny_pad = d0.shape[0] - 2
    # Eager, like the _spawn_candidates call below: under jit XLA may fuse
    # the candidates' lerp differently and move a position by an ulp.
    def scatter(d, key):
        return ref_grid.spawn_scatter(cfg, d, key, row_lo=0, n_rows=ny_pad)

    spawned = dropped = 0
    d_ref = jnp.asarray(d0)
    d_port = torch.from_numpy(d0.copy())
    for i in range(6):
        key = jax.random.PRNGKey(100 + i)
        d_ref, n_sp, n_dr = scatter(d_ref, key)
        c = _spawn_candidates(cfg, key)
        cand = convert.agents_from_numpy(c.pos, c.vel, c.speed, c.dest, c.active,
                                         "cpu")
        d_port, p_sp, p_dr = port_grid.spawn_scatter(pcfg, d_port, cand)
        np.testing.assert_array_equal(d_port.numpy(), np.asarray(d_ref))
        assert (int(p_sp), int(p_dr)) == (int(n_sp), int(n_dr))
        spawned += int(n_sp)
        dropped += int(n_dr)
    assert spawned > 0
    if k == 3:
        assert dropped > 0


def test_spawn_generator_statistics():
    """The port draws its own candidates: Poisson counts per periodic
    group, within 4 sigma of the rate over many steps."""
    pcfg = PStepConfig.build(ploads_scenario(SPAWN_SCENARIO), capacity=512,
                             neighbor_grid_unit=1.5, table_capacity=10)
    gen = torch.Generator().manual_seed(1)
    n = 4000
    lam = float(pcfg.spawn.lam.sum())
    counts = np.array([int(spawn_candidates(pcfg, gen).active.sum())
                       for _ in range(n)])
    sigma = np.sqrt(lam / n)
    assert abs(counts.mean() - lam) < 4 * sigma, (counts.mean(), lam)
    cand = spawn_candidates(pcfg, gen)
    assert cand.pos.shape == (pcfg.spawn.total, 2)
    assert (cand.speed >= 0.1).all()


GAP = "scenarios/gap.toml"


def test_make_initial_grid_state_matches_reference(monkeypatch):
    """``make_initial_grid_state`` bins the once-spawned agents: fed the
    reference's initial agents of gap.toml (seed 3, carried across; the
    port's own draw comes from its generator), it equals the reference's
    ``make_initial_grid_state`` bit for bit, and it is ``bin_state`` of
    ``make_initial_state`` from the same generator."""
    from pedoni_tpu.models.sfm import make_initial_state as ref_initial
    from pedoni_tpu_torch.models.sfm import make_initial_state

    src = pathlib.Path(GAP).read_text()
    cfg, pcfg = _configs(src, 128, 10)
    want = ref_grid.make_initial_grid_state(cfg, seed=3)
    flat = ref_initial(cfg, seed=3)
    carried = PSimState(convert.agents_from_numpy(
        *(np.asarray(x) for x in flat.agents), "cpu"), 0)
    with monkeypatch.context() as m:
        m.setattr(port_grid, "make_initial_state", lambda *_: carried)
        got = port_grid.make_initial_grid_state(pcfg, torch.Generator(), "cpu")
    np.testing.assert_array_equal(got.d.numpy(), np.asarray(want.d))
    assert int((got.d[:, :, 6] > 0.5).sum()) == 64
    own = port_grid.make_initial_grid_state(pcfg, torch.Generator().manual_seed(3),
                                            "cpu")
    binned = port_grid.bin_state(pcfg, make_initial_state(
        pcfg, torch.Generator().manual_seed(3), "cpu"))
    assert torch.equal(own.d, binned.d)


def test_wp_skip_is_accepted_and_changes_nothing():
    """``SimulatorOptions(wp_skip=False)``, valid against the reference
    (its sim.py:99-102), builds, and ticks gap.toml (two waypoints) exactly
    as ``wp_skip=True``: the port has no slot walk to skip."""
    from pedoni_tpu import sim as ref_sim
    from pedoni_tpu_torch import Simulator, SimulatorOptions, load_scenario

    assert ref_sim.SimulatorOptions(wp_skip=False).wp_skip is False
    assert SimulatorOptions().wp_skip is True
    sc = load_scenario(GAP)
    runs = []
    for skip in (True, False):
        sim = Simulator(SimulatorOptions(backend="grid", device="cpu", seed=1,
                                         wp_skip=skip), sc)
        ticks = []
        for _ in range(6):
            sim.tick()
            ticks.append(sim.last_metrics)
        runs.append((ticks, sim.state.d))
    assert runs[0][0] == runs[1][0] and runs[0][0][-1].n_active > 0
    assert torch.equal(runs[0][1], runs[1][1])
