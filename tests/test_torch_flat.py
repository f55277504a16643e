"""The port's flat backend (pedoni_tpu_torch/ops/{forces,sampling,neighbor,
forcepass}.py, models/sfm.py::make_step, Simulator(backend="xla")) against
the reference's, on the CPU:

- each op against its JAX function on the same seeded NumPy inputs;
- one flat step against the reference's ``make_step`` from the same state
  with the reference's own spawn candidates injected, in all three modes
  (distance map, segments, all-pairs): every StepMetrics field equal, the
  active agents within atol 1e-5 on pos/vel, compared order-free (XLA's
  CPU division by the cell size can put an agent one float below a cell
  boundary in the next cell, which reorders the cell-sorted output);
- one pair pass against many row blocks a pass;
- 50 steps against the f64 oracle tests/oracle_sfm.py at the bands
  tests/test_oracle.py holds the reference's xla backend to;
- gap.toml's evacuation from the reference's initial state;
- ``Simulator.run``'s lagged growth guard under a periodic burst that
  crosses 80% of the capacity within ``guard_every`` steps: the same
  ``n_dropped`` total from both packages, candidates carried across;
- the same guard on the grid backend, whose burst fills cells past K
  within the lag: the lost agents counted and logged (the port's own
  stream, counts pinned), and ``-m slow`` the same totals as the
  reference's grid fed its candidates.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pedoni_tpu import sim as ref_sim
from pedoni_tpu.field import Field, FieldMaps
from pedoni_tpu.models import sfm as R
from pedoni_tpu.ops import forcepass as rfp
from pedoni_tpu.ops import forces as rforces
from pedoni_tpu.ops import neighbor as rnb
from pedoni_tpu.ops import sampling as rsamp
from pedoni_tpu.physics import Physics
from pedoni_tpu.scenario import loads_scenario
from pedoni_tpu_torch import convert
from pedoni_tpu_torch import field as pfield
from pedoni_tpu_torch import scenario as pscenario
from pedoni_tpu_torch import sim as port_sim
from pedoni_tpu_torch.models import sfm as P
from pedoni_tpu_torch.ops import forcepass as pfp
from pedoni_tpu_torch.ops import forces as pforces
from pedoni_tpu_torch.ops import neighbor as pnb
from pedoni_tpu_torch.ops import sampling as psamp

from oracle_sfm import oracle_step  # noqa: F401  (used through test_oracle)
from test_grid_backend import SPAWN_SCENARIO
from test_oracle import CAP, N_STEPS, SCENARIO as ORACLE_SCENARIO, UNIT
from test_oracle import _compare, _oracle_traj, _seg_obstacles

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
GAP = ROOT / "scenarios" / "gap.toml"
PHYS = Physics()


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got: torch.Tensor, want, atol=1e-6, rtol=1e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


# --- ops ---------------------------------------------------------------------

def _force_inputs():
    rng = np.random.default_rng(11)
    n, m = 48, 20
    f32 = np.float32
    return dict(
        pos=rng.uniform(0, 6, (n, 2)).astype(f32),
        vel=rng.normal(0, 0.8, (n, 2)).astype(f32),
        e=rng.normal(0, 1, (n, 2)).astype(f32),
        cand_pos=rng.uniform(0, 6, (n, m, 2)).astype(f32),
        cand_vel=rng.normal(0, 0.8, (n, m, 2)).astype(f32),
        cand_valid=rng.uniform(size=(n, m)) < 0.7,
        speed=rng.uniform(0.5, 1.8, n).astype(f32),
        dist=rng.uniform(0, 2, n).astype(f32),
        grad=rng.normal(0, 1, (n, 2)).astype(f32),
        acc=rng.normal(0, 3, (n, 2)).astype(f32),
        active=rng.uniform(size=n) < 0.8,
        seg_p0=np.array([[1, 1], [4, 0], [2, 5]], f32),
        seg_p1=np.array([[1, 4], [5, 3], [2.5, 5]], f32),
        seg_w=np.array([0.6, 1.0, 0.4], f32),
    )


FORCE_CASES = {
    "safe_normalize": lambda F, x, j: F.safe_normalize(j(x["grad"])),
    "goal_force": lambda F, x, j: F.goal_force(j(x["e"]), j(x["vel"]),
                                               j(x["speed"]), PHYS),
    "pairwise_force": lambda F, x, j: F.pairwise_force(
        j(x["pos"]), j(x["vel"]), j(x["e"]), j(x["cand_pos"]), j(x["cand_vel"]),
        j(x["cand_valid"]), PHYS),
    "obstacle_force": lambda F, x, j: F.obstacle_force(j(x["dist"]), j(x["grad"]),
                                                       PHYS),
    "segment_obstacle_force": lambda F, x, j: F.segment_obstacle_force(
        j(x["pos"]), j(x["seg_p0"]), j(x["seg_p1"]), j(x["seg_w"]), PHYS),
    "integrate": lambda F, x, j: torch.cat(F.integrate(
        j(x["pos"]), j(x["vel"]), j(x["acc"]), j(x["speed"]), j(x["active"]),
        PHYS), 1) if F is pforces else jnp.concatenate(F.integrate(
            j(x["pos"]), j(x["vel"]), j(x["acc"]), j(x["speed"]), j(x["active"]),
            PHYS), 1),
}


@pytest.mark.parametrize("name", list(FORCE_CASES))
def test_force_terms_match_reference(name):
    x = _force_inputs()
    want = FORCE_CASES[name](rforces, x, jnp.asarray)
    got = FORCE_CASES[name](pforces, x, _t)
    _close(got, want)


def _gap_maps():
    src = GAP.read_text()
    ref = FieldMaps.from_field(Field.from_scenario(loads_scenario(src), unit=0.25))
    port = pfield.FieldMaps.from_field(
        pfield.Field.from_scenario(pscenario.loads_scenario(src), unit=0.25))
    return ref, port


def test_sample_field_matches_reference():
    """Inside the field, on its edge and past the padding ring, both
    waypoint planes."""
    maps, pmaps = _gap_maps()
    rng = np.random.default_rng(5)
    pos = rng.uniform(-3.0, 27.0, (400, 2)).astype(np.float32)
    dest = rng.integers(0, 2, 400).astype(np.int32)
    ref = rsamp.DeviceField.from_maps(maps)
    port = psamp.DeviceField.from_maps(pmaps, "cpu")
    np.testing.assert_array_equal(port.rows.numpy(), np.asarray(ref.rows))
    want = rsamp.sample_field(ref.rows, ref.hp, ref.wp_cols, jnp.asarray(dest),
                              jnp.asarray(pos), 0.25)
    got = psamp.sample_field(port.rows, port.hp, port.wp_cols, _t(dest), _t(pos),
                             0.25)
    for g, w in zip(got, want):
        _close(g, w, atol=1e-5, rtol=1e-6)


def _sorted_ids(n=600, seed=2, grid=rnb.CellGrid.for_size((18.0, 12.0), 1.4)):
    """Ascending cell ids, computed in NumPy f64, with the sentinel tail
    and some crowded cells (past K = 6)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, 18.0, (n, 2)) * np.array([1.0, 12.0 / 18.0])
    pos[:60] = 4.3 + rng.uniform(0.0, 1.3, (60, 2))  # one crowded cell
    cx = np.floor(pos[:, 0] / grid.unit).astype(np.int64)
    cy = np.floor(pos[:, 1] / grid.unit).astype(np.int64)
    active = rng.uniform(size=n) < 0.85
    cid = np.where(active, cy * grid.nx + cx, grid.n_cells).astype(np.int32)
    order = np.argsort(cid, kind="stable")
    return grid, pos[order].astype(np.float32), cid[order], active[order]


def test_neighbor_data_matches_reference():
    grid, _pos, cid, _active = _sorted_ids()
    k = 6
    want = rnb.build_neighbor_data(jnp.asarray(cid), grid, k)
    got = pnb.build_neighbor_data(_t(cid), pnb.CellGrid(*grid), k)
    for name in ("order", "cell_ids", "csr", "table", "n_overflow"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert int(got.n_overflow) > 0
    np.testing.assert_array_equal(
        pnb.gather_candidates(_t(cid), got.table, pnb.CellGrid(*grid)).numpy(),
        np.asarray(rnb.gather_candidates(jnp.asarray(cid), want.table, grid)))


def test_pair_pass_matches_reference():
    """build_layout + scatter_cell_data exactly, dense_pairwise and
    gather_pair_acc within 1e-5, on the same cell-sorted agents."""
    grid, pos, cid, active = _sorted_ids()
    rng = np.random.default_rng(9)
    vel = rng.normal(0, 0.5, pos.shape).astype(np.float32)
    e = rng.normal(0, 1, pos.shape).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    k = 6
    pgrid = pnb.CellGrid(*grid)
    lay = rfp.build_layout(jnp.asarray(cid), jnp.asarray(active), grid, k)
    play = pfp.build_layout(_t(cid), _t(active), pgrid, k)
    for name in ("slot", "valid", "n_overflow"):
        np.testing.assert_array_equal(getattr(play, name).numpy(),
                                      np.asarray(getattr(lay, name)), err_msg=name)
    assert int(play.n_overflow) > 0
    data = rfp.scatter_cell_data(lay, grid, k, *map(jnp.asarray, (pos, vel, e)))
    pdata = pfp.scatter_cell_data(play, pgrid, k, *map(_t, (pos, vel, e)))
    np.testing.assert_array_equal(pdata.numpy(), np.asarray(data))
    acc = rfp.dense_pairwise(data, grid, k, PHYS, row_block=4)
    pacc = pfp.dense_pairwise(pdata, pgrid, k, PHYS, row_block=4)
    _close(pacc, acc, atol=1e-5)
    assert float(pacc.abs().max()) > 0.1
    _close(pfp.gather_pair_acc(pacc, play), rfp.gather_pair_acc(acc, lay), atol=1e-5)


def test_pair_pass_size_leaves_the_result():
    """A slot's force depends on its own row only: one row a pass equals
    every row in one pass, bit for bit."""
    grid, pos, cid, active = _sorted_ids(n=900, seed=4)
    rng = np.random.default_rng(3)
    vel = rng.normal(0, 0.5, pos.shape).astype(np.float32)
    pgrid = pnb.CellGrid(*grid)
    lay = pfp.build_layout(_t(cid), _t(active), pgrid, 8)
    data = pfp.scatter_cell_data(lay, pgrid, 8, _t(pos), _t(vel), _t(vel))
    whole = pfp.dense_pairwise(data, pgrid, 8, PHYS, row_block=grid.ny)
    assert whole.abs().max() > 0.1
    for rb, budget in ((1, 1), (2, 1), (3, 1 << 20)):
        np.testing.assert_array_equal(
            pfp.dense_pairwise(data, pgrid, 8, PHYS, row_block=rb,
                               pass_bytes=budget).numpy(), whole.numpy())


# --- the step -----------------------------------------------------------------

MODES = {"distance_map": {}, "segments": {"use_distance_map": False},
         "all_pairs": {"use_neighbor_grid": False}}


def _rows(pos, vel, speed, dest, active):
    """Active agents as rows (pos, vel, speed, dest), sorted by a key of
    NumPy f64 (speed, unique per agent here, then position)."""
    rows = np.concatenate([pos, vel, speed[:, None], dest[:, None]], 1
                          ).astype(np.float64)[active]
    return rows[np.lexsort((rows[:, 1], rows[:, 0], rows[:, 4]))]


def _ref_rows(st):
    a = st.agents
    return _rows(*(np.asarray(x) for x in (a.pos, a.vel, a.speed, a.dest, a.active)))


def _port_rows(pst):
    a = convert.agents_to_numpy(pst.agents)
    return _rows(a["pos"], a["vel"], a["speed"], a["dest"], a["active"])


def _to_port(st):
    return P.SimState(convert.agents_from_numpy(
        *(np.asarray(x) for x in st.agents), "cpu"), int(st.step))


@pytest.mark.parametrize("mode", list(MODES))
def test_flat_step_matches_reference(mode):
    """Three steps of the spawning test scenario, each from the
    reference's own state carried across, with its candidates injected."""
    sc = loads_scenario(SPAWN_SCENARIO)
    psc = pscenario.loads_scenario(SPAWN_SCENARIO)
    maps = FieldMaps.from_field(Field.from_scenario(sc, unit=0.25))
    pmaps = pfield.FieldMaps.from_field(pfield.Field.from_scenario(psc, unit=0.25))
    cap = 384
    cfg = R.StepConfig.build(sc, capacity=cap, table_capacity=10, **MODES[mode])
    pcfg = P.StepConfig.build(psc, capacity=cap, table_capacity=10, **MODES[mode])
    rng = np.random.default_rng(3)
    pos = rng.uniform(0.8, np.array(sc.size) - 0.8, (cap, 2)).astype(np.float32)
    vel = rng.normal(0, 0.3, (cap, 2)).astype(np.float32)
    speed = (1.0 + 0.001 * np.arange(cap)).astype(np.float32)
    dest = rng.integers(0, 2, cap).astype(np.int32)
    active = np.arange(cap) < 300
    st = R.SimState(R.AgentState(*map(jnp.asarray, (pos, vel, speed, dest, active))),
                    jax.random.PRNGKey(7), jnp.int32(0))
    field, obstacles = R.device_inputs(cfg, maps)
    ref_step = jax.jit(R.make_step(cfg, maps))
    pf, pobs = P.device_inputs(pcfg, pmaps, "cpu")
    port_step = P.make_step(pcfg, torch.Generator())
    # jitted as inside the step, whose fused multiply-add draws the speeds
    draw = jax.jit(lambda key: R._spawn_candidates(cfg, jax.random.split(key)[1]))
    spawned = 0
    for i in range(3):
        cand = draw(st.key)
        pst = _to_port(st)
        st, m = ref_step(st, field.rows, obstacles)
        pst, pm = port_step(pst, pf.rows, pobs, convert.agents_from_numpy(
            *(np.asarray(x) for x in cand), "cpu"))
        want = {k: int(v) for k, v in m._asdict().items()}
        assert convert.metrics_to_dict(pm) == want, f"step {i}"
        assert pst.step == int(st.step)
        a, b = _ref_rows(st), _port_rows(pst)
        assert a.shape == b.shape and a.shape[0] > 250
        np.testing.assert_allclose(b[:, :4], a[:, :4], rtol=0, atol=1e-5)
        np.testing.assert_array_equal(b[:, 4:], a[:, 4:])
        spawned += want["n_spawned"]
    assert spawned > 0


def test_fault_containment_matches_reference():
    """An agent with a non-finite velocity, one with a non-finite speed and
    one at a NaN position: the 2**30 sentinels keep every agent finite,
    and the faulty ones leave the grid and are despawned, with the
    reference's counts each step.  (Forces on their neighbours come from
    an ellipse of ~1e8 m and depend on its rounding; some neighbours are
    flung out too, in both packages, so positions are not compared.)"""
    sc = loads_scenario(SPAWN_SCENARIO.split("[[pedestrians]]")[0])
    psc = pscenario.loads_scenario(SPAWN_SCENARIO.split("[[pedestrians]]")[0])
    maps = FieldMaps.from_field(Field.from_scenario(sc, unit=0.25))
    pmaps = pfield.FieldMaps.from_field(pfield.Field.from_scenario(psc, unit=0.25))
    cap = 256
    cfg = R.StepConfig.build(sc, capacity=cap, table_capacity=10)
    pcfg = P.StepConfig.build(psc, capacity=cap, table_capacity=10)
    rng = np.random.default_rng(8)
    pos = rng.uniform(0.8, np.array(sc.size) - 0.8, (cap, 2)).astype(np.float32)
    vel = rng.normal(0, 0.3, (cap, 2)).astype(np.float32)
    speed = rng.uniform(1.0, 1.6, cap).astype(np.float32)
    dest = rng.integers(0, 2, cap).astype(np.int32)
    active = np.arange(cap) < 200
    vel[3] = [np.inf, 0.0]
    speed[5] = np.nan
    pos[9] = np.nan
    st = R.SimState(R.AgentState(*map(jnp.asarray, (pos, vel, speed, dest, active))),
                    jax.random.PRNGKey(0), jnp.int32(0))
    pst = _to_port(st)
    field, obstacles = R.device_inputs(cfg, maps)
    ref_step = jax.jit(R.make_step(cfg, maps))
    pf, pobs = P.device_inputs(pcfg, pmaps, "cpu")
    port_step = P.make_step(pcfg)
    for i in range(2):
        st, m = ref_step(st, field.rows, obstacles)
        pst, pm = port_step(pst, pf.rows, pobs)
        assert convert.metrics_to_dict(pm) == {k: int(v) for k, v in
                                               m._asdict().items()}, f"step {i}"
        a = pst.agents
        assert bool(torch.isfinite(a.pos[a.active]).all())
    assert int(pm.n_active) <= 197  # 200, less the three faulty agents
    assert bool(torch.isfinite(a.vel[a.active]).all())


@pytest.mark.parametrize("mode", list(MODES))
def test_flat_step_matches_oracle(mode):
    """The port's flat step vs the f64 oracle over 50 steps, matched by
    unique speeds, within tests/test_oracle.py's 5e-3 m."""
    sc = loads_scenario(ORACLE_SCENARIO)
    field = Field.from_scenario(sc, unit=0.25)
    psc = pscenario.loads_scenario(ORACLE_SCENARIO)
    pmaps = pfield.FieldMaps.from_field(pfield.Field.from_scenario(psc, unit=0.25))
    rng = np.random.default_rng(42)  # tests/test_oracle.py::setup
    pos = rng.uniform(1.0, np.array(sc.size) - 1.0, (CAP, 2)).astype(np.float32)
    vel = rng.normal(0, 0.2, (CAP, 2)).astype(np.float32)
    speed = (1.0 + 0.002 * np.arange(CAP)).astype(np.float32)
    dest = rng.integers(0, 2, CAP).astype(np.int32)
    active = np.arange(CAP) < 100
    modes = {"distance_map": {}, "segments": {"obstacles": _seg_obstacles(sc)},
             "all_pairs": {"use_neighbor_grid": False}}[mode]
    o_pos, o_act = _oracle_traj(sc, field, pos, vel, speed, dest, active, **modes)
    pcfg = P.StepConfig.build(psc, capacity=CAP, neighbor_grid_unit=UNIT,
                              table_capacity=10, **MODES[mode])
    pf, pobs = P.device_inputs(pcfg, pmaps, "cpu")
    step = P.make_step(pcfg)
    st = P.SimState(convert.agents_from_numpy(pos, vel, speed, dest, active, "cpu"), 0)
    for _ in range(N_STEPS):
        st, _ = step(st, pf.rows, pobs)
    a = convert.agents_to_numpy(st.agents)
    _compare(speed, o_pos, o_act, a["pos"], a["active"], a["speed"],
             f"port flat {mode}")


def test_gap_evacuation_matches_reference():
    """gap.toml's 64 agents from the reference's initial state (seed 1),
    both flat steps until the population reaches 0: the step counts agree
    within the 5% band of tests/test_oracle.py (225 and 222 steps)."""
    src = GAP.read_text()
    sc, psc = loads_scenario(src), pscenario.loads_scenario(src)
    maps = FieldMaps.from_field(Field.from_scenario(sc, unit=0.25))
    pmaps = pfield.FieldMaps.from_field(pfield.Field.from_scenario(psc, unit=0.25))
    cfg = R.StepConfig.build(sc, capacity=128)
    pcfg = P.StepConfig.build(psc, capacity=128)
    st = R.make_initial_state(cfg, seed=1)
    pst = _to_port(st)
    field, obstacles = R.device_inputs(cfg, maps)
    ref_step = jax.jit(R.make_step(cfg, maps))
    pf, pobs = P.device_inputs(pcfg, pmaps, "cpu")
    port_step = P.make_step(pcfg)
    counts = {}
    for name, step, s, args in (("reference", ref_step, st, (field.rows, obstacles)),
                                ("port", port_step, pst, (pf.rows, pobs))):
        for i in range(400):
            s, m = step(s, *args)
            assert int(m.n_overflow) == 0 and int(m.n_dropped) == 0
            if int(m.n_active) == 0:
                counts[name] = i + 1
                break
    assert set(counts) == {"reference", "port"}, counts
    assert abs(counts["port"] - counts["reference"]) <= 0.05 * counts["reference"], counts


BURST = """
[field]
size = [30, 20]
[[waypoints]]
line = [[3, 4], [3, 16]]
[[waypoints]]
line = [[27, 4], [27, 16]]
[[pedestrians]]
origin = 0
destination = 1
spawn = { kind = "periodic", frequency = 100.0 }
[[pedestrians]]
origin = 0
destination = 1
spawn = { kind = "once", count = 40 }
"""


def test_run_guard_lags_a_burst_as_the_reference(monkeypatch, caplog):
    """A periodic burst of ~10 agents a step from 40: the population
    passes 80% of the capacity 64 after two steps, but ``run``'s guard
    reads the metrics of the step ``guard_every`` = 4 launches ago, so
    agents are cut at the capacity before it doubles.  The port's run,
    fed the reference's candidates, ends with the reference's totals
    (``n_dropped`` among them) and capacity."""
    sc, psc = loads_scenario(BURST), pscenario.loads_scenario(BURST)
    ref = ref_sim.Simulator(ref_sim.SimulatorOptions(capacity=64, seed=4), sc)
    cfg = ref.cfg
    key = ref.state.key
    draw = jax.jit(lambda k: R._spawn_candidates(cfg, k))  # fused as in the step
    cands = []
    for _ in range(12):  # the reference's stream: the key chain of its step
        key, k_spawn = jax.random.split(key)
        cands.append(convert.agents_from_numpy(
            *(np.asarray(x) for x in draw(k_spawn)), "cpu"))
    make_step = port_sim.make_step

    def injected(pcfg, generator=None):
        step = make_step(pcfg, generator)
        return lambda st, f, o: step(st, f, o, cands[st.step])

    monkeypatch.setattr(port_sim, "make_step", injected)
    port = port_sim.Simulator(port_sim.SimulatorOptions(capacity=64, device="cpu"),
                              psc)
    port.state = _to_port(ref.state)
    ref.run(12, guard_every=4)
    with caplog.at_level("WARNING"):
        port.run(12, guard_every=4)
    want = {k: int(v) for k, v in ref.last_run_metrics._asdict().items()}
    got = port.last_run_metrics._asdict()
    assert got == want
    assert want["n_dropped"] > 0 and want["n_spawned"] > 60
    assert ref.cfg.capacity == port.cfg.capacity > 64
    assert "agents dropped at capacity over the run" in caplog.text


# The grid's worst case under BURST: a table of K = 8 holds every one of
# the 40 initial agents, but the periodic burst fills the spawn cells past
# K within the guard's lag, so some candidates find their cells full.
BURST_GRID_K = 8


def _burst_grid_sim(seed: int) -> port_sim.Simulator:
    return port_sim.Simulator(port_sim.SimulatorOptions(
        backend="grid", capacity=64, table_capacity=BURST_GRID_K, seed=seed,
        device="cpu"), pscenario.loads_scenario(BURST))


def test_run_guard_lags_a_burst_on_the_grid(caplog):
    """The burst on the grid backend, ``run(12, guard_every=4)``: the
    lagged guard grows K twice (8 -> 12), too late for the first cells to
    fill, and what is lost is counted and logged, never silent: 9 spawn
    candidates dropped into full cells (``n_dropped``) and one agent lost
    to a rebin overflow (``n_overflow``), from the port's stream at seed
    4."""
    sim = _burst_grid_sim(4)
    assert sim.pedestrian_count == 40  # every initial agent binned
    with caplog.at_level("WARNING"):
        sim.run(12, guard_every=4)
    assert sim.last_run_metrics._asdict() == {
        "n_active": 135, "n_spawned": 105, "n_dropped": 9, "n_overflow": 1,
        "max_demand": 11, "n_exited": 0, "max_mover_demand": 3}
    assert sim.options.table_capacity == 12
    assert "9 spawn candidates dropped into full cells over the run" in caplog.text
    assert "1 agents lost to cell overflow over the run" in caplog.text


@pytest.mark.slow
def test_run_guard_on_the_grid_as_the_reference(monkeypatch):
    """The same burst through the reference's grid ``Simulator`` (its
    kernels in interpret mode) and the port's, fed the reference's initial
    agents and spawn candidates: equal ``last_run_metrics`` and table
    capacity after ``run(12, guard_every=4)``."""
    sc = loads_scenario(BURST)
    ref = ref_sim.Simulator(ref_sim.SimulatorOptions(
        backend="grid", capacity=64, table_capacity=BURST_GRID_K, seed=4), sc)
    cfg = ref.cfg
    key = ref.state.key
    draw = jax.jit(lambda k: R._spawn_candidates(cfg, k))  # fused as in the step
    cands = []
    for _ in range(12):  # the reference's stream: the key chain of its step
        key, k_spawn = jax.random.split(key)
        cands.append(convert.agents_from_numpy(
            *(np.asarray(x) for x in draw(k_spawn)), "cpu"))
    make_step_grid = port_sim.sfm_grid.make_step_grid

    def injected(pcfg, **kw):
        step = make_step_grid(pcfg, **kw)
        return lambda st, f, o: step(st, f, o, cands[st.step])

    monkeypatch.setattr(port_sim.sfm_grid, "make_step_grid", injected)
    port = _burst_grid_sim(4)
    flat = ref._to_flat_state()
    port.load_flat_state(_to_port(flat))
    assert port.pedestrian_count == ref.pedestrian_count
    ref.run(12, guard_every=4)
    port.run(12, guard_every=4)
    want = {k: int(v) for k, v in ref.last_run_metrics._asdict().items()}
    assert port.last_run_metrics._asdict() == want
    assert want["n_dropped"] > 0
    assert port.options.table_capacity == ref.options.table_capacity > BURST_GRID_K
