"""The port's 2D tiling (pedoni_tpu_torch/parallel/tile2d.py) on the CPU,
its tiles on one process's list of devices ("cpu" for each):

- R x C tiles against the port's own whole-grid step, on the full path and
  on the hybrid (``compact_every=1000``: only step 0 compacts), with spawns,
  migration across columns, across rows and diagonally, and spawns next to
  tile edges: every StepMetrics field equal each step and the tiles' own
  cells, gathered, equal to the whole grid BIT FOR BIT (every kernel block
  sees the window one grid would, and the twins sum in a fixed order);
- one run of the reference's tiled step (tests/test_tile2d.py::_setup at
  1 x 2, which tier-1 already compiles) against the port's, fed the
  reference's own spawn candidates: metrics equal, active sets within that
  test's band (rtol 1e-3, atol 2e-2: the reference contracts FMAs);
- the rebins' tile offsets against tests/test_rebin.py::_numpy_rebin;
- Simulator(n_devices=4, tile=(2, 2)) on gap.toml to evacuation, metrics
  equal to one device's each step; checkpoints across device counts.

The tile shapes the reference marks slow (2 x 2 and 3 x 2 in
test_tiled_equals_single_chip) are slow here too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pedoni_tpu.field import Field, FieldMaps
from pedoni_tpu.models.sfm import AgentState, SimState, StepConfig, _spawn_candidates
from pedoni_tpu.parallel import tile2d as ref_tile2d
from pedoni_tpu.scenario import loads_scenario
from pedoni_tpu_torch import Simulator, SimulatorOptions, checkpoint, convert
from pedoni_tpu_torch import load_scenario as pload_scenario
from pedoni_tpu_torch.field import Field as PField, FieldMaps as PFieldMaps
from pedoni_tpu_torch.models import sfm_grid
from pedoni_tpu_torch.models.sfm import SimState as PSimState
from pedoni_tpu_torch.models.sfm import StepConfig as PStepConfig
from pedoni_tpu_torch.models.sfm import spawn_candidates
from pedoni_tpu_torch.ops.kernels import rebin as rb
from pedoni_tpu_torch.parallel import grid_shard, tile2d
from pedoni_tpu_torch.scenario import loads_scenario as ploads_scenario

from test_rebin import K as RK, NX as RNX, NXL as RNXL, UNIT as RUNIT, _make_grid, _numpy_rebin
from test_tile2d import SCENARIO, SCENARIO_NOSPAWN, _active_set

torch.set_num_threads(1)

GAP = "scenarios/gap.toml"
STEPS = 4


def _port_setup(toml=SCENARIO, n=140, seed=5, k=10, cap=512):
    """tests/test_tile2d.py::_setup's agents for the port: (maps, cfg, flat
    state on the CPU)."""
    sc = ploads_scenario(toml)
    maps = PFieldMaps.from_field(PField.from_scenario(sc, unit=0.25))
    cfg = PStepConfig.build(sc, capacity=cap, neighbor_grid_unit=1.5,
                            table_capacity=k)
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.8, np.array(sc.size) - 0.8, (cap, 2)).astype(np.float32)
    vel = rng.normal(0, 0.3, (cap, 2)).astype(np.float32)
    speed = np.clip(rng.normal(1.34, 0.26, cap), 0.3, None).astype(np.float32)
    dest = rng.integers(0, 2, cap).astype(np.int32)
    agents = convert.agents_from_numpy(pos, vel, speed, dest, np.arange(cap) < n,
                                       "cpu")
    return maps, cfg, PSimState(agents, 0)


def _walkers(pos, vel, toml=SCENARIO_NOSPAWN, k=6):
    """A few agents at ``pos`` walking at ``vel``, with the rest of the
    64 slots inactive."""
    sc = ploads_scenario(toml)
    maps = PFieldMaps.from_field(PField.from_scenario(sc, unit=0.25))
    cfg = PStepConfig.build(sc, capacity=64, neighbor_grid_unit=1.5,
                            table_capacity=k)
    n = len(pos)
    p = np.zeros((64, 2), np.float32)
    v = np.zeros((64, 2), np.float32)
    p[:n], v[:n] = pos, vel
    agents = convert.agents_from_numpy(p, v, np.full(64, 1.34), np.ones(64),
                                       np.arange(64) < n, "cpu")
    return maps, cfg, PSimState(agents, 0)


def _run_both(maps, cfg, flat, tile, n_steps=STEPS, **step_kw):
    """The whole-grid step and the tiled one from the same state and the
    same candidates: (whole grid, gathered tiles, per-step metrics of each)."""
    gen = torch.Generator().manual_seed(0)  # spawns in 3 of the first 4 steps
    cands = [spawn_candidates(cfg, gen) for _ in range(n_steps)]
    fwp, fobs = sfm_grid.field_tensors(cfg, maps, "cpu")
    step = sfm_grid.make_step_grid(cfg, generator=gen, **step_kw)
    gs = sfm_grid.bin_state(cfg, flat)
    tcfg = tile2d.Tile2DConfig.build(cfg, *tile)
    if tile[1] == 1:  # row strips: grid_shard's shim builds the same layout
        assert grid_shard.GridShardConfig.build(cfg, tile[0]) == tcfg
    devices = ["cpu"] * tcfg.n_devices
    tfwp, tfobs = tile2d.device_inputs(tcfg, maps, sfm_grid.stride_for(cfg), devices)
    tstep = tile2d.make_sharded_step(tcfg, devices, generator=gen, **step_kw)
    ts = tile2d.make_sharded_grid_state(tcfg, flat, devices)
    whole, tiled = [], []
    for cand in cands:
        gs, m = step(gs, fwp, fobs, cand)
        ts, mt = tstep(ts, tfwp, tfobs, cand)
        whole.append(convert.metrics_to_dict(m))
        tiled.append(convert.metrics_to_dict(mt))
    return gs.d, tile2d.gather(tcfg, ts), whole, tiled


def _assert_tiled_equals_whole(maps, cfg, flat, tile, **step_kw):
    d, dt, whole, tiled = _run_both(maps, cfg, flat, tile, **step_kw)
    assert tiled == whole
    assert torch.equal(dt, d)
    return d, whole


PATHS = {"full": dict(incremental=False),
         "hybrid": dict(incremental=True, compact_every=1000)}


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("tile", [
    (1, 2),
    (2, 1),
    # uneven division: nx = 12 over 5 column tiles -> tiles own 3, 3, 3, 3,
    # 0 cells (one tile owns none)
    (1, 5),
    pytest.param((2, 2), marks=pytest.mark.slow),
    # uneven rows: ny = 8 over 3 row strips of 4 -> 4, 4, 0 rows
    pytest.param((3, 2), marks=pytest.mark.slow),
], ids=lambda t: f"{t[0]}x{t[1]}")
def test_tiled_equals_whole(tile, path):
    maps, cfg, flat = _port_setup()
    d, metrics = _assert_tiled_equals_whole(maps, cfg, flat, tile, **PATHS[path])
    assert sum(m["n_spawned"] for m in metrics) > 0 and metrics[-1]["n_active"] > 100


# direction -> (positions, velocity, tile): the column boundary of 1 x 2 or
# 2 x 2 tiles is x = 9 m (6 cells), the row boundary of 2 x 2 y = 6 m;
# walkers ~0.14 m short of it at 1.3 m/s cross it in the second step
MIGRATIONS = {
    "columns": ([(8.86, y) for y in (6.5, 7.5, 9.5, 10.5)], (1.3, 0.0), (1, 2)),
    "rows": ([(x, 5.86) for x in (3.5, 5.5, 7.5, 12.0)], (0.0, 1.3), (2, 2)),
    "diagonal": ([(8.86, 5.86)], (1.3, 1.3), (2, 2)),  # alone: no repulsion
}


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("direction", list(MIGRATIONS))
def test_migration(direction, path):
    """Walkers cross a column, a row or a corner of the tiles in the second
    step (the hybrid's first incremental one: its first step compacts) and
    arrive in the neighbour's, or the diagonal neighbour's, bins; none is
    lost, and the tiles equal the whole grid."""
    pos, vel, tile = MIGRATIONS[direction]
    maps, cfg, flat = _walkers(pos, [vel] * len(pos))
    d, metrics = _assert_tiled_equals_whole(maps, cfg, flat, tile, n_steps=2,
                                            **PATHS[path])
    assert [m["n_active"] for m in metrics] == [len(pos)] * 2
    assert all(m["n_overflow"] == m["n_dropped"] == 0 for m in metrics)
    rows = d.permute(0, 1, 3, 2).reshape(-1, 8)
    moved = rows[rows[:, 6] > 0.5][:, :2]
    crossed = {"columns": moved[:, 0] > 9.0, "rows": moved[:, 1] > 6.0,
               "diagonal": (moved[:, 0] > 9.0) & (moved[:, 1] > 6.0)}[direction]
    assert bool(crossed.all())


SPAWN_ON_EDGES = SCENARIO_NOSPAWN + """
[[waypoints]]
line = [[8.8, 1], [9.2, 11]]
[[waypoints]]
line = [[1, 5.9], [17, 6.1]]
[[pedestrians]]
origin = 2
destination = 1
spawn = { kind = "periodic", frequency = 20.0 }
[[pedestrians]]
origin = 3
destination = 0
spawn = { kind = "periodic", frequency = 20.0 }
"""


@pytest.mark.parametrize("path", list(PATHS))
def test_spawns_next_to_tile_edges(path):
    """Spawn lines along the column boundary (x = 9 m) and the row boundary
    (y = 6 m) of 2 x 2 tiles: candidates land in own cells and in ghost
    rings alike, and the tiles still equal the whole grid."""
    maps, cfg, flat = _port_setup(SPAWN_ON_EDGES, n=60)
    _, metrics = _assert_tiled_equals_whole(maps, cfg, flat, (2, 2), **PATHS[path])
    assert sum(m["n_spawned"] for m in metrics) >= 8


def test_tiled_matches_reference_tiled():
    """The reference's tiled step (1 x 2, tests/test_tile2d.py::_setup and
    its _run_tiled) and the port's, each step fed the reference's own
    spawn candidates: every metric equal each step, active sets within the
    reference test's band."""
    sc = loads_scenario(SCENARIO)
    maps = FieldMaps.from_field(Field.from_scenario(sc, unit=0.25))
    cfg = StepConfig.build(sc, capacity=512, neighbor_grid_unit=1.5, table_capacity=10)
    pmaps, pcfg, pflat = _port_setup()
    a = pflat.agents
    state = SimState(agents=AgentState(*(jnp.asarray(t.numpy()) for t in a)),
                     key=jax.random.PRNGKey(11), step=jnp.int32(0))
    tcfg = ref_tile2d.Tile2DConfig.build(cfg, 1, 2)
    mesh = ref_tile2d.make_mesh(tcfg)
    wp, obs = ref_tile2d.device_inputs_on_mesh(tcfg, mesh, maps)
    gs = ref_tile2d.make_sharded_grid_state(tcfg, mesh, state)
    step = jax.jit(ref_tile2d.make_sharded_step(tcfg, mesh))

    ptcfg = tile2d.Tile2DConfig.build(pcfg, 1, 2)
    devices = ["cpu", "cpu"]
    pwp, pobs = tile2d.device_inputs(ptcfg, pmaps, sfm_grid.stride_for(pcfg), devices)
    pts = tile2d.make_sharded_grid_state(ptcfg, pflat, devices)
    pstep = tile2d.make_sharded_step(ptcfg, devices, generator=torch.Generator())
    key = state.key
    for i in range(STEPS):
        key, k_spawn = jax.random.split(key)  # the reference step's draw
        c = _spawn_candidates(cfg, k_spawn)
        cand = convert.agents_from_numpy(*(np.asarray(x) for x in c), "cpu")
        gs, m = step(gs, wp, obs)
        jax.block_until_ready(gs)
        pts, pm = pstep(pts, pwp, pobs, cand)
        assert convert.metrics_to_dict(pm) == {n: int(v) for n, v in m._asdict().items()}, i
    want = _active_set(ref_tile2d.unbin_sharded(tcfg, gs).agents)
    got = _active_set(AgentState(*(np.asarray(t) for t in
                                   tile2d.unbin_sharded(ptcfg, pts).agents)))
    assert got.shape == want.shape and got.shape[0] > 100
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-2)


@pytest.mark.parametrize("tile", [(2, 2), (1, 3)], ids=lambda t: f"{t[0]}x{t[1]}")
def test_rebin_offsets_match_numpy_rebin(tile):
    """The rebin twins on each tile of tests/test_rebin.py's grid, cut as
    tile2d cuts it (rows and lanes with their one-cell ghost ring), with
    the tile's offsets: equal to _numpy_rebin of the tile with its
    positions shifted to the tile's origin, over the tile's own cells, and
    so to the whole grid's rebin there; both rebins' active sums count own
    lanes only."""
    ny, rl, cl = 8, 8 // tile[0], -(-RNX // tile[1])
    g = _make_grid(ny, seed=4)
    whole, _ = _numpy_rebin(g, RUNIT, RNX, ny)
    for r in range(tile[0]):
        for c in range(tile[1]):
            r0, c0 = r * rl, c * cl
            own = min(cl, RNX - c0)
            slab = np.zeros((rl + 2, RK, 8, RNXL), np.float32)
            lanes = min(RNXL, g.shape[3] - c0)
            slab[..., :lanes] = g[r0:r0 + rl + 2, ..., c0:c0 + lanes]
            slab[..., cl + 2:] = 0.0  # past the tile's ghost lane: padding
            got = rb.rebin(torch.from_numpy(slab), RUNIT, RNX, ny, 2,
                           row_offset=r0, col_offset=c0, nx_local=cl)
            shifted = slab.copy()
            shifted[:, :, 0] -= np.float32(c0 * RUNIT)
            shifted[:, :, 1] -= np.float32(r0 * RUNIT)
            want, demand = _numpy_rebin(shifted, RUNIT, own, rl)
            want[:, :, 0] += np.float32(c0 * RUNIT)
            want[:, :, 1] += np.float32(r0 * RUNIT)
            want[:, :, 0:2] *= want[:, :, 6:7]  # empty slots stay zero
            np.testing.assert_array_equal(got[0].numpy(), want)
            np.testing.assert_array_equal(
                got[0][1:-1, ..., 1:own + 1].numpy(),
                whole[1 + r0:1 + r0 + rl, ..., 1 + c0:1 + c0 + own])
            assert float(got[4].sum()) == float(np.minimum(demand, RK).sum())
            act = slab[1:-1, :, 6, 1:own + 1].sum()
            assert float(got[3].sum()) == float(act)
            # the incremental rebin with no movers keeps own-lane stayers
            gi = slab.copy()
            gi[:, :, 7] = gi[:, :, 6]  # everyone stays
            m = np.zeros((rl + 2, 2, 8, RNXL), np.float32)
            inc = rb.rebin_incremental(torch.from_numpy(gi), torch.from_numpy(m),
                                       RUNIT, RNX, ny, 2, row_offset=r0,
                                       col_offset=c0, nx_local=cl)
            kept = inc[0][:, :, 6].numpy()
            assert kept[:, :, own + 1:].sum() == 0 and kept[:, :, 0].sum() == 0
            assert float(inc[4].sum()) == float(act)


def test_tiled_simulator_evacuates_gap_like_one_device():
    """Simulator(n_devices=4, tile=(2, 2), device="cpu") runs gap.toml to
    evacuation; its metrics equal the one-device simulator's each step."""
    sc = pload_scenario(GAP)
    one = Simulator(SimulatorOptions(backend="grid", device="cpu", seed=1), sc)
    four = Simulator(SimulatorOptions(backend="grid", device="cpu", seed=1, n_devices=4,
                                      tile=(2, 2)), sc)
    assert four._kind.tcfg.n_devices == 4 and four.pedestrian_count == one.pedestrian_count
    for i in range(400):
        one.tick()
        four.tick()
        assert four.last_metrics == one.last_metrics, i
        if one.last_metrics.n_active == 0:
            break
    assert one.last_metrics.n_active == 0 and i > 100
    assert four.pedestrian_count == 0


def test_checkpoint_across_device_counts(tmp_path):
    """A checkpoint written by a 2-tile run restores onto 4-tile and 1-tile
    simulators (tests/test_grid_shard.py:111-137): the same step count and
    population, and the next three ticks' metrics equal — spawns included,
    since the generator's state rides in the file."""
    sc = ploads_scenario(SCENARIO)
    sim = Simulator(SimulatorOptions(backend="grid", device="cpu", seed=5, table_capacity=10,
                                     n_devices=2), sc)
    for _ in range(4):
        sim.tick()
    path = tmp_path / "ck.npz"
    checkpoint.save(sim, path)
    n0 = sim.pedestrian_count
    runs = {}
    for n_dev, tile in ((4, (2, 2)), (1, None)):
        sim2 = Simulator(SimulatorOptions(backend="grid", device="cpu", seed=99, table_capacity=10,
                                          n_devices=n_dev, tile=tile), sc)
        checkpoint.restore(sim2, path)
        assert sim2.step_count == sim.step_count and sim2.pedestrian_count == n0
        runs[n_dev] = []
        for _ in range(3):
            sim2.tick()
            runs[n_dev].append(sim2.last_metrics)
    assert runs[4] == runs[1]
    assert sum(m.n_spawned for m in runs[1]) > 0


def test_tiled_options_validated():
    sc = ploads_scenario(SCENARIO)
    with pytest.raises(ValueError, match="does not cover"):
        Simulator(SimulatorOptions(backend="grid", device="cpu", n_devices=4, tile=(1, 2)), sc)
    with pytest.raises(ValueError, match="rows >= 1"):
        tile2d.Tile2DConfig.build(_port_setup()[1], 0, 2)


def test_tiled_simulator_grows_like_one_device():
    """tick(), run() with its lagged guard, table growth and mover-table
    growth on 2 x 2 tiles (each re-bins through ``unbin_sharded``): the
    same growth at the same step as one device, the same metrics, the
    same agents."""
    sc = pload_scenario(GAP)  # 64 agents on one waypoint line: K 8 is short
    sims = [Simulator(SimulatorOptions(backend="grid", device="cpu", seed=2, table_capacity=8,
                                       mover_capacity=2, incremental_rebin=True,
                                       **kw), sc)
            for kw in ({}, {"n_devices": 4, "tile": (2, 2)})]
    for i in range(6):
        for sim in sims:
            sim.tick()
        assert sims[1].last_metrics == sims[0].last_metrics, i
    for sim in sims:
        sim.run(8, guard_every=2)
    assert sims[1].last_run_metrics == sims[0].last_run_metrics
    one, four = (sim.options for sim in sims)
    assert (four.table_capacity, four.mover_capacity) == (
        one.table_capacity, one.mover_capacity)
    assert one.table_capacity > 8 and one.mover_capacity > 2
    (p1, d1), (p4, d4) = (sim.list_pedestrians() for sim in sims)
    k1, k4 = np.lexsort(p1.T[::-1]), np.lexsort(p4.T[::-1])
    np.testing.assert_array_equal(p4[k4], p1[k1])
    np.testing.assert_array_equal(d4[k4], d1[k1])


def test_grid_shard_reexports_the_tiled_functions():
    """grid_shard re-exports tile2d's names as the reference's does
    (pedoni_tpu/parallel/grid_shard.py:23-32), the mesh names aside: the
    functions that take a transport across processes are tile2d's own."""
    from pedoni_tpu.parallel import grid_shard as ref_grid_shard

    mesh_only = {"AXIS", "make_mesh", "device_inputs_on_mesh"}
    names = [n for n, v in vars(ref_grid_shard).items()
             if getattr(v, "__module__", None) == "pedoni_tpu.parallel.tile2d"
             and n not in mesh_only]
    assert len(names) >= 5
    for name in names + ["device_inputs", "gather", "population", "exchange"]:
        assert getattr(grid_shard, name) is getattr(tile2d, name), name

