"""The port's x-strip step (pedoni_tpu_torch/parallel/spatial.py) on the
CPU, held against the reference's (pedoni_tpu/parallel/spatial.py) on the
8-device CPU mesh, with tests/test_parallel.py's scenario, capacity 1024,
chunk 256, K 12 and packages of 128 (the reference's compiles are that
file's):

- at 1, 2 and 8 strips, five steps, each from the reference's sharded
  state carried across (``convert``) and fed the candidates the
  reference's step draws: every StepMetrics field equal, and each strip's
  active rows equal order-free, speed and destination exactly, pos/vel
  within 1e-5.  The reference's pair formula takes the difference of two
  nearly equal squares where a neighbour lies almost on an agent's path
  (b^2 = t2^2 - (|v| dt)^2), so f32 rounding moves a few velocities by up
  to ~1e-4; there the port's flat step (models/sfm.py::make_step, held to
  the reference since it was ported) misses the reference's flat step by
  the same amount.  So every row is held to 1e-5 of the reference, or, in
  the rows where the port's flat step from the same input is itself
  farther than 1e-5 from the reference, to that flat step's own error
  plus 1e-5; and every row within 1e-5 of the port's flat step;
- the same for ten steps of 2 strips, at 2 m cells and K 3, where cells
  overflow in every step and the reference's windows lie on the global
  cell grid, and at 1.4 m and K 12, where no cell overflows;
- fifteen chained steps of the strips against the port's own flat step:
  ``n_active`` equal, positions within 2e-2 (the reference's
  ``test_sharded_matches_single``);
- packages of 2 saturate, and no agent is lost (tests/test_parallel.py::
  test_package_saturation_defers_not_destroys);
- ``shard_state`` of the reference's flat initial agents equals the
  reference's ``make_sharded_initial_state`` bit for bit, with its drop and
  warning when a strip is full;
- ``dryrun(4, device="cpu")``, and the package's exports.
"""

import logging

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pedoni_tpu import parallel as ref_parallel
from pedoni_tpu.field import Field, FieldMaps
from pedoni_tpu.models import sfm as R
from pedoni_tpu.parallel import spatial as RS
from pedoni_tpu.scenario import loads_scenario
from pedoni_tpu_torch import convert
from pedoni_tpu_torch import field as pfield
from pedoni_tpu_torch import parallel as port_parallel
from pedoni_tpu_torch import scenario as pscenario
from pedoni_tpu_torch.models import sfm as P
from pedoni_tpu_torch.parallel import spatial as PS

from test_parallel import SCENARIO

torch.set_num_threads(1)

CAP = 1024
PACKAGE = 128
TOL = 1e-5


def _configs(src=SCENARIO, capacity=CAP, **kw):
    sc, psc = loads_scenario(src), pscenario.loads_scenario(src)
    maps = FieldMaps.from_field(Field.from_scenario(sc, unit=0.25))
    pmaps = pfield.FieldMaps.from_field(pfield.Field.from_scenario(psc, unit=0.25))
    kw = {"capacity": capacity, "table_capacity": 12, **kw}
    return (maps, R.StepConfig.build(sc, **kw), pmaps,
            P.StepConfig.build(psc, **kw))


def _shards(agents, n_strips) -> PS.ShardedState:
    """The reference's global sharded arrays as the port's per-strip shards."""
    arrs = [np.asarray(x) for x in agents]
    cl = arrs[0].shape[0] // n_strips
    return PS.ShardedState(tuple(
        convert.agents_from_numpy(*(x[d * cl:(d + 1) * cl] for x in arrs), "cpu")
        for d in range(n_strips)), 0)


def _rows(a) -> np.ndarray:
    """Active agents as rows (pos, vel, speed, dest), sorted by speed (drawn
    per agent, unique here) then position."""
    a = {k: np.asarray(v) for k, v in a._asdict().items()}
    r = np.concatenate([a["pos"], a["vel"], a["speed"][:, None],
                        a["dest"][:, None]], 1).astype(np.float64)[a["active"]]
    return r[np.lexsort((r[:, 1], r[:, 0], r[:, 4]))]


def _cat(shards) -> P.AgentState:
    return P.AgentState(*(torch.cat(x) for x in zip(*shards)))


def _match_reference(n_strips, n_steps, **kw):
    """``n_steps`` steps of the port's strips against the reference's, each
    from the reference's sharded state carried across (module docstring);
    the StepConfig keywords ``kw`` beside chunk 256.  Returns (the last
    step's metrics, the cells' overflow count of each step, the agents
    spawned, the largest speed along an axis)."""
    maps, cfg, pmaps, pcfg = _configs(chunk_size=256, **kw)
    mesh = Mesh(np.array(jax.devices()[:n_strips]), ("x",))
    scfg = RS.ShardedConfig.build(cfg, n_strips, package_capacity=PACKAGE)
    step = jax.jit(RS.make_sharded_step(scfg, maps, mesh))
    state = RS.make_sharded_initial_state(scfg, mesh, seed=0)
    dfield, obstacles = R.device_inputs(cfg, maps)
    devices = ["cpu"] * n_strips
    pscfg = PS.ShardedConfig.build(pcfg, n_strips, package_capacity=PACKAGE)
    pstep = PS.make_sharded_step(pscfg, devices, torch.Generator())
    prows, pobs = PS.device_inputs(pscfg, pmaps, devices)
    flat = P.make_step(pcfg, torch.Generator())
    ffield, fobs = P.device_inputs(pcfg, pmaps, "cpu")
    # jitted as in the step, whose fused multiply-add draws the speeds
    draw = jax.jit(lambda key: R._spawn_candidates(cfg, jax.random.split(key)[1]))
    overflow, spawned, moved = [], 0, 0.0
    for i in range(n_steps):
        cand = convert.agents_from_numpy(*(np.asarray(x) for x in draw(state.key)),
                                         "cpu")
        ps = _shards(state.agents, n_strips)
        fs = P.SimState(_cat(ps.agents), 0)
        state, m = step(state, dfield.rows, obstacles)
        jax.block_until_ready(state)
        ps, pm = pstep(ps, prows, pobs, cand)
        fs, _ = flat(fs, ffield.rows, fobs, cand)
        want = {k: int(v) for k, v in m._asdict().items()}
        assert convert.metrics_to_dict(pm) == want, i
        ref = _shards(state.agents, n_strips)
        got_all, ref_all, flat_all = (_rows(_cat(ps.agents)), _rows(_cat(ref.agents)),
                                      _rows(fs.agents))
        assert got_all.shape == ref_all.shape == flat_all.shape
        np.testing.assert_array_equal(flat_all[:, 4:], ref_all[:, 4:])
        assert np.abs(got_all[:, :4] - flat_all[:, :4]).max() <= TOL, i
        flat_err = np.abs(flat_all[:, :4] - ref_all[:, :4]).max(1)
        for d in range(n_strips):
            got, want_rows = _rows(ps.agents[d]), _rows(ref.agents[d])
            assert got.shape == want_rows.shape, (i, d)
            np.testing.assert_array_equal(got[:, 4:], want_rows[:, 4:])
            err = np.abs(got[:, :4] - want_rows[:, :4]).max(1)
            at = np.searchsorted(ref_all[:, 4], want_rows[:, 4])  # speeds unique
            bound = np.where(flat_err[at] > TOL, flat_err[at] + TOL, TOL)
            assert (err <= bound).all(), (i, d, err.max(), bound[err.argmax()])
        overflow.append(want["n_overflow"])
        spawned += want["n_spawned"]
        moved = max(moved, float(np.abs(got_all[:, 2:4]).max()))
    return pm, overflow, spawned, moved


@pytest.mark.parametrize("n_strips", [1, 2, 8])
def test_strips_match_reference(n_strips):
    pm, _, spawned, moved = _match_reference(n_strips, 5)
    assert spawned > 0 and moved > 1.0 and int(pm.n_active) > 40


@pytest.mark.parametrize("kw, overflows", [
    ({"neighbor_grid_unit": 2.0, "table_capacity": 3}, True),
    ({}, False)], ids=["cells_overflow", "no_cell_overflows"])
def test_strips_match_reference_for_ten_steps(kw, overflows):
    """Ten steps of 2 strips against the reference's, each held as in
    ``test_strips_match_reference``: at 2 m cells and K 3, where cells
    overflow in every step (a 16 m strip is 8 cells, so the reference's
    windows, which start at the strip edge less the margin, lie on the
    global cell grid as the port's do, and both fill a cell past K from
    the same agents), and at the fixture's 1.4 m and K 12, where no cell
    overflows.  The port's strips equal the reference's and the port's
    flat step in every step, overflow or not."""
    pm, overflow, spawned, _ = _match_reference(2, 10, **kw)
    assert spawned > 0 and int(pm.n_active) > 40
    assert all(overflow) if overflows else not any(overflow), overflow


@pytest.mark.parametrize("n_strips", [2, 8])
def test_strips_match_the_flat_step(n_strips):
    """Fifteen chained steps from one initial state and the same drawn
    candidates: strips and the flat step keep the same population and
    positions within the reference's own band."""
    _, _, pmaps, pcfg = _configs(chunk_size=256)
    gen = torch.Generator().manual_seed(4)
    init = P.make_initial_state(pcfg, gen, "cpu")
    cands = [P.spawn_candidates(pcfg, gen) for _ in range(15)]
    devices = ["cpu"] * n_strips
    pscfg = PS.ShardedConfig.build(pcfg, n_strips, package_capacity=PACKAGE)
    pstep = PS.make_sharded_step(pscfg, devices, torch.Generator())
    prows, pobs = PS.device_inputs(pscfg, pmaps, devices)
    ps = PS.shard_state(pscfg, init, devices)
    flat = P.make_step(pcfg, torch.Generator())
    ffield, fobs = P.device_inputs(pcfg, pmaps, "cpu")
    fs = init
    for cand in cands:
        ps, pm = pstep(ps, prows, pobs, cand)
        fs, fm = flat(fs, ffield.rows, fobs, cand)
        assert int(pm.n_active) == int(fm.n_active)
    got, want = _rows(_cat(ps.agents)), _rows(fs.agents)
    assert got.shape == want.shape and got.shape[0] > 50
    np.testing.assert_allclose(got[:, :2], want[:, :2], atol=2e-2)


def test_package_saturation_defers_not_destroys():
    """Eight agents in strip 0 at its x = 4 m edge, walking right, and
    packages of 2: the shortfall shows in ``n_overflow``, no agent is ever
    lost, and all eight end in strips 1 and up."""
    src = SCENARIO.split("[[obstacles]]")[0]
    _, _, pmaps, pcfg = _configs(src, capacity=256)
    pscfg = PS.ShardedConfig.build(pcfg, 8, package_capacity=2)
    devices = ["cpu"] * 8
    n = 8
    pos = np.zeros((256, 2), np.float32)
    vel = np.zeros((256, 2), np.float32)
    pos[:n] = [(3.9, 2.0 + 1.5 * i) for i in range(n)]
    vel[:n] = (1.0, 0.0)
    agents = convert.agents_from_numpy(pos, vel, np.full(256, 1.34), np.ones(256),
                                       np.arange(256) < n, "cpu")
    ps = PS.ShardedState(_shards(agents, 8).agents, 0)
    pstep = PS.make_sharded_step(pscfg, devices)
    prows, pobs = PS.device_inputs(pscfg, pmaps, devices)
    saw_saturation = False
    for _ in range(10):
        ps, pm = pstep(ps, prows, pobs)
        assert int(pm.n_active) == n
        saw_saturation |= int(pm.n_overflow) > 0
    assert saw_saturation
    assert not bool(ps.agents[0].active.any())
    a = _cat(ps.agents)
    assert int(a.active.sum()) == n and bool((a.pos[a.active, 0] >= 4.0).all())


def test_an_edge_crosser_leaves_its_old_strip_as_in_the_reference():
    """Why strips drift from the flat step: an agent that crosses a strip's
    edge is shipped to its new strip and leaves its old one for that step
    (it is not sent back as a ghost), so agents it leaves behind within the
    cutoff miss its pair force for that step.  A walks 0.8 m behind B in
    strip 0; B has crossed the 16 m edge.  After one step of 2 strips, B's
    velocity is the flat step's (its new strip gets A as a ghost), A's
    misses B's push, and both equal the reference's strips'."""
    src = SCENARIO.split("[[obstacles]]")[0]
    maps, cfg, pmaps, pcfg = _configs(src, capacity=256)
    pos = np.zeros((256, 2), np.float32)
    vel = np.zeros((256, 2), np.float32)
    pos[:2] = [(15.5, 8.0), (16.3, 8.0)]
    vel[:2] = (1.0, 0.0)
    arrays = (pos, vel, np.full(256, 1.34, np.float32), np.ones(256, np.int32),
              np.arange(256) < 2)
    mesh = Mesh(np.array(jax.devices()[:2]), ("x",))
    scfg = RS.ShardedConfig.build(cfg, 2, package_capacity=PACKAGE)
    sharding = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("x"))
    ref0 = RS.make_sharded_initial_state(scfg, mesh, seed=0)
    ref0 = ref0._replace(agents=R.AgentState(*(jax.device_put(x, sharding)
                                               for x in arrays)))
    dfield, obstacles = R.device_inputs(cfg, maps)
    ref1, _ = jax.jit(RS.make_sharded_step(scfg, maps, mesh))(ref0, dfield.rows,
                                                               obstacles)
    devices = ["cpu"] * 2
    pscfg = PS.ShardedConfig.build(pcfg, 2, package_capacity=PACKAGE)
    ps, _ = PS.make_sharded_step(pscfg, devices)(
        _shards(R.AgentState(*arrays), 2), *PS.device_inputs(pscfg, pmaps, devices))
    flat_in = P.SimState(convert.agents_from_numpy(*arrays, "cpu"), 0)
    ffield, fobs = P.device_inputs(pcfg, pmaps, "cpu")
    fs, _ = P.make_step(pcfg)(flat_in, ffield.rows, fobs)
    got, ref, flat = _rows(_cat(ps.agents)), _rows(_cat(_shards(ref1.agents, 2).agents)), \
        _rows(fs.agents)
    assert got.shape == ref.shape == flat.shape == (2, 6)
    a, b = np.argsort(got[:, 0])  # A behind B
    np.testing.assert_allclose(got[:, :4], ref[:, :4], atol=TOL)
    np.testing.assert_allclose(got[b, :4], flat[b, :4], atol=TOL)
    assert np.abs(got[a, 2:4] - flat[a, 2:4]).max() > 100 * TOL


@pytest.mark.parametrize("capacity", [CAP, 64], ids=["fits", "strip_full"])
def test_shard_state_matches_reference(capacity, caplog):
    """The reference's flat initial agents (seed 2) re-homed by both: the
    port's shards equal the reference's bit for bit; at capacity 64 the 48
    agents of the last strip overfill its 8 slots and both drop 40 with
    the warning."""
    maps, cfg, _, pcfg = _configs(capacity=capacity)
    mesh = Mesh(np.array(jax.devices()[:8]), ("x",))
    scfg = RS.ShardedConfig.build(cfg, 8, package_capacity=PACKAGE)
    with caplog.at_level(logging.WARNING):
        want = RS.make_sharded_initial_state(scfg, mesh, seed=2)
    ref_warned = "dropped 40 agents" in caplog.text
    caplog.clear()
    flat = R.make_initial_state(cfg, seed=2)
    pscfg = PS.ShardedConfig.build(pcfg, 8, package_capacity=PACKAGE)
    with caplog.at_level(logging.WARNING, logger="pedoni_tpu_torch"):
        got = PS.shard_state(pscfg, P.SimState(convert.agents_from_numpy(
            *(np.asarray(x) for x in flat.agents), "cpu"), 0), ["cpu"] * 8)
    assert ("dropped 40 agents" in caplog.text) == ref_warned == (capacity == 64)
    cl = scfg.local_capacity
    for name in P.AgentState._fields:
        ref = np.asarray(getattr(want.agents, name))
        for d, shard in enumerate(got.agents):
            np.testing.assert_array_equal(getattr(shard, name).numpy(),
                                          ref[d * cl:(d + 1) * cl], err_msg=name)
    assert int(sum(int(a.active.sum()) for a in got.agents)) == (48 if capacity == CAP else 8)


def test_dryrun_and_exports(capsys):
    assert port_parallel.__all__ == ref_parallel.__all__
    port_parallel.dryrun(4, device="cpu")
    assert "spatial dryrun: 4 strips, 3 steps" in capsys.readouterr().out


@pytest.mark.parametrize("n_strips", [2, 4])
def test_strips_off_the_cell_grid_equal_the_flat_step(n_strips):
    """The bench's xla problem at 3000 agents (a 34.6 m square of 1.4 m
    cells, agents everywhere): strip edges at 17.3 m (8.7, 17.3, 26.0 m) fall
    inside cells.  One step of the strips equals the flat step from the
    same state, every metric and each row within 1e-5, because each strip's
    window starts on a global cell edge (``ShardedConfig.origin_cell``).
    The reference starts it at the strip edge less the margin, so its 3x3
    windows hold other neighbours: its strips miss its own flat step by far
    more (shown at 2 strips).  K 16, so that no cell overflows: where one
    does, which of its agents lose their pair forces depends on the order
    within the cell, and a ghost cell's overflow counts in both strips (as
    in the reference)."""
    from pedoni_tpu_torch import bench

    _sc, pmaps, pcfg, flat = bench.build_problem(3000, seed=1, table_capacity=16,
                                                 device="cpu", backend="xla")
    devices = ["cpu"] * n_strips
    pscfg = PS.ShardedConfig.build(pcfg, n_strips)
    prows, pobs = PS.device_inputs(pscfg, pmaps, devices)
    ps, pm = PS.make_sharded_step(pscfg, devices)(
        PS.shard_state(pscfg, flat, devices), prows, pobs)
    ffield, fobs = P.device_inputs(pcfg, pmaps, "cpu")
    fs, fm = P.make_step(pcfg)(flat, ffield.rows, fobs)
    assert convert.metrics_to_dict(pm) == convert.metrics_to_dict(fm)
    got, want = _rows(_cat(ps.agents)), _rows(fs.agents)
    assert got.shape == want.shape == (3000, 6)
    assert np.abs(got[:, :4] - want[:, :4]).max() <= TOL
    if n_strips != 2:
        return
    import bench as ref_bench

    _, maps, cfg, state = ref_bench.build_problem(3000, 2.5, 1, "xla", 16, 2048)
    mesh = Mesh(np.array(jax.devices()[:2]), ("x",))
    scfg = RS.ShardedConfig.build(cfg, 2)
    dfield, obstacles = R.device_inputs(cfg, maps)
    rs, _ = jax.jit(RS.make_sharded_step(scfg, maps, mesh))(state, dfield.rows,
                                                            obstacles)
    rf, _ = jax.jit(R.make_step(cfg, maps))(state, dfield.rows, obstacles)
    ref_err = np.abs(_rows(rs.agents)[:, :4] - _rows(rf.agents)[:, :4]).max()
    assert ref_err > 1e-3, ref_err
