"""The port's pallas backend (pedoni_tpu_torch/models/sfm_pallas.py,
Simulator(backend="pallas")) against the reference's, on the CPU, where
the fused step kernel runs as its PyTorch twin:

- the pallas step against the reference's ``make_step_pallas`` (interpret
  mode off the TPU) on tests/test_pallas_backend.py's scenario, capacity
  256 and K 12: three steps from the reference's own state carried across,
  with its candidates injected, and one step from a state with a cell
  fuller than K; rows compared order-free (XLA's CPU division by the cell
  size can move an agent into the next cell, which reorders the sorted
  output), pos/vel within 1e-5, the rest and the four metrics equal;
- agents of an overflowed cell keep their input rows (the reference's
  freeze), with the reference's ``n_overflow``;
- the pallas step against the port's own flat step at the 1.5 m unit in
  all three modes (the all-pairs pallas step on the 2.0 m cells the
  Simulator resolves): with no overflow only the order of the pair sum
  differs;
- pair forces reach the kernel: a step with pairs inside the cutoff, in
  one cell and across cells, differs from the same step without them;
- gap.toml evacuates through ``Simulator(backend="pallas")`` in the band
  of the port's xla and grid runs;
- checkpoints cross pallas <-> xla <-> grid, and a reference pallas
  checkpoint restores into the port's pallas Simulator;
- the bench's pallas problem is the reference's, and ``build`` steps it;
- ``forcepass.build_layout`` is the one placement, and ``slots_of`` maps
  it to the slot grid;
- the card gate's near-contact rule: rsqrt and exp a few ulp off move only
  the velocities of agents in near contact past half its tolerance.
"""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pedoni_tpu import checkpoint as ref_ckpt
from pedoni_tpu import sim as ref_sim
from pedoni_tpu.field import Field, FieldMaps
from pedoni_tpu.models import sfm as R
from pedoni_tpu.models import sfm_pallas as RP
from pedoni_tpu.scenario import loads_scenario
from pedoni_tpu_torch import Simulator, SimulatorOptions, bench, convert
from pedoni_tpu_torch import checkpoint as port_ckpt
from pedoni_tpu_torch import field as pfield
from pedoni_tpu_torch import scenario as pscenario
from pedoni_tpu_torch.models import sfm as P
from pedoni_tpu_torch.models import sfm_pallas as PP
from pedoni_tpu_torch.physics import Physics

import bench as ref_bench
from test_grid_backend import SPAWN_SCENARIO
from test_pallas_backend import SCENARIO
from test_torch_flat import _port_rows, _ref_rows, _rows, _to_port

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
GAP = ROOT / "scenarios" / "gap.toml"
CAP, K = 256, 12  # tests/test_pallas_backend.py's shapes
N_CARRIED = 3  # steps carried across from the reference's state


def _random_state(size, n_active, seed, cap=CAP):
    """A seeded flat state: positions inside the field, unique speeds."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.8, np.array(size) - 0.8, (cap, 2)).astype(np.float32)
    vel = rng.normal(0, 0.3, (cap, 2)).astype(np.float32)
    speed = (1.0 + 0.001 * np.arange(cap)).astype(np.float32)
    dest = rng.integers(0, 2, cap).astype(np.int32)
    active = np.arange(cap) < n_active
    return pos, vel, speed, dest, active


def _crowded_state(seed=4):
    """A random state with 16 agents in one 1.5 m cell, K = 12: 4 overflow."""
    pos, vel, speed, dest, active = _random_state((24.0, 15.0), 120, seed)
    rng = np.random.default_rng(seed + 1)
    pos[120:136] = rng.uniform([9.1, 9.1], [10.4, 10.4], (16, 2))
    active[120:136] = True
    return pos, vel, speed, dest, active


@pytest.fixture(scope="module")
def reference_run():
    """The reference's pallas step (compiled once) on N_CARRIED steps
    carried across from a random state and one step from the crowded
    state: [(state before, candidates, state after, metrics)]."""
    sc = loads_scenario(SCENARIO)
    maps = FieldMaps.from_field(Field.from_scenario(sc, unit=0.25))
    cfg = R.StepConfig.build(sc, capacity=CAP, neighbor_grid_unit=1.5,
                             table_capacity=K)
    step = jax.jit(RP.make_step_pallas(cfg, maps))
    fwp, fobs = RP.pallas_device_inputs(cfg, maps)
    # jitted as inside the step, whose fused multiply-add draws the speeds
    draw = jax.jit(lambda key: R._spawn_candidates(cfg, jax.random.split(key)[1]))

    def ref_state(arrays, seed):
        return R.SimState(R.AgentState(*map(jnp.asarray, arrays)),
                          jax.random.PRNGKey(seed), jnp.int32(0))

    runs = []
    st = ref_state(_random_state(sc.size, 200, 3), 7)
    for _ in range(N_CARRIED):
        cand = draw(st.key)
        new, m = step(st, fwp, fobs)
        runs.append((st, cand, new, m))
        st = new
    st = ref_state(_crowded_state(), 9)
    runs.append((st, draw(st.key), *step(st, fwp, fobs)))
    psc = pscenario.loads_scenario(SCENARIO)
    pmaps = pfield.FieldMaps.from_field(pfield.Field.from_scenario(psc, unit=0.25))
    pcfg = P.StepConfig.build(psc, capacity=CAP, neighbor_grid_unit=1.5,
                              table_capacity=K)
    return runs, pcfg, PP.pallas_device_inputs(pcfg, pmaps, "cpu")


def _port_step(reference_run, i):
    runs, pcfg, (pfwp, pfobs) = reference_run
    st, cand, want_st, want_m = runs[i]
    step = PP.make_step_pallas(pcfg, generator=torch.Generator())
    pst, pm = step(_to_port(st), pfwp, pfobs, convert.agents_from_numpy(
        *(np.asarray(x) for x in cand), "cpu"))
    return pst, pm, want_st, want_m


def _assert_rows_match(pst, want_st):
    a, b = _ref_rows(want_st), _port_rows(pst)
    assert a.shape == b.shape
    np.testing.assert_allclose(b[:, :4], a[:, :4], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(b[:, 4:], a[:, 4:])
    return a.shape[0]


@pytest.mark.parametrize("i", range(N_CARRIED))
def test_pallas_step_matches_reference(reference_run, i):
    """Step i from the reference's state, its candidates injected: the four
    metrics equal, the others 0, the rows order-free within 1e-5."""
    pst, pm, want_st, want_m = _port_step(reference_run, i)
    want = {k: int(v) for k, v in want_m._asdict().items()}
    got = convert.metrics_to_dict(pm)
    assert {k: got[k] for k in want} == want
    assert got["max_demand"] == got["n_exited"] == got["max_mover_demand"] == 0
    assert pst.step == int(want_st.step)
    assert _assert_rows_match(pst, want_st) >= 150


def test_overflow_freezes_rows_as_the_reference(reference_run):
    """16 agents in one cell of K = 12: the 4 past K in the stable sort
    (the last by index) keep their input rows and stay active; the
    reference counts the same overflow and gives the same rows."""
    pst, pm, want_st, want_m = _port_step(reference_run, N_CARRIED)
    assert int(pm.n_overflow) == int(want_m.n_overflow) == 4
    assert int(pm.n_active) == int(want_m.n_active)
    _assert_rows_match(pst, want_st)
    pos, vel, speed, _dest, _active = _crowded_state()
    a = pst.agents
    for j in range(132, 136):  # the crowded cell's agents past K
        (row,) = torch.nonzero(a.speed == float(speed[j])).flatten().tolist()
        assert bool(a.active[row])
        np.testing.assert_array_equal(a.pos[row].numpy(), pos[j])
        np.testing.assert_array_equal(a.vel[row].numpy(), vel[j])


MODES = {"distance_map": {}, "segments": {"use_distance_map": False},
         "all_pairs": {"use_neighbor_grid": False}}


def _configs(mode, cap=384, k=16):
    """(flat StepConfig, pallas StepConfig) on the spawning test scenario
    at the 1.5 m unit; for all-pairs the pallas one on the unit and K that
    ``SimulatorOptions.resolved`` gives the kernel backends."""
    psc = pscenario.loads_scenario(SPAWN_SCENARIO)
    opts = SimulatorOptions(backend="pallas", neighbor_grid_unit=1.5,
                            table_capacity=k, **MODES[mode]).resolved()
    flat = P.StepConfig.build(psc, capacity=cap, neighbor_grid_unit=1.5,
                              table_capacity=k, **MODES[mode])
    pallas = P.StepConfig.build(psc, capacity=cap,
                                neighbor_grid_unit=opts.neighbor_grid_unit,
                                table_capacity=opts.table_capacity,
                                **MODES[mode])
    return psc, flat, pallas


@pytest.mark.parametrize("mode", list(MODES))
def test_pallas_step_matches_flat_step(mode):
    """One step of both from the same state and candidates: every metric
    equal (no cell overflows), the rows order-free within 1e-5."""
    psc, fcfg, pcfg = _configs(mode)
    if mode == "all_pairs":
        assert pcfg.grid.unit == 2.0 and pcfg.table_capacity == 29
    pmaps = pfield.FieldMaps.from_field(pfield.Field.from_scenario(psc, unit=0.25))
    st = P.SimState(convert.agents_from_numpy(
        *_random_state(psc.size, 300, 5, cap=fcfg.capacity), "cpu"), 0)
    cand = P.spawn_candidates(fcfg, torch.Generator().manual_seed(2))
    field, obstacles = P.device_inputs(fcfg, pmaps, "cpu")
    fst, fm = P.make_step(fcfg, torch.Generator())(st, field.rows, obstacles,
                                                   cand)
    fwp, fobs = PP.pallas_device_inputs(pcfg, pmaps, "cpu")
    pst, pm = PP.make_step_pallas(pcfg, generator=torch.Generator())(
        st, fwp, fobs, cand)
    assert convert.metrics_to_dict(pm) == convert.metrics_to_dict(fm)
    assert int(pm.n_overflow) == 0 and int(pm.n_spawned) > 0
    a, b = _port_rows(fst), _port_rows(pst)
    assert a.shape == b.shape and a.shape[0] > 250
    np.testing.assert_allclose(b[:, :4], a[:, :4], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(b[:, 4:], a[:, 4:])


def test_pair_forces_reach_the_kernel():
    """Pairs inside the cutoff, in one cell and across a cell boundary: the
    step's result differs from the same step with the pair strength at 0,
    for every agent of a pair (a count channel left at zero would make the
    kernel skip every candidate)."""
    psc = pscenario.loads_scenario(SCENARIO)
    pmaps = pfield.FieldMaps.from_field(pfield.Field.from_scenario(psc, unit=0.25))
    pos = np.array([[6.2, 6.2], [6.9, 6.4],  # one cell (1.5 m: cell 4, 4)
                    [7.4, 10.0], [7.6, 10.1]], np.float32)  # across x = 7.5
    n = len(pos)
    st = P.SimState(convert.agents_from_numpy(
        pos, np.zeros((n, 2)), 1.3 + 0.01 * np.arange(n), np.ones(n),
        np.ones(n, bool),
        "cpu"), 0)
    cand = P.spawn_candidates(P.StepConfig.build(psc, capacity=n),
                              torch.Generator().manual_seed(0))
    cand = cand._replace(active=torch.zeros_like(cand.active))
    out = {}
    for strength in (Physics().ped_strength, 0.0):
        cfg = P.StepConfig.build(psc, physics=dataclasses.replace(
            Physics(), ped_strength=strength), capacity=n, neighbor_grid_unit=1.5,
            table_capacity=K)
        fwp, fobs = PP.pallas_device_inputs(cfg, pmaps, "cpu")
        new, m = PP.make_step_pallas(cfg, generator=torch.Generator())(
            st, fwp, fobs, cand)
        assert int(m.n_active) == n
        out[strength] = _rows(*(t.numpy() for t in new.agents))
    moved = np.abs(out[Physics().ped_strength][:, 2:4] - out[0.0][:, 2:4]).max(axis=1)
    assert (moved > 1e-3).all(), moved


def test_gap_evacuates_in_the_band_of_the_other_backends():
    """gap.toml's 64 agents (seed 1) through the three backends' Simulators
    until the population reaches 0: the pallas run within 5% of the steps
    of the xla and the grid run (231 and 235 steps here)."""
    sc = pscenario.load_scenario(GAP)
    steps = {}
    for backend in ("pallas", "xla", "grid"):
        sim = Simulator(SimulatorOptions(backend=backend, device="cpu", seed=1), sc)
        assert sim.pedestrian_count == 64
        for i in range(400):
            if sim.tick().active_ped_count == 0:
                steps[backend] = i + 1
                break
        if backend == "pallas":
            assert sim.cfg.grid.unit == 1.5 and sim.measure_kernel_time() is None
            assert sim.new_log("gap").to_dict()["model"] == "sfm-torch/pallas"
    assert set(steps) == {"pallas", "xla", "grid"}, steps
    for other in ("xla", "grid"):
        assert abs(steps["pallas"] - steps[other]) <= 0.05 * steps[other], steps


def _sim(backend, **kw):
    return Simulator(SimulatorOptions(backend=backend, device="cpu", seed=3,
                                      table_capacity=24, **kw),
                     pscenario.loads_scenario(SPAWN_SCENARIO))


def _sim_rows(sim):
    a = convert.agents_to_numpy(sim.flat_state().agents)
    return _rows(a["pos"], a["vel"], a["speed"], a["dest"], a["active"])


@pytest.mark.parametrize("src,dst", [("pallas", "xla"), ("pallas", "grid"),
                                     ("xla", "pallas"), ("grid", "pallas")])
def test_checkpoint_crosses_backends(tmp_path, src, dst):
    """A checkpoint written on one backend restores on the other with its
    agents exact, and the restored simulator steps."""
    sim = _sim(src)
    for _ in range(4):
        sim.tick()
    path = tmp_path / f"{src}.npz"
    port_ckpt.save(sim, path)
    other = _sim(dst)
    port_ckpt.restore(other, path)
    assert other.step_count == 4
    np.testing.assert_array_equal(_sim_rows(other), _sim_rows(sim))
    assert other.tick().active_ped_count > 0


def test_reference_pallas_checkpoint_restores(tmp_path):
    """The reference's pallas Simulator (its step built, never run) with a
    random state, checkpointed by the reference, restores into the port's
    pallas Simulator with its agents exact."""
    sc = loads_scenario(SPAWN_SCENARIO)
    ref = ref_sim.Simulator(ref_sim.SimulatorOptions(backend="pallas",
                                                     capacity=512), sc)
    assert ref.cfg.grid.unit == 1.5
    arrays = _random_state(sc.size, 300, 8, cap=512)
    ref.state = R.SimState(R.AgentState(*map(jnp.asarray, arrays)),
                           jax.random.PRNGKey(1), jnp.int32(12))
    ref.step_count = 12
    path = tmp_path / "ref_pallas.npz"
    ref_ckpt.save(ref, path)
    sim = _sim("pallas")
    port_ckpt.restore(sim, path)
    assert sim.step_count == 12 and sim.state.step == 12
    np.testing.assert_array_equal(_sim_rows(sim), _rows(*arrays))


def test_bench_pallas_problem_is_the_reference_and_steps():
    """``build_problem(backend="pallas")`` is the reference's pallas problem
    (the square field at 1.5 m, the same draw); ``build`` steps it with the
    pallas step on the CPU, every agent kept (agents past K = 14 in their
    cells frozen and counted)."""
    sc, _maps, cfg, st = ref_bench.build_problem(2000, 2.5, 0, "pallas", 14, 16384)
    psc, _pmaps, pcfg, pst = bench.build_problem(2000, device="cpu",
                                                 backend="pallas")
    assert psc.size == sc.size and psc.size[0] == psc.size[1]
    assert ((pcfg.grid.nx, pcfg.grid.ny, pcfg.grid.unit, pcfg.capacity)
            == (cfg.grid.nx, cfg.grid.ny, 1.5, cfg.capacity))
    for name in ("pos", "speed", "active"):
        np.testing.assert_array_equal(getattr(pst.agents, name).numpy(),
                                      np.asarray(getattr(st.agents, name)))
    args = bench.build_parser().parse_args(["--backend", "pallas", "--agents",
                                            "2000"])
    step, state, bcfg = bench.build(args, torch.device("cpu"))
    assert bcfg.grid.unit == 1.5 and state.agents.pos.shape == (2048, 2)
    state, m = step(state)
    assert int(m.n_active) == 2000 and 0 < int(m.n_overflow) < 20
    assert bool(torch.isfinite(state.agents.pos).all())


def test_pallas_options_as_the_reference():
    """``pallas`` resolves 1.4 m to 1.5 m as the grid does, refuses tiles with
    the reference's message, a scenario without waypoints with its
    "use backend='xla'", and a step that does not fit the free memory
    before any tensor exists."""
    assert SimulatorOptions(backend="pallas").resolved().neighbor_grid_unit == 1.5
    with pytest.raises(ValueError, match="requires the grid backend"):
        Simulator(SimulatorOptions(backend="pallas", device="cpu", n_devices=2),
                  pscenario.load_scenario(GAP))
    bare = pscenario.loads_scenario(SPAWN_SCENARIO.split("[[waypoints]]")[0])
    with pytest.raises(ValueError, match="use backend='xla'"):
        Simulator(SimulatorOptions(backend="pallas", device="cpu"), bare)
    cfg = _sim("pallas").cfg
    need = PP.device_bytes(cfg)
    assert PP.supports(cfg, free_bytes=need)
    assert not PP.supports(cfg, free_bytes=need - 1)
    from pedoni_tpu_torch.models import sfm_grid
    with pytest.raises(ValueError, match="the pallas step needs"):
        sfm_grid.check_fits(need, "cpu", free_bytes=need - 1,
                            what="the pallas step")


@pytest.mark.parametrize("k", [1, 4, 12])
def test_slots_are_build_layouts(k):
    """``forcepass.build_layout`` is the one placement of flat agents, in
    the flat step's padded (ny+2, nx+2, K) grid and, through ``slots_of``,
    in the pallas step's slot grid [ny_pad+2, K, 8, NXL]: on sorted ids
    with runs longer than K and the sentinel tail, each agent's rank is
    its index less its cell's first index (NumPy), an agent past K or out
    of the grid gets the grid's size, and the overflow counts those past
    K."""
    from pedoni_tpu_torch.models.sfm_grid import GridDims
    from pedoni_tpu_torch.ops import forcepass
    from pedoni_tpu_torch.ops.neighbor import CellGrid

    grid = CellGrid(unit=1.5, nx=7, ny=5)
    dims = GridDims(ny_pad=6, nxl=128, k=k, rb=2)
    rng = np.random.default_rng(k)
    cid = np.sort(np.concatenate([rng.integers(0, grid.n_cells, 300),
                                  np.full(40, grid.n_cells)]))
    rank = np.arange(cid.size) - np.searchsorted(cid, cid, side="left")
    ok = (cid < grid.n_cells) & (rank < k)
    cy, cx = cid // grid.nx, cid % grid.nx
    lanes = 8 * dims.nxl
    want = {
        "flat": np.where(ok, ((cy + 1) * (grid.nx + 2) + cx + 1) * k + rank,
                         (grid.ny + 2) * (grid.nx + 2) * k),
        "pallas": np.where(ok, ((cy + 1) * k + rank) * lanes + cx + 1,
                           (dims.ny_pad + 2) * k * lanes)}
    cid_t = torch.from_numpy(cid.astype(np.int32))
    in_grid = cid_t < grid.n_cells
    got = {"flat": forcepass.build_layout(cid_t, in_grid, grid, k),
           "pallas": PP.slots_of(cid_t, in_grid, grid, dims)}
    for name, lay in got.items():
        np.testing.assert_array_equal(lay.slot.numpy(), want[name], err_msg=name)
        np.testing.assert_array_equal(lay.valid.numpy(), ok, err_msg=name)
        assert int(lay.n_overflow) == int(((cid < grid.n_cells) & ~ok).sum()) > 0


def test_near_contact_bounds_the_card_gate(monkeypatch):
    """Why the card gate of the pallas step (test_torch_cuda.py) holds
    velocities to 1e-5 except in near contact: on its state and candidates,
    rsqrt and exp 2-4 ulp off (CUDA's rsqrtf and expf are within 2 ulp of
    the correctly rounded result) move the velocity of no agent at least
    NEAR_CONTACT from its nearest neighbour by half that tolerance, and
    move the pair in near contact by more than it."""
    from test_torch_cuda import NEAR_CONTACT, PALLAS_SCENARIO, _near_contact

    sc = pscenario.loads_scenario(PALLAS_SCENARIO)
    maps = pfield.FieldMaps.from_field(pfield.Field.from_scenario(sc, unit=0.25))
    cfg = P.StepConfig.build(sc, capacity=640, neighbor_grid_unit=1.5,
                             table_capacity=12)
    rng = np.random.default_rng(6)
    n = 640
    st = P.SimState(convert.agents_from_numpy(
        rng.uniform(0.8, 11.2, (n, 2)) * np.array([1.5, 1.0]),
        rng.normal(0, 0.4, (n, 2)), rng.uniform(0.8, 1.7, n),
        rng.integers(0, 2, n), np.arange(n) < 500, "cpu"), 0)
    gen = torch.Generator().manual_seed(3)
    fwp, fobs = PP.pallas_device_inputs(cfg, maps, "cpu")
    step = PP.make_step_pallas(cfg, generator=torch.Generator())
    rsqrt, exp = torch.rsqrt, torch.exp
    far = near = 0.0
    for _ in range(3):
        cand = P.spawn_candidates(cfg, gen)
        new, _m = step(st, fwp, fobs, cand)
        with monkeypatch.context() as mp:
            mp.setattr(torch, "rsqrt", lambda x: rsqrt(x) * (1 + 2 ** -22))
            mp.setattr(torch, "exp", lambda x: exp(x) * (1 - 2 ** -22))
            off, _m = step(st, fwp, fobs, cand)
        dv = (new.agents.vel - off.agents.vel).abs().amax(1).numpy()
        is_near = _near_contact(st.agents, cand, new.agents.speed.numpy())
        far = max(far, float(dv[~is_near].max()))
        near = max(near, float(dv[is_near].max(initial=0.0)))
        st = new
    assert 0 < far <= 5e-6 and near > 1e-5, (far, near, NEAR_CONTACT)
