"""The port's hybrid rebin path vs the reference, on the CPU twins:

(a) ``rebin_incremental_torch`` against the reference
    ``rebin_incremental(..., interpret=True, emit_counts=True)`` on the
    (G, M) pairs of tests/test_rebin_incremental.py: all five outputs
    exactly equal;
(b) the port's hybrid ``make_step_grid`` against the reference's
    (mover_k=4, compact_every=5), 8 steps of tests/test_rebin_incremental.py's
    spawning scenario fed the reference's own spawn candidates: every
    StepMetrics field equal each step, active sets within 2e-5 / 1e-5.
    The port's mover_k=1 run, which falls back to the full rebin on most
    steps, is held against the same reference trajectory: every metric is
    independent of the rebin taken (the reference's own
    test_step_incremental_matches_full_with_spawns shows it), and
    max_mover_demand is the unclamped peak, independent of mover_k;
(c) ``Simulator``: the auto rule picks what the reference picks, mover
    tables grow, and the gated wrappers run exactly the selected rebin.
The step kernel's mover emit is held against the reference in
tests/test_torch_step_kernel.py; the CUDA kernels against these twins on
the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import functools
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pedoni_tpu.models import sfm_grid as ref_grid
from pedoni_tpu.models.sfm import _spawn_candidates
from pedoni_tpu.ops.pallas.rebin import rebin_incremental as ref_rebin_incremental
from pedoni_tpu.scenario import load_scenario as ref_load_scenario
from pedoni_tpu.scenario import loads_scenario as ref_loads_scenario
from pedoni_tpu.sim import Simulator as RefSimulator
from pedoni_tpu.sim import SimulatorOptions as RefOptions
from pedoni_tpu_torch import convert
from pedoni_tpu_torch.field import Field as PField, FieldMaps as PFieldMaps
from pedoni_tpu_torch.models import sfm_grid as port_grid
from pedoni_tpu_torch.models.sfm import SimState as PSimState
from pedoni_tpu_torch.models.sfm import StepConfig as PStepConfig
from pedoni_tpu_torch.ops.kernels import rebin as port_rebin
from pedoni_tpu_torch.scenario import load_scenario, loads_scenario
from pedoni_tpu_torch.sim import Simulator, SimulatorOptions
from pedoni_tpu_torch.utils import trace

from test_rebin import K, NX, NXL, UNIT, _make_grid, _numpy_rebin
from test_rebin_incremental import SCENARIO, _active_cells, _setup, _split_stay_movers
from test_torch_rebin_cases import CASES, rebin_case

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCENARIOS = {w: ROOT / "scenarios" / f"{w}.toml" for w in ("gap", "corridor")}


@pytest.mark.parametrize("grid", ["seed3", "overflow"])
def test_rebin_incremental_twin_matches_pallas(grid):
    if grid == "seed3":
        ny, g0, mk = 8, _make_grid(8, seed=3), 6
    else:  # dense: more landers than holes (test_rebin_incremental.py:112)
        ny, g0, mk = 6, _make_grid(6, seed=5, n_per_cell=K, jitter=1.2), K
    gi, m = _split_stay_movers(g0, mk=mk)
    want = [np.asarray(a) for a in ref_rebin_incremental(
        jnp.asarray(gi), jnp.asarray(m), UNIT, NX, ny, row_block=2,
        interpret=True, emit_counts=True)]
    got = [t.numpy() for t in port_rebin.rebin_incremental(
        torch.from_numpy(gi), torch.from_numpy(m), UNIT, NX, ny, row_block=2)]
    for w, o in zip(want, got):
        np.testing.assert_array_equal(o, w)
    assert (got[0][:, :, 6] > 0.5).sum() > 50
    if grid == "overflow":
        assert got[1].sum() > 0  # landers genuinely dropped


# Where the reference, run on the CPU, is no referee: it places landers by
# multiplying with a one-hot mask, so a NaN or inf position in M spreads
# over its outputs (the step kernel never emits one: it sanitizes to 2^30),
# and XLA's CPU division by the constant cell size differs from the IEEE
# quotient one float below some cell boundaries.  There the twin is held to
# the NumPy full rebin's per-cell membership, which no overflow disturbs.
NOT_THE_REFERENCE = ("nan_inf", "below_boundary")


@pytest.mark.parametrize("case", CASES)
def test_rebin_incremental_twin_tile_edge_cases(case):
    """The grids built to break a tiled, bit-mask rebin (MK = 1 and MK = K,
    K = 1, K past 64, more movers than holes, exact cell boundaries, the
    2^30 sentinel, the edge lanes, padding rows, odd row counts): the twin
    equals the reference's rebin_incremental bit for bit on all five
    outputs."""
    c = rebin_case(case)
    args = (c["unit"], c["nx"], c["ny"])
    got = [t.numpy() for t in port_rebin.rebin_incremental(
        torch.from_numpy(c["gi"]), torch.from_numpy(c["m"]), *args,
        row_block=c["rb"])]
    assert got[4].sum() > 0
    if case in NOT_THE_REFERENCE:
        with np.errstate(invalid="ignore", over="ignore"):
            want, demand = _numpy_rebin(c["g"], *args)
        assert demand.max() <= c["k"] and got[1].sum() == 0
        assert _active_cells(got[0]) == _active_cells(want)
        assert got[2].max() == demand.max() and got[4].sum() == demand.sum()
        return
    want = [np.asarray(a) for a in ref_rebin_incremental(
        jnp.asarray(c["gi"]), jnp.asarray(c["m"]), *args, row_block=c["rb"],
        interpret=True, emit_counts=True)]
    for w, o in zip(want, got):
        np.testing.assert_array_equal(o, w)
    if case in ("nine_neighbours_overflow", "full_cell_takes_no_mover"):
        assert got[1].sum() > 0  # more movers than holes


def test_rebin_incremental_twin_lands_rows_past_the_count():
    """A hand-made M whose rows past a cell's count (ch 7) still hold a
    mover (ch 6 set): the twin lands every such row, as the reference does,
    so its per-cell membership is the NumPy full rebin's; the CUDA kernel is
    held to the twin on the same M on the card."""
    ny = 8
    g0 = _make_grid(ny, seed=3)
    gi, m = _split_stay_movers(g0, mk=K)
    held = m[:, :, 6] > 0.5
    m[:, :, 7] = np.maximum(m[:, :, 7] - 1.0, 0.0)  # one row past the count
    past = held & (np.arange(K)[None, :, None] >= m[:, :, 7])
    assert past.sum() > 20
    got = [t.numpy() for t in port_rebin.rebin_incremental(
        torch.from_numpy(gi), torch.from_numpy(m), UNIT, NX, ny)]
    want, demand = _numpy_rebin(g0, UNIT, NX, ny)
    assert demand.max() <= K and got[1].sum() == 0
    assert _active_cells(got[0]) == _active_cells(want)
    assert got[4].sum() == demand.sum() and got[2].max() == demand.max()


def test_rebin_incremental_cpu_tensor_takes_the_twin():
    g0 = _make_grid(4, seed=7)
    gi, m = map(torch.from_numpy, _split_stay_movers(g0, mk=4))
    before = port_rebin.rebin_incremental.launches
    a = port_rebin.rebin_incremental(gi, m, UNIT, NX, 4)
    b = port_rebin.rebin_incremental_torch(gi, m, UNIT, NX, 4)
    assert port_rebin.rebin_incremental.launches == before == 0
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        port_rebin.rebin_incremental(gi, m[:, :, :7].contiguous(), UNIT, NX, 4)


@pytest.mark.parametrize("flag", [port_rebin.FULL, port_rebin.INCREMENTAL])
def test_gated_rebins_run_only_the_selected_one(flag):
    """The hybrid step launches both rebins with one flag: only the
    selected one writes the shared outputs."""
    g0 = _make_grid(6, seed=8)
    gi, m = map(torch.from_numpy, _split_stay_movers(g0, mk=6))
    g_full = torch.from_numpy(g0)  # the full rebin ignores ch 7
    gate = torch.tensor(flag, dtype=torch.int32)
    out = port_rebin.new_outputs(gi)
    out[0].fill_(-7.0)
    port_rebin.rebin(g_full, UNIT, NX, 6, gate=gate, out=out)
    port_rebin.rebin_incremental(gi, m, UNIT, NX, 6, gate=gate, out=out)
    want = (port_rebin.rebin_torch(g_full, UNIT, NX, 6) if flag == port_rebin.FULL
            else port_rebin.rebin_incremental_torch(gi, m, UNIT, NX, 6))
    for x, y in zip(out, want):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="preallocated"):
        port_rebin.rebin(g_full, UNIT, NX, 6, gate=gate)
    with pytest.raises(ValueError, match="new_outputs"):
        port_rebin.rebin_incremental(gi, m, UNIT, NX, 6, gate=gate, out=out[:4])


@functools.lru_cache(maxsize=None)
def _spawn_setup():
    """The spawning scenario of tests/test_rebin_incremental.py in both
    packages, binned alike (asserted bit-equal)."""
    _sc, maps, cfg, st0, fwp, fobs = _setup()
    pcfg = PStepConfig.build(loads_scenario(SCENARIO), capacity=256,
                             neighbor_grid_unit=1.5, table_capacity=8)
    a = st0.agents
    pgs = port_grid.bin_state(pcfg, PSimState(convert.agents_from_numpy(
        a.pos, a.vel, a.speed, a.dest, a.active, "cpu"), 0))
    gs = ref_grid.bin_state(cfg, st0)
    np.testing.assert_array_equal(pgs.d.numpy(), np.asarray(gs.d))
    pmaps = PFieldMaps.from_field(PField.from_scenario(loads_scenario(SCENARIO),
                                                       unit=0.25))
    pfwp, pfobs = port_grid.field_tensors(pcfg, pmaps, "cpu")
    np.testing.assert_array_equal(pfwp.numpy(), np.asarray(fwp))
    return cfg, maps, pcfg, gs, pgs.d.numpy(), fwp, fobs, pfwp, pfobs


def _active_rows(d):
    rows = np.transpose(d, (0, 1, 3, 2)).reshape(-1, 8)
    rows = rows[rows[:, 6] > 0.5][:, :6]
    return rows[np.lexsort((rows[:, 1], rows[:, 0]))]


N_STEPS = 8


@functools.lru_cache(maxsize=None)
def _reference_run():
    """The reference hybrid (mover_k=4, compact_every=5) for N_STEPS: its
    per-step metrics, the spawn candidates it drew (split as
    sfm_grid.py:375) and its final active rows."""
    cfg, maps, _pcfg, gs, _d0, fwp, fobs, _pfwp, _pfobs = _spawn_setup()
    ref_step = jax.jit(ref_grid.make_step_grid(cfg, maps, incremental=True,
                                               mover_k=4, compact_every=5))
    key = gs.key
    metrics, cands = [], []
    for _ in range(N_STEPS):
        key, k_spawn = jax.random.split(key)
        c = _spawn_candidates(cfg, k_spawn)
        cands.append(convert.agents_from_numpy(c.pos, c.vel, c.speed, c.dest,
                                               c.active, "cpu"))
        gs, m = ref_step(gs, fwp, fobs)
        metrics.append({f: int(v) for f, v in m._asdict().items()})
    return metrics, cands, _active_rows(np.asarray(gs.d))


@pytest.mark.parametrize("mover_k,compact_every", [(4, 5), (1, 1000)])
def test_hybrid_step_matches_reference(mover_k, compact_every):
    want_metrics, cands, want_rows = _reference_run()
    _cfg, _maps, pcfg, _gs, d0, _fwp, _fobs, pfwp, pfobs = _spawn_setup()
    step = port_grid.make_step_grid(
        pcfg, incremental=True, mover_k=mover_k, compact_every=compact_every,
        generator=torch.Generator())  # unused: candidates are injected
    pgs = port_grid.GridState(d=torch.from_numpy(d0.copy()), step=0)
    trace.enable(True)  # step.full_rebins counts while tracing is on
    try:
        for i, (cand, want) in enumerate(zip(cands, want_metrics)):
            pgs, pm = step(pgs, pfwp, pfobs, cand)
            assert convert.metrics_to_dict(pm) == want, f"step {i}"
    finally:
        trace.enable(False)
    rows = _active_rows(pgs.d.numpy())
    assert rows.shape == want_rows.shape and rows.shape[0] > 100
    np.testing.assert_allclose(rows, want_rows, atol=2e-5, rtol=1e-5)
    peak = max(m["max_mover_demand"] for m in want_metrics)
    n_full = int(step.full_rebins)
    if mover_k == 1:
        assert peak > 1  # the mover table overflowed: fallback steps taken
        assert n_full > 2
    else:
        assert peak >= 1
        assert 2 <= n_full < N_STEPS  # steps 0 and 5 compact; others not all


@pytest.mark.parametrize("which", ["gap", "corridor", "spawning"])
def test_resolve_incremental_matches_reference(which):
    if which == "spawning":
        psc, sc = loads_scenario(SCENARIO), ref_loads_scenario(SCENARIO)
    else:
        psc, sc = load_scenario(SCENARIOS[which]), ref_load_scenario(SCENARIOS[which])
    for forced in (None, True, False):
        ref = RefSimulator._resolve_incremental(types.SimpleNamespace(
            options=RefOptions(backend="grid", neighbor_grid_unit=1.5,
                               incremental_rebin=forced), scenario=sc))
        got = Simulator._resolve_incremental(types.SimpleNamespace(
            options=SimulatorOptions(backend="grid", device="cpu", neighbor_grid_unit=1.5,
                                     incremental_rebin=forced), scenario=psc))
        assert got == ref
        if forced is None:
            assert ref == (which != "gap")


def test_simulator_hybrid_grows_movers():
    """corridor.toml resolves to the hybrid; at mover_capacity=2 the first
    cell with a mover grows the table (2 -> 4), and no agent is lost."""
    opts = SimulatorOptions(backend="grid", device="cpu", mover_capacity=2, seed=3)
    sim = Simulator(opts, load_scenario(SCENARIOS["corridor"]))
    assert sim._resolve_incremental()
    lost = 0
    for _ in range(60):
        sim.tick()
        lost += sim.last_metrics.n_overflow + sim.last_metrics.n_dropped
        if sim.options.mover_capacity > 2:
            break
    assert sim.options.mover_capacity == 4
    assert lost == 0
    last = sim.last_metrics
    assert sim.pedestrian_count == last.n_active - last.n_exited > 0
    assert sim.measure_kernel_time(n=1) > 0.0
