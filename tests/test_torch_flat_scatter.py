"""The flat step's pass after its sort and its integration, the twins that
csrc/flat_scatter.cu and csrc/flat_integrate.cu are held to on the card
(pedoni_tpu_torch/ops/kernels/flat_scatter.py::flat_scatter_torch,
flat_integrate.py::flat_integrate_torch), on the CPU:

- ``flat_scatter_torch`` against the reference's ``jnp.take(packed, order,
  mode="clip")``, ``forcepass.build_layout`` and ``scatter_cell_data``
  (plain XLA, no Pallas) exactly, on the seeded cases of
  tests/test_torch_flat_scatter_cases.py: cells past K (overflow
  counted), the sentinel run of dead and off-grid rows, holes in a cell's
  ranks, N > C, NaN and inf rows, K 255, a ragged nx and an x-strip's
  window; without cells (all-pairs
  mode) the rows alone; with the pallas slot grid's strides its layout;
- ``flat_integrate_torch`` against the reference's ``goal_force`` +
  ``obstacle_force`` (or ``segment_obstacle_force``, or none) +
  ``gather_pair_acc`` (or an all-pairs term) + ``integrate`` within atol
  1e-5 / rtol 1e-6, in the three modes;
- the flat step bit for bit against its composition before the two
  kernels (a frozen copy), in the three modes, spawning, with faulty agents;
- the wrappers on CPU tensors run the twins and count no launch, and refuse
  what the kernels do not take.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pedoni_tpu.ops import forcepass as rfp
from pedoni_tpu.ops import forces as rforces
from pedoni_tpu.ops import neighbor as rnb
from pedoni_tpu.physics import Physics
from pedoni_tpu_torch import field as pfield
from pedoni_tpu_torch import scenario as pscenario
from pedoni_tpu_torch.convert import agents_from_numpy
from pedoni_tpu_torch.models import sfm as P
from pedoni_tpu_torch.ops import forcepass as pfp
from pedoni_tpu_torch.ops import forces as pforces
from pedoni_tpu_torch.ops import neighbor as pnb
from pedoni_tpu_torch.ops.kernels import flat_integrate as fik
from pedoni_tpu_torch.ops.kernels import flat_scatter as fck
from pedoni_tpu_torch.ops.kernels import launch_counts, zero_launch_counts
from test_torch_flat_sample_cases import edge_case_agents
from test_torch_flat_scatter_cases import CASES, UNIT, scatter_case

torch.set_num_threads(1)

PHYS = Physics()


def _inputs(name):
    packed, cid, order, (ny, nx), k = scatter_case(name)
    return (torch.from_numpy(packed), torch.from_numpy(cid), torch.from_numpy(order),
            pnb.CellGrid(UNIT, nx, ny), k)


def _bits(t) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(t))
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("name", list(CASES))
def test_scatter_twin_matches_reference(name):
    """The sorted rows, cell ids, dest, active, count, layout and padded
    grid of flat_scatter_torch equal the reference's composition exactly
    (floats bit for bit, NaN payloads included)."""
    packed, cid, order, grid, k = _inputs(name)
    got = fck.flat_scatter_torch(packed, cid, order, grid, k)
    c = order.shape[0]
    rgrid = rnb.CellGrid(*grid)
    full = jnp.argsort(jnp.asarray(cid.numpy()), stable=True)
    np.testing.assert_array_equal(np.asarray(full[:c]), order.numpy())
    sp = jnp.take(jnp.asarray(packed.numpy()), full, axis=0, mode="clip")[:c]
    cs = jnp.take(jnp.asarray(cid.numpy()), full, mode="clip")[:c]
    active = sp[:, 6] > 0.5
    lay = rfp.build_layout(cs, active, rgrid, k)
    data = rfp.scatter_cell_data(lay, rgrid, k, sp[:, 0:2], sp[:, 2:4], sp[:, 7:9])
    np.testing.assert_array_equal(_bits(got.rows), _bits(sp))
    np.testing.assert_array_equal(got.cid.numpy(), np.asarray(cs))
    np.testing.assert_array_equal(got.dest.numpy(), np.asarray(sp[:, 5].astype(jnp.int32)))
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(active))
    assert int(got.n_active) == int(jnp.sum(active))
    np.testing.assert_array_equal(got.layout.slot.numpy(), np.asarray(lay.slot))
    np.testing.assert_array_equal(got.layout.valid.numpy(), np.asarray(lay.valid))
    assert int(got.layout.n_overflow) == int(lay.n_overflow) > 0
    assert got.layout.n_overflow.dtype == got.n_active.dtype == torch.int32
    np.testing.assert_array_equal(_bits(got.data), _bits(data))
    assert got.data.shape == (grid.ny + 2, grid.nx + 2, k, 8)
    # all-pairs mode: the same rows, no layout
    rows_only = fck.flat_scatter_torch(packed, cid, order, grid, k, cells=False)
    assert rows_only.layout is None and rows_only.data is None
    np.testing.assert_array_equal(_bits(rows_only.rows), _bits(got.rows))


def test_scatter_twin_takes_the_slot_grid_strides():
    """With the pallas step's slot-grid strides the twin's layout is
    ``build_layout``'s in that grid (sfm_pallas.slots_of), and no data."""
    packed, cid, order, grid, k = _inputs("ragged_nx")
    nxl = grid.nx + 3
    strides, size = (k * 8 * nxl, 1, 8 * nxl), (grid.ny + 2) * k * 8 * nxl
    got = fck.flat_scatter_torch(packed, cid, order, grid, k, strides=strides,
                                 size=size)
    rows = packed.index_select(0, order)
    want = pfp.build_layout(cid.index_select(0, order), rows[:, 6] > 0.5, grid, k,
                            strides, size)
    assert got.data is None
    for a, b in zip(got.layout, want):
        assert torch.equal(a, b)
    assert int((got.layout.slot < size).sum()) == int(got.layout.valid.sum()) > 100


def _integrate_inputs(mode):
    packed, cid, order, grid, k = _inputs("overflow")
    sc = fck.flat_scatter_torch(packed, cid, order, grid, k)
    rows = sc.rows
    rng = np.random.default_rng(11)
    acc_flat = torch.from_numpy(rng.normal(0, 2.0, (sc.data.numel() // 8, 2)
                                           ).astype(np.float32))
    extra = torch.from_numpy(rng.normal(0, 1.0, (rows.shape[0], 2)).astype(np.float32))
    return rows, sc, acc_flat, extra


@pytest.mark.parametrize("mode", ["distance_map", "segments", "no_obstacles",
                                  "all_pairs"])
def test_integrate_twin_matches_reference(mode):
    """flat_integrate_torch against the reference's force sum and
    integration within atol 1e-5 / rtol 1e-6: the obstacle term from the
    rows (distance map), from segments computed apart, or none; the pair
    term through the layout, or all pairs computed apart."""
    rows, sc, acc_flat, extra = _integrate_inputs(mode)
    seg = (np.float32([[3.0, 1.0], [9.0, 4.0]]), np.float32([[3.0, 8.0], [15.0, 4.5]]),
           np.float32([0.6, 1.0]))
    obstacle = None
    if mode == "segments":
        obstacle = pforces.segment_obstacle_force(rows[:, 0:2], *map(torch.from_numpy, seg),
                                                  PHYS)
    pair = extra if mode == "all_pairs" else None
    got = fik.flat_integrate_torch(rows, sc.active, PHYS, acc_flat=acc_flat,
                                   layout=sc.layout, pair=pair, obstacle=obstacle,
                                   distance_map=mode == "distance_map")
    r = jnp.asarray(rows.numpy())
    act = jnp.asarray(sc.active.numpy())
    acc = rforces.goal_force(r[:, 7:9], r[:, 2:4], r[:, 4], PHYS)
    if mode == "distance_map":
        acc = acc + rforces.obstacle_force(r[:, 9], r[:, 10:12], PHYS)
    elif mode == "segments":
        acc = acc + rforces.segment_obstacle_force(r[:, 0:2], *map(jnp.asarray, seg), PHYS)
    if pair is None:
        lay = rfp.CellLayout(jnp.asarray(sc.layout.slot.numpy().astype(np.int32)),
                             jnp.asarray(sc.layout.valid.numpy()),
                             jnp.int32(0))
        acc = acc + rfp.gather_pair_acc(jnp.asarray(acc_flat.numpy()), lay)
    else:
        acc = acc + jnp.asarray(pair.numpy())
    want = rforces.integrate(r[:, 0:2], r[:, 2:4], acc, r[:, 4], act, PHYS)
    live = sc.active.numpy()
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert np.isfinite(g[live]).all()
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-5)
        np.testing.assert_array_equal(_bits(g[~live]), _bits(w[~live]))


SPAWNING = """
[field]
size = [18, 12]
[[waypoints]]
line = [[2, 2], [2, 10]]
[[waypoints]]
line = [[16, 2], [16, 10]]
[[obstacles]]
line = [[9, 0], [9, 5]]
width = 1
[[pedestrians]]
origin = 0
destination = 1
spawn = { kind = "periodic", frequency = 4.0 }
"""


def _frozen_step(cfg):
    """The flat step after its sort as it was composed before flat_scatter
    and flat_integrate, frozen (models/sfm.py::make_step then)."""
    phys, c, grid, k = cfg.physics, cfg.capacity, cfg.grid, cfg.table_capacity

    def after_sort(packed, cid, obstacles):
        alive = cid < grid.n_cells
        order = torch.argsort(cid, stable=True)[:c]
        sp = packed.index_select(0, order)
        cid_sorted = cid.index_select(0, order)
        agents = P.AgentState(pos=sp[:, 0:2], vel=sp[:, 2:4], speed=sp[:, 4],
                              dest=sp[:, 5].to(torch.int32), active=sp[:, 6] > 0.5)
        e_s = sp[:, 7:9]
        n_active = agents.active.sum().to(torch.int32)
        n_dropped = alive.sum().to(torch.int32) - n_active
        acc = pforces.goal_force(e_s, agents.vel, agents.speed, phys)
        if cfg.use_distance_map:
            acc = acc + pforces.obstacle_force(sp[:, 9], sp[:, 10:12], phys)
        elif obstacles[0].shape[0] > 0:
            acc = acc + pforces.segment_obstacle_force(agents.pos, *obstacles, phys)
        if cfg.use_neighbor_grid:
            layout = pfp.build_layout(cid_sorted, agents.active, grid, k)
            data = pfp.scatter_cell_data(layout, grid, k, agents.pos, agents.vel, e_s)
            acc_flat = pfp.dense_pairwise(data, grid, k, phys)
            acc = acc + pfp.gather_pair_acc(acc_flat, layout)
            n_overflow = layout.n_overflow
        else:
            acc = acc + P._all_pairs_acc(cfg, agents, e_s)
            n_overflow = torch.zeros((), dtype=torch.int32)
        pos, vel = pforces.integrate(agents.pos, agents.vel, acc, agents.speed,
                                     agents.active, phys)
        return agents._replace(pos=pos, vel=vel), (n_active, n_dropped, n_overflow)

    return after_sort


@pytest.mark.parametrize("kw", [{}, {"use_distance_map": False},
                                {"use_neighbor_grid": False}],
                         ids=["distance_map", "segments", "all_pairs"])
def test_step_keeps_its_bits(kw, monkeypatch):
    """Three spawning flat steps on the CPU (faulty agents included): every
    output and metric bit-equal to the same steps through the composition
    the two kernels replaced."""
    psc = pscenario.loads_scenario(SPAWNING)
    pmaps = pfield.FieldMaps.from_field(pfield.Field.from_scenario(psc, unit=0.25))
    cfg = P.StepConfig.build(psc, capacity=400, table_capacity=8, **kw)
    pos, vel, speed, dest, act = edge_case_agents(400, 9, size=(18.0, 12.0))
    st = P.SimState(agents_from_numpy(pos, vel, speed, dest % 2, act, "cpu"), 0)
    field, obstacles = P.device_inputs(cfg, pmaps, "cpu")
    step = P.make_step(cfg, torch.Generator())
    frozen = _frozen_step(cfg)
    seen, real_sample = {}, P.flat_sample

    def spy(*args, **kwargs):
        seen["sample"] = real_sample(*args, **kwargs)
        return seen["sample"]

    monkeypatch.setattr(P, "flat_sample", spy)
    zero_launch_counts()
    for i in range(3):
        cand = P.spawn_candidates(cfg, torch.Generator().manual_seed(i))
        st, m = step(st, field.rows, obstacles, cand)
        want, (n_act, n_drop, n_over) = frozen(*seen["sample"], obstacles)
        for a, b in zip(st.agents, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a.contiguous().view(torch.uint8).numpy(),
                                          b.contiguous().view(torch.uint8).numpy())
        assert (int(m.n_active), int(m.n_dropped), int(m.n_overflow)) == (
            int(n_act), int(n_drop), int(n_over))
    assert all(v == 0 for v in launch_counts().values()), launch_counts()
    assert {"flat_scatter", "flat_integrate"} <= set(launch_counts())
    assert int(m.n_active) > 150 and int(m.n_spawned) > 0


@pytest.mark.parametrize("bad", ["packed_f64", "packed_width", "cid_i64",
                                 "order_i32", "order_long", "k256", "strides_alone",
                                 "rows_strided", "active_f32", "no_pair", "pair_shape",
                                 "obstacle_with_map"])
def test_wrappers_refuse_what_the_kernels_do_not_take(bad):
    packed, cid, order, grid, k = _inputs("overflow")
    sc = fck.flat_scatter_torch(packed, cid, order, grid, k)
    acc_flat = torch.zeros((sc.data.numel() // 8, 2))
    kw, ikw = {}, {"acc_flat": acc_flat, "layout": sc.layout}
    rows, active = sc.rows, sc.active
    if bad == "packed_f64":
        packed = packed.double()
    elif bad == "packed_width":
        packed = packed[:, :8].contiguous()
    elif bad == "cid_i64":
        cid = cid.long()
    elif bad == "order_i32":
        order = order.int()
    elif bad == "order_long":
        order = torch.cat([order, order])
    elif bad == "k256":
        k = 256
    elif bad == "strides_alone":
        kw["strides"] = (1, 1, 1)
    elif bad == "rows_strided":
        rows = torch.cat([rows, rows], 1)[:, :12]
    elif bad == "active_f32":
        active = active.float()
    elif bad == "no_pair":
        ikw = {}
    elif bad == "pair_shape":
        ikw = {"pair": torch.zeros((rows.shape[0] + 1, 2))}
    else:
        ikw["obstacle"] = torch.zeros((rows.shape[0], 2))
    with pytest.raises(ValueError):
        fck.flat_scatter(packed, cid, order, grid, k, **kw)
        fik.flat_integrate(rows, active, PHYS, **ikw)


def test_cpu_tensors_launch_nothing():
    """On CPU tensors both wrappers run their twins (the same bits) and
    count no launch."""
    packed, cid, order, grid, k = _inputs("nonfinite")
    zero_launch_counts()
    got = fck.flat_scatter(packed, cid, order, grid, k)
    want = fck.flat_scatter_torch(packed, cid, order, grid, k)
    for a, b in zip(got[:5], want[:5]):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    acc_flat = torch.ones((got.data.numel() // 8, 2))
    pos, vel = fik.flat_integrate(got.rows, got.active, PHYS, acc_flat=acc_flat,
                                  layout=got.layout)
    wpos, wvel = fik.flat_integrate_torch(got.rows, got.active, PHYS,
                                          acc_flat=acc_flat, layout=got.layout)
    np.testing.assert_array_equal(_bits(pos), _bits(wpos))
    np.testing.assert_array_equal(_bits(vel), _bits(wvel))
    assert all(v == 0 for v in launch_counts().values()), launch_counts()


def test_integrate_constants_round_as_the_twin():
    """The kernel's constants are the twin's Python scalars rounded to f32
    once, in IntegrateConsts order."""
    got = np.array(fik.integrate_constants(PHYS), np.float32)
    want = np.float32([PHYS.relaxation_time, PHYS.obs_strength, PHYS.obs_range,
                       1e-12, PHYS.delta_time, PHYS.max_speed_factor,
                       PHYS.delta_time * 0.5])
    np.testing.assert_array_equal(got, want)
