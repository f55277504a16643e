"""The port's debug modes and fault containment vs the reference, on the
CPU (the kernels' PyTorch twins):

(a) the segment-obstacle step twin (``fused_step(..., segments=...)``) vs
    ``fused_step_kernel(..., segments=segs, interpret=True)`` at the shape
    of tests/test_step_kernel.py:111-121 (18 x 12 m, K = 8, rb = 2, 220
    agents): atol 1e-5 on pos/vel of active slots, despawn flags equal;
(b) the port's grid step with ``use_distance_map=False`` vs the f64 oracle
    with the same segment obstacles, 50 steps within 5e-3 m (as
    tests/test_oracle.py:207-218 holds the reference);
(c) the all-pairs Simulator (``use_neighbor_grid=False``): unit 2.0 m and
    K 29 (as tests/test_sim.py:154-167 pins), 50 steps against the
    oracle's all-pairs branch within 5e-3 m (tests/test_oracle.py:192-204);
(d) containment: a NaN-position agent against the same slot deactivated,
    survivors exactly equal after 3 steps (tests/test_grid_backend.py:
    181-215).
The CUDA kernels are held against the twins on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pedoni_tpu.ops.pallas.step_kernel import fused_step_kernel
from pedoni_tpu.physics import Physics
from pedoni_tpu_torch import Simulator, SimulatorOptions
from pedoni_tpu_torch import convert
from pedoni_tpu_torch.field import Field as PField, FieldMaps as PFieldMaps
from pedoni_tpu_torch.models import sfm_grid as port_grid
from pedoni_tpu_torch.models.sfm import SimState as PSimState
from pedoni_tpu_torch.models.sfm import StepConfig as PStepConfig
from pedoni_tpu_torch.ops.kernels import step_kernel as port_step
from pedoni_tpu_torch.physics import Physics as PortPhysics
from pedoni_tpu_torch.scenario import loads_scenario as ploads_scenario

from oracle_sfm import oracle_step
from test_oracle import SCENARIO, _seg_obstacles
from test_torch_step_kernel import RB, _compare, step_setup  # noqa: F401

torch.set_num_threads(1)

CAP, N, N_STEPS = 128, 100, 50


@functools.lru_cache(maxsize=None)
def _reference_segment_step(size, segs):
    return jax.jit(functools.partial(fused_step_kernel, phys=Physics(),
                                     grid_size=size, row_block=RB,
                                     interpret=True, segments=segs))


def _segs(sc):
    return tuple((float(s.line[0][0]), float(s.line[0][1]), float(s.line[1][0]),
                  float(s.line[1][1]), float(s.width)) for s in sc.obstacles)


def test_segment_step_twin_matches_pallas(step_setup):  # noqa: F811
    sc, d, f6 = step_setup
    segs = _segs(sc)
    want = np.asarray(_reference_segment_step(sc.size, segs)(
        jnp.asarray(d), jnp.asarray(f6.wp), jnp.asarray(f6.obs)))
    args = (torch.from_numpy(d), torch.from_numpy(f6.wp),
            torch.from_numpy(f6.obs), PortPhysics(), sc.size)
    got = port_step.fused_step(*args, segments=port_step.segment_table(segs, "cpu"))
    assert port_step.fused_step.segment_launches == 0
    _compare(d, want, got.numpy())
    # the mode switched: the distance map gives other forces
    dmap = port_step.fused_step(*args).numpy()
    held = d[:, :, 6, :] > 0.5
    assert np.abs(dmap[:, :, 2, :] - got.numpy()[:, :, 2, :])[held].max() > 1e-3


def test_segment_helpers_default_to_the_card():
    """Like every entry point of the port, the edge-table functions put their
    tensor on the card unless asked; the step function builds its table on
    the host once and copies it to the state's device."""
    for fn in (port_step.segment_table, port_grid.debug_segments):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    pcfg = PStepConfig.build(ploads_scenario(SCENARIO), capacity=CAP,
                             neighbor_grid_unit=1.5, table_capacity=10,
                             use_distance_map=False)
    table = port_grid._segments_on(pcfg)(torch.device("cpu"))
    assert table.device.type == "cpu" and table.shape[1] == port_step.SEG_COLS
    assert torch.equal(table, port_grid.debug_segments(pcfg, "cpu"))


def _initial(seed=42):
    """tests/test_oracle.py's setup: unique speeds tag the agents."""
    psc = ploads_scenario(SCENARIO)
    rng = np.random.default_rng(seed)
    pos = rng.uniform(1.0, np.array(psc.size) - 1.0, (CAP, 2)).astype(np.float32)
    vel = rng.normal(0, 0.2, (CAP, 2)).astype(np.float32)
    speed = (1.0 + 0.002 * np.arange(CAP)).astype(np.float32)
    dest = rng.integers(0, 2, CAP).astype(np.int32)
    active = np.arange(CAP) < N
    return psc, pos, vel, speed, dest, active


def _oracle(psc, pos, vel, speed, dest, active, unit, **modes):
    field = PField.from_scenario(psc, unit=0.25)
    p, v, a = pos, vel, active.copy()
    for _ in range(N_STEPS):
        p, v, a = oracle_step(field, p, v, speed.astype(np.float64), dest, a,
                              psc.size, unit, **modes)
    return p, a


def _match_oracle(d, speed, o_pos, o_act):
    rows = np.transpose(d, (0, 1, 3, 2)).reshape(-1, 8)
    rows = rows[rows[:, 6] > 0.5]
    ids = {round(float(s), 6): i for i, s in enumerate(speed)}
    worst = 0.0
    for r in rows:
        oi = ids[round(float(r[4]), 6)]
        assert o_act[oi], f"agent {oi} active in the port, not the oracle"
        worst = max(worst, float(np.abs(r[0:2] - o_pos[oi]).max()))
    assert len(rows) == o_act.sum()
    assert worst < 5e-3, f"max position divergence {worst:.2e}"


def test_segment_grid_step_matches_oracle():
    psc, pos, vel, speed, dest, active = _initial()
    o_pos, o_act = _oracle(psc, pos, vel, speed, dest, active, 1.5,
                           obstacles=_seg_obstacles(psc))
    pcfg = PStepConfig.build(psc, capacity=CAP, neighbor_grid_unit=1.5,
                             table_capacity=10, use_distance_map=False)
    pmaps = PFieldMaps.from_field(PField.from_scenario(psc, unit=0.25))
    gs = port_grid.bin_state(pcfg, PSimState(
        convert.agents_from_numpy(pos, vel, speed, dest, active, "cpu"), 0))
    fwp, fobs = port_grid.field_tensors(pcfg, pmaps, "cpu")
    step = port_grid.make_step_grid(pcfg)
    for _ in range(N_STEPS):
        gs, _m = step(gs, fwp, fobs)
    _match_oracle(gs.d.numpy(), speed, o_pos, o_act)


def test_all_pairs_simulator_matches_oracle():
    psc, pos, vel, speed, dest, active = _initial()
    sim = Simulator(SimulatorOptions(backend="grid", device="cpu", use_neighbor_grid=False,
                                     capacity=CAP), psc)
    assert sim.options.neighbor_grid_unit == 2.0
    assert sim.options.table_capacity == 29  # ceil(16 * (2.0 / 1.5)^2)
    assert sim.cfg.grid.unit == 2.0 and sim._fwp.shape[2] == 8  # stride 8
    sim.load_flat_state(PSimState(
        convert.agents_from_numpy(pos, vel, speed, dest, active, "cpu"), 0))
    for _ in range(N_STEPS):
        sim.tick()
    o_pos, o_act = _oracle(psc, pos, vel, speed, dest, active, 2.0,
                           use_neighbor_grid=False)
    _match_oracle(sim.state.d.numpy(), speed, o_pos, o_act)


def test_nonfinite_agent_is_contained():
    """A NaN-position agent exerts no force, despawns the same step and is
    counted; the survivors evolve exactly as if it never existed."""
    psc = ploads_scenario(SCENARIO)
    rng = np.random.default_rng(3)
    pos = rng.uniform(0.8, np.array(psc.size) - 0.8, (512, 2))
    vel = rng.normal(0, 0.3, (512, 2))
    speed = np.clip(rng.normal(1.34, 0.26, 512), 0.3, None)
    dest = rng.integers(0, 2, 512)
    pcfg = PStepConfig.build(psc, capacity=512, neighbor_grid_unit=1.5,
                             table_capacity=10)
    pmaps = PFieldMaps.from_field(PField.from_scenario(psc, unit=0.25))
    d = port_grid.bin_state(pcfg, PSimState(convert.agents_from_numpy(
        pos, vel, speed, dest, np.arange(512) < 160, "cpu"), 0)).d
    fwp, fobs = port_grid.field_tensors(pcfg, pmaps, "cpu")
    r, kslot, lane = torch.nonzero(d[:, :, 6] > 0.5)[0].tolist()
    da, db = d.clone(), d.clone()
    da[r, kslot, 0:2, lane] = float("nan")
    db[r, kslot, 6, lane] = 0.0
    runs = []
    for dd in (da, db):
        step = port_grid.make_step_grid(pcfg)
        gs = port_grid.GridState(d=dd, step=0)
        for _ in range(3):
            gs, m = step(gs, fwp, fobs)
        runs.append((gs, convert.metrics_to_dict(m)))
    (ga, ma), (gb, mb) = runs
    assert ma["n_active"] == mb["n_active"] > 100
    a, b = (convert.agents_to_numpy(port_grid.unbin_state(pcfg, g).agents)
            for g in (ga, gb))

    def active_set(x):
        rows = np.concatenate([x["pos"], x["vel"], x["speed"][:, None],
                               x["dest"][:, None].astype(np.float32)], 1)
        rows = rows[x["active"]]
        return rows[np.lexsort((rows[:, 1], rows[:, 0]))]

    assert np.isfinite(a["pos"][a["active"]]).all(), "NaN escaped containment"
    np.testing.assert_array_equal(active_set(a), active_set(b))
