"""The port's grid step at the waypoint counts of the bench suite (W = 8)
and of evacuation.toml's class (W = 33, FIDELITY.md), on the CPU, and the
device-memory acceptance rule (``sfm_grid.device_bytes`` / ``supports`` /
``check_fits``):

- W = 8: the twin ``fused_step_torch`` against the reference's
  ``fused_step_kernel`` in interpret mode on the 18 x 12 m field with eight
  waypoints, K = 8, RB = 2, destinations spread over all eight planes, in
  base and mover mode, to the tolerances of tests/test_torch_step_kernel.py.
  The reference runs with its waypoint slot walk (``wp_planes``, its
  default for W > 1 in make_step_grid), which tests/test_wp_skip.py holds
  bit-identical on active slots to the ungated build: the ungated build
  unrolls one sampling pass per plane and at W = 8 compiled for over five
  minutes on a CPU, the slot walk in under one;
- W = 33: 50 steps of the port's grid step (twins) against the f64 oracle
  tests/oracle_sfm.py within 5e-3 m, as tests/test_torch_grid_step.py does
  at W = 2 (the reference's interpret-mode build is not used here: see
  above);
- ``device_bytes`` equals the summed bytes of the tensors one step holds at
  a tiny grid, whole and for one tile of it, for W in {1, 8, 33} with the
  hybrid and the full rebin, and ``supports`` / ``check_fits`` refuse one
  byte below it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pedoni_tpu.field import Field, FieldMaps
from pedoni_tpu.models import sfm_grid as ref_grid
from pedoni_tpu.models.sfm import AgentState, SimState, StepConfig
from pedoni_tpu.ops.pallas.fields6 import Fields6
from pedoni_tpu.ops.pallas.step_kernel import (fused_step_kernel,
                                               waypoint_block_planes)
from pedoni_tpu.physics import Physics
from pedoni_tpu.scenario import loads_scenario
from pedoni_tpu_torch import convert
from pedoni_tpu_torch.field import Field as PField, FieldMaps as PFieldMaps
from pedoni_tpu_torch.models import sfm_grid as port_grid
from pedoni_tpu_torch.models.sfm import SimState as PSimState
from pedoni_tpu_torch.models.sfm import StepConfig as PStepConfig
from pedoni_tpu_torch.ops.kernels import rebin as port_rebin
from pedoni_tpu_torch.ops.kernels import step_kernel as port_step
from pedoni_tpu_torch.parallel import tile2d
from pedoni_tpu_torch.physics import Physics as PortPhysics
from pedoni_tpu_torch.scenario import loads_scenario as ploads_scenario

from oracle_sfm import oracle_step
from test_torch_grid_step import _active_rows

torch.set_num_threads(1)

K = 8
RB = 2


def scenario(n_wp: int) -> str:
    """The 18 x 12 m test field with ``n_wp`` short waypoint segments, in
    turns on its left (x = 2) and right (x = 16) edge, and one obstacle."""
    per_side = -(-n_wp // 2)
    wps = []
    for i in range(n_wp):
        x = 2 if i % 2 == 0 else 16
        y0 = 1.0 + (i // 2) * 10.0 / per_side
        wps.append(f"[[waypoints]]\nline = [[{x}, {y0:.4f}], "
                   f"[{x}, {y0 + 0.4:.4f}]]\n")
    return ("[field]\nsize = [18, 12]\n" + "".join(wps)
            + "[[obstacles]]\nline = [[9, 0], [9, 5]]\nwidth = 1\n")


@pytest.fixture(scope="module")
def w8_setup():
    """220 agents, destinations drawn over all eight planes, binned by the
    reference; its fields6 planes."""
    sc = loads_scenario(scenario(8))
    maps = FieldMaps.from_field(Field.from_scenario(sc, unit=0.25))
    n = 220
    cfg = StepConfig.build(sc, capacity=n, neighbor_grid_unit=1.5,
                           table_capacity=K)
    rng = np.random.default_rng(8)
    pos = rng.uniform(0.8, np.array(sc.size) - 0.8, (n, 2)).astype(np.float32)
    vel = rng.normal(0, 0.5, (n, 2)).astype(np.float32)
    speed = np.clip(rng.normal(1.34, 0.26, n), 0.3, None).astype(np.float32)
    dest = rng.integers(0, 8, n).astype(np.int32)
    agents = AgentState(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                        speed=jnp.asarray(speed), dest=jnp.asarray(dest),
                        active=jnp.ones((n,), bool))
    gs = ref_grid.bin_state(cfg, SimState(agents=agents, key=jax.random.PRNGKey(0),
                                          step=jnp.int32(0)), RB)
    d = np.array(gs.d)
    held = d[:, :, 6, :] > 0.5
    assert set(np.unique(d[:, :, 5, :][held]).astype(int)) == set(range(8))
    f6 = Fields6.build(maps, cfg.grid.nx, d.shape[0] - 2, lane_align=128)
    assert f6.wp.shape[0] == 8
    return sc, d, f6


def _reference(sc, d, f6, emit_movers):
    """The reference kernel in interpret mode, with its slot walk."""
    dk = jnp.asarray(d)
    run = functools.partial(fused_step_kernel, phys=Physics(), grid_size=sc.size,
                            row_block=RB, interpret=True, emit_movers=emit_movers)
    out = run(dk, jnp.asarray(f6.wp), jnp.asarray(f6.obs),
              wp_planes=waypoint_block_planes(dk, RB, f6.wp.shape[0]))
    return [np.asarray(a) for a in out] if emit_movers else np.asarray(out)


def _port(sc, d, f6, emit_movers):
    out = port_step.fused_step_torch(
        torch.from_numpy(d), torch.from_numpy(f6.wp), torch.from_numpy(f6.obs),
        PortPhysics(), sc.size, emit_movers=emit_movers, row_block=RB)
    return [t.numpy() for t in out] if emit_movers else out.numpy()


def test_twin_matches_reference_at_8_waypoints(w8_setup):
    sc, d, f6 = w8_setup
    want = _reference(sc, d, f6, 0)
    got = _port(sc, d, f6, 0)
    held = d[:, :, 6, :] > 0.5
    live = want[:, :, 6, :] > 0.5
    assert live.sum() > 100 and (held & ~live).any()  # some despawn
    np.testing.assert_array_equal(got[:, :, 6, :], want[:, :, 6, :])
    for c in range(4):  # pos and vel of the slots that held agents
        np.testing.assert_allclose(got[:, :, c, :][held], want[:, :, c, :][held],
                                   rtol=0.0, atol=1e-5)
    np.testing.assert_allclose(got[:, :, 7, :][live], want[:, :, 7, :][live],
                               rtol=1e-5, atol=1e-5)  # sampled potential
    np.testing.assert_array_equal(got[:, :, 4:6, :], want[:, :, 4:6, :])
    assert np.all(got[0] == 0) and np.all(got[-1] == 0)


def test_twin_mover_mode_matches_reference_at_8_waypoints(w8_setup):
    sc, d, f6 = w8_setup
    g_w, m_w, movf_w, mdmx_w = _reference(sc, d, f6, 4)
    g_o, m_o, movf_o, mdmx_o = _port(sc, d, f6, 4)
    live = g_w[:, :, 6, :] > 0.5
    pos = g_w[:, :, 0:2, :].transpose(0, 1, 3, 2)[live]
    off = np.abs(pos / 1.5 - np.round(pos / 1.5)) * 1.5
    assert off.min() > 1e-4, "an agent sits on a cell boundary"
    held = d[:, :, 6, :] > 0.5
    np.testing.assert_array_equal(g_o[:, :, 6:8, :], g_w[:, :, 6:8, :])
    for c in range(4):
        np.testing.assert_allclose(g_o[:, :, c, :][held], g_w[:, :, c, :][held],
                                   rtol=0, atol=1e-5)
    np.testing.assert_array_equal(m_o[:, :, 5:8, :], m_w[:, :, 5:8, :])
    np.testing.assert_allclose(m_o[:, :, 0:5, :], m_w[:, :, 0:5, :], rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(movf_o, movf_w)
    np.testing.assert_array_equal(mdmx_o, mdmx_w)
    assert m_w[:, 0, 7, :].sum() >= 1 and (g_w[:, :, 7] > 0.5).sum() > 100
    assert len(np.unique(m_w[:, :, 5, :][m_w[:, :, 6, :] > 0.5])) > 1


def test_grid_step_matches_oracle_at_33_waypoints():
    """50 steps through the port's hybrid grid step vs the f64 oracle,
    matched by unique speed tags, destinations over all 33 planes."""
    src = scenario(33)
    psc = ploads_scenario(src)
    assert len(psc.waypoints) == 33
    cap, n, n_steps = 128, 100, 50
    pcfg = PStepConfig.build(psc, capacity=cap, neighbor_grid_unit=1.5,
                             table_capacity=10)
    field = PField.from_scenario(psc, unit=0.25)
    pmaps = PFieldMaps.from_field(field)
    rng = np.random.default_rng(33)
    pos = rng.uniform(1.0, np.array(psc.size) - 1.0, (cap, 2)).astype(np.float32)
    vel = rng.normal(0, 0.2, (cap, 2)).astype(np.float32)
    speed = (1.0 + 0.002 * np.arange(cap)).astype(np.float32)
    dest = (np.arange(cap) % 33).astype(np.int32)
    active = np.arange(cap) < n

    o_pos, o_vel, o_act = pos, vel, active.copy()
    for _ in range(n_steps):
        o_pos, o_vel, o_act = oracle_step(field, o_pos, o_vel,
                                          speed.astype(np.float64), dest,
                                          o_act, psc.size, 1.5)

    gs = port_grid.bin_state(pcfg, PSimState(
        convert.agents_from_numpy(pos, vel, speed, dest, active, "cpu"), 0))
    fwp, fobs = port_grid.field_tensors(pcfg, pmaps, "cpu")
    assert fwp.shape[0] == 33
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
    assert len(rows) == o_act.sum() and len(rows) > 50
    assert len(set(rows[:, 5].astype(int))) > 25  # most planes still walked
    assert worst < 5e-3, f"max position divergence {worst:.2e}"


@pytest.mark.parametrize("tiles", [None, (2, 2)])
@pytest.mark.parametrize("incremental", [False, True])
@pytest.mark.parametrize("n_wp", [1, 8, 33])
def test_device_bytes_counts_the_step_tensors(n_wp, incremental, tiles):
    """At a tiny grid, whole or one tile of it cut 2 x 2: D, the step
    kernel's outputs and scratch (``step_scratch``), fwp, fobs, their packed
    copy and the rebin's outputs, as the hybrid (M, movf, mdmx) or the full
    path makes them."""
    psc = ploads_scenario(scenario(n_wp))
    cfg = PStepConfig.build(psc, capacity=256, neighbor_grid_unit=1.5,
                            table_capacity=K)
    maps = PFieldMaps.from_field(PField.from_scenario(psc, unit=0.25))
    rng = np.random.default_rng(n_wp)
    n = 150
    flat = PSimState(convert.agents_from_numpy(
        rng.uniform(1, 11, (n, 2)), np.zeros((n, 2)), np.full(n, 1.3),
        rng.integers(0, n_wp, n), np.ones(n, bool), "cpu"), 0)
    off, tile = {}, None
    if tiles is None:
        d = port_grid.bin_state(cfg, flat, RB).d
        fwp, fobs = port_grid.field_tensors(cfg, maps, "cpu", row_block=RB)
    else:
        tcfg = tile2d.Tile2DConfig.build(cfg, *tiles, row_block=RB)
        d = tile2d.make_sharded_grid_state(tcfg, flat, ["cpu"] * 4).d[3]
        fwps, fobss = tile2d.device_inputs(tcfg, maps, 6, ["cpu"] * 4)
        fwp, fobs = fwps[3], fobss[3]
        r0, c0 = tcfg.origin(3)
        off = dict(row_offset=r0, col_offset=c0, nx_local=tcfg.cols_local)
        tile = (tcfg.rows_local, tcfg.nxl_local)
    held = [d, fwp, fobs, port_step.pack_fields(fwp, fobs),
            *port_step.step_scratch(d)]
    mk = 8 if incremental else 0
    g = port_step.fused_step(d, fwp, fobs, cfg.physics, psc.size,
                             emit_movers=mk, row_block=RB, **off)
    held += list(g) if incremental else [g]
    held += port_rebin.new_outputs(held[6], RB)
    need = port_grid.device_bytes(cfg, RB, incremental, tile=tile)
    assert need == sum(t.numel() * t.element_size() for t in held)
    if tiles is not None:
        return

    assert port_grid.supports(cfg, RB, incremental, free_bytes=need)
    assert not port_grid.supports(cfg, RB, incremental, free_bytes=need - 1)
    port_grid.check_fits(need, "cuda", free_bytes=need)
    with pytest.raises(ValueError, match=f"needs {need} bytes on cuda and "
                                         f"{need - 1} are free"):
        port_grid.check_fits(need, "cuda", free_bytes=need - 1)
    port_grid.check_fits(need, "cpu")  # the CPU has no such limit here
