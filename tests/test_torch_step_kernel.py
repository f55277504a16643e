"""The port's fused step (pedoni_tpu_torch/ops/kernels/step_kernel.py) vs
the reference Pallas kernel.

- The pair-force twin ``pair_accum`` vs the reference ``_pair_accum``
  (plain jnp, no Pallas), rtol 1e-5 / atol 1e-6: same f32 operations in
  the same order; only exp/rsqrt rounding differs between the libraries.
- The step twin vs ``fused_step_kernel(..., interpret=True)`` at the shape
  of tests/test_step_kernel.py (18 x 12 m, K = 8, rb = 2, 220 agents,
  distance map), atol 1e-5 on pos and vel of active slots, despawn flags
  equal — and once more with non-finite agents, which must take the
  reference's sanitize path.
- The mover mode, ``fused_step(..., emit_movers=4)`` vs
  ``fused_step_kernel(..., emit_movers=4, interpret=True)`` on
  tests/test_wp_skip.py's small grid (as :189-212): stay mask, active
  channel, M ch 5-7, movf and mdmx equal; G pos/vel and M ch 0-4 within
  1e-5; no agent within 1e-4 m of a cell boundary, so both sides
  classify it unambiguously.
The CUDA kernel is held against the twin on the card by
tests/test_torch_cuda.py and chip_smoke.py.
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
from pedoni_tpu.ops.pallas.pairwise import _pair_accum
from pedoni_tpu.ops.pallas.step_kernel import fused_step_kernel
from pedoni_tpu.physics import Physics
from pedoni_tpu.scenario import loads_scenario
from pedoni_tpu_torch.ops.kernels import step_kernel as port_step
from pedoni_tpu_torch.ops.kernels.pairwise import pair_accum
from pedoni_tpu_torch.physics import Physics as PortPhysics

from test_wp_skip import _small_grid_inputs

torch.set_num_threads(1)

SCENARIO = """
[field]
size = [18, 12]
[[waypoints]]
line = [[2, 2], [2, 10]]
[[waypoints]]
line = [[16, 2], [16, 10]]
[[obstacles]]
line = [[9, 0], [9, 5]]
width = 1
"""
K = 8
RB = 2


@pytest.mark.parametrize("hoisted,with_self", [(False, False), (True, True)])
def test_pair_accum_matches_reference(hoisted, with_self):
    rng = np.random.default_rng(11)
    shape_c, shape_q = (2, K, 128), (2, 1, 128)
    center = {n: rng.uniform(0, 4, shape_c).astype(np.float32) for n in ("px", "py")}
    e = rng.normal(size=(2,) + shape_c).astype(np.float32)
    e /= np.linalg.norm(e, axis=0)
    center["ex"], center["ey"] = e[0], e[1]
    cand = {n: rng.uniform(0, 4, shape_q).astype(np.float32) for n in ("px", "py")}
    vx, vy = (rng.normal(0, 1, shape_q).astype(np.float32) for _ in range(2))
    cand["act"] = (rng.uniform(size=shape_q) > 0.2).astype(np.float32)
    dt = Physics().delta_time
    if hoisted:
        cand.update(vxdt=vx * np.float32(dt), vydt=vy * np.float32(dt),
                    v2dtt=(vx * vx + vy * vy) * np.float32(dt * dt))
    else:
        cand.update(vx=vx, vy=vy)
    acc = tuple(rng.normal(0, 1, shape_c).astype(np.float32) for _ in range(2))
    self_np = (np.arange(K) == 3).reshape(1, K, 1) if with_self else None

    want = _pair_accum(tuple(map(jnp.asarray, acc)),
                       {n: jnp.asarray(v) for n, v in center.items()},
                       {n: jnp.asarray(v) for n, v in cand.items()}, Physics(),
                       None if self_np is None else jnp.asarray(self_np))
    got = pair_accum(tuple(map(torch.from_numpy, acc)),
                     {n: torch.from_numpy(v) for n, v in center.items()},
                     {n: torch.from_numpy(v) for n, v in cand.items()},
                     PortPhysics(),
                     None if self_np is None else torch.from_numpy(self_np))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def step_setup():
    sc = loads_scenario(SCENARIO)
    maps = FieldMaps.from_field(Field.from_scenario(sc, unit=0.25))
    n = 220
    cfg = StepConfig.build(sc, capacity=n, neighbor_grid_unit=1.5,
                           table_capacity=K)
    rng = np.random.default_rng(0)
    pos = rng.uniform(0.8, np.array(sc.size) - 0.8, (n, 2)).astype(np.float32)
    vel = rng.normal(0, 0.5, (n, 2)).astype(np.float32)
    speed = np.clip(rng.normal(1.34, 0.26, n), 0.3, None).astype(np.float32)
    dest = rng.integers(0, 2, n).astype(np.int32)
    agents = AgentState(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                        speed=jnp.asarray(speed), dest=jnp.asarray(dest),
                        active=jnp.ones((n,), bool))
    gs = ref_grid.bin_state(cfg, SimState(agents=agents, key=jax.random.PRNGKey(0),
                                          step=jnp.int32(0)), RB)
    ny_pad = gs.d.shape[0] - 2
    f6 = Fields6.build(maps, cfg.grid.nx, ny_pad, lane_align=128)
    return sc, np.array(gs.d), f6


@functools.lru_cache(maxsize=None)
def _reference_step(size):
    """The reference kernel, jitted once per module (one interpret-mode
    compile serves every call at this shape)."""
    return jax.jit(functools.partial(fused_step_kernel, phys=Physics(),
                                     grid_size=size, row_block=RB,
                                     interpret=True))


def _both(sc, d, f6):
    want = np.asarray(_reference_step(sc.size)(
        jnp.asarray(d), jnp.asarray(f6.wp), jnp.asarray(f6.obs)))
    got = port_step.fused_step(torch.from_numpy(d), torch.from_numpy(f6.wp),
                               torch.from_numpy(f6.obs), PortPhysics(), sc.size)
    return want, got.numpy()


def _compare(d, want, got, rtol=0.0):
    act_in = d[:, :, 6, :] > 0.5
    np.testing.assert_array_equal(got[:, :, 6, :], want[:, :, 6, :])
    for c in range(4):  # pos and vel of the slots that held agents
        np.testing.assert_allclose(got[:, :, c, :][act_in], want[:, :, c, :][act_in],
                                   rtol=rtol, atol=1e-5)
    live = want[:, :, 6, :] > 0.5
    np.testing.assert_allclose(got[:, :, 7, :][live], want[:, :, 7, :][live],
                               rtol=1e-5, atol=1e-5)  # sampled potential
    np.testing.assert_array_equal(got[:, :, 4:6, :], want[:, :, 4:6, :])
    assert np.all(got[0] == 0) and np.all(got[-1] == 0)


def test_step_twin_matches_pallas(step_setup):
    sc, d, f6 = step_setup
    assert (d[:, :, 6, :] > 0.5).sum() > 150
    want, got = _both(sc, d, f6)
    assert (want[:, :, 6, :] > 0.5).sum() > 100  # most agents stay alive
    _compare(d, want, got)


def test_step_twin_sanitizes_like_pallas(step_setup):
    """A NaN-position agent, an inf-velocity agent and a -inf-speed agent:
    sanitized to +2^30 in both, despawned or flung, all outputs finite."""
    sc, d, f6 = step_setup
    d = d.copy()
    occ = list(zip(*np.where(d[:, :, 6, :] > 0.5)))
    (r0, k0, l0), (r1, k1, l1), (r2, k2, l2) = occ[5], occ[40], occ[90]
    d[r0, k0, 0:2, l0] = np.nan
    d[r1, k1, 2, l1] = np.inf
    d[r2, k2, 4, l2] = -np.inf
    want, got = _both(sc, d, f6)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    assert got[r0, k0, 6, l0] == 0.0  # NaN position despawns
    # the flung agent sits near 2^30 m, where one f32 ulp is 128 m
    _compare(d, want, got, rtol=1e-6)


def test_step_cpu_tensor_takes_the_twin(step_setup):
    sc, d, f6 = step_setup
    args = (torch.from_numpy(d), torch.from_numpy(f6.wp),
            torch.from_numpy(f6.obs), PortPhysics(), sc.size)
    a = port_step.fused_step(*args)
    b = port_step.fused_step_torch(*args)
    assert port_step.fused_step.launches == 0
    assert torch.equal(a, b)


def test_fused_step_emit_movers_matches_pallas():
    sc, d, f6, rb = _small_grid_inputs(seed=1)
    # the port bounds the pair loop by each cell's count (ch 7, slot 0);
    # the reference kernel does not read ch 7 of D
    d[:, :, 7, :] = d[:, :, 6, :].sum(axis=1, keepdims=True)
    want = [np.asarray(a) for a in fused_step_kernel(
        jnp.asarray(d), jnp.asarray(f6.wp), jnp.asarray(f6.obs), Physics(),
        sc.size, row_block=rb, interpret=True, emit_movers=4)]
    got = [t.numpy() for t in port_step.fused_step(
        torch.from_numpy(d), torch.from_numpy(f6.wp), torch.from_numpy(f6.obs),
        PortPhysics(), sc.size, emit_movers=4, row_block=rb)]
    assert port_step.fused_step.mover_launches == 0
    g_w, m_w, movf_w, mdmx_w = want
    g_o, m_o, movf_o, mdmx_o = got
    live = g_w[:, :, 6, :] > 0.5
    pos = g_w[:, :, 0:2, :].transpose(0, 1, 3, 2)[live]
    off = np.abs(pos / 1.5 - np.round(pos / 1.5)) * 1.5
    assert off.min() > 1e-4, "an agent sits on a cell boundary"
    np.testing.assert_array_equal(g_o[:, :, 6:8, :], g_w[:, :, 6:8, :])
    held = d[:, :, 6, :] > 0.5
    for c in range(4):
        np.testing.assert_allclose(g_o[:, :, c, :][held], g_w[:, :, c, :][held],
                                   rtol=0, atol=1e-5)
    np.testing.assert_array_equal(m_o[:, :, 5:8, :], m_w[:, :, 5:8, :])
    np.testing.assert_allclose(m_o[:, :, 0:5, :], m_w[:, :, 0:5, :], rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(movf_o, movf_w)
    np.testing.assert_array_equal(mdmx_o, mdmx_w)
    assert m_w[:, 0, 7, :].sum() >= 1 and (g_w[:, :, 7] > 0.5).sum() > 100
