"""The flat step's pass before its sort (pedoni_tpu_torch/ops/sampling.py::
flat_sample_torch), which csrc/flat_sample.cu is held to on the card, on
the CPU:

- against the reference's composition of ``sample_field``,
  ``forces.safe_normalize`` and ``neighbor.compute_cell_ids`` as its flat
  step makes it (pedoni_tpu/models/sfm.py:335-373, jitted on CPU JAX) on
  seeded inputs that hold the kernel's edge cases: positions off the map
  (clamped into the 1e12 ring) and non-finite, non-finite and huge
  velocities and speeds, agents on cell boundaries, dest past the last
  waypoint.  The sample's potential, gradients and obstacle channels
  within rtol 1e-6 + atol 1e-6 (XLA may contract the lerp's multiply and
  add into one rounding, which the port's twin does not take), and a
  channel that blends the 1e12 padding ring (its reference value past
  1e3, where the lerp's operands are 1e12) within 1e-6 of the ring's
  value; every other packed channel exact; the cell id equal except where XLA's CPU
  division by the cell size lands one float below a cell boundary
  (ROADMAP.md section 3: "Where the reference is no referee"), and the
  twin's equal to NumPy's IEEE f32 quotient there; alive equal but where
  the cell id or a potential within the tolerance of the despawn
  threshold differ;
- the despawn test strict at the threshold;
- bit for bit the composition it replaced: the flat step's (a frozen copy
  of the code it replaced) and the x-strips' unsanitized rows (their
  frozen ``_pack``), and the flat step and a strip step on the CPU with the old
  composition patched in;
- the kernel's wrapper on a CPU tensor runs the twin and counts no launch,
  takes strided agent views, and refuses what the kernel does not take.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pedoni_tpu.field import Field, FieldMaps
from pedoni_tpu.ops import forces as rforces
from pedoni_tpu.ops import neighbor as rnb
from pedoni_tpu.ops import sampling as rsamp
from pedoni_tpu.physics import Physics
from pedoni_tpu.scenario import loads_scenario
from pedoni_tpu_torch import field as pfield
from pedoni_tpu_torch import scenario as pscenario
from pedoni_tpu_torch.convert import agents_from_numpy
from pedoni_tpu_torch.models import sfm as P
from pedoni_tpu_torch.ops import forces as pforces
from pedoni_tpu_torch.ops import neighbor as pnb
from pedoni_tpu_torch.ops import sampling as psamp
from pedoni_tpu_torch.ops.kernels import flat_sample as fsk
from pedoni_tpu_torch.ops.kernels import launch_counts, zero_launch_counts
from pedoni_tpu_torch.parallel import spatial
from test_torch_flat_sample_cases import edge_case_agents

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
GAP = ROOT / "scenarios" / "gap.toml"
PHYS = Physics()
UNIT = 0.25  # field unit
CELL = 1.4  # the flat step's cell unit
TOL = 1e-6  # rtol and atol of the sampled channels against the reference


def _maps():
    src = GAP.read_text()
    ref = rsamp.DeviceField.from_maps(
        FieldMaps.from_field(Field.from_scenario(loads_scenario(src), unit=UNIT)))
    port = psamp.DeviceField.from_maps(pfield.FieldMaps.from_field(
        pfield.Field.from_scenario(pscenario.loads_scenario(src), unit=UNIT)), "cpu")
    size = pscenario.loads_scenario(src).size
    return ref, port, pnb.CellGrid.for_size(size, CELL)


def _ref_pre_sort(rows, hp, wp, pos, vel, speed, dest, active, unit, despawn,
                  grid, sanitize):
    """The reference flat step's composition up to its sort
    (pedoni_tpu/models/sfm.py:335-373): (packed, cid, potential)."""
    fs = rsamp.sample_field(rows, hp, wp, dest, pos, unit)
    e = rforces.safe_normalize(fs.pot_grad)
    alive = active & (fs.potential > despawn)
    cid = rnb.compute_cell_ids(pos, alive, grid)
    alive = cid < grid.n_cells
    if sanitize:
        vel = jnp.where(jnp.abs(vel) < 2.0 ** 30, vel, 2.0 ** 30)
        speed = jnp.where(jnp.abs(speed) < 2.0 ** 30, speed, 2.0 ** 30)
    packed = jnp.concatenate([
        pos, vel, speed[:, None], dest.astype(jnp.float32)[:, None],
        alive.astype(jnp.float32)[:, None], e, fs.obs_dist[:, None], fs.obs_grad,
    ], axis=1)
    return packed, cid, fs.potential


_ref_jit = jax.jit(_ref_pre_sort, static_argnums=(1, 2, 8, 9, 10, 11))


def _ieee_cid(pos, alive, grid) -> np.ndarray:
    """neighbor.compute_cell_ids in NumPy: floor of the IEEE f32 quotient."""
    with np.errstate(invalid="ignore"):
        cx = np.floor(pos[:, 0] / np.float32(grid.unit))
        cy = np.floor(pos[:, 1] / np.float32(grid.unit))
        ok = alive & (cx >= 0) & (cx < grid.nx) & (cy >= 0) & (cy < grid.ny)
    cid = np.where(ok, cy, 0).astype(np.int64) * grid.nx + np.where(ok, cx, 0)
    return np.where(ok, cid, grid.n_cells).astype(np.int32)


RING = 1e12  # the padding ring's value (field.OOB_VALUE)


def _close_sample(got: np.ndarray, want: np.ndarray) -> None:
    """got within rtol TOL + atol TOL of want, element by element, where the
    reference's value stays below 1e3; within TOL * RING where it blends
    the ring (the value past 1e3, or not finite)."""
    ring = (np.abs(want) >= 1e3) | ~np.isfinite(want)
    assert 0 < ring.sum() < 0.6 * ring.size
    np.testing.assert_allclose(got[~ring], want[~ring], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got[ring], want[ring], rtol=0, atol=TOL * RING)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy()


def test_sample_matches_reference():
    """The sample under the twin (sampling.sample_field) on the edge-case
    agents: potential, gradients and obstacle channels within TOL (see
    ``_close_sample``)."""
    ref, port, _grid = _maps()
    pos, _vel, _speed, dest, _act = edge_case_agents(2000, 1)
    want = rsamp.sample_field(ref.rows, ref.hp, ref.wp_cols, jnp.asarray(dest),
                              jnp.asarray(pos), UNIT)
    got = psamp.sample_field(port.rows, port.hp, port.wp_cols, torch.from_numpy(dest),
                             torch.from_numpy(pos), UNIT)
    def cols(fs):
        return np.concatenate([np.asarray(fs.potential)[:, None], np.asarray(
            fs.pot_grad), np.asarray(fs.obs_dist)[:, None], np.asarray(fs.obs_grad)], 1)

    _close_sample(cols(got), cols(want))


@pytest.mark.parametrize("sanitize", [True, False], ids=["flat", "strips"])
def test_flat_sample_matches_reference(sanitize):
    """flat_sample_torch against the reference's composition on the
    edge-case agents (module docstring)."""
    ref, port, grid = _maps()
    rgrid = rnb.CellGrid(*grid)
    pos, vel, speed, dest, act = edge_case_agents(3000, 2)
    want, wcid, wpot = map(np.asarray, _ref_jit(
        ref.rows, ref.hp, ref.wp_cols, *map(jnp.asarray, (pos, vel, speed, dest, act)),
        UNIT, PHYS.despawn_potential, rgrid, sanitize))
    got, cid = psamp.flat_sample_torch(
        port.rows, port.hp, port.wp_cols, *map(torch.from_numpy, (pos, vel, speed, dest,
                                                                  act)),
        UNIT, PHYS.despawn_potential, grid, sanitize)
    got, cid = got.numpy(), cid.numpy()
    assert got.shape == (3000, 12) and got.dtype == np.float32 and cid.dtype == np.int32
    # pos, vel, speed, dest: copies (sanitized or not), exact
    np.testing.assert_array_equal(got[:, :6], want[:, :6])
    assert (got[:, 2:5] == 2.0 ** 30).sum() >= (20 if sanitize else 0)
    assert not sanitize or np.isfinite(got[:, 2:5]).all()
    # e (a unit vector, or NaN) and the obstacle channels
    fs = psamp.sample_field(port.rows, port.hp, port.wp_cols, torch.from_numpy(dest),
                            torch.from_numpy(pos), UNIT)
    pot = fs.potential.numpy()
    np.testing.assert_allclose(got[:, 7:9], want[:, 7:9], rtol=TOL, atol=TOL)
    _close_sample(got[:, 9:12], want[:, 9:12])
    # cell ids: the twin's the IEEE quotient's; the reference's one float off
    # at some cell boundaries
    np.testing.assert_array_equal(cid, _ieee_cid(pos, act & (pot > np.float32(
        PHYS.despawn_potential)), grid))
    differ = cid != wcid
    q = pos[differ] / np.float32(CELL)
    near = np.abs(q - np.round(q)) <= 4 * np.spacing(np.abs(q).astype(np.float32))
    assert near.any(axis=1).all(), pos[differ]
    assert differ.sum() <= 0.02 * differ.size
    on_edge = (cid < grid.n_cells).sum()
    assert on_edge > 1500 and (cid == grid.n_cells).sum() > 300
    # alive: equal, but where the cell id differs or the potential sits
    # within TOL of the threshold
    thr = np.abs(wpot - PHYS.despawn_potential) <= TOL * (1 + PHYS.despawn_potential)
    same = ~differ & ~thr
    np.testing.assert_array_equal(got[same, 6], want[same, 6])
    np.testing.assert_array_equal(got[:, 6], (cid < grid.n_cells).astype(np.float32))


def test_despawn_is_strict_at_the_threshold():
    """An agent whose potential equals the despawn threshold is despawned;
    one float below the threshold keeps it."""
    _ref, port, grid = _maps()
    pos, vel, speed, dest, _act = edge_case_agents(400, 3)
    inside = (pos[:, 0] > 1) & (pos[:, 0] < 23) & (pos[:, 1] > 1) & (pos[:, 1] < 23)
    i = int(np.nonzero(inside & (dest >= 0) & (dest <= 1))[0][0])
    act = np.zeros(400, bool)
    act[i] = True
    args = (port.rows, port.hp, port.wp_cols,
            *map(torch.from_numpy, (pos, vel, speed, dest, act)), UNIT)
    pot = float(psamp.sample_field(port.rows, port.hp, port.wp_cols,
                                   torch.from_numpy(dest), torch.from_numpy(pos),
                                   UNIT).potential[i])
    at, _ = psamp.flat_sample_torch(*args, pot, grid)
    below, _ = psamp.flat_sample_torch(*args, float(np.nextafter(np.float32(pot),
                                                                 np.float32(-1))), grid)
    assert float(at[i, 6]) == 0.0 and float(below[i, 6]) == 1.0
    assert float(at[:, 6].sum()) == 0.0


def _old_flat_pre_sort(rows, hp, wp, pos, vel, speed, dest, active, unit,
                        despawn, grid):
    """The flat step before its sort as it was composed before
    ``flat_sample_torch``, frozen."""
    fs = psamp.sample_field(rows, hp, wp, dest, pos, unit)
    e = pforces.safe_normalize(fs.pot_grad)
    alive = active & (fs.potential > despawn)
    cid = pnb.compute_cell_ids(pos, alive, grid)
    alive = cid < grid.n_cells
    vel_f = torch.where(vel.abs() < 2.0 ** 30, vel, 2.0 ** 30)
    speed_f = torch.where(speed.abs() < 2.0 ** 30, speed, 2.0 ** 30)
    packed = torch.cat([
        pos, vel_f, speed_f[:, None], dest.to(torch.float32)[:, None],
        alive.to(torch.float32)[:, None], e, fs.obs_dist[:, None], fs.obs_grad,
    ], dim=1)
    return packed, cid


def _old_strip_rows(rows, hp, wp, pos, vel, speed, dest, active, unit,
                     despawn, grid):
    """The x-strips' despawn and ``_pack`` as they were before
    ``flat_sample_torch``, frozen: (rows, alive)."""
    fs = psamp.sample_field(rows, hp, wp, dest, pos, unit)
    e = pforces.safe_normalize(fs.pot_grad)
    gx = torch.floor(pnb.true_divide(pos[:, 0], grid.unit))
    gy = torch.floor(pnb.true_divide(pos[:, 1], grid.unit))
    in_global = (gx >= 0) & (gx < grid.nx) & (gy >= 0) & (gy < grid.ny)
    alive = active & (fs.potential > despawn) & in_global
    return torch.cat([pos, vel, speed[:, None], dest.to(torch.float32)[:, None],
                      alive.to(torch.float32)[:, None], e, fs.obs_dist[:, None],
                      fs.obs_grad], dim=1), alive


def test_twin_keeps_the_bits_it_replaced():
    """flat_sample_torch equals, bit for bit, the flat step's code it
    replaced and (sanitize=False) the x-strips' rows, on the edge-case
    agents."""
    _ref, port, grid = _maps()
    ins = (port.rows, port.hp, port.wp_cols,
           *map(torch.from_numpy, edge_case_agents(3000, 4)), UNIT,
           PHYS.despawn_potential, grid)
    got, cid = psamp.flat_sample_torch(*ins)
    want, wcid = _old_flat_pre_sort(*ins)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(cid.numpy(), wcid.numpy())
    rows, scid = psamp.flat_sample_torch(*ins, sanitize=False)
    srows, alive = _old_strip_rows(*ins)
    np.testing.assert_array_equal(_bits(rows), _bits(srows))
    np.testing.assert_array_equal((scid < grid.n_cells).numpy(), alive.numpy())
    assert not np.isfinite(rows[:, 2:5].numpy()).all()


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


def _frozen_flat(rows, hp, wp, pos, vel, speed, dest, active, unit, despawn,
                 grid, sanitize=True):
    assert sanitize
    return _old_flat_pre_sort(rows, hp, wp, pos, vel, speed, dest, active,
                               unit, despawn, grid)


def _frozen_strip(rows, hp, wp, pos, vel, speed, dest, active, unit, despawn,
                  grid, sanitize=True):
    assert not sanitize
    packed, alive = _old_strip_rows(rows, hp, wp, pos, vel, speed, dest,
                                     active, unit, despawn, grid)
    return packed, torch.where(alive, 0, grid.n_cells).to(torch.int32)


def _state_bits(agents) -> list[np.ndarray]:
    return [t.contiguous().view(torch.uint8).numpy() for t in agents]


def test_steps_keep_their_bits(monkeypatch):
    """Three spawning flat steps, and three steps of the same state in 2
    x-strips, on the CPU (faulty agents included): every output and
    metric bit-equal to the same steps with the old composition patched
    in."""
    psc = pscenario.loads_scenario(SPAWNING)
    pmaps = pfield.FieldMaps.from_field(pfield.Field.from_scenario(psc, unit=UNIT))
    cfg = P.StepConfig.build(psc, capacity=512, table_capacity=10)
    pos, vel, speed, dest, act = edge_case_agents(480, 5, size=(18.0, 12.0))
    st0 = P.SimState(agents_from_numpy(pos, vel, speed, dest % 2, act, "cpu"), 0)
    cands = [P.spawn_candidates(cfg, torch.Generator().manual_seed(i)) for i in range(3)]
    field, obstacles = P.device_inputs(cfg, pmaps, "cpu")
    scfg = spatial.ShardedConfig.build(cfg, 2)
    srows, sobs = spatial.device_inputs(scfg, pmaps, ["cpu", "cpu"])

    def run(flat_fn, strip_fn):
        monkeypatch.setattr(P, "flat_sample", flat_fn)
        monkeypatch.setattr(spatial, "flat_sample", strip_fn)
        step = P.make_step(cfg, torch.Generator())
        sstep = spatial.make_sharded_step(scfg, ["cpu", "cpu"], torch.Generator())
        st, ss, out = st0, spatial.shard_state(scfg, st0, ["cpu", "cpu"]), []
        for cand in cands:
            st, m = step(st, field.rows, obstacles, cand)
            ss, sm = sstep(ss, srows, sobs, cand)
            out.append((_state_bits(st.agents), [int(x) for x in m],
                        [_state_bits(a) for a in ss.agents], [int(x) for x in sm]))
        return out

    new = run(fsk.flat_sample, fsk.flat_sample)
    old = run(_frozen_flat, _frozen_strip)
    for i, (a, b) in enumerate(zip(new, old)):
        assert a[1] == b[1] and a[3] == b[3], i
        for x, y in zip(a[0], b[0]):
            np.testing.assert_array_equal(x, y)
        for xs, ys in zip(a[2], b[2]):
            for x, y in zip(xs, ys):
                np.testing.assert_array_equal(x, y)
    assert new[-1][1][0] > 150 and new[-1][1][1] > 0  # active, spawned


def test_cpu_tensors_launch_nothing():
    """On CPU tensors the wrapper runs the twin (the same bits) and counts
    no launch; strided agent views (the step's state is columns of its
    packed rows) give the bits of contiguous ones."""
    _ref, port, grid = _maps()
    pos, vel, speed, dest, act = map(torch.from_numpy, edge_case_agents(600, 6))
    rows = torch.cat([pos, vel, speed[:, None], dest.float()[:, None]], 1)
    views = (rows[:, 0:2], rows[:, 2:4], rows[:, 4], dest, act)
    assert not views[0].is_contiguous() and not views[2].is_contiguous()
    zero_launch_counts()
    got, cid = fsk.flat_sample(port.rows, port.hp, port.wp_cols, *views, UNIT,
                               PHYS.despawn_potential, grid)
    assert all(v == 0 for v in launch_counts().values()), launch_counts()
    assert "flat_sample" in launch_counts()
    want, wcid = psamp.flat_sample_torch(port.rows, port.hp, port.wp_cols, pos, vel,
                                         speed, dest, act, UNIT,
                                         PHYS.despawn_potential, grid)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(cid.numpy(), wcid.numpy())


@pytest.mark.parametrize("bad", ["rows_f64", "rows_width", "rows_strided",
                                 "dest_i64", "active_f32", "speed_2d", "n_mismatch"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    _ref, port, grid = _maps()
    a = dict(zip(("pos", "vel", "speed", "dest", "active"),
                 map(torch.from_numpy, edge_case_agents(64, 7))))
    rows = port.rows
    if bad == "rows_f64":
        rows = rows.double()
    elif bad == "rows_width":
        rows = rows[:, :6].contiguous()
    elif bad == "rows_strided":
        rows = rows[::2]
    elif bad == "dest_i64":
        a["dest"] = a["dest"].long()
    elif bad == "active_f32":
        a["active"] = a["active"].float()
    elif bad == "speed_2d":
        a["speed"] = a["speed"][:, None]
    else:
        a["vel"] = a["vel"][:-1]
    with pytest.raises(ValueError):
        fsk.flat_sample(rows, port.hp, port.wp_cols, *a.values(), UNIT,
                        PHYS.despawn_potential, grid)


def test_sample_constants_round_as_the_twin():
    """The kernel's constants are the twin's Python scalars rounded to f32
    once, in SampleConsts order."""
    grid = pnb.CellGrid(1.4, 10, 7)
    got = np.array(fsk.sample_constants(100, 120, 0.25, 0.25, grid), np.float32)
    want = np.float32([0.25, 120 - 1.001, 100 - 1.001, 4.0, 0.25, 1.4, 1e-12])
    np.testing.assert_array_equal(got, want)
    assert got[1] == torch.clamp(torch.tensor([1e9]), 0.0, 120 - 1.001).item()
