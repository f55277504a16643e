"""The flat pair pass's twin (pedoni_tpu_torch/ops/forcepass.py::
dense_pairwise_torch), which csrc/flat_pairwise.cu is held to on the card,
on the CPU:

- against the reference's ``dense_pairwise`` (plain XLA on the CPU, no
  Pallas) within 1e-5 on the whole padded tensor, with cells past K, an
  empty band of cell rows and a ragged last pass on both sides;
- each slot's sum as the kernel takes it: its candidates in ``_OFFSETS``
  order, then slot j, added one at a time from +0;
- the cells it skips (no active slot in their 3x3 window) and every pass
  budget bit-equal to one pass over every interior cell;
- the kernel's wrapper on a CPU tensor runs the twin, and neither it nor
  ``dense_pairwise`` counts a launch; the wrapper refuses what the kernel
  does not take.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pedoni_tpu.ops import forcepass as rfp
from pedoni_tpu.ops import neighbor as rnb
from pedoni_tpu.physics import Physics
from pedoni_tpu_torch.ops import forcepass as pfp
from pedoni_tpu_torch.ops import forces as pforces
from pedoni_tpu_torch.ops import neighbor as pnb
from pedoni_tpu_torch.ops.kernels import flat_pairwise as fpk
from pedoni_tpu_torch.ops.kernels import launch_counts, zero_launch_counts

torch.set_num_threads(1)

PHYS = Physics()
GRID = rnb.CellGrid.for_size((18.0, 12.0), 1.4)  # 13 x 9 cells
EMPTY_ROWS = (4, 5, 6)  # cell rows that hold no agent


def _grid(k: int, seed: int = 5, n: int = 700):
    """The port's padded grid [ny+2, nx+2, K, 8] of seeded agents, cell
    sorted as the flat step sorts them: a crowd in one cell (past K), no
    agent in cell rows EMPTY_ROWS, 15% inactive."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, 1.0, (n, 2)) * np.array([18.0, 12.0])
    pos[:40] = (8.5, 1.5) + rng.uniform(0.0, 0.8, (40, 2))  # in cell (6, 1)
    cy = np.floor(pos[:, 1] / GRID.unit).astype(np.int64)
    keep = ~np.isin(cy, EMPTY_ROWS)
    pos, cy = pos[keep], cy[keep]
    cx = np.floor(pos[:, 0] / GRID.unit).astype(np.int64)
    active = rng.uniform(size=pos.shape[0]) < 0.85
    cid = np.where(active, cy * GRID.nx + cx, GRID.n_cells).astype(np.int32)
    order = np.argsort(cid, kind="stable")
    pos = pos[order].astype(np.float32)
    vel = rng.normal(0, 0.6, pos.shape).astype(np.float32)
    e = rng.normal(0, 1, pos.shape).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    grid = pnb.CellGrid(*GRID)
    lay = pfp.build_layout(torch.from_numpy(cid[order]),
                           torch.from_numpy(active[order]), grid, k)
    assert int(lay.n_overflow) > 0
    return grid, pfp.scatter_cell_data(lay, grid, k, *map(torch.from_numpy,
                                                          (pos, vel, e)))


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy()


def _interior(grid) -> torch.Tensor:
    r, c = np.meshgrid(np.arange(grid.ny), np.arange(grid.nx), indexing="ij")
    return torch.from_numpy(((r + 1) * (grid.nx + 2) + c + 1).ravel())


def _live_cells(data: torch.Tensor, grid) -> int:
    occ = (data[..., 6] > 0.5).any(-1).float()[None, None]
    win = torch.nn.functional.max_pool2d(occ, 3, stride=1)[0, 0]  # [ny, nx]
    return int(win.sum())


@pytest.mark.parametrize("k", [6, 16])
def test_twin_matches_reference(k):
    """Within 1e-5 of the reference's dense_pairwise on the whole padded
    tensor (ring, empty slots and empty rows included).  The reference
    runs 9 rows in row blocks of 4 (a ragged last block); the twin runs
    the live cells 7 a pass (a ragged last pass)."""
    grid, data = _grid(k)
    per_pass = 7
    assert _live_cells(data, grid) % per_pass != 0
    want = np.asarray(rfp.dense_pairwise(jnp.asarray(data.numpy()), GRID, k,
                                         PHYS, row_block=4))
    got = pfp.dense_pairwise_torch(data, grid, k, PHYS,
                                   pass_bytes=per_pass * 9 * k * k * 4)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert float(got.abs().max()) > 0.1
    rows = got.view(grid.ny + 2, grid.nx + 2, k, 2)
    assert not bool(rows[1 + EMPTY_ROWS[0]:2 + EMPTY_ROWS[-1]].any())  # slots at 0, 0
    assert not bool(rows[[0, -1]].any()) and not bool(rows[:, [0, -1]].any())


def test_each_slot_sums_its_candidates_in_kernel_order():
    """A slot's acceleration is the sum from +0, one f32 add at a time, of
    pair_terms over its candidates in _OFFSETS order then slot j (masked
    ones adding nothing): the order the kernel adds them in."""
    k = 6
    grid, data = _grid(k, seed=8)
    got = pfp.dense_pairwise_torch(data, grid, k, PHYS).view(
        grid.ny + 2, grid.nx + 2, k, 2)
    rng = np.random.default_rng(1)
    act = (data[..., 6] > 0.5).nonzero().numpy()
    act = act[(act[:, 0] >= 1) & (act[:, 0] <= grid.ny)
              & (act[:, 1] >= 1) & (act[:, 1] <= grid.nx)]
    picked = act[rng.choice(len(act), 12, replace=False)]
    checked = 0
    for r, c, i in picked:
        cand = torch.cat([data[r + dy, c + dx] for dy, dx in pfp._OFFSETS])
        me = data[r, c, i]
        dx, dy = me[0] - cand[:, 0], me[1] - cand[:, 1]
        d2 = dx * dx + dy * dy
        valid = (cand[:, 6] > 0.5) & (d2 <= PHYS.cutoff_sq)
        valid[pfp._SELF_BLOCK * k + i] = False
        fx, fy = pforces.pair_terms(dx, dy, d2, cand[:, 2], cand[:, 3],
                                    me[4], me[5], valid, PHYS)
        sx = sy = np.float32(0.0)
        for a, b in zip(fx.numpy(), fy.numpy()):
            sx, sy = np.float32(sx + a), np.float32(sy + b)
        want = np.array([sx, sy], np.float32)
        np.testing.assert_array_equal(got[r, c, i].numpy().view(np.int32),
                                      want.view(np.int32))
        checked += int(valid.sum()) > 1
    assert checked >= 6


def test_skipped_cells_and_budgets_leave_the_result():
    """Skipping the cells whose window holds no active slot, and any pass
    budget, give the bits of one pass over every interior cell."""
    k = 8
    grid, data = _grid(k, seed=3)
    cells = data.reshape(-1, k * 8)
    offsets = torch.tensor([dy * (grid.nx + 2) + dx for dy, dx in pfp._OFFSETS])
    j = torch.arange(9 * k)
    not_self = (j[:, None] != pfp._SELF_BLOCK * k + torch.arange(k)).view(9 * k, 1, k)
    idx = _interior(grid)
    whole = torch.zeros((cells.shape[0], k, 2))
    whole[idx] = pfp._pair_cells(cells, idx, offsets, k, not_self, PHYS)
    whole = whole.reshape(-1, 2)
    assert _live_cells(data, grid) < grid.n_cells  # some cells are skipped
    assert float(whole.abs().max()) > 0.1
    for budget in (1, 3 * 9 * k * k * 4, 1 << 20, None, 1 << 30):
        got = pfp.dense_pairwise_torch(data, grid, k, PHYS, pass_bytes=budget)
        np.testing.assert_array_equal(_bits(got), _bits(whole), err_msg=str(budget))


def test_an_empty_grid_is_zero():
    grid, data = _grid(6)
    data = torch.zeros_like(data)
    got = pfp.dense_pairwise_torch(data, grid, 6, PHYS)
    assert _bits(got).max() == 0 and _bits(got).min() == 0  # +0 everywhere


def test_cpu_grid_launches_nothing():
    """On a CPU tensor, dense_pairwise and the kernel's wrapper run the
    twin (the same bits) and count no launch."""
    k = 6
    grid, data = _grid(k)
    zero_launch_counts()
    got = pfp.dense_pairwise(data, grid, k, PHYS, row_block=2)
    wrapped = fpk.flat_pairwise(data, PHYS)
    assert all(v == 0 for v in launch_counts().values()), launch_counts()
    assert "flat_pairwise" in launch_counts()
    twin = pfp.dense_pairwise_torch(data, grid, k, PHYS)
    np.testing.assert_array_equal(_bits(got), _bits(twin))
    np.testing.assert_array_equal(_bits(wrapped), _bits(twin))


@pytest.mark.parametrize("bad", ["float64", "channels", "k", "strided"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    _, data = _grid(6)
    data = {"float64": data.double(), "channels": data[..., :7].contiguous(),
            "k": torch.zeros((4, 4, 256, 8)), "strided": data[:, ::2]}[bad]
    with pytest.raises(ValueError):
        fpk.flat_pairwise(data, PHYS)


def test_flat_constants_round_as_the_twin():
    """The kernel's constants are the twin's Python scalars rounded to f32
    once, in FlatConsts order."""
    got = torch.tensor(fpk.flat_constants(PHYS), dtype=torch.float32)
    want = [PHYS.cutoff_sq, 0.1, 1e-12, 2.1 / 0.3, 0.3, PHYS.cos_phi, 0.5]
    np.testing.assert_array_equal(got.numpy(), np.float32(want))
