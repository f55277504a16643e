"""The grid step's spawn scatter (pedoni_tpu_torch/ops/kernels/
spawn_scatter.py), the twin that csrc/spawn_scatter.cu is held to on the
card, on the CPU:

- ``sfm_grid.spawn_scatter`` (the wrapper, which runs the twin on CPU
  tensors) against a frozen copy of its composition before the kernel, bit
  for bit on the grid and in both counts, on seeded cases of
  scenarios/random.toml's grid (134 x 134 cells of 1.5 m, K 16, S 68):
  candidates from its own spawn sampler, a tile's window with its ghost
  ring, K 3 on a crowded grid, more than K candidates in one cell,
  inactive, off-grid and NaN candidates, S = 0 and S = 3000;
- the same for chained spawning steps of random.toml's sampler;
- the wrapper counts no launch on the CPU, ``launch_counts()`` carries its
  counter and ``zero_launch_counts()`` zeroes it;
- the wrapper refuses a grid of the wrong shape.

``spawn_case`` also feeds tests/test_torch_cuda.py and chip_smoke.py.
Imports neither JAX nor the reference package.
"""

import pathlib

import numpy as np
import pytest
import torch

from pedoni_tpu_torch import load_scenario
from pedoni_tpu_torch.models import sfm_grid
from pedoni_tpu_torch.models.sfm import AgentState, StepConfig, spawn_sampler
from pedoni_tpu_torch.ops.kernels import launch_counts, zero_launch_counts
from pedoni_tpu_torch.ops.kernels import spawn_scatter as ssk
from pedoni_tpu_torch.ops.neighbor import true_divide

torch.set_num_threads(1)

RANDOM = pathlib.Path(__file__).resolve().parents[1] / "scenarios" / "random.toml"
UNIT = 1.5  # -b grid's cell unit

# name: (K, window (row_lo, n_rows, col_lo, n_cols) or None for the whole
# grid, S or None for random.toml's sampler, seed)
CASES = {
    "whole": (16, None, None, 1),
    "tile": (16, (40, 30, 60, 50), 900, 2),  # ghost-ring candidates written, not counted
    "crowded_k3": (3, None, 1500, 3),  # drops
    "one_cell": (16, None, 60, 4),  # 60 candidates in one cell
    "faulty": (16, (0, 67, 0, 134), 400, 5),  # inactive, off the grid, NaN
    "empty": (16, None, 0, 6),
    "many": (16, None, 3000, 7),  # chunks of the kernel's block
}


def random_config(k: int = 16) -> StepConfig:
    return StepConfig.build(load_scenario(RANDOM), neighbor_grid_unit=UNIT,
                            table_capacity=k)


def spawn_case(name: str):
    """(cfg, d [n_rows+2, K, 8, NXL] f32, cand AgentState, window kwargs) on
    the CPU.  ``d`` holds seeded noise in every channel and seeded integral
    counts in [0, K] in ch 7 of slot 0 (0..K-4 outside ``crowded_k3``), so
    a slot the scatter must not touch shows if it does."""
    k, window, s, seed = CASES[name]
    cfg = random_config(k)
    dims = sfm_grid.GridDims.build(cfg)
    nx, ny = cfg.grid.nx, cfg.grid.ny
    kw = {}
    n_rows, nxl = dims.ny_pad, dims.nxl
    if window is not None:
        r0, n_rows, c0, n_cols = window
        kw = dict(row_lo=r0, n_rows=n_rows, col_lo=c0, n_cols=n_cols)
        nxl = -(-(n_cols + 3) // 128) * 128
    rng = np.random.default_rng(seed)
    d = rng.normal(0.0, 3.0, (n_rows + 2, k, 8, nxl)).astype(np.float32)
    top = k + 1 if name == "crowded_k3" else max(k - 3, 1)
    d[:, 0, 7, :] = rng.integers(0, top, (n_rows + 2, nxl))
    d = torch.from_numpy(d)
    if s is None:
        gen = torch.Generator().manual_seed(seed)
        cand = spawn_sampler(cfg, "cpu")(gen)
        cand = cand._replace(active=torch.ones_like(cand.active))
        return cfg, d, cand, kw
    if name == "tile":  # the window, its ghost ring and one cell beyond
        r0, n_rows, c0, n_cols = window
        cells = np.stack([rng.integers(r0 - 2, r0 + n_rows + 2, s),
                          rng.integers(c0 - 2, c0 + n_cols + 2, s)], 1)
    elif name == "one_cell":
        cells = np.tile([[70, 33]], (s, 1))
    elif name == "many":  # 3000 candidates in 40 cells: past K and across chunks
        pick = rng.integers(0, 40, s)
        cells = np.stack([60 + pick // 8, 20 + pick % 8], 1)
    else:
        cells = np.stack([rng.integers(-3, ny + 3, s), rng.integers(-3, nx + 3, s)], 1)
    pos = (cells[:, ::-1] + rng.uniform(0.0, 1.0, (s, 2))) * UNIT
    if name == "crowded_k3":  # a few cells take many candidates
        pos[: s // 3] = (np.array([60.5, 40.5]) + rng.uniform(-1.5, 1.5, (s // 3, 2))) * UNIT
    pos = pos.astype(np.float32)
    active = rng.uniform(size=s) < 0.9
    if name == "faulty":
        pos[:8] = np.nan
        pos[8:16, 0] = -0.3  # just left of the grid
        pos[16:24, 1] = ny * UNIT  # on the far edge: off the grid
        pos[24:32, 1] = np.float32(-0.0)  # on the near edge: row 0
        active[40:200] = False
    speed = rng.uniform(0.5, 2.0, s).astype(np.float32)
    dest = rng.integers(0, 4, s).astype(np.int32)
    cand = AgentState(pos=torch.from_numpy(pos), vel=torch.zeros((s, 2)),
                      speed=torch.from_numpy(speed), dest=torch.from_numpy(dest),
                      active=torch.from_numpy(active))
    return cfg, d, cand, kw


def frozen_spawn_scatter(cfg, d, cand, row_lo=0, n_rows=None, col_lo=0,
                         n_cols=None):
    """models/sfm_grid.py::spawn_scatter as it was before the kernel, kept
    as it was: the twin must keep its outputs bit for bit."""
    grid = cfg.grid
    k = cfg.table_capacity
    n2, kk, ch, nxl = d.shape
    if n_rows is None:
        n_rows = n2 - 2
    if n_cols is None:
        n_cols = grid.nx
    if kk != k or ch != 8 or n2 != n_rows + 2 or n_cols + 2 >= nxl:
        raise ValueError(f"d shape {tuple(d.shape)} does not match K={k}, "
                         f"{n_rows} rows, {n_cols} columns")
    dev = d.device
    cand = cand.to(dev)
    s = cand.pos.shape[0]
    gx = torch.floor(true_divide(cand.pos[:, 0], grid.unit))
    cy = torch.floor(true_divide(cand.pos[:, 1], grid.unit))
    ing = cand.active & (gx >= 0) & (gx < grid.nx) & (cy >= 0) & (cy < grid.ny)
    owned = (ing & (cy >= row_lo) & (cy < row_lo + n_rows)
             & (gx >= col_lo) & (gx < col_lo + n_cols))
    writable = (ing & (cy >= row_lo - 1) & (cy < row_lo + n_rows + 1)
                & (gx >= col_lo - 1) & (gx < col_lo + n_cols + 1))
    n_spawned = owned.sum().to(torch.int32)
    ly = torch.where(writable, cy - row_lo, 0.0).long()  # -1 .. n_rows
    lx = torch.where(writable, gx - col_lo, 0.0).long()  # -1 .. n_cols
    cell = torch.where(writable, (ly + 1) * (grid.nx + 2) + (lx + 1),
                       n2 * (grid.nx + 2))
    order = torch.sort(cell, stable=True).indices
    cell_s = cell[order]
    idx = torch.arange(s, device=dev)
    is_start = torch.ones(s, dtype=torch.bool, device=dev)
    is_start[1:] = cell_s[1:] != cell_s[:-1]
    rank = idx - torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    lx_s, ly_s = lx[order], ly[order]
    writable_s, owned_s = writable[order], owned[order]
    flat = d.view(-1)
    row_at = (ly_s + 1) * (k * 8 * nxl) + (lx_s + 1)  # slot 0, ch 0 of the cell
    slot_k = flat[row_at + 7 * nxl].long() + rank
    ok = writable_s & (slot_k < k)
    n_drop = (n_spawned - (owned_s & ok).sum()).to(torch.int32)

    dump = nxl - 1  # ghost row 0, slot 0, ch 0, the last lane: padding
    tgt = torch.where(ok, row_at + torch.clamp(slot_k, 0, k - 1) * (8 * nxl), dump)
    speed = cand.speed[order]
    vals = [cand.pos[order, 0], cand.pos[order, 1], torch.zeros_like(speed),
            torch.zeros_like(speed), speed, cand.dest[order].float(),
            torch.ones_like(speed)]
    for c, v in enumerate(vals):
        at = tgt + c * nxl
        flat.scatter_(0, at, torch.where(ok, v, flat[at]))
    cnt_at = torch.where(ok, row_at, dump) + 7 * nxl
    flat.scatter_add_(0, cnt_at, ok.float())
    return d, n_spawned, n_drop


def bits(t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("name", list(CASES))
def test_twin_keeps_the_composition_bits(name):
    """The wrapper on CPU tensors (the twin) writes the frozen
    composition's grid bit for bit and counts the same spawns and drops."""
    cfg, d, cand, kw = spawn_case(name)
    want_d, want_sp, want_dr = frozen_spawn_scatter(cfg, d.clone(), cand, **kw)
    got_d, got_sp, got_dr = sfm_grid.spawn_scatter(cfg, d.clone(), cand, **kw)
    np.testing.assert_array_equal(bits(got_d), bits(want_d))
    assert got_sp.dtype == got_dr.dtype == torch.int32
    assert got_sp.dim() == got_dr.dim() == 0
    assert (int(got_sp), int(got_dr)) == (int(want_sp), int(want_dr))


def test_cases_hold_their_edges():
    """Each case holds what it is named for: writes, drops, ghost-ring
    writes that are not counted, a cell past K, candidates not written."""
    seen = {}
    for name in CASES:
        cfg, d, cand, kw = spawn_case(name)
        before = d.clone()
        _, n_sp, n_dr = frozen_spawn_scatter(cfg, d, cand, **kw)
        written = int((d[:, :, 6] != before[:, :, 6]).sum())
        seen[name] = (cand.pos.shape[0], written, int(n_sp), int(n_dr))
    assert seen["whole"][0] == 68 and seen["whole"][1] > 0
    s, written, n_sp, n_dr = seen["tile"]
    assert written > n_sp - n_dr > 0  # ghost copies written, owner counts
    assert seen["crowded_k3"][3] > 0
    assert seen["one_cell"][3] > 0 and seen["one_cell"][1] < 60
    assert seen["faulty"][2] < 400 * 0.9
    assert seen["empty"] == (0, 0, 0, 0)
    assert seen["many"][3] > 0 and seen["many"][1] > 256


def test_chained_spawning_steps_keep_their_bits():
    """Eight chained draws of random.toml's sampler into one grid, through
    the wrapper and through the frozen composition: the same grid and
    counts after each."""
    cfg = random_config()
    _, d, _, _ = spawn_case("whole")
    draw = spawn_sampler(cfg, "cpu")
    gen = torch.Generator().manual_seed(11)
    d_old, d_new = d.clone(), d.clone()
    spawned = 0
    for _ in range(8):
        cand = draw(gen)
        d_old, sp_old, dr_old = frozen_spawn_scatter(cfg, d_old, cand)
        d_new, sp_new, dr_new = sfm_grid.spawn_scatter(cfg, d_new, cand)
        np.testing.assert_array_equal(bits(d_new), bits(d_old))
        assert (int(sp_new), int(dr_new)) == (int(sp_old), int(dr_old))
        spawned += int(sp_new)
    assert spawned > 0


def test_cpu_tensors_launch_nothing():
    """On CPU tensors the wrapper runs the twin and counts no launch; the
    counter is one of ``launch_counts()`` and ``zero_launch_counts()``
    zeroes it."""
    cfg, d, cand, kw = spawn_case("tile")
    zero_launch_counts()
    got = ssk.spawn_scatter(cfg.grid, cfg.table_capacity, d.clone(), cand, **kw)
    want = ssk.spawn_scatter_torch(cfg.grid, cfg.table_capacity, d.clone(), cand, **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(bits(a), bits(b))
    assert all(v == 0 for v in launch_counts().values()), launch_counts()
    assert "spawn_scatter" in launch_counts()
    ssk.spawn_scatter.launches = 3
    assert launch_counts()["spawn_scatter"] == 3
    zero_launch_counts()
    assert launch_counts()["spawn_scatter"] == 0


@pytest.mark.parametrize("bad", ["k", "rows", "lanes", "channels"])
def test_wrapper_refuses_a_grid_of_the_wrong_shape(bad):
    cfg, d, cand, _ = spawn_case("whole")
    k, kw = cfg.table_capacity, {}
    if bad == "k":
        k += 1
    elif bad == "rows":
        kw["n_rows"] = d.shape[0] - 3
    elif bad == "lanes":
        kw["n_cols"] = d.shape[3] - 2
    else:
        d = d[:, :, :7].contiguous()
    with pytest.raises(ValueError):
        ssk.spawn_scatter(cfg.grid, k, d, cand, **kw)
