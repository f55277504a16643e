"""The grid step's spawn scatter as one kernel (``csrc/spawn_scatter.cu``).

``spawn_scatter`` places spawn candidates into free slots of the
cell-resident grid ``d`` [n_rows+2, K, 8, NXL], in place, and returns the
spawned and dropped counts (``models/sfm_grid.spawn_scatter`` states the
contract).  On a CUDA tensor it launches the kernel or raises; on a CPU
tensor it runs the twin ``spawn_scatter_torch``.  Every value written is a
copy, an int's conversion or an integral count, so the two agree bit for
bit.

The reference has no pallas_call here: XLA fuses its scatter
(pedoni_tpu/models/sfm_grid.py:140).  The grid step, each tile of the
tiled step and ``Simulator.measure_spawn_time`` call it once a step.
"""

from __future__ import annotations

import torch

from ..neighbor import CellGrid, true_divide
from . import _build


def _window(grid: CellGrid, k: int, d: torch.Tensor, n_rows: int | None,
            n_cols: int | None) -> tuple[int, int]:
    """(n_rows, n_cols) of ``d``'s window, by default the whole grid;
    raise where ``d``'s shape does not match them."""
    n2, kk, ch, nxl = d.shape
    if n_rows is None:
        n_rows = n2 - 2
    if n_cols is None:
        n_cols = grid.nx
    if kk != k or ch != 8 or n2 != n_rows + 2 or n_cols + 2 >= nxl:
        raise ValueError(f"d shape {tuple(d.shape)} does not match K={k}, "
                         f"{n_rows} rows, {n_cols} columns")
    return n_rows, n_cols


def spawn_scatter_torch(grid: CellGrid, k: int, d: torch.Tensor, cand,
                        row_lo: int = 0, n_rows: int | None = None,
                        col_lo: int = 0, n_cols: int | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's twin, the grid step's scatter as it was composed before
    the kernel: a stable sort of the candidates by cell gives each its
    rank, and every candidate row takes part in one fixed-size scatter a
    channel: a row that is not written goes to a dump slot (slot 0 of
    ghost row 0 in the last, padding lane) and writes back what that slot
    holds, so nothing waits on the host."""
    n_rows, n_cols = _window(grid, k, d, n_rows, n_cols)
    n2, _, _, nxl = d.shape
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


def _check(d: torch.Tensor, cand) -> None:
    if d.dtype != torch.float32 or not d.is_contiguous():
        raise ValueError("spawn_scatter: d must be a contiguous float32 grid, "
                         f"got {d.dtype}")
    s = cand.pos.shape[0]
    for name, shape, dtype in (("pos", (s, 2), torch.float32),
                               ("speed", (s,), torch.float32),
                               ("dest", (s,), torch.int32),
                               ("active", (s,), torch.bool)):
        t = getattr(cand, name)
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"spawn_scatter: cand.{name} must be {dtype} "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
    if s >= 2 ** 31 - 256:
        raise ValueError(f"spawn_scatter: {s} candidates, at most 2^31 - 257")


def spawn_scatter(grid: CellGrid, k: int, d: torch.Tensor, cand,
                  row_lo: int = 0, n_rows: int | None = None,
                  col_lo: int = 0, n_cols: int | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """See the module's docstring: the kernel on a CUDA tensor, the twin
    on a CPU one.  ``cand`` (an AgentState: pos, speed, dest, active) is
    moved to ``d``'s device.  Returns (d, n_spawned, n_dropped), 0-d i32."""
    if d.device.type == "cpu":
        return spawn_scatter_torch(grid, k, d, cand, row_lo, n_rows, col_lo, n_cols)
    if d.device.type != "cuda":
        raise ValueError(f"spawn_scatter: unsupported device {d.device}")
    n_rows, n_cols = _window(grid, k, d, n_rows, n_cols)
    dev = d.device
    cand = cand.to(dev)
    _check(d, cand)
    pos, speed, dest, active = (t.contiguous() for t in (
        cand.pos, cand.speed, cand.dest, cand.active))
    counts = torch.empty((2,), dtype=torch.int32, device=dev)  # written by the kernel
    lib = _build.library()
    with torch.cuda.device(dev):  # a launch goes to the current card
        rc = lib.pedoni_spawn_scatter(
            pos.data_ptr(), speed.data_ptr(), dest.data_ptr(), active.data_ptr(),
            d.data_ptr(), counts.data_ptr(), pos.shape[0], grid.unit, grid.nx,
            grid.ny, k, d.shape[3], row_lo, n_rows, col_lo, n_cols,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(rc, "pedoni_spawn_scatter")
    spawn_scatter.launches += 1
    return d, counts[0], counts[1]


spawn_scatter.launches = 0
