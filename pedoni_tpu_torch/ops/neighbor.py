"""Uniform-grid neighbour search, in torch (counterpart of
pedoni_tpu/ops/neighbor.py).

The reference re-bins all agents into a cell list every step
(neighbor_grid.rs:22-36) and counting-sorts them into a cell-major CSR
layout (sfm.rs:58-77).  Here, with static shapes on the device:

1. a cell id per agent (inactive or out-of-grid agents get the sentinel
   ``n_cells``, so they sort to the end);
2. a stable sort by cell id (the caller's);
3. CSR offsets by ``searchsorted`` and a dense [n_cells, K] cell -> agent
   table (``build_neighbor_data``), whose cells drop agents past K
   (counted in ``n_overflow``), and each agent's 3x3 candidate window
   (``gather_candidates``).

The id uses an f32 DIVIDE by the cell unit, not a multiply by its
inverse: the rebin kernel classifies agents the same way, and the two
round differently at cell boundaries.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class CellGrid(NamedTuple):
    """Static description of the neighbor grid (neighbor_grid.rs:14-20)."""

    unit: float
    nx: int  # columns
    ny: int  # rows

    @property
    def n_cells(self) -> int:
        return self.nx * self.ny

    @classmethod
    def for_size(cls, size: tuple[float, float], unit: float) -> "CellGrid":
        return cls(
            unit=unit,
            nx=int(math.ceil(size[0] / unit)),
            ny=int(math.ceil(size[1] / unit)),
        )


def true_divide(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """``x / divisor`` as an IEEE f32 divide on every device.  (PyTorch's
    CUDA division by a Python scalar multiplies by the reciprocal instead,
    which rounds differently; a 0-d tensor on x's device avoids that.  It
    is filled there, not copied from the host, which would wait for the
    device.)"""
    return x / torch.full((), divisor, dtype=x.dtype, device=x.device)


def compute_cell_ids(pos: torch.Tensor, active: torch.Tensor,
                     grid: CellGrid) -> torch.Tensor:
    """Cell id per agent [N] i32; sentinel ``n_cells`` for inactive or
    out-of-grid agents.  ``pos`` is [N, 2] f32."""
    cx = torch.floor(true_divide(pos[:, 0], grid.unit))
    cy = torch.floor(true_divide(pos[:, 1], grid.unit))
    in_grid = (cx >= 0) & (cx < grid.nx) & (cy >= 0) & (cy < grid.ny)
    ok = active & in_grid
    cid = cy.clamp(0, grid.ny - 1).to(torch.int32) * grid.nx \
        + cx.clamp(0, grid.nx - 1).to(torch.int32)
    return torch.where(ok, cid, torch.full_like(cid, grid.n_cells))


class NeighborData(NamedTuple):
    """Per-step neighbour structure over the *sorted* agent tensors."""

    order: torch.Tensor  # [N] permutation that cell-sorts the agents
    cell_ids: torch.Tensor  # [N] sorted cell ids (sentinel n_cells at end)
    csr: torch.Tensor  # [n_cells + 1] CSR offsets into the sorted tensors
    table: torch.Tensor  # [n_cells, K] agent index a slot, N = sentinel
    n_overflow: torch.Tensor  # 0-d i32: agents dropped from full cells


def build_neighbor_data(cell_ids_sorted: torch.Tensor, grid: CellGrid,
                        table_capacity: int) -> NeighborData:
    """CSR offsets and the dense cell table from ascending cell ids (the
    step's sort already applied, so ``order`` is the identity).  The
    table's writes past K go to one spare dump slot that is cut off."""
    n = cell_ids_sorted.shape[0]
    dev = cell_ids_sorted.device
    ids = cell_ids_sorted.to(torch.int32)
    csr = torch.searchsorted(
        ids, torch.arange(grid.n_cells + 1, dtype=torch.int32, device=dev),
        side="left").to(torch.int32)
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    starts = csr[torch.clamp(ids, 0, grid.n_cells).long()]
    rank = idx - starts
    in_grid = ids < grid.n_cells
    valid = in_grid & (rank < table_capacity)
    dump = grid.n_cells * table_capacity
    slot = torch.where(valid, ids * table_capacity + rank, dump).long()
    table = torch.full((dump + 1,), n, dtype=torch.int32, device=dev)
    table.scatter_(0, slot, idx)
    return NeighborData(
        order=idx,
        cell_ids=ids,
        csr=csr,
        table=table[:dump].reshape(grid.n_cells, table_capacity),
        n_overflow=(in_grid & ~valid).sum().to(torch.int32),
    )


def gather_candidates(cell_ids_sorted: torch.Tensor, table: torch.Tensor,
                      grid: CellGrid) -> torch.Tensor:
    """Each agent's candidates: the agent indices of its 3x3 cell window,
    [N, 9K] into the sorted tensors, the sentinel N where invalid.  The
    window is masked, not clamped, at the grid's edge, so no cell counts
    twice (the reference clamps ranges to the same end, sfm.rs:117-120)."""
    n = cell_ids_sorted.shape[0]
    k = table.shape[1]
    cid = torch.clamp(cell_ids_sorted.long(), max=grid.n_cells - 1)
    cx = cid % grid.nx
    cy = cid // grid.nx
    dy = torch.tensor([-1, -1, -1, 0, 0, 0, 1, 1, 1], device=cid.device)
    dx = torch.tensor([-1, 0, 1, -1, 0, 1, -1, 0, 1], device=cid.device)
    ncx = cx[:, None] + dx
    ncy = cy[:, None] + dy
    cell_ok = (ncx >= 0) & (ncx < grid.nx) & (ncy >= 0) & (ncy < grid.ny)
    ncell = torch.where(cell_ok, ncy * grid.nx + ncx, 0)
    cand = table[ncell]  # [N, 9, K]
    cand = torch.where(cell_ok[:, :, None], cand, n)
    return cand.reshape(n, 9 * k)
