"""The flat step's pairwise pass over a dense cell layout, in torch
(counterpart of pedoni_tpu/ops/forcepass.py).

Agents are scattered once into a dense cell grid ``D[ny+2, nx+2, K, 8]``
(cell-major, K slots a cell, a one-cell zero ring), and the 3x3
neighbourhood of every cell is nine shifted slices of it, concatenated in
``_OFFSETS`` order into [K, 9K] candidate blocks: the same candidate order,
and so the same summation order of each slot, as the reference's.

Channels: pos.x, pos.y, vel.x, vel.y, e.x, e.y (the goal direction, for
the field-of-view anisotropy, sfm.rs:149-151), active flag, padding.

The pair math runs over whole cell rows at a time.  The reference maps one
block of ``row_block`` rows after the other (``lax.map``), a memory bound,
not a semantic one: a slot's force depends only on its own row.  Here a
pass takes as many row blocks as keep one [rows, nx, K, 9K] f32
intermediate within ``PAIR_PASS_BYTES``; at 1M agents on the bench's
square 1.4 m field (452 x 452 cells, K = 14) that is 84 rows a pass, 6
passes a step, where one block a pass would be 113 (``row_block`` 4).

Trade-offs of the dense layout, as in the reference: cells hold at most K
agents, and the overflow (counted) neither exerts nor receives pair forces
that step; empty slots compute masked lanes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..physics import Physics
from .forces import pair_terms
from .neighbor import CellGrid

N_CH = 8
# Bytes of one [rows, nx, K, 9K] f32 intermediate of a pass, which holds
# several such tensors at once.
PAIR_PASS_BYTES = 1 << 28

_OFFSETS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
_SELF_BLOCK = _OFFSETS.index((0, 0))  # candidate block holding the centre cell


class CellLayout(NamedTuple):
    slot: torch.Tensor  # [N] i64 flat index into the padded grid
    valid: torch.Tensor  # [N] has a cell slot (in grid, active, rank < K)
    n_overflow: torch.Tensor  # 0-d i32


def build_layout(cid_sorted: torch.Tensor, active: torch.Tensor,
                 grid: CellGrid, k: int,
                 strides: tuple[int, int, int] | None = None,
                 size: int | None = None) -> CellLayout:
    """Each cell-sorted agent's (cell, rank) slot in a padded grid: the flat
    index (cy + 1) * row + (cx + 1) * lane + rank * rank_stride for
    ``strides`` = (row, lane, rank_stride) -- by default the (ny+2, nx+2,
    K) grid's ((nx + 2) * K, K, 1), of ``size`` (ny+2) * (nx+2) * K.  The
    rank within the cell is rank[i] = i - (index of the first agent with
    the same cell id), that first index being the minimum one fixed-size
    ``scatter_reduce`` leaves per cell id (the sentinel ``n_cells``
    included): no host sync, and no running maximum over run starts,
    whose scan took 2.9 ms of a 4.9 ms pallas step at 1M agents on the
    card (PERF.md).  Agents without a slot get ``size``, one past the
    grid's last, which the scatter drops."""
    if strides is None:
        strides = ((grid.nx + 2) * k, k, 1)
        size = (grid.ny + 2) * (grid.nx + 2) * k
    row, lane, rank_stride = strides
    n = cid_sorted.shape[0]
    dev = cid_sorted.device
    idx = torch.arange(n, device=dev)
    cid_l = cid_sorted.long()
    first = torch.full((grid.n_cells + 1,), n, dtype=torch.long, device=dev
                       ).scatter_reduce_(0, cid_l, idx, "amin")
    rank = idx - first.index_select(0, cid_l)
    live = (cid_l < grid.n_cells) & active
    ok = live & (rank < k)
    cid = torch.clamp(cid_l, max=grid.n_cells - 1)
    # (cy + 1) * row + (cx + 1) * lane, with cx = cid - cy * nx
    slot = (cid // grid.nx * (row - grid.nx * lane) + cid * lane
            + rank * rank_stride + (row + lane))
    slot = torch.where(ok, slot, size)
    n_overflow = (live & (rank >= k)).sum().to(torch.int32)
    return CellLayout(slot=slot, valid=ok, n_overflow=n_overflow)


def scatter_cell_data(layout: CellLayout, grid: CellGrid, k: int,
                      pos: torch.Tensor, vel: torch.Tensor,
                      e: torch.Tensor) -> torch.Tensor:
    """One scatter of the packed agent channels into the padded cell grid,
    through a buffer with one spare dump row (the reference's ``mode=
    "drop"``): agents without a slot all land there, and it is cut off."""
    n = pos.shape[0]
    channels = torch.cat([
        pos, vel, e, layout.valid[:, None].to(torch.float32),
        torch.zeros((n, 1), dtype=torch.float32, device=pos.device),
    ], dim=1)  # [N, 8]
    flat = torch.zeros(((grid.ny + 2) * (grid.nx + 2) * k + 1, N_CH),
                       dtype=torch.float32, device=pos.device)
    flat.index_copy_(0, layout.slot, channels)
    return flat[:-1].reshape(grid.ny + 2, grid.nx + 2, k, N_CH)


def _pair_block(center: torch.Tensor, cand: torch.Tensor, not_self: torch.Tensor,
                phys: Physics) -> torch.Tensor:
    """Pairwise forces of a run of cell rows: center [rb, nx, K, 8], cand
    [rb, nx, 9K, 8] -> acc [rb, nx, K, 2] (sfm.rs:129-153).  ``not_self``
    [K, 9K] is false where candidate j is the centre slot itself."""
    center = center.movedim(-1, 0).contiguous()  # channel-major
    cand = cand.movedim(-1, 0).contiguous()

    def own(c):  # [rb, nx, K, 1]
        return center[c, ..., None]

    def other(c):  # [rb, nx, 1, 9K]
        return cand[c, ..., None, :]

    dx = own(0) - other(0)  # [rb, nx, K, 9K]
    dy = own(1) - other(1)
    d2 = dx * dx + dy * dy
    valid = (other(6) > 0.5) & (d2 <= phys.cutoff_sq) & not_self
    fx, fy = pair_terms(dx, dy, d2, other(2), other(3), own(4), own(5), valid,
                        phys)
    return torch.stack([fx.sum(-1), fy.sum(-1)], dim=-1)


def dense_pairwise(data: torch.Tensor, grid: CellGrid, k: int, phys: Physics,
                   row_block: int = 8, pass_bytes: int = PAIR_PASS_BYTES
                   ) -> torch.Tensor:
    """Pairwise accelerations of every cell slot.  ``data`` is the padded
    [ny+2, nx+2, K, 8] grid; returns the flat [(ny+2)*(nx+2)*K, 2]
    accelerations in the same padded layout, so that callers gather each
    agent's by its ``slot``.  A pass takes whole blocks of ``row_block``
    rows, as many as keep one [rows, nx, K, 9K] f32 intermediate within
    ``pass_bytes`` (at least one block)."""
    ny, nx = grid.ny, grid.nx
    dev = data.device
    rb = min(row_block, ny)
    row_bytes = nx * k * 9 * k * 4
    rows = rb * max(1, pass_bytes // (rb * row_bytes))
    j = torch.arange(9 * k, device=dev)
    not_self = j[None, :] != _SELF_BLOCK * k + torch.arange(k, device=dev)[:, None]
    acc = torch.zeros((ny + 2, nx + 2, k, 2), dtype=torch.float32, device=dev)
    for r0 in range(0, ny, rows):
        n = min(rows, ny - r0)
        win = data[r0:r0 + n + 2]  # cell rows r0 - 1 .. r0 + n
        cand = torch.cat([win[1 + dy:1 + dy + n, 1 + dx:1 + dx + nx]
                          for dy, dx in _OFFSETS], dim=2)
        acc[r0 + 1:r0 + 1 + n, 1:nx + 1] = _pair_block(
            win[1:n + 1, 1:nx + 1], cand, not_self, phys)
    return acc.reshape(-1, 2)


def gather_pair_acc(acc_flat: torch.Tensor, layout: CellLayout) -> torch.Tensor:
    """Each agent's pairwise acceleration: one [N] gather by slot."""
    slot = torch.clamp(layout.slot, max=acc_flat.shape[0] - 1)
    acc = acc_flat.index_select(0, slot)
    return torch.where(layout.valid[:, None], acc, 0.0)
