"""Uniform-grid cell ids, in torch (counterpart of pedoni_tpu/ops/neighbor.py).

Only the pieces the grid backend needs: the static grid description and
the per-agent cell id.  The id uses an f32 DIVIDE by the cell unit, not a
multiply by its inverse: the rebin kernel classifies agents the same way,
and the two round differently at cell boundaries.
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
    which rounds differently; a 0-d tensor on x's device avoids that.)"""
    return x / torch.tensor(divisor, dtype=x.dtype, device=x.device)


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
