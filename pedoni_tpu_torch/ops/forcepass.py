"""The flat step's pairwise pass over a dense cell layout, in torch
(counterpart of pedoni_tpu/ops/forcepass.py).

Agents are scattered once into a dense cell grid ``D[ny+2, nx+2, K, 8]``
(cell-major, K slots a cell, a one-cell zero ring), and the 3x3
neighbourhood of every cell is nine shifted slices of it, in ``_OFFSETS``
order: 9K candidates a centre slot, in the reference's candidate order.

Channels: pos.x, pos.y, vel.x, vel.y, e.x, e.y (the goal direction, for
the field-of-view anisotropy, sfm.rs:149-151), active flag, padding.

``dense_pairwise`` dispatches by the grid's device.  On the card it is one
launch of ``csrc/flat_pairwise.cu`` (``ops/kernels/flat_pairwise.py``),
which stands where XLA fuses the reference's ``lax.map`` over row blocks
(forcepass.py:141-184): no intermediate leaves the kernel.  On the CPU it
is ``dense_pairwise_torch``, the kernel's twin: each slot's candidates
summed one add at a time in the kernel's order (``_OFFSETS`` block, then
slot j), so that kernel and twin agree bit for bit on the card.

The twin computes only the interior cells whose 3x3 window holds an
active slot (any other slot has no candidate and keeps +0, as the kernel
writes it), gathering each such cell's 9K candidates, as many cells a
pass as keep one [9K, cells, K] f32 intermediate within
``PAIR_PASS_BYTES``, a budget sized for the CPU's caches.  A slot's force
depends on its own window alone, so neither the skip nor the pass size
changes a bit of the result.

Trade-offs of the dense layout, as in the reference: cells hold at most K
agents, and the overflow (counted) neither exerts nor receives pair forces
that step; empty slots compute masked lanes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..physics import Physics
from .forces import pair_terms
from .kernels import flat_pairwise as fpk
from .neighbor import CellGrid

N_CH = 8
# Bytes of one [9K, rows, nx, K] f32 intermediate of a CPU pass, which
# holds several such tensors at once (cpu_ticks.py chose it; PERF.md).
PAIR_PASS_BYTES = 4 << 20

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


def _pair_cells(cells: torch.Tensor, idx: torch.Tensor, offsets: torch.Tensor,
                k: int, not_self: torch.Tensor, phys: Physics) -> torch.Tensor:
    """Pairwise forces of the slots of the cells ``idx`` of the padded grid
    ``cells`` [(ny+2)*(nx+2), K*8]: acc [n, K, 2] (sfm.rs:129-153), each
    slot's 9K candidates (cell ``idx + offsets[b]``, slot j) summed one add
    at a time in candidate order from +0.  ``not_self`` [9K, 1, K] is false
    where candidate j is the centre slot itself."""
    n = idx.shape[0]
    center = cells.index_select(0, idx).view(n, k, N_CH).permute(2, 0, 1)
    cand = cells.index_select(0, (offsets[:, None] + idx).reshape(-1))
    cand = cand.view(9, n, k, N_CH).permute(3, 0, 2, 1).reshape(N_CH, 9 * k, n)

    def own(c):  # [n, K]
        return center[c]

    def other(c):  # [9K, n, 1]
        return cand[c, ..., None]

    dx = own(0) - other(0)  # [9K, n, K]
    dy = own(1) - other(1)
    d2 = dx * dx + dy * dy
    valid = (other(6) > 0.5) & (d2 <= phys.cutoff_sq) & not_self
    fx, fy = pair_terms(dx, dy, d2, other(2), other(3), own(4), own(5), valid,
                        phys)
    f = torch.stack([fx, fy], dim=1)  # [9K, 2, n, K]
    acc = torch.zeros_like(f[0])
    for j in range(9 * k):  # the kernel's order
        acc += f[j]
    return acc.permute(1, 2, 0)


def dense_pairwise(data: torch.Tensor, grid: CellGrid, k: int, phys: Physics,
                   row_block: int = 8, pass_bytes: int | None = None
                   ) -> torch.Tensor:
    """Pairwise accelerations of every cell slot.  ``data`` is the padded
    [ny+2, nx+2, K, 8] grid; returns the flat [(ny+2)*(nx+2)*K, 2]
    accelerations in the same padded layout (a zero ring), so that callers
    gather each agent's by its ``slot``.  A CUDA grid goes to the kernel
    (one launch, or an error), a CPU grid to ``dense_pairwise_torch`` in
    passes of ``pass_bytes``.  ``row_block``, the reference's block
    height, shapes nothing: a slot's force depends on its window alone."""
    if data.device.type == "cpu":
        return dense_pairwise_torch(data, grid, k, phys, pass_bytes)
    return fpk.flat_pairwise(data, phys)


def dense_pairwise_torch(data: torch.Tensor, grid: CellGrid, k: int,
                         phys: Physics, pass_bytes: int | None = None
                         ) -> torch.Tensor:
    """The kernel's twin.  Only the interior cells whose 3x3 window holds
    an active slot are computed, as many a pass as keep one [9K, cells, K]
    f32 intermediate within ``pass_bytes`` (default ``PAIR_PASS_BYTES``; at
    least one cell); every other slot has no candidate and keeps +0.
    Finding them reads the [ny+2, nx+2] cell occupancy to the host once."""
    ny, nx = grid.ny, grid.nx
    if tuple(data.shape) != (ny + 2, nx + 2, k, N_CH):
        raise ValueError(f"data {tuple(data.shape)} is not the padded grid "
                         f"{(ny + 2, nx + 2, k, N_CH)}")
    dev = data.device
    budget = PAIR_PASS_BYTES if pass_bytes is None else pass_bytes
    per_pass = max(1, budget // (9 * k * k * 4))
    occ = (data[..., 6] > 0.5).any(-1).cpu().numpy()  # [ny+2, nx+2]
    near = np.zeros((ny, nx), bool)
    for dy, dx in _OFFSETS:
        near |= occ[1 + dy:1 + dy + ny, 1 + dx:1 + dx + nx]
    r, c = np.nonzero(near)
    live = torch.from_numpy((r + 1) * (nx + 2) + c + 1).to(dev)
    offsets = torch.tensor([dy * (nx + 2) + dx for dy, dx in _OFFSETS],
                           device=dev)
    j = torch.arange(9 * k, device=dev)
    not_self = (j[:, None] != _SELF_BLOCK * k + torch.arange(k, device=dev)
                ).view(9 * k, 1, k)
    cells = data.reshape(-1, k * N_CH)
    acc = torch.zeros((cells.shape[0], k, 2), dtype=torch.float32, device=dev)
    for s in range(0, live.shape[0], per_pass):
        idx = live[s:s + per_pass]
        acc.index_copy_(0, idx, _pair_cells(cells, idx, offsets, k, not_self,
                                            phys))
    return acc.reshape(-1, 2)


def gather_pair_acc(acc_flat: torch.Tensor, layout: CellLayout) -> torch.Tensor:
    """Each agent's pairwise acceleration: one [N] gather by slot."""
    slot = torch.clamp(layout.slot, max=acc_flat.shape[0] - 1)
    acc = acc_flat.index_select(0, slot)
    return torch.where(layout.valid[:, None], acc, 0.0)
