"""Field sampling on the device (counterpart of pedoni_tpu/ops/sampling.py).

The runtime form of the reference's per-agent field queries (field.rs:
235-258 + util.rs:44-75).  All maps are padded with PAD rings of the
out-of-bounds value 1e12 (pedoni_tpu_torch/field.py), and gradients read
pre-convolved Sobel maps.  One row per map texel holds (potential, pot_gx,
pot_gy, obstacle distance, dist_gx, dist_gy, 0, 0), with the obstacle
channels repeated in every waypoint plane, so each agent's bilinear sample
is four row gathers.

Coordinates: world position ``pos`` (m) maps to unpadded grid coords
``pos / unit - 0.5`` (field.rs:236 half-cell offset), plus PAD for the
padded maps.  Positions out of range clamp into the 1e12 ring, the
reference's out-of-bounds semantics.

``flat_sample_torch`` is the flat step's whole pre-sort phase around the
sample (the reference's models/sfm.py:335-373 up to its sort): goal
direction, despawn test, cell id and the packed [N, 12] rows.  It is the
twin of ``csrc/flat_sample.cu`` (``ops/kernels/flat_sample.py``), which
computes it in one launch on the card, bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..field import PAD, FieldMaps
from .forces import safe_normalize
from .neighbor import CellGrid, compute_cell_ids, true_divide

# |vel| and |speed| at or past this (or non-finite) become it in the packed
# rows (the flat step's fault containment, see ``flat_sample_torch``)
SANITIZE_LIMIT = 2.0 ** 30


class FieldSample(NamedTuple):
    potential: torch.Tensor  # [N] destination potential (despawn + goal)
    pot_grad: torch.Tensor  # [N, 2] Sobel of the potential (downhill)
    obs_dist: torch.Tensor  # [N] obstacle distance
    obs_grad: torch.Tensor  # [N, 2] Sobel of the distance map (downhill)


class DeviceField(NamedTuple):
    """Packed, padded field maps: one [n_wp * Hp * Wp, 8] f32 row-major
    tensor of channels (pot, pot_gx, pot_gy, dist, dist_gx, dist_gy, 0,
    0)."""

    rows: torch.Tensor
    hp: int
    wp_cols: int

    @classmethod
    def from_maps(cls, maps: FieldMaps, device: torch.device | str = "cuda"
                  ) -> "DeviceField":
        n_wp, hp, wp_cols = maps.pot.shape
        zeros = np.zeros_like(maps.dist)
        obs = np.stack([maps.dist, maps.dist_gx, maps.dist_gy, zeros, zeros],
                       axis=-1)  # [Hp, Wp, 5]
        rows = np.concatenate(
            [np.stack([maps.pot, maps.pot_gx, maps.pot_gy], axis=-1),
             np.broadcast_to(obs[None], (n_wp, hp, wp_cols, 5))],
            axis=-1).astype(np.float32)  # [n_wp, Hp, Wp, 8]
        return cls(rows=torch.from_numpy(rows.reshape(n_wp * hp * wp_cols, 8)
                                         ).to(device),
                   hp=hp, wp_cols=wp_cols)


def sample_field(flat: torch.Tensor, hp: int, wp: int, dest: torch.Tensor,
                 pos: torch.Tensor, unit: float) -> FieldSample:
    """Bilinear-sample every field channel at world positions: four row
    gathers an agent (util.rs:44-58 semantics through the 1e12 padding and
    clamping).  ``flat`` is ``DeviceField.rows``; ``hp``/``wp`` its padded
    map dims.  Indices out of range clamp to the first or last row, as the
    reference's ``take(mode="clip")``."""
    px = torch.clamp(true_divide(pos[:, 0], unit) - 0.5 + PAD, 0.0, wp - 1.001)
    py = torch.clamp(true_divide(pos[:, 1], unit) - 0.5 + PAD, 0.0, hp - 1.001)
    bx = torch.floor(px)
    by = torch.floor(py)
    tx = (px - bx)[:, None]
    ty = (py - by)[:, None]
    base = (dest.long() * hp + by.long()) * wp + bx.long()
    last = flat.shape[0] - 1

    def take(idx: torch.Tensor) -> torch.Tensor:
        return flat.index_select(0, torch.clamp(idx, 0, last))

    v00 = take(base)
    v01 = take(base + 1)
    v10 = take(base + wp)
    v11 = take(base + wp + 1)
    top = v00 + tx * (v01 - v00)
    bot = v10 + tx * (v11 - v10)
    v = top + ty * (bot - top)  # [N, 8]
    return FieldSample(potential=v[:, 0], pot_grad=v[:, 1:3], obs_dist=v[:, 3],
                       obs_grad=v[:, 4:6])


def flat_sample_torch(rows: torch.Tensor, hp: int, wp: int, pos: torch.Tensor,
                      vel: torch.Tensor, speed: torch.Tensor, dest: torch.Tensor,
                      active: torch.Tensor, unit: float, despawn_potential: float,
                      grid: CellGrid, sanitize: bool = True
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The flat step before its sort: (packed [N, 12] f32 rows, cell id
    [N] i32).  One field sample an agent (``sample_field``), its goal
    direction e (``safe_normalize`` of the potential's gradient), the
    despawn test (arrived: potential <= ``despawn_potential``, sfm.rs:69;
    or out of ``grid``, where the cell id's sentinel doubles as the in-grid
    test), and the rows 0:2 pos, 2:4 vel, 4 speed, 5 dest, 6 alive, 7:9 e,
    9 obstacle distance, 10:12 its Sobel.  With ``sanitize`` (the flat
    step) a non-finite velocity or speed, or one of magnitude 2^30 or
    more, becomes 2^30: it would poison its whole 3x3 neighbourhood
    through 0 * NaN in the masked pair sum, or the goal force; the finite
    sentinel flings the agent out of the grid instead, where it is
    despawned and counted next step (non-finite positions are dead
    already: NaN fails the despawn test, inf the cell-id bound).  The
    x-strips pack unsanitized rows (``sanitize=False``)."""
    fs = sample_field(rows, hp, wp, dest, pos, unit)
    e = safe_normalize(fs.pot_grad)
    alive = active & (fs.potential > despawn_potential)
    cid = compute_cell_ids(pos, alive, grid)
    alive = cid < grid.n_cells
    if sanitize:
        vel = torch.where(vel.abs() < SANITIZE_LIMIT, vel, SANITIZE_LIMIT)
        speed = torch.where(speed.abs() < SANITIZE_LIMIT, speed, SANITIZE_LIMIT)
    packed = torch.cat([
        pos, vel, speed[:, None], dest.to(torch.float32)[:, None],
        alive.to(torch.float32)[:, None], e, fs.obs_dist[:, None], fs.obs_grad,
    ], dim=1)
    return packed, cid
