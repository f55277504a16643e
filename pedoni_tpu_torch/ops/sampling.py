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
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..field import PAD, FieldMaps
from .neighbor import true_divide


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
