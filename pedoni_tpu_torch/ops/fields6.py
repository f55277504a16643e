"""Stride-S field-plane layout for in-kernel sampling.

With ``neighbor_grid_unit = S * field_unit``, every neighbor cell spans
exactly S field cells.  An agent in cell (r, x) has its bilinear taps
inside the fixed (S+2)x(S+2) patch

    padded-map rows [S*r + 3, S*r + S + 4],  cols likewise

(the +3 = PAD(4) - half-cell - 0.5 rounding; see the derivation in
step_kernel.py; ROW0 = PAD - 1 is stride-independent).  We re-layout each
padded map so the kernel can reach any patch entry with *static* slices
and lane shifts:

    F6[f, c, ch, l]  =  map[f - S, S * (l - 1) + c]

- rows carry an S-row zero prologue so the topmost halo cell row (-1) is
  addressable: block i DMAs F6 rows [S * i * rb + 3, + S(rb+2)+2);
- the lane axis is aligned with the slot grid D (cell x at lane x + 1);
- patch column p of cell x is F6[.., (3+p) % S, ch, lane + (3+p)//S].

The default S=6 is the production pairing (1.5 m cells / 0.25 m field);
any integer ratio works — the reference's --field-unit / --neighbor-unit
flags stay fully general (args.rs:33-37).

Channel stacking: ``wp [n_wp, R, S, 4, NXL]`` holds (pot, sobel_gx,
sobel_gy, 0) per waypoint; ``obs [R, S, 4, NXL]`` holds (dist, gx, gy, 0)
— the channel dim pads to 4 for DMA tile alignment.
Zero fill everywhere unreachable (beyond-map rows/cols are only touched by
positions that are already outside the simulated field).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..field import FieldMaps

STRIDE = 6  # default field cells per neighbor cell (1.5 m / 0.25 m)
PATCH = 8  # bilinear patch extent at the default stride (= STRIDE + 2)
ROW0 = 3  # patch offset: first patch row/col of cell 0 in the padded map
F_OFF = STRIDE  # zero-prologue rows at the default stride
N_CH = 4  # channels per plane (3 used + 1 pad for DMA tile alignment)


def patch_extent(stride: int) -> int:
    return stride + 2


class Fields6(NamedTuple):
    wp: np.ndarray  # [n_wp, R, S, 4, NXL] f32
    obs: np.ndarray  # [R, S, 4, NXL] f32
    rows: int
    nxl: int
    nx_cells: int
    stride: int

    @classmethod
    def build(cls, maps: FieldMaps, nx_cells: int, ny_pad: int,
              lane_align: int = 128, stride: int = STRIDE) -> "Fields6":
        n_wp, hp, wpc = maps.pot.shape
        s = stride
        f_off = s  # zero prologue rows (makes halo cell row -1 addressable)

        rows = s * ny_pad + f_off + ROW0 + patch_extent(s) + s  # safe bound
        cols6 = s * (nx_cells + 2)
        nxl = -(-(nx_cells + 3) // lane_align) * lane_align

        def layout(chs: list[np.ndarray]) -> np.ndarray:
            out = np.zeros((rows, s, N_CH, nxl), np.float32)
            for ci, m in enumerate(chs):
                buf = np.zeros((rows, cols6), np.float32)
                r = min(rows - f_off, hp)
                c = min(cols6, wpc)
                buf[f_off : f_off + r, :c] = m[:r, :c]
                v = buf.reshape(rows, nx_cells + 2, s)
                # lane l holds cell l - 1, matching the slot grid D.
                out[:, :, ci, 1 : nx_cells + 3] = np.transpose(v, (0, 2, 1))
            return out

        wp = np.stack([
            layout([maps.pot[w], maps.pot_gx[w], maps.pot_gy[w]])
            for w in range(n_wp)
        ])
        obs = layout([maps.dist, maps.dist_gx, maps.dist_gy])
        return cls(wp=wp, obs=obs, rows=rows, nxl=nxl, nx_cells=nx_cells,
                   stride=s)
