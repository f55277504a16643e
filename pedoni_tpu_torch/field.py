"""Navigation-field preprocessing (host side, one-time per scenario).

Re-implements the behaviour of the reference's ``pedoni-simulator/src/field.rs``:

1. Rasterize each obstacle / waypoint segment, widened into a rectangle
   (field.rs:42-88, util.rs:106-111), onto a grid of cell size ``unit``
   (default 0.25 m).  The outermost one-cell ring is always obstacle
   (field.rs:29-32).
2. Build an obstacle distance map: 0 at obstacle cells, then a fast-marching
   Eikonal solve with speed function f = unit (field.rs:98-99).
3. Build one geodesic potential map per waypoint: 0 at waypoint cells,
   background +MAX, FMM with slowness unit * (1e6 if obstacle else 1)
   (field.rs:102-105).

The FMM (field.rs:118-192) is an inherently sequential priority-queue solve,
so it stays on the host: a C++ implementation (``pedoni_tpu/native``) with a
pure-NumPy/Python fallback.  It runs once per scenario; the resulting maps are
shipped to device HBM a single time, like the reference GPU backend's one-time
image upload (sfm_gpu.rs:53-79).

TPU-native twist — precomputed gradient maps
--------------------------------------------
The reference samples an 8-tap Sobel of each map at every agent every step
(util.rs:61-75: 8 bilinear reads = 32 grid taps, per map).  Bilinear
interpolation is *linear in the grid values* and the Sobel taps sit at integer
offsets, so::

    sobel(grid, p) == bilinear(conv(grid, sobel_stencil), p)     (exactly)

We therefore convolve each map with the Sobel stencil once at init and each
agent does a single 4-tap bilinear read per gradient component at runtime — an
8x reduction in gather traffic on the hot path.  Out-of-bounds reads return
1e12 in the reference (util.rs:44-58); we reproduce that by physically padding
every map with rings of 1e12 and clamping indices into the padded array, which
keeps the runtime sampling branch-free.
"""

from __future__ import annotations

import dataclasses
import heapq
import math

import numpy as np

from .scenario import Scenario, Segment
from .utils.geometry import widen_segment

# Padding (in cells) applied to every device-resident map.  In-field agents
# sample at grid coords in [-0.5, shape - 0.5]; the Sobel stencil reaches one
# more cell and bilinear one more, so 4 rings cover every in-field read
# exactly; farther excursions clamp into the 1e12 ring (same repulsive
# semantics as the reference's out-of-bounds value, util.rs:45).
PAD = 4

# Out-of-bounds fill value (util.rs:45 ``FMAX: f32 = 1e12``).
OOB_VALUE = np.float32(1e12)

# f32::MAX — the "untouched" background of potential maps (field.rs:79).
F32_MAX = np.float32(np.finfo(np.float32).max)


def _supercover_cells(p0: np.ndarray, p1: np.ndarray, shape: tuple[int, int]):
    """All grid cells a segment (in grid units) passes through.

    Equivalent in spirit to geo-rasterize's conservative line burning used by
    the reference for rasterizing rectangle outlines (field.rs:55-61).
    Returns (ys, xs) integer arrays clipped to ``shape`` = (H, W).
    """
    d = p1 - p0
    # Parameter values where the segment crosses x / y gridlines.
    ts = [np.array([0.0, 1.0])]
    for axis in range(2):
        if d[axis] != 0.0:
            lo = math.floor(min(p0[axis], p1[axis]))
            hi = math.ceil(max(p0[axis], p1[axis]))
            lines = np.arange(lo, hi + 1, dtype=np.float64)
            t = (lines - p0[axis]) / d[axis]
            ts.append(t[(t >= 0.0) & (t <= 1.0)])
    t = np.unique(np.concatenate(ts))
    if t.size < 2:
        mids = np.array([0.5])
    else:
        mids = (t[:-1] + t[1:]) * 0.5
    pts = p0[None, :] + mids[:, None] * d[None, :]
    xs = np.floor(pts[:, 0]).astype(np.int64)
    ys = np.floor(pts[:, 1]).astype(np.int64)
    keep = (xs >= 0) & (xs < shape[1]) & (ys >= 0) & (ys < shape[0])
    return ys[keep], xs[keep]


def rasterize_quad(mask: np.ndarray, corners: np.ndarray) -> None:
    """Mark all cells touched by a convex quad (corners in grid units,
    [4, 2] as (x, y)) in the boolean ``mask`` (shape (H, W)), in place.

    Marks the union of (a) cells crossed by the 4 edges (conservative, so
    walls thinner than one cell still rasterize, cf. straight.toml's 0.3 m
    walls on a 0.25 m grid) and (b) cells whose center lies inside the quad.
    """
    h, w = mask.shape
    for i in range(4):
        ys, xs = _supercover_cells(corners[i], corners[(i + 1) % 4], (h, w))
        mask[ys, xs] = True

    # Interior fill: test cell centers against the 4 half-planes.
    xmin = max(int(np.floor(corners[:, 0].min())), 0)
    xmax = min(int(np.ceil(corners[:, 0].max())), w - 1)
    ymin = max(int(np.floor(corners[:, 1].min())), 0)
    ymax = min(int(np.ceil(corners[:, 1].max())), h - 1)
    if xmin > xmax or ymin > ymax:
        return
    cx = np.arange(xmin, xmax + 1) + 0.5
    cy = np.arange(ymin, ymax + 1) + 0.5
    gx, gy = np.meshgrid(cx, cy)
    inside = np.ones(gx.shape, dtype=bool)
    # Winding sign of the quad (corners may be CW or CCW).
    area = 0.0
    for i in range(4):
        x0, y0 = corners[i]
        x1, y1 = corners[(i + 1) % 4]
        area += x0 * y1 - x1 * y0
    sign = 1.0 if area >= 0 else -1.0
    for i in range(4):
        x0, y0 = corners[i]
        x1, y1 = corners[(i + 1) % 4]
        cross = (x1 - x0) * (gy - y0) - (y1 - y0) * (gx - x0)
        inside &= sign * cross >= 0.0
    sub = mask[ymin : ymax + 1, xmin : xmax + 1]
    np.logical_or(sub, inside, out=sub)


def _segment_mask(segment: Segment, unit: float, shape: tuple[int, int]) -> np.ndarray:
    corners = widen_segment(segment.p0, segment.p1, segment.width) / unit
    mask = np.zeros(shape, dtype=bool)
    rasterize_quad(mask, corners)
    return mask


def fmm_python(potential: np.ndarray, f: np.ndarray) -> np.ndarray:
    """Fast-marching Eikonal solve, faithful to field.rs:118-192.

    ``potential`` holds 0.0 at source cells and a large background elsewhere;
    ``f`` is the per-cell slowness.  Returns the solved potential (float32).
    Pure-Python fallback; the C++ native version (pedoni_tpu/native) is used
    for large grids.
    """
    pot = potential.astype(np.float64).copy()
    fa = f.astype(np.float64)
    h, w = pot.shape
    accepted = np.zeros((h, w), dtype=bool)
    heap: list[tuple[float, int, int]] = []

    # Seed: neighbours of every source cell get potential = f (field.rs:128-146).
    src_ys, src_xs = np.nonzero(potential == 0.0)
    accepted[src_ys, src_xs] = True
    for y, x in zip(src_ys.tolist(), src_xs.tolist()):
        for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            ny, nx = y + dy, x + dx
            if 0 <= ny < h and 0 <= nx < w and pot[ny, nx] != 0.0:
                u = fa[ny, nx]
                pot[ny, nx] = u
                heapq.heappush(heap, (u, ny, nx))

    fmax = float(F32_MAX)

    def get(y: int, x: int) -> float:
        if 0 <= y < h and 0 <= x < w:
            return pot[y, x]
        return fmax

    while heap:
        u, y, x = heapq.heappop(heap)
        if accepted[y, x]:
            continue
        accepted[y, x] = True

        for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            ny, nx = y + dy, x + dx
            if not (0 <= ny < h and 0 <= nx < w) or accepted[ny, nx]:
                continue
            fv = fa[ny, nx]
            if dy == 0:  # horizontal step: u1 = popped value (field.rs:163-171)
                u1 = u
                u2 = min(get(ny - 1, nx), get(ny + 1, nx))
            else:
                u1 = min(get(ny, nx - 1), get(ny, nx + 1))
                u2 = u
            if u1 >= fmax:
                nu = u2 + fv
            elif u2 >= fmax:
                nu = u1 + fv
            else:
                sq = 2.0 * fv * fv - (u1 - u2) ** 2
                if sq >= 0.0:
                    nu = (u1 + u2 + math.sqrt(sq)) / 2.0
                else:
                    nu = min(u1, u2) + fv
            if nu < pot[ny, nx]:
                pot[ny, nx] = nu
                heapq.heappush(heap, (nu, ny, nx))

    return pot.astype(np.float32)


def _fmm(potential: np.ndarray, f: np.ndarray) -> np.ndarray:
    from . import native

    if native.available():
        return native.fmm(potential, f)
    return fmm_python(potential, f)


@dataclasses.dataclass
class Field:
    """Host-side navigation field (NumPy arrays, row-major grid[y, x])."""

    unit: float
    shape: tuple[int, int]  # (H, W)
    obstacle_exist: np.ndarray  # bool [H, W]
    distance_map: np.ndarray  # f32 [H, W]
    potential_maps: np.ndarray  # f32 [n_waypoints, H, W]

    @classmethod
    def from_scenario(cls, scenario: Scenario, unit: float = 0.25) -> "Field":
        w_m, h_m = scenario.size
        shape = (int(math.ceil(h_m / unit)), int(math.ceil(w_m / unit)))
        h, w = shape

        obstacle = np.zeros(shape, dtype=bool)
        obstacle[0, :] = obstacle[-1, :] = True  # boundary ring, field.rs:29-32
        obstacle[:, 0] = obstacle[:, -1] = True
        for obs in scenario.obstacles:
            obstacle |= _segment_mask(obs, unit, shape)

        # Obstacle distance map (field.rs:98-99): sources at obstacle cells,
        # background 1e24, slowness = unit everywhere.
        dist0 = np.where(obstacle, 0.0, 1e24).astype(np.float32)
        distance_map = _fmm(dist0, np.full(shape, unit, dtype=np.float32))

        # Per-waypoint potential maps (field.rs:102-105): sources at waypoint
        # cells, background f32::MAX, slowness unit * (1e6 | 1).
        slowness = np.where(obstacle, unit * 1e6, unit).astype(np.float32)
        potential_maps = np.empty((len(scenario.waypoints), h, w), dtype=np.float32)
        for i, wp in enumerate(scenario.waypoints):
            wp_mask = _segment_mask(wp, unit, shape)
            pot0 = np.where(wp_mask, 0.0, F32_MAX).astype(np.float32)
            potential_maps[i] = _fmm(pot0, slowness)

        return cls(
            unit=unit,
            shape=shape,
            obstacle_exist=obstacle,
            distance_map=distance_map,
            potential_maps=potential_maps,
        )

    # -- host-side samplers (used in tests and host tooling) ---------------

    def get_potential(self, waypoint_id: int, pos) -> float:
        """Bilinear potential sample at a world position (field.rs:235-239)."""
        return bilinear_host(self.potential_maps[waypoint_id], np.asarray(pos) / self.unit - 0.5)

    def get_obstacle_distance(self, pos) -> float:
        return bilinear_host(self.distance_map, np.asarray(pos) / self.unit - 0.5)


def bilinear_host(grid: np.ndarray, p) -> float:
    """Reference bilinear sample (util.rs:44-58): out-of-bounds taps read 1e12."""
    p = np.asarray(p, dtype=np.float64)
    bx, by = math.floor(p[0]), math.floor(p[1])
    tx, ty = p[0] - bx, p[1] - by
    h, w = grid.shape

    def get(y: int, x: int) -> float:
        if 0 <= y < h and 0 <= x < w:
            return float(grid[y, x])
        return float(OOB_VALUE)

    return (
        (1 - ty) * (1 - tx) * get(by, bx)
        + (1 - ty) * tx * get(by, bx + 1)
        + ty * (1 - tx) * get(by + 1, bx)
        + ty * tx * get(by + 1, bx + 1)
    )


def sobel_host(grid: np.ndarray, p) -> np.ndarray:
    """Reference 8-tap Sobel (util.rs:61-75).  NOTE the sign convention: this
    is the *negative* gradient, pointing downhill toward lower values."""
    p = np.asarray(p, dtype=np.float64)

    def b(dx: float, dy: float) -> float:
        return bilinear_host(grid, p + np.array([dx, dy]))

    u00, u01, u02 = b(-1, -1), b(0, -1), b(1, -1)
    u10, u12 = b(-1, 0), b(1, 0)
    u20, u21, u22 = b(-1, 1), b(0, 1), b(1, 1)
    return np.array(
        [
            u00 + 2 * u10 + u20 - u02 - 2 * u12 - u22,
            u00 + 2 * u01 + u02 - u20 - 2 * u21 - u22,
        ]
    )


def sobel_convolve(padded: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Convolve a 2D map with the reference Sobel stencil (util.rs:71-74).

    Input must already be padded by >= 1 ring; output is 1 ring smaller on
    each side.  Returns (gx, gy), the negative-gradient components, such that
    ``bilinear(gx, p) == sobel_host(grid, p)[0]`` exactly (linearity of
    bilinear interpolation in the grid values).
    """
    # float64 accumulation: cells next to the 1e12 out-of-bounds ring mix
    # huge and tiny terms whose f32 cancellation would wipe out the physical
    # gradient (the Rust reference tolerates this in its f32 taps; we don't
    # have to).
    c = padded.astype(np.float64)
    left = c[1:-1, :-2]
    right = c[1:-1, 2:]
    up = c[:-2, 1:-1]
    down = c[2:, 1:-1]
    ul, ur = c[:-2, :-2], c[:-2, 2:]
    dl, dr = c[2:, :-2], c[2:, 2:]
    gx = (ul + 2 * left + dl) - (ur + 2 * right + dr)
    gy = (ul + 2 * up + ur) - (dl + 2 * down + dr)
    return gx, gy


def pad_map(grid: np.ndarray, pad: int = PAD, fill: float = float(OOB_VALUE)) -> np.ndarray:
    """Pad a map with ``pad`` rings of the out-of-bounds value."""
    return np.pad(grid, pad, mode="constant", constant_values=fill).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class FieldMaps:
    """Device-ready, padded field maps (still NumPy here; the simulator puts
    them on device once).  All arrays share the padded shape
    [H + 2 PAD, W + 2 PAD]; index (y, x) of the unpadded grid lives at
    (y + PAD, x + PAD).

    - ``pot``            [n_wp, Hp, Wp]  potential values (for despawn checks)
    - ``pot_gx/pot_gy``  [n_wp, Hp, Wp]  Sobel-convolved potentials
    - ``dist``           [Hp, Wp]        obstacle distance
    - ``dist_gx/dist_gy``[Hp, Wp]        Sobel-convolved distance
    """

    unit: float
    shape: tuple[int, int]
    pot: np.ndarray
    pot_gx: np.ndarray
    pot_gy: np.ndarray
    dist: np.ndarray
    dist_gx: np.ndarray
    dist_gy: np.ndarray

    @classmethod
    def from_field(cls, field: Field) -> "FieldMaps":
        n_wp = field.potential_maps.shape[0]
        hp, wp = field.shape[0] + 2 * PAD, field.shape[1] + 2 * PAD
        pot = np.empty((max(n_wp, 1), hp, wp), dtype=np.float32)
        pot_gx = np.empty_like(pot)
        pot_gy = np.empty_like(pot)
        if n_wp == 0:
            pot[:] = OOB_VALUE
            pot_gx[:] = 0.0
            pot_gy[:] = 0.0
        for i in range(n_wp):
            padded1 = pad_map(field.potential_maps[i], PAD + 1)
            gx, gy = sobel_convolve(padded1)
            pot[i] = padded1[1:-1, 1:-1]
            pot_gx[i] = gx
            pot_gy[i] = gy

        dpad1 = pad_map(field.distance_map, PAD + 1)
        dgx, dgy = sobel_convolve(dpad1)
        return cls(
            unit=field.unit,
            shape=field.shape,
            pot=pot,
            pot_gx=pot_gx,
            pot_gy=pot_gy,
            dist=dpad1[1:-1, 1:-1],
            dist_gx=dgx.astype(np.float32),
            dist_gy=dgy.astype(np.float32),
        )
