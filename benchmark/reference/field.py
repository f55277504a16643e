"""The plain reference's navigation field: rasterized geometry and the
fast-marching potentials, worked out from the scenario alone.

Semantics of the reference simulator's ``field.rs`` (written here from
its description, sharing no code with the program under test):

- a grid of ``unit``-sized texels over the field, its outer ring an
  obstacle (field.rs:29-32);
- each segment widened to a rectangle (util.rs:106-111) and burned in:
  every texel an edge passes through, and every texel whose centre lies
  inside (field.rs:42-88);
- the obstacle distance map: a fast-marching solve from the obstacle
  texels (background 1e24, slowness ``unit``; field.rs:98-99);
- one potential map per waypoint: fast marching from the waypoint's
  texels (background f32::MAX, slowness ``unit * 1e6`` in obstacles and
  ``unit`` elsewhere; field.rs:102-105), the update of field.rs:118-192
  in double precision, stored as f32 as the reference stores it.

The solve is sequential and in pure Python, so a field of millions of
texels takes a minute.  ``fields`` keeps each solved field in
``.benchcache/`` at the checkout's root, under a hash of the geometry and
of this file: the first run of a checkout pays it, the others read it.
"""

from __future__ import annotations

import hashlib
import heapq
import json
import math
import os
from pathlib import Path

import numpy as np

F32_MAX = 3.4028234663852886e38
CACHE_DIR = Path(__file__).resolve().parents[2] / ".benchcache"


def _supercover(p0: np.ndarray, p1: np.ndarray, h: int, w: int):
    """(ys, xs) of the texels the segment p0 -> p1 (texel units) crosses."""
    d = p1 - p0
    ts = [np.array([0.0, 1.0])]
    for axis in range(2):
        if d[axis] != 0.0:
            lo = math.floor(min(p0[axis], p1[axis]))
            hi = math.ceil(max(p0[axis], p1[axis]))
            t = (np.arange(lo, hi + 1, dtype=np.float64) - p0[axis]) / d[axis]
            ts.append(t[(t >= 0.0) & (t <= 1.0)])
    t = np.unique(np.concatenate(ts))
    mids = np.array([0.5]) if t.size < 2 else (t[:-1] + t[1:]) * 0.5
    pts = p0[None, :] + mids[:, None] * d[None, :]
    xs = np.floor(pts[:, 0]).astype(np.int64)
    ys = np.floor(pts[:, 1]).astype(np.int64)
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    return ys[keep], xs[keep]


def segment_mask(p0, p1, width: float, unit: float, h: int, w: int
                 ) -> np.ndarray:
    """Texels of the segment p0 -> p1 (metres) widened to ``width``."""
    a, b = np.asarray(p0, np.float64), np.asarray(p1, np.float64)
    d = b - a
    n = np.linalg.norm(d)
    u = d / n if n != 0.0 else np.zeros(2)
    off = np.array([u[1], -u[0]]) * 0.5 * width
    corners = np.stack([a - off, a + off, b + off, b - off]) / unit
    mask = np.zeros((h, w), bool)
    for i in range(4):
        ys, xs = _supercover(corners[i], corners[(i + 1) % 4], h, w)
        mask[ys, xs] = True
    x0 = max(int(np.floor(corners[:, 0].min())), 0)
    x1 = min(int(np.ceil(corners[:, 0].max())), w - 1)
    y0 = max(int(np.floor(corners[:, 1].min())), 0)
    y1 = min(int(np.ceil(corners[:, 1].max())), h - 1)
    if x0 > x1 or y0 > y1:
        return mask
    gx, gy = np.meshgrid(np.arange(x0, x1 + 1) + 0.5, np.arange(y0, y1 + 1) + 0.5)
    area = sum(corners[i, 0] * corners[(i + 1) % 4, 1]
               - corners[(i + 1) % 4, 0] * corners[i, 1] for i in range(4))
    sign = 1.0 if area >= 0 else -1.0
    inside = np.ones(gx.shape, bool)
    for i in range(4):
        (ax, ay), (bx, by) = corners[i], corners[(i + 1) % 4]
        inside &= sign * ((bx - ax) * (gy - ay) - (by - ay) * (gx - ax)) >= 0.0
    mask[y0:y1 + 1, x0:x1 + 1] |= inside
    return mask


def fast_march(start: np.ndarray, slowness: np.ndarray) -> np.ndarray:
    """field.rs:118-192: texels at 0 are the sources; their 4-neighbours
    start at their slowness; then a binary-heap sweep accepts the least
    tentative value and updates its unaccepted 4-neighbours with the
    upwind quadratic, reading tentative values too, off-grid as f32::MAX.
    Double precision inside; f32 out."""
    h, w = start.shape
    pot = start.astype(np.float64).ravel().tolist()
    f = slowness.astype(np.float64).ravel().tolist()
    done = bytearray(h * w)
    heap: list[tuple[float, int]] = []
    push, pop = heapq.heappush, heapq.heappop
    sources = np.flatnonzero(start.ravel() == 0.0).tolist()
    for i in sources:
        done[i] = 1
    for i in sources:
        y, x = divmod(i, w)
        for ny, nx in ((y - 1, x), (y + 1, x), (y, x - 1), (y, x + 1)):
            if 0 <= ny < h and 0 <= nx < w:
                j = ny * w + nx
                if pot[j] != 0.0:
                    pot[j] = f[j]
                    push(heap, (f[j], j))
    while heap:
        u, i = pop(heap)
        if done[i]:
            continue
        done[i] = 1
        y, x = divmod(i, w)
        for j, ny, nx, across in ((i - w, y - 1, x, False), (i + w, y + 1, x, False),
                                  (i - 1, y, x - 1, True), (i + 1, y, x + 1, True)):
            if ny < 0 or ny >= h or nx < 0 or nx >= w or done[j]:
                continue
            fv = f[j]
            if across:  # a step along x: the popped texel is the x-neighbour
                a = pot[j - w] if ny > 0 else F32_MAX
                b = pot[j + w] if ny < h - 1 else F32_MAX
                u1, u2 = u, (a if a < b else b)
            else:
                a = pot[j - 1] if nx > 0 else F32_MAX
                b = pot[j + 1] if nx < w - 1 else F32_MAX
                u1, u2 = (a if a < b else b), u
            if u1 >= F32_MAX:
                nu = u2 + fv
            elif u2 >= F32_MAX:
                nu = u1 + fv
            else:
                dd = u1 - u2
                sq = 2.0 * fv * fv - dd * dd
                nu = (u1 + u2 + math.sqrt(sq)) / 2.0 if sq >= 0.0 else min(u1, u2) + fv
            if nu < pot[j]:
                pot[j] = nu
                push(heap, (nu, j))
    return np.array(pot, np.float64).reshape(h, w).astype(np.float32)


def solve(geometry: dict) -> dict[str, np.ndarray]:
    """{"dist": [H, W] f32, "pot": [n_wp, H, W] f32} of a geometry dict
    (``size`` (w, h), ``unit``, ``waypoints`` and ``obstacles`` as
    [[x0, y0], [x1, y1], width])."""
    unit = float(geometry["unit"])
    w_m, h_m = geometry["size"]
    h, w = int(math.ceil(h_m / unit)), int(math.ceil(w_m / unit))
    obstacle = np.zeros((h, w), bool)
    obstacle[0, :] = obstacle[-1, :] = obstacle[:, 0] = obstacle[:, -1] = True
    for p0, p1, width in geometry["obstacles"]:
        obstacle |= segment_mask(p0, p1, width, unit, h, w)
    dist = fast_march(np.where(obstacle, 0.0, 1e24).astype(np.float32),
                      np.full((h, w), unit, np.float32))
    slow = np.where(obstacle, unit * 1e6, unit).astype(np.float32)
    pot = np.empty((len(geometry["waypoints"]), h, w), np.float32)
    for k, (p0, p1, width) in enumerate(geometry["waypoints"]):
        src = segment_mask(p0, p1, width, unit, h, w)
        pot[k] = fast_march(np.where(src, 0.0, F32_MAX).astype(np.float32), slow)
    return {"dist": dist, "pot": pot}


def fields(geometry: dict) -> dict[str, np.ndarray]:
    """``solve(geometry)``, read from the checkout's cache where this file
    solved the same geometry before."""
    key = hashlib.sha256(json.dumps(geometry, sort_keys=True).encode()
                         + Path(__file__).read_bytes()).hexdigest()[:24]
    path = CACHE_DIR / f"field-{key}.npz"
    if path.exists():
        with np.load(path) as z:
            return {"dist": z["dist"], "pot": z["pot"]}
    out = solve(geometry)
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npz")
    np.savez(tmp, **out)
    os.replace(tmp, path)
    return out
