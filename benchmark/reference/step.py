"""The plain reference's step: one tick of the social-force model over flat
agent arrays, in plain PyTorch at any precision.

Physics of the reference simulator (sfm.rs:91-255, util.rs:44-75), as
``tests/oracle_sfm.py`` reads it, vectorised over agents:

- sampling at ``pos / field_unit - 0.5``, bilinear, a texel off the map
  reads 1e12; the gradient a Sobel of 8 bilinear taps at +-1 texel;
- despawn where the destination's potential is <= 0.25 or the agent is
  off the grid, before any force: outside the field's rectangle [0, w) x
  [0, h) (``outside="field"``, the reference simulator's rule and the grid
  step's), or outside the neighbour grid's whole cells (``"cells"``, the
  flat step's, whose last cells reach past the field's edge); both in f32
  as the reference computes them;
- goal (e * speed - vel) / 0.5, e the normalised Sobel of the potential;
- obstacle 10 * 0.2 * exp(-d / 0.2) along -normalise(Sobel(distance));
- pairs in the 3x3 window of neighbour cells (cell = floor(x / unit) as
  the reference's f32 divide gives it), 2 m cutoff, elliptical repulsion
  (2.1 / 0.3) exp(-b / 0.3), halved outside the 100 degree field of view;
- with ``k_cap`` (the flat step's table capacity K): an agent past the
  K-th of its cell, counted in input order, neither exerts nor receives a
  pair force (the cell table's overflow, as the reference counts it);
- vel += acc * 0.1 clamped at 1.3 * speed; pos += (vel + vel_prev) * 0.05.

Beside the result it gives each agent's ``allow``: the most that a
decision on a knife edge can move its new velocity, in m/s.  A pair whose
field-of-view test or cutoff test sits within rounding of its threshold
adds the force that flipping it would add or remove; a goal or obstacle
direction whose Sobel is near zero (one that rounding can turn by more
than ``DIR_KNIFE``) adds what turning it would.  Elsewhere the margin is
0, so the comparison sees the program's rounding.
``unsure`` marks agents whose despawn test sits within rounding of 0.25.
``scale`` is each agent's f32 rounding scale in m/s: the unit roundoff of
float32 times the sizes that its new velocity sums, each weighted by how
much its inputs' rounding grows in it: its velocity, and dt times its
goal and obstacle terms (times 1 + the ratio of the largest Sobel around
the point to the sampled one, as a direction turns under a rounded
gradient) and its pair terms (times 1 + t2^2 / 4b^2 (1 + b / 0.3), as b
= sqrt(t2^2 - |v_j dt|^2) / 2 loses digits where the two nearly cancel).
The comparison (``compare.py``) holds the program to the result beyond
these margins.
"""

from __future__ import annotations

import math

import numpy as np
import torch

FMAX = 1e12
COS_PHI = -0.17364817766693036  # cos(100 deg), sfm.rs:16
DT = 0.1
RELAX = 0.5
PED_STRENGTH = 2.1
PED_RANGE = 0.3
OBS_STRENGTH = 10.0
OBS_RANGE = 0.2
MAX_SPEED_FACTOR = 1.3
DESPAWN_POTENTIAL = 0.25
CUTOFF_SQ = 4.0
EPS = 1e-12
# Rounding margins of a program in float32: relative to the pair force for
# the field-of-view test, absolute in m^2 for the cutoff, absolute for the
# despawn potential, and the relative error of a sampled Sobel.
FOV_MARGIN = 1e-4
CUTOFF_MARGIN = 4e-6
DESPAWN_MARGIN = 1e-5
SOBEL_REL = 1e-5
DIR_KNIFE = 1e-3  # a direction that can turn by more counts as a knife edge


def cells_f32(pos: np.ndarray, unit: float) -> tuple[np.ndarray, np.ndarray]:
    """(cx, cy) int64 of f32 positions: floor of the IEEE f32 quotient."""
    p = np.asarray(pos, np.float32)
    u = np.float32(unit)
    return (np.floor(p[:, 0] / u).astype(np.int64),
            np.floor(p[:, 1] / u).astype(np.int64))


def _block(maps: torch.Tensor, sel: torch.Tensor | None, sx: torch.Tensor,
           sy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The 4x4 texels [N, 4, 4] around each sample point (rows by-1..by+2,
    columns bx-1..bx+2; off the map 1e12) and the fractions (tx, ty).
    ``maps`` [M, H, W], ``sel`` [N] the map of each agent (None: map 0)."""
    m, h, w = maps.shape
    bx, by = torch.floor(sx), torch.floor(sy)
    tx, ty = sx - bx, sy - by
    off = torch.arange(-1, 3, device=sx.device)
    ix = bx.long()[:, None] + off[None, :]  # [N, 4]
    iy = by.long()[:, None] + off[None, :]
    ok = ((ix >= 0) & (ix < w))[:, None, :] & ((iy >= 0) & (iy < h))[:, :, None]
    k = torch.zeros_like(bx, dtype=torch.long) if sel is None else sel.long()
    flat = ((k[:, None, None] * h + iy.clamp(0, h - 1)[:, :, None]) * w
            + ix.clamp(0, w - 1)[:, None, :])
    vals = maps.reshape(-1)[flat]
    return torch.where(ok, vals, torch.full_like(vals, FMAX)), tx, ty


def _bilinear(b: torch.Tensor, tx, ty, ox: int, oy: int) -> torch.Tensor:
    """util.rs:44-58 at the sample point + (ox, oy) texels, from the block."""
    r, c = 1 + oy, 1 + ox
    return ((1 - ty) * (1 - tx) * b[:, r, c] + (1 - ty) * tx * b[:, r, c + 1]
            + ty * (1 - tx) * b[:, r + 1, c] + ty * tx * b[:, r + 1, c + 1])


def _sobel(b: torch.Tensor, tx, ty):
    """util.rs:61-75: (gx, gy, scale); (gx, gy) points downhill; ``scale``
    the largest Sobel at the four texels around the point, the size of
    a program's rounding in the sampled Sobel."""
    u = {(ox, oy): _bilinear(b, tx, ty, ox, oy)
         for ox in (-1, 0, 1) for oy in (-1, 0, 1) if (ox, oy) != (0, 0)}
    gx = (u[-1, -1] + 2 * u[-1, 0] + u[-1, 1]
          - u[1, -1] - 2 * u[1, 0] - u[1, 1])
    gy = (u[-1, -1] + 2 * u[0, -1] + u[1, -1]
          - u[-1, 1] - 2 * u[0, 1] - u[1, 1])
    scale = torch.zeros_like(gx)
    for r in (1, 2):
        for c in (1, 2):
            sx_ = (b[:, r - 1, c - 1] + 2 * b[:, r, c - 1] + b[:, r + 1, c - 1]
                   - b[:, r - 1, c + 1] - 2 * b[:, r, c + 1] - b[:, r + 1, c + 1])
            sy_ = (b[:, r - 1, c - 1] + 2 * b[:, r - 1, c] + b[:, r - 1, c + 1]
                   - b[:, r + 1, c - 1] - 2 * b[:, r + 1, c] - b[:, r + 1, c + 1])
            scale = torch.maximum(scale, torch.maximum(sx_.abs(), sy_.abs()))
    return gx, gy, scale


def _knife(turn: torch.Tensor) -> torch.Tensor:
    """How far (radians, at most 2) a sampled direction can turn, where
    that is past ``DIR_KNIFE``; 0 elsewhere."""
    return torch.where(turn > DIR_KNIFE, torch.clamp(turn, max=2.0),
                       torch.zeros_like(turn))


def _norm(x, y):
    return torch.sqrt(torch.clamp(x * x + y * y, min=EPS))


def step(field: dict, agents: dict, size: tuple[float, float],
         field_unit: float, cell_unit: float, k_cap: int | None = None,
         dtype: torch.dtype = torch.float64, device: str = "cpu",
         outside: str = "field", terms: torch.dtype | None = None) -> dict:
    """One tick of ``agents`` (dict of [N] / [N, 2] arrays: pos, vel,
    speed, dest, all of them live before the tick, in the program's row
    order, which ``k_cap`` counts in) on ``field`` ({"dist": [H, W], "pot":
    [n_wp, H, W]}).  Returns NumPy f64 ``pos``, ``vel``, ``alive``,
    ``allow``, ``unsure`` and ``cx``, ``cy`` (the cells of the tick).
    ``terms`` (a control's): the state, the field taps, the Sobels and
    the pair offsets stay in ``dtype``; the directions, the goal, obstacle
    and pair forces, their sums and the velocity's increment are computed
    in ``terms``, and added to the state in ``dtype``."""
    n = len(agents["speed"])
    pos32 = np.asarray(agents["pos"], np.float32).reshape(n, 2)
    lo = terms or dtype
    pos = torch.as_tensor(pos32, device=device).to(dtype)
    vel = torch.as_tensor(np.asarray(agents["vel"], np.float32).reshape(n, 2),
                          device=device).to(dtype)
    speed = torch.as_tensor(np.asarray(agents["speed"], np.float32),
                            device=device).to(dtype)
    vlo, slo = vel.to(lo), speed.to(lo)
    dest = torch.as_tensor(np.asarray(agents["dest"], np.int64), device=device)
    pot = torch.as_tensor(field["pot"], device=device).to(dtype)
    dist = torch.as_tensor(field["dist"], device=device).to(dtype)[None]
    w_m, h_m = size
    nx, ny = int(math.ceil(w_m / cell_unit)), int(math.ceil(h_m / cell_unit))

    sx = pos[:, 0] / field_unit - 0.5
    sy = pos[:, 1] / field_unit - 0.5
    bp, tx, ty = _block(pot, dest, sx, sy)
    potential = _bilinear(bp, tx, ty, 0, 0)
    cx_np, cy_np = cells_f32(pos32, cell_unit)
    cx = torch.as_tensor(cx_np, device=device)
    cy = torch.as_tensor(cy_np, device=device)
    if outside == "cells":
        in_grid = (cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny)
    elif outside == "field":
        w32, h32 = np.float32(w_m), np.float32(h_m)
        in_grid = torch.as_tensor((pos32[:, 0] >= 0) & (pos32[:, 0] < w32)
                                  & (pos32[:, 1] >= 0) & (pos32[:, 1] < h32),
                                  device=device)
    else:
        raise ValueError(f"outside must be 'field' or 'cells', not {outside!r}")
    alive = (potential > DESPAWN_POTENTIAL) & in_grid
    unsure = ((potential - DESPAWN_POTENTIAL).abs() <= DESPAWN_MARGIN) & in_grid

    # goal and obstacle terms, and how far their directions can turn
    gx, gy, gs = _sobel(bp, tx, ty)
    gn = _norm(gx, gy)
    ex, ey = (gx / gn).to(lo), (gy / gn).to(lo)
    de_goal = _knife(SOBEL_REL * gs / gn)
    ax = (ex * slo - vlo[:, 0]) / RELAX
    ay = (ey * slo - vlo[:, 1]) / RELAX
    allow = de_goal * speed / RELAX
    size_terms = (speed * (1 + gs / gn) + _norm(vel[:, 0], vel[:, 1])) / RELAX
    bd, _, _ = _block(dist, None, sx, sy)
    od = _bilinear(bd, tx, ty, 0, 0)
    ogx, ogy, ogs = _sobel(bd, tx, ty)
    on = _norm(ogx, ogy)
    mag = OBS_STRENGTH * OBS_RANGE * torch.exp(-od.to(lo) / OBS_RANGE)
    ax = ax - mag * (ogx / on).to(lo)
    ay = ay - mag * (ogy / on).to(lo)
    allow = allow + mag * _knife(SOBEL_REL * ogs / on)
    size_terms = size_terms + mag * (1 + ogs / on)

    # pairs: the live agents (within the cap) sorted by cell
    cid = torch.where(alive, cy * nx + cx, torch.full_like(cx, nx * ny))
    part = alive.clone()
    if k_cap is not None:
        order_in = torch.arange(n, device=device)
        srt = torch.argsort(cid * (n + 1) + order_in)
        cs = cid[srt]
        first = torch.ones_like(cs, dtype=torch.bool)
        first[1:] = cs[1:] != cs[:-1]
        idx = torch.arange(n, device=device)
        rank = idx - torch.cummax(torch.where(first, idx, 0), dim=0).values
        capped = torch.zeros_like(alive)
        capped[srt] = rank >= k_cap
        part = alive & ~capped
    members = torch.nonzero(part).flatten()
    mc = cid[members]
    srt = torch.argsort(mc, stable=True)
    members, mc = members[srt], mc[srt]
    counts = torch.bincount(mc, minlength=nx * ny)
    starts = torch.cumsum(counts, 0) - counts
    max_count = int(counts.max()) if counts.numel() and members.numel() else 0

    i = members
    pxi, pyi = pos[i, 0], pos[i, 1]
    exi, eyi = ex[i], ey[i]
    pax = torch.zeros_like(pxi, dtype=lo)
    pay = torch.zeros_like(pxi, dtype=lo)
    pal = torch.zeros_like(pxi)
    pabs = torch.zeros_like(pxi)
    cxi, cyi = cx[i], cy[i]
    fov_margin = FOV_MARGIN + 2 * de_goal[i]
    for dyc in (-1, 0, 1):
        for dxc in (-1, 0, 1):
            ncx, ncy = cxi + dxc, cyi + dyc
            inside = (ncx >= 0) & (ncx < nx) & (ncy >= 0) & (ncy < ny)
            nc = torch.where(inside, ncy * nx + ncx, 0)
            cnt = torch.where(inside, counts[nc], 0)
            st = starts[nc]
            for r in range(max_count):
                ok = r < cnt
                if not bool(ok.any()):
                    break
                j = members[torch.clamp(st + r, max=members.numel() - 1)]
                ok = ok & (j != i)
                dx = (pxi - pos[j, 0]).to(lo)
                dy = (pyi - pos[j, 1]).to(lo)
                d2 = dx * dx + dy * dy
                near = ok & (d2 <= CUTOFF_SQ)
                edge = ok & ((d2 - CUTOFF_SQ).abs() <= CUTOFF_MARGIN)
                d = torch.sqrt(torch.clamp(d2, min=EPS))
                vjx, vjy = vlo[j, 0], vlo[j, 1]
                t1x = dx - vjx * DT
                t1y = dy - vjy * DT
                t1l = _norm(t1x, t1y)
                t2 = d + t1l
                b = 0.5 * torch.sqrt(torch.clamp(
                    t2 * t2 - (vjx * vjx + vjy * vjy) * DT * DT, min=EPS))
                c = (PED_STRENGTH / PED_RANGE) * torch.exp(-b / PED_RANGE) \
                    * t2 / (4.0 * b)
                fx = c * (dx / d + t1x / t1l)
                fy = c * (dy / d + t1y / t1l)
                flen = _norm(fx, fy)
                s = -(exi * fx + eyi * fy) - flen * COS_PHI
                half = s < 0
                fx = torch.where(half, 0.5 * fx, fx)
                fy = torch.where(half, 0.5 * fy, fy)
                zero = torch.zeros_like(fx)
                pax = pax + torch.where(near, fx, zero)
                pay = pay + torch.where(near, fy, zero)
                cond = 1 + t2 * t2 / (4 * b * b) * (1 + b / PED_RANGE)
                pabs = pabs + torch.where(near, flen * cond, zero)
                flip = near & (s.abs() <= fov_margin * flen)
                pal = pal + torch.where(flip, 0.5 * flen, zero) \
                    + torch.where(edge, flen, zero)
    ax = ax.index_add(0, i, pax)
    ay = ay.index_add(0, i, pay)
    allow = allow.index_add(0, i, pal)
    size_terms = size_terms.index_add(0, i, pabs)
    rnd = 2.0 ** -24 * (_norm(vel[:, 0], vel[:, 1]) + DT * size_terms)

    nvx = vel[:, 0] + (ax * DT).to(dtype)
    nvy = vel[:, 1] + (ay * DT).to(dtype)
    vmax = speed * MAX_SPEED_FACTOR
    vlen = torch.sqrt(nvx * nvx + nvy * nvy)
    scale = torch.where(vlen > vmax, vmax / torch.clamp(vlen, min=EPS),
                        torch.ones_like(vlen))
    nvx, nvy = nvx * scale, nvy * scale
    npx = pos[:, 0] + (nvx + vel[:, 0]) * (DT * 0.5)
    npy = pos[:, 1] + (nvy + vel[:, 1]) * (DT * 0.5)

    def out(t):
        return t.detach().to(torch.float64).cpu().numpy()

    return {"pos": np.stack([out(npx), out(npy)], 1),
            "vel": np.stack([out(nvx), out(nvy)], 1),
            "alive": alive.cpu().numpy(), "unsure": unsure.cpu().numpy(),
            "allow": out(allow * DT), "scale": out(rnd),
            "cx": cx_np, "cy": cy_np}
