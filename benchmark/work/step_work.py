"""The work one step of the social-force model needs, counted from the
problem (agents, field texels, the reference's neighbour window), not from
any layout of the program: the yardstick of ``step_roofline``.

Bytes: each live agent's state read once (pos 8, vel 8, desired speed 4,
destination 4 = 24 B) and what the step changes written once (pos, vel =
16 B); each f32 texel that the reference's taps touch read once: the
bilinear and Sobel taps at a sample point (8 bilinear taps at +-1 texel
and the centre) cover the 4 x 4 texels around it, in the potential map of
the agent's destination and in the distance map, counted once however
many agents touch them.

Operations (a divide, square root, exp or compare counts as one):

- a candidate test, for every other agent in the 3 x 3 neighbour cells at
  the cell's own unit: dx, dy, dx^2, dy^2, their sum, the cutoff compare
  = 6 (``TEST_OPS``);
- a pair within the 2 m cutoff, beyond its test (oracle_sfm.py): d =
  sqrt(max(d2, eps)) 2; the unit direction 2; t1 = diff - v_j dt 4; |t1|
  5; t2 1; |v_j|^2 3; b = sqrt(t2^2 - |v_j|^2 dt^2) / 2 6; the magnitude
  (2.1 / 0.3) exp(-b / 0.3) t2 / (4 b) 6; the force c (dir + t1 / |t1|) 6;
  the field-of-view test |f|, e . f, compare 9; the halving 2; the sum 2
  = 48 (``PAIR_OPS``);
- an agent, beside its pairs: the sample point 4; per map (potential,
  distance) four bilinear weights 6, nine bilinear taps 63, the Sobel's
  two sums 14 = 83, twice 166; two normalisations 14; the despawn test 1;
  the goal term 6; the obstacle term 9; the integration with its speed
  clamp 19 = 219 (``AGENT_OPS``).

The bound of a step is the larger of its bytes at the card's memory
bandwidth and its operations at its f32 rate (H100 SXM: 3.35 TB/s, 67
TFLOP/s without the tensor cores; ``PEAKS``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

STATE_READ_BYTES = 24
STATE_WRITE_BYTES = 16
TEXEL_BYTES = 4
TEST_OPS = 6
PAIR_OPS = 48
AGENT_OPS = 219
CUTOFF_SQ = 4.0
PEAKS = {"bytes_per_s": 3.35e12, "ops_per_s": 67e12,
         "card": "NVIDIA H100 SXM (80 GB HBM3)"}


def _cells(pos: np.ndarray, unit: float) -> tuple[np.ndarray, np.ndarray]:
    p = np.asarray(pos, np.float32)
    u = np.float32(unit)
    return (np.floor(p[:, 0] / u).astype(np.int64),
            np.floor(p[:, 1] / u).astype(np.int64))


def pairs(pos: np.ndarray, size, cell_unit: float, device: str = "cpu"
          ) -> tuple[int, int]:
    """(candidate tests, pairs within the cutoff) of live agents at
    ``pos`` [N, 2] in the reference's 3x3 window of ``cell_unit`` cells."""
    n = len(pos)
    if n == 0:
        return 0, 0
    nx = int(math.ceil(size[0] / cell_unit))
    ny = int(math.ceil(size[1] / cell_unit))
    cx_np, cy_np = _cells(pos, cell_unit)
    p = torch.as_tensor(np.asarray(pos, np.float64), device=device)
    cx = torch.as_tensor(cx_np, device=device)
    cy = torch.as_tensor(cy_np, device=device)
    ok = (cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny)
    members = torch.nonzero(ok).flatten()
    cid = (cy * nx + cx)[members]
    srt = torch.argsort(cid, stable=True)
    members, cid = members[srt], cid[srt]
    counts = torch.bincount(cid, minlength=nx * ny)
    starts = torch.cumsum(counts, 0) - counts
    max_count = int(counts.max())
    i = members
    tests = within = 0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            ncx, ncy = cx[i] + dx, cy[i] + dy
            inside = (ncx >= 0) & (ncx < nx) & (ncy >= 0) & (ncy < ny)
            nc = torch.where(inside, ncy * nx + ncx, 0)
            cnt = torch.where(inside, counts[nc], 0)
            st = starts[nc]
            for r in range(max_count):
                live = (r < cnt)
                if not bool(live.any()):
                    break
                j = members[torch.clamp(st + r, max=members.numel() - 1)]
                live = live & (j != i)
                d = p[i] - p[j]
                d2 = (d * d).sum(1)
                tests += int(live.sum())
                within += int((live & (d2 <= CUTOFF_SQ)).sum())
    return tests, within


def texels(pos: np.ndarray, dest: np.ndarray, geometry: dict,
           device: str = "cpu") -> tuple[int, int]:
    """(potential texels, distance texels) the taps at ``pos`` touch: the
    4 x 4 texels around each sample point pos / unit - 0.5, within the
    map."""
    unit = float(geometry["unit"])
    w = int(math.ceil(geometry["size"][0] / unit))
    h = int(math.ceil(geometry["size"][1] / unit))
    n_wp = max(len(geometry["waypoints"]), 1)
    p = torch.as_tensor(np.asarray(pos, np.float64), device=device)
    k = torch.as_tensor(np.asarray(dest, np.int64), device=device)
    bx = torch.floor(p[:, 0] / unit - 0.5).long() - 1
    by = torch.floor(p[:, 1] / unit - 0.5).long() - 1
    pot = torch.zeros((n_wp, h, w), dtype=torch.bool, device=device)
    dist = torch.zeros((h, w), dtype=torch.bool, device=device)
    for oy in range(4):
        for ox in range(4):
            x, y = bx + ox, by + oy
            ok = (x >= 0) & (x < w) & (y >= 0) & (y < h)
            pot[k[ok], y[ok], x[ok]] = True
            dist[y[ok], x[ok]] = True
    return int(pot.sum()), int(dist.sum())


def count(rows: dict, geometry: dict, cell_unit: float, device: str = "cpu"
          ) -> dict:
    """The needed work of one step from the live agents ``rows`` (pos,
    dest): bytes, operations and the counts they come from."""
    n = len(rows["pos"])
    tests, within = pairs(rows["pos"], geometry["size"], cell_unit, device)
    tp, td = texels(rows["pos"], rows["dest"], geometry, device)
    return {"agents": n, "tests": tests, "pairs": within,
            "texels": tp + td,
            "bytes": n * (STATE_READ_BYTES + STATE_WRITE_BYTES)
            + TEXEL_BYTES * (tp + td),
            "ops": tests * TEST_OPS + within * PAIR_OPS + n * AGENT_OPS}


def bound_seconds(work: dict) -> tuple[float, str]:
    """The least time of ``work`` on the card, and what bounds it."""
    tb = work["bytes"] / PEAKS["bytes_per_s"]
    to = work["ops"] / PEAKS["ops_per_s"]
    return (tb, "bytes") if tb >= to else (to, "operations")
