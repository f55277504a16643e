"""The open-field crowd of the reference bench (its bench.py:33-143), from
a configuration and a seed, in NumPy alone.

N agents placed uniformly on an open field of ``density`` agents/m^2, all
bound for the exit edge at x = 1 m (with W > 1 waypoints, each to its own
band of it), one 2 m wide obstacle across the middle, desired speeds
N(1.34, 0.26) clipped at 0.1, drawn from ``np.random.default_rng(seed)``
in the bench's order.  The traffic file gives the path's domain and cell
unit, as the bench builds them for that path: ``square`` (the square
field of the same area) or ``auto`` (the lane-exact rectangle: nx + 3
cell columns a multiple of 128, the widest of 8..1 such tiles that keeps
16 cell rows).  The same draws as ``pedoni_tpu_torch.bench.build_problem``,
bit for bit (benchmark/tests hold the two equal).
"""

from __future__ import annotations

import numpy as np


def domain(area: float, shape: str, cell_unit: float) -> tuple[float, float]:
    """(w, h) in metres of a field of ``area`` m^2."""
    if shape == "square":
        w = h = float(np.sqrt(area))
        return w, h
    if shape != "auto":
        raise ValueError(f"domain shape must be 'square' or 'auto', not {shape!r}")
    for t in range(8, 0, -1):
        w = (t * 128 - 3) * cell_unit
        h = area / w
        if h / cell_unit >= 16 or t == 1:
            break
    return w, h


def generate(config: dict, traffic: dict, seed: int) -> dict:
    """The problem of ``config`` in the domain and at the cell unit of
    ``traffic``: geometry, the cell unit, K, the capacity and the agents
    (NumPy, f32 / i32 / bool)."""
    n = int(config["agents"])
    cell_unit = float(traffic["cell_unit"])
    w, h = domain(n / float(config["density"]), traffic["domain"], cell_unit)
    n_wp = int(config["waypoints"])
    ys = np.linspace(1.0, h - 1.0, n_wp + 1)
    capacity = 1
    while capacity < n:
        capacity *= 2
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(2.0, w - 2.0, size=capacity),
                    rng.uniform(2.0, h - 2.0, size=capacity)],
                   axis=1).astype(np.float32)
    speed = np.clip(rng.normal(1.34, 0.26, capacity), 0.1, None).astype(np.float32)
    if n_wp > 1:
        dest = np.clip(np.searchsorted(ys[1:-1], pos[:, 1]), 0,
                       n_wp - 1).astype(np.int32)
    else:
        dest = np.zeros((capacity,), np.int32)
    return {
        "geometry": {
            "size": [w, h], "unit": float(config["field_unit"]),
            "waypoints": [[[1.0, float(ys[i])], [1.0, float(ys[i + 1])], 1.0]
                          for i in range(n_wp)],
            "obstacles": [[[w / 2, h / 4], [w / 2, h / 2], 2.0]],
        },
        "groups": [],
        "cell_unit": cell_unit,
        "table_capacity": int(config["table_capacity"]),
        "capacity": capacity,
        "agents": {"pos": pos, "vel": np.zeros_like(pos), "speed": speed,
                   "dest": dest, "active": np.arange(capacity) < n},
    }
