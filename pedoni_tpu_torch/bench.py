"""The headline workload of the reference's bench.py, without JAX.

``build_problem`` builds the same problem as bench.py:33-143 for the grid
backend: N agents uniformly placed on an open field of density
``density`` agents/m^2, all walking to a goal edge, one central obstacle.
The ``auto`` domain is the reference's lane-exact rectangle: nx + 3 cell
columns a multiple of 128 (1024 lanes when the field keeps >= 16 cell
rows), same area, density and physics.  At 1M agents and density 2.5 that
is 1021 x 175 cells of 1.5 m, K = 14, one waypoint.
"""

from __future__ import annotations

import numpy as np
import torch

from .convert import agents_from_numpy
from .field import Field, FieldMaps
from .models.sfm import SimState, StepConfig
from .scenario import Scenario, Segment


def build_problem(n_agents: int = 1_000_000, density: float = 2.5,
                  seed: int = 0, table_capacity: int = 14,
                  device: torch.device | str = "cuda", waypoints: int = 1
                  ) -> tuple[Scenario, FieldMaps, StepConfig, SimState]:
    """(scenario, maps, cfg, flat state on ``device``) of the bench
    workload; the agents are drawn from ``seed`` with NumPy exactly as the
    reference draws them."""
    area = n_agents / density
    unit = 1.5
    for t in range(8, 0, -1):
        nx = t * 128 - 3
        w = nx * unit
        h = area / w
        if h / unit >= 16 or t == 1:
            break
    ys = np.linspace(1.0, h - 1.0, waypoints + 1)
    scenario = Scenario(
        size=(w, h),
        waypoints=tuple(
            Segment(line=((1.0, float(ys[i])), (1.0, float(ys[i + 1]))),
                    width=1.0)
            for i in range(waypoints)),
        obstacles=(
            Segment(line=((w / 2, h / 4), (w / 2, h / 2)), width=2.0),
        ),
        pedestrians=(),
    )
    maps = FieldMaps.from_field(Field.from_scenario(scenario, unit=0.25))

    capacity = 1
    while capacity < n_agents:
        capacity *= 2
    cfg = StepConfig.build(scenario, capacity=capacity, neighbor_grid_unit=unit,
                           table_capacity=table_capacity)

    rng = np.random.default_rng(seed)
    pos = np.stack([
        rng.uniform(2.0, w - 2.0, size=capacity),
        rng.uniform(2.0, h - 2.0, size=capacity),
    ], axis=1).astype(np.float32)
    speed = np.clip(rng.normal(1.34, 0.26, capacity), 0.1, None).astype(np.float32)
    if waypoints > 1:
        dest = np.clip(np.searchsorted(ys[1:-1], pos[:, 1]), 0,
                       waypoints - 1).astype(np.int32)
    else:
        dest = np.zeros((capacity,), np.int32)
    active = np.arange(capacity) < n_agents
    agents = agents_from_numpy(pos, np.zeros_like(pos), speed, dest, active,
                               device)
    return scenario, maps, cfg, SimState(agents=agents, step=0)
