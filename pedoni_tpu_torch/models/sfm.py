"""Agent state, step configuration and spawn sampling, in torch.

Counterpart of the pieces of pedoni_tpu/models/sfm.py that the grid
backend uses.  Randomness comes from explicit ``torch.Generator``s: the
reference's ``jax.random`` streams cannot be reproduced in torch, so the
grid step takes its spawn candidates as an injectable ``AgentState`` and
tests hold the port's own generator to the reference only statistically.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops.neighbor import CellGrid
from ..physics import Physics
from ..scenario import Scenario


class AgentState(NamedTuple):
    """SoA agent tensors, fixed capacity (sfm.rs:26-33 analog)."""

    pos: torch.Tensor  # [C, 2] f32
    vel: torch.Tensor  # [C, 2] f32
    speed: torch.Tensor  # [C] f32 desired speed
    dest: torch.Tensor  # [C] i32 destination waypoint id
    active: torch.Tensor  # [C] bool

    def to(self, device: torch.device | str) -> "AgentState":
        return AgentState(*(t.to(device) for t in self))


class SimState(NamedTuple):
    agents: AgentState
    step: int


class StepMetrics(NamedTuple):
    """Per-step metrics as 0-d i32 tensors on the step's device (no host
    sync until a caller reads them).  Same fields as the reference."""

    n_active: torch.Tensor
    n_spawned: torch.Tensor
    n_dropped: torch.Tensor  # spawn candidates dropped into full cells
    n_overflow: torch.Tensor  # agents dropped at the rebin (cell full)
    max_demand: torch.Tensor  # peak un-clamped per-cell demand
    n_exited: torch.Tensor  # agents that walked off the field
    max_mover_demand: torch.Tensor  # peak movers of a cell (hybrid step; else 0)


def _spawn_cap(lam: float) -> int:
    """Static per-step candidate cap for a Poisson(lam) arrival count.
    P(X > lam + 6 sqrt(lam) + 6) is negligible (< 1e-8 per step)."""
    return int(math.ceil(lam + 6.0 * math.sqrt(max(lam, 0.0)) + 6.0))


@dataclasses.dataclass(frozen=True)
class SpawnPlan:
    """Static spawn tables derived from the scenario's periodic groups."""

    p0: np.ndarray  # [G, 2] origin line start
    p1: np.ndarray  # [G, 2] origin line end
    lam: np.ndarray  # [G] Poisson rate per step (frequency * dt)
    dest: np.ndarray  # [G] destination ids
    caps: tuple[int, ...]  # static per-group candidate caps

    @property
    def total(self) -> int:
        return sum(self.caps)

    @classmethod
    def from_scenario(cls, scenario: Scenario, phys: Physics) -> "SpawnPlan":
        groups = scenario.periodic_groups
        if not groups:
            return cls(
                p0=np.zeros((0, 2), np.float32),
                p1=np.zeros((0, 2), np.float32),
                lam=np.zeros((0,), np.float32),
                dest=np.zeros((0,), np.int32),
                caps=(),
            )
        p0 = np.array([scenario.waypoints[g.origin].line[0] for g in groups], np.float32)
        p1 = np.array([scenario.waypoints[g.origin].line[1] for g in groups], np.float32)
        lam = np.array(
            [g.spawn.frequency * phys.spawn_rate_scale for g in groups], np.float32
        )
        dest = np.array([g.destination for g in groups], np.int32)
        caps = tuple(_spawn_cap(float(l)) for l in lam)
        return cls(p0=p0, p1=p1, lam=lam, dest=dest, caps=caps)


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """Everything static the step function needs."""

    scenario: Scenario
    physics: Physics
    capacity: int
    grid: CellGrid
    spawn: SpawnPlan
    field_unit: float
    table_capacity: int = 16
    use_neighbor_grid: bool = True
    use_distance_map: bool = True

    @classmethod
    def build(
        cls,
        scenario: Scenario,
        physics: Physics = Physics(),
        capacity: int = 4096,
        neighbor_grid_unit: float = 1.4,
        field_unit: float = 0.25,
        table_capacity: int = 16,
        use_neighbor_grid: bool = True,
        use_distance_map: bool = True,
    ) -> "StepConfig":
        return cls(
            scenario=scenario,
            physics=physics,
            capacity=capacity,
            grid=CellGrid.for_size(scenario.size, neighbor_grid_unit),
            spawn=SpawnPlan.from_scenario(scenario, physics),
            field_unit=field_unit,
            table_capacity=table_capacity,
            use_neighbor_grid=use_neighbor_grid,
            use_distance_map=use_distance_map,
        )


def make_initial_state(cfg: StepConfig, generator: torch.Generator,
                       device: torch.device | str) -> SimState:
    """Initial state: agents from every ``once`` spawn group placed along
    their origin waypoint line (lib.rs:37-52).  Draws from ``generator``
    (on the generator's device) and returns tensors on ``device``."""
    c = cfg.capacity
    gdev = generator.device
    pos = torch.zeros((c, 2), dtype=torch.float32, device=gdev)
    speed = torch.full((c,), cfg.physics.speed_mean, dtype=torch.float32,
                       device=gdev)
    dest = torch.zeros((c,), dtype=torch.int32, device=gdev)
    active = torch.zeros((c,), dtype=torch.bool, device=gdev)

    i = 0
    for g in cfg.scenario.once_groups:
        n = g.spawn.count
        if i + n > c:
            raise ValueError(
                f"capacity {c} too small for {sum(x.spawn.count for x in cfg.scenario.once_groups)} once-spawned agents"
            )
        t = torch.rand((n,), generator=generator, device=gdev)
        a = torch.tensor(cfg.scenario.waypoints[g.origin].line[0],
                         dtype=torch.float32, device=gdev)
        b = torch.tensor(cfg.scenario.waypoints[g.origin].line[1],
                         dtype=torch.float32, device=gdev)
        pos[i : i + n] = a[None, :] + t[:, None] * (b - a)[None, :]
        sp = cfg.physics.speed_mean + cfg.physics.speed_std * torch.randn(
            (n,), generator=generator, device=gdev)
        speed[i : i + n] = torch.clamp(sp, min=0.1)
        dest[i : i + n] = g.destination
        active[i : i + n] = True
        i += n

    agents = AgentState(pos=pos, vel=torch.zeros_like(pos), speed=speed,
                        dest=dest, active=active)
    return SimState(agents=agents.to(device), step=0)


def spawn_candidates(cfg: StepConfig, generator: torch.Generator) -> AgentState:
    """Sample this step's spawn candidates: [S] tensors, S = plan.total
    static, on the generator's device.  Same distribution as the
    reference's ``_spawn_candidates``: a Poisson(lam) count per periodic
    group, positions uniform along the origin line, desired speed
    N(speed_mean, speed_std) clamped at 0.1."""
    plan = cfg.spawn
    s = plan.total
    dev = generator.device
    if s == 0:
        z2 = torch.zeros((0, 2), dtype=torch.float32, device=dev)
        z1 = torch.zeros((0,), dtype=torch.float32, device=dev)
        return AgentState(z2, z2, z1, torch.zeros((0,), dtype=torch.int32, device=dev),
                          torch.zeros((0,), dtype=torch.bool, device=dev))

    lam = torch.as_tensor(plan.lam, device=dev)
    counts = torch.poisson(lam, generator=generator)  # [G]
    group_of = torch.as_tensor(np.concatenate(
        [np.full(cap, g, np.int64) for g, cap in enumerate(plan.caps)]), device=dev)
    slot_in_group = torch.as_tensor(np.concatenate(
        [np.arange(cap, dtype=np.float32) for cap in plan.caps]), device=dev)
    active = slot_in_group < counts[group_of]

    t = torch.rand((s,), generator=generator, device=dev)
    p0 = torch.as_tensor(plan.p0, device=dev)[group_of]
    p1 = torch.as_tensor(plan.p1, device=dev)[group_of]
    pos = p0 + t[:, None] * (p1 - p0)
    speed = cfg.physics.speed_mean + cfg.physics.speed_std * torch.randn(
        (s,), generator=generator, device=dev)
    speed = torch.clamp(speed, min=0.1)
    dest = torch.as_tensor(plan.dest, device=dev)[group_of]
    return AgentState(
        pos=pos,
        vel=torch.zeros((s, 2), dtype=torch.float32, device=dev),
        speed=speed,
        dest=dest,
        active=active,
    )
