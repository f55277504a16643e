"""The social-force model as one device step on flat agent tensors, in
torch (counterpart of pedoni_tpu/models/sfm.py).

Agent state, step configuration and spawn sampling, shared with the grid
backend (models/sfm_grid.py), and the flat step (``make_step``, the
reference's default ``backend="xla"``), whose phases are:

1. spawn     -- this step's Poisson arrivals per periodic group (lib.rs:
                70-84), appended past the capacity window;
2. despawn   -- agents whose destination potential is <= 0.25 (sfm.rs:69)
                or that left the neighbour grid (neighbor_grid.rs:29);
3. sort      -- a stable sort by cell id (the counting sort of sfm.rs:
                61-77); active agents compact to the front, and the tail
                past the capacity is cut (counted in ``n_dropped``);
4. forces    -- goal + obstacle + pairwise over the dense 3x3-cell layout
                (ops/forcepass.py), or over all pairs;
5. integrate -- trapezoidal with speed clamp (sfm.rs:245-254).

Randomness comes from explicit ``torch.Generator``s: the reference's
``jax.random`` streams cannot be reproduced in torch, so both steps take
their spawn candidates as an injectable ``AgentState``, and tests hold the
port's own generator to the reference only statistically.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..field import PAD, FieldMaps
from ..ops import forcepass, forces as F
from ..ops.kernels.flat_integrate import flat_integrate
from ..ops.kernels.flat_sample import flat_sample
from ..ops.kernels.flat_scatter import flat_scatter
from ..ops.neighbor import CellGrid
from ..ops.sampling import DeviceField
from ..physics import Physics
from ..scenario import Scenario
from ..utils import trace


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
    row_block: int = 4  # cell rows a block of the flat step's pair pass
    chunk_size: int = 2048  # --work-size; SimulatorOptions.row_block derives
    #                         the grid step's metric blocks from it
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
        row_block: int = 4,
        chunk_size: int = 2048,
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
            row_block=row_block,
            chunk_size=chunk_size,
            use_neighbor_grid=use_neighbor_grid,
            use_distance_map=use_distance_map,
        )

    def obstacle_arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The obstacle segments as (p0 [O, 2], p1 [O, 2], width [O]) f32."""
        obs = self.scenario.obstacles
        if not obs:
            return (np.zeros((0, 2), np.float32), np.zeros((0, 2), np.float32),
                    np.zeros((0,), np.float32))
        p0 = np.array([o.line[0] for o in obs], np.float32)
        p1 = np.array([o.line[1] for o in obs], np.float32)
        w = np.array([o.width for o in obs], np.float32)
        return p0, p1, w


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


def spawn_sampler(cfg: StepConfig, device: torch.device | str
                  ) -> Callable[[torch.Generator], AgentState]:
    """``draw(generator) -> AgentState``: this step's spawn candidates, [S]
    tensors, S = plan.total static, on ``device`` (the generator's).  The
    plan's tables are copied to the device here, once, not every step (a
    copy from the host waits for it).  Same distribution as the
    reference's ``_spawn_candidates``: a Poisson(lam) count per periodic
    group, positions uniform along the origin line, desired speed
    N(speed_mean, speed_std) clamped at 0.1."""
    plan = cfg.spawn
    s = plan.total
    dev = torch.device(device)
    if s == 0:
        z2 = torch.zeros((0, 2), dtype=torch.float32, device=dev)
        z1 = torch.zeros((0,), dtype=torch.float32, device=dev)
        empty = AgentState(z2, z2, z1,
                           torch.zeros((0,), dtype=torch.int32, device=dev),
                           torch.zeros((0,), dtype=torch.bool, device=dev))
        return lambda generator: empty

    group_np = np.concatenate(
        [np.full(cap, g, np.int64) for g, cap in enumerate(plan.caps)])
    lam, slot_in_group, group_of, p0, p1, dest = (
        torch.as_tensor(a, device=dev) for a in (
            plan.lam,
            np.concatenate([np.arange(cap, dtype=np.float32) for cap in plan.caps]),
            group_np, plan.p0[group_np], plan.p1[group_np], plan.dest[group_np]))

    def draw(generator: torch.Generator) -> AgentState:
        counts = torch.poisson(lam, generator=generator)  # [G]
        active = slot_in_group < counts[group_of]
        t = torch.rand((s,), generator=generator, device=dev)
        pos = p0 + t[:, None] * (p1 - p0)
        speed = cfg.physics.speed_mean + cfg.physics.speed_std * torch.randn(
            (s,), generator=generator, device=dev)
        speed = torch.clamp(speed, min=0.1)
        return AgentState(
            pos=pos,
            vel=torch.zeros((s, 2), dtype=torch.float32, device=dev),
            speed=speed,
            dest=dest,
            active=active,
        )

    return draw


def spawn_candidates(cfg: StepConfig, generator: torch.Generator) -> AgentState:
    """One draw of ``spawn_sampler`` on the generator's device."""
    return spawn_sampler(cfg, generator.device)(generator)


def _all_pairs_acc(cfg: StepConfig, agents: AgentState, e: torch.Tensor
                   ) -> torch.Tensor:
    """All-pairs pairwise forces, the --no-neighbor-grid path (sfm.rs:
    158-184).  O(C^2) memory and time: for small scenarios only."""
    c = cfg.capacity
    idx = torch.arange(c, device=agents.pos.device)
    cand_ok = agents.active[None, :] & (idx[None, :] != idx[:, None])
    return F.pairwise_force(agents.pos, agents.vel, e,
                            agents.pos[None].expand(c, c, 2),
                            agents.vel[None].expand(c, c, 2), cand_ok,
                            cfg.physics)


def device_inputs(cfg: StepConfig, maps: FieldMaps,
                  device: torch.device | str = "cuda"
                  ) -> tuple[DeviceField, tuple[torch.Tensor, ...]]:
    """The tensors the flat step takes as arguments on ``device``: the
    packed field maps and the obstacle segments (p0, p1, width)."""
    obstacles = tuple(torch.from_numpy(a).to(device) for a in cfg.obstacle_arrays())
    return DeviceField.from_maps(maps, device), obstacles


def _concat(a: AgentState, b: AgentState) -> AgentState:
    return AgentState(*(torch.cat([x, y.to(x.device)]) for x, y in zip(a, b)))


def make_step(cfg: StepConfig, generator: torch.Generator | None = None):
    """Build the flat step: ``step(state, field_rows, obstacles,
    candidates=None) -> (SimState, StepMetrics)``.

    ``field_rows`` and ``obstacles`` come from :func:`device_inputs`;
    everything runs on their device.  ``candidates`` injects this step's
    spawn candidates (an AgentState of the scenario's S = spawn.total
    rows); when None they are drawn from ``generator``, which must then be
    given for a spawning scenario.  No phase reads a value back to the
    host.  ``n_dropped`` counts the agents cut at the capacity, and
    ``n_overflow`` those past K in their cells, who neither exert nor
    receive pair forces this step; ``max_demand``, ``n_exited`` and
    ``max_mover_demand`` are the grid step's and stay 0 here."""
    phys = cfg.physics
    c = cfg.capacity
    grid = cfg.grid
    k = cfg.table_capacity
    s = cfg.spawn.total
    if s > 0 and generator is None:
        raise ValueError("a spawning scenario needs a torch.Generator")
    draw = spawn_sampler(cfg, generator.device) if s > 0 else None
    map_h = int(math.ceil(cfg.scenario.size[1] / cfg.field_unit)) + 2 * PAD
    map_w = int(math.ceil(cfg.scenario.size[0] / cfg.field_unit)) + 2 * PAD

    def step(state: SimState, field_rows: torch.Tensor,
             obstacles: tuple[torch.Tensor, ...],
             candidates: AgentState | None = None
             ) -> tuple[SimState, StepMetrics]:
        with trace.span("flat.step"):
            dev = field_rows.device
            zero = torch.zeros((), dtype=torch.int32, device=dev)
            ext, n_spawned = state.agents, zero
            with trace.span("flat.spawn"):
                if candidates is None and s > 0:
                    candidates = draw(generator)
                if candidates is not None:  # appended past the capacity window
                    ext = _concat(ext, candidates)
                    n_spawned = candidates.active.sum().to(torch.int32).to(dev)

            # one pass before the sort (sampling.flat_sample_torch; on the
            # card one launch of csrc/flat_sample.cu): the field sample, the
            # goal direction, despawn (arrived, sfm.rs:69, or out of the grid,
            # where the cell id's sentinel doubles as the in-grid test) and
            # every channel packed into one [*, 12] tensor, so that the cell
            # sort moves one row an agent; velocity and speed sanitized (a
            # non-finite one would poison its 3x3 neighbourhood's pair sums)
            with trace.span("flat.sample"):
                packed, cid = flat_sample(field_rows, map_h, map_w, ext.pos,
                                          ext.vel, ext.speed, ext.dest,
                                          ext.active, cfg.field_unit,
                                          phys.despawn_potential, grid)

            # cell-sort and cut back to the capacity; then one pass
            # (flat_scatter, on the card one launch of csrc/flat_scatter.cu):
            # the sorted rows, the cell layout and the padded cell grid of the
            # pair pass; the state keeps its contiguous speed, not the rows'
            # strided column
            with trace.span("flat.sort"):
                order = torch.argsort(cid, stable=True)[:c]
            with trace.span("flat.scatter"):
                sc = flat_scatter(packed, cid, order, grid, k,
                                  cells=cfg.use_neighbor_grid)
                sp = sc.rows
                agents = AgentState(pos=sp[:, 0:2], vel=sp[:, 2:4],
                                    speed=sc.speed, dest=sc.dest,
                                    active=sc.active)

            # forces: goal (sfm.rs:107-109) + obstacle (sfm.rs:188-237) +
            # pairwise over the dense cell layout, or over all pairs, then
            # the integration (flat_integrate, on the card one launch of
            # csrc/flat_integrate.cu); segment-mode obstacles and all pairs
            # are computed apart and added in their place in the sum
            with trace.span("flat.pairs"):
                if cfg.use_neighbor_grid:
                    pair_kw = dict(acc_flat=forcepass.dense_pairwise(
                        sc.data, grid, k, phys, row_block=cfg.row_block),
                        layout=sc.layout)
                    n_overflow = sc.layout.n_overflow
                else:
                    pair_kw = dict(pair=_all_pairs_acc(cfg, agents, sp[:, 7:9]))
                    n_overflow = zero
            with trace.span("flat.integrate"):
                obstacle = None
                if not cfg.use_distance_map and obstacles[0].shape[0] > 0:
                    obstacle = F.segment_obstacle_force(agents.pos, *obstacles,
                                                        phys)
                pos, vel = flat_integrate(sp, sc.active, phys, obstacle=obstacle,
                                          distance_map=cfg.use_distance_map,
                                          **pair_kw)

            with trace.span("flat.metrics"):
                n_dropped = ((cid < grid.n_cells).sum().to(torch.int32)
                             - sc.n_active)
                metrics = StepMetrics(n_active=sc.n_active, n_spawned=n_spawned,
                                      n_dropped=n_dropped, n_overflow=n_overflow,
                                      max_demand=zero, n_exited=zero,
                                      max_mover_demand=zero)
            return SimState(agents=agents._replace(pos=pos, vel=vel),
                            step=state.step + 1), metrics

    return step
