"""The flat step cut into x-strips, one a device, with agent packages sent
between neighbour strips.

Counterpart of pedoni_tpu/parallel/spatial.py, the reference's round-1
multi-device path for its XLA backend (the reference's spatial step runs
no ``pallas_call``; here each strip runs the flat step's four kernels on
a card, one launch each a strip-step: csrc/flat_sample.cu before the
packages, then csrc/flat_scatter.cu after the sort, csrc/flat_pairwise.cu
for the pair pass and csrc/flat_integrate.cu).  The
field is split into D vertical strips along x; strip d owns the agents
inside [d * w / D, (d + 1) * w / D) (the last also everything to its
right) as a fixed-capacity flat shard on its device.  A step, for every
strip of this process (``step``):

1. spawn   -- every strip sees the same candidates, drawn once a step from
              one generator (across processes: from generators of the same
              seed, the reference's replicated key) or injected, and claims
              those in its strip;
2. despawn -- one field sample (potential, goal direction, obstacle
              distance) and the packed rows, the flat step's pass before
              its sort (one launch of csrc/flat_sample.cu on a card);
3. package -- emigrants first, then agents within the halo (the 2 m
              interaction cutoff) of a strip edge, compacted into a
              fixed-size package for each neighbour and sent through the
              transport (parallel/transport.py): strip 0's left and the
              last strip's right packages arrive as zeros.  Emigrants that
              do not fit stay alive locally and are counted in
              ``n_overflow``, with the ghosts the package truncated;
4. forces  -- one stable cell sort of owned, adopted and ghost rows over the
              strip's local window (strip + halo margin), the flat step's
              scatter, dense pair pass and integration over that window;
5. compact -- surviving owned agents back into the shard, cell-sorted.

The rows are the reference's packed [*, 12] f32 layout: 0:2 pos, 2:4 vel,
4 speed, 5 dest, 6 alive, 7:9 goal direction, 9 obstacle distance, 10:12
its Sobel.  Every compaction scatters into a buffer with one dump row past
its capacity (the reference's ``mode="drop"``): the real slots get unique
indices, the rest go to the dump row, which is cut off.

Owned agents near a strip edge see the same neighbours (own + ghosts) as
one flat step would, so D strips equal the flat step up to the order of
float sums.  ``StepMetrics`` holds the reference's four fields
(``n_active``, ``n_spawned``, ``n_dropped``: agents past a shard's
capacity, ``n_overflow``: cell-table overflow plus package saturation) and
zeros, as the port's flat step does.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..field import PAD, Field, FieldMaps
from ..models.sfm import (AgentState, SimState, StepConfig, StepMetrics,
                          device_inputs as flat_device_inputs,
                          make_initial_state, spawn_sampler)
from ..ops import forcepass, forces as F
from ..ops.kernels.flat_integrate import flat_integrate
from ..ops.kernels.flat_sample import flat_sample
from ..ops.kernels.flat_scatter import flat_scatter
from ..ops.neighbor import CellGrid, true_divide
from ..scenario import loads_scenario
from .transport import Local, Transport, all_reduce_metrics, check_replicated

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class ShardedConfig:
    """Static layout of the strip decomposition (the reference's
    spatial.py:60-100)."""

    base: StepConfig
    n_devices: int
    local_capacity: int  # capacity a strip
    package_capacity: int  # most agents sent each way a step
    halo: float  # halo width in meters (>= interaction cutoff)
    strip_width: float
    local_grid: CellGrid  # cell window covering strip + halo margin
    margin_cells: int

    @classmethod
    def build(cls, cfg: StepConfig, n_devices: int,
              package_capacity: int = 0) -> "ShardedConfig":
        if cfg.capacity % n_devices != 0:
            raise ValueError("capacity must divide by the device count")
        local_capacity = cfg.capacity // n_devices
        halo = cfg.physics.interaction_cutoff
        w, _h = cfg.scenario.size
        strip_width = w / n_devices
        unit = cfg.grid.unit
        margin_cells = int(math.ceil(halo / unit)) + 1
        nx_local = int(math.ceil(strip_width / unit)) + 2 * margin_cells + 1
        local_grid = CellGrid(unit=unit, nx=nx_local, ny=cfg.grid.ny)
        if not package_capacity:
            package_capacity = max(32, local_capacity // 4)
        return cls(base=cfg, n_devices=n_devices, local_capacity=local_capacity,
                   package_capacity=package_capacity, halo=halo,
                   strip_width=strip_width, local_grid=local_grid,
                   margin_cells=margin_cells)

    def origin_cell(self, d: int) -> int:
        """The global cell column of strip d's local window's first column:
        ``margin_cells`` left of the column holding x_lo.  The reference
        starts the window at x_lo - margin * unit (spatial.py:270), off the
        global cell grid wherever the strip width is not a multiple of the
        cell; its 3x3 windows then hold other neighbours than one device's
        (pairs 1.4 to 2 m apart in x), against its own claim that strips
        equal one device up to the order of float sums.  Starting on a
        global cell edge makes each owned agent's window one device's."""
        x_lo = self.bounds(d)[0]
        return math.floor(np.float32(x_lo) / np.float32(self.base.grid.unit)) \
            - self.margin_cells

    def bounds(self, d: int) -> tuple[float, float, float]:
        """(x_lo, x_hi, claim_hi) of strip d, rounded as the reference's f32
        arithmetic rounds them; the last strip claims everything to its
        right (spatial.py:170-174)."""
        x_lo = np.float32(d) * np.float32(self.strip_width)
        x_hi = x_lo + np.float32(self.strip_width)
        claim_hi = np.float32(1e30) if d == self.n_devices - 1 else x_hi
        return float(x_lo), float(x_hi), float(claim_hi)


class ShardedState(NamedTuple):
    agents: tuple[AgentState, ...]  # one [local_capacity] shard a strip of
    #                                 this process, in strip order
    step: int


def _transport(scfg: ShardedConfig, transport: Transport | None) -> Transport:
    if transport is None:
        return Local(scfg.n_devices)
    if transport.n_tiles != scfg.n_devices:
        raise ValueError(f"{scfg.n_devices} strips, and the transport has "
                         f"{transport.n_tiles} tiles")
    return transport


def device_inputs(scfg: ShardedConfig, maps: FieldMaps,
                  devices: Sequence[torch.device | str]
                  ) -> tuple[list[torch.Tensor], list[tuple[torch.Tensor, ...]]]:
    """The flat step's arguments (``models.sfm.device_inputs``: the packed
    field rows and the obstacle segments) for each strip of ``devices``,
    one copy a device."""
    by_dev = {}
    for dev in map(torch.device, devices):
        if dev not in by_dev:
            field, obstacles = flat_device_inputs(scfg.base, maps, dev)
            by_dev[dev] = (field.rows, obstacles)
    pairs = [by_dev[torch.device(dev)] for dev in devices]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _unpack(rows: torch.Tensor) -> AgentState:
    return AgentState(pos=rows[:, 0:2], vel=rows[:, 2:4], speed=rows[:, 4],
                      dest=rows[:, 5].to(torch.int32), active=rows[:, 6] > 0.5)


def _scatter(dst: torch.Tensor, capacity: int, rows: torch.Tensor) -> torch.Tensor:
    """rows to their ``dst`` slots in a [capacity, 12] buffer; ``dst`` is
    ``capacity`` (the dump row, cut off) for rows without a slot."""
    out = torch.zeros((capacity + 1, rows.shape[1]), dtype=rows.dtype,
                      device=rows.device)
    return out.index_copy_(0, dst, rows)[:capacity]


def _compact_rows(mask: torch.Tensor, capacity: int, rows: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable-compact the rows where ``mask`` into [capacity, 12]:
    (compacted, 0-d i32 rows lost past the capacity).  Order is kept, so
    cell-sorted rows stay cell-sorted."""
    dst = torch.cumsum(mask.to(torch.int32), 0) - 1
    dst = torch.where(mask & (dst < capacity), dst, capacity).long()
    total = mask.sum()
    return (_scatter(dst, capacity, rows),
            (total - torch.clamp(total, max=capacity)).to(torch.int32))


def _pack_priority(rows: torch.Tensor, emig: torch.Tensor, ghost: torch.Tensor,
                   pk: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Emigrants first, then ghosts, compacted into [pk] rows (spatial.py:
    200-216): (package, emigrants shipped, 0-d ghosts that did not fit)."""
    e = emig.to(torch.int32)
    g = ghost.to(torch.int32)
    dst_e = torch.cumsum(e, 0) - 1
    dst_g = e.sum() + torch.cumsum(g, 0) - 1
    dst = torch.where(emig, dst_e, torch.where(ghost, dst_g, pk))
    dst = torch.where(dst < pk, dst, pk).long()
    return (_scatter(dst, pk, rows), emig & (dst_e < pk),
            (ghost & (dst_g >= pk)).sum().to(torch.int32))


def make_sharded_step(scfg: ShardedConfig, devices: Sequence[torch.device | str],
                      generator: torch.Generator | None = None,
                      transport: Transport | None = None):
    """Build the strip step: ``step(state, field_rows, obstacles,
    candidates=None) -> (ShardedState, StepMetrics)``, ``devices`` one for
    each strip of this process (``transport.tiles``; every strip without a
    transport), ``field_rows`` and ``obstacles`` lists from
    :func:`device_inputs`.  ``candidates`` injects this step's spawn
    candidates, else they are drawn from ``generator``, as in
    ``models.sfm.make_step``.  The metrics are reduced over every strip, on
    the first strip's device, and over every process."""
    cfg = scfg.base
    phys = cfg.physics
    unit = cfg.grid.unit
    lgrid = scfg.local_grid
    cl, pk = scfg.local_capacity, scfg.package_capacity
    transport = _transport(scfg, transport)
    own = transport.tiles
    devices = [torch.device(dv) for dv in devices[: len(own)]]
    if len(devices) < len(own):
        raise ValueError(f"{len(own)} strips in this process need {len(own)} "
                         f"devices, got {len(devices)}")
    s = cfg.spawn.total
    if s > 0 and generator is None:
        raise ValueError("a spawning scenario needs a torch.Generator")
    draw = spawn_sampler(cfg, generator.device) if s > 0 else None
    map_h = int(math.ceil(cfg.scenario.size[1] / cfg.field_unit)) + 2 * PAD
    map_w = int(math.ceil(cfg.scenario.size[0] / cfg.field_unit)) + 2 * PAD
    bounds = [scfg.bounds(d) for d in own]
    origins = [scfg.origin_cell(d) for d in own]
    right = [(d, d + 1) for d in range(scfg.n_devices - 1)]
    left = [(b, a) for a, b in right]
    home = devices[0]

    def emit(agents: AgentState, cand: AgentState | None, field_rows, bnd):
        """Phases 1-3 before the send: (rows, left package, right package,
        bookkeeping for ``absorb``)."""
        x_lo, x_hi, claim_hi = bnd
        dev = field_rows.device
        n_spawned = torch.zeros((), dtype=torch.int32, device=dev)
        if cand is not None:
            cand = cand.to(dev)
            cx = cand.pos[:, 0]
            cand = cand._replace(active=cand.active & (cx >= x_lo) & (cx < claim_hi))
            n_spawned = cand.active.sum().to(torch.int32)
            agents = AgentState(*(torch.cat([a, c]) for a, c in zip(agents, cand)))
        # the flat step's pass before its sort (csrc/flat_sample.cu on a
        # card), unsanitized: alive = not arrived and inside the global grid
        rows, cid = flat_sample(field_rows, map_h, map_w, agents.pos, agents.vel,
                                agents.speed, agents.dest, agents.active,
                                cfg.field_unit, phys.despawn_potential, cfg.grid,
                                sanitize=False)
        alive = cid < cfg.grid.n_cells
        x = agents.pos[:, 0]
        stays = (x >= x_lo) & (x < claim_hi)
        emig_l = alive & ~stays & (x < x_lo)
        emig_r = alive & ~stays & (x >= x_lo)
        ghost_l = alive & stays & (x < float(np.float32(x_lo) + np.float32(scfg.halo)))
        ghost_r = alive & stays & (x >= float(np.float32(x_hi) - np.float32(scfg.halo)))
        pkg_l, shipped_l, lost_gl = _pack_priority(rows, emig_l, ghost_l, pk)
        pkg_r, shipped_r, lost_gr = _pack_priority(rows, emig_r, ghost_r, pk)
        n_deferred = ((emig_l & ~shipped_l).sum()
                      + (emig_r & ~shipped_r).sum()).to(torch.int32)
        # only the emigrants that shipped leave; the rest retry next step
        rows[:, 6] = (alive & (stays | ~(shipped_l | shipped_r))).to(torch.float32)
        return rows, pkg_l, pkg_r, (n_spawned, n_deferred + lost_gl + lost_gr)

    def absorb(rows, recv_l, recv_r, obstacles, bnd, origin_cell):
        """Phases 4-5 after the receive: (shard, [n_active, n_lost,
        n_overflow of the cell table])."""
        x_lo, _, claim_hi = bnd

        def adopted(recv):
            return (recv[:, 0] >= x_lo) & (recv[:, 0] < claim_hi)

        work = torch.cat([rows, recv_l, recv_r])
        owned = torch.cat([torch.ones_like(rows[:, 0], dtype=torch.bool),
                           adopted(recv_l), adopted(recv_r)])
        alive = work[:, 6] > 0.5
        cx = torch.floor(true_divide(work[:, 0], unit)) - origin_cell
        cy = torch.floor(true_divide(work[:, 1], unit))
        ok = alive & (cx >= 0) & (cx < lgrid.nx) & (cy >= 0) & (cy < lgrid.ny)
        cid = torch.where(ok, cy.clamp(0, lgrid.ny - 1).to(torch.int32) * lgrid.nx
                          + cx.clamp(0, lgrid.nx - 1).to(torch.int32), lgrid.n_cells)
        order = torch.sort(cid, stable=True).indices
        # the flat step's pass after its sort (csrc/flat_scatter.cu on a
        # card) over the strip's window, its pair pass and its integration
        # (csrc/flat_integrate.cu)
        k = cfg.table_capacity
        sc = flat_scatter(work, cid, order, lgrid, k)
        owned = owned.index_select(0, order)
        obstacle = None
        if not cfg.use_distance_map and obstacles[0].shape[0] > 0:
            obstacle = F.segment_obstacle_force(sc.rows[:, 0:2], *obstacles, phys)
        acc_flat = forcepass.dense_pairwise(sc.data, lgrid, k, phys,
                                            row_block=cfg.row_block)
        pos, vel = flat_integrate(sc.rows, sc.active, phys, acc_flat=acc_flat,
                                  layout=sc.layout, obstacle=obstacle,
                                  distance_map=cfg.use_distance_map)
        work = torch.cat([pos, vel, sc.rows[:, 4:]], dim=1)
        out, n_lost = _compact_rows(owned & sc.active, cl, work)
        shard = _unpack(out)
        return shard, (shard.active.sum().to(torch.int32), n_lost,
                       sc.layout.n_overflow)

    def step(state: ShardedState, field_rows: Sequence[torch.Tensor],
             obstacles: Sequence[tuple[torch.Tensor, ...]],
             candidates: AgentState | None = None
             ) -> tuple[ShardedState, StepMetrics]:
        if candidates is None and s > 0:
            candidates = draw(generator)
        sent = [emit(a, candidates, f, b)
                for a, f, b in zip(state.agents, field_rows, bounds)]
        pkg_l = [x[1] for x in sent]
        pkg_r = [x[2] for x in sent]
        recv_l = [torch.zeros_like(p) for p in pkg_r]  # zeros: no neighbour
        recv_r = [torch.zeros_like(p) for p in pkg_l]
        transport.shift((right, pkg_r, recv_l), (left, pkg_l, recv_r))
        shards, counts = [], []
        for (rows, _, _, (n_sp, n_pkg)), rl_, rr_, ob, b, o in zip(
                sent, recv_l, recv_r, obstacles, bounds, origins):
            shard, (n_act, n_lost, n_cell) = absorb(rows, rl_, rr_, ob, b, o)
            shards.append(shard)
            counts.append(torch.stack([n_act, n_sp, n_lost, n_cell + n_pkg]).to(home))
        tot = torch.stack(counts).sum(0).to(torch.int32)
        zero = torch.zeros((), dtype=torch.int32, device=home)
        metrics = StepMetrics(n_active=tot[0], n_spawned=tot[1], n_dropped=tot[2],
                              n_overflow=tot[3], max_demand=zero, n_exited=zero,
                              max_mover_demand=zero)
        return (ShardedState(agents=tuple(shards), step=state.step + 1),
                all_reduce_metrics(transport, metrics))

    return step


def shard_state(scfg: ShardedConfig, state: SimState,
                devices: Sequence[torch.device | str],
                transport: Transport | None = None,
                generator: torch.Generator | None = None) -> ShardedState:
    """A flat state re-homed into strips, this process's each on its
    device: each active agent, in index order, to the next free slot of its
    strip (floor(x / strip width), clipped to the strips); agents past a
    full strip's capacity are dropped with a warning (the reference's
    spatial.py:331-378, which loops over the agents in Python; here one
    stable sort).  Across processes every rank must hold the same flat
    state and the step's ``generator`` in the same state
    (``check_replicated``)."""
    transport = _transport(scfg, transport)
    a = state.agents
    check_replicated(transport, scfg.base, a, generator)
    n_strips, cl = scfg.n_devices, scfg.local_capacity
    n = a.pos.shape[0]
    dev = a.pos.device
    strip = torch.clamp(true_divide(a.pos[:, 0], scfg.strip_width).to(torch.int64),
                        0, n_strips - 1)
    key = torch.where(a.active, strip, n_strips)
    order = torch.sort(key, stable=True).indices
    key = key[order]
    idx = torch.arange(n, device=dev)
    first = torch.full((n_strips + 1,), n, dtype=torch.int64, device=dev
                       ).scatter_reduce_(0, key, idx, "amin")
    rank = idx - first[key]
    placed = (key < n_strips) & (rank < cl)
    lost = int(((key < n_strips) & (rank >= cl)).sum())
    if lost:
        log.warning("initial placement dropped %d agents (strip shard full)", lost)
    slot = (key * cl + rank)[placed]
    src = order[placed]
    cap = n_strips * cl
    out = AgentState(
        pos=torch.zeros((cap, 2), dtype=torch.float32, device=dev),
        vel=torch.zeros((cap, 2), dtype=torch.float32, device=dev),
        speed=torch.ones((cap,), dtype=torch.float32, device=dev),
        dest=torch.zeros((cap,), dtype=torch.int32, device=dev),
        active=torch.zeros((cap,), dtype=torch.bool, device=dev))
    for o, x in zip(out, a):
        o[slot] = x[src]
    shards = tuple(AgentState(*(o[d * cl:(d + 1) * cl].to(dv) for o in out))
                   for d, dv in zip(transport.tiles, devices))
    return ShardedState(agents=shards, step=state.step)


def make_sharded_initial_state(scfg: ShardedConfig,
                               devices: Sequence[torch.device | str],
                               generator: torch.Generator,
                               transport: Transport | None = None
                               ) -> ShardedState:
    """The once-spawned initial agents (``make_initial_state``, drawn from
    ``generator``) re-homed into strips (``shard_state``)."""
    flat = make_initial_state(scfg.base, generator, devices[0])
    return shard_state(scfg, flat, devices, transport, generator)


DRYRUN_SCENARIO = """
[field]
size = [32, 16]
[[waypoints]]
line = [[2, 2], [2, 14]]
[[waypoints]]
line = [[30, 2], [30, 14]]
[[obstacles]]
line = [[16, 0], [16, 6]]
width = 1
[[pedestrians]]
origin = 0
destination = 1
spawn = { kind = "periodic", frequency = 8.0 }
[[pedestrians]]
origin = 1
destination = 0
spawn = { kind = "once", count = 40 }
"""


def dryrun(n_devices: int, device: str = "cuda") -> None:
    """Entry hook: three strip steps over ``n_devices`` strips on tiny
    shapes (the reference's dryrun scenario, spatial.py:425-465), strip i
    on cuda:(i mod cards) (``device="cpu"``: every strip on the CPU), then
    a sanity check."""
    if device == "cpu":
        devices = [torch.device("cpu")] * n_devices
    else:
        n_cards = torch.cuda.device_count()
        if n_cards == 0:
            raise RuntimeError("dryrun on cuda, and torch.cuda.device_count() is 0")
        devices = [torch.device("cuda", i % n_cards) for i in range(n_devices)]
    scenario = loads_scenario(DRYRUN_SCENARIO)
    maps = FieldMaps.from_field(Field.from_scenario(scenario, unit=0.25))
    cfg = StepConfig.build(scenario, capacity=128 * n_devices, chunk_size=64,
                           table_capacity=8)
    scfg = ShardedConfig.build(cfg, n_devices, package_capacity=32)
    generator = torch.Generator(device=devices[0]).manual_seed(0)
    field_rows, obstacles = device_inputs(scfg, maps, devices)
    state = make_sharded_initial_state(scfg, devices, generator)
    step = make_sharded_step(scfg, devices, generator)
    for _ in range(3):
        state, metrics = step(state, field_rows, obstacles)
    n_active = int(metrics.n_active)
    if not 0 < n_active <= cfg.capacity:
        raise AssertionError(f"implausible active count {n_active}")
    for a in state.agents:
        if not bool(torch.isfinite(a.pos[a.active]).all()):
            raise AssertionError("non-finite positions after the strip steps")
    print(f"spatial dryrun: {n_devices} strips, 3 steps, {n_active} active; "
          + ", ".join(f"strip {i} on {d}" for i, d in enumerate(devices)),
          flush=True)
