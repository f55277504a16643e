"""Simulator orchestration: state, capacity growth, ticking.

Counterpart of pedoni_tpu/sim.py with the same surface:

    sim = Simulator(SimulatorOptions(device="cuda"), scenario)
    record = sim.tick()
    pos, dest = sim.list_pedestrians()
    sim.pedestrian_count

Three backends, as in the reference:

- ``"xla"`` (the default): the flat step (models/sfm.py::make_step) on
  fixed-capacity agent tensors at the 1.4 m unit, whose capacity doubles
  when the population passes 80% of it; one device.  Its all-pairs mode
  (``use_neighbor_grid=False``) is the true O(C^2) pass.
- ``"pallas"``: the same flat state and growth, at the 1.5 m unit, each
  step sorted into a slot grid that the fused step kernel advances
  (models/sfm_pallas.py::make_step_pallas); one device.
- ``"grid"``: the cell-resident grid step with the hybrid rebin
  (incremental, or full every ``compact_every``-th step and on fallback;
  auto-chosen by cell occupancy), at the 1.5 m unit, on one device or
  ``n_devices`` tiles (parallel/tile2d.py: row strips, or ``tile`` =
  (rows, cols)), with drop-free table growth and mover-table growth.
  Where ``torch.distributed`` is initialized with a world size above 1,
  the tiles are spread over the group's processes (the counterpart of the
  reference's global ``jax.devices()``): rank r owns a contiguous block of
  whole tile rows, all on its card ``cuda:(r mod cards)``, or on the CPU
  for ``device="cpu"``, and every rank's ``tick`` and ``run`` return the
  same metrics.  Reading the agents (``list_pedestrians``, checkpoints)
  is then refused, as the reference cannot read an array that spans
  processes either.

The two kernel backends (``pallas``, ``grid``) grow the cell unit in
all-pairs mode to cover the cutoff.  All three take distance-map or exact
segment obstacles (``use_distance_map=False``), keep ``run``'s totals on
the device behind its lagged growth guard, and checkpoint as flat agents
(checkpoint.py), so a checkpoint crosses backends and device counts.
"""

from __future__ import annotations

import dataclasses
import logging
import math

import torch

from .diagnostics import DiagnosticLog, StepRecord
from .field import Field, FieldMaps
from .models import sfm_grid, sfm_pallas
from .models.sfm import (AgentState, SimState, StepConfig, StepMetrics,
                          device_inputs, make_initial_state, make_step,
                          spawn_sampler)
from .parallel import tile2d
from .parallel.transport import transport_for
from .physics import Physics
from .scenario import Scenario
from .utils import trace
from .utils.timing import Timer

log = logging.getLogger(__name__)


def _accumulate_metrics(tot: StepMetrics, m: StepMetrics) -> StepMetrics:
    """Device-side running totals for Simulator.run(): counters sum,
    max_demand takes the max, n_active keeps the latest (a level, not a
    flow).  A few scalar kernels per step — no host sync."""
    return m._replace(
        n_spawned=tot.n_spawned + m.n_spawned,
        n_dropped=tot.n_dropped + m.n_dropped,
        n_overflow=tot.n_overflow + m.n_overflow,
        max_demand=torch.maximum(tot.max_demand, m.max_demand),
        n_exited=tot.n_exited + m.n_exited,
    )


def _to_host(m: StepMetrics) -> StepMetrics:
    """One device->host transfer for all metric scalars."""
    with trace.span("sim.fetch"):
        return StepMetrics(*torch.stack(list(m)).tolist())


@dataclasses.dataclass(frozen=True)
class SimulatorOptions:
    """Counterpart of the reference's options (lib.rs:109-135), with the
    same defaults."""

    backend: str = "xla"  # "xla": the flat step; "pallas": flat agents
    #                        through the step kernel; "grid": the grid step
    neighbor_grid_unit: float = 1.4  # the kernel backends run 1.4 as 1.5
    field_grid_unit: float = 0.25
    use_neighbor_grid: bool = True
    use_distance_map: bool = True
    table_capacity: int = 16
    chunk_size: int = 2048  # reference --work-size; row_block derives from it
    capacity: int = 0  # 0 = auto-size from the scenario
    seed: int = 0
    physics: Physics = Physics()
    n_devices: int = 1  # > 1: the grid cut into tiles, one a device (grid)
    tile: tuple[int, int] | None = None  # (rows, cols) of tiles; None =
    #                        row strips (rows = n_devices, cols = 1)
    # Hybrid rebin (the reference's sim.py:75-98): incremental on most
    # steps, full every compact_every-th step and on fallback.  None =
    # auto by expected cell occupancy (_resolve_incremental).
    # mover_capacity = mover-table rows per cell, grown like K.
    incremental_rebin: bool | None = None
    mover_capacity: int = 8
    compact_every: int = 8
    # The reference's per-block waypoint-plane skip (its sim.py:99-102).
    # Accepted and ignored: the port has no slot walk (each agent samples
    # its own plane), and the reference's own tests hold wp_skip=False
    # bit-identical to True (tests/test_wp_skip.py:131-212).
    wp_skip: bool = True
    device: str = "cuda"  # "cuda": tile i on cuda:i; "cpu": every tile there

    def resolve_tile(self) -> tuple[int, int]:
        if self.tile is not None:
            r, c = self.tile
            if r * c != self.n_devices:
                raise ValueError(
                    f"tile {r}x{c} does not cover n_devices={self.n_devices}")
            return r, c
        return self.n_devices, 1

    @property
    def row_block(self) -> int:
        """Cell rows per metric block (the reference's kernel dispatch
        granularity, derived from chunk_size the same way)."""
        return max(1, min(8, self.chunk_size // 1024))

    def check(self) -> None:
        """Raise on what this port does not cover."""
        if self.backend not in ("xla", "pallas", "grid"):
            raise ValueError(f"unknown backend {self.backend!r}: 'xla', "
                             "'pallas' or 'grid'")
        if self.n_devices > 1 and self.backend != "grid":
            raise ValueError("--devices > 1 requires the grid backend")
        self.resolve_tile()

    def resolved(self) -> "SimulatorOptions":
        """The options the step runs with (the reference's sim.py:124-152).
        The flat step takes them as they are.  For the two kernel backends
        (``pallas``, ``grid``) the 1.4 m default unit becomes 1.5 m (the
        stride-6 field layout), and in
        all-pairs mode the unit grows to cover the interaction cutoff, in
        whole field units, and K by the cell-area ratio; the reference's
        all-pairs branch keeps the same cutoff (sfm.rs:158-184), so a 3x3
        window of such cells finds exactly its interacting pairs."""
        o = self
        if o.backend not in ("pallas", "grid"):
            return o
        if o.neighbor_grid_unit == 1.4:
            o = dataclasses.replace(o, neighbor_grid_unit=1.5)
        if not o.use_neighbor_grid:
            fu = o.field_grid_unit
            unit_ap = math.ceil(o.physics.interaction_cutoff / fu - 1e-9) * fu
            if unit_ap > o.neighbor_grid_unit:
                k_ap = math.ceil(o.table_capacity
                                 * (unit_ap / o.neighbor_grid_unit) ** 2)
                o = dataclasses.replace(o, neighbor_grid_unit=unit_ap,
                                        table_capacity=k_ap)
                log.info("all-pairs mode on the %s backend: neighbor unit -> "
                         "%.2f m (covers the %.1f m interaction cutoff), table "
                         "capacity -> %d", o.backend, unit_ap,
                         o.physics.interaction_cutoff, k_ap)
        return o


class Simulator:
    def __init__(self, options: SimulatorOptions, scenario: Scenario) -> None:
        options.check()
        options = options.resolved()
        self.device = torch.device(options.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {options.device!r} requested but "
                               "torch.cuda.is_available() is False")
        n_dev = options.n_devices
        # the tiles over this process and the others of a distributed group
        self._transport = (transport_for(n_dev) if n_dev > 1
                           and options.backend == "grid" else None)
        cuda = self.device.type == "cuda"
        if self._transport is not None and self._transport.world > 1:
            # this process's tiles, all on one card (NCCL: one rank a card)
            own = len(self._transport.tiles)
            self.devices = ([torch.device(
                "cuda", self._transport.rank % torch.cuda.device_count())] * own
                if cuda else [self.device] * own)
        else:
            if cuda and torch.cuda.device_count() < n_dev:
                raise ValueError(f"--devices {n_dev} but only "
                                 f"{torch.cuda.device_count()} devices are visible")
            self.devices = ([torch.device("cuda", i) for i in range(n_dev)]
                            if cuda and n_dev > 1 else [self.device] * n_dev)
        # the generator and the metrics live on the first tile's device
        if n_dev > 1:
            self.device = self.devices[0]
        self.options = options
        self.scenario = scenario

        with Timer() as t_field:
            self.field = Field.from_scenario(scenario, options.field_grid_unit)
            self.maps = FieldMaps.from_field(self.field)
        self.time_calc_field = t_field.elapsed
        log.info("field: %dx%d cells, %d potential maps, built in %.3fs",
                 *self.field.shape, len(scenario.waypoints), t_field.elapsed)

        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(options.seed)
        capacity = options.capacity or self._auto_capacity(scenario)
        self._build(capacity)
        self.state = self._from_flat_state(
            make_initial_state(self.cfg, self.generator, self.device))
        self.step_count = 0
        self.last_metrics: StepMetrics | None = None  # host, last tick()
        self.last_run_metrics: StepMetrics | None = None  # host, last run()

    @staticmethod
    def _auto_capacity(scenario: Scenario) -> int:
        n_once = sum(g.spawn.count for g in scenario.once_groups)
        rate = sum(g.spawn.frequency for g in scenario.periodic_groups)
        estimate = int(n_once * 1.25 + rate * 60 + 1024)
        cap = 1024
        while cap < estimate:
            cap *= 2
        return cap

    def _resolve_incremental(self) -> bool:
        """incremental_rebin=None -> auto by expected cell occupancy: the
        reference's rule (sim.py:187-204), incremental iff lambda =
        E[agents] / area * unit^2 >= 1.75 over a 60 s population horizon.
        The threshold was measured on the TPU reference; it is copied, not
        re-measured on the GPU."""
        o = self.options
        if o.incremental_rebin is not None:
            return o.incremental_rebin
        n_once = sum(g.spawn.count for g in self.scenario.once_groups)
        rate = sum(g.spawn.frequency for g in self.scenario.periodic_groups)
        est_n = n_once + rate * 60
        w, h = self.scenario.size
        lam = est_n / max(w * h, 1e-9) * o.neighbor_grid_unit ** 2
        return lam >= 1.75

    @property
    def _flat(self) -> bool:
        """Flat agent tensors as the state: the xla and pallas backends."""
        return self.options.backend in ("xla", "pallas")

    def _build(self, capacity: int) -> None:
        o = self.options
        self.cfg = StepConfig.build(
            self.scenario, physics=o.physics, capacity=capacity,
            neighbor_grid_unit=o.neighbor_grid_unit, field_unit=o.field_grid_unit,
            table_capacity=o.table_capacity, chunk_size=o.chunk_size,
            use_neighbor_grid=o.use_neighbor_grid,
            use_distance_map=o.use_distance_map)
        self._tcfg = None
        self._kernel_chain = None  # shapes depend on K
        self._spawn_chain = None  # reads self.cfg, rebuilt with it
        if o.backend == "pallas":
            self._build_pallas(capacity)
            return
        if self._flat:
            # the step's two input arguments: on this backend the packed
            # field rows and the obstacle segments
            field, self._fobs = device_inputs(self.cfg, self.maps, self.device)
            self._fwp = field.rows
            self._step = make_step(self.cfg, generator=self.generator)
            log.info("step function built: capacity=%d backend=xla device=%s",
                     capacity, self.device)
            return
        step_kw = dict(incremental=self._resolve_incremental(),
                       mover_k=o.mover_capacity, compact_every=o.compact_every,
                       generator=self.generator)
        # the old fields, and the packed copy cached for them, go before the
        # new ones are made (a rebuild would otherwise hold both)
        self._fwp = self._fobs = None
        if o.n_devices > 1:  # the step's field arguments are per-tile lists
            self._tcfg = tile2d.Tile2DConfig.build(
                self.cfg, *o.resolve_tile(), row_block=o.row_block)
        self._check_fits(step_kw["incremental"])
        if self._tcfg is not None:
            self._fwp, self._fobs = tile2d.device_inputs(
                self._tcfg, self.maps, sfm_grid.stride_for(self.cfg),
                self.devices, self._transport)
            self._step = tile2d.make_sharded_step(
                self._tcfg, self.devices, transport=self._transport, **step_kw)
        else:
            self._fwp, self._fobs = sfm_grid.field_tensors(
                self.cfg, self.maps, self.device, row_block=o.row_block)
            self._step = sfm_grid.make_step_grid(
                self.cfg, row_block=o.row_block, **step_kw)
        log.info("step function built: capacity=%d K=%d device=%s tiles=%s",
                 capacity, o.table_capacity, self.device, o.resolve_tile())

    def _build_pallas(self, capacity: int) -> None:
        """The pallas backend's step and field tensors (the reference's
        sim.py:230-276), refused before any tensor exists where its layout
        or its memory (``sfm_pallas.device_bytes``) does not fit."""
        o = self.options
        if not sfm_pallas.layout_ok(self.cfg):
            raise ValueError(
                "pallas backend requires an integral neighbor/field unit "
                "ratio and at least one waypoint; use backend='xla' for this "
                "scenario")
        self._fwp = self._fobs = None  # the old fields go first
        sfm_grid.check_fits(sfm_pallas.device_bytes(self.cfg, o.row_block),
                            self.device, what="the pallas step")
        self._fwp, self._fobs = sfm_pallas.pallas_device_inputs(
            self.cfg, self.maps, self.device, row_block=o.row_block)
        self._step = sfm_pallas.make_step_pallas(
            self.cfg, row_block=o.row_block, generator=self.generator)
        log.info("step function built: capacity=%d K=%d backend=pallas "
                 "device=%s", capacity, o.table_capacity, self.device)

    def _check_fits(self, incremental: bool) -> None:
        """Refuse, before any of its tensors exist, a step whose tensors
        (``sfm_grid.device_bytes``) do not fit a card's free memory; tiles
        that share a card add up there."""
        o, tcfg = self.options, self._tcfg
        need = sfm_grid.device_bytes(
            self.cfg, o.row_block, incremental, o.mover_capacity,
            None if tcfg is None else (tcfg.rows_local, tcfg.nxl_local))
        for dev in set(self.devices):
            sfm_grid.check_fits(need * self.devices.count(dev), dev)

    def tick(self) -> StepRecord:
        """Advance one step (lib.rs:64-100) and return host-side metrics."""
        with trace.span("sim.tick"):
            with Timer() as t:
                self.state, dmetrics = self._step(self.state, self._fwp, self._fobs)
                metrics = _to_host(dmetrics)
            self.step_count += 1
            self.last_metrics = metrics
            if metrics.n_dropped > 0:
                log.warning("step %d: %d %s", self.step_count, metrics.n_dropped,
                            self._dropped_what)
            if metrics.n_exited > 0:
                log.debug("step %d: %d agents left the field", self.step_count,
                          metrics.n_exited)
            if self._flat:
                if metrics.n_active > 0.8 * self.cfg.capacity:
                    self._grow()
            elif metrics.n_overflow > 0:
                # Reactive: a cell jumped past K within one step.  Counted.
                self._grow_table(metrics.n_overflow)
            elif metrics.max_demand >= self.options.table_capacity - 1:
                # Drop-free growth: some cell is one agent short of K.
                self._grow_table(0)
            elif (metrics.max_mover_demand >= self.options.mover_capacity - 1
                  and self.options.mover_capacity < self.options.table_capacity):
                # A performance trigger, not a safety one: a mover-table
                # overflow only costs a full-rebin step, never an agent.
                self._grow_movers()
            return StepRecord(active_ped_count=metrics.n_active, time_spawn=0.0,
                              time_calc_state=t.elapsed)

    @property
    def _dropped_what(self) -> str:
        """What ``n_dropped`` counts on this backend."""
        return ("agents dropped at capacity" if self._flat
                else "spawn candidates dropped into full cells")

    def _needs_growth(self, m: StepMetrics) -> bool:
        """The preemptive growth rule of ``run``'s guard: the flat tensors
        at 80% of the capacity, the grid's peak cell demand at K - 1."""
        if self._flat:
            return int(m.n_active) > 0.8 * self.cfg.capacity
        return int(m.max_demand) >= self.options.table_capacity - 1

    def _grow_now(self) -> None:
        if self._flat:
            self._grow()
        else:
            self._grow_table(0)

    def run(self, n_steps: int, sync_every: int = 0,
            guard_every: int = 4) -> StepRecord:
        """Advance ``n_steps`` without per-step host syncs: metrics
        accumulate on the device and are fetched once at the end (in
        :attr:`last_run_metrics`).  Every ``guard_every`` steps the LAGGED
        metrics of the step ``guard_every`` launches ago are read and the
        table grows preemptively at peak demand >= K-1, as tick() does; a
        cell sprinting past K within the lag still falls to the counted
        reactive path.  The flat backend's guard doubles the capacity at 80%
        occupancy instead, and a population that outruns it within the lag
        is cut at the capacity and counted in ``n_dropped``.  ``sync_every``
        > 0 adds full syncs."""
        with trace.span("sim.run"):
            totals = None
            pending: list[StepMetrics] = []
            with Timer() as t:
                for i in range(n_steps):
                    self.state, metrics = self._step(self.state, self._fwp,
                                                     self._fobs)
                    totals = metrics if totals is None \
                        else _accumulate_metrics(totals, metrics)
                    if guard_every:
                        pending.append(metrics)
                        if len(pending) > guard_every:
                            pending.pop(0)
                        if ((i + 1) % guard_every == 0
                                and self._needs_growth(pending[0])):
                            self._grow_now()
                            pending.clear()
                    if sync_every and (i + 1) % sync_every == 0:
                        if self._needs_growth(metrics):
                            self._grow_now()
                host = _to_host(totals) if totals is not None else None
            self.step_count += n_steps
            self.last_run_metrics = host
            if host is not None:
                if host.n_dropped > 0:
                    log.warning("run(%d): %d %s over the run", n_steps,
                                host.n_dropped, self._dropped_what)
                if host.n_overflow > 0:
                    log.warning("run(%d): %d agents lost to cell overflow over "
                                "the run", n_steps, host.n_overflow)
            return StepRecord(
                active_ped_count=host.n_active if host is not None else 0,
                time_spawn=0.0, time_calc_state=t.elapsed / max(n_steps, 1))

    def _grow(self) -> None:
        """Flat backend: double the capacity, padding the agent tensors
        with inactive slots (the reference's sim.py:282-297)."""
        with trace.span("sim.grow"):
            old_cap = self.cfg.capacity
            a = self.state.agents
            self._build(old_cap * 2)
            pad = self.cfg.capacity - old_cap
            dev = a.pos.device
            self.state = self.state._replace(agents=AgentState(
                pos=torch.cat([a.pos, torch.zeros((pad, 2), device=dev)]),
                vel=torch.cat([a.vel, torch.zeros((pad, 2), device=dev)]),
                speed=torch.cat([a.speed, torch.ones((pad,), device=dev)]),
                dest=torch.cat([a.dest, torch.zeros((pad,), dtype=torch.int32,
                                                    device=dev)]),
                active=torch.cat([a.active, torch.zeros((pad,), dtype=torch.bool,
                                                        device=dev)])))
            log.info("capacity grown: %d -> %d", old_cap, self.cfg.capacity)

    def _grow_table(self, n_lost: int) -> None:
        """Grow the per-cell table K and re-bin (preemptively when
        n_lost == 0, reactively after a counted overflow)."""
        with trace.span("sim.grow"):
            old_k = self.options.table_capacity
            new_k = old_k + max(4, old_k // 2)
            if n_lost:
                log.warning("step %d: %d agents dropped from full cells; growing "
                            "table_capacity %d -> %d", self.step_count, n_lost,
                            old_k, new_k)
            else:
                log.info("step %d: peak cell demand reached %d; growing "
                         "table_capacity %d -> %d preemptively (drop-free)",
                         self.step_count, old_k - 1, old_k, new_k)
            self._rebuild(table_capacity=new_k)

    def _grow_movers(self) -> None:
        """Grow the mover table (capped at K) and rebuild the step — to keep
        the incremental path fast; an overflowing table loses no agent."""
        with trace.span("sim.grow"):
            old_mk = self.options.mover_capacity
            new_mk = min(old_mk + max(2, old_mk // 2), self.options.table_capacity)
            if new_mk == old_mk:
                return
            log.info("step %d: peak mover demand reached %d; growing mover table "
                     "%d -> %d (fast-path retention)", self.step_count, old_mk - 1,
                     old_mk, new_mk)
            self._rebuild(mover_capacity=new_mk)

    def _rebuild(self, **changes) -> None:
        """Apply option changes, rebuild the step and re-bin the agents
        (across processes, every rank re-bins the whole gathered grid)."""
        flat = (tile2d.unbin_sharded(self._tcfg, self.state,
                                     transport=self._transport, everywhere=True)
                if self._tcfg is not None else self._to_flat_state())
        self.state = None  # the old grid goes before the new step is sized
        self.options = dataclasses.replace(self.options, **changes)
        self._build(self.cfg.capacity)
        self.state = self._from_flat_state(flat)

    def measure_kernel_time(self, n: int = 10) -> float | None:
        """Seconds per step of the grid step's kernels alone (fused step +
        rebin, no spawn, no metrics; the incremental branch when the step
        is the hybrid), chained ``n`` times from the current state.  On a
        CUDA device timed with CUDA events; on the CPU (twins) with the
        host clock.  One device only; None on the flat backends, as in the
        reference (grid only)."""
        if self._flat:
            return None
        if self._tcfg is not None:
            raise ValueError("measure_kernel_time times one device's kernels; "
                             "this simulator runs tiles")
        if self._kernel_chain is None:
            self._kernel_chain = sfm_grid.make_kernel_chain(
                self.cfg, row_block=self.options.row_block,
                incremental=self._resolve_incremental(),
                mover_k=self.options.mover_capacity)
        d = self._kernel_chain(self.state.d, self._fwp, self._fobs)  # warm
        if self.device.type != "cuda":
            with Timer() as t:
                for _ in range(n):
                    d = self._kernel_chain(d, self._fwp, self._fobs)
            return t.elapsed / n
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            d = self._kernel_chain(d, self._fwp, self._fobs)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1000.0 / n

    def measure_spawn_time(self, n: int = 10) -> float | None:
        """Seconds of the grid step's spawn alone -- a draw of this step's
        candidates and their scatter into the grid, the ``time_spawn``
        diagnostic slot (the reference's sim.py:504-533) -- chained ``n``
        times on a copy of the current grid (the scatter writes in place)
        with a generator of its own (the simulator's stream does not move).
        On a CUDA device timed with CUDA events; on the CPU with the host
        clock.  Grid backend on one device only: None elsewhere; 0.0 when
        the scenario has no spawn sources."""
        if self.options.backend != "grid" or self._tcfg is not None:
            return None
        if self.cfg.spawn.total == 0:
            return 0.0
        if self._spawn_chain is None:
            draw = spawn_sampler(self.cfg, self.device)
            generator = torch.Generator(device=self.device)
            generator.manual_seed(self.options.seed)
            cfg = self.cfg
            self._spawn_chain = lambda d: sfm_grid.spawn_scatter(
                cfg, d, draw(generator))
        d = self.state.d.clone()
        self._spawn_chain(d)  # warm
        if self.device.type != "cuda":
            with Timer() as t:
                for _ in range(n):
                    self._spawn_chain(d)
            return t.elapsed / n
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            self._spawn_chain(d)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1000.0 / n

    def _one_process(self, what: str) -> None:
        """Raise NotImplementedError for ``what`` when the tiles span
        processes."""
        if self._transport is not None and self._transport.world > 1:
            raise NotImplementedError(
                f"{what} across {self._transport.world} processes is not "
                "supported (nor by the reference, which cannot read an array "
                "that spans processes); metrics and pedestrian_count are")

    def _to_flat_state(self) -> SimState:
        """The state as flat agent tensors, whatever the backend or device
        count: the checkpoint, render and diagnostic exchange format.  One
        process only (``_one_process``)."""
        if self._flat:
            return self.state
        self._one_process("reading the agents")
        if self._tcfg is not None:
            return tile2d.unbin_sharded(self._tcfg, self.state)
        return sfm_grid.unbin_state(self.cfg, self.state)

    def _from_flat_state(self, state: SimState):
        """Inverse of :meth:`_to_flat_state` (the reference's sim.py:
        543-560): the agents binned on this simulator's device, or cut into
        its tiles, or the flat agents themselves on the flat backend -- so
        checkpoints restore across backends and device counts."""
        state = SimState(agents=state.agents.to(self.device), step=state.step)
        if self._flat:
            return state
        if self._tcfg is not None:
            gs = tile2d.make_sharded_grid_state(self._tcfg, state, self.devices,
                                                self._transport, self.generator)
            n_binned = tile2d.population(gs, self._transport)
        else:
            gs = sfm_grid.bin_state(self.cfg, state,
                                    row_block=self.options.row_block)
            n_binned = int((gs.d[:, :, 6] > 0.5).sum())
        # bin_state drops agents beyond K in their cells, as the reference's
        # does; the count is logged, no tensor changes
        n_flat = int(state.agents.active.sum())
        (log.warning if n_binned < n_flat else log.info)(
            "binned %d of %d agents (%d beyond K=%d in their cells, dropped)",
            n_binned, n_flat, n_flat - n_binned, self.options.table_capacity)
        return gs

    def list_pedestrians(self):
        """Positions [n, 2] and destinations [n] of active agents, as
        NumPy arrays (models/mod.rs:29-32 exchange struct analog)."""
        a = self._to_flat_state().agents
        act = a.active
        return a.pos[act].cpu().numpy(), a.dest[act].cpu().numpy()

    @property
    def pedestrian_count(self) -> int:
        if self._flat:
            return int(self.state.agents.active.sum())
        if self._tcfg is not None:
            return tile2d.population(self.state, self._transport)
        return int((self.state.d[:, :, 6, :] > 0.5).sum())

    def new_log(self, scenario_name: str = "") -> DiagnosticLog:
        lg = DiagnosticLog(model=f"sfm-torch/{self.options.backend}",
                           scenario=scenario_name)
        lg.time_calc_field = self.time_calc_field
        return lg
