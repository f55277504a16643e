"""Simulator orchestration for the grid backend, on one device or tiled
over several.

Counterpart of pedoni_tpu/sim.py with the same surface:

    sim = Simulator(SimulatorOptions(device="cuda"), scenario)
    record = sim.tick()
    pos, dest = sim.list_pedestrians()
    sim.pedestrian_count

Covered: the cell-resident grid step with the hybrid rebin (incremental,
or full every ``compact_every``-th step and on fallback; auto-chosen by
cell occupancy), distance-map or exact segment obstacles
(``use_distance_map=False``), all-pairs interactions through a cell unit
grown to cover the cutoff (``use_neighbor_grid=False``), one device or
``n_devices`` tiles (parallel/tile2d.py: row strips, or ``tile`` = (rows,
cols)), drop-free table growth, mover-table growth, the on-device run
totals and the lagged growth guard of ``run``, and checkpoints
(checkpoint.py), which cross device counts.
Options outside that slice raise ``ValueError`` naming the ROADMAP item
that will port them.
"""

from __future__ import annotations

import dataclasses
import logging
import math

import torch

from .diagnostics import DiagnosticLog, StepRecord
from .field import Field, FieldMaps
from .models import sfm_grid
from .models.sfm import SimState, StepConfig, StepMetrics, make_initial_state
from .parallel import tile2d
from .physics import Physics
from .scenario import Scenario
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
    return StepMetrics(*torch.stack(list(m)).tolist())


@dataclasses.dataclass(frozen=True)
class SimulatorOptions:
    """Counterpart of the reference's options, grid backend only."""

    backend: str = "grid"
    neighbor_grid_unit: float = 1.4  # auto-switched to 1.5 (stride-6 fields)
    field_grid_unit: float = 0.25
    use_neighbor_grid: bool = True
    use_distance_map: bool = True
    table_capacity: int = 16
    chunk_size: int = 2048  # reference --work-size; row_block derives from it
    capacity: int = 0  # 0 = auto-size from the scenario
    seed: int = 0
    physics: Physics = Physics()
    n_devices: int = 1  # > 1: the grid cut into tiles, one a device
    tile: tuple[int, int] | None = None  # (rows, cols) of tiles; None =
    #                        row strips (rows = n_devices, cols = 1)
    # Hybrid rebin (the reference's sim.py:75-98): incremental on most
    # steps, full every compact_every-th step and on fallback.  None =
    # auto by expected cell occupancy (_resolve_incremental).
    # mover_capacity = mover-table rows per cell, grown like K.
    incremental_rebin: bool | None = None
    mover_capacity: int = 8
    compact_every: int = 8
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
        """Raise on what this port does not cover yet."""
        if self.backend != "grid":
            raise ValueError(f"backend {self.backend!r} is not ported; only "
                             "'grid' is (ROADMAP queue 1, item 9)")
        self.resolve_tile()

    def resolved(self) -> "SimulatorOptions":
        """The options the grid step runs with (the reference's sim.py:
        124-152): the 1.4 m default unit becomes 1.5 m (the stride-6 field
        layout); in all-pairs mode the unit grows to cover the interaction
        cutoff, in whole field units, and K by the cell-area ratio.  The
        reference's all-pairs branch keeps the same cutoff (sfm.rs:158-184),
        so a 3x3 window of such cells finds exactly its interacting pairs."""
        o = self
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
                log.info("all-pairs mode: neighbor unit -> %.2f m (covers the "
                         "%.1f m interaction cutoff), table capacity -> %d",
                         unit_ap, o.physics.interaction_cutoff, k_ap)
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
        if self.device.type == "cuda" and torch.cuda.device_count() < n_dev:
            raise ValueError(f"--devices {n_dev} but only "
                             f"{torch.cuda.device_count()} devices are visible")
        # the tiles' devices; the generator and the metrics live on the first
        self.devices = ([torch.device("cuda", i) for i in range(n_dev)]
                        if self.device.type == "cuda" and n_dev > 1
                        else [self.device] * n_dev)
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

    def _build(self, capacity: int) -> None:
        o = self.options
        self.cfg = StepConfig.build(
            self.scenario, physics=o.physics, capacity=capacity,
            neighbor_grid_unit=o.neighbor_grid_unit, field_unit=o.field_grid_unit,
            table_capacity=o.table_capacity, use_neighbor_grid=o.use_neighbor_grid,
            use_distance_map=o.use_distance_map)
        step_kw = dict(incremental=self._resolve_incremental(),
                       mover_k=o.mover_capacity, compact_every=o.compact_every,
                       generator=self.generator)
        self._tcfg = None
        if o.n_devices > 1:  # the step's field arguments are per-tile lists
            self._tcfg = tile2d.Tile2DConfig.build(
                self.cfg, *o.resolve_tile(), row_block=o.row_block)
            self._fwp, self._fobs = tile2d.device_inputs(
                self._tcfg, self.maps, sfm_grid.stride_for(self.cfg),
                self.devices)
            self._step = tile2d.make_sharded_step(self._tcfg, self.devices,
                                                  **step_kw)
        else:
            self._fwp, self._fobs = sfm_grid.field_tensors(
                self.cfg, self.maps, self.device, row_block=o.row_block)
            self._step = sfm_grid.make_step_grid(
                self.cfg, row_block=o.row_block, **step_kw)
        self._kernel_chain = None  # shapes depend on K
        log.info("step function built: capacity=%d K=%d device=%s tiles=%s",
                 capacity, o.table_capacity, self.device, o.resolve_tile())

    def tick(self) -> StepRecord:
        """Advance one step (lib.rs:64-100) and return host-side metrics."""
        with Timer() as t:
            self.state, dmetrics = self._step(self.state, self._fwp, self._fobs)
            metrics = _to_host(dmetrics)
        self.step_count += 1
        self.last_metrics = metrics
        if metrics.n_dropped > 0:
            log.warning("step %d: %d spawn candidates dropped into full cells",
                        self.step_count, metrics.n_dropped)
        if metrics.n_exited > 0:
            log.debug("step %d: %d agents left the field", self.step_count,
                      metrics.n_exited)
        if metrics.n_overflow > 0:
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

    def run(self, n_steps: int, sync_every: int = 0,
            guard_every: int = 4) -> StepRecord:
        """Advance ``n_steps`` without per-step host syncs: metrics
        accumulate on the device and are fetched once at the end (in
        :attr:`last_run_metrics`).  Every ``guard_every`` steps the LAGGED
        metrics of the step ``guard_every`` launches ago are read and the
        table grows preemptively at peak demand >= K-1, as tick() does; a
        cell sprinting past K within the lag still falls to the counted
        reactive path.  ``sync_every`` > 0 adds full syncs."""
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
                    if (i + 1) % guard_every == 0:
                        old = pending[0]
                        if int(old.max_demand) >= self.options.table_capacity - 1:
                            self._grow_table(0)
                            pending.clear()
                if sync_every and (i + 1) % sync_every == 0:
                    if int(metrics.max_demand) >= self.options.table_capacity - 1:
                        self._grow_table(0)
            host = _to_host(totals) if totals is not None else None
        self.step_count += n_steps
        self.last_run_metrics = host
        if host is not None:
            if host.n_dropped > 0:
                log.warning("run(%d): %d spawn candidates dropped into full "
                            "cells over the run", n_steps, host.n_dropped)
            if host.n_overflow > 0:
                log.warning("run(%d): %d agents lost to cell overflow over "
                            "the run", n_steps, host.n_overflow)
        return StepRecord(
            active_ped_count=host.n_active if host is not None else 0,
            time_spawn=0.0, time_calc_state=t.elapsed / max(n_steps, 1))

    def _grow_table(self, n_lost: int) -> None:
        """Grow the per-cell table K and re-bin (preemptively when
        n_lost == 0, reactively after a counted overflow)."""
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
        old_mk = self.options.mover_capacity
        new_mk = min(old_mk + max(2, old_mk // 2), self.options.table_capacity)
        if new_mk == old_mk:
            return
        log.info("step %d: peak mover demand reached %d; growing mover table "
                 "%d -> %d (fast-path retention)", self.step_count, old_mk - 1,
                 old_mk, new_mk)
        self._rebuild(mover_capacity=new_mk)

    def _rebuild(self, **changes) -> None:
        """Apply option changes, rebuild the step and re-bin the agents."""
        flat = self._to_flat_state()
        self.options = dataclasses.replace(self.options, **changes)
        self._build(self.cfg.capacity)
        self.state = self._from_flat_state(flat)

    def measure_kernel_time(self, n: int = 10) -> float:
        """Seconds per step of the kernels alone (fused step + rebin, no
        spawn, no metrics; the incremental branch when the step is the
        hybrid), chained ``n`` times from the current state.  On a CUDA
        device timed with CUDA events; on the CPU (twins) with the host
        clock.  One device only."""
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

    def _to_flat_state(self) -> SimState:
        """The state as flat agent tensors, whatever the device count: the
        checkpoint, render and diagnostic exchange format."""
        if self._tcfg is not None:
            return tile2d.unbin_sharded(self._tcfg, self.state)
        return sfm_grid.unbin_state(self.cfg, self.state)

    def _from_flat_state(self, state: SimState):
        """Inverse of :meth:`_to_flat_state` (the reference's sim.py:
        543-560): the agents binned on this simulator's device, or cut into
        its tiles — so checkpoints restore across device counts."""
        state = SimState(agents=state.agents.to(self.device), step=state.step)
        if self._tcfg is not None:
            return tile2d.make_sharded_grid_state(self._tcfg, state, self.devices)
        return sfm_grid.bin_state(self.cfg, state,
                                  row_block=self.options.row_block)

    def list_pedestrians(self):
        """Positions [n, 2] and destinations [n] of active agents, as
        NumPy arrays (models/mod.rs:29-32 exchange struct analog)."""
        a = self._to_flat_state().agents
        act = a.active
        return a.pos[act].cpu().numpy(), a.dest[act].cpu().numpy()

    @property
    def pedestrian_count(self) -> int:
        if self._tcfg is not None:
            return tile2d.population(self.state)
        return int((self.state.d[:, :, 6, :] > 0.5).sum())

    def new_log(self, scenario_name: str = "") -> DiagnosticLog:
        lg = DiagnosticLog(model="sfm-torch/grid", scenario=scenario_name)
        lg.time_calc_field = self.time_calc_field
        return lg
