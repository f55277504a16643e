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
  (``use_neighbor_grid=False``) is the true O(C^2) pass.  On a CUDA device
  each step after the first of a capacity is one replay of a CUDA graph
  of it (:class:`GraphedStep`), and the state it leaves in
  ``sim.state`` is the graph's own buffers, which the next step
  overwrites: clone a state to keep it across ticks.
- ``"pallas"``: the same flat state and growth, at the 1.5 m unit, each
  step sorted into a slot grid that the fused step kernel advances
  (models/sfm_pallas.py::make_step_pallas); one device.
- ``"grid"``: the cell-resident grid step with the hybrid rebin
  (incremental, or full every ``compact_every``-th step and on fallback;
  auto-chosen by cell occupancy), at the 1.5 m unit, on one device or
  ``n_devices`` tiles (parallel/tile2d.py: row strips, or ``tile`` =
  (rows, cols)), with drop-free table growth and mover-table growth.
  On one CUDA device each step after the first of a table size (of each
  branch of the hybrid) is one replay of a CUDA graph of it
  (:class:`GraphedStep`), and the grid it leaves in ``sim.state`` is
  the graph's own buffer, which the next step overwrites, as on the flat
  backend.  Where ``torch.distributed`` is initialized with a world size
  above 1, the tiles are spread over the group's processes (the
  counterpart of the reference's global ``jax.devices()``): rank r owns a
  contiguous block of whole tile rows, all on its card ``cuda:(r mod
  cards)``, or on the CPU for ``device="cpu"``, and every rank's ``tick``
  and ``run`` return the same metrics.  Reading the agents
  (``list_pedestrians``, checkpoints) is then refused, as the reference
  cannot read an array that spans processes either.

The two kernel backends (``pallas``, ``grid``) grow the cell unit in
all-pairs mode to cover the cutoff.  All three take distance-map or exact
segment obstacles (``use_distance_map=False``), keep ``run``'s totals on
the device behind its lagged growth guard, and checkpoint as flat agents
(``flat_state``, ``load_flat_state``), so a checkpoint crosses backends
and device counts.  What differs between them is decided by the state's
kind (``_Kind``), chosen once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
import threading
from typing import Callable

import torch

from .diagnostics import DiagnosticLog, StepRecord
from .field import Field, FieldMaps
from .models import sfm_grid, sfm_pallas
from .models.sfm import (SimState, StepConfig, StepMetrics, device_inputs,
                          make_initial_state, make_step, spawn_sampler)
from .ops.kernels import add_launch_counts, launch_counts
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


def _spawns_in_60s(scenario: Scenario) -> tuple[int, float]:
    """Agents placed at once, and spawned in 60 s: the population horizon
    of the capacity and the rebin estimates."""
    return (sum(g.spawn.count for g in scenario.once_groups),
            sum(g.spawn.frequency for g in scenario.periodic_groups) * 60)


def _seconds_per_call(fn: Callable[[], None], n: int,
                      device: torch.device) -> float:
    """Seconds a call of ``fn``, over ``n`` back to back after a warm one:
    CUDA events on a CUDA device, the host clock elsewhere."""
    fn()  # warm
    if device.type != "cuda":
        with Timer() as t:
            for _ in range(n):
                fn()
        return t.elapsed / n
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1000.0 / n


def _graphs_on(device: torch.device) -> bool:
    """Whether a kind that graphs its step does so on ``device``."""
    return device.type == "cuda"


def capture_graph(body: Callable[[], None], generator: torch.Generator
                  ) -> Callable[[], None]:
    """``body`` captured into a CUDA graph on the generator's card, on
    torch's side stream for capture, with ``generator`` registered: each
    replay draws what an eager ``body()`` would draw from the generator's
    state at the replay and leaves it as far advanced, so that
    ``set_state`` and ``manual_seed`` reach replays too.  Returns the
    graph's replay.  A capture that fails raises.  The capture is
    thread-local: another thread may use the card meanwhile."""
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(generator)
    with torch.cuda.device(generator.device), \
            torch.cuda.graph(graph, capture_error_mode="thread_local"):
        body()
    return graph.replay


@dataclasses.dataclass
class _Graph:
    """One captured graph of a step: its replay, the stack of the seven
    metrics its body writes, and the launch counts a replay adds."""
    replay: Callable[[], None] | None = None
    metrics: torch.Tensor | None = None
    launches: dict[str, int] = dataclasses.field(default_factory=dict)


class GraphedStep:
    """A step replayed from CUDA graphs, called as the eager step is:
    ``step(state, fields, obstacles) -> (state, StepMetrics)``; the flat
    step (models/sfm.py::make_step) or the one-device grid step
    (models/sfm_grid.py::make_step_grid).  ``keyed``: each value of the
    step's ``host_key(state)`` has a graph (the grid step's: one on the
    full path, one a branch of the hybrid); else one graph.  ``into``: the
    eager step writes its output into the buffers given as its ``into``
    (the grid's rebin), so the graph copies nothing back.

    The first call of a key after :meth:`rebuild` runs the eager step,
    which is the warm-up a capture needs (every kernel loaded, the library
    buffers allocated; the step uses no per-stream library handle, so the
    current stream serves), copies its result into input buffers of the
    graph's own (a clone of the state's first field, the flat agents' five
    tensors or the grid D, made at the first capture of a build and shared
    by the graphs of every key) and captures, from them, one step: the
    eager step, the stack of its seven metrics and the copy of its output
    state back into the input buffers.  Every later call of that key
    replays its graph: one launch, no host sync.  The state returned is the
    input buffers themselves, so a state handed back as it was returned
    costs no copy (:meth:`holds`); any other (a restored or an assigned
    one) is copied in first (``copies_in``).  The next call overwrites a
    returned state; the metrics are a copy of their own.  The fields and
    obstacles are bound at the first capture.  A call that injects the
    step's spawn candidates runs the eager step.

    The capture launches nothing, so the launch counts its wrappers took
    are given back and each replay adds them (``ops/kernels.
    launch_counts``).  The module's :func:`capture_graph` makes the replay
    of a body; a test stands the graph in by the body itself.
    """

    def __init__(self, generator: torch.Generator, keyed: bool = False,
                 into: bool = False) -> None:
        self.generator = generator
        self.keyed = keyed
        self.into = into
        self.captures = 0  # graphs captured, over every rebuild
        self.copies_in = 0  # states copied into the input buffers
        self.rebuild(None)

    def rebuild(self, eager) -> None:
        """Take a new eager step (new shapes): the next call of each key
        captures."""
        self.eager = eager
        self._key = eager.host_key if self.keyed and eager is not None else None
        self._graphs: dict[object, _Graph] = {}
        self._inputs = self._buffers = self._args = None

    def holds(self, state) -> bool:
        """Whether ``state`` is held in the input buffers themselves."""
        return self._buffers is not None and all(
            a is b for a, b in zip(self._tensors(state[0]), self._buffers))

    def __call__(self, state, fields: torch.Tensor, obstacles, *cand):
        if cand:
            return self.eager(state, fields, obstacles, *cand)
        if self._args is not None and (fields is not self._args[0]
                                       or obstacles is not self._args[1]):
            raise ValueError("GraphedStep: the fields or obstacles are not "
                             "those its graph was captured with")
        key = None if self._key is None else self._key(state)
        graph = self._graphs.get(key)
        if graph is None:
            return self._capture(key, state, fields, obstacles)
        if not self.holds(state):
            self._copy_in(state)
        with trace.span("sim.replay"):
            graph.replay()
        add_launch_counts(graph.launches)
        return (self._state(self._inputs, state.step + 1),
                StepMetrics(*graph.metrics.clone().unbind()))

    def _map(self, state) -> None:
        """The buffers' place in a state of a build's type, and their clone."""
        held = state[0]
        if isinstance(held, torch.Tensor):
            self._tensors = lambda h: (h,)
            self._inputs = held.clone()
        else:
            self._tensors = lambda h: h
            self._inputs = type(held)(*(t.clone() for t in held))
        self._state = type(state)
        self._buffers = self._tensors(self._inputs)

    def _copy_in(self, state) -> None:
        for dst, src in zip(self._buffers, self._tensors(state[0])):
            dst.copy_(src)
        self.copies_in += 1

    def _capture(self, key, state, fields, obstacles):
        with trace.span("sim.capture"):
            new, metrics = self.eager(state, fields, obstacles)
            if self._inputs is None:
                self._map(new)
                self.copies_in += 1
                self._args = (fields, obstacles)
            else:
                self._copy_in(new)
            into = {"into": self._inputs} if self.into else {}

            def body() -> None:
                out, m = self.eager(self._state(self._inputs, state.step),
                                    fields, obstacles, **into)
                graph.metrics = torch.stack(list(m))
                for dst, src in zip(self._buffers, self._tensors(out[0])):
                    if dst is not src:
                        dst.copy_(src)

            graph = _Graph()
            before = launch_counts()
            graph.replay = capture_graph(body, self.generator)
            graph.launches = {k: n - before[k] for k, n in launch_counts().items()
                              if n != before[k]}
            add_launch_counts({k: -n for k, n in graph.launches.items()})
            self._graphs[key] = graph
            self.captures += 1
        return self._state(self._inputs, new.step), metrics


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


class _Kind:
    """The Simulator's state kind, chosen once from its options: ``build``
    (the step and its two inputs for ``sim.cfg``, refused before any tensor
    exists where they do not fit), ``to_flat``/``from_flat`` (the state as
    flat agents and back), ``count``, ``growth`` (what a step's metrics call
    for), ``hold`` (room for more agent rows than the capacity) and
    ``dropped`` (what ``n_dropped`` counts).  Where ``graph_how``
    is set, the step on a card (:func:`_graphs_on`) is a
    :class:`GraphedStep` made with it."""

    graph_how: dict | None = None
    dropped = "agents dropped at capacity"

    def __init__(self, sim: "Simulator") -> None:
        self.sim = sim
        self.devices = [sim.device]
        self.graphed = self.graph_how is not None and _graphs_on(sim.device)
        self.graph: GraphedStep | None = None

    def _graph(self, step):
        """``step`` as this kind runs it: its graphs where it graphs."""
        if not self.graphed:
            return step
        if self.graph is None:
            self.graph = GraphedStep(self.sim.generator, **self.graph_how)
        self.graph.rebuild(step)
        return self.graph

    def release(self) -> None:
        """Before a build: the graphs, and the fields they bound, go."""
        if self.graph is not None:
            self.graph.rebuild(None)

    def one_process(self, what: str) -> None:
        """Raise NotImplementedError for ``what`` where the state spans
        processes."""

    def hold(self, rows: int) -> None:
        """Before a state of ``rows`` agent rows, more than the capacity, is
        put: the step is built for the capacity, so it is built again at
        ``rows``."""
        self.sim._build(rows)

    def measure_kernel_time(self, n: int) -> float | None:
        return None

    def measure_spawn_time(self, n: int) -> float | None:
        return None


class _FlatKind(_Kind):
    """``xla``: flat agent tensors (a SimState), the capacity doubled past
    80% occupancy; on a card one graph a capacity."""

    graph_how = {}

    def build(self):
        """The flat step; its inputs are the packed field rows and the
        obstacle segments."""
        sim = self.sim
        field, fobs = device_inputs(sim.cfg, sim.maps, sim.device)
        return (self._graph(make_step(sim.cfg, generator=sim.generator)),
                field.rows, fobs)

    def to_flat(self, state: SimState) -> SimState:
        return state

    from_flat = to_flat

    def count(self, state: SimState) -> int:
        return int(state.agents.active.sum())

    def growth(self, m: StepMetrics, guard: bool = False):
        """Both ``tick``'s rule and ``run``'s guard: the capacity doubles
        past 80% occupancy."""
        if int(m.n_active) > 0.8 * self.sim.cfg.capacity:
            return ("capacity",)
        return None


class _PallasKind(_FlatKind):
    """``pallas``: the flat state and growth, stepped by the fused step
    kernel; eager."""

    graph_how = None

    def build(self):
        """The pallas step and its field tensors (the reference's
        sim.py:230-276), refused where its layout or its memory
        (``sfm_pallas.device_bytes``) does not fit."""
        sim, o = self.sim, self.sim.options
        if not sfm_pallas.layout_ok(sim.cfg):
            raise ValueError(
                "pallas backend requires an integral neighbor/field unit "
                "ratio and at least one waypoint; use backend='xla' for this "
                "scenario")
        sfm_grid.check_fits(sfm_pallas.device_bytes(sim.cfg, o.row_block),
                            sim.device, what="the pallas step")
        fwp, fobs = sfm_pallas.pallas_device_inputs(
            sim.cfg, sim.maps, sim.device, row_block=o.row_block)
        return (sfm_pallas.make_step_pallas(sim.cfg, row_block=o.row_block,
                                            generator=sim.generator), fwp, fobs)


class _GridKind(_Kind):
    """``grid`` on one device: the grid D (a GridState), its table K and
    mover table grown; on a card one graph a host key, the rebin writing D'
    into the graph's buffer."""

    graph_how = {"keyed": True, "into": True}
    dropped = "spawn candidates dropped into full cells"

    def _step_kw(self, tile: tuple[int, int] | None = None) -> dict:
        """The grid step's arguments, refused before any of its tensors
        exist where they (``sfm_grid.device_bytes``, of a ``tile``'s rows
        and lanes) do not fit a card's free memory; tiles that share a card
        add up there."""
        sim, o = self.sim, self.sim.options
        incremental = sim._resolve_incremental()
        need = sfm_grid.device_bytes(sim.cfg, o.row_block, incremental,
                                     o.mover_capacity, tile)
        for dev in set(self.devices):
            sfm_grid.check_fits(need * self.devices.count(dev), dev)
        return dict(incremental=incremental, mover_k=o.mover_capacity,
                    compact_every=o.compact_every, generator=sim.generator)

    def build(self):
        sim, o = self.sim, self.sim.options
        self._kernel_chain = None  # shapes depend on K
        self._spawn_chain = None  # reads sim.cfg, rebuilt with it
        kw = self._step_kw()
        fwp, fobs = sfm_grid.field_tensors(sim.cfg, sim.maps, sim.device,
                                           row_block=o.row_block)
        return (self._graph(sfm_grid.make_step_grid(
            sim.cfg, row_block=o.row_block, **kw)), fwp, fobs)

    def hold(self, rows: int) -> None:
        """The agents live in the grid and no step reads the capacity, which
        only sizes the flat copies (``to_flat``): it is raised to ``rows``
        and the step, its fields and its graphs are kept."""
        self.sim.cfg = dataclasses.replace(self.sim.cfg, capacity=rows)

    def to_flat(self, state) -> SimState:
        return sfm_grid.unbin_state(self.sim.cfg, state)

    def _bin(self, state: SimState):
        return sfm_grid.bin_state(self.sim.cfg, state,
                                  row_block=self.sim.options.row_block)

    def from_flat(self, state: SimState):
        """The agents binned (the reference's sim.py:543-560)."""
        gs = self._bin(state)
        # bin_state drops agents beyond K in their cells, as the reference's
        # does; the count is logged, no tensor changes
        n_binned = self.count(gs)
        n_flat = int(state.agents.active.sum())
        (log.warning if n_binned < n_flat else log.info)(
            "binned %d of %d agents (%d beyond K=%d in their cells, dropped)",
            n_binned, n_flat, n_flat - n_binned, self.sim.options.table_capacity)
        return gs

    def count(self, state) -> int:
        return int((state.d[:, :, 6, :] > 0.5).sum())

    def growth(self, m: StepMetrics, guard: bool = False):
        """``tick``'s rule: the table grows reactively after a counted
        overflow, preemptively (drop-free) when some cell is one agent short
        of K, and the mover table when a cell's movers are one short of it.
        ``run``'s lagged guard grows only the table, preemptively."""
        o = self.sim.options
        if guard:
            return ("table",) if int(m.max_demand) >= o.table_capacity - 1 else None
        if m.n_overflow > 0:
            # Reactive: a cell jumped past K within one step.  Counted.
            return "table", m.n_overflow
        if m.max_demand >= o.table_capacity - 1:
            # Drop-free growth: some cell is one agent short of K.
            return ("table",)
        if (m.max_mover_demand >= o.mover_capacity - 1
                and o.mover_capacity < o.table_capacity):
            # A performance trigger, not a safety one: a mover-table
            # overflow only costs a full-rebin step, never an agent.
            return ("movers",)
        return None

    def measure_kernel_time(self, n: int) -> float | None:
        sim = self.sim
        if self._kernel_chain is None:
            self._kernel_chain = sfm_grid.make_kernel_chain(
                sim.cfg, row_block=sim.options.row_block,
                incremental=sim._resolve_incremental(),
                mover_k=sim.options.mover_capacity)
        chain, fwp, fobs, d = self._kernel_chain, sim._fwp, sim._fobs, sim.state.d

        def once() -> None:
            nonlocal d
            d = chain(d, fwp, fobs)

        return _seconds_per_call(once, n, sim.device)

    def measure_spawn_time(self, n: int) -> float | None:
        sim = self.sim
        if sim.cfg.spawn.total == 0:
            return 0.0
        if self._spawn_chain is None:
            draw = spawn_sampler(sim.cfg, sim.device)
            generator = torch.Generator(device=sim.device)
            generator.manual_seed(sim.options.seed)
            cfg = sim.cfg
            self._spawn_chain = lambda d: sfm_grid.spawn_scatter(
                cfg, d, draw(generator))
        chain, d = self._spawn_chain, sim.state.d.clone()
        return _seconds_per_call(lambda: chain(d), n, sim.device)


class _TileKind(_GridKind):
    """``grid`` cut into ``n_devices`` tiles (parallel/tile2d.py), over this
    process's devices or a process group's; eager."""

    graph_how = None

    def __init__(self, sim: "Simulator") -> None:
        super().__init__(sim)
        n_dev = sim.options.n_devices
        cuda = sim.device.type == "cuda"
        self.transport = transport_for(n_dev)
        if self.transport.world > 1:
            # this process's tiles, all on one card (NCCL: one rank a card)
            own = len(self.transport.tiles)
            self.devices = ([torch.device(
                "cuda", self.transport.rank % torch.cuda.device_count())] * own
                if cuda else [sim.device] * own)
        else:
            if cuda and torch.cuda.device_count() < n_dev:
                raise ValueError(f"--devices {n_dev} but only "
                                 f"{torch.cuda.device_count()} devices are visible")
            self.devices = ([torch.device("cuda", i) for i in range(n_dev)]
                            if cuda else [sim.device] * n_dev)

    def build(self):
        sim, o = self.sim, self.sim.options
        # the step's field arguments are per-tile lists
        self.tcfg = tile2d.Tile2DConfig.build(sim.cfg, *o.resolve_tile(),
                                              row_block=o.row_block)
        kw = self._step_kw((self.tcfg.rows_local, self.tcfg.nxl_local))
        fwp, fobs = tile2d.device_inputs(self.tcfg, sim.maps,
                                         sfm_grid.stride_for(sim.cfg),
                                         self.devices, self.transport)
        return (tile2d.make_sharded_step(self.tcfg, self.devices,
                                         transport=self.transport, **kw),
                fwp, fobs)

    def one_process(self, what: str) -> None:
        if self.transport.world > 1:
            raise NotImplementedError(
                f"{what} across {self.transport.world} processes is not "
                "supported (nor by the reference, which cannot read an array "
                "that spans processes); metrics and pedestrian_count are")

    def to_flat(self, state) -> SimState:
        """The gathered whole grid, unbinned on every rank."""
        return tile2d.unbin_sharded(self.tcfg, state, transport=self.transport,
                                    everywhere=True)

    def _bin(self, state: SimState):
        return tile2d.make_sharded_grid_state(self.tcfg, state, self.devices,
                                              self.transport, self.sim.generator)

    def count(self, state) -> int:
        return tile2d.population(state, self.transport)

    def measure_kernel_time(self, n: int) -> float | None:
        raise ValueError("measure_kernel_time times one device's kernels; "
                         "this simulator runs tiles")

    measure_spawn_time = _Kind.measure_spawn_time


class Simulator:
    """A scenario's agents and their step (see the module docstring).

    ``tick`` and ``run`` leave the state in ``state``.  On a CUDA device
    the next step of the flat backend and of the one-device grid
    overwrites that state in place (it is the graph's buffers,
    :class:`GraphedStep`): a caller that keeps a state across ticks clones
    it.  The steps, the growth and the agents' reads (``list_pedestrians``,
    ``pedestrian_count``, ``flat_state``) hold one lock, so another thread
    may read the agents while one ticks; a step lets the reads waiting for
    the lock go first."""

    def __init__(self, options: SimulatorOptions, scenario: Scenario) -> None:
        options.check()
        options = options.resolved()
        self.device = torch.device(options.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {options.device!r} requested but "
                               "torch.cuda.is_available() is False")
        self.options = options
        self.scenario = scenario
        # the state's kind, chosen once; the tiles' lays out their devices
        self._kind = (_FlatKind if options.backend == "xla"
                      else _PallasKind if options.backend == "pallas"
                      else _GridKind if options.n_devices == 1
                      else _TileKind)(self)
        # the generator and the metrics live on the first tile's device
        self.device = self._kind.devices[0]

        with Timer() as t_field:
            self.field = Field.from_scenario(scenario, options.field_grid_unit)
            self.maps = FieldMaps.from_field(self.field)
        self.time_calc_field = t_field.elapsed
        log.info("field: %dx%d cells, %d potential maps, built in %.3fs",
                 *self.field.shape, len(scenario.waypoints), t_field.elapsed)

        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(options.seed)
        # held by a step with its growth and by a read of the agents; a step
        # lets the reads waiting for it go first (_reading), so that ticks
        # back to back do not starve another thread's reads
        self._lock = threading.RLock()
        self._turn = threading.Condition(self._lock)
        self._readers: list[None] = []  # one entry a read waiting or reading
        capacity = options.capacity or self._auto_capacity(scenario)
        self._build(capacity)
        self._put(make_initial_state(self.cfg, self.generator, self.device))
        self.step_count = 0
        # growths by kind (_grow's), counted whether tracing is on or off
        self.growths = {"capacity": 0, "table": 0, "movers": 0}
        self.last_metrics: StepMetrics | None = None  # host, last tick()
        self.last_run_metrics: StepMetrics | None = None  # host, last run()

    @staticmethod
    def _auto_capacity(scenario: Scenario) -> int:
        n_once, n_periodic = _spawns_in_60s(scenario)
        estimate = int(n_once * 1.25 + n_periodic + 1024)
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
        n_once, n_periodic = _spawns_in_60s(self.scenario)
        est_n = n_once + n_periodic
        w, h = self.scenario.size
        lam = est_n / max(w * h, 1e-9) * o.neighbor_grid_unit ** 2
        return lam >= 1.75

    def _build(self, capacity: int) -> None:
        """The step's config at ``capacity``, and the kind's step and input
        tensors for it.  The old step, its graphs and its fields go before
        the new ones are made (a rebuild would otherwise hold both)."""
        o = self.options
        self._step = self._fwp = self._fobs = None
        self._kind.release()
        self.cfg = StepConfig.build(
            self.scenario, physics=o.physics, capacity=capacity,
            neighbor_grid_unit=o.neighbor_grid_unit, field_unit=o.field_grid_unit,
            table_capacity=o.table_capacity, chunk_size=o.chunk_size,
            use_neighbor_grid=o.use_neighbor_grid,
            use_distance_map=o.use_distance_map)
        self._step, self._fwp, self._fobs = self._kind.build()
        log.info("step function built: backend=%s capacity=%d K=%d device=%s "
                 "tiles=%s", o.backend, capacity, o.table_capacity, self.device,
                 o.resolve_tile())

    def _put(self, flat: SimState) -> None:
        """Flat agents as the state: padded with inactive slots to the
        capacity, on the simulator's device, in the kind's form."""
        self.state = self._kind.from_flat(SimState(
            flat.agents.padded(self.cfg.capacity).to(self.device), flat.step))

    def tick(self) -> StepRecord:
        """Advance one step (lib.rs:64-100) and return host-side metrics.
        The state it leaves in ``state`` may be overwritten by the next
        step (the flat backend and the one-device grid on a card): clone
        it to keep it."""
        with trace.span("sim.tick"), self._lock:
            self._readers_first()
            with Timer() as t:
                self.state, dmetrics = self._step(self.state, self._fwp, self._fobs)
                metrics = _to_host(dmetrics)
            self.step_count += 1
            self.last_metrics = metrics
            if metrics.n_dropped > 0:
                log.warning("step %d: %d %s", self.step_count, metrics.n_dropped,
                            self._kind.dropped)
            if metrics.n_exited > 0:
                log.debug("step %d: %d agents left the field", self.step_count,
                          metrics.n_exited)
            growth = self._kind.growth(metrics)
            if growth:
                self._grow(*growth)
            return StepRecord(active_ped_count=metrics.n_active, time_spawn=0.0,
                              time_calc_state=t.elapsed)

    @property
    def graph_captures(self) -> int:
        """CUDA graphs of the step captured so far: on the flat backend one
        at the first tick and one after each change of capacity; on the
        one-device grid one at the first step of each host key
        (``make_step_grid``'s ``host_key``: one on the full path, one a
        branch of the hybrid) and again after each growth of the table or
        the mover table (0 where the step runs eagerly: the CPU, the pallas
        backend, tiles)."""
        return getattr(self._kind.graph, "captures", 0)

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
        > 0 adds full syncs.  Its steps replay the step's graphs as
        ``tick``'s do, the guard outside them, and, as after ``tick``, the
        next step may overwrite the state left in ``state``."""
        with trace.span("sim.run"):
            totals = None
            pending: list[StepMetrics] = []
            with Timer() as t:
                for i in range(n_steps):
                    with self._lock:  # a step at a time: readers go between
                        self._readers_first()
                        self.state, metrics = self._step(self.state, self._fwp,
                                                         self._fobs)
                        totals = metrics if totals is None \
                            else _accumulate_metrics(totals, metrics)
                        if guard_every:
                            pending.append(metrics)
                            if len(pending) > guard_every:
                                pending.pop(0)
                            growth = ((i + 1) % guard_every == 0 and
                                      self._kind.growth(pending[0], guard=True))
                            if growth:
                                self._grow(*growth)
                                pending.clear()
                        if sync_every and (i + 1) % sync_every == 0:
                            if growth := self._kind.growth(metrics, guard=True):
                                self._grow(*growth)
                host = _to_host(totals) if totals is not None else None
            self.step_count += n_steps
            self.last_run_metrics = host
            if host is not None:
                if host.n_dropped > 0:
                    log.warning("run(%d): %d %s over the run", n_steps,
                                host.n_dropped, self._kind.dropped)
                if host.n_overflow > 0:
                    log.warning("run(%d): %d agents lost to cell overflow over "
                                "the run", n_steps, host.n_overflow)
            return StepRecord(
                active_ped_count=host.n_active if host is not None else 0,
                time_spawn=0.0, time_calc_state=t.elapsed / max(n_steps, 1))

    def _grow(self, what: str, n_lost: int = 0) -> None:
        """Grow what the kind's rule names, rebuild the step and load the
        agents back in (across processes, every rank re-bins the whole
        gathered grid).  ``"capacity"`` doubles the flat tensors, padding
        them with inactive slots (the reference's sim.py:282-297);
        ``"table"`` grows the per-cell table K (preemptively when ``n_lost``
        is 0, reactively after a counted overflow); ``"movers"`` grows the
        mover table, capped at K, to keep the incremental path fast (an
        overflowing mover table loses no agent).  Each growth adds one to
        ``growths[what]`` and opens ``sim.grow.<what>`` inside
        ``sim.grow``; a mover table already at K grows nothing."""
        with trace.span("sim.grow"):
            o, capacity, changes = self.options, self.cfg.capacity, {}
            if what == "capacity":
                capacity *= 2
            elif what == "table":
                old_k = o.table_capacity
                changes["table_capacity"] = new_k = old_k + max(4, old_k // 2)
                if n_lost:
                    log.warning("step %d: %d agents dropped from full cells; "
                                "growing table_capacity %d -> %d",
                                self.step_count, n_lost, old_k, new_k)
                else:
                    log.info("step %d: peak cell demand reached %d; growing "
                             "table_capacity %d -> %d preemptively (drop-free)",
                             self.step_count, old_k - 1, old_k, new_k)
            else:
                old_mk = o.mover_capacity
                new_mk = min(old_mk + max(2, old_mk // 2), o.table_capacity)
                if new_mk == old_mk:
                    return
                log.info("step %d: peak mover demand reached %d; growing mover "
                         "table %d -> %d (fast-path retention)", self.step_count,
                         old_mk - 1, old_mk, new_mk)
                changes["mover_capacity"] = new_mk
            self.growths[what] += 1
            with trace.span(f"sim.grow.{what}"):
                flat = self._kind.to_flat(self.state)
                self.state = None  # the old state goes before the new step is sized
                self.options = dataclasses.replace(o, **changes)
                self._build(capacity)
                self._put(flat)
            if what == "capacity":
                log.info("capacity grown: %d -> %d", capacity // 2, capacity)

    def measure_kernel_time(self, n: int = 10) -> float | None:
        """Seconds per step of the grid step's kernels alone (fused step +
        rebin, no spawn, no metrics; the incremental branch when the step
        is the hybrid), chained ``n`` times from the current state.  On a
        CUDA device timed with CUDA events; on the CPU (twins) with the
        host clock.  One device only; None on the flat backends, as in the
        reference (grid only)."""
        return self._kind.measure_kernel_time(n)

    def measure_spawn_time(self, n: int = 10) -> float | None:
        """Seconds of the grid step's spawn alone -- a draw of this step's
        candidates and their scatter into the grid, the ``time_spawn``
        diagnostic slot (the reference's sim.py:504-533) -- chained ``n``
        times on a copy of the current grid (the scatter writes in place)
        with a generator of its own (the simulator's stream does not move).
        On a CUDA device timed with CUDA events; on the CPU with the host
        clock.  Grid backend on one device only: None elsewhere; 0.0 when
        the scenario has no spawn sources."""
        return self._kind.measure_spawn_time(n)

    def flat_state(self) -> SimState:
        """The state as flat agent tensors, whatever the backend or device
        count: the checkpoint, render and diagnostic exchange format, read
        under the step's lock.  On the flat backends it is the state itself,
        which the next step on a card overwrites: clone it to keep it.  One
        process only (NotImplementedError where the tiles span
        processes)."""
        with self._reading():
            self._kind.one_process("reading the agents")
            return self._kind.to_flat(self.state)

    def load_flat_state(self, state: SimState) -> None:
        """Flat agent tensors (a checkpoint's, another backend's) as the
        state, under the step's lock: a state of more rows than the capacity
        raises the capacity to its rows (on the flat backends a rebuild of
        the step; the grid keeps its step, its fields and its graphs), one of
        fewer is padded with inactive slots (the reference's
        checkpoint.py:64-87), and the grid backend bins the agents (the
        reference's sim.py:543-560), so that agents cross backends and
        device counts.  One process only."""
        with self._lock:
            self._kind.one_process("loading the agents")
            n = state.agents.pos.shape[0]
            if n > self.cfg.capacity:
                self._kind.hold(n)
            self._put(state)

    @contextlib.contextmanager
    def _reading(self):
        """The step's lock, held for a read of the agents that the next
        step lets go first (:meth:`_readers_first`)."""
        self._readers.append(None)  # atomic: no lock needed to queue
        with self._lock:
            try:
                yield
            finally:
                self._readers.pop()
                self._turn.notify_all()

    def _readers_first(self) -> None:
        """Before a step, with the lock held: wait while reads wait."""
        while self._readers:
            self._turn.wait()

    def list_pedestrians(self):
        """Positions [n, 2] and destinations [n] of active agents, as
        NumPy arrays (models/mod.rs:29-32 exchange struct analog), of one
        state: read under the step's lock, so from any thread, and before
        the next step where a thread ticks back to back."""
        with self._reading():
            a = self.flat_state().agents
            act = a.active
            return a.pos[act].cpu().numpy(), a.dest[act].cpu().numpy()

    @property
    def pedestrian_count(self) -> int:
        with self._reading():
            return self._kind.count(self.state)

    def new_log(self, scenario_name: str = "") -> DiagnosticLog:
        lg = DiagnosticLog(model=f"sfm-torch/{self.options.backend}",
                           scenario=scenario_name)
        lg.time_calc_field = self.time_calc_field
        return lg
