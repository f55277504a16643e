"""Cell-resident grid backend: agent state lives in the cell grid.

Counterpart of pedoni_tpu/models/sfm_grid.py.  The grid IS the state:
``D [ny_pad+2, K, 8, NXL]`` stays on the device and each step runs

1. a plain-torch spawn scatter of at most S candidate rows (S small and
   static) into free slots, before the kernels, so new agents receive
   forces the same tick the reference spawns them (lib.rs:64-90);
2. the fused step kernel (ops/kernels/step_kernel.py): sampling, despawn,
   all forces, integration (sfm.rs:91-255) — by default in its mover mode,
   which also emits each cell's movers;
3. a rebin (ops/kernels/rebin.py), chosen on the device: the
   hole-preserving incremental rebin, or the full compacting rebin every
   ``compact_every``-th step, on mover-table overflow, or when a spawning
   scenario's fullest cell nears K;
4. on-device metric sums from the rebin's per-block outputs.

Channel layout (dim 2 of D): 0 pos.x, 1 pos.y, 2 vel.x, 3 vel.y, 4 speed,
5 dest, 6 active, 7 per-cell slot bound (valid at slot 0): the count after
a full rebin, the top occupied slot + 1 after an incremental one (slots
below it may be holes); the spawn scatter appends there and updates only
slot 0, the rebins broadcast it.

Deviations from the flat path, all reported per step: agents landing in a
full cell are dropped (n_overflow); spawn candidates aimed at full cells
are dropped (n_dropped); agents leaving the field vanish at the rebin
(n_exited, expected).

Obstacles: the distance map by default; with ``cfg.use_distance_map``
False (the reference's --no-distance-map) the step kernel's segment mode
reads the obstacle edge table of ``debug_segments``.

One device, or one tile of a grid cut into tiles (parallel/tile2d.py).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..field import FieldMaps
from ..ops.fields6 import Fields6
from ..ops.kernels.rebin import new_outputs, rebin, rebin_incremental
from ..ops.kernels.step_kernel import SEG_COLS, fused_step, segment_table
from ..ops.neighbor import compute_cell_ids, true_divide
from ..utils import trace
from .sfm import (AgentState, SimState, StepConfig, StepMetrics,
                  make_initial_state, spawn_sampler)


class GridState(NamedTuple):
    d: torch.Tensor  # [ny_pad+2, K, 8, NXL] cell-resident agent state
    step: int


class GridDims(NamedTuple):
    ny_pad: int
    nxl: int
    k: int
    rb: int

    @classmethod
    def build(cls, cfg: StepConfig, row_block: int = 2) -> "GridDims":
        rb = row_block
        ny_pad = -(-cfg.grid.ny // rb) * rb
        nxl = -(-(cfg.grid.nx + 3) // 128) * 128
        flat = (ny_pad + 2) * cfg.table_capacity * 8 * nxl
        if flat >= 2**31:
            raise ValueError("grid too large for int32 flat indexing")
        return cls(ny_pad=ny_pad, nxl=nxl, k=cfg.table_capacity, rb=rb)


def stride_for(cfg: StepConfig) -> int | None:
    """Field cells per neighbor cell when integral (the fields6 layout
    precondition), else None."""
    ratio = cfg.grid.unit / cfg.field_unit
    s = round(ratio)
    if abs(ratio - s) > 1e-6 or not (2 <= s <= 16):
        return None
    return s


def field_tensors(cfg: StepConfig, maps: FieldMaps, device: torch.device | str,
                  row_block: int = 2) -> tuple[torch.Tensor, torch.Tensor]:
    """(fwp [n_wp, R, S, 4, NXL], fobs [R, S, 4, NXL]) on ``device`` — the
    reference's ``pallas_device_inputs``."""
    ny_pad = -(-cfg.grid.ny // row_block) * row_block
    f6 = Fields6.build(maps, cfg.grid.nx, ny_pad, stride=stride_for(cfg) or 6)
    return (torch.from_numpy(f6.wp).to(device),
            torch.from_numpy(f6.obs).to(device))


def device_bytes(cfg: StepConfig, row_block: int = 2, incremental: bool = True,
                 mover_k: int = 8, tile: tuple[int, int] | None = None) -> int:
    """Bytes that one step of ``make_step_grid(cfg, row_block, incremental,
    mover_k)`` holds on its device: the port's counterpart of the
    reference's ``sfm_pallas.vmem_need_bytes``, for the card's memory.
    ``tile`` = (cell rows, lanes) of one tile of a grid cut into tiles
    (parallel/tile2d.py); by default the whole grid.

    D and the step kernel's output G; its scratch act' [ny2, K, NXL] and
    (e, acc) [ny2, K, NXL, 4] (``step_kernel.step_scratch``); fwp and fobs;
    their texel-major copy (``step_kernel.pack_fields``), 2 * n_wp planes
    of their size; the rebin's D' and its four per-block sums; in the
    hybrid the mover table M and the per-block movf and mdmx; in segment
    mode the edge table.  The sum of the tensors, not the peak: the scratch
    is freed before the rebin allocates D'."""
    dims = GridDims.build(cfg, row_block)
    ny_pad, nxl = tile or (dims.ny_pad, dims.nxl)
    k, s = dims.k, stride_for(cfg) or 6
    mk = min(mover_k, k) if incremental else 0
    n_wp = len(cfg.scenario.waypoints)
    n_obs = 0 if cfg.use_distance_map else len(cfg.scenario.obstacles)
    ny2, nb = ny_pad + 2, ny_pad // row_block
    slots = ny2 * k * nxl
    plane = (s * ny_pad + 3 * s + 5) * s * 4 * nxl  # Fields6.build's rows
    return 4 * (3 * slots * 8  # D, G, D'
                + slots * 5  # act', (e, acc)
                + 4 * nb  # the rebin's overflow, demand, active in and out
                + ny2 * mk * 8 * nxl + (2 * nb if mk else 0)  # M, movf, mdmx
                + n_obs * SEG_COLS
                + (n_wp + 1) * plane + 2 * max(n_wp, 1) * plane)


def card_free_bytes(device: torch.device | str = "cuda") -> int:
    """Bytes a new tensor can take on the card ``device``: the free memory
    ``torch.cuda.mem_get_info`` reports and what PyTorch's caching
    allocator holds unused."""
    free, _total = torch.cuda.mem_get_info(device)
    return (free + torch.cuda.memory_reserved(device)
            - torch.cuda.memory_allocated(device))


def supports(cfg: StepConfig, row_block: int = 2, incremental: bool = True,
             mover_k: int = 8, free_bytes: int | None = None) -> bool:
    """Whether the grid step of ``cfg`` fits ``free_bytes`` (by default the
    current card's ``card_free_bytes``): the reference's
    ``sfm_pallas.supports`` with the card's memory in place of VMEM."""
    if free_bytes is None:
        free_bytes = card_free_bytes()
    return device_bytes(cfg, row_block, incremental, mover_k) <= free_bytes


def check_fits(need: int, device: torch.device | str,
               free_bytes: int | None = None, what: str = "the grid step"
               ) -> None:
    """Raise ValueError, naming the bytes, where ``need`` bytes (a step's
    ``device_bytes``) do not fit the free memory of the card ``device``
    (``free_bytes``: as if that much were free).  Called before the step's
    tensors are allocated; a CPU device has no such limit here.  ``what``
    names the step in the message."""
    device = torch.device(device)
    if device.type != "cuda" and free_bytes is None:
        return
    free = card_free_bytes(device) if free_bytes is None else free_bytes
    if need > free:
        raise ValueError(f"{what} needs {need} bytes on {device} and "
                         f"{free} are free: fewer agents, waypoints or lanes, "
                         "or tiles over more cards")


def bin_state(cfg: StepConfig, sim: SimState, row_block: int = 2) -> GridState:
    """One-time conversion: flat agent tensors -> cell-resident grid.

    Stable sort by cell id, rank within the cell, slots beyond K dropped —
    the same placement as the reference (argsort and scatter are fine here,
    off the hot path)."""
    dims = GridDims.build(cfg, row_block)
    grid, k = cfg.grid, dims.k
    a = sim.agents
    dev = a.pos.device
    cid = compute_cell_ids(a.pos, a.active, grid).long()
    order = torch.sort(cid, stable=True).indices
    cid_s = cid[order]
    n = cid_s.shape[0]
    idx = torch.arange(n, device=dev)
    is_start = torch.ones(n, dtype=torch.bool, device=dev)
    is_start[1:] = cid_s[1:] != cid_s[:-1]
    run_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    rank = idx - run_start
    ok = (cid_s < grid.n_cells) & (rank < k)
    cy = cid_s[ok] // grid.nx
    cx = cid_s[ok] % grid.nx
    src = order[ok]
    rows = torch.cat([
        a.pos[src], a.vel[src], a.speed[src, None],
        a.dest[src, None].float(), torch.ones((src.shape[0], 1), device=dev),
    ], dim=1)  # [n_ok, 7]
    d = torch.zeros((dims.ny_pad + 2, k, 8, dims.nxl), dtype=torch.float32,
                    device=dev)
    for c in range(7):
        d[cy + 1, rank[ok], c, cx + 1] = rows[:, c]
    d[:, 0, 7, :] = d[:, :, 6, :].sum(dim=1)  # per-cell count at slot 0
    return GridState(d=d, step=sim.step)


def make_initial_grid_state(cfg: StepConfig, generator: torch.Generator,
                            device: torch.device | str = "cuda",
                            row_block: int = 2) -> GridState:
    """The once-spawned initial agents (``make_initial_state``), binned
    (the reference's sfm_grid.py:133-137)."""
    return bin_state(cfg, make_initial_state(cfg, generator, device), row_block)


def unbin_state(cfg: StepConfig, gs: GridState, n_out: int | None = None
                ) -> SimState:
    """Grid -> flat agent tensors (checkpoint / render / diagnostics).

    Active agents compact to the front, in grid order.  ``n_out`` sizes
    the flat tensors; by default cfg.capacity grown in power-of-two steps
    to hold the live population, so a round trip never truncates actives.
    Off the hot path: the population read is a device sync."""
    rows = gs.d.permute(0, 1, 3, 2).reshape(-1, 8)  # [slots, 8]
    act = rows[:, 6] > 0.5
    if n_out is None:
        n_out = cfg.capacity
        n_live = int(act.sum())
        while n_out < n_live:
            n_out *= 2
    order = torch.sort((~act).to(torch.int8), stable=True).indices[:n_out]
    sel = torch.zeros((n_out, 8), dtype=torch.float32, device=rows.device)
    sel[: order.shape[0]] = rows[order]
    agents = AgentState(
        pos=sel[:, 0:2].contiguous(),
        vel=sel[:, 2:4].contiguous(),
        speed=sel[:, 4].contiguous(),
        dest=sel[:, 5].to(torch.int32),
        active=sel[:, 6] > 0.5,
    )
    return SimState(agents=agents, step=gs.step)


def spawn_scatter(cfg: StepConfig, d: torch.Tensor, cand: AgentState,
                  row_lo: int = 0, n_rows: int | None = None,
                  col_lo: int = 0, n_cols: int | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scatter spawn candidates into free grid slots, IN PLACE in ``d``.

    ``d`` [n_rows+2, K, 8, NXL] holds cell rows [row_lo, row_lo + n_rows)
    and columns [col_lo, col_lo + n_cols) (lane l = column col_lo + l - 1):
    the whole grid by default, or one tile of it (parallel/tile2d.py).  A
    candidate is written iff its cell lies in that window or its one-cell
    ghost ring, but counted (spawned, dropped) only where the window owns
    it: every tile runs the same candidates, and a ghost copy lands where
    the owner's own placement does, since ranks follow the stream's order
    and the ghost ring's counts were just exchanged (the reference's
    sfm_grid.py:140-161).

    Slot = the cell's count (ch 7, slot 0) + the candidate's rank among
    same-cell candidates in stream order; candidates beyond K are dropped
    and counted.  Written channels 0-6 of the slot, then the count channel
    += 1 per written candidate — bit-equal to the reference's scatter.
    Every candidate row takes part in one fixed-size scatter: a row that is
    not written goes to a dump slot (slot 0 of ghost row 0 in the last,
    padding lane) and writes back what that slot holds, so nothing waits on
    the host.  Returns (d, n_spawned, n_dropped) with 0-d i32 tensors."""
    grid = cfg.grid
    k = cfg.table_capacity
    n2, kk, ch, nxl = d.shape
    if n_rows is None:
        n_rows = n2 - 2
    if n_cols is None:
        n_cols = grid.nx
    if kk != k or ch != 8 or n2 != n_rows + 2 or n_cols + 2 >= nxl:
        raise ValueError(f"d shape {tuple(d.shape)} does not match K={k}, "
                         f"{n_rows} rows, {n_cols} columns")
    dev = d.device
    cand = cand.to(dev)
    s = cand.pos.shape[0]
    gx = torch.floor(true_divide(cand.pos[:, 0], grid.unit))
    cy = torch.floor(true_divide(cand.pos[:, 1], grid.unit))
    ing = cand.active & (gx >= 0) & (gx < grid.nx) & (cy >= 0) & (cy < grid.ny)
    owned = (ing & (cy >= row_lo) & (cy < row_lo + n_rows)
             & (gx >= col_lo) & (gx < col_lo + n_cols))
    writable = (ing & (cy >= row_lo - 1) & (cy < row_lo + n_rows + 1)
                & (gx >= col_lo - 1) & (gx < col_lo + n_cols + 1))
    n_spawned = owned.sum().to(torch.int32)
    ly = torch.where(writable, cy - row_lo, 0.0).long()  # -1 .. n_rows
    lx = torch.where(writable, gx - col_lo, 0.0).long()  # -1 .. n_cols
    cell = torch.where(writable, (ly + 1) * (grid.nx + 2) + (lx + 1),
                       n2 * (grid.nx + 2))
    order = torch.sort(cell, stable=True).indices
    cell_s = cell[order]
    idx = torch.arange(s, device=dev)
    is_start = torch.ones(s, dtype=torch.bool, device=dev)
    is_start[1:] = cell_s[1:] != cell_s[:-1]
    rank = idx - torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    lx_s, ly_s = lx[order], ly[order]
    writable_s, owned_s = writable[order], owned[order]
    flat = d.view(-1)
    row_at = (ly_s + 1) * (k * 8 * nxl) + (lx_s + 1)  # slot 0, ch 0 of the cell
    slot_k = flat[row_at + 7 * nxl].long() + rank
    ok = writable_s & (slot_k < k)
    n_drop = (n_spawned - (owned_s & ok).sum()).to(torch.int32)

    dump = nxl - 1  # ghost row 0, slot 0, ch 0, the last lane: padding
    tgt = torch.where(ok, row_at + torch.clamp(slot_k, 0, k - 1) * (8 * nxl), dump)
    speed = cand.speed[order]
    vals = [cand.pos[order, 0], cand.pos[order, 1], torch.zeros_like(speed),
            torch.zeros_like(speed), speed, cand.dest[order].float(),
            torch.ones_like(speed)]
    for c, v in enumerate(vals):
        at = tgt + c * nxl
        flat.scatter_(0, at, torch.where(ok, v, flat[at]))
    cnt_at = torch.where(ok, row_at, dump) + 7 * nxl
    flat.scatter_add_(0, cnt_at, ok.float())
    return d, n_spawned, n_drop


def assert_movement_fits_rebin(cfg: StepConfig) -> None:
    """Movement must stay under one cell per step for the 3x3 rebin
    window."""
    phys = cfg.physics
    max_step = phys.max_speed_factor * (phys.speed_mean + 8 * phys.speed_std) \
        * phys.delta_time
    if not max_step < cfg.grid.unit:
        raise ValueError(f"max step {max_step} m does not fit a "
                         f"{cfg.grid.unit} m cell")


def debug_segments(cfg: StepConfig, device: torch.device | str = "cuda"
                   ) -> torch.Tensor | None:
    """The obstacle edge table of the --no-distance-map kernel mode
    (reference sfm_pallas.py:49-60, args.rs:27-31): None on the default
    path, else ``segment_table`` of the scenario's obstacles on
    ``device``."""
    if cfg.use_distance_map:
        return None
    return segment_table(
        [(s.line[0][0], s.line[0][1], s.line[1][0], s.line[1][1], s.width)
         for s in cfg.scenario.obstacles], device)


def _segments_on(cfg: StepConfig) -> Callable[[torch.device], torch.Tensor | None]:
    """device -> ``debug_segments(cfg)`` there: built once on the host,
    copied once per device (a copy from the host waits for it)."""
    table = debug_segments(cfg, "cpu")
    copies: dict[torch.device, torch.Tensor] = {}

    def on(device: torch.device) -> torch.Tensor | None:
        if table is None:
            return None
        if device.type == "cuda" and device.index is None:  # "cuda": the current card
            device = torch.device("cuda", torch.cuda.current_device())
        if device not in copies:
            copies[device] = table.to(device)
        return copies[device]

    return on


def _check_config(cfg: StepConfig) -> int:
    stride = stride_for(cfg)
    if stride is None or not cfg.scenario.waypoints:
        raise ValueError("grid backend needs an integral neighbor/field unit "
                         "ratio and at least one waypoint")
    assert_movement_fits_rebin(cfg)
    return stride


def make_kernel_chain(cfg: StepConfig, row_block: int = 2,
                      incremental: bool = False, mover_k: int = 8
                      ) -> Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                                    torch.Tensor]:
    """Kernels-only step (fused step + rebin, no spawn, no metrics):
    ``(d, fwp, fobs) -> d'`` — the surface behind the kernel-time
    diagnostic slot.  ``incremental`` runs the steady-state branch of the
    hybrid (mover emit + incremental rebin, no choice)."""
    forces, rebins = tile_kernels(cfg, row_block, incremental, mover_k)
    grid = cfg.grid

    def chain(d: torch.Tensor, fwp: torch.Tensor, fobs: torch.Tensor
              ) -> torch.Tensor:
        g, m, _mdmx, _flag = forces(d, fwp, fobs, compact=True)
        if incremental:
            return rebin_incremental(g, m, grid.unit, grid.nx, grid.ny,
                                     row_block=row_block)[0]
        return rebins(g, None, None)[0]

    return chain


def tile_kernels(cfg: StepConfig, row_block: int = 2, incremental: bool = True,
                 mover_k: int = 8, devices=()):
    """The kernels of a grid step on one grid, or on one tile of a grid cut
    into tiles (parallel/tile2d.py, which exchanges the tiles' ghosts
    between the two): ``(forces, rebins)``.

    ``forces(d, fwp, fobs, compact, **tile) -> (G, M, mdmx, flag)`` runs the
    fused step kernel; in the hybrid (``incremental``) it also emits each
    cell's movers (at most ``mover_k``) and, on a step that ``compact``
    does not send to the full rebin, makes the device flag of the full
    rebin: some cell had more movers than the table holds, or the scenario
    spawns and its fullest cell's slot bound is >= K - 1
    (sfm_grid.py:396-419).  M, mdmx and flag are None where not made.
    ``rebins(G, M, flag, **tile) -> (D', ovf, dmx, n_in, n_out)`` runs the
    full rebin where flag is None, else both rebins launched with the flag,
    of which only the selected one runs its body: no host sync.  ``tile``
    holds a tile's ``row_offset``, ``col_offset`` and ``nx_local``; none for
    a whole grid.  The segment table (segment mode) is copied to each of
    ``devices`` now, to another device at its first step."""
    stride = _check_config(cfg)
    segs_on = _segments_on(cfg)
    for dev in devices:
        segs_on(torch.device(dev))
    grid = cfg.grid
    k = cfg.table_capacity
    mk = min(mover_k, k)
    spawning = cfg.spawn.total > 0

    def forces(d: torch.Tensor, fwp: torch.Tensor, fobs: torch.Tensor,
               compact: bool, **tile):
        kw = dict(stride=stride, field_unit=cfg.field_unit,
                  segments=segs_on(d.device), row_block=row_block, **tile)
        if not incremental:
            return (fused_step(d, fwp, fobs, cfg.physics, cfg.scenario.size, **kw),
                    None, None, None)
        g, m, movf, mdmx = fused_step(d, fwp, fobs, cfg.physics,
                                      cfg.scenario.size, emit_movers=mk, **kw)
        if compact:
            return g, m, mdmx, None
        need_full = movf.sum() > 0.0
        if spawning:
            need_full = need_full | (d[:, 0, 7, :].amax() >= float(k - 1))
        return g, m, mdmx, need_full.to(torch.int32)

    def rebins(g: torch.Tensor, m: torch.Tensor | None,
               flag: torch.Tensor | None, **tile) -> tuple[torch.Tensor, ...]:
        args = (grid.unit, grid.nx, grid.ny)
        if flag is None:
            return rebin(g, *args, row_block=row_block, **tile)
        out = new_outputs(g, row_block)
        rebin(g, *args, row_block=row_block, gate=flag, out=out, **tile)
        rebin_incremental(g, m, *args, row_block=row_block, gate=flag, out=out,
                          **tile)
        return out

    return forces, rebins


def step_metrics(outs, n_spawned: torch.Tensor, n_dropped: torch.Tensor,
                 mdmx, home: torch.device) -> StepMetrics:
    """A step's metrics from the rebins' per-block outputs ``outs`` of each
    grid (one, or one a tile) and their peak mover counts ``mdmx`` (empty
    off the hybrid): summed, or max-ed, on ``home``, all on the device."""

    def over(ts, op):  # a whole grid needs no reduction over grids
        ts = [t.to(home) for t in ts]
        return ts[0] if len(ts) == 1 else op(torch.stack(ts))

    # Exact: per-block sums are integer-valued f32 far below 2^24.
    n_active = over([o[3].sum() for o in outs], torch.sum).to(torch.int32)
    n_overflow = over([o[1].sum() for o in outs], torch.sum).to(torch.int32)
    n_after = over([o[4].sum() for o in outs], torch.sum).to(torch.int32)
    return StepMetrics(
        n_active=n_active,
        n_spawned=n_spawned,
        n_dropped=n_dropped,
        n_overflow=n_overflow,
        max_demand=over([o[2].max() for o in outs], torch.max).to(torch.int32),
        n_exited=(n_active - n_after) - n_overflow,
        max_mover_demand=(over([x.max() for x in mdmx], torch.max).to(torch.int32)
                          if mdmx else torch.zeros((), dtype=torch.int32,
                                                   device=home)),
    )


def make_step_grid(cfg: StepConfig, row_block: int = 2,
                   incremental: bool = True, mover_k: int = 8,
                   compact_every: int = 8,
                   generator: torch.Generator | None = None):
    """Build the grid-resident step:
    ``step(state, fwp, fobs, cand=None) -> (GridState, StepMetrics)``.

    ``incremental`` (the reference's default) runs the hybrid: the step
    kernel also emits each cell's movers (at most ``mover_k``), and the
    rebin is the incremental one unless (a) some cell had more movers
    than the table holds, (b) ``state.step % compact_every == 0``, or (c)
    the scenario spawns and its fullest cell's slot bound is >= K - 1
    (``tile_kernels``).  (b) is a host int, so those steps launch the
    full rebin alone; (a) and (c) are read on the device.
    While tracing is on (``utils/trace.enabled()``), ``step.full_rebins``
    (0-d int32, on the device) counts the steps that took the full rebin;
    it stays None until then, so an untraced step launches no add for it.

    ``cand`` injects this step's spawn candidates (an AgentState of the
    scenario's S = spawn.total rows); when None they are drawn from
    ``generator``, which must then be given for a spawning scenario.
    The spawn scatter writes into ``state.d`` in place (no ~100 MB copy at
    1M agents): the input state is consumed."""
    forces, rebins = tile_kernels(cfg, row_block, incremental, mover_k)
    s = cfg.spawn.total
    if s > 0 and generator is None:
        raise ValueError("a spawning scenario needs a torch.Generator")
    draw = spawn_sampler(cfg, generator.device) if s > 0 else None

    def step(state: GridState, fwp: torch.Tensor, fobs: torch.Tensor,
             cand: AgentState | None = None
             ) -> tuple[GridState, StepMetrics]:
        with trace.span("grid.step"):
            d = state.d
            zero = torch.zeros((), dtype=torch.int32, device=d.device)
            n_spawned = n_spawn_drop = zero
            with trace.span("grid.spawn"):
                if s > 0:
                    if cand is None:
                        cand = draw(generator)
                    d, n_spawned, n_spawn_drop = spawn_scatter(cfg, d, cand)
            compact = state.step % compact_every == 0
            with trace.span("grid.forces"):
                g, m, mdmx, flag = forces(d, fwp, fobs, compact)
            with trace.span("grid.rebin"):
                out = rebins(g, m, flag)
            with trace.span("grid.metrics"):
                if incremental and trace.enabled():
                    if step.full_rebins is None:
                        step.full_rebins = torch.zeros((), dtype=torch.int32,
                                                       device=d.device)
                    step.full_rebins += 1 if flag is None else flag
                metrics = step_metrics([out], n_spawned, n_spawn_drop,
                                       [mdmx] if incremental else [], d.device)
            return GridState(d=out[0], step=state.step + 1), metrics

    step.full_rebins = None
    return step
