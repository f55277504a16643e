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

One device only.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..field import FieldMaps
from ..ops.fields6 import Fields6
from ..ops.kernels.rebin import new_outputs, rebin, rebin_incremental
from ..ops.kernels.step_kernel import fused_step, segment_table
from ..ops.neighbor import compute_cell_ids, true_divide
from .sfm import AgentState, SimState, StepConfig, StepMetrics, spawn_candidates


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


def spawn_scatter(cfg: StepConfig, d: torch.Tensor, cand: AgentState
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scatter spawn candidates into free grid slots, IN PLACE in ``d``.

    Slot = the cell's count (ch 7, slot 0) + the candidate's rank among
    same-cell candidates in stream order; candidates beyond K are dropped
    and counted.  Written channels 0-6 of the slot, then the count channel
    += 1 per written candidate — bit-equal to the reference's scatter.
    Returns (d, n_spawned, n_dropped) with 0-d i32 tensors."""
    grid = cfg.grid
    k = cfg.table_capacity
    n2, kk, ch, nxl = d.shape
    if kk != k or ch != 8:
        raise ValueError(f"d shape {tuple(d.shape)} does not match K={k}")
    dev = d.device
    cand = cand.to(dev)
    s = cand.pos.shape[0]
    gx = torch.floor(true_divide(cand.pos[:, 0], grid.unit))
    cy = torch.floor(true_divide(cand.pos[:, 1], grid.unit))
    owned = (cand.active & (gx >= 0) & (gx < grid.nx) & (cy >= 0)
             & (cy < min(grid.ny, n2 - 2)))
    n_spawned = owned.sum().to(torch.int32)
    gx = torch.where(owned, gx, 0.0).long()
    cy = torch.where(owned, cy, 0.0).long()
    cell = torch.where(owned, (cy + 1) * (grid.nx + 2) + (gx + 1),
                       n2 * (grid.nx + 2))
    order = torch.sort(cell, stable=True).indices
    cell_s = cell[order]
    idx = torch.arange(s, device=dev)
    is_start = torch.ones(s, dtype=torch.bool, device=dev)
    is_start[1:] = cell_s[1:] != cell_s[:-1]
    rank = idx - torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    gx_s, cy_s, owned_s = gx[order], cy[order], owned[order]
    base_cnt = d[cy_s + 1, 0, 7, gx_s + 1].long()
    slot_k = base_cnt + rank
    ok = owned_s & (slot_k < k)
    n_drop = (n_spawned - ok.sum()).to(torch.int32)

    r, sl, ln = cy_s[ok] + 1, slot_k[ok], gx_s[ok] + 1
    src = order[ok]
    vals = [cand.pos[src, 0], cand.pos[src, 1],
            torch.zeros_like(cand.speed[src]), torch.zeros_like(cand.speed[src]),
            cand.speed[src], cand.dest[src].float(),
            torch.ones_like(cand.speed[src])]
    for c, v in enumerate(vals):
        d[r, sl, c, ln] = v
    d.index_put_((r, torch.zeros_like(r), torch.full_like(r, 7), ln),
                 torch.ones_like(cand.speed[src]), accumulate=True)
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
    copied once per device."""
    table = debug_segments(cfg, "cpu")
    copies: dict[torch.device, torch.Tensor] = {}

    def on(device: torch.device) -> torch.Tensor | None:
        if table is not None and device not in copies:
            copies[device] = table.to(device)
        return copies.get(device)

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
    stride = _check_config(cfg)
    grid = cfg.grid
    mk = min(mover_k, cfg.table_capacity)
    segs_on = _segments_on(cfg)

    def chain(d: torch.Tensor, fwp: torch.Tensor, fobs: torch.Tensor
              ) -> torch.Tensor:
        kw = dict(stride=stride, field_unit=cfg.field_unit,
                  segments=segs_on(d.device))
        if incremental:
            g, m, _movf, _mdmx = fused_step(
                d, fwp, fobs, cfg.physics, cfg.scenario.size, emit_movers=mk,
                row_block=row_block, **kw)
            return rebin_incremental(g, m, grid.unit, grid.nx, grid.ny,
                                     row_block=row_block)[0]
        g = fused_step(d, fwp, fobs, cfg.physics, cfg.scenario.size, **kw)
        return rebin(g, grid.unit, grid.nx, grid.ny, row_block=row_block)[0]

    return chain


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
    (sfm_grid.py:396-419).  (b) is a host int, so those steps launch the
    full rebin alone; (a) and (c) are read on the device: both rebins are
    launched with one 0-d int32 flag and only the selected one runs its
    body — no host sync.  ``step.full_rebins`` (0-d int32, on the device)
    counts the steps that took the full rebin.

    ``cand`` injects this step's spawn candidates (an AgentState of the
    scenario's S = spawn.total rows); when None they are drawn from
    ``generator``, which must then be given for a spawning scenario.
    The spawn scatter writes into ``state.d`` in place (no ~100 MB copy at
    1M agents): the input state is consumed."""
    stride = _check_config(cfg)
    segs_on = _segments_on(cfg)
    phys = cfg.physics
    grid = cfg.grid
    s = cfg.spawn.total
    k = cfg.table_capacity
    mk = min(mover_k, k)
    if s > 0 and generator is None:
        raise ValueError("a spawning scenario needs a torch.Generator")

    def kernels(state: GridState, d: torch.Tensor, fwp: torch.Tensor,
                fobs: torch.Tensor):
        """Step kernel and rebin: (D', ovf, dmx, n_in, n_out, mover peak)."""
        kw = dict(stride=stride, field_unit=cfg.field_unit,
                  segments=segs_on(d.device))
        if not incremental:
            g = fused_step(d, fwp, fobs, phys, cfg.scenario.size, **kw)
            return (*rebin(g, grid.unit, grid.nx, grid.ny, row_block=row_block),
                    None)
        g, m, movf, mdmx = fused_step(d, fwp, fobs, phys, cfg.scenario.size,
                                      emit_movers=mk, row_block=row_block, **kw)
        if step.full_rebins is None:
            step.full_rebins = torch.zeros((), dtype=torch.int32, device=d.device)
        if state.step % compact_every == 0:
            out = rebin(g, grid.unit, grid.nx, grid.ny, row_block=row_block)
            step.full_rebins += 1
        else:
            need_full = movf.sum() > 0.0
            if s > 0:
                need_full = need_full | (d[:, 0, 7, :].amax() >= float(k - 1))
            flag = need_full.to(torch.int32)
            out = new_outputs(g, row_block)
            rebin(g, grid.unit, grid.nx, grid.ny, row_block=row_block,
                  gate=flag, out=out)
            rebin_incremental(g, m, grid.unit, grid.nx, grid.ny,
                              row_block=row_block, gate=flag, out=out)
            step.full_rebins += flag
        return (*out, mdmx.max().to(torch.int32))

    def step(state: GridState, fwp: torch.Tensor, fobs: torch.Tensor,
             cand: AgentState | None = None
             ) -> tuple[GridState, StepMetrics]:
        d = state.d
        zero = torch.zeros((), dtype=torch.int32, device=d.device)
        n_spawned = n_spawn_drop = zero
        if s > 0:
            if cand is None:
                cand = spawn_candidates(cfg, generator)
            d, n_spawned, n_spawn_drop = spawn_scatter(cfg, d, cand)
        d_new, ovf, dmx, nact_in, nact_out, mover_peak = kernels(
            state, d, fwp, fobs)
        # Exact: per-block sums are integer-valued f32 far below 2^24.
        n_active = nact_in.sum().to(torch.int32)
        n_overflow = ovf.sum().to(torch.int32)
        n_after = nact_out.sum().to(torch.int32)
        metrics = StepMetrics(
            n_active=n_active,
            n_spawned=n_spawned,
            n_dropped=n_spawn_drop,
            n_overflow=n_overflow,
            max_demand=dmx.max().to(torch.int32),
            n_exited=(n_active - n_after) - n_overflow,
            max_mover_demand=zero if mover_peak is None else mover_peak,
        )
        return GridState(d=d_new, step=state.step + 1), metrics

    step.full_rebins = None
    return step
