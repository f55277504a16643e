"""The pallas backend: flat agents through the fused step kernel.

Counterpart of pedoni_tpu/models/sfm_pallas.py (``make_step_pallas``,
its :110-224).  The state is the flat step's (models/sfm.py): agent
tensors of a fixed capacity C.  Each step

1. appends this step's spawn candidates past the capacity;
2. sorts the agents by cell id (a stable sort) and cuts the tail past C
   (counted in ``n_dropped``);
3. scatters the 8 channels (pos, vel, speed, dest, active, count) of
   every agent with a slot into a slot grid with a dump row, transposed
   lane-minor and padded to the grid step's ``[ny_pad+2, K, 8, NXL]``;
4. runs the fused step kernel (ops/kernels/step_kernel.fused_step) in its
   base mode, or with ``use_distance_map=False`` in its segment mode:
   sampling, despawn, all forces and integration;
5. gathers each agent's row back by its slot.

The kernel counts a candidate slot only below its cell's count, which it
reads from ch 7 of slot 0, as the grid state carries it.  The reference
packs zeros there and bounds its pair loop by a per-block occupancy
instead; here ch 7 of slot 0 gets the cell's count after the scatter, the
sum of ch 6 over the K slots.

Deviation from the flat step, as in the reference: agents in a cell that
holds more than K have no slot; they keep their sorted row for the step
(position and velocity unchanged, still active).  ``n_overflow`` counts
them.  The metrics are the reference's four (``n_active``, ``n_spawned``,
``n_dropped``, ``n_overflow``); the other fields stay 0.

The reference's VMEM sizing and its waypoint slot walk are not ported:
the card's memory takes VMEM's place (``device_bytes``, ``supports``), and
each agent samples its own destination plane.  The step reads nothing
back to the host.
"""

from __future__ import annotations

import torch

from ..ops import forcepass
from ..ops.kernels.step_kernel import SEG_COLS, fused_step
from ..ops.neighbor import compute_cell_ids
from . import sfm_grid
from .sfm import (AgentState, SimState, StepConfig, StepMetrics, _concat,
                  spawn_sampler)

# the reference's names for the grid step's helpers; pallas_device_inputs
# gives the step's two field arguments (fwp, fobs)
stride_for = sfm_grid.stride_for
debug_segments = sfm_grid.debug_segments
pallas_device_inputs = sfm_grid.field_tensors

# Bytes of one flat agent: pos and vel f32 [2], speed f32, dest i32, active
# bool.
AGENT_BYTES = 8 + 8 + 4 + 4 + 1
# The slot grid's channels that the sorted agents fill (pos, vel, speed,
# dest, active; ch 7 of slot 0 takes the count), and the kernel's output
# channels that go back to them (pos, vel, active).
_IN_CHANNELS = 7
_OUT_CHANNELS = (0, 1, 2, 3, 6)


def layout_ok(cfg: StepConfig) -> bool:
    """An integral neighbour/field unit ratio in [2, 16] (the fields6
    layout) and at least one waypoint."""
    return stride_for(cfg) is not None and bool(cfg.scenario.waypoints)


def device_bytes(cfg: StepConfig, row_block: int = 2) -> int:
    """Bytes that one step of ``make_step_pallas(cfg, row_block)`` holds on
    its device: the flat state in and out; the C + S appended agents, their
    cell ids and the sort's keys and order; the C sorted agents' channels
    and their slots (as int64: each one's cell's first row, its rank, the
    layout's slot, the gather's offset and one temporary); the slot
    grid ``dk`` with its dump lanes and the kernel's output; its scratch
    (``step_kernel.step_scratch``); the gathered outputs and their
    offsets; fwp and fobs and their texel-major copy (2 * max(n_wp, 1)
    planes of their size); in segment mode the edge table.  The sum of the
    tensors, not the peak."""
    dims = sfm_grid.GridDims.build(cfg, row_block)
    c, n = cfg.capacity, cfg.capacity + cfg.spawn.total
    s = stride_for(cfg) or 6
    n_wp = len(cfg.scenario.waypoints)
    n_obs = 0 if cfg.use_distance_map else len(cfg.scenario.obstacles)
    slots = (dims.ny_pad + 2) * dims.k * dims.nxl
    plane = (s * dims.ny_pad + 3 * s + 5) * s * 4 * dims.nxl  # Fields6's rows
    return (2 * c * AGENT_BYTES
            + n * (AGENT_BYTES + 4 + 4 + 8)  # appended, cid, keys, order
            + c * (_IN_CHANNELS * 4 + 5 * 8  # sorted channels, slots
                   + len(_OUT_CHANNELS) * (4 + 8))  # gathered outputs
            + 8 * (cfg.grid.n_cells + 1)  # the first row of each cell
            + slots * (2 * 8 + 5) * 4  # dk, out, act', (e, acc)
            + 4 * (n_obs * SEG_COLS + (n_wp + 1) * plane + 2 * max(n_wp, 1) * plane))


def supports(cfg: StepConfig, row_block: int = 2,
             free_bytes: int | None = None) -> bool:
    """Whether the pallas step of ``cfg`` runs: ``layout_ok`` and
    ``device_bytes`` within ``free_bytes`` (by default the current card's
    ``sfm_grid.card_free_bytes``) -- the reference's ``supports`` with the
    card's memory in place of VMEM."""
    if not layout_ok(cfg):
        return False
    if free_bytes is None:
        free_bytes = sfm_grid.card_free_bytes()
    return device_bytes(cfg, row_block) <= free_bytes


def _sort(cfg: StepConfig, agents: AgentState):
    """The cell sort, cut to the capacity: (the sorted agents' slot-grid
    channels, _IN_CHANNELS [C] f32 tensors; their cell ids; the in-grid
    flag; the count of in-grid agents before the cut).  Each channel is
    gathered on its own: on the card one gather of [N, 8] rows took 0.63 ms
    of a 2.0 ms step at 1M agents (PERF.md)."""
    grid = cfg.grid
    cid = compute_cell_ids(agents.pos, agents.active, grid)
    order = torch.argsort(cid, stable=True)[:cfg.capacity]
    cols = (agents.pos[:, 0], agents.pos[:, 1], agents.vel[:, 0],
            agents.vel[:, 1], agents.speed, agents.dest.to(torch.float32),
            agents.active.to(torch.float32))
    cols = tuple(col.index_select(0, order) for col in cols)
    cid_s = cid.index_select(0, order)
    # out-of-grid agents carry the sentinel cell id: inactive from here
    # (the kernel's despawn cannot reach agents without a slot)
    return cols, cid_s, cid_s < grid.n_cells, (cid < grid.n_cells).sum()


def slots_of(cid_sorted: torch.Tensor, in_grid: torch.Tensor, grid,
             dims: sfm_grid.GridDims) -> forcepass.CellLayout:
    """``forcepass.build_layout`` in the slot grid ``dk`` [ny_pad+2, K, 8,
    NXL]: each cell-sorted agent's slot is the offset of its (row cy + 1,
    rank, ch 0, lane cx + 1); an agent without one (out of the grid, or
    past K in its cell) gets the grid's size.  Inactive and out-of-grid
    agents carry the sentinel cell id, so ``in_grid`` is the active flag
    here."""
    lanes = 8 * dims.nxl
    return forcepass.build_layout(
        cid_sorted, in_grid, grid, dims.k, strides=(dims.k * lanes, 1, lanes),
        size=(dims.ny_pad + 2) * dims.k * lanes)


def _scatter(dims: sfm_grid.GridDims, cols, slot: torch.Tensor
             ) -> torch.Tensor:
    """The slot grid [ny_pad+2, K, 8, NXL]: one fixed-size scatter a
    channel of the sorted agents (agents without a slot write to a dump
    lane a channel past the grid's end, cut off), then each cell's count
    into ch 7 of slot 0, where the kernel reads it."""
    size = (dims.ny_pad + 2) * dims.k * 8 * dims.nxl
    buf = torch.zeros(size + _IN_CHANNELS * dims.nxl, dtype=torch.float32,
                      device=slot.device)
    for c, col in enumerate(cols):
        buf.index_copy_(0, slot + c * dims.nxl, col)
    dk = buf[:size].view(dims.ny_pad + 2, dims.k, 8, dims.nxl)
    dk[:, 0, 7, :] = dk[:, :, 6, :].sum(dim=1)
    return dk


def slot_grid(cfg: StepConfig, agents: AgentState, row_block: int = 2
              ) -> torch.Tensor:
    """The step kernel's input that the pallas step makes of ``agents``
    (no spawn): the grid state's layout, [ny_pad+2, K, 8, NXL]."""
    dims = sfm_grid.GridDims.build(cfg, row_block)
    cols, cid_s, act_s, _ = _sort(cfg, agents)
    return _scatter(dims, cols, slots_of(cid_s, act_s, cfg.grid, dims).slot)


def make_step_pallas(cfg: StepConfig, row_block: int = 2,
                     generator: torch.Generator | None = None):
    """Build the pallas-backend step: ``step(state, fwp, fobs,
    candidates=None) -> (SimState, StepMetrics)``.

    ``fwp`` and ``fobs`` come from :func:`pallas_device_inputs`; everything
    runs on their device, the fused step kernel on a CUDA card and its
    PyTorch twin on the CPU.  ``candidates`` injects this step's spawn
    candidates (an AgentState of the scenario's S = spawn.total rows); when
    None they are drawn from ``generator``, which must then be given for a
    spawning scenario.  Memory is the caller's to check
    (``device_bytes``, ``sfm_grid.check_fits``)."""
    if not layout_ok(cfg):
        raise ValueError("pallas backend needs an integral neighbor/field unit "
                         "ratio in [2, 16] and at least one waypoint")
    stride = stride_for(cfg)
    dims = sfm_grid.GridDims.build(cfg, row_block)
    grid, nxl = cfg.grid, dims.nxl
    s = cfg.spawn.total
    if s > 0 and generator is None:
        raise ValueError("a spawning scenario needs a torch.Generator")
    draw = spawn_sampler(cfg, generator.device) if s > 0 else None
    segs_on = sfm_grid._segments_on(cfg)
    offsets: dict[torch.device, torch.Tensor] = {}  # made once a device

    def step(state: SimState, fwp: torch.Tensor, fobs: torch.Tensor,
             candidates: AgentState | None = None
             ) -> tuple[SimState, StepMetrics]:
        dev = fwp.device
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        ext, n_spawned = state.agents, zero
        if candidates is None and s > 0:
            candidates = draw(generator)
        if candidates is not None:  # 1. spawns, appended past the capacity
            ext = _concat(ext, candidates)
            n_spawned = candidates.active.sum().to(torch.int32).to(dev)

        # 2. the cell sort (despawn happens in the kernel on this backend)
        cols, cid_s, act_s, n_alive = _sort(cfg, ext)
        n_dropped = (n_alive - act_s.sum()).to(torch.int32)

        # 3. the slot grid
        lay = slots_of(cid_s, act_s, grid, dims)
        dk = _scatter(dims, cols, lay.slot)

        # 4. the fused step kernel, base or segment mode
        out = fused_step(dk, fwp, fobs, cfg.physics, cfg.scenario.size,
                         stride=stride, field_unit=cfg.field_unit,
                         row_block=row_block, segments=segs_on(dev))
        del dk

        # 5. each agent's output channels by its slot; an agent without one
        # keeps its sorted row (the reference's freeze)
        if dev not in offsets:  # a copy from the host waits for it: once
            offsets[dev] = torch.tensor(_OUT_CHANNELS, device=dev) * nxl
        at = torch.where(lay.valid, lay.slot, 0)  # any slot in the grid
        res = out.view(-1).index_select(0, (at[:, None] + offsets[dev]).view(-1)
                                        ).view(-1, len(_OUT_CHANNELS))
        del out
        kept = [torch.where(lay.valid, res[:, i], cols[c])
                for i, c in enumerate(_OUT_CHANNELS[:4])]
        agents = AgentState(
            pos=torch.stack(kept[:2], dim=1), vel=torch.stack(kept[2:], dim=1),
            speed=cols[4], dest=cols[5].to(torch.int32),
            active=torch.where(lay.valid, res[:, 4] > 0.5, act_s),
        )
        metrics = StepMetrics(
            n_active=agents.active.sum().to(torch.int32), n_spawned=n_spawned,
            n_dropped=n_dropped, n_overflow=lay.n_overflow,
            max_demand=zero, n_exited=zero, max_mover_demand=zero)
        return SimState(agents=agents, step=state.step + 1), metrics

    return step
