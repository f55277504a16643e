"""2D tiling of the cell-resident grid backend: rows x columns of tiles,
one tile a device.

Counterpart of pedoni_tpu/parallel/tile2d.py.  The reference runs one
controller over a JAX mesh, global across processes once
``jax.distributed`` is up; here a process drives a list of devices, one
tile an entry (the list may name one device more than once: the tiles then
share it, and the step runs the same code as on as many cards).  The
tiles may be spread over the processes of a ``torch.distributed`` group
(``transport.ProcessGroup``): rank r owns a contiguous block of whole tile
rows, so that columns exchange within a rank and rows across ranks
(docs/multihost.md, "Mapping the mesh to hardware"); each function below
takes the transport and, where it takes devices, one device for each tile
of this process (``transport.tiles``).  Without a transport every tile is
in this process (``transport.Local``).

Layout per tile (r, c): ``d [rl+2, K, 8, NXL_loc]``, GHOST-CARRYING — rows
0 and rl+1 are ghost rows, lane ``l`` holds global cell column
``c*cl + l - 1`` with lanes 0 and cl+1 as ghost lanes, lanes >= cl+2 zero
padding to the 128-lane tile.  Positions stay in GLOBAL coordinates; the
kernels take the tile's row and column offsets.

A step (``make_sharded_step``):
1. ``exchange`` on D: ghost lanes from the lane neighbours' own edge lanes,
   then ghost rows from the row neighbours' edge rows, ghost lanes
   included, so that a corner cell's 3x3 window holds the diagonal tile's
   edge cell;
2. the spawn scatter into each tile's window, ghost ring included,
   counted by the owner only (``sfm_grid.spawn_scatter``); every tile
   sees the same candidates, drawn once a step from one generator;
3. the fused step kernel with the tile's offsets;
4. ``exchange`` on G, and on the mover table M in the hybrid, so that the
   rebin picks migrants out of ghost rows and lanes: a tile keeps what
   lands in its own cells (migration in any of the 8 directions);
5. the rebin with the tile's offsets; in the hybrid the full-or-
   incremental choice is made per tile on its device, the compaction
   cadence on the host, the same for all tiles;
6. the metrics, summed (or max-ed) over this process's tiles on its first
   tile's device, then over the processes (``all_reduce_metrics``), so
   that every rank returns the same metrics.

Every kernel block sees exactly the window one grid would, so R x C tiles
give the whole grid's result bit for bit.

``dryrun`` runs a few tiled steps on tiny shapes.  Not ported:
``make_mesh`` (a device list takes its place), the waypoint plane lists
and slot split (the port's kernels need neither).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..field import Field, FieldMaps
from ..models.sfm import (AgentState, SimState, StepConfig, StepMetrics,
                          make_initial_state, spawn_sampler)
from ..models.sfm_grid import (
    GridDims,
    GridState,
    _check_config,
    bin_state,
    spawn_scatter,
    step_metrics,
    stride_for,
    tile_kernels,
    unbin_state,
)
from ..ops.fields6 import Fields6
from ..scenario import loads_scenario
from .transport import Local, Transport, all_reduce_metrics, check_replicated


@dataclasses.dataclass(frozen=True)
class Tile2DConfig:
    """Static layout of the rows x cols tile decomposition."""

    base: StepConfig
    rows: int  # R tiles along cell rows
    cols: int  # C tiles along cell columns
    rows_local: int  # own cell rows a tile (a multiple of row_block)
    cols_local: int  # own cell columns a tile
    row_block: int
    nxl_local: int  # lanes a tile (cols_local + 3, 128-padded)

    @property
    def n_devices(self) -> int:
        return self.rows * self.cols

    @property
    def ny_total(self) -> int:
        return self.rows * self.rows_local

    @classmethod
    def build(cls, cfg: StepConfig, rows: int, cols: int,
              row_block: int = 2) -> "Tile2DConfig":
        """The reference's arithmetic: tiles of ceil(ny / (rb R)) * rb rows
        and ceil(nx / C) columns, so a split may leave tiles that own fewer
        cells, or none (an empty trailing strip).  The port's acceptance is
        the grid backend's own (``sfm_grid._check_config``) with a tile's
        int32 indexing in place of the reference's VMEM rule."""
        if rows < 1 or cols < 1:
            raise ValueError(
                f"tile must have rows >= 1 and cols >= 1, got {rows}x{cols}")
        _check_config(cfg)
        rb = row_block
        rl = -(-cfg.grid.ny // (rb * rows)) * rb
        cl = -(-cfg.grid.nx // cols)
        nxl = -(-(cl + 3) // 128) * 128
        if (rl + 2) * cfg.table_capacity * 8 * nxl >= 2**31:
            raise ValueError("tile too large for int32 flat indexing")
        return cls(base=cfg, rows=rows, cols=cols, rows_local=rl,
                   cols_local=cl, row_block=rb, nxl_local=nxl)

    def origin(self, i: int) -> tuple[int, int]:
        """(global cell row, global cell column) of tile i's row 1, lane 1;
        tiles are numbered row-major."""
        r, c = divmod(i, self.cols)
        return r * self.rows_local, c * self.cols_local

    def own_cols(self, i: int) -> int:
        """The columns of the field that tile i owns: cols_local, fewer in
        the last column of tiles, or none."""
        return max(0, min(self.cols_local,
                          self.base.grid.nx - self.origin(i)[1]))


class TiledGridState(NamedTuple):
    d: tuple[torch.Tensor, ...]  # per tile of this process, row-major:
    #                              [rl+2, K, 8, NXL_loc]
    step: int


def _transport(tcfg: Tile2DConfig, transport: Transport | None) -> Transport:
    """``transport``, or every tile in this process; a process must own
    whole rows of tiles."""
    if transport is None:
        return Local(tcfg.n_devices)
    if transport.n_tiles != tcfg.n_devices or tcfg.rows % transport.world:
        raise ValueError(
            f"{tcfg.rows}x{tcfg.cols} tiles over {transport.world} processes "
            f"({transport.n_tiles} tiles): a process owns whole rows of "
            "tiles, so the rows must divide by the processes")
    return transport


def shard_device_inputs(tcfg: Tile2DConfig, maps: FieldMaps, stride: int
                        ) -> list[tuple[np.ndarray, np.ndarray]]:
    """Per-tile field slabs (wp [n_wp, rows, S, 4, NXL_loc], obs [rows, S, 4,
    NXL_loc]), row-major, sliced in rows AND lanes from the fields6 planes
    of the whole padded grid, so that a tile's kernels index them locally
    and need only the offsets; ``rows`` is what the fused step kernel needs
    for a slab of rl + 2 grid rows."""
    cfg = tcfg.base
    rl, cl, s = tcfg.rows_local, tcfg.cols_local, stride
    f6 = Fields6.build(maps, cfg.grid.nx, tcfg.ny_total, stride=s)
    r_need = s * (rl + 3) + 3 + 2  # the kernel's: stride * (ny2 + 1) + ROW0 + 2
    lane_need = (tcfg.cols - 1) * cl + tcfg.nxl_local
    pad = max(0, lane_need - f6.wp.shape[-1])  # the last column of tiles
    wp = np.pad(f6.wp, [(0, 0)] * 4 + [(0, pad)])
    obs = np.pad(f6.obs, [(0, 0)] * 3 + [(0, pad)])
    out = []
    for i in range(tcfg.n_devices):
        r0, c0 = tcfg.origin(i)
        rows = slice(r0 * s, r0 * s + r_need)
        lanes = slice(c0, c0 + tcfg.nxl_local)
        out.append((np.ascontiguousarray(wp[:, rows, ..., lanes]),
                    np.ascontiguousarray(obs[rows, ..., lanes])))
    return out


def device_inputs(tcfg: Tile2DConfig, maps: FieldMaps, stride: int,
                  devices: Sequence[torch.device | str],
                  transport: Transport | None = None
                  ) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """``shard_device_inputs`` of this process's tiles as tensors, each
    tile's on its device: (fwp slabs, fobs slabs)."""
    tiles = _transport(tcfg, transport).tiles
    slabs = shard_device_inputs(tcfg, maps, stride)
    return ([torch.from_numpy(slabs[i][0]).to(dev) for i, dev in zip(tiles, devices)],
            [torch.from_numpy(slabs[i][1]).to(dev) for i, dev in zip(tiles, devices)])


def make_sharded_grid_state(tcfg: Tile2DConfig, state: SimState,
                            devices: Sequence[torch.device | str],
                            transport: Transport | None = None,
                            generator: torch.Generator | None = None
                            ) -> TiledGridState:
    """Bin a flat state (``bin_state``, on the agents' device) and cut the
    grid into ghost-carrying tiles, this process's each on its device: own
    rows and lanes copied, ghosts and padding zero (the step refreshes the
    ghosts).  Across processes every rank must hold the same flat state and
    the step's ``generator`` in the same state (``check_replicated``)."""
    cfg = tcfg.base
    rl, cl = tcfg.rows_local, tcfg.cols_local
    transport = _transport(tcfg, transport)
    check_replicated(transport, cfg, state.agents, generator)
    full = bin_state(cfg, state, row_block=tcfg.row_block).d
    tiles = []
    for i, dev in zip(transport.tiles, devices):
        r0, c0 = tcfg.origin(i)
        n_own = tcfg.own_cols(i)
        n_rows = max(0, min(rl, full.shape[0] - 2 - r0))
        t = torch.zeros((rl + 2, full.shape[1], 8, tcfg.nxl_local),
                        dtype=torch.float32, device=dev)
        t[1:1 + n_rows, ..., 1:1 + n_own] = \
            full[1 + r0:1 + r0 + n_rows, ..., 1 + c0:1 + c0 + n_own].to(dev)
        tiles.append(t)
    return TiledGridState(d=tuple(tiles), step=state.step)


def gather(tcfg: Tile2DConfig, gs: TiledGridState,
           transport: Transport | None = None, everywhere: bool = False
           ) -> torch.Tensor | None:
    """The tiles' own cells as one whole grid [ny_pad+2, K, 8, NXL] on the
    first tile's device (the layout of ``bin_state``).  Across processes
    the grid is collected onto rank 0, and the other ranks get None; with
    ``everywhere`` every rank gets it."""
    cfg = tcfg.base
    dims = GridDims.build(cfg, tcfg.row_block)
    tiles = _transport(tcfg, transport).collect(gs.d, everywhere)
    if tiles is None:
        return None
    dev = gs.d[0].device
    full = torch.zeros((dims.ny_pad + 2, dims.k, 8, dims.nxl),
                       dtype=torch.float32, device=dev)
    for i, t in enumerate(tiles):
        r0, c0 = tcfg.origin(i)
        n_own = tcfg.own_cols(i)
        n_rows = max(0, min(tcfg.rows_local, dims.ny_pad - r0))
        full[1 + r0:1 + r0 + n_rows, ..., 1 + c0:1 + c0 + n_own] = \
            t[1:1 + n_rows, ..., 1:1 + n_own].to(dev)
    return full


def unbin_sharded(tcfg: Tile2DConfig, gs: TiledGridState,
                  n_out: int | None = None, transport: Transport | None = None,
                  everywhere: bool = False) -> SimState | None:
    """The tiled grid back to flat agent tensors (``unbin_state`` of the
    gathered grid): on rank 0 across processes, None on the others (every
    rank with ``everywhere``)."""
    full = gather(tcfg, gs, transport, everywhere)
    if full is None:
        return None
    return unbin_state(tcfg.base, GridState(d=full, step=gs.step), n_out)


def population(gs: TiledGridState, transport: Transport | None = None) -> int:
    """Active agents of the tiles (their ghosts are empty between steps),
    over every process."""
    n = sum(int((t[:, :, 6, :] > 0.5).sum()) for t in gs.d)
    if transport is None:
        return n
    return int(transport.all_sum(torch.tensor([n], device=gs.d[0].device))[0])


def exchange(tcfg: Tile2DConfig, tiles: Sequence[torch.Tensor],
             transport: Transport | None = None) -> None:
    """Refresh the ghosts of tensors of the D / G / M layout, in place:
    ghost lanes 0 and cl+1 from the lane neighbours' own edge lanes cl and
    1, then ghost rows 0 and rl+1 from the row neighbours' own edge rows rl
    and 1, ghost lanes included, so that corners carry.  Ghosts at the
    field's edges keep what the kernels wrote there: no agent (the step
    kernel and the rebins leave no agent in an edge ghost).  The
    reference's ppermute, through ``transport``: ``tiles`` are this
    process's, in tile order (row-major)."""
    rl, cl, cols = tcfg.rows_local, tcfg.cols_local, tcfg.cols
    n = tcfg.n_devices
    t = _transport(tcfg, transport)
    right = [(i, i + 1) for i in range(n) if i % cols < cols - 1]
    down = [(i, i + cols) for i in range(n - cols)]
    t.shift((right, [x[..., cl] for x in tiles], [x[..., 0] for x in tiles]),
            ([(b, a) for a, b in right], [x[..., 1] for x in tiles],
             [x[..., cl + 1] for x in tiles]))
    t.shift((down, [x[rl] for x in tiles], [x[0] for x in tiles]),
            ([(b, a) for a, b in down], [x[1] for x in tiles],
             [x[rl + 1] for x in tiles]))


def make_sharded_step(tcfg: Tile2DConfig, devices: Sequence[torch.device | str],
                      incremental: bool = True, mover_k: int = 8,
                      compact_every: int = 8,
                      generator: torch.Generator | None = None,
                      transport: Transport | None = None):
    """Build the tiled step: ``step(state, fwp_slabs, fobs_slabs, cand=None)
    -> (TiledGridState, StepMetrics)``, the contract of
    ``sfm_grid.make_step_grid`` on a TiledGridState, with the same kernels
    on each tile (``sfm_grid.tile_kernels``; see the module's docstring).
    ``devices`` holds one device for each of this process's tiles.
    ``step.full_rebins`` ([tiles of this process] int32 on the first tile's
    device) counts each tile's steps that took the full rebin.  The input
    state is consumed (the tiles are written in place)."""
    cfg = tcfg.base
    s = cfg.spawn.total
    rl, cl = tcfg.rows_local, tcfg.cols_local
    transport = _transport(tcfg, transport)
    own = transport.tiles
    devices = [torch.device(dv) for dv in devices[: len(own)]]
    if len(devices) < len(own):
        raise ValueError(f"{len(own)} tiles of {tcfg.rows}x{tcfg.cols} in this "
                         f"process need {len(own)} devices, got {len(devices)}")
    forces, rebins = tile_kernels(cfg, tcfg.row_block, incremental, mover_k,
                                  devices)
    if s > 0 and generator is None:
        raise ValueError("a spawning scenario needs a torch.Generator")
    draw = spawn_sampler(cfg, generator.device) if s > 0 else None
    home = devices[0]
    origins = [tcfg.origin(i) for i in own]
    tiles_kw = [dict(row_offset=r0, col_offset=c0, nx_local=cl)
                for r0, c0 in origins]

    def step(state: TiledGridState, fwp: Sequence[torch.Tensor],
             fobs: Sequence[torch.Tensor], cand: AgentState | None = None
             ) -> tuple[TiledGridState, StepMetrics]:
        tiles = list(state.d)
        exchange(tcfg, tiles, transport)
        zero = torch.zeros((), dtype=torch.int32, device=home)
        n_spawned = n_dropped = zero
        if s > 0:
            if cand is None:
                cand = draw(generator)
            for d, dev, (r0, c0) in zip(tiles, devices, origins):
                _, n_sp, n_dr = spawn_scatter(cfg, d, cand.to(dev), row_lo=r0,
                                              n_rows=rl, col_lo=c0, n_cols=cl)
                n_spawned = n_spawned + n_sp.to(home)
                n_dropped = n_dropped + n_dr.to(home)
        compact = state.step % compact_every == 0
        ks = [forces(d, wp, ob, compact, **kw)
              for d, wp, ob, kw in zip(tiles, fwp, fobs, tiles_kw)]
        exchange(tcfg, [g for g, _, _, _ in ks], transport)
        gated = incremental and not compact
        if gated:
            exchange(tcfg, [m for _, m, _, _ in ks], transport)
        outs = [rebins(g, m, flag, **kw) for (g, m, _, flag), kw in zip(ks, tiles_kw)]
        if incremental:
            if step.full_rebins is None:
                step.full_rebins = torch.zeros((len(tiles),), dtype=torch.int32,
                                               device=home)
            step.full_rebins += (torch.stack([f.to(home) for _, _, _, f in ks])
                                 if gated else 1)
        metrics = all_reduce_metrics(transport, step_metrics(
            outs, n_spawned, n_dropped,
            [x for _, _, x, _ in ks] if incremental else [], home))
        return (TiledGridState(d=tuple(o[0] for o in outs), step=state.step + 1),
                metrics)

    step.full_rebins = None
    return step


DRYRUN_SCENARIO = """
[field]
size = [24, 24]
[[waypoints]]
line = [[2, 2], [2, 22]]
[[waypoints]]
line = [[22, 2], [22, 22]]
[[obstacles]]
line = [[12, 0], [12, 8]]
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


def dryrun(rows: int, cols: int, device: str = "cuda") -> None:
    """Entry hook: three tiled grid steps of a rows x cols tiling on
    tiny shapes (a spawning 24 x 24 m scenario), tile i on cuda:i, then a
    sanity check.  Where the machine has fewer cards than tiles, tile i
    runs on cuda:(i mod cards), which the printed line says: tiles that
    share a card run the same code as on as many cards.  ``device="cpu"``
    puts every tile on the CPU."""
    n = rows * cols
    if device == "cpu":
        devices = [torch.device("cpu")] * n
    else:
        n_cards = torch.cuda.device_count()
        if n_cards == 0:
            raise RuntimeError("dryrun on cuda, and torch.cuda.device_count() is 0")
        devices = [torch.device("cuda", i % n_cards) for i in range(n)]
    scenario = loads_scenario(DRYRUN_SCENARIO)
    maps = FieldMaps.from_field(Field.from_scenario(scenario, unit=0.25))
    cfg = StepConfig.build(scenario, capacity=1024, neighbor_grid_unit=1.5,
                           table_capacity=8)
    tcfg = Tile2DConfig.build(cfg, rows, cols)
    generator = torch.Generator(device=devices[0]).manual_seed(0)
    fwp, fobs = device_inputs(tcfg, maps, stride_for(cfg), devices)
    state = make_sharded_grid_state(
        tcfg, make_initial_state(cfg, generator, devices[0]), devices)
    step = make_sharded_step(tcfg, devices, generator=generator)
    for _ in range(3):
        state, metrics = step(state, fwp, fobs)
    n_active = int(metrics.n_active)
    if not 0 < n_active <= cfg.capacity:
        raise AssertionError(f"implausible active count {n_active}")
    flat = unbin_sharded(tcfg, state).agents
    if not bool(torch.isfinite(flat.pos[flat.active]).all()):
        raise AssertionError("non-finite positions after the tiled steps")
    names = ", ".join(f"tile {i} on {d}" for i, d in enumerate(devices))
    shared = ("" if device == "cpu" or len(set(devices)) == n
              else " (fewer cards than tiles: cards named more than once)")
    print(f"tile2d dryrun {rows}x{cols}: 3 steps, {n_active} active; "
          f"{names}{shared}", flush=True)
