"""2D tiling of the cell-resident grid backend: rows x columns of tiles,
one tile a device.

Counterpart of pedoni_tpu/parallel/tile2d.py.  The reference runs one
controller over a JAX mesh; here one process drives a list of devices,
one tile an entry (the list may name one device more than once: the tiles
then share it, and the step runs the same code as on as many cards).

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
6. the metrics, summed (or max-ed) over tiles on the first tile's device.

Every kernel block sees exactly the window one grid would, so R x C tiles
give the whole grid's result bit for bit.

Not ported: ``make_mesh`` (a device list takes its place), the waypoint
plane lists and slot split (the port's kernels need neither) and
``dryrun`` (chip_smoke.py drives the tiled step on the card).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..field import FieldMaps
from ..models.sfm import AgentState, SimState, StepConfig, StepMetrics, spawn_sampler
from ..models.sfm_grid import (
    GridDims,
    GridState,
    _check_config,
    bin_state,
    spawn_scatter,
    step_metrics,
    tile_kernels,
    unbin_state,
)
from ..ops.fields6 import Fields6


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
    d: tuple[torch.Tensor, ...]  # per tile, row-major: [rl+2, K, 8, NXL_loc]
    step: int


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
                  devices: Sequence[torch.device | str]
                  ) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """``shard_device_inputs`` as tensors, each tile's on its device:
    (fwp slabs, fobs slabs)."""
    slabs = shard_device_inputs(tcfg, maps, stride)
    return ([torch.from_numpy(wp).to(dev) for (wp, _), dev in zip(slabs, devices)],
            [torch.from_numpy(ob).to(dev) for (_, ob), dev in zip(slabs, devices)])


def make_sharded_grid_state(tcfg: Tile2DConfig, state: SimState,
                            devices: Sequence[torch.device | str]
                            ) -> TiledGridState:
    """Bin a flat state (``bin_state``, on the agents' device) and cut the
    grid into ghost-carrying tiles, each on its device: own rows and lanes
    copied, ghosts and padding zero (the step refreshes the ghosts)."""
    cfg = tcfg.base
    rl, cl = tcfg.rows_local, tcfg.cols_local
    full = bin_state(cfg, state, row_block=tcfg.row_block).d
    tiles = []
    for i, dev in enumerate(devices[: tcfg.n_devices]):
        r0, c0 = tcfg.origin(i)
        n_own = tcfg.own_cols(i)
        n_rows = max(0, min(rl, full.shape[0] - 2 - r0))
        t = torch.zeros((rl + 2, full.shape[1], 8, tcfg.nxl_local),
                        dtype=torch.float32, device=dev)
        t[1:1 + n_rows, ..., 1:1 + n_own] = \
            full[1 + r0:1 + r0 + n_rows, ..., 1 + c0:1 + c0 + n_own].to(dev)
        tiles.append(t)
    return TiledGridState(d=tuple(tiles), step=state.step)


def gather(tcfg: Tile2DConfig, gs: TiledGridState) -> torch.Tensor:
    """The tiles' own cells as one whole grid [ny_pad+2, K, 8, NXL] on the
    first tile's device (the layout of ``bin_state``)."""
    cfg = tcfg.base
    dims = GridDims.build(cfg, tcfg.row_block)
    dev = gs.d[0].device
    full = torch.zeros((dims.ny_pad + 2, dims.k, 8, dims.nxl),
                       dtype=torch.float32, device=dev)
    for i, t in enumerate(gs.d):
        r0, c0 = tcfg.origin(i)
        n_own = tcfg.own_cols(i)
        n_rows = max(0, min(tcfg.rows_local, dims.ny_pad - r0))
        full[1 + r0:1 + r0 + n_rows, ..., 1 + c0:1 + c0 + n_own] = \
            t[1:1 + n_rows, ..., 1:1 + n_own].to(dev)
    return full


def unbin_sharded(tcfg: Tile2DConfig, gs: TiledGridState,
                  n_out: int | None = None) -> SimState:
    """The tiled grid back to flat agent tensors (``unbin_state`` of the
    gathered grid)."""
    return unbin_state(tcfg.base, GridState(d=gather(tcfg, gs), step=gs.step),
                       n_out)


def population(gs: TiledGridState) -> int:
    """Active agents of the tiles (their ghosts are empty between steps)."""
    return sum(int((t[:, :, 6, :] > 0.5).sum()) for t in gs.d)


def exchange(tcfg: Tile2DConfig, tiles: Sequence[torch.Tensor]) -> None:
    """Refresh the ghosts of tensors of the D / G / M layout, in place:
    ghost lanes 0 and cl+1 from the lane neighbours' own edge lanes cl and
    1, then ghost rows 0 and rl+1 from the row neighbours' own edge rows rl
    and 1, ghost lanes included, so that corners carry.  Ghosts at the
    field's edges keep what the kernels wrote there: no agent (the step
    kernel and the rebins leave no agent in an edge ghost).  One process
    copies between the tiles' tensors; the reference's ppermute.  Tile i
    of ``tiles`` is tile i of ``tcfg`` (row-major)."""
    rl, cl, cols = tcfg.rows_local, tcfg.cols_local, tcfg.cols
    for i, x in enumerate(tiles):
        if i % cols > 0:
            x[..., 0].copy_(tiles[i - 1][..., cl])
        if i % cols < cols - 1:
            x[..., cl + 1].copy_(tiles[i + 1][..., 1])
    for i, x in enumerate(tiles):
        if i >= cols:
            x[0].copy_(tiles[i - cols][rl])
        if i < len(tiles) - cols:
            x[rl + 1].copy_(tiles[i + cols][1])


def make_sharded_step(tcfg: Tile2DConfig, devices: Sequence[torch.device | str],
                      incremental: bool = True, mover_k: int = 8,
                      compact_every: int = 8,
                      generator: torch.Generator | None = None):
    """Build the tiled step: ``step(state, fwp_slabs, fobs_slabs, cand=None)
    -> (TiledGridState, StepMetrics)``, the contract of
    ``sfm_grid.make_step_grid`` on a TiledGridState, with the same kernels
    on each tile (``sfm_grid.tile_kernels``; see the module's docstring).
    ``step.full_rebins`` ([n_tiles] int32 on the first tile's device) counts
    each tile's steps that took the full rebin.  The input state is
    consumed (the tiles are written in place)."""
    cfg = tcfg.base
    s = cfg.spawn.total
    rl, cl = tcfg.rows_local, tcfg.cols_local
    devices = [torch.device(dv) for dv in devices[: tcfg.n_devices]]
    if len(devices) < tcfg.n_devices:
        raise ValueError(f"{tcfg.rows}x{tcfg.cols} tiles need "
                         f"{tcfg.n_devices} devices, got {len(devices)}")
    forces, rebins = tile_kernels(cfg, tcfg.row_block, incremental, mover_k,
                                  devices)
    if s > 0 and generator is None:
        raise ValueError("a spawning scenario needs a torch.Generator")
    draw = spawn_sampler(cfg, generator.device) if s > 0 else None
    home = devices[0]
    origins = [tcfg.origin(i) for i in range(tcfg.n_devices)]
    tiles_kw = [dict(row_offset=r0, col_offset=c0, nx_local=cl)
                for r0, c0 in origins]

    def step(state: TiledGridState, fwp: Sequence[torch.Tensor],
             fobs: Sequence[torch.Tensor], cand: AgentState | None = None
             ) -> tuple[TiledGridState, StepMetrics]:
        tiles = list(state.d)
        exchange(tcfg, tiles)
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
        exchange(tcfg, [g for g, _, _, _ in ks])
        gated = incremental and not compact
        if gated:
            exchange(tcfg, [m for _, m, _, _ in ks])
        outs = [rebins(g, m, flag, **kw) for (g, m, _, flag), kw in zip(ks, tiles_kw)]
        if incremental:
            if step.full_rebins is None:
                step.full_rebins = torch.zeros((len(tiles),), dtype=torch.int32,
                                               device=home)
            step.full_rebins += (torch.stack([f.to(home) for _, _, _, f in ks])
                                 if gated else 1)
        metrics = step_metrics(outs, n_spawned, n_dropped,
                               [x for _, _, x, _ in ks] if incremental else [],
                               home)
        return (TiledGridState(d=tuple(o[0] for o in outs), step=state.step + 1),
                metrics)

    step.full_rebins = None
    return step
