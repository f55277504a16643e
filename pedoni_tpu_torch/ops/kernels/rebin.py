"""The two rebins of the post-step grid into fresh cell bins.

``rebin``: counterpart of pedoni_tpu/ops/pallas/rebin.py::rebin_kernel
(pallas_call at rebin.py:570) with ``emit_counts=True``: every output cell
takes the candidates of its 3x3 neighbourhood that land in it, in
(j, dy, dx) order, at slot = running count; landers beyond K are dropped
and counted.  Agents that leave the field vanish (neighbor_grid.rs:29).

``rebin_incremental``: counterpart of rebin.py::rebin_incremental
(pallas_call at rebin.py:488) with ``emit_counts=True``: stayers (G's
ch 7 = the step kernel's stay mask) keep their slots, and the movers of
the 3x3 mover tables M fill the holes in hole-rank order.

Each wrapper launches its hand-written kernel (``csrc/rebin.cu``,
``csrc/rebin_incremental.cu``; a block owns a tile of cells, classifies
every candidate once into per-cell bit masks in shared memory and writes
every output slot from its own thread — ``rebin_launch`` sizes the tile)
on a CUDA tensor and runs its plain PyTorch twin (``rebin_torch``,
``rebin_incremental_torch``) on a CPU tensor.  Both take an optional
device ``gate``: the hybrid step launches both with one 0-d int32 flag,
each kernel's body runs only where the flag selects it (1 = full, 0 =
incremental), and both write the same preallocated ``out`` — the choice
never reaches the host.

Both also take a tile of a larger grid (parallel/tile2d.py), as the
reference's kernels do: ``row_offset`` and ``col_offset`` place the tile
(lane l holds global cell column ``col_offset + l - 1``, row r global cell
row ``row_offset + r - 1``; positions are global), and only the tile's own
lanes [1, min(nx_local + col_offset, nx_cells) - col_offset] keep agents:
an agent that lands in a ghost lane belongs to the lane neighbour, and the
input active count reads the own lanes only.  The defaults are one whole
grid.
"""

from __future__ import annotations

import torch

from ..neighbor import true_divide
from . import _build
from .pairwise import _shift_lane
from .tiles import SMEM_BLOCK_RESERVED, SMEM_SM

FULL, INCREMENTAL = 1, 0  # gate values that select each rebin
REBIN_TILE_LANES = (64, 32)  # candidates, widest first
REBIN_BLOCKS_AN_SM = 4  # blocks an SM should have room for
SLOTS_PER_WORD = 3  # candidate slots whose 9 offsets share a mask word


def rebin_smem_bytes(k: int, mk: int, tile_rows: int, tile_lanes: int) -> int:
    """Shared memory of a rebin block that owns ``tile_rows`` x
    ``tile_lanes`` cells at K = ``k`` (csrc/rebin.cuh smem_bytes, the same
    sum): per cell the lander masks — 9 bits a candidate slot, K slots for
    the full rebin (``mk`` = 0), MK for the incremental one — a count or
    cursor word, a 16-bit source code per output slot, and for the
    incremental rebin the K-bit stay mask."""
    slots = mk if mk > 0 else k
    per_cell = 4 * -(-slots // SLOTS_PER_WORD) + 4 + 2 * k
    if mk > 0:
        per_cell += 4 * -(-k // 32)
    return tile_rows * tile_lanes * per_cell


def rebin_launch(k: int, mk: int, ny2: int, nxl: int, row_block: int
                 ) -> tuple[int, int, int, int]:
    """(tile rows, tile lanes, threads per block, shared-memory bytes) of
    a rebin kernel on a grid [ny2, K, 8, NXL]: ``mk`` = 0 for the full
    rebin, the mover table's MK for the incremental one.

    A block owns ``tile rows`` x ``tile lanes`` cells and has one thread
    per cell of the tile and of the halo rows above and below it (each
    classifies the candidates of its cell); the tiles cover the centre
    rows 1 .. ny2-2 and lanes [0, NXL) exactly.  A tile never
    straddles two blocks of ``row_block`` rows (its sums go to one), so it
    is two rows tall where ``row_block`` is even and one otherwise.  The
    widest tile of REBIN_TILE_LANES that leaves room for
    REBIN_BLOCKS_AN_SM blocks on an SM wins (their warps hide each other's
    phases), and the narrowest leaves that room at every K and MK up to
    255."""
    if (not 1 <= k <= 255 or not 0 <= mk <= 255 or ny2 < 3 or row_block < 1
            or nxl % 128 != 0 or (ny2 - 2) % row_block != 0):
        raise ValueError(f"rebin: unsupported grid ny2={ny2}, K={k}, MK={mk}, "
                         f"NXL={nxl}, row_block={row_block}")
    rows = 2 if row_block % 2 == 0 else 1
    for lanes in REBIN_TILE_LANES:
        need = rebin_smem_bytes(k, mk, rows, lanes)
        if REBIN_BLOCKS_AN_SM * (need + SMEM_BLOCK_RESERVED) <= SMEM_SM:
            break
    return rows, lanes, (rows + 2) * lanes, need


def _check(g: torch.Tensor, row_block: int) -> None:
    if g.dtype != torch.float32 or not g.is_contiguous():
        raise ValueError("g must be contiguous float32")
    ny2, _k, ch, nxl = g.shape
    if ch != 8 or nxl % 128 != 0 or (ny2 - 2) % row_block != 0:
        raise ValueError(
            f"g must be [ny_pad+2, K, 8, NXL] with NXL % 128 == 0 and "
            f"ny_pad % {row_block} == 0, got {tuple(g.shape)}")


def new_outputs(g: torch.Tensor, row_block: int = 2) -> tuple[torch.Tensor, ...]:
    """Outputs for either rebin: (D' [ny2, K, 8, NXL] uninitialised, then
    overflow, demand_max, active_in, active_out [nb] f32, zeroed — the
    kernels accumulate into them)."""
    nb = (g.shape[0] - 2) // row_block
    sums = torch.zeros((4, nb), dtype=torch.float32, device=g.device)
    return (torch.empty_like(g), *sums)


def _check_out(g: torch.Tensor, row_block: int, gate: torch.Tensor | None,
               out) -> None:
    if out is not None:
        nb = (g.shape[0] - 2) // row_block
        shapes = [tuple(g.shape)] + [(nb,)] * 4
        if len(out) != 5 or any(
                tuple(t.shape) != sh or t.dtype != torch.float32
                or t.device != g.device or not t.is_contiguous()
                for t, sh in zip(out, shapes)):
            raise ValueError("out must be new_outputs(g, row_block)")
    if gate is None:
        return
    if out is None:
        raise ValueError("a gated rebin writes into preallocated out")
    if gate.dtype != torch.int32 or gate.device != g.device or gate.dim() != 0:
        raise ValueError("gate must be a 0-d int32 tensor on g's device")


def _twin(gate: torch.Tensor | None, want: int, out, twin):
    """CPU path: run ``twin()`` unless the gate deselects it; results land
    in ``out`` when given."""
    if gate is not None and int(gate) != want:
        return out
    res = twin()
    if out is None:
        return res
    for o, r in zip(out, res):
        o.copy_(r)
    return out


def _ptrs(out, gate: torch.Tensor | None) -> tuple:
    """Kernel pointers: the four [nb] outputs, then the gate (or NULL)."""
    return (*(t.data_ptr() for t in out[1:]),
            gate.data_ptr() if gate is not None else None)


def _lane_hi(nx_cells: int, col_offset: int, nx_local: int | None) -> int:
    """The last own lane of a tile; see the module's docstring."""
    nx_local = nx_cells if nx_local is None else nx_local
    return min(nx_local + col_offset, nx_cells) - col_offset


def rebin(g: torch.Tensor, unit: float, nx_cells: int, ny_cells: int,
          row_block: int = 2, gate: torch.Tensor | None = None,
          out: tuple[torch.Tensor, ...] | None = None, row_offset: int = 0,
          col_offset: int = 0, nx_local: int | None = None
          ) -> tuple[torch.Tensor, ...]:
    """Returns (D' [ny2, K, 8, NXL], overflow, demand_max, active_in,
    active_out), the last four [nb] f32 per block of ``row_block`` rows.

    D' is ghost-carrying (rows 0 and ny2-1 zero); ch 6 = slot < count,
    ch 7 = min(count, K) on every slot.  G's ch 7 is not read.  With
    ``gate`` the body runs only where gate == FULL, into ``out``.  CUDA
    tensors run the kernel (or raise); CPU tensors the twin."""
    _check(g, row_block)
    _check_out(g, row_block, gate, out)
    tile = (row_offset, col_offset, nx_local)
    if g.device.type == "cpu":
        return _twin(gate, FULL, out, lambda: rebin_torch(
            g, unit, nx_cells, ny_cells, row_block, *tile))
    if g.device.type != "cuda":
        raise ValueError(f"rebin: unsupported device {g.device}")
    lib = _build.library()
    ny2, k, _, nxl = g.shape
    out = out if out is not None else new_outputs(g, row_block)
    with torch.cuda.device(g.device):  # a launch goes to the current card
        rc = lib.pedoni_rebin_full(
            g.data_ptr(), out[0].data_ptr(), *_ptrs(out, gate), FULL, ny2, k,
            nxl, row_block, unit, nx_cells, ny_cells, row_offset, col_offset,
            _lane_hi(nx_cells, col_offset, nx_local),
            *rebin_launch(k, 0, ny2, nxl, row_block),
            torch.cuda.current_stream(g.device).cuda_stream)
    _build.check_launch(rc, "pedoni_rebin_full")
    rebin.launches += 1
    return out


rebin.launches = 0


def rebin_incremental(g: torch.Tensor, m: torch.Tensor, unit: float,
                      nx_cells: int, ny_cells: int, row_block: int = 2,
                      gate: torch.Tensor | None = None,
                      out: tuple[torch.Tensor, ...] | None = None,
                      row_offset: int = 0, col_offset: int = 0,
                      nx_local: int | None = None
                      ) -> tuple[torch.Tensor, ...]:
    """Hole-preserving rebin: returns (D', overflow, demand_max, active_in,
    active_out), the contract of ``rebin`` except that bins may hold holes
    and ch 7 = topcnt, the top occupied slot + 1, on every slot.

    g: the step kernel's mover-mode output (ch 7 = stay mask); m its mover
    table [ny2, MK, 8, NXL].  demand_max is the peak of stayers + landing
    movers; overflow counts landers beyond a cell's holes.  With ``gate``
    the body runs only where gate == INCREMENTAL, into ``out``.  CUDA
    tensors run the kernel (or raise); CPU tensors the twin."""
    _check(g, row_block)
    ny2, k, _, nxl = g.shape
    if (m.dtype != torch.float32 or not m.is_contiguous() or m.dim() != 4
            or m.shape[0] != ny2 or m.shape[1] < 1
            or tuple(m.shape[2:]) != (8, nxl)
            or m.device != g.device):
        raise ValueError(f"m must be contiguous float32 [{ny2}, MK, 8, {nxl}] "
                         f"on {g.device}, got {tuple(m.shape)}")
    _check_out(g, row_block, gate, out)
    tile = (row_offset, col_offset, nx_local)
    if g.device.type == "cpu":
        return _twin(gate, INCREMENTAL, out, lambda: rebin_incremental_torch(
            g, m, unit, nx_cells, ny_cells, row_block, *tile))
    if g.device.type != "cuda":
        raise ValueError(f"rebin_incremental: unsupported device {g.device}")
    lib = _build.library()
    out = out if out is not None else new_outputs(g, row_block)
    with torch.cuda.device(g.device):  # a launch goes to the current card
        rc = lib.pedoni_rebin_incremental(
            g.data_ptr(), m.data_ptr(), out[0].data_ptr(), *_ptrs(out, gate),
            INCREMENTAL, ny2, k, m.shape[1], nxl, row_block, unit, nx_cells,
            ny_cells, row_offset, col_offset,
            _lane_hi(nx_cells, col_offset, nx_local),
            *rebin_launch(k, m.shape[1], ny2, nxl, row_block),
            torch.cuda.current_stream(g.device).cuda_stream)
    _build.check_launch(rc, "pedoni_rebin_incremental")
    rebin_incremental.launches += 1
    return out


rebin_incremental.launches = 0


def _landing(src: torch.Tensor, unit: float, ny_cells: int, row_f: torch.Tensor,
             col_offset: int, lane_hi: int) -> tuple[torch.Tensor, torch.Tensor]:
    """rebin.cu's landing test for candidates ``src`` [ny, C >= 7, NXL] of
    a row band whose global cell rows are ``row_f``: (lands in its row and
    in the tile's own lanes [1, lane_hi] of the field, global target
    lane)."""
    tgt_lane = torch.floor(true_divide(src[:, 0], unit)) + 1.0
    tgt_row = torch.floor(true_divide(src[:, 1], unit))
    lands = ((src[:, 6] > 0.5) & (tgt_row == row_f)
             & (tgt_row <= ny_cells - 1)
             & (tgt_lane >= col_offset + 1.0)
             & (tgt_lane <= lane_hi + col_offset))
    return lands, tgt_lane


def _lands_at(landing: tuple[torch.Tensor, torch.Tensor], lane_f: torch.Tensor,
              dxo: int) -> torch.Tensor:
    """Whether the candidate seen at lane l from lane l + dxo (no wrap)
    lands in the output cell at lane l."""
    lands_src, tgt_lane = landing
    lands = torch.roll(lands_src & (tgt_lane == lane_f - dxo), shifts=-dxo,
                       dims=-1)
    if dxo == -1:
        lands[:, 0] = False
    elif dxo == 1:
        lands[:, -1] = False
    return lands


def _rows_lanes(ny: int, nxl: int, dev, row_offset: int, col_offset: int
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Global cell rows [ny, 1] and global lanes [1, NXL] of a tile's centre
    rows (f32), and its local lanes [1, NXL]."""
    lane = torch.arange(nxl, device=dev).view(1, nxl)
    row_f = (torch.arange(ny, device=dev) + row_offset).float().view(ny, 1)
    return row_f, (lane + col_offset).float(), lane


def _slots_in_use(t: torch.Tensor) -> int:
    """The top slot + 1 that holds an active row anywhere in ``t`` [ny2,
    slots, 8, NXL]: the twins walk no further (a slot above it has no
    candidate).  Reads the device: the twins' business, not the kernels'."""
    occ = torch.nonzero((t[:, :, 6] > 0.5).any(dim=2).any(dim=0))
    return int(occ.max()) + 1 if occ.numel() else 0


def rebin_torch(g: torch.Tensor, unit: float, nx_cells: int, ny_cells: int,
                row_block: int = 2, row_offset: int = 0, col_offset: int = 0,
                nx_local: int | None = None) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch twin of the rebin kernel (same contract)."""
    ny2, k, _, nxl = g.shape
    ny = ny2 - 2
    dev = g.device
    lane_hi = _lane_hi(nx_cells, col_offset, nx_local)
    row_f, lane_f, lane = _rows_lanes(ny, nxl, dev, row_offset, col_offset)
    slot = torch.arange(k, device=dev).view(1, k, 1, 1)
    cnt = torch.zeros((ny, nxl), dtype=torch.int64, device=dev)
    outs = torch.zeros((ny, k, 6, nxl), dtype=torch.float32, device=dev)
    for j in range(_slots_in_use(g)):
        for dy in (-1, 0, 1):
            src = g[1 + dy : 1 + dy + ny, j]  # [ny, 8, NXL]
            landing = _landing(src, unit, ny_cells, row_f, col_offset, lane_hi)
            for dxo in (-1, 0, 1):
                # candidate at lane l comes from lane l + dxo (no wrap)
                sh = _shift_lane(src[:, :6], dxo)
                lands = _lands_at(landing, lane_f, dxo)
                put = lands[:, None, None, :] & (slot == cnt[:, None, None, :])
                outs = torch.where(put, sh[:, None], outs)
                cnt = cnt + lands
    kept = torch.clamp(cnt, max=k)
    out = torch.zeros_like(g)
    out[1:-1, :, :6] = outs
    out[1:-1, :, 6] = (slot[..., 0] < cnt[:, None, :]).float()
    out[1:-1, :, 7] = kept[:, None, :].float()

    nb = ny // row_block
    per_row = lambda x: x.float().view(nb, row_block, -1)  # noqa: E731
    own = ((lane >= 1) & (lane <= lane_hi)).float()
    act_in = g[1:-1, :, 6].sum(dim=1) * own  # [ny, NXL]
    return (out,
            per_row(torch.clamp(cnt - k, min=0)).sum(dim=(1, 2)),
            per_row(cnt).amax(dim=(1, 2)),
            per_row(act_in).sum(dim=(1, 2)),
            per_row(kept).sum(dim=(1, 2)))


def rebin_incremental_torch(g: torch.Tensor, m: torch.Tensor, unit: float,
                            nx_cells: int, ny_cells: int, row_block: int = 2,
                            row_offset: int = 0, col_offset: int = 0,
                            nx_local: int | None = None
                            ) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch twin of the incremental rebin kernel (same contract),
    the reference's _compute_inc (rebin.py:323-430): stayers are kept in
    the tile's own lanes only (ghost lanes hold the neighbour's edge)."""
    ny2, k, _, nxl = g.shape
    ny = ny2 - 2
    mk = m.shape[1]
    dev = g.device
    lane_hi = _lane_hi(nx_cells, col_offset, nx_local)
    row_f, lane_f, lane = _rows_lanes(ny, nxl, dev, row_offset, col_offset)
    own = (lane >= 1) & (lane <= lane_hi)  # [1, NXL]
    gc = g[1:-1]
    stay = (gc[:, :, 7] > 0.5) & own[:, None]  # [ny, K, NXL]
    outs = torch.where(stay[:, :, None], gc[:, :, :6], 0.0)
    # exclusive hole rank along the slot axis; stay slots poisoned to -1
    hole = (~stay).long()
    rank = torch.where(stay, -1, torch.cumsum(hole, dim=1) - hole)
    holes = hole.sum(dim=1)  # [ny, NXL]
    landed = torch.zeros((ny, nxl), dtype=torch.int64, device=dev)
    for j in range(_slots_in_use(m)):
        for dy in (-1, 0, 1):
            src = m[1 + dy : 1 + dy + ny, j]  # [ny, 8, NXL]
            landing = _landing(src, unit, ny_cells, row_f, col_offset, lane_hi)
            for dxo in (-1, 0, 1):
                sh = _shift_lane(src[:, :6], dxo)
                lands = _lands_at(landing, lane_f, dxo)
                put = lands[:, None, :] & (rank == landed[:, None, :])
                outs = torch.where(put[:, :, None], sh[:, None], outs)
                landed = landed + lands
    filled = (rank >= 0) & (rank < landed[:, None, :])
    act_out = stay | filled
    slot = torch.arange(1, k + 1, device=dev).view(1, k, 1)
    topcnt = torch.where(act_out, slot, 0).amax(dim=1)  # [ny, NXL]
    out = torch.zeros_like(g)
    out[1:-1, :, :6] = outs
    out[1:-1, :, 6] = act_out.float()
    out[1:-1, :, 7] = topcnt[:, None, :].float()

    nb = ny // row_block
    per_row = lambda x: x.float().view(nb, row_block, -1)  # noqa: E731
    act_in = (gc[:, :, 6] * own[:, None]).sum(dim=1)
    return (out,
            per_row(torch.clamp(landed - holes, min=0)).sum(dim=(1, 2)),
            per_row(k - holes + landed).amax(dim=(1, 2)),
            per_row(act_in).sum(dim=(1, 2)),
            per_row(act_out.sum(dim=1)).sum(dim=(1, 2)))
