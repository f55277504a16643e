"""Fused step: field sampling, despawn, all forces and integration.

Counterpart of pedoni_tpu/ops/pallas/step_kernel.py::fused_step_kernel
(pallas_call at step_kernel.py:898) in its base mode, its
``emit_movers`` mode and its ``segments`` mode: each agent samples its own
destination plane ``fwp[dest]`` (any waypoint count; this replaces the
reference's waypoint slot walk); obstacles come from the distance map, or
with ``segments`` from the exact geometry of each obstacle rectangle (the
reference's --no-distance-map mode).  Channel 7 of the output is the
sampled potential, or in the mover mode the stay mask, with the per-cell
mover table M that feeds ``rebin.rebin_incremental``.

``fused_step`` is the wrapper: on a CUDA tensor it launches the
hand-written kernel ``csrc/step_kernel.cu`` (a sample pass over a
texel-major copy of the fields, then a pair pass over tiles of cells in
shared memory, which in segments mode also walks the edge-table rows
near each tile; see its header); on a CPU tensor it runs
``fused_step_torch``, the plain PyTorch twin that mirrors the reference
algorithm — vectorised over the grid, lane shifts by ``torch.roll``,
candidate slots walked j outer, then dy, then dx.

The kernel's own inputs are made here, in Python the CPU tests reach:
``pack_fields`` (the texel-major copy, made once per pair of field
tensors by ``packed_fields``) and ``pair_pass_launch`` (the pair pass's
tile, block and shared-memory size for a grid shape).

Layouts are the reference's: d [ny2, K, 8, NXL], fwp [n_wp, R, S, 4, NXL],
fobs [R, S, 4, NXL]; the output is [ny2, K, 8, NXL], ghost rows zero;
M is [ny2, MK, 8, NXL].
"""

from __future__ import annotations

import math
import weakref

import torch

from ...physics import Physics
from ..neighbor import true_divide
from . import _build
from .pairwise import EPS, _shift_lane, pair_accum
from .tiles import TILE_LANES, tile_launch

BIG = 2.0 ** 30  # non-finite sanitize sentinel (step_kernel.py:394-398)
ROW0 = 3  # fields6.ROW0: first patch row/col of cell 0 in the padded map
FPAD = 4.0  # field-map PAD rings
SEG_COLS = 22  # columns of the obstacle edge table (segment_table)
SEG_CAP = 64  # segments: kept edge-table rows a pair-pass block stages at once
SEG_TERM_CAP = 1024  # segments: (agent, row) terms a block holds at once
SEG_CULL_RANGES = 110  # cull distance in obs_range: exp(-110) is 0 in f32
SEG_SAMPLE_WALK = 8  # segments: a table this short is walked by the sample pass
SEG_CULL_SLACK = 2.0 ** -12  # of the coordinates' size: their f32 rounding
WALK_LEVELS = 7  # slot levels of the pair walk's 63-bit word (csrc kChunk)
# blocks of the pair pass an SM's 65,536 registers hold: step_pairs takes 40
# a thread (ptxas; chip_smoke.py prints it), step_pairs_segments is bound to
# them (csrc/step_kernel.cu)
PAIR_BLOCKS_SM = 3


def _constants(phys: Physics, grid_size: tuple[float, float],
               field_unit: float, stride: int) -> list[float]:
    """The kernel's scalar constants, in csrc/step_kernel.cu StepConsts
    order; each is rounded to f32 when it reaches the kernel, as the twin's
    Python scalars are when they meet an f32 tensor."""
    return [
        1.0 / field_unit, grid_size[0], grid_size[1], phys.despawn_potential,
        phys.relaxation_time, phys.obs_strength, phys.obs_range,
        phys.delta_time, phys.delta_time * 0.5, phys.max_speed_factor,
        phys.cutoff_sq, phys.delta_time, phys.delta_time * phys.delta_time,
        0.5 * phys.ped_strength, -0.5 / phys.ped_range,
        phys.cos_phi * phys.cos_phi, phys.fov_damping,
        _cell_unit(stride, field_unit), segment_cull(phys, grid_size),
    ]


def segment_cull(phys: Physics, grid_size: tuple[float, float]) -> float:
    """Segments mode: the distance past which the pair pass drops an
    edge-table row for a tile (csrc/step_kernel.cu explains why that
    changes no bit): SEG_CULL_RANGES obstacle ranges, where
    exp(-d / obs_range) is 0 in f32, plus room for the f32 rounding of
    coordinates up to the grid's size."""
    reach = SEG_CULL_RANGES * phys.obs_range
    return reach + SEG_CULL_SLACK * (grid_size[0] + grid_size[1] + reach)


def _cell_unit(stride: int, field_unit: float) -> float:
    """The mover mode's cell size (step_kernel.py:854)."""
    return stride * field_unit


def segment_table(obstacles, device: torch.device | str = "cuda"
                  ) -> torch.Tensor:
    """The obstacle edge table of the segment mode: [n_obs, SEG_COLS] f32.

    ``obstacles``: (x0, y0, x1, y1, width) per obstacle, world metres.  Row
    o holds, for each of the 4 edges of the width-widened rectangle in the
    reference's order (step_kernel.py:130-132: across the two endpoints,
    then the two long sides), q0.x, q0.y, s.x, s.y and il2 = 1 / |s|^2 at
    columns 5e .. 5e+4, then width^2 and h^2 (h = the segment's length).
    Every constant is computed in Python float64 exactly as
    step_kernel.py:120-137 computes it and rounded to f32 once, as the
    reference's Python floats are where they meet an f32 array; corners or
    il2 recomputed in f32 would give other bits."""
    rows = []
    for x0, y0, x1, y1, width in obstacles:
        x0, y0, x1, y1, width = map(float, (x0, y0, x1, y1, width))
        dx_ = x1 - x0
        dy_ = y1 - y0
        h = max((dx_ * dx_ + dy_ * dy_) ** 0.5, 1e-6)
        nx_ = dy_ / h * (width * 0.5)
        ny_ = -dx_ / h * (width * 0.5)
        p0p = (x0 + nx_, y0 + ny_)
        p0m = (x0 - nx_, y0 - ny_)
        p1p = (x1 + nx_, y1 + ny_)
        p1m = (x1 - nx_, y1 - ny_)
        row = []
        for q0, q1 in ((p0p, p0m), (p1p, p1m), (p0p, p1p), (p0m, p1m)):
            sx = q1[0] - q0[0]
            sy = q1[1] - q0[1]
            row += [q0[0], q0[1], sx, sy, 1.0 / max(sx * sx + sy * sy, 1e-12)]
        rows.append(row + [width * width, h * h])
    return torch.tensor(rows, dtype=torch.float32,
                        device=device).reshape(len(rows), SEG_COLS)


def _check(d: torch.Tensor, fwp: torch.Tensor, fobs: torch.Tensor,
           segments: torch.Tensor | None, stride: int, emit_movers: int,
           row_block: int) -> None:
    if segments is not None and (segments.dim() != 2
                                 or segments.shape[1] != SEG_COLS):
        raise ValueError(f"segments must be [n_obs, {SEG_COLS}] (segment_table), "
                         f"got {tuple(segments.shape)}")
    for name, t in (("d", d), ("fwp", fwp), ("fobs", fobs),
                    ("segments", segments)):
        if t is None:
            continue
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
        if t.device != d.device:
            raise ValueError(f"{name} is on {t.device}, d on {d.device}")
    ny2, k, ch, nxl = d.shape
    if ch != 8 or nxl % 128 != 0:
        raise ValueError(f"d must be [ny2, K, 8, NXL % 128 == 0], got {tuple(d.shape)}")
    if fwp.dim() != 5 or tuple(fwp.shape[2:]) != (stride, 4, nxl):
        raise ValueError(f"fwp must be [n_wp, R, {stride}, 4, {nxl}], got {tuple(fwp.shape)}")
    if tuple(fobs.shape) != tuple(fwp.shape[1:]):
        raise ValueError(f"fobs must be {tuple(fwp.shape[1:])}, got {tuple(fobs.shape)}")
    need = stride * (ny2 + 1) + ROW0 + 2
    if fwp.shape[1] < need:
        raise ValueError(f"field planes have {fwp.shape[1]} rows, need {need}")
    if emit_movers < 0 or (emit_movers and (ny2 - 2) % row_block != 0):
        raise ValueError(f"emit_movers={emit_movers} needs ny_pad % "
                         f"row_block == 0, got ny2={ny2}, row_block={row_block}")


def pair_pass_smem_bytes(k: int, tile_rows: int, segments: bool = False,
                         levels: int | None = None) -> int:
    """Shared memory of the pair pass for a tile of ``tile_rows`` rows x
    TILE_LANES cells at K = ``k`` slots (csrc/step_kernel.cu
    pairs_smem_bytes, chunked_smem_bytes and segment_smem_bytes, the same
    sums): row bitmasks, act' and the new pos/vel of the tile, per-row
    counters, the agent list, and the staged pos/vel of the tile and its
    halo: all K slot levels, or with ``levels`` < K that many at a time (the
    tile's own positions and sums then wait in the new pos/vel's room).  In
    segments mode also SEG_CAP staged edge-table rows, SEG_TERM_CAP (x, y)
    terms, the per-warp box and counts (32 warps) and a resume index; where
    the levels are chunked, these share the staging room."""
    h, halo = tile_rows + 2, TILE_LANES + 2
    n_tile = tile_rows * k * TILE_LANES
    need = 8 * h * k + 20 * n_tile + 4 * h + 4 * (tile_rows + 1) + 2 * n_tile
    seg = (4 * SEG_COLS * SEG_CAP + 8 * SEG_TERM_CAP + 16 * 32 + 16
           if segments else 0)
    if levels is None or levels >= k:
        return need + 16 * h * k * halo + seg
    return need + max(16 * h * levels * halo, seg)


def pair_pass_launch(k: int, ny2: int, nxl: int, segments: bool = False
                     ) -> tuple[int, int, int, int]:
    """(tile rows, threads per block, shared-memory bytes, staged levels) of
    the pair pass on a grid [ny2, K, 8, NXL]; ``segments``: the pass walks
    an edge table (segments mode where ``segment_pass`` says so).

    A block owns ``tile_rows`` x TILE_LANES cells; blocks tile lanes
    [0, NXL) and the centre rows 1 .. ny2-2 (the last tile may be ragged).
    The tile comes from ``tiles.tile_launch``: the one that lets the most
    blocks reside on an SM, up to the PAIR_BLOCKS_SM its registers allow,
    two rows at a tie.  Two rows stage less halo a row (the 1M bench grid
    at K 14, three blocks either way: 0.303 ms against 0.404); past K 21
    only one-row tiles leave room for a third block, and the jams of
    scenarios/funnel.toml and random.toml at K 24 ran 0.055 and 0.066 ms
    in them against 0.074 and 0.079 in two-row tiles (PERF.md).
    Blocks of 512 threads: two or three of them give an SM the 32 or 48
    warps that hide the pair loop's latency (at 16 the 1M step measured
    slower, as did taller tiles; PERF.md).  Where a one-row tile's K slot
    levels do not fit a block (K above 98; above 92 in segments mode),
    one-row tiles stage them in chunks of a multiple of the walk's 7
    levels, which keeps the summation order."""
    if nxl % TILE_LANES != 0 or ny2 < 3 or not 1 <= k <= 255:
        raise ValueError(f"pair pass: unsupported grid ny2={ny2}, K={k}, NXL={nxl}")
    return tile_launch(
        lambda rows, levels: pair_pass_smem_bytes(k, rows, segments, levels),
        ny2, k, WALK_LEVELS, f"pair pass: K={k}", PAIR_BLOCKS_SM)


def segment_pass(n_seg: int) -> bool:
    """Segments mode: whether the pair pass (culling the table for each
    tile) walks an edge table of ``n_seg`` rows, not the sample pass (every
    row for each live agent).  Timed on the card from 1 to 1000 rows on a
    1M-agent, a 4873-agent and a 1641-agent state (``ab_step.py
    --crossover``; PERF.md), the two met between 8 and 16 rows on each: at
    SEG_SAMPLE_WALK rows the walk was within 0.001 ms of the pass or
    faster, from 16 rows the pass was faster, whatever the number of
    agents."""
    return n_seg > SEG_SAMPLE_WALK


def pack_fields(fwp: torch.Tensor, fobs: torch.Tensor) -> torch.Tensor:
    """The kernel's texel-major copy of the fields6 planes:
    [max(n_wp, 1), R, NXL * S, 8].  Texel (f, l * S + c) of plane p holds
    fwp[p, f, c, 0..3, l], then fobs[f, c, 0..3, l]: the channels of a tap
    are two 16-byte loads from one 32-byte sector whichever fields it
    needs, and a tap's x-neighbour is the next texel (the next lane's
    column 0 after column S-1).  Same bits as fwp / fobs; the obstacle map
    is repeated in every waypoint's plane (without waypoints, one plane of
    zeros carries it).  Memory: 2 * max(n_wp, 1) planes of fields6's size,
    written in place: no second copy of that size is made on the way."""
    r, s, _, nxl = fobs.shape
    p = max(fwp.shape[0], 1)
    packed = torch.empty((p, r, nxl, s, 8), dtype=fobs.dtype, device=fobs.device)
    packed[..., :4] = fwp.permute(0, 1, 4, 2, 3) if fwp.shape[0] else 0.0
    packed[..., 4:] = fobs.permute(0, 3, 1, 2)
    return packed.view(p, r, nxl * s, 8)


_packed: dict[tuple[int, int], tuple] = {}


def packed_fields(fwp: torch.Tensor, fobs: torch.Tensor) -> torch.Tensor:
    """``pack_fields(fwp, fobs)``, made once per pair of field tensors and
    kept until either is freed or written in place — never per step."""
    key = (id(fwp), id(fobs))
    version = (fwp._version, fobs._version)
    hit = _packed.get(key)
    if hit is not None and hit[0]() is fwp and hit[1]() is fobs and hit[2] == version:
        return hit[3]
    packed = pack_fields(fwp, fobs)
    _packed[key] = (weakref.ref(fwp), weakref.ref(fobs), version, packed)
    for t in (fwp, fobs):
        weakref.finalize(t, _packed.pop, key, None)
    return packed


def step_scratch(d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's scratch for the grid ``d`` [ny2, K, 8, NXL]: act' of
    every slot [ny2, K, NXL], and e and acc of the live centre slots
    [ny2, K, NXL, 4] (``sfm_grid.device_bytes`` counts them)."""
    ny2, k, _, nxl = d.shape
    return (torch.empty((ny2, k, nxl), dtype=torch.float32, device=d.device),
            torch.empty((ny2, k, nxl, 4), dtype=torch.float32, device=d.device))


def fused_step(d: torch.Tensor, fwp: torch.Tensor, fobs: torch.Tensor,
               phys: Physics, grid_size: tuple[float, float], stride: int = 6,
               field_unit: float = 0.25, emit_movers: int = 0,
               row_block: int = 2, segments: torch.Tensor | None = None,
               row_offset: int = 0, col_offset: int = 0,
               nx_local: int | None = None):
    """One fused step over the grid: returns G [ny2, K, 8, NXL], or with
    ``emit_movers`` = MK > 0 the tuple (G, M, movf, mdmx).

    ``d`` may be one tile of a larger grid (parallel/tile2d.py): lane l
    holds global cell column ``col_offset + l - 1`` and row r global cell
    row ``row_offset + r - 1``; positions stay global, so the field sample
    and the despawn test run in global coordinates, and fwp / fobs are the
    tile's slabs (sliced in rows and lanes at the same offsets).  With
    ``nx_local`` only lanes [1, nx_local] (the tile's own) emit movers: the
    ghost lanes' outputs come from incomplete windows and are replaced by
    the neighbour's.  The defaults are one whole grid.

    ``segments`` (a ``segment_table`` on d's device) switches the obstacle
    force from the distance map to the exact per-segment geometry; fobs is
    then neither read nor needed beyond its shape.  The kernel walks the
    table in its sample pass, every row for each agent, or in its pair pass,
    which culls it for each tile of cells, as ``segment_pass`` picks for
    the table's length; either gives the same bits.

    Channels out: post-step pos, vel; sanitized speed; dest unchanged;
    post-despawn active; ch 7 = sampled potential (base mode) or the stay
    mask act' * [integrated position still in this cell] (mover mode).
    M [ny2, MK, 8, NXL] holds each cell's movers in slot order, ch 6 =
    row < movers, ch 7 = min(movers, MK); movf / mdmx [nb] f32 are, per
    block of ``row_block`` rows, sum(max(movers - MK, 0)) and the peak
    mover count.  Rows 0 and ny2-1 are zero.  CUDA tensors run the kernel
    (or raise); CPU tensors the twin."""
    _check(d, fwp, fobs, segments, stride, emit_movers, row_block)
    if d.device.type == "cpu":
        return fused_step_torch(d, fwp, fobs, phys, grid_size, stride,
                                field_unit, emit_movers, row_block, segments,
                                row_offset, col_offset, nx_local)
    outs, args, _held = _launch_args(
        d, fwp, fobs, phys, grid_size, stride, field_unit, emit_movers,
        row_block, segments, row_offset, col_offset, nx_local)
    with torch.cuda.device(d.device):  # a launch goes to the current card
        rc = _build.library().pedoni_step_kernel(*args)
    _build.check_launch(rc, "pedoni_step_kernel")
    if segments is not None:
        fused_step.segment_launches += 1
    elif emit_movers:
        fused_step.mover_launches += 1
    else:
        fused_step.launches += 1
    return outs if emit_movers else outs[0]


fused_step.launches = 0  # distance-map base-mode launches
fused_step.mover_launches = 0  # distance-map emit_movers launches
fused_step.segment_launches = 0  # segment-mode launches, either output mode


def _launch_args(d, fwp, fobs, phys, grid_size, stride, field_unit, emit_movers,
                 row_block, segments, row_offset, col_offset, nx_local):
    """(outputs, arguments, held) of a launch of the kernel on ``d``, a CUDA
    tensor: the outputs G, and in the mover mode M, movf, mdmx; the
    arguments of ``pedoni_step_kernel`` that make them, the stream last;
    the scratch and the host array of constants they point to, to be held
    until the launch is queued."""
    if d.device.type != "cuda":
        raise ValueError(f"fused_step: unsupported device {d.device}")
    if segments is not None and not (phys.obs_range > 0
                                     and math.isfinite(phys.obs_strength)):
        raise ValueError("segments mode needs obs_range > 0 and a finite "
                         "obs_strength: the kernel's cull assumes that "
                         "exp(-d / obs_range) vanishes with distance")
    ny2, k, _, nxl = d.shape
    mk = emit_movers
    seg_pass = segments is not None and segment_pass(segments.shape[0])
    tile_rows, threads, smem, levels = pair_pass_launch(k, ny2, nxl, seg_pass)
    movers_lo, movers_hi = (0, nxl - 1) if nx_local is None else (1, nx_local)
    fields = packed_fields(fwp, fobs)
    out = torch.empty_like(d)
    act, ea = step_scratch(d)
    if mk:
        m = torch.empty((ny2, mk, 8, nxl), dtype=torch.float32, device=d.device)
        blocks = torch.zeros((2, (ny2 - 2) // row_block), dtype=torch.float32,
                             device=d.device)
        mover_ptrs = (m.data_ptr(), blocks[0].data_ptr(), blocks[1].data_ptr())
    else:
        mover_ptrs = (None, None, None)
    consts = torch.tensor(_constants(phys, grid_size, field_unit, stride),
                          dtype=torch.float32)  # host array, read at launch
    n_seg = -1 if segments is None else segments.shape[0]  # -1: distance map
    args = (d.data_ptr(), fields.data_ptr(),
            None if segments is None else segments.data_ptr(), act.data_ptr(),
            ea.data_ptr(), out.data_ptr(), *mover_ptrs, ny2, k, nxl,
            fwp.shape[0], fwp.shape[1], stride, mk, row_block, n_seg,
            int(seg_pass), tile_rows, threads, smem, levels, row_offset,
            col_offset, movers_lo, movers_hi, consts.data_ptr(),
            torch.cuda.current_stream(d.device).cuda_stream)
    return (((out, m, blocks[0], blocks[1]) if mk else (out,)), args,
            (act, ea, consts))


def step_pairs_occupancy(d: torch.Tensor, fwp: torch.Tensor, fobs: torch.Tensor,
                         phys: Physics, grid_size: tuple[float, float],
                         stride: int = 6, field_unit: float = 0.25,
                         emit_movers: int = 0, row_block: int = 2,
                         row_offset: int = 0, col_offset: int = 0,
                         nx_local: int | None = None) -> dict:
    """How busy the lanes of the pair pass's step 3 are on ``d`` (a CUDA
    tensor; ``fused_step``'s arguments, the distance-map mode): one launch
    of the kernel with its pair pass's counting build, which
    ``launch_counts()`` does not count, reads the pairs evaluated, the
    lanes of the force body's rounds, the candidates tested (live, below
    their cell's bound, not the agent itself) and the lanes' test slots
    of the walk (9 a lane a slot level its warp walks); the
    occupancies are pairs over body lanes and tests over walk slots.  Where
    the levels are staged in chunks (K above 98) it raises."""
    _check(d, fwp, fobs, None, stride, emit_movers, row_block)
    _outs, args, _held = _launch_args(
        d, fwp, fobs, phys, grid_size, stride, field_unit, emit_movers,
        row_block, None, row_offset, col_offset, nx_local)
    counts = torch.zeros(4, dtype=torch.int64, device=d.device)
    with torch.cuda.device(d.device):
        rc = _build.library().pedoni_step_kernel_occupancy(
            *args[:-1], counts.data_ptr(), args[-1])
    _build.check_launch(rc, "pedoni_step_kernel_occupancy")
    pairs, body, tests, walk = counts.tolist()
    return {"pairs": pairs, "body_lanes": body, "tests": tests, "walk_lanes": walk,
            "body_occupancy": pairs / body if body else None,
            "walk_occupancy": tests / walk if walk else None}


def _sample(planes: torch.Tensor, plane_idx: torch.Tensor | None,
            plane_ok: torch.Tensor | None, px: torch.Tensor, py: torch.Tensor,
            stride: int, channels: int, row_offset: int = 0,
            col_offset: int = 0) -> list[torch.Tensor]:
    """Bilinear sample of fields6 planes for every slot of the grid.

    planes [P, R, S, 4, NXL]; plane_idx/plane_ok [ny2, K, NXL] select each
    slot's plane (None: plane 0 for all).  px/py [ny2, K, NXL] are global
    field coordinates; the grid's row r and lane l are global row
    ``row_offset + r`` and lane ``col_offset + l``, the planes sliced to
    match.  A tap outside the cell's (S+2)^2 patch contributes 0, and the
    taps are summed in the reference's order (qy outer, qx inner)."""
    ny2, k, nxl = px.shape
    dev = px.device
    row = torch.arange(ny2, device=dev, dtype=torch.float32).view(ny2, 1, 1)
    lane = torch.arange(nxl, device=dev, dtype=torch.float32).view(1, 1, nxl)
    bx = torch.floor(px)
    by = torch.floor(py)
    tx = px - bx
    ty = py - by
    p0 = bx - (lane + (col_offset - 1.0)) * stride - ROW0
    q0 = by - (row + (row_offset - 1.0)) * stride - ROW0
    row_i = torch.arange(ny2, device=dev).view(ny2, 1, 1)
    lane_i = torch.arange(nxl, device=dev).view(1, 1, nxl)
    pidx = (torch.zeros_like(row_i) if plane_idx is None else plane_idx)
    out = [torch.zeros_like(px) for _ in range(channels)]
    ext = float(stride + 1)
    for a in (0, 1):
        qy = q0 + a
        wy = ty if a else 1.0 - ty
        for b in (0, 1):
            qx = p0 + b
            ok = (qy >= 0.0) & (qy <= ext) & (qx >= 0.0) & (qx <= ext)
            if plane_ok is not None:
                ok = ok & plane_ok
            w = wy * (tx if b else 1.0 - tx)
            qyi = torch.where(ok, qy, 0.0).long()
            col = torch.where(ok, qx, 0.0).long() + ROW0
            frow = stride * row_i + ROW0 + qyi
            l2 = (lane_i + col // stride) % nxl
            for c in range(channels):
                val = planes[pidx, frow, col % stride, c, l2]
                out[c] = out[c] + torch.where(ok, w * val, 0.0)
    return out


def fused_step_torch(d: torch.Tensor, fwp: torch.Tensor, fobs: torch.Tensor,
                     phys: Physics, grid_size: tuple[float, float],
                     stride: int = 6, field_unit: float = 0.25,
                     emit_movers: int = 0, row_block: int = 2,
                     segments: torch.Tensor | None = None,
                     row_offset: int = 0, col_offset: int = 0,
                     nx_local: int | None = None):
    """Plain PyTorch twin of the fused step kernel (same contract)."""
    ny2, k, _, nxl = d.shape
    n_wp = fwp.shape[0]
    # 1. sanitize pos, vel, speed of every row: NaN, +-inf -> +2^30
    san = [torch.where(torch.abs(d[:, :, c, :]) < BIG, d[:, :, c, :], BIG)
           for c in range(5)]
    posx, posy, velx, vely, speed = san
    dest = d[:, :, 5, :]
    act = d[:, :, 6, :]

    # 2. sample the agent's own destination plane
    px = posx * (1.0 / field_unit) - 0.5 + FPAD
    py = posy * (1.0 / field_unit) - 0.5 + FPAD
    plane_ok = (dest >= 0) & (dest < n_wp) & (dest == torch.floor(dest))
    plane_idx = torch.where(plane_ok, dest, 0.0).long()
    off = dict(row_offset=row_offset, col_offset=col_offset)
    pot, gx, gy = _sample(fwp, plane_idx, plane_ok, px, py, stride, 3, **off)

    # 3. despawn at the goal or off the grid
    in_grid = ((posx >= 0.0) & (posx < grid_size[0])
               & (posy >= 0.0) & (posy < grid_size[1]))
    act_new = torch.where((pot > phys.despawn_potential) & in_grid, act, 0.0)

    # 4-5. goal force; obstacle force from the distance map (subtracted),
    # or from the segment geometry (added, step_kernel.py:553-557)
    c = slice(1, ny2 - 1)
    g_norm = torch.rsqrt(torch.clamp(gx * gx + gy * gy, min=EPS))
    ex = gx * g_norm
    ey = gy * g_norm
    afx = true_divide(ex * speed - velx, phys.relaxation_time)
    afy = true_divide(ey * speed - vely, phys.relaxation_time)
    if segments is None:
        dist, dgx, dgy = _sample(fobs[None], None, None, px, py, stride, 3,
                                 **off)
        d_norm = torch.rsqrt(torch.clamp(dgx * dgx + dgy * dgy, min=EPS))
        mag = phys.obs_strength * torch.exp(true_divide(-dist, phys.obs_range))
        acc = ((afx - mag * dgx * d_norm)[c], (afy - mag * dgy * d_norm)[c])
    else:
        sfx, sfy = _segment_accel(posx[c], posy[c], segments, phys)
        acc = (afx[c] + sfx, afy[c] + sfy)

    # 6. pair force over the 3x3 cells' slots, j outer, then dy, then dx;
    # a candidate slot counts only below its cell's count (ch 7, slot 0)
    center = {"px": posx[c], "py": posy[c], "ex": ex[c], "ey": ey[c]}
    cnt = d[:, 0, 7, :]  # [ny2, NXL]
    slot = torch.arange(k, device=d.device).view(1, k, 1)
    dt = phys.delta_time
    kmax = int(torch.clamp(torch.ceil(cnt.max()), 0, k).item()) if cnt.numel() else 0
    for j in range(kmax):
        for dy in (-1, 0, 1):
            r = slice(1 + dy, ny2 - 1 + dy)
            cvx, cvy = velx[r, j:j + 1], vely[r, j:j + 1]
            row = {
                "px": posx[r, j:j + 1], "py": posy[r, j:j + 1],
                "vxdt": cvx * dt, "vydt": cvy * dt,
                "v2dtt": (cvx * cvx + cvy * cvy) * (dt * dt),
                "act": torch.where(j < cnt[r, None, :], act_new[r, j:j + 1], 0.0),
            }
            for dxo in (-1, 0, 1):
                cand = {n: _shift_lane(a, dxo) for n, a in row.items()}
                if dxo == -1:
                    cand["act"][..., 0] = 0.0  # no cell left of lane 0
                elif dxo == 1:
                    cand["act"][..., nxl - 1] = 0.0  # nor right of the last
                self_slot = (slot == j) if (dy == 0 and dxo == 0) else None
                acc = pair_accum(acc, center, cand, phys, self_slot)

    # 7. trapezoidal integration with the speed clamp, keep-gated
    accx, accy = acc
    vx0, vy0 = velx[c], vely[c]
    nvx = vx0 + accx * dt
    nvy = vy0 + accy * dt
    vmax = speed[c] * phys.max_speed_factor
    vlen = torch.sqrt(torch.clamp(nvx * nvx + nvy * nvy, min=EPS))
    scale = torch.clamp(vmax / vlen, max=1.0)
    nvx = nvx * scale
    nvy = nvy * scale
    keep = act_new[c] > 0.5
    half = dt * 0.5
    npx = torch.where(keep, posx[c] + (nvx + vx0) * half, posx[c])
    npy = torch.where(keep, posy[c] + (nvy + vy0) * half, posy[c])
    nvx = torch.where(keep, nvx, vx0)
    nvy = torch.where(keep, nvy, vy0)

    # 8. output: ch 7 = sampled potential, ghost rows zero
    out = torch.zeros_like(d)
    if not emit_movers:
        out[c] = torch.stack([npx, npy, nvx, nvy, speed[c], dest[c],
                              act_new[c], pot[c]], dim=2)
        return out

    # 8'. mover mode (step_kernel.py:697-749): ch 7 = stay mask; movers of
    # each cell, in slot order, fill the rows of M
    cu = _cell_unit(stride, field_unit)
    lane_i = torch.arange(nxl, device=d.device)
    lane_f = (lane_i + col_offset).float().view(1, 1, nxl)
    row_f = (torch.arange(ny2 - 2, device=d.device)
             + row_offset).float().view(-1, 1, 1)
    same = ((torch.floor(true_divide(npx, cu)) + 1.0 == lane_f)
            & (torch.floor(true_divide(npy, cu)) == row_f)).float()
    act_c = act_new[c]
    out[c] = torch.stack([npx, npy, nvx, nvy, speed[c], dest[c], act_c,
                          act_c * same], dim=2)
    mover = act_c * (1.0 - same) > 0.5
    if nx_local is not None:  # only the tile's own lanes emit movers
        mover = mover & ((lane_i >= 1) & (lane_i <= nx_local)).view(1, 1, nxl)
    return (out, *_movers_torch(out, mover, emit_movers, row_block))


def _segment_accel(posx: torch.Tensor, posy: torch.Tensor,
                   segments: torch.Tensor, phys: Physics
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact per-segment obstacle acceleration (step_kernel.py:104-159)
    from the edge table: the nearest of each rectangle's 4 edges repels
    along (pos - closest point), t clipped to [0, 1]; first minimum by a
    strict < on squared distances; agents inside the rectangle skipped;
    obstacles summed in table order.  Sanitized 2^30 positions stay finite
    (exp underflows to 0)."""
    afx = torch.zeros_like(posx)
    afy = torch.zeros_like(posx)
    for row in segments.tolist():  # the f32 constants, exactly
        d2s, dxs, dys = [], [], []
        for e in range(4):
            q0x, q0y, sx, sy, il2 = row[5 * e:5 * e + 5]
            t = torch.clamp(((posx - q0x) * sx + (posy - q0y) * sy) * il2,
                            0.0, 1.0)
            ddx = posx - (q0x + t * sx)
            ddy = posy - (q0y + t * sy)
            d2s.append(ddx * ddx + ddy * ddy)
            dxs.append(ddx)
            dys.append(ddy)
        w2, h2 = row[20], row[21]
        inside = (d2s[0] < w2) & (d2s[1] < w2) & (d2s[2] < h2) & (d2s[3] < h2)
        best, bdx, bdy = d2s[0], dxs[0], dys[0]
        for e in (1, 2, 3):
            sel = d2s[e] < best
            best = torch.where(sel, d2s[e], best)
            bdx = torch.where(sel, dxs[e], bdx)
            bdy = torch.where(sel, dys[e], bdy)
        dmin = torch.sqrt(torch.clamp(best, min=EPS))
        coef = torch.where(
            inside, 0.0,
            phys.obs_strength * torch.exp(true_divide(-dmin, phys.obs_range))
            / dmin)
        afx = afx + coef * bdx
        afy = afy + coef * bdy
    return afx, afy


def _movers_torch(g: torch.Tensor, mover: torch.Tensor, mk: int,
                  row_block: int) -> tuple[torch.Tensor, ...]:
    """The mover table of G's centre rows: (M, movf, mdmx)."""
    ny2, k, _, nxl = g.shape
    ny = ny2 - 2
    rows = torch.arange(mk, device=g.device).view(1, mk, 1)
    cnt = torch.zeros((ny, 1, nxl), dtype=torch.int64, device=g.device)
    vals = torch.zeros((ny, mk, 6, nxl), dtype=torch.float32, device=g.device)
    for j in range(k):
        mv = mover[:, j : j + 1]  # [ny, 1, NXL]
        put = (mv & (rows == cnt))[:, :, None, :]
        vals = torch.where(put, g[1:-1, j : j + 1, :6], vals)
        cnt = cnt + mv
    m = torch.zeros((ny2, mk, 8, nxl), dtype=torch.float32, device=g.device)
    m[1:-1, :, :6] = vals
    m[1:-1, :, 6] = (rows < cnt).float()
    m[1:-1, :, 7] = torch.clamp(cnt, max=mk).float().expand(-1, mk, -1)
    per_block = cnt.view(ny // row_block, -1).float()
    return (m, torch.clamp(per_block - mk, min=0.0).sum(dim=1),
            per_block.amax(dim=1))
