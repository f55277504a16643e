"""The flat step after its cell sort, up to the pair pass, as one kernel
(``csrc/flat_scatter.cu``).

``flat_scatter`` computes ``flat_scatter_torch``: from the packed [N, 12]
rows and cell ids of ``flat_sample`` and the first C entries of their
stable argsort, the sorted rows, their cell ids, dest, active flag and
speed (a contiguous copy, which the next step's sample reads without the
rows' 48-byte stride), the active count, the cell layout
(``forcepass.build_layout``: each row's slot, valid flag and the overflow
count) and the padded cell grid [ny+2, nx+2, K, 8]
(``forcepass.scatter_cell_data``).  On a CUDA tensor it
launches the kernel or raises; on a CPU tensor it runs the twin.  Every
output is a copy or an integer, so the two agree bit for bit.

The kernel takes the sorted order as it is: ``cid[order]`` must ascend (a
stable argsort's order, or its first C entries), where the twin ranks any
order by each cell's first index.

The reference has no pallas_call here: XLA fuses its row gather,
``build_layout`` and ``scatter_cell_data`` (pedoni_tpu/models/sfm.py:
373-386, pedoni_tpu/ops/forcepass.py:50, 77).  The flat step and every
x-strip step call it once a step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import forcepass
from ..forcepass import CellLayout
from ..neighbor import CellGrid
from . import _build


class Scattered(NamedTuple):
    rows: torch.Tensor  # [C, 12] f32, packed[order]
    cid: torch.Tensor  # [C] i32, cid[order]
    dest: torch.Tensor  # [C] i32, rows[:, 5] as int
    active: torch.Tensor  # [C] bool, rows[:, 6] > 0.5
    n_active: torch.Tensor  # 0-d i32
    layout: CellLayout | None  # with ``cells``
    data: torch.Tensor | None  # [ny+2, nx+2, K, 8], with ``cells`` and no strides
    speed: torch.Tensor  # [C] f32, rows[:, 4] contiguous


def flat_scatter_torch(packed: torch.Tensor, cid: torch.Tensor,
                       order: torch.Tensor, grid: CellGrid, k: int,
                       cells: bool = True,
                       strides: tuple[int, int, int] | None = None,
                       size: int | None = None) -> Scattered:
    """The kernel's twin: the flat step's code after its sort as it was
    composed before the kernel.  Without ``cells`` no layout and no grid;
    with ``strides`` (and ``size``) the layout in that grid and no data."""
    sp = packed.index_select(0, order)
    cid_sorted = cid.index_select(0, order)
    dest = sp[:, 5].to(torch.int32)
    active = sp[:, 6] > 0.5
    n_active = active.sum().to(torch.int32)
    layout = data = None
    if cells:
        layout = forcepass.build_layout(cid_sorted, active, grid, k, strides, size)
        if strides is None:
            data = forcepass.scatter_cell_data(layout, grid, k, sp[:, 0:2],
                                               sp[:, 2:4], sp[:, 7:9])
    return Scattered(sp, cid_sorted, dest, active, n_active, layout, data,
                     sp[:, 4].contiguous())


def _check(packed: torch.Tensor, cid: torch.Tensor, order: torch.Tensor,
           grid: CellGrid, k: int, strides, size) -> None:
    if (packed.dtype != torch.float32 or not packed.is_contiguous()
            or packed.dim() != 2 or packed.shape[1] != 12):
        raise ValueError("flat_scatter: packed must be a contiguous float32 "
                         f"[N, 12] tensor, got {packed.dtype} {tuple(packed.shape)}")
    n = packed.shape[0]
    for name, t, dtype in (("cid", cid, torch.int32), ("order", order, torch.int64)):
        if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous() \
                or t.device != packed.device:
            raise ValueError(f"flat_scatter: {name} must be a contiguous {dtype} "
                             f"[*] tensor on {packed.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if cid.shape[0] != n or order.shape[0] > n:
        raise ValueError(f"flat_scatter: {n} rows, {cid.shape[0]} cell ids and "
                         f"{order.shape[0]} sorted indices")
    if not 1 <= k <= 255 or grid.nx < 1 or grid.ny < 1:
        raise ValueError(f"flat_scatter: unsupported K {k} or grid {grid}")
    if (strides is None) != (size is None):
        raise ValueError("flat_scatter: strides and size go together")
    if n >= 2 ** 31 - 256:
        raise ValueError(f"flat_scatter: {n} rows, at most 2^31 - 257")


def flat_scatter(packed: torch.Tensor, cid: torch.Tensor, order: torch.Tensor,
                 grid: CellGrid, k: int, cells: bool = True,
                 strides: tuple[int, int, int] | None = None,
                 size: int | None = None) -> Scattered:
    """See ``flat_scatter_torch`` and the module's docstring: the kernel on
    a CUDA tensor, the twin on a CPU one."""
    _check(packed, cid, order, grid, k, strides, size)
    if packed.device.type == "cpu":
        return flat_scatter_torch(packed, cid, order, grid, k, cells, strides, size)
    if packed.device.type != "cuda":
        raise ValueError(f"flat_scatter: unsupported device {packed.device}")
    if packed.data_ptr() % 16:
        raise ValueError("flat_scatter: packed must be 16-byte aligned")
    dev = packed.device
    c = order.shape[0]
    rows = torch.empty((c, 12), dtype=torch.float32, device=dev)
    cid_s = torch.empty((c,), dtype=torch.int32, device=dev)
    dest = torch.empty((c,), dtype=torch.int32, device=dev)
    speed = torch.empty((c,), dtype=torch.float32, device=dev)
    counts = torch.empty((2,), dtype=torch.int32, device=dev)  # zeroed by the launcher
    active = torch.empty((c,), dtype=torch.bool, device=dev)
    layout = data = slot = valid = None
    mode = 0
    if cells:
        mode = 1
        if strides is None:
            mode = 2
            strides = ((grid.nx + 2) * k, k, 1)
            size = (grid.ny + 2) * (grid.nx + 2) * k
            data = torch.empty((grid.ny + 2, grid.nx + 2, k, 8),
                               dtype=torch.float32, device=dev)
        slot = torch.empty((c,), dtype=torch.int64, device=dev)
        valid = torch.empty((c,), dtype=torch.bool, device=dev)
        layout = CellLayout(slot=slot, valid=valid, n_overflow=counts[0])
    lay = torch.tensor([*(strides or (0, 0, 0)), size or 0], dtype=torch.int64)
    lib = _build.library()

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    with torch.cuda.device(dev):  # a launch goes to the current card
        rc = lib.pedoni_flat_scatter(
            packed.data_ptr(), cid.data_ptr(), order.data_ptr(), rows.data_ptr(),
            cid_s.data_ptr(), dest.data_ptr(), speed.data_ptr(),
            active.data_ptr(), ptr(slot), ptr(valid), counts.data_ptr(), ptr(data), c, grid.nx, grid.ny, k, mode,
            lay.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(rc, "pedoni_flat_scatter")
    flat_scatter.launches += 1
    return Scattered(rows, cid_s, dest, active, counts[1], layout, data, speed)


flat_scatter.launches = 0
