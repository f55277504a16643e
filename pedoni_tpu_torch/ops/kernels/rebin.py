"""Full compacting rebin of the post-step grid into fresh cell bins.

Counterpart of pedoni_tpu/ops/pallas/rebin.py::rebin_kernel (pallas_call
at rebin.py:570) with ``emit_counts=True``: every output cell takes the
candidates of its 3x3 neighbourhood that land in it, in (j, dy, dx) order,
at slot = running count; landers beyond K are dropped and counted.
Agents that leave the field vanish (neighbor_grid.rs:29).

``rebin`` is the wrapper: on a CUDA tensor it launches the hand-written
kernel ``csrc/rebin.cu``; on a CPU tensor it runs ``rebin_torch``, the
plain PyTorch twin, bit-exact with tests/test_rebin.py::_numpy_rebin.
"""

from __future__ import annotations

import torch

from ..neighbor import true_divide
from . import _build


def _check(g: torch.Tensor, row_block: int) -> None:
    if g.dtype != torch.float32 or not g.is_contiguous():
        raise ValueError("g must be contiguous float32")
    ny2, _k, ch, nxl = g.shape
    if ch != 8 or nxl % 128 != 0 or (ny2 - 2) % row_block != 0:
        raise ValueError(
            f"g must be [ny_pad+2, K, 8, NXL] with NXL % 128 == 0 and "
            f"ny_pad % {row_block} == 0, got {tuple(g.shape)}")


def rebin(g: torch.Tensor, unit: float, nx_cells: int, ny_cells: int,
          row_block: int = 2) -> tuple[torch.Tensor, ...]:
    """Returns (D' [ny2, K, 8, NXL], overflow, demand_max, active_in,
    active_out), the last four [nb] f32 per block of ``row_block`` rows.

    D' is ghost-carrying (rows 0 and ny2-1 zero); ch 6 = slot < count,
    ch 7 = min(count, K) on every slot.  CUDA tensors run the kernel (or
    raise); CPU tensors the twin."""
    _check(g, row_block)
    if g.device.type == "cpu":
        return rebin_torch(g, unit, nx_cells, ny_cells, row_block)
    if g.device.type != "cuda":
        raise ValueError(f"rebin: unsupported device {g.device}")
    lib = _build.library()
    ny2, k, _, nxl = g.shape
    nb = (ny2 - 2) // row_block
    out = torch.empty_like(g)
    sums = torch.zeros((3, nb), dtype=torch.float32, device=g.device)
    dmx = torch.zeros((nb,), dtype=torch.int32, device=g.device)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    rc = lib.pedoni_rebin_full(
        g.data_ptr(), out.data_ptr(), sums[0].data_ptr(), dmx.data_ptr(),
        sums[1].data_ptr(), sums[2].data_ptr(), ny2, k, nxl, row_block,
        unit, nx_cells, ny_cells, stream)
    _build.check_launch(rc, "pedoni_rebin_full")
    rebin.launches += 1
    return out, sums[0], dmx.float(), sums[1], sums[2]


rebin.launches = 0


def rebin_torch(g: torch.Tensor, unit: float, nx_cells: int, ny_cells: int,
                row_block: int = 2) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch twin of the rebin kernel (same contract)."""
    ny2, k, _, nxl = g.shape
    ny = ny2 - 2
    dev = g.device
    row_f = torch.arange(ny, device=dev, dtype=torch.float32).view(ny, 1)
    lane_f = torch.arange(nxl, device=dev, dtype=torch.float32).view(1, nxl)
    slot = torch.arange(k, device=dev).view(1, k, 1, 1)
    cnt = torch.zeros((ny, nxl), dtype=torch.int64, device=dev)
    outs = torch.zeros((ny, k, 6, nxl), dtype=torch.float32, device=dev)
    for j in range(k):
        for dy in (-1, 0, 1):
            src = g[1 + dy : 1 + dy + ny, j]  # [ny, 8, NXL]
            tgt_lane = torch.floor(true_divide(src[:, 0], unit)) + 1.0
            tgt_row = torch.floor(true_divide(src[:, 1], unit))
            lands_src = ((src[:, 6] > 0.5) & (tgt_row == row_f)
                         & (tgt_row <= ny_cells - 1)
                         & (tgt_lane >= 1.0) & (tgt_lane <= nx_cells))
            for dxo in (-1, 0, 1):
                # candidate at lane l comes from lane l + dxo (no wrap)
                sh = torch.roll(src[:, :6], shifts=-dxo, dims=-1)
                lands = (torch.roll(lands_src & (tgt_lane == lane_f - dxo),
                                    shifts=-dxo, dims=-1))
                if dxo == -1:
                    lands[:, 0] = False
                elif dxo == 1:
                    lands[:, nxl - 1] = False
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
    own = torch.zeros((1, nxl), dtype=torch.float32, device=dev)
    own[0, 1 : nx_cells + 1] = 1.0
    act_in = g[1:-1, :, 6].sum(dim=1) * own  # [ny, NXL]
    return (out,
            per_row(torch.clamp(cnt - k, min=0)).sum(dim=(1, 2)),
            per_row(cnt).amax(dim=(1, 2)),
            per_row(act_in).sum(dim=(1, 2)),
            per_row(kept).sum(dim=(1, 2)))
