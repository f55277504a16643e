"""The flat step's field taps, despawn test, cell id and packed rows as one
kernel (``csrc/flat_sample.cu``).

``flat_sample`` computes ``sampling.flat_sample_torch``: for every agent
the bilinear sample of its waypoint plane of the packed field rows, the
goal direction, the despawn test, the cell id on the neighbour grid and
the packed [N, 12] row (optionally with velocity and speed sanitized).  On
a CUDA tensor it launches the kernel or raises; on a CPU tensor it runs
the twin, ``flat_sample_torch``, which the kernel mirrors op by op, so the
two agree bit for bit on the card.

The reference has no pallas_call here: XLA fuses its sample, despawn and
packing (pedoni_tpu/ops/sampling.py:70-97, models/sfm.py:335-373).  The
flat step and every x-strip step call it once a step.
"""

from __future__ import annotations

import numpy as np
import torch

from ...field import PAD
from ..forces import EPS
from ..neighbor import CellGrid
from . import _build


def sample_constants(hp: int, wp: int, unit: float, despawn_potential: float,
                     grid: CellGrid) -> list[float]:
    """csrc/flat_sample.cu SampleConsts, in order; each rounded to f32 once,
    as the twin's Python scalars are when they meet an f32 tensor."""
    return [unit, wp - 1.001, hp - 1.001, float(PAD), despawn_potential,
            grid.unit, EPS]


def _check(rows: torch.Tensor, pos: torch.Tensor, vel: torch.Tensor,
           speed: torch.Tensor, dest: torch.Tensor, active: torch.Tensor) -> None:
    if (rows.dtype != torch.float32 or not rows.is_contiguous()
            or rows.dim() != 2 or rows.shape[1] != 8 or rows.shape[0] < 1):
        raise ValueError("rows must be a contiguous float32 [R, 8] tensor, got "
                         f"{rows.dtype} {tuple(rows.shape)}")
    n = pos.shape[0] if pos.dim() == 2 else -1
    want = {"pos": (pos, torch.float32, (n, 2)), "vel": (vel, torch.float32, (n, 2)),
            "speed": (speed, torch.float32, (n,)), "dest": (dest, torch.int32, (n,)),
            "active": (active, torch.bool, (n,))}
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != rows.device:
            raise ValueError(f"flat_sample: {name} must be {dtype} {shape} on "
                             f"{rows.device}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if n >= 2 ** 31:
        raise ValueError(f"flat_sample: {n} agents, at most 2^31 - 1")


def flat_sample(rows: torch.Tensor, hp: int, wp: int, pos: torch.Tensor,
                vel: torch.Tensor, speed: torch.Tensor, dest: torch.Tensor,
                active: torch.Tensor, unit: float, despawn_potential: float,
                grid: CellGrid, sanitize: bool = True
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(packed [N, 12] f32 rows, cell id [N] i32) of the agents (see
    ``sampling.flat_sample_torch``): the kernel on a CUDA tensor, the twin
    on a CPU one.  The agent tensors may be strided views."""
    _check(rows, pos, vel, speed, dest, active)
    if rows.device.type == "cpu":
        from ..sampling import flat_sample_torch
        return flat_sample_torch(rows, hp, wp, pos, vel, speed, dest, active,
                                 unit, despawn_potential, grid, sanitize)
    if rows.device.type != "cuda":
        raise ValueError(f"flat_sample: unsupported device {rows.device}")
    if rows.data_ptr() % 16:
        raise ValueError("flat_sample: rows must be 16-byte aligned")
    n = pos.shape[0]
    packed = torch.empty((n, 12), dtype=torch.float32, device=rows.device)
    cid = torch.empty((n,), dtype=torch.int32, device=rows.device)
    if n == 0:
        return packed, cid
    lib = _build.library()
    consts = torch.from_numpy(np.array(
        sample_constants(hp, wp, unit, despawn_potential, grid), np.float32))
    strides = torch.tensor([*pos.stride(), *vel.stride(), speed.stride(0),
                            dest.stride(0), active.stride(0)], dtype=torch.int64)
    with torch.cuda.device(rows.device):  # a launch goes to the current card
        rc = lib.pedoni_flat_sample(
            pos.data_ptr(), vel.data_ptr(), speed.data_ptr(), dest.data_ptr(),
            active.data_ptr(), rows.data_ptr(), packed.data_ptr(), cid.data_ptr(),
            n, rows.shape[0], hp, wp, grid.nx, grid.ny, int(sanitize),
            strides.data_ptr(), consts.data_ptr(),
            torch.cuda.current_stream(rows.device).cuda_stream)
    _build.check_launch(rc, "pedoni_flat_sample")
    flat_sample.launches += 1
    return packed, cid


flat_sample.launches = 0
