"""The flat step's pair pass as one kernel (``csrc/flat_pairwise.cu``).

``flat_pairwise`` computes ``forcepass.dense_pairwise``: the pair
acceleration of every slot of the padded cell grid [ny+2, nx+2, K, 8]
that ``forcepass.scatter_cell_data`` builds, as the flat
[(ny+2)*(nx+2)*K, 2] tensor with a zero ring.  Every slot of an interior
cell gets its acceleration, active or not; a candidate counts by its ch 6
alone.  On a CUDA tensor it launches the kernel or raises; on a CPU tensor
it runs ``forcepass.dense_pairwise_torch``, the twin, which sums each
slot's candidates in the kernel's order, so that the two agree bit for
bit on the card.

The kernel's block is a tile of cells with its one-cell halo in shared
memory; the kernel's launcher picks the tile from K (``tile_shape`` asks
it which), so that several blocks share an SM.  Its warps share the pair
work of 32 slots at a time; ``flat_pairwise_occupancy`` reads how busy
their lanes are.

The reference has no pallas_call here: XLA fuses its ``lax.map`` over row
blocks (pedoni_tpu/ops/forcepass.py:141).  The flat step and the x-strips
call it through ``forcepass.dense_pairwise``, once a step (a strip-step).
"""

from __future__ import annotations

import ctypes

import torch

from ...physics import Physics
from ..forces import EPS
from ..neighbor import CellGrid
from . import _build


def tile_shape(k: int) -> tuple[int, int, int, int]:
    """(tile rows, tile columns, threads, shared memory bytes) of the
    kernel's launch at K, as csrc/flat_pairwise.cu picks it; builds the
    kernels' library, so it needs nvcc."""
    shape = (ctypes.c_int * 4)()
    if _build.library().pedoni_flat_pairwise_tile(k, shape) != 0:
        raise ValueError(f"flat_pairwise: unsupported K {k} (1 <= K <= 255)")
    return tuple(shape)


def flat_constants(phys: Physics) -> list[float]:
    """csrc/flat_pairwise.cu FlatConsts, in order; each rounded to f32 once,
    as the twin's Python scalars are when they meet an f32 tensor."""
    return [phys.cutoff_sq, phys.delta_time, EPS, phys.ped_strength,
            phys.ped_range, phys.cos_phi, phys.fov_damping]


def _check(data: torch.Tensor) -> None:
    if (data.dtype != torch.float32 or not data.is_contiguous()
            or data.dim() != 4 or data.shape[3] != 8):
        raise ValueError("data must be a contiguous float32 [ny+2, nx+2, K, 8] "
                         f"tensor, got {data.dtype} {tuple(data.shape)}")
    ny2, nx2, k, _ = data.shape
    if ny2 < 3 or nx2 < 3 or not 1 <= k <= 255:
        raise ValueError(f"flat_pairwise: unsupported grid {tuple(data.shape)} "
                         "(ny, nx >= 1, 1 <= K <= 255)")


def _launch_args(data: torch.Tensor, phys: Physics):
    """(library, acc, constants) of a launch on ``data``, a CUDA tensor."""
    if data.device.type != "cuda":
        raise ValueError(f"flat_pairwise: unsupported device {data.device}")
    if data.data_ptr() % 16:
        raise ValueError("flat_pairwise: data must be 16-byte aligned")
    ny2, nx2, k, _ = data.shape
    acc = torch.empty((ny2 * nx2 * k, 2), dtype=torch.float32, device=data.device)
    consts = torch.tensor(flat_constants(phys), dtype=torch.float32)
    return _build.library(), acc, consts


def flat_pairwise(data: torch.Tensor, phys: Physics) -> torch.Tensor:
    """Pair accelerations of every slot of ``data`` (see the module's
    docstring): the kernel on a CUDA tensor, the twin on a CPU one."""
    _check(data)
    ny2, nx2, k, _ = data.shape
    if data.device.type == "cpu":
        from ..forcepass import dense_pairwise_torch
        return dense_pairwise_torch(data, CellGrid(1.0, nx2 - 2, ny2 - 2), k, phys)
    lib, acc, consts = _launch_args(data, phys)
    with torch.cuda.device(data.device):  # a launch goes to the current card
        rc = lib.pedoni_flat_pairwise(
            data.data_ptr(), acc.data_ptr(), ny2, nx2, k, consts.data_ptr(),
            torch.cuda.current_stream(data.device).cuda_stream)
    _build.check_launch(rc, "pedoni_flat_pairwise")
    flat_pairwise.launches += 1
    return acc


flat_pairwise.launches = 0


def flat_pairwise_occupancy(data: torch.Tensor, phys: Physics) -> dict:
    """How busy the kernel's lanes are on ``data`` (a CUDA tensor): one
    launch of its counting build (not counted in ``flat_pairwise.launches``)
    reads the pairs evaluated, the lanes issued in force-body batches, the
    distance tests made and the lanes issued in walk rounds; the
    occupancies are pairs over body lanes and tests over walk lanes."""
    _check(data)
    ny2, nx2, k, _ = data.shape
    lib, acc, consts = _launch_args(data, phys)
    counts = torch.zeros(4, dtype=torch.int64, device=data.device)
    with torch.cuda.device(data.device):
        rc = lib.pedoni_flat_pairwise_occupancy(
            data.data_ptr(), acc.data_ptr(), ny2, nx2, k, consts.data_ptr(),
            counts.data_ptr(), torch.cuda.current_stream(data.device).cuda_stream)
    _build.check_launch(rc, "pedoni_flat_pairwise_occupancy")
    pairs, body, tests, walk = counts.tolist()
    return {"pairs": pairs, "body_lanes": body, "tests": tests, "walk_lanes": walk,
            "body_occupancy": pairs / body if body else None,
            "walk_occupancy": tests / walk if walk else None}
