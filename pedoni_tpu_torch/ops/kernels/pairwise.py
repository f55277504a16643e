"""Pair force: the shared core and the standalone pairwise kernel.

``pair_accum`` is the plain PyTorch twin of ``csrc/pair.cuh``, the
counterpart of pedoni_tpu/ops/pallas/pairwise.py::_pair_accum
(pairwise.py:40-103): the Helbing elliptical repulsion of sfm.rs:129-153
(2 m cutoff, FOV damping, self-exclusion) in the reference's
strength-reduced form.  The CUDA version is the ``pair_accum`` device
function that the fused step kernel (csrc/step_kernel.cu) and the
pairwise kernel (csrc/pairwise.cu) inline.

``pairwise`` is the counterpart of ``pallas_pairwise`` (pallas_call at
pairwise.py:177): pair accelerations over the cell grid alone.  On a CUDA
tensor it launches ``csrc/pairwise.cu`` (tiles of cells in shared memory,
the fused step's pair pass in the reference's candidate order; its tile
from ``pairwise_launch``); on a CPU tensor it runs ``pairwise_torch``, the
twin.  The reference calls it only from its tests; here the tests and
chip_smoke.py drive it.

Both versions take every norm through rsqrt (``torch.rsqrt`` here,
``rsqrtf`` in CUDA, which is what ``torch.rsqrt`` runs on the card).
"""

from __future__ import annotations

import torch

from ...physics import Physics
from . import _build
from .tiles import TILE_LANES, tile_launch

EPS = 1e-12


def _shift_lane(x: torch.Tensor, delta: int) -> torch.Tensor:
    """x[..., l] -> x[..., l + delta], circular like the reference's roll."""
    return x if delta == 0 else torch.roll(x, shifts=-delta, dims=-1)


def pair_constants(phys: Physics) -> list[float]:
    """csrc/pair.cuh PairConsts, in order; each rounded to f32 once, as the
    reference's Python scalars are when they meet an f32 array."""
    return [phys.cutoff_sq, phys.delta_time, phys.delta_time * phys.delta_time,
            0.5 * phys.ped_strength, -0.5 / phys.ped_range,
            phys.cos_phi * phys.cos_phi, phys.fov_damping]


def pair_accum(acc: tuple[torch.Tensor, torch.Tensor],
               center: dict[str, torch.Tensor], cand: dict[str, torch.Tensor],
               phys: Physics, self_slot: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Accumulate the repulsion of one candidate array onto all centres.

    ``center``: "px", "py", "ex", "ey" tensors; ``cand``: "px", "py",
    "act" and either "vx"/"vy" or the pre-multiplied "vxdt", "vydt",
    "v2dtt" (vx*dt, vy*dt, (vx^2+vy^2)*dt^2), all broadcastable against
    the centres.  ``self_slot``: optional bool mask of centre slots equal
    to the candidate (excluded).  Same operations, in the same order, as
    the reference's ``_pair_accum``.
    """
    dt = phys.delta_time
    dx = center["px"] - cand["px"]
    dy = center["py"] - cand["py"]
    d2 = dx * dx + dy * dy

    valid = (cand["act"] > 0.5) & (d2 <= phys.cutoff_sq)
    if self_slot is not None:
        valid = valid & ~self_slot

    vxdt = cand["vxdt"] if "vxdt" in cand else cand["vx"] * dt
    vydt = cand["vydt"] if "vydt" in cand else cand["vy"] * dt
    t1x = dx - vxdt
    t1y = dy - vydt
    t1l2 = t1x * t1x + t1y * t1y
    inv_d = torch.rsqrt(torch.clamp(d2, min=EPS))
    inv_t1l = torch.rsqrt(torch.clamp(t1l2, min=EPS))
    t2 = d2 * inv_d + t1l2 * inv_t1l  # d + |t1|
    if "v2dtt" in cand:
        v2dtt = cand["v2dtt"]
    else:
        v2dtt = (cand["vx"] * cand["vx"] + cand["vy"] * cand["vy"]) * (dt * dt)
    b2 = torch.clamp(t2 * t2 - v2dtt, min=EPS)
    inv_b = torch.rsqrt(b2)  # 1 / (2b)
    mag = (0.5 * phys.ped_strength) * torch.exp(
        (b2 * inv_b) * (-0.5 / phys.ped_range)) * t2 * inv_b

    ux = dx * inv_d + t1x * inv_t1l
    uy = dy * inv_d + t1y * inv_t1l
    u2 = ux * ux + uy * uy
    eu = center["ex"] * ux + center["ey"] * uy
    if not phys.cos_phi < 0:
        raise ValueError("the squared FOV test assumes an obtuse half-angle")
    in_front = eu * torch.abs(eu) <= u2 * (phys.cos_phi * phys.cos_phi)

    w = torch.where(in_front, 1.0, phys.fov_damping)
    m = torch.where(valid, w * mag, 0.0)
    return acc[0] + m * ux, acc[1] + m * uy


def _check(d: torch.Tensor, row_block: int) -> None:
    if d.dtype != torch.float32 or not d.is_contiguous() or d.dim() != 4:
        raise ValueError("d must be a contiguous float32 [ny2, K, 8, NX] tensor")
    ny2, _k, ch, nx = d.shape
    if ch != 8 or nx % 128 != 0:
        raise ValueError(f"d must be [ny2, K, 8, NX % 128 == 0], got {tuple(d.shape)}")
    if ny2 < 3 or (ny2 - 2) % row_block != 0:
        raise ValueError(f"ny_pad = {ny2 - 2} must be a positive multiple of "
                         f"row_block = {row_block}")


def pairwise_smem_bytes(k: int, tile_rows: int) -> int:
    """Shared memory of a pairwise block for a tile of ``tile_rows`` rows x
    TILE_LANES cells at K = ``k`` (csrc/pairwise.cu tile_smem_bytes, the
    same sum): row bitmasks, the staged positions and velocity terms (5
    floats a slot) of the tile and its halo, the tile's accelerations, its
    slot list, per-row counters and the per-warp candidate box (32 warps)."""
    h, n_tile = tile_rows + 2, tile_rows * k * TILE_LANES
    return (8 * h * k + 20 * h * k * (TILE_LANES + 2) + 8 * n_tile
            + 2 * n_tile + 4 * h + 4 * (tile_rows + 1) + 16 * 32)


def pairwise_launch(k: int, ny2: int, nx: int) -> tuple[int, int, int]:
    """(tile rows, threads per block, shared-memory bytes) of the pairwise
    kernel on a grid [ny2, K, 8, NX], from ``tiles.tile_launch``, as the
    fused step's pair pass (``step_kernel.pair_pass_launch``).  Tiles cover lanes [0, NX) and the
    centre rows 1 .. ny2-2, the last one possibly ragged.  A K at which not
    even one row fits raises (K above 97)."""
    if nx % TILE_LANES != 0 or ny2 < 3 or not 1 <= k <= 255:
        raise ValueError(f"pairwise: unsupported grid ny2={ny2}, K={k}, NX={nx}")
    return tile_launch(lambda rows: pairwise_smem_bytes(k, rows), ny2,
                       f"pairwise: K={k}")


def pairwise(d: torch.Tensor, phys: Physics, row_block: int = 4) -> torch.Tensor:
    """Pair accelerations over the x-minor cell grid: acc [ny_pad, K, 2, NX].

    ``d`` [ny_pad+2, K, 8, NX]: ch 0 pos.x, 1 pos.y, 2 vel.x, 3 vel.y, 4-5
    the desired direction e, 6 active.  Every centre slot gets an
    acceleration, active or not; a candidate counts by its ch 6 alone (no
    count bound, no sanitize); lanes roll circularly.  ``row_block`` is the
    reference's block height, validated only (ny_pad % row_block == 0).
    CUDA tensors run the kernel (or raise); CPU tensors the twin."""
    _check(d, row_block)
    if d.device.type == "cpu":
        return pairwise_torch(d, phys, row_block)
    if d.device.type != "cuda":
        raise ValueError(f"pairwise: unsupported device {d.device}")
    ny2, k, _, nx = d.shape
    launch = pairwise_launch(k, ny2, nx)
    lib = _build.library()
    acc = torch.empty((ny2 - 2, k, 2, nx), dtype=torch.float32, device=d.device)
    consts = torch.tensor(pair_constants(phys), dtype=torch.float32)
    stream = torch.cuda.current_stream(d.device).cuda_stream
    rc = lib.pedoni_pairwise(d.data_ptr(), acc.data_ptr(), ny2, k, nx, *launch,
                             consts.data_ptr(), stream)
    _build.check_launch(rc, "pedoni_pairwise")
    pairwise.launches += 1
    return acc


pairwise.launches = 0


def pairwise_torch(d: torch.Tensor, phys: Physics, row_block: int = 4
                   ) -> torch.Tensor:
    """Plain PyTorch twin of the pairwise kernel: the reference's order,
    dy outer, then candidate slot j over all K, then dx (pairwise.py:128-153)."""
    _check(d, row_block)
    ny2, k, _, _nx = d.shape
    c = slice(1, ny2 - 1)
    center = {"px": d[c, :, 0], "py": d[c, :, 1], "ex": d[c, :, 4],
              "ey": d[c, :, 5]}
    acc = (torch.zeros_like(center["px"]), torch.zeros_like(center["px"]))
    slot = torch.arange(k, device=d.device).view(1, k, 1)
    dt = phys.delta_time
    for dy in (-1, 0, 1):
        r = slice(1 + dy, ny2 - 1 + dy)
        for j in range(k):
            cvx, cvy = d[r, j:j + 1, 2], d[r, j:j + 1, 3]
            row = {"px": d[r, j:j + 1, 0], "py": d[r, j:j + 1, 1],
                   "act": d[r, j:j + 1, 6], "vxdt": cvx * dt, "vydt": cvy * dt,
                   "v2dtt": (cvx * cvx + cvy * cvy) * (dt * dt)}
            for dxo in (-1, 0, 1):
                cand = {n: _shift_lane(a, dxo) for n, a in row.items()}
                self_slot = (slot == j) if (dy == 0 and dxo == 0) else None
                acc = pair_accum(acc, center, cand, phys, self_slot)
    return torch.stack(acc, dim=2)
