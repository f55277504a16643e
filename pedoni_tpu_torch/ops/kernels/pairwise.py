"""Pair-force core: the plain PyTorch twin of ``csrc/pair.cuh``.

Counterpart of pedoni_tpu/ops/pallas/pairwise.py::_pair_accum
(pairwise.py:40-103): the Helbing elliptical repulsion of sfm.rs:129-153
(2 m cutoff, FOV damping, self-exclusion) in the reference's
strength-reduced form.  The CUDA version is the ``pair_accum`` device
function that the fused step kernel (csrc/step_kernel.cu) inlines; this
function is what the step kernel's twin runs, and what the CPU tests hold
against the reference's ``_pair_accum``.

Both versions take every norm through rsqrt (``torch.rsqrt`` here,
``rsqrtf`` in CUDA, which is what ``torch.rsqrt`` runs on the card).
"""

from __future__ import annotations

import torch

from ...physics import Physics

EPS = 1e-12


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
