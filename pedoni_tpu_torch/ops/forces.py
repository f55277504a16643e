"""Social-force terms, in torch (counterpart of pedoni_tpu/ops/forces.py).

The physics of the reference's hot loop (sfm.rs:91-255) as masked
element-wise math over fixed-shape candidate sets:

- goal        (sfm.rs:107-109): ``acc += (e * v0 - v) / tau`` with ``e``
              the unit downhill direction of the destination's potential.
- pairwise    (sfm.rs:131-153): elliptical Helbing repulsion with a 2 m
              cutoff and 100-degree field-of-view damping.
- obstacle    (sfm.rs:188-192): exponential repulsion along the negative
              obstacle-distance gradient; or, without the distance map,
              exact per-segment forces (sfm.rs:194-237).

Integration   (sfm.rs:245-254): trapezoidal with speed clamp at 1.3 * v0.

Every division is guarded so masked-out lanes never produce NaN/Inf that
could leak through ``where``, and every division by a Python scalar goes
through ``neighbor.true_divide`` (an IEEE divide on every device).
"""

from __future__ import annotations

import torch

from ..physics import Physics
from .neighbor import true_divide

EPS = 1e-12


def safe_norm(v: torch.Tensor) -> torch.Tensor:
    """|v| over the last axis, of length 2, at least sqrt(EPS)."""
    return norm2(v[..., 0], v[..., 1])


def safe_normalize(v: torch.Tensor) -> torch.Tensor:
    return v / safe_norm(v).unsqueeze(-1)


def goal_force(e: torch.Tensor, vel: torch.Tensor, desired_speed: torch.Tensor,
               phys: Physics) -> torch.Tensor:
    """Acceleration toward the destination (sfm.rs:107-109); ``e`` [N, 2]
    is the unit downhill direction of the destination's potential."""
    return true_divide(e * desired_speed[:, None] - vel, phys.relaxation_time)


def norm2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``safe_norm`` of a vector given as its two components."""
    return torch.sqrt(torch.clamp(x * x + y * y, min=EPS))


def pair_terms(dx: torch.Tensor, dy: torch.Tensor, d2: torch.Tensor,
               vx: torch.Tensor, vy: torch.Tensor, ex: torch.Tensor,
               ey: torch.Tensor, valid: torch.Tensor, phys: Physics
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The masked repulsion (x, y) of each (agent, candidate) pair, before
    the sum over candidates, one tensor a component (the reference's
    [..., 2] math term by term, in its order).  (dx, dy) = own position -
    candidate's, ``d2`` its squared length, (vx, vy) the candidate's
    velocity, (ex, ey) the agent's goal direction, all broadcasting to the
    pair shape; ``valid`` holds the candidate mask and the cutoff test."""
    dt = phys.delta_time
    d = torch.sqrt(torch.clamp(d2, min=EPS))
    t1x = dx - vx * dt
    t1y = dy - vy * dt
    t1_len = norm2(t1x, t1y)
    t2 = d + t1_len
    vlen = norm2(vx, vy)
    b = torch.sqrt(torch.clamp(t2 * t2 - (vlen * dt) ** 2, min=EPS)) * 0.5
    b4 = 4.0 * b
    mag = phys.ped_strength * torch.exp(true_divide(-b, phys.ped_range))
    fx = mag * (t2 * (dx / d + t1x / t1_len) / b4)
    fy = mag * (t2 * (dy / d + t1y / t1_len) / b4)
    # field-of-view anisotropy (sfm.rs:149-151)
    in_front = ex * -fx + ey * -fy >= norm2(fx, fy) * phys.cos_phi
    fx = torch.where(in_front, fx, fx * phys.fov_damping)
    fy = torch.where(in_front, fy, fy * phys.fov_damping)
    return torch.where(valid, fx, 0.0), torch.where(valid, fy, 0.0)


def pairwise_force(pos: torch.Tensor, vel: torch.Tensor, e: torch.Tensor,
                   cand_pos: torch.Tensor, cand_vel: torch.Tensor,
                   cand_valid: torch.Tensor, phys: Physics) -> torch.Tensor:
    """Summed repulsion from candidate neighbours (sfm.rs:129-153).
    pos/vel/e [N, 2]; cand_pos/cand_vel [N, M, 2]; cand_valid [N, M]."""
    dx = pos[:, None, 0] - cand_pos[..., 0]
    dy = pos[:, None, 1] - cand_pos[..., 1]
    d2 = dx * dx + dy * dy
    valid = cand_valid & (d2 <= phys.cutoff_sq)
    fx, fy = pair_terms(dx, dy, d2, cand_vel[..., 0], cand_vel[..., 1],
                        e[:, None, 0], e[:, None, 1], valid, phys)
    return torch.stack([fx.sum(1), fy.sum(1)], dim=1)


def obstacle_force(dist: torch.Tensor, dist_grad: torch.Tensor,
                   phys: Physics) -> torch.Tensor:
    """Repulsion away from the nearest obstacle (sfm.rs:188-192): ``dist``
    [N] the sampled obstacle distance, ``dist_grad`` [N, 2] the sampled
    Sobel of the distance map, which points toward the obstacle."""
    direction = -safe_normalize(dist_grad)
    magnitude = phys.obs_strength * torch.exp(true_divide(-dist, phys.obs_range))
    return magnitude[:, None] * direction


def segment_obstacle_force(pos: torch.Tensor, seg_p0: torch.Tensor,
                           seg_p1: torch.Tensor, seg_width: torch.Tensor,
                           phys: Physics) -> torch.Tensor:
    """Exact per-segment obstacle force, the reference's path without the
    distance map (sfm.rs:194-237): for each obstacle rectangle (the segment
    widened by ``width``) the force comes from the nearest of its 4 edges,
    unless the agent is inside it.  pos [N, 2]; seg_* [O, 2] / [O]."""
    d = seg_p1 - seg_p0
    h = safe_norm(d)
    a = d / h[:, None]
    n = torch.stack([a[:, 1], -a[:, 0]], dim=-1) * (seg_width * 0.5)[:, None]

    # 4 edges per rectangle, as in sfm.rs:199-205: [O, 4, 2 points, 2]
    edges = torch.stack([
        torch.stack([seg_p0 + n, seg_p0 - n], dim=1),
        torch.stack([seg_p1 + n, seg_p1 - n], dim=1),
        torch.stack([seg_p0 + n, seg_p1 + n], dim=1),
        torch.stack([seg_p0 - n, seg_p1 - n], dim=1),
    ], dim=1)

    p = pos[:, None, None, :]
    q0 = edges[None, :, :, 0, :]
    seg = edges[None, :, :, 1, :] - q0
    seg_len2 = torch.clamp((seg * seg).sum(-1), min=EPS)
    t = torch.clamp(((p - q0) * seg).sum(-1) / seg_len2, 0.0, 1.0)
    diffs = p - (q0 + t.unsqueeze(-1) * seg)  # [N, O, 4, 2]
    dists = safe_norm(diffs)  # [N, O, 4]

    # inside test (sfm.rs:211-216): d0 < w && d1 < w && d2 < h && d3 < h
    w_ = seg_width[None, :]
    h_ = h[None, :]
    inside = ((dists[:, :, 0] < w_) & (dists[:, :, 1] < w_)
              & (dists[:, :, 2] < h_) & (dists[:, :, 3] < h_))

    min_idx = torch.argmin(dists, dim=-1, keepdim=True)  # first of ties
    min_d = torch.gather(dists, -1, min_idx)[..., 0]
    min_diff = torch.gather(
        diffs, -2, min_idx.unsqueeze(-1).expand(*min_idx.shape, 2))[..., 0, :]
    direction = min_diff / torch.clamp(min_d, min=EPS).unsqueeze(-1)

    force = (phys.obs_strength * torch.exp(true_divide(-min_d, phys.obs_range))
             ).unsqueeze(-1) * direction
    force = torch.where(inside.unsqueeze(-1), 0.0, force)
    return force.sum(1)


def integrate(pos: torch.Tensor, vel: torch.Tensor, acc: torch.Tensor,
              desired_speed: torch.Tensor, active: torch.Tensor,
              phys: Physics) -> tuple[torch.Tensor, torch.Tensor]:
    """Trapezoidal update with speed clamp (sfm.rs:245-254)."""
    dt = phys.delta_time
    vel_new = vel + acc * dt
    vmax = desired_speed * phys.max_speed_factor
    scale = torch.clamp(vmax / torch.clamp(safe_norm(vel_new), min=EPS), max=1.0)
    vel_new = vel_new * scale[:, None]
    pos_new = pos + (vel_new + vel) * (dt * 0.5)
    keep = active[:, None]
    return torch.where(keep, pos_new, pos), torch.where(keep, vel_new, vel)
