"""The flat step's force sum and integration as one kernel
(``csrc/flat_integrate.cu``).

``flat_integrate`` computes ``flat_integrate_torch``: for every sorted row
(``flat_scatter``'s) the goal term, the obstacle term, the pair term, their
sum and the trapezoidal integration with the speed clamp, as the new
(pos, vel).  The obstacle term comes from the rows' sampled distance and
Sobel (distance-map mode) or, computed apart, as ``obstacle`` (segment
mode; None without obstacles); the pair term from the pair pass's
accelerations through the layout's slots, or, computed apart, as ``pair``
(all-pairs mode).  On a CUDA tensor it launches the kernel or raises; on a
CPU tensor it runs the twin, which the kernel mirrors op by op, so the two
agree bit for bit on the card.

The reference has no pallas_call here: XLA fuses its goal, obstacle, pair
gather and integration (pedoni_tpu/ops/forces.py:41, 92, 158;
pedoni_tpu/ops/forcepass.py:187).  The flat step and every x-strip step
call it once a step.
"""

from __future__ import annotations

import numpy as np
import torch

from ...physics import Physics
from .. import forcepass, forces as F
from ..forcepass import CellLayout
from . import _build


def flat_integrate_torch(rows: torch.Tensor, active: torch.Tensor,
                         phys: Physics, acc_flat: torch.Tensor | None = None,
                         layout: CellLayout | None = None,
                         pair: torch.Tensor | None = None,
                         obstacle: torch.Tensor | None = None,
                         distance_map: bool = True
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's twin: the flat step's forces and integration as they
    were composed before the kernel.  The pair term is ``pair`` if given,
    else ``acc_flat`` gathered through ``layout``; the obstacle term comes
    from the rows with ``distance_map``, else it is ``obstacle`` (None:
    no term)."""
    pos, vel, speed, e = rows[:, 0:2], rows[:, 2:4], rows[:, 4], rows[:, 7:9]
    acc = F.goal_force(e, vel, speed, phys)
    if distance_map:
        acc = acc + F.obstacle_force(rows[:, 9], rows[:, 10:12], phys)
    elif obstacle is not None:
        acc = acc + obstacle
    if pair is None:
        acc = acc + forcepass.gather_pair_acc(acc_flat, layout)
    else:
        acc = acc + pair
    return F.integrate(pos, vel, acc, speed, active, phys)


def integrate_constants(phys: Physics) -> list[float]:
    """csrc/flat_integrate.cu IntegrateConsts, in order; each rounded to f32
    once, as the twin's Python scalars are when they meet an f32 tensor."""
    return [phys.relaxation_time, phys.obs_strength, phys.obs_range, F.EPS,
            phys.delta_time, phys.max_speed_factor, phys.delta_time * 0.5]


def _check(rows, active, acc_flat, layout, pair, obstacle, distance_map) -> None:
    if (rows.dtype != torch.float32 or not rows.is_contiguous() or rows.dim() != 2
            or rows.shape[1] != 12):
        raise ValueError("flat_integrate: rows must be a contiguous float32 [C, 12] "
                         f"tensor, got {rows.dtype} {tuple(rows.shape)}")
    c = rows.shape[0]
    want = {"active": (active, torch.bool, (c,))}
    if pair is None:
        if acc_flat is None or layout is None:
            raise ValueError("flat_integrate: give pair, or acc_flat and layout")
        want.update(slot=(layout.slot, torch.int64, (c,)),
                    valid=(layout.valid, torch.bool, (c,)),
                    acc_flat=(acc_flat, torch.float32, (acc_flat.shape[0], 2)))
    else:
        want["pair"] = (pair, torch.float32, (c, 2))
    if obstacle is not None:
        if distance_map:
            raise ValueError("flat_integrate: an obstacle term in distance-map mode")
        want["obstacle"] = (obstacle, torch.float32, (c, 2))
    for name, (t, dtype, shape) in want.items():
        if (t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous()
                or t.device != rows.device):
            raise ValueError(f"flat_integrate: {name} must be a contiguous {dtype} "
                             f"{shape} tensor on {rows.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def flat_integrate(rows: torch.Tensor, active: torch.Tensor, phys: Physics,
                   acc_flat: torch.Tensor | None = None,
                   layout: CellLayout | None = None,
                   pair: torch.Tensor | None = None,
                   obstacle: torch.Tensor | None = None,
                   distance_map: bool = True
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(pos [C, 2], vel [C, 2]) of the sorted rows after the step's forces
    (see ``flat_integrate_torch``): the kernel on a CUDA tensor, the twin
    on a CPU one."""
    _check(rows, active, acc_flat, layout, pair, obstacle, distance_map)
    if rows.device.type == "cpu":
        return flat_integrate_torch(rows, active, phys, acc_flat, layout, pair,
                                    obstacle, distance_map)
    if rows.device.type != "cuda":
        raise ValueError(f"flat_integrate: unsupported device {rows.device}")
    if rows.data_ptr() % 16:
        raise ValueError("flat_integrate: rows must be 16-byte aligned")
    c = rows.shape[0]
    pos = torch.empty((c, 2), dtype=torch.float32, device=rows.device)
    vel = torch.empty((c, 2), dtype=torch.float32, device=rows.device)
    if c == 0:
        return pos, vel
    obs_mode = 1 if distance_map else (0 if obstacle is None else 2)
    consts = torch.from_numpy(np.array(integrate_constants(phys), np.float32))

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    lib = _build.library()
    with torch.cuda.device(rows.device):  # a launch goes to the current card
        rc = lib.pedoni_flat_integrate(
            rows.data_ptr(), active.data_ptr(), ptr(acc_flat),
            ptr(layout.slot if pair is None else None),
            ptr(layout.valid if pair is None else None), ptr(pair),
            ptr(obstacle), pos.data_ptr(), vel.data_ptr(), c, obs_mode,
            int(pair is not None), consts.data_ptr(),
            torch.cuda.current_stream(rows.device).cuda_stream)
    _build.check_launch(rc, "pedoni_flat_integrate")
    flat_integrate.launches += 1
    return pos, vel


flat_integrate.launches = 0
