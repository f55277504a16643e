"""Reference state, as NumPy arrays, to the port's tensors, and back.

The two packages exchange data only as NumPy arrays.  Agent arrays and
step metrics need the conversions below; the grid ``D [ny_pad+2, K, 8,
NXL]`` and the fields6 planes have the reference's layout and dtype here,
so ``torch.from_numpy`` / ``Tensor.numpy()`` carry them unchanged.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .models.sfm import AgentState, StepMetrics


def agents_from_numpy(pos: Any, vel: Any, speed: Any, dest: Any, active: Any,
                      device: torch.device | str = "cuda") -> AgentState:
    """Flat agent arrays (any array-likes) -> AgentState on ``device`` (the
    card unless the caller asks for ``"cpu"``, as the port's other entry
    points)."""
    def f32(x):
        return torch.as_tensor(np.array(x, np.float32), device=device)
    return AgentState(
        pos=f32(pos), vel=f32(vel), speed=f32(speed),
        dest=torch.as_tensor(np.array(dest, np.int32), device=device),
        active=torch.as_tensor(np.array(active, bool), device=device),
    )


def agents_to_numpy(agents: AgentState) -> dict[str, np.ndarray]:
    return {name: t.detach().cpu().numpy() for name, t in agents._asdict().items()}


def metrics_to_dict(m: StepMetrics) -> dict[str, int]:
    """Step metrics (device tensors or ints) -> plain ints by field name."""
    return {name: int(v) for name, v in m._asdict().items()}
