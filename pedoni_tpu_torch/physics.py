"""Physics constants and tunables of the social-force model.

The reference hardcodes every physics constant inline (see
``pedoni-simulator/src/models/sfm.rs`` and ``pedoni/src/main.rs:28``).  We
collect them in one frozen dataclass so they are configurable, defaulting to
the exact reference values:

- ``delta_time``          main.rs:28 (``DELTA_TIME = 0.1``), sfm.rs:251-253
- ``relaxation_time``     sfm.rs:109 (``/ 0.5``)
- ``interaction_cutoff``  sfm.rs:133 (``distance_squared > 4.0`` => 2 m)
- ``ped_strength/range``  sfm.rs:147 (``2.1 / 0.3 * (-b / 0.3).exp()``)
- ``obs_strength/range``  sfm.rs:191 (``10.0 * 0.2 * (-d / 0.2).exp()``)
- ``cos_phi``             sfm.rs:16  (cos of 100 deg field-of-view half angle)
- ``fov_damping``         sfm.rs:150 (``force *= 0.5`` outside FOV)
- ``speed_mean/std``      sfm.rs:54  (``f32_normal_approx(1.34, 0.26)``)
- ``max_speed_factor``    sfm.rs:252 (``clamp_length_max(desired_speed * 1.3)``)
- ``despawn_potential``   sfm.rs:69  (``get_potential(..) > 0.25`` keeps agent)
- ``spawn_rate_scale``    lib.rs:73  (``poisson(frequency / 10.0)``)
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Physics:
    delta_time: float = 0.1
    relaxation_time: float = 0.5
    interaction_cutoff: float = 2.0
    ped_strength: float = 2.1 / 0.3
    ped_range: float = 0.3
    obs_strength: float = 10.0 * 0.2
    obs_range: float = 0.2
    cos_phi: float = -0.17364817766693036  # cos(100 deg)
    fov_damping: float = 0.5
    speed_mean: float = 1.34
    speed_std: float = 0.26
    max_speed_factor: float = 1.3
    despawn_potential: float = 0.25
    spawn_rate_scale: float = 0.1

    def __post_init__(self) -> None:
        if self.delta_time <= 0:
            raise ValueError("delta_time must be positive")
        if self.interaction_cutoff <= 0:
            raise ValueError("interaction_cutoff must be positive")

    @property
    def cutoff_sq(self) -> float:
        return self.interaction_cutoff * self.interaction_cutoff


DEFAULT_PHYSICS = Physics()

assert math.isclose(DEFAULT_PHYSICS.cos_phi, math.cos(math.radians(100.0)))
