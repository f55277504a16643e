"""The social-force model: state, step configuration, the flat step
(``sfm``), the pallas step (``sfm_pallas``: flat agents through the fused
step kernel), the grid step (``sfm_grid``) and the object surface
(``base``)."""

from .sfm import (
    AgentState,
    SimState,
    StepConfig,
    StepMetrics,
    make_initial_state,
    make_step,
)
from .sfm_pallas import make_step_pallas

__all__ = [
    "AgentState",
    "SimState",
    "StepConfig",
    "StepMetrics",
    "make_initial_state",
    "make_step",
    "make_step_pallas",
]
