"""The social-force model: state, step configuration, the flat step
(``sfm``), the grid step (``sfm_grid``) and the object surface (``base``)."""

from .sfm import (
    AgentState,
    SimState,
    StepConfig,
    StepMetrics,
    make_initial_state,
    make_step,
)

__all__ = [
    "AgentState",
    "SimState",
    "StepConfig",
    "StepMetrics",
    "make_initial_state",
    "make_step",
]
