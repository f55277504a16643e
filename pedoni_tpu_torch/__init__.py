"""pedoni-tpu ported to PyTorch and CUDA for NVIDIA Hopper (H100).

A second package beside ``pedoni_tpu`` (the JAX reference, which it never
imports).  It covers the grid backend, on one device or cut into tiles
over a list of devices (``parallel``): the plain-torch spawn scatter, the hand-written CUDA fused step kernel (distance-map or
segment obstacles, optional mover emit), the full and incremental rebins
and the standalone pairwise kernel (``ops/kernels/csrc``), each with a
plain PyTorch twin that runs on CPU tensors; the Simulator with both
debug modes, checkpoints (``checkpoint``) and the headless CLI
(``python -m pedoni_tpu_torch``).  Host modules (scenario, field,
physics, diagnostics, fields6, utils, the native FMM) are copies of the
reference's, since importing any of the reference's modules loads JAX.
"""

from .field import Field, FieldMaps
from .physics import Physics
from .scenario import Scenario, Segment, load_scenario, loads_scenario
from .sim import Simulator, SimulatorOptions

__version__ = "0.1.0"

__all__ = [
    "Field",
    "FieldMaps",
    "Physics",
    "Scenario",
    "Segment",
    "Simulator",
    "SimulatorOptions",
    "load_scenario",
    "loads_scenario",
]
