"""pedoni-tpu ported to PyTorch and CUDA for NVIDIA Hopper (H100).

A second package beside ``pedoni_tpu`` (the JAX reference, which it never
imports), with the reference's two backends.  The flat step (the default,
``backend="xla"``: ``models/sfm.py::make_step``) runs in plain PyTorch on
flat agent tensors, with the object surface of ``models/base.py`` over it.
The grid step (``backend="grid"``), on one device or cut into tiles over a
list of devices (``parallel``), runs the hand-written CUDA kernels
(``ops/kernels/csrc``: the fused step kernel with distance-map or segment
obstacles and an optional mover emit, the full and incremental rebins,
and the standalone pairwise kernel), each with a plain PyTorch twin that
runs on CPU tensors.  Around them: the Simulator with both debug modes,
checkpoints (``checkpoint``), the headless CLI (``python -m
pedoni_tpu_torch``), the headline benchmark (``python -m
pedoni_tpu_torch.bench``) and the entry points (``python -m
pedoni_tpu_torch.entry``).  Host modules (scenario, field, physics,
diagnostics, fields6, utils, the native FMM) are copies of the
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
