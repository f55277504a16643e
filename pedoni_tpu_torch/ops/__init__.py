"""Field sampling, neighbour search, the social-force terms and the flat
pair pass; the fields6 layout and the hand-written kernels."""

from .neighbor import CellGrid, NeighborData, build_neighbor_data
from .sampling import DeviceField, FieldSample, sample_field

__all__ = [
    "DeviceField",
    "FieldSample",
    "sample_field",
    "CellGrid",
    "NeighborData",
    "build_neighbor_data",
]
