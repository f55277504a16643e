"""Row strips of the grid backend: the cols = 1 case of tile2d.

Counterpart of pedoni_tpu/parallel/grid_shard.py: shard the grid ``D`` on
its cell-row axis and a step's communication is two one-row ghost
exchanges (``tile2d.exchange`` with no lane neighbours); migration is the
rebin picking movers out of a ghost row.  Everything else is
parallel/tile2d.py's, on the configuration this module builds.
"""

from __future__ import annotations

from ..models.sfm import StepConfig
from .tile2d import Tile2DConfig


class GridShardConfig:
    """Row strips = Tile2DConfig(rows=N, cols=1)."""

    @staticmethod
    def build(cfg: StepConfig, n_devices: int, row_block: int = 2) -> Tile2DConfig:
        return Tile2DConfig.build(cfg, n_devices, 1, row_block=row_block)
