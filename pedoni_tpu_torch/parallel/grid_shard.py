"""Row strips of the grid backend: the cols = 1 case of tile2d.

Counterpart of pedoni_tpu/parallel/grid_shard.py: shard the grid ``D`` on
its cell-row axis and a step's communication is two one-row ghost
exchanges (``tile2d.exchange`` with no lane neighbours); migration is the
rebin picking movers out of a ghost row.  Everything else is
parallel/tile2d.py's, on the configuration this module builds; its
functions, which take a transport across processes, are re-exported
here as the reference's are (``device_inputs`` in place of its
``device_inputs_on_mesh``; no mesh).  ``dryrun`` is tile2d's on n x 1
tiles.
"""

from __future__ import annotations

from ..models.sfm import StepConfig
from .tile2d import (  # noqa: F401  (re-exports, as the reference's)
    Tile2DConfig,
    device_inputs,
    exchange,
    gather,
    make_sharded_grid_state,
    make_sharded_step,
    population,
    shard_device_inputs,
    unbin_sharded,
)
from .tile2d import dryrun as dryrun_2d


class GridShardConfig:
    """Row strips = Tile2DConfig(rows=N, cols=1)."""

    @staticmethod
    def build(cfg: StepConfig, n_devices: int, row_block: int = 2) -> Tile2DConfig:
        return Tile2DConfig.build(cfg, n_devices, 1, row_block=row_block)


def dryrun(n_devices: int, device: str = "cuda") -> None:
    """Entry hook: the row-strip step on ``n_devices`` strips (tile2d's
    dryrun on n x 1 tiles)."""
    dryrun_2d(n_devices, 1, device=device)
