"""Multi-device paths: the grid cut into tiles over a list of devices
(``tile2d``: rows x columns; ``grid_shard``: row strips, its cols = 1
case), the flat step cut into x-strips with agent packages (``spatial``,
whose four names this package exports, as the reference's does), and the
transport between tiles of one process or of a ``torch.distributed``
group (``transport``)."""

from .spatial import ShardedConfig, dryrun, make_sharded_initial_state, make_sharded_step

__all__ = [
    "ShardedConfig",
    "make_sharded_step",
    "make_sharded_initial_state",
    "dryrun",
]
