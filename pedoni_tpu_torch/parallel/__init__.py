"""The grid cut into tiles over a list of devices: ``tile2d`` (rows x
columns) and ``grid_shard`` (row strips, its cols = 1 case)."""
