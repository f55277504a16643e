"""Entry points: one step of the flagship model and a multi-device dry run
(counterpart of the reference's root __graft_entry__.py).

- ``entry()`` -> (fn, example_args): one step of the grid backend (the
  fused step kernel and the hybrid rebin) on the card at a tiny setup;
  ``fn(*example_args)`` -> (GridState, StepMetrics).
- ``dryrun_multichip(n)``: a few tiled grid steps on tiny shapes over n
  tiles, tile i on cuda:i (row strips, and 2D tiles where n >= 4 is even),
  then a few steps of the flat step cut into n x-strips
  (``parallel.spatial``), as the reference's __graft_entry__.py:67-77.

    python -m pedoni_tpu_torch.entry   # both, over the machine's cards
"""

from __future__ import annotations

import torch

from .field import Field, FieldMaps
from .models import sfm_grid
from .models.sfm import StepConfig, make_initial_state
from .parallel import grid_shard, spatial, tile2d
from .scenario import loads_scenario

TINY_SCENARIO = """
[field]
size = [16, 16]
[[waypoints]]
line = [[2, 2], [2, 14]]
[[waypoints]]
line = [[14, 2], [14, 14]]
[[obstacles]]
line = [[8, 0], [8, 6]]
width = 1
[[pedestrians]]
origin = 0
destination = 1
spawn = { kind = "periodic", frequency = 4.0 }
[[pedestrians]]
origin = 1
destination = 0
spawn = { kind = "once", count = 32 }
"""


def entry(device: str = "cuda"):
    """One grid step at the reference's tiny setup (16 x 16 m, 32 agents
    and a periodic stream, capacity 256, 1.5 m cells, K = 8): the step
    function and its example arguments (state, fwp, fobs) on ``device``."""
    scenario = loads_scenario(TINY_SCENARIO)
    maps = FieldMaps.from_field(Field.from_scenario(scenario, unit=0.25))
    cfg = StepConfig.build(scenario, capacity=256, neighbor_grid_unit=1.5,
                           table_capacity=8)
    generator = torch.Generator(device=device).manual_seed(0)
    step = sfm_grid.make_step_grid(cfg, generator=generator)
    state = sfm_grid.bin_state(cfg, make_initial_state(cfg, generator, device))
    fwp, fobs = sfm_grid.field_tensors(cfg, maps, device)

    def fn(state, fwp, fobs):
        return step(state, fwp, fobs)

    return fn, (state, fwp, fobs)


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """The tiled grid step over ``n_devices`` tiles: row strips, and 2D
    tiles (n/2 x 2) where n >= 4 is even; then the strip step over
    ``n_devices`` strips (``device="cpu"``: every tile and strip on the
    CPU)."""
    grid_shard.dryrun(n_devices, device=device)
    if n_devices >= 4 and n_devices % 2 == 0:
        tile2d.dryrun(n_devices // 2, 2, device=device)
    spatial.dryrun(n_devices, device=device)


def main() -> int:
    fn, args = entry()
    _state, metrics = fn(*args)
    print(f"entry() ok: {int(metrics.n_active)} active agents on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    dryrun_multichip(max(torch.cuda.device_count(), 2))
    print("dryrun_multichip ok", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
