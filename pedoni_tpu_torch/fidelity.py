"""Evacuation fidelity: the reference author's own metric, steps until no
agent is left (the reference's main.rs:58-77), on the port's backends.

Two harnesses, as the JAX package has them:

- ``evac_steps(backend, seed)``: scenarios/gap.toml through
  ``Simulator`` until the population reaches 0, on the port's own random
  stream (the counterpart of scripts/gap_distribution.py).  Per-seed
  counts differ from the reference's, whose stream differs; only their
  distributions compare.
- ``evac_steps_from(geometry, seed, backend)``: the same count from an
  initial state that NumPy draws from ``seed``, identical to the one
  tests/test_oracle.py gives the reference and the f64 oracle
  (tests/oracle_sfm.py), so it compares seed by seed.  The geometries,
  their seeds and table capacities, CAP, UNIT and EVAC_MAX are copies of
  tests/test_oracle.py:236-342 (tests/test_torch_fidelity.py holds them
  equal), all but narrow_gap: it reads the reference's own
  narrow-gap.toml, which this repository does not hold.
  ``evac_steps_oracle`` runs the oracle, which the caller passes in: it
  lives with the tests and shares no code with either package.
- ``gap_distribution(backend, seeds)``: ``evac_steps`` over seeds 1..N,
  with the counts' mean and sample standard deviation.

    python -m pedoni_tpu_torch.fidelity [--backends xla grid pallas] [--seeds 8] [--device cuda]

prints each backend's gap.toml counts over seeds 1..N with their mean and
sample standard deviation (scripts/gap_distribution.py prints the
population's), then one JSON line with the device (the card's name and
power limit).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
from typing import Callable, NamedTuple

import numpy as np
import torch

from . import convert
from .bench import device_label
from .field import Field, FieldMaps
from .models import sfm_grid, sfm_pallas
from .models.sfm import SimState, StepConfig, device_inputs, make_step
from .scenario import Scenario, load_scenario, loads_scenario
from .sim import Simulator, SimulatorOptions

ROOT = pathlib.Path(__file__).resolve().parents[1]
GAP = ROOT / "scenarios" / "gap.toml"
BACKENDS = ("xla", "grid", "pallas")
CAP = 128  # agent rows of every identical-state run
UNIT = 1.5  # neighbor cell of every identical-state run, on all backends
EVAC_MAX = 600  # steps; a run past it counts EVAC_MAX + 1

# A trimmed multi-waypoint once-scenario: 3 exit bands on the left edge, a
# central wall with passages above and below, 48 agents starting on the
# right, each bound for its own band (nearest-exit assignment).
MULTIWP = """
[field]
size = [30, 21]
[[waypoints]]
line = [[2, 1], [2, 7]]
[[waypoints]]
line = [[2, 7], [2, 14]]
[[waypoints]]
line = [[2, 14], [2, 20]]
[[obstacles]]
line = [[15, 4], [15, 17]]
width = 2
"""

# A trimmed bottleneck funnel: two diagonal walls funnel 96 agents through
# a ~3 m opening at x = 16, then on to the exit line at x = 28.
FUNNEL = """
[field]
size = [30, 20]
[[waypoints]]
line = [[2, 2], [2, 18]]
[[waypoints]]
line = [[28, 2], [28, 18]]
[[obstacles]]
line = [[8, 0], [16, 8]]
width = 1
[[obstacles]]
line = [[8, 20], [16, 12]]
width = 1
"""


def _init_gap(seed: int):
    """64 agents in the left chamber of gap.toml, bound for waypoint 1 on
    the far side of the wall."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((CAP, 2), np.float32)
    pos[:, 0] = rng.uniform(2.0, 10.0, CAP)
    pos[:, 1] = rng.uniform(2.0, 22.0, CAP)
    return pos, np.ones(CAP, np.int32), 64



def _init_funnel(seed: int):
    """96 agents filling the funnel's mouth, bound for the far exit."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((CAP, 2), np.float32)
    pos[:, 0] = rng.uniform(2.0, 7.5, CAP)
    pos[:, 1] = rng.uniform(2.0, 18.0, CAP)
    return pos, np.ones(CAP, np.int32), 96


def _init_multiwp(seed: int):
    """48 agents on the right half, each bound for its own y band's exit."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((CAP, 2), np.float32)
    pos[:, 0] = rng.uniform(20.0, 28.0, CAP)
    pos[:, 1] = rng.uniform(2.0, 19.0, CAP)
    dest = np.minimum(pos[:, 1] // 7.0, 2).astype(np.int32)
    return pos, dest, 48


class Geometry(NamedTuple):
    """``source``: ("file", path of this repository) or ("inline", TOML
    text)."""
    source: tuple[str, str | pathlib.Path]
    init: Callable[[int], tuple[np.ndarray, np.ndarray, int]]
    seeds: tuple[int, ...]
    table_capacity: int


GEOMETRIES = {
    "gap": Geometry(("file", GAP), _init_gap, (1, 2, 3), 12),
    "multiwp": Geometry(("inline", MULTIWP), _init_multiwp, (1, 2, 3, 4, 5), 12),
    "funnel": Geometry(("inline", FUNNEL), _init_funnel, (1, 2, 3, 4, 5), 14),
}


def scenario(geometry: str) -> Scenario:
    """The geometry's scenario."""
    kind, src = GEOMETRIES[geometry].source
    return loads_scenario(src) if kind == "inline" else load_scenario(src)


def initial(geometry: str, seed: int):
    """(pos, vel, speed, dest, active) as NumPy arrays of CAP rows: the
    geometry's agents at rest, speeds 1 + 0.002 i (unique: they name the
    agents across the grid's slot order)."""
    pos, dest, n = GEOMETRIES[geometry].init(seed)
    vel = np.zeros((CAP, 2), np.float32)
    speed = (1.0 + 0.002 * np.arange(CAP)).astype(np.float32)
    return pos, vel, speed, dest, np.arange(CAP) < n


def evac_steps_from(geometry: str, seed: int, backend: str, *,
                    device: str = "cuda") -> tuple[int, int]:
    """(steps until no agent is left, agents lost) from the geometry's
    identical initial state (``initial``) on ``backend``: ``xla`` the flat
    step (models/sfm.py::make_step), ``grid`` the binned state through the
    hybrid grid step (sfm_grid.make_step_grid's defaults), ``pallas`` the
    flat agents through the pallas step (sfm_pallas.make_step_pallas), all
    at UNIT with the geometry's table capacity.  Steps past EVAC_MAX
    count EVAC_MAX + 1.  Agents lost: the grid's ``n_dropped +
    n_overflow`` over the run (an agent beyond K in its cell is dropped);
    0 on the flat paths, which keep every agent."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: one of {BACKENDS}")
    sc = scenario(geometry)
    maps = FieldMaps.from_field(Field.from_scenario(sc, unit=0.25))
    cfg = StepConfig.build(sc, capacity=CAP, neighbor_grid_unit=UNIT,
                           table_capacity=GEOMETRIES[geometry].table_capacity)
    state = SimState(convert.agents_from_numpy(*initial(geometry, seed), device), 0)
    if backend == "xla":
        field, obstacles = device_inputs(cfg, maps, device)
        step, args = make_step(cfg), (field.rows, obstacles)
    elif backend == "grid":
        state = sfm_grid.bin_state(cfg, state)
        step = sfm_grid.make_step_grid(cfg)
        args = sfm_grid.field_tensors(cfg, maps, device)
    else:
        step = sfm_pallas.make_step_pallas(cfg)
        args = sfm_pallas.pallas_device_inputs(cfg, maps, device)
    lost = 0
    for i in range(1, EVAC_MAX + 1):
        state, m = step(state, *args)
        n_active, dropped, overflow = torch.stack(
            [m.n_active, m.n_dropped, m.n_overflow]).tolist()
        if backend == "grid":
            lost += dropped + overflow
        if n_active == 0:
            return i, lost
    return EVAC_MAX + 1, lost


def evac_steps_oracle(geometry: str, seed: int, oracle_step) -> int:
    """The same count from the same initial state through ``oracle_step``
    (tests/oracle_sfm.py's signature) in f64, on this package's Field."""
    sc = scenario(geometry)
    field = Field.from_scenario(sc, unit=0.25)
    p, v, speed, dest, a = initial(geometry, seed)
    speed = speed.astype(np.float64)
    for i in range(1, EVAC_MAX + 1):
        p, v, a = oracle_step(field, p, v, speed, dest, a, sc.size, UNIT)
        if not a.any():
            return i
    return EVAC_MAX + 1


def evac_steps(backend: str, seed: int, *, device: str = "cuda",
               max_steps: int = EVAC_MAX) -> int:
    """Ticks of gap.toml through ``Simulator`` (``backend``, ``seed``)
    until the population reaches 0; -1 past ``max_steps``."""
    sim = Simulator(SimulatorOptions(backend=backend, seed=seed, device=device),
                    load_scenario(GAP))
    for i in range(1, max_steps + 1):
        if sim.tick().active_ped_count == 0:
            return i
    return -1


class GapDistribution(NamedTuple):
    steps: list[int]  # one count a seed, seeds 1..N
    mean: float
    sd: float  # sample standard deviation


def gap_distribution(backend: str, seeds: int, *, device: str = "cuda"
                     ) -> GapDistribution:
    """``evac_steps`` on ``backend`` at seeds 1..``seeds`` (at least 2),
    their mean and sample standard deviation.  RuntimeError where a seed
    does not evacuate within EVAC_MAX ticks."""
    steps = [evac_steps(backend, s, device=device) for s in range(1, seeds + 1)]
    if -1 in steps:
        raise RuntimeError(f"gap.toml on {backend}: seed "
                           f"{steps.index(-1) + 1} did not evacuate within "
                           f"{EVAC_MAX} ticks: {steps}")
    return GapDistribution(steps, statistics.mean(steps), statistics.stdev(steps))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backends", nargs="+", default=list(BACKENDS),
                    choices=BACKENDS)
    ap.add_argument("--seeds", type=int, default=8,
                    help="seeds 1..N of each backend (default 8, at least 2)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.exit(2, "fidelity: --device cuda but torch.cuda.is_available() "
                   "is False\n")
    out = {}
    for backend in args.backends:
        d = gap_distribution(backend, args.seeds, device=args.device)
        out[backend] = d._asdict()
        print(f"{backend:6s}: {d.steps}  mean {d.mean:.1f} ± {d.sd:.1f} "
              "(sample sd)", flush=True)
    print(json.dumps({"scenario": "gap.toml", "seeds": args.seeds,
                      "backends": out, "device": device_label(device)}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
