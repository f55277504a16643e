"""The port's headline benchmark: agent-steps/s of the grid step.

    python -m pedoni_tpu_torch.bench [--agents N] [--waypoints W] [--suite]
                                     [--backend grid|xla|pallas|cpu] [--verbose]

Counterpart of the reference's bench.py, without JAX.  ``build_problem``
builds the same problem as bench.py:33-143 for the grid backend, bit for
bit: N agents uniformly placed on an open field of density ``density``
agents/m^2, all walking to a goal edge (with W > 1, each to its own band
of it), one central obstacle.  The ``auto`` domain is the reference's
lane-exact rectangle, nx + 3 cell columns a multiple of 128 (1024 lanes
when the field keeps >= 16 cell rows; the reference's TPU-measured rule,
copied, not re-measured): at 1M agents and density 2.5, 1021 x 175 cells
of 1.5 m, K = 14.  ``square`` is the square field of the same area,
``tiles:T`` forces T x 128 lanes of width.  For ``--backend xla`` the
problem is the reference's xla one: always the square field, 1.4 m cells.

``main`` times the hybrid grid step (``make_step_grid(incremental=True)``,
the reference's default) as the reference's ``capture`` does: windows of
``steps // 4`` steps, each fenced by fetching ``metrics.n_active``, 4
windows a round, at least 2 rounds, more while a round beats the best by
over 15%; the best window is the step time.  It prints ONE JSON line:

    {"metric": "agent_steps_per_sec", "value": ..., "unit": "agent-steps/s",
     "vs_baseline": value / 1e9, "ms_per_step": ..., "method": ...,
     "rounds": ..., "waypoints": ..., "device": "<name>, <power limit>"}

or, with ``--suite``, three such lines with a ``config`` tag each: the 1M
headline, 1M at 8 waypoints and 8M agents, the headline first.

``--backend grid`` (the default) runs on the CUDA card and exits 2 where
there is none; ``cpu`` runs the same path on the CPU through the kernels'
PyTorch twins.  ``--backend xla`` times the flat step (``models/sfm.py::
make_step``) and ``--backend pallas`` the pallas step (``models/
sfm_pallas.py::make_step_pallas``: flat agents through the fused step
kernel, the square field at 1.5 m as the reference builds it) on the
card, with the same timing contract and keys.  The reference's
``--allow-fallback`` and ``--chunk-size`` exit non-zero with the reason;
``--no-wp-skip`` is accepted and changes nothing (the port has no slot
walk to disable).  A configuration whose step does not fit the card's free
memory is refused before its grid or slot grid is allocated
(``sfm_grid.device_bytes`` or ``sfm_pallas.device_bytes``, ``check_fits``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from .convert import agents_from_numpy
from .field import Field, FieldMaps
from .models import sfm_grid, sfm_pallas
from .models.sfm import SimState, StepConfig, device_inputs, make_step
from .ops.kernels import launch_counts, zero_launch_counts
from .scenario import Scenario, Segment

# The reference's --suite (bench.py:293-298): (config tag, flag overrides).
SUITE = (
    ("headline_1M", {}),
    ("waypoints8_1M", {"waypoints": 8}),
    ("scale_8M", {"agents": 8_000_000}),
)
DEVICE_OF_BACKEND = {"grid": "cuda", "xla": "cuda", "pallas": "cuda",
                     "cpu": "cpu"}
# The reference's flags that the port refuses, and why.
REFUSED = {
    "--allow-fallback": "the port never falls back: a kernel that fails to "
                        "build or launch raises, so a regression cannot "
                        "re-label a slower backend's numbers",
    "--chunk-size": "no step reads it: the flat step's pair pass is sized by "
                    "a byte budget (ops/forcepass.py), the grid step's "
                    "blocks by --row-block",
}
def lane_tiles(domain: str) -> int | None:
    """T of ``tiles:T``, None for ``auto`` and ``square``; ValueError, with
    the reference's messages (bench.py:234-247), for anything else."""
    if domain.startswith("tiles:"):
        try:
            t = int(domain.split(":", 1)[1])
        except ValueError:
            t = 0
        if t < 1:
            raise ValueError(f"--domain tiles:T needs a positive integer T "
                             f"(got {domain!r})")
        return t
    if domain not in ("auto", "square"):
        raise ValueError(f"--domain must be auto, square, or tiles:T "
                         f"(got {domain!r})")
    return None


def build_problem(n_agents: int = 1_000_000, density: float = 2.5,
                  seed: int = 0, table_capacity: int = 14,
                  device: torch.device | str = "cuda", waypoints: int = 1,
                  domain: str = "auto", backend: str = "grid"
                  ) -> tuple[Scenario, FieldMaps, StepConfig, SimState]:
    """(scenario, maps, cfg, flat state on ``device``) of the bench
    workload; the domain is shaped and the agents drawn from ``seed`` with
    NumPy exactly as the reference's bench does for ``backend`` ("grid",
    "xla": the square field at 1.4 m, or "pallas": the square field at
    1.5 m, whatever ``domain`` says)."""
    tiles = lane_tiles(domain)
    area = n_agents / density
    unit = 1.5
    if backend in ("xla", "pallas"):
        unit = 1.4 if backend == "xla" else 1.5
        w = h = float(np.sqrt(area))
    elif tiles is not None:
        nx = tiles * 128 - 3
        w = nx * unit
        h = area / w
    elif domain == "auto":
        for t in range(8, 0, -1):
            nx = t * 128 - 3
            w = nx * unit
            h = area / w
            if h / unit >= 16 or t == 1:
                break
    else:
        w = h = float(np.sqrt(area))
    # W > 1: the goal edge split into W bands along y, each agent bound
    # for its own band's exit (evacuation.toml's nearest-exit shape).
    ys = np.linspace(1.0, h - 1.0, waypoints + 1)
    scenario = Scenario(
        size=(w, h),
        waypoints=tuple(
            Segment(line=((1.0, float(ys[i])), (1.0, float(ys[i + 1]))),
                    width=1.0)
            for i in range(waypoints)),
        obstacles=(
            Segment(line=((w / 2, h / 4), (w / 2, h / 2)), width=2.0),
        ),
        pedestrians=(),
    )
    maps = FieldMaps.from_field(Field.from_scenario(scenario, unit=0.25))

    capacity = 1
    while capacity < n_agents:
        capacity *= 2
    cfg = StepConfig.build(scenario, capacity=capacity, neighbor_grid_unit=unit,
                           table_capacity=table_capacity)

    rng = np.random.default_rng(seed)
    pos = np.stack([
        rng.uniform(2.0, w - 2.0, size=capacity),
        rng.uniform(2.0, h - 2.0, size=capacity),
    ], axis=1).astype(np.float32)
    speed = np.clip(rng.normal(1.34, 0.26, capacity), 0.1, None).astype(np.float32)
    if waypoints > 1:
        dest = np.clip(np.searchsorted(ys[1:-1], pos[:, 1]), 0,
                       waypoints - 1).astype(np.int32)
    else:
        dest = np.zeros((capacity,), np.int32)
    active = np.arange(capacity) < n_agents
    agents = agents_from_numpy(pos, np.zeros_like(pos), speed, dest, active,
                               device)
    return scenario, maps, cfg, SimState(agents=agents, step=0)


def device_label(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _log(args, msg: str) -> None:
    if args.verbose:
        print(msg, file=sys.stderr, flush=True)


def build(args: argparse.Namespace, device: torch.device):
    """(step, state, cfg) of one configuration: the hybrid grid step on the
    binned problem, or with ``--backend xla`` the flat step and with
    ``--backend pallas`` the pallas step on the flat agents (the reference's
    bench.py:146-190).  ``step(state) -> (state, metrics)``."""
    rb = args.row_block
    backend = args.backend if args.backend in ("xla", "pallas") else "grid"
    _scenario, maps, cfg, flat = build_problem(
        args.agents, args.density, args.seed, args.table_capacity, device,
        args.waypoints, args.domain, backend)
    if backend == "xla":
        field, obstacles = device_inputs(cfg, maps, device)
        raw_flat = make_step(cfg)  # the bench problem spawns nothing
        _log(args, f"# capacity={cfg.capacity}, grid {cfg.grid.nx} x "
                   f"{cfg.grid.ny} cells of {cfg.grid.unit} m, "
                   f"K={cfg.table_capacity}")
        return (lambda s: raw_flat(s, field.rows, obstacles)), flat, cfg
    if backend == "pallas":
        need = sfm_pallas.device_bytes(cfg, rb)
        sfm_grid.check_fits(need, device, what="the pallas step")
        fwp, fobs = sfm_pallas.pallas_device_inputs(cfg, maps, device,
                                                    row_block=rb)
        raw_pallas = sfm_pallas.make_step_pallas(cfg, row_block=rb)
        _log(args, f"# capacity={cfg.capacity}, grid {cfg.grid.nx} x "
                   f"{cfg.grid.ny} cells of {cfg.grid.unit} m, "
                   f"K={cfg.table_capacity}, device bytes of a step {need}")
        return (lambda s: raw_pallas(s, fwp, fobs)), flat, cfg
    need = sfm_grid.device_bytes(cfg, rb)
    sfm_grid.check_fits(need, device)  # before the grid and fields exist
    fwp, fobs = sfm_grid.field_tensors(cfg, maps, device, row_block=rb)
    state = sfm_grid.bin_state(cfg, flat, row_block=rb)
    del flat
    n_binned = int((state.d[:, :, 6] > 0.5).sum())
    raw_step = sfm_grid.make_step_grid(cfg, row_block=rb)
    _log(args, f"# capacity={cfg.capacity}, grid {cfg.grid.nx} x "
               f"{cfg.grid.ny} cells, K={cfg.table_capacity}, device bytes "
               f"of a step {need}")
    _log(args, f"# binned {n_binned} of {args.agents} agents "
               f"({args.agents - n_binned} beyond K={cfg.table_capacity} in "
               "their cells, dropped at binning as the reference does)")
    return (lambda s: raw_step(s, fwp, fobs)), state, cfg


def capture(args: argparse.Namespace) -> dict:
    """Build and time one configuration; returns the JSON record."""
    device = torch.device(DEVICE_OF_BACKEND[args.backend])
    t0 = time.perf_counter()
    step, state, _cfg = build(args, device)
    state, metrics = step(state)  # the kernels build at their first launch
    int(metrics.n_active)
    _log(args, f"# build: {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    for _ in range(args.warmup):
        state, metrics = step(state)
    n_warm = int(metrics.n_active)  # the fence: a scalar the steps produce
    _log(args, f"# warmup({args.warmup}): {time.perf_counter() - t0:.1f}s, "
               f"active={n_warm}")

    window = max(1, args.steps // 4)
    n_active = 0

    def measure_round() -> float:
        nonlocal state, n_active
        b = float("inf")
        for _ in range(4):
            t0 = time.perf_counter()
            for _ in range(window):
                state, metrics = step(state)
            n_active = int(metrics.n_active)  # fence before the clock
            b = min(b, (time.perf_counter() - t0) / window)
        return b

    # The reference's convergence rule: at least 2 rounds, more while a
    # round beats the best by > 15%, at most 6 or past 360 s.
    zero_launch_counts()
    best = float("inf")
    rounds = 0
    deadline = time.perf_counter() + 360.0
    while rounds < 6:
        b = measure_round()
        rounds += 1
        improved = b < best * 0.85
        best = min(best, b)
        _log(args, f"# round {rounds}: {b * 1000:.4f} ms/step")
        if not improved and rounds >= 2:
            break
        if rounds >= 2 and time.perf_counter() > deadline:
            break
        if improved and rounds >= 2:
            time.sleep(30.0 if b * window * 4 >= 1.0 else 1.0)
    _log(args, f"# launches {json.dumps(launch_counts())}")

    steps_per_sec = 1.0 / best
    agent_steps = n_active * steps_per_sec
    _log(args, f"# {best * 1000:.4f} ms/step (best of {rounds} rounds x 4 "
               f"windows x {window}), active={n_active}, "
               f"{steps_per_sec:.1f} steps/s")
    print(f"# backend={args.backend}", file=sys.stderr, flush=True)
    return {
        "metric": "agent_steps_per_sec",
        "value": agent_steps,
        "unit": "agent-steps/s",
        "vs_baseline": agent_steps / 1e9,
        "ms_per_step": best * 1000.0,
        "method": f"best-of-{rounds}-rounds x 4 windows x {window} steps",
        "rounds": rounds,
        "waypoints": args.waypoints,
        "device": device_label(device),
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m pedoni_tpu_torch.bench")
    ap.add_argument("--agents", type=int, default=1_000_000)
    ap.add_argument("--density", type=float, default=2.5, help="agents per m^2")
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--warmup", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="grid",
                    choices=["grid", "cpu", "pallas", "xla"],
                    help="grid = the grid step on the CUDA card (1.5 m "
                         "cells); xla = the flat step there (1.4 m cells, "
                         "square field); pallas = flat agents through the "
                         "step kernel there (1.5 m cells, square field); "
                         "cpu = the grid step on the CPU (PyTorch twins)")
    ap.add_argument("--allow-fallback", action="store_true",
                    help="refused: " + REFUSED["--allow-fallback"])
    ap.add_argument("--table-capacity", type=int, default=14,
                    help="slots per cell; agents beyond it are dropped at "
                         "binning and overflow counted each step")
    ap.add_argument("--row-block", type=int, default=2,
                    help="cell rows per metric block")
    ap.add_argument("--chunk-size", type=int, default=None,
                    help="refused: " + REFUSED["--chunk-size"])
    ap.add_argument("--waypoints", type=int, default=1,
                    help="destination count: W > 1 splits the goal edge "
                         "into W band exits with nearest-exit assignment")
    ap.add_argument("--no-wp-skip", action="store_true",
                    help="accepted and ignored: the port has no waypoint "
                         "slot walk to disable (each agent samples its own "
                         "plane), and the reference's tests hold it "
                         "bit-identical to the skip")
    ap.add_argument("--domain", default="auto",
                    help="auto = the reference's lane-exact rectangle; "
                         "square = the square field of the same area; "
                         "tiles:T = T 128-lane tiles of width")
    ap.add_argument("--suite", action="store_true",
                    help="three lines: the 1M headline, 1M at 8 waypoints "
                         "and 8M agents, each with a \"config\" tag")
    ap.add_argument("--verbose", action="store_true")
    return ap


def main(argv: list[str] | None = None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    try:
        lane_tiles(args.domain)
    except ValueError as e:
        ap.error(str(e))
    if args.domain != "auto" and args.backend in ("xla", "pallas"):
        ap.error(f"--domain {args.domain!r} has no effect with --backend "
                 f"{args.backend} (domain shaping is a grid-backend knob; "
                 f"the {args.backend} problem is always the square field)")
    for flag, on in (("--allow-fallback", args.allow_fallback),
                     ("--chunk-size", args.chunk_size is not None)):
        if on:
            ap.error(f"{flag} is refused: {REFUSED[flag]}")
    if (DEVICE_OF_BACKEND[args.backend] == "cuda"
            and not torch.cuda.is_available()):
        print(f"FATAL: --backend {args.backend} needs a CUDA device and "
              "torch.cuda.is_available() is False; the bench does not run "
              "on the CPU instead (--backend cpu does, on purpose)",
              file=sys.stderr)
        return 2

    if args.suite:
        for tag, over in SUITE:
            sub = argparse.Namespace(**{**vars(args), "suite": False, **over})
            print(json.dumps({**capture(sub), "config": tag}), flush=True)
        return 0
    print(json.dumps(capture(args)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
