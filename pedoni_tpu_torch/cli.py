"""Command-line interface, headless mode.

The parser is the reference's (pedoni_tpu/cli.py:31-98, itself the
pedoni args.rs:12-44 flag set plus seed, capacity and backend); headless
mode reproduces ``run_headless`` / ``_headless_loop`` (:161-289): run the
simulation, log every 100 steps, write checkpoints every
``--checkpoint-every`` steps, and on SIGINT or ``--max-steps`` write the
JSON diagnostic log to ``<log-dir>/<timestamp>_log.json``.

    python -m pedoni_tpu_torch scenario.toml -H --max-steps 1000 -s 0

Backends: ``auto``, ``grid`` and ``pallas`` run the grid backend on the
CUDA card; ``cpu`` runs it on the CPU through the kernels' PyTorch twins.
This diverges from the reference, whose ``auto`` is its XLA backend at the
1.4 m unit: the port has no flat backend yet, so ``-b xla`` (and ``-b tpu``)
exit non-zero (ROADMAP queue 1, item 9).  ``--devices N`` and ``--tile RxC``
cut the grid into tiles (parallel/tile2d.py), with the reference's parsing
and messages: on the card tile i runs on cuda:i (more devices than the
machine has exit non-zero, naming the count); with ``-b cpu`` every tile
runs on the CPU.  The non-headless mode, ``--render``,
``--render-web``, ``--record-every``, ``--frame-every`` and ``--profile``
exit non-zero too (item 8: they need the renderer, the web view, the
trajectory writer and a profiler trace, not ported yet).  No flag falls
back silently.
"""

from __future__ import annotations

import argparse
import datetime
import logging
import signal
import time
from pathlib import Path

from .checkpoint import restore, save
from .physics import Physics
from .scenario import load_scenario
from .sim import Simulator, SimulatorOptions

log = logging.getLogger("pedoni_tpu_torch")

DEFAULT_SCENARIO = Path(__file__).resolve().parents[1] / "scenarios" / "default.toml"
DEVICE_OF_BACKEND = {"auto": "cuda", "grid": "cuda", "pallas": "cuda", "cpu": "cpu"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pedoni-tpu-torch",
        description="social-force crowd simulator on one NVIDIA GPU")
    p.add_argument("scenario", nargs="?", default=str(DEFAULT_SCENARIO),
                   help="path to scenario TOML (args.rs:14)")
    p.add_argument("-H", "--headless", action="store_true",
                   help="run headless (args.rs:17)")
    p.add_argument("-b", "--backend", default="auto",
                   choices=["auto", "cpu", "tpu", "xla", "pallas", "grid"],
                   help="auto/grid/pallas = the grid backend on the CUDA card; "
                        "cpu = the same on the CPU (PyTorch twins); xla and "
                        "tpu are not ported")
    p.add_argument("--devices", type=int, default=1, metavar="N",
                   help="cut the grid into N row strips, one a device")
    p.add_argument("--tile", default=None, metavar="RxC",
                   help="2D device tiling: R x C tiles, one a device "
                        "(--tile alone implies --devices R*C)")
    p.add_argument("-s", "--speed", type=float, default=100.0,
                   help="max playback speed multiple of real time (args.rs:23-24)")
    p.add_argument("--no-neighbor-grid", action="store_true",
                   help="all-pairs interactions: the cell unit grows to cover "
                        "the cutoff (args.rs:27-28)")
    p.add_argument("--no-distance-map", action="store_true",
                   help="use exact per-segment obstacle forces (args.rs:30-31)")
    p.add_argument("--field-unit", type=float, default=0.25,
                   help="field grid cell size in meters (args.rs:33-34)")
    p.add_argument("--neighbor-unit", type=float, default=1.4,
                   help="neighbor grid cell size in meters (args.rs:36-37); "
                        "1.4 runs as 1.5 (the stride-6 field layout)")
    p.add_argument("--work-size", type=int, default=2048,
                   help="agent slots per dispatch block (args.rs:39-40 "
                        "analog; sets row_block = work-size/1024 cell rows, "
                        "clamped to [1, 8])")
    p.add_argument("--max-steps", type=int, default=None,
                   help="stop after this many steps, headless only (args.rs:42-43)")
    p.add_argument("--seed", type=int, default=0, help="generator seed")
    p.add_argument("--capacity", type=int, default=0,
                   help="agent capacity; 0 = auto")
    p.add_argument("--table-capacity", type=int, default=16,
                   help="max agents per neighbor cell")
    p.add_argument("--log-dir", default="logs", help="diagnostic log directory")
    p.add_argument("--render", action="store_true",
                   help="live terminal rendering (not ported)")
    p.add_argument("--render-web", type=int, nargs="?", const=8000,
                   default=None, metavar="PORT",
                   help="browser live view (not ported)")
    p.add_argument("--render-web-host", default="127.0.0.1", metavar="ADDR",
                   help="bind address for --render-web (not ported)")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="write a checkpoint every N steps")
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--resume", default=None,
                   help="resume from a checkpoint file (either package's)")
    p.add_argument("--record-every", type=int, default=0, metavar="N",
                   help="trajectory dumps (not ported)")
    p.add_argument("--frame-every", type=int, default=0, metavar="N",
                   help="PNG frames (not ported)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="profiler trace (not ported)")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def _refuse_unported(args: argparse.Namespace) -> None:
    """Exit non-zero, naming the ROADMAP item, on what the port lacks."""
    if args.backend in ("xla", "tpu"):
        raise SystemExit(f"-b {args.backend} is not ported: the port runs the "
                         "grid backend only (-b auto|grid|pallas on the card, "
                         "-b cpu on the CPU); the flat backend is ROADMAP "
                         "queue 1, item 9")
    for flag, on in (("--render", args.render),
                     ("--render-web", args.render_web is not None),
                     ("--record-every", args.record_every),
                     ("--frame-every", args.frame_every),
                     ("--profile", args.profile),
                     ("the non-headless mode (no -H)", not args.headless)):
        if on:
            raise SystemExit(f"{flag} is not ported: it needs the renderer, the "
                             "web view, the trajectory writer or a profiler "
                             "trace (ROADMAP queue 1, item 8)")


def _tiles(args: argparse.Namespace) -> tuple[int, tuple[int, int] | None]:
    """(n_devices, tile) of --devices and --tile, as the reference parses
    them (pedoni_tpu/cli.py:107-125)."""
    tile = None
    n_devices = args.devices
    if args.tile:
        parts = args.tile.lower().split("x")
        try:
            r, c = (int(p) for p in parts)
        except ValueError:  # wrong count or non-integer parts
            r = c = 0
        if r < 1 or c < 1:
            raise SystemExit(
                f"--tile must be RxC with positive integers, got {args.tile!r}")
        tile = (r, c)
        if n_devices == 1:
            n_devices = r * c  # --tile 4x2 alone implies --devices 8
        elif n_devices != r * c:
            raise SystemExit(
                f"--tile {r}x{c} does not cover --devices {n_devices}")
    return n_devices, tile


def make_simulator(args: argparse.Namespace) -> Simulator:
    n_devices, tile = _tiles(args)
    options = SimulatorOptions(
        neighbor_grid_unit=args.neighbor_unit,
        field_grid_unit=args.field_unit,
        use_neighbor_grid=not args.no_neighbor_grid,
        use_distance_map=not args.no_distance_map,
        table_capacity=args.table_capacity,
        chunk_size=args.work_size,
        capacity=args.capacity,
        seed=args.seed,
        physics=Physics(),
        n_devices=n_devices,
        tile=tile,
        device=DEVICE_OF_BACKEND[args.backend],
    )
    return Simulator(options, load_scenario(args.scenario))


def run_headless(args: argparse.Namespace) -> Path:
    _refuse_unported(args)
    sim = make_simulator(args)
    if args.resume:
        restore(sim, args.resume)
        log.info("resumed from %s at step %d", args.resume, sim.step_count)
    diag = sim.new_log(scenario_name=str(args.scenario))

    interrupted: list[bool] = []
    previous = signal.signal(signal.SIGINT, lambda *a: interrupted.append(True))
    dt = sim.options.physics.delta_time
    min_interval = dt / args.speed if args.speed > 0 else 0.0
    try:
        _headless_loop(args, sim, diag, interrupted, min_interval)
    finally:
        signal.signal(signal.SIGINT, previous)

    ts = datetime.datetime.now().strftime("%Y-%m-%d_%H%M%S")
    out = Path(args.log_dir) / f"{ts}_log.json"
    diag.write(out)
    log.info("Exported log file: %s", out)
    return out


def _headless_loop(args, sim, diag, interrupted, min_interval) -> None:
    while not interrupted:
        start = time.perf_counter()
        rec = sim.tick()
        diag.push(rec)
        if sim.step_count % 100 == 0:
            log.info("Step: %6d, Active pedestrians: %6d",
                     sim.step_count, rec.active_ped_count)
        if args.checkpoint_every and sim.step_count % args.checkpoint_every == 0:
            save(sim, Path(args.checkpoint_dir) / f"step_{sim.step_count:08d}.npz")
        if args.max_steps is not None and diag.total_steps >= args.max_steps:
            break
        elapsed = time.perf_counter() - start
        if elapsed < min_interval:
            time.sleep(min_interval - elapsed)


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="[%(asctime)s %(levelname)s %(name)s] %(message)s",
    )
    run_headless(args)
    return 0
