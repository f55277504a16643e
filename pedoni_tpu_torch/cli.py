"""Command-line interface.

The parser is the reference's (pedoni_tpu/cli.py:31-98, itself the
pedoni args.rs:12-44 flag set plus seed, capacity and backend), and
``run_headless`` / ``_headless_loop`` are its (:161-289): run the
simulation, log every 100 steps, write checkpoints every
``--checkpoint-every`` steps, trajectory frames (``<log-dir>/traj.bin``)
every ``--record-every`` and PNG frames every ``--frame-every`` steps,
draw the terminal view (``--render``) and serve the browser view
(``--render-web``, whose pause the loop honours) from a snapshot thread,
record a ``torch.profiler`` trace into ``--profile DIR`` (with the
program's spans, ``utils/trace.py``, and the kernels' and the spawn's own
times every 100th step), and on SIGINT or
``--max-steps`` write the JSON diagnostic log to
``<log-dir>/<timestamp>_log.json``.  Without ``-H`` the terminal view is
on and the run stops after 100000 steps unless ``--max-steps`` says
otherwise.

    python -m pedoni_tpu_torch scenario.toml -H --max-steps 1000 -s 0

Backends follow the reference's ``make_simulator`` (its cli.py:101-158):
``auto``, ``xla`` and ``tpu`` run the flat backend at the 1.4 m unit on the
CUDA card, ``pallas`` the pallas backend (flat agents through the fused
step kernel) and ``grid`` the grid backend at 1.5 m there, and ``cpu`` the
flat backend on the CPU.  ``--devices N`` and ``--tile RxC`` cut the grid
into tiles (parallel/tile2d.py), with the reference's parsing and
messages: ``auto`` then runs the grid backend, and any other backend but
``grid`` exits non-zero; on the card tile i runs on cuda:i (more devices
than the machine has exit non-zero, naming the count).  No flag falls
back silently.
"""

from __future__ import annotations

import argparse
import datetime
import logging
import signal
import time
from pathlib import Path

import torch

from .checkpoint import restore, save
from .frames import save_frame
from .native import TrajectoryWriter
from .physics import Physics
from .scenario import load_scenario
from .sim import Simulator, SimulatorOptions
from .utils import trace

log = logging.getLogger("pedoni_tpu_torch")

DEFAULT_SCENARIO = Path(__file__).resolve().parents[1] / "scenarios" / "default.toml"
# -b -> (the Simulator's backend, its device)
BACKENDS = {"auto": ("xla", "cuda"), "xla": ("xla", "cuda"),
            "tpu": ("xla", "cuda"), "grid": ("grid", "cuda"),
            "pallas": ("pallas", "cuda"), "cpu": ("xla", "cpu")}


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
                   help="auto/xla/tpu = the flat backend (1.4 m cells) on "
                        "the CUDA card, or the grid backend with --devices/"
                        "--tile > 1 (auto); grid = the grid backend (1.5 m "
                        "cells) there; pallas = flat agents through the step "
                        "kernel (1.5 m cells) there; cpu = the flat backend "
                        "on the CPU")
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
                        "the grid backend runs 1.4 as 1.5 (the stride-6 "
                        "field layout)")
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
                   help="live terminal rendering while running (Space "
                        "pauses, q quits, arrows and +/-/0 move the camera)")
    p.add_argument("--render-web", type=int, nargs="?", const=8000,
                   default=None, metavar="PORT",
                   help="serve a browser live view on PORT (default 8000): "
                        "drag-pan, scroll-zoom, Space pause "
                        "(renderer/mod.rs:54-63,121-168)")
    p.add_argument("--render-web-host", default="127.0.0.1", metavar="ADDR",
                   help="bind address for --render-web; use 0.0.0.0 to "
                        "expose the (unauthenticated) viewer beyond this "
                        "machine")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="write a checkpoint every N steps")
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--resume", default=None,
                   help="resume from a checkpoint file (either package's)")
    p.add_argument("--record-every", type=int, default=0, metavar="N",
                   help="append agent positions to <log-dir>/traj.bin every "
                        "N steps (native.read_trajectory reads it)")
    p.add_argument("--frame-every", type=int, default=0, metavar="N",
                   help="render a PNG frame every N steps into <log-dir> "
                        "(matplotlib's, or a plain raster without it)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="record a torch.profiler trace of the run into DIR "
                        "(<timestamp>_trace.json, CPU and CUDA activities, "
                        "the tick's and the step's phases as named ranges), "
                        "and the kernels' and the spawn's own times every "
                        "100th step")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


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


def options_from_args(args: argparse.Namespace) -> SimulatorOptions:
    """The Simulator's options for parsed arguments (the reference's
    ``make_simulator``, cli.py:101-158): the backend and device of ``-b``,
    the grid's 1.5 m unit in place of the default 1.4, and tiles, which
    ``auto`` runs on the grid backend and an explicit flat one refuses."""
    n_devices, tile = _tiles(args)
    backend, device = BACKENDS[args.backend]
    if n_devices > 1 and backend != "grid":
        if args.backend != "auto":
            raise SystemExit(f"--devices {n_devices} requires the grid "
                             f"backend; drop '-b {args.backend}' or pass "
                             "'-b grid'")
        backend = "grid"  # auto: tiles run on the grid backend
    neighbor_unit = args.neighbor_unit
    if backend in ("pallas", "grid") and neighbor_unit == 1.4:
        neighbor_unit = 1.5  # the step kernel's stride-6 field layout
    return SimulatorOptions(
        backend=backend,
        neighbor_grid_unit=neighbor_unit,
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
        device=device,
    )


def make_simulator(args: argparse.Namespace) -> Simulator:
    return Simulator(options_from_args(args), load_scenario(args.scenario))


def run_headless(args: argparse.Namespace) -> Path:
    sim = make_simulator(args)
    if args.resume:
        restore(sim, args.resume)
        log.info("resumed from %s at step %d", args.resume, sim.step_count)
    diag = sim.new_log(scenario_name=str(args.scenario))

    interrupted: list[bool] = []
    previous = signal.signal(signal.SIGINT, lambda *a: interrupted.append(True))
    renderer = keys = stream = viewer = profiler = writer = None
    try:
        if args.render_web is not None:
            from .webview import WebViewer

            viewer = WebViewer(sim.scenario, fetch=sim.list_pedestrians,
                               port=args.render_web,
                               host=args.render_web_host).start()
            log.info("web view: %s", viewer.url)
            print(f"web view: {viewer.url}", flush=True)
        if args.render:
            from .renderer import KeyPoller, SnapshotStream, TerminalRenderer

            renderer = TerminalRenderer(sim.scenario)
            keys = KeyPoller()  # SPACE toggles pause (renderer/mod.rs:121-136)
            # frames are fetched on a thread of their own (the reference's
            # sim-thread / render-thread split, main.rs:20-26, 94-96); it
            # enqueues on the same stream as the steps, so it reads whole
            # states
            stream = SnapshotStream(
                fetch=sim.list_pedestrians,
                on_frame=lambda pos, dest: renderer.draw(pos, dest,
                                                         sim.step_count),
            ).start()
        dt = sim.options.physics.delta_time
        min_interval = dt / args.speed if args.speed > 0 else 0.0
        if args.record_every:
            writer = TrajectoryWriter(Path(args.log_dir) / "traj.bin")
        if args.profile:
            profiler = _start_profiler(sim.device)
        _headless_loop(args, sim, diag, interrupted, min_interval, renderer,
                       keys, viewer, writer)
    finally:
        signal.signal(signal.SIGINT, previous)
        if viewer is not None:
            viewer.stop()
        if stream is not None:
            stream.stop()
        if keys is not None:
            keys.restore()  # never leave the tty in cbreak/no-echo
        if writer is not None:
            writer.close()  # drain the async writer queue
        if profiler is not None:
            profiler.stop()
            trace.enable(False)

    ts = datetime.datetime.now().strftime("%Y-%m-%d_%H%M%S")
    if profiler is not None:
        trace_path = Path(args.profile) / f"{ts}_trace.json"
        trace_path.parent.mkdir(parents=True, exist_ok=True)
        profiler.export_chrome_trace(str(trace_path))
        log.info("profiler trace written to %s", trace_path)
    out = Path(args.log_dir) / f"{ts}_log.json"
    diag.write(out)
    log.info("Exported log file: %s", out)
    return out


def _start_profiler(device: torch.device) -> torch.profiler.profile:
    """A started ``torch.profiler`` over the host and, on a CUDA device,
    the card (where the reference starts ``jax.profiler``), with the
    program's spans on (``utils/trace.py``: the tick's and the step's
    phases): it keeps every event in memory until the run ends."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    trace.enable(True)
    return profiler


def _headless_loop(args, sim, diag, interrupted, min_interval, renderer=None,
                   keys=None, viewer=None, writer=None) -> None:
    paused = False
    while not interrupted:
        start = time.perf_counter()
        if keys is not None:
            for ch in keys.poll():
                if ch == " ":
                    paused = not paused
                elif ch in ("q", "Q"):
                    interrupted.append(True)
                elif renderer is not None:
                    renderer.handle_key(ch)  # camera pan/zoom
        if paused or (viewer is not None and viewer.paused):
            time.sleep(0.05)
            continue
        rec = sim.tick()
        if args.profile and sim.step_count % 100 == 1:
            # the kernels' and the spawn's own device time (the diagnostic
            # slots the reference measured and discarded, sfm_gpu.rs:229-236)
            rec.time_calc_state_kernel = sim.measure_kernel_time()
            t_spawn = sim.measure_spawn_time()
            if t_spawn is not None:
                rec.time_spawn = t_spawn
        diag.push(rec)
        if viewer is not None:
            viewer.set_step(sim.step_count)
        if sim.step_count % 100 == 0:
            log.info("Step: %6d, Active pedestrians: %6d",
                     sim.step_count, rec.active_ped_count)
        if writer is not None and sim.step_count % args.record_every == 0:
            pos, dest = sim.list_pedestrians()
            writer.append(sim.step_count, pos, dest)
        if args.frame_every and sim.step_count % args.frame_every == 0:
            pos, dest = sim.list_pedestrians()
            out_dir = Path(args.log_dir)
            out_dir.mkdir(parents=True, exist_ok=True)
            save_frame(sim.scenario, pos, dest,
                       str(out_dir / f"frame_{sim.step_count:08d}.png"))
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
    if not args.headless:  # the terminal view in place of the reference's GUI
        args.render = True
        args.max_steps = args.max_steps or 100000
    run_headless(args)
    return 0
