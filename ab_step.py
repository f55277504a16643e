#!/usr/bin/env python
"""Time the step and rebin kernels of two checkouts in turns on one NVIDIA GPU.

    python ab_step.py --parent DIR

``DIR`` holds another checkout of this repository (``git archive <commit>
| tar -x -C DIR``).  Each tree runs in a process of its own, in the order
parent, change, change, parent, so that both see the same card and the
drift between turns shows.  A turn builds that tree's kernels, sets up the
1M-agent bench problem, runs the full-rebin path and the hybrid for
chip_smoke.py's warm-up and timed steps (host clock around a synchronised
run), and times the kernels on each path's final state with chip_smoke.py's
``_median_ms``: ``fused_step`` in base mode and ``rebin`` on its output on
the full path's, ``fused_step`` in mover mode and ``rebin_incremental`` on
its output on the hybrid's.  Then, at the 1.5 m unit only: the step kernel in
segment mode (--no-distance-map) on the full path's state with the bench's
one obstacle, on the state of scenarios/random.toml (1000 obstacles)
after chip_smoke.py's ticks through ``Simulator(use_distance_map=False)``
and on funnel.toml's and default.toml's (4 and 3 obstacles) after
CROSSOVER_TICKS ticks, and the standalone pairwise kernel (2D) on the full
path's state with chip_smoke.py's seeded unit vectors in ch 4/5.  Each tree
makes random.toml's state with its own simulator, so the turns print a hash
of it and also time the kernel on the first turn's state
(``random_toml_common_segments_ms``).  Then the
same again for the
same agents at the all-pairs unit (2.0 m cells, K 25, field stride 8; keys
``all_pairs_*``).

Prints one JSON line per turn and a summary with the card's name and power
limit.  Exits non-zero without a CUDA device.

    python ab_step.py --crossover

times, in this checkout alone, where segment mode should walk its edge
table: the step kernel with the sample pass walking every row against
the pair pass culling it per tile (chip_smoke.py's ``_segment_walk``),
both checked bit-equal, at table sizes from 1 row up:
on the 1M bench state (rows spread over its field as scenarios/generate.py
spreads them), on random.toml's state after chip_smoke.py's ticks (its
first n rows), on funnel.toml's state at its own agent count (its 4 rows,
then more spread over its field), and on default.toml's and
room-evac.toml's states with their own 3 rows.  One JSON line per state.

    python ab_step.py --density

times, in this checkout alone, the grid step's two rebin paths against
the bench problem's density, the counterpart of the reference's
scripts/ab_incremental_rebin.py --density: 1M agents of
``bench.build_problem`` at each of DENSITIES agents/m^2 (0.78 is the
expected occupancy lambda = 1.75 a 1.5 m cell, where
``Simulator._resolve_incremental`` switches to the hybrid), K = max(14,
ceil(2.5 lambda)).  The full path (``incremental=False``) and the hybrid
run in turns, full, hybrid, hybrid, full, each for chip_smoke.py's
warm-up and timed steps (wall ms/step, the kernels' launches a step);
then the same turns again with PROFILE_STEPS steps under torch.profiler
after the warm-up (device ms/step, device launches a step), after every
wall-clock turn of every density, since a profiler once started slows
the host's launches for the rest of the process.  Also the binned agents,
the hybrid's share of full-rebin steps and its mover share (the agents
that leave their cell in a step, from one mover-mode step kernel on the
hybrid's last state).  One JSON line per density, then a summary that
names the card and its power limit and the densities where the hybrid's
device time is below the full path's.

    python ab_step.py --parent DIR --flat-paths

times, in the same turns, the paths that place flat agents into cells
instead: chip_smoke.py's 1M flat (xla) and 1M pallas measurements
(phases 15 and 16), the 1M xla problem in 2 x-strips on one card
(phase 18's cut), host-clock and profiled device ms/step, launches a step
and peak memory; and, as a control, the grid step's full path and hybrid
on the 1M bench problem (chip_smoke.py step 4), profiled device ms/step.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import pathlib
import statistics
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
CROSSOVER_TICKS = 300  # ticks before a shipped scenario's state is timed
# random.toml's state as the first turn left it, for the later turns' kernels
COMMON_STATE = HERE / ".scratch" / "ab_random_toml_state.pt"
FLAT_PATH_KEYS = ("ms_per_step", "device_ms_per_step", "launches_per_step",
                  "peak_bytes")
GRID_PATHS = ("full", "hybrid")  # the --flat-paths control, device ms/step
# agents/m^2 of the --density sweep: the reference's 0.5 / 1.0 / 2.5 / 5.0,
# the switch of the auto rule (0.78: lambda = 1.75 at 1.5 m) and 1.5
DENSITIES = (0.5, 0.78, 1.0, 1.5, 2.5, 5.0)
TURNS = ("full", "hybrid", "hybrid", "full")


def worker(tree: str) -> int:
    """One turn, in the tree given: prints its JSON line.  The timing
    helpers are this checkout's chip_smoke.py's for both trees; the port
    under test is ``tree``'s."""
    import torch

    import chip_smoke  # before the path changes: this checkout's
    sys.path[:] = [tree] + [p for p in sys.path if p not in ("", str(HERE))]

    from pedoni_tpu_torch import Simulator, SimulatorOptions, load_scenario
    from pedoni_tpu_torch.bench import build_problem
    from pedoni_tpu_torch.models import sfm_grid
    from pedoni_tpu_torch.models.sfm import StepConfig
    from pedoni_tpu_torch.ops.kernels import _build
    from pedoni_tpu_torch.ops.kernels import pairwise as pw
    from pedoni_tpu_torch.ops.kernels import rebin as rb
    from pedoni_tpu_torch.ops.kernels import step_kernel as sk

    dev = torch.device("cuda")
    _build.library()
    scenario, maps, cfg, flat = build_problem(chip_smoke.N_AGENTS, device=dev)
    # the same agents at the all-pairs unit (2.0 m, K 25, field stride 8)
    o = SimulatorOptions(backend="grid", neighbor_grid_unit=1.5, table_capacity=14,
                         use_neighbor_grid=False).resolved()
    wide = StepConfig.build(scenario, capacity=cfg.capacity,
                            neighbor_grid_unit=o.neighbor_grid_unit,
                            table_capacity=o.table_capacity,
                            use_neighbor_grid=False)
    res = {"tree": tree}
    for prefix, c in (("", cfg), ("all_pairs_", wide)):
        fwp, fobs = sfm_grid.field_tensors(c, maps, dev)
        phys, size, stride = c.physics, c.scenario.size, sfm_grid.stride_for(c)
        states = {}
        for name, incremental in (("full", False), ("hybrid", True)):
            step = sfm_grid.make_step_grid(c, incremental=incremental)
            gs, m, ms = chip_smoke._run_timed(step, sfm_grid.bin_state(c, flat),
                                              fwp, fobs)
            res[f"{prefix}{name}_ms_per_step"] = ms
            res[f"{prefix}{name}_active"] = int(m.n_active)
            states[name] = gs.d

        def fused(name, **kw):
            return sk.fused_step(states[name], fwp, fobs, phys, size,
                                 stride=stride, **kw)

        unit, nx, ny = c.grid.unit, c.grid.nx, c.grid.ny
        g = fused("full")
        g_mv, m_mv = fused("hybrid", emit_movers=8)[:2]
        for key, fn in (
                ("step_kernel_ms", lambda: fused("full")),
                ("step_kernel_movers_ms", lambda: fused("hybrid", emit_movers=8)),
                ("rebin_ms", lambda: rb.rebin(g, unit, nx, ny)),
                ("rebin_incremental_ms",
                 lambda: rb.rebin_incremental(g_mv, m_mv, unit, nx, ny))):
            res[prefix + key] = chip_smoke._median_ms(fn)
        if prefix:
            continue
        # segment mode on the 1M state and on random.toml's; 2D on the 1M state
        segs = sfm_grid.debug_segments(dataclasses.replace(c, use_distance_map=False),
                                       dev)
        res["step_kernel_segments_ms"] = chip_smoke._median_ms(
            lambda: fused("full", segments=segs))
        sim = Simulator(SimulatorOptions(backend="grid", device="cuda", seed=1,
                                         use_distance_map=False),
                        load_scenario(chip_smoke.RANDOM))
        for _ in range(chip_smoke.RANDOM_STEPS):
            sim.tick()
        rsegs = sfm_grid.debug_segments(sim.cfg, dev)
        rd, rstride = sim.state.d, sfm_grid.stride_for(sim.cfg)
        res["random_toml_active"] = int((rd[:, :, 6] > 0.5).sum())
        # whether both trees time the kernel on the same state
        res["random_toml_state"] = (f"{tuple(rd.shape)} sha256 " + hashlib.sha256(
            rd.cpu().numpy().tobytes()).hexdigest()[:16])
        res["random_toml_segments_ms"] = chip_smoke._median_ms(
            lambda: sk.fused_step(rd, sim._fwp, sim._fobs, sim.cfg.physics,
                                  sim.cfg.scenario.size, stride=rstride,
                                  segments=rsegs))
        # the same kernel on the first turn's state, whichever tree made it
        if not COMMON_STATE.exists():
            COMMON_STATE.parent.mkdir(parents=True, exist_ok=True)
            torch.save(rd.cpu(), COMMON_STATE)
        rc = torch.load(COMMON_STATE).to(dev)
        res["random_toml_common_segments_ms"] = chip_smoke._median_ms(
            lambda: sk.fused_step(rc, sim._fwp, sim._fobs, sim.cfg.physics,
                                  sim.cfg.scenario.size, stride=rstride,
                                  segments=rsegs))
        for name in ("funnel", "default"):  # shipped tables of 4 and 3 rows
            ssim = Simulator(SimulatorOptions(backend="grid", device="cuda", seed=1,
                                              use_distance_map=False),
                             load_scenario(HERE / "scenarios" / f"{name}.toml"))
            for _ in range(CROSSOVER_TICKS):
                ssim.tick()
            ssegs = sfm_grid.debug_segments(ssim.cfg, dev)
            res[f"{name}_toml_segments_ms"] = chip_smoke._median_ms(
                lambda: sk.fused_step(ssim.state.d, ssim._fwp, ssim._fobs,
                                      ssim.cfg.physics, ssim.cfg.scenario.size,
                                      stride=sfm_grid.stride_for(ssim.cfg),
                                      segments=ssegs))
        d2 = states["full"].clone()
        gen = torch.Generator(device=dev).manual_seed(7)
        e = torch.randn((d2.shape[0], d2.shape[1], 2, d2.shape[3]),
                        generator=gen, device=dev)
        d2[:, :, 4:6] = e / e.norm(dim=2, keepdim=True)
        res["pairwise_ms"] = chip_smoke._median_ms(lambda: pw.pairwise(d2, phys, 2))
    print(json.dumps(res), flush=True)
    return 0


def worker_flat_paths(tree: str) -> int:
    """One --flat-paths turn, in the tree given: chip_smoke.py's 1M flat and
    pallas measurements (this checkout's helpers, ``tree``'s port);
    prints their JSON line."""
    import torch

    import chip_smoke  # before the path changes: this checkout's
    sys.path[:] = [tree] + [p for p in sys.path if p not in ("", str(HERE))]

    from pedoni_tpu_torch.ops.kernels import _build

    dev, card = torch.device("cuda"), chip_smoke._card()
    _build.library()
    res = {"tree": tree}
    for name, measure in (("flat", chip_smoke._flat_1m),
                          ("pallas", chip_smoke._pallas_1m),
                          ("strips", _strips_1m)):
        got = measure(dev, card)
        for key in FLAT_PATH_KEYS:
            res[f"{name}_{key}"] = got[key]
        torch.cuda.empty_cache()
    res.update(_grid_1m(dev, card))
    print(json.dumps(res), flush=True)
    return 0


def _strips_1m(dev, card) -> dict:
    """The 1M xla problem in 2 x-strips on one card (chip_smoke.py phase
    18's cut): chip_smoke.py's flat warm-up and timed steps on the host
    clock, peak memory above the strips' state, then its flat profile
    steps under torch.profiler: device ms/step and launches a step."""
    import time

    import torch

    import chip_smoke
    from pedoni_tpu_torch.bench import build_problem
    from pedoni_tpu_torch.models import sfm
    from pedoni_tpu_torch.parallel import spatial

    _sc, maps, cfg, flat = build_problem(chip_smoke.N_AGENTS, device=dev,
                                         backend="xla")
    devices = [dev, dev]
    scfg = spatial.ShardedConfig.build(cfg, len(devices))
    srows, sobs = spatial.device_inputs(scfg, maps, devices)
    ss = spatial.shard_state(scfg, flat, devices)
    del flat
    step = spatial.make_sharded_step(scfg, devices)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(chip_smoke.FLAT_WARMUP):
        ss = step(ss, srows, sobs)[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(chip_smoke.FLAT_TIMED):
        ss = step(ss, srows, sobs)[0]
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / chip_smoke.FLAT_TIMED * 1e3
    peak = torch.cuda.max_memory_allocated() - base
    box = [ss]

    def run():
        box[0] = step(box[0], srows, sobs)[0]

    us, launches = chip_smoke._profile_counts(run, chip_smoke.FLAT_PROFILE_STEPS)
    dev_ms = sum(us.values()) / 1e3
    n_active = sum(int(a.active.sum()) for a in box[0].agents)
    print(f"# 1M xla problem in 2 strips on one card: {wall:.4f} ms/step wall, "
          f"{dev_ms:.4f} device, {sum(launches.values()):.1f} launches a step, "
          f"{n_active} active, peak {peak} bytes above the state on {card}",
          file=sys.stderr, flush=True)
    return {"ms_per_step": wall, "device_ms_per_step": dev_ms,
            "launches_per_step": sum(launches.values()), "peak_bytes": peak}


def _grid_1m(dev, card) -> dict:
    """The grid step on the 1M bench problem, full path and hybrid
    (chip_smoke.py step 4): its warm-up steps, then PROFILE_STEPS under
    torch.profiler; device ms/step of each."""
    import torch

    import chip_smoke
    from pedoni_tpu_torch.bench import build_problem
    from pedoni_tpu_torch.models import sfm_grid

    _sc, maps, cfg, flat = build_problem(chip_smoke.N_AGENTS, device=dev)
    fwp, fobs = sfm_grid.field_tensors(cfg, maps, dev)
    gs0 = sfm_grid.bin_state(cfg, flat)
    del flat
    out = {}
    for name in GRID_PATHS:
        step = sfm_grid.make_step_grid(cfg, incremental=name == "hybrid")
        gs = gs0
        for _ in range(chip_smoke.WARMUP):
            gs = step(gs, fwp, fobs)[0]
        box = [gs]

        def run():
            box[0] = step(box[0], fwp, fobs)[0]

        us, _ = chip_smoke._profile_counts(run, chip_smoke.PROFILE_STEPS)
        out[f"grid_{name}_device_ms_per_step"] = sum(us.values()) / 1e3
    return out


def _spread_rows(n: int, size, seed: int) -> list[tuple]:
    """n obstacles as scenarios/generate.py draws them (centre uniform 3 m
    inside the field, length 1-6 m, any angle, width 0.3-1.5 m)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        x, y = rng.uniform(3.0, size[0] - 3.0), rng.uniform(3.0, size[1] - 3.0)
        half = rng.uniform(1.0, 6.0) / 2
        a = rng.uniform(0.0, 6.28318)
        dx, dy = np.cos(a) * half, np.sin(a) * half
        rows.append((x - dx, y - dy, x + dx, y + dy, rng.uniform(0.3, 1.5)))
    return rows


def crossover() -> int:
    """Walk against pass in segment mode (see the module's docstring)."""
    import torch

    import chip_smoke
    from pedoni_tpu_torch import Simulator, SimulatorOptions, load_scenario
    from pedoni_tpu_torch.bench import build_problem
    from pedoni_tpu_torch.models import sfm_grid
    from pedoni_tpu_torch.ops.kernels import step_kernel as sk

    dev = torch.device("cuda")
    card = chip_smoke._card()
    print(card, flush=True)

    def sim_state(name: str, ticks: int):
        sim = Simulator(SimulatorOptions(backend="grid", device="cuda", seed=1,
                                         use_distance_map=False),
                        load_scenario(HERE / "scenarios" / name))
        for _ in range(ticks):
            sim.tick()
        return (sim.state.d, sim._fwp, sim._fobs, sim.cfg.physics,
                sim.cfg.scenario.size, sfm_grid.stride_for(sim.cfg),
                chip_smoke._obstacles(sim.cfg.scenario))

    scenario, maps, cfg, flat = build_problem(chip_smoke.N_AGENTS, device=dev)
    fwp, fobs = sfm_grid.field_tensors(cfg, maps, dev)
    gs = chip_smoke._run_timed(sfm_grid.make_step_grid(cfg, incremental=False),
                               sfm_grid.bin_state(cfg, flat), fwp, fobs)[0]
    size = cfg.scenario.size
    states = {
        "1M": ((gs.d, fwp, fobs, cfg.physics, size, sfm_grid.stride_for(cfg)),
               {n: _spread_rows(n, size, n) for n in (1, 2, 3, 4, 8, 16, 32, 64, 128)}),
    }
    r = sim_state("random.toml", chip_smoke.RANDOM_STEPS)
    states["random.toml"] = (r[:6], {n: r[6][:n] for n in
                                     (1, 2, 3, 4, 8, 16, 32, 64, 128, 256, 1000)})
    f = sim_state("funnel.toml", CROSSOVER_TICKS)
    states["funnel.toml"] = (f[:6], {n: f[6] + _spread_rows(n - 4, f[4], n)
                                     for n in (4, 8, 16, 32, 64)})
    for name in ("default.toml", "room-evac.toml"):
        s = sim_state(name, CROSSOVER_TICKS)
        states[name] = (s[:6], {len(s[6]): s[6]})
    for name, ((d, wp, ob, phys, sz, stride), tables) in states.items():
        res = {"state": name, "live": int((d[:, :, 6] > 0.5).sum()),
               "D": list(d.shape), "walk_ms": {}, "pass_ms": {}}
        for n, rows in tables.items():
            segs = sk.segment_table(rows, dev)

            def run(pair_pass):
                with chip_smoke._segment_walk(pair_pass):
                    return sk.fused_step(d, wp, ob, phys, sz, stride=stride,
                                         segments=segs)

            if not torch.equal(run(False), run(True)):
                raise AssertionError(f"{name}, {n} rows: walk and pass differ")
            res["walk_ms"][n] = chip_smoke._median_ms(lambda: run(False))
            res["pass_ms"][n] = chip_smoke._median_ms(lambda: run(True))
        print(json.dumps(res), flush=True)
    print(f"# walk against pass, medians of 20 CUDA-event runs on {card}",
          flush=True)
    return 0


def density_sweep() -> int:
    """Full against hybrid over DENSITIES (see the module's docstring)."""
    import math

    import torch

    import chip_smoke
    from pedoni_tpu_torch.bench import build_problem
    from pedoni_tpu_torch.models import sfm_grid
    from pedoni_tpu_torch.ops.kernels import launch_counts, zero_launch_counts
    from pedoni_tpu_torch.ops.kernels import step_kernel as sk
    from pedoni_tpu_torch.utils import trace

    dev = torch.device("cuda")
    card = chip_smoke._card()
    print(card, flush=True)
    n_steps = chip_smoke.WARMUP + chip_smoke.TIMED
    problems = []
    for rho in DENSITIES:  # wall clock first, before any profiler starts
        lam = rho * 1.5 ** 2
        k = max(14, math.ceil(2.5 * lam))
        scenario, maps, cfg, flat = build_problem(chip_smoke.N_AGENTS, density=rho,
                                                  table_capacity=k, device=dev)
        fwp, fobs = sfm_grid.field_tensors(cfg, maps, dev)
        del maps
        binned = int((sfm_grid.bin_state(cfg, flat).d[:, :, 6] > 0.5).sum())
        if binned < 0.99 * chip_smoke.N_AGENTS:
            raise AssertionError(f"density {rho}: {binned} agents binned at K {k}")
        res = {"density": rho, "lambda": lam, "K": k,
               "cells": [cfg.grid.nx, cfg.grid.ny], "binned": binned,
               "wall_ms": {"full": [], "hybrid": []},
               "device_ms": {"full": [], "hybrid": []},
               "device_launches": {"full": [], "hybrid": []}}
        trace.enable(True)  # step.full_rebins counts while tracing is on
        for name in TURNS:
            step = sfm_grid.make_step_grid(cfg, incremental=name == "hybrid")
            zero_launch_counts()
            gs, m, ms = chip_smoke._run_timed(step, sfm_grid.bin_state(cfg, flat),
                                              fwp, fobs)
            res["wall_ms"][name].append(ms)
            res[f"{name}_kernel_launches"] = {
                kname: c / n_steps for kname, c in launch_counts().items() if c}
            res[f"{name}_active"] = int(m.n_active)
            if name == "hybrid":
                res["hybrid_full_rebin_share"] = int(step.full_rebins) / n_steps
                movers = sk.fused_step(gs.d, fwp, fobs, cfg.physics, cfg.scenario.size,
                                       stride=sfm_grid.stride_for(cfg),
                                       emit_movers=8)[1:3]
                res["mover_share"] = (int((movers[0][:, :, 6] > 0.5).sum())
                                      + float(movers[1].sum())) / res["hybrid_active"]
            del gs
        trace.enable(False)
        problems.append((cfg, fwp, fobs, flat, res))
    for cfg, fwp, fobs, flat, res in problems:
        for name in TURNS:
            step = sfm_grid.make_step_grid(cfg, incremental=name == "hybrid")
            state = [sfm_grid.bin_state(cfg, flat)]
            for _ in range(chip_smoke.WARMUP):
                state[0] = step(state[0], fwp, fobs)[0]

            def run():
                state[0] = step(state[0], fwp, fobs)[0]

            us, launches = chip_smoke._profile_counts(run, chip_smoke.PROFILE_STEPS)
            if not sum(us.values()) > 0:
                raise AssertionError("the profiler traced no device time")
            res["device_ms"][name].append(sum(us.values()) / 1e3)
            res["device_launches"][name].append(sum(launches.values()))
            res[f"{name}_device_us"] = dict(us)
            del state
        dm = {name: statistics.mean(v) for name, v in res["device_ms"].items()}
        res["hybrid_over_full_device"] = dm["hybrid"] / dm["full"]
        print(json.dumps(res), flush=True)
    wins = [res["density"] for *_, res in problems
            if res["hybrid_over_full_device"] < 1.0]
    print(f"# device ms/step, hybrid over full, by density: " + ", ".join(
        f"{res['density']}: {res['hybrid_over_full_device']:.4f}"
        for *_, res in problems) + f" on {card}", flush=True)
    print("# the hybrid's device time is below the full path's at "
          + (f"densities {wins}" if wins else "no density: full wins at every one")
          + f" (mean of two turns each, {chip_smoke.PROFILE_STEPS} profiled steps a turn)",
          flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="directory of the other checkout")
    ap.add_argument("--crossover", action="store_true",
                    help="time segment mode's walk against its pass instead")
    ap.add_argument("--flat-paths", action="store_true",
                    help="time the 1M flat and pallas steps instead")
    ap.add_argument("--density", action="store_true",
                    help="time the full path against the hybrid over DENSITIES")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return (worker_flat_paths if args.flat_paths else worker)(args.worker)
    import torch
    if not torch.cuda.is_available():
        print("ab_step: no CUDA device", file=sys.stderr)
        return 2
    if args.crossover:
        return crossover()
    if args.density:
        return density_sweep()
    if not args.parent:
        ap.error("--parent is required")
    import chip_smoke
    parent = str(pathlib.Path(args.parent).resolve())
    card = chip_smoke._card()
    print(card, flush=True)
    turns = []
    COMMON_STATE.unlink(missing_ok=True)
    for label, tree in (("parent", parent), ("change", str(HERE)),
                        ("change", str(HERE)), ("parent", parent)):
        r = subprocess.run([sys.executable, __file__, "--worker", tree,
                            *(["--flat-paths"] if args.flat_paths else [])],
                           cwd=tree, capture_output=True, text=True,
                           timeout=1200)
        if r.returncode != 0:
            print(r.stdout[-2000:], r.stderr[-4000:], file=sys.stderr)
            return 1
        line = json.loads(r.stdout.strip().splitlines()[-1])
        line["turn"] = label
        turns.append(line)
        print(json.dumps(line), flush=True)
    if args.flat_paths:
        _summary(turns, [*(f"{p}_{k}" for p in ("flat", "pallas", "strips")
                           for k in FLAT_PATH_KEYS),
                         *(f"grid_{p}_device_ms_per_step" for p in GRID_PATHS)], card)
        return 0
    keys = ("step_kernel_ms", "step_kernel_movers_ms", "rebin_ms",
            "rebin_incremental_ms", "full_ms_per_step", "hybrid_ms_per_step")
    print("# random.toml state after the ticks, by turn: " + "; ".join(
        f"{t['turn']} {t['random_toml_state']}" for t in turns), flush=True)
    _summary(turns, (*keys, "step_kernel_segments_ms", "random_toml_segments_ms",
                     "random_toml_common_segments_ms",
                     "funnel_toml_segments_ms", "default_toml_segments_ms",
                     "pairwise_ms", *("all_pairs_" + k for k in keys)), card)
    return 0


def _summary(turns: list[dict], keys, card: str) -> None:
    """One line a key: both turns of each tree and change / parent."""
    for k in keys:
        p = [t[k] for t in turns if t["turn"] == "parent"]
        c = [t[k] for t in turns if t["turn"] == "change"]
        print(f"# {k}: parent {p[0]:.4f}, {p[1]:.4f}; change {c[0]:.4f}, "
              f"{c[1]:.4f}; change/parent {statistics.mean(c) / statistics.mean(p):.4f}"
              f" on {card}", flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
