#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python chip_smoke.py

Builds the hand-written kernels (pedoni_tpu_torch/ops/kernels/csrc) with
nvcc, then:

1. holds each kernel against its plain PyTorch twin on a seeded random
   grid: the rebin bit-equal, the step within abs 1e-5 on pos/vel of the
   slots that held agents with the active channel equal;
2. drives scenarios/gap.toml through ``Simulator.tick()`` until the
   population evacuates (must happen within 400 steps);
3. drives the 1M-agent bench workload (density 2.5 m^-2, 1021 x 175
   cells, K = 14, one waypoint) through ``make_step_grid``: 16 warm-up
   and 40 timed steps; positions finite, >= 0.99e6 agents active, each
   kernel launched exactly once per step;
4. repeats the kernel-vs-twin checks on the 1M state and times each
   kernel and its twin (median of 20 runs, CUDA events).

Prints the card's name and power limit, one JSON line describing the
kernels, and as its last line {"ok": true, "device": {...}}.  Exits
non-zero, with no result line, on any failure or without a CUDA device.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

TOL = 1e-5  # step kernel vs twin, pos/vel of slots that held agents
N_AGENTS = 1_000_000
WARMUP, TIMED = 16, 40
GAP_MAX_STEPS = 400
GAP = pathlib.Path(__file__).resolve().parent / "scenarios" / "gap.toml"


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def _median_ms(fn, n: int = 20) -> float:
    fn()  # warm
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _compare(d, fwp, fobs, phys, size, unit, nx, ny, what):
    """Kernel vs twin on one grid: returns (step max abs err, rebin err)."""
    from pedoni_tpu_torch.ops.kernels import rebin as rb
    from pedoni_tpu_torch.ops.kernels import step_kernel as sk

    g_k = sk.fused_step(d, fwp, fobs, phys, size)
    g_t = sk.fused_step_torch(d, fwp, fobs, phys, size)
    torch.cuda.synchronize()
    if not torch.equal(g_k[:, :, 6], g_t[:, :, 6]):
        raise AssertionError(f"{what}: step kernel active channel differs")
    # pos/vel of the slots that held agents; agents flung by a sanitized
    # (non-finite) velocity sit near 2^30 m and are held to 1e-6 relative
    held = (d[:, :, 6] > 0.5).unsqueeze(2).expand(-1, -1, 4, -1)
    diff = (g_k[:, :, 0:4] - g_t[:, :, 0:4]).abs()[held]
    ref = g_t[:, :, 0:4].abs()[held]
    sane = ref < 2.0 ** 20
    step_err = float(diff[sane].max()) if bool(sane.any()) else 0.0
    if not step_err <= TOL or not bool((diff[~sane] <= 1e-6 * ref[~sane]).all()):
        raise AssertionError(f"{what}: step kernel pos/vel err {step_err:.3e} > {TOL}")
    r_k = rb.rebin(g_t, unit, nx, ny)
    r_t = rb.rebin_torch(g_t, unit, nx, ny)
    torch.cuda.synchronize()
    for name, a, b in zip(("D'", "overflow", "demand", "active_in", "active_out"),
                          r_k, r_t):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: rebin {name} differs from the twin")
    print(f"# {what}: step kernel max |err| {step_err:.3e} (tol {TOL}), "
          f"active channel equal; rebin bit-equal on all 5 outputs", flush=True)
    return step_err


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run",
              file=sys.stderr)
        return 2
    from pedoni_tpu_torch import Simulator, SimulatorOptions, load_scenario
    from pedoni_tpu_torch.bench import build_problem
    from pedoni_tpu_torch.convert import agents_from_numpy
    from pedoni_tpu_torch.field import Field, FieldMaps
    from pedoni_tpu_torch.models import sfm_grid
    from pedoni_tpu_torch.models.sfm import SimState, StepConfig
    from pedoni_tpu_torch.ops.kernels import _build
    from pedoni_tpu_torch.ops.kernels import rebin as rb
    from pedoni_tpu_torch.ops.kernels import step_kernel as sk

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card()
    print(card, flush=True)
    print(f"# torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    _build.library()
    print(f"# kernels built from {_build.CSRC.relative_to(_build.CSRC.parents[3])}"
          f" -> {_build.library_path().name} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("#   ptxas:", line.strip(), flush=True)

    # 1. seeded random grid on gap.toml's fields (two waypoint planes, a
    # dense crowd, one NaN-position and one inf-velocity agent)
    sc = load_scenario(GAP)
    maps = FieldMaps.from_field(Field.from_scenario(sc, unit=0.25))
    cfg = StepConfig.build(sc, capacity=2048, neighbor_grid_unit=1.5,
                           table_capacity=14)
    rng = np.random.default_rng(0)
    n = 1500
    pos = rng.uniform(0.5, 23.5, (n, 2))
    agents = agents_from_numpy(pos, rng.normal(0, 0.6, (n, 2)),
                               np.clip(rng.normal(1.34, 0.26, n), 0.1, None),
                               rng.integers(0, 2, n), np.ones(n, bool), dev)
    d = sfm_grid.bin_state(cfg, SimState(agents, 0)).d
    occ = torch.nonzero(d[:, :, 6] > 0.5)
    r, k, l = occ[10].tolist()
    d[r, k, 0:2, l] = float("nan")
    r, k, l = occ[500].tolist()
    d[r, k, 2, l] = float("inf")
    fwp, fobs = sfm_grid.field_tensors(cfg, maps, dev)
    _compare(d, fwp, fobs, cfg.physics, sc.size, 1.5, cfg.grid.nx,
             cfg.grid.ny, "random grid (gap fields, 1500 agents)")

    # 2. gap.toml through the Simulator: the physics gate
    sk.fused_step.launches = rb.rebin.launches = 0
    sim = Simulator(SimulatorOptions(device="cuda", seed=1), sc)
    n0 = sim.pedestrian_count
    steps = 0
    active = n0
    while active > 0 and steps < GAP_MAX_STEPS:
        active = sim.tick().active_ped_count
        steps += 1
    if active != 0:
        raise AssertionError(f"gap.toml: {active} agents left after {steps} steps")
    if not (sk.fused_step.launches == rb.rebin.launches == steps):
        raise AssertionError("gap.toml: launch counts differ from the step count")
    print(f"# gap.toml: {n0} agents evacuated in {steps} steps "
          f"(limit {GAP_MAX_STEPS}); kernel launches {steps} each", flush=True)

    # 3. the 1M-agent bench workload through the port's grid step
    t0 = time.perf_counter()
    _sc, bmaps, bcfg, flat = build_problem(N_AGENTS, device=dev)
    bfwp, bfobs = sfm_grid.field_tensors(bcfg, bmaps, dev)
    gs = sfm_grid.bin_state(bcfg, flat)
    step = sfm_grid.make_step_grid(bcfg)
    del flat
    torch.cuda.synchronize()
    dims = tuple(gs.d.shape)
    print(f"# 1M problem: grid {bcfg.grid.nx} x {bcfg.grid.ny} cells, D {dims}, "
          f"{int((gs.d[:, :, 6] > 0.5).sum())} agents binned, set-up "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    sk.fused_step.launches = rb.rebin.launches = 0
    for _ in range(WARMUP):
        gs, m = step(gs, bfwp, bfobs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED):
        gs, m = step(gs, bfwp, bfobs)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / TIMED
    launches = {"step_kernel": sk.fused_step.launches, "rebin": rb.rebin.launches}
    n_steps = WARMUP + TIMED
    if set(launches.values()) != {n_steps}:
        raise AssertionError(f"1M: launches {launches} != {n_steps} steps")
    n_active = int(m.n_active)
    held = gs.d[:, :, 6] > 0.5
    if not bool(torch.isfinite(gs.d[:, :, 0:4][held.unsqueeze(2).expand(-1, -1, 4, -1)]).all()):
        raise AssertionError("1M: non-finite positions or velocities")
    if n_active < 0.99e6:
        raise AssertionError(f"1M: only {n_active} agents active")
    print(f"# 1M run: {n_steps} steps ({WARMUP} warm-up), {n_active} active, "
          f"overflow last step {int(m.n_overflow)}, max demand {int(m.max_demand)}; "
          f"{dt * 1e3:.3f} ms/step, {n_active / dt:.4e} agent-steps/s "
          f"on {card}", flush=True)

    # 4. kernel vs twin on the 1M state, and their times
    step_err = _compare(gs.d, bfwp, bfobs, bcfg.physics, bcfg.scenario.size,
                        bcfg.grid.unit, bcfg.grid.nx, bcfg.grid.ny, "1M state")
    phys, size = bcfg.physics, bcfg.scenario.size
    g = sk.fused_step_torch(gs.d, bfwp, bfobs, phys, size)
    unit, nx, ny = bcfg.grid.unit, bcfg.grid.nx, bcfg.grid.ny
    times = {
        "step_kernel": (_median_ms(lambda: sk.fused_step(gs.d, bfwp, bfobs, phys, size)),
                        _median_ms(lambda: sk.fused_step_torch(gs.d, bfwp, bfobs, phys, size))),
        "rebin": (_median_ms(lambda: rb.rebin(g, unit, nx, ny)),
                  _median_ms(lambda: rb.rebin_torch(g, unit, nx, ny))),
    }
    for name, (k_ms, t_ms) in times.items():
        print(f"# {name} at D {dims}: kernel {k_ms:.4f} ms, twin {t_ms:.4f} ms "
              f"(median of 20, CUDA events) on {card}", flush=True)

    kernels = [
        {"name": "step_kernel", "route": "cuda",
         "source": "pedoni_tpu_torch/ops/kernels/csrc/step_kernel.cu",
         "replaces": "pedoni_tpu/ops/pallas/step_kernel.py:898",
         "launches": launches["step_kernel"], "max_abs_err": step_err,
         "ms": times["step_kernel"][0], "plain_ms": times["step_kernel"][1]},
        {"name": "rebin", "route": "cuda",
         "source": "pedoni_tpu_torch/ops/kernels/csrc/rebin.cu",
         "replaces": "pedoni_tpu/ops/pallas/rebin.py:570",
         "launches": launches["rebin"], "max_abs_err": 0.0,
         "ms": times["rebin"][0], "plain_ms": times["rebin"][1]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
