#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python chip_smoke.py

Builds the hand-written kernels (pedoni_tpu_torch/ops/kernels/csrc) with
nvcc, one process per source, then:

1. holds each kernel against its plain PyTorch twin on a seeded random
   grid: the step kernel (base and mover modes) within abs 1e-5 on pos/vel
   of the slots that held agents, its other channels, mover table and
   per-block outputs equal; both rebins bit-equal on all five outputs;
2. drives scenarios/gap.toml through ``Simulator.tick()`` until the
   population evacuates (within 400 steps), on the auto-chosen full rebin
   and once more with ``incremental_rebin=True`` forced;
3. runs tests/test_rebin_incremental.py's spawning scenario through
   ``make_step_grid`` incremental and full from the same candidates for 8
   steps: every StepMetrics field equal each step, active sets within
   atol 2e-5 / rtol 1e-5 — with mover_k=4 and with mover_k=1 (fallback);
4. drives the 1M-agent bench workload (density 2.5 m^-2, 1021 x 175
   cells, K = 14, one waypoint) through ``make_step_grid``: the full-rebin
   path (``incremental=False``), then the hybrid as bench.py runs it
   (``incremental=True, mover_k=8, compact_every=8``), each 16 warm-up and
   40 timed steps with every launch count zeroed before and read after;
   the hybrid's timed steps run under ``set_sync_debug_mode("error")``;
   positions finite, >= 0.99e6 agents active, both rebin branches taken
   (read from the device counter after the run); then 24 more steps of
   each path under ``torch.profiler``: device us/step per kernel and the
   device's busy share of the unprofiled wall time;
5. repeats the kernel-vs-twin checks on each path's own 1M state (the
   base step and the full rebin on the full path's, the mover mode and the
   incremental rebin on the hybrid's; the incremental rebin also on a
   hand-made M whose rows past each cell's count hold movers) and times
   each kernel and its twin
   there (median of 20 runs for a kernel, TWIN_RUNS for a twin, CUDA
   events, each queued behind a device spin
   so that host enqueue time stays out).  Each bound counts the bytes the
   function needs from this state (see ``_needed_bytes``).  The step kernel's
   and the rebins' times are printed beside their first designs';
6. segment mode (--no-distance-map): the step kernel with the obstacle edge
   table vs its twin, base and mover modes, the table walked by the sample
   pass and again by the pair pass, on step 1's random grid (gap.toml's
   obstacles, then those and random.toml's 1000) and on both 1M states
   (the bench's one obstacle; the full path's also with random.toml's 1000
   rows, so that dense tiles meet the pair pass's cull); the 1M
   full path with ``use_distance_map=False`` (launch counts zeroed before,
   read after); scenarios/random.toml (1000 obstacles, 200 x 200 m, 4
   spawn groups) for 200 steps through ``Simulator(use_distance_map=
   False)``, then the kernel vs the twin on its state; kernel, twin and
   bound on both states, with the (agent, obstacle) pairs a walk of the
   whole table, the pair pass's tile cull and the data need; then 48 more
   random.toml ticks under ``torch.profiler``: device us per tick for each
   kernel and for the glue (spawn scatter, metrics), and the busy share;
   then 16 spawning steps of that grid whole and 16 cut into 2 x 2 tiles
   on this card, all under ``set_sync_debug_mode("error")``, every metric
   equal each step and the grids bit-equal;
7. all-pairs mode (--no-neighbor-grid): gap.toml through
   ``Simulator(use_neighbor_grid=False)`` (unit 2.0 m, K 29) evacuates
   within 400 steps; the 1M bench problem at unit 2.0 (K grown by the same
   rule, field stride 8), its ms/step, and the step kernel and both rebins
   vs their twins there;
8. the standalone pairwise kernel (2D) vs its twin on a random grid and on
   the 1M full-path state with ch 4/5 replaced by seeded unit vectors, one
   launch counted, kernel and twin timed;
9. the CLI as subprocesses: ``python -m pedoni_tpu_torch gap.toml -H
   --no-distance-map --checkpoint-every 100`` for 300 steps (population
   reaches 0, log written), then ``--resume`` from the step-100
   checkpoint: the resumed simulator's agents and generator equal the
   saved ones exactly, and its later checkpoints equal the first run's;
   ``--devices`` one more than the machine's cards exits non-zero naming
   the count;
10. the 1M workload cut into 1 x 2 and 2 x 2 tiles, every tile on this
   card (parallel/tile2d.py over a device list), full path and hybrid:
   TILE_STEPS tiled steps equal to the whole grid's (every metric each
   step, the tiles' own cells bit for bit), the step kernel (base and
   mover mode) and both rebins at a tile's offsets equal to their twins
   (max |err| 0), wall ms/step tiled and whole, the tiled step's device
   ms/step (profiler) and the ghost exchange's device time a step;
11. the 1M full-path state re-binned at K = BIG_K (121, past the largest
   K whose one-row tile holds every slot level): the step kernel (base
   and mover mode) and 2D equal to their twins, timed beside K = 14; then
   step 1's fields at K = MAX_K (255) with cells filled to K: the step
   kernel (base, mover and segment mode) and 2D equal to their twins.

Prints the card's name and power limit, one JSON line describing the
kernels, and as its last line {"ok": true, "device": {...}}.  Exits
non-zero, with no result line, on any failure or without a CUDA device.
"""

from __future__ import annotations

import contextlib
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
PARITY_STEPS = 8
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
PAIR_FLOPS = 45  # float operations of one pair_accum within the cutoff
PAIR_TEST_FLOPS = 6  # its distance test alone (a candidate past the cutoff)
SPIN_CYCLES = 2_000_000  # ~1 ms of device clock ahead of each timed run
TWIN_RUNS = 5  # runs of a plain PyTorch twin timed (tens of ms to seconds each)
PROFILE_STEPS = 24  # a multiple of the compaction period of 8
# kernel names as the profiler reports them, in step order
PROFILED = ("step_sample", "step_pairs", "rebin_full", "rebin_inc")
ROOT = pathlib.Path(__file__).resolve().parent
GAP = ROOT / "scenarios" / "gap.toml"
RANDOM = ROOT / "scenarios" / "random.toml"  # 1000 obstacles
RANDOM_STEPS = 200
SEG_FLOPS = 100  # float operations of one (agent, obstacle) segment test
EXP_ZERO_RANGES = 104  # exp(-d / obs_range) is 0 in f32 past this many ranges
RANDOM_PROFILE_TICKS = 48  # random.toml ticks under torch.profiler
# random.toml's wall / device ms a tick in segment mode with the spawn scatter
# that synced the host each step (PERF.md; NVIDIA H100 80GB HBM3, 700 W).
# Printed beside this run's; nothing is gated on it.
RANDOM_TICK_MS_SYNCING = (4.9446, 0.3487)
SPAWN_SYNC_STEPS = 16  # spawning steps under set_sync_debug_mode("error")
TILES = ((1, 2), (2, 2))  # the 1M workload's tilings, all on one card
TILE_STEPS = 16  # steps of the tiled and the whole-grid 1M step compared
BIG_K = 121  # the table capacity after 81 in Simulator._grow_table
MAX_K = 255  # the largest table capacity the pair passes take
# The same measurements with the kernels' first designs, from PERF.md (NVIDIA
# H100 80GB HBM3, 700 W): the step kernel with one thread per slot (a sample
# pass over the fields6 planes, a pair pass with a warp-wide candidate walk,
# a third launch for the movers, in segment mode a walk of the whole edge
# table), the rebins with one thread per output cell (a serial walk of its
# candidates, beside the redesigned step kernel), and 2D with one thread
# per centre slot over all its candidate slots.
# Printed beside this run's for comparison; nothing is gated on them (a card
# capped below 700 W would fail a timing gate for no fault of the code).
FIRST_DESIGN_MS = {"hybrid": 1.0674, "full": 0.9188, "step_kernel": 0.7499,
                   "step_kernel_movers": 0.9055, "step_kernel_segments": 0.6765,
                   "segments_full": 0.8441, "all_pairs": 1.4354,
                   "rebin": 0.1286, "rebin_incremental": 0.1248,
                   "step_kernel_segments_random_toml": 0.7328,
                   "pairwise": 0.5632}
# tests/test_rebin_incremental.py's spawning scenario
SPAWN_SCENARIO = """
[field]
size = [18, 12]
[[waypoints]]
line = [[2, 2], [2, 10]]
[[waypoints]]
line = [[16, 2], [16, 10]]
[[obstacles]]
line = [[9, 0], [9, 5]]
width = 1
[[pedestrians]]
origin = 0
destination = 1
spawn = { kind = "periodic", frequency = 4.0 }
"""
CSRC = "pedoni_tpu_torch/ops/kernels/csrc/"


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def _median_ms(fn, n: int = 20) -> float:
    """Median device time of ``fn`` over ``n`` runs, CUDA events.  Each run
    is queued behind a ~1 ms device spin, so the host's enqueue work
    (allocation, the ctypes call) overlaps the spin and only device time
    falls between the events."""
    fn()  # warm
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _vs_first(key: str, ms: float) -> str:
    """``ms`` beside FIRST_DESIGN_MS[key], for printing."""
    was = FIRST_DESIGN_MS[key]
    return f"{key} {ms:.4f} (first design {was}, {ms / was - 1:+.1%})"


def _launch_counts() -> dict[str, int]:
    from pedoni_tpu_torch.ops.kernels import pairwise as pw
    from pedoni_tpu_torch.ops.kernels import rebin as rb
    from pedoni_tpu_torch.ops.kernels import step_kernel as sk
    return {"step_kernel": sk.fused_step.launches,
            "step_kernel_movers": sk.fused_step.mover_launches,
            "step_kernel_segments": sk.fused_step.segment_launches,
            "rebin": rb.rebin.launches,
            "rebin_incremental": rb.rebin_incremental.launches,
            "pairwise": pw.pairwise.launches}


def _zero_launch_counts() -> None:
    from pedoni_tpu_torch.ops.kernels import pairwise as pw
    from pedoni_tpu_torch.ops.kernels import rebin as rb
    from pedoni_tpu_torch.ops.kernels import step_kernel as sk
    sk.fused_step.launches = sk.fused_step.mover_launches = 0
    sk.fused_step.segment_launches = 0
    rb.rebin.launches = rb.rebin_incremental.launches = 0
    pw.pairwise.launches = 0


def _step_err(d, got, want) -> float:
    """Max |err| on pos/vel of the slots that held agents; agents flung by
    a sanitized (non-finite) velocity sit near 2^30 m and are held to 1e-6
    relative."""
    held = (d[:, :, 6] > 0.5).unsqueeze(2).expand(-1, -1, 4, -1)
    diff = (got[:, :, 0:4] - want[:, :, 0:4]).abs()[held]
    ref = want[:, :, 0:4].abs()[held]
    sane = ref < 2.0 ** 20
    err = float(diff[sane].max()) if bool(sane.any()) else 0.0
    if not err <= TOL or not bool((diff[~sane] <= 1e-6 * ref[~sane]).all()):
        raise AssertionError(f"step kernel pos/vel err {err:.3e} > {TOL}")
    return err


@contextlib.contextmanager
def _segment_walk(pair_pass: bool | None):
    """Segment mode's edge table walked by the pair pass (True) or by the
    sample pass (False) inside the block, whatever its length; None leaves
    the choice to ``step_kernel.segment_pass``."""
    from pedoni_tpu_torch.ops.kernels import step_kernel as sk

    rule = sk.segment_pass
    if pair_pass is not None:
        sk.segment_pass = lambda n_seg: pair_pass
    try:
        yield
    finally:
        sk.segment_pass = rule


def _compare_step(d, fwp, fobs, phys, size, mk, what, **kw):
    """The step kernel vs its twin in base and mover mode (``kw``: the
    segment table, the field stride): returns (base err, mover err, the
    twin's base output, the twin's mover-mode outputs).  In segment mode the
    kernel runs twice, the table walked by its sample pass and by its pair
    pass (``_segment_walk``), each held to the one twin output."""
    from pedoni_tpu_torch.ops.kernels import step_kernel as sk

    seg = kw.get("segments") is not None
    g_t = sk.fused_step_torch(d, fwp, fobs, phys, size, **kw)
    mv_t = sk.fused_step_torch(d, fwp, fobs, phys, size, emit_movers=mk, **kw)
    ch = slice(4, 8) if seg else slice(4, 7)
    step_err = mover_err = 0.0
    for path in ((False, True) if seg else (None,)):
        where = what if path is None else f"{what}, {('sample', 'pair')[path]}-pass walk"
        with _segment_walk(path):
            g_k = sk.fused_step(d, fwp, fobs, phys, size, **kw)
            mv_k = sk.fused_step(d, fwp, fobs, phys, size, emit_movers=mk, **kw)
        torch.cuda.synchronize()
        if not torch.equal(g_k[:, :, ch], g_t[:, :, ch]):
            raise AssertionError(f"{where}: step kernel channels {ch} differ")
        step_err = max(step_err, _step_err(d, g_k, g_t))
        if not torch.equal(mv_k[0][:, :, 4:8], mv_t[0][:, :, 4:8]):
            raise AssertionError(f"{where}: mover mode speed/dest/active/stay differ")
        mover_err = max(mover_err, _step_err(d, mv_k[0], mv_t[0]))
        for name, a, b in zip(("M", "movf", "mdmx"), mv_k[1:], mv_t[1:]):
            if not torch.equal(a, b):
                raise AssertionError(f"{where}: mover mode {name} differs from the twin")
    return step_err, mover_err, g_t, mv_t


def _compare_rebins(g_t, mv_t, unit, nx, ny, what, **tile) -> None:
    """Both rebin kernels vs their twins, bit-equal on all five outputs, on
    the step twin's outputs: ``g_t`` (base mode) for the full rebin, ``mv_t``
    (mover mode: G with the stay mask, M) for the incremental one, and the
    incremental one again on a hand-made M: the same rows with every cell's
    count (ch 7) cut by one, so that a row past the count holds a mover
    (the reference lands it by its ch 6).  ``tile``: a tile's offsets and
    own lanes (parallel/tile2d.py), for all of them."""
    from pedoni_tpu_torch.ops.kernels import rebin as rb

    names = ("D'", "overflow", "demand", "active_in", "active_out")
    m_cut = mv_t[1].clone()
    m_cut[:, :, 7] = torch.clamp(m_cut[:, :, 7] - 1.0, min=0.0)
    if not bool((m_cut[:, :, 6] > 0.5).any()):
        raise AssertionError(f"{what}: no mover rows for the hand-made M")
    for label, got, want in (
            ("rebin", rb.rebin(g_t, unit, nx, ny, **tile),
             rb.rebin_torch(g_t, unit, nx, ny, **tile)),
            ("rebin_incremental",
             rb.rebin_incremental(mv_t[0], mv_t[1], unit, nx, ny, **tile),
             rb.rebin_incremental_torch(mv_t[0], mv_t[1], unit, nx, ny, **tile)),
            ("rebin_incremental, hand-made M",
             rb.rebin_incremental(mv_t[0], m_cut, unit, nx, ny, **tile),
             rb.rebin_incremental_torch(mv_t[0], m_cut, unit, nx, ny, **tile))):
        torch.cuda.synchronize()
        for name, a, b in zip(names, got, want):
            if not torch.equal(a, b):
                raise AssertionError(f"{what}: {label} {name} differs from the twin")


def _compare(d, fwp, fobs, phys, size, unit, nx, ny, mk, what):
    """All four kernels vs their twins on one grid: returns the step
    kernel's max abs pos/vel error in base and mover mode."""
    step_err, mover_err, g_t, mv_t = _compare_step(d, fwp, fobs, phys, size,
                                                   mk, what)
    _compare_rebins(g_t, mv_t, unit, nx, ny, what)
    n_movers = int(mv_t[1][:, 0, 7].sum())
    print(f"# {what}: step kernel max |err| {step_err:.3e} (base), "
          f"{mover_err:.3e} (mover mode, MK {mk}, {n_movers} movers; stay "
          f"mask, M, movf, mdmx equal) (tol {TOL}); rebin and "
          f"rebin_incremental bit-equal on all 5 outputs, the latter also on "
          f"M with its counts cut by one", flush=True)
    return step_err, mover_err


def _active_rows(d: torch.Tensor) -> np.ndarray:
    rows = d.permute(0, 1, 3, 2).reshape(-1, 8)
    rows = rows[rows[:, 6] > 0.5][:, :6].cpu().numpy()
    return rows[np.lexsort((rows[:, 1], rows[:, 0]))]


def _spawn_parity(dev) -> None:
    """Incremental vs full from the same state and candidates: equal
    metrics every step and equal active sets (tests/test_rebin_incremental.py
    :192-232 on the card)."""
    from pedoni_tpu_torch import loads_scenario
    from pedoni_tpu_torch.convert import agents_from_numpy, metrics_to_dict
    from pedoni_tpu_torch.field import Field, FieldMaps
    from pedoni_tpu_torch.models import sfm_grid
    from pedoni_tpu_torch.models.sfm import SimState, StepConfig, spawn_candidates

    sc = loads_scenario(SPAWN_SCENARIO)
    maps = FieldMaps.from_field(Field.from_scenario(sc, unit=0.25))
    cfg = StepConfig.build(sc, capacity=256, neighbor_grid_unit=1.5,
                           table_capacity=8)
    rng = np.random.default_rng(3)
    n = 256
    pos = rng.uniform(0.8, np.array(sc.size) - 0.8, (n, 2))
    vel = rng.normal(0, 0.3, (n, 2))
    speed = np.clip(rng.normal(1.34, 0.26, n), 0.3, None)
    dest = rng.integers(0, 2, n)
    d0 = sfm_grid.bin_state(cfg, SimState(agents_from_numpy(
        pos, vel, speed, dest, np.arange(n) < 150, dev), 0)).d
    fwp, fobs = sfm_grid.field_tensors(cfg, maps, dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    cands = [spawn_candidates(cfg, gen) for _ in range(PARITY_STEPS)]
    for mk, every in ((4, 5), (1, 1000)):
        runs = []
        for incremental in (False, True):
            step = sfm_grid.make_step_grid(cfg, incremental=incremental,
                                           mover_k=mk, compact_every=every,
                                           generator=gen)
            gs = sfm_grid.GridState(d=d0.clone(), step=0)
            ms = []
            for cand in cands:
                gs, m = step(gs, fwp, fobs, cand)
                ms.append(metrics_to_dict(m))
            runs.append((ms, _active_rows(gs.d), step.full_rebins))
        (m_full, a_full, _), (m_inc, a_inc, n_full) = runs
        for i, (mf, mi) in enumerate(zip(m_full, m_inc)):
            mf = dict(mf, max_mover_demand=mi["max_mover_demand"])  # full: 0
            if mf != mi:
                raise AssertionError(f"spawn parity mk={mk} step {i}: {mf} != {mi}")
        if a_full.shape != a_inc.shape or not np.allclose(a_inc, a_full, atol=2e-5,
                                                          rtol=1e-5):
            raise AssertionError(f"spawn parity mk={mk}: active sets differ")
        peak = max(m["max_mover_demand"] for m in m_inc)
        print(f"# spawning scenario, mover_k={mk}, compact_every={every}: "
              f"{PARITY_STEPS} steps incremental == full (all metrics each "
              f"step; {a_inc.shape[0]} agents within 2e-5/1e-5), "
              f"{int(n_full)} steps took the full rebin, peak mover demand "
              f"{peak}", flush=True)


def _bound(nbytes: float, flops: float = 0.0) -> tuple[float, str]:
    """Least time the card could take: the bytes at the HBM rate, or the
    float operations at the f32 rate, whichever is longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _nbytes(*ts: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _field_bytes(d: torch.Tensor, fwp: torch.Tensor, fobs: torch.Tensor | None,
                 stride: int = 6, field_unit: float = 0.25) -> int:
    """Bytes of the field planes the active agents' bilinear taps read: each
    distinct texel once, with the 3 channels sampled (the index arithmetic
    of step_kernel.py::_sample); ``fobs`` None (segment mode) leaves the
    obstacle plane out."""
    from pedoni_tpu_torch.ops.kernels.step_kernel import FPAD, ROW0
    act = d[:, :, 6] > 0.5
    r, _, l = torch.nonzero(act, as_tuple=True)
    px = d[:, :, 0][act] * (1.0 / field_unit) - 0.5 + FPAD
    py = d[:, :, 1][act] * (1.0 / field_unit) - 0.5 + FPAD
    dest = d[:, :, 5][act]
    wp_ok = (dest >= 0) & (dest < fwp.shape[0]) & (dest == torch.floor(dest))
    p0 = torch.floor(px).long() - (l - 1) * stride - ROW0
    q0 = torch.floor(py).long() - (r - 1) * stride - ROW0
    n_r, nxl = fwp.shape[1], fwp.shape[-1]
    texels = 0
    planes = [(torch.where(wp_ok, dest, 0.0).long(), wp_ok)]
    if fobs is not None:
        planes.append((torch.zeros_like(r), torch.ones_like(wp_ok)))
    for plane_of, ok_of in planes:
        keys = []
        for a in (0, 1):
            for b in (0, 1):
                qy, qx = q0 + a, p0 + b
                ok = ok_of & (qy >= 0) & (qy <= stride + 1) & (qx >= 0) & (qx <= stride + 1)
                col = qx + ROW0
                frow = stride * r + ROW0 + qy
                lane2 = (l + col // stride) % nxl
                keys.append((((plane_of * n_r + frow) * stride + col % stride) * nxl
                             + lane2)[ok])
        texels += int(torch.unique(torch.cat(keys)).numel())
    return texels * 3 * fwp.element_size()


def _needed_bytes(name: str, ins: tuple, outs: tuple) -> int:
    """Bytes the function must move on this state: every output written
    once, and of the inputs what this data needs.
    - step kernel (all modes): all of D (an empty slot's output is its
      sanitized input) and the field texels that active agents sample (in
      segment mode no obstacle plane, and the edge table once);
    - pairwise: D's ch 6 plane, ch 0, 1, 4, 5 of the centre rows (every
      centre slot gets an acceleration), ch 2-3 of the active slots and
      ch 0-1 of the active ghost-row slots (only active candidates are
      evaluated);
    - rebin: G's ch 6 plane (every slot of the 3x3 walk is tested) and
      ch 0-5 of G's active slots;
    - rebin_incremental: G's ch 6 and ch 7 planes, ch 0-5 of the stay slots,
      M's ch 6 plane (a row lands where its ch 6 is set, as in the
      reference), and ch 0-5 of the rows that hold a mover."""
    out_b = _nbytes(*outs)
    if name == "step_kernel_segments":
        d, fwp, segs, stride = ins
        return (_nbytes(d, segs) + _field_bytes(d, fwp, None, stride=stride)
                + out_b)
    if name.startswith("step_kernel"):
        d, fwp, fobs = ins
        return _nbytes(d) + _field_bytes(d, fwp, fobs) + out_b
    if name == "pairwise":
        d = ins[0]
        word = d.element_size()
        act = d[:, :, 6] > 0.5
        return (d[:, :, 6].numel() * word + 4 * d[1:-1, :, 0].numel() * word
                + 2 * word * (int(act.sum()) + int(act[[0, -1]].sum())) + out_b)
    g = ins[0]
    plane = g[:, :, 6].numel() * g.element_size()
    row6 = 6 * g.element_size()
    if name == "rebin":
        return plane + row6 * int((g[:, :, 6] > 0.5).sum()) + out_b
    m = ins[1]
    return (2 * plane + row6 * int((g[:, :, 7] > 0.5).sum())
            + _nbytes(m[:, :, 6]) + row6 * int((m[:, :, 6] > 0.5).sum()) + out_b)


def _device_profile(run, n: int, wall_ms: float, what: str, card: str) -> float:
    """``run()`` n times under torch.profiler: device us and launches per
    run for each kernel of PROFILED (everything else on the device is
    "glue"), and the busy share of ``wall_ms``, the unprofiled wall time of
    one run.  Returns the device ms per run."""
    import collections
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    us, launches = collections.Counter(), collections.Counter()
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host events; device kernels, memsets and copies stay
        label = next((k for k in PROFILED if k in ev.key), "glue")
        us[label] += ev.self_device_time_total / n
        launches[label] += ev.count / n
    dev_ms = sum(us.values()) / 1e3
    if not dev_ms > 0:
        raise AssertionError(f"{what}: the profiler traced no device time")
    print(f"# {what} profile, {n} runs (torch.profiler): device {dev_ms:.4f} "
          f"ms a run, unprofiled wall {wall_ms:.4f} ms a run, busy share "
          f"{dev_ms / wall_ms:.3f} on {card}", flush=True)
    for label in (*PROFILED, "glue"):
        if label in us:
            print(f"#   {label:12s} {us[label]:9.2f} us a run {us[label] / 1e3 / dev_ms:6.1%}"
                  f"  {launches[label]:.2f} launches a run", flush=True)
    return dev_ms


def _profile(step, gs, fwp, fobs, wall_ms: float, name: str, card: str):
    """PROFILE_STEPS more steps of a 1M path under torch.profiler (see
    ``_device_profile``); returns the state after them."""
    state = [gs]

    def run():
        state[0] = step(state[0], fwp, fobs)[0]

    _device_profile(run, PROFILE_STEPS, wall_ms, f"1M {name} (a run = a step)", card)
    return state[0]


def _pair_candidates(d: torch.Tensor) -> float:
    """Candidate pairs a pair loop visits on this grid: for every active
    agent, the active agents of its 3x3 cells other than itself."""
    act = (d[:, :, 6] > 0.5).sum(dim=1).float()  # [ny2, NXL]
    win = torch.nn.functional.avg_pool2d(act[None, None], 3, stride=1,
                                         padding=1, divisor_override=1)[0, 0]
    return float((act * win - act)[1:-1].sum())


def _pairwise_flops(d: torch.Tensor, cutoff_sq: float) -> tuple[float, int, int]:
    """Float operations of the pairwise kernel on this grid: (flops, pairs
    within the cutoff, pairs past it).  It visits, for every centre slot,
    each active candidate of the 3x3 cells (lanes circular, itself
    excluded); a pair within the cutoff costs a whole pair_accum, one past
    it the distance test alone."""
    ny2, k = d.shape[0], d.shape[1]
    px, py = d[1:-1, :, None, 0], d[1:-1, :, None, 1]  # [ny, K centres, 1, NX]
    not_self = ~torch.eye(k, dtype=torch.bool, device=d.device)[None, :, :, None]
    within = visited = 0
    for dy in (-1, 0, 1):
        rows = d[1 + dy:ny2 - 1 + dy]
        for dx in (-1, 0, 1):
            cand = torch.roll(rows, -dx, dims=-1)[:, None]  # [ny, 1, K, 8, NX]
            act = cand[:, :, :, 6] > 0.5
            if dy == dx == 0:
                act = act & not_self
            ex, ey = px - cand[:, :, :, 0], py - cand[:, :, :, 1]
            within += int((act & (ex * ex + ey * ey <= cutoff_sq)).sum())
            visited += int(act.sum()) * (1 if dy == dx == 0 else k)
    beyond = visited - within
    return within * PAIR_FLOPS + beyond * PAIR_TEST_FLOPS, within, beyond

def _segment_pairs(d: torch.Tensor, g: torch.Tensor, segs: torch.Tensor,
                   phys, grid_size) -> tuple[int, int, int]:
    """(agent, obstacle) pairs of segment mode on the grid ``d`` whose
    agents after despawn are ``g``'s ch 6: (every live agent with every
    row, as a walk of the whole table; the pairs the kernel evaluates: each
    tile's live agents with the rows its pair pass's cull keeps, or the
    whole walk where the sample pass walks a short table; the pairs within
    EXP_ZERO_RANGES obstacle ranges by box distance, past which a term is
    exactly 0: the work the data needs)."""
    from pedoni_tpu_torch.ops.kernels import step_kernel as sk
    ny2, k, _, nxl = d.shape
    live = g[1:-1, :, 6] > 0.5  # [ny, K, NXL]
    row, _, lane = torch.nonzero(live, as_tuple=True)
    ax, ay = d[1:-1, :, 0][live], d[1:-1, :, 1][live]
    corners = torch.stack([segs[:, 0:2], segs[:, 0:2] + segs[:, 2:4],
                           segs[:, 5:7], segs[:, 5:7] + segs[:, 7:9]])
    lo, hi = corners.amin(0), corners.amax(0)  # [n_seg, 2]
    gx = torch.clamp(torch.maximum(lo[None, :, 0] - ax[:, None],
                                   ax[:, None] - hi[None, :, 0]), min=0.0)
    gy = torch.clamp(torch.maximum(lo[None, :, 1] - ay[:, None],
                                   ay[:, None] - hi[None, :, 1]), min=0.0)
    near = int((gx * gx + gy * gy < (EXP_ZERO_RANGES * phys.obs_range) ** 2).sum())
    walk = int(ax.numel()) * segs.shape[0]
    if not sk.segment_pass(segs.shape[0]):
        return walk, walk, near
    rows = sk.pair_pass_launch(k, ny2, nxl, segments=True)[0]
    n_lt = nxl // sk.TILE_LANES
    tile = (row // rows) * n_lt + lane // sk.TILE_LANES
    n_tiles = -(-(ny2 - 2) // rows) * n_lt
    box = [torch.full((n_tiles,), v, device=d.device).scatter_reduce(
               0, tile, a, how, include_self=True)
           for v, a, how in ((float("inf"), ax, "amin"), (float("-inf"), ax, "amax"),
                             (float("inf"), ay, "amin"), (float("-inf"), ay, "amax"))]
    cull = sk.segment_cull(phys, grid_size)
    gap_x = torch.maximum(lo[None, :, 0] - box[1][:, None], box[0][:, None] - hi[None, :, 0])
    gap_y = torch.maximum(lo[None, :, 1] - box[3][:, None], box[2][:, None] - hi[None, :, 1])
    keep = ~((gap_x >= cull) | (gap_y >= cull))
    agents = torch.bincount(tile, minlength=n_tiles)
    kept = int((keep.sum(dim=1) * agents).sum())
    return walk, kept, near


def _obstacles(sc) -> list[tuple]:
    return [(o.line[0][0], o.line[0][1], o.line[1][0], o.line[1][1], o.width)
            for o in sc.obstacles]


def _run_timed(step, gs, fwp, fobs):
    """WARMUP then TIMED synchronised steps: (state, last metrics, ms/step)."""
    for _ in range(WARMUP):
        gs, m = step(gs, fwp, fobs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED):
        gs, m = step(gs, fwp, fobs)
    torch.cuda.synchronize()
    return gs, m, (time.perf_counter() - t0) / TIMED * 1e3


def _evacuate(sim, what: str) -> tuple[int, int]:
    """Tick until nobody is left (at most GAP_MAX_STEPS): (n0, steps)."""
    n0 = active = sim.pedestrian_count
    steps = 0
    while active > 0 and steps < GAP_MAX_STEPS:
        active = sim.tick().active_ped_count
        steps += 1
    if active != 0:
        raise AssertionError(f"{what}: {active} agents left after {steps} steps")
    return n0, steps


def _segments_phase(dev, card, grid1, bench, states) -> dict:
    """6. Segment mode: kernel vs twin on the random grid and both 1M
    states; the 1M full path with use_distance_map=False; random.toml
    through the Simulator; times and bounds.  Returns the JSON entry."""
    import dataclasses

    from pedoni_tpu_torch import Simulator, SimulatorOptions, load_scenario
    from pedoni_tpu_torch.models import sfm_grid
    from pedoni_tpu_torch.ops.kernels import step_kernel as sk

    sc, cfg, d, fwp, fobs = grid1
    rsc = load_scenario(RANDOM)
    errs = []
    for label, rows in (("gap.toml's", _obstacles(sc)),
                        ("gap.toml's and random.toml's", _obstacles(sc) + _obstacles(rsc))):
        segs = sk.segment_table(rows, dev)
        e = _compare_step(d, fwp, fobs, cfg.physics, sc.size, 4,
                          f"segments, random grid, {segs.shape[0]} rows",
                          segments=segs)[:2]
        errs += e
        print(f"# segments, random grid ({label} {segs.shape[0]} obstacles, a "
              f"NaN and an inf agent; walked by the sample pass and by the "
              f"pair pass): step kernel max |err| {e[0]:.3e} (base), "
              f"{e[1]:.3e} (mover mode); other channels, M, movf, mdmx equal "
              f"(tol {TOL})", flush=True)

    bcfg, bfwp, bfobs, gs0 = bench
    scfg = dataclasses.replace(bcfg, use_distance_map=False)
    bsegs = sfm_grid.debug_segments(scfg, dev)
    phys, size = bcfg.physics, bcfg.scenario.size
    rsegs = sk.segment_table(_obstacles(rsc), dev)
    for name, sd, sg in (("full", states["full"], bsegs),
                         ("hybrid", states["hybrid"], bsegs),
                         ("full", states["full"], rsegs)):
        e = _compare_step(sd, bfwp, bfobs, phys, size, 8,
                          f"segments, 1M {name}-path state, {sg.shape[0]} rows",
                          segments=sg)[:2]
        errs += e
        print(f"# segments, 1M {name}-path state ({sg.shape[0]} obstacle"
              f"{'s, random.toml' if sg is rsegs else ', the bench'}'s; walked "
              f"by the sample pass and by the pair pass): step kernel max "
              f"|err| {e[0]:.3e} (base), {e[1]:.3e} (mover mode); other "
              f"channels equal (tol {TOL})", flush=True)

    step = sfm_grid.make_step_grid(scfg, incremental=False)
    _zero_launch_counts()
    gs, m, ms_1m = _run_timed(step, gs0, bfwp, bfobs)
    counts = _launch_counts()
    n = WARMUP + TIMED
    want = dict.fromkeys(counts, 0)
    want.update(step_kernel_segments=n, rebin=n)
    if counts != want:
        raise AssertionError(f"1M segments: launches {counts} != {want}")
    n_active = int(m.n_active)
    if n_active < 0.99 * N_AGENTS or not bool(torch.isfinite(gs.d[:, :, 0:4]).all()):
        raise AssertionError(f"1M segments: {n_active} active or non-finite state")
    print(f"# 1M segments full path (use_distance_map=False): {n} steps "
          f"({WARMUP} warm-up), {n_active} active; {ms_1m:.4f} ms/step; "
          f"launches {counts}; {_vs_first('segments_full', ms_1m)} on {card}",
          flush=True)

    _zero_launch_counts()
    t0 = time.perf_counter()
    sim = Simulator(SimulatorOptions(device=dev.type, seed=1,
                                     use_distance_map=False), rsc)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(RANDOM_STEPS):
        rec = sim.tick()
    torch.cuda.synchronize()
    ms_rand = (time.perf_counter() - t0) / RANDOM_STEPS * 1e3
    rcounts = _launch_counts()
    if rcounts["step_kernel_segments"] != RANDOM_STEPS or rec.active_ped_count <= 0:
        raise AssertionError(f"random.toml: launches {rcounts}, "
                             f"{rec.active_ped_count} active")
    rsegs = sfm_grid.debug_segments(sim.cfg, dev)
    stride = sfm_grid.stride_for(sim.cfg)
    rd = sim.state.d
    e = _compare_step(rd, sim._fwp, sim._fobs, sim.cfg.physics, rsc.size,
                      min(sim.options.mover_capacity, sim.options.table_capacity),
                      "segments, random.toml state", segments=rsegs,
                      stride=stride)[:2]
    errs += e
    print(f"# random.toml ({rsegs.shape[0]} obstacles, {rsc.size[0]:g} x "
          f"{rsc.size[1]:g} m): set-up {t_build:.2f} s, {RANDOM_STEPS} ticks of "
          f"Simulator(use_distance_map=False) at {ms_rand:.4f} ms/tick (host "
          f"sync each tick), {rec.active_ped_count} active, D "
          f"{tuple(rd.shape)}; launches {rcounts}; step kernel vs twin max "
          f"|err| {e[0]:.3e} (base), {e[1]:.3e} (mover mode) on {card}",
          flush=True)

    timing = {}
    for label, (sd, wp, ob, p, sz, sg, st, n_twin) in {
            "1M": (gs.d, bfwp, bfobs, phys, size, bsegs, 6, TWIN_RUNS),
            "random.toml": (rd, sim._fwp, sim._fobs, sim.cfg.physics, rsc.size,
                            rsegs, stride, 3)}.items():
        def kernel():
            return sk.fused_step(sd, wp, ob, p, sz, stride=st, segments=sg)

        def twin():
            return sk.fused_step_torch(sd, wp, ob, p, sz, stride=st, segments=sg)

        k_ms, t_ms = _median_ms(kernel), _median_ms(twin, n=n_twin)
        g_t = twin()
        need = _needed_bytes("step_kernel_segments", (sd, wp, sg, st), (g_t,))
        walk, kept, near = _segment_pairs(sd, g_t, sg, p, sz)
        b_ms, by = _bound(need, SEG_FLOPS * near)
        timing[label] = (k_ms, t_ms, b_ms, by)
        print(f"# step_kernel_segments on the {label} state "
              f"({int((g_t[:, :, 6] > 0.5).sum())} live after despawn, "
              f"{sg.shape[0]} obstacles): ms/step "
              f"{ms_1m if label == '1M' else ms_rand:.4f}, kernel {k_ms:.4f} ms, "
              f"twin {t_ms:.4f} ms (median of {n_twin}); (agent, obstacle) "
              f"pairs: {walk} in a walk of the whole table, {kept} "
              f"evaluated by the kernel ({walk / max(kept, 1):.1f}x fewer), "
              f"{near} within {EXP_ZERO_RANGES} obstacle ranges by box "
              f"distance; bound {b_ms:.4f} ms ({by}; {need / 1e6:.1f} MB, "
              f"{SEG_FLOPS} flops x {near} pairs at "
              f"{F32_FLOP_PER_S / 1e12:.0f} TFLOP/s; {b_ms / k_ms:.1%} of it) "
              f"on {card}", flush=True)
    k_ms, t_ms, b_ms, by = timing["1M"]
    rk, rt, rb_ms, rby = timing["random.toml"]
    _zero_launch_counts()
    dev_rand = _device_profile(sim.tick, RANDOM_PROFILE_TICKS, ms_rand,
                               f"random.toml, segments (a run = a tick; glue = "
                               f"spawn scatter, metrics, zeroing)", card)
    if _launch_counts()["step_kernel_segments"] != RANDOM_PROFILE_TICKS:
        raise AssertionError(f"random.toml profile: launches {_launch_counts()}")
    print(f"# random.toml, segments: wall {ms_rand:.4f} / device {dev_rand:.4f} "
          f"ms a tick; with the spawn scatter that synced the host: "
          f"{RANDOM_TICK_MS_SYNCING[0]} / {RANDOM_TICK_MS_SYNCING[1]} on {card}",
          flush=True)
    _spawn_sync_phase(sim, card)
    print("# segment mode against the step kernel's first design: "
          + _vs_first("step_kernel_segments", k_ms) + ", "
          + _vs_first("step_kernel_segments_random_toml", rk), flush=True)
    return {"name": "step_kernel_segments", "route": "cuda",
            "source": CSRC + "step_kernel.cu",
            "replaces": "pedoni_tpu/ops/pallas/step_kernel.py:898",
            "path": "segments", "launches": counts["step_kernel_segments"],
            "max_abs_err": max(errs), "ms": k_ms, "plain_ms": t_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": None,
            "random_toml": {"launches": rcounts["step_kernel_segments"],
                            "ms": rk, "plain_ms": rt, "bound_ms": rb_ms,
                            "bound_by": rby, "ms_per_tick": ms_rand}}


def _spawn_sync_phase(sim, card) -> None:
    """Spawning steps: the Simulator's own step on random.toml's state (4
    spawn groups, segment mode) and the same grid cut into 2 x 2 tiles on
    this card, SPAWN_SYNC_STEPS steps each under set_sync_debug_mode(
    "error"), from one state and one generator state: no step waits on the
    host, and the tiled step's metrics each step and its grid equal the
    whole grid's."""
    from pedoni_tpu_torch.models import sfm_grid
    from pedoni_tpu_torch.parallel import tile2d

    dev, o = sim.device, sim.options
    flat = sim._to_flat_state()
    tcfg = tile2d.Tile2DConfig.build(sim.cfg, 2, 2, row_block=o.row_block)
    devices = [dev] * tcfg.n_devices
    twp, tob = tile2d.device_inputs(tcfg, sim.maps, sfm_grid.stride_for(sim.cfg),
                                    devices)
    tgen = torch.Generator(device=dev)
    tgen.set_state(sim.generator.get_state())
    tstep = tile2d.make_sharded_step(tcfg, devices,
                                     incremental=sim._resolve_incremental(),
                                     mover_k=o.mover_capacity,
                                     compact_every=o.compact_every, generator=tgen)
    ts = tile2d.make_sharded_grid_state(tcfg, flat, devices)
    gs = sim._from_flat_state(flat)
    torch.cuda.synchronize()
    runs = {"whole": [], "tiled": []}
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(SPAWN_SYNC_STEPS):
            gs, m = sim._step(gs, sim._fwp, sim._fobs)
            runs["whole"].append(torch.stack(list(m)))
        for _ in range(SPAWN_SYNC_STEPS):
            ts, m = tstep(ts, twp, tob)
            runs["tiled"].append(torch.stack(list(m)))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    whole, tiled = (torch.stack(runs[k]).cpu() for k in ("whole", "tiled"))
    n_spawned = int(whole[:, 1].sum())
    if not torch.equal(whole, tiled) or n_spawned == 0:
        raise AssertionError(f"random.toml spawning steps: whole {whole.tolist()} "
                             f"tiled {tiled.tolist()}")
    if not torch.equal(tile2d.gather(tcfg, ts), gs.d):
        raise AssertionError("random.toml spawning steps: tiled grid != whole grid")
    print(f"# spawning steps (random.toml, segments, {n_spawned} agents spawned): "
          f"{SPAWN_SYNC_STEPS} of the whole grid and {SPAWN_SYNC_STEPS} of 2 x 2 "
          f"tiles on one card under set_sync_debug_mode('error'); every metric "
          f"equal each step, grids bit-equal", flush=True)


def _tiles_phase(dev, card, bench) -> dict:
    """10. The 1M workload cut into tiles (parallel/tile2d.py over a device
    list that names this card once a tile), full path and hybrid: each
    kernel with a tile's offsets vs its twin, the tiled step vs the
    whole-grid step for TILE_STEPS steps (every metric each step, the grids
    bit for bit), ms/step tiled and whole, and the ghost exchange's share of
    a tiled step's device time.  Returns this phase's numbers."""
    from pedoni_tpu_torch.models import sfm_grid
    from pedoni_tpu_torch.parallel import tile2d

    bcfg, bmaps, bfwp, bfobs, flat, gs0 = bench
    stride = sfm_grid.stride_for(bcfg)
    phys, size = bcfg.physics, bcfg.scenario.size
    unit, nx, ny = bcfg.grid.unit, bcfg.grid.nx, bcfg.grid.ny
    out = {}
    for tile in TILES:
        tcfg = tile2d.Tile2DConfig.build(bcfg, *tile)
        n_t = tcfg.n_devices
        devices = [dev] * n_t
        twp, tob = tile2d.device_inputs(tcfg, bmaps, stride, devices)
        label = f"{tile[0]}x{tile[1]}"
        for name, incremental in (("full", False), ("hybrid", True)):
            step = sfm_grid.make_step_grid(bcfg, incremental=incremental)
            tstep = tile2d.make_sharded_step(tcfg, devices, incremental=incremental)
            ts = tile2d.make_sharded_grid_state(tcfg, flat, devices)
            gs = gs0
            _zero_launch_counts()
            wm, tm = [], []
            for _ in range(TILE_STEPS):
                gs, m = step(gs, bfwp, bfobs)
                wm.append(torch.stack(list(m)))
            counts_w = _launch_counts()
            _zero_launch_counts()
            for _ in range(TILE_STEPS):
                ts, m = tstep(ts, twp, tob)
                tm.append(torch.stack(list(m)))
            counts = _launch_counts()
            kname = "step_kernel_movers" if incremental else "step_kernel"
            if counts[kname] != n_t * TILE_STEPS or counts_w[kname] != TILE_STEPS:
                raise AssertionError(f"1M {label} {name}: launches {counts}")
            wm, tm = torch.stack(wm).cpu(), torch.stack(tm).cpu()
            if not torch.equal(wm, tm):
                raise AssertionError(f"1M {label} {name}: metrics differ: whole "
                                     f"{wm.tolist()} tiled {tm.tolist()}")
            if not torch.equal(tile2d.gather(tcfg, ts), gs.d):
                raise AssertionError(f"1M {label} {name}: tiled grid != whole grid")
            # a tile's own kernels against their twins, at its offsets
            i = n_t - 1
            r0, c0 = tcfg.origin(i)
            tiles = list(ts.d)
            tile2d.exchange(tcfg, tiles)
            off = dict(row_offset=r0, col_offset=c0, nx_local=tcfg.cols_local)
            e_base, e_mv, g_t, mv_t = _compare_step(
                tiles[i], twp[i], tob[i], phys, size, 8,
                f"1M {label} tile {i}", **off)
            _compare_rebins(g_t, mv_t, unit, nx, ny, f"1M {label} tile {i}", **off)
            if e_base != 0.0 or e_mv != 0.0:
                raise AssertionError(f"1M {label} tile {i}: step kernel err "
                                     f"{e_base}, {e_mv}")
            # times: wall ms/step of each, then device ms/step (profiler)
            _, _, ms_w = _run_timed(step, gs, bfwp, bfobs)
            _, _, ms_t = _run_timed(tstep, ts, twp, tob)
            tensors = [tiles, [torch.empty_like(t) for t in tiles]]
            if incremental:
                tensors.append([torch.empty((t.shape[0], 8, 8, t.shape[3]),
                                            device=dev) for t in tiles])
            ex_ms = _median_ms(lambda: [tile2d.exchange(tcfg, x) for x in tensors])
            state = [ts]

            def run():
                state[0] = tstep(state[0], twp, tob)[0]

            dev_t = _device_profile(run, PROFILE_STEPS // 3, ms_t,
                                    f"1M {label} tiles, {name} (a run = a step)",
                                    card)
            n_agents = int(wm[-1, 0])
            print(f"# 1M {label} tiles on one card, {name} path: {TILE_STEPS} "
                  f"steps equal to the whole grid's (metrics each step, grid bit "
                  f"for bit; {n_agents} active); tile {i} (offsets {r0}, {c0}): "
                  f"step kernel base and mover mode max |err| {e_base:.1e}, "
                  f"both rebins bit-equal to their twins; ms/step tiled "
                  f"{ms_t:.4f} / whole {ms_w:.4f} (wall, {TIMED} steps), tiled "
                  f"device {dev_t:.4f}; ghost exchange {ex_ms:.4f} ms a step "
                  f"({len(tensors)} exchanges of {n_t} tiles, "
                  f"{ex_ms / dev_t:.1%} of the tiled device time) on {card}",
                  flush=True)
            out[f"{label}_{name}"] = {"ms_per_step": ms_t, "whole_ms_per_step": ms_w,
                                      "device_ms_per_step": dev_t,
                                      "exchange_ms": ex_ms, "max_abs_err": e_base}
    return out


def _unit_e(d: torch.Tensor, seed: int) -> torch.Tensor:
    """``d`` with seeded unit vectors in ch 4/5 (2D's desired direction)."""
    gen = torch.Generator(device=d.device).manual_seed(seed)
    e = torch.randn((d.shape[0], d.shape[1], 2, d.shape[3]), generator=gen,
                    device=d.device)
    d2 = d.clone()
    d2[:, :, 4:6] = e / e.norm(dim=2, keepdim=True)
    return d2


def _max_k_check(dev, grid1) -> float:
    """K = MAX_K, the most the pair passes take, on step 1's fields (gap.toml)
    with a crowd and three cells filled to K, K - 9 and K // 2 agents side by
    side and diagonally, so that a pair pass walks every slot level of a tile
    and its halo: the step kernel (base and mover mode, and in segment mode
    with the table walked by either pass) and 2D equal to their twins.
    Returns the largest |err|."""
    import dataclasses

    from pedoni_tpu_torch.convert import agents_from_numpy
    from pedoni_tpu_torch.models import sfm_grid
    from pedoni_tpu_torch.models.sfm import SimState
    from pedoni_tpu_torch.ops.kernels import pairwise as pw
    from pedoni_tpu_torch.ops.kernels import step_kernel as sk

    sc, cfg1, _, fwp, fobs = grid1
    k = MAX_K
    cfg = dataclasses.replace(cfg1, table_capacity=k)
    rng = np.random.default_rng(k)
    pos = np.concatenate([
        rng.uniform(0.01, 23.99, (1500, 2)),
        rng.uniform(0.02, 1.48, (k, 2)) + [9.0, 9.0],
        rng.uniform(0.02, 1.48, (k - 9, 2)) + [10.5, 9.0],
        rng.uniform(0.02, 1.48, (k // 2, 2)) + [12.0, 10.5]])
    n = pos.shape[0]
    agents = agents_from_numpy(pos, rng.normal(0, 0.6, (n, 2)),
                               np.clip(rng.normal(1.34, 0.26, n), 0.1, None),
                               rng.integers(0, 2, n), np.ones(n, bool), dev)
    d = sfm_grid.bin_state(cfg, SimState(agents, 0)).d
    ny2, _, _, nxl = d.shape
    plans = (sk.pair_pass_launch(k, ny2, nxl), sk.pair_pass_launch(k, ny2, nxl, True),
             pw.pairwise_launch(k, ny2, nxl))
    if int(d[:, 0, 7].max()) != k or any(p[3] >= k for p in plans):
        raise AssertionError(f"K {k}: fullest cell {int(d[:, 0, 7].max())}, "
                             f"plans {plans}")
    phys = cfg.physics
    errs = _compare_step(d, fwp, fobs, phys, sc.size, 8, f"gap.toml grid at K {k}")[:2]
    errs += _compare_step(d, fwp, fobs, phys, sc.size, 8,
                          f"gap.toml grid at K {k}, segments",
                          segments=sk.segment_table(_obstacles(sc), dev))[:2]
    d2 = _unit_e(d, k)
    acc, acc_t = pw.pairwise(d2, phys, 2), pw.pairwise_torch(d2, phys, 2)
    torch.cuda.synchronize()
    e_2d = float((acc - acc_t).abs().max())
    if max(errs) != 0.0 or not torch.equal(acc, acc_t):
        raise AssertionError(f"K {k}: step kernel err {errs}, 2D err {e_2d}")
    print(f"# gap.toml grid at K {k} ({n} agents, cells of {k}, {k - 9} and "
          f"{k // 2}): pair passes stage {plans[0][3]} (base, mover), "
          f"{plans[1][3]} (segments) and {plans[2][3]} (2D) levels at once; "
          f"step kernel base, mover and segment mode (both walks) and 2D "
          f"bit-equal to their twins", flush=True)
    return max(*errs, e_2d)


def _large_k_phase(dev, card, bench, d_full, k14_ms, grid1) -> dict:
    """11. The 1M full-path state re-binned at K = BIG_K (the table after 81
    in Simulator._grow_table): the pair passes stage the slot levels in
    chunks there; the step kernel (base and mover mode) and 2D vs their
    twins, and their times beside those at K 14; then ``_max_k_check`` at
    K = MAX_K.  Returns the numbers."""
    import dataclasses

    from pedoni_tpu_torch.models import sfm_grid
    from pedoni_tpu_torch.ops.kernels import pairwise as pw
    from pedoni_tpu_torch.ops.kernels import step_kernel as sk

    bcfg, _bmaps, bfwp, bfobs, _flat, _gs0 = bench
    cfg = dataclasses.replace(bcfg, table_capacity=BIG_K)
    flat = sfm_grid.unbin_state(bcfg, sfm_grid.GridState(d_full, 0))
    d = sfm_grid.bin_state(cfg, flat).d
    ny2, k, _, nxl = d.shape
    phys, size = bcfg.physics, bcfg.scenario.size
    plan = sk.pair_pass_launch(k, ny2, nxl)
    plan2d = pw.pairwise_launch(k, ny2, nxl)
    if plan[3] >= k or plan2d[3] >= k:
        raise AssertionError(f"K {k}: pair passes {plan}, {plan2d} do not chunk")
    e_base, e_mv, g_t, _ = _compare_step(d, bfwp, bfobs, phys, size, 8,
                                         f"1M state at K {k}")
    d2 = _unit_e(d, 7)
    acc = pw.pairwise(d2, phys, 2)
    acc_t = pw.pairwise_torch(d2, phys, 2)
    torch.cuda.synchronize()
    e_2d = float((acc - acc_t).abs().max())
    if e_base != 0.0 or e_mv != 0.0 or not torch.equal(acc, acc_t):
        raise AssertionError(f"K {k}: step err {e_base}, {e_mv}; 2D err {e_2d}")
    step_ms = _median_ms(lambda: sk.fused_step(d, bfwp, bfobs, phys, size))
    pw_ms = _median_ms(lambda: pw.pairwise(d2, phys, 2))
    print(f"# 1M full-path state at K {k} (D {tuple(d.shape)}, "
          f"{_nbytes(d) / 1e9:.2f} GB, {int((d[:, :, 6] > 0.5).sum())} agents): "
          f"pair pass stages {plan[3]} of {k} slot levels at once on 1-row tiles "
          f"({plan[2]} bytes of shared memory), 2D {plan2d[3]} ({plan2d[2]} "
          f"bytes); step kernel (base, mover mode) and 2D bit-equal to their "
          f"twins; step kernel {step_ms:.4f} ms (K 14: {k14_ms[0]:.4f}), 2D "
          f"{pw_ms:.4f} ms (K 14: {k14_ms[1]:.4f}) on {card}", flush=True)
    e_max = _max_k_check(dev, grid1)
    return {"k": k, "step_kernel_ms": step_ms, "pairwise_ms": pw_ms,
            "max_abs_err": max(e_base, e_mv, e_2d), "k_max": MAX_K,
            "k_max_abs_err": e_max}


def _all_pairs_phase(dev, card, sc_gap, bscenario, bmaps, flat, capacity) -> None:
    """7. All-pairs mode: gap.toml evacuates; the 1M problem at the grown
    unit, its ms/step and the step kernel (at stride 8) and both rebins vs
    their twins there."""
    from pedoni_tpu_torch import Simulator, SimulatorOptions
    from pedoni_tpu_torch.models import sfm_grid
    from pedoni_tpu_torch.models.sfm import StepConfig

    _zero_launch_counts()
    sim = Simulator(SimulatorOptions(device=dev.type, seed=1,
                                     use_neighbor_grid=False), sc_gap)
    if (sim.options.neighbor_grid_unit, sim.options.table_capacity) != (2.0, 29):
        raise AssertionError(f"all-pairs options {sim.options}")
    n0, steps = _evacuate(sim, "gap.toml (use_neighbor_grid=False)")
    counts = _launch_counts()
    if counts["step_kernel"] + counts["step_kernel_movers"] != steps:
        raise AssertionError(f"all-pairs gap: launches {counts} vs {steps} steps")
    print(f"# gap.toml, Simulator(use_neighbor_grid=False): unit 2.0 m, K 29, "
          f"{n0} agents evacuated in {steps} steps (limit {GAP_MAX_STEPS}); "
          f"launches {counts}", flush=True)

    o = SimulatorOptions(neighbor_grid_unit=1.5, table_capacity=14,
                         use_neighbor_grid=False).resolved()
    cfg = StepConfig.build(bscenario, capacity=capacity,
                           neighbor_grid_unit=o.neighbor_grid_unit,
                           table_capacity=o.table_capacity,
                           use_neighbor_grid=False)
    stride = sfm_grid.stride_for(cfg)
    fwp, fobs = sfm_grid.field_tensors(cfg, bmaps, dev)
    gs = sfm_grid.bin_state(cfg, flat)
    step = sfm_grid.make_step_grid(cfg)  # the hybrid, as at the 1.5 m unit
    gs, m, ms = _run_timed(step, gs, fwp, fobs)
    n_active = int(m.n_active)
    if n_active < 0.99 * N_AGENTS or not bool(torch.isfinite(gs.d[:, :, 0:4]).all()):
        raise AssertionError(f"1M all-pairs: {n_active} active or non-finite state")
    *e, g_t, mv_t = _compare_step(gs.d, fwp, fobs, cfg.physics, bscenario.size,
                                  8, "1M all-pairs state", stride=stride)
    _compare_rebins(g_t, mv_t, cfg.grid.unit, cfg.grid.nx, cfg.grid.ny,
                    "1M all-pairs state")
    print(f"# 1M all-pairs (unit {o.neighbor_grid_unit} m, K {o.table_capacity}, "
          f"field stride {stride}, D {tuple(gs.d.shape)}): {n_active} active, "
          f"overflow last step {int(m.n_overflow)}, max demand "
          f"{int(m.max_demand)}; {ms:.4f} ms/step (hybrid, {WARMUP} warm-up, "
          f"{TIMED} timed); step kernel vs twin at stride {stride} max |err| "
          f"{e[0]:.3e} (base), {e[1]:.3e} (mover mode); rebin and "
          f"rebin_incremental bit-equal to their twins on all 5 outputs there; "
          f"{_vs_first('all_pairs', ms)} on {card}", flush=True)


def _pairwise_phase(dev, card, d_full, phys) -> dict:
    """8. The standalone pairwise kernel (2D) vs its twin on a random grid
    and on the 1M full-path state with seeded unit vectors in ch 4/5; one
    counted launch; times.  Returns the JSON entry."""
    from pedoni_tpu_torch.ops.kernels import pairwise as pw

    rng = np.random.default_rng(2)
    ny2, k, nx = 42, 8, 128
    dr = np.zeros((ny2, k, 8, nx), np.float32)
    r, j, c = np.nonzero(rng.uniform(size=(ny2 - 2, k, 100)) < 0.4)
    dr[r + 1, j, 0, c + 1] = (c + rng.uniform(size=r.size)) * 1.4
    dr[r + 1, j, 1, c + 1] = (r + rng.uniform(size=r.size)) * 1.4
    dr[r + 1, j, 2:4, c + 1] = rng.normal(0, 1, (r.size, 2))
    e = rng.normal(0, 1, (r.size, 2))
    dr[r + 1, j, 4:6, c + 1] = e / np.linalg.norm(e, axis=1, keepdims=True)
    dr[r + 1, j, 6, c + 1] = 1.0
    dr = torch.from_numpy(dr).to(dev)
    err_r = float((pw.pairwise(dr, phys, 4) - pw.pairwise_torch(dr, phys, 4)).abs().max())

    d = d_full.clone()
    gen = torch.Generator(device=dev).manual_seed(7)
    e = torch.randn((d.shape[0], d.shape[1], 2, d.shape[3]), generator=gen,
                    device=dev)
    d[:, :, 4:6] = e / e.norm(dim=2, keepdim=True)
    _zero_launch_counts()
    acc = pw.pairwise(d, phys, 2)
    torch.cuda.synchronize()
    counts = _launch_counts()
    want = pw.pairwise_torch(d, phys, 2)
    err = float((acc - want).abs().max())
    if counts != dict(dict.fromkeys(counts, 0), pairwise=1):
        raise AssertionError(f"pairwise: launches {counts}")
    if not (err_r <= TOL and err <= TOL) or not float(want.abs().max()) > 0.1:
        raise AssertionError(f"pairwise: err {err_r:.3e} (random), {err:.3e} (1M)")
    k_ms = _median_ms(lambda: pw.pairwise(d, phys, 2))
    t_ms = _median_ms(lambda: pw.pairwise_torch(d, phys, 2), n=5)
    need = _needed_bytes("pairwise", (d,), (acc,))
    flops, within, beyond = _pairwise_flops(d, phys.cutoff_sq)
    b_ms, by = _bound(need, flops)
    print(f"# pairwise (2D): max |err| {err_r:.3e} on a random grid "
          f"{tuple(dr.shape)}, {err:.3e} on the 1M full-path state "
          f"{tuple(d.shape)} with seeded unit e (tol {TOL}); launches "
          f"{counts}; kernel {k_ms:.4f} ms, twin {t_ms:.4f} ms (median of 5), "
          f"bound {b_ms:.4f} ms ({by}; {need / 1e6:.1f} MB at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; {within} pairs within the "
          f"cutoff x {PAIR_FLOPS} + {beyond} past it x {PAIR_TEST_FLOPS} = "
          f"{flops / 1e9:.3f} GFLOP at {F32_FLOP_PER_S / 1e12:.0f} TFLOP/s; "
          f"{b_ms / k_ms:.1%} of it); tiles of "
          f"{pw.pairwise_launch(d.shape[1], d.shape[0], d.shape[3])[0]} "
          f"rows; {_vs_first('pairwise', k_ms)} on {card}", flush=True)
    return {"name": "pairwise", "route": "cuda", "source": CSRC + "pairwise.cu",
            "replaces": "pedoni_tpu/ops/pallas/pairwise.py:177",
            "path": "standalone", "launches": counts["pairwise"],
            "max_abs_err": max(err_r, err), "ms": k_ms, "plain_ms": t_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": None}


def _agent_rows(a) -> np.ndarray:
    """The active agents of a checkpoint or of ``agents_to_numpy`` as
    sorted rows (pos, vel, speed, dest)."""
    rows = np.concatenate([a["pos"], a["vel"], a["speed"][:, None],
                           a["dest"][:, None].astype(np.float32)], 1)[a["active"]]
    return rows[np.lexsort(rows.T[::-1])]


def _npz_rows(path) -> np.ndarray:
    with np.load(path) as z:
        return _agent_rows(z)


def _cli_phase() -> None:
    """9. The CLI as subprocesses: a --no-distance-map run with checkpoints,
    then a run resumed from its step-100 checkpoint."""
    import tempfile

    from pedoni_tpu_torch import checkpoint, cli
    from pedoni_tpu_torch.convert import agents_to_numpy

    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        base = [str(GAP), "-H", "-s", "0", "--seed", "1", "--no-distance-map",
                "--checkpoint-every", "100"]
        ck100 = tmp / "ck" / "step_00000100.npz"
        runs = {"first": (base + ["--max-steps", "300", "--log-dir", str(tmp / "logs"),
                                  "--checkpoint-dir", str(tmp / "ck")], 300),
                "resumed": (base + ["--max-steps", "200", "--log-dir",
                                    str(tmp / "logs2"), "--checkpoint-dir",
                                    str(tmp / "ck2"), "--resume", str(ck100)], 200)}
        for name, (argv, n_steps) in runs.items():
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, "-m", "pedoni_tpu_torch", *argv],
                               cwd=ROOT, capture_output=True, text=True, timeout=600)
            if r.returncode != 0:
                raise AssertionError(f"CLI ({name}) exited {r.returncode}:\n"
                                     f"{r.stderr[-3000:]}")
            log_dir = pathlib.Path(argv[argv.index("--log-dir") + 1])
            (out,) = log_dir.glob("*_log.json")
            log = json.loads(out.read_text())
            pops = log["step_metrics"]["active_ped_count"]
            if log["total_steps"] != n_steps or pops[-1] != 0:
                raise AssertionError(f"CLI ({name}): {log['total_steps']} steps, "
                                     f"population {pops[-1]} at the end")
            print(f"# CLI ({name}): python -m pedoni_tpu_torch "
                  f"{' '.join(a if tmp.name not in a else '<tmp>' for a in argv)}"
                  f" -> exit 0 in {time.perf_counter() - t0:.1f} s, log "
                  f"{out.name}, population {pops[0]} -> 0 at logged step "
                  f"{pops.index(0) + 1}", flush=True)

        args = cli.build_parser().parse_args(runs["resumed"][0])
        sim = cli.make_simulator(args)
        checkpoint.restore(sim, args.resume)
        rows = _agent_rows(agents_to_numpy(sim._to_flat_state().agents))
        with np.load(ck100) as z:
            gen = torch.from_numpy(z["torch_generator"])
        if not (sim.step_count == 100 and np.array_equal(rows, _npz_rows(ck100))
                and torch.equal(sim.generator.get_state(), gen)):
            raise AssertionError("resumed agents or generator differ from the "
                                 "step-100 checkpoint")
        for s in (200, 300):
            name = f"step_{s:08d}.npz"
            if not np.array_equal(_npz_rows(tmp / "ck2" / name),
                                  _npz_rows(tmp / "ck" / name)):
                raise AssertionError(f"resumed run's {name} differs from the first run's")
        print(f"# CLI resume: the simulator restored from step 100 holds the "
              f"saved {rows.shape[0]} agents exactly and the saved generator "
              f"state; the resumed run's step-200 and step-300 checkpoints "
              f"equal the first run's", flush=True)
        n = torch.cuda.device_count()
        r = subprocess.run([sys.executable, "-m", "pedoni_tpu_torch", str(GAP), "-H",
                            "--devices", str(n + 1), "--max-steps", "1",
                            "--log-dir", str(tmp / "logs3")],
                           cwd=ROOT, capture_output=True, text=True, timeout=300)
        said = f"--devices {n + 1} but only {n} devices are visible"
        if r.returncode == 0 or said not in r.stderr:
            raise AssertionError(f"CLI --devices {n + 1}: exit {r.returncode}, "
                                 f"{r.stderr[-2000:]}")
        print(f"# CLI --devices {n + 1}: exit {r.returncode}, \"{said}\"",
              flush=True)


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

    t_start = t0 = time.perf_counter()
    _build.library()
    print(f"# kernels built from {_build.CSRC.relative_to(_build.CSRC.parents[3])}"
          f" -> {_build.library_path().name} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for line in _build.build_log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
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
    _compare(d, fwp, fobs, cfg.physics, sc.size, 1.5, cfg.grid.nx, cfg.grid.ny,
             4, "random grid (gap fields, 1500 agents)")
    grid1 = (sc, cfg, d, fwp, fobs)

    # 2. gap.toml through the Simulator: the physics gate, on the rebin the
    # auto rule picks (full at this occupancy) and on the forced hybrid
    for forced in (None, True):
        _zero_launch_counts()
        sim = Simulator(SimulatorOptions(device="cuda", seed=1,
                                         incremental_rebin=forced), sc)
        n0, steps = _evacuate(sim, f"gap.toml ({forced=})")
        counts = _launch_counts()
        used = (("step_kernel_movers", "rebin") if forced
                else ("step_kernel", "rebin"))
        if any(counts[kname] != steps for kname in used):
            raise AssertionError(f"gap.toml: launch counts {counts} vs {steps} steps")
        print(f"# gap.toml (incremental_rebin={forced}, resolved "
              f"{sim._resolve_incremental()}): {n0} agents evacuated in {steps} "
              f"steps (limit {GAP_MAX_STEPS}); launches {counts}", flush=True)

    # 3. spawning parity, incremental vs full, with and without fallback
    _spawn_parity(dev)

    # 4. the 1M-agent bench workload: the full path, then the hybrid
    t0 = time.perf_counter()
    bscenario, bmaps, bcfg, flat = build_problem(N_AGENTS, device=dev)
    bfwp, bfobs = sfm_grid.field_tensors(bcfg, bmaps, dev)
    gs0 = sfm_grid.bin_state(bcfg, flat)
    torch.cuda.synchronize()
    dims = tuple(gs0.d.shape)
    print(f"# 1M problem: grid {bcfg.grid.nx} x {bcfg.grid.ny} cells, D {dims}, "
          f"{int((gs0.d[:, :, 6] > 0.5).sum())} agents binned, set-up "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    n_steps = WARMUP + TIMED
    paths = {}
    for name, incremental in (("full", False), ("hybrid", True)):
        step = sfm_grid.make_step_grid(bcfg, incremental=incremental)
        gs = gs0
        _zero_launch_counts()
        for _ in range(WARMUP):
            gs, m = step(gs, bfwp, bfobs)
        torch.cuda.synchronize()
        if incremental:
            torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        for _ in range(TIMED):
            gs, m = step(gs, bfwp, bfobs)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / TIMED
        torch.cuda.set_sync_debug_mode("default")
        counts = _launch_counts()
        n_active = int(m.n_active)
        held = gs.d[:, :, 6] > 0.5
        if not bool(torch.isfinite(gs.d[:, :, 0:4][held.unsqueeze(2).expand(-1, -1, 4, -1)]).all()):
            raise AssertionError(f"1M {name}: non-finite positions or velocities")
        if n_active < 0.99e6:
            raise AssertionError(f"1M {name}: only {n_active} agents active")
        n_full = int(step.full_rebins) if incremental else n_steps
        if incremental:
            n_compact = -(-n_steps // 8)
            want = {"step_kernel": 0, "step_kernel_movers": n_steps,
                    "step_kernel_segments": 0, "rebin": n_steps,
                    "rebin_incremental": n_steps - n_compact, "pairwise": 0}
            if counts != want:
                raise AssertionError(f"1M hybrid: launches {counts} != {want}")
            if not 0 < n_full < n_steps:
                raise AssertionError(f"1M hybrid: {n_full} of {n_steps} steps "
                                     "took the full rebin; both branches must run")
            branches = (f"; rebin taken (device counter): full {n_full}, "
                        f"incremental {n_steps - n_full} of {n_steps} steps; "
                        f"peak mover demand last step {int(m.max_mover_demand)}; "
                        f"timed steps under set_sync_debug_mode('error')")
        else:
            want = {"step_kernel": n_steps, "step_kernel_movers": 0,
                    "step_kernel_segments": 0, "rebin": n_steps,
                    "rebin_incremental": 0, "pairwise": 0}
            if counts != want:
                raise AssertionError(f"1M full: launches {counts} != {want}")
            branches = ""
        print(f"# 1M {name} path: {n_steps} steps ({WARMUP} warm-up), "
              f"{n_active} active, overflow last step {int(m.n_overflow)}, max "
              f"demand {int(m.max_demand)}; {dt * 1e3:.4f} ms/step, "
              f"{n_active / dt:.4e} agent-steps/s; launches {counts}{branches} "
              f"on {card}", flush=True)
        paths[name] = (dt, counts, step, gs, n_full)
    # the profiles come after both timed runs: a profiler once started
    # slows the host's launches for the rest of the process
    for name, (dt, counts, step, gs, n_full) in paths.items():
        gs = _profile(step, gs, bfwp, bfobs, dt * 1e3, name, card)
        paths[name] = (dt, counts, gs.d, n_full)
    print(f"# 1M ms/step on {card}: hybrid {paths['hybrid'][0] * 1e3:.4f}, "
          f"full {paths['full'][0] * 1e3:.4f}", flush=True)
    packed = sk.packed_fields(bfwp, bfobs)
    tile = sk.pair_pass_launch(dims[1], dims[0], dims[3])
    print(f"# 1M step kernel: texel-major field copy {_nbytes(packed) / 1e6:.1f} "
          f"MB beside the fields6 planes' {_nbytes(bfwp, bfobs) / 1e6:.1f} MB; "
          f"pair pass tiles of {tile[0]} rows x {sk.TILE_LANES} lanes, "
          f"{tile[1]} threads, {tile[2]} bytes of shared memory a block",
          flush=True)
    for label, mk_ in (("rebin", 0), ("rebin_incremental", 8)):
        t_rows, t_lanes, t_threads, t_smem = rb.rebin_launch(
            dims[1], mk_, dims[0], dims[3], 2)
        print(f"# 1M {label}: tiles of {t_rows} rows x {t_lanes} lanes, "
              f"{t_threads} threads, {t_smem} bytes of shared memory a block, "
              f"{dims[3] // t_lanes * ((dims[0] - 2) // t_rows)} blocks",
              flush=True)
    print("# 1M ms/step against the step kernel's first design: " + ", ".join(
        _vs_first(p, paths[p][0] * 1e3) for p in ("hybrid", "full")), flush=True)

    # 5. kernels vs twins on each path's own 1M state, and their times
    d_full, d_hyb = paths["full"][2], paths["hybrid"][2]
    phys, size = bcfg.physics, bcfg.scenario.size
    unit, nx, ny = bcfg.grid.unit, bcfg.grid.nx, bcfg.grid.ny
    mk = 8
    step_err, _ = _compare(d_full, bfwp, bfobs, phys, size, unit, nx, ny, mk,
                           "1M full-path state")
    _, mover_err = _compare(d_hyb, bfwp, bfobs, phys, size, unit, nx, ny, mk,
                            "1M hybrid state")
    g = sk.fused_step_torch(d_full, bfwp, bfobs, phys, size)
    g_mv, m_mv, movf, mdmx = sk.fused_step_torch(d_hyb, bfwp, bfobs, phys, size,
                                                 emit_movers=mk)
    rb_out = rb.rebin_torch(g, unit, nx, ny)
    inc_out = rb.rebin_incremental_torch(g_mv, m_mv, unit, nx, ny)
    io = {"step_kernel": ((d_full, bfwp, bfobs), (g,)),
          "step_kernel_movers": ((d_hyb, bfwp, bfobs), (g_mv, m_mv, movf, mdmx)),
          "rebin": ((g,), rb_out),
          "rebin_incremental": ((g_mv, m_mv), inc_out)}
    flops = {"step_kernel": _pair_candidates(d_full) * PAIR_FLOPS,
             "step_kernel_movers": _pair_candidates(d_hyb) * PAIR_FLOPS}
    need = {name: _needed_bytes(name, ins, outs) for name, (ins, outs) in io.items()}
    bounds = {name: _bound(need[name], flops.get(name, 0.0)) for name in io}
    times = {
        "step_kernel": (_median_ms(lambda: sk.fused_step(d_full, bfwp, bfobs, phys, size)),
                        _median_ms(lambda: sk.fused_step_torch(d_full, bfwp, bfobs, phys, size),
                                   n=TWIN_RUNS)),
        "step_kernel_movers": (
            _median_ms(lambda: sk.fused_step(d_hyb, bfwp, bfobs, phys, size,
                                             emit_movers=mk)),
            _median_ms(lambda: sk.fused_step_torch(d_hyb, bfwp, bfobs, phys, size,
                                                   emit_movers=mk), n=TWIN_RUNS)),
        "rebin": (_median_ms(lambda: rb.rebin(g, unit, nx, ny)),
                  _median_ms(lambda: rb.rebin_torch(g, unit, nx, ny), n=TWIN_RUNS)),
        "rebin_incremental": (
            _median_ms(lambda: rb.rebin_incremental(g_mv, m_mv, unit, nx, ny)),
            _median_ms(lambda: rb.rebin_incremental_torch(g_mv, m_mv, unit, nx, ny),
                       n=TWIN_RUNS)),
    }
    meta = {
        "step_kernel": ("step_kernel.cu", "pedoni_tpu/ops/pallas/step_kernel.py:898",
                        "full", step_err),
        "step_kernel_movers": ("step_kernel.cu",
                               "pedoni_tpu/ops/pallas/step_kernel.py:898",
                               "hybrid", mover_err),
        "rebin": ("rebin.cu", "pedoni_tpu/ops/pallas/rebin.py:570", "full", 0.0),
        "rebin_incremental": ("rebin_incremental.cu",
                              "pedoni_tpu/ops/pallas/rebin.py:488", "hybrid", 0.0),
    }
    for name, (k_ms, t_ms) in times.items():
        b_ms, by = bounds[name]
        print(f"# {name} on the 1M {meta[name][2]}-path state: kernel {k_ms:.4f} "
              f"ms, twin {t_ms:.4f} ms, bound {b_ms:.4f} ms ({by}; "
              f"{need[name] / 1e6:.1f} MB needed of "
              f"{_nbytes(*io[name][0], *io[name][1]) / 1e6:.1f} MB in the tensors; "
              f"{b_ms / k_ms:.1%} of it) (medians of 20 and {TWIN_RUNS}, CUDA "
              f"events) on {card}",
              flush=True)
    print("# step kernel against its first design: " + ", ".join(
        _vs_first(n, times[n][0]) for n in ("step_kernel", "step_kernel_movers")),
        flush=True)
    print("# rebins against their first designs: " + ", ".join(
        _vs_first(n, times[n][0]) for n in ("rebin", "rebin_incremental")),
        flush=True)

    kernels = []
    for name, (src, replaces, path, err) in meta.items():
        kernels.append({
            "name": name, "route": "cuda", "source": CSRC + src,
            "replaces": replaces, "path": path,
            "launches": paths[path][1][name], "max_abs_err": err,
            "ms": times[name][0], "plain_ms": times[name][1],
            "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
            "library_ms": None})
        if name == "rebin":  # launched every hybrid step, run when selected
            kernels[-1].update(hybrid_launches=paths["hybrid"][1][name],
                               hybrid_bodies_run=paths["hybrid"][3])

    t0 = time.perf_counter()
    kernels.append(_segments_phase(dev, card, grid1, (bcfg, bfwp, bfobs, gs0),
                                   {"full": d_full, "hybrid": d_hyb}))
    print(f"# phase 6 (segments) took {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    _all_pairs_phase(dev, card, sc, bscenario, bmaps, flat, bcfg.capacity)
    print(f"# phase 7 (all-pairs) took {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    kernels.append(_pairwise_phase(dev, card, d_full, phys))
    print(f"# phase 8 (pairwise) took {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    _cli_phase()
    print(f"# phase 9 (CLI) took {time.perf_counter() - t0:.1f} s", flush=True)
    bench = (bcfg, bmaps, bfwp, bfobs, flat, gs0)
    t0 = time.perf_counter()
    tiled = _tiles_phase(dev, card, bench)
    print(f"# phase 10 (tiles) took {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    big_k = _large_k_phase(dev, card, bench, d_full,
                           (times["step_kernel"][0], kernels[-1]["ms"]), grid1)
    print(f"# phase 11 (K {BIG_K}, K {MAX_K}) took {time.perf_counter() - t0:.1f} s",
          flush=True)
    for entry in kernels:  # the forms of each kernel this run held to its twin
        if entry["name"] != "pairwise":
            entry["tile_offsets"] = "ported"
        if entry["name"] != "rebin" and entry["name"] != "rebin_incremental":
            entry["k_up_to"] = big_k["k_max"]  # the largest K compared here
    kernels[0]["tiles_1m"] = tiled
    kernels[0][f"k{BIG_K}"] = {n: big_k[n] for n in ("step_kernel_ms", "max_abs_err")}
    kernels[-1][f"k{BIG_K}"] = {"ms": big_k["pairwise_ms"],
                                "max_abs_err": big_k["max_abs_err"]}
    print(f"# chip_smoke.py took {time.perf_counter() - t_start:.1f} s, the "
          f"kernel build included", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
