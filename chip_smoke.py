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
10. the 1M workload cut into 1 x 2, 2 x 1 and 2 x 2 tiles, every tile on this
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
   kernel (base, mover and segment mode) and 2D equal to their twins;
12, 13. the bench problem at 8 and at 33 waypoints (``build_problem(
   waypoints=W)``, 1M agents on the full 1024 lanes):
   16 hybrid steps (launch counts zeroed before, read after; >= 99% of the
   agents active, positions finite, agents bound for every plane), their
   peak device memory (``max_memory_allocated`` after
   ``reset_peak_memory_stats``) within ``sfm_grid.device_bytes``; the step
   kernel (base, mover and segment mode) and both rebins against their
   twins on the state they leave; the step kernel's ms beside W = 1's; and
   ``sfm_grid.supports`` refusing the configuration one byte below
   ``device_bytes``;
14. ``python -m pedoni_tpu_torch.bench --steps 8 --warmup 2`` as a
   subprocess: exit 0, exactly one JSON line, value > 0, its ``device`` this
   card, and the hybrid's kernels launched in its timed rounds;
15. the flat backend (``backend="xla"``, the default since it was ported),
   which launches four kernels once each a step and no other: the flat
   sample kernel (csrc/flat_sample.cu: field taps, despawn, cell id, packed
   rows), after the sort the flat scatter kernel (csrc/flat_scatter.cu:
   sorted rows, cell layout, padded cell grid), the flat pair kernel
   (csrc/flat_pairwise.cu) and the flat integrate kernel
   (csrc/flat_integrate.cu: force sum, integration); every run below is
   held to exactly that (no pair kernel in all-pairs mode).  gap.toml through
   ``Simulator`` evacuates within 400 ticks at the 1.4 m unit; one flat
   step on the card against the same step on the CPU from the same state
   and candidates (pos/vel within 1e-5, every metric and the rest equal)
   on the spawning scenario in all three modes and on the xla bench
   problem at 20 000 agents; 16 spawning flat steps under
   ``set_sync_debug_mode("error")``; the 1M xla bench problem (square
   field, 452 x 452 cells of 1.4 m): ms/step on the host clock over steps
   run under ``set_sync_debug_mode("error")``, the launch counts zeroed
   before and read after, device ms/step, launches a step, busy share and
   the ten dearest kernels from ``torch.profiler`` (no gather of the
   field's [R, 8] rows nor of [N, 12] agent rows left in it), beside the
   step's before its scatter and integrate kernels, peak memory; the
   [N, 12] row gather alone
   (``index_select``, ``packed[order]``, ``torch.gather``, a sorted order,
   narrower rows, fewer rows, and a contiguous copy of the same bytes),
   with the cause of its cost; the flat pair kernel against its twin
   bit for bit on seeded grids (K 14, 16, 64 and 255, a ragged nx, an
   x-strip's window) and on the 1M problem's padded grid, and there
   kernel, twin and bound timed beside its first design; the flat sample
   kernel against its twin bit for bit (12 channels, NaN where the twin's
   is, and the cell ids) on tests/test_torch_flat_sample_cases.py's edge
   cases, with and without sanitizing, at one agent and a ragged count,
   and on the 1M problem's agents, and there kernel, twin and bound
   timed beside its us/step in the step's profile, the taps' footprint in
   32-byte sectors and ``grid_sample`` of the taps alone (the library
   call); the flat scatter kernel
   against its twin bit for bit (every output, the padded grid whole) on
   tests/test_torch_flat_scatter_cases.py's cases (cells past K, the
   sentinel run, holes, N > C, NaN and inf rows, K 255, a ragged nx, an
   x-strip's window; also without cells and with the pallas slot grid's
   strides) and on the 1M problem's sorted agents, and the flat
   integrate kernel against its twin bit for bit on those cases' rows in
   each obstacle and pair mode and on the 1M problem's, each timed there
   with its twin and bound (the row gather alone as the scatter's library
   call); ``python -m
   pedoni_tpu_torch.bench --backend xla``, the CLI on gap.toml with ``-b
   auto`` and ``-b xla`` (population 0, model ``sfm-torch/xla``) and
   ``python -m pedoni_tpu_torch.entry`` as subprocesses;
   ``SocialForceModel`` on the card against its CPU run; and
   ``examples/quickstart_torch.py``.  Every earlier phase that means the
   grid passes ``backend="grid"`` (``-b grid``);
16. the pallas backend (``backend="pallas"``: flat agents sorted into a
   slot grid that the step kernel advances, models/sfm_pallas.py): gap.toml
   through ``Simulator`` evacuates within 400 ticks, one step kernel
   launch a tick, with the distance map and in segment mode; pallas steps
   on the card against the CPU in base and segment mode on the spawning
   scenario (every metric equal, positions and velocities within TOL, the
   velocities of agents in near contact within NEAR_CONTACT_VEL_TOL); 16
   spawning steps under ``set_sync_debug_mode("error")``; the 1M pallas bench
   problem (square field, 422 x 422 cells of 1.5 m): ms/step on the host
   clock over steps run under ``set_sync_debug_mode("error")`` with the
   launch counts zeroed before and read after, peak memory within
   ``sfm_pallas.device_bytes``, the step kernel against its twin on the
   slot grid the step makes (base and segment mode, timed, bound), device
   ms/step, launches a step, busy share and the dearest kernels from
   ``torch.profiler``; ``python -m pedoni_tpu_torch.bench --backend
   pallas``, the CLI on gap.toml with ``-b pallas`` (model
   ``sfm-torch/pallas``) and ``-b cpu`` (the flat step on the CPU, model
   ``sfm-torch/xla``, 100 steps), one ``-b grid`` run with ``--record-every 10
   --frame-every 100 --profile DIR`` on the card (traj.bin read back
   against the log, the PNG frames, a trace naming ``step_sample`` and
   ``step_pairs``) and one ``-b pallas`` run in the non-headless mode with
   ``--render-web 0`` (terminal frames drawn, the web view served, 60
   steps logged) as subprocesses.  The step kernel's entries in the
   kernels line list their paths, the pallas path's numbers among them;
17. the 1M workload as 2 x 1 and 2 x 2 tiles over two processes of one
   ``torch.distributed`` group (parallel/transport.py; rank r owns tile row
   r), full path and hybrid: over gloo with both ranks on this card (each
   crossing buffer staged through pinned host memory), and over NCCL with
   rank r on cuda:r where there are two cards or more (else a line says
   why it did not run).  The ranks are this script run again with
   ``--rank R --store FILE --backend B --out PREFIX`` (``_rank_main``),
   started and, when one fails or RANK_TIMEOUT passes, killed together by
   ``transport.run_ranks``.  TILE_STEPS steps: metrics equal on both ranks
   and to rank 0's single-process whole-grid run each step, the grid
   gathered on rank 0 bit-equal to it, each rank launching the kernels of
   its own tiles; wall and device ms/step (the device time of each rank's
   kernels) and the cross-rank exchanges' ms a step, beside phase 10's
   one-process numbers for the same tiling;
18. the 1M xla problem (phase 15's) cut into x-strips
   (parallel/spatial.py; one launch of each of the four flat kernels a
   strip-step, and no other kernel's): 2 strips on this card, and one
   strip a card where there are more: the first step from the same state
   equal to the flat step's (every metric; rows order-free, velocities
   within TOL, NEAR_CONTACT_VEL_TOL in near contact, positions within TOL
   or one float apart, whose spacing passes TOL beyond 128 m), then
   SPATIAL_STEPS chained steps of each (n_spawned equal; the n_active
   difference and the largest position difference printed); wall and
   device ms/step and peak memory beside the flat step's; then (18b) the
   drift's cause: 2 strips against the flat step over 1 + SPATIAL_STEPS
   chained steps at the problem's K and at DRIFT_K, where no cell
   overflows (the overflow of each step printed), and the flat step
   against itself from a state one float apart, each with where its
   largest difference sits against the strips' edge;
19. the fidelity harness (pedoni_tpu_torch/fidelity.py), launch counts
   zeroed before and read after (each runtime kernel launched, the four
   flat kernels among them): gap.toml
   through the ``Simulator`` of ``xla``, ``grid`` and ``pallas`` at seeds
   1-8, every count in the reference's band [160, 340] and each backend's
   mean within three standard errors of the reference's record, 246 +- 22
   steps over 8 seeds; every geometry and seed of the identical-state
   harness (gap, multiwp, funnel: the reference's narrow_gap reads a
   file this repository does not hold) on the three backends within
   max(3, 5%) of the f64 oracle (tests/oracle_sfm.py, on the host), the grid losing no agent;
   the four runtime kernels against their twins on the funnel's grid
   after 150 steps; the counts, their means and the phase's seconds.
20. the grid step's spawn scatter kernel (csrc/spawn_scatter.cu) on
   scenarios/random.toml's grid state after SPAWN_FILL_TICKS ticks of
   ``Simulator(backend="grid")`` (one launch a tick, counted): against its
   twin bit for bit there (grid and counts) on a draw of its sampler and on
   the same draw with every candidate active; the kernel alone and the
   twin (the plain PyTorch composition it replaced) each timed by
   ``_median_ms``, chained in place on a copy of the state, with the bytes
   bound, beside ``Simulator.measure_spawn_time`` (a draw and the scatter,
   SPAWN_TIMED chained).

Each phase from 6 on prints its seconds.  With arguments the script is
one rank of phase 17 and prints no result line.  Prints the card's name and power
limit, one JSON line describing the kernels, and as its last line
{"ok": true, "device": {...}}.  Exits non-zero, with no result line, on any
failure or without a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import datetime
import importlib.util
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile
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
# float operations of one forces.pair_terms pair within the cutoff, as
# csrc/flat_pairwise.cu evaluates it (seven divides, four sqrt, one exp, the
# FOV test, the damping and the two adds of the sum each counted once)
FLAT_PAIR_FLOPS = 63
# float operations of one agent of csrc/flat_sample.cu (the coordinates,
# three lerps of six channels, the normalisation, the cell id and the tests,
# each counted once)
FLAT_SAMPLE_FLOPS = 60
# float operations of one agent of csrc/flat_integrate.cu (the goal term, the
# obstacle term, the two adds of the sum and the integration with its clamp,
# each counted once); csrc/flat_scatter.cu does none (copies and integers)
FLAT_INTEGRATE_FLOPS = 42
FLAT_KERNELS = ("flat_sample", "flat_scatter", "flat_pairwise", "flat_integrate")
# agents of a ragged flat sample check: one above a multiple of the 512
# agents a block of csrc/flat_sample.cu takes, so its last warp holds one
SAMPLE_RAGGED = 37 * 512 + 1
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
SPAWN_FILL_TICKS = 3000  # phase 20: random.toml's fill, as the benchmark's tick cells
SPAWN_TIMED = 20  # phase 20: chained spawns of measure_spawn_time
GRID_KERNELS = {"step_sample": "step_kernel", "step_pairs": "step_kernel",
                "rebin_full": "rebin", "spawn_scatter_kernel": "spawn_scatter"}
TILES = ((1, 2), (2, 1), (2, 2))  # the 1M workload's tilings, all on one card
TILE_STEPS = 16  # steps of the tiled and the whole-grid 1M step compared
BIG_K = 121  # the table capacity after 81 in Simulator._grow
WP_STEPS = 16  # hybrid steps of the bench problem at 8 and 33 waypoints
MAX_K = 255  # the largest table capacity the pair passes take
FLAT_WARMUP, FLAT_TIMED = 2, 10  # steps of the 1M flat (xla) problem
FLAT_PROFILE_STEPS = 4
FLAT_TWIN_PASS_BYTES = 1 << 28  # the twin's pass budget on the card (2 at 1M)
FLAT_TOP_KERNELS = 10  # the 1M flat profile's dearest kernels printed
PALLAS_WARMUP, PALLAS_TIMED = 4, 20  # steps of the 1M pallas problem
# A pallas step on the card against the same step on the CPU holds
# velocities to TOL, except an agent in near contact: another active agent
# closer than NEAR_CONTACT (m) at the step's input.  Its velocity is held
# to NEAR_CONTACT_VEL_TOL.  The kernel equals its twin on the card bit for
# bit, but the twin's rsqrt and exp are CUDA's rsqrtf and expf there (up to
# 2 ulp) and the CPU's elsewhere, and near contact the reference's pair
# formula takes a difference of nearly equal squares: a pair 4.9 mm apart
# moved 1.75e-5 between the two; on the CPU, rsqrt and exp a few ulp off
# move no other velocity by 5e-6 (tests/test_torch_pallas_backend.py::
# test_near_contact_bounds_the_card_gate).
NEAR_CONTACT = 0.01
NEAR_CONTACT_VEL_TOL = 1e-4
PALLAS_PROFILE_STEPS = 8
CPU_CLI_STEPS = 100  # steps of the `-b cpu` CLI run (the flat step on the CPU)
RANK_TILES = ((2, 1), (2, 2))  # phase 17: tilings whose rows split over 2 ranks
RANK_TIMEOUT = 300  # s: phase 17's ranks, and their process group's timeout
EXCHANGE_RUNS = 20  # timed exchanges a case in phase 17 (host clock)
SPATIAL_STEPS = 10  # chained steps of phase 18's strips and flat step
SPATIAL_PROFILE_STEPS = 2  # of each, profiled after them
DRIFT_K = 32  # phase 18b: a table capacity no cell of the 1M problem fills
# phase 19: gap.toml's seeds on each backend's Simulator, held to the
# reference's record, 246 +- 22 steps over 8 seeds (FIDELITY.md:18), and
# to the reference's frozen band (tests/test_regression_bands.py:24)
GAP_SEEDS = 8
GAP_RECORD = (246.0, 22.0, 8)  # mean, standard deviation (kind unstated), seeds
GAP_BAND = (160, 340)
FIDELITY_STATE_STEPS = 150  # funnel steps before its state meets the twins
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
                   "pairwise": 0.5632, "flat_pairwise": 1.1263}
# Each path's device ms/step (and the flat step's launches a step) before
# the flat sample kernel's redesign, from this script's run then (PERF.md
# section 5; NVIDIA H100 80GB HBM3, 700 W), printed beside this run's;
# nothing is gated on them
EARLIER_DEVICE_MS = {"full": 0.4335, "hybrid": 0.4815, "pallas": 1.1425,
                     "flat": 0.8982, "flat_launches": 23.5, "strips": 3.4569}
GATHER_RUNS = 20  # timed runs of each form of the [N, 12] row gather
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
SM_COUNT = 132  # H100 SXM streaming multiprocessors
BLOCKS_PER_SM = 32  # the most resident thread blocks an SM holds (Hopper)


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
    from pedoni_tpu_torch.ops.kernels import launch_counts
    return launch_counts()


def _zero_launch_counts() -> None:
    from pedoni_tpu_torch.ops.kernels import zero_launch_counts
    zero_launch_counts()


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
    from pedoni_tpu_torch.utils import trace

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
            trace.enable(True)  # step.full_rebins counts while tracing is on
            try:
                for cand in cands:
                    gs, m = step(gs, fwp, fobs, cand)
                    ms.append(metrics_to_dict(m))
            finally:
                trace.enable(False)
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
    - flat_pairwise: the ch 6 plane, ch 0, 1, 4, 5 of every slot of each
      interior cell whose 3x3 window holds an active slot (the others
      write +0 unread), ch 2-3 of the active slots and ch 0-1 of the
      active ring slots (only active candidates are evaluated);
    - flat_sample: each agent's pos, vel, speed, dest and active flag, and
      channels 0-5 of each distinct texel row its four taps read;
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
    if name == "flat_pairwise":
        d = ins[0]
        word = d.element_size()
        act = d[..., 6] > 0.5  # [ny2, nx2, K]
        occ = act.any(-1).float()[None, None]
        live = int(torch.nn.functional.max_pool2d(occ, 3, stride=1).sum())
        ring = act.clone()
        ring[1:-1, 1:-1] = False
        return (act.numel() * word + 4 * word * live * d.shape[2]
                + 2 * word * (int(act.sum()) + int(ring.sum())) + out_b)
    if name == "flat_sample":
        rows, hp, wp, pos, vel, speed, dest, active, unit = ins
        return (_nbytes(pos, vel, speed, dest, active) + out_b
                + 6 * rows.element_size() * _tap_rows(rows, hp, wp, pos, dest, unit))
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


def _tap_index(rows, hp: int, wp: int, pos, dest, unit: float) -> torch.Tensor:
    """The rows of ``rows`` that the four bilinear taps of the agents at
    ``pos`` bound for ``dest`` read, [4, N] (sampling.sample_field's index
    arithmetic, each tap clamped into the rows)."""
    from pedoni_tpu_torch.field import PAD
    from pedoni_tpu_torch.ops.neighbor import true_divide
    px = torch.clamp(true_divide(pos[:, 0], unit) - 0.5 + PAD, 0.0, wp - 1.001)
    py = torch.clamp(true_divide(pos[:, 1], unit) - 0.5 + PAD, 0.0, hp - 1.001)
    base = (dest.long() * hp + torch.floor(py).long()) * wp + torch.floor(px).long()
    taps = torch.stack([base, base + 1, base + wp, base + wp + 1])
    return torch.clamp(taps, 0, rows.shape[0] - 1)


def _tap_rows(rows, hp: int, wp: int, pos, dest, unit: float) -> int:
    """Distinct texel rows of ``rows`` the agents' taps read (``_tap_index``)."""
    return int(torch.unique(_tap_index(rows, hp, wp, pos, dest, unit)).numel())


def _tap_footprint(rows, hp: int, wp: int, pos, dest, unit: float) -> dict:
    """What the agents' taps (``_tap_index``) touch of ``rows`` as the card
    fetches it: distinct texel rows, 32-byte sectors, 64-byte pieces and
    128-byte lines (from the tensor's address), and the bytes of each."""
    byte = (rows.data_ptr() + torch.unique(_tap_index(rows, hp, wp, pos, dest, unit))
            * rows.shape[1] * rows.element_size())
    out = {"texels": int(byte.numel())}
    for name, size in (("sectors_32", 32), ("pieces_64", 64), ("lines_128", 128)):
        out[name] = int(torch.unique(torch.cat([byte, byte + rows.shape[1]
                                                * rows.element_size() - 1])
                                     // size).numel())
        out[name + "_mb"] = out[name] * size / 1e6
    return out


def _grid_sample_call(args: tuple):
    """The library yardstick of the flat sample's taps: (a function that
    runs ``torch.nn.functional.grid_sample`` once, bilinear, of the field's
    six channels as [1, 6, R / wp, wp] planes at the agents' points, in
    plane ``dest``, normalised with align_corners; the max error of its
    obstacle channels against the kernel's packed ch 9-11 on the alive
    agents, relative to max(1, |value|): the Sobel of the distance map
    reaches 4e11 beside an obstacle).  The planes and points are made outside the timed call.  It
    computes the taps alone: no goal direction, despawn, cell id or
    packing."""
    from pedoni_tpu_torch.field import PAD
    from pedoni_tpu_torch.ops.kernels.flat_sample import flat_sample
    from pedoni_tpu_torch.ops.neighbor import true_divide
    rows, hp, wp, pos, vel, speed, dest, active, unit = args[:9]
    h = rows.shape[0] // wp
    planes = rows[:h * wp, :6].t().reshape(1, 6, h, wp).contiguous()
    px = torch.clamp(true_divide(pos[:, 0], unit) - 0.5 + PAD, 0.0, wp - 1.001)
    py = torch.clamp(true_divide(pos[:, 1], unit) - 0.5 + PAD, 0.0, hp - 1.001)
    yg = dest.clamp(0, h // hp - 1).float() * hp + py
    pts = torch.stack([px * (2.0 / (wp - 1)) - 1.0, yg * (2.0 / (h - 1)) - 1.0],
                      1).view(1, 1, -1, 2).contiguous()

    def run():
        return torch.nn.functional.grid_sample(planes, pts, mode="bilinear",
                                               padding_mode="border",
                                               align_corners=True)

    packed, _ = flat_sample(*args)
    got = run()[0, 3:6, 0].t()
    ok = (packed[:, 6] > 0.5) & (dest >= 0) & (dest < h // hp)
    want = packed[ok, 9:12]
    err = (float(((got[ok] - want).abs() / want.abs().clamp(min=1.0)).max())
           if bool(ok.any()) else 0.0)
    return run, err


def _profile_counts(run, n: int):
    """``run()`` n times under torch.profiler: (device us, launches) per
    run, two Counters by label: each kernel of PROFILED, "nccl" and "glue"
    (everything else on the device)."""
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
        label = next((k for k in (*PROFILED, "nccl") if k in ev.key), "glue")
        us[label] += ev.self_device_time_total / n
        launches[label] += ev.count / n
    return us, launches


def _device_profile(run, n: int, wall_ms: float, what: str, card: str) -> float:
    """``run()`` n times under torch.profiler (``_profile_counts``): device
    us and launches per run for each kernel of PROFILED and the glue, and
    the busy share of ``wall_ms``, the unprofiled wall time of one run.
    NCCL's kernels (phase 17) spin on the card until the peer's data
    arrives: they are printed apart and left out of the device time.
    Returns the device ms per run."""
    us, launches = _profile_counts(run, n)
    waiting = us.pop("nccl", 0.0)
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
    if waiting:
        print(f"#   nccl         {waiting:9.2f} us a run (waiting for the peer; not "
              f"in the device time)  {launches['nccl']:.2f} launches a run",
              flush=True)
    return dev_ms


def _profile(step, gs, fwp, fobs, wall_ms: float, name: str, card: str):
    """PROFILE_STEPS more steps of a 1M path under torch.profiler (see
    ``_device_profile``); returns (the state after them, device ms/step)."""
    state = [gs]

    def run():
        state[0] = step(state[0], fwp, fobs)[0]

    dev_ms = _device_profile(run, PROFILE_STEPS, wall_ms,
                             f"1M {name} (a run = a step)", card)
    return state[0], dev_ms


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

def _flat_pairs(d: torch.Tensor, cutoff_sq: float) -> tuple[int, int]:
    """(pairs within the cutoff, pairs past it) that the flat pair pass
    evaluates on its padded grid ``d`` [ny2, nx2, K, 8]: every interior
    slot, active or not, with each active candidate of its 3x3 cells other
    than itself, the distance as the kernel computes it."""
    ny, nx, k = d.shape[0] - 2, d.shape[1] - 2, d.shape[2]
    px, py = d[1:-1, 1:-1, :, None, 0], d[1:-1, 1:-1, :, None, 1]  # [ny, nx, K, 1]
    not_self = ~torch.eye(k, dtype=torch.bool, device=d.device)
    within = tested = 0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            cand = d[1 + dy:1 + dy + ny, 1 + dx:1 + dx + nx, None]  # [ny, nx, 1, K, 8]
            act = (cand[..., 6] > 0.5).expand(-1, -1, k, -1)
            if dy == dx == 0:
                act = act & not_self
            ex, ey = px - cand[..., 0], py - cand[..., 1]
            within += int((act & (ex * ex + ey * ey <= cutoff_sq)).sum())
            tested += int(act.sum())
    return within, tested - within


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
    sim = Simulator(SimulatorOptions(backend="grid", device=dev.type, seed=1,
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
    flat = sim.flat_state()
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
    sim.load_flat_state(flat)
    gs = sim.state
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
    in Simulator._grow): the pair passes stage the slot levels in
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
    sim = Simulator(SimulatorOptions(backend="grid", device=dev.type, seed=1,
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

    o = SimulatorOptions(backend="grid", neighbor_grid_unit=1.5, table_capacity=14,
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
        base = [str(GAP), "-H", "-b", "grid", "-s", "0", "--seed", "1",
                "--no-distance-map", "--checkpoint-every", "100"]
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
        rows = _agent_rows(agents_to_numpy(sim.flat_state().agents))
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
                            "-b", "grid", "--devices", str(n + 1), "--max-steps", "1",
                            "--log-dir", str(tmp / "logs3")],
                           cwd=ROOT, capture_output=True, text=True, timeout=300)
        said = f"--devices {n + 1} but only {n} devices are visible"
        if r.returncode == 0 or said not in r.stderr:
            raise AssertionError(f"CLI --devices {n + 1}: exit {r.returncode}, "
                                 f"{r.stderr[-2000:]}")
        print(f"# CLI --devices {n + 1}: exit {r.returncode}, \"{said}\"",
              flush=True)


def _waypoints_phase(dev, card, n_wp: int, w1_ms: dict) -> dict:
    """12, 13. The bench problem at ``n_wp`` waypoints (full 1024-lane
    width): WP_STEPS hybrid steps (launch counts zeroed before, read after;
    peak memory beside ``device_bytes``), the step kernel in base, mover and
    segment mode and both rebins against their twins on the state they
    leave, the step kernel's ms beside W = 1's (``w1_ms``), and ``supports``
    refusing one byte below ``device_bytes``.  Returns the phase's numbers."""
    from pedoni_tpu_torch.bench import build_problem
    from pedoni_tpu_torch.models import sfm_grid
    from pedoni_tpu_torch.ops.kernels import step_kernel as sk

    what = f"1M W={n_wp}"
    t0 = time.perf_counter()
    _sc, maps, cfg, flat = build_problem(N_AGENTS, device=dev, waypoints=n_wp)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fwp, fobs = sfm_grid.field_tensors(cfg, maps, dev)
    gs = sfm_grid.bin_state(cfg, flat)  # flat stays: peak counts from base
    step = sfm_grid.make_step_grid(cfg)
    _zero_launch_counts()
    for _ in range(WP_STEPS):
        gs, m = step(gs, fwp, fobs)
    torch.cuda.synchronize()
    counts = _launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    need = sfm_grid.device_bytes(cfg)
    n_compact = -(-WP_STEPS // 8)
    want = dict(dict.fromkeys(counts, 0), step_kernel_movers=WP_STEPS,
                rebin=WP_STEPS, rebin_incremental=WP_STEPS - n_compact)
    if counts != want:
        raise AssertionError(f"{what}: launches {counts} != {want}")
    if peak > need:
        raise AssertionError(f"{what}: peak memory {peak} > device_bytes {need}")
    d = gs.d
    n_active = int(m.n_active)
    held = (d[:, :, 6] > 0.5).unsqueeze(2).expand(-1, -1, 4, -1)
    if not bool(torch.isfinite(d[:, :, 0:4][held]).all()):
        raise AssertionError(f"{what}: non-finite positions or velocities")
    if n_active < 0.99e6:
        raise AssertionError(f"{what}: only {n_active} agents active")
    planes = d[:, :, 5][d[:, :, 6] > 0.5].unique().numel()
    if planes != n_wp:
        raise AssertionError(f"{what}: agents bound for {planes} of {n_wp} planes")
    print(f"# {what}: grid {cfg.grid.nx} x {cfg.grid.ny} cells, D "
          f"{tuple(d.shape)}, fwp {_nbytes(fwp) / 1e6:.1f} MB, texel-major "
          f"copy {_nbytes(sk.packed_fields(fwp, fobs)) / 1e6:.1f} MB; problem "
          f"built in {t_build:.1f} s; {WP_STEPS} hybrid steps, {n_active} "
          f"active, agents bound for all {n_wp} planes; launches {counts}; "
          f"peak memory {peak} bytes, device_bytes {need} ({peak / need:.1%}) "
          f"on {card}", flush=True)

    phys, size = cfg.physics, cfg.scenario.size
    unit, nx, ny = cfg.grid.unit, cfg.grid.nx, cfg.grid.ny
    step_err, mover_err = _compare(d, fwp, fobs, phys, size, unit, nx, ny, 8,
                                   f"{what} state")
    segs = sk.segment_table(_obstacles(cfg.scenario), dev)
    seg_err, seg_mover_err, _, _ = _compare_step(d, fwp, fobs, phys, size, 8,
                                                 f"{what} state, segments",
                                                 segments=segs)
    print(f"# {what} state, segment mode: step kernel max |err| {seg_err:.3e} "
          f"(base), {seg_mover_err:.3e} (mover mode), both walks", flush=True)
    ms = {"step_kernel": _median_ms(lambda: sk.fused_step(d, fwp, fobs, phys, size)),
          "step_kernel_movers": _median_ms(
              lambda: sk.fused_step(d, fwp, fobs, phys, size, emit_movers=8))}
    print(f"# {what} step kernel: {ms['step_kernel']:.4f} ms base, "
          f"{ms['step_kernel_movers']:.4f} ms mover mode; W=1 on its path's "
          f"1M state {w1_ms['step_kernel']:.4f} / "
          f"{w1_ms['step_kernel_movers']:.4f} (medians of 20, CUDA events) "
          f"on {card}", flush=True)
    if not (sfm_grid.supports(cfg, free_bytes=need)
            and not sfm_grid.supports(cfg, free_bytes=need - 1)):
        raise AssertionError(f"{what}: supports does not turn at device_bytes")
    try:
        sfm_grid.check_fits(need, dev, free_bytes=need - 1)
    except ValueError as e:
        said = str(e)
    else:
        raise AssertionError(f"{what}: check_fits let {need} bytes into {need - 1}")
    print(f"# {what}: supports true at free_bytes = device_bytes, false one "
          f"byte below; check_fits: \"{said}\"", flush=True)
    return {"max_abs_err": max(step_err, mover_err, seg_err,
                                                   seg_mover_err),
            "step_kernel_ms": ms["step_kernel"],
            "step_kernel_movers_ms": ms["step_kernel_movers"],
            "peak_bytes": peak, "device_bytes": need}


def _bench_phase(card: str) -> dict:
    """14. ``python -m pedoni_tpu_torch.bench --steps 8 --warmup 2`` as a
    subprocess: exit 0, one JSON line, value > 0, ``device`` naming this
    card, and the launch counts of its timed rounds (``--verbose``) showing
    the hybrid's kernels."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "pedoni_tpu_torch.bench", "--steps",
                        "8", "--warmup", "2", "--verbose"],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"bench exited {r.returncode}:\n{r.stderr[-3000:]}")
    lines = [line for line in r.stdout.splitlines() if line.strip()]
    if len(lines) != 1:
        raise AssertionError(f"bench printed {len(lines)} lines:\n{r.stdout[-3000:]}")
    rec = json.loads(lines[0])
    launches = [line for line in r.stderr.splitlines()
                if line.startswith("# launches ")]
    counts = json.loads(launches[0][len("# launches "):]) if launches else {}
    if not (rec["value"] > 0 and rec["device"] == card.splitlines()[0]):
        raise AssertionError(f"bench record {rec} (card {card!r})")
    used = ("step_kernel_movers", "rebin", "rebin_incremental")
    if not all(counts.get(name, 0) > 0 for name in used):
        raise AssertionError(f"bench timed rounds launched {counts}")
    print(f"# bench (python -m pedoni_tpu_torch.bench --steps 8 --warmup 2): "
          f"exit 0 in {time.perf_counter() - t0:.1f} s, {lines[0]}; launches "
          f"in its timed rounds {counts}", flush=True)
    return rec


def _rank_device(backend: str, rank: int) -> torch.device:
    """Rank r's card: cuda:r under NCCL (one rank a card), cuda:0 under gloo
    (both ranks on one card)."""
    return torch.device("cuda", rank if backend == "nccl" else 0)


def _rank_main(argv: list[str]) -> int:
    """17, one rank: ``chip_smoke.py --rank R --store FILE --backend B --out
    PREFIX``, started twice by ``_processes_phase``.  Joins a 2-process group
    of backend B (gloo: both ranks on cuda:0, each crossing buffer staged
    through pinned host memory; nccl: rank r on cuda:r), builds the 1M bench
    state and runs each tiling of RANK_TILES, full path and hybrid, over
    ``transport.ProcessGroup`` (rank r owns tile row r): TILE_STEPS steps
    with each step's metrics and the launch counts, the grid gathered on
    rank 0 against rank 0's own single-process whole-grid run, then wall
    ms/step (WARMUP + TIMED steps), device ms/step of this rank's kernels
    (profiler) and the exchanges of a step across ranks (host clock).
    Writes its numbers as JSON to PREFIX.R."""
    import torch.distributed as dist

    from pedoni_tpu_torch.bench import build_problem
    from pedoni_tpu_torch.models import sfm_grid
    from pedoni_tpu_torch.parallel import tile2d
    from pedoni_tpu_torch.parallel.transport import ProcessGroup

    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--backend", choices=["gloo", "nccl"], required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke --rank: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    dev = _rank_device(args.backend, args.rank)
    torch.cuda.set_device(dev)
    card = _card()
    dist.init_process_group(args.backend, init_method=f"file://{args.store}",
                            rank=args.rank, world_size=2,
                            timeout=datetime.timedelta(seconds=RANK_TIMEOUT))
    try:
        _sc, bmaps, bcfg, flat = build_problem(N_AGENTS, device=dev)
        bfwp, bfobs = sfm_grid.field_tensors(bcfg, bmaps, dev)
        stride = sfm_grid.stride_for(bcfg)
        out = {}
        for tile in RANK_TILES:
            for name, incremental in (("full", False), ("hybrid", True)):
                label = f"{tile[0]}x{tile[1]}_{name}"
                tcfg = tile2d.Tile2DConfig.build(bcfg, *tile)
                tr = ProcessGroup(tcfg.n_devices)
                devices = [dev] * len(tr.tiles)
                twp, tob = tile2d.device_inputs(tcfg, bmaps, stride, devices, tr)
                ts = tile2d.make_sharded_grid_state(tcfg, flat, devices, tr)
                tstep = tile2d.make_sharded_step(tcfg, devices,
                                                 incremental=incremental, transport=tr)
                _zero_launch_counts()
                ms = []
                for _ in range(TILE_STEPS):
                    ts, m = tstep(ts, twp, tob)
                    ms.append(torch.stack(list(m)))
                entry = {"metrics": torch.stack(ms).cpu().tolist(),
                         "launches": _launch_counts(), "tiles": list(tr.tiles)}
                full = tile2d.gather(tcfg, ts, tr)
                if tr.rank == 0:  # the single-process whole-grid run
                    step = sfm_grid.make_step_grid(bcfg, incremental=incremental)
                    gs, wm = sfm_grid.bin_state(bcfg, flat), []
                    for _ in range(TILE_STEPS):
                        gs, m = step(gs, bfwp, bfobs)
                        wm.append(torch.stack(list(m)))
                    entry["whole_metrics"] = torch.stack(wm).cpu().tolist()
                    entry["grid_equal"] = bool(torch.equal(full, gs.d))
                    del gs
                del full
                ts, _, wall = _run_timed(tstep, ts, twp, tob)
                state = [ts]

                def run():
                    state[0] = tstep(state[0], twp, tob)[0]

                dev_ms = _device_profile(run, PROFILE_STEPS // 3, wall,
                                         f"rank {args.rank} {label} (a run = a step)",
                                         card)
                tiles = list(state[0].d)
                tensors = [tiles, [torch.empty_like(t) for t in tiles]]
                if incremental:
                    tensors.append([torch.empty((t.shape[0], 8, 8, t.shape[3]),
                                                device=dev) for t in tiles])
                times = []
                for _ in range(EXCHANGE_RUNS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for x in tensors:
                        tile2d.exchange(tcfg, x, tr)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                entry.update(ms_per_step=wall, device_ms_per_step=dev_ms,
                             exchange_ms=statistics.median(times),
                             exchanges=len(tensors))
                out[label] = entry
        with open(f"{args.out}.{args.rank}", "w") as f:
            json.dump({"card": card, "device": str(dev), "cases": out}, f)
    finally:
        dist.destroy_process_group()
    return 0


def _processes_phase(card, tiled: dict) -> dict:
    """17. The 1M bench state as RANK_TILES over two processes of one
    ``torch.distributed`` group (``_rank_main``, started by
    ``transport.run_ranks``, which kills both when one fails or RANK_TIMEOUT
    passes): over gloo with both ranks on this card, and over NCCL with
    rank r on cuda:r where there are two cards or more.  Every step's
    metrics equal on both ranks and to the single-process whole-grid run,
    the grid gathered on rank 0 bit-equal to it, each rank launching its
    own tiles' kernels; wall and device ms/step and the cross-rank
    exchanges' ms a step beside phase 10's single-process numbers for the
    same tiling (``tiled``).  Returns this phase's numbers."""
    from pedoni_tpu_torch.parallel.transport import run_ranks

    backends = ["gloo"]
    if torch.cuda.device_count() >= 2:
        backends.append("nccl")
    else:
        print("# phase 17: NCCL did not run: this machine has "
              f"{torch.cuda.device_count()} card, and NCCL takes one rank a "
              "card (it refuses two ranks on one GPU); gloo ran both ranks on "
              "this card", flush=True)
    numbers = {}
    for backend in backends:
        with tempfile.TemporaryDirectory() as tmp:
            prefix = str(pathlib.Path(tmp) / "rank")
            logs = run_ranks(
                lambda r, store: [sys.executable, str(ROOT / "chip_smoke.py"),
                                  "--rank", str(r), "--store", store,
                                  "--backend", backend, "--out", prefix],
                2, RANK_TIMEOUT, cwd=str(ROOT))
            ranks = [json.loads(pathlib.Path(f"{prefix}.{r}").read_text())
                     for r in range(2)]
        for r, log in enumerate(logs):
            for line in log.splitlines():
                if line.startswith("#   ") or " profile, " in line:
                    print(f"# {backend} rank {r}: {line[2:]}", flush=True)
        for label in ranks[0]["cases"]:
            c0, c1 = (rk["cases"][label] for rk in ranks)
            if not c0["metrics"] == c1["metrics"] == c0["whole_metrics"]:
                raise AssertionError(
                    f"phase 17 {backend} {label}: metrics differ: rank 0 "
                    f"{c0['metrics']} rank 1 {c1['metrics']} whole "
                    f"{c0['whole_metrics']}")
            if not c0["grid_equal"]:
                raise AssertionError(f"phase 17 {backend} {label}: the grid "
                                     "gathered on rank 0 != the whole grid")
            kname = ("step_kernel_movers" if label.endswith("hybrid")
                     else "step_kernel")
            for c in (c0, c1):
                if c["launches"][kname] != len(c["tiles"]) * TILE_STEPS:
                    raise AssertionError(f"phase 17 {backend} {label}: launches "
                                         f"{c['launches']} for tiles {c['tiles']}")
            one = tiled[label]
            print(f"# phase 17 {backend} {label}, 2 ranks ({ranks[0]['device']}, "
                  f"{ranks[1]['device']}): {TILE_STEPS} steps, metrics equal on "
                  f"both ranks and to the whole grid each step "
                  f"({c0['metrics'][-1][0]} active), grid gathered on rank 0 bit "
                  f"for bit; ms/step wall {c0['ms_per_step']:.4f} / "
                  f"{c1['ms_per_step']:.4f}, device (this rank's kernels) "
                  f"{c0['device_ms_per_step']:.4f} / {c1['device_ms_per_step']:.4f}, "
                  f"{c0['exchanges']} exchanges across ranks "
                  f"{c0['exchange_ms']:.4f} / {c1['exchange_ms']:.4f} ms a step "
                  f"(rank 0 / rank 1); one process (phase 10): wall "
                  f"{one['ms_per_step']:.4f}, device {one['device_ms_per_step']:.4f}, "
                  f"exchanges {one['exchange_ms']:.4f} ms on {card}", flush=True)
            numbers[f"{backend}_{label}"] = {
                "ms_per_step": [c0["ms_per_step"], c1["ms_per_step"]],
                "device_ms_per_step": [c0["device_ms_per_step"],
                                       c1["device_ms_per_step"]],
                "exchange_ms": [c0["exchange_ms"], c1["exchange_ms"]],
                "one_process": one}
    return numbers


def _flat_rows(agents) -> np.ndarray:
    """Every slot's (pos, vel, speed, dest, active) of flat agent tensors."""
    a = {k: t.detach().cpu().numpy() for k, t in agents._asdict().items()}
    return np.concatenate([a["pos"], a["vel"], a["speed"][:, None],
                           a["dest"][:, None], a["active"][:, None]], 1
                          ).astype(np.float64)


def _flat_vs_cpu(dev, what, sc, cfg_kw, agents, cand=None) -> float:
    """One flat step on the card against the same step on the CPU from the
    same state and candidates: slot by slot (the sort's cell ids come
    from the same IEEE divide on both), pos/vel within TOL, the rest and
    every metric equal; the card's step launches the flat sample, scatter
    and integrate kernels once each, the flat pair kernel once (none in
    all-pairs mode) and no other.
    Returns the max |err|."""
    from pedoni_tpu_torch.field import Field, FieldMaps
    from pedoni_tpu_torch.models import sfm
    from pedoni_tpu_torch.models.sfm import SimState

    maps = FieldMaps.from_field(Field.from_scenario(sc, unit=0.25))
    cfg = sfm.StepConfig.build(sc, **cfg_kw)
    out = []
    _zero_launch_counts()
    for d in (dev, torch.device("cpu")):
        field, obstacles = sfm.device_inputs(cfg, maps, d)
        step = sfm.make_step(cfg, torch.Generator(device=d))
        st, m = step(SimState(agents.to(d), 0), field.rows, obstacles,
                     None if cand is None else cand.to(d))
        out.append((_flat_rows(st.agents),
                    {k: int(v) for k, v in m._asdict().items()}))
    (got, gm), (want, wm) = out
    counts = _launch_counts()
    if counts != dict(dict.fromkeys(counts, 0), flat_sample=1, flat_scatter=1,
                      flat_integrate=1, flat_pairwise=int(cfg.use_neighbor_grid)):
        raise AssertionError(f"flat step {what}: launches {counts}")
    err = float(np.abs(got[:, :4] - want[:, :4]).max())
    if gm != wm or err > TOL or not np.array_equal(got[:, 4:], want[:, 4:]):
        raise AssertionError(f"flat step {what}: card {gm} vs CPU {wm}, "
                             f"pos/vel err {err:.3e}")
    print(f"# flat step {what}, card vs CPU: metrics equal {gm}, pos/vel max "
          f"|err| {err:.3e}, speed/dest/active equal", flush=True)
    return err


def _flat_sim_checks(dev) -> dict:
    """15a. gap.toml through the flat Simulator; one step against the CPU's
    in all three modes and on 20 000 agents of the xla bench problem;
    16 spawning steps under sync debug mode "error"."""
    from pedoni_tpu_torch import Simulator, SimulatorOptions, load_scenario
    from pedoni_tpu_torch.bench import build_problem
    from pedoni_tpu_torch.convert import agents_from_numpy
    from pedoni_tpu_torch.models import sfm
    from pedoni_tpu_torch.scenario import loads_scenario

    def one_a_step(n: int) -> dict:  # the four flat kernels, once a step each
        counts = _launch_counts()
        return dict(dict.fromkeys(counts, 0), **dict.fromkeys(FLAT_KERNELS, n))

    t0 = time.perf_counter()
    _zero_launch_counts()
    sim = Simulator(SimulatorOptions(device=dev.type, seed=1), load_scenario(GAP))
    n0, steps = _evacuate(sim, "gap.toml (flat)")
    if _launch_counts() != one_a_step(steps) or sim.cfg.grid.unit != 1.4:
        raise AssertionError(f"gap.toml (flat): launches {_launch_counts()} in "
                             f"{steps} ticks, unit {sim.cfg.grid.unit}")
    print(f"# gap.toml (backend xla, 1.4 m): {n0} agents evacuated in {steps} "
          f"ticks (limit {GAP_MAX_STEPS}), {time.perf_counter() - t0:.1f} s; "
          f"kernel launches {_launch_counts()}", flush=True)

    sc = loads_scenario(SPAWN_SCENARIO)
    rng = np.random.default_rng(6)
    n = 600
    agents = agents_from_numpy(
        rng.uniform(0.8, 11.2, (n, 2)) * np.array([1.5, 1.0]),
        rng.normal(0, 0.4, (n, 2)), rng.uniform(0.8, 1.7, n),
        rng.integers(0, 2, n), np.arange(n) < 500, "cpu")
    cand = sfm.spawn_candidates(sfm.StepConfig.build(sc),
                                torch.Generator().manual_seed(3))
    cand = cand._replace(active=torch.arange(cand.active.shape[0]) < 3)
    errs = [_flat_vs_cpu(dev, f"spawning scenario, {mode}", sc,
                         dict(capacity=n, table_capacity=12, **kw), agents, cand)
            for mode, kw in (("distance map", {}),
                             ("segments", {"use_distance_map": False}),
                             ("all-pairs", {"use_neighbor_grid": False}))]
    bsc, _bmaps, bcfg, bflat = build_problem(20_000, device="cpu", backend="xla")
    errs += [_flat_vs_cpu(dev, f"xla bench problem at 20 000 agents{what}", bsc,
                          dict(capacity=bcfg.capacity, table_capacity=14, **kw),
                          bflat.agents)
             for what, kw in (("", {}), (", segments", {"use_distance_map": False}))]

    sim = Simulator(SimulatorOptions(device=dev.type, seed=2), sc)
    for _ in range(2):
        sim.tick()
    torch.cuda.synchronize()
    spawned = []
    _zero_launch_counts()
    with _no_sync():
        for _ in range(SPAWN_SYNC_STEPS):
            sim.state, m = sim._step(sim.state, sim._fwp, sim._fobs)
            spawned.append(m.n_spawned)
    n_sp = int(sum(spawned))
    if n_sp == 0 or _launch_counts() != one_a_step(SPAWN_SYNC_STEPS):
        raise AssertionError(f"flat spawning steps: {n_sp} spawned, launches "
                             f"{_launch_counts()}")
    print(f"# flat step, spawning: {SPAWN_SYNC_STEPS} steps under "
          f"set_sync_debug_mode('error'), {n_sp} spawned, "
          f"{sim.pedestrian_count} active", flush=True)
    return {"gap_steps": steps, "max_abs_err_vs_cpu": max(errs)}


@contextlib.contextmanager
def _no_sync():
    """Raise on any host sync inside."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _flat_1m(dev, card, capture: dict | None = None) -> dict:
    """15b. The 1M xla bench problem: FLAT_TIMED steps after FLAT_WARMUP
    under sync debug mode "error", host clock, the launch counts zeroed
    before and read after ("launches"); peak memory; then
    FLAT_PROFILE_STEPS under torch.profiler: device ms, launches a step,
    busy share, the FLAT_TOP_KERNELS dearest kernels, beside
    EARLIER_DEVICE_MS, and the gathers it holds of the field's [R, 8] rows
    ("tap_gathers") and of [N, 12] agent rows ("row_gathers"), which phase
    15 holds to none: the four taps are the flat sample kernel's, the row
    gather after the argsort the flat scatter kernel's.  With ``capture``
    (a dict), one more step stores its padded cell grid and the physics
    ("grid"), the flat sample kernel's arguments ("sample") and outputs
    ("packed", "cid"), the sort's permutation ("order"), the flat
    scatter and integrate kernels' arguments ("scatter", "integrate"), and
    the problem's agents before their first step ("initial", unsorted).
    Returns the run's numbers, with each flat kernel's device us/step and
    launches a step in the profile under "kernel_us" and
    "kernel_profile_launches" (the step makes one of each; a profile that
    lost a launch's record counts fewer)."""
    import collections

    from pedoni_tpu_torch.bench import build_problem
    from pedoni_tpu_torch.models import sfm
    from pedoni_tpu_torch.ops import forcepass

    t0 = time.perf_counter()
    _sc, maps, cfg, flat = build_problem(N_AGENTS, device=dev, backend="xla")
    field, obstacles = sfm.device_inputs(cfg, maps, dev)
    step = sfm.make_step(cfg)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    st = flat
    _zero_launch_counts()  # the main path's run: its launches are read after it
    for _ in range(FLAT_WARMUP):
        st, m = step(st, field.rows, obstacles)
    torch.cuda.synchronize()
    with _no_sync():
        t0 = time.perf_counter()
        for _ in range(FLAT_TIMED):
            st, m = step(st, field.rows, obstacles)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / FLAT_TIMED * 1e3
    peak = torch.cuda.max_memory_allocated() - base_bytes
    launched = _launch_counts()
    n_active = int(m.n_active)
    a = st.agents
    if n_active < 0.99e6 or not bool(torch.isfinite(a.pos[a.active]).all()):
        raise AssertionError(f"1M flat: {n_active} active, or non-finite positions")
    print(f"# 1M flat (xla) problem: grid {cfg.grid.nx} x {cfg.grid.ny} cells of "
          f"{cfg.grid.unit} m, K {cfg.table_capacity}, capacity {cfg.capacity}; "
          f"built in {t_build:.1f} s; {FLAT_WARMUP} warm-up + {FLAT_TIMED} timed "
          f"steps (under set_sync_debug_mode('error')): {wall:.4f} ms/step wall, "
          f"{n_active} active, overflow last step {int(m.n_overflow)}, dropped "
          f"{int(m.n_dropped)}; peak memory {peak} bytes above the "
          f"{base_bytes} held before; kernel launches {launched} on "
          f"{card}", flush=True)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        for _ in range(FLAT_PROFILE_STEPS):
            st, m = step(st, field.rows, obstacles)
        torch.cuda.synchronize()
    us, counts, launches = collections.Counter(), collections.Counter(), 0.0
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us[ev.key] += ev.self_device_time_total / FLAT_PROFILE_STEPS
            counts[ev.key] += ev.count / FLAT_PROFILE_STEPS
            launches += ev.count / FLAT_PROFILE_STEPS
    by_shape = prof.key_averages(group_by_input_shape=True)
    gathers = ("aten::index_select", "aten::index", "aten::take", "aten::gather")
    row_gathers = sum(ev.count for ev in by_shape
                      if ev.key in gathers and ev.input_shapes
                      and len(ev.input_shapes[0]) == 2
                      and ev.input_shapes[0][1] == 12) / FLAT_PROFILE_STEPS
    taps = sum(ev.count for ev in by_shape
               if ev.key in gathers
               and ev.input_shapes and ev.input_shapes[0] == list(field.rows.shape)
               ) / FLAT_PROFILE_STEPS
    dev_ms = sum(us.values()) / 1e3
    if not dev_ms > 0:
        raise AssertionError("1M flat: the profiler traced no device time")
    print(f"# 1M flat profile, {FLAT_PROFILE_STEPS} steps (torch.profiler): "
          f"device {dev_ms:.4f} ms/step, {launches:.1f} launches a step, wall "
          f"{wall:.4f} ms/step unprofiled, busy share {dev_ms / wall:.3f}; "
          f"{row_gathers:.1f} gathers of [N, 12] agent rows and {taps:.1f} of the "
          f"field's {list(field.rows.shape)} rows a step; top {FLAT_TOP_KERNELS} kernels "
          f"(us/step, share): " + "; ".join(
              f"{k[:70]} {v:.1f} ({v / 1e3 / dev_ms:.1%})"
              for k, v in us.most_common(FLAT_TOP_KERNELS)), flush=True)
    print(f"# 1M flat beside EARLIER_DEVICE_MS (PERF.md; NVIDIA H100 80GB HBM3, "
          f"700 W): device {dev_ms:.4f} ms/step (earlier "
          f"{EARLIER_DEVICE_MS['flat']}), {launches:.1f} launches a step (earlier "
          f"{EARLIER_DEVICE_MS['flat_launches']}) on {card}",
          flush=True)
    if capture is not None:
        capture["initial"] = flat.agents
        real = (forcepass.dense_pairwise, sfm.flat_sample, sfm.flat_scatter,
                sfm.flat_integrate)

        def spy_pairs(data, *args, **kw):
            capture["grid"] = (data.clone(), cfg.physics)
            return real[0](data, *args, **kw)

        def spy_sample(*args, **kw):
            packed, cid = real[1](*args, **kw)
            capture["sample"] = (args, kw)
            capture["packed"], capture["cid"] = packed.clone(), cid.clone()
            capture["order"] = torch.argsort(cid, stable=True)[:cfg.capacity]
            return packed, cid

        def spy_scatter(*args, **kw):
            capture["scatter"] = (args, kw)
            return real[2](*args, **kw)

        def spy_integrate(*args, **kw):
            capture["integrate"] = (args, kw)
            return real[3](*args, **kw)

        (forcepass.dense_pairwise, sfm.flat_sample, sfm.flat_scatter,
         sfm.flat_integrate) = spy_pairs, spy_sample, spy_scatter, spy_integrate
        try:
            step(st, field.rows, obstacles)
        finally:
            (forcepass.dense_pairwise, sfm.flat_sample, sfm.flat_scatter,
             sfm.flat_integrate) = real
    return {"ms_per_step": wall, "device_ms_per_step": dev_ms,
            "launches_per_step": launches, "busy_share": dev_ms / wall,
            "peak_bytes": peak, "n_active": n_active, "launches": launched,
            "row_gathers": row_gathers, "tap_gathers": taps,
            "kernel_us": {k: sum(v for key, v in us.items() if f"{k}_" in key)
                          for k in FLAT_KERNELS},
            "kernel_profile_launches": {
                k: sum(v for key, v in counts.items() if f"{k}_" in key)
                for k in FLAT_KERNELS}}


def _flat_subprocesses(card) -> dict:
    """15c. ``python -m pedoni_tpu_torch.bench --backend xla``, the CLI on
    gap.toml with ``-b auto`` and ``-b xla``, and ``python -m
    pedoni_tpu_torch.entry``, as subprocesses.  Returns the bench line."""
    import tempfile

    rec = None
    with tempfile.TemporaryDirectory() as tmp:
        cli = [str(GAP), "-H", "-s", "0", "--seed", "1", "--max-steps", "300"]
        runs = (("bench", ["pedoni_tpu_torch.bench", "--backend", "xla",
                           "--steps", "8", "--warmup", "2"]),
                *((f"CLI -b {b}", ["pedoni_tpu_torch", *cli, "-b", b, "--log-dir",
                                   str(pathlib.Path(tmp) / b)])
                  for b in ("auto", "xla")),
                ("entry", ["pedoni_tpu_torch.entry"]))
        for name, argv in runs:
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, "-m", *argv], cwd=ROOT,
                               capture_output=True, text=True, timeout=600)
            if r.returncode != 0:
                raise AssertionError(f"{name} exited {r.returncode}:\n"
                                     f"{r.stderr[-3000:]}")
            dt = time.perf_counter() - t0
            if name == "bench":
                lines = [ln for ln in r.stdout.splitlines() if ln.strip()]
                rec = json.loads(lines[0])
                if len(lines) != 1 or not (rec["value"] > 0 and rec["device"]
                                           == card.splitlines()[0]):
                    raise AssertionError(f"bench --backend xla printed {r.stdout}")
                said = lines[0]
            elif name == "entry":
                said = " / ".join(r.stdout.strip().splitlines())
            else:
                (out,) = pathlib.Path(argv[-1]).glob("*_log.json")
                log = json.loads(out.read_text())
                pops = log["step_metrics"]["active_ped_count"]
                if log["model"] != "sfm-torch/xla" or pops[-1] != 0:
                    raise AssertionError(f"{name}: model {log['model']}, "
                                         f"population {pops[-1]} at the end")
                said = (f"model {log['model']}, population {pops[0]} -> 0 at "
                        f"logged step {pops.index(0) + 1}")
            print(f"# {name} (python -m {argv[0]}): exit 0 in {dt:.1f} s; "
                  f"{said}", flush=True)
    return {"bench": rec}


def _flat_model_and_quickstart(dev) -> None:
    """15d. ``SocialForceModel`` on ``dev`` against its CPU run over three
    spawn/update rounds; ``examples/quickstart_torch.py`` on ``dev``."""
    import importlib.util

    from pedoni_tpu_torch.field import Field
    from pedoni_tpu_torch.models import base
    from pedoni_tpu_torch.scenario import loads_scenario

    sc = loads_scenario(SPAWN_SCENARIO)
    fld = Field.from_scenario(sc, unit=0.25)
    models = [base.SocialForceModel(None, sc, fld, capacity=512, device=d)
              for d in (dev.type, "cpu")]
    rng = np.random.default_rng(4)
    for _ in range(3):
        batch = [base.Pedestrian((float(x), float(y)), int(dd)) for x, y, dd in zip(
            rng.uniform(3, 15, 40), rng.uniform(1, 11, 40), rng.integers(0, 2, 40))]
        for mdl in models:
            mdl.spawn_pedestrians(fld, batch)
            for _ in range(3):
                mdl.update_states(sc, fld)
    got, want = ([(p.pos[0], p.pos[1], p.destination) for p in mdl.list_pedestrians()]
                 for mdl in models)
    if len(got) != len(want) or len(got) < 100:
        raise AssertionError(f"SocialForceModel {dev.type} vs CPU: {len(got)} / "
                             f"{len(want)} pedestrians")
    err = float(np.abs(np.array(sorted(got)) - np.array(sorted(want))).max())
    if err > 1e-4:
        raise AssertionError(f"SocialForceModel {dev.type} vs CPU: err {err:.3e}")
    print(f"# SocialForceModel on {dev.type}: {len(got)} pedestrians after 3 "
          f"spawn rounds and 9 updates, positions within {err:.3e} m of the "
          f"CPU's", flush=True)
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
    qs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(qs)
    t0 = time.perf_counter()
    qsim = qs.main(dev.type)
    print(f"# examples/quickstart_torch.py on {dev.type}: {qsim.step_count} "
          f"ticks, {qsim.pedestrian_count} active, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def _pair_grid(step, st, *inputs) -> torch.Tensor:
    """The padded cell grid that the flat step ``step`` hands its pair pass
    on one step from ``st`` (a copy)."""
    from pedoni_tpu_torch.ops import forcepass

    real, seen = forcepass.dense_pairwise, []

    def spy(data, *args, **kw):
        seen.append(data.clone())
        return real(data, *args, **kw)

    forcepass.dense_pairwise = spy
    try:
        step(st, *inputs)
    finally:
        forcepass.dense_pairwise = real
    return seen[0]


def _jam_flat_grid(dev) -> tuple[torch.Tensor, object, int]:
    """scenarios/random.toml's padded cell grid on the flat step (K 16 at
    1.4 m) after SPAWN_FILL_TICKS ticks of the CLI's default Simulator, as
    the benchmark's random.tick cell fills it: (grid, physics, agents)."""
    from pedoni_tpu_torch import Simulator, SimulatorOptions, load_scenario
    from pedoni_tpu_torch.models import sfm

    sim = Simulator(SimulatorOptions(backend="xla", neighbor_grid_unit=1.4,
                                     field_grid_unit=0.25, table_capacity=16,
                                     seed=1, device=dev.type), load_scenario(RANDOM))
    sim.run(SPAWN_FILL_TICKS)
    field, obstacles = sfm.device_inputs(sim.cfg, sim.maps, dev)
    step = sfm.make_step(sim.cfg, generator=torch.Generator(device=dev).manual_seed(1))
    d = _pair_grid(step, sim.flat_state(), field.rows, obstacles)
    return d, sim.cfg.physics, sim.pedestrian_count


def _flat_grids(dev) -> list[tuple[str, torch.Tensor]]:
    """Seeded padded grids [ny+2, nx+2, K, 8] for the flat pair kernel:
    test_torch_cuda.py's cases (K 14, 16, 64 and 255, a ragged nx, one
    x-strip's window of the 1M problem, and agents scattered off their
    cells, a few at non-finite positions, for the kernel's box cull), slots
    filled from rank 0 as the flat step fills them, some cells past half
    full, a few inactive slots among the active, and a ring with agents in
    it."""
    rng = np.random.default_rng(12)
    grids = []
    for name, ny, nx, k in (("K 14", 30, 40, 14), ("K 16", 24, 37, 16),
                            ("K 64", 10, 12, 64), ("K 255", 6, 7, 255),
                            ("ragged nx", 17, 131, 14),
                            ("1M strip window", 452, 229, 14),
                            ("scattered", 30, 40, 14)):
        d = np.zeros((ny + 2, nx + 2, k, 8), np.float32)
        count = rng.integers(0, k + 1, (ny + 2, nx + 2)) * (
            rng.uniform(size=(ny + 2, nx + 2)) < 0.8)
        r, c, j = np.nonzero(np.arange(k)[None, None] < count[..., None])
        scattered = name == "scattered"
        spread = rng.uniform(-3.0, 4.0, (2, r.size)) if scattered else rng.uniform(
            size=(2, r.size))
        d[r, c, j, 0] = (c - 1 + spread[0]) * 1.4
        d[r, c, j, 1] = (r - 1 + spread[1]) * 1.4
        if scattered:
            odd = rng.choice(r.size, 8, replace=False)
            d[r[odd], c[odd], j[odd], odd % 2] = [np.nan, np.inf, -np.inf, 1e30] * 2
        d[r, c, j, 2:4] = rng.normal(0, 0.8, (r.size, 2))
        e = rng.normal(0, 1, (r.size, 2))
        d[r, c, j, 4:6] = e / np.linalg.norm(e, axis=1, keepdims=True)
        d[r, c, j, 6] = rng.uniform(size=r.size) < 0.95
        grids.append((f"{name} {tuple(d.shape)}", torch.from_numpy(d).to(dev)))
    return grids


def _flat_kernel_entry(dev, card, d: torch.Tensor, phys, launches: int) -> dict:
    """15c. The flat pair kernel against its twin (forcepass.
    dense_pairwise_torch, on the card) bit for bit on ``_flat_grids``, on
    the 1M problem's padded grid ``d`` and on random.toml's jammed grid
    (``_jam_flat_grid``); kernel, twin and bound timed on ``d``, beside its
    first design's time, the kernel on the jammed grid too, and the
    kernel's lane occupancies (flat_pairwise_occupancy) on both.  Returns
    the JSON entry, with ``launches`` from the 1M run."""
    from pedoni_tpu_torch.ops import forcepass
    from pedoni_tpu_torch.ops.kernels import flat_pairwise as fpk
    from pedoni_tpu_torch.ops.neighbor import CellGrid

    def twin(g):
        grid = CellGrid(1.4, g.shape[1] - 2, g.shape[0] - 2)
        return forcepass.dense_pairwise_torch(g, grid, g.shape[2], phys,
                                              pass_bytes=FLAT_TWIN_PASS_BYTES)

    jam, jam_phys, jam_agents = _jam_flat_grid(dev)
    errs, k_up_to = {}, 0
    for what, g in (*_flat_grids(dev), (f"1M grid {tuple(d.shape)}", d),
                    (f"random.toml jam {tuple(jam.shape)}", jam)):
        got, want = fpk.flat_pairwise(g, phys), twin(g)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)) or \
                not float(want.abs().max()) > 0.1:
            raise AssertionError(f"flat_pairwise {what}: max |err| "
                                 f"{float((got - want).abs().max()):.3e}, not bit-equal")
        errs[what] = float((got - want).abs().max())
        k_up_to = max(k_up_to, g.shape[2])
    acc = fpk.flat_pairwise(d, phys)
    k_ms = _median_ms(lambda: fpk.flat_pairwise(d, phys))
    t_ms = _median_ms(lambda: twin(d), n=TWIN_RUNS)
    need = _needed_bytes("flat_pairwise", (d,), (acc,))
    within, beyond = _flat_pairs(d, phys.cutoff_sq)
    flops = within * FLAT_PAIR_FLOPS + beyond * PAIR_TEST_FLOPS
    b_ms, by = _bound(need, flops)
    tr, tc, threads, smem = fpk.tile_shape(d.shape[2])
    print(f"# flat_pairwise: tiles of {tr} x {tc} cells, {threads} threads, "
          f"{smem} bytes of shared memory a block at K {d.shape[2]}; "
          + _vs_first("flat_pairwise", k_ms), flush=True)
    print(f"# flat_pairwise: bit-equal to its twin on the card (max |err| 0) on "
          f"{', '.join(errs)}; on the 1M grid kernel {k_ms:.4f} ms, twin "
          f"{t_ms:.4f} ms (median of 20 and {TWIN_RUNS}, CUDA events), bound "
          f"{b_ms:.4f} ms ({by}; {need / 1e6:.1f} MB needed of "
          f"{_nbytes(d, acc) / 1e6:.1f} MB in the tensors at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; {within} pairs within the cutoff x "
          f"{FLAT_PAIR_FLOPS} + {beyond} past it x {PAIR_TEST_FLOPS} = "
          f"{flops / 1e9:.3f} GFLOP at {F32_FLOP_PER_S / 1e12:.0f} TFLOP/s; "
          f"{b_ms / k_ms:.1%} of it) on {card}", flush=True)
    jam_ms = _median_ms(lambda: fpk.flat_pairwise(jam, jam_phys))
    occ = {"1M": fpk.flat_pairwise_occupancy(d, phys),
           "jam": fpk.flat_pairwise_occupancy(jam, jam_phys)}
    print(f"# flat_pairwise: on random.toml's jammed grid after {SPAWN_FILL_TICKS} "
          f"ticks ({jam_agents} agents, K {jam.shape[2]}) kernel {jam_ms:.4f} ms "
          f"(median of 20, CUDA events); lane occupancy of the force body / the "
          f"walk: 1M grid {occ['1M']['body_occupancy']:.4f} / "
          f"{occ['1M']['walk_occupancy']:.4f}, jammed grid "
          f"{occ['jam']['body_occupancy']:.4f} / {occ['jam']['walk_occupancy']:.4f} "
          f"({occ['1M']['pairs']} and {occ['jam']['pairs']} pairs) on {card}",
          flush=True)
    return {"name": "flat_pairwise", "route": "cuda",
            "source": CSRC + "flat_pairwise.cu",
            "replaces": "pedoni_tpu/ops/forcepass.py:141 (XLA, no pallas_call)",
            "path": "flat", "launches": launches,
            "max_abs_err": max(errs.values()), "ms": k_ms, "plain_ms": t_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": None,
            "k_up_to": k_up_to, "jam_ms": jam_ms, "occupancy": occ}


def _cases_module(name: str = "test_torch_flat_sample_cases"):
    """tests/test_torch_flat_sample_cases.py (seeded edge-case agents), or
    the module of tests/ named."""
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "tests" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same_bits(got: torch.Tensor, want: torch.Tensor) -> float:
    """Raise unless NaN stands in the same places and every other value is
    bit for bit the same; else the max |err|, 0.0."""
    nan = torch.isnan(want)
    if not torch.equal(torch.isnan(got), nan) or not torch.equal(
            got[~nan].view(torch.int32), want[~nan].view(torch.int32)):
        raise AssertionError("not bit-equal: max |err| "
                             f"{float((got - want).abs().nan_to_num().max()):.3e}")
    return 0.0


def _flat_sample_entry(dev, card, sample: tuple, launches: int,
                       in_step_us: float, in_step_launches: float) -> dict:
    """15c. The flat sample kernel against its twin (sampling.
    flat_sample_torch, on the card) bit for bit (``_same_bits``, and the
    cell ids equal) on tests/test_torch_flat_sample_cases.py's edge cases
    on gap.toml's fields, sanitized and not, at ragged sizes, and on the 1M
    problem's agents (``sample``: the step's arguments); kernel, twin and
    bound timed there, beside the kernel's us/step in the step's profile
    (``in_step_us`` over ``in_step_launches`` launches a step), the taps'
    footprint in 32-byte sectors and the
    library yardstick of the taps alone, ``grid_sample``
    (``_grid_sample_call``).  Returns the JSON entry, with ``launches``
    from the 1M run."""
    from pedoni_tpu_torch.field import Field, FieldMaps
    from pedoni_tpu_torch.ops.kernels import flat_sample as fsk
    from pedoni_tpu_torch.ops.neighbor import CellGrid
    from pedoni_tpu_torch.ops.sampling import DeviceField, flat_sample_torch
    from pedoni_tpu_torch.scenario import load_scenario

    sc = load_scenario(GAP)
    field = DeviceField.from_maps(FieldMaps.from_field(Field.from_scenario(sc, unit=0.25)),
                                  dev)
    grid = CellGrid.for_size(sc.size, 1.4)
    cases = _cases_module()
    checks = []
    for n, sanitize in ((3000, True), (3000, False), (200_003, True), (1, True),
                        (SAMPLE_RAGGED, False)):
        agents = [torch.from_numpy(x[:n]).to(dev)
                  for x in cases.edge_case_agents(max(n, 3000), n % 97)]
        checks.append((f"edge cases, {n} agents{'' if sanitize else ', unsanitized'}",
                       (field.rows, field.hp, field.wp_cols, *agents, 0.25, 0.25, grid),
                       {"sanitize": sanitize}))
    args, kw = sample
    checks.append((f"1M problem, {args[3].shape[0]} agents", args, kw))
    errs = {}
    for what, a, k in checks:
        got, cid = fsk.flat_sample(*a, **k)
        want, wcid = flat_sample_torch(*a, **k)
        torch.cuda.synchronize()
        try:
            errs[what] = _same_bits(got, want)
        except AssertionError as e:
            raise AssertionError(f"flat_sample {what}: {e}") from None
        if not torch.equal(cid, wcid):
            raise AssertionError(f"flat_sample {what}: cell ids differ at "
                                 f"{int((cid != wcid).sum())} agents")
    packed, cid = fsk.flat_sample(*args, **kw)
    k_ms = _median_ms(lambda: fsk.flat_sample(*args, **kw))
    t_ms = _median_ms(lambda: flat_sample_torch(*args, **kw), n=TWIN_RUNS)
    rows, hp, wp, pos, vel, speed, dest, active, unit = args[:9]
    need = _needed_bytes("flat_sample", (rows, hp, wp, pos, vel, speed, dest,
                                         active, unit), (packed, cid))
    n = pos.shape[0]
    b_ms, by = _bound(need, n * FLAT_SAMPLE_FLOPS)
    foot = _tap_footprint(rows, hp, wp, pos, dest, unit)
    grid_sample, gs_err = _grid_sample_call(args)
    gs_ms = _median_ms(grid_sample)
    print(f"# flat_sample: bit-equal to its twin on the card (max |err| 0, NaN in "
          f"the same places, cell ids equal) on {', '.join(errs)}; on the 1M "
          f"problem kernel {k_ms:.4f} ms, in the step {in_step_us:.1f} us/step "
          f"over {in_step_launches:.2f} launches a step recorded, "
          f"{in_step_us / max(in_step_launches, 1e-9):.1f} us a launch (phase "
          f"15's profile), twin {t_ms:.4f} ms (median of 20 and "
          f"{TWIN_RUNS}, CUDA events), bound {b_ms:.4f} ms ({by}; {need / 1e6:.1f} "
          f"MB needed, {need / n:.1f} B an agent, at {HBM_BYTES_PER_S / 1e12:.2f} "
          f"TB/s; {b_ms / k_ms:.1%} of it); the taps touch {foot['texels']} "
          f"texel rows in {foot['sectors_32']} 32-byte sectors "
          f"({foot['sectors_32_mb']:.1f} MB; {foot['pieces_64_mb']:.1f} MB in "
          f"64-byte pieces); library: grid_sample of the taps alone (six "
          f"channels, no despawn, cell id or packing) {gs_ms:.4f} ms, max "
          f"relative err {gs_err:.2e} against the kernel's obstacle channels on "
          f"{card}",
          flush=True)
    return {"name": "flat_sample", "route": "cuda", "source": CSRC + "flat_sample.cu",
            "replaces": "pedoni_tpu/ops/sampling.py:70 + pedoni_tpu/models/sfm.py:335 "
                        "(XLA, no pallas_call)",
            "path": "flat", "launches": launches, "max_abs_err": max(errs.values()),
            "ms": k_ms, "plain_ms": t_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": gs_ms, "library": "grid_sample of the taps alone",
            "in_step_us": in_step_us, "in_step_launches": in_step_launches,
            "tap_sectors_32": foot["sectors_32"]}


def _row_gather_finding(card, packed: torch.Tensor, cid: torch.Tensor,
                        order: torch.Tensor) -> dict:
    """15e. The flat step's [N, 12] row gather after its sort, alone, on the
    1M problem's rows and permutation: ``index_select`` (the step's),
    ``packed[order]``, ``torch.gather`` with the index broadcast over the
    12 channels, the same gather with a sorted order, of [N, 4] rows, of
    the [N] cell ids, of a quarter of the rows, and a contiguous copy of
    the same bytes (median of GATHER_RUNS, CUDA events).  PyTorch's
    ``vectorized_gather_kernel``, which ``index_select`` reaches, launches
    one block a row; the printed waves are rows over the blocks the card
    holds at once (SM_COUNT x BLOCKS_PER_SM)."""
    n = order.shape[0]
    quarter = order[: n // 4]
    ident = torch.arange(n, device=order.device)
    narrow = packed[:, :4].contiguous()
    out = {}
    forms = (("index_select", lambda: packed.index_select(0, order)),
             ("packed[order]", lambda: packed[order]),
             ("torch.gather", lambda: torch.gather(packed, 0, order[:, None].expand(-1, 12))),
             ("index_select, sorted order", lambda: packed.index_select(0, ident)),
             ("index_select, [N, 4] rows", lambda: narrow.index_select(0, order)),
             ("index_select, the [N] cell ids", lambda: cid.index_select(0, order)),
             ("index_select, N / 4 rows", lambda: packed.index_select(0, quarter)),
             ("contiguous copy of the same bytes", lambda: packed[:n].clone()))
    for what, fn in forms:
        out[what] = _median_ms(fn, n=GATHER_RUNS)
    if not torch.equal(packed[order], packed.index_select(0, order)):
        raise AssertionError("row gather: packed[order] != index_select")
    waves = n / (SM_COUNT * BLOCKS_PER_SM)
    print(f"# the [N, 12] row gather alone, N = {n}, 48-byte rows (median of "
          f"{GATHER_RUNS}, CUDA events) on {card}: " + "; ".join(
              f"{k} {v:.4f} ms" for k, v in out.items())
          + f"; bytes at {HBM_BYTES_PER_S / 1e12:.2f} TB/s "
          f"{2 * n * 48 / HBM_BYTES_PER_S * 1e3:.4f} ms; one block a row is "
          f"{n} blocks, {waves:.0f} waves of {SM_COUNT} SMs x {BLOCKS_PER_SM} "
          f"resident blocks, {out['index_select'] / waves * 1e3:.2f} us a wave",
          flush=True)
    return {k: v for k, v in out.items()}


def _scatter_outputs(sc) -> list[torch.Tensor]:
    """Every tensor of a flat_scatter result, in order (None left out)."""
    out = [sc.rows, sc.cid, sc.dest, sc.active, sc.n_active, sc.speed]
    if sc.layout is not None:
        out += list(sc.layout)
    return out + ([sc.data] if sc.data is not None else [])


def _scatter_bits(got, want) -> float:
    """Raise unless every output of two flat_scatter results is the same,
    floats bit for bit; else 0.0."""
    a, b = _scatter_outputs(got), _scatter_outputs(want)
    if len(a) != len(b):
        raise AssertionError(f"{len(a)} outputs against {len(b)}")
    for i, (x, y) in enumerate(zip(a, b)):
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if x.shape != y.shape or not torch.equal(x, y):
            raise AssertionError(f"output {i} differs")
    return 0.0


def _flat_scatter_entry(dev, card, scatter: tuple, launches: int,
                        index_select_ms: float) -> dict:
    """15c. The flat scatter kernel against its twin (flat_scatter.
    flat_scatter_torch, on the card) bit for bit on every output
    (``_scatter_bits``) on tests/test_torch_flat_scatter_cases.py's cases
    (cells past K, the sentinel run, holes, N > C, NaN and inf rows, K 255,
    a ragged nx, an x-strip's window; also without cells and with the
    pallas slot grid's strides) and on the 1M problem's sorted agents
    (``scatter``: the step's arguments); kernel, twin and bound timed
    there.  ``index_select_ms``, the [N, 12] row gather alone
    (``_row_gather_finding``), is the library call's time: the rows are
    the one part of its work that one PyTorch call computes.  Returns the
    JSON entry, with ``launches`` from the 1M run."""
    from pedoni_tpu_torch.ops.kernels import flat_scatter as fck
    from pedoni_tpu_torch.ops.neighbor import CellGrid

    cases = _cases_module("test_torch_flat_scatter_cases")
    checks = []
    for name in cases.CASES:
        packed, cid, order, (ny, nx), k = cases.scatter_case(name)
        grid = CellGrid(cases.UNIT, nx, ny)
        a = tuple(torch.from_numpy(x).to(dev) for x in (packed, cid, order)) + (grid, k)
        nxl = nx + 3
        for what, kw in (("", {}), (" (no cells)", {"cells": False}),
                         (" (slot-grid strides)", {"strides": (k * 8 * nxl, 1, 8 * nxl),
                                                   "size": (ny + 2) * k * 8 * nxl})):
            checks.append((f"{name}{what}", a, kw))
    args, kw = scatter
    checks.append((f"1M problem, {args[2].shape[0]} sorted agents", args, kw))
    errs, k_up_to = {}, 0
    for what, a, k_ in checks:
        got, want = fck.flat_scatter(*a, **k_), fck.flat_scatter_torch(*a, **k_)
        torch.cuda.synchronize()
        try:
            errs[what] = _scatter_bits(got, want)
        except AssertionError as e:
            raise AssertionError(f"flat_scatter {what}: {e}") from None
        k_up_to = max(k_up_to, a[4])
    sc = fck.flat_scatter(*args, **kw)
    k_ms = _median_ms(lambda: fck.flat_scatter(*args, **kw))
    t_ms = _median_ms(lambda: fck.flat_scatter_torch(*args, **kw), n=TWIN_RUNS)
    packed, cid, order = args[:3]
    c = order.shape[0]
    # each sorted row's order entry, cell id and packed row read once;
    # every output written once
    need = c * (order.element_size() + cid.element_size()
                + packed.shape[1] * packed.element_size()) + _nbytes(
                    *_scatter_outputs(sc))
    b_ms, by = _bound(need)
    print(f"# flat_scatter: bit-equal to its twin on the card (every output, the "
          f"padded grid whole) on {', '.join(errs)}; on the 1M problem kernel "
          f"{k_ms:.4f} ms, twin {t_ms:.4f} ms (median of 20 and {TWIN_RUNS}, CUDA "
          f"events), [N, 12] index_select alone {index_select_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms ({by}; {need / 1e6:.1f} MB needed, {need / c:.1f} B an "
          f"agent with the grid's {_nbytes(sc.data) / 1e6:.1f} MB, at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; {b_ms / k_ms:.1%} of it) on {card}",
          flush=True)
    return {"name": "flat_scatter", "route": "cuda", "source": CSRC + "flat_scatter.cu",
            "replaces": "pedoni_tpu/models/sfm.py:373 + pedoni_tpu/ops/forcepass.py:50, "
                        "77 (XLA, no pallas_call)",
            "path": "flat", "launches": launches, "max_abs_err": max(errs.values()),
            "ms": k_ms, "plain_ms": t_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": index_select_ms, "k_up_to": k_up_to}


def _flat_integrate_entry(dev, card, integrate: tuple, launches: int) -> dict:
    """15c. The flat integrate kernel against its twin (flat_integrate.
    flat_integrate_torch, on the card) bit for bit (``_same_bits``) on the
    flat scatter cases' sorted rows and layout with a seeded pair grid, in
    each mode (the obstacle term from the rows, from segments computed
    apart, or none; the pair term through the layout, or computed apart),
    and on the 1M problem's (``integrate``: the step's arguments); kernel,
    twin and bound timed there.  Returns the JSON entry, with ``launches``
    from the 1M run."""
    from pedoni_tpu_torch.ops import forces
    from pedoni_tpu_torch.ops.kernels import flat_integrate as fik
    from pedoni_tpu_torch.ops.kernels import flat_scatter as fck
    from pedoni_tpu_torch.ops.neighbor import CellGrid

    cases = _cases_module("test_torch_flat_scatter_cases")
    gen = torch.Generator(device=dev).manual_seed(5)
    seg = tuple(torch.tensor(x, device=dev) for x in (
        [[3.0, 1.0], [9.0, 4.0]], [[3.0, 8.0], [15.0, 4.5]], [0.6, 1.0]))
    args, kw = integrate
    phys = args[2]
    checks = []
    for name, mode in zip(cases.CASES, ("distance_map", "all_pairs", "distance_map",
                                        "segments", "no_obstacles", "segments")):
        packed, cid, order, (ny, nx), k = cases.scatter_case(name)
        sc = fck.flat_scatter_torch(*(torch.from_numpy(x).to(dev)
                                      for x in (packed, cid, order)),
                                    CellGrid(cases.UNIT, nx, ny), k)
        k_ = {"acc_flat": torch.randn((sc.data.numel() // 8, 2), generator=gen,
                                      device=dev),
              "layout": sc.layout, "distance_map": mode == "distance_map"}
        if mode == "segments":
            k_["obstacle"] = forces.segment_obstacle_force(sc.rows[:, 0:2], *seg, phys)
        if mode == "all_pairs":
            k_["pair"] = torch.randn((sc.rows.shape[0], 2), generator=gen, device=dev)
        checks.append((f"{name} ({mode})", (sc.rows, sc.active, phys), k_))
    checks.append((f"1M problem, {args[0].shape[0]} sorted agents", args, kw))
    errs = {}
    for what, a, k_ in checks:
        got, want = fik.flat_integrate(*a, **k_), fik.flat_integrate_torch(*a, **k_)
        torch.cuda.synchronize()
        try:
            errs[what] = max(_same_bits(g, w) for g, w in zip(got, want))
        except AssertionError as e:
            raise AssertionError(f"flat_integrate {what}: {e}") from None
    pos, vel = fik.flat_integrate(*args, **kw)
    k_ms = _median_ms(lambda: fik.flat_integrate(*args, **kw))
    t_ms = _median_ms(lambda: fik.flat_integrate_torch(*args, **kw), n=TWIN_RUNS)
    rows, active = args[:2]
    layout = kw["layout"]
    c = rows.shape[0]
    n_valid = int(layout.valid.sum())
    # of each row pos, vel, speed, e, the distance and its Sobel (10 of 12
    # words), its flag, slot and valid flag; the pair term of each valid
    # row; both outputs
    need = (c * (10 * rows.element_size() + active.element_size()
                 + layout.slot.element_size() + layout.valid.element_size())
            + n_valid * 2 * kw["acc_flat"].element_size() + _nbytes(pos, vel))
    b_ms, by = _bound(need, c * FLAT_INTEGRATE_FLOPS)
    print(f"# flat_integrate: bit-equal to its twin on the card (NaN in the same "
          f"places) on {', '.join(errs)}; on the 1M problem kernel {k_ms:.4f} ms, "
          f"twin {t_ms:.4f} ms (median of 20 and {TWIN_RUNS}, CUDA events), bound "
          f"{b_ms:.4f} ms ({by}; {need / 1e6:.1f} MB needed, {need / c:.1f} B an "
          f"agent, at {HBM_BYTES_PER_S / 1e12:.2f} TB/s; {b_ms / k_ms:.1%} of it) on "
          f"{card}", flush=True)
    return {"name": "flat_integrate", "route": "cuda",
            "source": CSRC + "flat_integrate.cu",
            "replaces": "pedoni_tpu/ops/forces.py:41, 92, 158 + "
                        "pedoni_tpu/ops/forcepass.py:187 (XLA, no pallas_call)",
            "path": "flat", "launches": launches, "max_abs_err": max(errs.values()),
            "ms": k_ms, "plain_ms": t_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": None}


def _flat_phase(dev, card) -> dict:
    """15. The flat backend on the card (module docstring, item 15).
    Returns the phase's numbers, with the four kernels' JSON entries under
    "kernels"."""
    res = _flat_sim_checks(dev)
    cap = {}
    res.update(_flat_1m(dev, card, capture=cap))
    want = dict(dict.fromkeys(res["launches"], 0),
                **dict.fromkeys(FLAT_KERNELS, FLAT_WARMUP + FLAT_TIMED))
    if res["launches"] != want:
        raise AssertionError(f"1M flat: launches {res['launches']}, want {want}")
    if res["tap_gathers"] or res["row_gathers"]:
        raise AssertionError(f"1M flat: {res['tap_gathers']} field-tap gathers and "
                             f"{res['row_gathers']} [N, 12] row gathers a step "
                             "left in the profile")
    d, phys = cap["grid"]
    res["row_gather_ms"] = _row_gather_finding(card, cap["packed"], cap["cid"],
                                               cap["order"])
    res["kernels"] = [
        _flat_kernel_entry(dev, card, d, phys, res["launches"]["flat_pairwise"]),
        _flat_sample_entry(dev, card, cap["sample"], res["launches"]["flat_sample"],
                           res["kernel_us"]["flat_sample"],
                           res["kernel_profile_launches"]["flat_sample"]),
        _flat_scatter_entry(dev, card, cap["scatter"], res["launches"]["flat_scatter"],
                            res["row_gather_ms"]["index_select"]),
        _flat_integrate_entry(dev, card, cap["integrate"],
                              res["launches"]["flat_integrate"])]
    del d, cap
    torch.cuda.empty_cache()  # the 1M problem's tensors are gone
    res.update(_flat_subprocesses(card))
    _flat_model_and_quickstart(dev)
    return res


def _near_contact(agents, cand, speed_out: np.ndarray) -> np.ndarray:
    """For each output row of a flat step, whether its agent was in near
    contact at the step's input (``agents`` and the candidates ``cand``).
    Rows are matched to input agents by their desired speed, which a step
    carries unchanged and the seeded draws make unique."""
    act = torch.cat([agents.active, cand.active]).cpu()
    pos = torch.cat([agents.pos, cand.pos]).cpu()[act].double().numpy()
    speed = torch.cat([agents.speed, cand.speed]).cpu()[act].numpy()
    if np.unique(speed).size != speed.size:
        raise AssertionError("near contact: two input agents share a speed")
    d2 = ((pos[:, None] - pos[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    near = speed[d2.min(1) < NEAR_CONTACT ** 2]
    return np.isin(speed_out.astype(np.float32), near)


def _pallas_vs_cpu(dev, mode: str, sc, cfg_kw, agents, cands) -> float:
    """Pallas steps, each on the card and on the CPU from the CPU's state
    and the same candidates, slot by slot (the sort's cell ids come from
    the same IEEE divide): positions and velocities within TOL, except the
    velocities of agents in near contact, within NEAR_CONTACT_VEL_TOL (at
    most 1% of the rows); the rest and every metric equal; each step on
    the card launches the step kernel once, in its mode, and none on the
    CPU.  Returns the max |err| of pos and vel."""
    from pedoni_tpu_torch.field import Field, FieldMaps
    from pedoni_tpu_torch.models import sfm, sfm_pallas
    from pedoni_tpu_torch.models.sfm import SimState

    maps = FieldMaps.from_field(Field.from_scenario(sc, unit=0.25))
    cfg = sfm.StepConfig.build(sc, **cfg_kw)
    counter = "step_kernel_segments" if mode == "segments" else "step_kernel"
    steps = {}
    for d in (dev, torch.device("cpu")):
        fwp, fobs = sfm_pallas.pallas_device_inputs(cfg, maps, d)
        steps[d.type] = (sfm_pallas.make_step_pallas(
            cfg, generator=torch.Generator(device=d)), fwp, fobs, d)
    st = SimState(agents.to("cpu"), 0)
    err = err_vel = err_near = 0.0
    n_near = 0
    for i, cand in enumerate(cands):
        out = {}
        for name, (step, fwp, fobs, d) in steps.items():
            before = _launch_counts()[counter]
            new, m = step(SimState(st.agents.to(d), st.step), fwp, fobs, cand.to(d))
            out[name] = (_flat_rows(new.agents),
                         {k: int(v) for k, v in m._asdict().items()},
                         _launch_counts()[counter] - before, new)
        near = _near_contact(st.agents, cand, out["cpu"][0][:, 4])
        (got, gm, gl, _), (want, wm, wl, st) = out["cuda"], out["cpu"]
        e_pos = float(np.abs(got[:, :2] - want[:, :2]).max())
        e_vel = np.abs(got[:, 2:4] - want[:, 2:4]).max(1)
        e_far = float(e_vel[~near].max())
        e_near = float(e_vel[near].max()) if near.any() else 0.0
        err, err_vel = max(err, e_pos), max(err_vel, e_far)
        err_near, n_near = max(err_near, e_near), n_near + int(near.sum())
        if (gm != wm or e_pos > TOL or e_far > TOL or e_near > NEAR_CONTACT_VEL_TOL
                or near.sum() > 0.01 * near.size or (gl, wl) != (1, 0)
                or not np.array_equal(got[:, 4:], want[:, 4:])):
            raise AssertionError(f"pallas step ({mode}) {i}: card {gm} vs CPU "
                                 f"{wm}, pos err {e_pos:.3e}, vel err {e_far:.3e}, "
                                 f"near contact {int(near.sum())} rows, vel err "
                                 f"{e_near:.3e}, launches {gl} / {wl}")
    print(f"# pallas step ({mode}), {len(cands)} steps each from the CPU's "
          f"state, card vs CPU: metrics equal (last {wm}), pos max |err| "
          f"{err:.3e} (tol {TOL}), vel max |err| {err_vel:.3e} (tol {TOL}); "
          f"{n_near} rows in near contact (< {NEAR_CONTACT} m), vel max |err| "
          f"{err_near:.3e} (tol {NEAR_CONTACT_VEL_TOL}); speed/dest/active "
          f"equal; one {counter} launch a step on the card, none on the CPU",
          flush=True)
    return max(err, err_vel, err_near)


def _pallas_sim_checks(dev) -> dict:
    """16a. gap.toml through Simulator(backend="pallas"); pallas steps on the
    card against the CPU in base and segment mode on the spawning scenario;
    SPAWN_SYNC_STEPS spawning steps under sync debug mode "error"."""
    from pedoni_tpu_torch import Simulator, SimulatorOptions, load_scenario
    from pedoni_tpu_torch.convert import agents_from_numpy
    from pedoni_tpu_torch.models import sfm
    from pedoni_tpu_torch.scenario import loads_scenario

    none = {k: 0 for k in _launch_counts()}
    gap_steps = {}
    for counter, dmap in (("step_kernel", True), ("step_kernel_segments", False)):
        t0 = time.perf_counter()
        _zero_launch_counts()
        sim = Simulator(SimulatorOptions(backend="pallas", device=dev.type, seed=1,
                                         use_distance_map=dmap), load_scenario(GAP))
        what = f"gap.toml (pallas{'' if dmap else ', segments'})"
        n0, steps = _evacuate(sim, what)
        counts = _launch_counts()
        if counts != {**none, counter: steps} or sim.cfg.grid.unit != 1.5:
            raise AssertionError(f"{what}: launches {counts} for {steps} ticks, "
                                 f"unit {sim.cfg.grid.unit}")
        gap_steps[counter] = steps
        print(f"# {what} (1.5 m): {n0} agents evacuated in {steps} ticks (limit "
              f"{GAP_MAX_STEPS}), {time.perf_counter() - t0:.1f} s; launches "
              f"{counts}", flush=True)

    sc = loads_scenario(SPAWN_SCENARIO)
    rng = np.random.default_rng(6)
    n = 640
    agents = agents_from_numpy(
        rng.uniform(0.8, 11.2, (n, 2)) * np.array([1.5, 1.0]),
        rng.normal(0, 0.4, (n, 2)), rng.uniform(0.8, 1.7, n),
        rng.integers(0, 2, n), np.arange(n) < 500, "cpu")
    base_kw = dict(capacity=n, neighbor_grid_unit=1.5, table_capacity=12)
    gen = torch.Generator().manual_seed(3)
    cands = [sfm.spawn_candidates(sfm.StepConfig.build(sc, **base_kw), gen)
             for _ in range(3)]
    errs = [_pallas_vs_cpu(dev, mode, sc, dict(base_kw, **kw), agents, cands)
            for mode, kw in (("base", {}), ("segments", {"use_distance_map": False}))]

    sim = Simulator(SimulatorOptions(backend="pallas", device=dev.type, seed=2), sc)
    for _ in range(2):
        sim.tick()
    torch.cuda.synchronize()
    _zero_launch_counts()
    spawned = []
    with _no_sync():
        for _ in range(SPAWN_SYNC_STEPS):
            sim.state, m = sim._step(sim.state, sim._fwp, sim._fobs)
            spawned.append(m.n_spawned)
    n_sp = int(sum(spawned))
    if n_sp == 0 or _launch_counts()["step_kernel"] != SPAWN_SYNC_STEPS:
        raise AssertionError(f"pallas spawning steps: {n_sp} spawned, launches "
                             f"{_launch_counts()}")
    print(f"# pallas step, spawning: {SPAWN_SYNC_STEPS} steps under "
          f"set_sync_debug_mode('error'), {n_sp} spawned, "
          f"{sim.pedestrian_count} active, launches {_launch_counts()}", flush=True)
    return {"gap_steps": gap_steps["step_kernel"],
            "gap_segment_launches": gap_steps["step_kernel_segments"],
            "max_abs_err_vs_cpu": max(errs)}


def _pallas_kernel_entry(dev, card, what, dk, fwp, fobs, phys, size, **kw) -> dict:
    """The step kernel against its twin on the slot grid the pallas step
    makes (``kw``: the segment table), timed beside its twin and bound."""
    from pedoni_tpu_torch.ops.kernels import step_kernel as sk

    seg = kw.get("segments") is not None
    g_k = sk.fused_step(dk, fwp, fobs, phys, size, **kw)
    g_t = sk.fused_step_torch(dk, fwp, fobs, phys, size, **kw)
    torch.cuda.synchronize()
    ch = slice(4, 8) if seg else slice(4, 7)
    if not torch.equal(g_k[:, :, ch], g_t[:, :, ch]):
        raise AssertionError(f"{what}: step kernel channels {ch} differ")
    err = _step_err(dk, g_k, g_t)
    k_ms = _median_ms(lambda: sk.fused_step(dk, fwp, fobs, phys, size, **kw))
    t_ms = _median_ms(lambda: sk.fused_step_torch(dk, fwp, fobs, phys, size, **kw),
                      n=TWIN_RUNS)
    if seg:
        need = _needed_bytes("step_kernel_segments", (dk, fwp, kw["segments"], 6),
                             (g_t,))
    else:
        need = _needed_bytes("step_kernel", (dk, fwp, fobs), (g_t,))
    b_ms, by = _bound(need, _pair_candidates(dk) * PAIR_FLOPS)
    print(f"# {what}: step kernel max |err| {err:.3e} (tol {TOL}), kernel "
          f"{k_ms:.4f} ms, twin {t_ms:.4f} ms (medians of 20 and {TWIN_RUNS}), "
          f"bound {b_ms:.4f} ms ({by}; {need / 1e6:.1f} MB; {b_ms / k_ms:.1%} "
          f"of it) on {card}", flush=True)
    return {"max_abs_err": err, "ms": k_ms, "plain_ms": t_ms, "bound_ms": b_ms,
            "bound_by": by}


def _pallas_1m(dev, card) -> dict:
    """16b. The 1M pallas bench problem (square field, 1.5 m cells, K 14):
    PALLAS_TIMED steps after PALLAS_WARMUP under sync debug mode "error",
    host clock, launch counts zeroed before and read after, peak memory
    within ``sfm_pallas.device_bytes``; the step kernel against its twin on
    the slot grid the step makes, in base and segment mode, timed; then
    PALLAS_PROFILE_STEPS under torch.profiler."""
    import collections

    from pedoni_tpu_torch.bench import build_problem
    from pedoni_tpu_torch.models import sfm_pallas
    from pedoni_tpu_torch.ops.kernels import step_kernel as sk

    none = {k: 0 for k in _launch_counts()}
    t0 = time.perf_counter()
    _sc, maps, cfg, flat = build_problem(N_AGENTS, device=dev, backend="pallas")
    torch.cuda.synchronize()
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    need = sfm_pallas.device_bytes(cfg)
    fwp, fobs = sfm_pallas.pallas_device_inputs(cfg, maps, dev)
    step = sfm_pallas.make_step_pallas(cfg)
    t_build = time.perf_counter() - t0
    st = flat
    del flat
    n_steps = PALLAS_WARMUP + PALLAS_TIMED
    _zero_launch_counts()
    for _ in range(PALLAS_WARMUP):
        st, m = step(st, fwp, fobs)
    torch.cuda.synchronize()
    with _no_sync():
        t0 = time.perf_counter()
        for _ in range(PALLAS_TIMED):
            st, m = step(st, fwp, fobs)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / PALLAS_TIMED * 1e3
    counts = _launch_counts()
    peak = torch.cuda.max_memory_allocated() - base_bytes
    if counts != {**none, "step_kernel": n_steps}:
        raise AssertionError(f"1M pallas: launches {counts} for {n_steps} steps")
    if peak > need:
        raise AssertionError(f"1M pallas: peak memory {peak} > device_bytes {need}")
    n_active = int(m.n_active)
    a = st.agents
    if n_active < 0.99e6 or not bool(torch.isfinite(a.pos[a.active]).all()):
        raise AssertionError(f"1M pallas: {n_active} active, or non-finite positions")
    print(f"# 1M pallas problem: grid {cfg.grid.nx} x {cfg.grid.ny} cells of "
          f"{cfg.grid.unit} m, K {cfg.table_capacity}, capacity {cfg.capacity}; "
          f"built in {t_build:.1f} s; {PALLAS_WARMUP} warm-up + {PALLAS_TIMED} timed "
          f"steps (under set_sync_debug_mode('error')): {wall:.4f} ms/step wall, "
          f"{n_active} active, overflow last step {int(m.n_overflow)} (frozen), "
          f"dropped {int(m.n_dropped)}; launches {counts}; peak memory {peak} "
          f"bytes, device_bytes {need} ({peak / need:.1%}) on {card}", flush=True)

    phys, size = cfg.physics, cfg.scenario.size
    dk = sfm_pallas.slot_grid(cfg, st.agents)
    entries = {"step_kernel": _pallas_kernel_entry(
        dev, card, "1M pallas slot grid", dk, fwp, fobs, phys, size)}
    segs = sk.segment_table(_obstacles(cfg.scenario), dev)
    entries["step_kernel_segments"] = _pallas_kernel_entry(
        dev, card, "1M pallas slot grid, segments", dk, fwp, fobs, phys, size,
        segments=segs)
    del dk
    entries["step_kernel"]["launches"] = counts["step_kernel"]

    state = [st]

    def run():
        state[0] = step(state[0], fwp, fobs)[0]

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(PALLAS_PROFILE_STEPS):
            run()
        torch.cuda.synchronize()
    us, per_step = collections.Counter(), collections.Counter()
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us[ev.key] += ev.self_device_time_total / PALLAS_PROFILE_STEPS
            per_step[ev.key] += ev.count / PALLAS_PROFILE_STEPS
    launches = sum(per_step.values())
    dev_ms = sum(us.values()) / 1e3
    if not dev_ms > 0:
        raise AssertionError("1M pallas: the profiler traced no device time")
    kern_us = {k: sum(v for key, v in us.items() if k in key)
               for k in ("step_sample", "step_pairs")}
    print(f"# 1M pallas profile, {PALLAS_PROFILE_STEPS} steps (torch.profiler): "
          f"device {dev_ms:.4f} ms/step, {launches:.1f} launches a step, wall "
          f"{wall:.4f} ms/step unprofiled, busy share {dev_ms / wall:.3f}; "
          f"step_sample {kern_us['step_sample']:.2f} us, step_pairs "
          f"{kern_us['step_pairs']:.2f} us, glue "
          f"{dev_ms * 1e3 - sum(kern_us.values()):.2f} us a step; top kernels "
          f"(us/step, launches a step): " + "; ".join(
              f"{k[:60]} {v:.1f} ({per_step[k]:.0f})" for k, v in us.most_common(10)),
          flush=True)
    return {"ms_per_step": wall, "device_ms_per_step": dev_ms,
            "launches_per_step": launches, "busy_share": dev_ms / wall,
            "peak_bytes": peak, "device_bytes": need, "n_active": n_active,
            "kernels": entries}


def _pallas_subprocesses(card) -> dict:
    """16c. ``python -m pedoni_tpu_torch.bench --backend pallas``, the CLI on
    gap.toml with ``-b pallas`` (the card) and ``-b cpu`` (the flat step on
    the CPU), one ``-b grid`` run with ``--record-every 10 --frame-every
    100 --profile DIR`` on the card (traj.bin read back against the log,
    the frames, and the trace naming the step kernel's two launches), and
    a ``-b pallas`` run without ``-H`` and with ``--render-web 0``."""
    import tempfile

    from pedoni_tpu_torch.native import read_trajectory

    rec = None
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        cli = [str(GAP), "-H", "-s", "0", "--seed", "1", "--max-steps", "300"]
        runs = (("bench", ["pedoni_tpu_torch.bench", "--backend", "pallas",
                           "--steps", "8", "--warmup", "2"]),
                ("CLI -b pallas", ["pedoni_tpu_torch", *cli, "-b", "pallas",
                                   "--log-dir", str(tmp / "pallas")]),
                ("CLI -b cpu", ["pedoni_tpu_torch", *cli[:-2], "--max-steps",
                                str(CPU_CLI_STEPS), "-b", "cpu", "--log-dir",
                                str(tmp / "cpu")]),
                ("CLI -b grid, record/frames/profile",
                 ["pedoni_tpu_torch", *cli, "-b", "grid", "--record-every", "10",
                  "--frame-every", "100", "--profile", str(tmp / "trace"),
                  "--log-dir", str(tmp / "grid")]))
        for name, argv in runs:
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, "-m", *argv], cwd=ROOT,
                               capture_output=True, text=True, timeout=600)
            if r.returncode != 0:
                raise AssertionError(f"{name} exited {r.returncode}:\n"
                                     f"{r.stderr[-3000:]}")
            dt = time.perf_counter() - t0
            if name == "bench":
                lines = [ln for ln in r.stdout.splitlines() if ln.strip()]
                rec = json.loads(lines[0])
                if len(lines) != 1 or not (rec["value"] > 0 and rec["device"]
                                           == card.splitlines()[0]):
                    raise AssertionError(f"bench --backend pallas printed {r.stdout}")
                print(f"# {name} (python -m {argv[0]}): exit 0 in {dt:.1f} s; "
                      f"{lines[0]}", flush=True)
                continue
            log_dir = pathlib.Path(argv[argv.index("--log-dir") + 1])
            (out,) = log_dir.glob("*_log.json")
            log = json.loads(out.read_text())
            pops = log["step_metrics"]["active_ped_count"]
            backend = argv[argv.index("-b") + 1]
            model = {"pallas": "sfm-torch/pallas", "cpu": "sfm-torch/xla",
                     "grid": "sfm-torch/grid"}[backend]
            if backend == "cpu":  # the flat step on the CPU: a short run
                if log["model"] != model or log["total_steps"] != CPU_CLI_STEPS:
                    raise AssertionError(f"{name}: model {log['model']}, "
                                         f"{log['total_steps']} steps")
                print(f"# {name} (python -m {argv[0]}): exit 0 in {dt:.1f} s; "
                      f"model {log['model']}, {CPU_CLI_STEPS} steps, population "
                      f"{pops[0]} -> {pops[-1]}", flush=True)
                continue
            if log["model"] != model or pops[-1] != 0:
                raise AssertionError(f"{name}: model {log['model']}, "
                                     f"population {pops[-1]} at the end")
            said = (f"model {log['model']}, population {pops[0]} -> 0 at logged "
                    f"step {pops.index(0) + 1}")
            if backend == "grid":
                frames = list(read_trajectory(log_dir / "traj.bin"))
                steps = [f[0] for f in frames]
                if (steps != list(range(10, 301, 10))
                        or any(len(f[2]) != pops[f[0] - 1] for f in frames)):
                    raise AssertionError(f"{name}: traj.bin frames {steps}")
                pngs = sorted(p.name for p in log_dir.glob("frame_*.png"))
                if pngs != [f"frame_{s:08d}.png" for s in (100, 200, 300)]:
                    raise AssertionError(f"{name}: frames {pngs}")
                (trace,) = (tmp / "trace").glob("*_trace.json")
                text = trace.read_text()
                if "step_sample" not in text or "step_pairs" not in text:
                    raise AssertionError(f"{name}: the trace names no step kernel")
                kernel_s = log["step_metrics"]["time_calc_state_kernel"]
                timed = [x for x in kernel_s if x is not None]
                if len(timed) != 3 or not all(x > 0 for x in timed):
                    raise AssertionError(f"{name}: kernel times {timed}")
                said += (f"; traj.bin {len(frames)} frames (steps 10..300, each "
                         f"the logged population), {len(pngs)} PNG frames, trace "
                         f"{trace.stat().st_size} bytes naming step_sample and "
                         f"step_pairs, kernel time at steps 1/101/201 "
                         f"{[round(x * 1e3, 4) for x in timed]} ms")
            print(f"# {name} (python -m {argv[0]}): exit 0 in {dt:.1f} s; "
                  f"{said}", flush=True)
        # the non-headless mode (the terminal view from the snapshot
        # thread) with the web view, ended by --max-steps
        argv = [str(GAP), "-b", "pallas", "-s", "5", "--seed", "1", "--max-steps",
                "60", "--render-web", "0", "--log-dir", str(tmp / "view")]
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "pedoni_tpu_torch", *argv],
                           cwd=ROOT, capture_output=True, text=True, timeout=300)
        logs = list((tmp / "view").glob("*_log.json"))
        log = json.loads(logs[0].read_text()) if logs else {}
        frames = r.stdout.count("zoom")
        if (r.returncode != 0 or "web view: http://127.0.0.1:" not in r.stdout
                or frames == 0 or log.get("total_steps") != 60):
            raise AssertionError(f"CLI non-headless: exit {r.returncode}, "
                                 f"{frames} frames, {r.stderr[-2000:]}")
        print(f"# CLI -b pallas without -H, --render-web 0 (python -m "
              f"pedoni_tpu_torch): exit 0 in {time.perf_counter() - t0:.1f} s; "
              f"{frames} terminal frames drawn, the web view served, "
              f"{log['total_steps']} steps logged", flush=True)
    return {"bench": rec}


def _pallas_phase(dev, card) -> dict:
    """16. The pallas backend on the card (module docstring, item 16).
    Returns the phase's numbers."""
    res = _pallas_sim_checks(dev)
    res.update(_pallas_1m(dev, card))
    res["kernels"]["step_kernel_segments"]["launches"] = res["gap_segment_launches"]
    torch.cuda.empty_cache()  # the 1M problem's tensors are gone
    res.update(_pallas_subprocesses(card))
    return res


def _first_step_near_contact(flat_in, out_rows: np.ndarray) -> np.ndarray:
    """For each row (pos, vel, ...) of a first step's output from agents at
    rest, whether its agent had another active agent within NEAR_CONTACT
    at the step's input: an agent at rest moves by vel * dt / 2 in that
    step, so its input position is found from its output row (scipy's
    cKDTree over the input positions)."""
    from scipy.spatial import cKDTree

    a = flat_in.agents
    pos = a.pos[a.active].double().cpu().numpy()
    tree = cKDTree(pos)
    near = np.zeros(len(pos), bool)
    pairs = tree.query_pairs(NEAR_CONTACT, output_type="ndarray")
    near[pairs.ravel()] = True
    dt = 0.1
    _, src = tree.query(out_rows[:, 0:2] - out_rows[:, 2:4] * (dt / 2))
    return near[src]


def _spatial_phase(dev, card, flat_1m: dict) -> dict:
    """18. The 1M xla bench problem (phase 15's: the 632.5 m square at 1.4
    m) cut into x-strips (parallel/spatial.py): 2 strips on this card, and
    one strip a card where there are two cards or more.  The first step
    from the same state against the flat step (the problem spawns nothing,
    so no candidates to inject): every metric equal, rows order-free, pos
    and vel within TOL, NEAR_CONTACT_VEL_TOL for agents in near contact;
    then SPATIAL_STEPS chained steps of each: ``n_spawned`` equal, the
    difference in ``n_active`` and the largest position difference written
    down; wall ms/step over them, device ms/step (profiler,
    SPATIAL_PROFILE_STEPS steps), peak memory, beside the flat step's
    (``flat_1m``, phase 15).  Each strip-step launches the flat sample,
    scatter, pair and integrate kernels once each, and no other kernel
    runs.  Returns this phase's numbers."""
    from pedoni_tpu_torch.bench import build_problem
    from pedoni_tpu_torch.convert import metrics_to_dict
    from pedoni_tpu_torch.models import sfm
    from pedoni_tpu_torch.parallel import spatial

    def strip_agents(state):  # the strips' shards as one flat AgentState
        return sfm.AgentState(*(torch.cat([x.to(dev) for x in xs])
                                for xs in zip(*state.agents)))

    _sc, maps, cfg, flat = build_problem(N_AGENTS, device=dev, backend="xla")
    field, obstacles = sfm.device_inputs(cfg, maps, dev)
    fstep = sfm.make_step(cfg)
    plans = [("2 strips on one card", [dev, dev])]
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        plans.append((f"{n_cards} strips, one a card",
                      [torch.device("cuda", i) for i in range(n_cards)]))
    else:
        print("# phase 18: one strip a card did not run: this machine has 1 "
              "card", flush=True)

    def rows(agents):
        a = {k: t.detach().cpu().numpy() for k, t in agents._asdict().items()}
        r = np.concatenate([a["pos"], a["vel"], a["speed"][:, None]], 1
                           ).astype(np.float64)[a["active"]]
        return r[np.lexsort((r[:, 1], r[:, 0], r[:, 4]))]

    def timed(step, state, args, n):
        """n chained steps: (state, metrics of each, wall ms/step)."""
        ms = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            state, m = step(state, *args)
            ms.append(torch.stack(list(m)))
        torch.cuda.synchronize()
        return state, torch.stack(ms).cpu(), (time.perf_counter() - t0) / n * 1e3

    def profiled(step, state, args, what, wall):
        box = [state]

        def run():
            box[0] = step(box[0], *args)[0]

        return _device_profile(run, SPATIAL_PROFILE_STEPS, wall, what, card)

    f1, fm = fstep(flat, field.rows, obstacles)
    want = rows(f1.agents)
    fs, fms, f_wall = timed(fstep, f1, (field.rows, obstacles), SPATIAL_STEPS)
    f_dev = profiled(fstep, fs, (field.rows, obstacles), "1M flat (phase 18)", f_wall)
    f_final = rows(fs.agents)
    out = {"flat": {"ms_per_step": f_wall, "device_ms_per_step": f_dev,
                    "peak_bytes": flat_1m["peak_bytes"]}}
    for what, devices in plans:
        scfg = spatial.ShardedConfig.build(cfg, len(devices))
        srows, sobs = spatial.device_inputs(scfg, maps, devices)
        ss = spatial.shard_state(scfg, flat, devices)
        sstep = spatial.make_sharded_step(scfg, devices)
        base = [torch.cuda.memory_allocated(d) for d in set(devices)]
        for d in set(devices):
            torch.cuda.reset_peak_memory_stats(d)
        _zero_launch_counts()
        s1, sm = sstep(ss, srows, sobs)
        if metrics_to_dict(sm) != metrics_to_dict(fm):
            raise AssertionError(f"1M {what}: first-step metrics "
                                 f"{metrics_to_dict(sm)} != flat {metrics_to_dict(fm)}")
        got = rows(strip_agents(s1))
        if got.shape != want.shape:
            raise AssertionError(f"1M {what}: {got.shape[0]} rows, flat {want.shape[0]}")
        if not np.array_equal(got[:, 4], want[:, 4]):
            raise AssertionError(f"1M {what}: speeds differ from the flat step's")
        err = np.abs(got[:, :4] - want[:, :4])
        # a position within TOL, or one float apart: past 128 m an f32
        # position's spacing exceeds TOL, and a velocity one float apart
        # (the order of a cell's pair sum) can round it either way
        pos_tol = np.maximum(TOL, np.spacing(np.abs(want[:, 0:2]).astype(np.float32)))
        n_near = 0
        if (err[:, 0:2] > pos_tol).any():
            raise AssertionError(f"1M {what}: first-step positions off the flat "
                                 f"step by {err[:, 0:2].max(0)}")
        if err[:, 2:4].max() > TOL:
            near = _first_step_near_contact(flat, want)
            n_near = int(near.sum())
            if (err[~near, 2:4].max() > TOL
                    or err[near, 2:4].max(initial=0.0) > NEAR_CONTACT_VEL_TOL):
                raise AssertionError(f"1M {what}: first-step velocities off the "
                                     f"flat step by {err[:, 2:4].max(0)} ({n_near} "
                                     "rows in near contact)")
        ss, sms, s_wall = timed(sstep, s1, (srows, sobs), SPATIAL_STEPS)
        peak = sum(torch.cuda.max_memory_allocated(d) for d in set(devices)) - sum(base)
        s_dev = profiled(sstep, ss, (srows, sobs), f"1M {what} (phase 18)", s_wall)
        counts = _launch_counts()
        strip_steps = (1 + SPATIAL_STEPS + SPATIAL_PROFILE_STEPS) * len(devices)
        if counts != dict(dict.fromkeys(counts, 0),
                          **dict.fromkeys(FLAT_KERNELS, strip_steps)):
            raise AssertionError(f"1M {what}: launches {counts}, want "
                                 f"{', '.join(FLAT_KERNELS)} {strip_steps} alone")
        if not torch.equal(sms[:, 1], fms[:, 1]):
            raise AssertionError(f"1M {what}: n_spawned {sms[:, 1]} != flat {fms[:, 1]}")
        final = rows(strip_agents(ss))
        d_active = int(sms[-1, 0]) - int(fms[-1, 0])
        n = min(len(final), len(f_final))
        pos_diff = (float(np.abs(final[:n, :2] - f_final[:n, :2]).max())
                    if d_active == 0 else float("nan"))
        print(f"# phase 18 {what}: first step equal to the flat step (metrics; rows "
              f"order-free, pos/vel max |err| {err[:, 0:2].max():.3e} / "
              f"{err[:, 2:4].max():.3e}, {int((err[:, 0:2] > TOL).sum())} "
              f"positions one float apart past {TOL}, {n_near} rows in near "
              f"contact); " + ", ".join(f"{counts[n]} {n}" for n in FLAT_KERNELS)
              + f" launches in {strip_steps} strip-steps; after "
              f"{SPATIAL_STEPS} more steps n_spawned equal, n_active "
              f"{int(sms[-1, 0])} vs flat {int(fms[-1, 0])} (difference {d_active}), "
              f"largest position difference {pos_diff:.3e} m; ms/step wall "
              f"{s_wall:.4f} (flat {f_wall:.4f}), device {s_dev:.4f} (flat "
              f"{f_dev:.4f}; earlier {EARLIER_DEVICE_MS['strips']}, PERF.md), peak "
              f"memory {peak} bytes above the strips' state "
              f"(flat {flat_1m['peak_bytes']}, phase 15); overflow last step "
              f"{int(sms[-1, 3])} (flat {int(fms[-1, 3])}) on {card}", flush=True)
        out[what] = {"ms_per_step": s_wall, "device_ms_per_step": s_dev,
                     "peak_bytes": peak,
                     **{f"{n}_launches": counts[n] for n in FLAT_KERNELS},
                     "first_step_pos_err": float(err[:, 0:2].max()),
                     "first_step_vel_err": float(err[:, 2:4].max()),
                     "near_contact_rows": n_near, "n_active_difference": d_active,
                     "position_difference": pos_diff}
        del ss, s1, srows, sobs
    out["drift"] = _strip_drift(dev, card, cfg, maps, flat, field, obstacles, rows,
                                strip_agents)
    return out


def _strip_drift(dev, card, cfg, maps, flat, field, obstacles, rows_of,
                 strip_agents) -> dict:
    """18b. Where the strips' drift from the flat step comes from: 1 +
    SPATIAL_STEPS chained steps of 2 strips on this card and of the flat
    step from the 1M problem's state, at its K and at DRIFT_K, where no
    cell overflows (every step's overflow counted); and the flat step
    against itself from its first step's state and from the same state
    with every velocity one float up.  Prints, for each, the largest
    position difference after them, where it sits against the strips'
    edge, and how many agents moved apart by more than 1 mm and 1 cm.
    Returns those numbers."""
    import dataclasses

    from pedoni_tpu_torch.models import sfm
    from pedoni_tpu_torch.parallel import spatial

    def apart(a, b, edge):
        if a.shape != b.shape:
            return {"rows": [a.shape[0], b.shape[0]]}
        d = np.abs(a[:, :2] - b[:, :2]).max(1)
        i = int(d.argmax())
        return {"largest": float(d[i]), "x_from_edge": float(b[i, 0] - edge),
                "over_1mm": int((d > 1e-3).sum()), "over_1cm": int((d > 1e-2).sum())}

    out = {}
    for k in (cfg.table_capacity, DRIFT_K):
        kcfg = dataclasses.replace(cfg, table_capacity=k)
        fstep = sfm.make_step(kcfg)
        scfg = spatial.ShardedConfig.build(kcfg, 2)
        srows, sobs = spatial.device_inputs(scfg, maps, [dev, dev])
        sstep = spatial.make_sharded_step(scfg, [dev, dev])
        fs, ss = flat, spatial.shard_state(scfg, flat, [dev, dev])
        f_over, s_over = [], []
        for _ in range(1 + SPATIAL_STEPS):
            fs, fm = fstep(fs, field.rows, obstacles)
            ss, sm = sstep(ss, srows, sobs)
            f_over.append(int(fm.n_overflow))
            s_over.append(int(sm.n_overflow))
        r = apart(rows_of(strip_agents(ss)), rows_of(fs.agents), scfg.bounds(0)[1])
        out[f"strips_k{k}"] = dict(r, flat_overflow=f_over, strips_overflow=s_over)
        print(f"# phase 18b, K {k}: 2 strips against the flat step after "
              f"{1 + SPATIAL_STEPS} steps: {r}; cells' overflow each step flat "
              f"{f_over}, strips {s_over} on {card}", flush=True)
        if k == cfg.table_capacity:
            f1 = fstep(flat, field.rows, obstacles)[0]
            a = f1.agents
            up = f1._replace(agents=a._replace(vel=torch.nextafter(
                a.vel, torch.full_like(a.vel, float("inf")))))
            for _ in range(SPATIAL_STEPS):
                f1 = fstep(f1, field.rows, obstacles)[0]
                up = fstep(up, field.rows, obstacles)[0]
            r = apart(rows_of(up.agents), rows_of(f1.agents), scfg.bounds(0)[1])
            out["flat_one_float_up"] = r
            print(f"# phase 18b, K {k}: the flat step against itself, every "
                  f"velocity one float up after its first step, after "
                  f"{SPATIAL_STEPS} more steps: {r} on {card}", flush=True)
        del ss, srows, sobs
    return out


def _fidelity_phase(dev, card) -> dict:
    """19. The evacuation fidelity harness (pedoni_tpu_torch/fidelity.py)
    on the card, its launch counts zeroed before and read after: gap.toml
    through each backend's ``Simulator`` at seeds 1..GAP_SEEDS, every count
    in GAP_BAND and each backend's mean within three standard errors of the
    reference's GAP_RECORD; then every geometry and seed of the
    identical-state harness on ``xla``, ``grid`` and ``pallas``, each within max(3, round(0.05 o)) steps of the f64 oracle's
    o (tests/oracle_sfm.py, run here on the host), the grid losing no agent;
    then the four runtime kernels against their twins on the funnel's grid
    state after FIDELITY_STATE_STEPS steps.  Returns the phase's numbers."""
    from pedoni_tpu_torch import convert
    from pedoni_tpu_torch import fidelity as F
    from pedoni_tpu_torch.field import Field, FieldMaps
    from pedoni_tpu_torch.models import sfm_grid
    from pedoni_tpu_torch.models.sfm import SimState, StepConfig

    spec = importlib.util.spec_from_file_location(
        "oracle_sfm", ROOT / "tests" / "oracle_sfm.py")
    oracle = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(oracle)

    out = {"gap": {}, "oracle": {}}
    _zero_launch_counts()
    ref_mean, ref_sd, ref_n = GAP_RECORD
    for backend in F.BACKENDS:
        steps, mean, sd = F.gap_distribution(backend, GAP_SEEDS, device=str(dev))
        se = (sd ** 2 / GAP_SEEDS + ref_sd ** 2 / ref_n) ** 0.5
        print(f"# gap.toml on {backend}, seeds 1-{GAP_SEEDS}: {steps}, mean "
              f"{mean:.1f} +- {sd:.1f} (sample sd; reference record {ref_mean:.0f} +- "
              f"{ref_sd:.0f} over {ref_n}; 3 standard errors {3 * se:.1f}) on "
              f"{card}", flush=True)
        if not all(GAP_BAND[0] <= s <= GAP_BAND[1] for s in steps):
            raise AssertionError(f"gap.toml on {backend}: {steps} outside {GAP_BAND}")
        if abs(mean - ref_mean) > 3 * se:
            raise AssertionError(f"gap.toml on {backend}: mean {mean:.1f} more "
                                 f"than 3 standard errors from {ref_mean}")
        out["gap"][backend] = {"steps": steps, "mean": mean, "sd": sd}
    for geometry, g in F.GEOMETRIES.items():
        for seed in g.seeds:
            o = F.evac_steps_oracle(geometry, seed, oracle.oracle_step)
            row = {"oracle": o}
            for backend in F.BACKENDS:
                b, lost = F.evac_steps_from(geometry, seed, backend, device=str(dev))
                row[backend] = b
                if abs(b - o) > max(3, round(0.05 * o)) or o > F.EVAC_MAX:
                    raise AssertionError(f"{geometry} seed {seed} on {backend}: "
                                         f"{b} steps, oracle {o}")
                if lost:
                    raise AssertionError(f"{geometry} seed {seed} on grid: "
                                         f"{lost} agents lost")
            print(f"# {geometry} seed {seed}: evacuated in {row} steps (within "
                  f"max(3, 5%) of the oracle; grid lost 0)", flush=True)
            out["oracle"][f"{geometry}/{seed}"] = row
    counts = _launch_counts()
    print(f"# phase 19 launches {counts}", flush=True)
    runtime = ("step_kernel", "step_kernel_movers", "rebin", "rebin_incremental",
               *FLAT_KERNELS)
    if any(counts[name] == 0 for name in runtime):
        raise AssertionError(f"phase 19 launched a runtime kernel no time: {counts}")
    out["launches"] = {name: counts[name] for name in runtime}

    sc = F.scenario("funnel")
    maps = FieldMaps.from_field(Field.from_scenario(sc, unit=0.25))
    cfg = StepConfig.build(sc, capacity=F.CAP, neighbor_grid_unit=F.UNIT,
                           table_capacity=F.GEOMETRIES["funnel"].table_capacity)
    fwp, fobs = sfm_grid.field_tensors(cfg, maps, dev)
    gs = sfm_grid.bin_state(cfg, SimState(convert.agents_from_numpy(
        *F.initial("funnel", 1), dev), 0))
    step = sfm_grid.make_step_grid(cfg)
    for _ in range(FIDELITY_STATE_STEPS):
        gs = step(gs, fwp, fobs)[0]
    out["funnel_state_err"] = _compare(
        gs.d, fwp, fobs, cfg.physics, sc.size, cfg.grid.unit, cfg.grid.nx,
        cfg.grid.ny, 8, f"funnel's grid after {FIDELITY_STATE_STEPS} steps")
    return out


def _spawn_scatter_phase(dev, card) -> dict:
    """20. The spawn scatter kernel on random.toml's filled grid: bit-equal
    to its twin, timed beside it and beside ``measure_spawn_time``."""
    from pedoni_tpu_torch import Simulator, SimulatorOptions, load_scenario
    from pedoni_tpu_torch.models.sfm import spawn_sampler
    from pedoni_tpu_torch.ops.kernels import spawn_scatter as ssk

    sim = Simulator(SimulatorOptions(backend="grid", neighbor_grid_unit=1.5,
                                     seed=1, device=dev.type), load_scenario(RANDOM))
    _zero_launch_counts()
    t0 = time.perf_counter()
    sim.run(SPAWN_FILL_TICKS)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    launches = _launch_counts()["spawn_scatter"]
    if launches != SPAWN_FILL_TICKS:
        raise AssertionError(f"random.toml grid fill: {launches} spawn scatter "
                             f"launches in {SPAWN_FILL_TICKS} ticks")
    grid, k, d0 = sim.cfg.grid, sim.cfg.table_capacity, sim.state.d
    cand = spawn_sampler(sim.cfg, dev)(torch.Generator(device=dev).manual_seed(7))
    every = cand._replace(active=torch.ones_like(cand.active))
    written = {}
    for what, c in (("a draw", cand), ("every candidate active", every)):
        got = ssk.spawn_scatter(grid, k, d0.clone(), c)
        want = ssk.spawn_scatter_torch(grid, k, d0.clone(), c)
        _same_bits(got[0], want[0])
        if [int(t) for t in got[1:]] != [int(t) for t in want[1:]]:
            raise AssertionError(f"spawn scatter on random.toml's grid ({what}): "
                                 f"counts {got[1:]} != the twin's {want[1:]}")
        written[what] = int(got[1]) - int(got[2])
    d_kernel, d_twin = d0.clone(), d0.clone()
    kernel_ms = _median_ms(lambda: ssk.spawn_scatter(grid, k, d_kernel, cand))
    twin_ms = _median_ms(lambda: ssk.spawn_scatter_torch(grid, k, d_twin, cand))
    spawn_ms = sim.measure_spawn_time(n=SPAWN_TIMED) * 1e3
    # each candidate's pos, speed, dest and active flag read once; each
    # written row's 7 channels and its cell's count read and written once
    s = cand.pos.shape[0]
    need = s * 17 + written["a draw"] * (7 * 4 + 8) + 8
    bound_ms, by = _bound(need)
    print(f"# spawn scatter (phase 20) on random.toml's grid after "
          f"{SPAWN_FILL_TICKS} ticks ({sim.pedestrian_count} agents, fill "
          f"{fill_s:.1f} s, {launches} launches): bit-equal to its twin on a draw "
          f"({written['a draw']} of {s} written) and with every candidate "
          f"active ({written['every candidate active']} written); kernel "
          f"{kernel_ms:.4f} ms, twin {twin_ms:.4f} ms, bound {bound_ms:.2e} ms "
          f"({by}; {need} B) (medians of 20, CUDA events); measure_spawn_time "
          f"(draw + scatter, {SPAWN_TIMED} chained) {spawn_ms:.4f} ms on {card}",
          flush=True)
    return {"name": "spawn_scatter", "route": "cuda",
            "source": CSRC + "spawn_scatter.cu",
            "replaces": "pedoni_tpu/models/sfm_grid.py:140", "path": "grid spawn",
            "launches": launches, "max_abs_err": 0.0, "ms": kernel_ms,
            "plain_ms": twin_ms, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": None, "measure_spawn_ms": spawn_ms}


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
    from pedoni_tpu_torch.utils import trace

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
        sim = Simulator(SimulatorOptions(backend="grid", device="cuda", seed=1,
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
    paths, grid_device_ms = {}, {}
    # step.full_rebins counts while tracing is on; both paths pay the spans
    trace.enable(True)
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
            want = dict(dict.fromkeys(counts, 0), step_kernel_movers=n_steps,
                        rebin=n_steps, rebin_incremental=n_steps - n_compact)
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
            want = dict(dict.fromkeys(counts, 0), step_kernel=n_steps,
                        rebin=n_steps)
            if counts != want:
                raise AssertionError(f"1M full: launches {counts} != {want}")
            branches = ""
        print(f"# 1M {name} path: {n_steps} steps ({WARMUP} warm-up), "
              f"{n_active} active, overflow last step {int(m.n_overflow)}, max "
              f"demand {int(m.max_demand)}; {dt * 1e3:.4f} ms/step, "
              f"{n_active / dt:.4e} agent-steps/s; launches {counts}{branches} "
              f"on {card}", flush=True)
        paths[name] = (dt, counts, step, gs, n_full)
    trace.enable(False)
    # the profiles come after both timed runs: a profiler once started
    # slows the host's launches for the rest of the process
    for name, (dt, counts, step, gs, n_full) in paths.items():
        gs, dev_ms = _profile(step, gs, bfwp, bfobs, dt * 1e3, name, card)
        paths[name] = (dt, counts, gs.d, n_full)
        grid_device_ms[name] = dev_ms
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
    w1_ms = {n: times[n][0] for n in ("step_kernel", "step_kernel_movers")}
    by_wp = {}
    for n_wp, phase in ((8, 12), (33, 13)):
        t0 = time.perf_counter()
        by_wp[n_wp] = _waypoints_phase(dev, card, n_wp, w1_ms)
        print(f"# phase {phase} (W {n_wp}) took {time.perf_counter() - t0:.1f} s",
              flush=True)
    t0 = time.perf_counter()
    _bench_phase(card)
    print(f"# phase 14 (bench) took {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    flat = _flat_phase(dev, card)
    kernels.extend(flat.pop("kernels"))
    print(f"# phase 15 (flat backend) took {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    pallas = _pallas_phase(dev, card)
    print(f"# phase 16 (pallas backend) took {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    processes = _processes_phase(card, tiled)
    print(f"# phase 17 (processes) took {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    strips = _spatial_phase(dev, card, flat)
    print(f"# phase 18 (spatial strips) took {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    fidelity = _fidelity_phase(dev, card)
    fidelity["seconds"] = time.perf_counter() - t0
    print(f"# phase 19 (fidelity) took {fidelity['seconds']:.1f} s", flush=True)
    t0 = time.perf_counter()
    kernels.append(_spawn_scatter_phase(dev, card))
    print(f"# phase 20 (spawn scatter) took {time.perf_counter() - t0:.1f} s",
          flush=True)
    for entry in kernels:  # the forms of each kernel this run held to its twin
        if entry["name"] not in ("pairwise", *FLAT_KERNELS):
            entry["tile_offsets"] = "ported"
        if entry["name"] not in ("rebin", "rebin_incremental", "spawn_scatter",
                                 *FLAT_KERNELS):
            entry["k_up_to"] = big_k["k_max"]  # the largest K compared here
        if entry["name"].startswith("step_kernel"):
            entry["waypoints"] = [1, 2, 8, 33]  # W compared here (2: step 1)
    for entry in kernels:  # the paths each kernel ran on in this run
        entry["paths"] = {"step_kernel": ["full", "tiles", "pallas", "processes",
                                          "fidelity"],
                          "step_kernel_movers": ["hybrid", "tiles", "processes",
                                                 "fidelity"],
                          "step_kernel_segments": ["segments", "pallas --no-distance-map"],
                          "rebin": ["full", "hybrid", "tiles", "processes", "fidelity"],
                          "rebin_incremental": ["hybrid", "tiles", "processes",
                                                "fidelity"],
                          "pairwise": ["standalone"],
                          **dict.fromkeys(FLAT_KERNELS, ["flat", "strips"]),
                          "spawn_scatter": ["grid spawn", "tiles"]
                          }[entry["name"]]
        if entry["name"] in pallas["kernels"]:
            entry["pallas"] = pallas["kernels"][entry["name"]]
        if entry["name"] in fidelity["launches"]:
            entry["fidelity_launches"] = fidelity["launches"][entry["name"]]
    kernels[0]["tiles_1m"] = tiled
    kernels[0]["by_waypoints"] = by_wp
    kernels[0][f"k{BIG_K}"] = {n: big_k[n] for n in ("step_kernel_ms", "max_abs_err")}
    by_name = {entry["name"]: entry for entry in kernels}
    by_name["pairwise"][f"k{BIG_K}"] = {"ms": big_k["pairwise_ms"],
                                        "max_abs_err": big_k["max_abs_err"]}
    for name in FLAT_KERNELS:
        by_name[name]["strip_launches"] = {
            what: r[f"{name}_launches"] for what, r in strips.items()
            if what not in ("flat", "drift")}
    print("# device ms/step beside EARLIER_DEVICE_MS (PERF.md; NVIDIA H100 80GB HBM3, 700 "
          "W): " + ", ".join(
              f"{what} {ms:.4f} (earlier {EARLIER_DEVICE_MS[what]}, "
              f"{ms / EARLIER_DEVICE_MS[what] - 1:+.1%})" for what, ms in (
                  ("full", grid_device_ms["full"]), ("hybrid", grid_device_ms["hybrid"]),
                  ("pallas", pallas["device_ms_per_step"]),
                  ("flat", flat["device_ms_per_step"]),
                  ("strips", strips["2 strips on one card"]["device_ms_per_step"])))
          + f" on {card}", flush=True)
    print("# flat backend (phase 15): " + json.dumps(flat), flush=True)
    print("# pallas backend (phase 16): " + json.dumps(
        {k: v for k, v in pallas.items() if k != "kernels"}), flush=True)
    print("# tiles over 2 processes (phase 17): " + json.dumps(processes), flush=True)
    print("# spatial strips (phase 18): " + json.dumps(strips), flush=True)
    print("# fidelity (phase 19): " + json.dumps(fidelity), flush=True)
    print(f"# chip_smoke.py took {time.perf_counter() - t_start:.1f} s, the "
          f"kernel build included", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    # with arguments: one rank of phase 17 (``_rank_main``)
    raise SystemExit(_rank_main(sys.argv[1:]) if len(sys.argv) > 1 else main())
