"""The tick driver: per-tick latency of ``Simulator.tick()``, as the
headless CLI loop calls it, over a fixed segment of ticks.

Set-up builds the path's Simulator on the configuration's scenario with
``--seed`` as its spawn seed, checks its first tick from the empty field
(spawns only) and fills the field with ``Simulator.run`` batches
(``fill_ticks`` ticks in ``fill_batch`` batches: traffic the cell needs,
not waste).  A crowd that keeps arriving faster than it leaves grows
without end, so a window of ticks from one moment on would time a larger
crowd the faster the program is: the window replays one segment instead.
Set-up checkpoints the filled state (``checkpoint.save``, under TMPDIR),
ticks the ``segment_ticks`` of the segment once (the table and capacity
grow to what the segment needs, and the tick path warms) and restores the
checkpoint.  The window calls ``tick()`` back to back, with no pacing,
pushes each record into a ``DiagnosticLog`` as the headless loop does,
times each tick from the call to its return with host metrics, and
restores the checkpoint after every ``segment_ticks`` ticks (a restore is
no tick); it closes at the first tick that ends past ``--seconds`` (a
traced run: past ``trace_ticks`` ticks too).  ``tick_ms_p50`` and
``tick_ms_p95`` are nearest-rank percentiles over every tick of the
window.  After the window one more tick is checked.  ``control.py`` sets
a cell up with ``setup`` and reads its limits from ``first_check``, the
window's first tick.
"""

from __future__ import annotations

import math
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace


def percentile(values: list[float], q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least q% of the
    values at or below it."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


def checked(ctx, sim, label: str) -> dict:
    """One tick of ``sim`` and its check."""
    path = ctx.path
    inp = path.rows(sim.state)
    judging = path.sim_judging(sim)
    sim.tick()
    return ctx.check(label, inp, path.rows(sim.state),
                     path.common.metrics(sim.last_metrics), judging)


def setup(ctx) -> SimpleNamespace:
    """The Simulator built, its first tick checked, the field filled, the
    segment ticked once and the checkpoint of its start restored."""
    tr = ctx.traffic
    sim = ctx.path.common.simulator(ctx.problem, ctx.seed, ctx.device,
                                    ctx.path.BACKEND)
    log = sim.new_log(ctx.entry["config"])
    checks = [checked(ctx, sim, "start")]
    done = 1
    while done < tr["fill_ticks"]:
        n = min(tr["fill_batch"], tr["fill_ticks"] - done)
        sim.run(n)
        done += n
    tmp = tempfile.TemporaryDirectory()
    ckpt = Path(tmp.name) / "segment.npz"
    ctx.path.common.save(sim, ckpt)
    for _ in range(tr["segment_ticks"]):
        log.push(sim.tick())
    ctx.path.common.restore(sim, ckpt)
    ctx.sync()
    print(f"# filled: {sim.pedestrian_count} agents after {done} ticks",
          file=ctx.log, flush=True)
    return SimpleNamespace(sim=sim, log=log, tmp=tmp, ckpt=ckpt, checks=checks)


def first_check(ctx, s: SimpleNamespace) -> dict:
    """The check of the tick the window starts with."""
    return checked(ctx, s.sim, "first")


def run(ctx) -> dict:
    tr = ctx.traffic
    s = setup(ctx)
    sim, log, ckpt, checks = s.sim, s.log, s.ckpt, s.checks
    limit = tr["trace_ticks"] if ctx.tracing else None
    times: list[float] = []
    seg = 0
    with ctx.window() as win:
        while True:
            a = time.perf_counter()
            with ctx.span("tick"):
                rec = sim.tick()
            log.push(rec)
            b = time.perf_counter()
            times.append(b - a)
            if b - win.t0 >= ctx.seconds or (limit is not None and len(times) >= limit):
                break
            seg += 1
            if seg == tr["segment_ticks"]:
                with ctx.span("restore"):
                    ctx.path.common.restore(sim, ckpt)
                seg = 0
    s.tmp.cleanup()
    out = {"attempted": len(times), "checks": checks,
           "e2e": {"tick_ms_p50": percentile(times, 50) * 1e3,
                   "tick_ms_p95": percentile(times, 95) * 1e3},
           "memory_peak_bytes": ctx.memory_peak()}
    checks.append(checked(ctx, sim, "end"))
    print(f"# window: {len(times)} ticks in {win.seconds:.4f} s, "
          f"{sim.pedestrian_count} agents at the end", file=ctx.log, flush=True)
    return out
