"""The bulk driver: agent-steps/s of a step function over a fixed segment.

Set-up builds the path's step on the configuration's problem, takes one
step from the generated state (the check of the start) and ``warmup_steps``
in all, and keeps the state they reach as the segment's start.  The window
replays the segment: ``segment_steps`` steps from a device-side copy of the
start, again and again, each step's live count added on the device; every
``fence_every`` steps it waits for the device and reads the clock, and it
closes at the first fence past ``--seconds`` (a traced run: past
``trace_steps`` steps too).  ``agent_steps_per_s`` is the summed live
count, read once, over the window's wall time from its first launch to the
last wait; restores and fences lie inside it.  After the window one more
step from its final state is checked.  ``control.py`` sets a cell up with
``setup`` and reads its limits from ``first_check``, the window's first
step.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import torch


def checked(ctx, prog, state, label: str):
    """One step of ``prog`` from ``state``: (the new state, its metrics,
    the step's check)."""
    inp = ctx.path.rows(state)
    state, m = prog.step(state)
    return state, m, ctx.check(label, inp, ctx.path.rows(state),
                               ctx.path.common.metrics(m), prog)


def setup(ctx) -> SimpleNamespace:
    """The step built on the problem, the binning and the first step
    checked, ``warmup_steps`` taken: ``saved`` is the segment's start."""
    path = ctx.path
    prog = path.Bulk(ctx.problem, ctx.device)
    checks = []
    s0 = prog.state
    if s0 is not prog.initial:  # the program binned the generated agents
        checks.append(ctx.check("binning", path.common.flat_rows(prog.initial.agents),
                                path.rows(s0), None, prog, copy=True))
    del prog.initial
    state, m, c = checked(ctx, prog, s0, "start")
    checks.append(c)
    del s0
    for _ in range(ctx.traffic["warmup_steps"] - 1):
        state, m = prog.step(state)
    return SimpleNamespace(prog=prog, saved=state, metrics=m, checks=checks)


def first_check(ctx, s: SimpleNamespace) -> dict:
    """The check of the step the window starts with."""
    return checked(ctx, s.prog, s.saved, "first")[2]


def run(ctx) -> dict:
    tr = ctx.traffic
    s = setup(ctx)
    prog, saved, checks = s.prog, s.saved, s.checks
    acc = torch.zeros((), dtype=torch.int64, device=ctx.device)
    state = prog.clone(saved)  # the restore and the device sum, warmed
    acc += s.metrics.n_active
    acc.zero_()
    del s
    ctx.sync()

    seg_len, fence = tr["segment_steps"], tr["fence_every"]
    limit = tr["trace_steps"] if ctx.tracing else None
    steps = seg = 0
    with ctx.window() as win:
        while True:
            with ctx.span("step"):
                state, m = prog.step(state)
                acc += m.n_active
            steps += 1
            seg += 1
            if steps % fence == 0:
                with ctx.span("fence"):
                    ctx.sync()
                if (time.perf_counter() - win.t0 >= ctx.seconds
                        or (limit is not None and steps >= limit)):
                    break
            if seg == seg_len:
                with ctx.span("restore"):
                    state = prog.clone(saved)
                seg = 0
        ctx.sync()
    agent_steps = int(acc)
    out = {"attempted": steps, "checks": checks,
           "e2e": {"agent_steps_per_s": agent_steps / win.seconds},
           "memory_peak_bytes": ctx.memory_peak()}
    if ctx.tracing:
        out["work"] = [ctx.work(ctx.path.rows(saved)), ctx.work(ctx.path.rows(state))]
    checks.append(checked(ctx, prog, state, "end")[2])
    print(f"# window: {steps} steps, {agent_steps} agent-steps in "
          f"{win.seconds:.4f} s", file=ctx.log, flush=True)
    return out
