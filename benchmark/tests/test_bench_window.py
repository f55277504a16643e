"""The end-to-end metrics see a stall inside the window: a step that
stalls lowers agent_steps_per_s, ticks that stall raise tick_ms_p95 (no
best, minimum or median of windows hides them)."""

from __future__ import annotations

import time

from benchmark.paths import flat
from benchmark.tests import tiny


def _stalling(fn, every: int, first: int, seconds: float):
    calls = [0]

    def wrapped(*a, **k):
        calls[0] += 1
        if calls[0] >= first and (calls[0] - first) % every == 0:
            time.sleep(seconds)
        return fn(*a, **k)
    return wrapped


def test_a_stalled_step_lowers_agent_steps_per_s(tiny_root, monkeypatch):
    root, man = tiny_root
    base = tiny.run(root, man, "b.flat", seconds=1.0)[1]["metrics"]["agent_steps_per_s"]["value"]
    # warm-up 4 steps, the start check's step, then the window: call 12 is in it
    monkeypatch.setattr(flat.Bulk, "step", _stalling(flat.Bulk.step, 10**9, 12, 3.0))
    stalled = tiny.run(root, man, "b.flat", seconds=1.0)[1]["metrics"]["agent_steps_per_s"]["value"]
    assert stalled < 0.6 * base


def test_stalled_ticks_raise_tick_ms_p95(tiny_root, monkeypatch):
    root, man = tiny_root
    base = tiny.run(root, man, "t.flat", seconds=1.5)[1]["metrics"]
    from pedoni_tpu_torch.sim import Simulator
    # every 8th tick stalls: 12% of the window's ticks, past its 95th percentile
    monkeypatch.setattr(Simulator, "tick", _stalling(Simulator.tick, 8, 8, 0.25))
    stalled = tiny.run(root, man, "t.flat", seconds=1.5)[1]["metrics"]
    assert stalled["tick_ms_p95"]["value"] >= 250.0 > base["tick_ms_p95"]["value"]
    assert stalled["tick_ms_p50"]["value"] < 250.0
