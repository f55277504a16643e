"""The reduction of the program's spans (``benchmark/spans.py``) on
synthetic profiles: nested spans, idle gaps split by the innermost program
span and summing to ``trace.reduce``'s ``idle_by_span``, device copies of
program ranges kept out of the device's operations, launches charged to
the innermost span; the readers of the spans; and a traced CPU run of the
test-sized cells with the program's spans on."""

from __future__ import annotations

import argparse
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, spans, trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
NAMES = spans.program_names()


def _ev(name, a, b, device=CPU, annotation=None, thread=1):
    return SimpleNamespace(name=name, device_type=device, thread=thread,
                           time_range=SimpleNamespace(start=a, end=b),
                           is_user_annotation=(name in NAMES or name in trace.SPANS
                                               or name == "window")
                           if annotation is None else annotation)


class _Prof:
    def __init__(self, evs):
        self._evs = evs

    def events(self):
        return self._evs


def _tick_profile(annotation=None):
    """A window of two ticks; each tick's step has a spawn phase, and each
    tick ends in a fetch.  The device works in [30, 40] and [130, 135]."""
    evs = [_ev("window", 0, 260)]
    for t0 in (0, 100):
        evs += [_ev("tick", t0 + 1, t0 + 90), _ev("sim.tick", t0 + 2, t0 + 88),
                _ev("flat.step", t0 + 3, t0 + 50), _ev("flat.spawn", t0 + 5, t0 + 20),
                _ev("sim.fetch", t0 + 55, t0 + 87),
                _ev("cudaLaunchKernel", t0 + 6, t0 + 7),
                _ev("cudaLaunchKernel", t0 + 25, t0 + 26),
                _ev("cudaMemcpyAsync", t0 + 56, t0 + 84),
                # the device's copies of the host's ranges
                _ev("sim.tick", t0 + 30, t0 + 80, CUDA, annotation),
                _ev("flat.step", t0 + 30, t0 + 40, CUDA, annotation)]
    evs += [_ev("step_kernel", 30, 40, CUDA), _ev("step_kernel", 130, 135, CUDA)]
    return _Prof(evs)


def test_nested_spans_go_to_the_innermost():
    pieces = spans.innermost([(0, 10, "P"), (2, 5, "C"), (6, 8, "D"),
                              (10, 12, "Q")])
    assert pieces == [(0, 2, "P"), (2, 5, "C"), (5, 6, "P"), (6, 8, "D"),
                      (8, 10, "P"), (10, 12, "Q")]
    starts = [p[0] for p in pieces]
    assert [spans.at(pieces, starts, t) for t in (1, 3, 5.5, 7, 9, 11, 13)] == [
        "P", "C", "P", "D", "P", "Q", None]


def test_idle_gaps_split_by_program_span_and_sum_to_idle_by_span():
    s = spans.reduce(_tick_profile(), {}, {})
    gaps = s["idle_gaps"]
    # [0, 30]: mid 15, inside the first tick's spawn; [40, 130]: mid 85,
    # the first tick's fetch; [135, 260]: mid 197.5, after the second tick
    assert gaps == pytest.approx({"tick/flat.spawn": 30e-6, "tick/sim.fetch": 90e-6,
                                  "host": 125e-6})
    by_harness: dict[str, float] = {}
    for name, v in gaps.items():
        key = name.split("/")[0]
        by_harness[key] = by_harness.get(key, 0.0) + v
    assert by_harness == pytest.approx(s["idle_by_span"])
    ps = s["program_spans"]
    assert ps["flat.spawn"]["idle_s"] == pytest.approx(30e-6)
    assert ps["sim.fetch"]["idle_s"] == pytest.approx(90e-6)
    assert ps["sim.tick"]["n"] == 2 and ps["sim.tick"]["s"] == pytest.approx(172e-6)
    assert ps["grid.step"] == {"s": 0.0, "n": 0, "launches": 0, "idle_s": 0.0}
    assert spans.breakdown(s)["idle_gaps"][0] == ["host", pytest.approx(125e-6)]


@pytest.mark.parametrize("annotation", [True, False])
def test_a_program_span_on_the_device_is_no_operation(annotation):
    ev = spans.events(_tick_profile(annotation), NAMES)
    assert ev["device"] == [(30, 40), (130, 135)]
    s = spans.split(ev, NAMES)
    assert sum(s["idle_gaps"].values()) == pytest.approx(245e-6)


def test_launches_go_to_the_innermost_span():
    ps = spans.reduce(_tick_profile(), {}, {})["program_spans"]
    assert ps["flat.spawn"]["launches"] == 2  # t 6 and 106
    assert ps["flat.step"]["launches"] == 2  # t 25 and 125, after the spawn
    assert ps["sim.fetch"]["launches"] == 2  # the metrics' copies
    assert ps["sim.tick"]["launches"] == 0


def test_spans_of_another_thread_are_left_out():
    prof = _tick_profile()
    prof._evs.append(_ev("grid.step", 10, 150, thread=2))
    assert spans.reduce(prof, {}, {})["program_spans"]["grid.step"]["n"] == 0


@pytest.mark.parametrize("name", ["step_host_ms.bulk", "step_host_ms.tick",
                                  "fetch_ms_per_tick"])
def test_the_span_readers(name):
    read = harness.load(harness.reader(harness.ROOT, name), "m_" + name).read
    base = {"units": 4, "busy_s": 1.0, "window_s": 2.0}
    assert read(base) is None
    empty = {n: {"s": 0.0, "n": 0, "launches": 0, "idle_s": 0.0} for n in NAMES}
    assert read(dict(base, program_spans=empty)) is None
    full = dict(empty, **{"flat.step": {"s": 0.004, "n": 4, "launches": 8, "idle_s": 0.0},
                          "sim.fetch": {"s": 0.002, "n": 4, "launches": 4, "idle_s": 0.0}})
    want = 0.5 if name == "fetch_ms_per_tick" else 1.0
    assert read(dict(base, program_spans=full)) == pytest.approx(want)


@pytest.mark.parametrize("cell,step", [("b.flat", "flat.step"), ("t.grid", "grid.step")])
def test_a_traced_cpu_run_reads_the_program_spans(tiny_root, cell, step):
    root, man = tiny_root
    ns = argparse.Namespace(workload=cell, seed=2**31 + 77, seconds=0.5, profiler=1)
    out = spans.run(ns, root=root, manifest=man, device=torch.device("cpu"))
    ps = out["program_spans"]
    assert ps[step]["n"] == out["units"] > 0
    assert sum(out["idle_gaps"].values()) == pytest.approx(
        sum(out["idle_by_span"].values()))
    new = spans.NEW_METRICS["tick" if cell.startswith("t.") else "bulk"]
    assert set(new) <= set(out["metrics"])
    if cell.startswith("t."):
        assert ps["sim.tick"]["n"] == ps["sim.fetch"]["n"] == out["units"]
    from pedoni_tpu_torch.utils import trace as ptrace
    assert not ptrace.enabled()
