"""The program's own spans in a traced window (``pedoni_tpu_torch/utils/
trace.py``: the Simulator's tick, run, fetch and growth, the flat and grid
steps and their phases), read from the same torch.profiler trace as the
device's kernels.

    python benchmark/spans.py --workload <cell> --seed <n> --seconds <s> [--profiler 0]

runs one cell as ``run.py --trace 1`` does (the cell's ``drivers/``
module, its traced window of ``trace_steps`` or ``trace_ticks``) with the
program's spans on in the window, and prints one JSON line: the window's
end-to-end numbers (a traced run's, so not the cell's result), the
per-layer metrics of the cell with the readers of
``metrics/step_host_ms.py`` and ``metrics/fetch_ms_per_tick.py`` beside
them, the program spans and the idle gaps split by them; standard error
gets the spans a unit (step or tick) as a table.  It judges nothing: ``run.py`` decides ``correct``.
With ``--profiler 0`` the spans are on and no profile records: the cell's
untraced window, for the cost of the spans alone.

The reduction (``reduce``) adds to ``trace.reduce``'s summary:

- ``program_spans``: for each name of the program's ``NAMES``, ``s`` (host
  seconds inside the window), ``n`` (how many opened), ``launches`` (the
  runtime's launch, memset and memcpy calls made while it was the
  innermost program span) and ``idle_s`` (the device idle it was the
  innermost program span for);
- ``idle_gaps``: each idle gap of the window named by the harness's span
  open at its middle (``host`` where none is), then ``/`` and the
  innermost program span open there, if one is; summed by the part before
  ``/`` it is ``idle_by_span``.

Spans may nest: a point in time belongs to the innermost span open there.
The device's copies of the program's ranges are no device operations.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import re
import sys
import time
from pathlib import Path

T_START = time.perf_counter()

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import harness, trace  # noqa: E402
from benchmark.work import step_work  # noqa: E402

RUNTIME_CALL = re.compile(r"^cu(da)?(Launch|Memcpy|Memset|GraphLaunch)")
NEW_METRICS = {"bulk": ("step_host_ms.bulk",),
               "tick": ("step_host_ms.tick", "fetch_ms_per_tick")}

Span = tuple[float, float, str]


def program_names() -> tuple[str, ...]:
    """The program's span names; none where the program has no spans."""
    try:
        from pedoni_tpu_torch.utils import trace as ptrace
    except ImportError:
        return ()
    return ptrace.NAMES


def innermost(spans: list[Span]) -> list[Span]:
    """Disjoint pieces of the time ``spans`` cover, in order, each named by
    the innermost span open over it; spans nest or follow one another."""
    pieces: list[Span] = []
    stack: list[tuple[float, str]] = []  # (end, name), outermost first
    pos = 0.0

    def close_until(t: float) -> None:
        nonlocal pos
        while stack and stack[-1][0] <= t:
            end, name = stack.pop()
            if end > pos:
                pieces.append((pos, end, name))
            pos = max(pos, end)

    for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        close_until(a)
        if stack and a > pos:
            pieces.append((pos, a, stack[-1][1]))
        stack.append((b, name))
        pos = a
    close_until(float("inf"))
    return pieces


def at(pieces: list[Span], starts: list[float], t: float) -> str | None:
    """The name of the piece that holds ``t``, as ``trace.reduce`` finds
    the harness's span at an idle gap."""
    k = bisect.bisect_right(starts, t) - 1
    if k >= 0 and pieces[k][1] >= t:
        return pieces[k][2]
    return None


def events(prof, names: tuple[str, ...]) -> dict:
    """What ``split`` reads of a profile: the window, the harness's and the
    program's spans on the window's thread, the device's operations and the
    runtime's launch, memset and memcpy calls (times in us)."""
    cuda = torch.autograd.DeviceType.CUDA
    window = thread = None
    harness_spans: list[Span] = []
    program: list[tuple[float, float, str, int]] = []
    dev: list[tuple[float, float]] = []
    calls: list[float] = []
    for ev in prof.events():
        tr = ev.time_range
        if ev.device_type == cuda:
            if not (getattr(ev, "is_user_annotation", False) or ev.name in names
                    or ev.name in trace.SPANS or ev.name == "window"):
                dev.append((tr.start, tr.end))
        elif ev.name == "window":
            window, thread = (tr.start, tr.end), ev.thread
        elif ev.name in trace.SPANS:
            harness_spans.append((tr.start, tr.end, ev.name, ev.thread))
        elif ev.name in names:
            program.append((tr.start, tr.end, ev.name, ev.thread))
        elif RUNTIME_CALL.match(ev.name):
            calls.append(tr.start)
    if window is None:
        raise RuntimeError("the trace holds no 'window' range")
    return {"window": window,
            "harness": [s[:3] for s in harness_spans if s[3] == thread],
            "program": [s[:3] for s in program if s[3] == thread],
            "device": dev, "calls": calls}


def split(ev: dict, names: tuple[str, ...]) -> dict:
    """``program_spans`` and ``idle_gaps`` (see the module's docstring) of
    ``events``' output."""
    w0, w1 = ev["window"]
    busy = trace._union([(max(a, w0), min(b, w1)) for a, b in ev["device"]
                         if b > w0 and a < w1])
    outer = sorted(ev["harness"])  # as trace.reduce: they follow one another
    outer_starts = [s[0] for s in outer]
    pieces = innermost([s for s in ev["program"] if s[1] > w0 and s[0] < w1])
    starts = [p[0] for p in pieces]
    table = {n: {"s": 0.0, "n": 0, "launches": 0, "idle_s": 0.0} for n in names}
    for a, b, name in ev["program"]:
        if w0 <= a < w1:
            table[name]["n"] += 1
        if b > w0 and a < w1:
            table[name]["s"] += (min(b, w1) - max(a, w0)) * 1e-6
    for t in ev["calls"]:
        name = at(pieces, starts, t) if w0 <= t <= w1 else None
        if name is not None:
            table[name]["launches"] += 1
    gaps: dict[str, float] = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        name = at(outer, outer_starts, mid) or "host"
        inner = at(pieces, starts, mid)
        if inner is not None:
            table[inner]["idle_s"] += (b - a) * 1e-6
            name = f"{name}/{inner}"
        gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-6
    return {"program_spans": table, "idle_gaps": gaps}


def reduce(prof, counts_before: dict, counts_after: dict) -> dict:
    """``trace.reduce``'s summary with ``program_spans`` and ``idle_gaps``."""
    names = program_names()
    summary = trace.reduce(prof, counts_before, counts_after)
    summary.update(split(events(prof, names), names))
    return summary


def breakdown(summary: dict) -> dict:
    """``trace.breakdown`` with the idle gaps split by program span."""
    out = trace.breakdown(summary)
    out["idle_gaps"] = [[n, s] for n, s in sorted(
        summary["idle_gaps"].items(), key=lambda x: -x[1])[:10]]
    return out


def table(summary: dict, units: int) -> str:
    """The program spans a unit: host ms, launches, idle ms and count."""
    rows = [f"{'span':<16}{'host ms':>10}{'launches':>10}{'idle ms':>10}{'n':>8}"]
    for name, v in summary["program_spans"].items():
        if v["n"]:
            rows.append(f"{name:<16}{v['s'] / units * 1e3:>10.4f}"
                        f"{v['launches'] / units:>10.2f}"
                        f"{v['idle_s'] / units * 1e3:>10.4f}{v['n'] / units:>8.2f}")
    return "\n".join(rows)


class _Spanned(harness.Context):
    """A cell's context whose window runs with the program's spans on."""

    @contextlib.contextmanager
    def window(self):
        from pedoni_tpu_torch.utils import trace as ptrace
        ptrace.enable(True)
        try:
            with super().window() as w:
                yield w
        finally:
            ptrace.enable(False)


def run(ns: argparse.Namespace, root: Path = harness.ROOT,
        manifest: dict | None = None, device: torch.device | None = None) -> dict:
    """One cell with the program's spans on in its window: what the module's
    docstring says the line holds."""
    if manifest is None:
        manifest = harness.read_json(harness.REPO / "BENCHMARK.json")
    entry = {w["name"]: w for w in manifest["workloads"]}[ns.workload]
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("spans.py needs a CUDA device")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    config = harness.read_json(root / "configs" / f"{entry['config']}.json")
    traffic = harness.read_json(root / "traffic" / f"{entry['traffic']}.json")
    profiled = bool(ns.profiler)
    ctx = _Spanned(entry["name"], entry, config, traffic, ns.seed,
                   float(ns.seconds), profiled, device, T_START, root)
    driver = harness.load(root / "drivers" / f"{traffic['driver']}.py",
                          f"bench_driver_{traffic['driver']}")
    res = driver.run(ctx)
    out = {"cell": entry["name"], "seed": ns.seed, "profiler": int(profiled),
           "units": res["attempted"], "window_s": ctx.win.seconds,
           "e2e": res["e2e"]}
    if not profiled:
        return out
    summary = reduce(ctx.prof, *ctx.counts)
    ctx.prof = None
    summary.update(units=res["attempted"],
                   launches_ok=trace.launches_agree(summary["launch_check"]))
    if res.get("work"):
        summary["bound_s"] = float(np.mean(
            [step_work.bound_seconds(w)[0] for w in res["work"]]))
    metrics = {}
    names = [m["name"] for m in harness.metrics_of(manifest, "per_layer",
                                                   entry["name"])]
    for name in names + list(NEW_METRICS[traffic["driver"]]):
        v = harness.load(harness.reader(root, name),
                         f"bench_metric_{name}").read(summary)
        if v is not None:
            metrics[name] = v
    print(table(summary, res["attempted"]), file=sys.stderr)
    out.update(busy_s=summary["busy_s"], traced_window_s=summary["window_s"],
               metrics=metrics, idle_by_span=summary["idle_by_span"],
               breakdown=breakdown(summary), idle_gaps=summary["idle_gaps"],
               program_spans={k: v for k, v in summary["program_spans"].items()
                              if v["n"]})
    return out


def parse(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python benchmark/spans.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--profiler", type=int, choices=(0, 1), default=1)
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    out = run(parse(argv))
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
