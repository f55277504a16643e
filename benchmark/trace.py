"""The traced run's reduction: a torch.profiler trace of the window to the
numbers the per-layer readers take (``benchmark/metrics/``) and the
``breakdown`` of the result line.

- ``busy_s``: the union of the device's operation intervals (kernels,
  copies, sets) inside the window;
- ``window_s``: the window's span on the same clock (the harness's
  ``window`` range);
- ``device_ops``: device operations (kernels, copies, sets) in the window;
- ``by_kernel``: device seconds and launches by short kernel name;
- ``idle_by_span``: the device's idle time inside the window by the
  harness's span (``step``, ``tick``, ``restore``, ``fence``; ``host``
  where none is open) that was open at the middle of each idle gap;
- ``launch_check``: each hand kernel's launches in the trace against the
  program's own counter (``ops/kernels.launch_counts``), through
  ``metrics/hand_kernels.json``.
"""

from __future__ import annotations

import bisect
import json
import re
from pathlib import Path

import torch

SPANS = ("step", "tick", "restore", "fence")
HAND_KERNELS = Path(__file__).parent / "metrics" / "hand_kernels.json"


def short_name(name: str) -> str:
    """A kernel's function name without return type, namespace, template
    or arguments."""
    s = name.replace("(anonymous namespace)::", "")
    if s.startswith("void "):
        s = s[5:]
    base = re.split(r"[(<]", s, maxsplit=1)[0]
    return base.split("::")[-1].strip() or name


def _union(iv: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce(prof, counts_before: dict, counts_after: dict) -> dict:
    """The numbers of a profile whose window the harness marked with a
    ``window`` range; ``counts_*``: ``launch_counts()`` around it."""
    cuda = torch.autograd.DeviceType.CUDA
    window = None
    spans: list[tuple[float, float, str]] = []
    dev: list[tuple[float, float, str]] = []
    for ev in prof.events():
        tr = ev.time_range
        if ev.device_type == cuda:
            # the device's copies of the harness's ranges are no operations
            if not (getattr(ev, "is_user_annotation", False)
                    or ev.name in SPANS or ev.name == "window"):
                dev.append((tr.start, tr.end, ev.name))
        elif ev.name == "window":
            window = (tr.start, tr.end)
        elif ev.name in SPANS:
            spans.append((tr.start, tr.end, ev.name))
    if window is None:
        raise RuntimeError("the trace holds no 'window' range")
    w0, w1 = window
    dev = [(max(a, w0), min(b, w1), n) for a, b, n in dev if b > w0 and a < w1]
    busy = _union([(a, b) for a, b, _ in dev])
    by_kernel: dict[str, list[float]] = {}
    for a, b, n in dev:
        k = by_kernel.setdefault(short_name(n), [0.0, 0])
        k[0] += (b - a) * 1e-6
        k[1] += 1
    spans.sort()
    starts = [s[0] for s in spans]
    idle: dict[str, float] = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        name = "host"
        k = bisect.bisect_right(starts, mid) - 1
        if k >= 0 and spans[k][1] >= mid:  # spans follow one another
            name = spans[k][2]
        idle[name] = idle.get(name, 0.0) + (b - a) * 1e-6
    return {"busy_s": sum(b - a for a, b in busy) * 1e-6,
            "window_s": (w1 - w0) * 1e-6,
            "device_ops": len(dev),
            "by_kernel": by_kernel,
            "idle_by_span": idle,
            "launch_check": launch_check(by_kernel, counts_before, counts_after)}


def launch_check(by_kernel: dict, before: dict, after: dict) -> dict:
    """{kernel: (launches traced, launches counted)} for each hand kernel
    whose counters moved; counters that no entry maps are listed under
    ``unmapped``."""
    table = json.loads(HAND_KERNELS.read_text())
    moved = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    out: dict = {}
    mapped = set()
    for kernel, counters in table.items():
        mapped.update(counters)
        counted = sum(moved.get(c, 0) for c in counters)
        traced = sum(v[1] for name, v in by_kernel.items()
                     if name == kernel or name.startswith(kernel + "_"))
        if counted or traced:
            out[kernel] = (traced, counted)
    out["unmapped"] = sorted(k for k, v in moved.items() if v and k not in mapped)
    return out


def launches_agree(check: dict) -> bool:
    return all(t == c for k, (t, c) in
               ((k, v) for k, v in check.items() if k != "unmapped"))


def breakdown(summary: dict) -> dict:
    """The result line's breakdown: the ten device operations that took
    most time and the idle time by host span, seconds as measured."""
    ops = sorted(((n, v[0]) for n, v in summary["by_kernel"].items()),
                 key=lambda x: -x[1])[:10]
    gaps = sorted(summary["idle_by_span"].items(), key=lambda x: -x[1])[:10]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}
