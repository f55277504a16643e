"""Named spans of the program's phases, on torch.profiler's clock.

Tracing is off by default.  ``span(name)`` then returns one shared no-op
context: it allocates nothing, and the step pays one call and one flag
test a phase.  With ``enable(True)`` it returns a profiler range of that
name (torch's C++ ``_RecordFunctionFast``, which opens and closes some
twenty times faster than ``torch.profiler.record_function``; the latter
where a torch lacks it).  The range lands in whatever profile is
recording (the benchmark's traced window, the CLI's ``--profile DIR``),
on the same clock as the device's kernels; with no profile recording it
is opened and closed and kept nowhere.

Every name carries a dotted prefix (its layer), so none equals a span
that a caller opens around the program (``window``, ``step``, ``tick``,
``restore``, ``fence``).  ``NAMES`` lists every span the program opens;
a reader of a profile tells the program's ranges from others by it.
"""

from __future__ import annotations

import contextlib

import torch

NAMES = (
    "sim.tick", "sim.run", "sim.fetch", "sim.grow",
    "flat.step", "flat.spawn", "flat.sample", "flat.sort", "flat.scatter",
    "flat.pairs", "flat.integrate", "flat.metrics",
    "grid.step", "grid.spawn", "grid.forces", "grid.rebin", "grid.metrics",
    "pallas.step", "tiles.step",
)

_OFF = contextlib.nullcontext()
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast",
                 torch.profiler.record_function)
_on = False


def enable(flag: bool) -> None:
    """Turn the program's spans (and the counters kept only while tracing,
    such as a grid step's ``full_rebins``) on or off, process-wide."""
    global _on
    _on = bool(flag)


def enabled() -> bool:
    return _on


def span(name: str):
    """A context that marks ``name`` in the profile while tracing is on."""
    if not _on:
        return _OFF
    return _RANGE(name)
