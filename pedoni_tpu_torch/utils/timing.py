"""Small wall-clock timing helper mirroring the reference's per-phase
``Instant::now()`` instrumentation (pedoni-simulator/src/lib.rs:68-91)."""

from __future__ import annotations

import time


class Timer:
    """Context manager that records elapsed wall-clock seconds."""

    def __init__(self) -> None:
        self.elapsed = 0.0

    def __enter__(self) -> "Timer":
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.elapsed = time.perf_counter() - self._start
