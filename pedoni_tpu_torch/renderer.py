"""Host-side visualization.

The reference ships an interactive OpenGL renderer (pedoni/src/renderer/);
in a TPU pod / headless world the equivalents are:

- ``TerminalRenderer``: live ANSI rendering of the field — obstacles as
  blocks, agents as density glyphs colored by destination (the reference's
  6-color destination cycle, renderer/mod.rs:9-16).
- ``save_frame`` / ``save_trajectory_plot``: matplotlib snapshots for
  offline inspection (gated import; matplotlib is optional).
- ``SnapshotStream``: double-buffered async device->host position fetch so
  rendering never blocks the simulation step — the moral equivalent of the
  reference's sim-thread/render-thread split (main.rs:20-26, 94-96).
"""

from __future__ import annotations

import sys
import threading
from typing import Callable

import numpy as np

from .scenario import Scenario

# ANSI 256-color codes roughly matching the reference's destination color
# cycle (renderer/mod.rs:9-16).
_DEST_COLORS = [196, 208, 226, 46, 51, 129]


class TerminalRenderer:
    """Live ANSI field view with a camera.

    Pan with the arrow keys (or h/j/k/l), zoom with +/-, reset with 0 —
    the terminal counterpart of the reference GUI's drag-pan / scroll-zoom
    camera (renderer/mod.rs:54-63, 138-168), which makes the 200 m+
    scenarios inspectable at character-cell resolution.  Agent glyphs
    encode per-cell density (· • ● █), colored by destination."""

    def __init__(self, scenario: Scenario, width: int = 100) -> None:
        self.scenario = scenario
        w_m, h_m = scenario.size
        self.cols = min(width, 160)
        # Terminal cells are ~2x taller than wide.
        self.rows = max(1, int(self.cols * (h_m / w_m) * 0.5))
        self.zoom = 1.0
        self.cx = w_m / 2.0
        self.cy = h_m / 2.0
        self._static = self._build_static()
        self._first = True
        self._lock = threading.Lock()

    # -- camera -----------------------------------------------------------
    def _view(self) -> tuple[float, float, float, float]:
        """(x0, y0, sx, sy): world origin of the view + cells per meter."""
        w_m, h_m = self.scenario.size
        vw, vh = w_m / self.zoom, h_m / self.zoom
        x0 = min(max(self.cx - vw / 2, 0.0), max(w_m - vw, 0.0))
        y0 = min(max(self.cy - vh / 2, 0.0), max(h_m - vh, 0.0))
        return x0, y0, self.cols / vw, self.rows / vh

    def handle_key(self, ch: str) -> bool:
        """Camera controls; returns True if the key was consumed."""
        w_m, h_m = self.scenario.size
        pan = 0.1 * max(w_m, h_m) / self.zoom
        with self._lock:
            if ch in ("LEFT", "h"):
                self.cx -= pan
            elif ch in ("RIGHT", "l"):
                self.cx += pan
            elif ch in ("UP", "k"):
                self.cy -= pan
            elif ch in ("DOWN", "j"):
                self.cy += pan
            elif ch in ("+", "="):
                self.zoom = min(self.zoom * 1.5, 64.0)
            elif ch in ("-", "_"):
                self.zoom = max(self.zoom / 1.5, 1.0)
            elif ch == "0":
                self.zoom, self.cx, self.cy = 1.0, w_m / 2, h_m / 2
            else:
                return False
            self.cx = min(max(self.cx, 0.0), w_m)
            self.cy = min(max(self.cy, 0.0), h_m)
            self._static = self._build_static()
        return True

    def _build_static(self) -> np.ndarray:
        grid = np.full((self.rows, self.cols), " ", dtype=object)
        from .field import rasterize_quad
        from .utils.geometry import widen_segment

        x0, y0, sx, sy = self._view()
        off = np.array([x0, y0])
        scale = np.array([sx, sy])
        for obs in self.scenario.obstacles:
            mask = np.zeros((self.rows, self.cols), dtype=bool)
            corners = (widen_segment(obs.p0, obs.p1, obs.width) - off) * scale
            rasterize_quad(mask, corners)
            grid[mask] = "\x1b[90m█\x1b[0m"
        for wp in self.scenario.waypoints:
            mask = np.zeros((self.rows, self.cols), dtype=bool)
            corners = (widen_segment(wp.p0, wp.p1, wp.width) - off) * scale
            rasterize_quad(mask, corners)
            grid[mask] = "\x1b[33m▒\x1b[0m"
        return grid

    _DENSITY = "·•●█"

    def draw(self, pos: np.ndarray, dest: np.ndarray, step: int) -> None:
        with self._lock:
            grid = self._static.copy()
            x0, y0, sx, sy = self._view()
            zoom = self.zoom
        if len(pos):
            xs = ((pos[:, 0] - x0) * sx).astype(int)
            ys = ((pos[:, 1] - y0) * sy).astype(int)
            inside = (xs >= 0) & (xs < self.cols) & (ys >= 0) & (ys < self.rows)
            xs, ys, ds = xs[inside], ys[inside], dest[inside]
            # Work per occupied character cell, not per agent (agent counts
            # reach millions; the screen has at most rows*cols cells).
            flat = ys * self.cols + xs
            counts = np.bincount(flat, minlength=self.rows * self.cols)
            dcell = np.zeros(self.rows * self.cols, np.int64)
            np.maximum.at(dcell, flat, ds.astype(np.int64))
            for f in np.nonzero(counts)[0]:
                color = _DEST_COLORS[int(dcell[f]) % len(_DEST_COLORS)]
                glyph = self._DENSITY[min(int(counts[f]) - 1, 3)]
                grid[f // self.cols, f % self.cols] = \
                    f"\x1b[38;5;{color}m{glyph}\x1b[0m"
        lines = ["".join(row) for row in grid]
        out = sys.stdout
        if not self._first:
            out.write(f"\x1b[{self.rows + 1}A")
        self._first = False
        out.write("\n".join(lines))
        out.write(
            f"\nstep {step:6d}  agents {len(pos):6d}  zoom {zoom:4.1f}x"
            "  [arrows/hjkl pan, +/- zoom, 0 reset, space pause, q quit]\x1b[K\n"
        )
        out.flush()


class SnapshotStream:
    """Background thread that repeatedly fetches (pos, dest) snapshots and
    hands them to a callback, double-buffered so the sim loop never waits.

    Pacing is adaptive: each cycle sleeps at least ``backoff`` times the
    duration of the previous fetch, so when a fetch is expensive (grid
    unbin + device->host transfer at 1M+ agents over a tunnel) the stream
    automatically degrades to a lower frame rate instead of saturating
    the host core the sim loop needs."""

    def __init__(self, fetch: Callable[[], tuple[np.ndarray, np.ndarray]],
                 on_frame: Callable[[np.ndarray, np.ndarray], None],
                 interval: float = 0.05, backoff: float = 3.0) -> None:
        self._fetch = fetch
        self._on_frame = on_frame
        self._interval = interval
        self._backoff = backoff
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self) -> "SnapshotStream":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)

    def _run(self) -> None:
        import time as _time

        wait = self._interval
        while not self._stop.wait(wait):
            t0 = _time.perf_counter()
            try:
                pos, dest = self._fetch()
            except Exception:
                continue
            self._on_frame(pos, dest)
            wait = max(self._interval,
                       self._backoff * (_time.perf_counter() - t0))


def save_frame(scenario: Scenario, pos: np.ndarray, dest: np.ndarray,
               path: str, dpi: int = 120) -> None:
    """Save a matplotlib snapshot of the current crowd state."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import Polygon as MplPolygon

    from .utils.geometry import widen_segment

    w, h = scenario.size
    fig, ax = plt.subplots(figsize=(8, 8 * h / w))
    for obs in scenario.obstacles:
        ax.add_patch(MplPolygon(widen_segment(obs.p0, obs.p1, obs.width),
                                color="0.4"))
    for wp in scenario.waypoints:
        ax.add_patch(MplPolygon(widen_segment(wp.p0, wp.p1, wp.width),
                                color="orange", alpha=0.6))
    if len(pos):
        cmap = ["tab:red", "tab:orange", "gold", "tab:green", "tab:cyan",
                "tab:purple"]
        colors = [cmap[int(d) % 6] for d in dest]
        ax.scatter(pos[:, 0], pos[:, 1], s=4, c=colors)
    ax.set_xlim(0, w)
    ax.set_ylim(h, 0)
    ax.set_aspect("equal")
    fig.savefig(path, dpi=dpi, bbox_inches="tight")
    plt.close(fig)


class KeyPoller:
    """Non-blocking single-key reader for the terminal render loop — the
    counterpart of the reference GUI's keyboard handling (Space pauses,
    renderer/mod.rs:121-136; we add 'q' to quit).  No-ops when stdin is not
    a tty (pipes, tests)."""

    def __init__(self) -> None:
        self._enabled = False
        try:
            import atexit
            import termios
            import tty

            self._fd = sys.stdin.fileno()
            if sys.stdin.isatty():
                self._old = termios.tcgetattr(self._fd)
                tty.setcbreak(self._fd)
                self._enabled = True
                # __del__ is not guaranteed to run (exceptions, interpreter
                # teardown ordering) — atexit makes sure the user never gets
                # a cbreak/no-echo terminal back.
                atexit.register(self.restore)
        except Exception:
            pass

    _ARROWS = {"A": "UP", "B": "DOWN", "C": "RIGHT", "D": "LEFT"}

    @classmethod
    def _decode(cls, buf: list[str]) -> list[str]:
        """CSI arrow sequences decode to UP/DOWN/LEFT/RIGHT."""
        out: list[str] = []
        i = 0
        while i < len(buf):
            if (buf[i] == "\x1b" and i + 2 < len(buf) and buf[i + 1] == "["
                    and buf[i + 2] in cls._ARROWS):
                out.append(cls._ARROWS[buf[i + 2]])
                i += 3
            else:
                out.append(buf[i])
                i += 1
        return out

    def poll(self) -> list[str]:
        """Pending keys, arrow sequences decoded."""
        if not self._enabled:
            return []
        import select

        buf = []
        while select.select([sys.stdin], [], [], 0)[0]:
            buf.append(sys.stdin.read(1))
        return self._decode(buf)

    def restore(self) -> None:
        """Put the tty back; idempotent, safe to call from finally blocks."""
        if self._enabled:
            self._enabled = False
            try:
                import termios

                termios.tcsetattr(self._fd, termios.TCSADRAIN, self._old)
            except Exception:
                pass

    def __del__(self) -> None:
        self.restore()
