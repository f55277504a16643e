"""Native (C++) host runtime, loaded via ctypes: the reference's
``pedoni_tpu/native`` library, compiled with g++ on first use from the
sources here into one library in ``pedoni_tpu_torch/_build/``.

- ``fmm.cpp`` -- the fast-marching Eikonal preprocessing (field.rs:
  118-192).  The sequential binary-heap solve is ~100x slower in pure
  Python on the multi-megacell grids of the large scenarios (the 1M-agent
  bench field is ~6.4M cells); the pure-Python fallback (field.fmm_python)
  keeps the package usable without a toolchain.
- ``trajlog.cpp`` -- the asynchronous binary trajectory recorder behind
  ``TrajectoryWriter``: a frame costs the caller one memcpy, and a
  background thread writes ``PTRJ0001`` frames (``read_trajectory`` reads
  them back).  Without the library the writer falls back to one
  compressed ``.npz`` per frame, as the reference's does.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

log = logging.getLogger(__name__)

_SRCS = [Path(__file__).parent / "fmm.cpp",
         Path(__file__).parent / "trajlog.cpp"]
_LIB = Path(__file__).resolve().parents[1] / "_build" / "libpedoni_native.so"
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False

TRAJ_MAGIC = b"PTRJ0001"


def _build() -> bool:
    _LIB.parent.mkdir(parents=True, exist_ok=True)
    tmp = _LIB.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           *map(str, _SRCS), "-o", str(tmp), "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired, OSError) as e:
        out = getattr(e, "stderr", b"") or b""
        log.warning("native build failed (%s): %s", e, out.decode(errors="replace")[:500])
        return False
    tmp.replace(_LIB)  # atomic: concurrent test workers never see a partial file
    return True


def _load() -> ctypes.CDLL | None:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not all(src.exists() for src in _SRCS):
            return None
        newest_src = max(src.stat().st_mtime for src in _SRCS)
        if not _LIB.exists() or _LIB.stat().st_mtime < newest_src:
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(str(_LIB))
        except OSError as e:
            log.warning("failed to load native lib: %s", e)
            return None
        lib.pedoni_fmm.argtypes = [
            ctypes.POINTER(ctypes.c_float),  # potential, in/out
            ctypes.POINTER(ctypes.c_float),  # slowness
            ctypes.c_int64,  # height
            ctypes.c_int64,  # width
        ]
        lib.pedoni_fmm.restype = None
        lib.pedoni_traj_open.argtypes = [ctypes.c_char_p]
        lib.pedoni_traj_open.restype = ctypes.c_void_p
        lib.pedoni_traj_append.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.pedoni_traj_append.restype = None
        lib.pedoni_traj_pending.argtypes = [ctypes.c_void_p]
        lib.pedoni_traj_pending.restype = ctypes.c_int64
        lib.pedoni_traj_close.argtypes = [ctypes.c_void_p]
        lib.pedoni_traj_close.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def fmm(potential: np.ndarray, f: np.ndarray) -> np.ndarray:
    """Fast-marching Eikonal solve on the native side.  Same contract as
    ``field.fmm_python``."""
    lib = _load()
    assert lib is not None, "native library unavailable"
    pot = np.ascontiguousarray(potential, dtype=np.float32).copy()
    slowness = np.ascontiguousarray(f, dtype=np.float32)
    h, w = pot.shape
    lib.pedoni_fmm(
        pot.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        slowness.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(h),
        ctypes.c_int64(w),
    )
    return pot


class TrajectoryWriter:
    """Streaming trajectory capture (the reference's ``TrajectoryWriter``).

    Uses the native async writer when available (one memcpy on the caller's
    thread, framed binary format); otherwise falls back to one compressed
    .npz per frame next to ``path``.
    """

    def __init__(self, path: str | Path) -> None:
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._h = None
        lib = _load()
        if lib is not None:
            self._h = lib.pedoni_traj_open(str(self.path).encode())
        self.native = self._h is not None

    def append(self, step: int, pos: np.ndarray, dest: np.ndarray) -> None:
        pos = np.ascontiguousarray(pos, dtype=np.float32)
        dest = np.ascontiguousarray(dest, dtype=np.int32)
        n = len(dest)
        if self._h is not None:
            _lib.pedoni_traj_append(
                self._h, ctypes.c_int64(step), ctypes.c_int64(n),
                pos.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                dest.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            )
        else:
            np.savez_compressed(
                self.path.parent / f"{self.path.stem}_{step:08d}.npz",
                pos=pos, dest=dest)

    def pending(self) -> int:
        if self._h is None:
            return 0
        return int(_lib.pedoni_traj_pending(self._h))

    def close(self) -> None:
        if self._h is not None:
            _lib.pedoni_traj_close(self._h)
            self._h = None

    def __enter__(self) -> "TrajectoryWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_trajectory(path: str | Path):
    """Yield (step, pos [n,2] f32, dest [n] i32) frames from a .traj file."""
    with open(path, "rb") as f:
        if f.read(8) != TRAJ_MAGIC:
            raise ValueError(f"{path}: not a pedoni trajectory file")
        while True:
            head = f.read(16)
            if len(head) < 16:
                return
            step, n = np.frombuffer(head, dtype=np.int64)
            pos = np.frombuffer(f.read(8 * n), dtype=np.float32).reshape(-1, 2)
            dest = np.frombuffer(f.read(4 * n), dtype=np.int32)
            yield int(step), pos, dest
