"""Native (C++) fast-marching solver, loaded via ctypes.

``fmm.cpp`` is the fast-marching Eikonal preprocessing (field.rs:118-192),
compiled with g++ on first use into ``pedoni_tpu_torch/_build/``.  The
sequential binary-heap solve is ~100x slower in pure Python on the
multi-megacell grids of the large scenarios (the 1M-agent bench field is
~6.4M cells); the pure-Python fallback (field.fmm_python) keeps the
package usable without a toolchain.
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

_SRC = Path(__file__).parent / "fmm.cpp"
_LIB = Path(__file__).resolve().parents[1] / "_build" / "libpedoni_fmm.so"
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def _build() -> bool:
    _LIB.parent.mkdir(parents=True, exist_ok=True)
    tmp = _LIB.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           str(_SRC), "-o", str(tmp)]
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
        if not _SRC.exists():
            return None
        if not _LIB.exists() or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
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
