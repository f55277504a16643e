"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` for Hopper (``sm_90a``), one
``nvcc`` per source, all started together, and linked into one shared
library with a plain C interface, at first use, and loaded with
``ctypes``.  The library lands in ``pedoni_tpu_torch/_build/`` under a name
that carries a hash of the sources and flags, so an edited source is
never served by a stale build.

Flags: no ``--use_fast_math`` (the rebin's cell classification needs the
IEEE f32 divide, and the step kernel's expf/sqrtf must stay the accurate
ones), and ``--fmad=false`` so that no a*b+c is fused into an FMA that the
plain PyTorch twins do not perform.

A missing ``nvcc`` or a failed build raises: nothing falls back to the
twins on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log: str = ""  # nvcc/ptxas output of that build (registers, spills)


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256()
    for p in sorted(q for q in CSRC.iterdir() if q.is_file()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libpedoni_kernels_{h.hexdigest()[:16]}.so"


def _run(cmds: list[list[str]]) -> str:
    """Run the commands side by side; raise on the first that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    logs = []
    for p in procs:
        logs.append(p.communicate(timeout=600)[0])
    for p, text in zip(procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{text[-4000:]}")
    return "".join(logs)


def _compile(out: Path) -> None:
    global build_log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    log = _run([[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                for src, o in zip(_sources(), objs)])
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log += _run([[_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)]])
    for o in objs:
        o.unlink()
    tmp.replace(out)
    build_log = log


def library() -> ctypes.CDLL:
    """The kernel library, built on first call in this checkout."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _compile(path)
        lib = ctypes.CDLL(str(path))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.pedoni_step_kernel.argtypes = [p] * 9 + [i] * 18 + [p, p]
        lib.pedoni_step_kernel.restype = i
        lib.pedoni_rebin_full.argtypes = [p] * 7 + [i] * 5 + [f] + [i] * 9 + [p]
        lib.pedoni_rebin_full.restype = i
        lib.pedoni_rebin_incremental.argtypes = [p] * 8 + [i] * 6 + [f] + [i] * 9 + [p]
        lib.pedoni_rebin_incremental.restype = i
        lib.pedoni_pairwise.argtypes = [p, p] + [i] * 7 + [p, p]
        lib.pedoni_pairwise.restype = i
        lib.pedoni_flat_pairwise.argtypes = [p, p] + [i] * 3 + [p, p]
        lib.pedoni_flat_pairwise.restype = i
        lib.pedoni_flat_pairwise_tile.argtypes = [i, p]
        lib.pedoni_flat_pairwise_tile.restype = i
        q = ctypes.c_int64
        lib.pedoni_flat_sample.argtypes = [p] * 8 + [q, q] + [i] * 5 + [p] * 3
        lib.pedoni_flat_sample.restype = i
        lib.pedoni_flat_scatter.argtypes = [p] * 12 + [q] + [i] * 4 + [p, p]
        lib.pedoni_flat_scatter.restype = i
        lib.pedoni_flat_integrate.argtypes = [p] * 9 + [q, i, i, p, p]
        lib.pedoni_flat_integrate.restype = i
        _lib = lib
        return lib


WRONG_DEVICE = -2  # csrc/device.cuh: PEDONI_WRONG_DEVICE


def check_launch(rc: int, name: str) -> None:
    """Raise on a refused launch (the C launchers return cudaGetLastError,
    -1 for a launch shape they do not take, WRONG_DEVICE for a grid that
    does not lie on the current device)."""
    if rc == WRONG_DEVICE:
        raise RuntimeError(f"{name}: the grid's memory is not on the current "
                           "CUDA device; the launch would run on another card")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
