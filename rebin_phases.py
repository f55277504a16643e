#!/usr/bin/env python
"""Where the rebin kernels' time goes, on one NVIDIA GPU.

    python rebin_phases.py

On the 1M-agent bench problem's states (24 steps of each path, as
chip_smoke.py builds them) it times, with chip_smoke.py's ``_median_ms``:

1. both rebin kernels at every tile shape their launchers take (tile rows
   2 and 1, tile lanes 64 and 32), called through the library with the
   outputs preallocated, each held against the wrapper's result;
2. one-off builds of ``csrc/rebin.cu`` cut down to a part of its work: the
   classification and compaction without the write phase, the candidates'
   loads without the landing test, and the write phase alone (no candidate
   lands, every slot is written as empty).  The cuts are made in a copy of
   the source under the build directory; a changed source that no longer
   holds the lines they replace stops the script;
3. two yardsticks on the same output tensor: ``Tensor.zero_()`` (the
   output's bytes written once) and ``Tensor.copy_()`` (read and written).

Prints the card's name and power limit, then one JSON line per timing.
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

# what each cut-down build keeps; 0 is the kernel as it is
PHASES = {0: "whole kernel", 1: "classify and compact, no write",
          2: "write alone (nothing classified)", 3: "candidate loads alone"}
CUTS = [
    ("  // 3. write: the warps",
     "#if PEDONI_PHASE == 1 || PEDONI_PHASE == 3\n  return;\n#endif\n"
     "  // 3. write: the warps"),
    ("for (int j0 = 0; j0 < k; j0 += kClassify) {",
     "for (int j0 = 0; j0 < (PEDONI_PHASE == 2 ? 0 : k); j0 += kClassify) {"),
    ("const int n_halo = (t.rows + 2) * k * 2;",
     "const int n_halo = PEDONI_PHASE == 2 ? 0 : (t.rows + 2) * k * 2;"),
    ("halo_item(g, tid, k, t, nxl);",
     "halo_item(g, PEDONI_PHASE == 2 ? 1 << 20 : tid, k, t, nxl);"),
    ("        if (a6[q] > 0.5f)\n"
     "          mark_lander(mask, t, gd, x[q], y[q], col.h, col.l + 1, j0 + q);",
     "#if PEDONI_PHASE == 3\n        n_in += x[q] + y[q];\n#else\n"
     "        if (a6[q] > 0.5f)\n"
     "          mark_lander(mask, t, gd, x[q], y[q], col.h, col.l + 1, j0 + q);\n"
     "#endif"),
]


def _cut_builds(build) -> dict[int, ctypes.CDLL]:
    """The cut-down libraries, one nvcc per phase, all started together."""
    src = (build.CSRC / "rebin.cu").read_text()
    for old, new in CUTS:
        if src.count(old) != 1:
            raise SystemExit(f"rebin.cu no longer holds the line to cut: {old!r}")
        src = src.replace(old, new)
    work = build.BUILD_DIR / "rebin_phases"
    work.mkdir(parents=True, exist_ok=True)
    (work / "rebin.cu").write_text(src)
    for header in build.CSRC.glob("*.cuh"):
        (work / header.name).write_text(header.read_text())
    procs = {p: subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, f"-DPEDONI_PHASE={p}", "-shared",
         "-o", str(work / f"phase{p}.so"), str(work / "rebin.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for p in PHASES}
    libs = {}
    for p, proc in procs.items():
        log = proc.communicate(timeout=600)[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on phase {p}:\n{log[-3000:]}")
        libs[p] = ctypes.CDLL(str(work / f"phase{p}.so"))
        libs[p].pedoni_rebin_full.argtypes = build.library().pedoni_rebin_full.argtypes
        libs[p].pedoni_rebin_full.restype = ctypes.c_int
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("rebin_phases: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from pedoni_tpu_torch.bench import build_problem
    from pedoni_tpu_torch.models import sfm_grid
    from pedoni_tpu_torch.ops.kernels import _build
    from pedoni_tpu_torch.ops.kernels import rebin as rb
    from pedoni_tpu_torch.ops.kernels import step_kernel as sk

    dev = torch.device("cuda")
    lib = _build.library()
    print(chip_smoke._card(), flush=True)
    _sc, maps, cfg, flat = build_problem(chip_smoke.N_AGENTS, device=dev)
    fwp, fobs = sfm_grid.field_tensors(cfg, maps, dev)
    phys, size = cfg.physics, cfg.scenario.size
    unit, nx, ny = cfg.grid.unit, cfg.grid.nx, cfg.grid.ny
    states = {}
    for name, incremental in (("full", False), ("hybrid", True)):
        step = sfm_grid.make_step_grid(cfg, incremental=incremental)
        gs = sfm_grid.bin_state(cfg, flat)
        for _ in range(24):
            gs, _m = step(gs, fwp, fobs)
        states[name] = gs.d
    g = sk.fused_step(states["full"], fwp, fobs, phys, size)
    g_mv, m_mv = sk.fused_step(states["hybrid"], fwp, fobs, phys, size,
                               emit_movers=8)[:2]
    want = {"rebin": rb.rebin(g, unit, nx, ny),
            "rebin_incremental": rb.rebin_incremental(g_mv, m_mv, unit, nx, ny)}
    ny2, k, _, nxl = g.shape
    mk = m_mv.shape[1]
    stream = torch.cuda.current_stream().cuda_stream
    out = rb.new_outputs(g)
    tail = (unit, nx, ny, 0, 0, nx)  # a whole grid: no tile offsets

    def full(library, rows, lanes):
        return library.pedoni_rebin_full(
            g.data_ptr(), out[0].data_ptr(), *rb._ptrs(out, None), rb.FULL, ny2,
            k, nxl, 2, *tail, rows, lanes, (rows + 2) * lanes,
            rb.rebin_smem_bytes(k, 0, rows, lanes), stream)

    def incremental(library, rows, lanes):
        return library.pedoni_rebin_incremental(
            g_mv.data_ptr(), m_mv.data_ptr(), out[0].data_ptr(),
            *rb._ptrs(out, None), rb.INCREMENTAL, ny2, k, mk, nxl, 2, *tail,
            rows, lanes, (rows + 2) * lanes,
            rb.rebin_smem_bytes(k, mk, rows, lanes), stream)

    def timed(fn, *args) -> float:
        def run():
            _build.check_launch(fn(*args), fn.__name__)
        return chip_smoke._median_ms(run)

    # 1. every tile shape; the sums accumulate, so they are cleared first
    for rows in (2, 1):
        for lanes in rb.REBIN_TILE_LANES:
            for name, fn in (("rebin", full), ("rebin_incremental", incremental)):
                out[0].fill_(float("nan"))
                for t in out[1:]:
                    t.zero_()
                _build.check_launch(fn(lib, rows, lanes), name)
                torch.cuda.synchronize()
                equal = all(torch.equal(a, b) for a, b in zip(out, want[name]))
                print(json.dumps({"kernel": name, "tile_rows": rows,
                                  "tile_lanes": lanes, "equal_to_wrapper": equal,
                                  "ms": timed(fn, lib, rows, lanes)}), flush=True)
                if not equal:
                    return 1
    # 2. the full rebin cut down to its phases, at the chooser's tile
    rows, lanes = rb.rebin_launch(k, 0, ny2, nxl, 2)[:2]
    for phase, cut in _cut_builds(_build).items():
        print(json.dumps({"kernel": "rebin", "phase": PHASES[phase],
                          "tile_rows": rows, "tile_lanes": lanes,
                          "ms": timed(full, cut, rows, lanes)}), flush=True)
    # 3. yardsticks
    print(json.dumps({"yardstick": "zero_ of the output",
                      "ms": chip_smoke._median_ms(out[0].zero_)}), flush=True)
    print(json.dumps({"yardstick": "copy_ of the input into the output",
                      "ms": chip_smoke._median_ms(lambda: out[0].copy_(g))}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
