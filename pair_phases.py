#!/usr/bin/env python
"""Where the flat pair kernel's time goes, on one NVIDIA GPU.

    python pair_phases.py [--parent DIR] [--sass DIR]

On two padded cell grids of the flat step -- the 1M-agent xla bench
problem after FLAT_STEPS steps (chip_smoke.py phase 15's problem, K 14)
and scenarios/random.toml's jammed crowd after chip_smoke.py's fill of
3000 ticks, as the benchmark's random.tick cell fills it (K 16) -- it
times ``csrc/flat_pairwise.cu`` with chip_smoke.py's ``_median_ms`` (CUDA
events, median of 20, each run behind a ~1 ms device spin):

1. the kernel as it is, each build held first bit for bit to its twin
   (forcepass.dense_pairwise_torch) on both grids;
2. one-off builds cut down to a part of its work (PHASES): the staging and
   the boxes alone (no pair phase), and the staging with the pair phase's
   walk but without its force body; and whole builds of the design's
   variants.  The cuts and variants are string edits (DESIGNS, one entry a
   design of the kernel, recognised by its first cut) of a copy of the
   source under the build directory; a source that holds none of the
   designs' texts stops the script;
3. where the kernel has the occupancy counter
   (``flat_pairwise.flat_pairwise_occupancy``), its readings on both grids.

With ``--parent DIR`` (a checkout of another commit, e.g. a ``git
archive`` under a git-ignored directory) the parent's kernel and its cuts
are timed too, in turns (parent, this tree, this tree, parent).  ``--sass
DIR`` writes each whole build's SASS there (``cuobjdump -sass``).

Prints the card's name and power limit, then one JSON line per timing and
a summary line of medians.  Exits 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import shutil
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent
KERNEL = pathlib.Path("pedoni_tpu_torch/ops/kernels/csrc/flat_pairwise.cu")
FLAT_STEPS = 16  # steps of the 1M problem before its grid is taken
# what each cut-down build keeps; 0 is the kernel as it is
PHASES = {0: "whole kernel", 1: "staging and boxes (no pair phase)",
          2: "staging and walk (no force body)"}
# Each design's cuts, (old, new) pairs of source text whose new text keys
# on PEDONI_PHASE, so one cut source builds every phase; and its variants,
# edits of the same kind built whole beside the design as it is.  A design
# is recognised by its first cut's old text.
DESIGNS = {
    "one lane a centre (PR 14)": ([
        ("  for (int base = 0; base < n_live + n_idle; base += blockDim.x) {",
         "  for (int base = 0; base < (PEDONI_PHASE == 1 ? 0 : n_live + n_idle);\n"
         "       base += blockDim.x) {"),
        ("      const int rounds = __reduce_max_sync(kFullWarp, n);",
         "      const int rounds = PEDONI_PHASE == 2 ? 0 : "
         "__reduce_max_sync(kFullWarp, n);"),
    ], {}),
    "warp pair queues (PR 24)": ([
        ("  for (int g = warp; g < n_groups; g += nwarps) {",
         "  for (int g = warp; g < (PEDONI_PHASE == 1 ? 0 : n_groups); "
         "g += nwarps) {"),
        ("      const int ne = last ? qn : qn & ~31;\n",
         "      const int ne = last ? qn : qn & ~31;\n#if PEDONI_PHASE == 2\n"
         "      qn = 0;  // the queue dropped: no force body, no sum\n"
         "      continue;\n#endif\n"),
    ], {
        "groups of 32 active slots in list order": [
            ("  const int n_lg = (n_live + 32 * nwarps - 1) / (32 * nwarps) * nwarps;",
             "  const int n_lg = (n_live + 31) / 32;"),
            ("  const int g_live = n_lg ? (n_live + n_lg - 1) / n_lg : 0;",
             "  const int g_live = 32;"),
        ],
        "a queue of 128 pairs": [
            ("constexpr int kQueue = 256;", "constexpr int kQueue = 128;"),
        ],
    }),
}


def _design(src: str) -> str:
    """The name of the design ``src`` is, by its first cut's text."""
    for name, (cuts, _variants) in DESIGNS.items():
        if cuts[0][0] in src:
            return name
    raise SystemExit("flat_pairwise.cu is none of pair_phases.DESIGNS; "
                     "add its cuts")


def _replace(src: str, edits: list[tuple[str, str]], what: str) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"flat_pairwise.cu no longer holds the text of "
                             f"{what}: {old!r}")
        src = src.replace(old, new)
    return src


def cut_source(src: str, variant: str | None = None) -> str:
    """``src`` with its design's cuts made, then a variant's edits."""
    cuts, variants = DESIGNS[_design(src)]
    out = _replace(src, cuts, "the cuts")
    return out if variant is None else _replace(out, variants[variant], variant)


def _build_libs(build, csrc: pathlib.Path, work: pathlib.Path, src: str,
                phases, tag: str) -> dict[int, ctypes.CDLL]:
    """``src`` built once per phase in ``work``, one nvcc each, all started
    together; prints each build's register and spill lines."""
    work.mkdir(parents=True, exist_ok=True)
    (work / KERNEL.name).write_text(src)
    for header in csrc.glob("*.cuh"):
        shutil.copy(header, work / header.name)
    procs = {p: subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, f"-DPEDONI_PHASE={p}", "-shared",
         "-o", str(work / f"phase{p}.so"), str(work / KERNEL.name)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for p in phases}
    libs = {}
    for p, proc in procs.items():
        log = proc.communicate(timeout=600)[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {tag} phase {p}:\n{log[-3000:]}")
        info, name = {}, None
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                name = ln.split("'")[1] if "'" in ln else ln
            elif name and "flat_pairwise_tile" in name and (
                    "registers" in ln or "spill" in ln):
                info.setdefault(name, []).append(ln.split(":", 1)[-1].strip())
        print(json.dumps({"source": tag, "phase": PHASES[p], "ptxas": info}),
              flush=True)
        lib = ctypes.CDLL(str(work / f"phase{p}.so"))
        lib.pedoni_flat_pairwise.argtypes = [ctypes.c_void_p] * 2 + [
            ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
        lib.pedoni_flat_pairwise.restype = ctypes.c_int
        libs[p] = lib
    return libs


def _builds(build, root: pathlib.Path, tag: str, sass: pathlib.Path | None
            ) -> dict[str, dict[int, ctypes.CDLL]]:
    """{tag: every phase's build of ``root``'s kernel, and "tag / variant":
    each variant's whole build}."""
    csrc = root / KERNEL.parent
    src = (csrc / KERNEL.name).read_text()
    work = build.BUILD_DIR / "pair_phases" / tag
    out = {tag: _build_libs(build, csrc, work, cut_source(src), PHASES, tag)}
    for i, variant in enumerate(DESIGNS[_design(src)][1]):
        name = f"{tag} / {variant}"
        out[name] = _build_libs(build, csrc, work / f"variant{i}",
                                cut_source(src, variant), [0], name)
    if sass is not None and shutil.which("cuobjdump"):
        sass.mkdir(parents=True, exist_ok=True)
        text = subprocess.run(["cuobjdump", "-sass", str(work / "phase0.so")],
                              capture_output=True, text=True, timeout=300).stdout
        (sass / f"{tag}.sass").write_text(text)
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=pathlib.Path, default=None,
                    help="a checkout of another commit, timed in turns")
    ap.add_argument("--sass", type=pathlib.Path, default=None,
                    help="write each whole build's SASS into this directory")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("pair_phases: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from pedoni_tpu_torch.bench import build_problem
    from pedoni_tpu_torch.models import sfm
    from pedoni_tpu_torch.ops import forcepass
    from pedoni_tpu_torch.ops.kernels import _build
    from pedoni_tpu_torch.ops.kernels import flat_pairwise as fpk
    from pedoni_tpu_torch.ops.neighbor import CellGrid

    dev = torch.device("cuda")
    print(chip_smoke._card(), flush=True)
    _sc, maps, cfg, st = build_problem(chip_smoke.N_AGENTS, device=dev, backend="xla")
    field, obstacles = sfm.device_inputs(cfg, maps, dev)
    step = sfm.make_step(cfg)
    for _ in range(FLAT_STEPS):
        st, _m = step(st, field.rows, obstacles)
    grids = {"1M": (chip_smoke._pair_grid(step, st, field.rows, obstacles),
                    cfg.physics)}
    del st, step, field, obstacles
    jam, phys, n = chip_smoke._jam_flat_grid(dev)
    grids["random.toml jam"] = (jam, phys)
    for name, (d, _p) in grids.items():
        print(json.dumps({"grid": name, "shape": list(d.shape),
                          "active": int((d[..., 6] > 0.5).sum())}), flush=True)

    sources = {"change": ROOT}
    if args.parent is not None:
        sources["parent"] = args.parent.resolve()
    libs = {}
    for tag, root in sources.items():
        libs.update(_builds(_build, root, tag, args.sass))
    stream = torch.cuda.current_stream().cuda_stream
    runs = {}
    for gname, (d, phys) in grids.items():
        ny2, nx2, k, _ = d.shape
        consts = torch.tensor(fpk.flat_constants(phys), dtype=torch.float32)
        acc = torch.empty((ny2 * nx2 * k, 2), dtype=torch.float32, device=dev)
        grid = CellGrid(1.4, nx2 - 2, ny2 - 2)
        want = forcepass.dense_pairwise_torch(
            d, grid, k, phys, pass_bytes=chip_smoke.FLAT_TWIN_PASS_BYTES)

        def launch(lib):
            _build.check_launch(lib.pedoni_flat_pairwise(
                d.data_ptr(), acc.data_ptr(), ny2, nx2, k, consts.data_ptr(),
                stream), "pedoni_flat_pairwise")

        for tag, cut in libs.items():
            launch(cut[0])
            torch.cuda.synchronize()
            if not torch.equal(acc.view(torch.int32), want.view(torch.int32)):
                print(f"pair_phases: the {tag} kernel is not bit-equal to its twin "
                      f"on the {gname} grid", file=sys.stderr)
                return 1
        order = ([t for t in libs if t.startswith("parent")]
                 + [t for t in libs if not t.startswith("parent")])
        order = order + order[::-1]  # in turns: ABBA
        for tag in order:
            for p, lib in libs[tag].items():
                ms = chip_smoke._median_ms(lambda: launch(lib))
                runs.setdefault((gname, tag, p), []).append(ms)
                print(json.dumps({"grid": gname, "source": tag,
                                  "phase": PHASES[p], "ms": ms}), flush=True)
        if hasattr(fpk, "flat_pairwise_occupancy"):
            print(json.dumps({"grid": gname, "occupancy":
                              fpk.flat_pairwise_occupancy(d, phys)}), flush=True)
    print(json.dumps({"medians": {f"{g} / {t} / {PHASES[p]}": statistics.median(v)
                                  for (g, t, p), v in runs.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
