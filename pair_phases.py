#!/usr/bin/env python
"""Where a pair kernel's time goes, on one NVIDIA GPU.

    python pair_phases.py [--kernel flat_pairwise|step_pairs] [--parent DIR]
                          [--sass DIR]

``--kernel flat_pairwise`` (the default): the flat step's pair kernel
``csrc/flat_pairwise.cu`` on two padded cell grids of the flat step -- the
1M-agent xla bench problem after FLAT_STEPS steps (chip_smoke.py phase 15's
problem, K 14) and scenarios/random.toml's jammed crowd after chip_smoke.py's
fill of 3000 ticks, as the benchmark's random.tick cell fills it (K 16).

``--kernel step_pairs``: the grid step's pair pass, ``step_pairs`` of
``csrc/step_kernel.cu``, on the grids of ``step_grids``: the bench problem
after GRID_STEPS hybrid steps in the mover mode, at 1M agents (K 14) and
at 250k, and scenarios/random.toml's and scenarios/funnel.toml's grids
after FILL_TICKS ticks of the grid Simulator in the base mode (K 24, the
table grown).  The timed launch is the pair pass alone: each build's entry
point skips its sample pass while ``pedoni_pairs_only`` is set, after one
whole launch has written the sample pass's act' and e/acc.  Every build is
launched in the tiles this tree's ``step_kernel.pair_pass_launch`` picks
(printed as ``tile_rows``), and its whole pass also in one-row and in
two-row tiles, whatever the chooser (``..., 1-row tiles``), so that a
parent's kernel is timed in its own chooser's tiles too.

Each kernel is timed with chip_smoke.py's ``_median_ms`` (CUDA events,
median of 20, each run behind a ~1 ms device spin):

1. the kernel as it is, each build held first bit for bit to its twin
   (forcepass.dense_pairwise_torch; step_kernel.fused_step_torch) on every
   grid;
2. one-off builds cut down to a part of its work (PHASES): the staging
   (and, for the step, the list) alone, with no pair phase; and the
   staging with the pair phase's walk but without its force body; and
   whole builds of the design's variants.  The cuts and variants are string
   edits (KERNELS[...].designs, one entry a design of the kernel,
   recognised by its first cut) of a copy of the source under the build
   directory; a source that holds none of the designs' texts stops the
   script;
3. where the kernel has an occupancy counter
   (``flat_pairwise.flat_pairwise_occupancy``,
   ``step_kernel.step_pairs_occupancy``), its readings on every grid.

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
from types import SimpleNamespace

ROOT = pathlib.Path(__file__).resolve().parent
FLAT_STEPS = 16  # steps of the 1M flat problem before its grid is taken
GRID_STEPS = 16  # hybrid steps of the 1M grid problem, as segments.grid warms up
FILL_TICKS = 3000  # Simulator ticks before a scenario's grid is taken
# what each cut-down build keeps; 0 is the kernel as it is
PHASES = {0: "whole kernel", 1: "staging and boxes (no pair phase)",
          2: "staging and walk (no force body)"}
STEP_PHASES = {0: "whole pair pass", 1: "staging and list (no pair phase)",
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
STEP_DESIGNS = {
    "one thread a listed agent": ([
        ("    for (int base = 0; base < n_live; base += blockDim.x) {\n"
         "      const int i = base + tid;\n"
         "      const bool has = i < n_live;\n"
         "      const int entry = has ? list[i] : 0;\n"
         "      const int k = entry & 255;\n"
         "      const int w = entry >> 13;        // tile row\n",
         "    for (int base = 0; base < (PEDONI_PHASE == 1 ? 0 : n_live);\n"
         "         base += blockDim.x) {\n"
         "      const int i = base + tid;\n"
         "      const bool has = i < n_live;\n"
         "      const int entry = has ? list[i] : 0;\n"
         "      const int k = entry & 255;\n"
         "      const int w = entry >> 13;        // tile row\n"),
        ("\n        while (__any_sync(kFullWarp, hits != 0)) {",
         "\n#if PEDONI_PHASE == 2\n"
         "        accx = accx + (float)__popcll(hits);  // the hits kept, no force body\n"
         "        hits = 0;\n#endif\n"
         "        while (__any_sync(kFullWarp, hits != 0)) {"),
    ], {}),
}
# Edits of every design of the step kernel: the entry point launches the
# pair pass alone while pedoni_pairs_only is set, and takes a shared-memory
# size of -1 as its own design's (all levels staged), so that one launch's
# arguments serve builds of designs whose blocks differ.
STEP_COMMON = [
    ("  if (const int w = pedoni_on_current_device(d)) return w;\n  StepConsts sc;",
     "  if (const int w = pedoni_on_current_device(d)) return w;\n"
     "  if (smem_bytes < 0) smem_bytes = (int)pairs_smem_bytes(tile_rows, k);\n"
     "  StepConsts sc;"),
    ('#include "pair.cuh"\n',
     '#include "pair.cuh"\n\n'
     'extern "C" int pedoni_pairs_only = 0;  // pair_phases.py: no sample pass\n'),
    ("  if (seg)\n    step_sample<true><<<",
     "  if (pedoni_pairs_only) {\n  } else if (seg)\n    step_sample<true><<<"),
]
TILE_ROWS_ARG = 19  # pedoni_step_kernel's arguments tile_rows and smem_bytes
SMEM_ARG = 21
CSRC = pathlib.Path("pedoni_tpu_torch/ops/kernels/csrc")
KERNELS = {
    "flat_pairwise": SimpleNamespace(
        path=CSRC / "flat_pairwise.cu", designs=DESIGNS, common=[],
        phases=PHASES, entry="pedoni_flat_pairwise",
        argtypes=[ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2),
    "step_pairs": SimpleNamespace(
        path=CSRC / "step_kernel.cu", designs=STEP_DESIGNS, common=STEP_COMMON,
        phases=STEP_PHASES, entry="pedoni_step_kernel",
        argtypes=[ctypes.c_void_p] * 9 + [ctypes.c_int] * 18 + [ctypes.c_void_p] * 2),
}
KERNEL = KERNELS["flat_pairwise"].path


def _design(src: str, kernel: str = "flat_pairwise") -> str:
    """The name of the design ``src`` is, by its first cut's text."""
    for name, (cuts, _variants) in KERNELS[kernel].designs.items():
        if cuts[0][0] in src:
            return name
    raise SystemExit(f"{KERNELS[kernel].path.name} is none of the designs of "
                     f"pair_phases.KERNELS[{kernel!r}]; add its cuts")


def _replace(src: str, edits: list[tuple[str, str]], what: str) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"the kernel's source no longer holds the text of "
                             f"{what}: {old!r}")
        src = src.replace(old, new)
    return src


def cut_source(src: str, variant: str | None = None,
               kernel: str = "flat_pairwise") -> str:
    """``src`` with the kernel's common edits and its design's cuts made,
    then a variant's edits."""
    spec = KERNELS[kernel]
    cuts, variants = spec.designs[_design(src, kernel)]
    out = _replace(_replace(src, spec.common, "the common edits"), cuts, "the cuts")
    return out if variant is None else _replace(out, variants[variant], variant)


def _build_libs(build, spec, csrc: pathlib.Path, work: pathlib.Path, src: str,
                phases, tag: str) -> dict[int, ctypes.CDLL]:
    """``src`` built once per phase in ``work``, one nvcc each, all started
    together; prints each build's register and spill lines."""
    work.mkdir(parents=True, exist_ok=True)
    name = spec.path.name
    (work / name).write_text(src)
    for header in csrc.glob("*.cuh"):
        shutil.copy(header, work / header.name)
    procs = {p: subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, f"-DPEDONI_PHASE={p}", "-shared",
         "-o", str(work / f"phase{p}.so"), str(work / name)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for p in phases}
    libs = {}
    for p, proc in procs.items():
        log = proc.communicate(timeout=600)[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {tag} phase {p}:\n{log[-3000:]}")
        info, fn = {}, None
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                fn = ln.split("'")[1] if "'" in ln else ln
            elif fn and ("registers" in ln or "spill" in ln):
                info.setdefault(fn, []).append(ln.split(":", 1)[-1].strip())
        print(json.dumps({"source": tag, "phase": spec.phases[p], "ptxas": info}),
              flush=True)
        lib = ctypes.CDLL(str(work / f"phase{p}.so"))
        getattr(lib, spec.entry).argtypes = spec.argtypes
        getattr(lib, spec.entry).restype = ctypes.c_int
        libs[p] = lib
    return libs


def _builds(build, kernel: str, root: pathlib.Path, tag: str,
            sass: pathlib.Path | None) -> dict[str, dict[int, ctypes.CDLL]]:
    """{tag: every phase's build of ``root``'s kernel, and "tag / variant":
    each variant's whole build}."""
    spec = KERNELS[kernel]
    csrc = root / spec.path.parent
    src = (csrc / spec.path.name).read_text()
    work = build.BUILD_DIR / "pair_phases" / kernel / tag
    out = {tag: _build_libs(build, spec, csrc, work, cut_source(src, None, kernel),
                            spec.phases, tag)}
    for i, variant in enumerate(spec.designs[_design(src, kernel)][1]):
        name = f"{tag} / {variant}"
        try:
            vsrc = cut_source(src, variant, kernel)
        except SystemExit as e:  # a variant of a later state of the design
            print(json.dumps({"source": name, "skipped": str(e)}), flush=True)
            continue
        out[name] = _build_libs(build, spec, csrc, work / f"variant{i}", vsrc,
                                [0], name)
    if sass is not None and shutil.which("cuobjdump"):
        sass.mkdir(parents=True, exist_ok=True)
        text = subprocess.run(["cuobjdump", "-sass", str(work / "phase0.so")],
                              capture_output=True, text=True, timeout=300).stdout
        (sass / f"{kernel}.{tag}.sass").write_text(text)
    return out


def _flat_cases(dev):
    """{grid name: (timed launch of a build, twin check of a build,
    occupancy reading, no other tile shapes)} of the flat pair kernel on
    its two grids."""
    import chip_smoke
    import torch
    from pedoni_tpu_torch.bench import build_problem
    from pedoni_tpu_torch.models import sfm
    from pedoni_tpu_torch.ops import forcepass
    from pedoni_tpu_torch.ops.kernels import _build
    from pedoni_tpu_torch.ops.kernels import flat_pairwise as fpk
    from pedoni_tpu_torch.ops.neighbor import CellGrid

    _sc, maps, cfg, st = build_problem(chip_smoke.N_AGENTS, device=dev, backend="xla")
    field, obstacles = sfm.device_inputs(cfg, maps, dev)
    step = sfm.make_step(cfg)
    for _ in range(FLAT_STEPS):
        st, _m = step(st, field.rows, obstacles)
    grids = {"1M": (chip_smoke._pair_grid(step, st, field.rows, obstacles),
                    cfg.physics)}
    del st, step, field, obstacles
    jam, phys, _n = chip_smoke._jam_flat_grid(dev)
    grids["random.toml jam"] = (jam, phys)
    stream = torch.cuda.current_stream().cuda_stream
    cases = {}
    for gname, (d, phys) in grids.items():
        print(json.dumps({"grid": gname, "shape": list(d.shape),
                          "active": int((d[..., 6] > 0.5).sum())}), flush=True)
        ny2, nx2, k, _ = d.shape
        consts = torch.tensor(fpk.flat_constants(phys), dtype=torch.float32)
        acc = torch.empty((ny2 * nx2 * k, 2), dtype=torch.float32, device=dev)
        want = forcepass.dense_pairwise_torch(
            d, CellGrid(1.4, nx2 - 2, ny2 - 2), k, phys,
            pass_bytes=chip_smoke.FLAT_TWIN_PASS_BYTES)

        def launch(lib, d=d, acc=acc, consts=consts, dims=(ny2, nx2, k)):
            _build.check_launch(lib.pedoni_flat_pairwise(
                d.data_ptr(), acc.data_ptr(), *dims, consts.data_ptr(), stream),
                "pedoni_flat_pairwise")

        def same(lib, launch=launch, acc=acc, want=want):
            launch(lib)
            torch.cuda.synchronize()
            return torch.equal(acc.view(torch.int32), want.view(torch.int32))

        cases[gname] = (launch, same,
                        lambda d=d, phys=phys: fpk.flat_pairwise_occupancy(d, phys), ())
    return cases


GRIDS = ("1M open field", "250k open field", "random.toml", "funnel.toml")


def step_grids(dev, names=GRIDS) -> dict:
    """{name: (d, fwp, fobs, kw)} of the grid step's cells' grids, those of
    ``names``: ``fused_step(d, fwp, fobs, **kw)`` is the step kernel's
    launch there.  The bench problem after GRID_STEPS hybrid steps, in the
    mover mode, as the hybrid runs it: 1M agents (open1M.grid's scale, K
    14) and 250k (a uniform crowd whose two-row grid of blocks is about as
    small as random.toml's); random.toml's and funnel.toml's grids after
    FILL_TICKS ticks of the grid Simulator, in the base mode of its full
    path (each grows its table to K 24 in them)."""
    import chip_smoke
    from pedoni_tpu_torch import Simulator, SimulatorOptions, load_scenario
    from pedoni_tpu_torch.bench import build_problem
    from pedoni_tpu_torch.models import sfm_grid

    def kw(cfg, mk, row_block=2):
        return dict(phys=cfg.physics, grid_size=cfg.scenario.size,
                    stride=sfm_grid.stride_for(cfg), field_unit=cfg.field_unit,
                    emit_movers=mk, row_block=row_block)

    grids = {}
    for name, n in (("1M open field", chip_smoke.N_AGENTS),
                    ("250k open field", 250_000)):
        if name not in names:
            continue
        _sc, maps, cfg, flat = build_problem(n, device=dev)
        fwp, fobs = sfm_grid.field_tensors(cfg, maps, dev)
        step = sfm_grid.make_step_grid(cfg, incremental=True)
        gs = sfm_grid.bin_state(cfg, flat)
        for _ in range(GRID_STEPS):
            gs, _m = step(gs, fwp, fobs)
        grids[name] = (gs.d, fwp, fobs, kw(cfg, min(8, cfg.table_capacity)))
    for name, path in (("random.toml", chip_smoke.RANDOM),
                       ("funnel.toml", ROOT / "scenarios" / "funnel.toml")):
        if name not in names:
            continue
        sim = Simulator(SimulatorOptions(backend="grid", device=dev.type, seed=1,
                                         neighbor_grid_unit=1.5,
                                         field_grid_unit=0.25, table_capacity=16),
                        load_scenario(path))
        sim.run(FILL_TICKS)
        grids[name] = (sim.state.d.clone(), sim._fwp, sim._fobs,
                       kw(sim.cfg, 0, sim.options.row_block))
    return grids


def _own_smem(launch: tuple) -> tuple:
    """``step_kernel._launch_args``'s (outputs, arguments, held) with the
    shared memory left to each build (-1: STEP_COMMON)."""
    outs, args, held = launch
    return outs, (*args[:SMEM_ARG], -1, *args[SMEM_ARG + 1:]), held


def _step_cases(dev):
    """{grid name: (timed launch, twin check, occupancy reading, the tile
    rows each whole pass is timed in besides)} of the step kernel's pair
    pass on ``step_grids``."""
    import torch
    from pedoni_tpu_torch.ops.kernels import _build
    from pedoni_tpu_torch.ops.kernels import step_kernel as sk

    cases = {}
    for gname, (d, fwp, fobs, kw) in step_grids(dev).items():
        print(json.dumps({"grid": gname, "shape": list(d.shape),
                          "active": int((d[:, :, 6] > 0.5).sum()), "mode":
                          "movers" if kw["emit_movers"] else "base",
                          "tile_rows": sk.pair_pass_launch(d.shape[1], d.shape[0],
                                                           d.shape[3])[0]}),
              flush=True)
        want = sk.fused_step_torch(d, fwp, fobs, **kw)
        want = want if isinstance(want, tuple) else (want,)
        args = [kw[a] for a in ("phys", "grid_size", "stride", "field_unit",
                                "emit_movers", "row_block")]
        timed = _own_smem(sk._launch_args(d, fwp, fobs, *args, None, 0, 0, None))

        def launch(lib, rows=None, timed=timed, primed=set()):
            """The pair pass of ``lib`` on this grid, in the tiles the
            chooser picks or in tiles of ``rows`` rows."""
            a = timed[1] if rows is None else (
                *timed[1][:TILE_ROWS_ARG], rows, *timed[1][TILE_ROWS_ARG + 1:])
            only = ctypes.c_int.in_dll(lib, "pedoni_pairs_only")
            if id(lib) not in primed:  # act' and e/acc written once
                only.value = 0
                _build.check_launch(lib.pedoni_step_kernel(*a), "pedoni_step_kernel")
                primed.add(id(lib))
            only.value = 1
            _build.check_launch(lib.pedoni_step_kernel(*a), "pedoni_step_kernel")

        def same(lib, want=want, d=d, fwp=fwp, fobs=fobs, args=args):
            outs, fresh, _held = _own_smem(sk._launch_args(d, fwp, fobs, *args,
                                                           None, 0, 0, None))
            ctypes.c_int.in_dll(lib, "pedoni_pairs_only").value = 0
            _build.check_launch(lib.pedoni_step_kernel(*fresh), "pedoni_step_kernel")
            torch.cuda.synchronize()
            return all(torch.equal(a, b) for a, b in zip(outs, want))

        cases[gname] = (launch, same, lambda d=d, fwp=fwp, fobs=fobs, kw=kw: (
            sk.step_pairs_occupancy(d, fwp, fobs, **kw)),
            (1, 2) if d.shape[0] > 3 else ())
    return cases


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=list(KERNELS), default="flat_pairwise")
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
    from pedoni_tpu_torch.ops.kernels import _build

    dev = torch.device("cuda")
    print(chip_smoke._card(), flush=True)
    spec = KERNELS[args.kernel]
    cases = (_flat_cases if args.kernel == "flat_pairwise" else _step_cases)(dev)
    sources = {"change": ROOT}
    if args.parent is not None:
        sources["parent"] = args.parent.resolve()
    libs = {}
    for tag, root in sources.items():
        libs.update(_builds(_build, args.kernel, root, tag, args.sass))
    runs = {}
    for gname, (launch, same, occupancy, tile_rows) in cases.items():
        for tag, cut in libs.items():
            if not same(cut[0]):
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
                                  "phase": spec.phases[p], "ms": ms}), flush=True)
                for rows in tile_rows if p == 0 else ():  # each tile shape
                    ms = chip_smoke._median_ms(lambda: launch(lib, rows))
                    runs.setdefault((gname, f"{tag}, {rows}-row tiles", p),
                                    []).append(ms)
        print(json.dumps({"grid": gname, "occupancy": occupancy()}), flush=True)
    print(json.dumps({"medians": {f"{g} / {t} / {spec.phases[p]}": statistics.median(v)
                                  for (g, t, p), v in runs.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
