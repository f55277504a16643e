#!/usr/bin/env python
"""Where the flat sample kernel's time goes, on one NVIDIA GPU.

    python sample_phases.py [--parent DIR]

On the 1M-agent xla bench problem (chip_smoke.py phase 15's run, whose
flat step is captured) it times ``csrc/flat_sample.cu`` with CUDA events,
the median of RUNS runs, each behind chip_smoke.py's ~1 ms device spin:

1. states: the captured sorted state (the step's own arguments: pos and
   vel from the last step's flat_integrate, speed, dest and active from
   its flat_scatter), the same with speed read from a column of a
   [C, 12] tensor (as the step read it before flat_scatter wrote a
   contiguous speed), the same with pos, vel and speed read from the
   columns of one [C, 12] tensor (as the x-strips' state is), with speed
   alone contiguous, and the problem's unsorted agents before their
   first step;
2. one-off builds of the kernel cut down to a part of its work (PHASES):
   no taps (every agent reads one fixed texel), the state and tap loads
   without the row and cell-id stores, the stores alone (no loads); and
   whole builds of the design's variants (DESIGNS: agents a thread,
   register caps, no streaming hints, unstaged row stores, a grid of the
   blocks the card holds at once).  The edits are made in a copy of the
   source under the build directory; a source that no longer holds the
   text they replace stops the script.  Every whole build is first held
   bit for bit to the twin (sampling.flat_sample_torch) on every state;
3. the L2 before each run (TEMPS): "warm", run after run as chip_smoke.py
   times it; "cold", after a 64 MB scratch write; "hot", after a copy of
   pos and vel into the arguments; "step", on the state the step's own
   flat_integrate launch writes just before (its pos and vel, the speed
   of the rows it read);
4. each whole build followed by the step's sort and flat_scatter, timed
   together (the scatter reads the rows the sample wrote);
5. yardsticks: a ``copy_`` that moves as many bytes (read and written) as
   the kernel must with its taps counted in 32-byte sectors, and
   ``torch.nn.functional.grid_sample`` of the field's six channels at the
   agents' points (the taps alone), with the taps' footprint: distinct
   texel rows, 32-byte sectors, 64-byte pieces and 128-byte lines.

With ``--parent DIR`` (a checkout of another commit) the cut builds of its
``csrc/flat_sample.cu`` are timed too, in turns with this tree's (parent,
change, change, parent).

Prints the card's name and power limit, then one JSON line per timing.
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import statistics
import subprocess
import sys

RUNS = 20
SCRATCH_BYTES = 64 << 20  # more than the H100's 50 MB L2
# what each cut-down build keeps; 0 is the kernel as it is
PHASES = {0: "whole kernel", 1: "no taps (one fixed texel)",
          2: "state and tap loads, no stores", 3: "stores alone (no loads)"}
TEMPS = ("warm", "cold", "hot", "step")
STRIDED = "sorted, speed at a 48-byte stride"
STRIPS = "sorted, pos, vel and speed at a 48-byte stride (the strips' state)"
# Each design's cuts, (old, new) pairs of source text under the name of
# the design, and its variants, built whole (phase 0) beside the design as
# it is; a design is recognised by its first cut's old text.
_KEEP = ("  const float keep = x{j} + y{j} + {vx} + {vy} + {sp} + (float)d{j} +\n"
         "                     (ok ? 1.0f : 0.0f) + ex + ey + v[3] + v[4] + v[5];\n"
         "  if (keep == 1.5e-45f) cid[0] = 0;  // never: keeps the loads\n")
_OLD_STORES = ("  float4* out = reinterpret_cast<float4*>(packed + a * 12);\n"
               "  out[0] = make_float4(x, y, vx, vy);\n"
               "  out[1] = make_float4(sp, (float)d, ok ? 1.0f : 0.0f, ex);\n"
               "  out[2] = make_float4(ey, v[3], v[4], v[5]);\n")
_NEW_STORES = """      st[3 * lane] = make_float4(x[j], y[j], wx, wy);
      st[3 * lane + 1] = make_float4(w, (float)d[j], ok ? 1.0f : 0.0f, ex);
      st[3 * lane + 2] = make_float4(ey, v[3], v[4], v[5]);
      __syncwarp();
      const int64_t w0 = b0 + j * kThreads + (threadIdx.x & ~31);
      const int64_t m = n - w0 < 32 ? n - w0 : 32;  // the warp's agents, may be <= 0
      float4* out = reinterpret_cast<float4*>(packed) + w0 * 3;
      for (int q = lane; q < 3 * m; q += 32) store_out(out + q, st[q]);
      __syncwarp();
      const int64_t a = w0 + lane;
      if (a < n) store_out(cid + a, ok ? (int)cy * nx + (int)cx : nx * ny);
"""
_NEW_LOADS = """      x[j] = load_state(pos + i * s.pos0);
      y[j] = load_state(pos + i * s.pos0 + s.pos1);
      d[j] = load_state(dest + i * s.dest);
      vx[j] = load_state(vel + i * s.vel0);
      vy[j] = load_state(vel + i * s.vel0 + s.vel1);
      sp[j] = load_state(speed + i * s.speed);
      act[j] = load_state(active + i * s.active);
"""
_NEW_TAPS = """        lo[j][q] = __ldg(r4 + 2 * tap[q]);
        hi[j][q] = __ldg(reinterpret_cast<const float2*>(r4 + 2 * tap[q] + 1));
"""
def _agents(k: int) -> tuple[str, str]:
    return ("constexpr int kAgents = 2;", f"constexpr int kAgents = {k};")


def _blocks(m: int) -> tuple[str, str]:
    return ("__global__ void __launch_bounds__(kThreads)\n",
            f"__global__ void __launch_bounds__(kThreads, {m})\n")


DESIGNS = {
    "one agent a thread (PR 14)": ([
        ("  const int64_t base = ((int64_t)d * hp + (int64_t)by) * wp + (int64_t)bx;",
         "#if PEDONI_PHASE == 1\n  const int64_t base = 0;\n#else\n"
         "  const int64_t base = ((int64_t)d * hp + (int64_t)by) * wp + (int64_t)bx;\n"
         "#endif"),
        ("  if (a >= n) return;\n",
         "  if (a >= n) return;\n#if PEDONI_PHASE == 3\n  {\n"
         "    const float f = (float)a;\n"
         "    float4* o = reinterpret_cast<float4*>(packed + a * 12);\n"
         "    o[0] = make_float4(f, f, f, f);\n    o[1] = o[0];\n    o[2] = o[0];\n"
         "    cid[a] = (int)a;\n    return;\n  }\n#endif\n"),
        ("  cid[a] = ok ? (int)cy * nx + (int)cx : nx * ny;\n",
         "#if PEDONI_PHASE != 2\n  cid[a] = ok ? (int)cy * nx + (int)cx : nx * ny;\n"
         "#endif\n"),
        (_OLD_STORES, "#if PEDONI_PHASE == 2\n"
         + _KEEP.format(j="", vx="vx", vy="vy", sp="sp") + "#else\n" + _OLD_STORES
         + "#endif\n"),
    ], {}),
    "several agents a thread, staged rows (PR 16)": ([
        ("      const int64_t base = ((int64_t)d[j] * hp + (int64_t)by) * wp + "
         "(int64_t)bx;",
         "#if PEDONI_PHASE == 1\n      const int64_t base = 0;\n#else\n"
         "      const int64_t base = ((int64_t)d[j] * hp + (int64_t)by) * wp + "
         "(int64_t)bx;\n#endif"),
        (_NEW_LOADS, "#if PEDONI_PHASE == 3\n      x[j] = y[j] = vx[j] = vy[j] = "
         "sp[j] = (float)i;\n      d[j] = 0;\n      act[j] = 1;\n#else\n"
         + _NEW_LOADS + "#endif\n"),
        (_NEW_TAPS, "#if PEDONI_PHASE == 3\n        lo[j][q] = make_float4(tx[j], "
         "ty[j], tx[j], ty[j]);\n        hi[j][q] = make_float2(tx[j], ty[j]);\n"
         "#else\n" + _NEW_TAPS + "#endif\n"),
        (_NEW_STORES, "#if PEDONI_PHASE == 2\n"
         + _KEEP.format(j="[j]", vx="wx", vy="wy", sp="w").replace("  ", "      ", 2)
         .replace("\n  if", "\n      if") + "#else\n" + _NEW_STORES + "#endif\n"),
    ], {
        "1 agent a thread": [_agents(1)],
        "4 agents a thread": [_agents(4)],
        "2 agents a thread, at least 3 blocks an SM": [_blocks(3)],
        "2 agents a thread, at least 4 blocks an SM": [_blocks(4)],
        "1 agent a thread, at least 8 blocks an SM": [_agents(1), _blocks(8)],
        "4 agents a thread, at least 2 blocks an SM": [_agents(4), _blocks(2)],
        "plain loads and stores (no streaming hints)": [
            ("  return __ldcs(p);", "  return *p;"), ("  __stcs(p, v);", "  *p = v;")],
        "row stores unstaged (three float4 a thread)": [(_NEW_STORES, """\
      const int64_t a = b0 + j * kThreads + threadIdx.x;
      if (a < n) {
        float4* out = reinterpret_cast<float4*>(packed) + a * 3;
        store_out(out, make_float4(x[j], y[j], wx, wy));
        store_out(out + 1, make_float4(w, (float)d[j], ok ? 1.0f : 0.0f, ex));
        store_out(out + 2, make_float4(ey, v[3], v[4], v[5]));
        store_out(cid + a, ok ? (int)cy * nx + (int)cx : nx * ny);
      }
""")],
        "the blocks the card holds at once, walking the agents": [(
            "  const int64_t blocks = (n + kBlockAgents - 1) / kBlockAgents;",
            """\
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, flat_sample_kernel,
                                                kThreads, 0);
  const int64_t need = (n + kBlockAgents - 1) / kBlockAgents;
  const int64_t blocks = need < sms * per_sm ? need : sms * per_sm;""")],
    }),
}


def _design(src: str) -> str:
    for name, (cuts, _variants) in DESIGNS.items():
        if src.count(cuts[0][0]) == 1:
            return name
    raise SystemExit("flat_sample.cu holds none of the designs sample_phases.py "
                     "knows how to cut")


def _replace(src: str, pairs, what: str) -> str:
    for old, new in pairs:
        if src.count(old) != 1:
            raise SystemExit(f"{what}: flat_sample.cu no longer holds the text to "
                             f"replace: {old!r}")
        src = src.replace(old, new)
    return src


def _cut_builds(build, csrc: pathlib.Path, tag: str) -> tuple[str, dict, dict]:
    """(design, {(variant, phase): library}, {variant: ptxas' lines}) of the
    builds of ``csrc``/flat_sample.cu: the design as it is in every phase,
    each variant whole; one nvcc each, all started together, under the
    build directory's ``sample_phases/tag``."""
    src = (csrc / "flat_sample.cu").read_text()
    design = _design(src)
    cuts, variants = DESIGNS[design]
    work = build.BUILD_DIR / "sample_phases" / tag
    work.mkdir(parents=True, exist_ok=True)
    for header in csrc.glob("*.cuh"):
        (work / header.name).write_text(header.read_text())
    jobs = {}
    for v, (name, pairs) in enumerate([("as it is", []), *variants.items()]):
        cu = work / f"v{v}.cu"
        cu.write_text(_replace(_replace(src, cuts, name), pairs, name))
        for p in (PHASES if v == 0 else (0,)):
            so = work / f"v{v}_phase{p}.so"
            jobs[(name, p)] = (so, subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, f"-DPEDONI_PHASE={p}", "-shared",
                 "-o", str(so), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, ptxas = {}, {}
    for (name, p), (so, proc) in jobs.items():
        log = proc.communicate(timeout=600)[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {tag} {name} phase {p}:\n{log[-3000:]}")
        if p == 0:
            ptxas[name] = " | ".join(line.strip() for line in log.splitlines()
                                     if "registers" in line or "spill" in line)
        libs[(name, p)] = ctypes.CDLL(str(so))
        libs[(name, p)].pedoni_flat_sample.argtypes = \
            build.library().pedoni_flat_sample.argtypes
        libs[(name, p)].pedoni_flat_sample.restype = ctypes.c_int
    return design, libs, ptxas


def _timed(run, prep=None, n: int = RUNS) -> float:
    """Median device ms of ``run(prep())`` (``run(None)`` without ``prep``)
    over ``n`` runs; ``prep`` runs on the card after the spin and before the
    first event, so it sets the L2 the run finds but is not timed."""
    import torch

    import chip_smoke
    run(prep() if prep else None)  # warm
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(chip_smoke.SPIN_CYCLES)
        x = prep() if prep else None
        a.record()
        run(x)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=pathlib.Path, default=None,
                    help="a checkout of another commit whose kernel is timed too")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("sample_phases: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from pedoni_tpu_torch.ops.kernels import _build
    from pedoni_tpu_torch.ops.kernels import flat_integrate as fik
    from pedoni_tpu_torch.ops.kernels import flat_sample as fsk
    from pedoni_tpu_torch.ops.kernels import flat_scatter as fck
    from pedoni_tpu_torch.ops.sampling import flat_sample_torch

    dev = torch.device("cuda")
    card = chip_smoke._card()
    print(card, flush=True)

    def emit(**kw):
        print(json.dumps(kw), flush=True)

    cap = {}
    res = chip_smoke._flat_1m(dev, card, capture=cap)
    emit(what="in-step us/step and launches a step (profile, chip_smoke.py "
         "phase 15)", us=res["kernel_us"], launches=res["kernel_profile_launches"],
         device_ms_per_step=res["device_ms_per_step"])
    sample_args, kw = cap["sample"]
    if kw:
        raise SystemExit(f"the step called flat_sample with {kw}")
    rows, hp, wp, pos, vel, speed, dest, active, unit, despawn, grid = sample_args
    init = cap["initial"]
    strided = torch.zeros((speed.shape[0], 12), dtype=speed.dtype, device=dev)
    strided[:, 0:2], strided[:, 2:4], strided[:, 4] = pos, vel, speed
    states = {
        "sorted": (pos, vel, speed, dest, active),
        STRIDED: (pos, vel, strided[:, 4], dest, active),
        STRIPS: (strided[:, 0:2], strided[:, 2:4], strided[:, 4], dest, active),
        STRIPS + ", speed contiguous": (strided[:, 0:2], strided[:, 2:4], speed, dest,
                                        active),
        "unsorted": (init.pos, init.vel, init.speed, init.dest, init.active)}
    n = pos.shape[0]
    # the step state: the flat_integrate launch that writes it, timed apart
    irgs, ikw = cap["integrate"]
    srows = irgs[0]
    s_speed, s_dest = srows[:, 4].contiguous(), srows[:, 5].to(torch.int32)
    s_active = srows[:, 6] > 0.5

    builds = {"change": _cut_builds(_build, _build.CSRC, "change")}
    if args.parent is not None:
        builds["parent"] = _cut_builds(
            _build, args.parent / "pedoni_tpu_torch" / "ops" / "kernels" / "csrc",
            "parent")
    for tree, (design, _libs, ptxas) in builds.items():
        emit(tree=tree, design=design, ptxas=ptxas)
    packed = torch.empty((n, 12), dtype=torch.float32, device=dev)
    cid = torch.empty((n,), dtype=torch.int32, device=dev)
    scratch = torch.empty((SCRATCH_BYTES,), dtype=torch.uint8, device=dev)

    def launcher(lib, state):
        p_, v_, s_, d_, a_ = state

        def run(_x=None):
            _build.check_launch(fsk.launch(lib, rows, hp, wp, p_, v_, s_, d_, a_, unit,
                                           despawn, grid, True, packed, cid),
                                "pedoni_flat_sample")
        return run

    # every whole-kernel build equals the twin bit for bit, on every state
    for tree, (_d, libs, _p) in builds.items():
        for (variant, phase), lib in libs.items():
            if phase:
                continue
            for name, state in states.items():
                want, wcid = flat_sample_torch(rows, hp, wp, *state, unit, despawn,
                                               grid)
                launcher(lib, state)()
                torch.cuda.synchronize()
                try:
                    chip_smoke._same_bits(packed, want)
                except AssertionError as e:
                    raise AssertionError(f"{tree} {variant} on {name}: {e}") from None
                if not torch.equal(cid, wcid):
                    raise AssertionError(f"{tree} {variant} on {name}: cell ids differ")

    def prep_for(temp, state):
        if temp == "cold":
            return lambda: scratch.fill_(1)
        if temp == "hot":
            p_, v_ = state[0], state[1]
            src_p, src_v = p_.clone(), v_.clone()
            return lambda: (p_.copy_(src_p), v_.copy_(src_v))
        return None

    def step_run(lib):
        """(prep, run) of the step temperature: the integrate launch, then
        the sample on its outputs."""
        def prep():
            return fik.flat_integrate(*irgs, **ikw)

        def run(pv):
            _build.check_launch(
                fsk.launch(lib, rows, hp, wp, pv[0], pv[1], s_speed, s_dest,
                           s_active, unit, despawn, grid, True, packed, cid),
                "pedoni_flat_sample")
        return prep, run

    def chain(lib):
        """The sample, then the step's sort and flat_scatter of its output,
        timed together (the scatter reads the rows the sample wrote)."""
        run = launcher(lib, states["sorted"])

        def go(_x):
            run()
            order = torch.argsort(cid, stable=True)[:cap_c]
            fck.flat_scatter(packed, cid, order, grid, k)
        return go

    cap_c, k = cap["scatter"][0][2].shape[0], cap["scatter"][0][4]
    order = ["parent", "change", "change", "parent"] if "parent" in builds else ["change"]
    turns = {}
    for turn, tree in enumerate(order):
        for (variant, phase), lib in builds[tree][1].items():
            cases = []
            for name, state in states.items():
                for temp in TEMPS:
                    if temp == "step" and name == "sorted":
                        cases.append((name, temp, *step_run(lib)))
                    elif temp in ("warm", "cold") or temp == "hot" and name in (
                            "sorted", "unsorted"):
                        cases.append((name, temp, prep_for(temp, state),
                                      launcher(lib, state)))
            if phase == 0:
                cases.append(("sorted", "warm, with the step's sort and flat_scatter "
                              "after it", None, chain(lib)))
            if phase or variant != "as it is":  # the cuts and variants: fewer cases
                cases = [c for c in cases if c[0] == "sorted" and c[1] != "hot"]
            for name, temp, prep, run in cases:
                ms = _timed(run, prep)
                turns.setdefault((tree, variant, phase, name, temp), []).append(ms)
                emit(tree=tree, turn=turn, variant=variant, phase=PHASES[phase],
                     state=name, l2=temp, ms=ms)
    for (tree, variant, phase, name, temp), ms in turns.items():
        if len(ms) > 1:
            emit(tree=tree, variant=variant, phase=PHASES[phase], state=name, l2=temp,
                 ms_mean_of_turns=sum(ms) / len(ms))

    # the step temperature's prep alone, and the sort and scatter of the chain
    emit(what="flat_integrate launch alone (the step temperature's prep)",
         ms=_timed(lambda _x: fik.flat_integrate(*irgs, **ikw)))
    emit(what="the step's sort and flat_scatter alone (the chain less the sample)",
         ms=_timed(lambda _x: fck.flat_scatter(
             packed, cid, torch.argsort(cid, stable=True)[:cap_c], grid, k)))
    # yardsticks
    for name, state in states.items():
        if name not in ("sorted", "unsorted"):
            continue
        p_, v_, s_, d_, a_ = state
        foot = chip_smoke._tap_footprint(rows, hp, wp, p_, d_, unit)
        need = chip_smoke._needed_bytes(
            "flat_sample", (rows, hp, wp, p_, v_, s_, d_, a_, unit), (packed, cid))
        moved = (chip_smoke._nbytes(p_, v_, s_, d_, a_, packed, cid)
                 + foot["sectors_32"] * 32)
        src = torch.empty((moved // 2,), dtype=torch.uint8, device=dev)
        dst = torch.empty_like(src)
        copy_ms = _timed(lambda _x: dst.copy_(src))
        del src, dst
        gs, gs_err = chip_smoke._grid_sample_call((rows, hp, wp, *state, unit,
                                                   despawn, grid))
        gs_ms = _timed(lambda _x: gs())
        bound_ms, by = chip_smoke._bound(need, n * chip_smoke.FLAT_SAMPLE_FLOPS)
        emit(state=name, footprint=foot, needed_mb=need / 1e6, bound_ms=bound_ms,
             bound_by=by, bytes_with_sectors_mb=moved / 1e6,
             bytes_with_sectors_ms=moved / chip_smoke.HBM_BYTES_PER_S * 1e3,
             copy_same_bytes_ms=copy_ms, grid_sample_ms=gs_ms,
             grid_sample_max_abs_err=gs_err)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
