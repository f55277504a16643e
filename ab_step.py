#!/usr/bin/env python
"""Time the step and rebin kernels of two checkouts in turns on one NVIDIA GPU.

    python ab_step.py --parent DIR

``DIR`` holds another checkout of this repository (``git archive <commit>
| tar -x -C DIR``).  Each tree runs in a process of its own, in the order
parent, change, change, parent, so that both see the same card and the
drift between turns shows.  A turn builds that tree's kernels, sets up the
1M-agent bench problem, runs the full-rebin path and the hybrid for
chip_smoke.py's warm-up and timed steps (host clock around a synchronised
run), and times the kernels on each path's final state with chip_smoke.py's
``_median_ms``: ``fused_step`` in base mode and ``rebin`` on its output on
the full path's, ``fused_step`` in mover mode and ``rebin_incremental`` on
its output on the hybrid's.  Then the same again for the same agents at the
all-pairs unit (2.0 m cells, K 25, field stride 8; keys ``all_pairs_*``).

Prints one JSON line per turn and a summary with the card's name and power
limit.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent


def worker(tree: str) -> int:
    """One turn, in the tree given: prints its JSON line.  The timing
    helpers are this checkout's chip_smoke.py's for both trees; the port
    under test is ``tree``'s."""
    import torch

    import chip_smoke  # before the path changes: this checkout's
    sys.path[:] = [tree] + [p for p in sys.path if p not in ("", str(HERE))]

    from pedoni_tpu_torch import SimulatorOptions
    from pedoni_tpu_torch.bench import build_problem
    from pedoni_tpu_torch.models import sfm_grid
    from pedoni_tpu_torch.models.sfm import StepConfig
    from pedoni_tpu_torch.ops.kernels import _build
    from pedoni_tpu_torch.ops.kernels import rebin as rb
    from pedoni_tpu_torch.ops.kernels import step_kernel as sk

    dev = torch.device("cuda")
    _build.library()
    scenario, maps, cfg, flat = build_problem(chip_smoke.N_AGENTS, device=dev)
    # the same agents at the all-pairs unit (2.0 m, K 25, field stride 8)
    o = SimulatorOptions(neighbor_grid_unit=1.5, table_capacity=14,
                         use_neighbor_grid=False).resolved()
    wide = StepConfig.build(scenario, capacity=cfg.capacity,
                            neighbor_grid_unit=o.neighbor_grid_unit,
                            table_capacity=o.table_capacity,
                            use_neighbor_grid=False)
    res = {"tree": tree}
    for prefix, c in (("", cfg), ("all_pairs_", wide)):
        fwp, fobs = sfm_grid.field_tensors(c, maps, dev)
        phys, size, stride = c.physics, c.scenario.size, sfm_grid.stride_for(c)
        states = {}
        for name, incremental in (("full", False), ("hybrid", True)):
            step = sfm_grid.make_step_grid(c, incremental=incremental)
            gs, m, ms = chip_smoke._run_timed(step, sfm_grid.bin_state(c, flat),
                                              fwp, fobs)
            res[f"{prefix}{name}_ms_per_step"] = ms
            res[f"{prefix}{name}_active"] = int(m.n_active)
            states[name] = gs.d

        def fused(name, **kw):
            return sk.fused_step(states[name], fwp, fobs, phys, size,
                                 stride=stride, **kw)

        unit, nx, ny = c.grid.unit, c.grid.nx, c.grid.ny
        g = fused("full")
        g_mv, m_mv = fused("hybrid", emit_movers=8)[:2]
        for key, fn in (
                ("step_kernel_ms", lambda: fused("full")),
                ("step_kernel_movers_ms", lambda: fused("hybrid", emit_movers=8)),
                ("rebin_ms", lambda: rb.rebin(g, unit, nx, ny)),
                ("rebin_incremental_ms",
                 lambda: rb.rebin_incremental(g_mv, m_mv, unit, nx, ny))):
            res[prefix + key] = chip_smoke._median_ms(fn)
    print(json.dumps(res), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="directory of the other checkout")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args.worker)
    import torch
    if not torch.cuda.is_available():
        print("ab_step: no CUDA device", file=sys.stderr)
        return 2
    if not args.parent:
        ap.error("--parent is required")
    import chip_smoke
    parent = str(pathlib.Path(args.parent).resolve())
    card = chip_smoke._card()
    print(card, flush=True)
    turns = []
    for label, tree in (("parent", parent), ("change", str(HERE)),
                        ("change", str(HERE)), ("parent", parent)):
        r = subprocess.run([sys.executable, __file__, "--worker", tree],
                           cwd=tree, capture_output=True, text=True,
                           timeout=1200)
        if r.returncode != 0:
            print(r.stdout[-2000:], r.stderr[-4000:], file=sys.stderr)
            return 1
        line = json.loads(r.stdout.strip().splitlines()[-1])
        line["turn"] = label
        turns.append(line)
        print(json.dumps(line), flush=True)
    keys = ("step_kernel_ms", "step_kernel_movers_ms", "rebin_ms",
            "rebin_incremental_ms", "full_ms_per_step", "hybrid_ms_per_step")
    for k in (*keys, *("all_pairs_" + k for k in keys)):
        p = [t[k] for t in turns if t["turn"] == "parent"]
        c = [t[k] for t in turns if t["turn"] == "change"]
        print(f"# {k}: parent {p[0]:.4f}, {p[1]:.4f}; change {c[0]:.4f}, "
              f"{c[1]:.4f}; change/parent {statistics.mean(c) / statistics.mean(p):.4f}"
              f" on {card}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
