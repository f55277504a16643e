#!/usr/bin/env python
"""Milliseconds a tick of the flat step on the CPU (the CLI's ``-b cpu``),
for the port or the reference, on scenario files.

    python cpu_ticks.py scenarios/zigzag.toml scenarios/funnel.toml \
        [--package pedoni_tpu_torch | pedoni_tpu] [--root DIR] \
        [--pass-bytes N [N ...]] [--warmup 3] [--ticks 8] [--seed 0]

Builds ``Simulator(SimulatorOptions(backend="xla", seed=SEED))`` of the
package named on each scenario (the port's with ``device="cpu"``, the
reference's under ``JAX_PLATFORMS=cpu``), runs ``--warmup`` ticks, then
times ``--ticks`` more on the host clock; a tick reads its metrics back, so
each ends synchronised.  ``--root DIR`` imports the package from another
checkout (an unpacked parent commit, say).  ``--pass-bytes`` sets the
port's CPU pair-pass budget (``ops.forcepass.PAIR_PASS_BYTES``), one run
per value.  Threads: torch's and XLA's defaults (all cores).  Prints a line
a run and then one JSON object with every run.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import pathlib
import sys
import time


def _run(pkg, path: str, seed: int, warmup: int, ticks: int) -> dict:
    opts = {"backend": "xla", "seed": seed}
    if pkg.__name__ == "pedoni_tpu_torch":
        opts["device"] = "cpu"
    sim = pkg.Simulator(pkg.SimulatorOptions(**opts), pkg.load_scenario(path))
    for _ in range(warmup):
        sim.tick()
    t0 = time.perf_counter()
    for _ in range(ticks):
        rec = sim.tick()
    ms = (time.perf_counter() - t0) / ticks * 1e3
    return {"ms_per_tick": ms, "active": int(rec.active_ped_count)}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scenarios", nargs="+")
    ap.add_argument("--package", default="pedoni_tpu_torch",
                    choices=("pedoni_tpu_torch", "pedoni_tpu"))
    ap.add_argument("--root", default=None,
                    help="import the package from this checkout")
    ap.add_argument("--pass-bytes", type=int, nargs="*", default=[],
                    help="the port's CPU pair-pass budgets to run (bytes)")
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--ticks", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.package == "pedoni_tpu":
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
    if args.root:
        sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    pkg = importlib.import_module(args.package)
    budgets = args.pass_bytes or [None]
    if args.pass_bytes and args.package != "pedoni_tpu_torch":
        ap.error("--pass-bytes sets the port's budget")
    runs = []
    for path in args.scenarios:
        for budget in budgets:
            if budget is not None:
                importlib.import_module(f"{args.package}.ops.forcepass"
                                        ).PAIR_PASS_BYTES = budget
            rec = {"package": args.package, "root": args.root or ".",
                   "scenario": path, "pass_bytes": budget,
                   **_run(pkg, path, args.seed, args.warmup, args.ticks)}
            print(f"# {args.package} ({rec['root']}) {path}, pass bytes "
                  f"{budget or 'default'}: {rec['ms_per_tick']:.1f} ms/tick "
                  f"({args.ticks} ticks after {args.warmup}), {rec['active']} "
                  f"active", flush=True)
            runs.append(rec)
    print(json.dumps({"cpu_count": os.cpu_count(), "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
