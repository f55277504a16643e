"""The readings that a cell's limits are set from, apart from the
benchmark's own runs: the program's numbers and the controls', at the
cell's own size, over several seeds in one process.

    python benchmark/control.py --workload <cell> --seeds 1 2 3

For each seed the cell is set up as its driver sets it up (``setup``) and
the program takes the step (tick) that the window starts with
(``first_check``).  The same input is then stepped by the plain reference
in the program's place, at lower precisions than the float32 that the
configurations state (the controls, which have to fail):

- ``bf16``: all of it in bfloat16, the state too;
- ``bf16_terms``: the state, the field taps, the Sobels and the pair
  offsets in float32; the directions, the forces, their sums and the
  velocity's increment in bfloat16, added to the float32 state;
- ``fp16_terms``: the same in float16 (a reading: it fails at the
  cells' own size, not at every test size);

and in float32 (``f32``, a witness).
Each is judged by the float64 reference as a run judges the program.  One
JSON line a seed: each stepper's compared numbers, notes (``allowed``:
agents with a knife-edge margin, ``allow_max`` the largest) and whether
they pass the cell's limits.  The benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import harness  # noqa: E402
from benchmark.reference import compare, field as ref_field  # noqa: E402
from benchmark.reference import step as ref_step  # noqa: E402

# name: (the state's dtype, the terms' dtype)
STEPPERS = {"f32": (torch.float32, None),
            "bf16": (torch.bfloat16, None),
            "bf16_terms": (torch.float32, torch.bfloat16),
            "fp16_terms": (torch.float32, torch.float16)}
CONTROLS = ("bf16", "bf16_terms")  # held failing at test size too


def readings(cell: str, seed: int, root: Path = harness.ROOT,
             manifest: dict | None = None,
             device: torch.device | None = None) -> dict:
    manifest = manifest or harness.read_json(harness.REPO / "BENCHMARK.json")
    entry = {w["name"]: w for w in manifest["workloads"]}[cell]
    if device is None:
        device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    config = harness.read_json(root / "configs" / f"{entry['config']}.json")
    traffic = harness.read_json(root / "traffic" / f"{entry['traffic']}.json")
    limits = harness.read_json(root / "cells" / f"{cell}.json")["limits"]
    ctx = harness.Context(cell, entry, config, traffic, seed, 0.0, False,
                          device, 0.0, root)
    driver = harness.load(root / "drivers" / f"{traffic['driver']}.py",
                          f"bench_driver_{traffic['driver']}")
    check = driver.first_check(ctx, driver.setup(ctx))
    problem = ctx.problem
    del ctx
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    field = ref_field.fields(problem["geometry"])
    geo = problem["geometry"]
    inp, k_cap = check["inp"], check["k_cap"]

    def stepped(agents, dtype, terms=None):
        return ref_step.step(field, agents, geo["size"], geo["unit"],
                             problem["cell_unit"], k_cap, dtype, str(device),
                             problem["outside"], terms)

    cache: dict[str, dict] = {}

    def reference(agents):  # the same input is judged once for every stepper
        key = hashlib.sha1(np.ascontiguousarray(agents["pos"]).tobytes()).hexdigest()
        if key not in cache:
            cache[key] = stepped(agents, torch.float64)
        return cache[key]

    def verdict(out, metrics, k_cells):
        r = compare.judge(field, inp, out, metrics, problem, k_cap, k_cells,
                          reference)
        n = r["numbers"]
        return {"numbers": n, "info": r["info"],
                "passes": all(v <= limits.get(k, -1.0) for k, v in n.items())}

    res = {"cell": cell, "seed": seed, "agents": len(inp["speed"]),
           "program": verdict(check["out"], check["metrics"], check["k_cells"])}
    for name, (dtype, terms) in STEPPERS.items():
        r = stepped(inp, dtype, terms)
        live = r["alive"]
        out = {"pos": r["pos"][live].astype(np.float32),
               "vel": r["vel"][live].astype(np.float32),
               "speed": np.asarray(inp["speed"])[live],
               "dest": np.asarray(inp["dest"])[live]}
        res[name] = verdict(out, None, None)
    return res


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python benchmark/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
