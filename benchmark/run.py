"""Run one benchmark cell and print its result as the last line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in BENCHMARK.json; its files are
found by name under ``benchmark/`` (``harness.py``).  With ``--trace 0``
the line carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics from a profile of the window.  The numbers that decide
``correct`` are printed beside their limits as the last lines of standard
error and under ``checks``, last in the line.  Exits non-zero, printing no
result, without the CUDA devices the cell asks for, without the program,
or with JAX or the JAX package loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import harness  # noqa: E402


def parse(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    code, result = harness.run_cell(parse(argv), t_start=T_START)
    if result is not None:
        sys.stderr.flush()
        print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    raise SystemExit(main())
