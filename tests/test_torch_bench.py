"""The port's bench entry (pedoni_tpu_torch/bench.py) on the CPU:

- ``build_problem`` is bit-equal to the reference's (root bench.py) for
  W in {1, 8, 33} x domain in {auto, square, tiles:2} at 20 000 agents: the
  scenario's segments and size, the cell grid, and the agents' pos, vel,
  speed, dest and active; so is the reference's xla problem (the square
  field at 1.4 m), which ``build`` steps with the flat step;
- ``python -m pedoni_tpu_torch.bench --backend cpu`` prints exactly one
  JSON line with the reference's keys (tests/test_bench_contract.py) and
  ``device``, and importing the module loads neither JAX nor the reference;
- every flag the port refuses exits non-zero with its reason, and
  ``--backend grid``, ``xla`` and ``pallas`` exit 2 where there is no CUDA
  device;
- ``--suite`` runs the reference's three (tag, overrides), headline first.
"""

import ast
import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench as ref_bench
from pedoni_tpu_torch import bench

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_AGENTS = 20_000


def _segments(segs):
    return [(tuple(map(tuple, s.line)), s.width) for s in segs]


@pytest.mark.parametrize("domain", ["auto", "square", "tiles:2"])
@pytest.mark.parametrize("waypoints", [1, 8, 33])
def test_build_problem_bit_equal_to_reference(waypoints, domain):
    sc, _maps, cfg, st = ref_bench.build_problem(
        N_AGENTS, 2.5, 7, "grid", 14, 16384, domain, waypoints)
    psc, _pmaps, pcfg, pst = bench.build_problem(
        N_AGENTS, 2.5, 7, 14, "cpu", waypoints, domain)
    assert psc.size == sc.size
    assert _segments(psc.waypoints) == _segments(sc.waypoints)
    assert _segments(psc.obstacles) == _segments(sc.obstacles)
    assert len(psc.waypoints) == waypoints
    assert (pcfg.capacity, pcfg.table_capacity) == (cfg.capacity, cfg.table_capacity)
    assert ((pcfg.grid.nx, pcfg.grid.ny, pcfg.grid.unit)
            == (cfg.grid.nx, cfg.grid.ny, cfg.grid.unit))
    for name in ("pos", "vel", "speed", "dest", "active"):
        want = np.asarray(getattr(st.agents, name))
        got = getattr(pst.agents, name).numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    dest = pst.agents.dest[pst.agents.active]
    assert int(dest.max()) == waypoints - 1 or domain == "tiles:2"
    if domain == "tiles:2":
        assert pcfg.grid.nx == 2 * 128 - 3


@pytest.mark.parametrize("n_agents", [2000, 20_000])
def test_xla_problem_bit_equal_to_reference(n_agents):
    """``--backend xla``: the reference's square field at 1.4 m, capacity
    the next power of two, the same NumPy draw (bench.py:33-143), and the
    same field maps."""
    sc, maps, cfg, st = ref_bench.build_problem(n_agents, 2.5, 3, "xla", 14, 16384)
    psc, pmaps, pcfg, pst = bench.build_problem(n_agents, 2.5, 3, 14, "cpu",
                                                backend="xla")
    assert psc.size == sc.size and psc.size[0] == psc.size[1]
    assert _segments(psc.waypoints) == _segments(sc.waypoints)
    assert _segments(psc.obstacles) == _segments(sc.obstacles)
    assert (pcfg.capacity, pcfg.table_capacity) == (cfg.capacity, cfg.table_capacity)
    assert ((pcfg.grid.nx, pcfg.grid.ny, pcfg.grid.unit)
            == (cfg.grid.nx, cfg.grid.ny, 1.4))
    for name in ("pos", "vel", "speed", "dest", "active"):
        np.testing.assert_array_equal(getattr(pst.agents, name).numpy(),
                                      np.asarray(getattr(st.agents, name)),
                                      err_msg=name)
    for name in ("pot", "dist", "dist_gx"):
        np.testing.assert_array_equal(getattr(pmaps, name), getattr(maps, name))


def test_xla_build_steps_the_flat_problem():
    """``build`` for ``--backend xla``, on the CPU: the flat step over the
    flat agents, all of them kept (1.4 m cells, K = 14)."""
    args = bench.build_parser().parse_args(["--backend", "xla", "--agents", "2000"])
    step, state, cfg = bench.build(args, torch.device("cpu"))
    assert cfg.grid.unit == 1.4 and state.agents.pos.shape == (2048, 2)
    state, m = step(state)
    assert int(m.n_active) == 2000 and int(m.n_dropped) == 0
    assert state.step == 1 and bool(torch.isfinite(state.agents.pos).all())


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    env["OMP_NUM_THREADS"] = "1"  # as torch.set_num_threads(1) in this process
    env.pop("JAX_PLATFORMS", None)
    return env


def test_bench_json_contract():
    proc = subprocess.run(
        [sys.executable, "-m", "pedoni_tpu_torch.bench", "--agents", "2000",
         "--steps", "3", "--warmup", "1", "--backend", "cpu", "--verbose"],
        capture_output=True, text=True, timeout=600, env=_env(), cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [l for l in proc.stdout.strip().splitlines() if l.strip()]
    assert len(lines) == 1, proc.stdout
    d = json.loads(lines[0])
    assert set(d) == {"metric", "value", "unit", "vs_baseline", "ms_per_step",
                      "method", "rounds", "waypoints", "device"}
    assert d["metric"] == "agent_steps_per_sec"
    assert d["unit"] == "agent-steps/s"
    assert d["value"] > 0
    assert d["vs_baseline"] == d["value"] / 1e9
    assert d["ms_per_step"] > 0
    assert "best-of" in d["method"] and d["rounds"] >= 2
    assert d["waypoints"] == 1
    assert d["device"] == "cpu"
    # this field is 3 cells tall: bin_state drops agents past K, and says so
    binned = re.search(r"# binned (\d+) of 2000 agents \((\d+) beyond K=14",
                       proc.stderr)
    assert binned and 1000 < int(binned[1]) < 2000
    assert int(binned[1]) + int(binned[2]) == 2000
    # the CPU path runs the twins: no kernel was launched
    launches = [l for l in proc.stderr.splitlines() if l.startswith("# launches ")]
    assert launches and not any(json.loads(launches[0][len("# launches "):]).values())


def test_bench_imports_no_jax():
    code = ("import sys; import pedoni_tpu_torch.bench; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'pedoni_tpu' or m.startswith('pedoni_tpu.')]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=_env(), cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]


def _main(argv, capsys):
    try:
        rc = bench.main(argv)
    except SystemExit as e:
        rc = e.code
    return rc, capsys.readouterr().err


@pytest.mark.parametrize("argv,said", [
    (["--backend", "pallas"], "needs a CUDA device"),
    (["--backend", "pallas", "--domain", "square"], "no effect with --backend pallas"),
    (["--backend", "xla"], "needs a CUDA device"),
    (["--backend", "xla", "--domain", "square"], "no effect with --backend xla"),
    (["--allow-fallback"], "the port never falls back"),
    # accepted: the flag passes to the device check (no slot walk to skip)
    (["--no-wp-skip"], "needs a CUDA device"),
    (["--chunk-size", "16384"], "no step reads it"),
    (["--domain", "tiles:0"], "needs a positive integer T"),
    (["--domain", "round"], "must be auto, square, or tiles:T"),
    ([], "needs a CUDA device"),  # --backend grid, the default
    (["--backend", "grid", "--suite"], "needs a CUDA device"),
])
def test_refused_flags_exit_nonzero_with_the_reason(argv, said, capsys):
    if said == "needs a CUDA device" and torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --backend grid runs")
    rc, err = _main(argv + ["--agents", "2000"], capsys)
    assert rc == 2 and said in err, err


def _reference_suite():
    """The (tag, overrides) list of the reference's ``--suite``, read from
    root bench.py's source (it is local to its ``main``)."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) == "configs"):
            return ast.literal_eval(node.value)
    raise AssertionError("no configs list in bench.py")


def test_suite_runs_the_reference_configurations(monkeypatch, capsys):
    want = _reference_suite()
    assert [tuple(c) for c in want] == list(bench.SUITE)
    seen = []

    def fake_capture(args):
        seen.append(args)
        return {"metric": "agent_steps_per_sec", "value": 1.0,
                "waypoints": args.waypoints}

    monkeypatch.setattr(bench, "capture", fake_capture)
    assert bench.main(["--suite", "--backend", "cpu", "--steps", "8"]) == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert [l["config"] for l in lines] == [tag for tag, _ in want]
    for args, (_tag, over) in zip(seen, want):
        assert not args.suite and args.steps == 8 and args.backend == "cpu"
        assert args.agents == over.get("agents", 1_000_000)
        assert args.waypoints == over.get("waypoints", 1)
