"""The port's checkpoints and headless CLI (pedoni_tpu_torch/checkpoint.py,
cli.py), on the CPU:

- checkpoints cross between the packages with the agents exact: a port
  checkpoint loads through ``pedoni_tpu.checkpoint.load_state``, and a
  reference ``save_state`` file restores into the port's ``Simulator``
  (whose generator is then reseeded from its options);
- ``cli.main([... "-b", "grid", "--no-distance-map", ...])``, with the grid
  backend's device set to the CPU (``cli.BACKENDS`` patched by the
  ``grid_on_cpu`` fixture; the CLI runs ``-b grid`` on the card), writes a
  log with the reference's schema (tests/test_api.py:88-147), checkpoints
  every N steps, and a resumed run restores agents and generator exactly;
- every flag of the reference's CLI does its work: ``--record-every``
  writes ``traj.bin``, ``--frame-every`` PNG frames, ``--profile`` a trace,
  ``--render-web`` serves ``/scene`` and ``/state``, and ``--render`` and
  the non-headless mode draw frames and exit at ``--max-steps``;
- ``-b`` resolves as the reference's ``make_simulator`` does for all six
  values (auto, xla and tpu: the flat backend at 1.4 m on the card; cpu:
  the flat backend on the CPU; pallas and grid at 1.5 m on the card; with
  tiles, auto: the grid at 1.5 m; an explicit non-grid backend with tiles
  exits non-zero);
- ``--tile 2x2 -b grid`` runs gap.toml on four tiles on the CPU until the
  population reaches 0, and ``--devices`` / ``--tile`` are parsed with the
  reference's messages.
"""

import json
import pathlib
import signal
import struct
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pedoni_tpu import checkpoint as ref_ckpt
from pedoni_tpu import cli as ref_cli
from pedoni_tpu.models.sfm import AgentState, SimState
from pedoni_tpu_torch import Simulator, SimulatorOptions, cli, convert, native
from pedoni_tpu_torch import checkpoint as port_ckpt
from pedoni_tpu_torch.scenario import loads_scenario

from test_api import SCENARIO as API_SCENARIO

torch.set_num_threads(1)

# tests/test_api.py's scenario (10 agents spawned once) with an obstacle,
# so that --no-distance-map has a segment to walk
SCENARIO = API_SCENARIO + """
[[obstacles]]
line = [[8, 0], [8, 6]]
width = 1
"""


def _active_rows(pos, vel, speed, dest, active):
    rows = np.concatenate([pos, vel, speed[:, None],
                           dest[:, None].astype(np.float32)], 1)[active]
    return rows[np.lexsort(rows.T[::-1])]


def _sim_rows(sim):
    a = convert.agents_to_numpy(sim.flat_state().agents)
    return _active_rows(a["pos"], a["vel"], a["speed"], a["dest"], a["active"])


def test_port_checkpoint_loads_in_reference(tmp_path):
    sim = Simulator(SimulatorOptions(backend="grid", device="cpu", seed=3), loads_scenario(SCENARIO))
    for _ in range(5):
        sim.tick()
    path = tmp_path / "port.npz"
    port_ckpt.save(sim, path)
    state, step_count = ref_ckpt.load_state(path)
    assert step_count == 5 and int(state.step) == 5
    assert state.key.shape == (2,) and state.key.dtype == jnp.uint32
    a = state.agents
    got = _active_rows(*(np.asarray(x) for x in (a.pos, a.vel, a.speed, a.dest,
                                                 a.active)))
    assert got.shape[0] == 10
    np.testing.assert_array_equal(got, _sim_rows(sim))


def test_reference_checkpoint_restores_in_port(tmp_path):
    rng = np.random.default_rng(5)
    n = 300  # more than the simulator's capacity below: it must grow
    pos = rng.uniform(1.0, 15.0, (n, 2)).astype(np.float32)
    vel = rng.normal(0, 0.3, (n, 2)).astype(np.float32)
    speed = rng.uniform(0.8, 1.6, n).astype(np.float32)
    dest = rng.integers(0, 2, n).astype(np.int32)
    active = rng.uniform(size=n) < 0.5
    path = tmp_path / "ref.npz"
    ref_ckpt.save_state(SimState(
        agents=AgentState(*map(jnp.asarray, (pos, vel, speed, dest, active))),
        key=jax.random.PRNGKey(9), step=jnp.int32(40)), path, step_count=40)

    sim = Simulator(SimulatorOptions(backend="grid", device="cpu", seed=11, capacity=256,
                                     table_capacity=32),
                    loads_scenario(SCENARIO))
    sim.generator.manual_seed(999)
    port_ckpt.restore(sim, path)
    assert sim.step_count == 40 and sim.state.step == 40
    assert sim.cfg.capacity == n
    np.testing.assert_array_equal(_sim_rows(sim),
                                  _active_rows(pos, vel, speed, dest, active))
    # no port generator state in a reference file: reseeded from options
    assert torch.equal(sim.generator.get_state(),
                       torch.Generator().manual_seed(11).get_state())


@pytest.fixture
def grid_on_cpu(monkeypatch):
    """``-b grid`` runs the grid backend on the CPU (the kernels' twins)."""
    monkeypatch.setitem(cli.BACKENDS, "grid", ("grid", "cpu"))


def _argv(tmp_path, *extra):
    scen = tmp_path / "s.toml"
    scen.write_text(SCENARIO)
    return [str(scen), "-H", "-b", "grid", "-s", "0", "--capacity", "256",
            "--log-dir", str(tmp_path / "logs"), *extra]


def test_cli_headless_log_schema(tmp_path, grid_on_cpu):
    assert cli.main(_argv(tmp_path, "--no-distance-map", "--max-steps", "20")) == 0
    (out,) = (tmp_path / "logs").glob("*_log.json")
    d = json.loads(out.read_text())
    assert set(d) == {"model", "scenario", "total_steps", "preprocess_metrics",
                      "step_metrics"}
    assert d["model"] == "sfm-torch/grid"
    assert d["total_steps"] == 20
    assert set(d["preprocess_metrics"]) == {"time_calc_field"}
    sm = d["step_metrics"]
    assert set(sm) == {"active_ped_count", "time_spawn", "time_calc_state",
                       "time_calc_state_kernel"}
    assert len(sm["active_ped_count"]) == 20 and sm["active_ped_count"][0] == 10
    assert sm["time_calc_state_kernel"] == [None] * 20


def test_cli_checkpoint_and_resume(tmp_path, grid_on_cpu):
    ck = tmp_path / "cks"
    cli.main(_argv(tmp_path, "--no-distance-map", "--max-steps", "10",
                   "--checkpoint-every", "5", "--checkpoint-dir", str(ck)))
    cks = sorted(ck.glob("*.npz"))
    assert [p.name for p in cks] == ["step_00000005.npz", "step_00000010.npz"]
    args = cli.build_parser().parse_args(
        _argv(tmp_path, "--no-distance-map", "--resume", str(cks[0])))
    sim = cli.make_simulator(args)
    port_ckpt.restore(sim, cks[0])
    with np.load(cks[0]) as z:
        saved = _active_rows(z["pos"], z["vel"], z["speed"], z["dest"], z["active"])
        gen = torch.from_numpy(z["torch_generator"])
    assert sim.step_count == 5
    np.testing.assert_array_equal(_sim_rows(sim), saved)
    assert torch.equal(sim.generator.get_state(), gen)
    # the resumed run continues from step 5: 5 more steps reach step 10
    cli.main(_argv(tmp_path, "--no-distance-map", "--max-steps", "5",
                   "--resume", str(cks[0]), "--checkpoint-every", "5",
                   "--checkpoint-dir", str(tmp_path / "cks2")))
    with np.load(cks[1]) as a, np.load(tmp_path / "cks2" / "step_00000010.npz") as b:
        np.testing.assert_array_equal(
            _active_rows(b["pos"], b["vel"], b["speed"], b["dest"], b["active"]),
            _active_rows(a["pos"], a["vel"], a["speed"], a["dest"], a["active"]))


def _log_of(tmp_path):
    (out,) = (tmp_path / "logs").glob("*_log.json")
    return json.loads(out.read_text())


def _flag_record(tmp_path, capsys, monkeypatch):
    """--record-every 5: traj.bin in the log dir, read back, a frame each
    5 steps holding the active agents."""
    assert cli.main(_argv(tmp_path, "--max-steps", "10", "--record-every", "5")) == 0
    frames = list(native.read_trajectory(tmp_path / "logs" / "traj.bin"))
    assert [f[0] for f in frames] == [5, 10]
    for _step, pos, dest in frames:
        assert pos.shape == (10, 2) and np.isfinite(pos).all() and dest.shape == (10,)


def _flag_frames(tmp_path, capsys, monkeypatch):
    """--frame-every 5: PNG frames named by step in the log dir."""
    assert cli.main(_argv(tmp_path, "--max-steps", "10", "--frame-every", "5")) == 0
    pngs = sorted(p.name for p in (tmp_path / "logs").glob("*.png"))
    assert pngs == ["frame_00000005.png", "frame_00000010.png"]
    assert (tmp_path / "logs" / pngs[0]).read_bytes()[:4] == b"\x89PNG"


def _flag_profile(tmp_path, capsys, monkeypatch):
    """--profile DIR: a torch.profiler trace of the run in DIR (CPU
    activities here), and every 100th step's kernel and spawn times."""
    trace_dir = tmp_path / "trace"
    assert cli.main(_argv(tmp_path, "--max-steps", "3", "--profile",
                          str(trace_dir))) == 0
    (trace,) = trace_dir.glob("*_trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("index_copy" in e.get("name", "") or "aten::" in e.get("name", "")
               for e in events)
    sm = _log_of(tmp_path)["step_metrics"]
    # step 1 is timed: the grid's kernel chain (its twins here); no spawns
    assert sm["time_calc_state_kernel"][0] > 0 and sm["time_spawn"][0] == 0.0
    assert sm["time_calc_state_kernel"][1:] == [None, None]


def _flag_web(tmp_path, capsys, monkeypatch):
    """--render-web 0: the web view serves /scene and /state while the run
    goes on, the loop holds while the view is paused, and the run ends on
    SIGINT, as the reference's does."""
    import threading
    import urllib.request

    from pedoni_tpu_torch import webview

    seen = {}
    started = threading.Event()
    real_start = webview.WebViewer.start

    def start(viewer):
        seen["viewer"] = real_start(viewer)
        started.set()
        return seen["viewer"]

    def request(path, body=None):
        req = urllib.request.Request(
            seen["viewer"].url.rstrip("/") + path,
            data=None if body is None else json.dumps(body).encode(),
            method="GET" if body is None else "POST")
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.read()

    def probe():
        if not started.wait(120):
            return
        try:
            seen["scene"] = json.loads(request("/scene"))
            deadline = time.time() + 60
            while time.time() < deadline and "state" not in seen:
                step, n, total = struct.unpack_from("<III", request("/state"), 0)
                if total == 10 and step > 0:
                    seen["state"] = (step, n, total)
                time.sleep(0.02)
            request("/control", {"paused": True})
            time.sleep(0.3)  # the loop notices within one 0.05 s nap
            held = seen["viewer"]._step
            time.sleep(0.5)
            seen["held"] = (held, seen["viewer"]._step)
            request("/control", {"paused": False})
        finally:
            signal.raise_signal(signal.SIGINT)  # the run's own handler

    monkeypatch.setattr(webview.WebViewer, "start", start)
    thread = threading.Thread(target=probe)
    thread.start()
    try:
        assert cli.main(_argv(tmp_path, "--max-steps", "100000",
                              "--render-web", "0", "-s", "1")) == 0
    finally:
        thread.join(180)
    assert seen["scene"]["size"] == [16, 16]
    assert seen["state"][2] == 10 and 0 < seen["state"][1] <= 10
    assert seen["held"][0] == seen["held"][1]  # no step while paused
    assert "web view: http://127.0.0.1:" in capsys.readouterr().out
    assert _log_of(tmp_path)["total_steps"] >= seen["held"][0]


def _flag_render(tmp_path, capsys, monkeypatch, headless=True):
    """--render (and the non-headless mode, which turns it on): frames drawn
    to stdout by the snapshot thread; the run ends at --max-steps."""
    argv = _argv(tmp_path, "--max-steps", "40", "--render", "-s", "5")
    if not headless:
        argv.remove("-H")
        argv.remove("--render")
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "\x1b[" in out and "zoom" in out
    assert _log_of(tmp_path)["total_steps"] == 40


FLAG_CASES = {"render": _flag_render, "render-web": _flag_web,
              "5_0": _flag_record, "5_1": _flag_frames, "trace": _flag_profile,
              "no-headless": lambda *fixtures: _flag_render(*fixtures,
                                                            headless=False)}


@pytest.mark.parametrize("case", list(FLAG_CASES))
def test_cli_flags_do_their_work(tmp_path, case, capsys, monkeypatch,
                                 grid_on_cpu):
    """The reference's display, record and profile flags on the grid
    backend on the CPU (cases named as the refusals they replace: 5_0
    --record-every 5, 5_1 --frame-every 5, trace --profile)."""
    FLAG_CASES[case](tmp_path, capsys, monkeypatch)


def _reference_options(argv, monkeypatch):
    """The options the reference's ``make_simulator`` builds for ``argv``
    (its Simulator replaced by a stub that returns them)."""
    monkeypatch.setattr(ref_cli, "Simulator", lambda options, scenario: options)
    try:
        options, _ = ref_cli.make_simulator(ref_cli.build_parser().parse_args(argv))
    finally:  # -b cpu / tpu set JAX's default device: back to unset
        jax.config.update("jax_default_device", None)
    return options


@pytest.mark.parametrize("extra", [
    ["-b", "auto"], ["-b", "xla"], ["-b", "tpu"], ["-b", "grid"],
    ["-b", "auto", "--tile", "2x2"], ["-b", "auto", "--devices", "2"],
    ["-b", "xla", "--neighbor-unit", "2.0"], ["-b", "grid", "--tile", "1x2"],
    ["-b", "cpu"], ["-b", "pallas"],
], ids=lambda e: "_".join(a.lstrip("-") for a in e[1:]))
def test_cli_backends_resolve_as_the_reference(tmp_path, extra, monkeypatch):
    """``-b auto`` runs the flat backend at 1.4 m, and with tiles the grid
    at 1.5 m; ``-b cpu`` the flat backend on the CPU, ``-b pallas`` the
    pallas backend at 1.5 m; the port's backend, unit, device count and
    tiles are the reference's, on the CUDA card but for ``cpu``."""
    argv = _argv(tmp_path)[:2] + extra  # the scenario, -H
    got = cli.options_from_args(cli.build_parser().parse_args(argv))
    want = _reference_options(argv, monkeypatch)
    assert ((got.backend, got.neighbor_grid_unit, got.n_devices, got.tile)
            == (want.backend, want.neighbor_grid_unit, want.n_devices, want.tile))
    assert got.device == ("cpu" if extra[1] == "cpu" else "cuda")
    if extra[1:] == ["auto"]:
        assert (got.backend, got.neighbor_grid_unit) == ("xla", 1.4)
    if "--tile" in extra and extra[1] == "auto":
        assert (got.backend, got.neighbor_grid_unit) == ("grid", 1.5)
    if extra[1:] == ["cpu"]:
        assert (got.backend, got.neighbor_grid_unit) == ("xla", 1.4)
    if extra[1:] == ["pallas"]:
        assert (got.backend, got.neighbor_grid_unit) == ("pallas", 1.5)


@pytest.mark.parametrize("backend,extra", [
    ("xla", ["--devices", "2"]), ("tpu", ["--devices", "2"]),
    ("pallas", ["--devices", "2"]), ("cpu", ["--tile", "2x2"]),
], ids=["xla", "tpu", "pallas", "cpu"])
def test_cli_flat_backend_with_devices_exits_nonzero(tmp_path, backend, extra,
                                                     monkeypatch):
    """A backend other than grid and auto cannot run tiles: ``-b xla
    --devices 2``, ``-b pallas --devices 2`` and ``-b cpu --tile 2x2`` exit
    non-zero with the reference's message, before any work."""
    argv = _argv(tmp_path, *extra, "--max-steps", "1")
    argv[argv.index("grid")] = backend
    with pytest.raises(SystemExit, match="requires the grid backend") as exc:
        cli.main(argv)
    assert exc.value.code not in (0, None)
    assert not (tmp_path / "logs").exists()
    with pytest.raises(SystemExit, match="requires the grid backend"):
        _reference_options(argv, monkeypatch)


def test_cli_tiles_evacuate_gap(tmp_path, grid_on_cpu):
    """``python -m pedoni_tpu_torch gap.toml -H -b grid --tile 2x2``: four
    tiles on the CPU, until the population reaches 0 (step 263 at seed 0,
    as on one device)."""
    gap = pathlib.Path(__file__).resolve().parents[1] / "scenarios" / "gap.toml"
    argv = [str(gap), "-H", "-b", "grid", "--tile", "2x2", "-s", "0",
            "--max-steps", "280", "--log-dir", str(tmp_path / "logs")]
    sim = cli.make_simulator(cli.build_parser().parse_args(argv))
    assert sim.options.resolve_tile() == (2, 2) and sim.options.n_devices == 4
    assert cli.main(argv) == 0
    (out,) = (tmp_path / "logs").glob("*_log.json")
    pops = json.loads(out.read_text())["step_metrics"]["active_ped_count"]
    assert pops[0] == 64 and pops[-1] == 0 and pops.index(0) + 1 == 263


@pytest.mark.parametrize("extra,message", [
    (["--tile", "0x2"], "positive integers"),
    (["--tile", "2by2"], "positive integers"),
    (["--tile", "2x2", "--devices", "3"], "does not cover --devices 3"),
], ids=["zero", "malformed", "mismatch"])
def test_cli_tile_parsing(tmp_path, extra, message, grid_on_cpu):
    """--tile and --devices as the reference parses them (its cli.py:107-
    125): bad tiles exit non-zero with its messages, before any work."""
    with pytest.raises(SystemExit, match=message):
        cli.main(_argv(tmp_path, "--max-steps", "1", *extra))
    assert not (tmp_path / "logs").exists()


def test_cli_devices_cut_row_strips(tmp_path, grid_on_cpu):
    """--devices 2 alone: two row strips, as the reference's row-strip
    shim; the run equals one device's."""
    logs = {}
    for n in ("1", "2"):
        argv = _argv(tmp_path, "--max-steps", "8", "--devices", n,
                     "--log-dir", str(tmp_path / n))
        assert cli.main(argv) == 0
        (out,) = (tmp_path / n).glob("*_log.json")
        logs[n] = json.loads(out.read_text())["step_metrics"]["active_ped_count"]
    sim = cli.make_simulator(cli.build_parser().parse_args(
        _argv(tmp_path, "--devices", "2")))
    assert sim.options.resolve_tile() == (2, 1)
    assert logs["2"] == logs["1"] and logs["1"][0] == 10
