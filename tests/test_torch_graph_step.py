"""The Simulator's graphed steps (``sim.GraphedStep``) on the CPU, with the
CUDA graph stood in by the body it would capture (the module's
``capture_graph`` patched) and the Simulator built as on a card (the
module's ``_graphs_on`` patched while it is built): the flat step and the
one-device grid step.  Ticks and runs equal to the eager step's bit for
bit across a restore and growths (the flat capacity; the grid's table and
mover table); a state copied into the graph's buffers only when it is not
the graph's own last output (the first tick, a restore, an assignment); a
capture again only where the shapes change (growth, a flat restore
that rebuilds at a larger capacity), never on a same-size restore nor on
a grid restore of more rows than the capacity; a graph a
branch of the grid's hybrid, with tracing in its key; the launch counts a
capture gives back and a replay adds; the ``sim.capture`` and
``sim.replay`` spans; the agents read from another thread only between
steps.  Tiles and the pallas backend stay eager.  On the card the same
holds of the real graphs (tests/test_torch_cuda.py, ``-k graphed``)."""

from __future__ import annotations

import collections
import threading
import time

import pytest
import torch

from pedoni_tpu_torch import checkpoint
from pedoni_tpu_torch import sim as sim_module
from pedoni_tpu_torch.models.sfm import (AgentState, SimState, StepMetrics,
                                          spawn_sampler)
from pedoni_tpu_torch.ops import kernels
from pedoni_tpu_torch.ops.kernels import flat_sample as fsk
from pedoni_tpu_torch.scenario import loads_scenario
from pedoni_tpu_torch.sim import GraphedStep, Simulator, SimulatorOptions
from pedoni_tpu_torch.utils import trace

torch.set_num_threads(1)

# two spawning flows and a crowd placed at once, on a small field
SCENARIO = """
[field]
size = [24, 12]

[[waypoints]]
line = [[3, 2], [3, 10]]

[[waypoints]]
line = [[21, 2], [21, 10]]

[[obstacles]]
line = [[12, 0], [12, 4]]
width = 0.5

[[pedestrians]]
origin = 0
destination = 1
spawn = { kind = "once", count = 40 }

[[pedestrians]]
origin = 0
destination = 1
spawn = { kind = "periodic", frequency = 5 }

[[pedestrians]]
origin = 1
destination = 0
spawn = { kind = "periodic", frequency = 5 }
"""

# each backend's graphed step, the grid on its full path
KINDS = {"xla": {}, "grid": {"backend": "grid", "incremental_rebin": False}}


def stand_in(body, generator):
    """The graph stood in by its body: a replay runs it eagerly."""
    return body


@pytest.fixture(autouse=True)
def _graphs_stood_in(monkeypatch):
    monkeypatch.setattr(sim_module, "capture_graph", stand_in)


def _sim(graphed: bool, **options) -> Simulator:
    """A Simulator on the CPU whose kind graphs its step as on a card
    (``graphed``), or steps eagerly."""
    options = {"device": "cpu", "seed": 5, "capacity": 256, **options}
    with pytest.MonkeyPatch.context() as m:
        m.setattr(sim_module, "_graphs_on", lambda device: graphed)
        return Simulator(SimulatorOptions(**options), loads_scenario(SCENARIO))


def _tensors(state) -> tuple[torch.Tensor, ...]:
    return (state.d,) if hasattr(state, "d") else tuple(state.agents)


def _cloned(state):
    """The same state in tensors of its own: an assignment."""
    if hasattr(state, "d"):
        return state._replace(d=state.d.clone())
    return state._replace(agents=AgentState(*(t.clone() for t in state.agents)))


def _same(a: Simulator, b: Simulator) -> None:
    assert a.options == b.options and a.cfg.capacity == b.cfg.capacity
    assert a.state.step == b.state.step
    for x, y in zip(_tensors(a.state), _tensors(b.state)):
        assert x.dtype == y.dtype
        assert torch.equal(x.view(torch.int32) if x.is_floating_point() else x,
                           y.view(torch.int32) if y.is_floating_point() else y)
    assert a.last_metrics == b.last_metrics


def test_the_cpu_simulator_steps_eagerly():
    for backend in ("xla", "pallas", "grid"):
        sim = Simulator(SimulatorOptions(backend=backend, device="cpu",
                                         capacity=256), loads_scenario(SCENARIO))
        assert not isinstance(sim._step, GraphedStep)
        sim.tick()
        assert sim.graph_captures == 0


@pytest.mark.parametrize("path", ["xla", "full", "hybrid"])
def test_graphed_ticks_equal_eager_across_a_restore_and_a_growth(path, tmp_path):
    """Ticks of the graphed Simulator equal the eager one's bit for bit
    through forced growths (the flat capacity 256 -> 512; the grid's table,
    and in the hybrid its mover table) and a restore of an earlier
    checkpoint (the flat one's 256 rows padded to 512).  Each growth
    captures again and the restore does not; both leave a state of their
    own, copied in at the next tick.  The hybrid (compact_every 4) meets
    both of its keys between any two builds."""
    if path == "xla":
        kw, save, grows, restore, n_ticks = {}, 10, {25: "capacity"}, 40, 60
    else:
        kw = {"backend": "grid", "incremental_rebin": path == "hybrid",
              "compact_every": 4}
        grows = {12: "table", **({20: "movers"} if path == "hybrid" else {})}
        save, restore, n_ticks = 5, 28, 40
    graphed, eager = _sim(True, **kw), _sim(False, **kw)
    ckpt = tmp_path / "c.npz"
    for t in range(1, n_ticks + 1):
        for sim in (graphed, eager):
            sim.tick()
            if t == save:
                checkpoint.save(sim, ckpt)
            if t in grows:
                sim._grow(grows[t])
            if t == restore:
                checkpoint.restore(sim, ckpt)
        _same(graphed, eager)
        assert graphed._step.holds(graphed.state) == (t not in (*grows, restore))
    keys = 2 if path == "hybrid" else 1
    assert graphed.graph_captures == (1 + len(grows)) * keys
    assert graphed._step.copies_in == graphed.graph_captures + 1  # + the restore
    assert eager.graph_captures == 0
    if path == "xla":
        assert graphed.cfg.capacity == 512
        assert any(m > 0 for m in graphed.last_metrics[:2])
    else:
        assert graphed.options.table_capacity == 24
        assert graphed.pedestrian_count > 40


@pytest.mark.parametrize("backend", ["xla", "grid"])
def test_graphed_runs_equal_eager_with_the_lagged_guard(backend):
    """``run`` keeps a lagged metric of each step and sums them: each
    replay's metrics are its own, not the graph's next output.  Its guard,
    outside the graph, doubles the flat capacity or grows the grid's table
    as the eager Simulator's does; one capture at the first tick, one a
    growth."""
    kw = ({"capacity": 64} if backend == "xla" else
          {**KINDS["grid"], "table_capacity": 4})
    graphed, eager = _sim(True, **kw), _sim(False, **kw)
    for sim in (graphed, eager):
        sim.tick()
        for _ in range(3):
            sim.run(12 if backend == "xla" else 8, guard_every=4)
    assert graphed.last_run_metrics == eager.last_run_metrics
    _same(graphed, eager)
    if backend == "xla":
        assert graphed.cfg.capacity > 64
        grown = (graphed.cfg.capacity // 64).bit_length() - 1
    else:
        k, grown = 4, 0
        while k < graphed.options.table_capacity:  # 4 -> 8 -> 12 -> 18 ...
            k, grown = k + max(4, k // 2), grown + 1
        assert grown > 0
    assert graphed.graph_captures == 1 + grown


@pytest.mark.parametrize("backend", ["xla", "grid"])
def test_a_state_is_copied_in_only_when_it_is_not_the_graphs(backend):
    sim = _sim(True, **KINDS[backend])
    step = sim._step
    sim.tick()  # the first tick: its eager result is copied in
    assert (step.captures, step.copies_in) == (1, 1)
    for _ in range(3):
        sim.tick()  # the graph's own output handed back: no copy
    assert step.copies_in == 1
    sim.state = sim.state._replace(step=sim.state.step)  # the same tensors
    sim.tick()
    assert step.copies_in == 1
    sim.state = _cloned(sim.state)  # an assignment
    sim.tick()
    assert step.copies_in == 2 and step.holds(sim.state)
    if backend == "xla":
        sim.state.agents.pos[0, 0] += 0.5  # written in place: the graph reads it
        before = sim.state.agents.pos[0].clone()
        sim.tick()
        assert step.copies_in == 2
        assert not torch.equal(sim.state.agents.pos[0], before)
    assert step.captures == 1


def test_a_restore_copies_in_and_captures_only_at_a_larger_capacity(tmp_path):
    small, large = tmp_path / "small.npz", tmp_path / "large.npz"
    sim = _sim(True)
    sim.tick()
    checkpoint.save(sim, small)  # capacity 256
    sim.tick()
    step = sim._step
    assert (step.captures, step.copies_in) == (1, 1)
    checkpoint.restore(sim, small)  # the same capacity
    sim.tick()
    assert (step.captures, step.copies_in) == (1, 2)
    sim._grow("capacity")
    sim.tick()  # a new capacity: captured again
    assert sim.cfg.capacity == 512 and (step.captures, step.copies_in) == (2, 3)
    checkpoint.save(sim, large)  # capacity 512
    other = _sim(True)
    other.tick()
    checkpoint.restore(other, large)  # rebuilds at 512
    assert other.graph_captures == 1
    other.tick()
    assert other.graph_captures == 2 and other.cfg.capacity == 512
    checkpoint.restore(other, small)  # 256 rows padded to 512: no rebuild
    other.tick()
    assert other.graph_captures == 2 and other._step.copies_in == 3


def test_a_grid_restore_past_the_capacity_keeps_the_graph(tmp_path):
    """The grid's agents live in the grid, so a checkpoint of more rows than
    the capacity (a crowd that outgrew it, unbinned) raises the capacity
    and is binned into the step as built: no rebuild, no capture, the same
    fields; only the copy in.  The ticks after it equal an eager
    Simulator's bit for bit."""
    ckpt = tmp_path / "c.npz"
    graphed, eager = _sim(True, **KINDS["grid"]), _sim(False, **KINDS["grid"])
    big = _sim(False, **KINDS["grid"], capacity=1024)
    big.load_flat_state(SimState(AgentState(
        pos=torch.rand((300, 2), generator=torch.Generator().manual_seed(1))
        * torch.tensor([16.0, 10.0]) + torch.tensor([4.0, 1.0]),
        vel=torch.zeros((300, 2)), speed=torch.full((300,), 1.3),
        dest=torch.ones(300, dtype=torch.int32),
        active=torch.ones(300, dtype=torch.bool)), 0))
    checkpoint.save(big, ckpt)
    for sim in (graphed, eager):
        sim.tick()
        built = (sim._step, sim._fwp, sim._fobs)
        checkpoint.restore(sim, ckpt)  # 1024 rows into a capacity of 256
        assert (sim._step, sim._fwp, sim._fobs) == built
        assert sim.pedestrian_count > 256 and sim.cfg.capacity == 1024
        for _ in range(3):
            sim.tick()
    _same(graphed, eager)
    assert graphed.graph_captures == 1 and graphed._step.copies_in == 2


def test_a_restore_rewinds_the_graphed_stream(tmp_path):
    sim = _sim(True)
    sim.tick()
    ckpt = tmp_path / "c.npz"
    checkpoint.save(sim, ckpt)
    first = [(sim.tick(), sim.last_metrics,
              [t.clone() for t in sim.state.agents])[1:] for _ in range(5)]
    checkpoint.restore(sim, ckpt)
    again = [(sim.tick(), sim.last_metrics,
              [t.clone() for t in sim.state.agents])[1:] for _ in range(5)]
    for (m1, a1), (m2, a2) in zip(first, again):
        assert m1 == m2 and all(torch.equal(x, y) for x, y in zip(a1, a2))


def _toy_eager(state: SimState, field_rows, obstacles):
    """A stand-in eager step that counts one flat_sample launch a call."""
    fsk.flat_sample.launches += 1
    z = torch.zeros((), dtype=torch.int32)
    a = state.agents
    return (SimState(agents=a._replace(pos=a.pos + 1.0), step=state.step + 1),
            StepMetrics(a.active.sum().to(torch.int32), z, z, z, z, z, z))


def _toy_state(n: int = 4) -> SimState:
    return SimState(agents=AgentState(
        pos=torch.zeros((n, 2)), vel=torch.zeros((n, 2)), speed=torch.ones(n),
        dest=torch.zeros(n, dtype=torch.int32), active=torch.ones(n, dtype=bool)),
        step=0)


def test_a_replay_adds_the_launches_its_capture_gave_back(monkeypatch):
    def record(body, generator):
        body()  # a capture records the body's launches and runs nothing

        def replay():
            pass  # a replay launches them without their wrappers

        return replay

    monkeypatch.setattr(sim_module, "capture_graph", record)
    kernels.zero_launch_counts()
    try:
        step = GraphedStep(torch.Generator())
        step.rebuild(_toy_eager)
        rows, obstacles = torch.zeros((1, 8)), ()
        state, m = step(_toy_state(), rows, obstacles)  # the warm-up, eager
        assert kernels.launch_counts()["flat_sample"] == 1
        assert step._graphs[None].launches == {"flat_sample": 1}
        for i in range(3):
            state, m = step(state, rows, obstacles)
            assert kernels.launch_counts()["flat_sample"] == 2 + i
        assert state.step == 4 and int(m.n_active) == 4
        with pytest.raises(ValueError, match="captured with"):
            step(state, torch.zeros((1, 8)), obstacles)
    finally:
        kernels.zero_launch_counts()


def test_the_metrics_of_each_replay_are_their_own():
    step = GraphedStep(torch.Generator())
    step.rebuild(_toy_eager)
    rows = torch.zeros((1, 8))
    state, m1 = step(_toy_state(4), rows, ())
    state, m2 = step(state, rows, ())
    state = state._replace(agents=state.agents._replace(
        active=torch.tensor([True, False, False, True])))
    state, m3 = step(state, rows, ())
    assert [int(m.n_active) for m in (m1, m2, m3)] == [4, 4, 2]
    assert float(state.agents.pos[0, 0]) == 3.0


def _program_tree(prof) -> collections.Counter:
    out = collections.Counter()
    for ev in prof.events():
        if ev.name not in trace.NAMES:
            continue
        parent = ev.cpu_parent
        while parent is not None and parent.name not in trace.NAMES:
            parent = parent.cpu_parent
        out[(ev.name, None if parent is None else parent.name)] += 1
    return out


@pytest.mark.parametrize("backend", ["xla", "grid"])
def test_capture_and_replay_open_their_spans_inside_the_tick(backend):
    sim = _sim(True, **KINDS[backend])
    trace.enable(True)
    try:
        trees = []
        for _ in range(2):
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
                sim.tick()
            trees.append(_program_tree(prof))
    finally:
        trace.enable(False)
    first, second = trees
    layer = "flat" if backend == "xla" else "grid"
    assert first[("sim.capture", "sim.tick")] == 1
    assert first[(f"{layer}.step", "sim.capture")] == 1  # the warm-up, eager
    assert first[("sim.replay", "sim.tick")] == 0
    assert second[("sim.replay", "sim.tick")] == 1
    assert second[("sim.capture", "sim.tick")] == 0
    assert second[("sim.fetch", "sim.tick")] == 1


@pytest.mark.parametrize("advance", ["tick", "run"])
@pytest.mark.parametrize("backend", ["xla", "grid"])
def test_agents_are_read_from_another_thread_only_between_steps(
        backend, advance, monkeypatch):
    """``list_pedestrians`` on a second thread, as the CLI's live views
    call it, while ``tick`` or ``run`` replays and grows (the flat
    capacity, the grid's table): no read starts inside a replay (on a card
    the replay rewrites the state it would read), and each read is of one
    state whole."""
    stepping = threading.Event()

    def slow(body, generator):
        def replay():
            stepping.set()
            time.sleep(0.002)  # a long replay, for a read to fall into
            body()
            stepping.clear()

        return replay

    monkeypatch.setattr(sim_module, "capture_graph", slow)
    # the 40 placed at once pass 80% of 48; K 4 fills at once
    sim = (_sim(True, capacity=48) if backend == "xla"
           else _sim(True, **KINDS["grid"], table_capacity=4))
    flat_state = sim.flat_state
    inside, reads = [], []

    def watched():
        inside.append(stepping.is_set())
        return flat_state()

    sim.flat_state = watched
    done = threading.Event()

    def reader():
        while not done.is_set():
            pos, dest = sim.list_pedestrians()
            reads.append((len(pos), len(dest)))

    thread = threading.Thread(target=reader)
    thread.start()
    try:
        for _ in range(15):
            if advance == "tick":
                sim.tick()
            else:
                sim.run(4, guard_every=2)
    finally:
        done.set()
        thread.join(timeout=60)
    assert not thread.is_alive()
    grown = (sim.cfg.capacity > 48 if backend == "xla"
             else sim.options.table_capacity > 4)
    assert grown and sim.graph_captures >= 2
    assert reads and not any(inside)
    assert all(n_pos == n_dest for n_pos, n_dest in reads)


def test_the_hybrid_captures_a_graph_a_branch():
    sim = _sim(True, backend="grid", incremental_rebin=True, compact_every=4)
    step = sim._step
    sim.tick()  # step 0: the full rebin's branch
    assert list(step._graphs) == [(True, False)]
    for _ in range(7):
        sim.tick()
    assert sorted(step._graphs) == [(False, False), (True, False)]
    assert (step.captures, step.copies_in) == (2, 2)


def test_turning_tracing_on_captures_the_hybrid_again():
    """Tracing adds to ``full_rebins`` inside the hybrid step, so it joins
    the host key: its graphs are captured again while it is on, and count
    the full rebins as the eager step does."""
    kw = {"backend": "grid", "incremental_rebin": True, "compact_every": 4}
    graphed, eager = _sim(True, **kw), _sim(False, **kw)
    for sim in (graphed, eager):
        for _ in range(4):
            sim.tick()
    assert graphed.graph_captures == 2
    trace.enable(True)
    try:
        for sim in (graphed, eager):
            for _ in range(9):
                sim.tick()
    finally:
        trace.enable(False)
    assert graphed.graph_captures == 4
    assert int(graphed._step.eager.full_rebins) == int(eager._step.full_rebins) >= 2
    for sim in (graphed, eager):
        sim.tick()
    assert graphed.graph_captures == 4  # off again: the first graphs
    _same(graphed, eager)


def test_injected_candidates_and_the_timings_stay_eager():
    sim = _sim(True, **KINDS["grid"])
    for _ in range(3):
        sim.tick()
    step = sim._step
    before = sim.state.d.clone()
    assert sim.measure_kernel_time(2) > 0 and sim.measure_spawn_time(2) > 0
    assert torch.equal(sim.state.d, before) and step.captures == 1
    cand = spawn_sampler(sim.cfg, sim.device)(torch.Generator().manual_seed(3))
    state, _m = sim._step(sim.state, sim._fwp, sim._fobs, cand)
    assert not step.holds(state) and step.captures == 1
    sim.state = state
    sim.tick()
    assert step.copies_in == 2 and step.holds(sim.state)


def test_tiles_and_the_pallas_backend_step_eagerly():
    """Even where steps are graphed, as on a card."""
    for options in ({"backend": "grid", "n_devices": 2}, {"backend": "pallas"}):
        sim = _sim(True, **options)
        sim.tick()
        assert not isinstance(sim._step, GraphedStep) and sim.graph_captures == 0


@pytest.mark.parametrize("backend", ["xla", "grid"])
def test_a_step_lets_a_waiting_read_go_first(backend):
    """A read that waits for the step's lock goes before the next step, so
    that ticks back to back (the CLI's live views with no pacing) do not
    starve another thread's reads."""
    sim = _sim(True, **KINDS[backend])
    sim.tick()
    flat_state = sim.flat_state
    read_at = []

    def watched():
        read_at.append(sim.step_count)
        return flat_state()

    sim.flat_state = watched
    thread = threading.Thread(target=sim.list_pedestrians)
    with sim._lock:  # a step under way
        thread.start()
        while not sim._readers:  # the read waits for the lock
            time.sleep(0.001)
        sim.tick()
    thread.join(timeout=60)
    assert not thread.is_alive()
    assert read_at == [1] and sim.step_count == 2
