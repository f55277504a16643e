"""The Simulator's graphed flat step (``sim.GraphedStep``) on the CPU, with
the CUDA graph stood in by the body it would capture: ticks and runs
equal to the eager step's bit for bit across a restore and a growth; a
state copied into the graph's buffers only when it is not the graph's own
last output (the first tick, a restore, an assignment); a capture again
only where the shapes change (growth, a restore that rebuilds at a larger
capacity), never on a same-size restore; the launch counts a capture
gives back and a replay adds; the ``sim.capture`` and ``sim.replay``
spans; the agents read from another thread only between steps.  The
one-device grid Simulator's graphed step (``sim.GraphedGridStep``) the
same, through table and mover growths, with a graph a branch of the
hybrid and tracing in its key; tiles and the pallas backend stay eager.
On the card the same holds of the real graphs (tests/test_torch_cuda.py,
``-k graphed``)."""

from __future__ import annotations

import collections
import threading
import time

import pytest
import torch

from pedoni_tpu_torch import checkpoint
from pedoni_tpu_torch.models.sfm import (AgentState, SimState, StepMetrics,
                                          spawn_sampler)
from pedoni_tpu_torch.ops import kernels
from pedoni_tpu_torch.ops.kernels import flat_sample as fsk
from pedoni_tpu_torch.scenario import loads_scenario
from pedoni_tpu_torch.sim import (GraphedGridStep, GraphedStep, Simulator,
                                  SimulatorOptions)
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


def stand_in(body, generator):
    """The graph stood in by its body: a replay runs it eagerly."""
    return body


def _sim(graphed: bool, capacity: int = 256, seed: int = 5) -> Simulator:
    sim = Simulator(SimulatorOptions(device="cpu", seed=seed, capacity=capacity),
                    loads_scenario(SCENARIO))
    if graphed:
        sim._graphed = GraphedStep(sim.generator, capture=stand_in)
        sim._build(sim.cfg.capacity)
    return sim


def _same(a: Simulator, b: Simulator) -> None:
    assert a.cfg.capacity == b.cfg.capacity and a.state.step == b.state.step
    for x, y in zip(a.state.agents, b.state.agents):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert a.last_metrics == b.last_metrics


def test_the_cpu_simulator_steps_eagerly():
    for backend in ("xla", "pallas", "grid"):
        sim = Simulator(SimulatorOptions(backend=backend, device="cpu",
                                         capacity=256), loads_scenario(SCENARIO))
        assert sim._graphed is None and not isinstance(sim._step, GraphedStep)
        sim.tick()
        assert sim.graph_captures == 0


def test_graphed_ticks_equal_eager_across_a_restore_and_a_growth(tmp_path):
    graphed, eager = _sim(True), _sim(False)
    ckpt = tmp_path / "c.npz"
    for t in range(1, 61):
        for sim in (graphed, eager):
            sim.tick()
            if t == 10:
                checkpoint.save(sim, ckpt)
            if t == 25:
                sim._grow()  # a forced growth: 256 -> 512
            if t == 40:
                checkpoint.restore(sim, ckpt)  # at 512: padded, no rebuild
        _same(graphed, eager)
        # growth and a restore leave a state of their own, copied in next
        assert (graphed.state.agents is graphed._step._inputs) == (t not in (25, 40))
    assert graphed.cfg.capacity == 512 and graphed.graph_captures == 2
    assert any(m > 0 for m in graphed.last_metrics[:2])


def test_graphed_runs_equal_eager_with_the_lagged_guard():
    """``run`` keeps a lagged metric of each step and sums them: each
    replay's metrics are its own, not the graph's next output."""
    graphed, eager = _sim(True, capacity=64), _sim(False, capacity=64)
    for sim in (graphed, eager):
        sim.tick()
        for _ in range(3):
            sim.run(12, guard_every=4)
    assert graphed.last_run_metrics == eager.last_run_metrics
    for x, y in zip(graphed.state.agents, eager.state.agents):
        assert torch.equal(x, y)
    assert graphed.cfg.capacity == eager.cfg.capacity > 64  # the guard grew it
    # one capture at the first tick, one a doubling
    assert graphed.graph_captures == 1 + (graphed.cfg.capacity // 64).bit_length() - 1


def test_a_state_is_copied_in_only_when_it_is_not_the_graphs():
    sim = _sim(True)
    step = sim._step
    sim.tick()  # the first tick: its eager result is copied in
    assert (step.captures, step.copies_in) == (1, 1)
    for _ in range(3):
        sim.tick()  # the graph's own output handed back: no copy
    assert step.copies_in == 1
    sim.state = sim.state._replace(step=sim.state.step)  # the same tensors
    sim.tick()
    assert step.copies_in == 1
    a = sim.state.agents
    sim.state = SimState(agents=AgentState(*(t.clone() for t in a)),
                         step=sim.state.step)  # an assignment
    sim.tick()
    assert step.copies_in == 2
    sim.state.agents.pos[0, 0] += 0.5  # written in place: the graph reads it
    before = sim.state.agents.pos[0].clone()
    sim.tick()
    assert step.copies_in == 2 and not torch.equal(sim.state.agents.pos[0], before)
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
    sim._grow()
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


def test_a_replay_adds_the_launches_its_capture_gave_back():
    def record(body, generator):
        body()  # a capture records the body's launches and runs nothing

        def replay():
            pass  # a replay launches them without their wrappers

        return replay

    kernels.zero_launch_counts()
    try:
        step = GraphedStep(torch.Generator(), capture=record)
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
    step = GraphedStep(torch.Generator(), capture=stand_in)
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


def test_capture_and_replay_open_their_spans_inside_the_tick():
    sim = _sim(True)
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
    assert first[("sim.capture", "sim.tick")] == 1
    assert first[("flat.step", "sim.capture")] == 1  # the warm-up, eager
    assert first[("sim.replay", "sim.tick")] == 0
    assert second[("sim.replay", "sim.tick")] == 1
    assert second[("sim.capture", "sim.tick")] == 0
    assert second[("sim.fetch", "sim.tick")] == 1


@pytest.mark.parametrize("advance", ["tick", "run"])
def test_agents_are_read_from_another_thread_only_between_steps(advance):
    """``list_pedestrians`` on a second thread, as the CLI's live views
    call it, while ``tick`` or ``run`` replays and grows: no read starts
    inside a replay (on a card the replay rewrites the state it would
    read), and each read is of one state whole."""
    stepping = threading.Event()

    def slow(body, generator):
        def replay():
            stepping.set()
            time.sleep(0.002)  # a long replay, for a read to fall into
            body()
            stepping.clear()

        return replay

    sim = _sim(False, capacity=48)  # the 40 placed at once pass 80%
    sim._graphed = GraphedStep(sim.generator, capture=slow)
    sim._build(sim.cfg.capacity)
    to_flat = sim._to_flat_state
    inside, reads = [], []

    def watched():
        inside.append(stepping.is_set())
        return to_flat()

    sim._to_flat_state = watched
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
        thread.join()
    assert sim.cfg.capacity > 48 and sim.graph_captures >= 2  # grown
    assert reads and not any(inside)
    assert all(n_pos == n_dest for n_pos, n_dest in reads)


# The one-device grid Simulator's graphed step (``sim.GraphedGridStep``):
# its buffer is the grid D, and the hybrid holds one graph a host key.


def _grid(graphed: bool, **options) -> Simulator:
    options = {"backend": "grid", "device": "cpu", "seed": 5, "capacity": 256,
               **options}
    sim = Simulator(SimulatorOptions(**options), loads_scenario(SCENARIO))
    if graphed:
        sim._graphed = GraphedGridStep(sim.generator, capture=stand_in)
        sim._build(sim.cfg.capacity)
    return sim


def _same_grid(a: Simulator, b: Simulator) -> None:
    assert a.options == b.options and a.state.step == b.state.step
    assert torch.equal(a.state.d.view(torch.int32), b.state.d.view(torch.int32))
    assert a.last_metrics == b.last_metrics


@pytest.mark.parametrize("path", ["full", "hybrid"])
def test_graphed_grid_ticks_equal_eager_across_growths_and_a_restore(path, tmp_path):
    """Ticks of the graphed grid Simulator equal the eager one's bit for bit
    through a table growth, (in the hybrid) a mover growth and a restore of
    an earlier checkpoint; each growth captures again, the restore (the
    same sizes) does not; the hybrid meets both of its keys between any two
    rebuilds (compact_every 4)."""
    kw = {"incremental_rebin": path == "hybrid", "compact_every": 4}
    graphed, eager = _grid(True, **kw), _grid(False, **kw)
    ckpt = tmp_path / "c.npz"
    for t in range(1, 41):
        for sim in (graphed, eager):
            sim.tick()
            if t == 5:
                checkpoint.save(sim, ckpt)
            if t == 12:
                sim._grow_table(0)
            if t == 20 and path == "hybrid":
                sim._grow_movers()
            if t == 28:
                checkpoint.restore(sim, ckpt)
        _same_grid(graphed, eager)
        own = t not in ((12, 20, 28) if path == "hybrid" else (12, 28))
        assert (graphed.state.d is graphed._step._inputs) == own
    assert graphed.options.table_capacity == 24
    builds = 3 if path == "hybrid" else 2
    assert graphed.graph_captures == builds * (2 if path == "hybrid" else 1)
    assert graphed._step.copies_in == graphed.graph_captures + 1  # + the restore
    assert eager.graph_captures == 0 and graphed.pedestrian_count > 40


def test_the_hybrid_captures_a_graph_a_branch():
    sim = _grid(True, incremental_rebin=True, compact_every=4)
    step = sim._step
    sim.tick()  # step 0: the full rebin's branch
    assert list(step._graphs) == [(True, False)]
    for _ in range(7):
        sim.tick()
    assert sorted(step._graphs) == [(False, False), (True, False)]
    assert (step.captures, step.copies_in) == (2, 2)


def test_a_grid_state_is_copied_in_only_when_it_is_not_the_graphs():
    sim = _grid(True, incremental_rebin=False)
    step = sim._step
    for _ in range(4):
        sim.tick()
    assert (step.captures, step.copies_in) == (1, 1)
    sim.state = sim.state._replace(d=sim.state.d.clone())  # an assignment
    sim.tick()
    assert (step.captures, step.copies_in) == (1, 2)
    assert sim.state.d is step._inputs


def test_graphed_grid_runs_equal_eager_with_the_lagged_guard():
    """``run`` replays, its lagged guard outside the graph grows the table
    as the eager Simulator's does."""
    kw = {"table_capacity": 4, "incremental_rebin": False}
    graphed, eager = _grid(True, **kw), _grid(False, **kw)
    for sim in (graphed, eager):
        sim.tick()
        for _ in range(3):
            sim.run(8, guard_every=4)
    assert graphed.last_run_metrics == eager.last_run_metrics
    assert graphed.options.table_capacity == eager.options.table_capacity > 4
    _same_grid(graphed, eager)
    k, grown = 4, 0
    while k < graphed.options.table_capacity:  # 4 -> 8 -> 12 -> 18 ...
        k, grown = k + max(4, k // 2), grown + 1
    assert graphed.graph_captures == 1 + grown


def test_turning_tracing_on_captures_the_hybrid_again():
    """Tracing adds to ``full_rebins`` inside the hybrid step, so it joins
    the host key: its graphs are captured again while it is on, and count
    the full rebins as the eager step does."""
    kw = {"incremental_rebin": True, "compact_every": 4}
    graphed, eager = _grid(True, **kw), _grid(False, **kw)
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
    _same_grid(graphed, eager)


def test_injected_candidates_and_the_timings_stay_eager():
    sim = _grid(True, incremental_rebin=False)
    for _ in range(3):
        sim.tick()
    step = sim._step
    before = sim.state.d.clone()
    assert sim.measure_kernel_time(2) > 0 and sim.measure_spawn_time(2) > 0
    assert torch.equal(sim.state.d, before) and step.captures == 1
    cand = spawn_sampler(sim.cfg, sim.device)(torch.Generator().manual_seed(3))
    state, _m = sim._step(sim.state, sim._fwp, sim._fobs, cand)
    assert state.d is not step._inputs and step.captures == 1
    sim.state = state
    sim.tick()
    assert step.copies_in == 2 and sim.state.d is step._inputs


def test_tiles_and_the_pallas_backend_step_eagerly():
    for options in ({"backend": "grid", "n_devices": 2}, {"backend": "pallas"}):
        sim = Simulator(SimulatorOptions(device="cpu", capacity=256, **options),
                        loads_scenario(SCENARIO))
        sim.tick()
        assert sim._graphed is None and sim.graph_captures == 0


def test_grid_capture_and_replay_open_their_spans_inside_the_tick():
    sim = _grid(True, incremental_rebin=False)
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
    assert first[("sim.capture", "sim.tick")] == 1
    assert first[("grid.step", "sim.capture")] == 1  # the warm-up, eager
    assert second[("sim.replay", "sim.tick")] == 1
    assert second[("sim.capture", "sim.tick")] == 0


def test_grid_agents_are_read_from_another_thread_only_between_steps():
    """The grid's reads (an unbinning of the graph's buffer) from a second
    thread while ``tick`` replays and the table grows: none inside a
    replay, each of one state whole."""
    stepping = threading.Event()

    def slow(body, generator):
        def replay():
            stepping.set()
            time.sleep(0.002)
            body()
            stepping.clear()

        return replay

    sim = _grid(False, table_capacity=4, incremental_rebin=False)
    sim._graphed = GraphedGridStep(sim.generator, capture=slow)
    sim._build(sim.cfg.capacity)
    to_flat = sim._to_flat_state
    inside, reads = [], []

    def watched():
        inside.append(stepping.is_set())
        return to_flat()

    sim._to_flat_state = watched
    done = threading.Event()

    def reader():
        while not done.is_set():
            pos, dest = sim.list_pedestrians()
            reads.append((len(pos), len(dest)))

    thread = threading.Thread(target=reader)
    thread.start()
    try:
        for _ in range(12):
            sim.tick()
    finally:
        done.set()
        thread.join(timeout=60)
    assert not thread.is_alive()
    assert sim.options.table_capacity > 4 and sim.graph_captures >= 2  # grown
    assert reads and not any(inside)
    assert all(n_pos == n_dest for n_pos, n_dest in reads)


@pytest.mark.parametrize("backend", ["xla", "grid"])
def test_a_step_lets_a_waiting_read_go_first(backend):
    """A read that waits for the step's lock goes before the next step, so
    that ticks back to back (the CLI's live views with no pacing) do not
    starve another thread's reads."""
    sim = (_sim(True) if backend == "xla"
           else _grid(True, incremental_rebin=False))
    sim.tick()
    to_flat = sim._to_flat_state
    read_at = []

    def watched():
        read_at.append(sim.step_count)
        return to_flat()

    sim._to_flat_state = watched
    thread = threading.Thread(target=sim.list_pedestrians)
    with sim._lock:  # a step under way
        thread.start()
        while not sim._readers:  # the read waits for the lock
            time.sleep(0.001)
        sim.tick()
    thread.join(timeout=60)
    assert not thread.is_alive()
    assert read_at == [1] and sim.step_count == 2
