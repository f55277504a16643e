"""The port's tiled grid step across two processes on the CPU: two ranks of
one ``torch.distributed`` gloo group (a ``FileStore`` under ``tmp_path``,
so that test workers never race for a port), each owning a block of whole
tile rows (parallel/transport.py::ProcessGroup), the counterpart of
tests/test_multihost.py's two ``jax.distributed`` processes:

- 8 x 1, 4 x 2 and 2 x 1 tiles (4, 4 and 1 a rank; 4 x 2: columns exchange
  within a rank, the middle row across), each on the full and the hybrid
  path, over parallel/tile2d.py's dryrun scenario (24 x 24 m, spawning)
  for 9 steps, so that the compaction of step 8 is included: every step's
  metrics equal on both ranks, equal to one process's tiled run and to the
  whole grid's, and the grid gathered on rank 0 equal to the whole grid
  (``torch.equal``);
- a 2-rank ``Simulator(backend="grid", n_devices=4, device="cpu")`` on
  gap.toml, K 8 and a mover table of 2, so that both tables grow (every
  rank re-bins the grid it gathers): each tick's metrics and a ``run``'s
  totals equal to the one-process Simulator's, the population read on
  both ranks, and reading the agents refused;
- a build whose ranks were given different seeds raises on both;
- ``transport.run_ranks`` kills every rank when one fails or its time
  limit passes.

Both ranks run all cases in one launch (``_worker``, this file run as a
script); ``transport.run_ranks`` kills both when one fails or the 120 s
limit passes, and the group has the same timeout, so the suite cannot
hang.
"""

import datetime
import os
import pathlib
import sys
import time

import pytest
import torch
import torch.distributed as dist

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from pedoni_tpu_torch import Simulator, SimulatorOptions, convert  # noqa: E402
from pedoni_tpu_torch import load_scenario  # noqa: E402
from pedoni_tpu_torch.field import Field, FieldMaps  # noqa: E402
from pedoni_tpu_torch.models import sfm_grid  # noqa: E402
from pedoni_tpu_torch.models.sfm import StepConfig, make_initial_state  # noqa: E402
from pedoni_tpu_torch.parallel import tile2d  # noqa: E402
from pedoni_tpu_torch.parallel.transport import (Local, ProcessGroup,  # noqa: E402
                                                 run_ranks)
from pedoni_tpu_torch.scenario import loads_scenario  # noqa: E402

torch.set_num_threads(1)

TIMEOUT = 120.0
STEPS = 9
TILES = [(8, 1), (4, 2), (2, 1)]
PATHS = {"full": dict(incremental=False), "hybrid": dict(incremental=True)}
GAP = ROOT / "scenarios" / "gap.toml"
SIM_OPTIONS = dict(backend="grid", device="cpu", table_capacity=8,
                   mover_capacity=2, incremental_rebin=True)
TICKS = 12


def _problem():
    sc = loads_scenario(tile2d.DRYRUN_SCENARIO)
    maps = FieldMaps.from_field(Field.from_scenario(sc, unit=0.25))
    cfg = StepConfig.build(sc, capacity=1024, neighbor_grid_unit=1.5,
                           table_capacity=8)
    return maps, cfg


def _run_tiles(tile, path, transport, device="cpu"):
    """STEPS tiled steps from the seed-0 initial state, every tile of this
    process on ``device``: (metrics a step, the gathered grid or None)."""
    maps, cfg = _problem()
    tcfg = tile2d.Tile2DConfig.build(cfg, *tile)
    devices = [device] * len(transport.tiles)
    gen = torch.Generator(device=device).manual_seed(0)
    state = tile2d.make_sharded_grid_state(
        tcfg, make_initial_state(cfg, gen, device), devices, transport, gen)
    fwp, fobs = tile2d.device_inputs(tcfg, maps, sfm_grid.stride_for(cfg),
                                     devices, transport)
    step = tile2d.make_sharded_step(tcfg, devices, generator=gen,
                                    transport=transport, **PATHS[path])
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, fwp, fobs)
        metrics.append(convert.metrics_to_dict(m))
    return metrics, tile2d.gather(tcfg, state, transport)


def _run_whole(path, device="cpu"):
    maps, cfg = _problem()
    gen = torch.Generator(device=device).manual_seed(0)
    gs = sfm_grid.make_initial_grid_state(cfg, gen, device)
    fwp, fobs = sfm_grid.field_tensors(cfg, maps, device)
    step = sfm_grid.make_step_grid(cfg, generator=gen, **PATHS[path])
    metrics = []
    for _ in range(STEPS):
        gs, m = step(gs, fwp, fobs)
        metrics.append(convert.metrics_to_dict(m))
    return metrics, gs.d


def _run_simulator(**kw):
    """TICKS ticks, then run(8): (metrics a tick, run totals, table sizes,
    population, the simulator)."""
    sim = Simulator(SimulatorOptions(**{**SIM_OPTIONS, **kw}), load_scenario(GAP))
    ticks = []
    for _ in range(TICKS):
        sim.tick()
        ticks.append(tuple(sim.last_metrics))
    sim.run(8, guard_every=2)
    return (ticks, tuple(sim.last_run_metrics),
            (sim.options.table_capacity, sim.options.mover_capacity),
            sim.pedestrian_count, sim)


def _worker(rank: int, store: str, out: str, backend: str = "gloo",
            device: str = "cpu") -> None:
    """One rank: every case, its results saved to ``out.rank``.  On a card
    (``device="cuda"``) gloo puts both ranks on cuda:0, NCCL rank r on
    cuda:r."""
    if device == "cuda":
        device = f"cuda:{rank if backend == 'nccl' else 0}"
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                            world_size=2,
                            timeout=datetime.timedelta(seconds=TIMEOUT))
    try:
        res = {}
        for tile in TILES:
            for path in PATHS:
                res[tile, path] = _run_tiles(tile, path,
                                             ProcessGroup(tile[0] * tile[1]), device)
        *sim_res, sim = _run_simulator(seed=1, n_devices=4,
                                       device=device.split(":")[0])
        try:
            sim.list_pedestrians()
            refused = ""
        except NotImplementedError as e:
            refused = str(e)
        res["simulator"] = (*sim_res, refused)
        try:
            Simulator(SimulatorOptions(**{**SIM_OPTIONS, "seed": rank,
                                          "device": device.split(":")[0]},
                                       n_devices=2), load_scenario(GAP))
            res["seeds"] = "built"
        except ValueError as e:
            res["seeds"] = str(e)
        torch.save(res, f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


def launch(tmp_dir, backend="gloo", device="cpu"):
    """Both ranks' results (``_worker``), one launch for every case."""
    out = str(pathlib.Path(tmp_dir) / "res")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    run_ranks(lambda r, store: [sys.executable, __file__, str(r), store, out,
                                backend, device],
              2, TIMEOUT, env=env, cwd=str(ROOT))
    return [torch.load(f"{out}.{r}", weights_only=False) for r in range(2)]


def check_case(ranks, tile, path, device="cpu"):
    """One tile case of both ranks against one process's tiled run and the
    whole grid on ``device``: the whole grid's metrics."""
    (m0, grid0), (m1, grid1) = ranks[0][tile, path], ranks[1][tile, path]
    local, local_grid = _run_tiles(tile, path, Local(tile[0] * tile[1]), device)
    whole, whole_grid = _run_whole(path, device)
    assert m0 == m1 == local == whole, (tile, path)
    assert grid1 is None
    assert torch.equal(grid0.to(device), whole_grid)
    assert torch.equal(local_grid, whole_grid)
    return whole


def check_simulator(ranks, device="cpu"):
    """Both ranks' Simulator against one process's (4 tiles on the CPU, one
    card on a card), and both refusing to read the agents and to build
    from different seeds: the one process's results."""
    one = _run_simulator(seed=1, n_devices=4 if device == "cpu" else 1,
                         device=device)[:4]
    for r in range(2):
        *got, refused = ranks[r]["simulator"]
        assert tuple(got) == one, r
        assert "across 2 processes is not supported" in refused
        assert "differs between the 2 processes" in ranks[r]["seeds"]
    return one


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return launch(tmp_path_factory.mktemp("multihost"))


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("tile", TILES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_two_ranks_equal_one_process_and_the_whole_grid(ranks, tile, path):
    whole = check_case(ranks, tile, path)
    assert sum(m["n_spawned"] for m in whole) > 0 and whole[-1]["n_active"] > 40


def test_two_rank_simulator_equals_one_process(ranks):
    """Ticks, a run's totals, table growth and the population, equal; the
    agents and a different seed refused."""
    one = check_simulator(ranks)
    assert one[2] != (8, 2)  # both tables grew


def test_process_group_needs_whole_tile_rows():
    """A process owns whole rows of tiles: 1 x 2 tiles do not split over 2."""
    class TwoRanks(Local):
        world = 2

    _, cfg = _problem()
    with pytest.raises(ValueError, match="rows must divide by the processes"):
        tile2d.make_sharded_step(tile2d.Tile2DConfig.build(cfg, 1, 2), ["cpu"],
                                 transport=TwoRanks(2))


@pytest.mark.parametrize("rank1,limit,said", [
    ("raise SystemExit(3)", 60, "a rank failed"),
    ("time.sleep(60)", 2, "timed out after 2 s"),
], ids=["one_fails", "time_limit"])
def test_run_ranks_kills_every_rank(rank1, limit, said):
    """Rank 0 would sleep a minute: when rank 1 fails, or the time limit
    passes, both are killed at once and the error names the cause."""
    code = ["import time; time.sleep(60)", f"import time; {rank1}"]
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=said):
        run_ranks(lambda r, _store: [sys.executable, "-c", code[r]], 2, limit)
    assert time.monotonic() - t0 < 30


def test_ranks_with_different_seeds_refuse_to_build(ranks):
    for r in range(2):
        assert "differs between the 2 processes" in ranks[r]["seeds"]


if __name__ == "__main__":
    _worker(int(sys.argv[1]), *sys.argv[2:])
