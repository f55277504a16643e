"""The hand-written CUDA kernels vs their plain PyTorch twins, on the card:
the step kernel (base, mover and segment modes, field strides 6 and 8,
grids built to break its cell tiles, and the grids of the benchmark's grid
cells: random.toml's and funnel.toml's jams at K 24 in one- and two-row
tiles, the 1M bench state in the mover mode; and its pair pass's occupancy
counter), the full and the incremental rebin
(and the grids of tests/test_torch_rebin_cases.py, built to break their
tiles and bit masks), the device gate that makes the hybrid step's choice,
the standalone pairwise kernel, the flat pair kernel up to K 255, the
flat sample, scatter and integrate kernels (with a flat step on the card
against the CPU), the grid step's spawn scatter kernel (with a spawning
grid step under sync debug mode "error"), and the flat and the grid
Simulator's steps as CUDA graph replays (``-k graphed``: bit-equal to the
eager step across a restore and growths, both branches of the hybrid, no
sync, their launches counted as the profiler sees them, their agents read
from a second thread; funnel.toml's jam growing the grid's table while a
graph is live, its ticks after the growth against the CPU twin's).

Needs an NVIDIA GPU and nvcc; skips elsewhere.  Imports neither JAX nor the
reference package, so it runs on a machine with only PyTorch:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

(the repository's conftest configures JAX, hence ``--noconftest``).
"""

import pathlib

import numpy as np
import pytest
import torch

from pedoni_tpu_torch import load_scenario, loads_scenario
from pedoni_tpu_torch.convert import agents_from_numpy
from pedoni_tpu_torch.field import Field, FieldMaps
from pedoni_tpu_torch.models import sfm_grid
from pedoni_tpu_torch.models.sfm import SimState, StepConfig
from pedoni_tpu_torch.ops.kernels import flat_pairwise as fpk
from pedoni_tpu_torch.ops.kernels import launch_counts, zero_launch_counts
from pedoni_tpu_torch.ops.kernels import flat_sample as fsk
from pedoni_tpu_torch.ops.kernels import pairwise as pw
from pedoni_tpu_torch.ops.kernels import rebin as rb
from pedoni_tpu_torch.ops.kernels import step_kernel as sk
from pedoni_tpu_torch.ops.kernels import tiles
from pedoni_tpu_torch.physics import Physics
from test_torch_flat_sample_cases import edge_case_agents
from test_torch_rebin_cases import CASES, rebin_case

SCENARIOS = pathlib.Path(__file__).resolve().parents[1] / "scenarios"
GAP = SCENARIOS / "gap.toml"


@pytest.fixture(scope="module")
def card_grid():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    sc = load_scenario(GAP)
    maps = FieldMaps.from_field(Field.from_scenario(sc, unit=0.25))
    cfg = StepConfig.build(sc, capacity=2048, neighbor_grid_unit=1.5,
                           table_capacity=12)
    rng = np.random.default_rng(3)
    n = 1200
    agents = agents_from_numpy(
        rng.uniform(0.5, 23.5, (n, 2)), rng.normal(0, 0.6, (n, 2)),
        np.clip(rng.normal(1.34, 0.26, n), 0.1, None), rng.integers(0, 2, n),
        np.ones(n, bool), "cuda")
    d = sfm_grid.bin_state(cfg, SimState(agents, 0)).d
    fwp, fobs = sfm_grid.field_tensors(cfg, maps, "cuda")
    return sc, cfg, d, fwp, fobs


@pytest.fixture(scope="module")
def cell_grids():
    """The grids of the grid step's cells on the card, each built once when
    a test first asks for it (pair_phases.step_grids): the 1M bench problem
    after its warm-up, random.toml's and funnel.toml's after the fill that
    grows their tables to K 24."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import pair_phases

    built = {}

    def get(name):
        if name not in built:
            built.update(pair_phases.step_grids(torch.device("cuda"), (name,)))
        return built[name]

    return get


@pytest.mark.cuda
@pytest.mark.parametrize("state", ["gap.toml crowd", "random.toml", "funnel.toml"])
def test_step_kernel_matches_twin(card_grid, cell_grids, state, monkeypatch):
    """The base mode against its twin: on gap.toml's seeded crowd, and bit
    for bit on random.toml's and funnel.toml's grids after the fill (K 24;
    the funnel's jam holds cells of 13 agents and more), in the one-row
    tiles the chooser picks there and in two-row tiles (the chooser held to
    two blocks an SM)."""
    if state == "gap.toml crowd":
        sc, cfg, d, fwp, fobs = card_grid
        before = sk.fused_step.launches
        got = sk.fused_step(d, fwp, fobs, cfg.physics, sc.size)
        want = sk.fused_step_torch(d, fwp, fobs, cfg.physics, sc.size)
        torch.cuda.synchronize()
        assert sk.fused_step.launches == before + 1
        assert torch.equal(got[:, :, 6], want[:, :, 6])
        held = (d[:, :, 6] > 0.5).unsqueeze(2).expand(-1, -1, 4, -1)
        assert float((got[:, :, 0:4] - want[:, :, 0:4]).abs()[held].max()) <= 1e-5
        assert torch.equal(got[:, :, 4:6], want[:, :, 4:6])
        assert torch.equal(got[0], torch.zeros_like(got[0]))
        return
    d, fwp, fobs, kw = cell_grids(state)
    ny2, k, _, nxl = d.shape
    assert k == 24 and int(d[:, 0, 7].max()) >= (13 if state == "funnel.toml" else 1)
    want = sk.fused_step_torch(d, fwp, fobs, **kw)
    for rows in (1, 2):
        monkeypatch.setattr(sk, "PAIR_BLOCKS_SM", 3 if rows == 1 else 2)
        assert sk.pair_pass_launch(k, ny2, nxl)[0] == rows
        before = sk.fused_step.launches
        got = sk.fused_step(d, fwp, fobs, **kw)
        torch.cuda.synchronize()
        assert sk.fused_step.launches == before + 1
        assert torch.equal(got, want), rows


@pytest.mark.cuda
def test_rebin_kernel_matches_twin(card_grid):
    sc, cfg, d, fwp, fobs = card_grid
    g = sk.fused_step_torch(d, fwp, fobs, cfg.physics, sc.size)
    before = rb.rebin.launches
    got = rb.rebin(g, 1.5, cfg.grid.nx, cfg.grid.ny)
    want = rb.rebin_torch(g, 1.5, cfg.grid.nx, cfg.grid.ny)
    torch.cuda.synchronize()
    assert rb.rebin.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("state", ["gap.toml crowd", "1M open field"])
def test_step_kernel_movers_matches_twin(card_grid, cell_grids, state):
    """The mover mode against its twin: on gap.toml's seeded crowd, and bit
    for bit on the 1M bench problem's state after its warm-up, as the
    hybrid runs it (two-row tiles)."""
    if state == "1M open field":
        d, fwp, fobs, kw = cell_grids(state)
        assert sk.pair_pass_launch(d.shape[1], d.shape[0], d.shape[3])[0] == 2
        before = sk.fused_step.mover_launches
        got = sk.fused_step(d, fwp, fobs, **kw)
        want = sk.fused_step_torch(d, fwp, fobs, **kw)
        torch.cuda.synchronize()
        assert sk.fused_step.mover_launches == before + 1
        for a, b in zip(got, want):  # G, M, movf, mdmx
            assert torch.equal(a, b)
        assert float(got[1][:, 0, 7].sum()) > 0  # some movers
        return
    sc, cfg, d, fwp, fobs = card_grid
    before = sk.fused_step.mover_launches
    got = sk.fused_step(d, fwp, fobs, cfg.physics, sc.size, emit_movers=6)
    want = sk.fused_step_torch(d, fwp, fobs, cfg.physics, sc.size, emit_movers=6)
    torch.cuda.synchronize()
    assert sk.fused_step.mover_launches == before + 1
    held = (d[:, :, 6] > 0.5).unsqueeze(2).expand(-1, -1, 4, -1)
    assert float((got[0][:, :, 0:4] - want[0][:, :, 0:4]).abs()[held].max()) <= 1e-5
    assert torch.equal(got[0][:, :, 4:8], want[0][:, :, 4:8])  # ch 7 = stay
    for a, b in zip(got[1:], want[1:]):  # M, movf, mdmx
        assert torch.equal(a, b)
    assert float(got[1][:, 0, 7].sum()) > 0  # some movers


@pytest.mark.cuda
@pytest.mark.parametrize("state", ["gap.toml crowd", "funnel.toml"])
def test_step_pairs_occupancy(card_grid, cell_grids, state):
    """The pair pass's occupancy counter (step_kernel.step_pairs_occupancy)
    on gap.toml's crowd and on the funnel's jam: both occupancies in (0, 1],
    no more pairs than candidates tested, no more of these than test slots,
    whole warps of lanes, the same counts from a second launch, and no
    launch counted in launch_counts(); past K 98 (levels in chunks) it
    raises."""
    if state == "funnel.toml":
        d, fwp, fobs, kw = cell_grids(state)
    else:
        sc, cfg, d, fwp, fobs = card_grid
        kw = dict(phys=cfg.physics, grid_size=sc.size)
    before = launch_counts()
    got = sk.step_pairs_occupancy(d, fwp, fobs, **kw)
    again = sk.step_pairs_occupancy(d, fwp, fobs, **kw)
    assert launch_counts() == before
    assert got == again
    assert 0 < got["body_occupancy"] <= 1 and 0 < got["walk_occupancy"] <= 1
    assert 0 < got["pairs"] <= got["tests"] <= got["walk_lanes"]
    assert got["body_lanes"] % 32 == 0 and got["walk_lanes"] % (9 * 32) == 0
    if state == "gap.toml crowd":
        big = _crowded_grid(120, seed=3)
        with pytest.raises(RuntimeError):
            sk.step_pairs_occupancy(*big[2:5], big[1].physics, big[0].size)


@pytest.mark.cuda
def test_rebin_incremental_kernel_matches_twin(card_grid):
    sc, cfg, d, fwp, fobs = card_grid
    g, m, _movf, _mdmx = sk.fused_step_torch(d, fwp, fobs, cfg.physics, sc.size,
                                             emit_movers=6)
    before = rb.rebin_incremental.launches
    got = rb.rebin_incremental(g, m, 1.5, cfg.grid.nx, cfg.grid.ny)
    want = rb.rebin_incremental_torch(g, m, 1.5, cfg.grid.nx, cfg.grid.ny)
    torch.cuda.synchronize()
    assert rb.rebin_incremental.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("flag", [rb.FULL, rb.INCREMENTAL])
def test_device_gate_runs_exactly_one_rebin(card_grid, flag):
    """Both rebins launched with one device flag: only the selected body
    writes the shared outputs (poisoned beforehand)."""
    sc, cfg, d, fwp, fobs = card_grid
    g, m, _movf, _mdmx = sk.fused_step_torch(d, fwp, fobs, cfg.physics, sc.size,
                                             emit_movers=6)
    gate = torch.tensor(flag, dtype=torch.int32, device="cuda")
    out = rb.new_outputs(g)
    out[0].fill_(float("nan"))
    rb.rebin(g, 1.5, cfg.grid.nx, cfg.grid.ny, gate=gate, out=out)
    rb.rebin_incremental(g, m, 1.5, cfg.grid.nx, cfg.grid.ny, gate=gate, out=out)
    want = (rb.rebin_torch(g, 1.5, cfg.grid.nx, cfg.grid.ny) if flag == rb.FULL
            else rb.rebin_incremental_torch(g, m, 1.5, cfg.grid.nx, cfg.grid.ny))
    torch.cuda.synchronize()
    for a, b in zip(out, want):
        assert torch.equal(a, b)


def _assert_step_close(d, got, want):
    """pos/vel of the slots that held agents within 1e-5, other channels
    equal."""
    torch.cuda.synchronize()
    assert torch.equal(got[:, :, 4:8], want[:, :, 4:8])
    held = (d[:, :, 6] > 0.5).unsqueeze(2).expand(-1, -1, 4, -1)
    assert float((got[:, :, 0:4] - want[:, :, 0:4]).abs()[held].max()) <= 1e-5


def _obstacles(sc):
    return [(s.line[0][0], s.line[0][1], s.line[1][0], s.line[1][1], s.width)
            for s in sc.obstacles]


@pytest.mark.cuda
@pytest.mark.parametrize("seg_pass", [False, True])
@pytest.mark.parametrize("scenario", ["gap.toml", "random.toml"])
def test_step_kernel_segments_matches_twin(card_grid, scenario, seg_pass,
                                           monkeypatch):
    """Segment mode with gap.toml's 2 obstacles and with random.toml's
    1000-row edge table (88 KB, past constant memory), base and mover
    output modes, the table walked by the sample pass and by the pair
    pass."""
    sc, cfg, d, fwp, fobs = card_grid
    segs = sk.segment_table(_obstacles(load_scenario(SCENARIOS / scenario)), "cuda")
    assert segs.shape[0] == (2 if scenario == "gap.toml" else 1000)
    monkeypatch.setattr(sk, "segment_pass", lambda n_seg: seg_pass)
    before = sk.fused_step.segment_launches
    got = sk.fused_step(d, fwp, fobs, cfg.physics, sc.size, segments=segs)
    want = sk.fused_step_torch(d, fwp, fobs, cfg.physics, sc.size, segments=segs)
    _assert_step_close(d, got, want)
    got = sk.fused_step(d, fwp, fobs, cfg.physics, sc.size, segments=segs,
                        emit_movers=6)
    want = sk.fused_step_torch(d, fwp, fobs, cfg.physics, sc.size,
                               segments=segs, emit_movers=6)
    _assert_step_close(d, got[0], want[0])
    for a, b in zip(got[1:], want[1:]):  # M, movf, mdmx
        assert torch.equal(a, b)
    assert sk.fused_step.segment_launches == before + 2


@pytest.mark.cuda
def test_step_kernel_stride8_matches_twin():
    """The all-pairs unit: 2.0 m cells over 0.25 m fields (stride 8)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    sc = load_scenario(GAP)
    maps = FieldMaps.from_field(Field.from_scenario(sc, unit=0.25))
    cfg = StepConfig.build(sc, capacity=2048, neighbor_grid_unit=2.0,
                           table_capacity=20, use_neighbor_grid=False)
    rng = np.random.default_rng(4)
    n = 1200
    agents = agents_from_numpy(
        rng.uniform(0.5, 23.5, (n, 2)), rng.normal(0, 0.6, (n, 2)),
        np.clip(rng.normal(1.34, 0.26, n), 0.1, None), rng.integers(0, 2, n),
        np.ones(n, bool), "cuda")
    d = sfm_grid.bin_state(cfg, SimState(agents, 0)).d
    fwp, fobs = sfm_grid.field_tensors(cfg, maps, "cuda")
    assert fwp.shape[2] == 8
    got = sk.fused_step(d, fwp, fobs, cfg.physics, sc.size, stride=8)
    want = sk.fused_step_torch(d, fwp, fobs, cfg.physics, sc.size, stride=8)
    _assert_step_close(d, got, want)


def _gap_grid(unit, k, pos, seed, dest=None):
    """gap.toml's fields (two waypoint planes, NXL = 128) with agents at
    ``pos``: (sc, cfg, d, fwp, fobs, stride) on the card."""
    sc = load_scenario(GAP)
    maps = FieldMaps.from_field(Field.from_scenario(sc, unit=0.25))
    cfg = StepConfig.build(sc, capacity=4096, neighbor_grid_unit=unit,
                           table_capacity=k, use_neighbor_grid=unit == 1.5)
    rng = np.random.default_rng(seed)
    n = pos.shape[0]
    agents = agents_from_numpy(
        pos, rng.normal(0, 0.6, (n, 2)),
        np.clip(rng.normal(1.34, 0.26, n), 0.1, None),
        rng.integers(0, 2, n) if dest is None else dest, np.ones(n, bool), "cuda")
    d = sfm_grid.bin_state(cfg, SimState(agents, 0)).d
    fwp, fobs = sfm_grid.field_tensors(cfg, maps, "cuda")
    return sc, cfg, d, fwp, fobs, sfm_grid.stride_for(cfg)


# case -> (K, (tile rows, threads, blocks an SM) that pair_pass_launch gives)
TALL_K = {"k40_one_row_tiles": (40, (1, 512, 2)),
          "k50_one_block_an_sm": (50, (2, 512, 1)),
          "k70_one_row_one_block": (70, (1, 512, 1))}


def _tile_case(name):
    """(sc, cfg, d, fwp, fobs, stride, row_block) of one grid built to break
    a design that tiles the cells."""
    rng = np.random.default_rng(11)
    crowd = rng.uniform(0.01, 23.99, (1500, 2))  # lanes 1 and nx included
    if name == "full_cell_among_empty":
        # one cell at exactly K agents, its 8 neighbours empty, a second
        # full cell diagonally two cells off, a lone agent in a corner
        k = 12
        pos = np.concatenate([
            rng.uniform(0.02, 1.48, (k, 2)) + [9.0, 9.0],
            rng.uniform(0.02, 1.48, (k, 2)) + [12.0, 12.0], [[0.3, 23.5]]])
        case = _gap_grid(1.5, k, pos, 1)
        assert int(case[2][:, 0, 7].max()) == k
        return (*case, 2)
    if name == "holes_below_the_top_slot":
        # the state an incremental rebin leaves: slots 0 and 2 of every
        # second cell emptied, the bound (ch 7) still the top slot + 1
        case = _gap_grid(1.5, 14, crowd, 2)
        d = case[2]
        bound = d[:, 0, 7].clone()
        d[:, 0, :, ::2] = 0.0
        d[:, 2, :, ::2] = 0.0
        d[:, 0, 7] = bound
        assert bool(((d[:, :, 6] > 0.5).sum(dim=1) < bound).any())
        return (*case, 2)
    if name == "odd_centre_rows":
        # 15 centre rows (the last tile ragged); the cut-off row acts as the
        # ghost row and its agents as candidates only
        sc, cfg, d, fwp, fobs, stride = _gap_grid(1.5, 14, crowd, 3)
        d = d[:-1].contiguous()
        assert (d.shape[0] - 2) % 2 == 1 and bool((d[-1, :, 6] > 0.5).any())
        return sc, cfg, d, fwp, fobs, stride, 1
    if name == "k29_stride8":
        case = _gap_grid(2.0, 29, np.concatenate(
            [crowd, rng.uniform(0.02, 1.98, (29, 2)) + [10.0, 6.0]]), 4)
        assert case[2].shape[1] == 29 and case[5] == 8
        return (*case, 2)
    if name in TALL_K:
        # a K past the bench's: the pair pass leaves its 2-row tile and its
        # two blocks an SM; one cell holds exactly K agents
        k, launch = TALL_K[name]
        case = _gap_grid(1.5, k, np.concatenate(
            [crowd, rng.uniform(0.02, 1.48, (k, 2)) + [9.0, 12.0]]), 6)
        ny2, kk, _, nxl = case[2].shape
        assert kk == k and int(case[2][:, 0, 7].max()) == k
        rows, threads, smem, _levels = sk.pair_pass_launch(k, ny2, nxl)
        assert (rows, threads) == launch[:2]
        assert (2 * (smem + tiles.SMEM_BLOCK_RESERVED) <= tiles.SMEM_SM) == (launch[2] == 2)
        return (*case, 2)
    if name == "single_centre_row":
        # ny2 = 3: one tile row however small K is; row 2 is the ghost row
        sc, cfg, d, fwp, fobs, stride = _gap_grid(1.5, 14, crowd, 7)
        d = d[:3].contiguous()
        assert sk.pair_pass_launch(14, 3, 128)[0] == 1
        assert bool((d[1, :, 6] > 0.5).any()) and bool((d[2, :, 6] > 0.5).any())
        return sc, cfg, d, fwp, fobs, stride, 1
    if name == "edge_lanes_only":
        # agents only in lanes 1 and nx, one waypoint plane each
        n = 300
        x = np.where(np.arange(n) % 2 == 0, rng.uniform(0.01, 1.49, n),
                     rng.uniform(22.51, 23.99, n))
        pos = np.stack([x, rng.uniform(0.01, 23.99, n)], axis=1)
        return (*_gap_grid(1.5, 14, pos, 5, dest=np.arange(n) % 2), 2)
    raise ValueError(name)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["full_cell_among_empty",
                                  "holes_below_the_top_slot", "odd_centre_rows",
                                  "k29_stride8", "edge_lanes_only",
                                  "single_centre_row", *TALL_K])
def test_step_kernel_tile_edges(case):
    """Kernel vs twin, base and mover mode, on gap.toml's fields (NXL = 128,
    two waypoint planes with the agents split between them)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    sc, cfg, d, fwp, fobs, stride, rb = _tile_case(case)
    assert d.shape[3] == 128 and fwp.shape[0] == 2
    assert len(torch.unique(d[:, :, 5][d[:, :, 6] > 0.5])) == 2
    kw = dict(stride=stride, row_block=rb)
    got = sk.fused_step(d, fwp, fobs, cfg.physics, sc.size, **kw)
    want = sk.fused_step_torch(d, fwp, fobs, cfg.physics, sc.size, **kw)
    _assert_step_close(d, got, want)
    assert torch.equal(got[[0, -1]], torch.zeros_like(got[[0, -1]]))
    got = sk.fused_step(d, fwp, fobs, cfg.physics, sc.size, emit_movers=6, **kw)
    want = sk.fused_step_torch(d, fwp, fobs, cfg.physics, sc.size,
                               emit_movers=6, **kw)
    _assert_step_close(d, got[0], want[0])
    for a, b in zip(got[1:], want[1:]):  # M, movf, mdmx
        assert torch.equal(a, b)
    assert float(want[0][:, :, 6].sum()) > 0  # agents survive the step


# case -> (tile rows, tile lanes) that rebin_launch gives the full and the
# incremental rebin where it leaves the bench's 2 x 64
REBIN_TILES = {"k150": ((2, 32), (2, 64)), "row_block_1": ((1, 64), (1, 64))}


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_rebin_tile_edges(case):
    """Both rebin kernels vs their twins, bit-equal on all five outputs, on
    the grids of tests/test_torch_rebin_cases.py; D' is poisoned beforehand,
    so a slot the kernel leaves unwritten shows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    c = rebin_case(case)
    g, gi, m = (torch.from_numpy(c[name]).cuda() for name in ("g", "gi", "m"))
    ny2, k, _, nxl = g.shape
    tiles = REBIN_TILES.get(case, ((2, 64), (2, 64)))
    assert rb.rebin_launch(k, 0, ny2, nxl, c["rb"])[:2] == tiles[0]
    assert rb.rebin_launch(k, c["mk"], ny2, nxl, c["rb"])[:2] == tiles[1]
    args = (c["unit"], c["nx"], c["ny"], c["rb"])
    runs = ((rb.rebin, rb.rebin_torch, (g,)),
            (rb.rebin_incremental, rb.rebin_incremental_torch, (gi, m)))
    for kernel, twin, ins in runs:
        out = rb.new_outputs(g, c["rb"])
        out[0].fill_(float("nan"))
        got = kernel(*ins, *args, out=out)
        want = twin(*ins, *args)
        torch.cuda.synchronize()
        for name, a, b in zip(("D'", "ovf", "dmx", "nin", "nout"), got, want):
            assert torch.equal(a, b), f"{kernel.__name__} {name}"
        assert float(want[4].sum()) > 0  # agents survive the rebin


@pytest.mark.cuda
def test_pairwise_kernel_matches_twin():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    rng = np.random.default_rng(2)
    ny2, k, nx = 18, 8, 128
    d = np.zeros((ny2, k, 8, nx), np.float32)
    occ = rng.uniform(size=(ny2 - 2, k, 40)) < 0.4
    r, j, c = np.nonzero(occ)
    d[r + 1, j, 0, c + 1] = (c + rng.uniform(size=r.size)) * 1.4
    d[r + 1, j, 1, c + 1] = (r + rng.uniform(size=r.size)) * 1.4
    d[r + 1, j, 2:4, c + 1] = rng.normal(0, 1, (r.size, 2))
    e = rng.normal(0, 1, (r.size, 2))
    d[r + 1, j, 4:6, c + 1] = e / np.linalg.norm(e, axis=1, keepdims=True)
    d[r + 1, j, 6, c + 1] = 1.0
    dt = torch.from_numpy(d).cuda()
    before = pw.pairwise.launches
    got = pw.pairwise(dt, Physics(), row_block=4)
    want = pw.pairwise_torch(dt, Physics(), row_block=4)
    torch.cuda.synchronize()
    assert pw.pairwise.launches == before + 1
    assert float((got - want).abs().max()) <= 1e-5
    assert float(want.abs().max()) > 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("seg_pass", [False, True])
def test_step_kernel_segments_random_toml_cull(seg_pass, monkeypatch):
    """Segment mode on random.toml's own fields and 1000-row edge table:
    ~2000 seeded agents over the 200 x 200 m field, some inside rectangles
    and some 20 to 24 m from one, so the pair pass's tiles keep and drop
    rows on both sides of the cull distance; kernel vs twin in base and
    mover mode, the table walked by the sample pass and by the pair pass."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from pedoni_tpu_torch import Simulator, SimulatorOptions
    sim = Simulator(SimulatorOptions(backend="grid", device="cuda", seed=1, use_distance_map=False),
                    load_scenario(SCENARIOS / "random.toml"))
    cfg = sim.cfg
    segs = sfm_grid.debug_segments(cfg, "cuda")
    assert segs.shape[0] == 1000
    rng = np.random.default_rng(9)
    o = np.asarray(_obstacles(cfg.scenario), np.float64)
    mid = 0.5 * (o[:, 0:2] + o[:, 2:4])
    seg = o[:, 2:4] - o[:, 0:2]
    normal = np.stack([seg[:, 1], -seg[:, 0]], 1) / np.linalg.norm(seg, axis=1)[:, None]
    ring = mid + normal * (0.5 * o[:, 4:5] + rng.uniform(20.0, 24.0, (len(o), 1)))
    ring = ring[((ring > 0.5) & (ring < 199.5)).all(axis=1)][:300]
    pos = np.concatenate([rng.uniform(0.5, 199.5, (1500, 2)),
                          mid[rng.choice(len(o), 200, replace=False)], ring])
    n = pos.shape[0]
    agents = agents_from_numpy(
        pos, rng.normal(0, 0.6, (n, 2)), np.clip(rng.normal(1.34, 0.26, n), 0.1, None),
        rng.integers(0, 4, n), np.ones(n, bool), "cuda")
    d = sfm_grid.bin_state(cfg, SimState(agents, 0)).d
    stride = sfm_grid.stride_for(cfg)
    args = (d, sim._fwp, sim._fobs, cfg.physics, cfg.scenario.size)
    monkeypatch.setattr(sk, "segment_pass", lambda n_seg: seg_pass)
    got = sk.fused_step(*args, stride=stride, segments=segs)
    want = sk.fused_step_torch(*args, stride=stride, segments=segs)
    _assert_step_close(d, got, want)
    assert float(want[:, :, 6].sum()) > 1000
    got = sk.fused_step(*args, stride=stride, segments=segs, emit_movers=8)
    want = sk.fused_step_torch(*args, stride=stride, segments=segs, emit_movers=8)
    _assert_step_close(d, got[0], want[0])
    for a, b in zip(got[1:], want[1:]):  # M, movf, mdmx
        assert torch.equal(a, b)


def _pairwise_grid(k, nx, ny_pad, seed):
    """A 2D input [ny_pad + 2, K, 8, NX] on the card: agents in every row
    (ghost rows included) and lane, lane NX-1 placed left of lane 0 so that
    the lane wrap brings them within the cutoff, some slots inactive, unit
    e; and the one NaN-position active agent's slot."""
    rng = np.random.default_rng(seed)
    ny2 = ny_pad + 2
    d = np.zeros((ny2, k, 8, nx), np.float32)
    occ = rng.uniform(size=(ny2, k, nx)) < 0.45
    occ[:, 0, [0, nx - 1]] = True  # the edge lanes hold agents
    r, j, c = np.nonzero(occ)
    x = np.where(c == nx - 1, -1, c)  # lane NX-1 sits left of lane 0
    d[r, j, 0, c] = (x + rng.uniform(size=r.size)) * 1.4
    d[r, j, 1, c] = (r - 1 + rng.uniform(size=r.size)) * 1.4
    d[r, j, 2:4, c] = rng.normal(0, 1, (r.size, 2))
    e = rng.normal(0, 1, (r.size, 2))
    d[r, j, 4:6, c] = e / np.linalg.norm(e, axis=1, keepdims=True)
    d[r, j, 6, c] = (rng.uniform(size=r.size) > 0.15).astype(np.float32)
    nan_at = (2, 0, 1)  # (row, slot, lane): next to the wrapped lane 0
    d[nan_at[0], nan_at[1], 6, nan_at[2]] = 1.0
    d[nan_at[0], nan_at[1], 0:2, nan_at[2]] = np.nan
    return torch.from_numpy(d).cuda(), nan_at


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 8, 14, 29])
@pytest.mark.parametrize("nx", [128, 256])
def test_pairwise_tile_edges(k, nx):
    """2D vs its twin on grids built to break the tiles: the lane wrap,
    ny_pad = 7 (the last two-row tile ragged), ghost-row candidates,
    inactive centres, and one active candidate at a NaN position, which
    fails every cutoff test in the kernel: it is held to the twin with that
    slot made inactive and moved out of reach (the twin's 0 * NaN would
    spread the NaN over its neighbours)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    d, (r, j, c) = _pairwise_grid(k, nx, 7, seed=k + nx)
    assert pw.pairwise_launch(k, d.shape[0], nx)[0] == 2
    before = pw.pairwise.launches
    got = pw.pairwise(d, Physics(), row_block=1)
    torch.cuda.synchronize()
    assert pw.pairwise.launches == before + 1
    ref = d.clone()
    ref[r, j, 6, c] = 0.0
    ref[r, j, 0:2, c] = 1e4
    want = pw.pairwise_torch(ref, Physics(), row_block=1)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-5
    assert float(want.abs().max()) > 0.1
    # the wrap matters: lane 0's accelerations differ without it
    cut = ref.clone()
    cut[:, :, 6, nx - 1] = 0.0
    assert not torch.equal(pw.pairwise_torch(cut, Physics(), row_block=1)[:, :, :, 0],
                           want[:, :, :, 0])


@pytest.mark.cuda
def test_rebin_incremental_lands_rows_past_the_count():
    """2B on a hand-made M whose rows past a cell's count (ch 7) hold a
    mover (ch 6 set): the kernel lands them as the twin does, bit-equal on
    all five outputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    c = rebin_case("k14_mk8")
    m = c["m"].copy()
    m[:, :, 7] = np.maximum(m[:, :, 7] - 1.0, 0.0)
    assert (m[:, :, 6] > 0.5).sum() > (m[:, 0, 7]).sum() + 10
    gi, m = torch.from_numpy(c["gi"]).cuda(), torch.from_numpy(m).cuda()
    args = (c["unit"], c["nx"], c["ny"], c["rb"])
    got = rb.rebin_incremental(gi, m, *args)
    want = rb.rebin_incremental_torch(gi, m, *args)
    torch.cuda.synchronize()
    for name, a, b in zip(("D'", "ovf", "dmx", "nin", "nout"), got, want):
        assert torch.equal(a, b), name


def _crowded_grid(k, seed):
    """gap.toml's fields (NXL = 128) with a crowd and three cells filled to
    K, K - 9 and K // 2 agents side by side and diagonally, so that a pair
    pass walks every slot level of a tile and its halo."""
    rng = np.random.default_rng(seed)
    pos = np.concatenate([
        rng.uniform(0.01, 23.99, (1500, 2)),
        rng.uniform(0.02, 1.48, (k, 2)) + [9.0, 9.0],
        rng.uniform(0.02, 1.48, (k - 9, 2)) + [10.5, 9.0],
        rng.uniform(0.02, 1.48, (k // 2, 2)) + [12.0, 10.5]])
    case = _gap_grid(1.5, k, pos, seed)
    assert int(case[2][:, 0, 7].max()) == k
    return case


@pytest.mark.cuda
@pytest.mark.parametrize("k", [98, 120, 255])
def test_pair_passes_at_large_k(k, monkeypatch):
    """Past K 97 a one-row tile's slot levels no longer fit a block's shared
    memory and the pair passes stage them in chunks: the step kernel (base
    and mover mode, segment mode with the table walked by the pair pass)
    and 2D equal their twins bit for bit, as they do at small K."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    sc, cfg, d, fwp, fobs, stride = _crowded_grid(k, seed=k)
    ny2, _, _, nxl = d.shape
    assert sk.pair_pass_launch(k, ny2, nxl, segments=True)[3] < k
    assert (sk.pair_pass_launch(k, ny2, nxl)[3] < k) == (k > 98)
    assert pw.pairwise_launch(k, ny2, nxl)[3] < k
    args = (d, fwp, fobs, cfg.physics, sc.size)
    got = sk.fused_step(*args)
    want = sk.fused_step_torch(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    got = sk.fused_step(*args, emit_movers=8)
    want = sk.fused_step_torch(*args, emit_movers=8)
    torch.cuda.synchronize()
    for a, b in zip(got, want):  # G, M, movf, mdmx
        assert torch.equal(a, b)
    monkeypatch.setattr(sk, "segment_pass", lambda n_seg: True)
    segs = sk.segment_table(_obstacles(sc), "cuda")
    got = sk.fused_step(*args, segments=segs)
    want = sk.fused_step_torch(*args, segments=segs)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    e = torch.randn((ny2, k, 2, nxl), generator=torch.Generator("cuda").manual_seed(k),
                    device="cuda")
    d2 = d.clone()
    d2[:, :, 4:6] = e / e.norm(dim=2, keepdim=True)
    got = pw.pairwise(d2, Physics(), row_block=2)
    want = pw.pairwise_torch(d2, Physics(), row_block=2)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and float(want.abs().max()) > 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [(2, 2), (1, 3)])
def test_kernels_at_tile_offsets(tile):
    """Each tile of gap.toml's grid cut into tiles (parallel/tile2d.py),
    its ghosts exchanged: the step kernel (base and mover mode) and both
    rebins with the tile's row and column offsets equal their twins bit for
    bit on all outputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from pedoni_tpu_torch.parallel import tile2d
    sc, cfg, d, fwp, fobs, stride = _crowded_grid(14, seed=5)
    tcfg = tile2d.Tile2DConfig.build(cfg, *tile)
    devices = ["cuda"] * tcfg.n_devices
    flat = sfm_grid.unbin_state(cfg, sfm_grid.GridState(d, 0))
    tiles = list(tile2d.make_sharded_grid_state(tcfg, flat, devices).d)
    tile2d.exchange(tcfg, tiles)
    maps = FieldMaps.from_field(Field.from_scenario(sc, unit=0.25))
    fwps, fobss = tile2d.device_inputs(tcfg, maps, stride, devices)
    unit, nx, ny = cfg.grid.unit, cfg.grid.nx, cfg.grid.ny
    for i, (dt, wp, ob) in enumerate(zip(tiles, fwps, fobss)):
        r0, c0 = tcfg.origin(i)
        off = dict(row_offset=r0, col_offset=c0, nx_local=tcfg.cols_local)
        args = (dt, wp, ob, cfg.physics, sc.size)
        g = sk.fused_step(*args, **off)
        g_t = sk.fused_step_torch(*args, **off)
        mv = sk.fused_step(*args, emit_movers=6, **off)
        mv_t = sk.fused_step_torch(*args, emit_movers=6, **off)
        torch.cuda.synchronize()
        assert torch.equal(g, g_t)
        for a, b in zip(mv, mv_t):
            assert torch.equal(a, b)
        # the wrappers run the twins on CPU tensors
        for kernel, ins in ((rb.rebin, (g_t,)),
                            (rb.rebin_incremental, (mv_t[0], mv_t[1]))):
            got = kernel(*ins, unit, nx, ny, **off)
            want = kernel(*(t.cpu() for t in ins), unit, nx, ny, **off)
            for a, b in zip(got, want):
                assert torch.equal(a.cpu(), b)
        assert float(g_t[:, :, 6].sum()) > 0


@pytest.mark.cuda
def test_cli_more_devices_than_cards_exits_naming_the_count(tmp_path):
    """On the card, tile i runs on cuda:i: asking for one device more than
    the machine has exits non-zero before any step, naming the count (the
    reference's message); it never falls back to fewer tiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import subprocess
    import sys
    n = torch.cuda.device_count()
    r = subprocess.run([sys.executable, "-m", "pedoni_tpu_torch", str(GAP), "-H",
                        "--devices", str(n + 1), "--max-steps", "1",
                        "--log-dir", str(tmp_path)],
                       cwd=pathlib.Path(__file__).resolve().parents[1],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert f"--devices {n + 1} but only {n} devices are visible" in r.stderr
    assert not list(tmp_path.glob("*_log.json"))


@pytest.mark.cuda
def test_launch_off_the_current_card_is_refused():
    """A kernel launches on the current card.  A grid on cuda:1 handed to a
    launcher while cuda:0 is current is refused by the launcher's device
    check (csrc/device.cuh); through the wrappers, which make the grid's
    card current, the step kernel, both rebins and 2D run on cuda:1 and
    equal the same kernels on cuda:0 bit for bit."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: tiles run on cuda:i")
    from pedoni_tpu_torch.ops.kernels import _build
    sc, cfg, d, fwp, fobs, stride = _crowded_grid(14, seed=3)
    on1 = [t.to("cuda:1") for t in (d, fwp, fobs)]
    unit, nx, ny = cfg.grid.unit, cfg.grid.nx, cfg.grid.ny
    ny2, k, _, nxl = d.shape
    phys, size = cfg.physics, sc.size

    def run(d, fwp, fobs):
        g, m = sk.fused_step(d, fwp, fobs, phys, size, emit_movers=8)[:2]
        outs = (sk.fused_step(d, fwp, fobs, phys, size),
                rb.rebin(g, unit, nx, ny)[0],
                rb.rebin_incremental(g, m, unit, nx, ny)[0],
                pw.pairwise(d, Physics(), row_block=2))
        torch.cuda.synchronize(d.device)
        return outs

    lib = _build.library()
    with torch.cuda.device(0):
        out = rb.new_outputs(on1[0])
        rc = lib.pedoni_rebin_full(
            on1[0].data_ptr(), out[0].data_ptr(), *rb._ptrs(out, None), rb.FULL,
            ny2, k, nxl, 2, unit, nx, ny, 0, 0, nx,
            *rb.rebin_launch(k, 0, ny2, nxl, 2), None)
        assert rc == _build.WRONG_DEVICE
        with pytest.raises(RuntimeError, match="not on the current CUDA device"):
            _build.check_launch(rc, "pedoni_rebin_full")
        want = run(d, fwp, fobs)
        got = run(*on1)
    assert all(t.device == torch.device("cuda", 1) for t in got)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("incremental", [False, True])
def test_tiles_on_several_cards(incremental):
    """Simulator(n_devices=n) puts tile i on cuda:i: corridor.toml (two
    periodic streams) on 2 x 2 tiles over four cards (1 x 2 over two)
    equals one card's run, every metric each tick and the agents after it,
    on the full path and on the hybrid (``compact_every=1000``)."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA devices or more: tile i runs on cuda:i")
    from pedoni_tpu_torch import Simulator, SimulatorOptions
    tile = (2, 2) if n >= 4 else (1, 2)
    n_t = tile[0] * tile[1]
    sc = load_scenario(SCENARIOS / "corridor.toml")
    opts = dict(device="cuda", seed=3, incremental_rebin=incremental,
                compact_every=1000 if incremental else 8)
    one = Simulator(SimulatorOptions(backend="grid", **opts), sc)
    tiled = Simulator(SimulatorOptions(backend="grid", n_devices=n_t, tile=tile, **opts), sc)
    assert [t.device for t in tiled.state.d] == [torch.device("cuda", i)
                                                 for i in range(n_t)]
    spawned = 0
    for _ in range(60):
        one.tick()
        tiled.tick()
        assert tiled.last_metrics == one.last_metrics
        spawned += one.last_metrics.n_spawned
    assert spawned > 0 and one.last_metrics.n_active > 0
    for a, b in zip(one.list_pedestrians(), tiled.list_pedestrians()):
        assert np.array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n_wp", [8, 33])
def test_kernels_at_many_waypoints(n_wp):
    """The bench problem at W = 8 and 33 on one 128-lane tile (20 000
    agents, ``bench.build_problem(domain="tiles:1")``): the step kernel in
    base and mover mode equal to its twin (pos/vel within 1e-5), both
    rebins bit-equal on the twin's outputs, the mover mode's M, movf and
    mdmx equal; and a step's peak memory within ``device_bytes`` and the
    caching allocator's slack: it keeps a block whole where the rest would
    be 1 MiB or less, so each of the step's nine large tensors (D, G, D',
    act', (e, acc), M, fwp, fobs, the packed copy) may take up to 1 MiB
    more than its bytes.  At this size that slack exceeds the margin the
    freed scratch leaves (chip_smoke.py holds the 1M steps to
    ``device_bytes`` itself)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from pedoni_tpu_torch.bench import build_problem
    _sc, maps, cfg, flat = build_problem(20_000, waypoints=n_wp,
                                         domain="tiles:1", device="cuda")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fwp, fobs = sfm_grid.field_tensors(cfg, maps, "cuda")
    gs = sfm_grid.bin_state(cfg, flat)
    step = sfm_grid.make_step_grid(cfg)
    for _ in range(3):
        gs, m = step(gs, fwp, fobs)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    need = sfm_grid.device_bytes(cfg)
    assert peak <= need + 9 * 2**20, (peak, need)
    assert int(m.n_active) > 15_000
    d = gs.d
    assert set(d[:, :, 5][d[:, :, 6] > 0.5].unique().long().tolist()) \
        == set(range(n_wp))
    phys, size = cfg.physics, cfg.scenario.size
    got = sk.fused_step(d, fwp, fobs, phys, size)
    want = sk.fused_step_torch(d, fwp, fobs, phys, size)
    _assert_step_close(d, got, want)
    mv = sk.fused_step(d, fwp, fobs, phys, size, emit_movers=8)
    mv_t = sk.fused_step_torch(d, fwp, fobs, phys, size, emit_movers=8)
    _assert_step_close(d, mv[0], mv_t[0])
    for a, b in zip(mv[1:], mv_t[1:]):
        assert torch.equal(a, b)
    unit, nx, ny = cfg.grid.unit, cfg.grid.nx, cfg.grid.ny
    for kernel, twin, ins in ((rb.rebin, rb.rebin_torch, (want,)),
                              (rb.rebin_incremental, rb.rebin_incremental_torch,
                               mv_t[:2])):
        got_r = kernel(*ins, unit, nx, ny)
        want_r = twin(*ins, unit, nx, ny)
        torch.cuda.synchronize()
        for a, b in zip(got_r, want_r):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_supports_reads_the_card_memory(monkeypatch):
    """``card_free_bytes`` is mem_get_info's free memory plus what the
    caching allocator holds unused; ``supports`` compares ``device_bytes``
    with it; ``Simulator`` and the bench refuse a step that does not fit
    before allocating its grid, naming the bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pedoni_tpu_torch import Simulator, SimulatorOptions, bench
    free, total = torch.cuda.mem_get_info()
    card = sfm_grid.card_free_bytes()
    assert free <= card <= total
    sc = load_scenario(GAP)
    cfg = StepConfig.build(sc, capacity=2048, neighbor_grid_unit=1.5,
                           table_capacity=14)
    need = sfm_grid.device_bytes(cfg)
    assert sfm_grid.supports(cfg) and need < card
    assert not sfm_grid.supports(cfg, free_bytes=need - 1)
    monkeypatch.setattr(sfm_grid, "card_free_bytes", lambda device="cuda": 4096)
    before = torch.cuda.memory_allocated()
    with pytest.raises(ValueError, match="bytes on cuda and 4096 are free"):
        Simulator(SimulatorOptions(backend="grid", device="cuda"), sc)
    with pytest.raises(ValueError, match="bytes on cuda and 4096 are free"):
        bench.capture(bench.build_parser().parse_args(["--agents", "20000"]))
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() - before < need


# An agent with another active agent closer than this (m) at a step's input
# is in near contact; its velocity after a pallas step is held to
# NEAR_CONTACT_VEL_TOL between the card and the CPU, every other to 1e-5.
NEAR_CONTACT = 0.01
NEAR_CONTACT_VEL_TOL = 1e-4


def _near_contact(agents, cand, speed_out: np.ndarray) -> np.ndarray:
    """For each output row of a flat step, whether its agent was in near
    contact at the step's input (``agents`` and the candidates ``cand``).
    Rows are matched to input agents by their desired speed, which a step
    carries unchanged and the seeded draws make unique."""
    act = torch.cat([agents.active, cand.active]).cpu()
    pos = torch.cat([agents.pos, cand.pos]).cpu()[act].double().numpy()
    speed = torch.cat([agents.speed, cand.speed]).cpu()[act].numpy()
    assert np.unique(speed).size == speed.size
    d2 = ((pos[:, None] - pos[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    near = speed[d2.min(1) < NEAR_CONTACT ** 2]
    return np.isin(speed_out.astype(np.float32), near)


# the spawning scenario of tests/test_rebin_incremental.py
PALLAS_SCENARIO = """
[field]
size = [18, 12]
[[waypoints]]
line = [[2, 2], [2, 10]]
[[waypoints]]
line = [[16, 2], [16, 10]]
[[obstacles]]
line = [[9, 0], [9, 5]]
width = 1
[[pedestrians]]
origin = 0
destination = 1
spawn = { kind = "periodic", frequency = 4.0 }
"""


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["base", "segments"])
def test_pallas_step_on_the_card_equals_the_cpu(mode):
    """Three pallas steps (models/sfm_pallas.py), each run on the card and on
    the CPU from the CPU's state and the same candidates: every metric
    equal, the rows slot by slot (the sort's cell ids come from the same
    IEEE divide) with positions and velocities within 1e-5 and the rest
    equal; the step kernel's launch counter rises by one a step on the
    card, in its mode, and the CPU runs the twin.  An agent in near
    contact (another active agent within NEAR_CONTACT at the step's input)
    has its velocity held to NEAR_CONTACT_VEL_TOL instead: the kernel
    equals its twin on the card bit for bit, but the twin's rsqrt and exp
    are CUDA's on the card and the CPU's here, and the reference's pair
    formula takes a difference of nearly equal squares there (a pair 4.9
    mm apart moved 1.75e-5 between the two; on the CPU, rsqrt and exp a
    few ulp off move no other velocity by 5e-6:
    test_torch_pallas_backend.py::test_near_contact_bounds_the_card_gate)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pedoni_tpu_torch.models import sfm, sfm_pallas
    from pedoni_tpu_torch.scenario import loads_scenario

    sc = loads_scenario(PALLAS_SCENARIO)
    maps = FieldMaps.from_field(Field.from_scenario(sc, unit=0.25))
    cfg = StepConfig.build(sc, capacity=640, neighbor_grid_unit=1.5,
                           table_capacity=12,
                           use_distance_map=(mode == "base"))
    rng = np.random.default_rng(6)
    n = 640
    st = SimState(agents_from_numpy(
        rng.uniform(0.8, 11.2, (n, 2)) * np.array([1.5, 1.0]),
        rng.normal(0, 0.4, (n, 2)), rng.uniform(0.8, 1.7, n),
        rng.integers(0, 2, n), np.arange(n) < 500, "cpu"), 0)
    gen = torch.Generator().manual_seed(3)
    counter = "segment_launches" if mode == "segments" else "launches"
    steps = {}
    for dev in ("cuda", "cpu"):
        fwp, fobs = sfm_pallas.pallas_device_inputs(cfg, maps, dev)
        steps[dev] = (sfm_pallas.make_step_pallas(
            cfg, generator=torch.Generator(device=dev)), fwp, fobs)
    spawned = 0
    for _ in range(3):
        cand = sfm.spawn_candidates(cfg, gen)
        out = {}
        for dev, (step, fwp, fobs) in steps.items():
            before = getattr(sk.fused_step, counter)
            new, m = step(SimState(st.agents.to(dev), st.step), fwp, fobs,
                          cand.to(dev))
            out[dev] = ({k: int(v) for k, v in m._asdict().items()},
                        [t.cpu().numpy() for t in new.agents],
                        getattr(sk.fused_step, counter) - before, new)
        st_in = st
        (gm, ga, gl, _), (wm, wa, wl, st) = out["cuda"], out["cpu"]
        assert gm == wm and (gl, wl) == (1, 0)
        np.testing.assert_allclose(ga[0], wa[0], rtol=0, atol=1e-5)  # pos
        near = _near_contact(st_in.agents, cand, wa[2])
        assert near.sum() <= 0.01 * near.size  # a few rows, not a loose gate
        np.testing.assert_allclose(ga[1][~near], wa[1][~near], rtol=0, atol=1e-5)
        np.testing.assert_allclose(ga[1][near], wa[1][near], rtol=0,
                                   atol=NEAR_CONTACT_VEL_TOL)
        for got, want in zip(ga[2:], wa[2:]):  # speed, dest, active
            np.testing.assert_array_equal(got, want)
        spawned += wm["n_spawned"]
    assert spawned > 0


@pytest.mark.cuda
def test_pallas_simulator_on_the_card_evacuates_gap():
    """``Simulator(backend="pallas")`` on the card: gap.toml evacuates within
    400 ticks, one base-mode step kernel launch a tick."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pedoni_tpu_torch import Simulator, SimulatorOptions

    sim = Simulator(SimulatorOptions(backend="pallas", device="cuda", seed=1),
                    load_scenario(GAP))
    before = sk.fused_step.launches
    for i in range(400):
        if sim.tick().active_ped_count == 0:
            break
    assert sim.pedestrian_count == 0
    assert sk.fused_step.launches - before == i + 1


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_two_ranks_on_cards(backend, tmp_path):
    """tests/test_torch_multihost.py's cases with the tiles on cards: gloo
    with both ranks on cuda:0 (each crossing buffer staged through pinned
    host memory), NCCL with rank r on cuda:r (two cards or more): every
    tiled case equal to one process's tiled run and to the whole grid on
    the card (metrics each step, the grid gathered on rank 0 bit for bit),
    the 2-rank Simulator equal to one card's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    if backend == "nccl" and torch.cuda.device_count() < 2:
        pytest.skip("NCCL takes one rank a card: needs two CUDA devices")
    import test_torch_multihost as mh

    ranks = mh.launch(tmp_path, backend, "cuda")
    for tile in mh.TILES:
        for path in mh.PATHS:
            mh.check_case(ranks, tile, path, "cuda")
    mh.check_simulator(ranks, "cuda")


@pytest.mark.cuda
def test_spatial_strips_on_the_card():
    """parallel/spatial.py on the card: its dryrun scenario (32 x 16 m, a
    spawning stream) in 2 strips on one card, and in one strip a card where
    there are two or more, against the flat step on the card from the same
    state and candidates: the first step's metrics equal and its rows
    within 1e-5 (order-free), and ten chained steps keep every metric
    equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pedoni_tpu_torch.models import sfm
    from pedoni_tpu_torch.parallel import spatial

    scenario = loads_scenario(spatial.DRYRUN_SCENARIO)
    maps = FieldMaps.from_field(Field.from_scenario(scenario, unit=0.25))
    cfg = StepConfig.build(scenario, capacity=1024, table_capacity=12)
    gen = torch.Generator(device="cuda").manual_seed(2)
    flat = sfm.make_initial_state(cfg, gen, "cuda")
    cands = [sfm.spawn_candidates(cfg, gen) for _ in range(11)]
    field, obstacles = sfm.device_inputs(cfg, maps, "cuda")
    fstep = sfm.make_step(cfg, gen)

    def rows(agents):
        a = {k: t.cpu().numpy() for k, t in agents._asdict().items()}
        r = np.concatenate([a["pos"], a["vel"], a["speed"][:, None]], 1
                           ).astype(np.float64)[a["active"]]
        return r[np.lexsort((r[:, 1], r[:, 0], r[:, 4]))]

    n = torch.cuda.device_count()
    plans = [["cuda:0", "cuda:0"]] + ([[f"cuda:{i}" for i in range(n)]] if n > 1 else [])
    for devices in plans:
        scfg = spatial.ShardedConfig.build(cfg, len(devices))
        srows, sobs = spatial.device_inputs(scfg, maps, devices)
        sstep = spatial.make_sharded_step(scfg, devices, gen)
        ss, fs = spatial.shard_state(scfg, flat, devices), flat
        for i, cand in enumerate(cands):
            ss, sm = sstep(ss, srows, sobs, cand)
            fs, fm = fstep(fs, field.rows, obstacles, cand)
            assert [int(x) for x in sm] == [int(x) for x in fm], (devices, i)
            if i == 0:
                got = rows(sfm.AgentState(*(torch.cat([x.to("cuda:0") for x in xs])
                                            for xs in zip(*ss.agents))))
                want = rows(fs.agents)
                assert got.shape == want.shape and got.shape[0] > 30
                assert np.abs(got[:, :4] - want[:, :4]).max() <= 1e-5
        assert sum(int(x.active.sum()) for x in ss.agents) == int(fm.n_active) > 30


def _flat_grid(ny: int, nx: int, k: int, seed: int,
               kind: str = "random") -> torch.Tensor:
    """A seeded padded grid [ny+2, nx+2, K, 8] on the card, as
    forcepass.scatter_cell_data lays one out: each cell filled from slot 0
    (a fifth of them empty), cells up to full, 5% of the filled slots
    inactive, agents in the ring too.  ``kind``: "scattered", positions
    anywhere within 3 cells of their own (no cell holds only its own), a
    few NaN and infinite, so that the kernel's per-cell box cull meets
    boxes that overlap and boxes with non-finite corners; "jam", nine in
    ten cells full and every filled slot active, 5-8 agents a m^2 at
    1.4 m; "lone", one full tile of 4 x 8 cells among empty ones."""
    rng = np.random.default_rng(seed)
    d = np.zeros((ny + 2, nx + 2, k, 8), np.float32)
    count = rng.integers(0, k + 1, (ny + 2, nx + 2)) * (
        rng.uniform(size=(ny + 2, nx + 2)) < 0.8)
    if kind == "jam":
        count = np.where(rng.uniform(size=count.shape) < 0.9, k,
                         rng.integers(10, k + 1, count.shape))
    if kind == "lone":
        count = np.zeros_like(count)
        count[4:8, 8:16] = k  # the tile (1, 1) of the K 14 launch
    r, c, j = np.nonzero(np.arange(k)[None, None] < count[..., None])
    scattered = kind == "scattered"
    spread = rng.uniform(-3.0, 4.0, (2, r.size)) if scattered else rng.uniform(
        size=(2, r.size))
    d[r, c, j, 0] = (c - 1 + spread[0]) * 1.4
    d[r, c, j, 1] = (r - 1 + spread[1]) * 1.4
    if scattered:
        odd = rng.choice(r.size, 8, replace=False)
        d[r[odd], c[odd], j[odd], odd % 2] = [np.nan, np.inf, -np.inf, 1e30] * 2
    d[r, c, j, 2:4] = rng.normal(0, 0.8, (r.size, 2))
    e = rng.normal(0, 1, (r.size, 2))
    d[r, c, j, 4:6] = e / np.linalg.norm(e, axis=1, keepdims=True)
    d[r, c, j, 6] = rng.uniform(size=r.size) < (1.0 if kind == "jam" else 0.95)
    return torch.from_numpy(d).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("ny, nx, k, kind",
                         [(30, 40, 14, "random"), (24, 37, 16, "random"),
                          (10, 12, 64, "random"), (6, 7, 255, "random"),
                          (17, 131, 14, "random"), (452, 229, 14, "random"),
                          (30, 40, 14, "scattered"), (8, 9, 64, "scattered"),
                          (24, 37, 16, "jam"), (14, 26, 14, "lone"),
                          (30, 40, 1, "random"), (10, 12, 33, "random")],
                         ids=["K14", "K16", "K64", "K255", "ragged_nx", "strip",
                              "scattered_K14", "scattered_K64", "jam_K16",
                              "lone_tile", "K1", "K33"])
def test_flat_pairwise_matches_twin(ny, nx, k, kind):
    """The flat pair kernel (csrc/flat_pairwise.cu) against its twin
    (forcepass.dense_pairwise_torch) on the card, bit for bit on the whole
    padded tensor, ring and inactive slots included; each K takes its own
    tile shape (1 x 1 at K 255); the strip case is one of two x-strips'
    windows of the 1M xla problem; the scattered cases hold agents off
    their cells, some at non-finite positions; a jammed grid at K 16 (a
    warp's queue fills many times over), one full tile among empty ones,
    and K 1 and 33, where a cell's slots are fewer or more than a warp's
    lanes.  One launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from pedoni_tpu_torch.ops import forcepass
    from pedoni_tpu_torch.ops.neighbor import CellGrid

    d = _flat_grid(ny, nx, k, seed=k + nx, kind=kind)
    phys = Physics()
    before = fpk.flat_pairwise.launches
    got = fpk.flat_pairwise(d, phys)
    want = forcepass.dense_pairwise_torch(d, CellGrid(1.4, nx, ny), k, phys,
                                          pass_bytes=1 << 28)
    torch.cuda.synchronize()
    assert fpk.flat_pairwise.launches == before + 1
    assert float(want.abs().max()) > 0.1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
        float((got - want).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("ny, nx, k, kind", [(30, 40, 14, "random"),
                                             (24, 37, 16, "jam")],
                         ids=["K14", "jam_K16"])
def test_flat_pairwise_occupancy(ny, nx, k, kind):
    """The kernel's occupancy counter (flat_pairwise_occupancy): its pairs
    are the pairs within the cutoff that chip_smoke.py's _flat_pairs counts
    on the same grid (every interior slot's, active or idle), its distance
    tests at least as many, both occupancies in (0, 1], and it counts no
    launch of the step's kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import chip_smoke

    d = _flat_grid(ny, nx, k, seed=k + nx, kind=kind)
    phys = Physics()
    before = fpk.flat_pairwise.launches
    got = fpk.flat_pairwise_occupancy(d, phys)
    assert fpk.flat_pairwise.launches == before
    within, _beyond = chip_smoke._flat_pairs(d, phys.cutoff_sq)
    assert got["pairs"] == within > 0
    assert got["tests"] >= got["pairs"]
    assert 0 < got["body_occupancy"] <= 1 and 0 < got["walk_occupancy"] <= 1
    assert got["body_lanes"] % 32 == 0 and got["walk_lanes"] % 32 == 0


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 14, 16, 64, 255])
def test_flat_pairwise_tile_fits_the_block(k):
    """The flat pair kernel's launch at K as its launcher picks it
    (csrc/flat_pairwise.cu flat_tile, asked through tile_shape): at every K
    up to 255 its shared memory within 64 KB, its halo slots indexable by
    the kernel's 16-bit list, threads a multiple of 32 up to 256 and no
    more than its slots need; the preferred 4 x 8 tile at the 1M problem's
    K 14, with four blocks resident an SM, fewer warps past K 213, and the
    shared memory laid out as the kernel's comment says."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    for kk in range(1, 256):
        tr, tc, threads, smem = fpk.tile_shape(kk)
        assert smem <= 64 * 1024
        assert (tr + 2) * (tc + 2) * kk < 1 << 16
        assert threads % 32 == 0 and 32 <= threads <= 256
        assert threads <= max(32, -(-tr * tc * kk // 32) * 32)
    for bad in (0, 256):
        with pytest.raises(ValueError, match="unsupported K"):
            fpk.tile_shape(bad)
    tr, tc, threads, smem = fpk.tile_shape(k)
    assert (tr, tc, threads) == {1: (4, 8, 32), 14: (4, 8, 256), 16: (4, 8, 256),
                                 64: (2, 4, 256), 255: (1, 1, 128)}[k]
    halo, warps = (tr + 2) * (tc + 2), threads // 32
    assert smem == (12 * tr * tc * k + 20 * halo * k + 20 * halo + 196
                    + (1408 + 8 * 256) * warps)
    if k in (14, 16):  # four blocks an SM (228 KB, 1 KB reserved a block)
        assert 4 * (smem + 1024) <= 228 * 1024


def _same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    """NaN in the same places, every other value bit for bit."""
    nan = torch.isnan(want)
    return (torch.equal(torch.isnan(got), nan)
            and torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32)))


def _sample_block_agents() -> int:
    """Agents a block of csrc/flat_sample.cu takes a turn: its threads
    times the agents each thread takes (read from the source)."""
    import re
    src = (pathlib.Path(fsk.__file__).parent / "csrc" / "flat_sample.cu").read_text()
    threads = int(re.search(r"constexpr int kThreads = (\d+);", src).group(1))
    return threads * int(re.search(r"constexpr int kAgents = (\d+);", src).group(1))


@pytest.mark.cuda
@pytest.mark.parametrize("n, sanitize, strided", [
    (3000, True, False), (3000, False, False), (200_003, True, True),
    *((n, sanitize, strided) for n in ("1", "block-1", "block+1")
      for sanitize in (True, False) for strided in (False, True))],
    ids=["edges", "strips", "ragged_strided",
         *(f"{n}-{'sanitized' if sanitize else 'unsanitized'}-"
           f"{'strided' if strided else 'contiguous'}"
           for n in ("1", "block-1", "block+1") for sanitize in (True, False)
           for strided in (False, True))])
def test_flat_sample_matches_twin(n, sanitize, strided):
    """The flat sample kernel (csrc/flat_sample.cu) against its twin
    (sampling.flat_sample_torch) on the card, on gap.toml's two waypoint
    planes and tests/test_torch_flat_sample_cases.py's agents (off the map,
    non-finite, on cell boundaries, huge velocities and speeds, dest past
    the planes): the 12 packed channels bit for bit (NaN where the twin's
    is), the cell ids equal; with and without sanitizing, from contiguous
    and strided agents, at one agent and one below and one above a multiple
    of the agents a block takes (its threads times a thread's agents), so
    that the last warp and thread are partly filled.  One launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from pedoni_tpu_torch.ops.neighbor import CellGrid
    from pedoni_tpu_torch.ops.sampling import DeviceField, flat_sample_torch

    if isinstance(n, str):
        n = {"1": 1, "block-1": 37 * _sample_block_agents() - 1,
             "block+1": 37 * _sample_block_agents() + 1}[n]
    sc = load_scenario(GAP)
    field = DeviceField.from_maps(FieldMaps.from_field(Field.from_scenario(sc, unit=0.25)),
                                  "cuda")
    grid = CellGrid.for_size(sc.size, 1.4)
    pos, vel, speed, dest, act = (torch.from_numpy(x[:n]).cuda()
                                  for x in edge_case_agents(max(n, 3000), n % 97))
    if strided:
        rows = torch.cat([pos, vel, speed[:, None]], 1)
        pos, vel, speed = rows[:, 0:2], rows[:, 2:4], rows[:, 4]
    args = (field.rows, field.hp, field.wp_cols, pos, vel, speed, dest, act, 0.25,
            Physics().despawn_potential, grid, sanitize)
    before = fsk.flat_sample.launches
    got, cid = fsk.flat_sample(*args)
    want, wcid = flat_sample_torch(*args)
    torch.cuda.synchronize()
    assert fsk.flat_sample.launches == before + 1
    assert _same_bits(got, want), float((got - want).abs().nan_to_num().max())
    assert torch.equal(cid, wcid)
    assert n == 1 or 0 < int((cid < grid.n_cells).sum()) < n


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["distance_map", "segments"])
def test_flat_step_on_the_card_equals_the_cpu(mode):
    """Three flat steps (models/sfm.py::make_step), each on the card and on
    the CPU from the CPU's state and the same candidates: every metric
    equal, the rows slot by slot with positions within 1e-5 and velocities
    within 1e-5, or NEAR_CONTACT_VEL_TOL for an agent in near contact (the
    kernel equals its twin bit for bit on the card, but expf and sqrtf
    there and the CPU's exp elsewhere differ by ulps, which near contact
    the pair formula magnifies); the four flat kernels (sample, scatter,
    pair pass, integrate) launched once each a step on the card and no
    other, none on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pedoni_tpu_torch.models import sfm
    from pedoni_tpu_torch.scenario import loads_scenario

    sc = loads_scenario(PALLAS_SCENARIO)
    maps = FieldMaps.from_field(Field.from_scenario(sc, unit=0.25))
    cfg = StepConfig.build(sc, capacity=640, table_capacity=12,
                           use_distance_map=(mode == "distance_map"))
    rng = np.random.default_rng(6)
    n = 640
    st = SimState(agents_from_numpy(
        rng.uniform(0.8, 11.2, (n, 2)) * np.array([1.5, 1.0]),
        rng.normal(0, 0.4, (n, 2)), rng.uniform(0.8, 1.7, n),
        rng.integers(0, 2, n), np.arange(n) < 500, "cpu"), 0)
    gen = torch.Generator().manual_seed(3)
    steps = {}
    for dev in ("cuda", "cpu"):
        field, obstacles = sfm.device_inputs(cfg, maps, dev)
        steps[dev] = (sfm.make_step(cfg, torch.Generator(device=dev)),
                      field.rows, obstacles)
    spawned = 0
    for _ in range(3):
        cand = sfm.spawn_candidates(cfg, gen)
        out = {}
        for dev, (step, rows, obstacles) in steps.items():
            zero_launch_counts()
            new, m = step(SimState(st.agents.to(dev), st.step), rows, obstacles,
                          cand.to(dev))
            out[dev] = ({k: int(v) for k, v in m._asdict().items()},
                        [t.cpu().numpy() for t in new.agents], launch_counts(), new)
        st_in = st
        (gm, ga, gl, _), (wm, wa, wl, st) = out["cuda"], out["cpu"]
        flat = ("flat_sample", "flat_scatter", "flat_pairwise", "flat_integrate")
        assert gm == wm and gl == dict(dict.fromkeys(gl, 0), **dict.fromkeys(flat, 1))
        assert wl == dict.fromkeys(wl, 0)
        np.testing.assert_allclose(ga[0], wa[0], rtol=0, atol=1e-5)  # pos
        near = _near_contact(st_in.agents, cand, wa[2])
        assert near.sum() <= 0.01 * near.size
        np.testing.assert_allclose(ga[1][~near], wa[1][~near], rtol=0, atol=1e-5)
        np.testing.assert_allclose(ga[1][near], wa[1][near], rtol=0,
                                   atol=NEAR_CONTACT_VEL_TOL)
        for got, want in zip(ga[2:], wa[2:]):  # speed, dest, active
            np.testing.assert_array_equal(got, want)
        spawned += wm["n_spawned"]
    assert spawned > 0


def _scatter_inputs(name: str):
    from pedoni_tpu_torch.ops.neighbor import CellGrid
    from test_torch_flat_scatter_cases import UNIT, scatter_case

    packed, cid, order, (ny, nx), k = scatter_case(name)
    return (torch.from_numpy(packed).cuda(), torch.from_numpy(cid).cuda(),
            torch.from_numpy(order).cuda(), CellGrid(UNIT, nx, ny), k)


def _bits_equal(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Equal bit for bit (floats through their int32 view, NaN payloads
    included)."""
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    return got.shape == want.shape and torch.equal(got, want)


SCATTER_CASES = ["overflow", "capacity_cut", "nonfinite", "k255", "ragged_nx",
                 "strip_window", "1M"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", SCATTER_CASES)
def test_flat_scatter_matches_twin(name):
    """The flat scatter kernel (csrc/flat_scatter.cu) against its twin
    (flat_scatter.flat_scatter_torch) on the card, on tests/
    test_torch_flat_scatter_cases.py's cases (cells past K, the sentinel
    run, holes in a cell's ranks, N > C, NaN and inf rows, K 255, a ragged
    nx, an x-strip's window) and on a 1M-agent layout of the 1M xla
    problem's grid: every output bit for bit, the padded grid whole; also
    without cells (the rows alone) and with the pallas slot grid's strides
    (the layout, no grid).  One launch counted a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from pedoni_tpu_torch.ops.kernels import flat_scatter as fck

    packed, cid, order, grid, k = _scatter_inputs(name)
    nxl = grid.nx + 3
    slot_grid = {"strides": (k * 8 * nxl, 1, 8 * nxl),
                 "size": (grid.ny + 2) * k * 8 * nxl}
    for kw in ({}, {"cells": False}, slot_grid):
        before = fck.flat_scatter.launches
        got = fck.flat_scatter(packed, cid, order, grid, k, **kw)
        want = fck.flat_scatter_torch(packed, cid, order, grid, k, **kw)
        torch.cuda.synchronize()
        assert fck.flat_scatter.launches == before + 1
        for field in ("rows", "cid", "dest", "active", "n_active", "speed"):
            assert _bits_equal(getattr(got, field), getattr(want, field)), (kw, field)
        assert (got.layout is None) == (want.layout is None)
        if got.layout is not None:
            for a, b in zip(got.layout, want.layout):
                assert _bits_equal(a, b), kw
            assert int(got.layout.n_overflow) > 0
        assert (got.data is None) == (want.data is None)
        if got.data is not None:
            assert _bits_equal(got.data, want.data)
            assert int((got.data[..., 6] > 0.5).sum()) == int(got.layout.valid.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("name, mode", [("overflow", "distance_map"),
                                        ("nonfinite", "distance_map"),
                                        ("strip_window", "segments"),
                                        ("ragged_nx", "no_obstacles"),
                                        ("capacity_cut", "all_pairs"),
                                        ("k255", "distance_map"),
                                        ("1M", "distance_map")])
def test_flat_integrate_matches_twin(name, mode):
    """The flat integrate kernel (csrc/flat_integrate.cu) against its twin
    (flat_integrate.flat_integrate_torch) on the card, bit for bit (NaN
    where the twin's is), on the sorted rows and layout of the flat scatter
    cases with a seeded pair grid: the obstacle term from the rows, from
    segments computed apart, or none; the pair term through the layout or
    computed apart.  One launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from pedoni_tpu_torch.ops import forces
    from pedoni_tpu_torch.ops.kernels import flat_integrate as fik
    from pedoni_tpu_torch.ops.kernels import flat_scatter as fck

    packed, cid, order, grid, k = _scatter_inputs(name)
    sc = fck.flat_scatter_torch(packed, cid, order, grid, k)
    gen = torch.Generator(device="cuda").manual_seed(5)
    acc_flat = torch.randn((sc.data.numel() // 8, 2), generator=gen, device="cuda")
    kw = {"acc_flat": acc_flat, "layout": sc.layout,
          "distance_map": mode == "distance_map"}
    if mode == "segments":
        seg = (torch.tensor([[3.0, 1.0], [9.0, 4.0]]), torch.tensor([[3.0, 8.0], [15.0, 4.5]]),
               torch.tensor([0.6, 1.0]))
        kw["obstacle"] = forces.segment_obstacle_force(
            sc.rows[:, 0:2], *(t.cuda() for t in seg), Physics())
    if mode == "all_pairs":
        kw["pair"] = torch.randn((sc.rows.shape[0], 2), generator=gen, device="cuda")
    before = fik.flat_integrate.launches
    got = fik.flat_integrate(sc.rows, sc.active, Physics(), **kw)
    want = fik.flat_integrate_torch(sc.rows, sc.active, Physics(), **kw)
    torch.cuda.synchronize()
    assert fik.flat_integrate.launches == before + 1
    for g, w in zip(got, want):
        assert _same_bits(g, w), float((g - w).abs().nan_to_num().max())
    assert float((got[0] - sc.rows[:, 0:2]).abs().nan_to_num().max()) > 0.01


SPAWN_CASES = ["whole", "tile", "crowded_k3", "one_cell", "faulty", "empty", "many"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", SPAWN_CASES)
def test_spawn_scatter_matches_twin(name):
    """The spawn scatter kernel (csrc/spawn_scatter.cu) against its twin
    (spawn_scatter.spawn_scatter_torch) on the card and on the CPU, bit for
    bit on the whole grid and in both counts, on tests/
    test_torch_spawn_scatter.py's cases of random.toml's grid: its own
    sampler's candidates, a tile's window (ghost-ring candidates written,
    not counted), K 3 on a crowded grid, more than K candidates in one
    cell, inactive, off-grid and NaN candidates, S = 0 and S = 3000 (the
    kernel's chunks).  One launch counted a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from pedoni_tpu_torch.ops.kernels import spawn_scatter as ssk
    from test_torch_spawn_scatter import spawn_case

    cfg, d, cand, kw = spawn_case(name)
    args = (cfg.grid, cfg.table_capacity)
    cpu = ssk.spawn_scatter_torch(*args, d.clone(), cand, **kw)
    d, cand = d.cuda(), cand.to("cuda")
    before = ssk.spawn_scatter.launches
    got = ssk.spawn_scatter(*args, d.clone(), cand, **kw)
    want = ssk.spawn_scatter_torch(*args, d.clone(), cand, **kw)
    torch.cuda.synchronize()
    assert ssk.spawn_scatter.launches == before + 1
    assert got[1].dtype == got[2].dtype == torch.int32 and got[1].dim() == 0
    for ref in (want, cpu):
        assert _bits_equal(got[0].cpu(), ref[0].cpu())
        assert (int(got[1]), int(got[2])) == (int(ref[1]), int(ref[2]))


@pytest.mark.cuda
def test_spawning_grid_step_makes_no_sync():
    """A spawning grid step on the card (a small field, four spawns a step
    on average) runs under set_sync_debug_mode("error"), one spawn scatter
    launch a step, and spawns."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from pedoni_tpu_torch import Simulator, SimulatorOptions

    sc = loads_scenario("""
[field]
size = [18, 12]
[[waypoints]]
line = [[2, 2], [2, 10]]
[[waypoints]]
line = [[16, 2], [16, 10]]
[[pedestrians]]
origin = 0
destination = 1
spawn = { kind = "periodic", frequency = 40.0 }
""")
    sim = Simulator(SimulatorOptions(backend="grid", device="cuda", seed=1), sc)
    sim.run(4)
    gs = sim.state
    torch.cuda.synchronize()
    zero_launch_counts()
    spawned = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(8):
            gs, m = sim._step(gs, sim._fwp, sim._fobs)
            spawned.append(m.n_spawned)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert launch_counts()["spawn_scatter"] == 8
    assert int(torch.stack(spawned).sum()) > 0


def _built(graphed: bool, **options):
    """scenarios/random.toml's Simulator on the card, graphed as it is
    built, or with the eager step its graphs capture (the module's
    ``_graphs_on`` patched while it is built)."""
    from pedoni_tpu_torch import Simulator, SimulatorOptions
    from pedoni_tpu_torch import sim as sim_module

    with pytest.MonkeyPatch.context() as m:
        m.setattr(sim_module, "_graphs_on", lambda device: graphed)
        return Simulator(SimulatorOptions(device="cuda", seed=7, **options),
                         load_scenario(SCENARIOS / "random.toml"))


def _random_flat(graphed: bool, capacity: int = 0):
    """random.toml's flat Simulator on the card (the CLI's -b auto)."""
    return _built(graphed, capacity=capacity)


@pytest.mark.cuda
def test_graphed_flat_ticks_equal_eager_across_a_restore_and_a_growth(tmp_path):
    """600 ticks of random.toml's flat Simulator, graphed and eager: every
    tick the positions, velocities, speeds, destinations, activity and
    every StepMetrics field equal bit for bit, through a forced capacity
    growth at tick 150 (captured again) and a restore at tick 300 of the
    checkpoint of tick 100 (padded to the new capacity, not captured
    again); both generators rewound alike."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from pedoni_tpu_torch import checkpoint
    from pedoni_tpu_torch.sim import GraphedStep

    graphed, eager = _random_flat(True), _random_flat(False)
    assert isinstance(graphed._step, GraphedStep)
    assert not isinstance(eager._step, GraphedStep)
    ckpt = tmp_path / "c.npz"
    spawned = 0
    for t in range(1, 601):
        for sim in (graphed, eager):
            sim.tick()
            if t == 100:
                checkpoint.save(sim, ckpt)
            if t == 150:
                sim._grow("capacity")
            if t == 300:
                checkpoint.restore(sim, ckpt)
        assert graphed.last_metrics == eager.last_metrics, t
        assert graphed.cfg.capacity == eager.cfg.capacity
        for a, b in zip(graphed.state.agents, eager.state.agents):
            assert _bits_equal(a, b), t
        spawned += graphed.last_metrics.n_spawned
    assert graphed.graph_captures == 2 and eager.graph_captures == 0
    assert graphed._step.copies_in == 3  # the first tick, the growth, the restore
    assert spawned > 0 and graphed.pedestrian_count > 0


@pytest.mark.cuda
def test_graphed_replay_makes_no_sync():
    """Replays of the graphed flat step, an assigned state copied in among
    them, under set_sync_debug_mode("error"); they spawn."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from pedoni_tpu_torch.models.sfm import AgentState

    sim = _random_flat(True)
    for _ in range(3):
        sim.tick()
    step = sim._step
    copies = step.copies_in
    assigned = SimState(AgentState(*(t.clone() for t in sim.state.agents)),
                        sim.state.step)
    torch.cuda.synchronize()
    spawned = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        sim.state = assigned
        for _ in range(8):
            sim.state, m = sim._step(sim.state, sim._fwp, sim._fobs)
            spawned.append(m.n_spawned)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert step.copies_in == copies + 1 and step.captures == 1
    assert int(torch.stack(spawned).sum()) > 0


@pytest.mark.cuda
def test_graphed_replay_counts_the_launches_the_profiler_sees():
    """Over ticks that replay the graph, ``launch_counts()`` moves by the
    launches of each flat kernel that torch.profiler traces: one a tick."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import re

    sim = _random_flat(True)
    for _ in range(3):
        sim.tick()
    act = torch.profiler.ProfilerActivity
    # one tick of the profiler's warm-up first, so that tracing is running
    # when the counted ticks start
    with torch.profiler.profile(
            activities=[act.CPU, act.CUDA],
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=6)) as prof:
        sim.tick()
        torch.cuda.synchronize()
        before = launch_counts()
        for _ in range(6):
            prof.step()  # the first: warm-up over, recording
            sim.tick()
        torch.cuda.synchronize()
    after = launch_counts()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    for kernel, counter in (("flat_sample_kernel", "flat_sample"),
                            ("flat_scatter_kernel", "flat_scatter"),
                            ("flat_pairwise_tile", "flat_pairwise"),
                            ("flat_integrate_kernel", "flat_integrate")):
        traced = sum(bool(re.search(rf"\b{kernel}\b", n)) for n in names)
        assert traced == after[counter] - before[counter] == 6, (kernel, traced)
    assert sim.graph_captures == 1


@pytest.mark.cuda
def test_graphed_flat_agents_read_from_a_thread_through_growths():
    """The CLI's live views: ``list_pedestrians`` on a second thread while
    random.toml's graphed flat Simulator ticks from a capacity of 256
    through its growths, each a capture (whose start frees torch's cache
    and waits on the card) while the other thread reads.  No capture
    fails, every read is of one state (as many destinations as positions,
    each a waypoint), and the ticks end bit-equal to those of an eager
    Simulator that nobody read."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import threading

    graphed = _random_flat(True, capacity=256)
    n_wp = len(graphed.scenario.waypoints)
    done = threading.Event()
    reads, errors = [], []

    def reader():
        try:
            while not done.is_set():
                pos, dest = graphed.list_pedestrians()
                reads.append(len(pos) == len(dest)
                             and bool(((dest >= 0) & (dest < n_wp)).all())
                             and bool(np.isfinite(pos).all()))
        except Exception as e:  # noqa: BLE001 - the main thread raises it
            errors.append(e)

    thread = threading.Thread(target=reader)
    thread.start()
    try:
        for _ in range(300):
            graphed.tick()
    finally:
        done.set()
        thread.join()
    assert not errors, errors
    assert graphed.cfg.capacity >= 1024 and graphed.graph_captures >= 3
    assert len(reads) > 10 and all(reads)
    eager = _random_flat(False, capacity=256)
    for _ in range(300):
        eager.tick()
    assert eager.cfg.capacity == graphed.cfg.capacity
    assert eager.last_metrics == graphed.last_metrics
    for a, b in zip(graphed.state.agents, eager.state.agents):
        assert _bits_equal(a, b)


def _random_grid(graphed: bool, **options):
    """random.toml's grid Simulator on the card (the CLI's -b grid; the
    full rebin unless ``incremental_rebin`` says otherwise)."""
    return _built(graphed, backend="grid", **options)


def _sizes(sim) -> tuple[int, int, int]:
    """What a change of rebuilds the grid step (and captures again)."""
    return sim.options.table_capacity, sim.options.mover_capacity, sim.cfg.capacity


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["full", "hybrid"])
def test_graphed_grid_ticks_equal_eager_through_growths_and_a_restore(path, tmp_path):
    """600 ticks of random.toml's grid Simulator (200 of the forced
    hybrid), graphed and eager: every tick the grid and every StepMetrics
    field equal bit for bit, through a forced table growth (and in the
    hybrid a mover growth), each captured again, and a restore of an
    earlier checkpoint (the same sizes: not captured again).  The full
    path holds one graph a build, the hybrid one for each branch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from pedoni_tpu_torch import checkpoint
    from pedoni_tpu_torch.sim import GraphedStep

    hybrid = path == "hybrid"
    kw = {"incremental_rebin": True} if hybrid else {}
    graphed, eager = _random_grid(True, **kw), _random_grid(False, **kw)
    assert isinstance(graphed._step, GraphedStep)
    assert not isinstance(eager._step, GraphedStep)
    assert graphed._resolve_incremental() == hybrid
    ckpt = tmp_path / "c.npz"
    n_ticks, grow, restore = (200, 60, 120) if hybrid else (600, 150, 300)
    builds, spawned = 1, 0
    for t in range(1, n_ticks + 1):
        sizes = _sizes(graphed)
        for sim in (graphed, eager):
            sim.tick()
            if t == 50:
                checkpoint.save(sim, ckpt)
            if t == grow:
                sim._grow("table")
            if t == grow + 20 and hybrid:
                sim._grow("movers")
            if t == restore:
                checkpoint.restore(sim, ckpt)
        builds += _sizes(graphed) != sizes
        assert graphed.last_metrics == eager.last_metrics, t
        assert _sizes(graphed) == _sizes(eager)
        assert _bits_equal(graphed.state.d, eager.state.d), t
        spawned += graphed.last_metrics.n_spawned
    step = graphed._step
    assert builds >= (3 if hybrid else 2)
    assert graphed.graph_captures == builds * (2 if hybrid else 1)
    if hybrid:
        assert sorted(step._graphs) == [(False, False), (True, False)]
    assert step.copies_in == graphed.graph_captures + 1  # + the restore
    assert eager.graph_captures == 0 and spawned > 0


@pytest.mark.cuda
def test_graphed_grid_replay_makes_no_sync():
    """Replays of the graphed grid step, an assigned grid copied in among
    them, under set_sync_debug_mode("error"); they spawn."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    sim = _random_grid(True)
    for _ in range(3):
        sim.tick()
    step = sim._step
    copies = step.copies_in
    assigned = sim.state._replace(d=sim.state.d.clone())
    torch.cuda.synchronize()
    spawned = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        sim.state = assigned
        for _ in range(8):
            sim.state, m = sim._step(sim.state, sim._fwp, sim._fobs)
            spawned.append(m.n_spawned)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert step.copies_in == copies + 1 and step.captures == 1
    assert int(torch.stack(spawned).sum()) > 0


@pytest.mark.cuda
def test_graphed_grid_replay_counts_the_launches_the_profiler_sees():
    """Over ticks that replay the grid's graph, ``launch_counts()`` moves by
    the launches of each hand kernel that torch.profiler traces: one a
    tick."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import re

    sim = _random_grid(True)
    for _ in range(3):
        sim.tick()
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(
            activities=[act.CPU, act.CUDA],
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=6)) as prof:
        sim.tick()
        torch.cuda.synchronize()
        before = launch_counts()
        for _ in range(6):
            prof.step()
            sim.tick()
        torch.cuda.synchronize()
    after = launch_counts()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    for kernel, counter in (("step_sample", "step_kernel"),
                            ("step_pairs", "step_kernel"),
                            ("rebin_full", "rebin"),
                            ("spawn_scatter_kernel", "spawn_scatter")):
        traced = sum(bool(re.search(rf"\b{kernel}\b", n)) for n in names)
        assert traced == after[counter] - before[counter] == 6, (kernel, traced)
    assert sim.graph_captures == 1


@pytest.mark.cuda
def test_graphed_grid_agents_read_from_a_thread_through_growths():
    """The CLI's live views on the grid: ``list_pedestrians`` on a second
    thread while random.toml's graphed grid Simulator ticks from K 8
    through its table growths, each a capture.  No capture fails, every
    read is of one state, and the ticks end bit-equal to those of an eager
    Simulator that nobody read."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import threading

    graphed = _random_grid(True, table_capacity=8)
    n_wp = len(graphed.scenario.waypoints)
    done = threading.Event()
    reads, errors = [], []

    def reader():
        try:
            while not done.is_set():
                pos, dest = graphed.list_pedestrians()
                reads.append(len(pos) == len(dest)
                             and bool(((dest >= 0) & (dest < n_wp)).all())
                             and bool(np.isfinite(pos).all()))
        except Exception as e:  # noqa: BLE001 - the main thread raises it
            errors.append(e)

    thread = threading.Thread(target=reader)
    thread.start()
    try:
        for _ in range(300):
            graphed.tick()
    finally:
        done.set()
        thread.join(timeout=120)
    assert not thread.is_alive() and not errors, errors
    assert graphed.options.table_capacity > 8 and graphed.graph_captures >= 2
    assert len(reads) > 10 and all(reads)
    eager = _random_grid(False, table_capacity=8)
    for _ in range(300):
        eager.tick()
    assert _sizes(eager) == _sizes(graphed)
    assert eager.last_metrics == graphed.last_metrics
    assert _bits_equal(graphed.state.d, eager.state.d)


# A jam holds agents whose velocity is ill-conditioned in float32: near
# contact, or where the pair formula's b^2 = t2^2 - (|v_j| dt)^2 cancels (a
# neighbour almost on the agent's path), two f32 implementations differ by
# up to 1.09e-4 (ROADMAP, the strips against the reference).  At most
# JAM_KNIFE_SHARE of a jam's agents may sit on such an edge, within
# JAM_KNIFE_VEL_TOL; every other velocity is held to 1e-5.  (funnel.toml on
# an H100 after its first growth: 1 agent of 17,942, at 1.085e-4.)
JAM_KNIFE_SHARE = 1e-3
JAM_KNIFE_VEL_TOL = 2e-4


def _grid_rows(d: torch.Tensor) -> np.ndarray:
    """The live agents of a grid D as [n, 6] float64 (pos, vel, speed,
    dest) on the host, ordered by speed, destination and position."""
    dd = d.permute(0, 3, 1, 2)
    r = dd[dd[..., 6] > 0.5][:, :6].double().cpu().numpy()
    return r[np.lexsort((r[:, 1], r[:, 0], r[:, 5], r[:, 4]))]


@pytest.mark.cuda
def test_graphed_funnel_grows_k_and_ticks_as_the_cpu():
    """scenarios/funnel.toml's graphed grid Simulator on the card, from K 12
    (the CLI's 16 grows ~500 ticks in, 12 sooner): the jam at the opening
    grows the table while the graph of the old K is live, the next tick
    captures at the new K, and each of the three ticks after the growth
    equals the CPU twin's grid step from the same grid and the same spawn
    candidates (drawn from the generator's state at the tick): every metric
    equal, the agents (in any slot order) with their speeds and
    destinations equal, positions within 1e-5 (or their f32 spacing, on
    the 180 m field) and velocities within 1e-5, but for at most
    JAM_KNIFE_SHARE of them on a knife edge, within JAM_KNIFE_VEL_TOL."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from pedoni_tpu_torch import Simulator, SimulatorOptions
    from pedoni_tpu_torch.models.sfm import AgentState, spawn_sampler
    from pedoni_tpu_torch.sim import GraphedStep

    sim = Simulator(SimulatorOptions(backend="grid", device="cuda", seed=4,
                                     table_capacity=12),
                    load_scenario(SCENARIOS / "funnel.toml"))
    assert isinstance(sim._step, GraphedStep) and not sim._resolve_incremental()
    for _ in range(2000):
        sim.tick()
        if sim.growths["table"]:
            break
    assert sim.options.table_capacity == 18 and sim.graph_captures == 1
    cfg, rows = sim.cfg, sim.options.row_block
    fields = sfm_grid.field_tensors(cfg, sim.maps, "cpu", row_block=rows)
    twin = sfm_grid.make_step_grid(cfg, row_block=rows, incremental=False,
                                   generator=torch.Generator())
    draw = spawn_sampler(cfg, "cuda")
    spawned = 0
    for _ in range(3):
        d_in = sim.state.d.clone()
        gen = torch.Generator(device="cuda")
        gen.set_state(sim.generator.get_state())
        cand = draw(gen)
        sim.tick()
        want, wm = twin(sfm_grid.GridState(d_in.cpu(), sim.state.step - 1), *fields,
                        AgentState(*(t.cpu() for t in cand)))
        assert sim.last_metrics == type(sim.last_metrics)(*(int(v) for v in wm))
        got, ref = _grid_rows(sim.state.d), _grid_rows(want.d)
        assert got.shape == ref.shape and got.shape[0] > 1000
        np.testing.assert_array_equal(got[:, 4:], ref[:, 4:])  # speed, dest
        # 1e-5, or one f32 spacing of a position past 128 m (1.53e-5)
        ulp = np.spacing(np.abs(ref[:, :2]).astype(np.float32))
        assert (np.abs(got[:, :2] - ref[:, :2]) <= np.maximum(1e-5, ulp)).all()
        dv = np.abs(got[:, 2:4] - ref[:, 2:4]).max(1)
        assert (dv > 1e-5).sum() <= JAM_KNIFE_SHARE * len(dv)
        assert dv.max() <= JAM_KNIFE_VEL_TOL
        spawned += sim.last_metrics.n_spawned
    assert sim.graph_captures == 1 + sim.growths["table"] and spawned > 0
    assert sim.growths == {"capacity": 0, "table": sim.growths["table"], "movers": 0}
