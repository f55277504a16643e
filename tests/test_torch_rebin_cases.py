"""Grids built to break a rebin that tiles the cells and compacts through
bit masks, and the CPU tests of the rebins' launch-shape chooser.

``rebin_case(name)`` builds, with NumPy alone and from a fixed seed, one
post-step grid g [ny_pad+2, K, 8, NXL] and the (G with ch 7 = stay mask,
mover table M) pair the step kernel's mover mode would emit for it.  The
same grids run on the CPU through the plain PyTorch twins against the
reference (tests/test_torch_rebin.py, tests/test_torch_rebin_incremental.py)
and on the card through the CUDA kernels against the twins
(tests/test_torch_cuda.py::test_rebin_tile_edges).  This module imports
neither JAX nor the reference package, so the card's tests can use it.

The chooser (pedoni_tpu_torch/ops/kernels/rebin.py::rebin_launch) is plain
Python: for every K in 1..80 and MK in 0..K its tile fits a block's shared
memory, never straddles a block of ``row_block`` rows and covers the grid
exactly.
"""

import numpy as np
import pytest

from pedoni_tpu_torch.ops.kernels import rebin as rb

UNIT = 1.5
NXL = 128
SMEM_BLOCK = 227 * 1024  # bytes of shared memory one block may use on an H100


def split_stay_movers(g0: np.ndarray, mk: int, unit: float):
    """(G with ch 7 = stay mask, M [ny2, mk, 8, NXL]) as the step kernel's
    mover mode emits them for the post-step grid ``g0``: an active agent
    whose position floors to its own cell stays; the others fill the rows
    of their cell's mover table in slot order, ch 6 = row holds a mover,
    ch 7 = min(movers, mk) on every row."""
    ny2, k, _, nxl = g0.shape
    gi = g0.copy()
    m = np.zeros((ny2, mk, 8, nxl), np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        tl = np.floor(g0[:, :, 0] / np.float32(unit)) + 1  # [ny2, K, NXL]
        tr = np.floor(g0[:, :, 1] / np.float32(unit))
    lane = np.arange(nxl, dtype=np.float32)[None, None, :]
    row = (np.arange(ny2, dtype=np.float32) - 1)[:, None, None]
    act = g0[:, :, 6] > 0.5
    stay = act & (tl == lane) & (tr == row)
    gi[:, :, 7] = stay
    gi[[0, -1], :, 7] = 0.0
    mover = act & ~stay
    mover[[0, -1]] = False
    for r, l in zip(*np.nonzero(mover.any(axis=1))):
        slots = np.nonzero(mover[r, :, l])[0]
        for n, j in enumerate(slots[:mk]):
            m[r, n, :6, l] = g0[r, j, :6, l]
            m[r, n, 6, l] = 1.0
        m[r, :, 7, l] = min(len(slots), mk)
    return gi, m


def _random_grid(rng, ny, k, nx, n_max, jitter, p_dead=0.15, n_min=0):
    """``n_min`` to ``n_max`` agents a cell in their own cells, displaced by up to
    ``jitter`` metres so that some land next door; some slots dead."""
    g = np.zeros((ny + 2, k, 8, NXL), np.float32)
    n = rng.integers(n_min, n_max + 1, (ny, nx))
    for r, x in zip(*np.nonzero(n)):
        for j in range(n[r, x]):
            p = (np.array([x, r]) * UNIT + rng.uniform(0.05, UNIT - 0.05, 2)
                 + rng.uniform(-jitter, jitter, 2))
            g[r + 1, j, 0:2, x + 1] = p
            g[r + 1, j, 2:4, x + 1] = rng.normal(0, 0.5, 2)
            g[r + 1, j, 4, x + 1] = rng.uniform(0.8, 1.8)
            g[r + 1, j, 5, x + 1] = rng.integers(0, 3)
            g[r + 1, j, 6, x + 1] = float(rng.uniform() > p_dead)
    return g


def _put(g, row, j, lane, x, y, tag):
    """An active agent in slot j of cell (grid row, lane) at (x, y); ``tag``
    rides in the speed channel."""
    g[row, j, 0:2, lane] = (x, y)
    g[row, j, 2:4, lane] = (0.25, -0.5)
    g[row, j, 4, lane] = tag
    g[row, j, 5, lane] = 1.0
    g[row, j, 6, lane] = 1.0


def _case_grid(name: str) -> dict:
    rng = np.random.default_rng(17)
    k, mk, ny, ny_cells, nx, rb_ = 6, 6, 6, None, 20, 2
    if name == "k1":  # one slot a cell: every second lander overflows
        k, mk, ny = 1, 1, 4
        g = _random_grid(rng, ny, k, nx, 1, 0.9, p_dead=0.0)
    elif name == "k14_mk8":  # the bench's shape
        k, mk, ny = 14, 8, 4
        g = _random_grid(rng, ny, k, nx, 9, 0.9)
    elif name == "k40_mk1":  # one mover row a cell: the table overflows
        k, mk, ny = 40, 1, 2
        g = _random_grid(rng, ny, k, nx, 30, 0.9)
    elif name == "k70":  # more than 64 slots: several mask words a cell
        k, mk, ny, nx = 70, 70, 2, 8
        g = _random_grid(rng, ny, k, nx, 70, 0.9, p_dead=0.05, n_min=50)
    elif name == "k150":  # the narrowest tile
        k, mk, ny, nx = 150, 8, 2, 4
        g = _random_grid(rng, ny, k, nx, 150, 0.5, p_dead=0.3)
    elif name == "nine_neighbours_overflow":
        # all 9 cells around (row 2, x 5) send two agents each into it: 18
        # landers for K = 6; its own two stay, so 16 movers meet 4 holes
        g = np.zeros((ny + 2, k, 8, NXL), np.float32)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                for j in (1, 4):
                    _put(g, 3 + dy, j, 6 + dx, 5 * UNIT + 0.1 * (dx + 2) + 0.01 * j,
                         2 * UNIT + 0.1 * (dy + 2), 100 * (dy + 1) + 10 * (dx + 1) + j)
    elif name == "full_cell_takes_no_mover":
        # K stayers, movers from both sides: no hole, every lander dropped
        g = np.zeros((ny + 2, k, 8, NXL), np.float32)
        for j in range(k):
            _put(g, 2, j, 4, 3 * UNIT + 0.2 * j + 0.1, UNIT + 0.5, j)
        for j, lane in ((0, 3), (2, 5), (3, 5)):
            _put(g, 2, j, lane, 3 * UNIT + 0.7, UNIT + 0.9, 50 + lane + j)
    elif name == "mk_equals_k":  # dense: the mover table never overflows
        g = _random_grid(rng, ny, k, nx, k, 1.2)
    elif name in ("cell_boundary", "below_boundary"):
        # x or y exactly on n * unit and on the field's far edges, or one
        # float below them; sources one cell away from where they land
        g = np.zeros((ny + 2, k, 8, NXL), np.float32)
        spots = [(4 * UNIT, 2 * UNIT), (5 * UNIT, 2.2), (7.1, 3 * UNIT),
                 (0.0, 0.0), (nx * UNIT, 1.0), (3.0, ny * UNIT),
                 ((nx - 1) * UNIT, (ny - 1) * UNIT), (UNIT, UNIT)]
        if name == "below_boundary":
            below = lambda v: np.nextafter(np.float32(v), np.float32(0))  # noqa: E731
            spots = [(below(x) if i % 3 != 1 else x, below(y) if i % 3 != 0 else y)
                     for i, (x, y) in enumerate(s_ for s_ in spots if s_ != (0.0, 0.0))]
        for i, (x, y) in enumerate(spots):
            cx = int(np.clip(np.floor(x / UNIT), 0, nx - 1))
            cy = int(np.clip(np.floor(y / UNIT), 0, ny - 1))
            for n, (ox, oy) in enumerate(((0, 0), (-1, 0), (1, 1))):
                lane, row = cx + ox + 1, cy + oy + 1
                if 1 <= lane <= nx and 1 <= row <= ny:
                    _put(g, row, (i + 2 * n) % k, lane, x, y, 10 * i + n)
    elif name in ("sentinel", "nan_inf"):
        # the step kernel's 2^30 sentinel and other huge positions, or NaN
        # and +-inf, in x or in y: all land off the field
        g = _random_grid(rng, ny, k, nx, 3, 0.9)
        bad = ([2.0 ** 30, -(2.0 ** 30), 3e38, -3e38, 2.0 ** 24, 1e9]
               if name == "sentinel" else [np.nan, np.inf, -np.inf] * 2)
        for i, v in enumerate(bad):
            _put(g, 2 + i % 3, 5, 3 + i, v, 1.6 + i % 3 * UNIT, 900 + i)
            _put(g, 2 + i % 3, 4, 12 + i, (11 + i) * UNIT + 0.3, v, 950 + i)
    elif name == "edge_lanes":
        # nx = NXL - 2: lanes 0 and NXL-1 are not owned but are candidates;
        # landers at lanes 1 and nx from inside and from outside, leavers
        nx = NXL - 2
        g = _random_grid(rng, ny, k, nx, 2, 0.9)
        g[:, :, :, 0] = 0.0
        g[:, :, :, NXL - 1] = 0.0
        for r in range(1, ny + 1):
            y = (r - 1) * UNIT + 0.4
            _put(g, r, 0, 0, 0.3, y, 1)  # from lane 0 into lane 1
            _put(g, r, 1, 0, -0.3, y, 2)  # lane 0, stays outside
            _put(g, r, 2, NXL - 1, nx * UNIT - 0.2, y, 3)  # into lane nx
            _put(g, r, 3, NXL - 1, nx * UNIT + 0.2, y, 4)  # stays outside
            _put(g, r, 4, 1, -0.1, y, 5)  # leaves the field at x < 0
            _put(g, r, 5, nx, nx * UNIT + 0.1, y, 6)  # and past the last cell
    elif name == "ny_cells_below_ny_pad":
        # 5 cell rows in 6 padded ones: the padding row's agents and the
        # agents that move into it vanish
        ny_cells = 5
        g = _random_grid(rng, ny, k, nx, 3, 0.9)
        for x in range(1, nx + 1, 3):
            _put(g, 5, 5, x, (x - 1) * UNIT + 0.5, 5 * UNIT + 0.1, 70)  # 4 -> 5
            _put(g, 6, 4, x, (x - 1) * UNIT + 0.6, 5 * UNIT - 0.1, 71)  # 5 -> 4
    elif name == "row_block_1":  # odd row count: tiles one row tall
        ny, rb_ = 5, 1
        g = _random_grid(rng, ny, k, nx, 5, 1.0)
    else:
        raise ValueError(name)
    return dict(g=g, k=k, mk=mk, ny=ny if ny_cells is None else ny_cells,
                nx=nx, rb=rb_, unit=UNIT)


CASES = ["k1", "k14_mk8", "k40_mk1", "k70", "k150", "nine_neighbours_overflow",
         "full_cell_takes_no_mover", "mk_equals_k", "cell_boundary",
         "below_boundary", "sentinel", "nan_inf", "edge_lanes",
         "ny_cells_below_ny_pad", "row_block_1"]


def rebin_case(name: str) -> dict:
    """One grid of CASES: g, gi, m (NumPy), k, mk, nx, ny (cell rows of the
    field), rb, unit."""
    case = _case_grid(name)
    case["gi"], case["m"] = split_stay_movers(case["g"], case["mk"], case["unit"])
    return case


def test_cases_hold_what_they_claim():
    """The grids do reach the corners they are named for."""
    c = rebin_case("nine_neighbours_overflow")
    assert c["gi"][3, :, 7, 6].sum() == 2 and c["m"][:, 0, 7].sum() == 16
    c = rebin_case("full_cell_takes_no_mover")
    assert c["gi"][2, :, 7, 4].sum() == c["k"] and c["m"][2, 0, 7, [3, 5]].tolist() == [1, 2]
    c = rebin_case("k40_mk1")
    assert c["m"].shape[1] == 1 and (c["g"][:, :, 6] > 0.5).sum() > 3 * c["m"][:, 0, 7].sum() > 0
    c = rebin_case("k70")
    assert (c["gi"][:, 65:, 7] > 0.5).any() and (c["g"][:, :, 6].sum(axis=1) > 64).any()
    c = rebin_case("edge_lanes")
    assert c["nx"] == NXL - 2 and (c["m"][1:-1, 0, 7, [0, NXL - 1]] == 1).all()
    assert (c["gi"][1:-1, :, 7, [0, NXL - 1]].sum(axis=1) == 1).all()  # unowned stayers
    c = rebin_case("nan_inf")
    assert np.isnan(c["m"][:, :, 0:2]).any() and np.isinf(c["m"][:, :, 0:2]).any()
    c = rebin_case("sentinel")
    assert np.isfinite(c["m"]).all() and np.abs(c["m"][:, :, 0:2]).max() > 1e38
    c = rebin_case("below_boundary")
    assert (c["g"][:, :, 0] == np.nextafter(np.float32(4 * UNIT), np.float32(0))).any()
    c = rebin_case("ny_cells_below_ny_pad")
    assert c["ny"] == c["g"].shape[0] - 3 and (c["g"][6, :, 6] > 0.5).any()


# (ny2, NXL, row_block): the 1M bench grid, random.toml's, the all-pairs 1M
# grid, the test grids of this module and a single centre row
SHAPES = [(178, 1024, 2), (136, 256, 2), (134, 896, 2), (8, 128, 2),
          (7, 128, 1), (3, 128, 1), (10, 128, 4)]


@pytest.mark.parametrize("ny2,nxl,row_block", SHAPES)
def test_rebin_launch_fits_and_covers(ny2, nxl, row_block):
    for k in range(1, 81):
        for mk in range(0, k + 1):
            rows, lanes, threads, smem = rb.rebin_launch(k, mk, ny2, nxl, row_block)
            assert smem == rb.rebin_smem_bytes(k, mk, rows, lanes) <= SMEM_BLOCK
            assert rows in (1, 2) and lanes in (32, 64) and threads == (rows + 2) * lanes
            # a tile lies inside one block of row_block rows; the launch
            # grid of csrc/rebin.cu covers every centre cell once
            assert row_block % rows == 0 and (ny2 - 2) % rows == 0 and nxl % lanes == 0
    rows, lanes, _, _ = rb.rebin_launch(14, 8, ny2, nxl, row_block)
    cover = np.zeros((ny2, nxl), np.int32)
    for by in range((ny2 - 2) // rows):
        for bx in range(nxl // lanes):
            cover[1 + by * rows:1 + (by + 1) * rows, bx * lanes:(bx + 1) * lanes] += 1
    assert (cover[1:-1] == 1).all() and (cover[[0, -1]] == 0).all()


def test_rebin_launch_narrows_the_tile_as_k_grows():
    """Room for REBIN_BLOCKS_AN_SM blocks on an SM: the bench's K keeps the
    widest tile, a tall K takes a narrower one, never none."""
    widths = [rb.rebin_launch(k, 0, 178, 1024, 2)[1] for k in (14, 40, 70, 150, 255)]
    assert widths[0] == 64 and widths[-1] == 32 and widths == sorted(widths, reverse=True)
    assert rb.rebin_launch(150, 150, 178, 1024, 2)[1] < rb.rebin_launch(150, 8, 178, 1024, 2)[1]
    for k, mk in ((14, 0), (14, 8), (70, 0), (255, 255)):
        smem = rb.rebin_launch(k, mk, 178, 1024, 2)[3]
        assert rb.REBIN_BLOCKS_AN_SM * (smem + 1024) <= 228 * 1024
    assert rb.rebin_launch(14, 0, 7, 128, 1)[0] == 1  # odd row_block: one row


@pytest.mark.parametrize("k,mk,ny2,nxl,row_block", [
    (0, 0, 178, 1024, 2), (256, 0, 178, 1024, 2), (14, 256, 178, 1024, 2),
    (14, 0, 178, 1000, 2), (14, 0, 2, 128, 2), (14, 0, 9, 128, 2)])
def test_rebin_launch_raises_on_a_grid_it_cannot_tile(k, mk, ny2, nxl, row_block):
    with pytest.raises(ValueError):
        rb.rebin_launch(k, mk, ny2, nxl, row_block)
