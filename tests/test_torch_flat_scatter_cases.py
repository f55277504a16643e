"""Seeded inputs for the flat step's pass after its sort and its
integration (tests/test_torch_flat_scatter.py on the CPU,
tests/test_torch_cuda.py and chip_smoke.py's phase 15 on the card), and a
check that they hold the edge cases they claim.  Imports neither JAX nor
the reference package."""

import numpy as np

UNIT = 1.4  # the flat step's cell unit

# name: (ny, nx, K, N agents, C kept after the sort, seed)
CASES = {
    "overflow": (9, 13, 10, 700, 700, 1),  # a crowd of 60 in one cell
    "capacity_cut": (9, 13, 10, 700, 520, 2),  # N > C: alive rows cut
    "nonfinite": (9, 13, 10, 700, 700, 3),  # NaN / inf rows, alive and dead
    "k255": (6, 5, 255, 900, 900, 4),  # a crowd of 300 in one cell
    "ragged_nx": (6, 131, 14, 2500, 2500, 5),
    "strip_window": (40, 23, 14, 3000, 2900, 6),  # an x-strip's local window
}
BIG = (452, 452, 14, 1_000_000, 1_000_000, 7)  # the 1M xla problem's grid


def scatter_case(name: str):
    """Seeded (packed [N, 12] f32, cid [N] i32, order [C] i64, (ny, nx), K)
    NumPy arrays as the flat step (or a strip step) hands them to its pass
    after the sort: rows laid out as flat_sample packs them, most alive in
    the grid, a crowd past K in one cell, a band of empty cell rows, 10%
    dead (cell id n_cells, alive 0) and some off the grid, a few alive
    flags 0 on a valid cell id (a hole in the cell's ranks, which the
    layout keeps), NaN and inf in velocities, goal directions and the
    obstacle channels of live rows and in positions of dead ones;
    ``order`` the first C entries of the stable argsort of ``cid``."""
    ny, nx, k, n, c, seed = BIG if name == "1M" else CASES[name]
    rng = np.random.default_rng(seed)
    n_cells = nx * ny
    pos = rng.uniform(0.0, 1.0, (n, 2)) * np.array([nx, ny]) * UNIT
    if name != "1M":
        crowd = {"k255": 300}.get(name, 60)
        pos[:crowd] = (np.array([nx // 2, ny // 2]) + rng.uniform(0.05, 0.95, (crowd, 2))
                       ) * UNIT
        band = ny // 2 + 2 if ny > 4 else None
        if band is not None:  # no agent in this cell row
            pos[:, 1] = np.where(np.floor(pos[:, 1] / UNIT) == band,
                                 pos[:, 1] + UNIT, pos[:, 1])
        off = rng.choice(np.arange(crowd, n), n // 20, replace=False)
        pos[off, 0] = rng.choice([-2.0, nx * UNIT + 3.0], off.size)
    pos = pos.astype(np.float32)
    alive = rng.uniform(size=n) >= 0.1
    with np.errstate(invalid="ignore"):
        cx = np.floor(pos[:, 0] / np.float32(UNIT))
        cy = np.floor(pos[:, 1] / np.float32(UNIT))
        alive &= (cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny)
    cid = np.where(alive, np.where(alive, cy, 0) * nx + np.where(alive, cx, 0),
                   n_cells).astype(np.int32)
    flag = alive.astype(np.float32)
    holes = rng.choice(np.nonzero(alive)[0], max(2, n // 200), replace=False)
    flag[holes] = 0.0
    vel = rng.normal(0.0, 0.8, (n, 2))
    e = rng.normal(0.0, 1.0, (n, 2))
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    obs = np.concatenate([rng.uniform(0.0, 6.0, (n, 1)), rng.normal(0, 2, (n, 2))], 1)
    packed = np.concatenate([
        pos, vel, rng.uniform(0.8, 1.7, (n, 1)),
        rng.integers(0, 3, (n, 1)).astype(np.float64), flag[:, None], e, obs,
    ], 1).astype(np.float32)
    if name == "nonfinite":
        live = np.nonzero(alive)[0]
        odd = [np.nan, np.inf, -np.inf, 2.0 ** 30]
        for ch in (2, 3, 7, 8, 9, 10):
            packed[rng.choice(live, len(odd), replace=False), ch] = odd
        dead = np.nonzero(~alive)[0][:8]
        packed[dead, 0:2] = np.nan
    order = np.argsort(cid, kind="stable")[:c].astype(np.int64)
    return packed, cid, order, (ny, nx), k


def test_cases_hold_their_edges():
    """Every case: cells past K, the sentinel run, holes in the ranks; the
    capacity cut drops alive rows; the non-finite case holds NaN and inf."""
    for name in CASES:
        packed, cid, order, (ny, nx), k = scatter_case(name)
        n_cells = nx * ny
        counts = np.bincount(cid[cid < n_cells], minlength=n_cells)
        assert counts.max() > k, name
        assert (cid == n_cells).sum() > 0.05 * cid.size, name
        assert ((cid < n_cells) & (packed[:, 6] == 0)).sum() >= 2, name
        assert (counts == 0).sum() > 0, name
        if name == "capacity_cut":
            assert order.size < (cid < n_cells).sum()
        if name == "nonfinite":
            assert np.isnan(packed[:, 2:4]).any() and np.isinf(packed[:, 7:9]).any()
