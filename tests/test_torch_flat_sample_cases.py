"""Seeded agents for the flat sample's twin and kernel
(tests/test_torch_flat_sample.py on the CPU, tests/test_torch_cuda.py and
chip_smoke.py's phase 15 on the card), and a check that they hold the edge
cases they claim.  Imports neither JAX nor the reference package."""

import numpy as np

CELL = 1.4  # the flat step's cell unit


def edge_case_agents(n: int, seed: int, size=(24.0, 24.0), n_wp: int = 2,
                     unit: float = CELL):
    """Seeded (pos, vel, speed, dest, active) NumPy arrays: most agents in
    the field, some off it (past the padding ring) and non-finite, some on
    cell boundaries (x or y = m * unit in f32), non-finite and huge
    velocities and speeds (2^30 itself, the float below it, inf, NaN),
    dest a valid waypoint or, for a tenth, -1, n_wp or n_wp + 1; 15%
    inactive."""
    rng = np.random.default_rng(seed)
    w, h = size
    pos = np.stack([rng.uniform(-3.0, w + 3.0, n), rng.uniform(-3.0, h + 3.0, n)], 1)
    b = n // 8
    m = rng.integers(0, int(max(w, h) / unit) + 1, (b, 2))
    pos[:b, 0] = np.float32(unit) * m[:, 0]  # on a column boundary
    pos[b // 2:b, 1] = np.float32(unit) * m[b // 2:, 1]  # on both
    odd = [1e6, -1e6, np.inf, -np.inf, np.nan, 1e30]
    pos[b:b + len(odd), 0] = odd
    pos[b + len(odd):b + 2 * len(odd), 1] = odd
    vel = rng.normal(0.0, 0.8, (n, 2))
    speed = rng.uniform(0.8, 1.7, n)
    big = [np.inf, -np.inf, np.nan, 2.0 ** 30, -2.0 ** 30, 2.0 ** 30 - 64, 1e30, -1e38]
    idx = rng.choice(n, (3, len(big)), replace=False)
    vel[idx[0], 0] = big
    vel[idx[1], 1] = big
    speed[idx[2]] = big
    dest = rng.integers(0, n_wp, n)
    past = rng.uniform(size=n) < 0.1
    dest[past] = rng.choice([-1, n_wp, n_wp + 1], past.sum())
    active = rng.uniform(size=n) < 0.85
    return (pos.astype(np.float32), vel.astype(np.float32), speed.astype(np.float32),
            dest.astype(np.int32), active)


def test_edge_cases_are_there():
    """Off the map, non-finite positions, exact cell boundaries,
    non-finite and huge velocities and speeds, dest past the planes."""
    pos, vel, speed, dest, act = edge_case_agents(3000, 2)
    assert pos.dtype == vel.dtype == speed.dtype == np.float32
    assert dest.dtype == np.int32 and act.dtype == bool
    assert (~np.isfinite(pos)).any(axis=1).sum() >= 6
    with np.errstate(invalid="ignore"):
        assert ((pos < 0) | (pos > 24)).any(axis=1).sum() > 200
    q = pos[:, 0] / np.float32(CELL)
    assert (q == np.floor(q)).sum() > 100
    assert (~np.isfinite(vel)).any() and (~np.isfinite(speed)).any()
    assert (np.abs(vel) == 2.0 ** 30).any() and (speed == 2.0 ** 30 - 64).any()
    assert ((dest < 0) | (dest > 1)).sum() > 100 and 0.8 < act.mean() < 0.9
