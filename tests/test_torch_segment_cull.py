"""The segment mode's obstacle cull and the launch choosers of the pair
passes, on the CPU.

In segments mode (--no-distance-map) the step kernel's pair pass walks, for
a tile of cells, only the edge-table rows whose rectangle's box lies within
``segment_cull`` of the tile's agents' box (csrc/step_kernel.cu explains why
that changes no bit: past ~104 obstacle ranges exp(-d / obs_range) is
exactly 0 in f32).  Here the rule is computed with NumPy, as the kernel
states it, on scenarios/random.toml's 1000-row edge table and ~2000 seeded
agents over its 200 x 200 m field — agents inside rectangles and agents 20
to 24 m from one included — and the plain PyTorch twin's ``_segment_accel``
on the culled tables equals, bit for bit, the twin on the whole table.

The choosers (``step_kernel.pair_pass_launch`` in segments mode,
``pairwise.pairwise_launch``) are plain Python: their tiles fit a block's
shared memory, use the kernels' sums and cover the grid.  The kernels
themselves run on the card only (tests/test_torch_cuda.py).
"""

import pathlib

import numpy as np
import pytest
import torch

from pedoni_tpu_torch import load_scenario
from pedoni_tpu_torch.ops.kernels import pairwise as pw
from pedoni_tpu_torch.ops.kernels import step_kernel as sk
from pedoni_tpu_torch.ops.kernels import tiles
from pedoni_tpu_torch.physics import Physics

torch.set_num_threads(1)

RANDOM = pathlib.Path(__file__).resolve().parents[1] / "scenarios" / "random.toml"
SMEM_BLOCK = 227 * 1024  # bytes of shared memory one block may use on an H100
FIELD = (200.0, 200.0)


def _obstacles():
    sc = load_scenario(RANDOM)
    assert tuple(sc.size) == FIELD
    return [(o.line[0][0], o.line[0][1], o.line[1][0], o.line[1][1], o.width)
            for o in sc.obstacles]


def _agents(obs):
    """~2000 agents: uniform over the field, at the centres of 200
    rectangles, and 100 on the normal through a rectangle's midpoint, 20 to
    24 m from its long side."""
    rng = np.random.default_rng(6)
    pts = [rng.uniform(0.5, 199.5, (1700, 2))]
    o = np.asarray(obs, np.float64)
    mid = 0.5 * (o[:, 0:2] + o[:, 2:4])
    pts.append(mid[rng.choice(len(o), 200, replace=False)])
    seg = o[:, 2:4] - o[:, 0:2]
    normal = np.stack([seg[:, 1], -seg[:, 0]], 1) / np.linalg.norm(seg, axis=1)[:, None]
    ring = []
    for i in rng.permutation(len(o)):
        p = mid[i] + normal[i] * (0.5 * o[i, 4] + rng.uniform(20.0, 24.0))
        if 0.5 < p[0] < 199.5 and 0.5 < p[1] < 199.5:
            ring.append(p)
        if len(ring) == 100:
            break
    pts.append(np.asarray(ring))
    return np.concatenate(pts).astype(np.float32)


def _cull(table: np.ndarray, xs: np.ndarray, ys: np.ndarray, cull: float):
    """The rows the kernel keeps for agents at (xs, ys): the box of edge 0's
    and edge 1's q0 and q0 + s, in f32, within ``cull`` of the agents' box
    on both axes."""
    t = table.astype(np.float32)
    cx = np.stack([t[:, 0], t[:, 0] + t[:, 2], t[:, 5], t[:, 5] + t[:, 7]])
    cy = np.stack([t[:, 1], t[:, 1] + t[:, 3], t[:, 6], t[:, 6] + t[:, 8]])
    gx = np.maximum(cx.min(0) - xs.max(), xs.min() - cx.max(0))
    gy = np.maximum(cy.min(0) - ys.max(), ys.min() - cy.max(0))
    return ~((gx >= np.float32(cull)) | (gy >= np.float32(cull)))


def test_cull_changes_no_bit_of_the_twin():
    obs = _obstacles()
    table = sk.segment_table(obs, "cpu")
    assert table.shape == (1000, sk.SEG_COLS)
    phys = Physics()
    cull = sk.segment_cull(phys, FIELD)
    assert sk.SEG_CULL_RANGES * phys.obs_range < cull < 22.2
    pts = _agents(obs)
    px, py = torch.from_numpy(pts[:, 0]), torch.from_numpy(pts[:, 1])
    whole = sk._segment_accel(px, py, table, phys)
    assert float(whole[0].abs().max()) > 1.0  # agents inside and next to walls

    # groups: squares of 100 m (many agents), and 30 ring agents alone (a
    # point box, the tightest cull)
    sq = (pts[:, 0] // 100).astype(int) * 2 + (pts[:, 1] // 100).astype(int)
    groups = [np.nonzero(sq == g)[0] for g in range(4)]
    groups += [np.array([i]) for i in range(len(pts) - 30, len(pts))]
    tab = table.numpy()
    dropped = 0
    for idx in groups:
        keep = _cull(tab, pts[idx, 0], pts[idx, 1], cull)
        assert keep.sum() < 0.7 * len(tab)
        dropped += int((~keep).sum())
        part = sk._segment_accel(px[idx], py[idx], table[torch.from_numpy(keep)], phys)
        for a, b in zip(part, whole):
            assert torch.equal(a, b[idx])
    assert dropped > 28_000

    # the cull is not vacuous: a term from an obstacle 19.5 m off is not
    # yet 0 (a denormal), so a cull at ~19 m would change bits
    o = np.asarray(obs[0], np.float64)
    mid, seg = 0.5 * (o[0:2] + o[2:4]), o[2:4] - o[0:2]
    p = mid + np.array([seg[1], -seg[0]]) / np.linalg.norm(seg) * (0.5 * o[4] + 19.5)
    far = sk._segment_accel(torch.tensor([p[0]], dtype=torch.float32),
                            torch.tensor([p[1]], dtype=torch.float32), table[:1], phys)
    assert 0 < float(torch.hypot(*far)) < 1e-40


def test_segment_walk_choice():
    """Tables of up to SEG_SAMPLE_WALK rows (the shipped scenarios' 1 to 4)
    are walked by the sample pass, longer ones (random.toml's 1000) by the
    pair pass, whose launch then carries the segment pass's shared
    memory."""
    assert sk.SEG_SAMPLE_WALK == 8
    assert [sk.segment_pass(n) for n in (0, 1, 4, 8, 9, 16, 1000)] == [
        False, False, False, False, True, True, True]
    walk = sk.pair_pass_launch(16, 136, 256, segments=sk.segment_pass(4))
    cull = sk.pair_pass_launch(16, 136, 256, segments=sk.segment_pass(1000))
    assert walk[:2] == cull[:2] and cull[2] - walk[2] == (
        4 * sk.SEG_COLS * sk.SEG_CAP + 8 * sk.SEG_TERM_CAP + 16 * 32 + 16)


@pytest.mark.parametrize("k", [1, 8, 14, 29, 150])
@pytest.mark.parametrize("ny2,nxl", [(178, 1024), (136, 256), (19, 128), (3, 128)])
def test_segment_pair_pass_launch(k, ny2, nxl):
    """Segments mode adds its staged rows and terms to the pair pass's
    shared memory; the tile still fits a block and covers the grid once;
    at K = 150 no tile holds every slot level in either mode, and one-row
    tiles stage them in chunks, the segment pass's room shared with the
    staging."""
    if k == 150:
        for seg in (False, True):
            rows, threads, smem, levels = sk.pair_pass_launch(k, ny2, nxl,
                                                              segments=seg)
            assert (rows, threads) == (1, 512) and levels < k
            assert levels % sk.WALK_LEVELS == 0
            assert smem == sk.pair_pass_smem_bytes(k, 1, seg, levels) <= SMEM_BLOCK
        _assert_covers(1, ny2, nxl)
        return
    rows, threads, smem, levels = sk.pair_pass_launch(k, ny2, nxl, segments=True)
    assert levels == k
    extra = (4 * sk.SEG_COLS * sk.SEG_CAP + 8 * sk.SEG_TERM_CAP + 16 * 32 + 16)
    assert smem == sk.pair_pass_smem_bytes(k, rows) + extra <= SMEM_BLOCK
    assert smem == sk.pair_pass_smem_bytes(k, rows, segments=True)
    assert threads == 512 and rows in (1, 2) and rows <= ny2 - 2
    _assert_covers(rows, ny2, nxl)
    if k <= 16 and ny2 > 3:  # random.toml's K 16: two blocks an SM, 2 rows
        assert rows == 2 and 2 * (smem + tiles.SMEM_BLOCK_RESERVED) <= tiles.SMEM_SM


@pytest.mark.parametrize("k", [1, 8, 14, 29, 150])
@pytest.mark.parametrize("ny2,nx", [(178, 1024), (18, 128), (19, 256), (3, 128)])
def test_pairwise_launch(k, ny2, nx):
    """2D's tile: 512 threads, 1 or 2 rows, the shared memory of
    csrc/pairwise.cu's sum, room for two blocks an SM up to K 29; at K =
    150 no tile holds every slot level, and one-row tiles stage a dy row's
    levels in chunks."""
    if k == 150:
        rows, threads, smem, levels = pw.pairwise_launch(k, ny2, nx)
        assert (rows, threads) == (1, 512) and levels < k
        assert levels % pw.HIT_LEVELS == 0
        assert smem == pw.pairwise_smem_bytes(k, 1, levels) <= SMEM_BLOCK
        # masks, one dy row's staged levels, accelerations, list, counters, box
        assert smem == 8 * 3 * k + 20 * levels * 34 + 10 * k * 32 + 12 + 8 + 512
        _assert_covers(1, ny2, nx)
        return
    rows, threads, smem, levels = pw.pairwise_launch(k, ny2, nx)
    assert levels == k
    assert smem == pw.pairwise_smem_bytes(k, rows) <= SMEM_BLOCK
    assert threads == 512 and rows in (1, 2) and rows <= ny2 - 2
    assert 2 * (smem + tiles.SMEM_BLOCK_RESERVED) <= tiles.SMEM_SM
    _assert_covers(rows, ny2, nx)
    # what csrc/pairwise.cu lays out: masks, staged positions and velocity
    # terms, accelerations, list, per-row counters, per-warp box
    h, n_tile = rows + 2, rows * k * 32
    assert smem == 8 * h * k + 20 * h * k * 34 + 10 * n_tile + 4 * h + 4 * (rows + 1) + 512


def test_pairwise_launch_refuses_bad_grids():
    for args in ((14, 178, 1000), (0, 178, 1024), (14, 2, 128)):
        with pytest.raises(ValueError):
            pw.pairwise_launch(*args)


def _assert_covers(rows, ny2, nxl):
    """The launch grid of the pair passes: every centre cell once."""
    grid_x, grid_y = nxl // 32, -(-(ny2 - 2) // rows)
    cover = np.zeros((ny2, nxl), np.int32)
    for by in range(grid_y):
        r0 = 1 + by * rows
        cover[r0:min(r0 + rows, ny2 - 1)] += 1
    assert grid_x * 32 == nxl
    assert (cover[1:-1] == 1).all() and (cover[[0, -1]] == 0).all()
