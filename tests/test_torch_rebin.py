"""The port's full rebin (pedoni_tpu_torch/ops/kernels/rebin.py) vs the
reference: its plain PyTorch twin must be BIT-exact with the NumPy
referee tests/test_rebin.py::_numpy_rebin on that file's cases, and with
the reference Pallas kernel in interpret mode.  The CUDA kernel itself is
held against the twin on the card by tests/test_torch_cuda.py and
chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pedoni_tpu.ops.pallas.rebin import rebin_kernel
from pedoni_tpu_torch.ops.kernels import rebin as port_rebin
from test_rebin import K, NX, NXL, UNIT, _block_reductions, _make_grid, _numpy_rebin
from test_torch_rebin_cases import CASES, rebin_case

torch.set_num_threads(1)


def _port(g: np.ndarray, ny: int, rb: int = 2):
    return [t.numpy() for t in port_rebin.rebin(torch.from_numpy(g), UNIT, NX,
                                                 ny, row_block=rb)]


@pytest.mark.parametrize("ny,seed", [(8, 1), (6, 2), (8, 4)])
def test_rebin_twin_matches_numpy(ny, seed):
    g = _make_grid(ny, seed=seed)
    want, demand = _numpy_rebin(g, UNIT, NX, ny)
    got, ovf, dmx, nin, nout = _port(g, ny)
    np.testing.assert_array_equal(got, want)
    want_ovf, want_dmx = _block_reductions(demand, 2, K)
    np.testing.assert_array_equal(ovf, want_ovf)
    np.testing.assert_array_equal(dmx, want_dmx)
    for i in range(ny // 2):
        rows = slice(i * 2 + 1, i * 2 + 3)
        assert nin[i] == g[rows, :, 6, 1:NX + 1].sum()
        assert nout[i] == (got[rows, :, 6, :] > 0.5).sum()


@pytest.mark.parametrize("case", CASES)
def test_rebin_twin_tile_edge_cases(case):
    """The grids built to break a tiled, bit-mask rebin (K = 1, K past 64,
    nine-neighbour overflow, exact cell boundaries, non-finite positions,
    the edge lanes, padding rows, odd row counts): the twin equals the
    NumPy referee bit for bit on all five outputs."""
    c = rebin_case(case)
    g, k, nx, ny, rb = c["g"], c["k"], c["nx"], c["ny"], c["rb"]
    with np.errstate(invalid="ignore", over="ignore"):
        want, demand = _numpy_rebin(g, c["unit"], nx, ny)
    got, ovf, dmx, nin, nout = [t.numpy() for t in port_rebin.rebin(
        torch.from_numpy(g), c["unit"], nx, ny, row_block=rb)]
    np.testing.assert_array_equal(got, want)
    want_ovf, want_dmx = _block_reductions(demand, rb, k)
    np.testing.assert_array_equal(ovf, want_ovf)
    np.testing.assert_array_equal(dmx, want_dmx)
    for i in range((g.shape[0] - 2) // rb):
        rows = slice(i * rb + 1, (i + 1) * rb + 1)
        assert nin[i] == g[rows, :, 6, 1:nx + 1].sum()
        assert nout[i] == (want[rows, :, 6, :] > 0.5).sum()
    assert nout.sum() > 0
    if case in ("k1", "nine_neighbours_overflow", "full_cell_takes_no_mover"):
        assert ovf.sum() > 0  # landers genuinely dropped


def test_rebin_twin_conservation():
    ny = 6
    g = _make_grid(ny, seed=2)
    _want, demand = _numpy_rebin(g, UNIT, NX, ny)
    got, ovf, _dmx, _nin, nout = _port(g, ny)
    kept = np.minimum(demand, K).sum()
    assert (got[:, :, 6, :] > 0.5).sum() == kept == nout.sum()
    assert ovf.sum() == np.maximum(demand - K, 0).sum()


def test_rebin_twin_overflow_drops_in_order():
    ny = 4
    g = np.zeros((ny + 2, K, 8, NXL), np.float32)
    tx, ty = 5 * UNIT + 0.7, 1 * UNIT + 0.7
    for x in (4, 5, 6):
        for j in range(K):
            g[2, j, 0, x + 1] = tx
            g[2, j, 1, x + 1] = ty
            g[2, j, 4, x + 1] = 100 * x + j  # tag in the speed channel
            g[2, j, 6, x + 1] = 1.0
    got, ovf, dmx, _nin, _nout = _port(g, ny)
    cell = got[2, :, :, 6]
    assert (cell[:, 6] > 0.5).all()
    assert got[2, 0, 7, 6] == K
    assert dmx[0] == 18
    assert ovf[0] == 18 - K
    np.testing.assert_array_equal(cell[:, 4], [400, 500, 600, 401, 501, 601])
    assert (got[:, :, 6, :] > 0.5).sum() == K


def test_rebin_twin_out_of_field_vanish():
    ny = 4
    g = np.zeros((ny + 2, K, 8, NXL), np.float32)
    g[1, 0, 0:2, 1] = (-0.3, 0.5)
    g[1, 0, 6, 1] = 1.0
    g[ny, 1, 0:2, 3] = (2.0, ny * UNIT + 0.2)
    g[ny, 1, 6, 3] = 1.0
    g[1, 2, 0:2, NX] = (NX * UNIT + 0.1, 0.5)
    g[1, 2, 6, NX] = 1.0
    got, ovf, _dmx, nin, nout = _port(g, ny)
    assert (got[:, :, 6, :] > 0.5).sum() == 0
    assert ovf.sum() == 0 and nout.sum() == 0 and nin.sum() == 3
    assert np.all(got[0] == 0) and np.all(got[-1] == 0)


def test_rebin_twin_matches_pallas_emit_counts():
    """One call against the reference kernel itself (interpret mode, the
    shape of tests/test_rebin.py) with emit_counts: every output equal."""
    ny = 8
    g = _make_grid(ny, seed=4)
    want = [np.asarray(a) for a in rebin_kernel(
        jnp.asarray(g), UNIT, NX, ny, row_block=2, interpret=True,
        emit_counts=True)]
    got = _port(g, ny)
    for w, o in zip(want, got):
        np.testing.assert_array_equal(o, w)


def test_rebin_cpu_tensor_takes_the_twin():
    ny = 4
    g = torch.from_numpy(_make_grid(ny, seed=5))
    before = port_rebin.rebin.launches
    a = port_rebin.rebin(g, UNIT, NX, ny, row_block=2)
    b = port_rebin.rebin_torch(g, UNIT, NX, ny, row_block=2)
    assert port_rebin.rebin.launches == before == 0
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_rebin_rejects_bad_input():
    g = torch.zeros((6, K, 8, 100))
    with pytest.raises(ValueError):
        port_rebin.rebin(g, UNIT, NX, 4)
    with pytest.raises(ValueError):
        port_rebin.rebin(torch.zeros((6, K, 8, NXL), dtype=torch.float64),
                         UNIT, NX, 4)

