"""The port's standalone pairwise twin (``pairwise_torch``, the CPU path of
``pairwise``) vs the reference ``pallas_pairwise(..., interpret=True)`` on
tests/test_pallas.py's grid: 12 x 8 cells of 1.4 m, K = 8, row blocks 2
and 4, within test_pallas's tolerance (rtol 2e-5, atol 1e-5).  The CUDA
kernel (csrc/pairwise.cu) is held against the twin on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pedoni_tpu.ops.neighbor import CellGrid
from pedoni_tpu.ops.pallas.pairwise import pallas_pairwise
from pedoni_tpu.physics import Physics
from pedoni_tpu_torch.ops.kernels import pairwise as port_pair
from pedoni_tpu_torch.physics import Physics as PortPhysics

from test_pallas import _random_cell_data

torch.set_num_threads(1)


def _grid(rb):
    """test_pallas.py's random grid in the kernel's x-minor layout."""
    grid = CellGrid(unit=1.4, nx=12, ny=8)
    k = 8
    d = _random_cell_data(np.random.default_rng(0), grid, k)
    ny_pad = -(-grid.ny // rb) * rb
    nx128 = -(-(grid.nx + 2) // 128) * 128
    dt = np.zeros((ny_pad + 2, k, 8, nx128), np.float32)
    dt[: grid.ny + 2, :, :, : grid.nx + 2] = np.transpose(d, (0, 2, 3, 1))
    return dt


@pytest.mark.parametrize("rb", [2, 4])
def test_pairwise_twin_matches_pallas(rb):
    d = _grid(rb)
    want = np.asarray(pallas_pairwise(jnp.asarray(d), Physics(), row_block=rb,
                                      interpret=True))
    got = port_pair.pairwise(torch.from_numpy(d), PortPhysics(), row_block=rb)
    assert port_pair.pairwise.launches == 0  # a CPU tensor takes the twin
    assert got.shape == want.shape == (d.shape[0] - 2, 8, 2, 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-5)
    assert np.abs(want).max() > 0.1


def test_pairwise_rejects_bad_shapes():
    d = torch.zeros((6, 4, 8, 128))
    with pytest.raises(ValueError, match="row_block"):
        port_pair.pairwise(d, PortPhysics(), row_block=3)
    with pytest.raises(ValueError, match="NX"):
        port_pair.pairwise(torch.zeros((6, 4, 8, 100)), PortPhysics(), row_block=2)
