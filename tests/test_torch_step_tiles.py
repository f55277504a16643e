"""The step kernel's host-side helpers, on the CPU: the pair pass's tile
chooser (``pair_pass_launch``) and the texel-major field copy
(``pack_fields`` / ``packed_fields``) of
pedoni_tpu_torch/ops/kernels/step_kernel.py.

The kernel itself runs only on the card (tests/test_torch_cuda.py); what
it is launched with and what it reads are plain Python and torch, checked
here: every tile shape fits a block's shared memory and the tiles cover
every centre cell once; the packed fields hold exactly fields6's values at
the texel each (row, lane, qy, qx) of the twin's ``_sample`` addresses, the
circular lane wrap included, for field strides 6 and 8; and a sample taken
through the packed copy equals, bit for bit, both the twin's and the JAX
package's own (pedoni_tpu/ops/pallas/step_kernel.py::_sample_row, run in
Pallas interpret mode), so the packer and the twin cannot share a wrong
index rule unseen.
"""

import functools
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from pedoni_tpu.ops.pallas.fields6 import ROW0 as REF_ROW0
from pedoni_tpu.ops.pallas.step_kernel import _sample_row
from pedoni_tpu_torch.ops.kernels import step_kernel as sk

torch.set_num_threads(1)

SMEM_BLOCK = 227 * 1024  # bytes of shared memory one block may use on an H100

# (ny2, NXL): the 1M bench grid, random.toml's, the all-pairs 1M grid, an
# odd number of centre rows at the narrowest lane count, a single centre row
SHAPES = [(178, 1024), (136, 256), (134, 896), (19, 128), (3, 128)]


@pytest.mark.parametrize("k", [14, 16, 25, 29])
@pytest.mark.parametrize("ny2,nxl", SHAPES)
def test_pair_pass_launch_fits_and_covers(k, ny2, nxl):
    rows, threads, smem, levels = sk.pair_pass_launch(k, ny2, nxl)
    assert smem == sk.pair_pass_smem_bytes(k, rows) <= SMEM_BLOCK
    assert levels == k  # every slot level staged at once
    assert threads == 512 and rows in (1, 2)  # all csrc/step_kernel.cu takes
    # the launch grid of csrc/step_kernel.cu: every centre cell once
    grid_x, grid_y = nxl // sk.TILE_LANES, -(-(ny2 - 2) // rows)
    cover = np.zeros((ny2, nxl), np.int32)
    for by in range(grid_y):
        r0 = 1 + by * rows
        for bx in range(grid_x):
            cover[r0:min(r0 + rows, ny2 - 1),
                  bx * sk.TILE_LANES:(bx + 1) * sk.TILE_LANES] += 1
    assert (cover[1:-1] == 1).all() and (cover[[0, -1]] == 0).all()


def test_pair_pass_launch_prefers_two_blocks_an_sm():
    """512 threads and room for a second block at the bench's K = 14 and
    the all-pairs K = 29 alike, the most blocks of the pair pass an SM's
    registers hold (three) first: two rows of cells at K 14, where three
    blocks of them fit, one row at K 29 and K 25, where only one-row tiles
    leave room for a third, and two rows again at K 16."""
    assert sk.pair_pass_launch(14, 178, 1024)[:2] == (2, 512)
    assert sk.pair_pass_launch(16, 136, 256)[:2] == (2, 512)
    assert sk.pair_pass_launch(29, 136, 256)[:2] == (1, 512)
    assert sk.pair_pass_launch(25, 178, 1024)[:2] == (1, 512)
    assert sk.PAIR_BLOCKS_SM == 3
    for k in (14, 16, 25, 29):
        assert 2 * (sk.pair_pass_launch(k, 178, 1024)[2] + 1024) <= 228 * 1024


@pytest.mark.parametrize("k,ny2,nxl", [(256, 178, 1024), (0, 178, 1024),
                                       (14, 178, 1000), (14, 2, 128)])
def test_pair_pass_launch_raises_where_nothing_fits(k, ny2, nxl):
    with pytest.raises(ValueError):
        sk.pair_pass_launch(k, ny2, nxl)


def test_pair_pass_launch_falls_back_to_one_row():
    """A K at which two blocks of two rows no longer fit an SM takes one
    row; a grid with one centre row does too; smem grows with K."""
    rows, threads, smem, levels = sk.pair_pass_launch(40, 178, 1024)
    assert rows == 1 and threads == 512 and 2 * (smem + 1024) <= 228 * 1024
    assert levels == 40
    assert sk.pair_pass_launch(14, 3, 128)[0] == 1
    assert sk.pair_pass_smem_bytes(29, 2) > sk.pair_pass_smem_bytes(25, 2)


def _fields(stride, n_wp, ny2=7, nxl=128, seed=0):
    rng = np.random.default_rng(seed)
    r = stride * (ny2 + 1) + sk.ROW0 + 2
    fwp = torch.from_numpy(rng.normal(size=(n_wp, r, stride, 4, nxl)).astype(np.float32))
    fobs = torch.from_numpy(rng.normal(size=(r, stride, 4, nxl)).astype(np.float32))
    return fwp, fobs


@pytest.mark.parametrize("stride", [6, 8])
@pytest.mark.parametrize("n_wp", [1, 2, 3, 8, 33])
def test_pack_fields_holds_fields6_at_every_tap(stride, n_wp):
    """For every (row, lane) and every tap (qy, qx) of the cell's (S+2)^2
    patch, the texel the kernel addresses — plane, field row, lane' * S +
    col % S with lane' = (lane + col // S) mod NXL — holds the 4 channels
    that ``_sample`` reads from fwp and from fobs."""
    ny2, nxl = 7, 128
    fwp, fobs = _fields(stride, n_wp, ny2, nxl)
    packed = sk.pack_fields(fwp, fobs)
    assert packed.shape == (n_wp, fwp.shape[1], nxl * stride, 8)
    assert packed.is_contiguous() and packed.dtype == torch.float32
    row, lane, qy, qx = torch.meshgrid(
        torch.arange(ny2), torch.arange(nxl), torch.arange(stride + 2),
        torch.arange(stride + 2), indexing="ij")
    frow = stride * row + sk.ROW0 + qy  # _sample's index arithmetic
    col = qx + sk.ROW0
    l2 = (lane + col // stride) % nxl
    assert int(l2.min()) == 0 and bool((l2 < lane).any())  # the wrap is hit
    x = l2 * stride + col % stride
    for p in range(n_wp):
        got = packed[p, frow, x]  # [..., 8]
        assert torch.equal(got[..., :4], fwp[p][frow, col % stride, :, l2])
        assert torch.equal(got[..., 4:], fobs[frow, col % stride, :, l2])


@functools.lru_cache(maxsize=None)
def _reference_row(stride, k, nxl):
    def body(f_ref, q0_ref, p0_ref, tx_ref, ty_ref, o_ref):
        vals = _sample_row(f_ref, 0, q0_ref[...], p0_ref[...], tx_ref[...],
                           ty_ref[...], stride=stride)
        for c, v in enumerate(vals):
            o_ref[c] = v

    return jax.jit(pl.pallas_call(
        body, out_shape=jax.ShapeDtypeStruct((3, k, nxl), jnp.float32),
        interpret=True))


def _reference_sample(plane, q0, p0, tx, ty, stride):
    """The JAX package's field sample of one fields6 plane [R, S, 4, NXL]
    for every slot of the grid: ``_sample_row`` per cell row, as its step
    kernel calls it (step_kernel.py:499-519: the row's window of S + 2 field
    rows starts at ROW0 + S * row), in interpret mode, compiled once.
    q0, p0, tx, ty: [ny2, K, NXL].  Returns 3 tensors [ny2, K, NXL]."""
    ny2, k, nxl = q0.shape
    one_row = _reference_row(stride, k, nxl)
    rows = []
    for w in range(ny2):
        start = REF_ROW0 + stride * w
        rows.append(np.array(one_row(*(jnp.asarray(a.numpy()) for a in (
            plane[start:start + stride + 2], q0[w], p0[w], tx[w], ty[w])))))
    out = torch.from_numpy(np.stack(rows))  # [ny2, 3, K, NXL]
    return [out[:, c] for c in range(3)]


@pytest.mark.parametrize("stride", [6, 8])
def test_packed_sample_equals_twin_sample(stride):
    """Sampling through the packed copy with the kernel's addressing gives
    the twin's ``_sample`` bit for bit and the JAX package's
    ``_sample_row`` within 1e-6 absolute on fields of unit variance (one
    ulp was read: XLA's CPU code contracts the multiply-add), agents near
    the patch edges and in the last lane included."""
    ny2, k, nxl = 7, 3, 128
    fwp, fobs = _fields(stride, 2, ny2, nxl, seed=1)
    packed = sk.pack_fields(fwp, fobs)
    rng = np.random.default_rng(2)
    row = torch.arange(ny2).view(ny2, 1, 1).float()
    lane = torch.arange(nxl).view(1, 1, nxl).float()
    # field coordinates around each slot's own cell, some outside its patch
    px = torch.from_numpy(rng.uniform(-1.5, stride + 1.5, (ny2, k, nxl)).astype(np.float32)) \
        + (lane - 1.0) * stride + sk.ROW0
    py = torch.from_numpy(rng.uniform(-1.5, stride + 1.5, (ny2, k, nxl)).astype(np.float32)) \
        + (row - 1.0) * stride + sk.ROW0
    plane = torch.from_numpy(rng.integers(0, 2, (ny2, k, nxl)))
    ok = torch.ones_like(plane, dtype=torch.bool)
    want_wp = sk._sample(fwp, plane, ok, px, py, stride, 3)
    want_obs = sk._sample(fobs[None], None, None, px, py, stride, 3)

    bx, by = torch.floor(px), torch.floor(py)
    tx, ty = px - bx, py - by
    p0 = bx - (lane - 1.0) * stride - sk.ROW0
    q0 = by - (row - 1.0) * stride - sk.ROW0
    got = [torch.zeros_like(px) for _ in range(8)]
    for a in (0, 1):
        for b in (0, 1):
            qy, qx = q0 + a, p0 + b
            inside = (qy >= 0) & (qy <= stride + 1) & (qx >= 0) & (qx <= stride + 1)
            w = (ty if a else 1.0 - ty) * (tx if b else 1.0 - tx)
            frow = stride * row.long() + sk.ROW0 + torch.where(inside, qy, 0.0).long()
            col = sk.ROW0 + torch.where(inside, qx, 0.0).long()
            l2 = lane.long() + col // stride
            l2 = torch.where(l2 >= nxl, l2 - nxl, l2)
            texel = packed[plane, frow, l2 * stride + col % stride]
            for c in range(8):
                got[c] = got[c] + torch.where(inside, w * texel[..., c], 0.0)
    for c in range(3):
        assert torch.equal(got[c], want_wp[c])
        assert torch.equal(got[4 + c], want_obs[c])
    assert float(want_wp[0].abs().max()) > 0.1
    # the reference samples one plane a call: each slot takes its own
    ref = [_reference_sample(f, q0, p0, tx, ty, stride)
           for f in (fwp[0], fwp[1], fobs)]
    for c in range(3):
        torch.testing.assert_close(
            got[c], torch.where(plane == 0, ref[0][c], ref[1][c]),
            rtol=0.0, atol=1e-6)
        torch.testing.assert_close(got[4 + c], ref[2][c], rtol=0.0, atol=1e-6)


def test_pack_fields_without_waypoints_keeps_the_obstacle_map():
    fwp, fobs = _fields(6, 1)
    packed = sk.pack_fields(fwp[:0], fobs)
    assert packed.shape[0] == 1 and not bool(packed[..., :4].any())
    assert torch.equal(packed[..., 4:], sk.pack_fields(fwp, fobs)[..., 4:])


def test_packed_fields_is_made_once_per_field():
    fwp, fobs = _fields(6, 2)
    first = sk.packed_fields(fwp, fobs)
    assert sk.packed_fields(fwp, fobs) is first  # a step packs nothing
    assert torch.equal(first, sk.pack_fields(fwp, fobs))
    fobs[0, 0, 0, 0] = 5.0  # written in place: packed anew, same bits
    second = sk.packed_fields(fwp, fobs)
    assert second is not first and float(second[0, 0, 0, 4]) == 5.0
    assert sk.packed_fields(fwp, fobs) is second
    other = sk.packed_fields(*_fields(6, 2, seed=3))
    assert other is not second and sk.packed_fields(fwp, fobs) is second
    n = len(sk._packed)
    del fwp, fobs, other
    gc.collect()
    assert len(sk._packed) < n  # freed fields drop their copies
