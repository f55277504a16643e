"""The pair passes' launch choosers take every K the grid allows (1 to 255),
on the CPU: pedoni_tpu_torch/ops/kernels/{step_kernel,pairwise,rebin}.py.

Where a one-row tile's K slot levels do not fit a block's shared memory
(the step's pair pass above K 98, above 92 in segments mode; 2D above 97),
the chooser plans one-row tiles that stage the levels in chunks, a
multiple of the kernel's word of hits (7 levels for the step, 21 for 2D),
as many as fit.  Every K that fitted before keeps the plan it had: all
levels staged at once, the same tile and shared memory.  The kernels
themselves run on the card (tests/test_torch_cuda.py::
test_pair_passes_at_large_k).
"""

import pytest
import torch

from pedoni_tpu_torch.ops.kernels import pairwise as pw
from pedoni_tpu_torch.ops.kernels import rebin as rb
from pedoni_tpu_torch.ops.kernels import step_kernel as sk
from pedoni_tpu_torch.ops.kernels import tiles

torch.set_num_threads(1)

ROOM = tiles.SMEM_SM - tiles.SMEM_BLOCK_RESERVED  # bytes a block may use
NY2 = 178  # the 1M bench grid's rows

# chooser -> (plan of (K, NXL), the largest K that stages all levels, word)
CHOOSERS = {
    "step": (lambda k, nxl: sk.pair_pass_launch(k, NY2, nxl), 98, sk.WALK_LEVELS),
    "step_segments": (lambda k, nxl: sk.pair_pass_launch(k, NY2, nxl, True), 92,
                      sk.WALK_LEVELS),
    "pairwise": (lambda k, nxl: pw.pairwise_launch(k, NY2, nxl), 97, pw.HIT_LEVELS),
}
SMEM = {
    "step": lambda k, rows, levels: sk.pair_pass_smem_bytes(k, rows, False, levels),
    "step_segments": lambda k, rows, levels: sk.pair_pass_smem_bytes(k, rows, True,
                                                                     levels),
    "pairwise": lambda k, rows, levels: pw.pairwise_smem_bytes(k, rows, levels),
}


@pytest.mark.parametrize("nxl", [128, 1024])
@pytest.mark.parametrize("name", list(CHOOSERS))
def test_pair_pass_plans_every_k(name, nxl):
    choose, whole_up_to, word = CHOOSERS[name]
    for k in range(1, 256):
        rows, threads, smem, levels = choose(k, nxl)
        assert threads == tiles.PAIR_THREADS and rows in (1, 2)
        assert smem == SMEM[name](k, rows, levels) <= ROOM, k
        if k <= whole_up_to:
            assert levels == k, k
            continue
        # chunks: one-row tiles, a multiple of the word, the most that fit
        assert rows == 1 and 0 < levels < k and levels % word == 0, k
        more = levels + word
        assert more >= k or SMEM[name](k, 1, more) > ROOM, k


@pytest.mark.parametrize("nxl", [128, 1024])
def test_rebin_plans_every_k(nxl):
    """The rebins took every K and MK up to 255 already; they still do."""
    for k in range(1, 256):
        for mk in (0, 1, 8, k):
            rows, lanes, threads, smem = rb.rebin_launch(k, mk, NY2, nxl, 2)
            assert threads == (rows + 2) * lanes and smem <= ROOM


def test_plans_below_the_chunks_are_unchanged():
    """Where every level fits, the plan stages them all at once, in the
    tile that lets the most blocks of the step's pair pass reside on an SM
    (three at its registers), two rows at a tie: the bench's K 14 in two
    rows, the all-pairs K 29 in one row (three blocks, where two rows leave
    room for two), K 40 and 98 in one row, with the whole-level shared
    memory."""
    assert sk.pair_pass_launch(14, NY2, 1024) == (2, 512, 50652, 14)
    assert sk.pair_pass_launch(29, 136, 256)[:2] == (1, 512)
    assert 3 * (sk.pair_pass_smem_bytes(29, 1) + tiles.SMEM_BLOCK_RESERVED) \
        <= tiles.SMEM_SM < 3 * (sk.pair_pass_smem_bytes(29, 2)
                                 + tiles.SMEM_BLOCK_RESERVED)
    assert sk.pair_pass_launch(40, NY2, 1024)[:2] == (1, 512)
    rows, _, smem, levels = sk.pair_pass_launch(98, NY2, 1024)
    assert (rows, levels) == (1, 98) and smem == sk.pair_pass_smem_bytes(98, 1)
    assert pw.pairwise_launch(97, NY2, 1024)[3] == 97
    assert pw.pairwise_launch(14, NY2, 1024)[:3] == (
        2, 512, pw.pairwise_smem_bytes(14, 2))


def test_chunked_shared_memory_sums():
    """csrc/step_kernel.cu chunked_smem_bytes and csrc/pairwise.cu
    tile_smem_bytes where the levels come in chunks, written out: the
    step's per-slot arrays (act', new pos/vel, list) stay whole, the staged
    pos/vel hold `levels` levels of the tile and its halo and share their
    room with the segment pass; 2D stages the tile's rows at one dy."""
    k, levels, h, n = 255, 28, 3, 255 * 32
    base = 8 * h * k + 20 * n + 4 * h + 8 + 2 * n
    assert sk.pair_pass_smem_bytes(k, 1, False, levels) == base + 16 * h * levels * 34
    seg = 4 * sk.SEG_COLS * sk.SEG_CAP + 8 * sk.SEG_TERM_CAP + 16 * 32 + 16
    assert sk.pair_pass_smem_bytes(k, 1, True, 7) == base + max(16 * h * 7 * 34, seg)
    assert pw.pairwise_smem_bytes(k, 1, 210) == (8 * h * k + 20 * 210 * 34 + 10 * n
                                                 + 4 * h + 8 + 512)
    assert sk.pair_pass_launch(255, NY2, 1024)[2:] == (
        sk.pair_pass_smem_bytes(255, 1, False, 28), 28)
