"""Launch shapes that the kernels' choosers share.

The H100's shared memory, and the tile of the two pair passes over cells
in shared memory: the fused step's (``step_kernel.pair_pass_launch``) and
the standalone pairwise kernel's (``pairwise.pairwise_launch``).  The
rebins size their own tiles (``rebin.rebin_launch``) against the same
shared memory.
"""

from __future__ import annotations

SMEM_SM = 233472  # bytes of shared memory on one SM (H100: 228 KB)
SMEM_BLOCK_RESERVED = 1024  # of which the system keeps this much per block
TILE_LANES = 32  # cells of a pair-pass tile row: one warp
PAIR_TILE_ROWS = (2, 1)  # tile rows of the pair passes, tallest first
PAIR_THREADS = 512  # threads a block of the pair passes


def tile_launch(smem_of, ny2: int, what: str) -> tuple[int, int, int]:
    """(tile rows, PAIR_THREADS, shared-memory bytes) of a pair pass over
    tiles of TILE_LANES cells a row whose block needs ``smem_of(tile_rows)``
    bytes, on a grid of ny2 rows (ghost rows included): the tallest tile of
    PAIR_TILE_ROWS (and no taller than the grid's centre rows) that leaves
    room for two blocks on an SM, else the tallest that fits one; raises
    where not even one row fits."""
    rows = [t for t in PAIR_TILE_ROWS if t <= ny2 - 2] or [1]
    for blocks in (2, 1):
        for t in rows:
            need = smem_of(t)
            if blocks * (need + SMEM_BLOCK_RESERVED) <= SMEM_SM:
                return t, PAIR_THREADS, need
    raise ValueError(f"{what} needs {smem_of(1)} bytes of shared memory for "
                     f"one tile row, an SM has "
                     f"{SMEM_SM - SMEM_BLOCK_RESERVED} for a block")
