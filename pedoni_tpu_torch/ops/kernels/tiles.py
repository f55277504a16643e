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


def tile_launch(smem_of, ny2: int, k: int, level_step: int, what: str,
                blocks: int = 2) -> tuple[int, int, int, int]:
    """(tile rows, PAIR_THREADS, shared-memory bytes, staged levels) of a
    pair pass over tiles of TILE_LANES cells a row at K = ``k`` slot
    levels, on a grid of ny2 rows (ghost rows included).  Its block needs
    ``smem_of(tile_rows, levels)`` bytes where it stages ``levels`` slot
    levels of the tile and its halo at once: all of them (levels == k), or
    fewer, in chunks.

    Where all K levels fit: the tallest tile of PAIR_TILE_ROWS (and no
    taller than the grid's centre rows) that leaves room for ``blocks``
    blocks on an SM (the most that the kernel's registers let reside),
    else for one fewer, and so on down to one.  Else one-row tiles that stage
    the levels in chunks: the most levels, a multiple of ``level_step``
    below K, that fit one block.  Raises where not even ``level_step``
    levels fit."""
    rows = [t for t in PAIR_TILE_ROWS if t <= ny2 - 2] or [1]
    room = SMEM_SM - SMEM_BLOCK_RESERVED
    for b in range(blocks, 0, -1):
        for t in rows:
            need = smem_of(t, k)
            if b * (need + SMEM_BLOCK_RESERVED) <= SMEM_SM:
                return t, PAIR_THREADS, need, k
    for levels in range((k - 1) // level_step * level_step, 0, -level_step):
        need = smem_of(1, levels)
        if need <= room:
            return 1, PAIR_THREADS, need, levels
    raise ValueError(f"{what} needs {smem_of(1, min(level_step, k))} bytes of "
                     f"shared memory for one tile row, an SM has {room} for "
                     f"a block")
