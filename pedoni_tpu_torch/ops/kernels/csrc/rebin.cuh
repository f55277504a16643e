// What the two rebin kernels (rebin.cu, rebin_incremental.cu) share: the
// tile a block owns, the landing test, the candidate bit masks, the ghost
// rows, the device gate and the per-block sums.
//
// A block owns a tile of tile_rows x tile_lanes output cells (lanes in whole
// warps, rows inside one block of rb rows) and looks at the candidates of
// the tile and a one-cell halo around it.  Every candidate a tile sees is
// classified once there, by one thread: the landing test gives the cell it
// lands in, and the thread sets the candidate's bit in that cell's mask in
// shared memory (a candidate of a halo row is seen by two tiles).  A
// cell's mask holds its landers in the reference's compaction order
// (slot j outer, then dy, then dx): slot j's nine neighbour offsets are 9
// bits, three slots share a 32-bit word, so popping the set bits of the
// words in ascending order walks the landers exactly as the reference's
// serial walk meets them.  The bits are set with atomicOr, whose result does
// not depend on the order of the threads.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pedoni_rebin {

constexpr int kMaxThreads = 256;  // a block has (tile rows + 2) x tile lanes
constexpr int kSlotsPerWord = 3;  // 3 slots x 9 offsets = 27 bits of a word
constexpr int kBitsPerWord = 9 * kSlotsPerWord;

struct Grid {
  int ny2, k, nxl, rb, nx_cells, ny_cells;
  float unit;
};

// The tile of this block: first grid row and lane, rows, lanes, cells.
struct Tile {
  int row0, l0, rows, lanes, cells;
};

struct Sums {
  float over, n_out, n_in;
  int peak, go;
};

__host__ __device__ constexpr int mask_words(int slots) {
  return (slots + kSlotsPerWord - 1) / kSlotsPerWord;
}

// Shared memory of a block (rebin.py::rebin_smem_bytes, the same sum):
// the lander masks of k (full) or mk (incremental) candidate slots, a count
// or cursor word per cell, the source code of every output slot, and for
// the incremental rebin the stay mask.
__host__ __device__ constexpr int64_t smem_bytes(int k, int mk, int cells) {
  return (int64_t)cells * (4 * mask_words(mk > 0 ? mk : k) + 4 + 2 * k +
                           (mk > 0 ? 4 * ((k + 31) / 32) : 0));
}

// Thread 0 reads the gate, once a block, and clears the block's sums.  The
// answer is in s->go after the block's next __syncthreads; until then the
// block may only touch its own shared memory.
__device__ __forceinline__ void read_gate(const int* gate, int want, Sums* s) {
  if (threadIdx.x == 0) {
    s->over = s->n_out = s->n_in = 0.0f;
    s->peak = 0;
    s->go = (gate == nullptr || *gate == want) ? 1 : 0;
  }
}

__device__ __forceinline__ Tile block_tile(int tile_rows, int tile_lanes) {
  return Tile{1 + (int)blockIdx.y * tile_rows, (int)blockIdx.x * tile_lanes,
              tile_rows, tile_lanes, tile_rows * tile_lanes};
}

// What a thread of the block's (rows + 2) x lanes threads works on.  While
// candidates are classified: lane l of candidate row h (0 and rows + 1 are
// the halo) over all its slots.  While the tile's own slots are read or
// written: lane l of cell row r, sharing the row's slots with the `parts`
// warps that have the same (r, l): slots part, part + parts, ...  No loop
// over slots ever divides.
struct Column {
  int h, l, r, part, parts;
};

__device__ __forceinline__ Column thread_column(const Tile& t) {
  const int chunks = t.lanes >> 5, warp = threadIdx.x >> 5;
  const int h = warp / chunks;
  const int l = (warp - h * chunks) * 32 + (threadIdx.x & 31);
  // rows + 2 warps a lane chunk over `rows` cell rows: rows 2 -> 2 parts a
  // row; rows 1 -> 3 parts
  const int parts = (t.rows + 2) / t.rows;
  return Column{h, l, h / parts, h - (h / parts) * parts, parts};
}

// The blocks of the first and the last tile row also zero ghost row 0 and
// ghost row ny2-1 over their lanes.
__device__ __forceinline__ void zero_ghost_rows(float* __restrict__ out,
                                                const Grid& gd,
                                                const Tile& t) {
  const int n = gd.k * 8 * t.lanes;
  for (int side = 0; side < 2; ++side) {
    if (blockIdx.y != (side == 0 ? 0u : gridDim.y - 1)) continue;
    float* row = out + (int64_t)(side == 0 ? 0 : gd.ny2 - 1) * gd.k * 8 * gd.nxl +
                 t.l0;
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      row[(int64_t)(i / t.lanes) * gd.nxl + (i % t.lanes)] = 0.0f;
  }
}

// The landing test, once per candidate.  A candidate at grid row `row`
// (cell row row-1) and lane `lane` with position (x, y) lands in the cell
// (ty, tx) away from its own, or nowhere the 3x3 walk of an output cell
// would see it: off the field, or further than one cell.  The divide is the
// IEEE one (the reference's), never a multiply by the inverse.  floorf gives
// integers, so the differences are exact wherever they are small; huge,
// infinite and NaN positions fail the range test.
__device__ __forceinline__ bool landing(float x, float y, int row, int lane,
                                        const Grid& gd, int* ty, int* tx) {
  const float tgt_lane = floorf(__fdiv_rn(x, gd.unit)) + 1.0f;
  const float tgt_row = floorf(__fdiv_rn(y, gd.unit));
  const float fy = tgt_row - (float)(row - 1);
  const float fx = tgt_lane - (float)lane;
  if (!(fy >= -1.0f && fy <= 1.0f && fx >= -1.0f && fx <= 1.0f &&
        tgt_row <= (float)(gd.ny_cells - 1) && tgt_lane >= 1.0f &&
        tgt_lane <= (float)gd.nx_cells))
    return false;
  *ty = (int)fy;
  *tx = (int)fx;
  return true;
}

// Classify the candidate of slot j at halo coordinates (h, hl) — h in
// 0..rows+1, hl in 0..lanes+1, the tile inside 1..rows x 1..lanes — and set
// its bit in the mask [words][cells] of the tile cell it lands in.  Seen
// from that cell the candidate sits at (dy, dx) = (-ty, -tx).
__device__ __forceinline__ void mark_lander(uint32_t* mask, const Tile& t,
                                            const Grid& gd, float x, float y,
                                            int h, int hl, int j) {
  int ty, tx;
  if (!landing(x, y, t.row0 - 1 + h, t.l0 - 1 + hl, gd, &ty, &tx)) return;
  const int th = h + ty, thl = hl + tx;
  if (th < 1 || th > t.rows || thl < 1 || thl > t.lanes) return;
  const int cell = (th - 1) * t.lanes + (thl - 1);
  const int bit = (j % kSlotsPerWord) * 9 + (1 - ty) * 3 + (1 - tx);
  atomicOr(mask + (j / kSlotsPerWord) * t.cells + cell, 1u << bit);
}

// The candidates in the halo's two lanes, l0 - 1 and l0 + lanes, of a table
// of `slots` slots a cell: item i is (row h, slot j, side).  Lanes -1 and
// NXL do not exist (no wrap).
struct HaloItem {
  const float* c;  // the candidate's ch 0, or null
  int h, hl, j;
};

__device__ __forceinline__ HaloItem halo_item(const float* table, int i,
                                              int slots, const Tile& t,
                                              int nxl) {
  const int side = i & 1, line = i >> 1;
  const int h = line / slots, j = line - h * slots;
  const int lane = side ? t.l0 + t.lanes : t.l0 - 1;
  const float* c = nullptr;
  if (h < t.rows + 2 && lane >= 0 && lane < nxl)
    c = table + ((int64_t)(t.row0 - 1 + h) * slots + j) * 8 * nxl + lane;
  return HaloItem{c, h, side ? t.lanes + 1 : 0, j};
}

// A lander's code is its bit's index over the whole mask, word * 27 + bit
// = j * 9 + (dy + 1) * 3 + (dx + 1): the address of its source relative to
// the output cell at grid row `row`, lane `lane`, in a table of `slots`
// slots a cell.
__device__ __forceinline__ const float* lander_source(const float* table,
                                                      int code, int row,
                                                      int lane, int slots,
                                                      int nxl) {
  const int j = code / 9, d = code - 9 * j;
  const int dy = d / 3 - 1, dx = d - 3 * (d / 3) - 1;
  return table + ((int64_t)(row + dy) * slots + j) * 8 * nxl + lane + dx;
}

// Add this thread's share to the block's sums: warp shuffles, then one
// shared-memory atomic a warp.  Every thread of the block calls it.  All
// sums are integer-valued floats, exact in any order.
__device__ __forceinline__ void block_add(Sums* s, float over, float n_out,
                                          float n_in, int peak) {
  const unsigned full = 0xffffffffu;
  for (int off = 16; off > 0; off >>= 1) {
    over += __shfl_down_sync(full, over, off);
    n_out += __shfl_down_sync(full, n_out, off);
    n_in += __shfl_down_sync(full, n_in, off);
    const int p2 = __shfl_down_sync(full, peak, off);
    peak = p2 > peak ? p2 : peak;
  }
  if ((threadIdx.x & 31) == 0) {
    if (over != 0.0f) atomicAdd(&s->over, over);
    if (n_out != 0.0f) atomicAdd(&s->n_out, n_out);
    if (n_in != 0.0f) atomicAdd(&s->n_in, n_in);
    if (peak > 0) atomicMax(&s->peak, peak);
  }
}

// After a __syncthreads behind block_add: one thread adds the block's sums
// to the outputs of its block of rb rows (a tile never straddles two).  The
// peak is an integer atomicMax on the float's bits: non-negative floats
// order as their bit patterns do.
__device__ __forceinline__ void block_emit(const Sums* s, const Grid& gd,
                                           const Tile& t, float* ovf,
                                           float* dmx, float* nin,
                                           float* nout) {
  if (threadIdx.x != 0) return;
  const int b = (t.row0 - 1) / gd.rb;
  if (s->over != 0.0f) atomicAdd(ovf + b, s->over);
  if (s->n_out != 0.0f) atomicAdd(nout + b, s->n_out);
  if (s->n_in != 0.0f) atomicAdd(nin + b, s->n_in);
  if (s->peak > 0) atomicMax((int*)(dmx + b), __float_as_int((float)s->peak));
}

// Whether a launch shape is one rebin.py::rebin_launch can return.
inline bool launch_ok(const Grid& gd, int mk, int tile_rows, int tile_lanes,
                      int threads, int smem) {
  return gd.k >= 1 && gd.k <= 255 && mk >= 0 && mk <= 255 && gd.ny2 >= 3 &&
         gd.rb >= 1 && (tile_rows == 1 || tile_rows == 2) &&
         gd.rb % tile_rows == 0 && (gd.ny2 - 2) % gd.rb == 0 &&
         (tile_lanes == 32 || tile_lanes == 64) &&
         gd.nxl % tile_lanes == 0 && threads == (tile_rows + 2) * tile_lanes &&
         (int64_t)smem == smem_bytes(gd.k, mk, tile_rows * tile_lanes);
}

}  // namespace pedoni_rebin
