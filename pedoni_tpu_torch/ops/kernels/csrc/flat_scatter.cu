// Flat scatter: the flat step after its cell sort, up to the pair pass, in
// one launch: the sorted agent rows, their cell ids, the cell layout
// (slot, valid, overflow) and the padded cell grid.
//
// Replaces no pallas_call: the reference computes this as XLA-fused code
// (pedoni_tpu/models/sfm.py:373-386, the row gather after its argsort;
// pedoni_tpu/ops/forcepass.py:50 build_layout and :77 scatter_cell_data).
// Plain PyTorch twin: pedoni_tpu_torch/ops/kernels/flat_scatter.py::
// flat_scatter_torch.  Callers: the flat step (models/sfm.py::make_step)
// and each x-strip step (parallel/spatial.py), once a step, through
// ops/kernels/flat_scatter.py.
//
// Layouts:
//   packed [N, 12] f32     flat_sample's rows (contiguous, 16-byte
//                          aligned): 0:2 pos, 2:4 vel, 4 speed, 5 dest,
//                          6 alive, 7:9 goal direction e, 9:12 obstacle
//   cid [N] i32            each row's cell id, n_cells = nx * ny for none
//   order [C] i64          the first C entries of a stable argsort of cid,
//                          so that cid[order] is ascending
//   rows [C, 12] f32       packed[order]
//   cid_s [C] i32          cid[order]
//   dest [C] i32, active [C] u8   rows[:, 5] as int, rows[:, 6] > 0.5
//   speed [C] f32          rows[:, 4], contiguous: the next step's flat
//                          sample reads it without the rows' 48-byte stride
//   slot [C] i64, valid [C] u8    forcepass.build_layout with the strides
//                          (row, lane, rank) and size given
//   counts [2] i32         n_overflow, n_active (zeroed here first)
//   data [ny+2, nx+2, K, 8] f32   forcepass.scatter_cell_data: ch 0-5 pos,
//                          vel, e of the valid rows, ch 6 valid, ch 7 and
//                          every other slot +0 (default strides only)
//
// Modes: 0 the rows alone (all-pairs mode), 1 the rows and the layout
// (any strides, no grid: the pallas step's slot grid is laid out
// otherwise), 2 the rows, the layout and the grid.
//
// The launch has two kinds of block.
//   Row blocks, one thread a sorted row: the 16-byte loads of the packed
//   row and its stores; the rank within the cell (the twin's sorted index
//   less the cell's first index) found by walking back at most K sorted
//   ids, staged in shared memory with the K before the block's first row,
//   since a rank of K or more says only "overflow"; the slot; the counts
//   by warp ballots and one atomic a warp.
//   Cell blocks (mode 2), one block for each run of CH padded cells of the
//   grid: the sorted rows of the run's interior cells are a contiguous
//   range [lo, hi) of the sorted order, found by two warp-wide 33-ary
//   searches of cid[order[.]]; the block marks each cell's first and last
//   row in shared memory, then writes every slot of its cells, the valid
//   row's channels (gathered again through order) or +0.  So the grid is
//   written once, with no memset, and no block waits on another.
// Every value is a copy (a float's bits, an int's conversion as PyTorch's
// .to(torch.int32)), so kernel and twin agree bit for bit.
//
// What bounds it on the card (NVIDIA H100 80GB HBM3): the bytes, ~120 an
// agent for the rows and layout, the rows' 48 bytes again for the grid, and
// the grid written once (92 MB at the 1M problem).  The twin is two row
// gathers (PyTorch runs one block a row), a scatter_reduce, an index_select
// and a cat around one index_copy_.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "device.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 255;
constexpr int kSlotsPerCellBlock = 2048;  // CH * K, about
constexpr int kMaxCellsPerBlock = 512;

struct Layout {
  int64_t row, lane, rank, size;
};

__device__ __forceinline__ int sorted_cid(const int* cid, const int64_t* order,
                                          int64_t m) {
  return cid[order[m]];
}

// The first m in [0, c) with cid[order[m]] >= v (c when none), by the
// whole warp: each round probes 32 points of the range [a, b) and keeps
// the stretch between the last probe below v and the first at or above,
// so a 1M order takes four rounds of two dependent loads.
__device__ int lower_bound_warp(const int* cid, const int64_t* order, int c,
                                int v, int lane) {
  int a = 0, b = c;
  while (b > a) {
    const int span = b - a;
    const bool small = span <= 32;
    const int p = small ? a + lane
                        : a + (int)((int64_t)span * (lane + 1) / 33);
    const bool ge = (!small || lane < span) && sorted_cid(cid, order, p) >= v;
    const unsigned m = __ballot_sync(0xffffffffu, ge);
    if (small) return m ? a + __ffs(m) - 1 : b;
    if (m == 0) {
      a = a + (int)((int64_t)span * 32 / 33) + 1;
    } else {
      const int l = __ffs(m) - 1;
      const int a_new = l ? a + (int)((int64_t)span * l / 33) + 1 : a;
      b = a + (int)((int64_t)span * (l + 1) / 33);
      a = a_new;
    }
  }
  return a;
}

// The first interior cell id whose padded cell index is >= p.
__device__ __forceinline__ int first_cid_from(int64_t p, int nx, int ny) {
  const int64_t y = p / (nx + 2), x = p % (nx + 2);
  if (y == 0) return 0;
  if (y > ny) return nx * ny;
  if (x == 0) return (int)((y - 1) * nx);
  if (x > nx) return (int)(y * nx);
  return (int)((y - 1) * nx + x - 1);
}

__device__ void row_block(const float* __restrict__ packed,
                          const int* __restrict__ cid,
                          const int64_t* __restrict__ order, float* rows,
                          int* cid_s, int* dest, float* speed,
                          unsigned char* active, int64_t* slot, unsigned char* valid, int* counts,
                          int c, int nx, int n_cells, int k, int mode,
                          Layout L, int blk, int* sh) {
  const int t = threadIdx.x;
  const int i0 = blk * kThreads;
  const int i = i0 + t;
  // sh[j] = cid[order[i0 - k + j]], -1 before the first row
  int64_t o = 0;
  if (i < c) {
    o = order[i];
    sh[k + t] = cid[o];
  }
  if (t < k) {
    const int m = i0 - k + t;
    sh[t] = m >= 0 ? sorted_cid(cid, order, m) : -1;
  }
  __syncthreads();
  bool act = false, over = false;
  if (i < c) {
    const int ci = sh[k + t];
    const float4* src = reinterpret_cast<const float4*>(packed + o * 12);
    const float4 p0 = src[0], p1 = src[1], p2 = src[2];
    float4* dst = reinterpret_cast<float4*>(rows + (int64_t)i * 12);
    dst[0] = p0;
    dst[1] = p1;
    dst[2] = p2;
    cid_s[i] = ci;
    dest[i] = (int)p1.y;
    speed[i] = p1.x;
    act = p1.z > 0.5f;
    active[i] = act;
    if (mode > 0) {
      int r = 0;
      while (r < k && sh[k + t - 1 - r] == ci) ++r;
      const bool live = ci < n_cells && act;
      const bool ok = live && r < k;
      over = live && r >= k;
      const int64_t cc = ci < n_cells - 1 ? ci : n_cells - 1;
      slot[i] = ok ? cc / nx * (L.row - (int64_t)nx * L.lane) + cc * L.lane +
                         (int64_t)r * L.rank + (L.row + L.lane)
                   : L.size;
      valid[i] = ok;
    }
  }
  const unsigned n_act = __popc(__ballot_sync(0xffffffffu, act));
  const unsigned n_over = __popc(__ballot_sync(0xffffffffu, over));
  if ((t & 31) == 0) {
    if (n_over) atomicAdd(&counts[0], (int)n_over);
    if (n_act) atomicAdd(&counts[1], (int)n_act);
  }
}

__device__ void cell_block(const float* __restrict__ packed,
                           const int* __restrict__ cid,
                           const int64_t* __restrict__ order,
                           float* __restrict__ data, int c, int nx, int ny,
                           int k, int ch, int blk, int* first, int* last,
                           int* stage, int* bounds) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t n_padded = (int64_t)(ny + 2) * (nx + 2);
  const int64_t p0 = (int64_t)blk * ch;
  const int64_t p1 = p0 + ch < n_padded ? p0 + ch : n_padded;
  const int n_local = (int)(p1 - p0);
  const int c_lo = first_cid_from(p0, nx, ny);
  const int c_hi = first_cid_from(p1, nx, ny);
  if (warp < 2) {
    const int at = lower_bound_warp(cid, order, c, warp ? c_hi : c_lo, lane);
    if (lane == 0) bounds[warp] = at;
  }
  for (int j = t; j < n_local; j += kThreads) first[j] = last[j] = 0;
  __syncthreads();
  const int lo = bounds[0], hi = bounds[1];
  // each interior cell's rows are [first, last) of the sorted order
  for (int base = lo; base < hi; base += kThreads) {
    const int m = base + t;
    if (m < hi) stage[t + 1] = sorted_cid(cid, order, m);
    if (t == 0) stage[0] = base > lo ? sorted_cid(cid, order, base - 1) : -1;
    if (t == 0)
      stage[kThreads + 1] =
          base + kThreads < hi ? sorted_cid(cid, order, base + kThreads) : -1;
    __syncthreads();
    if (m < hi) {
      const int ci = stage[t + 1];
      const int64_t local =
          (int64_t)(ci / nx + 1) * (nx + 2) + ci % nx + 1 - p0;
      const int next = m + 1 < hi ? stage[t + 2] : -1;
      if (local >= 0 && local < n_local) {  // always, for a sorted order
        if (stage[t] != ci) first[local] = m;
        if (next != ci) last[local] = m + 1;
      }
    }
    __syncthreads();
  }
  // every slot of the run: the valid row's channels, else +0
  const int n_slots = n_local * k;
  float4* out = reinterpret_cast<float4*>(data + p0 * k * 8);
  for (int q = t; q < n_slots; q += kThreads) {
    const int cell = q / k, r = q - cell * k;
    const int m = first[cell] + r;
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float4 b = a;
    if (m < last[cell]) {
      const float* src = packed + order[m] * 12;
      const float4 s0 = reinterpret_cast<const float4*>(src)[0];
      const float4 s1 = reinterpret_cast<const float4*>(src)[1];
      if (s1.z > 0.5f) {
        a = s0;
        b = make_float4(s1.w, src[8], 1.0f, 0.0f);
      }
    }
    out[2 * (int64_t)q] = a;
    out[2 * (int64_t)q + 1] = b;
  }
}

__global__ void __launch_bounds__(kThreads)
flat_scatter_kernel(const float* __restrict__ packed, const int* __restrict__ cid,
                    const int64_t* __restrict__ order, float* rows, int* cid_s,
                    int* dest, float* speed, unsigned char* active, int64_t* slot,
                    unsigned char* valid, int* counts, float* data, int c,
                    int nx, int ny, int k, int mode, Layout L, int ch,
                    int cell_blocks) {
  __shared__ int sh_rows[kMaxK + kThreads];
  __shared__ int sh_first[kMaxCellsPerBlock], sh_last[kMaxCellsPerBlock];
  __shared__ int sh_stage[kThreads + 2];
  __shared__ int sh_bounds[2];
  const int b = blockIdx.x;
  if (b < cell_blocks)
    cell_block(packed, cid, order, data, c, nx, ny, k, ch, b, sh_first, sh_last,
               sh_stage, sh_bounds);
  else
    row_block(packed, cid, order, rows, cid_s, dest, speed, active, slot,
              valid, counts, c, nx, nx * ny, k, mode, L, b - cell_blocks,
              sh_rows);
}

// Padded cells a cell block writes at K: about kSlotsPerCellBlock slots.
int cells_per_block(int k) {
  const int ch = kSlotsPerCellBlock / k;
  return ch < 1 ? 1 : (ch > kMaxCellsPerBlock ? kMaxCellsPerBlock : ch);
}

}  // namespace

// layout: (row, lane, rank, size) of the slot index, in elements of the
// layout's grid; for mode 2 they must be the padded grid's ((nx + 2) * K,
// K, 1, (ny + 2) * (nx + 2) * K).  data may be null below mode 2; slot and
// valid below mode 1.  Returns a cudaError_t, -1 for arguments it does not
// take, or PEDONI_WRONG_DEVICE (device.cuh) for rows off the current device.
extern "C" int pedoni_flat_scatter(const float* packed, const int* cid,
                                   const int64_t* order, float* rows, int* cid_s,
                                   int* dest, float* speed,
                                   unsigned char* active, int64_t* slot, unsigned char* valid,
                                   int* counts, float* data, int64_t c, int nx,
                                   int ny, int k, int mode,
                                   const int64_t* layout, void* stream) {
  if (const int w = pedoni_on_current_device(counts)) return w;
  if (c < 0 || c >= INT_MAX - kThreads || nx < 1 || ny < 1 || k < 1 ||
      k > kMaxK || mode < 0 || mode > 2 ||
      (int64_t)(nx + 2) * (ny + 2) >= INT_MAX)
    return -1;
  Layout L;
  L.row = layout[0];
  L.lane = layout[1];
  L.rank = layout[2];
  L.size = layout[3];
  if (mode == 2 && (L.row != (int64_t)(nx + 2) * k || L.lane != k ||
                    L.rank != 1 || L.size != (int64_t)(ny + 2) * (nx + 2) * k))
    return -1;
  cudaError_t e = cudaMemsetAsync(counts, 0, 2 * sizeof(int), (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  const int ch = cells_per_block(k);
  const int64_t n_padded = (int64_t)(ny + 2) * (nx + 2);
  const int64_t cell_blocks = mode == 2 ? (n_padded + ch - 1) / ch : 0;
  const int64_t row_blocks = (c + kThreads - 1) / kThreads;
  const int64_t blocks = cell_blocks + row_blocks;
  if (blocks == 0) return 0;
  if (blocks >= INT_MAX) return -1;
  flat_scatter_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      packed, cid, order, rows, cid_s, dest, speed, active, slot, valid, counts,
      data, (int)c, nx, ny, k, mode, L, ch, (int)cell_blocks);
  return (int)cudaGetLastError();
}
