// Spawn scatter: the grid step's spawn candidates written into free slots
// of the cell-resident grid D, in place, in one launch.
//
// Replaces no pallas_call: the reference computes this as XLA-fused code
// (pedoni_tpu/models/sfm_grid.py:140, spawn_scatter).  Plain PyTorch twin:
// pedoni_tpu_torch/ops/kernels/spawn_scatter.py::spawn_scatter_torch.
// Callers: the grid step (models/sfm_grid.py::make_step_grid), each tile of
// the tiled step (parallel/tile2d.py) with its window, and
// Simulator.measure_spawn_time, through ops/kernels/spawn_scatter.py.
//
// Layouts:
//   pos [S, 2] f32, speed [S] f32, dest [S] i32, active [S] u8
//                          the candidates, contiguous, in stream order
//   d [n_rows+2, K, 8, NXL] f32   cell rows [row_lo, row_lo + n_rows) and
//                          columns [col_lo, col_lo + n_cols) with a one-cell
//                          ghost ring (lane l = column col_lo + l - 1);
//                          ch 7 of slot 0 holds each cell's count
//   counts [2] i32         n_spawned, n_dropped (written here, no memset)
//
// The twin's contract, bit for bit: a candidate's cell is floor(x / unit),
// floor(y / unit) with the IEEE divide; it is written iff it is active, in
// the grid and its cell lies in the window or its ghost ring ("writable"),
// and counted iff the window owns its cell ("owned").  Its slot is the
// cell's count (ch 7, slot 0, truncated to an integer) + its rank among
// the writable candidates of its cell in stream order; it is written only
// where slot < K: channels 0-6 = pos.x, pos.y, +0, +0, speed, (float)dest,
// 1.  The cell's count then grows by its writes.  n_spawned = the owned
// candidates, n_dropped = those less the owned ones written.  The twin's
// sort and its scatter of unchanged values into a dump slot have no
// counterpart here: they change no bit.
//
// Design: S is small (68 for scenarios/random.toml, 0 for a field without
// spawners), so one block of kThreads takes every candidate, a thread
// each, in chunks of kThreads where S is larger.  The block stages the
// cell keys of kThreads candidates at a time in shared memory; each thread
// counts the equal keys before its own (its rank) and in all (its cell's
// writable candidates): no sort, no atomics, deterministic.  Each thread
// reads its cell's count once, writes its row, and after a barrier the
// last writer of each cell (the highest rank with slot < K) writes the new
// count, so no count is written before every thread of its chunk has read
// it.  A later chunk may read a count that an earlier chunk's last writer
// raised; its candidates of that cell rank after that writer, so they are
// not written with either count.  Both sums are reduced in the block.
//
// What bounds it on the card (NVIDIA H100 80GB HBM3): neither bytes (~40
// a candidate) nor operations; one launch on a queue of a few
// microseconds.  The twin is ~125 launches of PyTorch's elementwise, sort,
// gather and scatter kernels.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "device.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Window {
  int row_lo, n_rows, col_lo, n_cols;
};

struct Candidate {
  int key;  // (ly + 1) * (n_cols + 2) + (lx + 1) where writable, else -1
  int ly, lx;
  bool owned;
};

__device__ Candidate classify(int i, const float* pos, const unsigned char* active,
                              float unit, int nx, int ny, Window w) {
  Candidate c{-1, 0, 0, false};
  const float gx = floorf(pos[2 * (int64_t)i] / unit);
  const float cy = floorf(pos[2 * (int64_t)i + 1] / unit);
  const bool ing = active[i] != 0 && gx >= 0.0f && gx < (float)nx && cy >= 0.0f &&
                   cy < (float)ny;
  c.owned = ing && cy >= (float)w.row_lo && cy < (float)(w.row_lo + w.n_rows) &&
            gx >= (float)w.col_lo && gx < (float)(w.col_lo + w.n_cols);
  const bool writable = ing && cy >= (float)(w.row_lo - 1) &&
                        cy < (float)(w.row_lo + w.n_rows + 1) &&
                        gx >= (float)(w.col_lo - 1) &&
                        gx < (float)(w.col_lo + w.n_cols + 1);
  if (writable) {
    c.ly = (int)cy - w.row_lo;  // -1 .. n_rows
    c.lx = (int)gx - w.col_lo;  // -1 .. n_cols
    c.key = (c.ly + 1) * (w.n_cols + 2) + (c.lx + 1);
  }
  return c;
}

__device__ int block_sum(int v, int* sh) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // sh may still be read by a previous sum
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  int total = 0;
  for (int q = 0; q < kWarps; ++q) total += sh[q];
  return total;
}

__global__ void __launch_bounds__(kThreads)
spawn_scatter_kernel(const float* __restrict__ pos, const float* __restrict__ speed,
                     const int* __restrict__ dest,
                     const unsigned char* __restrict__ active, float* d,
                     int* __restrict__ counts, int s, float unit, int nx, int ny,
                     int k, int nxl, Window w) {
  __shared__ int sh_key[kThreads];
  __shared__ int sh_sum[kWarps];
  const int64_t ch = nxl, slot_stride = 8 * ch, row_stride = (int64_t)k * slot_stride;
  int n_owned = 0, n_owned_written = 0;
  for (int base = 0; base < s; base += kThreads) {
    const int i = base + threadIdx.x;
    Candidate c{-1, 0, 0, false};
    if (i < s) c = classify(i, pos, active, unit, nx, ny, w);
    int rank = 0, total = 0;
    for (int kb = 0; kb < s; kb += kThreads) {
      const int j = kb + threadIdx.x;
      __syncthreads();  // the last stage's keys are read
      sh_key[threadIdx.x] =
          kb == base ? c.key : (j < s ? classify(j, pos, active, unit, nx, ny, w).key : -1);
      __syncthreads();
      if (c.key >= 0) {
        const int n = min(kThreads, s - kb);
        for (int t = 0; t < n; ++t) {
          const bool eq = sh_key[t] == c.key;
          total += eq;
          rank += eq && kb + t < i;
        }
      }
    }
    bool ok = false, last = false;
    float count = 0.0f;
    int64_t at = 0;
    if (c.key >= 0) {
      at = (c.ly + 1) * row_stride + (c.lx + 1);  // slot 0, ch 0 of the cell
      count = d[at + 7 * ch];
      const long long slot = (long long)count + rank;
      ok = slot < k;
      if (ok) {
        last = rank == total - 1 || slot == k - 1;
        float* row = d + at + (slot < 0 ? 0 : slot) * slot_stride;
        row[0] = pos[2 * (int64_t)i];
        row[ch] = pos[2 * (int64_t)i + 1];
        row[2 * ch] = 0.0f;
        row[3 * ch] = 0.0f;
        row[4 * ch] = speed[i];
        row[5 * ch] = (float)dest[i];
        row[6 * ch] = 1.0f;
      }
    }
    n_owned += c.owned;
    n_owned_written += c.owned && ok;
    __syncthreads();  // every count of this chunk is read before one is written
    if (last) d[at + 7 * ch] = count + (float)(rank + 1);
  }
  n_owned = block_sum(n_owned, sh_sum);
  n_owned_written = block_sum(n_owned_written, sh_sum);
  if (threadIdx.x == 0) {
    counts[0] = n_owned;
    counts[1] = n_owned - n_owned_written;
  }
}

}  // namespace

// d [n_rows + 2, K, 8, nxl] with n_cols + 2 < nxl; the candidates' pointers
// may be null where s is 0.  Returns a cudaError_t, -1 for arguments it does
// not take, or PEDONI_WRONG_DEVICE (device.cuh) for a grid off the current
// device.
extern "C" int pedoni_spawn_scatter(const float* pos, const float* speed,
                                    const int* dest, const unsigned char* active,
                                    float* d, int* counts, int s, float unit,
                                    int nx, int ny, int k, int nxl, int row_lo,
                                    int n_rows, int col_lo, int n_cols,
                                    void* stream) {
  if (const int wd = pedoni_on_current_device(d)) return wd;
  if (s < 0 || s > INT_MAX - kThreads || nx < 1 || ny < 1 || k < 1 ||
      n_rows < 0 || n_cols < 0 || n_cols + 2 >= nxl ||
      (int64_t)(n_rows + 2) * (n_cols + 2) >= INT_MAX)
    return -1;
  const Window w{row_lo, n_rows, col_lo, n_cols};
  spawn_scatter_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      pos, speed, dest, active, d, counts, s, unit, nx, ny, k, nxl, w);
  return (int)cudaGetLastError();
}
