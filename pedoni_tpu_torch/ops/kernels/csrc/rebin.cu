// Full compacting rebin: re-bin the post-step grid into fresh cell bins.
//
// Replaces pedoni_tpu/ops/pallas/rebin.py::rebin_kernel (pallas_call at
// rebin.py:570; bodies _kernel :60 and _compute :136) with emit_counts on.
// Plain PyTorch twin: pedoni_tpu_torch/ops/kernels/rebin.py::rebin_torch,
// and the bit-exact NumPy referee tests/test_rebin.py::_numpy_rebin.
//
// g   [ny2, K, 8, NXL] f32: the step kernel's output (ghost rows empty;
//                          ch 7 holds the sampled potential, not a count).
// out [ny2, K, 8, NXL] f32: fresh compacted bins, ghost rows zero,
//                          ch 6 = slot < count, ch 7 = min(count, K).
// ovf, dmx, nin, nout [nb] f32, per block of rb cell rows: overflow
//   sum(max(count - K, 0)), peak un-clamped count, input active sum over
//   owned lanes, output active sum.  All integer-valued, so the float
//   atomics are exact in any order (totals stay below 2^24).
// gate: optional device int; when given, the body runs only where
//   *gate == want, so the step's full-or-incremental choice is read on the
//   device (rebin_incremental.cu takes the same gate and the other value).
//
// What bounds it on the card: device-memory traffic, and of that the
// output: every one of the K x 8 floats of a cell is written, most of them
// zeros, against one active plane and six floats an agent read.  What held
// the first design (one thread per output cell, walking its 9 x K
// candidates in series with a global load, two divides and a store whose
// slot hung on a running count) at a quarter of that bound was latency: a
// thread had one or two memory operations in flight.
//
// The design (rebin.cuh has the shared parts):
//   1. classify: one thread per candidate cell (row, lane) of the tile and
//      its halo takes that cell's K slots, kClassify at a time: it asks for
//      their active flags, x and y at once, so that the loads overlap, and
//      no loop divides; the landing test runs once an agent and sets one
//      bit of the landing cell's mask;
//   2. compact: one thread per cell pops the set bits of its mask in
//      ascending order — the reference's (j, dy, dx) order — and writes the
//      n-th lander's code into the cell's n-th source entry, in shared
//      memory only; the count is the number of bits, un-clamped;
//   3. write: the same threads, two to a cell (three where tiles are one
//      row tall), a warp on 32 neighbouring lanes of one (row, slot) line;
//      each takes every second slot of its cell, kWrite at a time: it reads
//      their source entries, gathers each agent's six floats from g and
//      stores eight channels a slot.  No store waits on a count, and every
//      thread has kWrite x 8 stores in flight.
// Deterministic, no atomics on the bins, bit-equal to the twin.  The walk
// cannot be bounded by counts: ch 7 of g is the potential, so step 1 looks
// at every slot j < K and skips inactive ones.  Times: PERF.md.

#include "rebin.cuh"

namespace {

using namespace pedoni_rebin;

constexpr int kClassify = 7;  // candidate slots a thread has in flight at once
constexpr int kWrite = 4;     // output slots a thread has in flight at once

__global__ void __launch_bounds__(kMaxThreads, 4)
rebin_full(const float* __restrict__ g, float* __restrict__ out,
           float* __restrict__ ovf, float* __restrict__ dmx,
           float* __restrict__ nin, float* __restrict__ nout,
           const int* __restrict__ gate, int want, Grid gd, int tile_rows,
           int tile_lanes) {
  extern __shared__ uint32_t smem[];
  __shared__ Sums sums;
  read_gate(gate, want, &sums);
  const Tile t = block_tile(tile_rows, tile_lanes);
  const int k = gd.k, nxl = gd.nxl;
  const int words = mask_words(k);
  uint32_t* mask = smem;                                // [words][cells]
  int* cnt = (int*)(mask + words * t.cells);            // [cells]
  uint16_t* src = (uint16_t*)(cnt + t.cells);           // [k][cells]
  const int tid = threadIdx.x, threads = blockDim.x;
  const int64_t sk = (int64_t)8 * nxl;  // slot stride
  const Column col = thread_column(t);

  for (int i = tid; i < words * t.cells; i += threads) mask[i] = 0u;
  __syncthreads();
  if (!sums.go) return;  // gated off: the same for the whole block
  zero_ghost_rows(out, gd, t);

  // 1. classify: this thread's warp owns 32 lanes of one candidate row of the
  // tile and its halo, and walks that row's K slots, kClassify at a time: the
  // flag, x and y of all of them are asked for at once (x and y also where
  // the flag turns out clear: one trip to memory, not two in a row)
  float n_in = 0.0f;
  const int n_halo = (t.rows + 2) * k * 2;
  // the halo's two lanes: this thread's first candidate there is asked for
  // now and classified after the walk below
  const HaloItem first = halo_item(g, tid, k, t, nxl);
  float h6 = 0.0f, hx = 0.0f, hy = 0.0f;
  if (first.c != nullptr) {
    h6 = first.c[6 * nxl];
    hx = first.c[0];
    hy = first.c[nxl];
  }
  {
    const int lane = t.l0 + col.l;
    const float* c = g + (int64_t)(t.row0 - 1 + col.h) * k * sk + lane;
    const bool counted = col.h >= 1 && col.h <= t.rows && lane >= 1 &&
                         lane <= gd.lane_hi;
    for (int j0 = 0; j0 < k; j0 += kClassify) {
      float a6[kClassify], x[kClassify], y[kClassify];
#pragma unroll
      for (int q = 0; q < kClassify; ++q) {
        a6[q] = x[q] = y[q] = 0.0f;
        if (j0 + q < k) {
          const float* cj = c + (j0 + q) * sk;
          a6[q] = cj[6 * nxl];
          x[q] = cj[0];
          y[q] = cj[nxl];
        }
      }
#pragma unroll
      for (int q = 0; q < kClassify; ++q) {
        if (counted) n_in += a6[q];
        if (a6[q] > 0.5f)
          mark_lander(mask, t, gd, x[q], y[q], col.h, col.l + 1, j0 + q);
      }
    }
  }
  if (h6 > 0.5f) mark_lander(mask, t, gd, hx, hy, first.h, first.hl, first.j);
  for (int i = tid + threads; i < n_halo; i += threads) {  // a tall K only
    const HaloItem it = halo_item(g, i, k, t, nxl);
    if (it.c != nullptr && it.c[6 * nxl] > 0.5f)
      mark_lander(mask, t, gd, it.c[0], it.c[nxl], it.h, it.hl, it.j);
  }
  __syncthreads();

  // 2. compact: the n-th set bit is the n-th lander
  float over = 0.0f, kept = 0.0f;
  int peak = 0;
  for (int cell = tid; cell < t.cells; cell += threads) {
    int n = 0;
    for (int w = 0; w < words; ++w) {
      uint32_t bits = mask[w * t.cells + cell];
      while (bits) {
        const int b = __ffs(bits) - 1;
        bits &= bits - 1;
        if (n < k) src[n * t.cells + cell] = (uint16_t)(w * kBitsPerWord + b);
        ++n;
      }
    }
    cnt[cell] = n;
    over += (float)(n > k ? n - k : 0);
    kept += (float)(n < k ? n : k);
    peak = n > peak ? n : peak;
  }
  block_add(&sums, over, kept, n_in, peak);
  __syncthreads();
  block_emit(&sums, gd, t, ovf, dmx, nin, nout);

  // 3. write: the warps of a cell row share its K slots, each thread a lane;
  // kWrite slots at a time, all their gathers asked for before the first
  // store
  {
    const int cell = col.r * t.lanes + col.l;
    const int row = t.row0 + col.r, lane = t.l0 + col.l;
    const int n = cnt[cell];
    const float kept_f = (float)(n < k ? n : k);
    float* o = out + (int64_t)row * k * sk + lane;
    for (int s0 = col.part; s0 < k; s0 += kWrite * col.parts) {
      float v[kWrite][6];
#pragma unroll
      for (int q = 0; q < kWrite; ++q) {
        const int s = s0 + q * col.parts;
#pragma unroll
        for (int ch = 0; ch < 6; ++ch) v[q][ch] = 0.0f;
        if (s < k && s < n) {
          const float* c = lander_source(g, src[s * t.cells + cell], row, lane, k, nxl);
#pragma unroll
          for (int ch = 0; ch < 6; ++ch) v[q][ch] = c[ch * nxl];
        }
      }
#pragma unroll
      for (int q = 0; q < kWrite; ++q) {
        const int s = s0 + q * col.parts;
        if (s >= k) break;
        float* os = o + s * sk;
#pragma unroll
        for (int ch = 0; ch < 6; ++ch) os[ch * nxl] = v[q][ch];
        os[6 * nxl] = s < n ? 1.0f : 0.0f;
        os[7 * nxl] = kept_f;
      }
    }
  }
}

}  // namespace

// ovf/dmx/nin/nout must be zeroed by the caller.  gate may be null.  roff,
// coff and lane_hi place a tile of a larger grid (rebin.cuh; 0, 0, nx_cells
// for a whole grid).
// tile_rows, tile_lanes, threads and smem_bytes are the launch shape
// (rebin.py::rebin_launch); returns a cudaError_t, -1 for a launch shape
// that function cannot return, or PEDONI_WRONG_DEVICE (device.cuh).
extern "C" int pedoni_rebin_full(const float* g, float* out, float* ovf,
                                 float* dmx, float* nin, float* nout,
                                 const int* gate, int want, int ny2, int k,
                                 int nxl, int rb, float unit, int nx_cells,
                                 int ny_cells, int roff, int coff,
                                 int lane_hi, int tile_rows, int tile_lanes,
                                 int threads, int smem_bytes, void* stream) {
  if (const int w = pedoni_on_current_device(g)) return w;
  const pedoni_rebin::Grid gd{ny2,      k,    nxl,  rb,   nx_cells,
                              ny_cells, unit, roff, coff, lane_hi};
  if (!pedoni_rebin::launch_ok(gd, 0, tile_rows, tile_lanes, threads, smem_bytes)) return -1;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rebin_full, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((unsigned)(nxl / tile_lanes), (unsigned)((ny2 - 2) / tile_rows));
  rebin_full<<<grid, threads, smem_bytes, (cudaStream_t)stream>>>(
      g, out, ovf, dmx, nin, nout, gate, want, gd, tile_rows, tile_lanes);
  return (int)cudaGetLastError();
}
