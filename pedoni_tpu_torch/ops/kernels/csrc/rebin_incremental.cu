// Incremental (hole-preserving) rebin: stayers keep their slots, movers
// from the 3x3 mover tables fill the holes.
//
// Replaces pedoni_tpu/ops/pallas/rebin.py::rebin_incremental (pallas_call
// at rebin.py:488; bodies _kernel_inc :239 and _compute_inc :323) with
// emit_counts on.  Plain PyTorch twin:
// pedoni_tpu_torch/ops/kernels/rebin.py::rebin_incremental_torch.
//
// g   [ny2, K, 8, NXL] f32: the step kernel's mover-mode output, ch 7 =
//                          stay mask (1 = active and still in this cell).
// m   [ny2, MK, 8, NXL] f32: its mover table, each cell's movers in rows
//                          0.., ch 6 = row holds a mover, ch 7 = mover count.
// out [ny2, K, 8, NXL] f32: ghost rows zero; ch 6 = stay or filled hole,
//                          ch 7 = topcnt (top occupied slot + 1) on every
//                          slot.  Bins may hold holes below topcnt.
// ovf, dmx, nin, nout [nb] f32 per block of rb cell rows: movers beyond the
//   free slots, peak (stayers + landers), input active sum over owned
//   lanes, output active sum.  Integer-valued: float atomics are exact in
//   any order.
// gate: optional device int; the body runs only where *gate == want (the
//   step passes the same gate to rebin.cu with the other value).
//
// What bounds it on the card: device-memory traffic, and of that the
// output (K x 8 floats a cell) beside g's two mask planes, the stayers' six
// floats and the few mover rows.  The first design (one thread per output
// cell: the stay mask read from device memory up to three times, a serial
// mover walk, each slot stored in turn) sat at under a third of that bound
// on latency alone.
//
// The design (rebin.cuh has the shared parts):
//   1. the block's threads, two to a cell of the tile (three where tiles
//      are one row tall), read ch 7 and ch 6 of the cell's K slots once,
//      kStay slots at a time: the stay bit goes into the cell's K-bit stay
//      mask in shared memory (stayers are gated to the owned lanes 1..nx),
//      ch 6 into the input active sum;
//   2. classify: one thread per cell (row, lane) of the tile and its halo
//      takes that cell's MK mover rows, kClassify at a time; a row counts
//      where its ch 6 is set, as in the reference (M's ch 7, the count, is
//      not read: a row past the count with ch 6 set lands too); the landing
//      test runs once a mover and sets one bit of the landing cell's mask;
//   3. place: one thread per cell pops the lander bits in ascending order —
//      the reference's (j, dy, dx) order (rebin.py:380-406) — and the hole
//      bits (the stay mask's complement) in slot order: the n-th lander
//      takes the hole of exclusive rank n while holes are left
//      (rebin.py:358-369).  Shared memory only.  topcnt, overflow and demand
//      fall out of the two masks' popcounts and the last hole filled;
//   4. write: the threads of step 1, each every second slot of its cell,
//      kWrite at a time: a stayer copies its six floats from g, a filled
//      hole gathers its mover's from m, the rest is zero; ch 6 and ch 7 =
//      topcnt.  A slot's eight channels leave in one go: copying the
//      stayers early, in step 1, left lines half written for a while and
//      cost a third more time (PERF.md).
// Deterministic, no atomics on the bins, bit-equal to the twin.  Times:
// PERF.md.

#include "rebin.cuh"

namespace {

using namespace pedoni_rebin;

constexpr int kStay = 4;      // slots whose masks a thread asks for at once
constexpr int kClassify = 4;  // mover rows a thread has in flight at once
constexpr int kWrite = 4;     // output slots a thread has in flight at once

// The hole bits of stay-mask word w of a cell: slots below k that no
// stayer holds.
__device__ __forceinline__ uint32_t hole_bits(const uint32_t* stay, int w,
                                              int cell, int cells, int k) {
  const int left = k - w * 32;
  const uint32_t valid = left >= 32 ? 0xffffffffu : (1u << left) - 1u;
  return ~stay[w * cells + cell] & valid;
}

__global__ void __launch_bounds__(kMaxThreads, 4)
rebin_inc(const float* __restrict__ g, const float* __restrict__ m,
          float* __restrict__ out, float* __restrict__ ovf,
          float* __restrict__ dmx, float* __restrict__ nin,
          float* __restrict__ nout, const int* __restrict__ gate, int want,
          Grid gd, int mk, int tile_rows, int tile_lanes) {
  extern __shared__ uint32_t smem[];
  __shared__ Sums sums;
  read_gate(gate, want, &sums);
  const Tile t = block_tile(tile_rows, tile_lanes);
  const int k = gd.k, nxl = gd.nxl;
  const int mwords = mask_words(mk), swords = (k + 31) / 32;
  uint32_t* mask = smem;                         // [mwords][cells] landers
  uint32_t* stay = mask + mwords * t.cells;      // [swords][cells]
  int* fin = (int*)(stay + swords * t.cells);    // [cells] cursor | topcnt << 16
  uint16_t* src = (uint16_t*)(fin + t.cells);    // [k][cells]
  const int tid = threadIdx.x, threads = blockDim.x;
  const int64_t sk = (int64_t)8 * nxl;  // slot stride
  const Column col = thread_column(t);
  const int cell = col.r * t.lanes + col.l;  // of the slots this thread owns
  const int row = t.row0 + col.r, lane = t.l0 + col.l;
  const float* own = g + (int64_t)row * k * sk + lane;  // that cell's slot 0

  for (int i = tid; i < (mwords + swords) * t.cells; i += threads) mask[i] = 0u;
  __syncthreads();
  if (!sums.go) return;  // gated off: the same for the whole block
  zero_ghost_rows(out, gd, t);

  // the mover table's halo lanes: this thread's first mover row there is
  // asked for now and classified in step 2
  const int n_halo = (t.rows + 2) * mk * 2;
  const HaloItem first = halo_item(m, tid, mk, t, nxl);
  const float h6 = first.c != nullptr ? first.c[6 * nxl] : 0.0f;

  // 1. the stay masks and the input active sum: the warps of a cell row
  // share its K slots, kStay at a time
  float n_in = 0.0f;
  if (lane >= 1 && lane <= gd.nx_cells) {
    for (int s0 = col.part; s0 < k; s0 += kStay * col.parts) {
      float a7[kStay], a6[kStay];
#pragma unroll
      for (int q = 0; q < kStay; ++q) {
        const int s = s0 + q * col.parts;
        a7[q] = a6[q] = 0.0f;
        if (s < k) {
          a7[q] = own[s * sk + 7 * nxl];
          a6[q] = own[s * sk + 6 * nxl];
        }
      }
#pragma unroll
      for (int q = 0; q < kStay; ++q) {
        const int s = s0 + q * col.parts;
        n_in += a6[q];
        if (a7[q] > 0.5f)
          atomicOr(stay + (s >> 5) * t.cells + cell, 1u << (s & 31));
      }
    }
  }

  // 2. classify: this thread's warp owns 32 lanes of one mover-table row of
  // the tile and its halo and walks that row's MK mover rows
  {
    const int clane = t.l0 + col.l;
    const float* c = m + (int64_t)(t.row0 - 1 + col.h) * mk * sk + clane;
    for (int j0 = 0; j0 < mk; j0 += kClassify) {
      float a6[kClassify], x[kClassify], y[kClassify];
      bool live[kClassify];
#pragma unroll
      for (int q = 0; q < kClassify; ++q)
        a6[q] = j0 + q < mk ? c[(j0 + q) * sk + 6 * nxl] : 0.0f;
#pragma unroll
      for (int q = 0; q < kClassify; ++q)
        live[q] = a6[q] > 0.5f;
#pragma unroll
      for (int q = 0; q < kClassify; ++q) {
        x[q] = live[q] ? c[(j0 + q) * sk] : 0.0f;
        y[q] = live[q] ? c[(j0 + q) * sk + nxl] : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < kClassify; ++q)
        if (live[q]) mark_lander(mask, t, gd, x[q], y[q], col.h, col.l + 1, j0 + q);
    }
  }
  if (h6 > 0.5f)
    mark_lander(mask, t, gd, first.c[0], first.c[nxl], first.h, first.hl, first.j);
  for (int i = tid + threads; i < n_halo; i += threads) {  // a tall MK only
    const HaloItem it = halo_item(m, i, mk, t, nxl);
    if (it.c != nullptr && it.c[6 * nxl] > 0.5f)
      mark_lander(mask, t, gd, it.c[0], it.c[nxl], it.h, it.hl, it.j);
  }
  __syncthreads();

  // 3. place: the n-th lander into the hole of rank n
  float over = 0.0f, n_out = 0.0f;
  int peak = 0;
  for (int pc = tid; pc < t.cells; pc += threads) {
    int stayers = 0, top_stay = 0;  // top stay slot + 1
    for (int w = 0; w < swords; ++w) {
      const uint32_t bits = stay[w * t.cells + pc];
      stayers += __popc(bits);
      if (bits) top_stay = w * 32 + 32 - __clz(bits);
    }
    const int holes = k - stayers;
    int landed = 0, cur = 0;  // cur: slot index past the last filled hole
    int hw = 0;
    uint32_t hbits = hole_bits(stay, 0, pc, t.cells, k);
    for (int w = 0; w < mwords; ++w) {
      uint32_t bits = mask[w * t.cells + pc];
      while (bits) {
        const int b = __ffs(bits) - 1;
        bits &= bits - 1;
        if (landed < holes) {
          while (hbits == 0u) hbits = hole_bits(stay, ++hw, pc, t.cells, k);
          const int slot = hw * 32 + __ffs(hbits) - 1;
          hbits &= hbits - 1;
          src[slot * t.cells + pc] = (uint16_t)(w * kBitsPerWord + b);
          cur = slot + 1;
        }
        ++landed;
      }
    }
    fin[pc] = cur | ((cur > top_stay ? cur : top_stay) << 16);
    const int filled = landed < holes ? landed : holes;
    over += (float)(landed - filled);
    n_out += (float)(stayers + filled);
    const int demand = stayers + landed;
    peak = demand > peak ? demand : peak;
  }
  block_add(&sums, over, n_out, n_in, peak);
  __syncthreads();
  block_emit(&sums, gd, t, ovf, dmx, nin, nout);

  // 4. write this thread's slots, kWrite at a time: all their loads are
  // asked for before the first store
  {
    const int f = fin[cell];
    const int cur = f & 0xffff;
    const float top = (float)(f >> 16);
    float* o = out + (int64_t)row * k * sk + lane;
    for (int s0 = col.part; s0 < k; s0 += kWrite * col.parts) {
      float v[kWrite][6];
      bool on[kWrite];
#pragma unroll
      for (int q = 0; q < kWrite; ++q) {
        const int s = s0 + q * col.parts;
        on[q] = false;
#pragma unroll
        for (int ch = 0; ch < 6; ++ch) v[q][ch] = 0.0f;
        if (s < k) {
          const bool stays = (stay[(s >> 5) * t.cells + cell] >> (s & 31)) & 1u;
          on[q] = stays || s < cur;  // a stayer or a filled hole
          if (on[q]) {
            const float* c = stays
                ? own + s * sk
                : lander_source(m, src[s * t.cells + cell], row, lane, mk, nxl);
#pragma unroll
            for (int ch = 0; ch < 6; ++ch) v[q][ch] = c[ch * nxl];
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kWrite; ++q) {
        const int s = s0 + q * col.parts;
        if (s >= k) break;
        float* os = o + s * sk;
#pragma unroll
        for (int ch = 0; ch < 6; ++ch) os[ch * nxl] = v[q][ch];
        os[6 * nxl] = on[q] ? 1.0f : 0.0f;
        os[7 * nxl] = top;
      }
    }
  }
}

}  // namespace

// ovf/dmx/nin/nout must be zeroed by the caller.  gate may be null.
// tile_rows, tile_lanes, threads and smem_bytes are the launch shape
// (rebin.py::rebin_launch); returns a cudaError_t, or -1 for a launch shape
// that function cannot return.
extern "C" int pedoni_rebin_incremental(const float* g, const float* m,
                                        float* out, float* ovf, float* dmx,
                                        float* nin, float* nout,
                                        const int* gate, int want, int ny2,
                                        int k, int mk, int nxl, int rb,
                                        float unit, int nx_cells, int ny_cells,
                                        int tile_rows, int tile_lanes,
                                        int threads, int smem_bytes,
                                        void* stream) {
  const pedoni_rebin::Grid gd{ny2, k, nxl, rb, nx_cells, ny_cells, unit};
  if (mk < 1 || !pedoni_rebin::launch_ok(gd, mk, tile_rows, tile_lanes, threads,
                                         smem_bytes))
    return -1;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rebin_inc, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((unsigned)(nxl / tile_lanes), (unsigned)((ny2 - 2) / tile_rows));
  rebin_inc<<<grid, threads, smem_bytes, (cudaStream_t)stream>>>(
      g, m, out, ovf, dmx, nin, nout, gate, want, gd, mk, tile_rows, tile_lanes);
  return (int)cudaGetLastError();
}
