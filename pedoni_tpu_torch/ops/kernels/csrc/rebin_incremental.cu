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
//   any order; the peak is an integer atomicMax on the float's bits.
// gate: optional device int; the body runs only where *gate == want (the
//   step passes the same gate to rebin.cu with the other value).
//
// What bounds it on the card: device-memory traffic.  Each output cell
// reads its K slots' ch 6-7 (ch 0-5 of stayers), the 3x3 mover cells'
// counts and their mover rows (mostly cache hits, shared by neighbouring
// threads), and writes its K x 8 slots once.
//
// The simple design: one thread per output cell (row, lane).
//   1. Count the cell's holes (slots whose stay mask is not set, or any
//      slot of a lane outside 1..nx: stayers are gated to owned lanes).
//   2. Walk the mover candidates in the reference's order — mover row j
//      outer, then dy, then dx (rebin.py:380-406) — with j bounded by the
//      largest of the 9 cells' mover counts, as the reference's mmax
//      bound does.  The landing test is rebin.cu's, IEEE divide included.
//      The n-th lander takes the hole of rank n while n < holes: a cursor
//      steps over stay slots, so holes fill in slot order, exactly the
//      reference's exclusive hole rank (rebin.py:358-369).
//   3. Write every slot once more: stayers copy their ch 0-5, filled holes
//      keep what step 2 wrote, the rest are zero; ch 6 and ch 7 = topcnt.
// Deterministic, no atomics on the bins, bit-equal to the twin.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void rebin_inc(const float* __restrict__ g,
                          const float* __restrict__ m, float* __restrict__ out,
                          float* __restrict__ ovf, float* __restrict__ dmx,
                          float* __restrict__ nin, float* __restrict__ nout,
                          const int* __restrict__ gate, int want, int ny2,
                          int k, int mk, int nxl, int rb, float unit,
                          int nx_cells, int ny_cells) {
  if (gate != nullptr && *gate != want) return;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y;  // every thread of a block shares its row
  if (lane >= nxl) return;
  const int64_t sk = (int64_t)8 * nxl;  // slot stride
  float* dst = out + (int64_t)row * k * sk + lane;
  if (row == 0 || row == ny2 - 1) {
    for (int s = 0; s < k; ++s)
      for (int c = 0; c < 8; ++c) dst[s * sk + (int64_t)c * nxl] = 0.0f;
    return;
  }
  const bool own = lane >= 1 && lane <= nx_cells;
  const float* gs = g + (int64_t)row * k * sk + lane;
#define PEDONI_STAY(s) (own && gs[(s) * sk + 7 * nxl] > 0.5f)

  // 1. holes and the input active sum
  int holes = 0;
  int top_stay = 0;  // top stay slot + 1
  float in_act = 0.0f;
  for (int s = 0; s < k; ++s) {
    if (PEDONI_STAY(s)) top_stay = s + 1;
    else ++holes;
    if (own) in_act += gs[s * sk + 6 * nxl];
  }

  // 2. mover walk: (j, dy, dx) order, landers into holes by rank
  const float* mrow[3];
  int jmax = 0;
  float mcnt[9];
  for (int dy = -1; dy <= 1; ++dy) {
    mrow[dy + 1] = m + (int64_t)(row + dy) * mk * sk;
    for (int dx = -1; dx <= 1; ++dx) {
      const int l2 = lane + dx;
      float cv = 0.0f;
      if (l2 >= 0 && l2 < nxl) cv = mrow[dy + 1][7 * nxl + l2];
      mcnt[(dy + 1) * 3 + dx + 1] = cv;
      const int ci = cv > (float)mk ? mk : (cv > 0.0f ? (int)ceilf(cv) : 0);
      jmax = ci > jmax ? ci : jmax;
    }
  }
  const float row_f = (float)(row - 1);
  const float lane_f = (float)lane;
  int landed = 0;
  int cur = 0;  // slot index past the last filled hole
  for (int j = 0; j < jmax; ++j) {
    for (int dy = -1; dy <= 1; ++dy) {
      const float* crow = mrow[dy + 1] + j * sk;
      for (int dx = -1; dx <= 1; ++dx) {
        const int l2 = lane + dx;
        if (l2 < 0 || l2 >= nxl) continue;
        if (!((float)j < mcnt[(dy + 1) * 3 + dx + 1])) continue;
        const float* cs = crow + l2;
        if (!(cs[6 * nxl] > 0.5f)) continue;
        const float x = cs[0];
        const float y = cs[nxl];
        const float tgt_lane = floorf(__fdiv_rn(x, unit)) + 1.0f;
        const float tgt_row = floorf(__fdiv_rn(y, unit));
        if (!(tgt_row == row_f && tgt_row <= (float)(ny_cells - 1) &&
              tgt_lane >= 1.0f && tgt_lane <= (float)nx_cells &&
              tgt_lane == lane_f))
          continue;
        if (landed < holes) {
          while (PEDONI_STAY(cur)) ++cur;
          float* o = dst + cur * sk;
          o[0] = x;
          o[nxl] = y;
          for (int c = 2; c < 6; ++c) o[(int64_t)c * nxl] = cs[(int64_t)c * nxl];
          ++cur;
        }
        ++landed;
      }
    }
  }

  // 3. stayers, the untouched rest, ch 6 and ch 7 = topcnt
  const int topcnt = cur > top_stay ? cur : top_stay;
  int n_out = 0;
  for (int s = 0; s < k; ++s) {
    float* o = dst + s * sk;
    const bool stay = PEDONI_STAY(s);
    const bool filled = !stay && s < cur;
    if (stay)
      for (int c = 0; c < 6; ++c) o[(int64_t)c * nxl] = gs[s * sk + (int64_t)c * nxl];
    else if (!filled)
      for (int c = 0; c < 6; ++c) o[(int64_t)c * nxl] = 0.0f;
    o[6 * nxl] = (stay || filled) ? 1.0f : 0.0f;
    o[7 * nxl] = (float)topcnt;
    n_out += (stay || filled) ? 1 : 0;
  }
#undef PEDONI_STAY

  // Per-block reductions: warp sums, then one atomic per warp.
  float over = (float)(landed > holes ? landed - holes : 0);
  float out_f = (float)n_out;
  int peak = (k - holes) + landed;
  const unsigned mask = 0xffffffffu;  // full warps: NXL % 128 == 0
  for (int off = 16; off > 0; off >>= 1) {
    over += __shfl_down_sync(mask, over, off);
    out_f += __shfl_down_sync(mask, out_f, off);
    in_act += __shfl_down_sync(mask, in_act, off);
    const int p2 = __shfl_down_sync(mask, peak, off);
    peak = p2 > peak ? p2 : peak;
  }
  if ((threadIdx.x & 31) == 0) {
    const int b = (row - 1) / rb;
    if (over != 0.0f) atomicAdd(ovf + b, over);
    if (out_f != 0.0f) atomicAdd(nout + b, out_f);
    if (in_act != 0.0f) atomicAdd(nin + b, in_act);
    if (peak > 0) atomicMax((int*)(dmx + b), __float_as_int((float)peak));
  }
}

}  // namespace

// ovf/dmx/nin/nout must be zeroed by the caller.  nxl % 32 == 0, so every
// warp is full and the shuffles see 32 live lanes.  gate may be null.
extern "C" int pedoni_rebin_incremental(const float* g, const float* m,
                                        float* out, float* ovf, float* dmx,
                                        float* nin, float* nout,
                                        const int* gate, int want, int ny2,
                                        int k, int mk, int nxl, int rb,
                                        float unit, int nx_cells, int ny_cells,
                                        void* stream) {
  const int threads = 128;
  dim3 grid((unsigned)((nxl + threads - 1) / threads), (unsigned)ny2);
  rebin_inc<<<grid, threads, 0, (cudaStream_t)stream>>>(
      g, m, out, ovf, dmx, nin, nout, gate, want, ny2, k, mk, nxl, rb, unit,
      nx_cells, ny_cells);
  return (int)cudaGetLastError();
}
