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
//   atomics are exact in any order (totals stay below 2^24); the peak is
//   an integer atomicMax on the float's bits (non-negative floats order as
//   their bit patterns do).
// gate: optional device int; when given, the body runs only where
//   *gate == want, so the step's full-or-incremental choice is read on the
//   device (rebin_incremental.cu takes the same gate and the other value).
//
// What bounds it on the card: device-memory traffic.  Each output cell
// reads the 7 channels of its 3x3 neighbourhood's K slots (mostly cache
// hits: neighbouring threads share them) and writes its K x 8 slots once,
// ~3 bytes read per byte written and almost no arithmetic.
//
// The simple design: one thread per output cell (row, lane), owning that
// cell's K slots.  It walks the 9 neighbour cells' slots in the order
// (j, dy, dx) — the reference's compaction order — and a candidate that
// lands here goes to slot cnt, then cnt increments.  Deterministic, no
// atomics on the bins, bit-exact with the reference.  The walk cannot be
// bounded by counts: ch 7 of g is the potential, so it visits every slot
// j < K and skips inactive ones.  The landing test is an IEEE f32 divide
// (__fdiv_rn), never a multiply by the inverse: it must classify cell
// boundaries exactly as the reference does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void rebin_full(const float* __restrict__ g, float* __restrict__ out,
                           float* __restrict__ ovf, float* __restrict__ dmx,
                           float* __restrict__ nin, float* __restrict__ nout,
                           const int* __restrict__ gate, int want,
                           int ny2, int k, int nxl, int rb, float unit,
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
  const float row_f = (float)(row - 1);
  const float lane_f = (float)lane;
  int cnt = 0;
  for (int j = 0; j < k; ++j) {
    for (int dy = -1; dy <= 1; ++dy) {
      const float* crow = g + ((int64_t)(row + dy) * k + j) * sk;
      for (int dx = -1; dx <= 1; ++dx) {
        const int l2 = lane + dx;
        if (l2 < 0 || l2 >= nxl) continue;
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
        if (cnt < k) {
          float* o = dst + cnt * sk;
          o[0] = x;
          o[nxl] = y;
          for (int c = 2; c < 6; ++c) o[(int64_t)c * nxl] = cs[(int64_t)c * nxl];
        }
        ++cnt;
      }
    }
  }
  const int kept = cnt < k ? cnt : k;
  for (int s = 0; s < k; ++s) {
    float* o = dst + s * sk;
    if (s >= kept)
      for (int c = 0; c < 6; ++c) o[(int64_t)c * nxl] = 0.0f;
    o[6 * nxl] = s < cnt ? 1.0f : 0.0f;
    o[7 * nxl] = (float)kept;
  }

  // Per-block reductions: warp sums, then one atomic per warp.
  float in_act = 0.0f;
  if (lane >= 1 && lane <= nx_cells) {
    const float* gs = g + (int64_t)row * k * sk + 6 * nxl + lane;
    for (int s = 0; s < k; ++s) in_act += gs[s * sk];
  }
  float over = (float)(cnt > k ? cnt - k : 0);
  float kept_f = (float)kept;
  int peak = cnt;
  const unsigned mask = 0xffffffffu;  // full warps: NXL % 128 == 0
  for (int off = 16; off > 0; off >>= 1) {
    over += __shfl_down_sync(mask, over, off);
    kept_f += __shfl_down_sync(mask, kept_f, off);
    in_act += __shfl_down_sync(mask, in_act, off);
    const int p2 = __shfl_down_sync(mask, peak, off);
    peak = p2 > peak ? p2 : peak;
  }
  if ((threadIdx.x & 31) == 0) {
    const int b = (row - 1) / rb;
    if (over != 0.0f) atomicAdd(ovf + b, over);
    if (kept_f != 0.0f) atomicAdd(nout + b, kept_f);
    if (in_act != 0.0f) atomicAdd(nin + b, in_act);
    if (peak > 0) atomicMax((int*)(dmx + b), __float_as_int((float)peak));
  }
}

}  // namespace

// ovf/dmx/nin/nout must be zeroed by the caller.  nxl % 32 == 0, so every
// warp is full and the shuffles see 32 live lanes.  gate may be null.
extern "C" int pedoni_rebin_full(const float* g, float* out, float* ovf,
                                 float* dmx, float* nin, float* nout,
                                 const int* gate, int want, int ny2, int k,
                                 int nxl, int rb, float unit, int nx_cells,
                                 int ny_cells, void* stream) {
  const int threads = 128;
  dim3 grid((unsigned)((nxl + threads - 1) / threads), (unsigned)ny2);
  rebin_full<<<grid, threads, 0, (cudaStream_t)stream>>>(
      g, out, ovf, dmx, nin, nout, gate, want, ny2, k, nxl, rb, unit,
      nx_cells, ny_cells);
  return (int)cudaGetLastError();
}
