// Standalone pairwise kernel: pair accelerations over the cell grid.
//
// Replaces pedoni_tpu/ops/pallas/pairwise.py::pallas_pairwise (pallas_call
// at pairwise.py:177, body _kernel :109).  Plain PyTorch twin:
// pedoni_tpu_torch/ops/kernels/pairwise.py::pairwise_torch.
//
// Layouts (f32, contiguous):
//   d    [ny2, K, 8, NX]     ch 0 pos.x, 1 pos.y, 2 vel.x, 3 vel.y, 4-5 the
//                            desired direction e, 6 active, 7 unused
//   acc  [ny2 - 2, K, 2, NX] the acceleration of the centre slot at D row
//                            r + 1 (no ghost rows)
//
// Semantics of the reference, which differ from the fused step's pair loop:
// the candidate order is dy outer, then slot j over all K, then dx; a
// candidate counts by its ch 6 alone (no per-cell count bound); every
// centre slot gets an acceleration, active or not; nothing is sanitized;
// lanes roll circularly (candidate lane (l + dx) mod NX); the centre itself
// is excluded at dy = dx = 0, j = k.
//
// What bounds it on the card: load latency.  Each thread walks 27 K
// candidate slots, reading ch 6 of each (and ch 0-3 of the active ones);
// neighbouring lanes read neighbouring words, so the loads coalesce and
// hit L1/L2, and the bytes from device memory are D once and the output
// once.  The design is the simple one: one thread per centre slot (row, k,
// lane), lanes fastest, the pair force from pair.cuh.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair.cuh"

namespace {

__global__ void pairwise_kernel(const float* __restrict__ d,
                                float* __restrict__ acc, int ny_pad, int k,
                                int nx, PairConsts pc) {
  const int64_t n = (int64_t)ny_pad * k * nx;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int lane = (int)(idx % nx);
  const int64_t rk = idx / nx;  // centre row r (D row r + 1) * K + slot
  const int row = (int)(rk / k);
  const int kk = (int)(rk % k);
  const int64_t nxl = nx;
  const float* c = d + ((int64_t)(row + 1) * k + kk) * 8 * nxl + lane;
  const float px = c[0], py = c[nxl], ex = c[4 * nxl], ey = c[5 * nxl];
  float ax = 0.0f, ay = 0.0f;
  for (int dy = -1; dy <= 1; ++dy) {
    const int64_t r2 = row + 1 + dy;
    for (int j = 0; j < k; ++j) {
      const float* cs_row = d + (r2 * k + j) * 8 * nxl;
      for (int dx = -1; dx <= 1; ++dx) {
        if (dy == 0 && dx == 0 && j == kk) continue;  // self
        int l2 = lane + dx;
        if (l2 < 0) l2 += nx;
        if (l2 >= nx) l2 -= nx;
        const float* cs = cs_row + l2;
        if (!(cs[6 * nxl] > 0.5f)) continue;
        pair_accum(ax, ay, px, py, ex, ey, cs[0], cs[nxl], cs[2 * nxl],
                   cs[3 * nxl], pc);
      }
    }
  }
  float* o = acc + rk * 2 * nxl + lane;
  o[0] = ax;
  o[nxl] = ay;
}

}  // namespace

// consts: the 7 PairConsts floats, in order (pairwise.py::pair_constants).
extern "C" int pedoni_pairwise(const float* d, float* acc, int ny2, int k,
                               int nx, const float* consts, void* stream) {
  PairConsts pc;
  pc.cutoff_sq = consts[0];
  pc.dt = consts[1];
  pc.dt2 = consts[2];
  pc.half_strength = consts[3];
  pc.neg_half_inv_range = consts[4];
  pc.cos2 = consts[5];
  pc.fov_damping = consts[6];
  const int ny_pad = ny2 - 2;
  const int64_t n = (int64_t)ny_pad * k * nx;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  pairwise_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(d, acc, ny_pad,
                                                               k, nx, pc);
  return (int)cudaGetLastError();
}
