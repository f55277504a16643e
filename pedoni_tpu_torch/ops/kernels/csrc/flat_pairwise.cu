// Flat pair pass: the pair acceleration of every slot of the flat step's
// dense cell grid, in one launch.
//
// Replaces no pallas_call: the reference computes this function as
// XLA-fused element-wise code, a lax.map over row blocks
// (pedoni_tpu/ops/forcepass.py:141, _pair_block :97).  Plain PyTorch twin:
// pedoni_tpu_torch/ops/forcepass.py::dense_pairwise_torch.  Callers: the
// flat step (models/sfm.py) and the x-strips (parallel/spatial.py).
//
// Layouts (f32, contiguous, 16-byte aligned):
//   data [ny2, nx2, K, 8]  forcepass.scatter_cell_data's padded grid: ch 0
//                          pos.x, 1 pos.y, 2 vel.x, 3 vel.y, 4-5 the goal
//                          direction e, 6 active, 7 unused; a one-cell ring
//   acc  [ny2, nx2, K, 2]  the acceleration of every slot; the ring's is 0
//
// Semantics of the twin: every slot of an interior cell gets its
// acceleration, active or not; a candidate counts where its ch 6 > 0.5, its
// squared distance <= the cutoff's, and it is not the slot itself (block
// 4, slot i); candidates come in forcepass._OFFSETS order (dy outer, dx
// inner), then slot j, and each slot's sum starts at +0 and takes them one
// add at a time.  The arithmetic is forces.pair_terms term by term in its
// f32 order: sqrtf, IEEE divides (__fdiv_rn), expf, the FOV test
// ex*(-fx) + ey*(-fy) >= |f| cos_phi, no fused multiply-add (--fmad=false),
// and clamps that pass NaN through as torch.clamp does.  A masked candidate
// is skipped: a sum that starts at +0 is never -0 under round-to-nearest,
// so adding the twin's +0 leaves it unchanged, NaN and inf included.  So
// kernel and twin agree bit for bit.
//
// What bounds it on the card (NVIDIA H100 80GB HBM3): instruction issue.
// A pair within the cutoff costs ~60 float operations, several of them
// multi-instruction (four IEEE divides, four sqrtf, an accurate expf), and
// the pair test falls differently in each lane.  The bytes are few: the
// grid is read from L1/L2 (each slot is a candidate of 9 cells) and the
// output written once.
//
// The design is the simple one: one block per tile of kTileRows x
// kTileCols cells of the padded grid, one thread per slot of the tile.
//   1. Each cell of the tile and its one-cell halo gets, in shared memory,
//      1 + its highest slot with ch 6 > 0.5 (0 for none), read from ch 6.
//      A slot at or past it is inactive, so the pair loop stops there.
//   2. A slot whose 9 window cells hold no active slot, and every ring slot,
//      writes +0 without looping; any other walks its window in the twin's
//      order, reading each candidate from global memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device.cuh"

namespace {

constexpr int kTileRows = 2;
constexpr int kTileCols = 16;
constexpr int kHaloCols = kTileCols + 2;
constexpr int kHaloCells = (kTileRows + 2) * kHaloCols;
constexpr int kMaxThreads = 512;

struct FlatConsts {
  float cutoff_sq, dt, eps, strength, range, cos_phi, fov_damping;
};

// torch.clamp(x, min=lo): a NaN passes through (fmaxf would drop it).
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

// forces.norm2: sqrt(clamp(x*x + y*y, EPS)).
__device__ __forceinline__ float norm2(float x, float y, float eps) {
  return sqrtf(clamp_min(x * x + y * y, eps));
}

// forces.pair_terms of one pair within the cutoff, before the mask.
__device__ __forceinline__ void pair_term(float dx, float dy, float d2,
                                          float vx, float vy, float ex,
                                          float ey, const FlatConsts& c,
                                          float& fx, float& fy) {
  const float d = sqrtf(clamp_min(d2, c.eps));
  const float t1x = dx - vx * c.dt;
  const float t1y = dy - vy * c.dt;
  const float t1_len = norm2(t1x, t1y, c.eps);
  const float t2 = d + t1_len;
  const float vdt = norm2(vx, vy, c.eps) * c.dt;
  const float b = sqrtf(clamp_min(t2 * t2 - vdt * vdt, c.eps)) * 0.5f;
  const float b4 = 4.0f * b;
  const float mag = c.strength * expf(__fdiv_rn(-b, c.range));
  fx = mag * __fdiv_rn(t2 * (__fdiv_rn(dx, d) + __fdiv_rn(t1x, t1_len)), b4);
  fy = mag * __fdiv_rn(t2 * (__fdiv_rn(dy, d) + __fdiv_rn(t1y, t1_len)), b4);
  if (!(ex * -fx + ey * -fy >= norm2(fx, fy, c.eps) * c.cos_phi)) {
    fx = fx * c.fov_damping;
    fy = fy * c.fov_damping;
  }
}

__global__ void __launch_bounds__(kMaxThreads)
flat_pairwise_tile(const float* __restrict__ data, float* __restrict__ acc,
                   int ny2, int nx2, int k, FlatConsts c) {
  __shared__ int top[kHaloCells];
  const int r0 = blockIdx.y * kTileRows;  // the tile's first padded row
  const int c0 = blockIdx.x * kTileCols;
  for (int t = threadIdx.x; t < kHaloCells; t += blockDim.x) top[t] = 0;
  __syncthreads();
  for (int t = threadIdx.x; t < kHaloCells * k; t += blockDim.x) {
    const int cell = t / k, j = t - cell * k;
    const int r = r0 - 1 + cell / kHaloCols, col = c0 - 1 + cell % kHaloCols;
    if (r < 0 || r >= ny2 || col < 0 || col >= nx2) continue;
    if (data[((int64_t)r * nx2 + col) * k * 8 + j * 8 + 6] > 0.5f)
      atomicMax(&top[cell], j + 1);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < kTileRows * kTileCols * k; t += blockDim.x) {
    const int cell = t / k, i = t - cell * k;
    const int tr = cell / kTileCols, tc = cell % kTileCols;
    const int r = r0 + tr, col = c0 + tc;
    if (r >= ny2 || col >= nx2) continue;
    const int64_t slot = ((int64_t)r * nx2 + col) * k + i;
    float sx = 0.0f, sy = 0.0f;
    int any = 0;
    if (r >= 1 && r <= ny2 - 2 && col >= 1 && col <= nx2 - 2) {
      for (int w = 0; w < 9; ++w) any |= top[(tr + w / 3) * kHaloCols + tc + w % 3];
    }
    if (any) {
      const float4 lo = *reinterpret_cast<const float4*>(data + slot * 8);
      const float4 hi = *reinterpret_cast<const float4*>(data + slot * 8 + 4);
      for (int w = 0; w < 9; ++w) {  // _OFFSETS: dy = w / 3 - 1, dx = w % 3 - 1
        const int n = top[(tr + w / 3) * kHaloCols + tc + w % 3];
        const float* q = data + (((int64_t)(r + w / 3 - 1) * nx2 +
                                  (col + w % 3 - 1)) * k) * 8;
        for (int j = 0; j < n; ++j, q += 8) {
          if (!(q[6] > 0.5f) || (w == 4 && j == i)) continue;
          const float4 p = *reinterpret_cast<const float4*>(q);
          const float dx = lo.x - p.x;
          const float dy = lo.y - p.y;
          const float d2 = dx * dx + dy * dy;
          if (!(d2 <= c.cutoff_sq)) continue;
          float fx, fy;
          pair_term(dx, dy, d2, p.z, p.w, hi.x, hi.y, c, fx, fy);
          sx = sx + fx;
          sy = sy + fy;
        }
      }
    }
    reinterpret_cast<float2*>(acc)[slot] = make_float2(sx, sy);
  }
}

}  // namespace

// consts: the 7 FlatConsts floats, in order
// (kernels/flat_pairwise.py::flat_constants).  Returns a cudaError_t, -1 for
// a grid it does not take, or PEDONI_WRONG_DEVICE (device.cuh) for a grid
// off the current device.
extern "C" int pedoni_flat_pairwise(const float* data, float* acc, int ny2,
                                    int nx2, int k, const float* consts,
                                    void* stream) {
  if (const int w = pedoni_on_current_device(data)) return w;
  if (ny2 < 3 || nx2 < 3 || k < 1 || k > 255 ||
      (ny2 + kTileRows - 1) / kTileRows > 65535)
    return -1;
  FlatConsts c;
  c.cutoff_sq = consts[0];
  c.dt = consts[1];
  c.eps = consts[2];
  c.strength = consts[3];
  c.range = consts[4];
  c.cos_phi = consts[5];
  c.fov_damping = consts[6];
  const int slots = kTileRows * kTileCols * k;
  const int threads = slots < kMaxThreads ? (slots + 31) / 32 * 32 : kMaxThreads;
  dim3 grid((unsigned)((nx2 + kTileCols - 1) / kTileCols),
            (unsigned)((ny2 + kTileRows - 1) / kTileRows));
  flat_pairwise_tile<<<grid, threads, 0, (cudaStream_t)stream>>>(data, acc, ny2,
                                                                 nx2, k, c);
  return (int)cudaGetLastError();
}
