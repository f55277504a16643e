// Flat integrate: the flat step's force sum and integration, one thread an
// agent, in one launch.
//
// Replaces no pallas_call: the reference computes this as XLA-fused
// element-wise code (pedoni_tpu/ops/forces.py:41 goal_force, :92
// obstacle_force, :158 integrate; pedoni_tpu/ops/forcepass.py:187
// gather_pair_acc; pedoni_tpu/models/sfm.py:391-409).  Plain PyTorch twin:
// pedoni_tpu_torch/ops/kernels/flat_integrate.py::flat_integrate_torch.
// Callers: the flat step (models/sfm.py::make_step) and each x-strip step
// (parallel/spatial.py), once a step, through ops/kernels/flat_integrate.py.
//
// Layouts (f32 unless said, contiguous):
//   rows [C, 12]           the sorted rows (flat_scatter): 0:2 pos, 2:4
//                          vel, 4 speed, 7:9 goal direction e, 9 obstacle
//                          distance, 10:12 its Sobel; 16-byte aligned
//   active [C] u8          the rows' active flag
//   pair term, by pair_mode:
//     0  acc_flat [M, 2] (flat_pairwise's, by slot), slot [C] i64 and
//        valid [C] u8 (the layout): acc_flat[slot] where valid, else +0
//     1  pair [C, 2]       a term computed apart (all-pairs mode)
//   obstacle term, by obs_mode: 0 none (segment mode without obstacles),
//     1 from the rows' distance and Sobel (distance-map mode), 2 obstacle
//     [C, 2] computed apart (segment mode)
//   pos [C, 2], vel [C, 2] the integrated agents (the old ones where
//                          inactive)
//
// One thread an agent mirrors the twin op by op, each op rounded to f32 as
// PyTorch rounds it, no fused multiply-add (--fmad=false): the goal term
// (e * speed - v) / tau with an IEEE divide (__fdiv_rn); the obstacle term
// -(g / sqrt(clamp(|g|^2, EPS))) * (strength * expf(-dist / range)); the
// pair term; the sum goal + obstacle + pair in that order, a term that the
// twin does not add left out (adding +0 would turn a -0 into +0); then
// v' = v + a dt, scale = clamp(v_max / clamp(sqrt(clamp(|v'|^2, EPS)),
// EPS), max 1) with clamps that pass NaN as torch.clamp does, v' * scale,
// p + (v' + v) (dt / 2).  So kernel and twin agree bit for bit.
//
// What bounds it on the card (NVIDIA H100 80GB HBM3): the bytes, ~90 an
// agent (the 48-byte row, the flag, the slot and its pair term, 16 out).
// The twin is ~40 element-wise launches and one gather.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device.cuh"

namespace {

struct IntegrateConsts {
  float tau, obs_strength, obs_range, eps, dt, max_speed_factor, half_dt;
};

// torch.clamp(x, min=lo) and torch.clamp(x, max=hi): a NaN passes through.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return x > hi ? hi : x;
}

__global__ void __launch_bounds__(256)
flat_integrate_kernel(const float* __restrict__ rows,
                      const unsigned char* __restrict__ active,
                      const float* __restrict__ acc_flat,
                      const int64_t* __restrict__ slot,
                      const unsigned char* __restrict__ valid,
                      const float* __restrict__ pair,
                      const float* __restrict__ obstacle, float* __restrict__ pos,
                      float* __restrict__ vel, int64_t c, int obs_mode,
                      int pair_mode, IntegrateConsts k) {
  const int64_t a = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (a >= c) return;
  const float4* src = reinterpret_cast<const float4*>(rows + a * 12);
  const float4 r0 = src[0], r1 = src[1], r2 = src[2];
  const float x = r0.x, y = r0.y, vx = r0.z, vy = r0.w, sp = r1.x;
  const float ex = r1.w, ey = r2.x;

  // forces.goal_force
  float ax = __fdiv_rn(ex * sp - vx, k.tau);
  float ay = __fdiv_rn(ey * sp - vy, k.tau);
  // forces.obstacle_force, or a term computed apart
  if (obs_mode == 1) {
    const float gx = r2.z, gy = r2.w;
    const float n = sqrtf(clamp_min(gx * gx + gy * gy, k.eps));
    const float mag = k.obs_strength * expf(__fdiv_rn(-r2.y, k.obs_range));
    ax = ax + mag * -__fdiv_rn(gx, n);
    ay = ay + mag * -__fdiv_rn(gy, n);
  } else if (obs_mode == 2) {
    ax = ax + obstacle[2 * a];
    ay = ay + obstacle[2 * a + 1];
  }
  // forcepass.gather_pair_acc, or a term computed apart
  float px = 0.0f, py = 0.0f;
  if (pair_mode == 0) {
    if (valid[a]) {
      const float2 p = reinterpret_cast<const float2*>(acc_flat)[slot[a]];
      px = p.x;
      py = p.y;
    }
  } else {
    px = pair[2 * a];
    py = pair[2 * a + 1];
  }
  ax = ax + px;
  ay = ay + py;

  // forces.integrate
  float2* pos2 = reinterpret_cast<float2*>(pos);
  float2* vel2 = reinterpret_cast<float2*>(vel);
  if (!active[a]) {
    pos2[a] = make_float2(x, y);
    vel2[a] = make_float2(vx, vy);
    return;
  }
  float nvx = vx + ax * k.dt;
  float nvy = vy + ay * k.dt;
  const float vmax = sp * k.max_speed_factor;
  const float norm = clamp_min(sqrtf(clamp_min(nvx * nvx + nvy * nvy, k.eps)), k.eps);
  const float scale = clamp_max(__fdiv_rn(vmax, norm), 1.0f);
  nvx = nvx * scale;
  nvy = nvy * scale;
  pos2[a] = make_float2(x + (nvx + vx) * k.half_dt, y + (nvy + vy) * k.half_dt);
  vel2[a] = make_float2(nvx, nvy);
}

}  // namespace

// consts: the 7 IntegrateConsts floats, in order
// (kernels/flat_integrate.py::integrate_constants).  acc_flat, slot and
// valid may be null unless pair_mode is 0, pair unless it is 1, obstacle
// unless obs_mode is 2.  Returns a cudaError_t, -1 for arguments it does
// not take, or PEDONI_WRONG_DEVICE (device.cuh) for rows off the current
// device.
extern "C" int pedoni_flat_integrate(const float* rows,
                                     const unsigned char* active,
                                     const float* acc_flat, const int64_t* slot,
                                     const unsigned char* valid,
                                     const float* pair, const float* obstacle,
                                     float* pos, float* vel, int64_t c,
                                     int obs_mode, int pair_mode,
                                     const float* consts, void* stream) {
  if (const int w = pedoni_on_current_device(pos)) return w;
  if (c < 1 || obs_mode < 0 || obs_mode > 2 || pair_mode < 0 || pair_mode > 1)
    return -1;
  IntegrateConsts k;
  k.tau = consts[0];
  k.obs_strength = consts[1];
  k.obs_range = consts[2];
  k.eps = consts[3];
  k.dt = consts[4];
  k.max_speed_factor = consts[5];
  k.half_dt = consts[6];
  constexpr int kThreads = 256;
  const int64_t blocks = (c + kThreads - 1) / kThreads;
  flat_integrate_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      rows, active, acc_flat, slot, valid, pair, obstacle, pos, vel, c,
      obs_mode, pair_mode, k);
  return (int)cudaGetLastError();
}
