// Flat sample: the flat step's field taps, goal direction, despawn test,
// cell id and packed agent rows, in one launch.
//
// Replaces no pallas_call: the reference computes this as XLA-fused
// element-wise code around four row gathers (pedoni_tpu/ops/sampling.py:
// 70-97, sample_field; pedoni_tpu/models/sfm.py:335-373 up to the sort).
// Plain PyTorch twin: pedoni_tpu_torch/ops/sampling.py::flat_sample_torch.
// Callers: the flat step (models/sfm.py::make_step) and each x-strip step
// (parallel/spatial.py), once a step, through ops/kernels/flat_sample.py.
//
// Layouts:
//   pos [N, 2], vel [N, 2] f32, speed [N] f32, dest [N] i32, active [N]
//                          bool: any strides (the step's state is often
//                          columns of the last step's packed rows)
//   rows [R, 8] f32        sampling.DeviceField.rows: one row a texel of
//                          a waypoint plane, ch 0 potential, 1-2 its
//                          Sobel, 3 obstacle distance, 4-5 its Sobel;
//                          16-byte aligned
//   packed [N, 12] f32     0:2 pos, 2:4 vel, 4 speed, 5 dest, 6 alive, 7:9
//                          the goal direction e, 9 obstacle distance,
//                          10:12 its Sobel
//   cid [N] i32            the cell id, nx * ny for a dead agent
//
// One thread an agent mirrors the twin op by op, each op rounded to f32 as
// PyTorch rounds it, no fused multiply-add (--fmad=false):
//   px = clamp(x / unit - 0.5 + PAD, 0, wp - 1.001) with an IEEE divide
//   (__fdiv_rn; neighbor.true_divide), likewise py; clamps that pass NaN
//   through as torch.clamp does; base = (dest * hp + floor(py)) * wp +
//   floor(px) in 64 bits, each of the four taps clamped into [0, R - 1]
//   (the reference's take(mode="clip")); each tap's row read as two
//   float4; the lerps top, bot, v channel by channel in the twin's order;
//   e = g / sqrt(clamp(gx*gx + gy*gy, EPS)) with IEEE divides; alive =
//   active & (potential > despawn) & in the grid, the cell id from the
//   IEEE divide by the cell unit (neighbor.compute_cell_ids); vel and
//   speed at or past 2^30 in magnitude, or NaN, become 2^30 when
//   sanitizing; the row written as three float4.  So kernel and twin agree
//   bit for bit.
//
// What bounds it on the card (NVIDIA H100 80GB HBM3): the bytes, ~170 an
// agent (25 of state, four 32-byte texel rows of which 24 are used, 52
// out), ~0.05 ms at 1M agents; the taps are scattered, each in its own
// 32-byte sector, and neighbouring agents (in the last step's cell order)
// share texel rows through L1/L2.  The twin is ~60 launches of element-wise
// code and four 1M-row gathers, ~3 ms at 1M on the card.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device.cuh"

namespace {

struct SampleConsts {
  float unit, px_hi, py_hi, pad, despawn, cell_unit, eps;
};

struct AgentStrides {
  int64_t pos0, pos1, vel0, vel1, speed, dest, active;
};

constexpr float kSanitize = 1073741824.0f;  // 2^30

// torch.clamp(x, lo, hi): a NaN passes through.
__device__ __forceinline__ float clamp2(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// torch.where(|x| < 2^30, x, 2^30)
__device__ __forceinline__ float sanitize(float x) {
  return fabsf(x) < kSanitize ? x : kSanitize;
}

__device__ __forceinline__ int64_t clip_row(int64_t i, int64_t last) {
  return i < 0 ? 0 : (i > last ? last : i);
}

__global__ void __launch_bounds__(256)
flat_sample_kernel(const float* __restrict__ pos, const float* __restrict__ vel,
                   const float* __restrict__ speed, const int* __restrict__ dest,
                   const unsigned char* __restrict__ active,
                   const float* __restrict__ rows, float* __restrict__ packed,
                   int* __restrict__ cid, int64_t n, int64_t n_rows, int hp,
                   int wp, int nx, int ny, int sanitizing, AgentStrides s,
                   SampleConsts c) {
  const int64_t a = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (a >= n) return;
  const float x = pos[a * s.pos0];
  const float y = pos[a * s.pos0 + s.pos1];
  const int d = dest[a * s.dest];

  // sampling.sample_field
  const float px = clamp2(__fdiv_rn(x, c.unit) - 0.5f + c.pad, 0.0f, c.px_hi);
  const float py = clamp2(__fdiv_rn(y, c.unit) - 0.5f + c.pad, 0.0f, c.py_hi);
  const float bx = floorf(px);
  const float by = floorf(py);
  const float tx = px - bx;
  const float ty = py - by;
  const int64_t base = ((int64_t)d * hp + (int64_t)by) * wp + (int64_t)bx;
  const int64_t last = n_rows - 1;
  const float4* r4 = reinterpret_cast<const float4*>(rows);
  const int64_t i00 = clip_row(base, last), i01 = clip_row(base + 1, last);
  const int64_t i10 = clip_row(base + wp, last);
  const int64_t i11 = clip_row(base + wp + 1, last);
  const float4 a0 = r4[2 * i00], a1 = r4[2 * i00 + 1];
  const float4 b0 = r4[2 * i01], b1 = r4[2 * i01 + 1];
  const float4 c0 = r4[2 * i10], c1 = r4[2 * i10 + 1];
  const float4 d0 = r4[2 * i11], d1 = r4[2 * i11 + 1];
  const float v00[6] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y};
  const float v01[6] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y};
  const float v10[6] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y};
  const float v11[6] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y};
  float v[6];
#pragma unroll
  for (int ch = 0; ch < 6; ++ch) {
    const float top = v00[ch] + tx * (v01[ch] - v00[ch]);
    const float bot = v10[ch] + tx * (v11[ch] - v10[ch]);
    v[ch] = top + ty * (bot - top);
  }

  // forces.safe_normalize of the potential's gradient
  const float g2 = v[1] * v[1] + v[2] * v[2];
  const float norm = sqrtf(g2 < c.eps ? c.eps : g2);  // NaN passes
  const float ex = __fdiv_rn(v[1], norm);
  const float ey = __fdiv_rn(v[2], norm);

  // despawn, then neighbor.compute_cell_ids; its sentinel is the in-grid test
  const bool arrived_not = active[a * s.active] != 0 && v[0] > c.despawn;
  const float cx = floorf(__fdiv_rn(x, c.cell_unit));
  const float cy = floorf(__fdiv_rn(y, c.cell_unit));
  const bool ok = arrived_not && cx >= 0.0f && cx < (float)nx && cy >= 0.0f &&
                  cy < (float)ny;
  cid[a] = ok ? (int)cy * nx + (int)cx : nx * ny;

  float vx = vel[a * s.vel0];
  float vy = vel[a * s.vel0 + s.vel1];
  float sp = speed[a * s.speed];
  if (sanitizing) {
    vx = sanitize(vx);
    vy = sanitize(vy);
    sp = sanitize(sp);
  }
  float4* out = reinterpret_cast<float4*>(packed + a * 12);
  out[0] = make_float4(x, y, vx, vy);
  out[1] = make_float4(sp, (float)d, ok ? 1.0f : 0.0f, ex);
  out[2] = make_float4(ey, v[3], v[4], v[5]);
}

}  // namespace

// strides: the 7 AgentStrides in elements, in order; consts: the 7
// SampleConsts floats (kernels/flat_sample.py::sample_constants).  Returns a
// cudaError_t, -1 for arguments it does not take, or PEDONI_WRONG_DEVICE
// (device.cuh) for rows off the current device.
extern "C" int pedoni_flat_sample(const float* pos, const float* vel,
                                  const float* speed, const int* dest,
                                  const unsigned char* active, const float* rows,
                                  float* packed, int* cid, int64_t n,
                                  int64_t n_rows, int hp, int wp, int nx, int ny,
                                  int sanitizing, const int64_t* strides,
                                  const float* consts, void* stream) {
  if (const int w = pedoni_on_current_device(rows)) return w;
  if (n < 1 || n_rows < 1 || hp < 2 || wp < 2 || nx < 1 || ny < 1 ||
      (int64_t)nx * ny >= 2147483647LL)
    return -1;
  AgentStrides s;
  s.pos0 = strides[0];
  s.pos1 = strides[1];
  s.vel0 = strides[2];
  s.vel1 = strides[3];
  s.speed = strides[4];
  s.dest = strides[5];
  s.active = strides[6];
  SampleConsts c;
  c.unit = consts[0];
  c.px_hi = consts[1];
  c.py_hi = consts[2];
  c.pad = consts[3];
  c.despawn = consts[4];
  c.cell_unit = consts[5];
  c.eps = consts[6];
  constexpr int kThreads = 256;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  flat_sample_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      pos, vel, speed, dest, active, rows, packed, cid, n, n_rows, hp, wp, nx,
      ny, sanitizing, s, c);
  return (int)cudaGetLastError();
}
