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
//                          bool: any strides (the flat step's state is
//                          flat_integrate's pos and vel and flat_scatter's
//                          contiguous speed; the strips' speed is a column
//                          of their compacted rows)
//   rows [R, 8] f32        sampling.DeviceField.rows: one row a texel of
//                          a waypoint plane, ch 0 potential, 1-2 its
//                          Sobel, 3 obstacle distance, 4-5 its Sobel;
//                          16-byte aligned
//   packed [N, 12] f32     0:2 pos, 2:4 vel, 4 speed, 5 dest, 6 alive, 7:9
//                          the goal direction e, 9 obstacle distance,
//                          10:12 its Sobel
//   cid [N] i32            the cell id, nx * ny for a dead agent
//
// Each agent's arithmetic mirrors the twin op by op, each op rounded to f32
// as PyTorch rounds it, no fused multiply-add (--fmad=false):
//   px = clamp(x / unit - 0.5 + PAD, 0, wp - 1.001) with an IEEE divide
//   (__fdiv_rn; neighbor.true_divide), likewise py; clamps that pass NaN
//   through as torch.clamp does; base = (dest * hp + floor(py)) * wp +
//   floor(px) in 64 bits, each of the four taps clamped into [0, R - 1]
//   (the reference's take(mode="clip")); the lerps top, bot, v channel by
//   channel in the twin's order; e = g / sqrt(clamp(gx*gx + gy*gy, EPS))
//   with IEEE divides; alive = active & (potential > despawn) & in the
//   grid, the cell id from the IEEE divide by the cell unit
//   (neighbor.compute_cell_ids); vel and speed at or past 2^30 in
//   magnitude, or NaN, become 2^30 when sanitizing.  So kernel and twin
//   agree bit for bit.
//
// What bounds it on the card (NVIDIA H100 80GB HBM3, 700 W): the bytes,
// ~170 an agent (25 of state, four texel rows of which 24 bytes are used,
// 52 out), ~0.05 ms at 1M agents.  The taps are scattered: at 1M they
// touch ~3-4 M texel rows, each its own 32-byte sector (sample_phases.py
// counts them).  The design, from sample_phases.py's cut-down builds of
// the one-thread-an-agent kernel before it: its row stores (three float4
// a thread at a 48-byte stride) wrote their 54.5 MB at 1.4 TB/s, and a
// state read at the rows' 48-byte stride (the speed column) cost ~13 us.
// So each thread takes kAgents agents and issues all their state loads,
// then all their tap loads, before any arithmetic, so the two dependent
// trips to memory of one agent overlap the other's; state loads stream
// past L1 and taps stay L1-cached (neighbours in cell order share texel
// rows); each warp stages its 32 rows in shared memory and writes them as
// whole 128-byte lines with streaming stores.  So built it takes 0.090 ms
// at 1M (sample_phases.py), the rate of a copy_ for what the card
// fetches: its taps touch 64-byte pieces, not the 24 bytes a texel that
// the bound counts.  The twin is ~60 launches of element-wise code and
// four 1M-row gathers, ~3 ms at 1M on the card.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kAgents = 2;  // agents a thread
constexpr int kBlockAgents = kThreads * kAgents;

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

// An agent's state word, read once: streamed past L1.
template <typename T>
__device__ __forceinline__ T load_state(const T* p) {
  return __ldcs(p);
}

// An output word, written once and read by the next kernel: streamed.
template <typename T>
__device__ __forceinline__ void store_out(T* p, T v) {
  __stcs(p, v);
}

__device__ __forceinline__ float lerp(float a, float b, float t) {
  return a + t * (b - a);
}

// A block takes kBlockAgents agents from b0 (and, in a grid smaller than
// the agents, those a grid's worth on); its thread t takes agents b0 + j *
// kThreads + t, j < kAgents, so each load and store of a warp is
// contiguous.  Three passes over the thread's agents: every state load;
// every tap (clamped into the rows; an agent past n reads agent 0's and
// writes nothing); then the arithmetic, each warp staging its 32 rows in
// shared memory and writing them as whole lines.
__global__ void __launch_bounds__(kThreads)
flat_sample_kernel(const float* __restrict__ pos, const float* __restrict__ vel,
                   const float* __restrict__ speed, const int* __restrict__ dest,
                   const unsigned char* __restrict__ active,
                   const float* __restrict__ rows, float* __restrict__ packed,
                   int* __restrict__ cid, int64_t n, int64_t n_rows, int hp,
                   int wp, int nx, int ny, int sanitizing, AgentStrides s,
                   SampleConsts c) {
  __shared__ float4 stage[kWarps][32 * 3];
  const int lane = threadIdx.x & 31;
  float4* const st = stage[threadIdx.x >> 5];
  const int64_t last = n_rows - 1;
  const float4* r4 = reinterpret_cast<const float4*>(rows);
  for (int64_t b0 = (int64_t)blockIdx.x * kBlockAgents; b0 < n;
       b0 += (int64_t)gridDim.x * kBlockAgents) {
    float x[kAgents], y[kAgents], vx[kAgents], vy[kAgents], sp[kAgents];
    int d[kAgents];
    unsigned char act[kAgents];
#pragma unroll
    for (int j = 0; j < kAgents; ++j) {
      const int64_t a = b0 + j * kThreads + threadIdx.x;
      const int64_t i = a < n ? a : 0;
      x[j] = load_state(pos + i * s.pos0);
      y[j] = load_state(pos + i * s.pos0 + s.pos1);
      d[j] = load_state(dest + i * s.dest);
      vx[j] = load_state(vel + i * s.vel0);
      vy[j] = load_state(vel + i * s.vel0 + s.vel1);
      sp[j] = load_state(speed + i * s.speed);
      act[j] = load_state(active + i * s.active);
    }

    // sampling.sample_field: the four taps' ch 0-3 (float4) and 4-5
    float4 lo[kAgents][4];
    float2 hi[kAgents][4];
    float tx[kAgents], ty[kAgents];
#pragma unroll
    for (int j = 0; j < kAgents; ++j) {
      const float px = clamp2(__fdiv_rn(x[j], c.unit) - 0.5f + c.pad, 0.0f, c.px_hi);
      const float py = clamp2(__fdiv_rn(y[j], c.unit) - 0.5f + c.pad, 0.0f, c.py_hi);
      const float bx = floorf(px);
      const float by = floorf(py);
      tx[j] = px - bx;
      ty[j] = py - by;
      const int64_t base = ((int64_t)d[j] * hp + (int64_t)by) * wp + (int64_t)bx;
      const int64_t tap[4] = {clip_row(base, last), clip_row(base + 1, last),
                              clip_row(base + wp, last),
                              clip_row(base + wp + 1, last)};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        lo[j][q] = __ldg(r4 + 2 * tap[q]);
        hi[j][q] = __ldg(reinterpret_cast<const float2*>(r4 + 2 * tap[q] + 1));
      }
    }

#pragma unroll
    for (int j = 0; j < kAgents; ++j) {
      // the lerps top, bot, v channel by channel in the twin's order; taps
      // 0-3 are (x, y), (x + 1, y), (x, y + 1), (x + 1, y + 1)
      const float t[4][6] = {
          {lo[j][0].x, lo[j][0].y, lo[j][0].z, lo[j][0].w, hi[j][0].x, hi[j][0].y},
          {lo[j][1].x, lo[j][1].y, lo[j][1].z, lo[j][1].w, hi[j][1].x, hi[j][1].y},
          {lo[j][2].x, lo[j][2].y, lo[j][2].z, lo[j][2].w, hi[j][2].x, hi[j][2].y},
          {lo[j][3].x, lo[j][3].y, lo[j][3].z, lo[j][3].w, hi[j][3].x, hi[j][3].y}};
      float v[6];
#pragma unroll
      for (int ch = 0; ch < 6; ++ch) {
        const float top = lerp(t[0][ch], t[1][ch], tx[j]);
        const float bot = lerp(t[2][ch], t[3][ch], tx[j]);
        v[ch] = lerp(top, bot, ty[j]);
      }

      // forces.safe_normalize of the potential's gradient
      const float g2 = v[1] * v[1] + v[2] * v[2];
      const float norm = sqrtf(g2 < c.eps ? c.eps : g2);  // NaN passes
      const float ex = __fdiv_rn(v[1], norm);
      const float ey = __fdiv_rn(v[2], norm);

      // despawn, then neighbor.compute_cell_ids; its sentinel is the
      // in-grid test
      const bool arrived_not = act[j] != 0 && v[0] > c.despawn;
      const float cx = floorf(__fdiv_rn(x[j], c.cell_unit));
      const float cy = floorf(__fdiv_rn(y[j], c.cell_unit));
      const bool ok = arrived_not && cx >= 0.0f && cx < (float)nx && cy >= 0.0f &&
                      cy < (float)ny;
      float wx = vx[j], wy = vy[j], w = sp[j];
      if (sanitizing) {
        wx = sanitize(wx);
        wy = sanitize(wy);
        w = sanitize(w);
      }

      // the warp's 32 rows through shared memory (48-byte rows: a quarter
      // warp's float4 stores hit distinct banks), out as whole lines
      st[3 * lane] = make_float4(x[j], y[j], wx, wy);
      st[3 * lane + 1] = make_float4(w, (float)d[j], ok ? 1.0f : 0.0f, ex);
      st[3 * lane + 2] = make_float4(ey, v[3], v[4], v[5]);
      __syncwarp();
      const int64_t w0 = b0 + j * kThreads + (threadIdx.x & ~31);
      const int64_t m = n - w0 < 32 ? n - w0 : 32;  // the warp's agents, may be <= 0
      float4* out = reinterpret_cast<float4*>(packed) + w0 * 3;
      for (int q = lane; q < 3 * m; q += 32) store_out(out + q, st[q]);
      __syncwarp();
      const int64_t a = w0 + lane;
      if (a < n) store_out(cid + a, ok ? (int)cy * nx + (int)cx : nx * ny);
    }
  }
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
  const int64_t blocks = (n + kBlockAgents - 1) / kBlockAgents;
  flat_sample_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      pos, vel, speed, dest, active, rows, packed, cid, n, n_rows, hp, wp, nx,
      ny, sanitizing, s, c);
  return (int)cudaGetLastError();
}
