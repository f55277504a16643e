// Fused step kernel: field sampling, despawn, goal, obstacle and pair
// forces, and integration over the cell-resident grid.
//
// Replaces pedoni_tpu/ops/pallas/step_kernel.py::fused_step_kernel
// (pallas_call at step_kernel.py:898; bodies _kernel :162 and _compute :367)
// in its base mode, its emit_movers mode (_mover_pass :717) and its
// segments mode (_segment_accel :104, used at :553-557): one waypoint plane
// per agent, obstacles from the distance map or from the exact segment
// geometry, no slot split.  Plain PyTorch twin:
// pedoni_tpu_torch/ops/kernels/step_kernel.py::fused_step_torch.
//
// Layouts (all f32, contiguous):
//   d    [ny2, K, 8, NXL]  ch 0 pos.x, 1 pos.y, 2 vel.x, 3 vel.y, 4 speed,
//                          5 dest, 6 active, 7 cell count (valid at slot 0)
//   fwp  [n_wp, R, S, 4, NXL], fobs [R, S, 4, NXL]  (fields6 layout:
//                          F[f, c, ch, l] = map[f - S, S*(l-1) + c])
//   segs [n_seg, 22]       segments mode only: the obstacle edge table of
//                          step_kernel.py::segment_table (fobs unread)
//   out  [ny2, K, 8, NXL]  ghost rows 0 and ny2-1 zero; ch 7 = potential,
//                          or the stay mask in the mover mode
//   m    [ny2, MK, 8, NXL] mover mode only: each cell's movers in slot
//                          order, ch 6 = row < movers, ch 7 = min(movers, MK)
//   movf, mdmx [nb]        mover mode only, per block of rb cell rows:
//                          sum(max(movers - MK, 0)) and the peak mover count
//
// What bounds it on the card: device-memory traffic and load latency.  Per
// agent slot pass A reads 7 channels and 24 field taps; pass B reads the 9
// neighbour cells' candidates (~5 loads each, mostly from L1/L2 since
// neighbouring lanes share them) — about 1 FLOP per byte from device
// memory, far under the H100's compute line.
//
// Segments mode (the reference's --no-distance-map debug mode) is a
// compile-time template parameter of pass A, so the distance-map
// instantiation keeps its code and its registers.  The segment
// instantiation replaces the obstacle-plane sample by a walk over the edge
// table, for centre slots whose post-despawn act is set (pass B reads the
// force of no other slot).  Every thread of a warp reads the same table
// row, so each load is one broadcast; the table stays in device memory (a
// 1000-obstacle scenario needs 88 KB, more than constant memory holds).
// That walk is bound by operations: ~100 float operations per (active
// agent, obstacle).  Divisions are IEEE and expf the accurate one (the
// build has no fast math), as the twin's.
//
// The simple design: one thread per agent slot (row, k, lane), lanes
// fastest so every channel read of a warp is one coalesced 128-byte line.
// The pair force of a centre agent needs every candidate's POST-despawn
// active flag, which comes from sampling the candidate's own potential; one
// launch cannot see that without a grid-wide barrier, so the step is two
// launches:
//   pass A  every slot of rows 0..ny2-1: sanitize, sample, despawn, goal and
//           obstacle force -> scratch [6, ny2, K, NXL]
//           (act', e.x, e.y, acc.x, acc.y, potential);
//   pass B  every slot: pair force over the 3x3 cells' candidate slots
//           (slot j outer, then dy, then dx — the reference's summation
//           order), integration, output.  Ghost rows write zeros.
// Inactive centre slots skip the pair loop: their outputs are keep-gated
// pass-through in the reference, so the force would be discarded.
// A candidate slot j counts only below its cell's count (ch 7, slot 0),
// which replaces the reference's per-block jmax bound.  After an
// incremental rebin that channel is the cell's top occupied slot + 1 and
// the slots below it may hold holes; the post-despawn act test skips them.
//
// Mover mode (MK > 0, feeding rebin_incremental.cu): passes A and B run
// as in the base mode, then a third launch, one thread per cell, walks
// the cell's K output slots in order.  It overwrites ch 7 with the stay
// mask act' * same, same = [the integrated position's cell is this cell]
// (step_kernel.py:697-714), and writes the movers — act' * (1 - same) >
// 0.5 — to rows 0, 1, ... of M; movers beyond MK are counted in movf only
// (the step then takes the full rebin).  The cell test is the IEEE divide
// __fdiv_rn, the one both rebins use, so a stay mask and a rebin never
// disagree at a cell boundary.  The classification lives in this launch,
// not in pass B: there it raised pass B's registers from 80 to 90 and cut
// its occupancy, which cost ~0.18 ms of pass B time at 1M agents (NVIDIA
// H100 80GB HBM3, 700 W) against ~0.06 ms for this launch.  The TPU's one-hot MAC walk
// bounded by jmax is not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair.cuh"

namespace {

constexpr float kBig = 1073741824.0f;  // 2^30 sanitize sentinel
constexpr int kRow0 = 3;               // fields6.ROW0
constexpr float kFpad = 4.0f;          // field-map PAD rings
constexpr int kSegCols = 22;           // step_kernel.py SEG_COLS

struct StepConsts {
  float inv_unit;          // 1 / field_unit
  float grid_w, grid_h;    // world size (m) for the out-of-grid despawn
  float despawn_potential;
  float relaxation_time;
  float obs_strength, obs_range;
  float dt, dt_half;       // delta_time, 0.5 * delta_time
  float max_speed_factor;
  PairConsts pair;
  float cell_unit;         // stride * field_unit: the mover mode's cell size
};

struct Dims {
  int ny2, k, nxl, n_wp, frows, stride;
};

__device__ __forceinline__ float sanitize(float v) {
  return fabsf(v) < kBig ? v : kBig;  // NaN and -inf map to +2^30 too
}

// Bilinear sample of channels [0, nch) of one fields6 plane at the agent in
// D row `row`, lane `lane`.  Taps exist only inside the cell's (S+2)^2
// patch; a tap outside it contributes 0 (not the map value there), exactly
// as the reference's masked 8x8 patch walk (step_kernel.py:64-101).
// Summation order (qy outer, qx inner) matches the reference.
__device__ __forceinline__ void sample(const float* __restrict__ plane,
                                       const Dims& dm, int row, int lane,
                                       float px, float py, int nch,
                                       float* outv) {
  const int s = dm.stride;
  const float bx = floorf(px);
  const float by = floorf(py);
  const float tx = px - bx;
  const float ty = py - by;
  const float p0 = bx - (float)(lane - 1) * (float)s - (float)kRow0;
  const float q0 = by - (float)(row - 1) * (float)s - (float)kRow0;
  for (int c = 0; c < nch; ++c) outv[c] = 0.0f;
  const float ext = (float)(s + 1);
  for (int a = 0; a < 2; ++a) {
    const float qy = q0 + (float)a;
    if (!(qy >= 0.0f && qy <= ext)) continue;
    const float wy = a ? ty : 1.0f - ty;
    const int frow = s * row + kRow0 + (int)qy;
    for (int b = 0; b < 2; ++b) {
      const float qx = p0 + (float)b;
      if (!(qx >= 0.0f && qx <= ext)) continue;
      const float w = wy * (b ? tx : 1.0f - tx);
      const int col = kRow0 + (int)qx;
      int l2 = lane + col / s;
      if (l2 >= dm.nxl) l2 -= dm.nxl;  // circular, as the lane roll
      const float* base =
          plane + ((int64_t)(frow * s + col % s) * 4) * dm.nxl + l2;
      for (int c = 0; c < nch; ++c) outv[c] = outv[c] + w * base[(int64_t)c * dm.nxl];
    }
  }
}

// Exact obstacle acceleration at (px, py) from the edge table
// (step_kernel.py:104-159): per obstacle, the closest point of each of the
// widened rectangle's 4 edges (t clipped to [0, 1]), the first minimum by a
// strict < on squared distances, no force inside the rectangle (the
// reference adds coef = 0 there, which changes no sum).  Row layout: for
// edge e, q0.x q0.y s.x s.y il2 at 5e .. 5e+4; then width^2, h^2.
__device__ __forceinline__ void segment_accel(const float* __restrict__ segs,
                                              int n_seg, float px, float py,
                                              const StepConsts& sc, float& ax,
                                              float& ay) {
  for (int o = 0; o < n_seg; ++o) {
    const float* r = segs + (int64_t)o * kSegCols;
    float d2[4], ddx[4], ddy[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float q0x = __ldg(r + 5 * e), q0y = __ldg(r + 5 * e + 1);
      const float sx = __ldg(r + 5 * e + 2), sy = __ldg(r + 5 * e + 3);
      const float il2 = __ldg(r + 5 * e + 4);
      float t = ((px - q0x) * sx + (py - q0y) * sy) * il2;
      t = fminf(fmaxf(t, 0.0f), 1.0f);
      ddx[e] = px - (q0x + t * sx);
      ddy[e] = py - (q0y + t * sy);
      d2[e] = ddx[e] * ddx[e] + ddy[e] * ddy[e];
    }
    const float w2 = __ldg(r + 20), h2 = __ldg(r + 21);
    if (d2[0] < w2 && d2[1] < w2 && d2[2] < h2 && d2[3] < h2) continue;
    float best = d2[0], bdx = ddx[0], bdy = ddy[0];
#pragma unroll
    for (int e = 1; e < 4; ++e) {
      if (d2[e] < best) {
        best = d2[e];
        bdx = ddx[e];
        bdy = ddy[e];
      }
    }
    const float dmin = sqrtf(fmaxf(best, PEDONI_EPS));
    const float coef = sc.obs_strength * expf(-dmin / sc.obs_range) / dmin;
    ax = ax + coef * bdx;
    ay = ay + coef * bdy;
  }
}

template <bool kSeg>
__global__ void step_pass_a(const float* __restrict__ d,
                            const float* __restrict__ fwp,
                            const float* __restrict__ fobs,
                            float* __restrict__ scr, Dims dm, StepConsts sc,
                            const float* __restrict__ segs, int n_seg) {
  const int64_t plane_sz = (int64_t)dm.ny2 * dm.k * dm.nxl;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= plane_sz) return;
  const int lane = (int)(idx % dm.nxl);
  const int64_t rk = idx / dm.nxl;  // row * K + k
  const int row = (int)(rk / dm.k);
  const float* src = d + rk * 8 * dm.nxl + lane;
  const float posx = sanitize(src[0]);
  const float posy = sanitize(src[(int64_t)dm.nxl]);
  const float velx = sanitize(src[(int64_t)2 * dm.nxl]);
  const float vely = sanitize(src[(int64_t)3 * dm.nxl]);
  const float speed = sanitize(src[(int64_t)4 * dm.nxl]);
  const float dest = src[(int64_t)5 * dm.nxl];
  const float act = src[(int64_t)6 * dm.nxl];

  const float px = posx * sc.inv_unit - 0.5f + kFpad;
  const float py = posy * sc.inv_unit - 0.5f + kFpad;
  const bool center = row >= 1 && row <= dm.ny2 - 2;
  const int64_t plane_stride = (int64_t)dm.frows * dm.stride * 4 * dm.nxl;

  // The agent's own destination plane; a dest that names no plane samples
  // 0 (and so despawns), as the reference's dest == plane selects do.
  float pv[3] = {0.0f, 0.0f, 0.0f};
  if (dest >= 0.0f && dest < (float)dm.n_wp && dest == floorf(dest)) {
    sample(fwp + (int64_t)dest * plane_stride, dm, row, lane, px, py,
           center ? 3 : 1, pv);
  }
  const float pot = pv[0];
  const bool in_grid =
      posx >= 0.0f && posx < sc.grid_w && posy >= 0.0f && posy < sc.grid_h;
  const float act_new = (pot > sc.despawn_potential && in_grid) ? act : 0.0f;

  float ex = 0.0f, ey = 0.0f, afx = 0.0f, afy = 0.0f;
  if (center) {
    const float gx = pv[1], gy = pv[2];
    const float g_norm = rsqrtf(fmaxf(gx * gx + gy * gy, PEDONI_EPS));
    ex = gx * g_norm;
    ey = gy * g_norm;
    afx = (ex * speed - velx) / sc.relaxation_time;
    afy = (ey * speed - vely) / sc.relaxation_time;
    if constexpr (kSeg) {
      if (act_new > 0.5f) {
        float sfx = 0.0f, sfy = 0.0f;
        segment_accel(segs, n_seg, posx, posy, sc, sfx, sfy);
        afx = afx + sfx;
        afy = afy + sfy;
      }
    } else {
      float ov[3];
      sample(fobs, dm, row, lane, px, py, 3, ov);
      const float d_norm = rsqrtf(fmaxf(ov[1] * ov[1] + ov[2] * ov[2], PEDONI_EPS));
      const float mag = sc.obs_strength * expf(-ov[0] / sc.obs_range);
      afx = afx - mag * ov[1] * d_norm;
      afy = afy - mag * ov[2] * d_norm;
    }
  }
  scr[idx] = act_new;
  scr[plane_sz + idx] = ex;
  scr[2 * plane_sz + idx] = ey;
  scr[3 * plane_sz + idx] = afx;
  scr[4 * plane_sz + idx] = afy;
  scr[5 * plane_sz + idx] = pot;
}

__global__ void step_pass_b(const float* __restrict__ d,
                            const float* __restrict__ scr,
                            float* __restrict__ out, Dims dm, StepConsts sc) {
  const int64_t plane_sz = (int64_t)dm.ny2 * dm.k * dm.nxl;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= plane_sz) return;
  const int lane = (int)(idx % dm.nxl);
  const int64_t rk = idx / dm.nxl;
  const int row = (int)(rk / dm.k);
  const int k = (int)(rk % dm.k);
  float* dst = out + rk * 8 * dm.nxl + lane;
  if (row == 0 || row == dm.ny2 - 1) {
    for (int c = 0; c < 8; ++c) dst[(int64_t)c * dm.nxl] = 0.0f;
    return;
  }
  const int64_t nxl = dm.nxl;
  const float* src = d + rk * 8 * nxl + lane;
  const float px = sanitize(src[0]);
  const float py = sanitize(src[nxl]);
  const float velx = sanitize(src[2 * nxl]);
  const float vely = sanitize(src[3 * nxl]);
  const float speed = sanitize(src[4 * nxl]);
  const float act_c = scr[idx];
  float npx = px, npy = py, nvx = velx, nvy = vely;

  if (act_c > 0.5f) {
    const float ex = scr[plane_sz + idx];
    const float ey = scr[2 * plane_sz + idx];
    float accx = scr[3 * plane_sz + idx];
    float accy = scr[4 * plane_sz + idx];
    // Counts of the 3x3 neighbour cells; lanes outside [0, NXL) hold no
    // cell (lane 0 and lanes past nx+1 are empty, so this gives what the
    // reference's circular roll gives).
    float cnt[9];
    int cmax = 0;
    for (int dy = -1; dy <= 1; ++dy) {
      for (int dx = -1; dx <= 1; ++dx) {
        const int l2 = lane + dx;
        float cv = 0.0f;
        if (l2 >= 0 && l2 < dm.nxl)
          cv = d[(((int64_t)(row + dy) * dm.k) * 8 + 7) * nxl + l2];
        cnt[(dy + 1) * 3 + dx + 1] = cv;
        const int ci = cv > (float)dm.k ? dm.k : (cv > 0.0f ? (int)ceilf(cv) : 0);
        cmax = ci > cmax ? ci : cmax;
      }
    }
    for (int j = 0; j < cmax; ++j) {
      for (int dy = -1; dy <= 1; ++dy) {
        const int64_t rk2 = (int64_t)(row + dy) * dm.k + j;
        for (int dx = -1; dx <= 1; ++dx) {
          const int l2 = lane + dx;
          if (!((float)j < cnt[(dy + 1) * 3 + dx + 1])) continue;
          if (dy == 0 && dx == 0 && j == k) continue;  // self
          if (!(scr[rk2 * nxl + l2] > 0.5f)) continue;  // post-despawn act
          const float* cs = d + rk2 * 8 * nxl + l2;
          pair_accum(accx, accy, px, py, ex, ey, sanitize(cs[0]),
                     sanitize(cs[nxl]), sanitize(cs[2 * nxl]),
                     sanitize(cs[3 * nxl]), sc.pair);
        }
      }
    }
    // Trapezoidal integration with the speed clamp (sfm.rs:245-254).
    float vx = velx + accx * sc.dt;
    float vy = vely + accy * sc.dt;
    const float vmax = speed * sc.max_speed_factor;
    const float vlen = sqrtf(fmaxf(vx * vx + vy * vy, PEDONI_EPS));
    const float scale = fminf(1.0f, vmax / vlen);
    vx = vx * scale;
    vy = vy * scale;
    npx = px + (vx + velx) * sc.dt_half;
    npy = py + (vy + vely) * sc.dt_half;
    nvx = vx;
    nvy = vy;
  }
  dst[0] = npx;
  dst[nxl] = npy;
  dst[2 * nxl] = nvx;
  dst[3 * nxl] = nvy;
  dst[4 * nxl] = speed;
  dst[5 * nxl] = src[5 * nxl];
  dst[6 * nxl] = act_c;
  dst[7 * nxl] = scr[5 * plane_sz + idx];
}

// One thread per cell (row, lane) of pass B's output G: ch 7 becomes the
// stay mask, and the cell's movers, walked in slot order, fill rows 0, 1,
// ... of M with their post-step ch 0-5 (step_kernel.py:697-749).  Per-block
// movf/mdmx by warp shuffles and one atomic per warp; the values are
// integers, exact in any order.
__global__ void step_movers(float* __restrict__ g,
                            float* __restrict__ m, float* __restrict__ movf,
                            float* __restrict__ mdmx, Dims dm, int mk, int rb,
                            float cell_unit) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y;  // every thread of a block shares its row
  if (lane >= dm.nxl) return;
  const int64_t nxl = dm.nxl;
  const int64_t sk = 8 * nxl;  // slot stride
  float* dst = m + (int64_t)row * mk * sk + lane;
  if (row == 0 || row == dm.ny2 - 1) {
    for (int r = 0; r < mk; ++r)
      for (int c = 0; c < 8; ++c) dst[r * sk + c * nxl] = 0.0f;
    return;
  }
  float* src = g + (int64_t)row * dm.k * sk + lane;
  int cnt = 0;
  for (int j = 0; j < dm.k; ++j) {
    float* cs = src + j * sk;
    const float act = cs[6 * nxl];
    const float tgt_lane = floorf(__fdiv_rn(cs[0], cell_unit)) + 1.0f;
    const float tgt_row = floorf(__fdiv_rn(cs[nxl], cell_unit));
    const float same =
        (tgt_lane == (float)lane && tgt_row == (float)(row - 1)) ? 1.0f : 0.0f;
    cs[7 * nxl] = act * same;
    if (!(act * (1.0f - same) > 0.5f)) continue;
    if (cnt < mk) {
      float* o = dst + cnt * sk;
      for (int c = 0; c < 6; ++c) o[c * nxl] = cs[c * nxl];
    }
    ++cnt;
  }
  const int kept = cnt < mk ? cnt : mk;
  for (int r = 0; r < mk; ++r) {
    float* o = dst + r * sk;
    if (r >= kept)
      for (int c = 0; c < 6; ++c) o[c * nxl] = 0.0f;
    o[6 * nxl] = r < cnt ? 1.0f : 0.0f;
    o[7 * nxl] = (float)kept;
  }
  float over = (float)(cnt > mk ? cnt - mk : 0);
  int peak = cnt;
  const unsigned mask = 0xffffffffu;  // full warps: NXL % 128 == 0
  for (int off = 16; off > 0; off >>= 1) {
    over += __shfl_down_sync(mask, over, off);
    const int p2 = __shfl_down_sync(mask, peak, off);
    peak = p2 > peak ? p2 : peak;
  }
  if ((threadIdx.x & 31) == 0) {
    const int b = (row - 1) / rb;
    if (over != 0.0f) atomicAdd(movf + b, over);
    // non-negative floats order as their bit patterns do
    if (peak > 0) atomicMax((int*)(mdmx + b), __float_as_int((float)peak));
  }
}

}  // namespace

// consts: 18 floats in StepConsts order (see step_kernel.py::_constants).
// mk == 0 is the base mode (m, movf, mdmx unused); mk > 0 the mover mode,
// where movf and mdmx [nb] must be zeroed by the caller.  n_seg < 0 takes
// the obstacle force from fobs (segs unused); n_seg >= 0 from the n_seg
// rows of segs.
extern "C" int pedoni_step_kernel(const float* d, const float* fwp,
                                  const float* fobs, const float* segs,
                                  float* scratch, float* out, float* m,
                                  float* movf, float* mdmx, int ny2, int k,
                                  int nxl, int n_wp, int frows, int stride,
                                  int mk, int rb, int n_seg,
                                  const float* consts, void* stream) {
  StepConsts sc;
  sc.inv_unit = consts[0];
  sc.grid_w = consts[1];
  sc.grid_h = consts[2];
  sc.despawn_potential = consts[3];
  sc.relaxation_time = consts[4];
  sc.obs_strength = consts[5];
  sc.obs_range = consts[6];
  sc.dt = consts[7];
  sc.dt_half = consts[8];
  sc.max_speed_factor = consts[9];
  sc.pair.cutoff_sq = consts[10];
  sc.pair.dt = consts[11];
  sc.pair.dt2 = consts[12];
  sc.pair.half_strength = consts[13];
  sc.pair.neg_half_inv_range = consts[14];
  sc.pair.cos2 = consts[15];
  sc.pair.fov_damping = consts[16];
  sc.cell_unit = consts[17];
  Dims dm{ny2, k, nxl, n_wp, frows, stride};
  const int64_t n = (int64_t)ny2 * k * nxl;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t st = (cudaStream_t)stream;
  if (n_seg < 0)
    step_pass_a<false><<<blocks, threads, 0, st>>>(d, fwp, fobs, scratch, dm,
                                                   sc, segs, n_seg);
  else
    step_pass_a<true><<<blocks, threads, 0, st>>>(d, fwp, fobs, scratch, dm,
                                                  sc, segs, n_seg);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  step_pass_b<<<blocks, threads, 0, st>>>(d, scratch, out, dm, sc);
  e = cudaGetLastError();
  if (e != cudaSuccess || mk == 0) return (int)e;
  const int mthreads = 128;
  dim3 grid((unsigned)((nxl + mthreads - 1) / mthreads), (unsigned)ny2);
  step_movers<<<grid, mthreads, 0, st>>>(out, m, movf, mdmx, dm, mk, rb,
                                         sc.cell_unit);
  return (int)cudaGetLastError();
}
