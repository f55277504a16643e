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
// acceleration, active or not (an idle slot's, at the position it holds,
// is the reference's too; no caller reads it); a candidate counts where
// its ch 6 > 0.5, its squared distance <= the cutoff's, and it is not the
// slot itself (block 4, slot i); candidates come in forcepass._OFFSETS
// order (dy outer, dx inner), then slot j, and each slot's sum starts at
// +0 and takes them one add at a time.  The arithmetic is
// forces.pair_terms term by term in its f32 order: sqrtf, IEEE divides
// (__fdiv_rn), expf, the FOV test ex*(-fx) + ey*(-fy) >= |f| cos_phi, no
// fused multiply-add (--fmad=false), and clamps that pass NaN through as
// torch.clamp does.  The candidate's v.x dt, v.y dt and (|v| dt)^2 are the
// same f32 values for every centre, so they are computed once a staged
// slot.  A masked candidate is skipped: a sum that starts at +0 is never -0
// under round-to-nearest, so adding the twin's +0 leaves it unchanged, NaN
// and inf included.  So kernel and twin agree bit for bit.
//
// What bounds it on the card (NVIDIA H100 80GB HBM3): instruction issue.
// A pair within the cutoff costs ~60 float operations, several of them
// multi-instruction (four IEEE divides, three sqrtf, an accurate expf).
// The bytes are few: the grid is read once from device memory (its halo
// again from L2) and the output written once.
//
// The design is step_pairs' (step_kernel.cu): one block per tile of tr x tc
// cells of the padded grid (flat_tile: the first of kTiles whose shared
// memory fits 64 KB, 4 x 8 at K 14, 1 x 1 at K 255, whose 3 x 3 cells of
// 255 slots still fit, so no chunked staging is needed).
//   1. stage: every slot of the tile and its one-cell halo, read once with
//      coalesced loads, into shared memory as structure of arrays: pos.x,
//      pos.y (NaN for an inactive slot, so that its distance test fails as
//      the twin's active mask does), v.x dt, v.y dt, (|v| dt)^2; each
//      cell's top active slot + 1 (the pair loop stops there); and, in the
//      same pass, by warp ballots, the list of the tile's interior slots,
//      cell by cell in slot order: the active ones first, then the idle
//      ones, so that the warps that hold agents hold nothing else and
//      neighbouring threads share their 9 cells.  Then each halo cell's
//      bounding box of active positions.  An idle slot in the flat step's
//      grid holds zeros: its phantom at (0, 0) is past the cutoff of every
//      window cell's box away from that corner, so its walk is 9 box tests
//      (box_past_cutoff: a cull that drops only candidates that add +0).
//   2. pairs: one thread per listed slot, its position and e read once
//      from device memory, in rounds: a light part walks the slot's window
//      on (the _OFFSETS order, then slot j, skipping a cell whose box lies
//      past the cutoff) with the distance test alone, until it holds kHits
//      candidates within the cutoff, listed in shared memory; a heavy part
//      evaluates pair_term of the r-th listed candidate of every lane
//      together, r up to the warp's longest list, so the lanes run the
//      expensive body together across window cells (a round per window
//      cell leaves a lane idle whenever its own cell holds fewer hits than
//      its warp's busiest, which at the 1M problem's density is most of
//      the time; a block-wide list of (agent, candidate) pairs, with the
//      terms summed per agent afterwards, was slower for its barriers).
//      Each slot's terms are added in its walk's order.  The sum goes to the tile's
//      slot in shared memory; a ring slot keeps +0.
//   3. output: the tile's slots as whole rows of cells, coalesced.
// The first design ran one thread per slot of a 2 x 16 tile: two thirds
// of its lanes held an empty slot and idled through their warp's walks,
// and each fetched every candidate from L1/L2 again (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "device.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kHits = 32;  // a thread's pairs within the cutoff a round
constexpr unsigned kFullWarp = 0xffffffffu;
// tile shapes (rows, columns of cells), most preferred first; (1, 1) fits
// kSmemBudget at every K up to 255
constexpr int kTiles[][2] = {{4, 8}, {4, 4}, {2, 4}, {2, 2}, {1, 2}, {1, 1}};
constexpr int kSmemBudget = 64 * 1024;  // a block's; past 48 KB it opts in

struct FlatConsts {
  float cutoff_sq, dt, eps, strength, range, cos_phi, fov_damping;
};

// Dynamic shared memory of a tr x tc tile, in the order laid out in
// flat_pairwise_tile: each halo cell's box (float4), each tile slot's
// acceleration (float2), five floats a halo slot, each halo cell's top
// slot, the warps' counts, each tile slot's list entry (u16) and kHits u16
// candidates a thread.
inline int flat_smem_bytes(int tr, int tc, int k, int threads) {
  const int halo = (tr + 2) * (tc + 2);
  const int slots = tr * tc * k;
  return 16 * halo + 8 * slots + 20 * halo * k + 4 * halo + 4 * 32 +
         2 * slots + 2 * kHits * threads;
}

// The launch at K (1..255): the first of kTiles whose shared memory fits
// kSmemBudget, with threads for every slot of the tile up to kMaxThreads,
// a multiple of 32.  The halo's slots stay below 2^16 (the list is u16).
inline void flat_tile(int k, int& tr, int& tc, int& threads) {
  for (const auto& t : kTiles) {
    tr = t[0];
    tc = t[1];
    threads = (tr * tc * k + 31) / 32 * 32;
    if (threads > kMaxThreads) threads = kMaxThreads;
    if (flat_smem_bytes(tr, tc, k, threads) <= kSmemBudget) return;
  }
}

// torch.clamp(x, min=lo): a NaN passes through (fmaxf would drop it).
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

// forces.norm2: sqrt(clamp(x*x + y*y, EPS)).
__device__ __forceinline__ float norm2(float x, float y, float eps) {
  return sqrtf(clamp_min(x * x + y * y, eps));
}

// Whether no candidate of a cell whose active positions lie in box (x0,
// x1, y0, y1) can pass the cutoff test from (px, py): the rounded
// g = max(px - x1, x0 - px, 0) per axis is at most the rounded |px - x| of
// every candidate (rounding is monotone), so fl(gx*gx) + fl(gy*gy), rounded,
// is at most every candidate's d2 as the test computes it; a NaN anywhere
// only makes the cull fail, never pass.  Skipping such a cell drops only
// candidates that add +0: it is bit-neutral.
__device__ __forceinline__ bool box_past_cutoff(float px, float py, float4 b,
                                                const FlatConsts& c) {
  const float gx = fmaxf(fmaxf(px - b.y, b.x - px), 0.0f);
  const float gy = fmaxf(fmaxf(py - b.w, b.z - py), 0.0f);
  return gx * gx + gy * gy > c.cutoff_sq;
}

// forces.pair_terms of one pair within the cutoff, before the mask; the
// candidate's velocity as vxdt = v.x dt, vydt = v.y dt, vdt2 = (|v| dt)^2.
__device__ __forceinline__ void pair_term(float dx, float dy, float d2,
                                          float vxdt, float vydt, float vdt2,
                                          float ex, float ey,
                                          const FlatConsts& c, float& fx,
                                          float& fy) {
  const float d = sqrtf(clamp_min(d2, c.eps));
  const float t1x = dx - vxdt;
  const float t1y = dy - vydt;
  const float t1_len = norm2(t1x, t1y, c.eps);
  const float t2 = d + t1_len;
  const float b = sqrtf(clamp_min(t2 * t2 - vdt2, c.eps)) * 0.5f;
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
                   int ny2, int nx2, int k, int tr, int tc, FlatConsts c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hcols = tc + 2;
  const int nh = (tr + 2) * hcols * k;  // halo slots
  const int nt = tr * tc * k;           // tile slots
  float4* sbox = (float4*)smem_raw;  // [halo cells] x0, x1, y0, y1
  float2* sacc = (float2*)(sbox + (tr + 2) * hcols);  // [nt]
  float* spx = (float*)(sacc + nt);  // [nh] each
  float* spy = spx + nh;
  float* svx = spy + nh;  // v.x dt
  float* svy = svx + nh;  // v.y dt
  float* sv2 = svy + nh;  // (|v| dt)^2
  int* top = (int*)(sv2 + nh);                // [halo cells]
  int* wcnt = top + (tr + 2) * hcols;         // [32]: [0, 16) active, then idle
  unsigned short* list = (unsigned short*)(wcnt + 32);  // [nt] halo slots
  unsigned short* hits = list + nt;  // [kHits][blockDim] each thread's next
                                     // candidates within the cutoff

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int r0 = blockIdx.y * tr;  // the tile's first padded row
  const int c0 = blockIdx.x * tc;
  const float qnan = __int_as_float(0x7fffffff);

  for (int t = tid; t < (tr + 2) * hcols; t += blockDim.x) top[t] = 0;
  for (int t = tid; t < nt; t += blockDim.x) sacc[t] = make_float2(0.0f, 0.0f);
  __syncthreads();

  // 1. stage the halo; list the interior slots of the tile in halo-slot
  // order, the active ones from the front and the idle ones from the back
  int n_live = 0, n_idle = 0;  // the same in every thread
  for (int base = 0; base < nh; base += blockDim.x) {
    const int u = base + tid;
    bool centre = false, idle = false;
    if (u < nh) {
      const int hc = u / k, j = u - hc * k;
      const int hr = hc / hcols, hcol = hc - hr * hcols;
      const int r = r0 - 1 + hr, col = c0 - 1 + hcol;
      float x = qnan, y = qnan, vxdt = 0.0f, vydt = 0.0f, v2 = 0.0f;
      if (r >= 0 && r < ny2 && col >= 0 && col < nx2) {
        const float* q = data + (((int64_t)r * nx2 + col) * k + j) * 8;
        const float4 p = *reinterpret_cast<const float4*>(q);
        const bool interior = hr >= 1 && hr <= tr && hcol >= 1 && hcol <= tc &&
                              r >= 1 && r <= ny2 - 2 && col >= 1 && col <= nx2 - 2;
        if (q[6] > 0.5f) {
          x = p.x;
          y = p.y;
          vxdt = p.z * c.dt;
          vydt = p.w * c.dt;
          const float vdt = norm2(p.z, p.w, c.eps) * c.dt;
          v2 = vdt * vdt;
          atomicMax(&top[hc], j + 1);
          centre = interior;
        } else {
          idle = interior;
        }
      }
      spx[u] = x;
      spy[u] = y;
      svx[u] = vxdt;
      svy[u] = vydt;
      sv2[u] = v2;
    }
    const unsigned bal = __ballot_sync(kFullWarp, centre);
    const unsigned bal_idle = __ballot_sync(kFullWarp, idle);
    if (lane == 0) {
      wcnt[warp] = __popc(bal);
      wcnt[16 + warp] = __popc(bal_idle);
    }
    __syncthreads();
    int before = 0, total = 0, before_idle = 0, total_idle = 0;
    for (int w = 0; w < nwarps; ++w) {
      before += w < warp ? wcnt[w] : 0;
      total += wcnt[w];
      before_idle += w < warp ? wcnt[16 + w] : 0;
      total_idle += wcnt[16 + w];
    }
    const unsigned below = (1u << lane) - 1u;
    if (centre) list[n_live + before + __popc(bal & below)] = (unsigned short)u;
    if (idle)
      list[nt - 1 - (n_idle + before_idle + __popc(bal_idle & below))] =
          (unsigned short)u;
    n_live += total;
    n_idle += total_idle;
    __syncthreads();  // wcnt is written again next round
  }

  // each halo cell's box of active positions (NaN ones left out: they never
  // pass the cutoff test); an empty cell's is empty (x0 = +inf, x1 = -inf)
  for (int t = tid; t < (tr + 2) * hcols; t += blockDim.x) {
    float4 b = make_float4(INFINITY, -INFINITY, INFINITY, -INFINITY);
    for (int j = 0; j < top[t]; ++j) {
      const float x = spx[t * k + j], y = spy[t * k + j];
      b = make_float4(fminf(b.x, x), fmaxf(b.y, x), fminf(b.z, y), fmaxf(b.w, y));
    }
    sbox[t] = b;
  }
  __syncthreads();

  // 2. one thread per listed slot (the active ones first), all lanes of a
  // warp in every round
  for (int base = 0; base < n_live + n_idle; base += blockDim.x) {
    const int li = base + tid;
    const bool has = li < n_live + n_idle;
    const int u = !has ? 0 : li < n_live ? list[li] : list[nt - 1 - (li - n_live)];
    const int hc = u / k, i = u - hc * k;
    const int hr = hc / hcols, hcol = hc - hr * hcols;
    float px = 0.0f, py = 0.0f, ex = 0.0f, ey = 0.0f;
    if (has) {  // an idle slot's position is staged as NaN: read it here
      const float* q = data + (((int64_t)(r0 - 1 + hr) * nx2 + (c0 - 1 + hcol)) * k + i) * 8;
      const float2 p = *reinterpret_cast<const float2*>(q);
      const float2 e = *reinterpret_cast<const float2*>(q + 4);
      px = p.x;
      py = p.y;
      ex = e.x;
      ey = e.y;
    }
    float sx = 0.0f, sy = 0.0f;
    int w = 0, j = 0;  // the walk's next candidate: window cell (_OFFSETS), slot
    bool more = has;
    while (__any_sync(kFullWarp, more)) {
      // light: walk on to the next kHits candidates within the cutoff
      int n = 0;
      while (more && n < kHits) {
        const int cell = (hr - 1 + w / 3) * hcols + hcol - 1 + w % 3;
        if (j >= top[cell] || (j == 0 && box_past_cutoff(px, py, sbox[cell], c))) {
          more = ++w < 9;
          j = 0;
          continue;
        }
        const int v = cell * k + j;
        const float dx = px - spx[v];
        const float dy = py - spy[v];
        if (dx * dx + dy * dy <= c.cutoff_sq && !(w == 4 && j == i))
          hits[n++ * blockDim.x + tid] = (unsigned short)v;
        ++j;
      }
      // heavy: the warp's lanes evaluate their r-th hit together
      const int rounds = __reduce_max_sync(kFullWarp, n);
      for (int r = 0; r < rounds; ++r) {
        if (r < n) {
          const int v = hits[r * blockDim.x + tid];
          const float dx = px - spx[v];
          const float dy = py - spy[v];
          float fx, fy;
          pair_term(dx, dy, dx * dx + dy * dy, svx[v], svy[v], sv2[v], ex, ey,
                    c, fx, fy);
          sx = sx + fx;
          sy = sy + fy;
        }
      }
    }
    if (has) sacc[((hr - 1) * tc + hcol - 1) * k + i] = make_float2(sx, sy);
  }
  __syncthreads();

  // 3. the tile's slots, row by row of cells
  for (int t = tid; t < nt; t += blockDim.x) {
    const int cell = t / k, i = t - cell * k;
    const int trow = cell / tc, tcol = cell - trow * tc;
    const int r = r0 + trow, col = c0 + tcol;
    if (r < ny2 && col < nx2)
      reinterpret_cast<float2*>(acc)[((int64_t)r * nx2 + col) * k + i] = sacc[t];
  }
}

}  // namespace

// The launch flat_pairwise makes at K, for a caller that prints or checks
// it: shape[0..3] = tile rows, tile columns, threads, shared memory bytes.
// Returns -1 for a K outside 1..255, else 0.
extern "C" int pedoni_flat_pairwise_tile(int k, int* shape) {
  if (k < 1 || k > 255) return -1;
  flat_tile(k, shape[0], shape[1], shape[2]);
  shape[3] = flat_smem_bytes(shape[0], shape[1], k, shape[2]);
  return 0;
}

// consts: the 7 FlatConsts floats, in order
// (kernels/flat_pairwise.py::flat_constants).  Returns a cudaError_t, -1 for
// a grid it does not take, or PEDONI_WRONG_DEVICE (device.cuh) for a grid
// off the current device.
extern "C" int pedoni_flat_pairwise(const float* data, float* acc, int ny2,
                                    int nx2, int k, const float* consts,
                                    void* stream) {
  if (const int w = pedoni_on_current_device(data)) return w;
  if (ny2 < 3 || nx2 < 3 || k < 1 || k > 255) return -1;
  int tr, tc, threads;
  flat_tile(k, tr, tc, threads);
  if ((ny2 + tr - 1) / tr > 65535) return -1;
  const int smem = flat_smem_bytes(tr, tc, k, threads);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flat_pairwise_tile, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  FlatConsts c;
  c.cutoff_sq = consts[0];
  c.dt = consts[1];
  c.eps = consts[2];
  c.strength = consts[3];
  c.range = consts[4];
  c.cos_phi = consts[5];
  c.fov_damping = consts[6];
  dim3 grid((unsigned)((nx2 + tc - 1) / tc), (unsigned)((ny2 + tr - 1) / tr));
  flat_pairwise_tile<<<grid, threads, smem, (cudaStream_t)stream>>>(
      data, acc, ny2, nx2, k, tr, tc, c);
  return (int)cudaGetLastError();
}
