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
// is excluded at dy = dx = 0, j = k.  A NaN distance fails the cutoff test
// (pair.cuh), so a NaN position adds nothing where the twin's 0 * NaN
// spreads it.
//
// What bounds it on the card (NVIDIA H100 80GB HBM3, 700 W, the 1M-agent
// bench state): instruction issue, as the fused step's pair pass: ~100
// instructions a pair evaluation (three rsqrtf, an accurate expf, no fused
// multiply-add), ~30 M evaluations.  The first design gave each centre slot
// its own thread over a flat index and walked all 27 K candidate slots from
// L1/L2, with a branch per candidate: one lane in a few did work that
// counted (PERF.md has both designs' times).
//
// The design is step_pairs' (step_kernel.cu), with the reference's order.
// One block per tile of TR rows x 32 lanes of cells (TR, the block size and
// the shared memory come from pairwise.py::pairwise_launch):
//   1. stage: the position and pair_vterms of every slot (row, j) of the
//      tile and its one-cell halo in shared memory (the velocity terms once
//      a candidate, as the reference hoists them, not once a pair),
//      coalesced along the lanes; halo lanes wrap
//      (lane -1 is NX-1, lane 32 of the last tile is 0), rows past ny2-1
//      hold nothing.  A warp's ballot of ch 6 > 0.5 is that row's 34-lane
//      bitmask for slot j.  The box of those candidates' positions (fminf
//      skips NaN) is reduced on the way.
//   2. list: every centre slot of the tile whose position is within the
//      cutoff of that box — a slot further off has no candidate within the
//      cutoff, and its acceleration is +0 — cell by cell, so neighbouring
//      threads share their 9 cells.  The box distance is computed as the
//      cutoff test's distance is (|x - c| >= the box gap, rounding being
//      monotone), so the skip is exact.  Empty slots at (0, 0) cost no
//      thread.
//   3. pairs: one thread per listed slot.  A light part with no branch on
//      the data tests the cutoff of its candidates into 63-bit words of
//      hits, one word a dy row, bit 3 (j - j0) + dx + 1 for slot level j of
//      a chunk of 21 from j0, the self bit cleared; then the lanes that hold
//      a hit pop their lowest bit and run pair_force_vt together.  Where the
//      warp's slot levels fit one word (K <= 21, the bench's 14), a level's
//      9 candidates are tested in one step and the three words popped in dy
//      order; else each dy row's chunks in turn.  Either way the hits come
//      in the reference's order (dy, then j, then dx), so kernel and twin
//      agree bit for bit.
//   4. output: every centre slot of the tile as whole 128-byte rows of
//      lanes, +0 for the slots that were not listed.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair.cuh"

namespace {

constexpr int kTileLanes = 32;  // cells of a tile row: one warp
constexpr int kHaloLanes = kTileLanes + 2;
constexpr int kChunk = 21;      // slot levels a light part: 63 bits
constexpr int kMaxWarps = 32;
constexpr unsigned kFullWarp = 0xffffffffu;

// Shared memory of a block for a tile of `tr` rows at `k` slots, in bytes;
// pairwise.py::pairwise_smem_bytes is the same sum.
__host__ __device__ constexpr int64_t tile_smem_bytes(int tr, int k) {
  const int64_t h = tr + 2, n_tile = (int64_t)tr * k * kTileLanes;
  return 8 * h * k                  // row bitmasks
         + 20 * h * k * kHaloLanes  // staged pos, velocity terms
         + 8 * n_tile               // accelerations of the tile's slots
         + 2 * n_tile               // the slot list
         + 4 * h                    // top candidate slot + 1 per halo row
         + 4 * ((int64_t)tr + 1)    // listed slots per tile row
         + 16 * kMaxWarps;          // per-warp candidate box
}

__global__ void __launch_bounds__(512, 3)
pairwise_tile(const float* __restrict__ d, float* __restrict__ acc, int ny2,
              int K, int nx, int tr, PairConsts pc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int H = tr + 2;
  const int n_halo = H * K * kHaloLanes;
  const int n_tile = tr * K * kTileLanes;
  unsigned long long* rowmask = (unsigned long long*)smem_raw;  // [H][K]
  float* cpx = (float*)(rowmask + H * K);                      // [H][K][34]
  float* cpy = cpx + n_halo;
  float* cvx = cpy + n_halo;  // vel.x dt, vel.y dt, |vel|^2 dt^2
  float* cvy = cvx + n_halo;
  float* cv2 = cvy + n_halo;
  float* rax = cv2 + n_halo;  // [tr][K][32]
  float* ray = rax + n_tile;
  float* wbox = ray + n_tile;           // [kMaxWarps][4]
  int* jtop = (int*)(wbox + 4 * kMaxWarps);  // [H]
  int* rowcnt = jtop + H;               // [tr + 1]
  unsigned short* list = (unsigned short*)(rowcnt + tr + 1);  // [n_tile]

  const int tid = threadIdx.x, t = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int l0 = blockIdx.x * kTileLanes;  // first lane of the tile
  const int row0 = 1 + blockIdx.y * tr;    // first (centre) row of the tile
  const int last = ny2 - 2;                // last centre row
  const int64_t nxl = nx;
  const float inf = __int_as_float(0x7f800000);

  // 1. one warp per (halo row, slot), 34 lanes in two turns (lanes 0, 1 of
  // the warp take halo lanes 32, 33); all loads started before any is used
  float x0 = inf, x1 = -inf, y0 = inf, y1 = -inf;
  for (int it = warp; it < H * K; it += nwarps) {
    const int hr = it / K;
    const int j = it - hr * K;
    const int row = row0 - 1 + hr;
    const bool row_ok = row <= ny2 - 1;
    float v[2][5];
#pragma unroll
    for (int turn = 0; turn < 2; ++turn) {
      const bool mine = turn ? t < 2 : true;
      int lane = l0 - 1 + (turn ? kTileLanes + t : t);
      lane = lane < 0 ? lane + nx : (lane >= nx ? lane - nx : lane);
#pragma unroll
      for (int c = 0; c < 5; ++c) v[turn][c] = 0.0f;
      if (mine && row_ok) {
        const float* cs = d + ((int64_t)row * K + j) * 8 * nxl + lane;
#pragma unroll
        for (int c = 0; c < 4; ++c) v[turn][c] = cs[c * nxl];
        v[turn][4] = cs[6 * nxl];
      }
    }
    unsigned long long mask = 0;
#pragma unroll
    for (int turn = 0; turn < 2; ++turn) {
      const int hl = turn ? kTileLanes + t : t;
      const bool mine = turn ? t < 2 : true;
      const bool valid = mine && v[turn][4] > 0.5f;
      if (mine) {
        const int ci = it * kHaloLanes + hl;
        const float3 vt = pair_vterms(v[turn][2], v[turn][3], pc);
        cpx[ci] = v[turn][0];
        cpy[ci] = v[turn][1];
        cvx[ci] = vt.x;
        cvy[ci] = vt.y;
        cv2[ci] = vt.z;
      }
      if (valid) {
        x0 = fminf(x0, v[turn][0]);
        x1 = fmaxf(x1, v[turn][0]);
        y0 = fminf(y0, v[turn][1]);
        y1 = fmaxf(y1, v[turn][1]);
      }
      const unsigned bal = __ballot_sync(kFullWarp, valid);
      mask |= turn ? (unsigned long long)(bal & 3u) << kTileLanes
                   : (unsigned long long)bal;
    }
    if (t == 0) rowmask[it] = mask;
  }
  for (int off = 16; off > 0; off >>= 1) {
    x0 = fminf(x0, __shfl_xor_sync(kFullWarp, x0, off));
    x1 = fmaxf(x1, __shfl_xor_sync(kFullWarp, x1, off));
    y0 = fminf(y0, __shfl_xor_sync(kFullWarp, y0, off));
    y1 = fmaxf(y1, __shfl_xor_sync(kFullWarp, y1, off));
  }
  if (t == 0) {
    wbox[4 * warp] = x0;
    wbox[4 * warp + 1] = x1;
    wbox[4 * warp + 2] = y0;
    wbox[4 * warp + 3] = y1;
  }
  for (int i = tid; i < n_tile; i += blockDim.x) rax[i] = ray[i] = 0.0f;
  __syncthreads();

  // 2. the list: warp w < tr owns tile row w, one thread per cell
  for (int w = 0; w < nwarps; ++w) {
    x0 = fminf(x0, wbox[4 * w]);
    x1 = fmaxf(x1, wbox[4 * w + 1]);
    y0 = fminf(y0, wbox[4 * w + 2]);
    y1 = fmaxf(y1, wbox[4 * w + 3]);
  }
  if (tid < H) {  // top candidate slot + 1 of each halo row
    int top = K;
    while (top > 0 && rowmask[tid * K + top - 1] == 0) --top;
    jtop[tid] = top;
  }
  // a slot is listed unless its box distance fails the cutoff test; an
  // empty box (+inf, -inf) lists nothing
  auto listed = [&](int w, int k) {
    const int own = ((w + 1) * K + k) * kHaloLanes + t + 1;
    const float px = cpx[own], py = cpy[own];
    const float gx = fmaxf(fmaxf(x0 - px, px - x1), 0.0f);
    const float gy = fmaxf(fmaxf(y0 - py, py - y1), 0.0f);
    return !(gx * gx + gy * gy > pc.cutoff_sq);
  };
  int cell_cnt = 0;
  const bool row_live = warp < tr && row0 + warp <= last;
  if (row_live) {
    for (int k = 0; k < K; ++k) cell_cnt += listed(warp, k) ? 1 : 0;
    int incl = cell_cnt;
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(kFullWarp, incl, off);
      if (t >= off) incl += v;
    }
    if (t == 31) rowcnt[warp] = incl;
    cell_cnt = incl - cell_cnt;  // exclusive, within the row
  } else if (warp < tr && t == 31) {
    rowcnt[warp] = 0;
  }
  __syncthreads();
  if (row_live) {
    int at = cell_cnt;
    for (int w = 0; w < warp; ++w) at += rowcnt[w];
    for (int k = 0; k < K; ++k)
      if (listed(warp, k))
        list[at++] = (unsigned short)(((warp * kTileLanes + t) << 8) | k);
  }
  __syncthreads();
  int n_list = 0;
  for (int w = 0; w < tr; ++w) n_list += rowcnt[w];

  // 3. one thread per listed slot
  for (int base = 0; base < n_list; base += blockDim.x) {
    const int i = base + tid;
    const bool has = i < n_list;
    const int entry = has ? list[i] : 0;
    const int k = entry & 255;
    const int w = entry >> 13;         // tile row
    const int lt = (entry >> 8) & 31;  // tile lane
    const int own = ((w + 1) * K + k) * kHaloLanes + lt + 1;
    const float px = cpx[own], py = cpy[own];
    float ex = 0.0f, ey = 0.0f, ax = 0.0f, ay = 0.0f;
    if (has) {
      const float* c = d + ((int64_t)(row0 + w) * K + k) * 8 * nxl + l0 + lt;
      ex = c[4 * nxl];
      ey = c[5 * nxl];
    }
    // the walk's levels (dy, j), each dy up to the warp's top candidate
    // slot + 1 of halo row w + dy (offset dy - 1)
    int top[3];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
      top[dy] = __reduce_max_sync(kFullWarp, has ? jtop[w + dy] : 0);
    const int jall = max(top[0], max(top[1], top[2]));
    if (jall <= kChunk) {
      // one word of hits a dy row holds every level: a level's 9
      // candidates are tested together, the words popped in dy order
      unsigned long long h[3] = {0, 0, 0};
      for (int j = 0; j < jall; ++j) {
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          unsigned bits =
              (unsigned)((rowmask[(w + dy) * K + j] >> lt) & 7ull);
          if (dy == 1 && j == k) bits &= ~2u;  // self
          const int c0 = ((w + dy) * K + j) * kHaloLanes + lt;
          unsigned in = 0;
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float ddx = px - cpx[c0 + dx];
            const float ddy = py - cpy[c0 + dx];
            in |= pair_in_cutoff(ddx * ddx + ddy * ddy, pc) ? 1u << dx : 0u;
          }
          h[dy] |= (unsigned long long)(has ? bits & in : 0u) << (3 * j);
        }
      }
      while (__any_sync(kFullWarp, (h[0] | h[1] | h[2]) != 0)) {
        if (h[0] | h[1] | h[2]) {
          const int dy = h[0] ? 0 : (h[1] ? 1 : 2);
          const unsigned long long word =
              dy == 0 ? h[0] : (dy == 1 ? h[1] : h[2]);
          const int b = __ffsll((long long)word) - 1;
          const unsigned long long rest = word & (word - 1);
          h[0] = dy == 0 ? rest : h[0];
          h[1] = dy == 1 ? rest : h[1];
          h[2] = dy == 2 ? rest : h[2];
          const int ci =
              ((w + dy) * K + b / 3) * kHaloLanes + lt + b % 3;
          pair_force_vt(ax, ay, px, py, ex, ey, cpx[ci], cpy[ci],
                        make_float3(cvx[ci], cvy[ci], cv2[ci]), pc);
        }
      }
    } else {
      // more levels than a word holds: each dy row in turn, in chunks
      for (int dy = 0; dy < 3; ++dy) {
        const unsigned long long* rm = rowmask + (w + dy) * K;
        for (int j0 = 0; j0 < top[dy]; j0 += kChunk) {
          unsigned long long hits = 0;
          const int j1 = min(j0 + kChunk, top[dy]);
          for (int j = j0; j < j1; ++j) {
            unsigned bits = (unsigned)((rm[j] >> lt) & 7ull);
            if (dy == 1 && j == k) bits &= ~2u;  // self
            const int c0 = ((w + dy) * K + j) * kHaloLanes + lt;
            unsigned in = 0;
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
              const float ddx = px - cpx[c0 + dx];
              const float ddy = py - cpy[c0 + dx];
              in |= pair_in_cutoff(ddx * ddx + ddy * ddy, pc) ? 1u << dx
                                                               : 0u;
            }
            hits |= (unsigned long long)(has ? bits & in : 0u)
                    << (3 * (j - j0));
          }
          while (__any_sync(kFullWarp, hits != 0)) {
            if (hits) {
              const int b = __ffsll((long long)hits) - 1;
              hits &= hits - 1;
              const int ci =
                  ((w + dy) * K + j0 + b / 3) * kHaloLanes + lt + b % 3;
              pair_force_vt(ax, ay, px, py, ex, ey, cpx[ci], cpy[ci],
                            make_float3(cvx[ci], cvy[ci], cv2[ci]), pc);
            }
          }
        }
      }
    }
    if (has) {
      const int si = (w * K + k) * kTileLanes + lt;
      rax[si] = ax;
      ray[si] = ay;
    }
  }
  __syncthreads();

  // 4. output: one warp per (tile row, slot), whole rows of lanes
  for (int it = warp; it < tr * K; it += nwarps) {
    const int w = it / K;
    const int k = it - w * K;
    const int row = row0 + w;
    if (row > last) break;  // `it` grows with w
    float* o = acc + ((int64_t)(row - 1) * K + k) * 2 * nxl + l0 + t;
    o[0] = rax[it * kTileLanes + t];
    o[nxl] = ray[it * kTileLanes + t];
  }
}

}  // namespace

// consts: the 7 PairConsts floats, in order (pairwise.py::pair_constants).
// tile_rows, threads and smem_bytes are the launch shape
// (pairwise.py::pairwise_launch); returns a cudaError_t, or -1 for a shape
// that function cannot return.
extern "C" int pedoni_pairwise(const float* d, float* acc, int ny2, int k,
                               int nx, int tile_rows, int threads,
                               int smem_bytes, const float* consts,
                               void* stream) {
  PairConsts pc;
  pc.cutoff_sq = consts[0];
  pc.dt = consts[1];
  pc.dt2 = consts[2];
  pc.half_strength = consts[3];
  pc.neg_half_inv_range = consts[4];
  pc.cos2 = consts[5];
  pc.fov_damping = consts[6];
  if (tile_rows < 1 || tile_rows > 2 || k < 1 || k > 255 || threads != 512 ||
      ny2 < 3 || nx % kTileLanes != 0 ||
      (int64_t)smem_bytes != tile_smem_bytes(tile_rows, k))
    return -1;
  const cudaError_t e = cudaFuncSetAttribute(
      pairwise_tile, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)(nx / kTileLanes),
            (unsigned)((ny2 - 2 + tile_rows - 1) / tile_rows));
  pairwise_tile<<<grid, threads, smem_bytes, (cudaStream_t)stream>>>(
      d, acc, ny2, k, nx, tile_rows, pc);
  return (int)cudaGetLastError();
}
