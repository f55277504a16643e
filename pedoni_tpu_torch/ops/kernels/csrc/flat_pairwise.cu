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
// multi-instruction (seven IEEE divides, four sqrtf, an accurate expf):
// pair_term issues ~150 instructions.  The bytes are few: the grid is read
// once from device memory (its halo again from L2) and the output written
// once.
//
// One block per tile of tr x tc cells of the padded grid (flat_tile: the
// first of kTiles whose shared memory fits 64 KB: 4 x 8 at K 14 and 16,
// four blocks an SM; 1 x 1 at K 255, whose 3 x 3 cells of 255 slots still
// fit with fewer warps, so no chunked staging is needed).
//   1. stage (block-wide barriers): every slot of the tile and its one-cell
//      halo, read once with coalesced loads.  The active slots are
//      compacted, in halo order (cell by cell, row-major, then slot j),
//      into shared arrays of pos, (v.x dt, v.y dt) and (|v| dt)^2, and
//      cstart[c] is the first compacted slot of halo cell c.  The three
//      cells of a window row are neighbours in halo order, so each row of
//      a centre's window is one contiguous range of the compacted slots,
//      in the twin's order.  In the same pass, by warp ballots, the list
//      of the tile's interior slots, cell by cell in slot order: the active
//      ones first, then the idle ones, each with its own compacted index
//      (the self test).  Then each halo cell's bounding box of active
//      positions.
//   2. pairs, with no block barrier (only __syncwarp and warp votes): the
//      listed active slots are cut into groups of at most 32 centres, as
//      even as lets every warp hold one (about 20 at the 1M problem),
//      the idle ones into groups of 32; a warp takes a group at a time.
//      Each lane trims its centre's three rows of the end cells whose box
//      lies past the cutoff (box_past_cutoff) and lays the rows end to end:
//      the centre's W candidates.  An idle slot of the flat step's grid
//      holds (0, 0), past the cutoff of every box away from that corner, so
//      its W is 0.  The group's pairs are its centres' candidates, centre
//      by centre (those with W = 0 left out), each centre's [start, end)
//      by a scan across the lanes; its row ranges, self, pos and e go to
//      the warp's 32 centre records.
//      a. walk: the lanes take 32 consecutive pairs a round; a lane finds
//         its centre by counting the centres' ends before its pair
//         (__reduce_or_sync, __popc), tests the distance, and the hits are
//         compacted by __ballot_sync / __popc into the warp's queue in
//         shared memory, in pair order: centre by centre, each centre's
//         hits in its walk order, the twin's.
//      b. force body: once the queue holds more than kQueue - 32 entries
//         (and when the group's walk ends), the lanes take 32 queued pairs
//         at a time, every lane busy but in the group's last batch, call
//         pair_term and write each term (fx, fy) over its queue entry,
//         marking where each centre's run of entries starts and ends.
//      c. sum: each centre's lane adds its run's terms to its sum in queue
//         order, one add at a time; the sum carries over to the next
//         queue chunk.  The entries of a batch not yet full move to the
//         queue's front.
//      The sum goes to the tile's slot in shared memory; a slot with no
//      candidate, and a ring slot, keep +0.
//   3. output: the tile's slots as whole rows of cells, coalesced.
// Shared memory (flat_smem_bytes): 20 B a halo slot, 12 B a tile slot,
// 20 B a halo cell and, a warp, 1280 B of centre records, 8 B a queued
// pair and 128 B of run marks: 51,220 B at K 14 (the design before,
// 38,992 B and five blocks an SM; four now, held by 59 registers too).
// Bit-neutral: the compacted slots are exactly the twin's active
// candidates (an inactive one adds +0); a trimmed cell holds only
// candidates that fail the cutoff test (box_past_cutoff); each term is
// pair_term of the same staged f32 inputs as before, only the lane that
// computes it changes; and each slot adds the same terms in the same order
// from +0.
// Earlier designs (PERF.md): one thread per slot of a 2 x 16 tile (two
// thirds of its lanes idled); one lane a centre, walking its own window
// and evaluating its own hits, the warp's lanes idle past the shortest
// walk and the shortest list (about 28% of the force body's lanes and 43%
// of the walk's at the 1M problem); a block-wide list of (agent,
// candidate) pairs, slower for its barriers.  Tried on this design and
// slower: groups of 32 centres in list order (most warps of a block then
// idle), a queue of 128 pairs (twice the sums' serial runs), five blocks
// an SM at 48 registers, a walk a centre at a time (lanes past a centre's
// last candidate idle), two walk rounds an iteration and prefetched
// staging.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kQueue = 256;  // a warp's queued pairs
constexpr unsigned kFullWarp = 0xffffffffu;
// tile shapes (rows, columns of cells), most preferred first; (1, 1) fits
// kSmemBudget at every K up to 255, with fewer warps past K 213
constexpr int kTiles[][2] = {{4, 8}, {4, 4}, {2, 4}, {2, 2}, {1, 2}, {1, 1}};
constexpr int kSmemBudget = 64 * 1024;  // a block's; past 48 KB it opts in
// the occupancy counter's totals (flat_pairwise_occupancy)
enum { kPairs, kBodyLanes, kTests, kWalkLanes };

struct FlatConsts {
  float cutoff_sq, dt, eps, strength, range, cos_phi, fov_damping;
};

// Dynamic shared memory of a tr x tc tile, in the order laid out in
// flat_pairwise_tile: each halo cell's box (float4); each warp's 32
// centres (int4, int4, float2); each halo slot's compacted pos and v dt
// (float2 each); each warp's queue (float2); each tile slot's acceleration
// (float2); each halo slot's (|v| dt)^2; cstart; the warps' counts; each
// tile slot's list entry (u32); each warp's run starts and ends.
inline int flat_smem_bytes(int tr, int tc, int k, int threads) {
  const int halo = (tr + 2) * (tc + 2);
  const int slots = tr * tc * k;
  const int warps = threads / 32;
  return 16 * halo + 40 * 32 * warps + 16 * halo * k + 8 * kQueue * warps +
         8 * slots + 4 * halo * k + 4 * (halo + 1) + 4 * 48 + 4 * slots +
         4 * 32 * warps;
}

// The launch at K (1..255): the first of kTiles whose shared memory fits
// kSmemBudget, with threads for every slot of the tile up to kMaxThreads,
// a multiple of 32; where none fits (K past 213), the 1 x 1 tile with as
// many warps as fit.  The halo's slots stay below 2^16 (the list and the
// queue hold 16-bit slots).
inline void flat_tile(int k, int& tr, int& tc, int& threads) {
  for (const auto& t : kTiles) {
    tr = t[0];
    tc = t[1];
    threads = (tr * tc * k + 31) / 32 * 32;
    if (threads > kMaxThreads) threads = kMaxThreads;
    if (flat_smem_bytes(tr, tc, k, threads) <= kSmemBudget) return;
  }
  while (threads > 32 && flat_smem_bytes(tr, tc, k, threads) > kSmemBudget)
    threads -= 32;
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

// Of the warps' counts cnt[0, nwarps) (nwarps <= 8): (the sum over the
// warps before this one, the sum over all), by a scan across the lanes.
__device__ __forceinline__ int2 warps_before(const int* cnt, int warp,
                                             int nwarps, int lane) {
  const int own = lane < nwarps ? cnt[lane] : 0;
  int incl = own;
  for (int o = 1; o < 8; o <<= 1) {
    const int t = __shfl_up_sync(kFullWarp, incl, o);
    if (lane >= o) incl += t;
  }
  return make_int2(__shfl_sync(kFullWarp, incl - own, warp),
                   __shfl_sync(kFullWarp, incl, nwarps - 1));
}

// kCount: also add the launch's four totals (kPairs ...) into counts (the
// occupancy counter; the step launches the kernel without it).
template <bool kCount>
__global__ void __launch_bounds__(kMaxThreads)
flat_pairwise_tile(const float* __restrict__ data, float* __restrict__ acc,
                   int ny2, int nx2, int k, int tr, int tc, FlatConsts c,
                   unsigned long long* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hcols = tc + 2;
  const int ncells = (tr + 2) * hcols;  // halo cells
  const int nh = ncells * k;            // halo slots
  const int nt = tr * tc * k;           // tile slots
  const int nwarps = blockDim.x >> 5;
  float4* sbox = (float4*)smem_raw;      // [halo cells] x0, x1, y0, y1
  int4* meta_a = (int4*)(sbox + ncells);  // [warps][32] the walk's ranges
  int4* meta_b = meta_a + 32 * nwarps;    // [warps][32] the walk's and body's
  float2* meta_e = (float2*)(meta_b + 32 * nwarps);  // [warps][32] e
  float2* cxy = meta_e + 32 * nwarps;  // [nh] compacted active slots' pos
  float2* cvd = cxy + nh;              // v.x dt, v.y dt
  float2* queue = cvd + nh;            // [warps][kQueue] entry, then term
  float2* sacc = queue + kQueue * nwarps;  // [nt]
  float* cv2 = (float*)(sacc + nt);    // [nh] (|v| dt)^2
  int* cstart = (int*)(cv2 + nh);      // [halo cells + 1]
  int* wcnt = cstart + ncells + 1;     // [48]: active centres, idle, active
  unsigned* list = (unsigned*)(wcnt + 48);  // [nt] halo slot | compacted << 16
  unsigned short* run_s = (unsigned short*)(list + nt);  // [warps][32] a
  unsigned short* run_e = run_s + 32 * nwarps;  // centre's first entry, its end

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int r0 = blockIdx.y * tr;  // the tile's first padded row
  const int c0 = blockIdx.x * tc;

  for (int t = tid; t < nt; t += blockDim.x) sacc[t] = make_float2(0.0f, 0.0f);
  for (int t = tid; t < 64 * nwarps; t += blockDim.x) run_s[t] = 0;  // and run_e

  // 1. stage the halo, its active slots compacted; list the interior slots
  // of the tile in halo-slot order, the active ones from the front and the
  // idle ones from the back
  int n_live = 0, n_idle = 0, n_act = 0;  // the same in every thread
  for (int base = 0; base < nh; base += blockDim.x) {
    const int u = base + tid;
    bool centre = false, idle = false, act = false;
    float2 xy = make_float2(0.0f, 0.0f), vd = xy;
    float v2 = 0.0f;
    int hc = 0, j = 0;
    if (u < nh) {
      hc = u / k;
      j = u - hc * k;
      const int hr = hc / hcols, hcol = hc - hr * hcols;
      const int r = r0 - 1 + hr, col = c0 - 1 + hcol;
      if (r >= 0 && r < ny2 && col >= 0 && col < nx2) {
        const float* q = data + (((int64_t)r * nx2 + col) * k + j) * 8;
        const float4 p = *reinterpret_cast<const float4*>(q);
        const bool interior = hr >= 1 && hr <= tr && hcol >= 1 && hcol <= tc &&
                              r >= 1 && r <= ny2 - 2 && col >= 1 && col <= nx2 - 2;
        if (q[6] > 0.5f) {
          act = true;
          xy = make_float2(p.x, p.y);
          vd = make_float2(p.z * c.dt, p.w * c.dt);
          const float vdt = norm2(p.z, p.w, c.eps) * c.dt;
          v2 = vdt * vdt;
          centre = interior;
        } else {
          idle = interior;
        }
      }
    }
    const unsigned bal = __ballot_sync(kFullWarp, centre);
    const unsigned bal_idle = __ballot_sync(kFullWarp, idle);
    const unsigned bal_act = __ballot_sync(kFullWarp, act);
    if (lane == 0) {
      wcnt[warp] = __popc(bal);
      wcnt[16 + warp] = __popc(bal_idle);
      wcnt[32 + warp] = __popc(bal_act);
    }
    __syncthreads();
    const int2 live = warps_before(wcnt, warp, nwarps, lane);
    const int2 idl = warps_before(wcnt + 16, warp, nwarps, lane);
    const int2 actv = warps_before(wcnt + 32, warp, nwarps, lane);
    // the compacted index of slot u: the active slots before it
    const int ci = n_act + actv.x + __popc(bal_act & below);
    if (u < nh && j == 0) cstart[hc] = ci;
    if (act) {
      cxy[ci] = xy;
      cvd[ci] = vd;
      cv2[ci] = v2;
    }
    if (centre)
      list[n_live + live.x + __popc(bal & below)] = (unsigned)u | (unsigned)ci << 16;
    if (idle)
      list[nt - 1 - (n_idle + idl.x + __popc(bal_idle & below))] =
          (unsigned)u | 0xffff0000u;
    n_live += live.y;
    n_idle += idl.y;
    n_act += actv.y;
    __syncthreads();  // wcnt is written again next round
  }
  if (tid == 0) cstart[ncells] = n_act;
  __syncthreads();

  // each halo cell's box of active positions (NaN ones left out: they never
  // pass the cutoff test); an empty cell's is empty (x0 = +inf, x1 = -inf)
  for (int t = tid; t < ncells; t += blockDim.x) {
    float4 b = make_float4(INFINITY, -INFINITY, INFINITY, -INFINITY);
    for (int s = cstart[t]; s < cstart[t + 1]; ++s) {
      const float2 p = cxy[s];
      b = make_float4(fminf(b.x, p.x), fmaxf(b.y, p.x), fminf(b.z, p.y),
                      fmaxf(b.w, p.y));
    }
    sbox[t] = b;
  }
  __syncthreads();

  // 2. pairs: each warp a group of listed slots at a time
  int4* ma_w = meta_a + 32 * warp;
  int4* mb_w = meta_b + 32 * warp;
  float2* me_w = meta_e + 32 * warp;
  float2* q_w = queue + kQueue * warp;
  unsigned* qent = reinterpret_cast<unsigned*>(q_w);  // entry e at qent[2 e]
  unsigned short* rs_w = run_s + 32 * warp;
  unsigned short* re_w = run_e + 32 * warp;
  unsigned long long n_pairs = 0, n_body = 0, n_tests = 0, n_walk = 0;
  // the active slots in groups of at most 32 as even as the warps' count
  // allows, so that every warp holds some; then the idle ones, 32 a group
  const int n_lg = (n_live + 32 * nwarps - 1) / (32 * nwarps) * nwarps;
  const int g_live = n_lg ? (n_live + n_lg - 1) / n_lg : 0;
  const int n_groups = n_lg + (n_idle + 31) / 32;
  for (int g = warp; g < n_groups; g += nwarps) {
    const int li0 = g < n_lg ? g * g_live : n_live + (g - n_lg) * 32;
    const int li = li0 + lane;
    const bool has = g < n_lg ? lane < g_live && li < n_live : li < n_live + n_idle;
    const unsigned ent =
        !has ? 0u : li < n_live ? list[li] : list[nt - 1 - (li - n_live)];
    const int u = ent & 0xffff;
    const int self = ent >> 16;  // 0xffff for an idle slot: no candidate's
    const int hc = u / k, i = u - hc * k;
    const int hr = hc / hcols, hcol = hc - hr * hcols;
    float px = 0.0f, py = 0.0f, ex = 0.0f, ey = 0.0f;
    // the window's rows as ranges [a, a + n) of the compacted slots, each
    // trimmed of the end cells whose box lies past the cutoff
    int a0 = 0, a1 = 0, a2 = 0, n0 = 0, n1 = 0, n2 = 0;
    if (has) {  // pos and e from the grid (an idle slot is not staged)
      const float* q = data + (((int64_t)(r0 - 1 + hr) * nx2 + (c0 - 1 + hcol)) * k + i) * 8;
      const float2 p = *reinterpret_cast<const float2*>(q);
      const float2 e = *reinterpret_cast<const float2*>(q + 4);
      px = p.x;
      py = p.y;
      ex = e.x;
      ey = e.y;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const int cell = (hr - 1 + dy) * hcols + hcol - 1;
        const bool cl = box_past_cutoff(px, py, sbox[cell], c);
        const bool cm = box_past_cutoff(px, py, sbox[cell + 1], c);
        const bool cr = box_past_cutoff(px, py, sbox[cell + 2], c);
        const int lo = cell + (cl ? (cm ? 2 : 1) : 0);
        const int hi = cell + 3 - (cr ? (cm ? 2 : 1) : 0);
        const int a = cstart[lo];
        const int n = lo < hi ? cstart[hi] - a : 0;
        if (dy == 0) { a0 = a; n0 = n; }
        if (dy == 1) { a1 = a; n1 = n; }
        if (dy == 2) { a2 = a; n2 = n; }
      }
    }
    // the group's pairs: each centre's [start, end), lane by lane
    const int w = n0 + n1 + n2;
    int end = w;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFullWarp, end, o);
      if (lane >= o) end += t;
    }
    const int start = end - w;
    const int n_group = __shfl_sync(kFullWarp, end, 31);
    const int d = __popc(__ballot_sync(kFullWarp, w > 0) & below);  // dense index
    if (w > 0) {  // pair p of the centre is its compacted slot p + offset
      ma_w[d] = make_int4(start + n0, start + n0 + n1, a0 - start, a1 - start - n0);
      mb_w[d] = make_int4(a2 - start - n0 - n1, self, __float_as_int(px),
                          __float_as_int(py));
      me_w[d] = make_float2(ex, ey);
    }
    __syncwarp();
    float sx = 0.0f, sy = 0.0f;
    int qn = 0, cd0 = 0;  // queued entries; the dense centre of pair p0
    for (int p0 = 0; p0 < n_group; p0 += 32) {
      // a. walk: pair p0 + lane of centre cd (the ends at or before it)
      const unsigned ends = __reduce_or_sync(
          kFullWarp, w > 0 && end > p0 && end <= p0 + 32 ? 1u << (end - p0 - 1) : 0u);
      const int cd = cd0 + __popc(ends & below);
      const int p = p0 + lane;
      bool hit = false;
      int v = 0;
      if (p < n_group) {
        const int4 ma = ma_w[cd];
        const int4 mb = mb_w[cd];
        v = p + (p < ma.x ? ma.z : p < ma.y ? ma.w : mb.x);
        const float2 xy = cxy[v];
        const float dx = __int_as_float(mb.z) - xy.x;
        const float dy = __int_as_float(mb.w) - xy.y;
        hit = dx * dx + dy * dy <= c.cutoff_sq && v != mb.y;
      }
      const unsigned hits = __ballot_sync(kFullWarp, hit);
      if (hit) qent[2 * (qn + __popc(hits & below))] = (unsigned)v | (unsigned)cd << 16;
      qn += __popc(hits);
      cd0 += __popc(ends);
      const bool last = p0 + 32 >= n_group;
      if (kCount) {
        n_tests += min(32, n_group - p0);
        n_walk += 32;
      }
      if (qn <= kQueue - 32 && !last) continue;
      // b. force body: whole batches of 32 queued pairs (all at the last)
      const int ne = last ? qn : qn & ~31;
      int prev_cd = -1;  // the centre of the entry before the batch
      for (int b = 0; b < ne; b += 32) {
        const int e = b + lane;
        int ce = -1;
        float fx = 0.0f, fy = 0.0f;
        if (e < ne) {
          const unsigned en = qent[2 * e];
          const int cv = en & 0xffff;
          ce = en >> 16;
          const int4 mb = mb_w[ce];
          const float2 me = me_w[ce];
          const float2 xy = cxy[cv];
          const float2 vd = cvd[cv];
          const float dx = __int_as_float(mb.z) - xy.x;
          const float dy = __int_as_float(mb.w) - xy.y;
          pair_term(dx, dy, dx * dx + dy * dy, vd.x, vd.y, cv2[cv], me.x, me.y,
                    c, fx, fy);
        }
        int prev = __shfl_up_sync(kFullWarp, ce, 1);
        int next = __shfl_down_sync(kFullWarp, ce, 1);
        if (lane == 0) prev = prev_cd;
        if (lane == 31) next = e + 1 < ne ? (int)(qent[2 * (e + 1)] >> 16) : -1;
        prev_cd = __shfl_sync(kFullWarp, ce, 31);
        __syncwarp();  // every entry of the batch read before its term lands
        if (e < ne) {
          q_w[e] = make_float2(fx, fy);
          if (ce != prev) rs_w[ce] = e;
          if (ce != next) re_w[ce] = e + 1;
        }
      }
      if (kCount) {
        n_pairs += ne;
        n_body += (ne + 31) / 32 * 32;
      }
      __syncwarp();
      // c. sum: each centre's run, in queue order
      if (w > 0) {
        const int s0 = rs_w[d], s1 = re_w[d];
#pragma unroll 4
        for (int e = s0; e < s1; ++e) {
          const float2 f = q_w[e];
          sx = sx + f.x;
          sy = sy + f.y;
        }
        rs_w[d] = 0;
        re_w[d] = 0;
      }
      // the batch not yet full moves to the queue's front
      const int rem = qn - ne;
      const unsigned keep = lane < rem ? qent[2 * (ne + lane)] : 0u;
      __syncwarp();
      if (lane < rem) qent[2 * lane] = keep;
      qn = rem;
      __syncwarp();
    }
    if (w > 0) sacc[((hr - 1) * tc + hcol - 1) * k + i] = make_float2(sx, sy);
    __syncwarp();  // the group's centres are written again by the next
  }
  if (kCount && lane == 0) {
    atomicAdd(counts + kPairs, n_pairs);
    atomicAdd(counts + kBodyLanes, n_body);
    atomicAdd(counts + kTests, n_tests);
    atomicAdd(counts + kWalkLanes, n_walk);
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

// The launch of flat_pairwise_tile<kCount>, or -1 for a grid it does not
// take.
template <bool kCount>
int launch(const float* data, float* acc, int ny2, int nx2, int k,
           const float* consts, unsigned long long* counts, void* stream) {
  if (const int w = pedoni_on_current_device(data)) return w;
  if (ny2 < 3 || nx2 < 3 || k < 1 || k > 255) return -1;
  int tr, tc, threads;
  flat_tile(k, tr, tc, threads);
  if ((ny2 + tr - 1) / tr > 65535) return -1;
  const int smem = flat_smem_bytes(tr, tc, k, threads);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flat_pairwise_tile<kCount>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
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
  flat_pairwise_tile<kCount><<<grid, threads, smem, (cudaStream_t)stream>>>(
      data, acc, ny2, nx2, k, tr, tc, c, counts);
  return (int)cudaGetLastError();
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
  return launch<false>(data, acc, ny2, nx2, k, consts, nullptr, stream);
}

// pedoni_flat_pairwise with the occupancy counter: adds the launch's pairs
// evaluated, lanes issued in force-body batches, distance tests and lanes
// issued in walk rounds into counts[0..3] (device memory, int64).
extern "C" int pedoni_flat_pairwise_occupancy(const float* data, float* acc,
                                              int ny2, int nx2, int k,
                                              const float* consts,
                                              unsigned long long* counts,
                                              void* stream) {
  return launch<true>(data, acc, ny2, nx2, k, consts, counts, stream);
}
