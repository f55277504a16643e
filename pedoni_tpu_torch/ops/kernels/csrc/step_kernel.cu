// Fused step kernel: field sampling, despawn, goal, obstacle and pair
// forces, integration, and the mover emit, over the cell-resident grid.
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
//   d      [ny2, K, 8, NXL]  ch 0 pos.x, 1 pos.y, 2 vel.x, 3 vel.y, 4 speed,
//                            5 dest, 6 active, 7 cell bound (valid at slot 0)
//   fields [n_wp, R, NXL * S, 8]  texel-major copy of the fields6 planes
//                            (step_kernel.py::pack_fields): texel
//                            (f, l * S + c) of plane p holds fwp[p, f, c,
//                            0..3, l], then fobs[f, c, 0..3, l]
//   segs   [n_seg, 22]       segments mode only: the obstacle edge table of
//                            step_kernel.py::segment_table
//   act    [ny2, K, NXL]     scratch: the post-despawn active flag act'
//   ea     [ny2, K, NXL, 4]  scratch: e.x, e.y, acc.x, acc.y (goal direction,
//                            goal + obstacle acceleration; the goal's alone
//                            in segments mode), written and read only for
//                            centre slots with act' > 0.5
//   out    [ny2, K, 8, NXL]  ghost rows 0 and ny2-1 zero; ch 7 = potential,
//                            or the stay mask in the mover mode
//   m      [ny2, MK, 8, NXL] mover mode only: each cell's movers in slot
//                            order, ch 6 = row < movers, ch 7 = min(movers, MK)
//   movf, mdmx [nb]          mover mode only, per block of rb cell rows:
//                            sum(max(movers - MK, 0)) and the peak mover count
//
// What bounds it on the card (NVIDIA H100 80GB HBM3, 700 W, the 1M-agent
// bench state: 39% of the slots hold an agent, an agent has ~50 candidates
// in its 3x3 cells of which ~29 are within the cutoff):
// - the pair pass by instruction throughput: one pair evaluation is ~100
//   instructions (three rsqrtf, an accurate expf, and no fused multiply-add:
//   the twin has none), 29.6 M of them a step;
// - the sample pass by the 32-byte sectors its scattered loads move, not by
//   the bytes it uses: 4 taps an agent from 4 different sectors.
// A first design ran one thread per slot, walked (j, dy, dx) warp-wide so
// that every lane ran the pair body whenever one lane had a candidate
// (about one lane in seven did work that counted), fetched every candidate
// from L1/L2 again for every centre agent, and sampled channel-planar
// fields6 planes at a sector per channel per tap.  PERF.md has both
// designs' times.
//
// The pair force of a centre agent needs every candidate's POST-despawn
// active flag, which comes from sampling the candidate's own potential; one
// launch cannot see that without a grid-wide barrier, so the step is two
// launches.
//
// step_sample<kSeg> (one thread per slot, lanes fastest):
//   sanitize, sample the agent's waypoint plane, despawn -> act'.  A slot
//   whose active flag is exactly 0 stops there (act' = 0 whatever it
//   samples); in the base mode it first samples its potential, which goes
//   to out ch 7 of every centre slot.  A centre slot with act' > 0.5 goes on
//   to the goal force and the obstacle force (from the same texels' second
//   half; with kSeg, the walk of a short edge table, or the pair pass adds
//   it) and writes one float4 of ea.
//   A texel holds a tap's channels of both fields in one sector: 4
//   sectors an agent, where fields6 cost 24.
// step_pairs (one block per tile of TR rows x 32 lanes of cells; TR, the
// block size and the shared memory come from step_kernel.py::
// pair_pass_launch: two rows where three blocks of them fit an SM, as the
// kernel's 40 registers allow, else one row where that fits three, and so
// on down.  Past K 21 a two-row tile leaves room for two blocks only: a
// jam's few dense tiles then set the pass's time, and one-row tiles, three
// blocks an SM, ran the funnel's jam at K 24 in 0.055 ms against 0.074;
// two rows stage less halo a row and win where three fit, 0.303 ms
// against 0.404 on the 1M grid; PERF.md):
//   1. stage: every slot (row, j) of the tile and its one-cell halo, as
//      sanitized pos/vel in shared memory, with coalesced loads along the
//      lanes, all started before any is used.  A warp stages one (row, j)
//      over the 34 lanes; its ballot of "valid candidate" (below the cell's
//      bound, ch 7 of slot 0, and act' > 0.5) is that row's lane bitmask
//      for slot j.  Lanes -1 and NXL and rows past the grid hold no cell.
//      After this the pair loop touches no device memory.
//   2. list: the tile's slots with act' > 0.5, cell by cell (prefix sum
//      over per-cell counts), so neighbouring threads share their 9 cells
//      and their shared-memory reads are broadcasts.  Empty slots cost no
//      thread.
//   3. pairs: one thread per listed agent, in chunks of 7 slot levels.
//      Light part, without a branch on the data: per level the three row
//      bitmasks give the 9 cells' candidates as 9 bits, and the cutoff test
//      of all 9 slots sets the bits of a 63-bit word of hits.  Heavy part:
//      the lanes that still hold a hit pop their lowest bit and run
//      pair_force together.
//      Ascending bits are the reference's summation order (slot j outer,
//      then dy, then dx), so kernel and twin agree bit for bit.  Holes
//      below a cell's bound cost nothing (their bit is clear).  Then the
//      trapezoidal integration, and the new pos/vel go to shared memory.
//      The counting build (step_pairs_count, launched by
//      pedoni_step_kernel_occupancy alone) adds up the pairs evaluated, the
//      lanes of the heavy part's rounds, the candidates tested and the
//      light part's test slots (9 a lane a level its warp walks).
//      Tried and slower (PERF.md): lanes that each walk their own
//      candidate stream to the next hit (the warp waits for its slowest
//      search every round); warp-wide pair queues, as flat_pairwise.cu's
//      (even groups of listed agents a warp, a group's (agent, level)
//      records walked 32 a round, hits queued and evaluated 32 at a time,
//      each agent's terms added in queue order through warp shuffles):
//      2.3 times the time on the funnel's jam, since its lanes were busy
//      already (0.82 of the heavy part's, 0.99 queued) and the shuffles (~100
//      a batch of 32 pairs) and a walk three times as dear cost more than
//      pair_force; even groups a warp alone (more warps, fewer lanes each:
//      slower at every grid); two or three hits a lane a round (-12% on
//      the jam, +13% on the 1M grid at 56-62 registers, two blocks an SM
//      where three were; -7%/-1% bound to three); two-row tiles split on
//      the card where their cells hold more agents than a block has
//      threads (the registers rose to 64, or spilled at 40).
//   4. movers (mover mode, the tile's first TR warps, one thread per cell):
//      walk the cell's K slots in order and note the movers — act' * (1 -
//      same) > 0.5, same = [the integrated position's cell is this cell] by
//      the IEEE divide __fdiv_rn, the one both rebins use — in shared
//      memory; per-block movf / mdmx by warp shuffles and one atomic per
//      warp (integer values, exact in any order).  It runs after the
//      barrier that ends the pair loop, so its registers do not add to the
//      loop's, and it replaces a third launch that read G again.
//   5. output: every slot of the tile as whole 128-byte rows of lanes —
//      new or passed-through pos/vel, sanitized speed, dest, act', and in
//      the mover mode the stay mask act' * same; the first and last tile
//      rows also zero the ghost rows of out and M.
//   6. mover mode: every row of M of the tile, by all warps, as whole rows
//      of lanes: the cell's r-th mover, or zeros.
//
// Where a one-row tile's K slot levels do not fit a block's shared memory
// (K above 98, above 92 in segments mode; step_kernel.py::pair_pass_launch),
// the _chunked kernels stage them `levels` at a time: step 1 takes the row
// bitmasks and act' of every level and the tile's own positions (into the
// new pos's room), step 3 stages the levels [j0, j0 + levels) of the tile
// and its halo in turn and every listed agent walks them as above, its
// acceleration waiting in the new vel's room between chunks; then the
// integration.  The chunks come in slot order, so each agent's terms are
// summed in the same order and the result has the same bits.  A slot that
// is not live passes its sanitized pos/vel through from d.
//
// A grid may be one tile of a larger one (parallel/tile2d.py): d's row r
// and lane l are global cell row roff + r - 1 and column coff + l - 1, the
// field planes are the tile's slab, positions are global.  The sample pass
// and the mover classification add the offsets; the mover mode emits
// movers from lanes [mlo, mhi] only (a tile's own; every lane for a whole
// grid).
//
// Segments mode (the reference's --no-distance-map debug mode) is a
// compile-time template parameter of both launches, and the caller
// chooses where the edge table is walked (seg_pass; the rule and its
// measured crossover are step_kernel.py::segment_pass's).  Walked by
// step_sample<true> for each live agent, into ea, and the pair pass is the
// base mode's: on a short table and a dense grid the pass below costs more
// barriers and staging than such a walk (PERF.md).  Walked by the pair
// pass, step_sample<true> writes the goal acceleration alone to ea, and
// the pair pass, as the kernel step_pairs_segments, adds the obstacle
// force of its listed agents between steps 2 and 3:
//   2'. segments: the bounding box of the tile's listed agents; then the
//      edge table in passes: a block-wide prefix sum over the rows, in
//      chunks of the block, keeps the rows whose widened rectangle's
//      axis-aligned box (its corners: q0 and q0 + s of edges 0 and 1) lies
//      within the cull distance of the agents' box on both axes, and stages
//      up to kSegCap of them in table order in shared memory; then the
//      terms of (listed agent, kept row) pairs are computed by all threads,
//      agents fastest, kTermCap at a time, and two threads an agent (x and
//      y) add that agent's terms in table order to its running sum.  The
//      sum starts at +0 and goes to the new pos/vel's room (rpx, rpy), free
//      until step 3 writes it.
//      Step 3 then starts from ea's goal acceleration + that sum: the
//      `afx + sfx` of the twin, in its order.
// The cull changes no bit.  The build keeps denormals and has no fast math,
// so expf(x) is exactly +0 for x < ln(2^-150) ~ -103.97.  A dropped row's
// box is at least cull = 110 x obs_range + 2^-12 x (grid_w + grid_h +
// 110 x obs_range) from every agent of the tile on one axis, so the agent's
// dmin is at least 110 x obs_range (the second term covers the f32 rounding
// of corners and closest points, a few ulp of coordinates below that size),
// -dmin / obs_range < -103.97 and coef = 0: the skipped term is +-0, and
// adding +-0 to a sum that starts at +0 leaves its bits as they are (such a
// sum is never -0).  A row the agent stands inside has box distance 0 and
// is always kept.  A live agent stands in the grid (a non-finite or
// out-of-grid agent is despawned before any force), so its distances are
// finite.  fused_step refuses obs_range <= 0 and a non-finite obs_strength,
// where this would not hold.  The first design walked all rows of the table
// with one thread per live slot of a strip of lanes: ~100 dependent float
// operations a row, 1000 rows in random.toml, few live lanes a warp; it sat
// at 1.7% of its bound (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "device.cuh"
#include "pair.cuh"

namespace {

constexpr float kBig = 1073741824.0f;  // 2^30 sanitize sentinel
constexpr int kRow0 = 3;               // fields6.ROW0
constexpr float kFpad = 4.0f;          // field-map PAD rings
constexpr int kSegCols = 22;           // step_kernel.py SEG_COLS
constexpr int kTileLanes = 32;         // cells of a tile row: one warp
constexpr int kHaloLanes = kTileLanes + 2;
constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kChunk = 7;              // slot levels per walk chunk: 63 bits
constexpr int kSegCap = 64;            // segments: kept rows staged at once
constexpr int kTermCap = 1024;         // segments: (agent, row) terms a round
constexpr int kMaxWarps = 32;
// the occupancy counter's totals (pedoni_step_kernel_occupancy)
enum { kPairs, kBodyLanes, kTests, kWalkLanes };

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
  float seg_cull;          // segments: the cull distance (see above)
};

struct Dims {
  int ny2, k, nxl, n_wp, frows, stride;
  int roff, coff;  // a tile's global cell row and column of its row 1, lane 1
  int mlo, mhi;    // mover mode: the lanes that emit movers
};

__device__ __forceinline__ float sanitize(float v) {
  return fabsf(v) < kBig ? v : kBig;  // NaN and -inf map to +2^30 too
}

// Bilinear sample of one texel-major plane at the agent in D row `row`, lane
// `lane` (global cell row row - 1 + roff, column lane - 1 + coff; the plane
// is the tile's slab): channels [0, nch) of the waypoint field into pv and,
// with kObs,
// the 3 channels of the obstacle map (the texel's second float4) into ov.
// Taps exist only inside the cell's (S+2)^2 patch; a tap outside it
// contributes 0 (not the map value there), exactly as the reference's masked
// 8x8 patch walk (step_kernel.py:64-101).  Summation order (qy outer, qx
// inner) matches the reference, for each field on its own.  The texel of
// patch column `col` is fields6's (col % S, lane + col / S), the lane
// circular as the reference's lane roll.
template <bool kObs>
__device__ __forceinline__ void sample(const float4* __restrict__ plane,
                                       const Dims& dm, int row, int lane,
                                       float px, float py, int nch,
                                       float* pv, float* ov) {
  const int s = dm.stride;
  const float bx = floorf(px);
  const float by = floorf(py);
  const float tx = px - bx;
  const float ty = py - by;
  const float p0 = bx - (float)(lane - 1 + dm.coff) * (float)s - (float)kRow0;
  const float q0 = by - (float)(row - 1 + dm.roff) * (float)s - (float)kRow0;
  pv[0] = pv[1] = pv[2] = 0.0f;
  if (kObs) ov[0] = ov[1] = ov[2] = 0.0f;
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
      const float4* texel =
          plane + ((int64_t)frow * dm.nxl * s + l2 * s + col % s) * 2;
      const float4 t = __ldg(texel);
      pv[0] = pv[0] + w * t.x;
      if (nch > 1) {
        pv[1] = pv[1] + w * t.y;
        pv[2] = pv[2] + w * t.z;
      }
      if (kObs) {
        const float4 u = __ldg(texel + 1);
        ov[0] = ov[0] + w * u.x;
        ov[1] = ov[1] + w * u.y;
        ov[2] = ov[2] + w * u.z;
      }
    }
  }
}

// The exact obstacle acceleration term of one obstacle at (px, py)
// (step_kernel.py:104-159): the closest point of each of the widened
// rectangle's 4 edges (t clipped to [0, 1]), the first minimum by a strict <
// on squared distances, +0 inside the rectangle (the reference adds coef = 0
// there).  Column c of the obstacle's row is r[c * stride]: the edge table
// itself (stride 1) or its staged column-major copy (stride kSegCap).  A row
// holds, for edge e, q0.x q0.y s.x s.y il2 at 5e .. 5e+4, then width^2, h^2.
// Divisions are IEEE and expf the accurate one (the build has no fast
// math), as the twin's.
__device__ __forceinline__ void segment_term(const float* r, int stride,
                                             float px, float py,
                                             const StepConsts& sc, float& tx,
                                             float& ty) {
  float best = 0.0f, bdx = 0.0f, bdy = 0.0f;
  bool inside = true;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float q0x = r[(5 * e) * stride];
    const float q0y = r[(5 * e + 1) * stride];
    const float sx = r[(5 * e + 2) * stride];
    const float sy = r[(5 * e + 3) * stride];
    const float il2 = r[(5 * e + 4) * stride];
    float t = ((px - q0x) * sx + (py - q0y) * sy) * il2;
    t = fminf(fmaxf(t, 0.0f), 1.0f);
    const float ddx = px - (q0x + t * sx);
    const float ddy = py - (q0y + t * sy);
    const float d2 = ddx * ddx + ddy * ddy;
    inside = inside && d2 < r[(e < 2 ? 20 : 21) * stride];
    if (e == 0 || d2 < best) {  // the first minimum
      best = d2;
      bdx = ddx;
      bdy = ddy;
    }
  }
  const float dmin = sqrtf(fmaxf(best, PEDONI_EPS));
  const float coef = sc.obs_strength * expf(-dmin / sc.obs_range) / dmin;
  tx = inside ? 0.0f : coef * bdx;
  ty = inside ? 0.0f : coef * bdy;
}

template <bool kSeg>
__global__ void step_sample(const float* __restrict__ d,
                            const float4* __restrict__ fields,
                            float* __restrict__ act_out,
                            float4* __restrict__ ea, float* __restrict__ out,
                            Dims dm, StepConsts sc,
                            const float* __restrict__ segs, int n_walk,
                            int write_pot) {
  const int64_t plane_sz = (int64_t)dm.ny2 * dm.k * dm.nxl;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= plane_sz) return;
  const int lane = (int)(idx % dm.nxl);
  const int64_t rk = idx / dm.nxl;  // row * K + k
  const int row = (int)(rk / dm.k);
  const int64_t nxl = dm.nxl;
  const float* src = d + rk * 8 * nxl + lane;
  const float act = src[6 * nxl];
  const bool center = row >= 1 && row <= dm.ny2 - 2;
  const bool pot_out = write_pot && center;
  // act' = act or 0: a slot whose flag is 0 needs its sample only where the
  // potential itself is an output
  if (act == 0.0f && !pot_out) {
    act_out[idx] = 0.0f;
    return;
  }
  const float posx = sanitize(src[0]);
  const float posy = sanitize(src[nxl]);
  const float dest = src[5 * nxl];
  const float px = posx * sc.inv_unit - 0.5f + kFpad;
  const float py = posy * sc.inv_unit - 0.5f + kFpad;
  const int64_t plane_stride = (int64_t)dm.frows * dm.stride * nxl * 2;

  // The agent's own destination plane; a dest that names no plane samples
  // 0 (and so despawns), as the reference's dest == plane selects do.  A
  // slot that may go on to the forces takes the obstacle map, which shares
  // the texels, in the same pass.
  const bool full = center && act != 0.0f;
  float pv[3] = {0.0f, 0.0f, 0.0f};
  float ov[3] = {0.0f, 0.0f, 0.0f};
  if (dest >= 0.0f && dest < (float)dm.n_wp && dest == floorf(dest)) {
    const float4* plane = fields + (int64_t)dest * plane_stride;
    if (full && !kSeg)
      sample<true>(plane, dm, row, lane, px, py, 3, pv, ov);
    else
      sample<false>(plane, dm, row, lane, px, py, full ? 3 : 1, pv, ov);
  }
  const float pot = pv[0];
  const bool in_grid =
      posx >= 0.0f && posx < sc.grid_w && posy >= 0.0f && posy < sc.grid_h;
  const float act_new = (pot > sc.despawn_potential && in_grid) ? act : 0.0f;
  act_out[idx] = act_new;
  if (pot_out) out[(rk * 8 + 7) * nxl + lane] = pot;
  // the pair pass reads e and acc of no other slot
  if (!(center && act_new > 0.5f)) return;

  const float velx = sanitize(src[2 * nxl]);
  const float vely = sanitize(src[3 * nxl]);
  const float speed = sanitize(src[4 * nxl]);
  const float gx = pv[1], gy = pv[2];
  const float g_norm = rsqrtf(fmaxf(gx * gx + gy * gy, PEDONI_EPS));
  const float ex = gx * g_norm;
  const float ey = gy * g_norm;
  float afx = (ex * speed - velx) / sc.relaxation_time;
  float afy = (ey * speed - vely) / sc.relaxation_time;
  if constexpr (kSeg) {  // a short table is walked here, else in the pass
    float sfx = 0.0f, sfy = 0.0f;
    for (int o = 0; o < n_walk; ++o) {
      float tx, ty;
      segment_term(segs + o * kSegCols, 1, posx, posy, sc, tx, ty);
      sfx = sfx + tx;
      sfy = sfy + ty;
    }
    afx = afx + sfx;
    afy = afy + sfy;
  } else {
    const float d_norm = rsqrtf(fmaxf(ov[1] * ov[1] + ov[2] * ov[2], PEDONI_EPS));
    const float mag = sc.obs_strength * expf(-ov[0] / sc.obs_range);
    afx = afx - mag * ov[1] * d_norm;
    afy = afy - mag * ov[2] * d_norm;
  }
  ea[idx] = make_float4(ex, ey, afx, afy);
}

// Shared memory of step_pairs for a tile of `tr` rows at `k` slots, in
// bytes, and what segments mode adds; step_kernel.py::pair_pass_smem_bytes
// is the same sum.
__host__ __device__ constexpr int64_t pairs_smem_bytes(int tr, int k) {
  const int64_t h = tr + 2;
  return 8 * h * k                        // row bitmasks
         + 16 * h * k * kHaloLanes        // staged pos.x, pos.y, vel.x, vel.y
         + 20 * (int64_t)tr * k * kTileLanes  // act', new pos/vel
         + 4 * h                          // top candidate slot + 1 per row
         + 4 * ((int64_t)tr + 1)          // live agents per tile row, total
         + 2 * (int64_t)tr * k * kTileLanes;  // the agent list
}
__host__ __device__ constexpr int64_t segment_smem_bytes() {
  return 4 * (int64_t)kSegCols * kSegCap  // kept rows, column-major
         + 8 * (int64_t)kTermCap          // terms (x, y)
         + 16 * kMaxWarps                 // per-warp box / counts
         + 16;                            // resume row
}
// Where the levels are staged `levels` at a time (levels < k): the staged
// pos/vel of that many levels, which the segment pass's room shares.
__host__ __device__ constexpr int64_t chunked_smem_bytes(int tr, int k,
                                                         int levels,
                                                         bool seg) {
  const int64_t h = tr + 2, stage = 16 * h * levels * kHaloLanes;
  const int64_t room = seg && segment_smem_bytes() > stage
                           ? segment_smem_bytes() : stage;
  return pairs_smem_bytes(tr, k) - 16 * h * k * kHaloLanes + room;
}

// 2'. segments mode: the obstacle acceleration of each of the n_live listed
// agents into sfx[si], sfy[si] (see the header).  `list` entries and the
// positions cpx / cpy are step_pairs': the staged halo (kTileIdx false) or
// the tile's own slots, indexed as sfx (kTileIdx true, where the levels are
// staged in chunks); every thread of the block calls it, and it ends
// behind a barrier.
template <bool kTileIdx>
__device__ void segment_pass(const float* __restrict__ segs, int n_seg,
                             const StepConsts& sc, const unsigned short* list,
                             int n_live, int K, const float* cpx,
                             const float* cpy, float* sfx, float* sfy,
                             unsigned char* smem) {
  float* obs = (float*)smem;               // [kSegCols][kSegCap]
  float* tx = obs + kSegCols * kSegCap;    // [kTermCap]
  float* ty = tx + kTermCap;               // [kTermCap]
  float* wred = ty + kTermCap;             // [kMaxWarps][4]
  int* wcnt = (int*)wred;                  // [kMaxWarps], after the box
  int* resume = (int*)(wred + 4 * kMaxWarps);
  const int tid = threadIdx.x, t = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const float inf = __int_as_float(0x7f800000);

  // the box of the listed agents; every sum starts at +0
  float x0 = inf, x1 = -inf, y0 = inf, y1 = -inf;
  for (int i = tid; i < n_live; i += nthreads) {
    const int e = list[i];
    const int k = e & 255, w = e >> 13, lt = (e >> 8) & 31;
    const int si = (w * K + k) * kTileLanes + lt;
    const int own = kTileIdx ? si : ((w + 1) * K + k) * kHaloLanes + lt + 1;
    sfx[si] = 0.0f;
    sfy[si] = 0.0f;
    x0 = fminf(x0, cpx[own]);
    x1 = fmaxf(x1, cpx[own]);
    y0 = fminf(y0, cpy[own]);
    y1 = fmaxf(y1, cpy[own]);
  }
  for (int off = 16; off > 0; off >>= 1) {
    x0 = fminf(x0, __shfl_xor_sync(kFullWarp, x0, off));
    x1 = fmaxf(x1, __shfl_xor_sync(kFullWarp, x1, off));
    y0 = fminf(y0, __shfl_xor_sync(kFullWarp, y0, off));
    y1 = fmaxf(y1, __shfl_xor_sync(kFullWarp, y1, off));
  }
  if (t == 0) {
    wred[4 * warp] = x0;
    wred[4 * warp + 1] = x1;
    wred[4 * warp + 2] = y0;
    wred[4 * warp + 3] = y1;
  }
  __syncthreads();
  for (int w = 0; w < nwarps; ++w) {
    x0 = fminf(x0, wred[4 * w]);
    x1 = fmaxf(x1, wred[4 * w + 1]);
    y0 = fminf(y0, wred[4 * w + 2]);
    y1 = fmaxf(y1, wred[4 * w + 3]);
  }
  __syncthreads();  // wred is reused as wcnt below
  const float cull = sc.seg_cull;
  const unsigned below = (1u << t) - 1u;

  for (int start = 0; start < n_seg;) {
    // the next kept rows from `start`, at most kSegCap, in table order
    int n_obs = 0, next = n_seg;
    for (int base = start; base < n_seg; base += nthreads) {
      const int row = base + tid;
      const float* r = segs + (int64_t)row * kSegCols;
      bool keep = false;
      if (row < n_seg) {
        const float ax = __ldg(r), ay = __ldg(r + 1);   // edge 0: q0, s
        const float bx = ax + __ldg(r + 2), by = ay + __ldg(r + 3);
        const float cx = __ldg(r + 5), cy = __ldg(r + 6);  // edge 1: q0, s
        const float dx = cx + __ldg(r + 7), dy = cy + __ldg(r + 8);
        const float ox0 = fminf(fminf(ax, bx), fminf(cx, dx));
        const float ox1 = fmaxf(fmaxf(ax, bx), fmaxf(cx, dx));
        const float oy0 = fminf(fminf(ay, by), fminf(cy, dy));
        const float oy1 = fmaxf(fmaxf(ay, by), fmaxf(cy, dy));
        const float gx = fmaxf(ox0 - x1, x0 - ox1);  // < 0: the boxes overlap
        const float gy = fmaxf(oy0 - y1, y0 - oy1);
        keep = !(gx >= cull || gy >= cull);  // a NaN corner keeps the row
      }
      const unsigned bal = __ballot_sync(kFullWarp, keep);
      if (t == 0) wcnt[warp] = __popc(bal);
      __syncthreads();
      int before = 0, total = 0;
      for (int w = 0; w < nwarps; ++w) {
        const int c = wcnt[w];
        before += w < warp ? c : 0;
        total += c;
      }
      const int pos = n_obs + before + __popc(bal & below);
      if (keep && pos < kSegCap) {
        for (int c = 0; c < kSegCols; ++c) obs[c * kSegCap + pos] = __ldg(r + c);
        if (pos == kSegCap - 1) *resume = row + 1;
      }
      __syncthreads();
      if (n_obs + total >= kSegCap) {
        n_obs = kSegCap;
        next = *resume;
        break;
      }
      n_obs += total;
    }
    // the terms, agents fastest, then each agent's sum in table order
    if (n_obs > 0) {
      const int per = kTermCap / n_obs;  // agents a round, >= 16
      for (int a0 = 0; a0 < n_live; a0 += per) {
        const int na = min(per, n_live - a0);
        for (int it = tid; it < na * n_obs; it += nthreads) {
          const int o = it / na;
          const int e = list[a0 + it - o * na];
          const int k = e & 255, w = e >> 13, lt = (e >> 8) & 31;
          const int own = kTileIdx ? (w * K + k) * kTileLanes + lt
                                   : ((w + 1) * K + k) * kHaloLanes + lt + 1;
          segment_term(obs + o, kSegCap, cpx[own], cpy[own], sc, tx[it],
                       ty[it]);
        }
        __syncthreads();
        for (int q = tid; q < 2 * na; q += nthreads) {
          const int a = q >> 1;
          const int e = list[a0 + a];
          const int k = e & 255, w = e >> 13, lt = (e >> 8) & 31;
          const int si = (w * K + k) * kTileLanes + lt;
          const float* src = (q & 1) ? ty : tx;
          float* dst = (q & 1) ? sfy : sfx;
          float acc = dst[si];
          for (int o = 0; o < n_obs; ++o) acc = acc + src[o * na + a];
          dst[si] = acc;
        }
        __syncthreads();
      }
    }
    start = next;
  }
}

template <bool kSeg, bool kChunked, bool kCount>
__device__ __forceinline__ void pairs_body(
    const float* __restrict__ d, const float* __restrict__ act_in,
    const float4* __restrict__ ea, float* __restrict__ out,
    float* __restrict__ m, float* __restrict__ movf, float* __restrict__ mdmx,
    const Dims& dm, const StepConsts& sc, int tr, int mk, int rb,
    const float* __restrict__ segs, int n_seg, int levels,
    unsigned long long* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int K = dm.k;
  const int H = tr + 2;
  const int C = kChunked ? levels : K;  // slot levels staged at once
  const int n_halo = H * C * kHaloLanes;
  const int n_tile = tr * K * kTileLanes;
  unsigned long long* rowmask = (unsigned long long*)smem_raw;  // [H][K]
  // the staged pos/vel [H][C][34]: after the masks, or where the levels are
  // staged in chunks, after the list (the segment pass's room too)
  float* cpx = (float*)(rowmask + H * K);
  float* sact = kChunked ? cpx : cpx + 4 * n_halo;  // [tr][K][32]
  float* rpx = sact + n_tile;
  float* rpy = rpx + n_tile;
  float* rvx = rpy + n_tile;
  float* rvy = rvx + n_tile;
  int* jtop = (int*)(rvy + n_tile);  // [H]
  int* rowlive = jtop + H;           // [tr + 1]
  unsigned short* list = (unsigned short*)(rowlive + tr + 1);  // [n_tile]
  if (kChunked) cpx = (float*)(list + n_tile);
  float* cpy = cpx + n_halo;
  float* cvx = cpy + n_halo;
  float* cvy = cvx + n_halo;
  // after the pair loop the list's room holds the movers of each cell
  unsigned char* mslots = (unsigned char*)list;  // [tr * 32][mk] slot indices
  unsigned char* mcnt = mslots + n_tile;         // [tr * 32] movers, <= K

  const int tid = threadIdx.x;
  const int t = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int l0 = blockIdx.x * kTileLanes;  // first lane of the tile
  const int row0 = 1 + blockIdx.y * tr;    // first (centre) row of the tile
  const int64_t nxl = dm.nxl;
  const int last = dm.ny2 - 2;             // last centre row

  // 1. one warp per (halo row, slot), 34 lanes in two turns (lanes 0, 1 of
  // the warp take halo lanes 32, 33).  Every load is started before any is
  // used; lanes -1 and NXL and rows past the grid hold no cell.  Where the
  // levels are staged in chunks, this pass takes the masks and act' alone
  // (the pos/vel come in step 3), and the tile's own positions next.
  for (int it = warp; it < H * K; it += nwarps) {
    const int hr = it / K;
    const int j = it - hr * K;
    const int row = row0 - 1 + hr;
    const int64_t slot = (int64_t)row * K + j;
    float a[2], bound[2], v[2][4];
    bool cell[2];
#pragma unroll
    for (int turn = 0; turn < 2; ++turn) {
      const int lane = l0 - 1 + (turn ? kTileLanes + t : t);
      cell[turn] = (turn ? t < 2 : true) && row <= last + 1 && lane >= 0 &&
                   lane < dm.nxl;
      a[turn] = bound[turn] = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) v[turn][c] = 0.0f;
      if (cell[turn]) {
        a[turn] = act_in[slot * nxl + lane];
        bound[turn] = d[((int64_t)row * K * 8 + 7) * nxl + lane];
        const float* cs = d + slot * 8 * nxl + lane;
        if (!kChunked) {
#pragma unroll
          for (int c = 0; c < 4; ++c) v[turn][c] = cs[c * nxl];
        }
      }
    }
    unsigned long long mask = 0;
#pragma unroll
    for (int turn = 0; turn < 2; ++turn) {
      const int hl = turn ? kTileLanes + t : t;
      const bool mine = turn ? t < 2 : true;
      const bool valid = cell[turn] && a[turn] > 0.5f && (float)j < bound[turn];
      if (mine) {
        if (!kChunked) {
          const int ci = it * kHaloLanes + hl;
          cpx[ci] = sanitize(v[turn][0]);
          cpy[ci] = sanitize(v[turn][1]);
          cvx[ci] = sanitize(v[turn][2]);
          cvy[ci] = sanitize(v[turn][3]);
        }
        if (hr >= 1 && hr <= tr && hl >= 1 && hl <= kTileLanes)
          sact[((hr - 1) * K + j) * kTileLanes + hl - 1] =
              row <= last ? a[turn] : 0.0f;
      }
      const unsigned bal = __ballot_sync(kFullWarp, valid);
      mask |= turn ? (unsigned long long)(bal & 3u) << kTileLanes
                   : (unsigned long long)bal;
    }
    if (t == 0) rowmask[it] = mask;
  }
  if (kChunked) {  // the tile's own positions wait in the new pos's room
    for (int it = warp; it < tr * K; it += nwarps) {
      const int row = row0 + it / K;
      if (row > last) break;  // `it` grows with the row
      const float* cs = d + ((int64_t)row * K + it % K) * 8 * nxl + l0 + t;
      rpx[it * kTileLanes + t] = sanitize(cs[0]);
      rpy[it * kTileLanes + t] = sanitize(cs[nxl]);
    }
  }
  __syncthreads();

  // 2. the list of live centre agents, cell by cell: warp w < tr owns tile
  // row w, one thread per cell
  int cell_live = 0;
  if (tid < H) {  // top candidate slot + 1 of each halo row
    int top = K;
    while (top > 0 && rowmask[tid * K + top - 1] == 0) --top;
    jtop[tid] = top;
  }
  if (warp < tr) {
    for (int j = 0; j < K; ++j)
      cell_live += sact[(warp * K + j) * kTileLanes + t] > 0.5f ? 1 : 0;
    int incl = cell_live;
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(kFullWarp, incl, off);
      if (t >= off) incl += v;
    }
    if (t == 31) rowlive[warp] = incl;
    cell_live = incl - cell_live;  // exclusive, within the row
  }
  __syncthreads();
  if (warp < tr) {
    int at = cell_live;
    for (int w = 0; w < warp; ++w) at += rowlive[w];
    for (int j = 0; j < K; ++j)
      if (sact[(warp * K + j) * kTileLanes + t] > 0.5f)
        list[at++] = (unsigned short)(((warp * kTileLanes + t) << 8) | j);
  }
  __syncthreads();
  int n_live = 0;
  for (int w = 0; w < tr; ++w) n_live += rowlive[w];
  if constexpr (kSeg) {
    if (n_live > 0) {  // the same for the whole block
      if constexpr (kChunked)  // the sums go to the new vel's room
        segment_pass<true>(segs, n_seg, sc, list, n_live, K, rpx, rpy, rvx,
                           rvy, (unsigned char*)cpx);
      else
        segment_pass<false>(segs, n_seg, sc, list, n_live, K, cpx, cpy, rpx,
                            rpy, (unsigned char*)(list + n_tile));
    }
  }

  if constexpr (kChunked) {
    // 3, in chunks: each listed agent's acceleration waits in the new vel's
    // room; the levels [j0, j0 + C) of the tile and its halo are staged, and
    // every agent walks them as below; then the integration.  The chunks
    // come in slot order, so the sums are taken in the same order.
    for (int i = tid; i < n_live; i += blockDim.x) {
      const int e = list[i];
      const int k = e & 255, w = e >> 13, lt = (e >> 8) & 31;
      const int si = (w * K + k) * kTileLanes + lt;
      const float4 f = ea[((int64_t)(row0 + w) * K + k) * nxl + l0 + lt];
      float accx = f.z, accy = f.w;
      if constexpr (kSeg) {  // the goal acceleration + the obstacle sum
        accx = accx + rvx[si];
        accy = accy + rvy[si];
      }
      rvx[si] = accx;
      rvy[si] = accy;
    }
    int jblk = 0;  // top candidate slot + 1 of the block
    for (int h = 0; h < H; ++h) jblk = max(jblk, jtop[h]);
    for (int js = 0; js < jblk; js += C) {
      const int nc = min(C, jblk - js);
      __syncthreads();  // the last chunk's walk is done with the staging room
      for (int it = warp; it < H * nc; it += nwarps) {
        const int hr = it / nc;
        const int jj = it - hr * nc;
        const int row = row0 - 1 + hr;
        float v[2][4];
#pragma unroll
        for (int turn = 0; turn < 2; ++turn) {
          const int lane = l0 - 1 + (turn ? kTileLanes + t : t);
#pragma unroll
          for (int c = 0; c < 4; ++c) v[turn][c] = 0.0f;
          if ((turn ? t < 2 : true) && row <= last + 1 && lane >= 0 &&
              lane < dm.nxl) {
            const float* cs = d + ((int64_t)row * K + js + jj) * 8 * nxl + lane;
#pragma unroll
            for (int c = 0; c < 4; ++c) v[turn][c] = cs[c * nxl];
          }
        }
#pragma unroll
        for (int turn = 0; turn < 2; ++turn) {
          if (turn && t >= 2) continue;
          const int ci = (hr * C + jj) * kHaloLanes + (turn ? kTileLanes + t : t);
          cpx[ci] = sanitize(v[turn][0]);
          cpy[ci] = sanitize(v[turn][1]);
          cvx[ci] = sanitize(v[turn][2]);
          cvy[ci] = sanitize(v[turn][3]);
        }
      }
      __syncthreads();
      for (int base = 0; base < n_live; base += blockDim.x) {
        const int i = base + tid;
        const bool has = i < n_live;
        const int entry = has ? list[i] : 0;
        const int k = entry & 255;
        const int w = entry >> 13;
        const int lt = (entry >> 8) & 31;
        const int si = (w * K + k) * kTileLanes + lt;
        const float px = rpx[si], py = rpy[si];
        float ex = 0.0f, ey = 0.0f, accx = 0.0f, accy = 0.0f;
        int jend = 0;
        if (has) {
          const float4 f = ea[((int64_t)(row0 + w) * K + k) * nxl + l0 + lt];
          ex = f.x;
          ey = f.y;
          accx = rvx[si];
          accy = rvy[si];
          jend = min(js + nc, max(jtop[w], max(jtop[w + 1], jtop[w + 2])));
        }
        const unsigned long long* rm = rowmask + w * K;
        const int jwarp = __reduce_max_sync(kFullWarp, jend);
        for (int j0 = js; j0 < jwarp; j0 += kChunk) {
          unsigned long long hits = 0;
          const int j1 = min(j0 + kChunk, jend);
          for (int j = j0; j < j1; ++j) {
            unsigned bits = (unsigned)((rm[j] >> lt) & 7ull) |
                            (unsigned)((rm[K + j] >> lt) & 7ull) << 3 |
                            (unsigned)((rm[2 * K + j] >> lt) & 7ull) << 6;
            if (j == k) bits &= ~16u;  // self
            if (bits == 0) continue;
            const int c0 = (w * C + j - js) * kHaloLanes + lt;
            unsigned in = 0;
#pragma unroll
            for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
              for (int dx = 0; dx < 3; ++dx) {
                const int ci = c0 + dy * C * kHaloLanes + dx;
                const float ddx = px - cpx[ci];
                const float ddy = py - cpy[ci];
                if (pair_in_cutoff(ddx * ddx + ddy * ddy, sc.pair))
                  in |= 1u << (3 * dy + dx);
              }
            }
            hits |= (unsigned long long)(bits & in) << (9 * (j - j0));
          }
          while (__any_sync(kFullWarp, hits != 0)) {
            if (hits) {
              const int b = __ffsll((long long)hits) - 1;
              hits &= hits - 1;
              const int jj = b / 9;
              const int c = b - 9 * jj;
              const int dy = c / 3;
              const int ci = ((w + dy) * C + j0 - js + jj) * kHaloLanes + lt +
                             (c - 3 * dy);
              pair_force(accx, accy, px, py, ex, ey, cpx[ci], cpy[ci],
                         cvx[ci], cvy[ci], sc.pair);
            }
          }
        }
        if (has) {
          rvx[si] = accx;
          rvy[si] = accy;
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < n_live; i += blockDim.x) {
      const int e = list[i];
      const int k = e & 255, w = e >> 13, lt = (e >> 8) & 31;
      const int si = (w * K + k) * kTileLanes + lt;
      const float* cs = d + ((int64_t)(row0 + w) * K + k) * 8 * nxl + l0 + lt;
      const float velx = sanitize(cs[2 * nxl]), vely = sanitize(cs[3 * nxl]);
      const float speed = sanitize(cs[4 * nxl]);
      const float px = rpx[si], py = rpy[si];
      // Trapezoidal integration with the speed clamp (sfm.rs:245-254).
      float vx = velx + rvx[si] * sc.dt;
      float vy = vely + rvy[si] * sc.dt;
      const float vmax = speed * sc.max_speed_factor;
      const float vlen = sqrtf(fmaxf(vx * vx + vy * vy, PEDONI_EPS));
      const float scale = fminf(1.0f, vmax / vlen);
      vx = vx * scale;
      vy = vy * scale;
      rpx[si] = px + (vx + velx) * sc.dt_half;
      rpy[si] = py + (vy + vely) * sc.dt_half;
      rvx[si] = vx;
      rvy[si] = vy;
    }
  } else {
    // 3. one thread per live agent
    unsigned long long n_pairs = 0, n_body = 0, n_tests = 0, n_walk = 0;
    for (int base = 0; base < n_live; base += blockDim.x) {
      const int i = base + tid;
      const bool has = i < n_live;
      const int entry = has ? list[i] : 0;
      const int k = entry & 255;
      const int w = entry >> 13;        // tile row
      const int lt = (entry >> 8) & 31;  // tile lane
      const int si = (w * K + k) * kTileLanes + lt;
      const int own = ((w + 1) * K + k) * kHaloLanes + lt + 1;
      const float px = cpx[own], py = cpy[own];
      const float velx = cvx[own], vely = cvy[own];
      float ex = 0.0f, ey = 0.0f, accx = 0.0f, accy = 0.0f, speed = 0.0f;
      int jend = 0;
      if (has) {
        const int64_t slot = (int64_t)(row0 + w) * K + k;
        const float4 f = ea[slot * nxl + l0 + lt];
        ex = f.x;
        ey = f.y;
        accx = f.z;
        accy = f.w;
        if constexpr (kSeg) {  // the goal acceleration + the obstacle sum
          accx = accx + rpx[si];
          accy = accy + rpy[si];
        }
        speed = sanitize(d[(slot * 8 + 4) * nxl + l0 + lt]);
        jend = max(jtop[w], max(jtop[w + 1], jtop[w + 2]));
      }
      // The walk, in chunks of kChunk slot levels.  Light part, no branch on
      // the data: per level j the 9 cells' candidate bits, and the cutoff
      // test of all 9 slots (a slot that holds no candidate reads whatever
      // shared memory holds there; its bit is clear).  Bit 9 * (j - j0) +
      // 3 * (dy + 1) + dx + 1 of `hits` = a candidate within the cutoff, so
      // ascending bits are the reference's summation order.  Heavy part: the
      // lanes that still hold a bit pop their lowest and run pair_force
      // together.
      const unsigned long long* rm = rowmask + w * K;
      const int jwarp = __reduce_max_sync(kFullWarp, jend);
      if (kCount) n_walk += 9ull * 32 * jwarp;
      for (int j0 = 0; j0 < jwarp; j0 += kChunk) {
        unsigned long long hits = 0;
        const int j1 = min(j0 + kChunk, jend);
        for (int j = j0; j < j1; ++j) {
          unsigned bits = (unsigned)((rm[j] >> lt) & 7ull) |
                          (unsigned)((rm[K + j] >> lt) & 7ull) << 3 |
                          (unsigned)((rm[2 * K + j] >> lt) & 7ull) << 6;
          if (j == k) bits &= ~16u;  // self
          if (kCount) n_tests += __popc(bits);
          if (bits == 0) continue;
          const int c0 = (w * K + j) * kHaloLanes + lt;
          unsigned in = 0;
  #pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
  #pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
              const int ci = c0 + dy * K * kHaloLanes + dx;
              const float ddx = px - cpx[ci];
              const float ddy = py - cpy[ci];
              if (pair_in_cutoff(ddx * ddx + ddy * ddy, sc.pair))
                in |= 1u << (3 * dy + dx);
            }
          }
          hits |= (unsigned long long)(bits & in) << (9 * (j - j0));
        }
        while (__any_sync(kFullWarp, hits != 0)) {
          if (kCount) {
            n_body += 32;
            n_pairs += __popc(__ballot_sync(kFullWarp, hits != 0));
          }
          if (hits) {
            const int b = __ffsll((long long)hits) - 1;
            hits &= hits - 1;
            const int jj = b / 9;
            const int c = b - 9 * jj;
            const int dy = c / 3;
            const int ci =
                ((w + dy) * K + j0 + jj) * kHaloLanes + lt + (c - 3 * dy);
            pair_force(accx, accy, px, py, ex, ey, cpx[ci], cpy[ci], cvx[ci],
                       cvy[ci], sc.pair);
          }
        }
      }
      if (has) {
        // Trapezoidal integration with the speed clamp (sfm.rs:245-254).
        float vx = velx + accx * sc.dt;
        float vy = vely + accy * sc.dt;
        const float vmax = speed * sc.max_speed_factor;
        const float vlen = sqrtf(fmaxf(vx * vx + vy * vy, PEDONI_EPS));
        const float scale = fminf(1.0f, vmax / vlen);
        vx = vx * scale;
        vy = vy * scale;
        rpx[si] = px + (vx + velx) * sc.dt_half;
        rpy[si] = py + (vy + vely) * sc.dt_half;
        rvx[si] = vx;
        rvy[si] = vy;
      }
    }
    if (kCount) {
      for (int off = 16; off > 0; off >>= 1)
        n_tests += __shfl_down_sync(kFullWarp, n_tests, off);
      if (t == 0) {
        atomicAdd(counts + kPairs, n_pairs);
        atomicAdd(counts + kBodyLanes, n_body);
        atomicAdd(counts + kTests, n_tests);
        atomicAdd(counts + kWalkLanes, n_walk);
      }
    }
  }
  __syncthreads();

  // 4. mover mode: warp w < tr owns tile row w, one thread per cell: the
  // cell's movers in slot order, into shared memory
  const bool top = blockIdx.y == 0;
  const int ms = mk < K ? mk : K;  // a cell has at most K movers
  const bool bottom = row0 + tr > last;
  if (mk > 0 && warp < tr && row0 + warp <= last) {
    const int row = row0 + warp;
    const int lane = l0 + t;
    const int cell = warp * kTileLanes + t;
    const bool emits = lane >= dm.mlo && lane <= dm.mhi;
    int cnt = 0;
    for (int j = 0; emits && j < K; ++j) {
      const int si = (warp * K + j) * kTileLanes + t;
      const float a = sact[si];
      if (!(a > 0.5f)) continue;  // a mover is live: its pos/vel are new
      const float tgt_lane = floorf(__fdiv_rn(rpx[si], sc.cell_unit)) + 1.0f;
      const float tgt_row = floorf(__fdiv_rn(rpy[si], sc.cell_unit));
      const float same = (tgt_lane == (float)(lane + dm.coff) &&
                          tgt_row == (float)(row - 1 + dm.roff))
                             ? 1.0f : 0.0f;
      if (!(a * (1.0f - same) > 0.5f)) continue;
      if (cnt < mk) mslots[cell * ms + cnt] = (unsigned char)j;
      ++cnt;
    }
    mcnt[cell] = (unsigned char)cnt;
    float over = (float)(cnt > mk ? cnt - mk : 0);
    int peak = cnt;
    for (int off = 16; off > 0; off >>= 1) {
      over += __shfl_down_sync(kFullWarp, over, off);
      const int p2 = __shfl_down_sync(kFullWarp, peak, off);
      peak = p2 > peak ? p2 : peak;
    }
    if (t == 0) {
      const int b = (row - 1) / rb;
      if (over != 0.0f) atomicAdd(movf + b, over);
      // non-negative floats order as their bit patterns do
      if (peak > 0) atomicMax((int*)(mdmx + b), __float_as_int((float)peak));
    }
  }

  // 5. output: one warp per (tile row, slot), whole rows of lanes
  for (int it = warp; it < tr * K; it += nwarps) {
    const int w = it / K;
    const int k = it - w * K;
    const int row = row0 + w;
    if (row > last) break;  // `it` grows with w
    const int lane = l0 + t;
    const int si = it * kTileLanes + t;
    const int own = ((w + 1) * K + k) * kHaloLanes + t + 1;
    const int64_t at = ((int64_t)row * K + k) * 8 * nxl + lane;
    const float* src = d + at;
    const float speed = src[4 * nxl];
    const float dest = src[5 * nxl];
    const float a = sact[si];
    const bool live = a > 0.5f;
    // a slot that is not live passes its sanitized pos/vel through: staged,
    // or where the levels were staged in chunks, read again
    const float npx = live ? rpx[si] : kChunked ? sanitize(src[0]) : cpx[own];
    const float npy = live ? rpy[si] : kChunked ? sanitize(src[nxl]) : cpy[own];
    float* dst = out + at;
    dst[0] = npx;
    dst[nxl] = npy;
    dst[2 * nxl] = live ? rvx[si] : kChunked ? sanitize(src[2 * nxl]) : cvx[own];
    dst[3 * nxl] = live ? rvy[si] : kChunked ? sanitize(src[3 * nxl]) : cvy[own];
    dst[4 * nxl] = sanitize(speed);
    dst[5 * nxl] = dest;
    dst[6 * nxl] = a;
    if (mk > 0) {  // the stay mask; else ch 7 holds step_sample's potential
      const float tgt_lane = floorf(__fdiv_rn(npx, sc.cell_unit)) + 1.0f;
      const float tgt_row = floorf(__fdiv_rn(npy, sc.cell_unit));
      const float same = (tgt_lane == (float)(lane + dm.coff) &&
                          tgt_row == (float)(row - 1 + dm.roff))
                             ? 1.0f : 0.0f;
      dst[7 * nxl] = a * same;
    }
  }

  // 6. mover mode: M, one warp per (tile row, mover row), whole rows of lanes
  if (mk > 0) {
    __syncthreads();
    for (int it = warp; it < tr * mk; it += nwarps) {
      const int w = it / mk;
      const int r = it - w * mk;
      const int row = row0 + w;
      if (row > last) break;
      const int lane = l0 + t;
      const int cell = w * kTileLanes + t;
      const int cnt = mcnt[cell];
      const int kept = cnt < mk ? cnt : mk;
      float val[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      if (r < kept) {
        const int j = mslots[cell * ms + r];
        const int si = (w * K + j) * kTileLanes + t;
        const float* cs = d + ((int64_t)row * K + j) * 8 * nxl + lane;
        val[0] = rpx[si];
        val[1] = rpy[si];
        val[2] = rvx[si];
        val[3] = rvy[si];
        val[4] = sanitize(cs[4 * nxl]);
        val[5] = cs[5 * nxl];
      }
      float* o = m + ((int64_t)row * mk + r) * 8 * nxl + lane;
#pragma unroll
      for (int c = 0; c < 6; ++c) o[c * nxl] = val[c];
      o[6 * nxl] = r < cnt ? 1.0f : 0.0f;
      o[7 * nxl] = (float)kept;
    }
  }
  // ghost rows of out and M: zeros
  for (int g = 0; g < 2; ++g) {
    if (!(g ? bottom : top)) continue;
    const int row = g ? last + 1 : 0;
    float* o = out + (int64_t)row * K * 8 * nxl + l0 + t;
    for (int it = warp; it < K * 8; it += nwarps) o[it * nxl] = 0.0f;
    if (mk > 0) {
      float* om = m + (int64_t)row * mk * 8 * nxl + l0 + t;
      for (int it = warp; it < mk * 8; it += nwarps) om[it * nxl] = 0.0f;
    }
  }
}

// The pair pass of the base and mover modes, and of segments mode, at the
// 40 registers that let three blocks reside on an SM, as step_kernel.py::
// PAIR_BLOCKS_SM counts on when it picks the tile.  The base mode takes 40
// unbounded (bound to three blocks it ran 2.5% slower, and an
// explicit minimum of one block an SM slowed it too); the segments kernel
// asks for three: at 64 registers it got two, and the 1M segment state's
// kernel ran 13% slower (PERF.md).  The _chunked kernels stage the slot
// levels `levels` at a time, for a K whose one-row tile does not fit a
// block's shared memory (one block an SM).
#define PEDONI_PAIRS_KERNEL(name, bounds, seg, chunked, count)                \
  __global__ void bounds name(                                               \
      const float* __restrict__ d, const float* __restrict__ act_in,         \
      const float4* __restrict__ ea, float* __restrict__ out,                \
      float* __restrict__ m, float* __restrict__ movf,                       \
      float* __restrict__ mdmx, Dims dm, StepConsts sc, int tr, int mk,      \
      int rb, const float* __restrict__ segs, int n_seg, int levels,         \
      unsigned long long* __restrict__ counts) {                             \
    pairs_body<seg, chunked, count>(d, act_in, ea, out, m, movf, mdmx, dm,   \
                                    sc, tr, mk, rb, segs, n_seg, levels,     \
                                    counts);                                 \
  }
PEDONI_PAIRS_KERNEL(step_pairs, __launch_bounds__(512), false, false, false)
PEDONI_PAIRS_KERNEL(step_pairs_segments, __launch_bounds__(512, 3), true, false,
                    false)
PEDONI_PAIRS_KERNEL(step_pairs_chunked, __launch_bounds__(512), false, true,
                    false)
PEDONI_PAIRS_KERNEL(step_pairs_segments_chunked, __launch_bounds__(512), true,
                    true, false)
// the occupancy counter's build of step_pairs (never launched by a step)
PEDONI_PAIRS_KERNEL(step_pairs_count, __launch_bounds__(512), false, false,
                    true)
#undef PEDONI_PAIRS_KERNEL

// consts: 19 floats in StepConsts order (see step_kernel.py::_constants).
// mk == 0 is the base mode (m, movf, mdmx unused); mk > 0 the mover mode,
// where movf and mdmx [nb] must be zeroed by the caller.  n_seg < 0 takes
// the obstacle force from the fields' obstacle channels (segs unused); n_seg >= 0
// from the n_seg rows of segs: walked by the pair pass where seg_pass != 0,
// else by the sample pass.  tile_rows, threads and smem_bytes are the pair
// pass's launch shape (step_kernel.py::pair_pass_launch), with `levels`
// the slot levels it stages at once (k: all); smem_bytes must equal
// pairs_smem_bytes(tile_rows, k), plus segment_smem_bytes() where the pair
// pass walks the table, or chunked_smem_bytes where levels < k.  roff and
// coff place a tile of a larger grid (0 for a whole grid); in the mover
// mode only lanes [movers_lo, movers_hi] emit movers.  Returns a
// cudaError_t, -1 for a launch shape the kernel does not take
// (pair_pass_launch gives tiles of 1 or 2 rows and blocks of 512 threads),
// or PEDONI_WRONG_DEVICE (device.cuh) for a grid off the current device.
int step_launch(const float* d, const float* fields, const float* segs,
                float* act, float* ea, float* out, float* m, float* movf,
                float* mdmx, int ny2, int k, int nxl, int n_wp, int frows,
                int stride, int mk, int rb, int n_seg, int seg_pass,
                int tile_rows, int threads, int smem_bytes, int levels,
                int roff, int coff, int movers_lo, int movers_hi,
                const float* consts, unsigned long long* counts,
                void* stream) {
  if (const int w = pedoni_on_current_device(d)) return w;
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
  sc.seg_cull = consts[18];
  const bool seg = n_seg >= 0;
  const bool pass = seg && seg_pass != 0;  // else step_sample walks the table
  const bool chunked = levels < k;
  if (counts && (seg || chunked)) return -1;  // the counter's build: step_pairs
  if (tile_rows < 1 || tile_rows > 2 || k > 255 || threads != 512 ||
      nxl % kTileLanes != 0 || levels < 1 || levels > k ||
      (int64_t)smem_bytes !=
          (chunked ? chunked_smem_bytes(tile_rows, k, levels, pass)
                   : pairs_smem_bytes(tile_rows, k) +
                         (pass ? segment_smem_bytes() : 0)))
    return -1;
  Dims dm{ny2, k, nxl, n_wp, frows, stride, roff, coff, movers_lo, movers_hi};
  const int64_t n = (int64_t)ny2 * k * nxl;
  const int sthreads = 256;
  const unsigned sblocks = (unsigned)((n + sthreads - 1) / sthreads);
  cudaStream_t st = (cudaStream_t)stream;
  const float4* f4 = (const float4*)fields;
  if (seg)
    step_sample<true><<<sblocks, sthreads, 0, st>>>(
        d, f4, act, (float4*)ea, out, dm, sc, segs, pass ? 0 : n_seg, mk == 0);
  else
    step_sample<false><<<sblocks, sthreads, 0, st>>>(
        d, f4, act, (float4*)ea, out, dm, sc, segs, 0, mk == 0);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  auto pairs = counts ? step_pairs_count
               : chunked ? (pass ? step_pairs_segments_chunked : step_pairs_chunked)
                         : (pass ? step_pairs_segments : step_pairs);
  e = cudaFuncSetAttribute(pairs, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)(nxl / kTileLanes),
            (unsigned)((ny2 - 2 + tile_rows - 1) / tile_rows));
  pairs<<<grid, threads, smem_bytes, st>>>(d, act, (const float4*)ea, out, m,
                                           movf, mdmx, dm, sc, tile_rows, mk,
                                           rb, segs, n_seg, levels, counts);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pedoni_step_kernel(const float* d, const float* fields,
                                  const float* segs, float* act, float* ea,
                                  float* out, float* m, float* movf,
                                  float* mdmx, int ny2, int k, int nxl,
                                  int n_wp, int frows, int stride, int mk,
                                  int rb, int n_seg, int seg_pass,
                                  int tile_rows, int threads, int smem_bytes,
                                  int levels, int roff, int coff,
                                  int movers_lo, int movers_hi,
                                  const float* consts, void* stream) {
  return step_launch(d, fields, segs, act, ea, out, m, movf, mdmx, ny2, k, nxl,
                     n_wp, frows, stride, mk, rb, n_seg, seg_pass, tile_rows,
                     threads, smem_bytes, levels, roff, coff, movers_lo,
                     movers_hi, consts, nullptr, stream);
}

// pedoni_step_kernel with the occupancy counter's build of its pair pass:
// adds the pairs evaluated, the lanes of the force body's rounds, the
// candidates tested (below their cell's bound, live, not the agent itself)
// and the lanes' test slots of the walk (9 a lane a slot level its warp
// walks) into counts[0..3] (device memory, int64).  The distance-map mode with
// all levels staged at once; -1 otherwise.
extern "C" int pedoni_step_kernel_occupancy(
    const float* d, const float* fields, const float* segs, float* act,
    float* ea, float* out, float* m, float* movf, float* mdmx, int ny2, int k,
    int nxl, int n_wp, int frows, int stride, int mk, int rb, int n_seg,
    int seg_pass, int tile_rows, int threads, int smem_bytes, int levels,
    int roff, int coff, int movers_lo, int movers_hi, const float* consts,
    unsigned long long* counts, void* stream) {
  return step_launch(d, fields, segs, act, ea, out, m, movf, mdmx, ny2, k, nxl,
                     n_wp, frows, stride, mk, rb, n_seg, seg_pass, tile_rows,
                     threads, smem_bytes, levels, roff, coff, movers_lo,
                     movers_hi, consts, counts, stream);
}
