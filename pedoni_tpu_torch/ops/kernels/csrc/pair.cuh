// Pair-force core of the fused step kernel (step_kernel.cu) and of the
// standalone pairwise kernel (pairwise.cu).
//
// Replaces pedoni_tpu/ops/pallas/pairwise.py::_pair_accum (pairwise.py:40),
// the Helbing elliptical repulsion of sfm.rs:129-153 in its
// strength-reduced form: every norm through one rsqrt, the FOV test
// divided through by the (positive) force magnitude and squared so neither
// |force| nor |u| is formed.  Its plain PyTorch twin is
// pedoni_tpu_torch/ops/kernels/pairwise.py::pair_accum; both evaluate the
// same f32 operations in the same order.
//
// Norms use rsqrtf, as torch.rsqrt does on the card, and expf (the build
// has no --use_fast_math, so neither becomes an approximate intrinsic).
// The build passes --fmad=false so no a*b+c is contracted into an FMA the
// twin does not perform.
#pragma once

#define PEDONI_EPS 1e-12f

struct PairConsts {
  float cutoff_sq;          // interaction_cutoff^2
  float dt;                 // delta_time
  float dt2;                // delta_time^2
  float half_strength;      // 0.5 * ped_strength
  float neg_half_inv_range; // -0.5 / ped_range
  float cos2;               // cos_phi^2 (cos_phi < 0)
  float fov_damping;
};

// The cutoff test of one candidate at squared distance d2: NaN and the huge
// d2 of a sanitized (2^30) position fail it.
__device__ __forceinline__ bool pair_in_cutoff(float d2, const PairConsts& c) {
  return d2 <= c.cutoff_sq;
}

// The candidate's velocity terms of pair_force: v.x dt, v.y dt and
// |v|^2 dt^2, as the reference hoists them (pairwise.py:127-135).
__device__ __forceinline__ float3 pair_vterms(float cvx, float cvy,
                                              const PairConsts& c) {
  return make_float3(cvx * c.dt, cvy * c.dt, (cvx * cvx + cvy * cvy) * c.dt2);
}

// Accumulate the repulsion of one ACTIVE candidate at (cpx, cpy) with the
// velocity terms vt = pair_vterms(...) WITHIN THE CUTOFF onto one centre
// agent (px, py, ex, ey).  The caller has applied the active,
// self-exclusion and cutoff masks.
__device__ __forceinline__ void pair_force_vt(
    float& ax, float& ay, float px, float py, float ex, float ey,
    float cpx, float cpy, float3 vt, const PairConsts& c) {
  const float dx = px - cpx;
  const float dy = py - cpy;
  const float d2 = dx * dx + dy * dy;
  const float vxdt = vt.x;
  const float vydt = vt.y;
  const float v2dtt = vt.z;
  const float t1x = dx - vxdt;
  const float t1y = dy - vydt;
  const float t1l2 = t1x * t1x + t1y * t1y;
  const float inv_d = rsqrtf(fmaxf(d2, PEDONI_EPS));
  const float inv_t1l = rsqrtf(fmaxf(t1l2, PEDONI_EPS));
  const float t2 = d2 * inv_d + t1l2 * inv_t1l;  // d + |t1|
  const float b2 = fmaxf(t2 * t2 - v2dtt, PEDONI_EPS);
  const float inv_b = rsqrtf(b2);  // 1 / (2b)
  const float mag =
      c.half_strength * expf((b2 * inv_b) * c.neg_half_inv_range) * t2 * inv_b;
  const float ux = dx * inv_d + t1x * inv_t1l;
  const float uy = dy * inv_d + t1y * inv_t1l;
  const float u2 = ux * ux + uy * uy;
  const float eu = ex * ux + ey * uy;
  const bool in_front = eu * fabsf(eu) <= u2 * c.cos2;
  const float m = (in_front ? 1.0f : c.fov_damping) * mag;
  ax = ax + m * ux;
  ay = ay + m * uy;
}

// pair_force_vt with the candidate's velocity (cvx, cvy).
__device__ __forceinline__ void pair_force(
    float& ax, float& ay, float px, float py, float ex, float ey,
    float cpx, float cpy, float cvx, float cvy, const PairConsts& c) {
  pair_force_vt(ax, ay, px, py, ex, ey, cpx, cpy, pair_vterms(cvx, cvy, c), c);
}

// pair_force behind the cutoff test: the caller has applied the active and
// self-exclusion masks only.
__device__ __forceinline__ void pair_accum(
    float& ax, float& ay, float px, float py, float ex, float ey,
    float cpx, float cpy, float cvx, float cvy, const PairConsts& c) {
  const float dx = px - cpx;
  const float dy = py - cpy;
  if (!pair_in_cutoff(dx * dx + dy * dy, c)) return;
  pair_force(ax, ay, px, py, ex, ey, cpx, cpy, cvx, cvy, c);
}
