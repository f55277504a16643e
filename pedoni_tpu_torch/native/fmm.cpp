// Fast-marching-method Eikonal solver (host preprocessing).
//
// C++ counterpart of the reference's Rust solver
// (pedoni-simulator/src/field.rs:118-192): a Dijkstra-like binary-heap sweep
// that propagates arrival times from source cells (potential == 0) outward,
// using the first-order upwind quadratic update.  Runs once per scenario at
// load time; results are shipped to TPU HBM and never touched again.
//
// Semantics notes (kept identical to the Rust code and the Python fallback
// in pedoni_tpu/field.py):
//  - neighbour values used in the update are the *tentative* values, not
//    accepted-only (field.rs:162-171);
//  - out-of-bounds neighbour reads act as +MAX (field.rs:164-169);
//  - seeding assigns f (slowness) directly to the 4-neighbours of each
//    source cell (field.rs:128-146).
//
// Internally computes in double and stores back float32, matching the Python
// fallback bit-for-bit on small grids in practice.

#include <cmath>
#include <cstdint>
#include <limits>
#include <queue>
#include <vector>

namespace {

struct Node {
  double u;
  int64_t idx;
  bool operator>(const Node& o) const { return u > o.u; }
};

constexpr double kMax = 3.4028234663852886e38;  // f32::MAX

}  // namespace

extern "C" void pedoni_fmm(float* potential, const float* slowness,
                           int64_t height, int64_t width) {
  const int64_t n = height * width;
  std::vector<double> pot(n);
  std::vector<uint8_t> accepted(n, 0);
  for (int64_t i = 0; i < n; ++i) pot[i] = potential[i];

  std::priority_queue<Node, std::vector<Node>, std::greater<Node>> heap;

  auto get = [&](int64_t y, int64_t x) -> double {
    if (y < 0 || y >= height || x < 0 || x >= width) return kMax;
    return pot[y * width + x];
  };

  // Seed neighbours of source cells.
  for (int64_t y = 0; y < height; ++y) {
    for (int64_t x = 0; x < width; ++x) {
      const int64_t idx = y * width + x;
      if (potential[idx] != 0.0f) continue;
      accepted[idx] = 1;
      static const int64_t dy[4] = {-1, 1, 0, 0};
      static const int64_t dx[4] = {0, 0, -1, 1};
      for (int k = 0; k < 4; ++k) {
        const int64_t ny = y + dy[k], nx = x + dx[k];
        if (ny < 0 || ny >= height || nx < 0 || nx >= width) continue;
        const int64_t nidx = ny * width + nx;
        if (pot[nidx] == 0.0) continue;
        const double u = slowness[nidx];
        pot[nidx] = u;
        heap.push({u, nidx});
      }
    }
  }

  while (!heap.empty()) {
    const Node node = heap.top();
    heap.pop();
    const int64_t idx = node.idx;
    if (accepted[idx]) continue;
    accepted[idx] = 1;
    const int64_t y = idx / width, x = idx % width;
    const double u = node.u;

    static const int64_t dy[4] = {-1, 1, 0, 0};
    static const int64_t dx[4] = {0, 0, -1, 1};
    for (int k = 0; k < 4; ++k) {
      const int64_t ny = y + dy[k], nx = x + dx[k];
      if (ny < 0 || ny >= height || nx < 0 || nx >= width) continue;
      const int64_t nidx = ny * width + nx;
      if (accepted[nidx]) continue;

      const double f = slowness[nidx];
      double u1, u2;
      if (dy[k] == 0) {  // horizontal step: popped value is the x-neighbour
        u1 = u;
        u2 = std::min(get(ny - 1, nx), get(ny + 1, nx));
      } else {
        u1 = std::min(get(ny, nx - 1), get(ny, nx + 1));
        u2 = u;
      }

      double nu;
      if (u1 >= kMax) {
        nu = u2 + f;
      } else if (u2 >= kMax) {
        nu = u1 + f;
      } else {
        const double sq = 2.0 * f * f - (u1 - u2) * (u1 - u2);
        nu = (sq >= 0.0) ? (u1 + u2 + std::sqrt(sq)) / 2.0
                         : std::min(u1, u2) + f;
      }
      if (nu < pot[nidx]) {
        pot[nidx] = nu;
        heap.push({nu, nidx});
      }
    }
  }

  for (int64_t i = 0; i < n; ++i) potential[i] = static_cast<float>(pot[i]);
}
