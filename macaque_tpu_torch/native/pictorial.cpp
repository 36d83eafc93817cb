// Native parity kernels for the pictorial-structure stage.
//
// The reference keeps its only in-repo native code here (Cython/C + OpenMP:
// src/m_lib/pictorial.pyx — max-product inference :109-150 and boolean
// transitive closure :152-185). This C++ library provides the same two
// kernels as CPU oracles for the PyTorch implementations in
// macaque_tpu_torch/association/pictorial.py, exposed via a C ABI for ctypes.
//
// Build: see macaque_tpu_torch/native/build.py (g++ -O3 -fopenmp -shared -fPIC).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {
constexpr int kJoints = 13;
// parent of each joint in the 13-joint tree (root = -1)
constexpr int kParent[kJoints] = {-1, 0, 0, 1, 2, 3, 4, 0, 0, 7, 8, 9, 10};

inline double pair_prior(const double* xa, const double* xb, double mean,
                         double stdd) {
  const double dx = xa[0] - xb[0];
  const double dy = xa[1] - xb[1];
  const double dz = xa[2] - xb[2];
  const double dist = std::sqrt(dx * dx + dy * dy + dz * dz);
  const double r = dist - mean;
  return std::exp(-(r * r) / (2.0 * stdd * stdd)) / stdd;
}
}  // namespace

extern "C" {

// Max-product inference over the 13-joint tree.
//   unary:      [13 * n_cand] joint/candidate potentials (modified copy)
//   candidates: [13 * n_cand * 3] candidate 3D positions
//   bone_mean, bone_std: [13] per-child-joint Gaussian bone priors
//   out_picks:  [13] selected candidate index per joint
void pictorial_infer(const double* unary_in, const double* candidates,
                     const double* bone_mean, const double* bone_std,
                     int n_cand, int64_t* out_picks) {
  std::vector<double> unary(unary_in, unary_in + kJoints * n_cand);

  // upward pass: joints in descending index order (children first)
  for (int j = kJoints - 1; j >= 1; --j) {
    const int p = kParent[j];
    std::vector<double> msg(n_cand);
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int pc = 0; pc < n_cand; ++pc) {
      double best = -1e100;
      const double* xp = candidates + (p * n_cand + pc) * 3;
      for (int cc = 0; cc < n_cand; ++cc) {
        const double* xc = candidates + (j * n_cand + cc) * 3;
        const double v =
            pair_prior(xc, xp, bone_mean[j], bone_std[j]) + unary[j * n_cand + cc];
        if (v > best) best = v;
      }
      msg[pc] = best;
    }
    for (int pc = 0; pc < n_cand; ++pc) unary[p * n_cand + pc] += msg[pc];
  }

  // root pick
  int best_root = 0;
  for (int c = 1; c < n_cand; ++c)
    if (unary[c] > unary[best_root]) best_root = c;
  out_picks[0] = best_root;

  // downward backtracking
  for (int j = 1; j < kJoints; ++j) {
    const int p = kParent[j];
    const int pc = static_cast<int>(out_picks[p]);
    const double* xp = candidates + (p * n_cand + pc) * 3;
    int best_c = 0;
    double best = -1e100;
    for (int cc = 0; cc < n_cand; ++cc) {
      const double* xc = candidates + (j * n_cand + cc) * 3;
      const double v =
          pair_prior(xc, xp, bone_mean[j], bone_std[j]) + unary[j * n_cand + cc];
      if (v > best) {
        best = v;
        best_c = cc;
      }
    }
    out_picks[j] = best_c;
  }
}

// Boolean transitive closure + cluster/permutation extraction
// (semantics of the reference's transform_closure).
//   x: [n * n] uint8 relation matrix
//   out: [n * n] uint8 cluster matrix; out[j, i] = 1 when j belongs to the
//        cluster whose lowest-index representative is i.
void transform_closure(const uint8_t* x, int n, uint8_t* out) {
  std::vector<uint8_t> reach(x, x + static_cast<size_t>(n) * n);
  for (int i = 0; i < n; ++i) reach[i * n + i] = 1;
  // Floyd-Warshall closure
  for (int k = 0; k < n; ++k) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int i = 0; i < n; ++i) {
      if (!reach[i * n + k]) continue;
      const uint8_t* rk = reach.data() + static_cast<size_t>(k) * n;
      uint8_t* ri = reach.data() + static_cast<size_t>(i) * n;
      for (int j = 0; j < n; ++j) ri[j] = ri[j] | rk[j];
    }
  }
  std::memset(out, 0, static_cast<size_t>(n) * n);
  std::vector<uint8_t> vis(n, 0);
  for (int i = 0; i < n; ++i) {
    if (vis[i]) continue;
    for (int j = 0; j < n; ++j) {
      if (reach[i * n + j]) {
        vis[j] = 1;
        out[j * n + i] = 1;
      }
    }
  }
}

}  // extern "C"
