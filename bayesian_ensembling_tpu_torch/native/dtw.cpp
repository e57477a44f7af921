// Native DTW / DBA engine.
//
// Host-side C++ implementation of squared dynamic-time-warping alignment and
// DTW barycenter averaging, matching the semantics of the DTW plain versions
// in bayesian_ensembling_tpu_torch/ops/dtw.py (which follow the reference
// library's pure-numpy dtwa.py: squared local cost, diag-then-left-
// then-top tie-breaking, medoid initialisation, path-mean updates).
//
// Used through ctypes (bayesian_ensembling_tpu_torch/native) as (a) a fast oracle
// for cross-checking the DTW kernels and (b) a host preprocessing path when
// no accelerator is attached.  Built at first use into build/native/.
//
// All matrices are row-major float64.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// Cost-only squared-DTW with two rolling rows: O(T) memory.
double sq_dtw_impl(const double* a, const double* b, int n) {
  std::vector<double> prev(n), cur(n);
  prev[0] = (a[0] - b[0]) * (a[0] - b[0]);
  for (int j = 1; j < n; ++j) {
    const double d = a[0] - b[j];
    prev[j] = prev[j - 1] + d * d;
  }
  for (int i = 1; i < n; ++i) {
    {
      const double d = a[i] - b[0];
      cur[0] = prev[0] + d * d;
    }
    for (int j = 1; j < n; ++j) {
      const double d = a[i] - b[j];
      const double best = std::min(prev[j - 1], std::min(cur[j - 1], prev[j]));
      cur[j] = best + d * d;
    }
    std::swap(prev, cur);
  }
  return prev[n - 1];
}

// Full DP with move matrix for backtracking.  moves: 0=diag, 1=left, 2=top,
// -1 at the origin; diag wins ties, then left, then top.
void dtw_path(const double* center, const double* s, int n,
              std::vector<double>& cost, std::vector<int8_t>& move) {
  auto at = [n](int i, int j) { return i * n + j; };
  {
    const double d = center[0] - s[0];
    cost[at(0, 0)] = d * d;
    move[at(0, 0)] = -1;
  }
  for (int i = 1; i < n; ++i) {
    const double d = center[i] - s[0];
    cost[at(i, 0)] = cost[at(i - 1, 0)] + d * d;
    move[at(i, 0)] = 2;
  }
  for (int j = 1; j < n; ++j) {
    const double d = center[0] - s[j];
    cost[at(0, j)] = cost[at(0, j - 1)] + d * d;
    move[at(0, j)] = 1;
  }
  for (int i = 1; i < n; ++i) {
    for (int j = 1; j < n; ++j) {
      const double diag = cost[at(i - 1, j - 1)];
      const double left = cost[at(i, j - 1)];
      const double top = cost[at(i - 1, j)];
      double best;
      int8_t mv;
      if (diag <= left && diag <= top) {
        best = diag;
        mv = 0;
      } else if (left <= top) {
        best = left;
        mv = 1;
      } else {
        best = top;
        mv = 2;
      }
      const double d = center[i] - s[j];
      cost[at(i, j)] = best + d * d;
      move[at(i, j)] = mv;
    }
  }
}

}  // namespace

extern "C" {

// Squared-DTW cost between two equal-length series.
double bet_squared_dtw(const double* a, const double* b, int n) {
  return sq_dtw_impl(a, b, n);
}

// All-pairs squared-DTW matrix: series (r, t) row-major -> out (r, r).
// The r(r-1)/2 alignment problems are independent -> OpenMP parallel.
void bet_dtw_pairwise(const double* series, int r, int t, double* out) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
  for (int i = 0; i < r; ++i) {
    out[i * r + i] = 0.0;
    for (int j = i + 1; j < r; ++j) {
      const double d = sq_dtw_impl(series + i * t, series + j * t, t);
      out[i * r + j] = d;
      out[j * r + i] = d;
    }
  }
}

// DTW barycenter averaging: series (r, t) -> out_center (t).
// Medoid initialisation (exact over all rows), n_iters path-mean updates.
void bet_dba(const double* series, int r, int t, int n_iters,
             double* out_center) {
  // Medoid: the row minimising the summed squared-DTW to all others.
  int medoid = 0;
  double best = std::numeric_limits<double>::infinity();
  std::vector<double> row_ss(r, 0.0);
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
  for (int i = 0; i < r; ++i) {
    double ss = 0.0;
    for (int j = 0; j < r; ++j) {
      if (i == j) continue;
      ss += sq_dtw_impl(series + i * t, series + j * t, t);
    }
    row_ss[i] = ss;
  }
  for (int i = 0; i < r; ++i) {
    if (row_ss[i] < best) {
      best = row_ss[i];
      medoid = i;
    }
  }
  std::vector<double> center(series + medoid * t, series + (medoid + 1) * t);

  std::vector<double> sums(t), counts(t);
  // Per-realisation partials: alignments against the fixed centre are
  // independent, so each row writes its own slice in parallel and the
  // reduction runs serially in realisation order afterwards — bitwise
  // deterministic regardless of thread count or scheduling (an
  // omp-critical merge of thread-local buffers would sum in thread-arrival
  // order and vary in the last ulp run-to-run).
  std::vector<double> psums(static_cast<size_t>(r) * t);
  std::vector<double> pcounts(static_cast<size_t>(r) * t);

  for (int it = 0; it < n_iters; ++it) {
    std::fill(psums.begin(), psums.end(), 0.0);
    std::fill(pcounts.begin(), pcounts.end(), 0.0);
#ifdef _OPENMP
#pragma omp parallel
#endif
    {
      std::vector<double> cost(static_cast<size_t>(t) * t);
      std::vector<int8_t> move(static_cast<size_t>(t) * t);
#ifdef _OPENMP
#pragma omp for schedule(dynamic) nowait
#endif
      for (int sdx = 0; sdx < r; ++sdx) {
        const double* s = series + static_cast<size_t>(sdx) * t;
        double* ls = psums.data() + static_cast<size_t>(sdx) * t;
        double* lc = pcounts.data() + static_cast<size_t>(sdx) * t;
        dtw_path(center.data(), s, t, cost, move);
        int i = t - 1, j = t - 1;
        while (true) {
          ls[i] += s[j];
          lc[i] += 1.0;
          const int8_t mv = move[static_cast<size_t>(i) * t + j];
          if (mv == -1) break;
          if (mv == 0) {
            --i;
            --j;
          } else if (mv == 1) {
            --j;
          } else {
            --i;
          }
        }
      }
    }
    std::fill(sums.begin(), sums.end(), 0.0);
    std::fill(counts.begin(), counts.end(), 0.0);
    for (int sdx = 0; sdx < r; ++sdx) {
      const double* ls = psums.data() + static_cast<size_t>(sdx) * t;
      const double* lc = pcounts.data() + static_cast<size_t>(sdx) * t;
      for (int k = 0; k < t; ++k) {
        sums[k] += ls[k];
        counts[k] += lc[k];
      }
    }
    for (int k = 0; k < t; ++k) center[k] = sums[k] / counts[k];
  }
  std::memcpy(out_center, center.data(), sizeof(double) * t);
}

// Batched DBA over independent models: series (b, r, t) -> out (b, t).
// Model-level parallelism (each model's DBA runs serially inside).
void bet_dba_batch(const double* series, int b, int r, int t, int n_iters,
                   double* out_centers) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
  for (int m = 0; m < b; ++m) {
    bet_dba(series + static_cast<size_t>(m) * r * t, r, t, n_iters,
            out_centers + static_cast<size_t>(m) * t);
  }
}

}  // extern "C"
