// Right-looking Cholesky column loop shared by the fused Cholesky-solve
// (chol_solve.cu) and the plain Cholesky (chol.cu), the counterpart of the
// TPU kernels' shared body linalg_pallas.py::_chol_factorise.
#pragma once

#include "common.cuh"

namespace bet {

// Factorises the t x t SPD matrix held row-major in shared memory `a`
// (leading dimension ld; only the lower triangle is read) in place into its
// lower Cholesky factor.  `col` is shared scratch of t values.
//
// Per column k:
//  * phase A scales column k by 1/sqrt(pivot) into `col`; thread 0 then
//    calls on_pivot(k, pivot, 1 / L_kk);
//  * barrier;
//  * phase B writes `col` back as column k of L, calls on_entry(i, L_ik)
//    once for every i > k, and applies the rank-1 update to the trailing
//    lower triangle;
//  * barrier.
// A non-positive (or NaN) pivot gives NaN, which propagates to the rest of
// the factor.  Ends on a barrier, so the caller may read `a` at once.
template <int kThreads, typename T, typename OnPivot, typename OnEntry>
__device__ __forceinline__ void chol_factorise(T* a, int ld, T* col, int t, OnPivot on_pivot,
                                               OnEntry on_entry) {
  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;
  constexpr int kRows = kThreads / 32;
  for (int k = 0; k < t; ++k) {
    const T d = a[k * ld + k];
    const T lkk = d > T(0) ? sqrt(d) : Num<T>::nan();
    const T inv = T(1) / lkk;
    for (int i = k + 1 + tid; i < t; i += kThreads) col[i] = a[i * ld + k] * inv;
    if (tid == 0) {
      col[k] = lkk;
      on_pivot(k, d, inv);
    }
    __syncthreads();

    for (int i = k + tid; i < t; i += kThreads) {
      a[i * ld + k] = col[i];
      if (i > k) on_entry(i, col[i]);
    }
    for (int i = k + 1 + ty; i < t; i += kRows) {
      const T ci = col[i];
      T* row = a + i * ld;
      for (int j = k + 1 + tx; j <= i; j += 32) row[j] -= ci * col[j];
    }
    __syncthreads();
  }
}

}  // namespace bet
