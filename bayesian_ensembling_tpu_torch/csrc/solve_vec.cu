// Batched vector solve with a given Cholesky factor: z = L^-1 y,
// alpha = L^-T z, logdet = 2 sum_i log L_ii.
//
// Replaces the Pallas TPU kernel
//   bayesian_ensembling_tpu/ops/linalg_pallas.py::_solve_vec_kernel
//   (public entry solve_vec_batched).  Its callers are the library API's
//   full-covariance scores (ops/scoring.py, ops/distributions.py), which
//   solve against the factor of each model's posterior covariance.
//
// What bounds it on an H100: 2 T^2 flops per matrix and two reads of the
// lower triangle of L, in a chain of T dependent unknowns per pass.  With
// one block per matrix and B <= 16 on the library path, the time is the
// chain's: 2 ceil(T/32) panel steps per pass, each two barriers.
//
// Design (not a lane-by-lane carry-over: the TPU kernel walks columns of L
// with an outer-product accumulator because its batch-in-lanes layout makes
// columns contiguous; here L is batch-major, rows are contiguous):
//  * One block of 512 threads per matrix.  L stays in device memory and is
//    read by rows, coalesced, each entry of the lower triangle once per
//    pass.  Shared memory holds z, the backward accumulator, one 32 x 32
//    diagonal triangle (leading dimension 33) and two 32-vectors, so T is
//    bounded by 2 T + 1120 elements (far above the fused kernel's cap).
//  * Forward, panels of 32 rows top down: every warp forms the dot products
//    of its rows of the panel with the z already known (lanes stride along
//    the row, shuffle reduction) while the triangle is staged; one barrier;
//    warp 0 solves the triangle with one shuffle per unknown; one barrier.
//  * Backward (L^T alpha = z), panels bottom up: warp 0 solves the
//    transposed triangle against z - acc; one barrier; then every thread
//    owns columns k below the panel and adds sum_r L[j0+r, k] alpha_r to
//    acc[k] (rows of L again), while the next triangle is staged.
//  * A zero diagonal entry gives inf/NaN in z and alpha from that row on
//    and -inf in logdet; a negative or NaN one gives NaN in logdet.  Nothing
//    is trapped, as in the plain version.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPanel = 32;
constexpr int kTriLd = kPanel + 1;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Stage the diagonal triangle of panel rows [j0, j0 + n) into tri, padded to
// 32 x 32 with the identity so that idle lanes solve 1 * x = 0.
template <typename T>
__device__ __forceinline__ void stage_triangle(const T* __restrict__ l, int t, int j0, int n,
                                               T* __restrict__ tri) {
  for (int q = threadIdx.x; q < kPanel * kPanel; q += kThreads) {
    const int i = q / kPanel;
    const int c = q - i * kPanel;
    T v = i == c ? T(1) : T(0);
    if (i < n && c <= i) v = l[static_cast<size_t>(j0 + i) * t + j0 + c];
    tri[i * kTriLd + c] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    solve_vec_kernel(const T* __restrict__ l_all, const T* __restrict__ y_all,
                     T* __restrict__ z_out, T* __restrict__ alpha_out,
                     T* __restrict__ logdet_out, int t) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* zv = reinterpret_cast<T*>(smem);  // z, complete after the forward pass
  T* acc = zv + t;                     // backward: sum_{i solved} L[i,k] alpha_i
  T* tri = acc + t;                    // 32 x 33 diagonal triangle
  T* dot = tri + kPanel * kTriLd;      // forward: panel rows . known z
  T* alpha_p = dot + kPanel;           // backward: the panel's alpha

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const T* l = l_all + static_cast<size_t>(blockIdx.x) * t * t;
  const T* y = y_all + static_cast<size_t>(blockIdx.x) * t;
  T* z_g = z_out + static_cast<size_t>(blockIdx.x) * t;
  T* alpha_g = alpha_out + static_cast<size_t>(blockIdx.x) * t;
  const int n_panels = (t + kPanel - 1) / kPanel;

  // ---- forward: L z = y, and the log-determinant from the diagonal
  T logdet = T(0);  // meaningful in warp 0, per lane until the reduction
  for (int p = 0; p < n_panels; ++p) {
    const int j0 = p * kPanel;
    const int n = min(kPanel, t - j0);
    stage_triangle(l, t, j0, n, tri);
    for (int r = warp; r < n; r += kWarps) {
      const T* row = l + static_cast<size_t>(j0 + r) * t;
      T s = T(0);
      for (int k = lane; k < j0; k += 32) s += row[k] * zv[k];
      s = warp_sum(s);
      if (lane == 0) dot[r] = s;
    }
    __syncthreads();
    if (warp == 0) {
      T rhs = lane < n ? y[j0 + lane] - dot[lane] : T(0);
      const T diag = tri[lane * kTriLd + lane];
      logdet += log(diag);
      T mine = T(0);
      for (int c = 0; c < kPanel; ++c) {
        const T zc = __shfl_sync(0xffffffffu, rhs / diag, c);
        if (lane == c) mine = zc;
        if (lane > c) rhs -= tri[lane * kTriLd + c] * zc;
      }
      if (lane < n) {
        zv[j0 + lane] = mine;
        z_g[j0 + lane] = mine;
      }
    }
    __syncthreads();
  }
  if (warp == 0) {
    logdet = warp_sum(logdet);
    if (lane == 0) logdet_out[blockIdx.x] = T(2) * logdet;
  }

  // ---- backward: L^T alpha = z
  for (int q = tid; q < t; q += kThreads) acc[q] = T(0);
  {
    const int j0 = (n_panels - 1) * kPanel;
    stage_triangle(l, t, j0, min(kPanel, t - j0), tri);
  }
  __syncthreads();
  for (int p = n_panels - 1; p >= 0; --p) {
    const int j0 = p * kPanel;
    const int n = min(kPanel, t - j0);
    if (warp == 0) {
      T rhs = lane < n ? zv[j0 + lane] - acc[j0 + lane] : T(0);
      const T diag = tri[lane * kTriLd + lane];
      T mine = T(0);
      for (int c = kPanel - 1; c >= 0; --c) {
        const T ac = __shfl_sync(0xffffffffu, rhs / diag, c);
        if (lane == c) mine = ac;
        if (lane < c) rhs -= tri[c * kTriLd + lane] * ac;  // L[j0+c, j0+lane]
      }
      alpha_p[lane] = mine;
      if (lane < n) alpha_g[j0 + lane] = mine;
    }
    __syncthreads();  // alpha_p is complete, tri is free
    if (p > 0) stage_triangle(l, t, j0 - kPanel, kPanel, tri);
    for (int k = tid; k < j0; k += kThreads) {
      T s = T(0);
#pragma unroll 8
      for (int r = 0; r < n; ++r) s += l[static_cast<size_t>(j0 + r) * t + k] * alpha_p[r];
      acc[k] += s;
    }
    __syncthreads();
  }
}

template <typename T>
size_t solve_vec_smem_bytes(int t) {
  return sizeof(T) * (2 * static_cast<size_t>(t) + kPanel * kTriLd + 2 * kPanel);
}

template <typename T>
int launch_solve_vec(const void* l, const void* y, void* z, void* alpha, void* logdet, int b,
                     int t, void* stream) {
  if (b <= 0 || t <= 0) return cudaSuccess;
  const size_t smem = solve_vec_smem_bytes<T>(t);
  cudaError_t err = bet::set_dynamic_smem(solve_vec_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  solve_vec_kernel<T><<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(l), static_cast<const T*>(y), static_cast<T*>(z),
      static_cast<T*>(alpha), static_cast<T*>(logdet), t);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int bet_solve_vec_f32(const void* l, const void* y, void* z, void* alpha, void* logdet, int b,
                      int t, void* stream) {
  return launch_solve_vec<float>(l, y, z, alpha, logdet, b, t, stream);
}

int bet_solve_vec_f64(const void* l, const void* y, void* z, void* alpha, void* logdet, int b,
                      int t, void* stream) {
  return launch_solve_vec<double>(l, y, z, alpha, logdet, b, t, stream);
}

}  // extern "C"
