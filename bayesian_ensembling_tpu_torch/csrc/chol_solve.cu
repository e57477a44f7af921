// Fused Cholesky + forward solve + log-determinant + backward solve for a
// batch of small SPD matrices: K = L L^T, z = L^-1 y, alpha = L^-T z,
// logdet = log|K|.
//
// Replaces the Pallas TPU kernel
//   bayesian_ensembling_tpu/ops/linalg_pallas.py::_chol_solve_kernel
//   (public entry cholesky_solve_fused).
//
// What bounds it on an H100: T^3/3 flops per matrix (0.75 MFLOP at T=165)
// in a chain of T column steps, each of which needs the previous one's
// trailing update.  At the main path's batch (B=112, fewer than the 132 SMs)
// it is latency-bound: one block per matrix, and the time is T steps times
// (two barriers + one trailing update spread over the block).  Device
// memory traffic is one read of K and one write of L.
//
// Design:
//  * One block of 512 threads per matrix; K lives in dynamic shared memory
//    (109 KB at T=165 in f32, 219 KB in f64), with an odd leading dimension
//    so column walks are free of bank conflicts.
//  * Right-looking column loop.  Phase A scales column k by 1/sqrt(pivot)
//    into a shared vector; phase B writes it back as column k of L, folds
//    it into the forward-substitution accumulator, and applies the rank-1
//    update to the trailing lower triangle.  z[k] and the log-det term are
//    formed inside the loop, as in the TPU kernel; alpha follows in a
//    column-oriented backward substitution (one barrier per step).
//  * A non-positive (or NaN) pivot yields NaN, which then propagates to the
//    rest of the factor, z, alpha and logdet, as the TPU kernel does.
//  * L is written to device memory with zeros above the diagonal, because
//    the triangular inverse and the posterior read it.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;  // fastest of 128..1024 at T=86 and 165 on an H100

template <typename T>
__global__ void __launch_bounds__(kThreads)
    chol_solve_kernel(const T* __restrict__ ky, const T* __restrict__ y, T* __restrict__ l_out,
                      T* __restrict__ z_out, T* __restrict__ alpha_out, T* __restrict__ logdet_out,
                      int t) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = bet::smem_ld(t);
  T* a = reinterpret_cast<T*>(smem);  // t x ld, factorised in place
  T* col = a + static_cast<size_t>(t) * ld;  // scaled column k
  T* acc = col + t;  // forward accumulator, then backward residual
  T* yv = acc + t;
  T* zv = yv + t;
  __shared__ T zk_shared;

  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;
  constexpr int kRows = kThreads / 32;
  const size_t mat0 = static_cast<size_t>(blockIdx.x) * t * t;
  const size_t vec0 = static_cast<size_t>(blockIdx.x) * t;

  for (int q = tid; q < t * t; q += kThreads) {
    const int i = q / t;
    a[i * ld + (q - i * t)] = ky[mat0 + q];
  }
  for (int q = tid; q < t; q += kThreads) {
    yv[q] = y[vec0 + q];
    acc[q] = T(0);
  }
  T logdet = T(0);  // meaningful in thread 0
  __syncthreads();

  for (int k = 0; k < t; ++k) {
    // Phase A: pivot and column k of L.
    const T d = a[k * ld + k];
    const T lkk = d > T(0) ? sqrt(d) : bet::Num<T>::nan();
    const T inv = T(1) / lkk;
    for (int i = k + 1 + tid; i < t; i += kThreads) col[i] = a[i * ld + k] * inv;
    if (tid == 0) {
      col[k] = lkk;
      const T zk = (yv[k] - acc[k]) * inv;
      zv[k] = zk;
      zk_shared = zk;
      logdet += log(d);
    }
    __syncthreads();

    // Phase B: store the column, forward accumulator, trailing update.
    const T zk = zk_shared;
    for (int i = k + tid; i < t; i += kThreads) {
      a[i * ld + k] = col[i];
      if (i > k) acc[i] += col[i] * zk;
    }
    for (int i = k + 1 + ty; i < t; i += kRows) {
      const T ci = col[i];
      T* row = a + i * ld;
      for (int j = k + 1 + tx; j <= i; j += 32) row[j] -= ci * col[j];
    }
    __syncthreads();
  }

  // alpha = L^-T z, column-oriented: alpha_i = r_i / L_ii, then
  // r_m -= L_im alpha_i for m < i.
  for (int q = tid; q < t; q += kThreads) acc[q] = zv[q];
  __syncthreads();
  for (int i = t - 1; i >= 0; --i) {
    const T ai = acc[i] / a[i * ld + i];
    for (int m = tid; m < i; m += kThreads) acc[m] -= a[i * ld + m] * ai;
    if (tid == 0) alpha_out[vec0 + i] = ai;
    __syncthreads();
  }

  for (int q = tid; q < t * t; q += kThreads) {
    const int i = q / t;
    const int j = q - i * t;
    l_out[mat0 + q] = j <= i ? a[i * ld + j] : T(0);
  }
  for (int q = tid; q < t; q += kThreads) z_out[vec0 + q] = zv[q];
  if (tid == 0) logdet_out[blockIdx.x] = logdet;
}

template <typename T>
size_t chol_solve_smem_bytes(int t) {
  return sizeof(T) * (static_cast<size_t>(t) * bet::smem_ld(t) + 4 * static_cast<size_t>(t));
}

template <typename T>
int launch_chol_solve(const void* ky, const void* y, void* l, void* z, void* alpha, void* logdet,
                      int b, int t, void* stream) {
  if (b <= 0 || t <= 0) return cudaSuccess;
  const size_t smem = chol_solve_smem_bytes<T>(t);
  cudaError_t err = bet::set_dynamic_smem(chol_solve_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  chol_solve_kernel<T><<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(ky), static_cast<const T*>(y), static_cast<T*>(l), static_cast<T*>(z),
      static_cast<T*>(alpha), static_cast<T*>(logdet), t);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int bet_chol_solve_f32(const void* ky, const void* y, void* l, void* z, void* alpha, void* logdet,
                       int b, int t, void* stream) {
  return launch_chol_solve<float>(ky, y, l, z, alpha, logdet, b, t, stream);
}

int bet_chol_solve_f64(const void* ky, const void* y, void* l, void* z, void* alpha, void* logdet,
                       int b, int t, void* stream) {
  return launch_chol_solve<double>(ky, y, l, z, alpha, logdet, b, t, stream);
}

}  // extern "C"
