// Fused Cholesky + forward solve + log-determinant + backward solve for a
// batch of small SPD matrices: K = L L^T, z = L^-1 y, alpha = L^-T z,
// logdet = log|K|.
//
// Replaces the Pallas TPU kernel
//   bayesian_ensembling_tpu/ops/linalg_pallas.py::_chol_solve_kernel
//   (public entry cholesky_solve_fused).
//
// What bounds it on an H100: T^3/3 flops per matrix (0.75 MFLOP at T=165)
// and one read of K and one write of L are worth a few microseconds; at the
// main path's batch (B=112, fewer than the 132 SMs, one block per matrix) the
// time is the length of the dependent chain: the factorisation's, and then
// the backward substitution's T steps.
//
// Design:
//  * One block of 256 threads per matrix; K's lower triangle lives in
//    dynamic shared memory (111 KB at T=165 in f32, 219 KB in f64), its rows
//    on 16-byte boundaries so that operands are read 16 bytes at a time.
//  * The factorisation is the panel-blocked body shared with chol.cu
//    (chol_factorise.cuh: 32-column panels, three barriers per panel).  Its
//    per-panel hook does the forward substitution and the log-determinant in
//    the block's last warp, beside the other warps' trailing update: once a
//    panel's columns are final, z_p = L11^-1 r_p by a 32-step shuffle
//    substitution (r starts as y), r[i] -= L21[i, :] z_p for the rows below,
//    and logdet += 2 sum log L_kk.  Only that warp touches r, z and the
//    log-determinant, so the hook needs no barrier of its own.
//  * alpha follows in a column-oriented backward substitution, one barrier
//    per step: the part of the chain that is still column by column.
//  * A non-positive (or NaN) pivot yields NaN, which then propagates to the
//    rest of the factor, z, alpha and logdet, as the TPU kernel does.
//  * L is written to device memory with zeros above the diagonal, because
//    the triangular inverse and the posterior read it.
#include "chol_factorise.cuh"

namespace {

// Threads per block: 256 is faster than 512 (6% in float32, 20% in float64
// at T = 165, phase clocks): the backward substitution's barriers cost less
// with 8 warps, and 255 registers a thread end the spills.
#ifndef BET_CHOL_THREADS
#define BET_CHOL_THREADS 256
#endif
constexpr int kThreads = BET_CHOL_THREADS;
constexpr int kWarps = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    chol_solve_kernel(const T* __restrict__ ky, const T* __restrict__ y, T* __restrict__ l_out,
                      T* __restrict__ z_out, T* __restrict__ alpha_out, T* __restrict__ logdet_out,
                      int t) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = bet::smem_ld<T>(t);
  T* a = reinterpret_cast<T*>(smem);  // t x ld, factorised in place
  T* res = a + static_cast<size_t>(t) * ld;  // y less what the solved columns explain; then the backward residual
  T* zv = res + t;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t mat0 = static_cast<size_t>(blockIdx.x) * t * t;
  const size_t vec0 = static_cast<size_t>(blockIdx.x) * t;

  BET_PHASE_CLOCK_RESET();
  BET_PHASE_CLOCK();
  bet::load_lower<kThreads, false>(a, ld, ky + mat0, t);
  for (int q = tid; q < t; q += kThreads) res[q] = y[vec0 + q];
  T logdet = T(0);  // per-lane partial sums in the last warp
  __syncthreads();
  BET_PHASE_CLOCK();  // the load

  bet::chol_factorise<kThreads>(a, ld, t, [&](int k0, int nb, const T* inv_diag, T* spare) {
    if (warp != kWarps - 1) return;
    const T* l11 = a + k0 * ld + k0;  // L11 with L11^T above its diagonal
    const bool live = lane < nb;
    T r = live ? res[k0 + lane] : T(0);
    const T my_inv = inv_diag[lane];  // 1 beyond a ragged panel's width
    T zc = T(0);
    for (int m = 0; m < nb; ++m) {
      const T zm = __shfl_sync(bet::kFullWarp, r * my_inv, m);
      if (lane == m) zc = zm;
      if (live && lane > m) r -= l11[m * ld + lane] * zm;  // L[lane][m], read from L11^T
    }
    if (live) {
      zv[k0 + lane] = zc;
      logdet -= T(2) * log(my_inv);
    }
    spare[lane] = zc;  // z_p on a 16-byte boundary; zeros beyond a ragged panel's width
    __syncwarp();
    T zp[bet::kPanel];
    bet::load_row(spare, zp, 0, bet::kPanel);
    for (int i = k0 + bet::kPanel + lane; i < t; i += 32) {
      const T* row = a + i * ld + k0;  // rows exist below only under a full panel
      T lrow[bet::kPanel];
      bet::load_row(row, lrow, 0, bet::kPanel);
      T s = T(0);
#pragma unroll
      for (int m = 0; m < bet::kPanel; ++m) s += lrow[m] * zp[m];
      res[i] -= s;
    }
    __syncwarp();
  });

  // alpha = L^-T z, column-oriented: alpha_i = r_i / L_ii, then
  // r_m -= L_im alpha_i for m < i.
  for (int q = tid; q < t; q += kThreads) res[q] = zv[q];
  __syncthreads();
  for (int i = t - 1; i >= 0; --i) {
    const T ai = res[i] / a[i * ld + i];
    for (int m = tid; m < i; m += kThreads) res[m] -= a[i * ld + m] * ai;
    if (tid == 0) alpha_out[vec0 + i] = ai;
    __syncthreads();
  }
  BET_PHASE_CLOCK();  // the backward substitution

  bet::store_lower<kThreads>(l_out + mat0, a, ld, t);
  for (int q = tid; q < t; q += kThreads) z_out[vec0 + q] = zv[q];
  if (warp == kWarps - 1) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) logdet += __shfl_xor_sync(bet::kFullWarp, logdet, off);
    if (lane == 0) logdet_out[blockIdx.x] = logdet;
  }
  BET_PHASE_CLOCK();  // the store, as thread 0 sees it
}

template <typename T>
size_t chol_solve_smem_bytes(int t) {
  return sizeof(T) * (static_cast<size_t>(t) * bet::smem_ld<T>(t) + 2 * static_cast<size_t>(t));
}

template <typename T>
int launch_chol_solve(const void* ky, const void* y, void* l, void* z, void* alpha, void* logdet,
                      int b, int t, void* stream) {
  static bet::SmemGrant grant;
  if (b <= 0 || t <= 0) return cudaSuccess;
  const size_t smem = chol_solve_smem_bytes<T>(t);
  cudaError_t err = bet::grant_dynamic_smem(chol_solve_kernel<T>, smem,
                                            bet::chol_factorise_static_bytes<T>(), grant);
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
