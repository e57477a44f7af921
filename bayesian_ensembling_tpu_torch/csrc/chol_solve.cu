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
// main path's batch (B=112, fewer than the 132 SMs, one block per matrix) and
// the library path's (B <= 16) the time is the length of one block's
// dependent chain: the factorisation's, the forward substitution's and the
// backward substitution's.
//
// Design:
//  * One block of 256 threads per matrix; K's lower triangle lives in
//    dynamic shared memory (111 KB at T=165 in f32, 219 KB in f64), its rows
//    on 16-byte boundaries so that operands are read 16 bytes at a time.
//  * The factorisation is the panel-blocked body shared with chol.cu
//    (chol_factorise.cuh: 32-column panels, three barriers per panel).
//  * Forward substitution and log-determinant ride on its hooks.  Once a
//    panel's columns are final, the last warp solves z_p = L11^-1 r_p by a
//    32-step shuffle chain (r starts as y; each lane holds its row of L11 in
//    registers, so the chain is a shuffle and a multiply-add a step) and adds
//    2 sum log L_kk, beside the other warps' trailing update.  The update of
//    the rows under the panel, r[i] -= L21[i, :] z_p, is not on that warp's
//    chain: it waits for the next panel, whose diagonal block occupies warp 0
//    alone, and the other warps apply it there, one row a lane.
//  * Backward substitution, alpha = L^-T z, by panels from the last one up,
//    in place in z: warp 0 solves L11^T alpha_p = r_p by the same 32-step
//    chain (each lane holds its column of L11, which is the row of L11^T
//    that the factorisation left above the block's diagonal); then all warps
//    apply r[0:k0] -= L[k0:k0+32, 0:k0]^T alpha_p, eight lanes a 16-byte
//    column group, four row quarters summed by shuffles.  Two barriers per
//    panel (11 at T=165) where a column loop paid one per column.
//  * A non-positive (or NaN) pivot yields NaN, which then propagates to the
//    rest of the factor, z, alpha and logdet, as the TPU kernel does.
//  * L is written to device memory with zeros above the diagonal, because
//    the triangular inverse and the posterior read it.
#include "chol_factorise.cuh"

namespace {

// Threads per block: 256 is faster than 512 (6% in float32, 20% in float64
// at T = 165, phase clocks), and 255 registers a thread end the spills.
#ifndef BET_CHOL_THREADS
#define BET_CHOL_THREADS 256
#endif
constexpr int kThreads = BET_CHOL_THREADS;
constexpr int kWarps = kThreads / 32;

// One warp: the nb <= 32 unknowns of a diagonal block's triangular system,
// x = rhs / diag and then rhs -= coef * x down (kBackward false) or up the
// lanes, one shuffle a step.  coef[c] is this lane's coefficient of unknown
// c, zero where unknown c does not enter its row; inv is 1 / diag for a live
// lane and 1 elsewhere, where rhs is 0.
template <bool kBackward, typename T>
__device__ __forceinline__ T warp_tri_solve(T rhs, T inv, const T (&coef)[bet::kPanel]) {
  const int lane = threadIdx.x & 31;
  T x = T(0);
#pragma unroll
  for (int s = 0; s < bet::kPanel; ++s) {
    const int c = kBackward ? bet::kPanel - 1 - s : s;
    const T xc = __shfl_sync(bet::kFullWarp, rhs * inv, c);
    if (lane == c) x = xc;
    rhs -= coef[c] * xc;
  }
  return x;
}

// This lane's row of the 32 x 32 diagonal block at `d` (the row of the
// ragged block's last live lane for the others), 16 bytes at a time; the
// entries that keep(c) refuses are zero.
template <typename T, typename Keep>
__device__ __forceinline__ void block_row(const T* d, int ld, int nb, int ncols,
                                          T (&row)[bet::kPanel], Keep keep) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < bet::kPanel; ++c) row[c] = T(0);
  bet::load_row(d + min(lane, nb - 1) * ld, row, 0, ncols);
#pragma unroll
  for (int c = 0; c < bet::kPanel; ++c)
    if (!keep(c)) row[c] = T(0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    chol_solve_kernel(const T* __restrict__ ky, const T* __restrict__ y, T* __restrict__ l_out,
                      T* __restrict__ z_out, T* __restrict__ alpha_out, T* __restrict__ logdet_out,
                      int t) {
  constexpr int kVec = bet::vec_len<T>();
  constexpr int kPanel = bet::kPanel;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = bet::smem_ld<T>(t);
  T* a = reinterpret_cast<T*>(smem);  // t x ld, factorised in place
  T* zv = a + static_cast<size_t>(t) * ld;  // z, panel by panel; then alpha in its place
  T* res = zv + t;  // y less what the solved columns explain

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

  // Beside the diagonal block of panel k0 (warps 1 on): the rows from k0 on
  // take the previous panel's z_p, r[i] -= L[i, kp:kp+32] z_p.
  const auto on_diag = [&](int k0) {
    if (k0 == 0) return;
    const int kp = k0 - kPanel;
    T zp[kPanel];
    bet::load_row(zv + kp, zp, 0, kPanel);
    for (int i0 = k0 + (warp - 1) * 32; i0 < t; i0 += (kWarps - 1) * 32) {
      const int i = i0 + lane;
      T lrow[kPanel];
      bet::load_row(a + min(i, t - 1) * ld + kp, lrow, 0, kPanel);
      T s = T(0);
#pragma unroll
      for (int m = 0; m < kPanel; ++m) s += lrow[m] * zp[m];
      if (i < t) res[i] -= s;
    }
  };
  // After panel k0's columns are final (the last warp): z_p and log|L11|.
  const auto on_panel = [&](int k0, int nb, const T* inv_diag) {
    if (warp != kWarps - 1) return;
    const bool live = lane < nb;
    T lrow[kPanel];  // L[k0+lane][k0+m] for m < lane
    block_row(a + k0 * ld + k0, ld, nb, min(kPanel, ld - k0), lrow,
              [&](int c) { return live && c < lane; });
    const T my_inv = inv_diag[lane];  // 1 beyond a ragged panel's width
    const T zc = warp_tri_solve<false>(live ? res[k0 + lane] : T(0), my_inv, lrow);
    if (live) {
      zv[k0 + lane] = zc;
      z_out[vec0 + k0 + lane] = zc;
      logdet -= T(2) * log(my_inv);
    }
  };
  bet::chol_factorise<kThreads>(a, ld, t, on_diag, on_panel);

  // alpha = L^-T z, panels from the last one up, in place in zv.
  for (int k0 = (t - 1) / kPanel * kPanel;; k0 -= kPanel) {
    const int nb = min(kPanel, t - k0);
    if (warp == 0) {
      const bool live = lane < nb;
      const T* d = a + k0 * ld + k0;
      T ucol[kPanel];  // L[k0+c][k0+lane] for c > lane, from L11^T above the diagonal
      block_row(d, ld, nb, min(kPanel, ld - k0), ucol,
                [&](int c) { return live && c > lane && c < nb; });
      const T inv = live ? T(1) / d[lane * ld + lane] : T(1);
      const T x = warp_tri_solve<true>(live ? zv[k0 + lane] : T(0), inv, ucol);
      if (live) zv[k0 + lane] = x;
    }
    __syncthreads();
    if (k0 == 0) break;
    // r[0:k0] -= L[k0:k0+nb, 0:k0]^T alpha_p: lanes 8q .. 8q+7 of a warp
    // read eight consecutive 16-byte column groups of the panel's rows
    // 8q .. 8q+7, and the four quarters are summed by shuffles.
    const int q = lane >> 3;
    T al[8];
#pragma unroll
    for (int v = 0; v < 8; v += kVec) bet::load16(zv + k0 + 8 * q + v, al + v);
    for (int g0 = warp * 8; g0 < k0 / kVec; g0 += kWarps * 8) {
      const int j = (g0 + (lane & 7)) * kVec;
      T acc[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[e] = T(0);
#pragma unroll
      for (int rr = 0; rr < 8; ++rr) {
        if (8 * q + rr < nb) {
          T lv[kVec];
          bet::load16(a + (k0 + 8 * q + rr) * ld + j, lv);
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[e] += lv[e] * al[rr];
        }
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        acc[e] += __shfl_xor_sync(bet::kFullWarp, acc[e], 8);
        acc[e] += __shfl_xor_sync(bet::kFullWarp, acc[e], 16);
      }
      if (q == 0) {
        T r[kVec];
        bet::load16(zv + j, r);
#pragma unroll
        for (int e = 0; e < kVec; ++e) r[e] -= acc[e];
        bet::store16(zv + j, r);
      }
    }
    __syncthreads();
  }
  BET_PHASE_CLOCK();  // the backward substitution

  bet::store_lower<kThreads>(l_out + mat0, a, ld, t);
  for (int q = tid; q < t; q += kThreads) alpha_out[vec0 + q] = zv[q];
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
