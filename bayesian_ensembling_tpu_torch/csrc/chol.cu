// Cholesky factor of a batch of small SPD matrices: K = L L^T.
//
// Replaces the Pallas TPU kernel
//   bayesian_ensembling_tpu/ops/linalg_pallas.py::_chol_kernel
//   (public entry cholesky_batched).  Its hot caller is the recursive blocked
//   NLML (ops/linalg_blocked.py), which factors the 128 x 128 diagonal blocks
//   of the monthly SSP batch (B=65) with it; the library API factors one
//   scenario's posterior covariances (B=16, T=165 and 86).
//
// What bounds it on an H100: T^3/3 flops per matrix (0.7 MFLOP at T=128) and
// one read of K's lower triangle and one write of L are worth a few
// microseconds; with one block per matrix and B below the 132 SMs the time
// is the dependent chain of the factorisation.
//
// Design: the panel-blocked body of chol_factorise.cuh (32-column panels:
// the diagonal block in one warp's registers, the rows below two threads
// each, the trailing update as register-tiled 32 x 32 blocks; three
// barriers per panel) without a panel hook.  One block of 256 threads per
// matrix, K's lower triangle in dynamic shared memory with rows on 16-byte
// boundaries (68 KB at T=128 in f32); T <= 240 in f32 and T <= 170 in f64,
// the launcher refuses more.  A non-positive pivot gives NaN in that matrix
// only, from that column on; L is written with zeros above the diagonal.
#include "chol_factorise.cuh"

namespace {

// Threads per block.  256 and 512 take the same time in float32 (phase
// clocks, T = 165 and 128); 256 leaves each thread 255 registers, which ends
// the float64 kernel's spills.
#ifndef BET_CHOL_THREADS
#define BET_CHOL_THREADS 256
#endif
constexpr int kThreads = BET_CHOL_THREADS;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    chol_kernel(const T* __restrict__ ky, T* __restrict__ l_out, int t) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = bet::smem_ld<T>(t);
  T* a = reinterpret_cast<T*>(smem);  // t x ld, factorised in place

  const size_t mat0 = static_cast<size_t>(blockIdx.x) * t * t;
  BET_PHASE_CLOCK_RESET();
  BET_PHASE_CLOCK();
  bet::load_lower<kThreads, false>(a, ld, ky + mat0, t);
  __syncthreads();
  BET_PHASE_CLOCK();  // the load

  bet::chol_factorise<kThreads>(a, ld, t, [](int) {}, [](int, int, const T*) {});

  bet::store_lower<kThreads>(l_out + mat0, a, ld, t);
  BET_PHASE_CLOCK();  // the store, as thread 0 sees it
}

template <typename T>
size_t chol_smem_bytes(int t) {
  return sizeof(T) * static_cast<size_t>(t) * bet::smem_ld<T>(t);
}

template <typename T>
int launch_chol(const void* ky, void* l, int b, int t, void* stream) {
  static bet::SmemGrant grant;
  if (b <= 0 || t <= 0) return cudaSuccess;
  const size_t smem = chol_smem_bytes<T>(t);
  cudaError_t err = bet::grant_dynamic_smem(chol_kernel<T>, smem,
                                            bet::chol_factorise_static_bytes<T>(), grant);
  if (err != cudaSuccess) return err;
  chol_kernel<T><<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(ky), static_cast<T*>(l), t);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int bet_chol_f32(const void* ky, void* l, int b, int t, void* stream) {
  return launch_chol<float>(ky, l, b, t, stream);
}

int bet_chol_f64(const void* ky, void* l, int b, int t, void* stream) {
  return launch_chol<double>(ky, l, b, t, stream);
}

}  // extern "C"
