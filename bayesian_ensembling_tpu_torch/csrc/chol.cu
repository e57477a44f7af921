// Cholesky factor of a batch of small SPD matrices: K = L L^T.
//
// Replaces the Pallas TPU kernel
//   bayesian_ensembling_tpu/ops/linalg_pallas.py::_chol_kernel
//   (public entry cholesky_batched).  Its hot caller is the recursive blocked
//   NLML (ops/linalg_blocked.py), which factors the 128 x 128 diagonal blocks
//   of the monthly SSP batch (B=65) with it.
//
// What bounds it on an H100: T^3/3 flops per matrix (0.7 MFLOP at T=128) in
// a chain of T dependent column steps.  At B=65 (fewer blocks than the 132
// SMs) it is latency-bound: the time is T steps of two barriers and one
// trailing update spread over the block.  Device memory traffic is one read
// of K and one write of L.
//
// Design: the column loop of the fused Cholesky-solve (chol_factorise.cuh)
// without its solve hooks.  One block of 512 threads per matrix, K in
// dynamic shared memory with an odd leading dimension (66 KB at T=128 in
// f32); T <= 240 in f32 and T <= 169 in f64, the launcher refuses more.  A
// non-positive pivot gives NaN in that matrix only; L is written with zeros
// above the diagonal.
#include "chol_factorise.cuh"

namespace {

constexpr int kThreads = 512;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    chol_kernel(const T* __restrict__ ky, T* __restrict__ l_out, int t) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = bet::smem_ld(t);
  T* a = reinterpret_cast<T*>(smem);  // t x ld, factorised in place
  T* col = a + static_cast<size_t>(t) * ld;

  const int tid = threadIdx.x;
  const size_t mat0 = static_cast<size_t>(blockIdx.x) * t * t;
  for (int q = tid; q < t * t; q += kThreads) {
    const int i = q / t;
    a[i * ld + (q - i * t)] = ky[mat0 + q];
  }
  __syncthreads();

  bet::chol_factorise<kThreads>(a, ld, col, t, [](int, T, T) {}, [](int, T) {});

  for (int q = tid; q < t * t; q += kThreads) {
    const int i = q / t;
    const int j = q - i * t;
    l_out[mat0 + q] = j <= i ? a[i * ld + j] : T(0);
  }
}

template <typename T>
size_t chol_smem_bytes(int t) {
  return sizeof(T) * (static_cast<size_t>(t) * bet::smem_ld(t) + static_cast<size_t>(t));
}

template <typename T>
int launch_chol(const void* ky, void* l, int b, int t, void* stream) {
  if (b <= 0 || t <= 0) return cudaSuccess;
  const size_t smem = chol_smem_bytes<T>(t);
  cudaError_t err = bet::set_dynamic_smem(chol_kernel<T>, smem);
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
