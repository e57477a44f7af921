// Inverse of a batch of lower-triangular Cholesky factors: W = L^-1.
//
// Replaces the Pallas TPU kernel
//   bayesian_ensembling_tpu/ops/linalg_pallas.py::_tri_inv_kernel_streamed
//   (public entry tri_inv_batched).
//
// What bounds it on an H100: T^3/6 multiply-adds per matrix in a chain of T
// dependent steps.  At the main path's batch (B=112 < 132 SMs) it is
// latency-bound like the Cholesky: T steps of (one barrier + one rank-1
// update of the rows below).  Device memory traffic is one read of L and
// one write of W.
//
// Design:
//  * One block of 512 threads per matrix; W lives in dynamic shared memory
//    (starts as the identity, odd leading dimension).  L stays in device
//    memory, where it is L2-resident, and its columns are streamed through
//    a two-slot shared buffer: each thread loads its element of column j+1
//    into a register before step j's update and stores it after, so the
//    load latency hides behind the update (the TPU kernel double-buffers
//    L's columns by DMA for the same reason).
//  * Step j eliminates rows i > j with the still unscaled row j,
//    W[i, :j] -= (L[i,j] / L[j,j]) W[j, :j], and scales row j-1 by
//    1/L[j-1,j-1].  No thread touches row j-1 in step j, so the scaling
//    needs no extra barrier: one __syncthreads per step.
//  * Requires T <= 512 (one prefetch register per thread) and W in shared
//    memory (T <= 240 in f32, T <= 169 in f64); the launcher refuses more.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;  // fastest of 128..1024 at T=86 and 165 on an H100

template <typename T>
__global__ void __launch_bounds__(kThreads)
    tri_inv_kernel(const T* __restrict__ l, T* __restrict__ w_out, int t) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = bet::smem_ld(t);
  T* w = reinterpret_cast<T*>(smem);  // t x ld
  T* colbuf = w + static_cast<size_t>(t) * ld;  // 2 x t: columns j and j+1 of L

  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;
  constexpr int kRows = kThreads / 32;
  const size_t mat0 = static_cast<size_t>(blockIdx.x) * t * t;
  const T* lb = l + mat0;

  for (int q = tid; q < t * t; q += kThreads) {
    const int i = q / t;
    const int c = q - i * t;
    w[i * ld + c] = i == c ? T(1) : T(0);
  }
  if (tid < t) colbuf[tid] = lb[tid * t];
  __syncthreads();

  T inv_prev = T(0);
  for (int j = 0; j < t; ++j) {
    const T* cj = colbuf + (j & 1) * t;
    const int pi = j + 1 + tid;
    const bool prefetch = pi < t;
    T pf = T(0);
    if (prefetch) pf = lb[pi * t + j + 1];

    const T inv = T(1) / cj[j];
    if (j > 0) {
      T* prev = w + (j - 1) * ld;
      for (int c = tid; c < j; c += kThreads) prev[c] *= inv_prev;
    }
    const T* wj = w + j * ld;
    for (int i = j + 1 + ty; i < t; i += kRows) {
      const T f = cj[i] * inv;
      T* row = w + i * ld;
      for (int c = tx; c <= j; c += 32) row[c] -= f * wj[c];
    }
    if (prefetch) colbuf[((j + 1) & 1) * t + pi] = pf;
    inv_prev = inv;
    __syncthreads();
  }
  {
    T* last = w + (t - 1) * ld;
    for (int c = tid; c < t; c += kThreads) last[c] *= inv_prev;
  }
  __syncthreads();

  for (int q = tid; q < t * t; q += kThreads) {
    const int i = q / t;
    const int c = q - i * t;
    w_out[mat0 + q] = c <= i ? w[i * ld + c] : T(0);
  }
}

template <typename T>
size_t tri_inv_smem_bytes(int t) {
  return sizeof(T) * (static_cast<size_t>(t) * bet::smem_ld(t) + 2 * static_cast<size_t>(t));
}

template <typename T>
int launch_tri_inv(const void* l, void* w, int b, int t, void* stream) {
  if (b <= 0 || t <= 0) return cudaSuccess;
  if (t > kThreads) return cudaErrorInvalidValue;
  const size_t smem = tri_inv_smem_bytes<T>(t);
  cudaError_t err = bet::set_dynamic_smem(tri_inv_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  tri_inv_kernel<T><<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(l), static_cast<T*>(w), t);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int bet_tri_inv_f32(const void* l, void* w, int b, int t, void* stream) {
  return launch_tri_inv<float>(l, w, b, t, stream);
}

int bet_tri_inv_f64(const void* l, void* w, int b, int t, void* stream) {
  return launch_tri_inv<double>(l, w, b, t, stream);
}

}  // extern "C"
