// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel is a template over the element type (float, double) and is
// exported through a plain C entry point that takes raw device pointers, the
// sizes and a cudaStream_t, and returns cudaGetLastError() after the launch
// (0 on success).  The Python side loads the library with ctypes.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace bet {

template <typename T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float nan() { return CUDART_NAN_F; }
  // Explicitly rounded ops where the result must equal the plain PyTorch
  // version bit for bit: nvcc would otherwise contract a*b+c into an FMA.
  static __device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
};

template <>
struct Num<double> {
  static __device__ __forceinline__ double nan() { return CUDART_NAN; }
  static __device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
};

// Opt the kernel into `bytes` of dynamic shared memory (above 48 KB needs
// the attribute).  Fails with cudaErrorInvalidValue when the request exceeds
// what one block may hold on this card.
template <typename Kernel>
inline cudaError_t set_dynamic_smem(Kernel kernel, size_t bytes) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (bytes > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Leading dimension of a T x T matrix held in shared memory: odd, so that
// walking down a column touches 32 different banks.
__host__ __device__ inline int smem_ld(int t) { return t | 1; }

}  // namespace bet
