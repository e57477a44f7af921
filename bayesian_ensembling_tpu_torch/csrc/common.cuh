// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel is a template over the element type (float, double) and is
// exported through a plain C entry point that takes raw device pointers, the
// sizes and a cudaStream_t, and returns cudaGetLastError() after the launch
// (0 on success).  The Python side loads the library with ctypes.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include <mutex>

// Phase clocks, compiled in only with -DBET_PHASE_CLOCKS (the build of
// utils/linalg_phase_clocks.py, one source per library): thread 0 of block 0
// records the SM's cycle counter at each BET_PHASE_CLOCK(), and
// bet_phase_clocks() copies the marks of the last launch to the host.  Where
// no profiler can look inside a kernel, this is what shows which phase of
// the chain the time goes to.
#ifdef BET_PHASE_CLOCKS
namespace bet {
constexpr int kMaxPhaseClocks = 256;
__device__ long long g_phase_clock[kMaxPhaseClocks];
__device__ int g_phase_count;
}  // namespace bet
#define BET_PHASE_CLOCK_RESET()                                           \
  do {                                                                    \
    if (blockIdx.x == 0 && threadIdx.x == 0) bet::g_phase_count = 0;      \
  } while (0)
#define BET_PHASE_CLOCK()                                                 \
  do {                                                                    \
    if (blockIdx.x == 0 && threadIdx.x == 0 &&                            \
        bet::g_phase_count < bet::kMaxPhaseClocks)                        \
      bet::g_phase_clock[bet::g_phase_count++] = clock64();               \
  } while (0)
extern "C" int bet_phase_clocks(long long* out, int* n) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err != cudaSuccess) return err;
  err = cudaMemcpyFromSymbol(n, bet::g_phase_count, sizeof(int));
  if (err != cudaSuccess) return err;
  return cudaMemcpyFromSymbol(out, bet::g_phase_clock, sizeof(long long) * bet::kMaxPhaseClocks);
}
#else
#define BET_PHASE_CLOCK_RESET() do {} while (0)
#define BET_PHASE_CLOCK() do {} while (0)
#endif

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
  static __device__ __forceinline__ float rsqrt(float a) { return rsqrtf(a); }  // within 2 ulp
  // 1/a within an ulp or so for a normal a, without the branches of an
  // IEEE division: the hardware's approximation and one Newton step.
  static __device__ __forceinline__ float rcp(float a) {
    float r;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(a));
    return fmaf(r, fmaf(-a, r, 1.0f), r);
  }
};

template <>
struct Num<double> {
  static __device__ __forceinline__ double nan() { return CUDART_NAN; }
  static __device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double rsqrt(double a) { return ::rsqrt(a); }  // within 1 ulp
  // The hardware's 20-bit approximation and two Newton steps.
  static __device__ __forceinline__ double rcp(double a) {
    double r;
    asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(a));
    r = fma(r, fma(-a, r, 1.0), r);
    return fma(r, fma(-a, r, 1.0), r);
  }
};

// Opt the kernel into `bytes` of dynamic shared memory (above 48 KB needs
// the attribute).  Fails with cudaErrorInvalidValue when the request, with
// the kernel's `static_bytes` of static shared memory, exceeds what one
// block may hold on this card.
template <typename Kernel>
inline cudaError_t set_dynamic_smem(Kernel kernel, size_t bytes, size_t static_bytes = 0) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (bytes + static_bytes > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// What one kernel instantiation has been granted so far in this process.  A
// launcher keeps one as a function-local static, so the device query and
// the attribute call of set_dynamic_smem happen once per kernel (and again
// only for a larger request or another device), not on every launch: on a
// host-bound path they are pure host time.
struct SmemGrant {
  std::mutex lock;
  int device = -1;
  size_t bytes = 0;
};

template <typename Kernel>
inline cudaError_t grant_dynamic_smem(Kernel kernel, size_t bytes, size_t static_bytes,
                                      SmemGrant& grant) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> guard(grant.lock);
  if (device == grant.device && bytes <= grant.bytes) return cudaSuccess;
  err = set_dynamic_smem(kernel, bytes, static_bytes);
  if (err != cudaSuccess) return err;
  grant.device = device;
  grant.bytes = bytes;
  return cudaSuccess;
}

}  // namespace bet
