// The Matern-3/2 Gram of the GP fit, and the contraction of the NLML's
// gradient against it down to two scalars a matrix.
//
// Replaces no Pallas TPU kernel: the JAX package builds the Gram in
// bayesian_ensembling_tpu/ops/gp.py::_nlml_from_stat and leaves it, and its
// gradient, to XLA, which fuses the elementwise chain on the TPU.  PyTorch
// runs the same chain as separate passes over the (B, T, T) batch: about 9
// forward and, through autograd, about 15 backward, with two T x T
// reductions (ops/gp._build_batch_step on the CPU).
//
//   gram:  ky[b,i,j] = v_b (1 + s) exp(-s) + [i == j] (noise[b,i] + jitter),
//          s = sqrt3 r, r = dist[b,i,j] / ls_b;
//   grad:  G = g_logdet K^-1 - g_quad alpha alpha^T (the NLML's d/dK),
//          g_v_b  = sum_ij G_ij (1 + s) exp(-s),
//          g_ls_b = (v_b / ls_b) sum_ij G_ij s^2 exp(-s).
//
// What bounds it on an H100: bytes.  The build reads dist and writes ky, the
// contraction reads K^-1 and dist: two T x T passes each, against a few
// tens of operations an element (an IEEE division and an exp), so 8 B (f32)
// an element at 3.35 TB/s.  At the gridded batch, (41,472, 86, 86) f32,
// that is 0.73 ms a kernel.
//
// Design: the flattened T x T of each matrix is cut into `chunks` equal
// ranges (ops/gram.py picks the count from T alone, about 512 elements a
// range), and one warp takes one (matrix, range) item; a block holds 8 items,
// so up to T = 22 eight matrices share a block, at T = 86 (15 ranges) a
// matrix spans two or three, and at T = 1980 958.  Lanes walk their range
// 32 apart, four loads in flight, coalesced along the rows; the row and
// column come from one multiply-high by a magic number (no division).
//  * The build computes each element in the chain's order with IEEE
//    rounding at every step (explicitly rounded intrinsics, so nvcc cannot
//    contract a product and a sum into an FMA; expf / exp as PyTorch's exp
//    calls them), so ky equals the chain bit for bit.
//  * The contraction computes s and exp(-s) as the build does and each
//    element's two terms in the element type, as the chain does, but sums
//    them in double: each lane in its order, then the warp by shuffles;
//    each warp writes its range's two partial sums, and a second launch
//    adds a matrix's partials in range order, one warp a matrix.  Fixed order everywhere and no atomics: two launches
//    give the same bits, and a matrix's result does not depend on the batch
//    it is in.
#include "common.cuh"

#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;
constexpr double kSqrt3 = 1.7320508075688772;

// n / d for n, d < 2^31 by a multiply-high and a shift (the divider of
// PyTorch's index arithmetic, after Granlund and Montgomery).
struct FastDiv {
  unsigned d, magic, shift;
};

FastDiv make_fast_div(unsigned d) {
  FastDiv f{d, 0u, 0u};
  while (f.shift < 32 && (1u << f.shift) < d) ++f.shift;
  const uint64_t one = 1;
  f.magic = static_cast<unsigned>(((one << 32) * ((one << f.shift) - d)) / d + 1);
  return f;
}

__device__ __forceinline__ unsigned fast_div(unsigned n, const FastDiv& f) {
  return (__umulhi(n, f.magic) + n) >> f.shift;
}

template <typename T>
struct Ieee;

template <>
struct Ieee<float> {
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float exp(float a) { return expf(a); }
};

template <>
struct Ieee<double> {
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double exp(double a) { return ::exp(a); }
};

// s = sqrt3 (dist / ls) and exp(-s), rounded as the chain rounds them:
// sqrt3 * r with sqrt3 in the element type, and -s as (-sqrt3) * r, whose
// rounding is the negative of s's.
template <typename T>
__device__ __forceinline__ void scaled_distance(T dist, T ls, T& s, T& e) {
  using N = bet::Num<T>;
  s = N::mul_rn(static_cast<T>(kSqrt3), Ieee<T>::div(dist, ls));
  e = Ieee<T>::exp(-s);
}

// The (matrix, range) item of this warp: range p of matrix m, elements
// [e0, e1) of its flattened T x T.  False past the last item.
struct Item {
  int m;
  unsigned p, e0, e1;
};

__device__ __forceinline__ bool warp_item(int b, int chunks, unsigned tt, Item& it) {
  const long long item = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (item >= static_cast<long long>(b) * chunks) return false;
  it.m = static_cast<int>(item / chunks);
  it.p = static_cast<unsigned>(item - static_cast<long long>(it.m) * chunks);
  const unsigned len = (tt + chunks - 1) / chunks;
  it.e0 = min(tt, it.p * len);
  it.e1 = min(tt, it.e0 + len);
  return true;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gram_kernel(const T* __restrict__ dist, const T* __restrict__ ls, const T* __restrict__ var,
                const T* __restrict__ noise, T* __restrict__ ky, int b, int t, int chunks,
                FastDiv by_t, T jitter) {
  using N = bet::Num<T>;
  const unsigned tt = static_cast<unsigned>(t) * t;
  Item it;
  if (!warp_item(b, chunks, tt, it)) return;
  const int m = it.m;
  const unsigned e0 = it.e0, e1 = it.e1;
  const size_t base = static_cast<size_t>(m) * tt;
  const T l = ls[m], v = var[m];
  const T* nz = noise + static_cast<size_t>(m) * t;
  const unsigned lane = threadIdx.x & 31;
  for (unsigned e = e0 + lane; e < e1; e += 32 * kUnroll) {
    T d[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned f = e + 32 * u;
      d[u] = f < e1 ? dist[base + f] : T(0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned f = e + 32 * u;
      if (f >= e1) break;
      const unsigned i = fast_div(f, by_t);
      const bool diag = f - i * t == i;
      T s, ex;
      scaled_distance(d[u], l, s, ex);
      const T k = N::mul_rn(N::mul_rn(v, N::add_rn(T(1), s)), ex);
      // (k + diag_embed(noise)) + jitter * I, zeros and all, as the chain adds.
      ky[base + f] = N::add_rn(N::add_rn(k, diag ? nz[i] : T(0)), diag ? jitter : T(0));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gram_grad_kernel(const T* __restrict__ kinv, const T* __restrict__ alpha,
                     const T* __restrict__ g_quad, const T* __restrict__ g_logdet,
                     const T* __restrict__ dist, const T* __restrict__ ls,
                     double* __restrict__ partial, int b, int t, int chunks, FastDiv by_t) {
  const unsigned tt = static_cast<unsigned>(t) * t;
  Item it;
  if (!warp_item(b, chunks, tt, it)) return;
  const int m = it.m;
  const unsigned e0 = it.e0, e1 = it.e1;
  const size_t base = static_cast<size_t>(m) * tt;
  const T l = ls[m], gq = g_quad[m], gl = g_logdet[m];
  const T* a = alpha + static_cast<size_t>(m) * t;
  const unsigned lane = threadIdx.x & 31;
  double acc_v = 0.0, acc_l = 0.0;
  for (unsigned e = e0 + lane; e < e1; e += 32 * kUnroll) {
    T d[kUnroll], k[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned f = e + 32 * u;
      d[u] = f < e1 ? dist[base + f] : T(0);
      k[u] = f < e1 ? kinv[base + f] : T(0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned f = e + 32 * u;
      if (f >= e1) break;
      const unsigned i = fast_div(f, by_t);
      const unsigned j = f - i * t;
      T s, ex;
      scaled_distance(d[u], l, s, ex);
      const T g = gl * k[u] - gq * (a[i] * a[j]);
      acc_v += static_cast<double>(g * ((T(1) + s) * ex));
      acc_l += static_cast<double>(g * (s * s * ex));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc_v += __shfl_down_sync(0xffffffffu, acc_v, off);
    acc_l += __shfl_down_sync(0xffffffffu, acc_l, off);
  }
  if (lane == 0) {
    double* out = partial + 2 * (static_cast<size_t>(m) * chunks + it.p);
    out[0] = acc_v;
    out[1] = acc_l;
  }
}

// One warp a matrix: its ranges' partial sums in range order, then
// g_var = sum_v and g_ls = (v / ls) sum_l.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gram_grad_finish_kernel(const double* __restrict__ partial, const T* __restrict__ ls,
                            const T* __restrict__ var, T* __restrict__ g_ls, T* __restrict__ g_var,
                            int b, int chunks) {
  const long long m = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (m >= b) return;
  const unsigned lane = threadIdx.x & 31;
  const double* p = partial + 2 * m * chunks;
  double sv = 0.0, sl = 0.0;
  for (int c = lane; c < chunks; c += 32) {
    sv += p[2 * c];
    sl += p[2 * c + 1];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sv += __shfl_down_sync(0xffffffffu, sv, off);
    sl += __shfl_down_sync(0xffffffffu, sl, off);
  }
  if (lane == 0) {
    g_var[m] = static_cast<T>(sv);
    g_ls[m] = static_cast<T>(static_cast<double>(var[m]) / static_cast<double>(ls[m]) * sl);
  }
}

// The largest T whose T x T offsets stay below 2^31 (FastDiv's range).
constexpr int kMaxT = 46340;

int blocks_for(long long warps) { return static_cast<int>((warps + kWarps - 1) / kWarps); }

bool bad_shape(int b, int t, int chunks) {
  return t > kMaxT || chunks <= 0 || static_cast<long long>(t) * t < chunks ||
         static_cast<long long>(b) * chunks > (1ll << 31) - 1 - kWarps;
}

template <typename T>
int launch_gram(const void* dist, const void* ls, const void* var, const void* noise, void* ky,
                int b, int t, int chunks, double jitter, void* stream) {
  if (b <= 0 || t <= 0) return cudaSuccess;
  if (bad_shape(b, t, chunks)) return cudaErrorInvalidValue;
  gram_kernel<T><<<blocks_for(static_cast<long long>(b) * chunks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(dist), static_cast<const T*>(ls), static_cast<const T*>(var),
      static_cast<const T*>(noise), static_cast<T*>(ky), b, t, chunks,
      make_fast_div(static_cast<unsigned>(t)), static_cast<T>(jitter));
  return cudaGetLastError();
}

template <typename T>
int launch_gram_grad(const void* kinv, const void* alpha, const void* g_quad,
                     const void* g_logdet, const void* dist, const void* ls, const void* var,
                     void* partial, void* g_ls, void* g_var, int b, int t, int chunks,
                     void* stream) {
  if (b <= 0) return cudaSuccess;
  if (t <= 0 || bad_shape(b, t, chunks)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gram_grad_kernel<T><<<blocks_for(static_cast<long long>(b) * chunks), kThreads, 0, s>>>(
      static_cast<const T*>(kinv), static_cast<const T*>(alpha), static_cast<const T*>(g_quad),
      static_cast<const T*>(g_logdet), static_cast<const T*>(dist), static_cast<const T*>(ls),
      static_cast<double*>(partial), b, t, chunks, make_fast_div(static_cast<unsigned>(t)));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gram_grad_finish_kernel<T><<<blocks_for(b), kThreads, 0, s>>>(
      static_cast<const double*>(partial), static_cast<const T*>(ls), static_cast<const T*>(var),
      static_cast<T*>(g_ls), static_cast<T*>(g_var), b, chunks);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int bet_gram_matern32_f32(const void* dist, const void* ls, const void* var, const void* noise,
                          void* ky, int b, int t, int chunks, double jitter, void* stream) {
  return launch_gram<float>(dist, ls, var, noise, ky, b, t, chunks, jitter, stream);
}

int bet_gram_matern32_f64(const void* dist, const void* ls, const void* var, const void* noise,
                          void* ky, int b, int t, int chunks, double jitter, void* stream) {
  return launch_gram<double>(dist, ls, var, noise, ky, b, t, chunks, jitter, stream);
}

int bet_gram_matern32_grad_f32(const void* kinv, const void* alpha, const void* g_quad,
                               const void* g_logdet, const void* dist, const void* ls,
                               const void* var, void* partial, void* g_ls, void* g_var, int b,
                               int t, int chunks, void* stream) {
  return launch_gram_grad<float>(kinv, alpha, g_quad, g_logdet, dist, ls, var, partial, g_ls,
                                 g_var, b, t, chunks, stream);
}

int bet_gram_matern32_grad_f64(const void* kinv, const void* alpha, const void* g_quad,
                               const void* g_logdet, const void* dist, const void* ls,
                               const void* var, void* partial, void* g_ls, void* g_var, int b,
                               int t, int chunks, void* stream) {
  return launch_gram_grad<double>(kinv, alpha, g_quad, g_logdet, dist, ls, var, partial, g_ls,
                                  g_var, b, t, chunks, stream);
}

}  // extern "C"
