// Squared-DTW cost of many (centre, series) pairs: the anti-diagonal
// wavefront DP with no move codes, returning cell (T-1, T-1).
//
// Replaces the Pallas TPU kernel
//   bayesian_ensembling_tpu/ops/dtw_pallas.py::_make_dtw_cost_kernel
//   (public entry squared_dtw_cost_batch).
// It serves the medoid initialisation of the DBA (all R(R-1)/2 pairs of
// every model in one launch) and the subgradient DBA's per-epoch cost.
//
// What bounds it on an H100: as for dba_update.cu, the chain of 2T-1
// dependent anti-diagonal steps per pair, each one barrier and O(T) cells,
// so barrier and shared-memory latency set its time, not FLOPs or device
// memory (each pair reads 2T values and writes one).
//
// Design:
//  * dba_update.cu's wavefront without its move codes and traceback: one
//    block per pair; shared memory holds the series, the centre and three
//    cost diagonals (t+1 slots each, slot 0 the sentinel of row -1), 5T+3
//    values, so T is capped only at 11,621 in f32 and 5,810 in f64.
//  * Up to 512 threads per block; each owns the rows i = tid, tid + blockDim,
//    ... (strided over threads when T > 512, as in dba_update_split.cu).
//    Only valid cells are written: a slot read for an invalid cell has never
//    been written and still holds the sentinel.
//  * Valid cells take min(best + delta, 3e38), the TPU kernel's saturation,
//    with best chosen by dba_update.cu's comparisons; the local cost uses
//    explicitly rounded multiply and add, so every valid cell equals the
//    plain version bit for bit (nvcc would otherwise fuse best + d*d into an
//    FMA).  T = 1 needs no step: the corner is cell (0, 0).
#include "common.cuh"

namespace {

constexpr double kBig = 3.0e38;
constexpr int kMaxThreads = 512;

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    dtw_cost_kernel(const T* __restrict__ centers, const T* __restrict__ series,
                    T* __restrict__ out, int t) {
  using N = bet::Num<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* s = reinterpret_cast<T*>(smem);  // the series, t values
  T* c = s + t;                       // the centre, t values
  T* diag = c + t;                    // three diagonals (k mod 3), slot i+1 = row i

  const T big = static_cast<T>(kBig);
  const size_t row0 = static_cast<size_t>(blockIdx.x) * t;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;

  for (int q = tid; q < t; q += nthreads) {
    s[q] = series[row0 + q];
    c[q] = centers[row0 + q];
  }
  for (int q = tid; q < 3 * (t + 1); q += nthreads) diag[q] = big;
  __syncthreads();
  if (tid == 0) {
    const T d = N::sub_rn(c[0], s[0]);
    diag[1] = N::mul_rn(d, d);  // diagonal 0 = cell (0, 0), buffer 0
  }
  __syncthreads();

  for (int k = 1; k < 2 * t - 1; ++k) {
    T* cur = diag + (k % 3) * (t + 1);
    const T* p1 = diag + ((k + 2) % 3) * (t + 1);  // diagonal k-1
    const T* p2 = diag + ((k + 1) % 3) * (t + 1);  // diagonal k-2
    const int lo = k - t + 1 > 0 ? k - t + 1 : 0;
    const int hi = k < t - 1 ? k : t - 1;
    for (int i = lo + tid; i <= hi; i += nthreads) {
      const T dg = p2[i];      // (i-1, j-1)
      const T lf = p1[i + 1];  // (i,   j-1)
      const T tp = p1[i];      // (i-1, j)
      T best;
      if (dg <= lf && dg <= tp) {
        best = dg;
      } else if (lf <= tp) {
        best = lf;
      } else {
        best = tp;
      }
      const T d = N::sub_rn(c[i], s[k - i]);
      const T v = N::add_rn(best, N::mul_rn(d, d));
      cur[i + 1] = v > big ? big : v;  // NaN passes through, as jnp.minimum's
    }
    __syncthreads();
  }

  if (tid == 0) out[blockIdx.x] = diag[((2 * t - 2) % 3) * (t + 1) + t];
}

template <typename T>
size_t dtw_cost_smem_bytes(int t) {
  return sizeof(T) * (2 * static_cast<size_t>(t) + 3 * (static_cast<size_t>(t) + 1));
}

template <typename T>
int launch_dtw_cost(const void* centers, const void* series, void* out, int n, int t,
                    void* stream) {
  if (n <= 0 || t <= 0) return cudaSuccess;
  const size_t smem = dtw_cost_smem_bytes<T>(t);
  cudaError_t err = bet::set_dynamic_smem(dtw_cost_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const int rounded = (t + 31) / 32 * 32;
  const int threads = rounded < kMaxThreads ? rounded : kMaxThreads;
  dtw_cost_kernel<T><<<n, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(centers), static_cast<const T*>(series), static_cast<T*>(out), t);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int bet_dtw_cost_f32(const void* centers, const void* series, void* out, int n, int t,
                     void* stream) {
  return launch_dtw_cost<float>(centers, series, out, n, t, stream);
}

int bet_dtw_cost_f64(const void* centers, const void* series, void* out, int n, int t,
                     void* stream) {
  return launch_dtw_cost<double>(centers, series, out, n, t, stream);
}

}  // extern "C"
