// DBA update: squared-DTW alignment of many (centre, series) pairs, then the
// aligned-value sums and visit counts per centre slot.
//
// Replaces the Pallas TPU kernel
//   bayesian_ensembling_tpu/ops/dtw_pallas.py::_make_dba_update_kernel
//   (public entry dba_update_batch(impl="fused")).
//
// What bounds it on an H100: the DP is a chain of 2T-1 dependent
// anti-diagonal steps per pair, each only O(T) arithmetic, so the time goes
// to the per-step barrier and shared-memory latency, not to FLOPs or device
// memory (each pair reads 2T values and writes 2T).  The move codes are
// the only large state: (2T-1) x T bytes in the TPU kernel's diagonal
// layout.
//
// Design:
//  * One thread block per pair, one thread per row i of the cost matrix.
//    Step k of the wavefront computes cell (i, k-i) in every thread; the
//    last three cost diagonals live in shared memory (triple-buffered, so
//    one __syncthreads per step suffices).
//  * Move codes are stored per cell, moves[i*T + j], one byte each: T^2
//    bytes (27 KB at T=165) stay in shared memory, with no device-memory
//    round trip.  T is capped by shared memory (about T=470 in f32); the
//    launcher refuses larger T.
//  * The path is unique, so the TPU kernel's backward on-path sweep equals a
//    traceback from the corner (T-1, T-1).  One thread walks it and sums the
//    aligned values per centre slot in the same order as the plain version
//    (descending anti-diagonal), so sums and counts match it exactly.
//  * Tie-break diag, then left, then top; invalid cells hold the same 3e38
//    sentinel as the TPU kernel.  Local costs use explicitly rounded
//    multiply and add, so valid cells equal the plain version bit for bit.
#include "common.cuh"

namespace {

constexpr double kBig = 3.0e38;

template <typename T>
__global__ void dba_update_kernel(const T* __restrict__ centers, const T* __restrict__ series,
                                  T* __restrict__ sums, T* __restrict__ counts, int t) {
  using N = bet::Num<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* s = reinterpret_cast<T*>(smem);  // the series, t values
  // Three cost diagonals (k mod 3), each t+1 slots: slot i+1 holds row i,
  // slot 0 is the sentinel for row -1.
  T* diag = s + t;
  unsigned char* moves = reinterpret_cast<unsigned char*>(diag + 3 * (t + 1));

  const T big = static_cast<T>(kBig);
  const size_t row0 = static_cast<size_t>(blockIdx.x) * t;
  const int i = threadIdx.x;

  for (int q = threadIdx.x; q < t; q += blockDim.x) s[q] = series[row0 + q];
  for (int q = threadIdx.x; q < 3 * (t + 1); q += blockDim.x) diag[q] = big;
  const T ci = i < t ? centers[row0 + i] : T(0);
  __syncthreads();
  if (i == 0) {
    const T d = N::sub_rn(ci, s[0]);
    diag[1] = N::mul_rn(d, d);  // diagonal 0 = cell (0, 0), buffer 0
  }
  __syncthreads();

  for (int k = 1; k < 2 * t - 1; ++k) {
    T* cur = diag + (k % 3) * (t + 1);
    const T* p1 = diag + ((k + 2) % 3) * (t + 1);  // diagonal k-1
    const T* p2 = diag + ((k + 1) % 3) * (t + 1);  // diagonal k-2
    if (i < t) {
      const int j = k - i;
      T val = big;
      if (j >= 0 && j < t) {
        const T dg = p2[i];     // (i-1, j-1)
        const T lf = p1[i + 1]; // (i,   j-1)
        const T tp = p1[i];     // (i-1, j)
        T best;
        unsigned char mv;
        if (dg <= lf && dg <= tp) {
          best = dg;
          mv = 0;
        } else if (lf <= tp) {
          best = lf;
          mv = 1;
        } else {
          best = tp;
          mv = 2;
        }
        const T d = N::sub_rn(ci, s[j]);
        val = N::add_rn(best, N::mul_rn(d, d));
        moves[i * t + j] = mv;
      }
      cur[i + 1] = val;
    }
    __syncthreads();
  }

  if (threadIdx.x == 0) {
    // Traceback from the corner.  Rows are visited in descending order and
    // each row's cells in descending column order, so every slot is written
    // once, after its last contribution.
    T* out_s = sums + row0;
    T* out_c = counts + row0;
    int ii = t - 1, jj = t - 1;
    T acc = s[jj];
    T cnt = T(1);
    while (ii > 0 || jj > 0) {
      int mv = moves[ii * t + jj];
      if (ii == 0) mv = 1;       // the first row can only move left
      else if (jj == 0) mv = 2;  // the first column can only move up
      const int ni = ii - (mv != 1);
      jj -= (mv != 2);
      if (ni != ii) {
        out_s[ii] = acc;
        out_c[ii] = cnt;
        acc = T(0);
        cnt = T(0);
        ii = ni;
      }
      acc = N::add_rn(acc, s[jj]);
      cnt += T(1);
    }
    out_s[0] = acc;
    out_c[0] = cnt;
  }
}

template <typename T>
size_t dba_smem_bytes(int t) {
  return sizeof(T) * (t + 3 * (t + 1)) + static_cast<size_t>(t) * t;
}

template <typename T>
int launch_dba_update(const void* centers, const void* series, void* sums, void* counts, int n,
                      int t, void* stream) {
  if (n <= 0 || t <= 0) return cudaSuccess;
  if (t > 1024) return cudaErrorInvalidValue;  // one thread per row
  const size_t smem = dba_smem_bytes<T>(t);
  cudaError_t err = bet::set_dynamic_smem(dba_update_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const int threads = (t + 31) / 32 * 32;
  dba_update_kernel<T><<<n, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(centers), static_cast<const T*>(series), static_cast<T*>(sums),
      static_cast<T*>(counts), t);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int bet_dba_update_f32(const void* centers, const void* series, void* sums, void* counts, int n,
                       int t, void* stream) {
  return launch_dba_update<float>(centers, series, sums, counts, n, t, stream);
}

int bet_dba_update_f64(const void* centers, const void* series, void* sums, void* counts, int n,
                       int t, void* stream) {
  return launch_dba_update<double>(centers, series, sums, counts, n, t, stream);
}

const char* bet_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
