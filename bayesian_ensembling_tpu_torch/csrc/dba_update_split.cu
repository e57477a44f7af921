// Large-T DBA update: the same function as dba_update.cu (squared-DTW
// alignment of many (centre, series) pairs, then the aligned-value sums and
// visit counts per centre slot), with the move codes in device memory.
//
// Replaces the Pallas TPU kernel pair
//   bayesian_ensembling_tpu/ops/dtw_pallas.py::_make_dba_fwd_kernel and
//   ::_make_dba_bwd_kernel (public entry dba_update_batch(impl="split")),
//   which exists because the fused TPU kernel outgrew the 16 MB VMEM at the
//   monthly historical T=1980.  On Hopper the split does not help: what
//   outgrows shared memory is the move codes alone, so this one kernel keeps
//   them in device memory and everything else on chip.
//
// What bounds it on an H100: as for dba_update.cu, the chain of 2T-1
// dependent anti-diagonal steps, each one barrier and O(T/blockDim) cells per
// thread (T=1980: 3,959 steps).  The move codes add (2T-1) x T bytes per
// pair of device-memory writes (7.8 MB at T=1980), written coalesced, and
// the traceback adds 2T dependent one-byte reads by one thread, which miss
// in L2 when hundreds of pairs are in flight.
//
// Design:
//  * One block of 512 threads per pair; each thread owns the rows
//    i = tid, tid + 512, ... (T=1980: four rows), so that consecutive
//    threads touch consecutive shared-memory words and code bytes.
//  * Shared memory holds the series, the centre and three cost diagonals
//    (t+1 slots each, slot 0 the sentinel of row -1): 5T+3 values, 40 KB at
//    T=1980 in f32.  This caps T at 11,621 in f32 and 5,810 in f64; the
//    launcher refuses more.  Only valid cells are written: a slot read for
//    an invalid cell has never been written and still holds the sentinel.
//  * Move codes go to a device-memory scratch that the wrapper allocates,
//    diagonal-major ((2T-1) x T bytes per pair, byte k*T + i for cell
//    (i, k-i)), so one step's stores of a warp are 32 consecutive bytes.
//  * The path is unique, so one thread traces it back from the corner, as
//    dba_update.cu does, summing the aligned values per centre slot in the
//    plain version's order (descending anti-diagonal).
//  * Tie-break diag, then left, then top; the 3e38 sentinel of the TPU
//    kernels; explicitly rounded local costs, so sums and counts equal the
//    plain version bit for bit.
#include "common.cuh"

namespace {

constexpr double kBig = 3.0e38;
constexpr int kThreads = 512;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dba_update_split_kernel(const T* __restrict__ centers, const T* __restrict__ series,
                            T* __restrict__ sums, T* __restrict__ counts,
                            unsigned char* __restrict__ codes, int t) {
  using N = bet::Num<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* s = reinterpret_cast<T*>(smem);  // the series, t values
  T* c = s + t;                       // the centre, t values
  T* diag = c + t;                    // three diagonals (k mod 3), slot i+1 = row i

  const T big = static_cast<T>(kBig);
  const size_t row0 = static_cast<size_t>(blockIdx.x) * t;
  unsigned char* mv = codes + static_cast<size_t>(blockIdx.x) * (2 * static_cast<size_t>(t) - 1) * t;
  const int tid = threadIdx.x;

  for (int q = tid; q < t; q += kThreads) {
    s[q] = series[row0 + q];
    c[q] = centers[row0 + q];
  }
  for (int q = tid; q < 3 * (t + 1); q += kThreads) diag[q] = big;
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
    unsigned char* mk = mv + static_cast<size_t>(k) * t;
    const int lo = k - t + 1 > 0 ? k - t + 1 : 0;
    const int hi = k < t - 1 ? k : t - 1;
    for (int i = lo + tid; i <= hi; i += kThreads) {
      const T dg = p2[i];      // (i-1, j-1)
      const T lf = p1[i + 1];  // (i,   j-1)
      const T tp = p1[i];      // (i-1, j)
      T best;
      unsigned char code;
      if (dg <= lf && dg <= tp) {
        best = dg;
        code = 0;
      } else if (lf <= tp) {
        best = lf;
        code = 1;
      } else {
        best = tp;
        code = 2;
      }
      const T d = N::sub_rn(c[i], s[k - i]);
      cur[i + 1] = N::add_rn(best, N::mul_rn(d, d));
      mk[i] = code;
    }
    __syncthreads();  // also makes the code stores visible to thread 0
  }

  if (tid == 0) {
    // Traceback from the corner, as in dba_update.cu: rows in descending
    // order, each row's cells in descending column order.
    T* out_s = sums + row0;
    T* out_c = counts + row0;
    int ii = t - 1, jj = t - 1;
    T acc = s[jj];
    T cnt = T(1);
    while (ii > 0 || jj > 0) {
      int code = mv[static_cast<size_t>(ii + jj) * t + ii];
      if (ii == 0) code = 1;       // the first row can only move left
      else if (jj == 0) code = 2;  // the first column can only move up
      const int ni = ii - (code != 1);
      jj -= (code != 2);
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
size_t dba_split_smem_bytes(int t) {
  return sizeof(T) * (2 * static_cast<size_t>(t) + 3 * (static_cast<size_t>(t) + 1));
}

template <typename T>
int launch_dba_update_split(const void* centers, const void* series, void* sums, void* counts,
                            void* codes, int n, int t, void* stream) {
  if (n <= 0 || t <= 0) return cudaSuccess;
  const size_t smem = dba_split_smem_bytes<T>(t);
  cudaError_t err = bet::set_dynamic_smem(dba_update_split_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  dba_update_split_kernel<T><<<n, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(centers), static_cast<const T*>(series), static_cast<T*>(sums),
      static_cast<T*>(counts), static_cast<unsigned char*>(codes), t);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int bet_dba_update_split_f32(const void* centers, const void* series, void* sums, void* counts,
                             void* codes, int n, int t, void* stream) {
  return launch_dba_update_split<float>(centers, series, sums, counts, codes, n, t, stream);
}

int bet_dba_update_split_f64(const void* centers, const void* series, void* sums, void* counts,
                             void* codes, int n, int t, void* stream) {
  return launch_dba_update_split<double>(centers, series, sums, counts, codes, n, t, stream);
}

}  // extern "C"
