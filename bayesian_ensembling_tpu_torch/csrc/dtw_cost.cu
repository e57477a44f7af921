// Squared-DTW cost of many (centre, series) pairs: the DP with no move
// codes, returning cell (T-1, T-1).
//
// Replaces the Pallas TPU kernel
//   bayesian_ensembling_tpu/ops/dtw_pallas.py::_make_dtw_cost_kernel
//   (public entry squared_dtw_cost_batch).
// It serves the medoid initialisation of the DBA (all R(R-1)/2 pairs of
// every model in one launch, N = 45,472 at T = 165) and the subgradient
// DBA's per-epoch cost (N = 3,248).
//
// What bounds it on an H100: 5 T^2 operations a pair in a chain of
// dependent cells (each pair reads 2T values and writes one).  With
// thousands of pairs the regime is throughput: the instructions a cell and
// the lanes left idle, not the chain of one pair.  A wavefront of one thread
// per row pays a block barrier per anti-diagonal (2T-1 of them) and a
// shared-memory round trip per cell; this design has neither:
//
//  * One warp a pair while a built height gives at most 32 bands (T up to
//    1,024 in float32, 512 in float64): dtw_band.cuh's band wavefront, lane
//    g owning H = ceil(T/32) rows (rounded up to the instantiated heights)
//    in registers, a skewed pipeline of T + 31 steps handing the row above
//    a band on by __shfl_up_sync.  There are no codes and no traceback: the
//    lane that owns row T-1 holds the answer after its last column.
//  * Wider pairs take the largest height (32 in float32, 16 in float64) and
//    ceil(T / 32H) warps handing rows on through dtw_band.cuh's ring in
//    shared memory (T = 1980 in float32: 2 warps of 32 and 30 bands).
//  * Four pairs a block while a pair takes at most two warps, one pair a
//    block otherwise; shared memory holds each pair's series and, between
//    each two of its warps, a ring of 128 values and two counters.  Warps a
//    block are at most 16, which caps T at 16,384 in float32 and 8,192 in
//    float64.
//  * Valid cells take min(best + delta, 3e38), the TPU kernel's saturation;
//    cell (0, 0) is d*d alone.  Every cell equals the plain version bit for
//    bit.  T = 1 is the one cell (0, 0).
//
// ops/dtw_cuda.py picks (H, pairs a block) by _cost_layout and mirrors the
// shared memory; the launcher refuses a height it was not built for.
#include "dtw_band.cuh"

namespace {

constexpr int kMaxThreads = 512;

template <typename T>
__host__ __device__ inline size_t cost_pair_bytes(int t, int warps) {
  const size_t raw = sizeof(T) * static_cast<size_t>(t) + bet::band_ring_bytes<T>(warps);
  return (raw + 15) / 16 * 16;
}

template <typename T, int H>
__global__ void __launch_bounds__(kMaxThreads)
    dtw_cost_kernel(const T* __restrict__ centers, const T* __restrict__ series,
                    T* __restrict__ out, int n, int t, int ppb) {
  extern __shared__ __align__(16) unsigned char smem[];
  BET_PHASE_CLOCK_RESET();
  BET_PHASE_CLOCK();
  const int p = (t + H - 1) / H;
  const int nwp = (p + 31) / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wip = warp % nwp;
  const int slot = warp / nwp;
  const int pair = blockIdx.x * ppb + slot;
  unsigned char* base = smem + slot * cost_pair_bytes<T>(t, nwp);
  T* s = reinterpret_cast<T*>(base);
  const bet::BandRing<T> ring = bet::band_ring<T>(base + sizeof(T) * t, nwp);
  const size_t row0 = static_cast<size_t>(pair) * t;
  if (pair < n) {
    for (int q = wip * 32 + lane; q < t; q += 32 * nwp) s[q] = series[row0 + q];
    for (int q = wip * 32 + lane; q < nwp - 1; q += 32 * nwp) {
      ring.made[q] = 0;
      ring.taken[q] = 0;
    }
  }
  const int g = wip * 32 + lane;
  T cen[H];
  bet::load_band_centre<T, H>(cen, centers + (pair < n ? row0 : 0), g, pair < n ? t : 0);
  __syncthreads();
  BET_PHASE_CLOCK();  // the load
  if (pair >= n) return;

  T cost[H];
#pragma unroll
  for (int r = 0; r < H; ++r) cost[r] = static_cast<T>(bet::kDtwBig);
  if (nwp == 1)
    bet::band_wavefront<T, H, false, true, false>(cost, cen, s, t, p, wip, nwp, lane, ring, nullptr);
  else
    bet::band_wavefront<T, H, false, true, true>(cost, cen, s, t, p, wip, nwp, lane, ring, nullptr);
  BET_PHASE_CLOCK();  // the wavefront, as warp 0 sees it
  if (g == (t - 1) / H) {
    const int r_last = (t - 1) % H;
    T v = cost[0];
#pragma unroll
    for (int r = 1; r < H; ++r)
      if (r == r_last) v = cost[r];
    out[pair] = v;
  }
  __syncwarp();
  BET_PHASE_CLOCK();  // the store, as thread 0 sees it
}

template <typename T, int H>
cudaError_t launch_h(const T* centers, const T* series, T* out, int n, int t, int ppb,
                     size_t smem, cudaStream_t stream) {
  static bet::SmemGrant grant;
  cudaError_t err = bet::grant_dynamic_smem(dtw_cost_kernel<T, H>, smem, 0, grant);
  if (err != cudaSuccess) return err;
  const int warps = ((t + H - 1) / H + 31) / 32;
  const int blocks = (n + ppb - 1) / ppb;
  dtw_cost_kernel<T, H><<<blocks, 32 * warps * ppb, smem, stream>>>(centers, series, out, n, t,
                                                                   ppb);
  return cudaGetLastError();
}

template <typename T>
int launch_dtw_cost(const void* centers_, const void* series_, void* out_, int n, int t, int h,
                    int ppb, void* stream_) {
  if (n <= 0 || t <= 0) return cudaSuccess;
  if (ppb <= 0) return cudaErrorInvalidValue;
  const int warps = ((t + h - 1) / h + 31) / 32;
  if (32 * warps * ppb > kMaxThreads) return cudaErrorInvalidValue;
  const size_t smem = cost_pair_bytes<T>(t, warps) * ppb;
  const T* centers = static_cast<const T*>(centers_);
  const T* series = static_cast<const T*>(series_);
  T* out = static_cast<T*>(out_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  switch (h) {
    case 1: return launch_h<T, 1>(centers, series, out, n, t, ppb, smem, stream);
    case 2: return launch_h<T, 2>(centers, series, out, n, t, ppb, smem, stream);
    case 3: return launch_h<T, 3>(centers, series, out, n, t, ppb, smem, stream);
    case 4: return launch_h<T, 4>(centers, series, out, n, t, ppb, smem, stream);
    case 6: return launch_h<T, 6>(centers, series, out, n, t, ppb, smem, stream);
    case 8: return launch_h<T, 8>(centers, series, out, n, t, ppb, smem, stream);
    case 16: return launch_h<T, 16>(centers, series, out, n, t, ppb, smem, stream);
    case 32:
      // 32 costs and 32 centre values a lane: float32 only (float64 would spill).
      if constexpr (sizeof(T) == 4) {
        return launch_h<T, 32>(centers, series, out, n, t, ppb, smem, stream);
      } else {
        return cudaErrorInvalidValue;
      }
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int bet_dtw_cost_f32(const void* centers, const void* series, void* out, int n, int t, int h,
                     int ppb, void* stream) {
  return launch_dtw_cost<float>(centers, series, out, n, t, h, ppb, stream);
}

int bet_dtw_cost_f64(const void* centers, const void* series, void* out, int n, int t, int h,
                     int ppb, void* stream) {
  return launch_dtw_cost<double>(centers, series, out, n, t, h, ppb, stream);
}

}  // extern "C"
