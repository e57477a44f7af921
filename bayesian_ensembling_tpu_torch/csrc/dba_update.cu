// DBA update: squared-DTW alignment of many (centre, series) pairs, then the
// aligned-value sums and visit counts per centre slot.
//
// Replaces the Pallas TPU kernel
//   bayesian_ensembling_tpu/ops/dtw_pallas.py::_make_dba_update_kernel
//   (public entry dba_update_batch(impl="fused")).
//
// What bounds it on an H100: the DP is 5 T^2 operations a pair in a chain of
// dependent cells, then a walk of up to 2T-1 dependent moves back from the
// corner (each pair reads 2T values and writes 2T).  It runs in two
// regimes: the subgradient DBA launches it 1,189 times a step at N = 112
// pairs, fewer than the SMs, where one pair's chain is the time; the classic
// DBA at N = 3,248, where the instructions a cell are.  A wavefront of one
// thread per row pays a block barrier per anti-diagonal; this design has
// none:
//
//  * dtw_band.cuh's band wavefront with move codes: lane g of a pair owns H
//    rows in registers, the lanes run a skewed pipeline handing the row
//    above a band on by __shfl_up_sync, and a pair of more than 32 bands
//    takes several warps that hand rows on through a ring in shared memory.
//    H is 1, 2, 4, 8 or 16 (it divides 16, so a band column is one field of
//    one 32-bit code word).  A chain of a pair is about (T + bands - 1)
//    steps of H cells, so a small H shortens it and costs lanes.
//  * Move codes in shared memory, 2 bits a cell: band g's codes are one
//    stream of words, the code of row g*H + r at column j in slot H*j + r.
//    T = 165 takes 7.0 KB a pair, so the float32 cap is 944 and at
//    N = 3,248 four pairs share a block.
//  * One block barrier, after the wavefront.  Then one thread a pair walks
//    back from the corner, a move the load of one code word, a shift, a
//    compare, a select and a subtract.  The walk only records, for each
//    row, the first and last column of its cells; then the pair's first
//    warp sums the rows, one a lane, in the plain version's order
//    (descending column), so sums and counts equal it bit for bit and no
//    add or load of the series waits in the walk's chain.  A move out of
//    the matrix (only after a NaN or past the float range) ends the path,
//    as in the plain version's sweep; rows it never reached sum to 0.
//
// ops/dtw_cuda.py picks (H, pairs a block) from T and N by _fused_layout
// (the rule is written there) and mirrors the shared memory; the launcher
// refuses a layout it was not built for or that does not fit.
#include "dtw_band.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr unsigned kUnreached = 0xffffffffu;  // the record of a row the path never reached

// Words of one band's code stream: T*H slots of 2 bits, rounded up to an even
// count so that the lanes storing at one step hit distinct banks.
__host__ __device__ inline int stream_words(int t, int h) {
  const int w = (t * h + 15) / 16;
  return (w + 1) / 2 * 2;
}

// Shared memory of one pair, a multiple of 16 bytes: the code streams, the
// series, the rings between its warps and the path's row records.
template <typename T>
__host__ __device__ inline size_t dba_pair_bytes(int t, int h) {
  const int bands = (t + h - 1) / h;
  const int warps = (bands + 31) / 32;
  const size_t raw = sizeof(unsigned) * (static_cast<size_t>(bands) * stream_words(t, h) + t) +
                     sizeof(T) * static_cast<size_t>(t) + bet::band_ring_bytes<T>(warps);
  return (raw + 15) / 16 * 16;
}

template <typename T, int H>
__global__ void __launch_bounds__(kMaxThreads)
    dba_update_kernel(const T* __restrict__ centers, const T* __restrict__ series,
                      T* __restrict__ sums, T* __restrict__ counts, int n, int t, int ppb) {
  using N = bet::Num<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  BET_PHASE_CLOCK_RESET();
  BET_PHASE_CLOCK();
  const int p = (t + H - 1) / H;
  const int nwp = (p + 31) / 32;
  const int words = stream_words(t, H);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wip = warp % nwp;
  const int slot = warp / nwp;
  const int pair = blockIdx.x * ppb + slot;
  const bool active = pair < n;
  unsigned char* base = smem + slot * dba_pair_bytes<T>(t, H);
  unsigned* codes = reinterpret_cast<unsigned*>(base);
  T* s = reinterpret_cast<T*>(codes + static_cast<size_t>(p) * words);
  const bet::BandRing<T> ring = bet::band_ring<T>(reinterpret_cast<unsigned char*>(s + t), nwp);
  const size_t row0 = static_cast<size_t>(active ? pair : 0) * t;
  if (active) {
    for (int q = wip * 32 + lane; q < t; q += 32 * nwp) s[q] = series[row0 + q];
    for (int q = wip * 32 + lane; q < nwp - 1; q += 32 * nwp) {
      ring.made[q] = 0;
      ring.taken[q] = 0;
    }
  }
  const int g = wip * 32 + lane;
  T cen[H];
  bet::load_band_centre<T, H>(cen, centers + row0, g, active ? t : 0);
  __syncthreads();
  BET_PHASE_CLOCK();  // the load

  unsigned* rows = reinterpret_cast<unsigned*>(reinterpret_cast<unsigned char*>(s + t) +
                                               bet::band_ring_bytes<T>(nwp));
  if (active) {
    T cost[H];
#pragma unroll
    for (int r = 0; r < H; ++r) cost[r] = static_cast<T>(bet::kDtwBig);
    // A lane past the last band stores its junk codes in the row records,
    // which the walk writes only after the barrier below.
    unsigned* stream = g < p ? codes + static_cast<size_t>(g) * words : rows;
    if (nwp == 1)
      bet::band_wavefront<T, H, true, false, false>(cost, cen, s, t, p, wip, nwp, lane, ring, stream);
    else
      bet::band_wavefront<T, H, true, false, true>(cost, cen, s, t, p, wip, nwp, lane, ring, stream);
  }
  __syncthreads();  // every band's codes are in shared memory
  BET_PHASE_CLOCK();  // the wavefront

  if (active && wip == 0) {
    if (lane == 0) {
      // Walk back from the corner over the pair's streams as one array:
      // cell (g*H + r, j) is slot gs = g*W + H*j + r, W = 16 * words the
      // slots of a band, and cell (0, 0) is slot 0.  A move lowers gs by H
      // for left, by 1 for up within a band and by W - H + 1 for up into the
      // band above; the last is known from gs before the code is, so the
      // chain of a move is the load of its word, a shift, a compare, a
      // select and a subtract.  (Loading the words of the three cells a
      // move may reach before its code is read made a move slower on the
      // H100, 116 cycles against 96.)  Each row the path leaves gets its record,
      // (first column << 16) | last column: the walk enters a row at its
      // largest column and leaves it at its smallest.
      const int w = 16 * words;
      int ii = t - 1, jj = t - 1, enter = t - 1;
      int gs = (ii / H) * w + H * jj + ii % H;
      unsigned word = codes[gs >> 4];
      while (gs != 0) {
        const int up_slots = (gs & (H - 1)) != 0 ? 1 : w - H + 1;
        const int code = __funnelshift_r(word, word, 2 * gs) & 3;
        const bool up = code != 1;
        const bool left = code != 2;
        // A move out of the matrix (only after a NaN or past the float
        // range) ends the path there, as the plain version's sweep does.
        if ((up && ii == 0) || (left && jj == 0)) break;
        gs -= (left ? H : 0) + (up ? up_slots : 0);
        word = codes[gs >> 4];
        if (up) {
          rows[ii] = static_cast<unsigned>(enter) << 16 | static_cast<unsigned>(jj);
          enter = jj - left;
        }
        ii -= up;
        jj -= left;
      }
      rows[ii] = static_cast<unsigned>(enter) << 16 | static_cast<unsigned>(jj);
      for (int i = 0; i < ii; ++i) rows[i] = kUnreached;
    }
    __syncwarp();
    BET_PHASE_CLOCK();  // the walk
    // Each row's sum in the plain version's order, descending columns, one
    // row a lane at a time; a row the path never reached sums to 0.
    T* out_s = sums + row0;
    T* out_c = counts + row0;
    for (int i = lane; i < t; i += 32) {
      const unsigned rec = rows[i];
      T acc = T(0), cnt = T(0);
      if (rec != kUnreached) {
        const int hi = static_cast<int>(rec >> 16), lo = static_cast<int>(rec & 0xffffu);
        acc = s[hi];
        for (int jc = hi - 1; jc >= lo; --jc) acc = N::add_rn(acc, s[jc]);
        cnt = static_cast<T>(hi - lo + 1);
      }
      out_s[i] = acc;
      out_c[i] = cnt;
    }
  }
  BET_PHASE_CLOCK();  // the sums and their stores, as thread 0 sees them
}

template <typename T, int H>
cudaError_t launch_h(const T* centers, const T* series, T* sums, T* counts, int n, int t, int ppb,
                     cudaStream_t stream) {
  static bet::SmemGrant grant;
  const size_t smem = dba_pair_bytes<T>(t, H) * ppb;
  cudaError_t err = bet::grant_dynamic_smem(dba_update_kernel<T, H>, smem, 0, grant);
  if (err != cudaSuccess) return err;
  const int warps = ((t + H - 1) / H + 31) / 32;
  const int blocks = (n + ppb - 1) / ppb;
  dba_update_kernel<T, H><<<blocks, 32 * warps * ppb, smem, stream>>>(centers, series, sums,
                                                                     counts, n, t, ppb);
  return cudaGetLastError();
}

template <typename T>
int launch_dba_update(const void* centers_, const void* series_, void* sums_, void* counts_, int n,
                      int t, int h, int ppb, void* stream_) {
  if (n <= 0 || t <= 0) return cudaSuccess;
  if (h <= 0 || ppb <= 0) return cudaErrorInvalidValue;
  const int warps = ((t + h - 1) / h + 31) / 32;
  if (32 * warps * ppb > kMaxThreads) return cudaErrorInvalidValue;
  const T* centers = static_cast<const T*>(centers_);
  const T* series = static_cast<const T*>(series_);
  T* sums = static_cast<T*>(sums_);
  T* counts = static_cast<T*>(counts_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  switch (h) {
    case 1: return launch_h<T, 1>(centers, series, sums, counts, n, t, ppb, stream);
    case 2: return launch_h<T, 2>(centers, series, sums, counts, n, t, ppb, stream);
    case 4: return launch_h<T, 4>(centers, series, sums, counts, n, t, ppb, stream);
    case 8: return launch_h<T, 8>(centers, series, sums, counts, n, t, ppb, stream);
    case 16: return launch_h<T, 16>(centers, series, sums, counts, n, t, ppb, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int bet_dba_update_f32(const void* centers, const void* series, void* sums, void* counts, int n,
                       int t, int h, int ppb, void* stream) {
  return launch_dba_update<float>(centers, series, sums, counts, n, t, h, ppb, stream);
}

int bet_dba_update_f64(const void* centers, const void* series, void* sums, void* counts, int n,
                       int t, int h, int ppb, void* stream) {
  return launch_dba_update<double>(centers, series, sums, counts, n, t, h, ppb, stream);
}

const char* bet_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
