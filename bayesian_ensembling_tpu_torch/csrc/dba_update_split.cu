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
// What bounds it on an H100: 5 T^2 operations per pair (T=1980: 19.6M) in a
// chain of dependent cells, and T^2 2-bit move codes (0.98 MB at T=1980)
// written once and read back along the path.  A wavefront of one thread per
// row pays a block-wide barrier per anti-diagonal (2T-1 of them), so the
// design keeps the chain inside registers and shuffles:
//
//  * Bands.  Lane g of a pair owns the 64 rows g*64 .. g*64+63 (T=1980: 31
//    lanes, one warp; T=1032: 17) and keeps that band's column of costs in
//    registers.  The lanes run a skewed pipeline: at step st lane g does
//    column st - g, top to bottom, and takes the cost of the row above its
//    band from lane g-1 by __shfl_up_sync (lane g-1 did that column the step
//    before).  A step is 64 cells of one lane's chain and one shuffle; there
//    is no barrier.  The height 64 is what a 16-byte word of 2-bit codes
//    holds, and it amortises the shuffle over 64 cells while a pair of T=1980
//    still fits one warp.  What is left bounds it: about 12 instructions a
//    cell, issued by one warp a pair (6 warps an SM at 812 pairs) at about
//    one every 3 cycles (a pair alone: some 38 cycles a cell).
//  * A pair wider than 32 bands (T > 2048) takes several warps.  The last
//    lane of warp w hands its bottom row to lane 0 of warp w+1 through a ring
//    of 128 values in shared memory, with a counter of the columns published
//    and one of the columns taken (spin-waits on shared memory, no barrier).
//  * Move codes in 2 bits, valid cells only: the codes of one band's column
//    are one 16-byte word, word (g, j) at g*T + j of the pair's
//    ceil(T/64) * T words, so a lane stores 16 bytes a step (two columns'
//    words back to back, one 32-byte sector) and the traceback finds a
//    cell's upper neighbour in the same word and its left neighbours in the
//    next word down.
//  * Traceback by the first warp from the corner, as dba_update.cu's (a
//    move out of the matrix ends the path, rows it never reached sum to 0): the
//    warp stages 32 consecutive words of the current band (512 bytes,
//    coalesced) in shared memory and every lane walks the path on them, so
//    device memory is waited on once per 32 columns or band change (about
//    T/32 + T/64 times), not once per cell.  Sums follow the plain version's
//    order (descending anti-diagonal).
//  * Shared memory holds the series, the centre in band-major 16-byte
//    groups (a warp reads one group of rows of all its bands as consecutive
//    16-byte words, one load for 4 cells in f32) and the rings:
//    (T + 64 ceil(T/64)) values a pair, which caps T at 28,134 in f32 and
//    14,080 in f64; the launcher refuses more.
//  * Tie-break diag, then left, then top; the 3e38 sentinel of the TPU
//    kernels; explicitly rounded local costs, so sums and counts equal the
//    plain version bit for bit.
#include "warp_tile.cuh"  // vec_len, load16

namespace {

constexpr double kBig = 3.0e38;
constexpr int kBand = 64;   // rows per lane: the codes of one band column fill 16 bytes
constexpr int kRing = 128;  // columns in flight between two warps of a pair
constexpr int kTileBytes = 32 * 16;
constexpr unsigned kFull = 0xffffffffu;

// Warps per block at most: the register file bounds them (64 costs a lane,
// 128 registers in float64).
template <typename T>
struct SplitWarps;
template <>
struct SplitWarps<float> {
  static constexpr int kMax = 16;
};
template <>
struct SplitWarps<double> {
  static constexpr int kMax = 8;
};

inline int split_bands(int t) { return (t + kBand - 1) / kBand; }
inline int split_warps(int t) { return (split_bands(t) + 31) / 32; }

// Shared memory of one pair (a block), a multiple of 16 bytes: the
// traceback's staged words, the centre, the series, and the rings and
// counters between warps.
template <typename T>
size_t dba_split_smem_bytes(int t) {
  const size_t w = split_warps(t);
  const size_t bytes = kTileBytes + sizeof(T) * (static_cast<size_t>(kBand) * split_bands(t) + t +
                                                 kRing * (w - 1)) + 2 * sizeof(int) * (w - 1);
  return (bytes + 15) / 16 * 16;
}

template <typename T>
__global__ void __launch_bounds__(32 * SplitWarps<T>::kMax)
    dba_update_split_kernel(const T* __restrict__ centers, const T* __restrict__ series,
                            T* __restrict__ sums, T* __restrict__ counts,
                            uint4* __restrict__ codes, int t) {
  using N = bet::Num<T>;
  constexpr int kVec = bet::vec_len<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int p = (t + kBand - 1) / kBand;  // bands = lanes at work
  const int nw = blockDim.x >> 5;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = tid;  // this lane's band

  uint4* tile = reinterpret_cast<uint4*>(smem);           // the traceback's 32 words
  // The centre, band-major in 16-byte groups: rows g*64 + r .. + kVec - 1
  // at (r / kVec) * p * kVec + g * kVec, so that a warp's loads of one group
  // of rows are consecutive 16-byte words.
  T* cb = reinterpret_cast<T*>(smem + kTileBytes);
  T* s = cb + kBand * p;                                  // the series
  volatile T* ring = s + t;                               // ring w-1: the row above warp w's bands
  volatile int* made = reinterpret_cast<volatile int*>(s + t + kRing * (nw - 1));
  volatile int* taken = made + (nw - 1);

  const T big = static_cast<T>(kBig);
  const size_t row0 = static_cast<size_t>(blockIdx.x) * t;
  uint4* mv = codes + static_cast<size_t>(blockIdx.x) * p * t;

  for (int q = tid; q < t; q += blockDim.x) s[q] = series[row0 + q];
  for (int q = tid; q < kBand * p; q += blockDim.x) {
    const int grp = q / (p * kVec), rest = q % (p * kVec);
    const int i = (rest / kVec) * kBand + grp * kVec + rest % kVec;
    cb[q] = i < t ? centers[row0 + i] : T(0);  // rows past T compute junk that nothing reads
  }
  for (int q = tid; q < nw - 1; q += blockDim.x) {
    made[q] = 0;
    taken[q] = 0;
  }
  __syncthreads();

  T cost[kBand];  // the band's costs at the column last done
#pragma unroll
  for (int r = 0; r < kBand; ++r) cost[r] = big;
  T bottom = big;   // cost[kBand - 1], handed to the next lane
  T up_prev = big;  // the row above the band at the previous column
  uint4 pending = make_uint4(0, 0, 0, 0);
  for (int st = 0; st < t + 31; ++st) {
    const int j = st - lane;
    T up = __shfl_up_sync(kFull, bottom, 1);
    if (lane == 0) {
      if (warp == 0) {
        up = big;
      } else if (j < t) {
        while (made[warp - 1] <= j) {
        }
        __threadfence_block();
        up = ring[(warp - 1) * kRing + j % kRing];
        __threadfence_block();
        taken[warp - 1] = j + 1;
      }
    }
    const bool live = j >= 0 && j < t && g < p;
    if (live) {
      const T sj = s[j];
      T dg = up_prev;  // (i-1, j-1)
      T tp = up;       // (i-1, j)
      unsigned bits[4] = {0u, 0u, 0u, 0u};
      T cv[kVec];
#pragma unroll
      for (int r = 0; r < kBand; ++r) {
        if (r % kVec == 0) bet::load16(cb + (r / kVec) * p * kVec + g * kVec, cv);
        // The tie-break diag > left > top as two steps, so that only the
        // second waits on the cell above (tp): the first picks between the
        // previous column's two cells, the second keeps that one unless top
        // is strictly less.  NaN compares false either way, as in one step.
        const T lf = cost[r];  // (i, j-1)
        const bool diag_first = dg <= lf;
        const T near = diag_first ? dg : lf;
        const bool keep = near <= tp;
        const T best = keep ? near : tp;
        const T d = N::sub_rn(cv[r % kVec], sj);
        T v = N::add_rn(best, N::mul_rn(d, d));
        if (r == 0 && g == 0 && j == 0) v = N::mul_rn(d, d);  // cell (0, 0)
        bits[r >> 4] += (keep ? (diag_first ? 0u : 1u) : 2u) << (2 * (r & 15));
        cost[r] = v;
        dg = lf;
        tp = v;
      }
      bottom = cost[kBand - 1];
      const uint4 word = make_uint4(bits[0], bits[1], bits[2], bits[3]);
      uint4* dst = mv + static_cast<size_t>(g) * t + j;
      if (j & 1) {
        dst[-1] = pending;
        dst[0] = word;
      } else if (j == t - 1) {
        dst[0] = word;
      } else {
        pending = word;
      }
      if (lane == 31 && warp + 1 < nw) {
        while (taken[warp] <= j - kRing) {
        }
        ring[warp * kRing + j % kRing] = bottom;
        __threadfence_block();
        made[warp] = j + 1;
      }
    }
    up_prev = up;
  }
  __syncthreads();  // every warp's codes are in device memory

  if (warp == 0) {
    // Traceback from the corner, as in dba_update.cu: rows in descending
    // order, each row's cells in descending column order.  Every lane walks
    // the same path; lane 0 writes.
    T* out_s = sums + row0;
    T* out_c = counts + row0;
    int ii = t - 1, jj = t - 1;
    int tile_band = -1, tile_lo = 0;
    T acc = s[jj];
    T cnt = T(1);
    while (ii > 0 || jj > 0) {
      if (ii / kBand != tile_band || jj < tile_lo) {
        tile_band = ii / kBand;
        tile_lo = max(0, jj - 31);
        __syncwarp();
        if (tile_lo + lane <= jj) tile[lane] = mv[static_cast<size_t>(tile_band) * t + tile_lo + lane];
        __syncwarp();
      }
      const uint4 word = tile[jj - tile_lo];
      const int r = ii % kBand;
      const unsigned part = r < 16 ? word.x : r < 32 ? word.y : r < 48 ? word.z : word.w;
      const int code = (part >> (2 * (r & 15))) & 3;
      // A move out of the matrix (only after a NaN or past the float
      // range) ends the path there, as the plain version's sweep does.
      if ((code != 1 && ii == 0) || (code != 2 && jj == 0)) break;
      const int ni = ii - (code != 1);
      jj -= (code != 2);
      if (ni != ii) {
        if (lane == 0) {
          out_s[ii] = acc;
          out_c[ii] = cnt;
        }
        acc = T(0);
        cnt = T(0);
        ii = ni;
      }
      acc = N::add_rn(acc, s[jj]);
      cnt += T(1);
    }
    if (lane == 0) {
      out_s[ii] = acc;
      out_c[ii] = cnt;
    }
    for (int i = lane; i < ii; i += 32) {  // rows the path never reached
      out_s[i] = T(0);
      out_c[i] = T(0);
    }
  }
}

template <typename T>
int launch_dba_update_split(const void* centers, const void* series, void* sums, void* counts,
                            void* codes, int n, int t, void* stream) {
  static bet::SmemGrant grant;
  if (n <= 0 || t <= 0) return cudaSuccess;
  const int warps = split_warps(t);
  if (warps > SplitWarps<T>::kMax) return cudaErrorInvalidValue;
  const size_t smem = dba_split_smem_bytes<T>(t);
  cudaError_t err = bet::grant_dynamic_smem(dba_update_split_kernel<T>, smem, 0, grant);
  if (err != cudaSuccess) return err;
  dba_update_split_kernel<T><<<n, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(centers), static_cast<const T*>(series), static_cast<T*>(sums),
      static_cast<T*>(counts), static_cast<uint4*>(codes), t);
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
