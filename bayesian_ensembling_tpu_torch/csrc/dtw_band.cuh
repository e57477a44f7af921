// The band wavefront of the squared-DTW DP, shared by the DBA update
// (dba_update.cu, with move codes) and the squared-DTW cost (dtw_cost.cu,
// without): one pair's cost matrix swept by one or more warps with no block
// barrier.
//
// Lane g of a pair (warp wip, lane l: g = 32 wip + l) owns the band of H
// rows g*H .. g*H+H-1 and keeps their costs, and their centre values, in
// registers.  The lanes run a skewed pipeline: at step st, lane l does
// column st - l of its band, top to bottom, and takes the cost of the row
// above its band from lane l-1 by __shfl_up_sync (lane l-1 did that column
// the step before).  A step is H cells of one lane's chain and one shuffle.
// A pair wider than 32 bands takes several warps: the last lane of warp w
// hands its bottom row to lane 0 of warp w+1 through a ring of kDtwRing
// values in shared memory, with a counter of the columns published and one
// of the columns taken (spin-waits on shared memory, no barrier), as
// dba_update_split.cu does, but with release stores and acquire loads once
// per kDtwBatch columns instead of two block fences a column.
//
// Each cell is the plain version's: the tie-break diag, then left, then top,
// in two steps so that only the second waits on the cell above (the first
// picks between the previous column's two cells; NaN compares false either
// way, so the answer is that of one step for every input), then explicitly
// rounded subtract, multiply and add (nvcc would otherwise fuse best + d*d
// into an FMA).  Cell (0, 0) is d*d alone.  Invalid neighbours
// hold the 3e38 sentinel of the TPU kernels; kClamp saturates every other
// valid cell at 3e38 as the TPU cost kernel's jnp.minimum does (a NaN passes).
//
// Move codes (kCodes), 2 bits a cell, 0 diag / 1 left / 2 top: band g's
// codes are one stream of 32-bit words in shared memory, the code of row
// g*H + r at column j in slot H*j + r (word (H*j + r) / 16, bits
// 2 ((H*j + r) % 16)).  H divides 16, so one band column is one 2H-bit field
// of one word, a lane stores a whole word every 16 / H columns, and the
// stream takes T*H/4 bytes: the pair's codes take about T^2/4 bytes.
#pragma once

#include "common.cuh"

namespace bet {

constexpr double kDtwBig = 3.0e38;
constexpr int kDtwRing = 128;  // columns in flight between two warps of a pair
constexpr unsigned kDtwFull = 0xffffffffu;

// The hand-over between the warps of one pair, in shared memory: ring w holds
// the bottom row of warp w's last band, column j at j % kDtwRing; `made`
// counts the columns warp w has published, `taken` those warp w + 1 has
// read.  Both counters move in batches of kDtwBatch columns with release
// stores and are read with acquire loads, so a fence is paid once a batch,
// not once a column.
template <typename T>
struct BandRing {
  T* vals;     // (warps - 1) x kDtwRing
  int* made;   // warps - 1
  int* taken;  // warps - 1
};

constexpr int kDtwBatch = 32;

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.cta.b32 [%0], %1;" : : "l"(p), "r"(v) : "memory");
}

// Saturation at the sentinel, NaN passing: one NaN-propagating min in
// float32 (a NaN comes out as the canonical NaN), a compare and select in
// float64.
__device__ __forceinline__ float saturate_big(float v) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(v), "f"(static_cast<float>(kDtwBig)));
  return r;
}
__device__ __forceinline__ double saturate_big(double v) {
  return v > kDtwBig ? kDtwBig : v;
}

// One step st of the skewed pipeline for one lane: column st - lane of its
// band.  kChecked: some lane of the warp may be outside the matrix.
template <bool kChecked, typename T, int H, bool kCodes, bool kClamp, bool kMulti>
__device__ __forceinline__ void band_step(T (&cost)[H], const T (&cen)[H], T& bottom, T& up_prev,
                                          T& s_next, unsigned& pending, int& seen, const T* s,
                                          int t, int st, int g, bool in_band, int wip,
                                          bool receives, bool hands_on, int lane,
                                          const BandRing<T>& ring, unsigned* stream) {
  using N = Num<T>;
  const T big = static_cast<T>(kDtwBig);
  const int j = st - lane;
  const T sj = s_next;
  s_next = s[max(0, min(j + 1, t - 1))];
  T up = __shfl_up_sync(kDtwFull, bottom, 1);
  if (lane == 0) up = big;
  if constexpr (kMulti) {
    if (receives && lane == 0 && j < t) {
      while (seen <= j) seen = load_acquire(ring.made + wip - 1);
      up = ring.vals[(wip - 1) * kDtwRing + j % kDtwRing];
      if ((j + 1) % kDtwBatch == 0 || j == t - 1) store_release(ring.taken + wip - 1, j + 1);
    }
  }
  bool live = true;
  if constexpr (kChecked) live = j >= 0 && j < t && in_band;
  if (live) {
    const bool first = g == 0 && j == 0;
    T dg = up_prev;  // (i-1, j-1)
    T tp = up;       // (i-1, j)
    unsigned col = 0u;
#pragma unroll
    for (int r = 0; r < H; ++r) {
      const T lf = cost[r];  // (i, j-1)
      const bool diag_first = dg <= lf;
      const T near = diag_first ? dg : lf;
      const bool keep = near <= tp;
      const T best = keep ? near : tp;
      const T d = N::sub_rn(cen[r], sj);
      const T dd = N::mul_rn(d, d);
      T v = N::add_rn(best, dd);
      if constexpr (kClamp) v = saturate_big(v);
      if (r == 0 && first) v = dd;  // cell (0, 0)
      if constexpr (kCodes) col |= (keep ? (diag_first ? 0u : 1u) : 2u) << (2 * r);
      cost[r] = v;
      dg = lf;
      tp = v;
    }
    bottom = cost[H - 1];
    if constexpr (kCodes) {
      const int slot = (j * H) & 15;
      pending |= col << (2 * slot);
      stream[max(j, 0) * H >> 4] = pending;
      pending = slot + H == 16 ? 0u : pending;
    }
    if constexpr (kMulti) {
      if (hands_on && lane == 31) {
        while (seen <= j - kDtwRing) seen = load_acquire(ring.taken + wip);
        ring.vals[wip * kDtwRing + j % kDtwRing] = bottom;
        if ((j + 1) % kDtwBatch == 0 || j == t - 1) store_release(ring.made + wip, j + 1);
      }
    }
  }
  up_prev = up;
}

// Run the wavefront of one pair for the calling warp (warp `wip` of the
// pair's `nwp`, lane `lane`).  `cost` enters as the sentinel and leaves
// holding the band's costs at column t-1; `cen` holds the band's centre
// values (0 past row t-1: those rows compute junk that nothing reads); `s`
// is the series in shared memory.  With kCodes, `stream` is this lane's code
// stream (for a lane past the last band, any scratch of T words: it stores
// junk there).  kMulti: the pair has several warps (nwp > 1).  Every lane of
// the warp calls it (the shuffles need them all).
//
// The steps where every lane of the warp is inside the matrix (all but the
// pipeline's fill and drain) run with no branch that could split the warp:
// a lane past the last band computes junk, and a lane stores its current
// code word at every step, the partial word included, so no store waits on
// a condition.  The series value of the next step is loaded a step ahead.
template <typename T, int H, bool kCodes, bool kClamp, bool kMulti>
__device__ __forceinline__ void band_wavefront(T (&cost)[H], const T (&cen)[H], const T* s, int t,
                                               int p, int wip, int nwp, int lane,
                                               const BandRing<T>& ring, unsigned* stream) {
  static_assert(!kCodes || 16 % H == 0, "a band column must be one field of one code word");
  const T big = static_cast<T>(kDtwBig);
  const int g = wip * 32 + lane;
  const int lanes = min(32, p - wip * 32);  // uniform over the warp
  const bool in_band = g < p;
  const bool receives = wip > 0, hands_on = wip + 1 < nwp;  // uniform over the warp
  T bottom = big, up_prev = big;
  T s_next = s[max(0, min(-lane, t - 1))];
  unsigned pending = 0u;
  int seen = 0;
  // Fill (lane l waits l steps), the steps with every lane inside, drain.
  const int all_in = min(lanes - 1, t), drain = max(all_in, t);
  int st = 0;
  for (; st < all_in; ++st)
    band_step<true, T, H, kCodes, kClamp, kMulti>(cost, cen, bottom, up_prev, s_next, pending, seen,
                                                  s, t, st, g, in_band, wip, receives, hands_on,
                                                  lane, ring, stream);
  for (; st < drain; ++st)
    band_step<false, T, H, kCodes, kClamp, kMulti>(cost, cen, bottom, up_prev, s_next, pending,
                                                   seen, s, t, st, g, in_band, wip, receives,
                                                   hands_on, lane, ring, stream);
  for (; st < t + lanes - 1; ++st)
    band_step<true, T, H, kCodes, kClamp, kMulti>(cost, cen, bottom, up_prev, s_next, pending, seen,
                                                  s, t, st, g, in_band, wip, receives, hands_on,
                                                  lane, ring, stream);
}

// The band's centre values, 0 past row t-1.
template <typename T, int H>
__device__ __forceinline__ void load_band_centre(T (&cen)[H], const T* __restrict__ centre, int g,
                                                 int t) {
#pragma unroll
  for (int r = 0; r < H; ++r) {
    const int i = g * H + r;
    cen[r] = i < t ? centre[i] : T(0);
  }
}

// Shared memory of the ring between the warps of one pair: values, then the
// two counters.
template <typename T>
__host__ __device__ inline size_t band_ring_bytes(int warps) {
  return (warps - 1) * (sizeof(T) * kDtwRing + 2 * sizeof(int));
}

template <typename T>
__device__ __forceinline__ BandRing<T> band_ring(unsigned char* base, int warps) {
  T* vals = reinterpret_cast<T*>(base);
  int* made = reinterpret_cast<int*>(vals + (warps - 1) * kDtwRing);
  return BandRing<T>{vals, made, made + (warps - 1)};
}

}  // namespace bet
