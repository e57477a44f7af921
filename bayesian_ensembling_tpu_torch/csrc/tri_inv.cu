// Inverse of a batch of lower-triangular Cholesky factors: W = L^-1.
//
// Replaces the Pallas TPU kernel
//   bayesian_ensembling_tpu/ops/linalg_pallas.py::_tri_inv_kernel_streamed
//   (public entry tri_inv_batched).
//
// What bounds it on an H100: T^3/3 flops per matrix and one read of L's
// lower triangle and one write of W are worth a few microseconds; with one
// block per matrix and B below the 132 SMs (112 on the annual path, 65 at
// the blocked NLML's leaves) the time is the length of the dependent chain.
// A row-at-a-time elimination pays T block-wide barriers; this design pays
// four per doubling level.
//
// Design, in place in one T x T shared-memory matrix (one, not two: T = 165
// in float64 already fills the 227 KB of a block), its rows on 16-byte
// boundaries so that operands are read 16 bytes at a time (warp_tile.cuh):
//  * L's lower triangle is loaded once, with zeros above the diagonal of
//    every diagonal block and in the padding columns.
//  * Every 32 x 32 diagonal block is inverted by one warp, all of them at
//    once: lane c runs the substitution for row c of the inverse with the row
//    in registers and the block's rows read as 16-byte broadcasts.  No lane
//    waits for another.  A ragged last block is padded with the identity in
//    the index arithmetic, not in storage.
//  * The blocks under the diagonal follow by doubling (the recursion of
//    ops/linalg_blocked.py one level down): for pairs of neighbouring
//    inverted blocks of 32, then 64, then 128 rows,
//        W21 = -W22 (L21 W11),
//    two block products per level.  Every 32 x 32 block of every pair of a
//    level goes to a warp of its own (at most 16 at T <= 256), operands in
//    shared memory, an 8 x 4 accumulator tile per lane in registers.  The
//    products skip the 32-blocks of W11 and W22 that lie above the
//    diagonal.  Each product overwrites one of its operands, so it ends with
//    barrier, store, barrier.
//  * W is written with zeros above the diagonal.
#include "warp_tile.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// Each doubling level gives every warp at most one 32 x 32 block.
constexpr int kMaxT = 256;

// One warp: the inverse of the nb x nb lower-triangular block at `d`
// (nb <= 32), in place, zeros above the diagonal.  `ncols` is how many of the
// block's 32 columns the matrix's rows hold (less than 32 only for a ragged
// last block).  Lane c owns row c of the inverse X and solves x_c D = e_c
// from the right: for i = 31 .. 0, x_i = rhs_i / D_ii, then
// rhs_m -= x_i D_im for m < i.  That reads D a row at a time, the same row
// in every lane: 16-byte broadcast loads.  Rows beyond nb are the identity.
template <typename T>
__device__ __forceinline__ void invert_diag_block(T* d, int ld, int nb, int ncols) {
  constexpr int kVec = bet::vec_len<T>();
  const int lane = threadIdx.x & 31;
  const T my_inv = lane < nb ? T(1) / d[lane * ld + lane] : T(1);
  T rhs[bet::kPanel];
#pragma unroll
  for (int m = 0; m < bet::kPanel; ++m) rhs[m] = m == lane ? T(1) : T(0);
#pragma unroll
  for (int i = bet::kPanel - 1; i >= 0; --i) {
    // rhs_i is 0 in every live lane for i >= nb, so those steps change nothing.
    const T x = rhs[i] * __shfl_sync(bet::kFullWarp, my_inv, i);
    rhs[i] = x;
    const T* drow = d + min(i, nb - 1) * ld;
#pragma unroll
    for (int g = 0; kVec * g < i; ++g) {
      if (kVec * g < ncols) {
        T dv[kVec];
        bet::load16(drow + kVec * g, dv);
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          if (kVec * g + e < i) rhs[kVec * g + e] -= x * dv[e];
      }
    }
  }
  __syncwarp();  // every lane has read the block; now overwrite it
  if (lane < nb) {
#pragma unroll
    for (int g = 0; g < bet::kPanel / kVec; ++g)
      if (kVec * g < ncols) bet::store16(d + lane * ld + kVec * g, rhs + kVec * g);
  }
}

// The 32 x 32 block (ib, jb) of the pair that this warp serves at a level.
struct Unit {
  bool active;
  int r0;  // first row (and column) of the pair's upper block
  int r1;  // first row of its lower block
  int h;   // rows of the lower block
  int ib, jb;
};

__device__ __forceinline__ Unit my_unit(int s, int t, int warp) {
  Unit u{false, 0, 0, 0, 0, 0};
  const int cols = s / bet::kPanel;
  int left = warp;
  for (int r0 = 0; r0 + s < t; r0 += 2 * s) {
    const int h = min(s, t - (r0 + s));
    const int n = (h + bet::kPanel - 1) / bet::kPanel * cols;
    if (left < n) {
      u = Unit{true, r0, r0 + s, h, left / cols, left % cols};
      break;
    }
    left -= n;
  }
  return u;
}

// sign * acc into the warp's 32 x 32 block at `dst`; a lane's four columns
// are neighbours.
template <typename T>
__device__ __forceinline__ void store_tile(T* dst, int ld, int rows,
                                           const T (&acc)[bet::kTileRows][bet::kTileCols], T sign) {
  constexpr int kVec = bet::vec_len<T>();
#pragma unroll
  for (int r = 0; r < bet::kTileRows; ++r) {
    const int i = bet::tile_row(r);
    if (i < rows) {
      T out[bet::kTileCols];
#pragma unroll
      for (int c = 0; c < bet::kTileCols; ++c) out[c] = sign * acc[r][c];
#pragma unroll
      for (int c = 0; c < bet::kTileCols; c += kVec)
        bet::store16(dst + i * ld + bet::tile_col<false>(c), out + c);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    tri_inv_kernel(const T* __restrict__ l, T* __restrict__ w_out, int t) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = bet::smem_ld<T>(t);
  T* w = reinterpret_cast<T*>(smem);  // t x ld: L on entry, W on exit

  const int warp = threadIdx.x >> 5;
  const size_t mat0 = static_cast<size_t>(blockIdx.x) * t * t;

  BET_PHASE_CLOCK_RESET();
  BET_PHASE_CLOCK();
  bet::load_lower<kThreads, true>(w, ld, l + mat0, t);
  __syncthreads();
  BET_PHASE_CLOCK();  // the load

  for (int k0 = warp * bet::kPanel; k0 < t; k0 += kWarps * bet::kPanel)
    invert_diag_block(w + k0 * ld + k0, ld, min(bet::kPanel, t - k0), min(bet::kPanel, ld - k0));
  __syncthreads();
  BET_PHASE_CLOCK();  // the diagonal blocks

  for (int s = bet::kPanel; s < t; s *= 2) {
    const Unit u = my_unit(s, t, warp);
    const int i0 = u.r1 + u.ib * bet::kPanel;  // first row of this warp's block
    const int j0 = u.r0 + u.jb * bet::kPanel;  // and its first column
    const int rows = min(bet::kPanel, u.h - u.ib * bet::kPanel);
    T acc[bet::kTileRows][bet::kTileCols];

    // P = L21 W11, over L21.  W11 is lower triangular: k starts at the
    // block's own column.
    bet::warp_tile_zero(acc);
    if (u.active)
      bet::warp_tile_mac<false>(acc, w + i0 * ld + u.r0, rows, w + u.r0 * ld + j0, s, ld,
                                u.jb * bet::kPanel, s);
    __syncthreads();
    if (u.active) store_tile(w + i0 * ld + j0, ld, rows, acc, T(1));
    __syncthreads();
    BET_PHASE_CLOCK();  // P = L21 W11 of this level

    // W21 = -W22 P, over P.  W22 is lower triangular: k ends with the
    // block's own rows.
    bet::warp_tile_zero(acc);
    if (u.active)
      bet::warp_tile_mac<false>(acc, w + i0 * ld + u.r1, rows, w + u.r1 * ld + j0, u.h, ld, 0,
                                min(u.h, (u.ib + 1) * bet::kPanel));
    __syncthreads();
    if (u.active) store_tile(w + i0 * ld + j0, ld, rows, acc, T(-1));
    __syncthreads();
    BET_PHASE_CLOCK();  // W21 = -W22 P of this level
  }

  bet::store_lower<kThreads>(w_out + mat0, w, ld, t);
  BET_PHASE_CLOCK();  // the store, as thread 0 sees it
}

template <typename T>
size_t tri_inv_smem_bytes(int t) {
  return sizeof(T) * static_cast<size_t>(t) * bet::smem_ld<T>(t);
}

template <typename T>
int launch_tri_inv(const void* l, void* w, int b, int t, void* stream) {
  static bet::SmemGrant grant;
  if (b <= 0 || t <= 0) return cudaSuccess;
  if (t > kMaxT) return cudaErrorInvalidValue;
  const size_t smem = tri_inv_smem_bytes<T>(t);
  cudaError_t err = bet::grant_dynamic_smem(tri_inv_kernel<T>, smem, 0, grant);
  if (err != cudaSuccess) return err;
  tri_inv_kernel<T><<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(l), static_cast<T*>(w), t);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int bet_tri_inv_f32(const void* l, void* w, int b, int t, void* stream) {
  return launch_tri_inv<float>(l, w, b, t, stream);
}

int bet_tri_inv_f64(const void* l, void* w, int b, int t, void* stream) {
  return launch_tri_inv<double>(l, w, b, t, stream);
}

}  // extern "C"
