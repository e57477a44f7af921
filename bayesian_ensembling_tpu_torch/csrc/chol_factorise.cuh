// Right-looking panel-blocked Cholesky body shared by the Cholesky kernel
// (chol.cu) and the fused Cholesky-solve (chol_solve.cu), the counterpart of
// the TPU kernels' shared body linalg_pallas.py::_chol_factorise.
//
// What bounds it on an H100: with one block per matrix and fewer matrices
// than SMs, the time is the length of the dependent chain, not the T^3/3
// flops.  A column-at-a-time loop pays a block-wide barrier or two per
// column (T = 165: 330 barriers of about 1 us each).  Here the chain is cut
// into panels of 32 columns:
//  1. one warp factorises the 32 x 32 diagonal block with its rows in
//     registers (lane i owns row i; each step's column crosses the warp
//     through 32 values of shared memory, with no block-wide barrier inside
//     the 32 steps and one reciprocal, not a square root and a division, on
//     the chain from pivot to pivot), and leaves L11^T in the block's upper
//     triangle, which nothing else uses;
//  2. the rows under the block are independent: two threads per row run the
//     32-step substitution L21 = A21 L11^-T with the row in their registers
//     and the rows of L11^T read by 16-byte broadcast loads;
//  3. the trailing update A22 -= L21 L21^T is a rank-32 update in 32 x 32
//     blocks of the lower triangle, one warp per block with 8 x 4 register
//     tiles (warp_tile.cuh).
// That is three block-wide barriers per panel: 18 at T = 165.
#pragma once

#include "warp_tile.cuh"

namespace bet {

// Static shared memory of chol_factorise: the reciprocals of one panel's
// diagonal and the diagonal block's two-row ring.  The launchers add it to
// what they ask for.
template <typename T>
__host__ __device__ constexpr size_t chol_factorise_static_bytes() {
  return sizeof(T) * 3 * kPanel;
}

// One warp: the Cholesky factor of the nb x nb block at `d` (nb <= 32), in
// place, with L in the lower triangle and L^T above the diagonal.  `ncols`
// is how many of the block's 32 columns the matrix's rows hold (a multiple
// of 16 bytes; less than 32 only under a ragged last panel).  Lane i holds
// row i in registers; rows and columns beyond nb are the identity, so every
// panel runs the same 32 steps of straight-line code.
//
// One warp alone runs its instructions in order, so every instruction between
// one pivot and the next costs its full latency.  The chain is kept to a
// reciprocal, a multiply, a multiply-add and a shuffle.  Step k updates the
// columns to its right with the still unscaled column, u_i u_j / pivot, so
// no square root is on the chain: the columns are scaled by 1 / sqrt(pivot) after the last
// step.  It updates column k + 1 first and sends that column on its way (its
// pivot by a shuffle, its entries u_j through `ring`, two rows of 32 values
// in shared memory that are read back by 16-byte broadcast loads) before it
// turns to the other columns, whose multiply-adds fill the shuffle's
// latency.  With two rows in turn, one __syncwarp a step is enough.  A
// non-positive or NaN pivot becomes NaN and spreads to every later column of
// the block.  On return inv_diag[k] = 1 / L_kk.
template <typename T>
__device__ __forceinline__ void chol_diag_block(T* d, int ld, int nb, int ncols, T* inv_diag,
                                                T* ring) {
  constexpr int kVec = vec_len<T>();
  const int lane = threadIdx.x & 31;
  const bool live = lane < nb;
  T* mine = d + min(lane, nb - 1) * ld;
  T row[kPanel];
#pragma unroll
  for (int c = 0; c < kPanel; ++c) row[c] = T(0);
#pragma unroll
  for (int g = 0; g < kPanel / kVec; ++g)
    if (kVec * g < ncols) load16(mine + kVec * g, row + kVec * g);
#pragma unroll
  for (int c = 0; c < kPanel; ++c)
    if (!(live && c <= lane)) row[c] = c == lane ? T(1) : T(0);
  T my_pivot = T(1);
  T u = row[0];  // this lane's entry of the current column
  T pivot = __shfl_sync(kFullWarp, u, 0);
  ring[lane] = u;
#pragma unroll
  for (int k = 0; k < kPanel; ++k) {
    __syncwarp();  // column k has arrived in its row of the ring
    T col[kPanel];
    load_row(ring + (k & 1) * kPanel, col, k + 1, kPanel);
    const T scaled = u * (pivot > T(0) ? Num<T>::rcp(pivot) : Num<T>::nan());
    if (lane == k) my_pivot = pivot;
    if (k + 1 < kPanel) {
      row[k + 1] -= scaled * col[k + 1];
      u = row[k + 1];
      ring[((k + 1) & 1) * kPanel + lane] = u;
      pivot = __shfl_sync(kFullWarp, u, k + 1);
    }
    // Lanes <= k update entries above the diagonal, which are never stored.
#pragma unroll
    for (int j = k + 2; j < kPanel; ++j) row[j] -= scaled * col[j];
  }
  inv_diag[lane] = my_pivot > T(0) ? Num<T>::rsqrt(my_pivot) : Num<T>::nan();
  __syncwarp();
  T inv[kPanel];
  load_row(inv_diag, inv, 0, kPanel);
#pragma unroll
  for (int c = 0; c < kPanel; ++c) row[c] *= inv[c];
  // Row i of L, 16 bytes at a time: the last group also writes what the lane
  // holds above the diagonal, which L^T then overwrites (or, beyond a ragged
  // panel's width, padding that nothing reads).
  if (live) {
#pragma unroll
    for (int g = 0; g < kPanel / kVec; ++g)
      if (kVec * g <= lane && kVec * g < ncols) store16(mine + kVec * g, row + kVec * g);
  }
  __syncwarp();
#pragma unroll
  for (int m = 0; m + 1 < kPanel; ++m)
    if (live && lane > m) d[m * ld + lane] = row[m];
}

// Two threads (neighbouring lanes): x L11^T = row for the 32 entries at
// `row`, in place, by forward substitution.  The columns are dealt out in
// 16-byte groups, even groups to the even lane and odd groups to the odd
// one, so both have work until the last steps; each step's owner hands its
// new entry to its neighbour by a shuffle.  `l11` is the factorised diagonal
// block: row m of L11^T, above its diagonal, is read by 16-byte broadcast
// loads.  Every lane of the warp must call it; lanes whose `live` is false
// compute on a valid row and store nothing.
template <typename T>
__device__ __forceinline__ void chol_panel_row(T* row, bool live, const T* l11, int ld,
                                               const T* inv_diag) {
  constexpr int kVec = vec_len<T>();
  constexpr int kOwnGroups = kPanel / kVec / 2;
  const int lane = threadIdx.x & 31;
  const int h = lane & 1;
  T v[kPanel / 2];  // v[kVec * q + e]: the entry of column kVec * (2 q + h) + e
#pragma unroll
  for (int q = 0; q < kOwnGroups; ++q) load16(row + kVec * (2 * q + h), v + kVec * q);
  T inv[kPanel];
  load_row(inv_diag, inv, 0, kPanel);
#pragma unroll
  for (int m = 0; m < kPanel; ++m) {
    const int qm = m / kVec / 2;
    const int em = m % kVec;
    const int hm = (m / kVec) & 1;
    const T x = __shfl_sync(kFullWarp, v[kVec * qm + em] * inv[m], (lane & ~1) | hm);
    if (h == hm) v[kVec * qm + em] = x;
#pragma unroll
    for (int q = qm; q < kOwnGroups; ++q) {
      const int c0 = kVec * (2 * q + h);
      if (c0 + kVec - 1 > m) {
        T lt[kVec];
        load16(l11 + m * ld + c0, lt);
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          if (c0 + e > m) v[kVec * q + e] -= x * lt[e];
      }
    }
  }
  if (live) {
#pragma unroll
    for (int q = 0; q < kOwnGroups; ++q) store16(row + kVec * (2 * q + h), v + kVec * q);
  }
}

// Factorises the t x t SPD matrix held row-major in shared memory `a`
// (leading dimension ld = smem_ld<T>(t); only the lower triangle is read)
// in place into its lower Cholesky factor.  The entries above the diagonal
// inside each 32 x 32 diagonal block are scratch (they end up holding
// L11^T); the rest of the upper triangle is not touched.  All kThreads
// threads of the block call it.
//
// Two hooks let a caller run work beside the factorisation's own phases:
//  * While warp 0 factorises the diagonal block of the panel at column k0,
//    every thread of the other warps calls on_diag(k0).  The columns left of
//    k0 are final then; the hook must not touch columns k0 on.
//  * After a panel's 32 columns are final (its diagonal block and every row
//    under it) and before the block moves on, every thread calls
//    on_panel(k0, nb, inv_diag): k0 is the panel's first column, nb its
//    width (32, or less for a ragged last panel), inv_diag[c] =
//    1 / L[k0+c][k0+c].  The hook may read the panel's columns of `a`; the
//    trailing update that runs beside it touches only columns to the right
//    of the panel.
//
// A non-positive (or NaN) pivot gives NaN, which spreads through the panel
// solve and the trailing update to the rest of the factor.  Ends on a
// barrier, so the caller may read `a` at once.
template <int kThreads, typename T, typename OnDiag, typename OnPanel>
__device__ __forceinline__ void chol_factorise(T* a, int ld, int t, OnDiag on_diag,
                                               OnPanel on_panel) {
  __shared__ __align__(16) T scratch[3 * kPanel];
  T* inv_diag = scratch;
  T* ring = scratch + kPanel;
  constexpr int kWarps = kThreads / 32;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  for (int k0 = 0; k0 < t; k0 += kPanel) {
    const int nb = min(kPanel, t - k0);
    const int below = k0 + kPanel;  // first row under the panel, if any
    T* l11 = a + k0 * ld + k0;
    if (warp == 0)
      chol_diag_block(l11, ld, nb, min(kPanel, ld - k0), inv_diag, ring);
    else
      on_diag(k0);
    __syncthreads();
    BET_PHASE_CLOCK();  // the diagonal block

    // Two threads per row under the panel; whole warps take part.
    for (int p0 = warp * 32; p0 < 2 * (t - below); p0 += kThreads) {
      const int i = below + (p0 + (tid & 31)) / 2;
      chol_panel_row(a + min(i, t - 1) * ld + k0, i < t, l11, ld, inv_diag);
    }
    __syncthreads();
    BET_PHASE_CLOCK();  // the rows under it

    on_panel(k0, nb, inv_diag);

    // A22 -= L21 L21^T over the 32 x 32 blocks (ib, jb), jb <= ib, of the
    // lower triangle of the rows and columns from `below` on.
    const int nblk = (t - below + kPanel - 1) / kPanel;  // <= 0 under the last panel
    for (int u = warp; u < nblk * (nblk + 1) / 2; u += kWarps) {
      int ib = 0;
      while ((ib + 1) * (ib + 2) / 2 <= u) ++ib;
      const int jb = u - ib * (ib + 1) / 2;
      const int i0 = below + ib * kPanel;
      const int j0 = below + jb * kPanel;
      T acc[kTileRows][kTileCols];
      warp_tile_zero(acc);
      warp_tile_mac<true>(acc, a + i0 * ld + k0, min(kPanel, t - i0), a + j0 * ld + k0,
                          min(kPanel, t - j0), ld, 0, kPanel);
#pragma unroll
      for (int r = 0; r < kTileRows; ++r) {
        const int i = i0 + tile_row(r);
#pragma unroll
        for (int c = 0; c < kTileCols; ++c) {
          const int j = j0 + tile_col<true>(c);
          if (i < t && j <= i) a[i * ld + j] -= acc[r][c];
        }
      }
    }
    __syncthreads();
    BET_PHASE_CLOCK();  // the hook and the trailing update
  }
}

}  // namespace bet
