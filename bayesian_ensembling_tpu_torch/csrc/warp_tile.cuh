// Building blocks of the panel-blocked Cholesky (chol_factorise.cuh) and of
// the blocked triangular inverse (tri_inv.cu): the shared-memory layout of a
// T x T matrix, 16-byte loads from it, a register-tiled 32 x 32 block product
// for one warp, and the copies between device and shared memory.
//
// What these kernels run out of first is not arithmetic but shared-memory
// instructions: the SM starts one per cycle against four multiply-add
// instructions per cycle, and a lone warp, which runs its instructions in
// order, waits out the full latency of every load it depends on.  So every row of the matrix starts on a 16-byte boundary, and
// operands are read 16 bytes at a time (4 floats or 2 doubles) into register
// tiles: 12 loads feed 128 float multiply-adds.
#pragma once

#include <cuda_pipeline.h>

#include "common.cuh"

namespace bet {

constexpr int kPanel = 32;  // panel width = block edge = warp width
constexpr int kTileRows = 8;  // accumulator rows per lane
constexpr int kTileCols = 4;  // accumulator columns per lane
constexpr unsigned kFullWarp = 0xffffffffu;

// Values of T in one 16-byte load.
template <typename T>
__host__ __device__ constexpr int vec_len() {
  return 16 / sizeof(T);
}

// Leading dimension of a T x T matrix held in shared memory: a multiple of
// 16 bytes, so that every row can be read by 16-byte loads, and not a
// multiple of 128 bytes, so that the rows of one column do not all start in
// the same bank.  Columns t .. ld-1 are padding.
template <typename T>
__host__ __device__ inline int smem_ld(int t) {
  constexpr int kVec = vec_len<T>();
  int ld = (t + kVec - 1) / kVec * kVec;
  if (ld * sizeof(T) % 128 == 0) ld += kVec;
  return ld;
}

__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

__device__ __forceinline__ void load16(const double* p, double* out) {
  const double2 v = *reinterpret_cast<const double2*>(p);
  out[0] = v.x;
  out[1] = v.y;
}

__device__ __forceinline__ void store16(float* p, const float* in) {
  *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
}

__device__ __forceinline__ void store16(double* p, const double* in) {
  *reinterpret_cast<double2*>(p) = make_double2(in[0], in[1]);
}

// out[j] = src[j] for the 16-byte groups that meet [first, last), from a
// 16-byte aligned row of shared memory; the rest of `out` is left alone.
// When every lane reads the same row (a broadcast), a load costs the shared
// memory one cycle however wide it is.
template <typename T>
__device__ __forceinline__ void load_row(const T* src, T (&out)[kPanel], int first, int last) {
  constexpr int kVec = vec_len<T>();
#pragma unroll
  for (int g = 0; g < kPanel / kVec; ++g)
    if (kVec * g + kVec > first && kVec * g < last) load16(src + kVec * g, out + kVec * g);
}

// Lane (ly, lx) = (lane / 8, lane % 8) of a warp owns the entries
// (tile_row(r), tile_col(c)), r < 8, c < 4, of a 32 x 32 block: rows
// ly + 4 r; columns 4 lx + c when the second operand is read along its rows
// (kTransB false: a lane's four columns are one 16-byte load), lx + 8 c when
// it is read as rows of a transposed operand (kTransB true: the eight rows
// that a warp reads at once lie 16 bytes apart modulo 128 or nearly so).
__device__ __forceinline__ int tile_row(int r) { return ((threadIdx.x & 31) >> 3) + 4 * r; }
template <bool kTransB>
__device__ __forceinline__ int tile_col(int c) {
  return kTransB ? (threadIdx.x & 7) + 8 * c : 4 * (threadIdx.x & 7) + c;
}

// acc[r][c] += sum over k in [kbeg, kend) of A(tile_row(r), k) * B(k, tile_col(c)).
//   A(i, k) = a[i * ld + k]; rows i >= a_rows (a ragged last block) are read
//   from row a_rows - 1 instead, and the caller discards those results.
//   kTransB false: B(k, j) = b[k * ld + j], all 32 columns present; rows
//     k >= b_rows are read from row b_rows - 1.
//   kTransB true:  B(k, j) = b[j * ld + k], rows j >= b_rows clamped like A's.
// a, b, ld and kbeg are multiples of 16 bytes.  k runs in whole 16-byte
// groups: when kend is not a multiple of the group, A (and, transposed, B)
// must hold zeros in columns kend .. the end of the group, which the padding
// columns of a zero-filled matrix do.
template <bool kTransB, typename T>
__device__ __forceinline__ void warp_tile_mac(T (&acc)[kTileRows][kTileCols],
                                              const T* __restrict__ a, int a_rows,
                                              const T* __restrict__ b, int b_rows, int ld,
                                              int kbeg, int kend) {
  constexpr int kVec = vec_len<T>();
  constexpr int kUnroll = sizeof(T) == 4 ? 2 : 1;  // doubles: no registers to spare
  int ao[kTileRows];
#pragma unroll
  for (int r = 0; r < kTileRows; ++r) ao[r] = min(tile_row(r), a_rows - 1) * ld;
  int bo[kTileCols];  // transposed: one row of b per column of the tile
#pragma unroll
  for (int c = 0; c < kTileCols; ++c)
    bo[c] = kTransB ? min(tile_col<true>(c), b_rows - 1) * ld : tile_col<false>(0);
#pragma unroll kUnroll
  for (int k = kbeg; k < kend; k += kVec) {
    T av[kTileRows][kVec];
    T bv[kVec][kTileCols];  // bv[s][c] = B(k + s, tile_col(c))
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) load16(a + ao[r] + k, av[r]);
    if (kTransB) {
#pragma unroll
      for (int c = 0; c < kTileCols; ++c) {
        T col[kVec];
        load16(b + bo[c] + k, col);
#pragma unroll
        for (int s = 0; s < kVec; ++s) bv[s][c] = col[s];
      }
    } else {
#pragma unroll
      for (int s = 0; s < kVec; ++s) {
        const T* row = b + min(k + s, b_rows - 1) * ld + bo[0];
#pragma unroll
        for (int c = 0; c < kTileCols; c += kVec) load16(row + c, bv[s] + c);
      }
    }
#pragma unroll
    for (int s = 0; s < kVec; ++s)
#pragma unroll
      for (int r = 0; r < kTileRows; ++r)
#pragma unroll
        for (int c = 0; c < kTileCols; ++c) acc[r][c] += av[r][s] * bv[s][c];
  }
}

template <typename T>
__device__ __forceinline__ void warp_tile_zero(T (&acc)[kTileRows][kTileCols]) {
#pragma unroll
  for (int r = 0; r < kTileRows; ++r)
#pragma unroll
    for (int c = 0; c < kTileCols; ++c) acc[r][c] = T(0);
}

// Rows of a (B, T, T) batch-major matrix in device memory to and from the
// t x ld shared-memory matrix, one warp per row so that a warp's accesses to
// device memory are contiguous.  The load reads the lower triangle only, as
// asynchronous copies straight into shared memory: every thread queues all
// of its elements before it waits, so the block pays the memory's latency
// once and not once per row.  With kZeroAbove it also writes zeros above the
// diagonal inside the row's 32 x 32 diagonal block and into the padding
// columns (the 32-blocks wholly above the diagonal are left as they are).
// The caller follows it with a barrier.
template <int kThreads, bool kZeroAbove, typename T>
__device__ __forceinline__ void load_lower(T* a, int ld, const T* __restrict__ src, int t) {
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < t; i += kThreads / 32) {
    for (int c = lane; c <= i; c += 32)
      __pipeline_memcpy_async(a + i * ld + c, src + i * t + c, sizeof(T));
    if (kZeroAbove) {
      const int c = i + 1 + lane;
      if (c < min(ld, (i / kPanel + 1) * kPanel)) a[i * ld + c] = T(0);
      if (t + lane < ld) a[i * ld + t + lane] = T(0);
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
}

// The store writes the lower triangle and zeros above the diagonal, 256
// columns of a row at a time with the loop unrolled, so that a lane's
// shared-memory reads are all in flight before its first store.
template <int kThreads, typename T>
__device__ __forceinline__ void store_lower(T* __restrict__ dst, const T* a, int ld, int t) {
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < t; i += kThreads / 32)
    for (int c0 = lane; c0 < t; c0 += 256) {
      T v[8];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int c = c0 + 32 * n;
        v[n] = c <= i ? a[i * ld + c] : T(0);
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int c = c0 + 32 * n;
        if (c < t) dst[i * t + c] = v[n];
      }
    }
}

}  // namespace bet
