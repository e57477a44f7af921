// Batched vector solve with a given Cholesky factor: z = L^-1 y,
// alpha = L^-T z, logdet = 2 sum_i log L_ii; with forward_only, z and
// logdet alone (the library's scores throw alpha away).
//
// Replaces the Pallas TPU kernel
//   bayesian_ensembling_tpu/ops/linalg_pallas.py::_solve_vec_kernel
//   (public entry solve_vec_batched).  Its callers are the library API's
//   full-covariance scores (ops/scoring.py, ops/distributions.py), which
//   solve against the factor of each model's posterior covariance.
//
// What bounds it on an H100: one read of the lower triangle of L (2 T^2
// flops per matrix, far below the memory's rate) and a chain of 2T
// dependent unknowns (T forward-only).  A read of L from device memory
// inside the chain costs a round trip a 32-row panel step (about 8,000
// cycles at T = 165), so both layouts have L in shared memory before the
// chain reads it.
//
// Two layouts, chosen by the wrapper from T (ops/linalg_cuda.py mirrors the
// shared memory and sets the flag of the streamed one past the resident cap):
//
//  * Resident (T <= 337 in float32, 237 in float64; every library shape).
//    512 threads load the packed lower triangle (row i at i (i+1) / 2) into
//    shared memory once (coalesced loads of 4 or 8 bytes, a batch of rows
//    in flight at a time: rows of odd T are not 16-byte aligned), with one
//    mbarrier per 32-row panel; both passes then read shared memory only.
//    Per panel, warp 0 solves the panel's 32 unknowns by a shuffle chain on
//    its rows (forward) or columns (backward) held in registers and scaled
//    by the reciprocals of the diagonal, which the other threads compute a
//    panel ahead, so a link is a shuffle and an FMA, with no division; then
//    every thread takes a row below (a column left of) the panel and adds
//    its 32 terms.  Two block barriers a panel.  Measured on the H100
//    (PERF.md) against one warp sweeping every column with no barrier and
//    against the diagonal blocks' inverses computed off the chain, this was
//    the fastest at T = 86 and 165.
//  * Streamed (larger T, up to 33,216 / 16,608).  Both passes read row
//    panels of L in a fixed order, forward top-down and backward bottom-up,
//    as tiles of 32 rows x W columns (W = 128 float32, 64 float64: 16 KB)
//    through a ring of six shared-memory stages.  The copy engine moves a
//    tile on one request where rows start on 16 bytes (T a multiple of 16
//    bytes: the monthly T = 1032 and 1980), else two producer warps copy
//    the lower triangle's entries one by one; full/empty mbarriers pace the
//    ring.  W consumer threads, one a column, form the forward dot products
//    of the panel's rows with the known z (32 running sums a thread,
//    reduced at the panel's end) and apply the backward updates
//    v_c -= sum_r L[j0+r, c] alpha_r; one solver warp solves each 32 x 32
//    diagonal block from the stage by the same shuffle chain.  Consumers
//    take every chunk in order and release it (with the solver's share on
//    all but the diagonal chunks, which the solver releases); the solver
//    waits on a diagonal chunk's stage only once the consumers have found
//    the chunk there (after the panel's dot products, or a counter), so no
//    parity wait mistakes one round of a stage for another.  Consumers run
//    ahead into the next panel while the solver works and wait (spinning
//    on a counter) only for the unknowns they use.  One T-vector in shared
//    memory holds z, then z minus the backward sums, then alpha, in place.
//
// A zero diagonal entry gives inf or NaN in z and alpha from that row on
// and -inf in logdet; a negative or NaN one gives NaN in logdet.  Nothing
// is trapped, as in the plain version.
#include <cuda.h>  // CUtensorMap (the types only: the encoder is looked up at run time)

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kPanel = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStreamedFlag = 2;  // flags bit 1: the streamed layout (bit 0: forward only)

// ---------------------------------------------------------------- helpers
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n\t.reg .pred done;\n"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n\t"
      "@!done bra WAIT;\n}" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar, unsigned count) {
  asm volatile("{\n\t.reg .b64 st;\n\tmbarrier.arrive.shared::cta.b64 st, [%0], %1;\n}" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// One element from device to shared memory, asynchronously.
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  if (sizeof(T) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
}

// One arrival that also expects `bytes` more of bulk copies in this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\tmbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// A 2-D tile (columns c, rows r on) of the tensor map's tensor by the copy
// engine, counted against the mbarrier's expected bytes; columns past the
// tensor's width and rows past its height arrive as zeros.
__device__ __forceinline__ void tile_copy(void* dst, const CUtensorMap* map, int c, int r, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(r), "r"(smem_addr(bar))
      : "memory");
}

// The mbarrier completes its phase once the calling thread's earlier
// cp.async copies have landed (counted as one of its expected arrivals).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

// 32 values from a 16-byte aligned row of shared memory, 16 bytes a load.
__device__ __forceinline__ void load_row(const float* p, float (&out)[kPanel]) {
#pragma unroll
  for (int g = 0; g < kPanel / 4; ++g) {
    const float4 v = reinterpret_cast<const float4*>(p)[g];
    out[4 * g] = v.x;
    out[4 * g + 1] = v.y;
    out[4 * g + 2] = v.z;
    out[4 * g + 3] = v.w;
  }
}

__device__ __forceinline__ void load_row(const double* p, double (&out)[kPanel]) {
#pragma unroll
  for (int g = 0; g < kPanel / 2; ++g) {
    const double2 v = reinterpret_cast<const double2*>(p)[g];
    out[2 * g] = v.x;
    out[2 * g + 1] = v.y;
  }
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__host__ __device__ constexpr size_t align16(size_t bytes) { return (bytes + 15) / 16 * 16; }

// Loads placed before this stay before it: a lone warp runs in order, and
// nvcc would otherwise put each shared-memory load of a chain's or a sum's
// coefficients right before its use.
__device__ __forceinline__ void compiler_fence() { asm volatile("" ::: "memory"); }

// One link of a panel's chain: the lanes that the unknown x enters subtract
// coef x, the others keep their value (a select, so the warp never splits).
template <typename T>
__device__ __forceinline__ T link(T cur, T coef, T x, bool enters) {
  const T upd = fma(-coef, x, cur);
  return enters ? upd : cur;
}

// The forward chain of a panel: lane i holds cur_i = (r_i - known sums) /
// L_ii and lrow[c] = L_ic / L_ii (read for c < i); returns z_i.  Links
// past a ragged panel's n reach only lanes past it, whose values nobody
// uses, so all 32 run with no branch.
template <typename T>
__device__ __forceinline__ T forward_chain(T cur, const T (&lrow)[kPanel], int lane) {
#pragma unroll
  for (int cc = 0; cc < kPanel; ++cc) {
    const T zc = __shfl_sync(kFull, cur, cc);
    cur = link(cur, lrow[cc], zc, lane > cc);
  }
  return cur;
}

// The backward chain of a panel (L^T): lane i holds cur_i = (z_i - known
// sums) / L_ii and lcol[c] = L_ci / L_ii (read for i < c < n); returns alpha_i.
template <typename T>
__device__ __forceinline__ T backward_chain(T cur, const T (&lcol)[kPanel], int lane, int n) {
#pragma unroll
  for (int cc = kPanel - 1; cc >= 0; --cc) {
    const T ac = __shfl_sync(kFull, cur, cc);
    cur = link(cur, lcol[cc], ac, lane < cc && cc < n);
  }
  return cur;
}

// ------------------------------------------------------ resident layout
constexpr int kResThreads = 512;
constexpr int kResWarps = kResThreads / 32;
constexpr int kResHeader = 16 * 8;  // one mbarrier a panel, at most 11 panels

// Packed offset of row i: rows of the triangle one after the other.
__host__ __device__ constexpr int packed_row(int i) { return i * (i + 1) / 2; }

template <typename T>
size_t resident_smem_bytes(int t) {
  return kResHeader + 3 * align16(sizeof(T) * t) + sizeof(T) * static_cast<size_t>(packed_row(t));
}

// K: 32-value chunks of the longest row, the loaders' loads a row; the
// launcher picks the smallest built K >= ceil(T / 32) (11 covers float32's
// cap of 337, 8 float64's of 237).
template <typename T, int K>
__global__ void __launch_bounds__(kResThreads)
    solve_vec_resident(const T* __restrict__ l_all, const T* __restrict__ y_all,
                       T* __restrict__ z_out, T* __restrict__ alpha_out,
                       T* __restrict__ logdet_out, int t, int forward_only) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);  // panel p has landed
  T* v = reinterpret_cast<T*>(smem + kResHeader);     // y, then z, then z - the backward sums, then alpha
  T* dot = v + align16(sizeof(T) * t) / sizeof(T);    // forward: the rows' sums over the solved columns
  T* rinv = dot + align16(sizeof(T) * t) / sizeof(T);  // 1 / L_ii
  T* tri = rinv + align16(sizeof(T) * t) / sizeof(T);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int np = (t + kPanel - 1) / kPanel;
  const size_t m = blockIdx.x;
  BET_PHASE_CLOCK_RESET();
  BET_PHASE_CLOCK();

  if (tid == 0)
    for (int p = 0; p < np; ++p) mbar_init(&bar[p], kResThreads);
  for (int i = tid; i < t; i += kResThreads) {
    v[i] = y_all[m * t + i];
    dot[i] = T(0);
  }
  __syncthreads();

  // Loads: warp w takes rows w, w + kResWarps, ... in order, kBatch rows
  // at a time, lanes along each row; all of a batch's loads (coalesced, 4
  // or 8 bytes a lane: rows of odd T are not 16-byte aligned) are in flight
  // before its stores into the packed triangle.  A thread arrives on a
  // panel's mbarrier once its rows of the panel are stored, so a panel has
  // landed when all of them are; the solve starts when panel 0 has.
  {
    constexpr int kBatch = sizeof(T) == 4 ? 4 : 2;
    const T* l = l_all + m * t * t;
    int arrived = 0;
    for (int i0 = warp; i0 < t; i0 += kResWarps * kBatch) {
      T x[kBatch][K];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + kResWarps * u;
        const T* src = l + static_cast<size_t>(min(i, t - 1)) * t;
#pragma unroll
        for (int q = 0; q < K; ++q) {
          const int c = lane + 32 * q;
          x[u][q] = i < t && c <= i ? __ldg(src + c) : T(0);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + kResWarps * u;
#pragma unroll
        for (int q = 0; q < K; ++q) {
          const int c = lane + 32 * q;
          if (i < t && c <= i) tri[packed_row(i) + c] = x[u][q];
        }
      }
      for (const int done = min(np, (i0 + kResWarps * kBatch) / kPanel); arrived < done; ++arrived)
        mbar_arrive(&bar[arrived], 1);
    }
    for (; arrived < np; ++arrived) mbar_arrive(&bar[arrived], 1);
  }

  // Forward.  Panel p: warp 0 solves its 32 unknowns by a shuffle chain on
  // the panel's rows, held in registers and scaled by the reciprocals of
  // the diagonal (computed off the chain); then every thread takes a row
  // below the panel and adds its 32 terms.  Two block barriers a panel.
  T logsum = T(0);
  T* z_g = z_out + m * t;
  for (int p = 0; p < np; ++p) {
    const int j0 = kPanel * p;
    const int n = min(kPanel, t - j0);
    if (warp == 0) {
      mbar_wait(&bar[p], 0);
      if (p == 0) {
        BET_PHASE_CLOCK();  // panel 0 has landed
        if (lane < n) rinv[lane] = T(1) / tri[packed_row(lane) + lane];
        __syncwarp();
      }
      const int row = min(j0 + lane, t - 1);
      const T* lr = tri + packed_row(row) + j0;
      const T rcur = rinv[row];
      if (lane < n) logsum += log(tri[packed_row(row) + row]);
      T lrow[kPanel];  // L[j0 + lane, j0 + cc] / L_ii, used for cc < lane
#pragma unroll
      for (int cc = 0; cc < kPanel; ++cc) lrow[cc] = lr[min(cc, row - j0)] * rcur;
      T cur = (v[row] - dot[row]) * rcur;
      compiler_fence();
      cur = forward_chain(cur, lrow, lane);
      if (lane < n) {
        v[j0 + lane] = cur;
        z_g[j0 + lane] = cur;
      }
    }
    __syncthreads();  // z of the panel is in v
    for (int i = j0 + kPanel + tid; i < t; i += kResThreads) {
      mbar_wait(&bar[i / kPanel], 0);
      const T* li = tri + packed_row(i) + j0;
      T lv[kPanel], zv[kPanel];
#pragma unroll
      for (int cc = 0; cc < kPanel; ++cc) lv[cc] = li[cc];
      load_row(v + j0, zv);
      compiler_fence();
      T s4[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
      for (int cc = 0; cc < kPanel; ++cc) s4[cc & 3] = fma(lv[cc], zv[cc], s4[cc & 3]);
      dot[i] += (s4[0] + s4[1]) + (s4[2] + s4[3]);
      if (i < j0 + 2 * kPanel) rinv[i] = T(1) / tri[packed_row(i) + i];  // the next panel's, off the chain
    }
    __syncthreads();  // the next panel's rows have their sums and reciprocals
    BET_PHASE_CLOCK();  // forward panel p
  }
  if (warp == 0) {
    logsum = warp_sum(logsum);
    if (lane == 0) logdet_out[m] = T(2) * logsum;
  }
  if (forward_only) return;

  // Backward, L^T alpha = z, panels from the last: warp 0 solves the
  // panel's unknowns by a shuffle chain on its columns (row cc of L is
  // column cc of L^T, contiguous in the packed triangle), then every thread
  // takes a column left of the panel and subtracts its 32 terms.
  T* alpha_g = alpha_out + m * t;
  for (int p = np - 1; p >= 0; --p) {
    const int j0 = kPanel * p;
    const int n = min(kPanel, t - j0);
    if (warp == 0) {
      const int row = min(j0 + lane, t - 1);
      const T rcur = rinv[row];
      T lcol[kPanel];  // L[j0 + cc, j0 + lane] / L_ii, used for lane < cc < n
#pragma unroll
      for (int cc = 0; cc < kPanel; ++cc) {
        const int rc = min(j0 + cc, t - 1);
        lcol[cc] = tri[packed_row(rc) + min(j0 + lane, rc)] * rcur;
      }
      T cur = v[row] * rcur;
      compiler_fence();
      cur = backward_chain(cur, lcol, lane, n);
      if (lane < n) {
        v[j0 + lane] = cur;
        alpha_g[j0 + lane] = cur;
      }
    }
    __syncthreads();  // alpha of the panel is in v
    for (int c = tid; c < j0; c += kResThreads) {
      T lv[kPanel], av[kPanel];
#pragma unroll
      for (int r = 0; r < kPanel; ++r) lv[r] = tri[packed_row(j0 + min(r, n - 1)) + c];
      load_row(v + j0, av);
      compiler_fence();
      T s4[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
      for (int r = 0; r < kPanel; ++r) s4[r & 3] = r < n ? fma(lv[r], av[r], s4[r & 3]) : s4[r & 3];
      v[c] -= (s4[0] + s4[1]) + (s4[2] + s4[3]);
    }
    __syncthreads();
    BET_PHASE_CLOCK();  // backward panel p
  }
}

// ------------------------------------------------------ streamed layout
constexpr int kStages = 6;
constexpr int kStageBytes = 16384;  // 32 rows x W columns
constexpr int kProducers = 2;       // warps
constexpr int kStrHeader = 256;     // mbarriers and counters

template <typename T>
struct Stream {
  static constexpr int kW = kStageBytes / (kPanel * static_cast<int>(sizeof(T)));  // 128 / 64
  static constexpr int kLd = kW;  // a stage is the tile as the copy engine writes it, rows of 512 bytes
  static constexpr int kConsumers = kW / 32;  // warps, one thread a column
  static constexpr int kThreads = 32 * (1 + kConsumers + kProducers);
  static constexpr size_t kStage = align16(sizeof(T) * kPanel * kLd);
  static constexpr size_t kDots = sizeof(T) * 2 * kConsumers * kPanel;
};

template <typename T>
size_t streamed_smem_bytes(int t) {
  return kStages * Stream<T>::kStage + kStrHeader + Stream<T>::kDots + align16(sizeof(T) * t);
}

// The chunks of both passes, in the one order that producer, consumers and
// solver all follow: forward panels top-down, each from column 0 to its
// diagonal block (the last chunk); backward panels bottom-up, each from its
// diagonal block (the first chunk) down to column 0.  fn(p, q, diag, backward).
template <int kW, typename Fn>
__device__ __forceinline__ void for_each_chunk(int t, bool backward_too, Fn fn) {
  const int np = (t + kPanel - 1) / kPanel;
  for (int p = 0; p < np; ++p) {
    const int qd = kPanel * p / kW;
    for (int q = 0; q <= qd; ++q) fn(p, q, q == qd, false);
  }
  if (!backward_too) return;
  for (int p = np - 1; p >= 0; --p) {
    const int qd = kPanel * p / kW;
    for (int q = qd; q >= 0; --q) fn(p, q, q == qd, true);
  }
}

template <typename T>
__global__ void __launch_bounds__(Stream<T>::kThreads)
    solve_vec_streamed(const T* __restrict__ l_all, const T* __restrict__ y_all,
                       T* __restrict__ z_out, T* __restrict__ alpha_out,
                       T* __restrict__ logdet_out, int t, int forward_only, int bulk,
                       const __grid_constant__ CUtensorMap tiles) {
  using S = Stream<T>;
  constexpr int kW = S::kW;
  constexpr int kLd = S::kLd;
  constexpr int kC = S::kConsumers;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);  // the stages, on 128 bytes for the copy engine
  unsigned char* head = smem + kStages * S::kStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(head);  // stage s holds its chunk
  uint64_t* empty = full + kStages;                     // stage s may be refilled
  uint64_t* dots_full = empty + kStages;                // a forward panel's dot products are in
  uint64_t* v_ready = dots_full + 1;                    // the next backward panel's rhs is final
  volatile int* z_done = reinterpret_cast<volatile int*>(v_ready + 1);  // z known below it
  volatile int* a_lo = z_done + 1;                                      // alpha known from it on
  volatile int* seen = a_lo + 1;  // the last chunk the first consumer warp found in the ring
  T* dots = reinterpret_cast<T*>(head + kStrHeader);  // [2][kC][32]
  T* v = reinterpret_cast<T*>(head + kStrHeader + S::kDots);
  volatile T* vv = v;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int np = (t + kPanel - 1) / kPanel;
  const bool both = !forward_only;
  const size_t m = blockIdx.x;
  const T* l = l_all + m * t * t;
  BET_PHASE_CLOCK_RESET();
  BET_PHASE_CLOCK();

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], bulk ? 1 : 32 * kProducers);
      mbar_init(&empty[s], kC + 1);
    }
    mbar_init(dots_full, kC);
    mbar_init(v_ready, kC);
    *z_done = 0;
    *a_lo = t;
    *seen = -1;
  }
  __syncthreads();  // the only block barrier

  const auto stage_of = [](int k) { return k % kStages; };
  const auto parity_of = [](int k) { return static_cast<unsigned>((k / kStages) & 1); };

  if (warp > kC) {
    // ---- producers: rows j0 .. j0+31 of the panel, columns [c0, c0 + W).
    // Where rows start on 16 bytes (T a multiple of 16 bytes, L aligned:
    // the monthly T = 1032 and 1980) the copy engine moves the whole tile
    // on one request (the entries above the diagonal and past T come along
    // and are never read); else both warps copy the lower triangle's
    // entries one by one.
    const int ptid = tid - 32 * (1 + kC);
    if (bulk && ptid > 0) return;
    int k = 0;
    for_each_chunk<kW>(t, both, [&](int p, int q, bool, bool) {
      const int s = stage_of(k);
      if (k >= kStages) mbar_wait(&empty[s], parity_of(k) ^ 1u);
      const int j0 = kPanel * p;
      const int n = min(kPanel, t - j0);
      const int c0 = kW * q;
      T* st = ring + s * (S::kStage / sizeof(T));
      if (bulk) {
        mbar_expect_tx(&full[s], static_cast<unsigned>(S::kStage));
        tile_copy(st, &tiles, c0, static_cast<int>(blockIdx.x) * t + j0, &full[s]);
      } else {
        for (int e = ptid; e < kPanel * kW; e += 32 * kProducers) {
          const int r = e / kW, c = c0 + e % kW;
          if (r < n && c <= j0 + r) cp_async(st + r * kLd + (c - c0), l + static_cast<size_t>(j0 + r) * t + c);
        }
        cp_async_arrive(&full[s]);
      }
      ++k;
    });
    mbar_wait(&full[stage_of(k - 1)], parity_of(k - 1));  // this thread's copies have all landed
    return;
  }

  if (warp > 0) {
    // ---- consumers: one column c = c0 + ct of every chunk.
    const int ct = tid - 32;
    const int cw = warp - 1;
    T acc[kPanel];  // forward: this column's part of each panel row's dot product
#pragma unroll
    for (int r = 0; r < kPanel; ++r) acc[r] = T(0);
    int k = 0, fwd_panels = 0;
    for_each_chunk<kW>(t, both, [&](int p, int q, bool diag, bool backward) {
      const int s = stage_of(k);
      mbar_wait(&full[s], parity_of(k));
      if (cw == 0 && lane == 0) *seen = k;
      const int j0 = kPanel * p;
      const int n = min(kPanel, t - j0);
      const int c = kW * q + ct;
      const T* st = ring + s * (S::kStage / sizeof(T)) + ct;
      if (c < j0) {  // below the diagonal block
        if (!backward) {
          while (*z_done <= c) {
          }
          __threadfence_block();
          const T zc = vv[c];
          T lv[kPanel];
#pragma unroll
          for (int r = 0; r < kPanel; ++r) lv[r] = st[r * kLd];
          compiler_fence();
#pragma unroll
          for (int r = 0; r < kPanel; ++r) acc[r] = fma(lv[r], zc, acc[r]);
        } else {
          while (*a_lo > j0) {
          }
          __threadfence_block();
          T lv[kPanel], al[kPanel];
#pragma unroll
          for (int r = 0; r < kPanel; ++r) {
            lv[r] = st[r * kLd];
            al[r] = r < n ? vv[j0 + r] : T(0);
          }
          compiler_fence();
          T u[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
          for (int r = 0; r < kPanel; ++r) u[r & 3] = r < n ? fma(lv[r], al[r], u[r & 3]) : u[r & 3];
          vv[c] = vv[c] - ((u[0] + u[1]) + (u[2] + u[3]));
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s], (!diag && cw == 0) ? 2u : 1u);  // the solver's share
      if (!backward && diag) {
        // The panel's dot products: 31 shuffles leave lane r with row r's
        // sum over this warp's columns.
#pragma unroll
        for (int w = 16; w >= 1; w >>= 1) {
          const bool upper = (lane & w) != 0;
#pragma unroll
          for (int r = 0; r < w; ++r) {
            const T send = upper ? acc[r] : acc[r + w];
            const T keep = upper ? acc[r + w] : acc[r];
            acc[r] = keep + __shfl_xor_sync(kFull, send, w);
          }
        }
        // The solver has taken the dot products of two panels back (the
        // buffer is double) and waited for the last phase of dots_full.
        while (*z_done < j0) {
        }
        dots[((fwd_panels & 1) * kC + cw) * kPanel + lane] = acc[0];
#pragma unroll
        for (int r = 0; r < kPanel; ++r) acc[r] = T(0);
        __syncwarp();
        if (lane == 0) mbar_arrive(dots_full, 1);
        ++fwd_panels;
      }
      // Backward: once this panel's update has reached the columns of the
      // panel above, that panel's right-hand side is final.
      if (backward && p > 0 && q == (j0 - 1) / kW) {
        while (*a_lo > j0) {  // the solver has waited for the last phase of v_ready
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(v_ready, 1);
      }
      ++k;
    });
    return;
  }

  // ---- the solver warp: one 32 x 32 diagonal block a panel, from its stage
  const T* y = y_all + m * t;
  T* z_g = z_out + m * t;
  T* alpha_g = alpha_out + m * t;
  T logsum = T(0);
  T y_next = lane < t ? y[lane] : T(0);
  int k = 0, fwd_panels = 0, bwd_panels = 0;
  for_each_chunk<kW>(t, both, [&](int p, int q, bool diag, bool backward) {
    if (!diag) {
      ++k;
      return;
    }
    const int s = stage_of(k);
    const int j0 = kPanel * p;
    const int n = min(kPanel, t - j0);
    const T* st = ring + s * (S::kStage / sizeof(T)) + (j0 - kW * q);  // column j0 of the stage
    if (!backward) {
      const T y_p = y_next;
      if (j0 + kPanel + lane < t) y_next = y[j0 + kPanel + lane];
      mbar_wait(dots_full, static_cast<unsigned>(fwd_panels & 1));
      mbar_wait(&full[s], parity_of(k));
      BET_PHASE_CLOCK();  // waited for the dot products and the stage
      T rhs = y_p;
#pragma unroll
      for (int w = 0; w < kC; ++w) rhs -= dots[((fwd_panels & 1) * kC + w) * kPanel + lane];
      const int r = min(lane, n - 1);
      const T d = st[r * kLd + r];
      const T rcur = T(1) / d;
      if (lane < n) logsum += log(d);
      T lrow[kPanel];  // this lane's row of the block, scaled by 1 / L_ii (used for cc < r)
      load_row(st + r * kLd, lrow);  // 16-byte loads: the rows of a stage share their banks
#pragma unroll
      for (int cc = 0; cc < kPanel; ++cc) lrow[cc] *= rcur;
      T cur = rhs * rcur;
      compiler_fence();
      cur = forward_chain(cur, lrow, lane);
      if (lane < n) {
        vv[j0 + lane] = cur;
        z_g[j0 + lane] = cur;
      }
      __syncwarp();
      __threadfence_block();
      if (lane == 0) {
        *z_done = j0 + n;
        mbar_arrive(&empty[s], 1);
      }
      ++fwd_panels;
      if (p == np - 1) {
        logsum = warp_sum(logsum);
        if (lane == 0) logdet_out[m] = T(2) * logsum;
      }
    } else {
      if (p < np - 1) mbar_wait(v_ready, static_cast<unsigned>((bwd_panels - 1) & 1));
      while (*seen < k) {  // the chunk is in its stage: the parity wait below is of this round
      }
      mbar_wait(&full[s], parity_of(k));
      BET_PHASE_CLOCK();  // waited for the right-hand side and the stage
      const int r = min(lane, n - 1);
      const T rcur = T(1) / st[r * kLd + r];
      T lcol[kPanel];  // column lane of the block (row cc of L^T), scaled by 1 / L_ii
#pragma unroll
      for (int cc = 0; cc < kPanel; ++cc) lcol[cc] = st[min(cc, n - 1) * kLd + r] * rcur;
      T cur = (lane < n ? vv[j0 + lane] : T(0)) * rcur;
      compiler_fence();
      cur = backward_chain(cur, lcol, lane, n);
      if (lane < n) {
        vv[j0 + lane] = cur;
        alpha_g[j0 + lane] = cur;
      }
      __syncwarp();
      __threadfence_block();
      if (lane == 0) {
        *a_lo = j0;
        mbar_arrive(&empty[s], 1);
      }
      ++bwd_panels;
    }
    BET_PHASE_CLOCK();  // the panel's chain
    ++k;
  });
}

template <typename T, int K>
cudaError_t launch_resident(const T* l, const T* y, T* z, T* alpha, T* logdet, int b, int t,
                            int forward_only, cudaStream_t stream) {
  static bet::SmemGrant grant;
  const size_t smem = resident_smem_bytes<T>(t);
  cudaError_t err = bet::grant_dynamic_smem(solve_vec_resident<T, K>, smem, 0, grant);
  if (err != cudaSuccess) return err;
  solve_vec_resident<T, K><<<b, kResThreads, smem, stream>>>(l, y, z, alpha, logdet, t, forward_only);
  return cudaGetLastError();
}

// The streamed layout's tiles of L, (B T) rows of T values, 32 x W a tile,
// for the copy engine.  cuTensorMapEncodeTiled is looked up once through
// the runtime, so that the library links against nothing more.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

template <typename T>
cudaError_t encode_tiles(CUtensorMap* map, const T* l, int b, int t) {
  static std::mutex lock;
  static EncodeTiled encode = nullptr;
  {
    std::lock_guard<std::mutex> guard(lock);
    if (encode == nullptr) {
      cudaDriverEntryPointQueryResult found;
      const cudaError_t err = cudaGetDriverEntryPoint(
          "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode), cudaEnableDefault, &found);
      if (err != cudaSuccess) return err;
      if (found != cudaDriverEntryPointSuccess || encode == nullptr) return cudaErrorNotSupported;
    }
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(t), static_cast<cuuint64_t>(b) * t};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(t) * sizeof(T)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(Stream<T>::kW), kPanel};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(map, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_FLOAT64,
                            2, const_cast<T*>(l), dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T>
int launch_solve_vec(const void* l_, const void* y_, void* z_, void* alpha_, void* logdet_, int b,
                     int t, int flags, void* stream_) {
  if (b <= 0 || t <= 0) return cudaSuccess;
  const T* l = static_cast<const T*>(l_);
  const T* y = static_cast<const T*>(y_);
  T* z = static_cast<T*>(z_);
  T* alpha = static_cast<T*>(alpha_);
  T* logdet = static_cast<T*>(logdet_);
  const int forward_only = flags & 1;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (flags & kStreamedFlag) {
    static bet::SmemGrant grant;
    const size_t smem = streamed_smem_bytes<T>(t);
    cudaError_t err = bet::grant_dynamic_smem(solve_vec_streamed<T>, smem, 0, grant);
    if (err != cudaSuccess) return err;
    const int bulk = reinterpret_cast<uintptr_t>(l) % 16 == 0 && t * sizeof(T) % 16 == 0;
    CUtensorMap tiles{};
    if (bulk) {
      err = encode_tiles<T>(&tiles, l, b, t);
      if (err != cudaSuccess) return err;
    }
    solve_vec_streamed<T><<<b, Stream<T>::kThreads, smem, stream>>>(l, y, z, alpha, logdet, t,
                                                                       forward_only, bulk, tiles);
    return cudaGetLastError();
  }
  const int slots = (t + kPanel - 1) / kPanel;
  if (slots <= 1) return launch_resident<T, 1>(l, y, z, alpha, logdet, b, t, forward_only, stream);
  if (slots <= 2) return launch_resident<T, 2>(l, y, z, alpha, logdet, b, t, forward_only, stream);
  if (slots <= 3) return launch_resident<T, 3>(l, y, z, alpha, logdet, b, t, forward_only, stream);
  if (slots <= 4) return launch_resident<T, 4>(l, y, z, alpha, logdet, b, t, forward_only, stream);
  if (slots <= 6) return launch_resident<T, 6>(l, y, z, alpha, logdet, b, t, forward_only, stream);
  if (slots <= 8) return launch_resident<T, 8>(l, y, z, alpha, logdet, b, t, forward_only, stream);
  if constexpr (sizeof(T) == 4)
    if (slots <= 11) return launch_resident<T, 11>(l, y, z, alpha, logdet, b, t, forward_only, stream);
  return cudaErrorInvalidValue;  // past the resident cap: the wrapper asks for the streamed layout
}

}  // namespace

extern "C" {

int bet_solve_vec_f32(const void* l, const void* y, void* z, void* alpha, void* logdet, int b,
                      int t, int flags, void* stream) {
  return launch_solve_vec<float>(l, y, z, alpha, logdet, b, t, flags, stream);
}

int bet_solve_vec_f64(const void* l, const void* y, void* z, void* alpha, void* logdet, int b,
                      int t, int flags, void* stream) {
  return launch_solve_vec<double>(l, y, z, alpha, logdet, b, t, flags, stream);
}

}  // extern "C"
