// Sorted-set intersection counts |row_a(pos_a[i]) ∩ row_b(pos_b[i])| over
// compact CSR, load-balanced by work rather than by row.
//
// Replaces the TPU kernel src/repro/kernels/intersect/kernel.py
// (_intersect_kernel / intersect_count_pallas), which compares a tile of
// SENTINEL-padded rows against all K lane rotations of the other side:
// O(K^2) work per row, regardless of how many real entries the rows hold.
//
// What bounds it here: dependent probe steps. A pair costs min(d_a, d_b)
// probes of the narrow row into the wide one, each a binary search whose
// every step waits on a load (the min(d_x, d_y) accounting of Thm. 17);
// the bytes of the rows, read once, take far less time at 3.35 TB/s.
//
// Design:
// * Input is compact CSR: per side a value array and, per key position,
//   the row's first and one-past-last value index (beg[r], end[r]). For
//   CSR offsets beg = off and end = off + 1; the padded per-row API reads
//   its (R, K) matrix as CSR with beg[r] = r * stride and end[r] = beg[r]
//   plus the row's real length (ops.py). Each pair i names its rows by key
//   positions pos_a[i], pos_b[i].
// * Work split, not row split. work_kernel writes each pair's work
//   w_i = min(d_a, d_b) and the caller scans it into work_off (n_pairs + 1
//   entries). A fixed grid walks tiles of that work space
//   (intersect_core.cuh, shared with the fused count kernel of
//   lftj_fused.cu): a tile of one pair whose window fits stages the wide
//   row's window in shared memory with cp.async and gallops through it; a
//   tile of at least eight pairs gives a warp to each pair; every other
//   tile gives a warp 32 consecutive probes of one narrow row, each a
//   binary search of the wide row resumed from the thread's last hit.
//   The tile size is read from work_off[n_pairs] on the device, so the
//   host never reads a size.
// * Merge-path splits for rows of comparable length are not used: a
//   window in shared memory makes such a pair's probes a few shared loads,
//   and the split would add a co-rank search per thread.
// * Outputs from one pass: one int64 partial per block (no atomics on
//   totals; the caller sums them on the device), and optionally per-pair
//   int32 counts, where a pair that spans tiles or threads adds with
//   integer atomicAdd (exact and order-free).
// The kernel allocates nothing; the caller passes outputs and scratch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "intersect_core.cuh"

namespace {

using probe::kThreads;
using probe::PairRows;
// the fixed grid that walks the tiles
constexpr int kBlocks = 132 * 8;

struct Side {
  const long long* beg;  // first value index of the row at each key position
  const long long* end;  // one past its last value index
  const int* vals;
  const long long* pos;  // key position of each pair's row
};

// INTERSECT_WARP_CHUNKS builds the kernel on the fused count's scheduler
// (probe::warp_chunks, at its four blocks an SM and 4 KB a warp) instead
// of the block tiles, for scripts/kernel_ab_probe.py --intersect-variant
#ifdef INTERSECT_WARP_CHUNKS
constexpr int kBlocksPerSM = 4;
constexpr int kChunkWarpWin = 1024;
constexpr int kSmem = kChunkWarpWin * (kThreads / 32) * 4;
#else
constexpr int kBlocksPerSM = 8;
constexpr int kChunkWarpWin = 0;
constexpr int kSmem = probe::kWinBytes;
#endif

// the pairs as count_tiles reads them: read-only inputs through __ldg; the
// sides stay the kernel's parameters (read from parameter space, not held
// in registers: the kernel runs at 32 registers a thread)
struct PairItems {
  const Side& A;
  const Side& B;
  const long long* work_off;
  int* per_item;
  static constexpr bool kRest = false;
  static constexpr bool kPerItem = true;
  static constexpr int kWarpWin = kChunkWarpWin;

  // a warp's hits c (per lane) in pair p, when per-pair counts are asked
  __device__ __forceinline__ void add(long long p, long long c) const {
    if (per_item == nullptr) return;
    c = probe::warp_sum(c);
    if ((threadIdx.x & 31) == 0 && c) atomicAdd(per_item + p, (int)c);
  }

  __device__ __forceinline__ long long work(long long p) const {
    return __ldg(work_off + p);
  }

  __device__ __forceinline__ PairRows rows(long long p) const {
    const long long ra = __ldg(A.pos + p);
    const long long rb = __ldg(B.pos + p);
    const long long ba = __ldg(A.beg + ra);
    const long long bb = __ldg(B.beg + rb);
    const int la = (int)(__ldg(A.end + ra) - ba);
    const int lb = (int)(__ldg(B.end + rb) - bb);
    if (lb < la) return PairRows{B.vals + bb, A.vals + ba, la};
    return PairRows{A.vals + ba, B.vals + bb, lb};
  }

  __device__ __forceinline__ bool rest(long long, int) const { return true; }
};

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
intersect_kernel(const __grid_constant__ Side A,
                 const __grid_constant__ Side B, long long n_pairs,
                 const long long* __restrict__ work_off,
                 long long* __restrict__ partials,
                 int* __restrict__ per_pair) {
  extern __shared__ __align__(16) int win[];
  __shared__ probe::TileShared S;
  __shared__ long long s_warp[kThreads / 32];
  const PairItems I{A, B, work_off, per_pair};
#ifdef INTERSECT_WARP_CHUNKS
  long long acc = probe::warp_chunks(I, n_pairs, __ldg(work_off + n_pairs),
                                     win);
#else
  long long acc = probe::count_tiles(I, n_pairs, __ldg(work_off + n_pairs),
                                     win, S, per_pair);
#endif
  acc = probe::warp_sum(acc);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    long long v = threadIdx.x < kThreads / 32 ? s_warp[threadIdx.x] : 0;
    v = probe::warp_sum(v);
    if (threadIdx.x == 0) partials[blockIdx.x] = v;
  }
}

// work_off[0] = 0 and work_off[1 + i] = min(d_a, d_b) of pair i
__global__ void __launch_bounds__(kThreads)
work_kernel(const Side A, const Side B, long long n_pairs,
            long long* __restrict__ work_off) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i == 0) work_off[0] = 0;
  if (i >= n_pairs) return;
  const long long ra = __ldg(A.pos + i);
  const long long rb = __ldg(B.pos + i);
  work_off[1 + i] = min(__ldg(A.end + ra) - __ldg(A.beg + ra),
                        __ldg(B.end + rb) - __ldg(B.beg + rb));
}

}  // namespace

extern "C" int intersect_n_partials() { return kBlocks; }

// work_off (n_pairs + 1 int64) <- 0, then each pair's work min(d_a, d_b);
// the caller scans work_off[1:] in place before intersect_launch
extern "C" int intersect_work_launch(const void* beg_a, const void* end_a,
                                     const void* pos_a, const void* beg_b,
                                     const void* end_b, const void* pos_b,
                                     long long n_pairs, void* work_off,
                                     void* stream) {
  if (n_pairs <= 0) return (int)cudaErrorInvalidValue;
  const Side A{(const long long*)beg_a, (const long long*)end_a, nullptr,
               (const long long*)pos_a};
  const Side B{(const long long*)beg_b, (const long long*)end_b, nullptr,
               (const long long*)pos_b};
  const long long blocks = (n_pairs + kThreads - 1) / kThreads;
  work_kernel<<<(unsigned int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      A, B, n_pairs, (long long*)work_off);
  return (int)cudaGetLastError();
}

// Side of each pair: (beg, end, vals, pos) per side as above; work_off has
// n_pairs + 1 entries, the exclusive scan of the pairs' work;
// partials has intersect_n_partials() entries; per_pair (int32, zeroed by
// the caller) may be null.
extern "C" int intersect_launch(const void* beg_a, const void* end_a,
                                const void* vals_a, const void* pos_a,
                                const void* beg_b, const void* end_b,
                                const void* vals_b, const void* pos_b,
                                long long n_pairs, const void* work_off,
                                void* partials, void* per_pair,
                                void* stream) {
  if (n_pairs <= 0) return (int)cudaErrorInvalidValue;
  const Side A{(const long long*)beg_a, (const long long*)end_a,
               (const int*)vals_a, (const long long*)pos_a};
  const Side B{(const long long*)beg_b, (const long long*)end_b,
               (const int*)vals_b, (const long long*)pos_b};
  intersect_kernel<<<kBlocks, kThreads, kSmem,
                     (cudaStream_t)stream>>>(
      A, B, n_pairs, (const long long*)work_off, (long long*)partials,
      (int*)per_pair);
  return (int)cudaGetLastError();
}
