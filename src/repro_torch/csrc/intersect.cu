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
//   entries). A fixed grid walks
//   tiles of that work space, grid-stride. The tile size is read from
//   work_off[n_pairs] on the device, so the host never reads a size: the
//   least multiple of kThreads probes that spreads the call over the grid,
//   at most kTileMax, so a small call still reaches every SM. A tile finds
//   its first and last pair by binary search in work_off. A hub pair thus
//   spans many blocks, and a run of small pairs shares one block.
// * One pair in the tile whose window fits (hub pairs over dense rows):
//   the block stages the window of the wide row that its narrow slice
//   [s, e) can hit, [lb(wide, narrow[s]), lb(wide, narrow[e-1]) + 1), into
//   shared memory with cp.async (16-byte copies for the aligned body,
//   4-byte at the edges). Each thread takes a contiguous run of tile /
//   kThreads probes, binary-searches the first in the window and gallops from hit
//   to hit (steps 1, 2, 4, ...): the dependent steps hit shared memory
//   (~30 cycles) instead of L2 or HBM (~300-600), and a probe costs
//   O(log gap) steps, not O(log window).
// * Tiles of many pairs (at least one a warp): warp w takes the tile's
//   pairs w, w + 8, ..., its lanes the pair's probes in the tile with
//   stride 32, as the warp-per-pair kernel this replaced did: the pair's
//   row lookups are warp-uniform loads and the lanes' searches share
//   their path down the wide row. Threads that each walk their own short
//   pairs scatter every load of a warp over 32 sectors, and lost to it
//   2-3x on boxes of short pairs.
// * Every other tile (a few pairs, or one pair whose window is wider than
//   the buffer): thread t takes the tile's probes t, t + kThreads,
//   ..., so the 32 lanes of a warp probe 32 consecutive values of one
//   narrow row. Each probe finds its pair by binary search in the tile's
//   range of work_off (only when it leaves the previous one) and
//   binary-searches the wide row in global memory from the thread's last
//   hit. The lanes' searches follow one path down the wide row until the
//   last few levels, so a warp's load is one or two sectors, as in the
//   warp-per-pair kernel this replaced; a thread running alone through
//   its own probes (runs with galloping) scatters the warp's loads over as
//   many sectors as lanes, and lost to it on mid-size pairs (about 1,000
//   probes into rows of up to 65,536 values).
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

namespace {

constexpr int kThreads = 256;
// probes per work tile, and the fixed grid that walks the tiles
constexpr long long kTileMax = 2048;
constexpr int kBlocks = 132 * 8;
// shared-memory window of the wide row, in int32 values (16 KB: with the
// kernel held to 32 registers a thread, eight blocks fit an SM; latency
// hiding matters more than wide windows), plus the up to three values of
// alignment padding in front of it; under the 48 KB a launch may take
// without opting in
constexpr int kWin = 4096;
constexpr int kWinBytes = (kWin + 4) * 4;

struct Side {
  const long long* beg;  // first value index of the row at each key position
  const long long* end;  // one past its last value index
  const int* vals;
  const long long* pos;  // key position of each pair's row
};

template <typename Index>
__device__ __forceinline__ Index lower_bound(const int* __restrict__ row,
                                             Index lo, Index hi, int x) {
  while (lo < hi) {
    const Index mid = (lo + hi) >> 1;
    if (row[mid] < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// lower_bound over a row in global memory, through the read-only cache
__device__ __forceinline__ int global_lower_bound(const int* __restrict__ row,
                                                  int lo, int hi, int x) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(row + mid) < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// the first index in [lo, hi) of a row in shared memory whose value is
// >= x, found by galloping from lo (steps 1, 2, 4, ... then a binary
// search): O(log gap) steps when consecutive probes land close together
__device__ __forceinline__ int shared_gallop(const int* row, int lo, int hi,
                                             int x) {
  int step = 1;
  int b = lo;
  while (true) {
    b = lo + step - 1;
    if (b >= hi) {
      b = hi;
      break;
    }
    if (row[b] >= x) break;
    lo = b + 1;
    step <<= 1;
  }
  return lower_bound<int>(row, lo, b, x);
}

// the pair p in [lo, hi) with work_off[p] <= g < work_off[p + 1]: the last
// p with work_off[p] <= g, which skips pairs without work
__device__ __forceinline__ long long pair_of(
    const long long* __restrict__ work_off, long long lo, long long hi,
    long long g) {
  while (hi - lo > 1) {
    const long long mid = (lo + hi) >> 1;
    if (__ldg(work_off + mid) <= g) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// a pair's rows, narrow (probed) and wide (searched); a row holds fewer
// than 2^31 values (its values are distinct int32 ids)
struct PairRows {
  const int* narrow;
  const int* wide;
  int n_wide;
};

__device__ __forceinline__ PairRows pair_rows(const Side& A, const Side& B,
                                              long long p) {
  const long long ra = __ldg(A.pos + p);
  const long long rb = __ldg(B.pos + p);
  const long long ba = __ldg(A.beg + ra);
  const long long bb = __ldg(B.beg + rb);
  const int la = (int)(__ldg(A.end + ra) - ba);
  const int lb = (int)(__ldg(B.end + rb) - bb);
  if (lb < la) return PairRows{B.vals + bb, A.vals + ba, la};
  return PairRows{A.vals + ba, B.vals + bb, lb};
}

__device__ __forceinline__ void cp_async4(int* smem, const int* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async16(int* smem, const int* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// copy src[0, n) into shared memory with cp.async; element i lands at
// win[pad + i], where pad (returned) puts the 16-byte-aligned body of src
// on a 16-byte boundary of win. Every thread of the block calls it.
__device__ int stage_window(int* win, const int* src, int n) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(src);
  int head = (int)(((16 - (addr & 15)) & 15) >> 2);
  if (head > n) head = n;
  const int pad = (4 - head) & 3;
  const int body = (n - head) >> 2;
  for (int i = threadIdx.x; i < head; i += kThreads) {
    cp_async4(win + pad + i, src + i);
  }
  for (int i = threadIdx.x; i < body; i += kThreads) {
    cp_async16(win + pad + head + 4 * i, src + head + 4 * i);
  }
  for (int i = head + 4 * body + threadIdx.x; i < n; i += kThreads) {
    cp_async4(win + pad + i, src + i);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  return pad;
}

__device__ __forceinline__ long long warp_sum(long long v) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// the probes [g0, g1) of a tile over pairs [p0, p1], thread t taking
// probes g0 + t, g0 + t + kThreads, ...: a warp probes consecutive values
// of a narrow row, and its binary searches in the wide row share their
// path (and their loads) down to the last few levels. A probe's search
// starts at the thread's last hit in the same pair, or at lo0 (the tile's
// window start when the tile is one pair, else 0).
__device__ __forceinline__ long long strided_probes(
    const Side& A, const Side& B, const long long* __restrict__ work_off,
    long long g0, long long g1, long long p0, long long p1, int lo0,
    int* __restrict__ per_pair) {
  long long cnt = 0;
  long long p = p0 - 1;     // the pair of the thread's last probe
  long long base = 0;       // its first probe, work_off[p]
  long long next = -1;      // the first probe of the pair after it
  PairRows pr{nullptr, nullptr, 0};
  int q = 0;                // the last hit's index in the wide row
  for (long long g = g0 + threadIdx.x; g < g1; g += kThreads) {
    if (g >= next) {        // a later pair: the last one starting <= g
      p = pair_of(work_off, max(p + 1, p0), p1 + 1, g);
      base = __ldg(work_off + p);
      next = __ldg(work_off + p + 1);
      pr = pair_rows(A, B, p);
      q = p0 == p1 ? lo0 : 0;
    }
    const int x = __ldg(pr.narrow + (g - base));
    q = global_lower_bound(pr.wide, q, pr.n_wide, x);
    if (q < pr.n_wide && __ldg(pr.wide + q) == x) {
      ++cnt;
      if (per_pair) atomicAdd(per_pair + p, 1);
    }
  }
  return cnt;
}

// the pairs [p0, p1] of a tile [g0, g1), warp w taking pairs p0 + w,
// p0 + w + 8, ... and its lanes a pair's probes in the tile with stride 32,
// each a binary search in the wide row from the lane's last hit
__device__ __forceinline__ long long warp_pairs(
    const Side& A, const Side& B, const long long* __restrict__ work_off,
    long long g0, long long g1, long long p0, long long p1,
    int* __restrict__ per_pair) {
  const int lane = threadIdx.x & 31;
  long long cnt = 0;
  for (long long p = p0 + (threadIdx.x >> 5); p <= p1; p += kThreads / 32) {
    const long long base = __ldg(work_off + p);
    const long long s = max(g0, base) - base;
    const long long e = min(g1, __ldg(work_off + p + 1)) - base;
    if (s >= e) continue;  // no work: the whole warp skips the pair
    const PairRows pr = pair_rows(A, B, p);
    int q = 0;
    long long c = 0;
    for (long long j = s + lane; j < e; j += 32) {
      const int x = __ldg(pr.narrow + j);
      q = global_lower_bound(pr.wide, q, pr.n_wide, x);
      c += (q < pr.n_wide && __ldg(pr.wide + q) == x) ? 1 : 0;
    }
    cnt += c;
    if (per_pair) {
      c = warp_sum(c);
      if (lane == 0 && c) atomicAdd(per_pair + p, (int)c);
    }
  }
  return cnt;
}

__global__ void __launch_bounds__(kThreads, 8)
intersect_kernel(const Side A, const Side B, long long n_pairs,
                 const long long* __restrict__ work_off,
                 long long* __restrict__ partials,
                 int* __restrict__ per_pair) {
  extern __shared__ __align__(16) int win[];
  __shared__ long long s_p[2];
  __shared__ int s_win[2];
  __shared__ long long s_warp[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const long long w_total = __ldg(work_off + n_pairs);
  // the least multiple of kThreads probes that spreads the work over the
  // grid, at most kTileMax
  const long long per_block = (w_total + gridDim.x - 1) / gridDim.x;
  const long long tile =
      min(kTileMax, max(1LL, (per_block + kThreads - 1) / kThreads) * kThreads);
  const long long run = tile / kThreads;
  const long long n_tiles = (w_total + tile - 1) / tile;
  long long acc = 0;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long g0 = t * tile;
    const long long g1 = min(w_total, g0 + tile);
    if (threadIdx.x == 0) s_p[0] = pair_of(work_off, 0, n_pairs, g0);
    if (threadIdx.x == 32) s_p[1] = pair_of(work_off, 0, n_pairs, g1 - 1);
    __syncthreads();
    const long long p0 = s_p[0];
    const long long p1 = s_p[1];
    int lo = 0;
    int n_win = kWin + 1;  // several pairs: no window
    if (p0 == p1) {
      // the window of the wide row that the tile's narrow slice can hit
      const PairRows pr = pair_rows(A, B, p0);
      const long long base = __ldg(work_off + p0);
      if (threadIdx.x == 0) {
        s_win[0] = global_lower_bound(pr.wide, 0, pr.n_wide,
                                      __ldg(pr.narrow + (g0 - base)));
      }
      if (threadIdx.x == 32) {
        s_win[1] = min(pr.n_wide,
                       global_lower_bound(pr.wide, 0, pr.n_wide,
                                          __ldg(pr.narrow + (g1 - 1 - base)))
                           + 1);
      }
      __syncthreads();
      lo = s_win[0];
      n_win = max(0, s_win[1] - lo);
    }
    long long cnt = 0;
    if (n_win <= kWin) {
      const PairRows pr = pair_rows(A, B, p0);
      const long long base = __ldg(work_off + p0);
      const int pad = stage_window(win, pr.wide + lo, n_win);
      __syncthreads();
      const int* w = win + pad;
      const long long j0 = g0 - base + (long long)threadIdx.x * run;
      const long long j1 = min(g1 - base, j0 + run);
      if (j0 < j1) {
        int q = lower_bound<int>(w, 0, n_win, __ldg(pr.narrow + j0));
        for (long long j = j0; j < j1; ++j) {
          const int x = __ldg(pr.narrow + j);
          q = shared_gallop(w, q, n_win, x);
          cnt += (q < n_win && w[q] == x) ? 1 : 0;
        }
      }
      if (per_pair) {
        const long long c = warp_sum(cnt);
        if (lane == 0 && c) atomicAdd(per_pair + p0, (int)c);
      }
    } else if (p1 - p0 + 1 >= kThreads / 32) {
      cnt = warp_pairs(A, B, work_off, g0, g1, p0, p1, per_pair);
    } else {
      cnt = strided_probes(A, B, work_off, g0, g1, p0, p1, lo, per_pair);
    }
    acc += cnt;
    __syncthreads();  // the tile's shared state is free for the next one
  }
  acc = warp_sum(acc);
  if (lane == 0) s_warp[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    long long v = threadIdx.x < kThreads / 32 ? s_warp[threadIdx.x] : 0;
    v = warp_sum(v);
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
  intersect_kernel<<<kBlocks, kThreads, kWinBytes, (cudaStream_t)stream>>>(
      A, B, n_pairs, (const long long*)work_off, (long long*)partials,
      (int*)per_pair);
  return (int)cudaGetLastError();
}
