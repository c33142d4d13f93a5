// Exact binding count of one box's join: the whole Leapfrog-Triejoin loop
// nest of a pattern of at most kMaxDepth variables, in one launch pair.
//
// Replaces the TPU kernel src/repro/kernels/lftj_fused/kernel.py
// (make_fused_count_kernel / build_fused_count), which stages every atom
// as a dense SENTINEL-padded (R, K) matrix split into two f32 halves,
// gathers rows by one-hot MXU products and tests membership by K lane
// rotations, because Mosaic has no vector gather. It generates one
// program per (pattern, padded shape) and walks depth-0 tiles in order.
//
// Here atoms stay in compact CSR in device memory: sorted int32 keys,
// int64 offsets, int32 values. A row lookup is a binary search of the key
// array; a membership test is a binary search of the wider row. No padded
// matrix exists. One compiled kernel serves every pattern: the wrapper
// passes a by-value descriptor (__grid_constant__) with n_vars, each
// atom's (first, second) variable as per-depth bit masks, its CSR
// pointers, and the constant row of every starts-only depth.
//
// What bounds it on this card: dependent probe steps. For the triangle
// pattern a pair (x, y) costs min(deg) * ceil(log2(max deg + 1)) probes
// whose every step waits on a load; the bytes of the touched CSR rows,
// read once, take far less time at 3.35 TB/s. So the design spreads the
// probes over as many threads as possible:
//
// * Work split. On skewed graphs one hub x owns tens of thousands of
//   depth-1 candidates, so a thread (or warp) per depth-0 row would leave
//   the card idle behind the hub. Pass 1 (one thread per depth-0 row)
//   writes the length of each row's depth-1 candidate source; the wrapper
//   turns that into an exclusive scan; pass 2 gives one thread to each
//   (depth-0 row, depth-1 slot) pair, grid-stride over a fixed grid, so
//   consecutive threads share a row and read it coalesced.
// * Each thread runs depths 2..n-1 as an explicit DFS with a cursor per
//   depth. At every depth the candidates are the narrowest of the bound
//   atoms' rows, probed into the others; rows are sets (the wrapper checks
//   it), so this is the same candidate set as the reference's first-atom
//   row. The innermost depth counts |intersection| with resumed searches:
//   the probes ascend, so each other row's search starts where the last
//   one ended (the min(d_x, d_y) accounting of Thm. 17).
// * Absent keys give empty rows, so a binding dies exactly where the
//   reference's SENTINEL-filled gather kills it (kernel.py:177-188).
// * Counts are int64 per thread and per block (the reference keeps int32
//   per depth-0 row, which a hub row of the triangle query can pass);
//   pass 2 writes one int64 partial per block and the wrapper sums them.
//   No atomics, so the sum is the same on every run.
//
// The kernels allocate nothing; the wrapper passes the outputs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxDepth = 6;
constexpr int kMaxAtoms = 16;
constexpr int kThreads = 256;
// pass 2's fixed grid (16 blocks per SM of an H100): one partial each
constexpr int kBlocks = 132 * 16;
constexpr int kDescWords = 2 + 6 * kMaxAtoms + 2 * kMaxDepth;

struct Atom {
  const int* keys;
  const long long* off;
  const int* vals;
  long long n_keys;
};

struct Desc {
  Atom atom[kMaxAtoms];
  const int* cst[kMaxDepth];        // constant row of a starts-only depth
  long long n_cst[kMaxDepth];
  unsigned first_mask[kMaxDepth];   // atoms whose first variable is d
  unsigned second_mask[kMaxDepth];  // atoms whose second variable is d
  int fd[kMaxAtoms];                // first variable of each atom
  int n_vars;
};

struct Row {
  const int* p;
  long long n;
};

__device__ __forceinline__ long long lower_bound(const int* __restrict__ a,
                                                 long long lo, long long hi,
                                                 int x) {
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (__ldg(a + mid) < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__device__ __forceinline__ Row lookup(const Atom& at, int v) {
  const long long i = lower_bound(at.keys, 0, at.n_keys, v);
  if (i < at.n_keys && __ldg(at.keys + i) == v) {
    const long long b = __ldg(at.off + i);
    return Row{at.vals + b, __ldg(at.off + i + 1) - b};
  }
  return Row{nullptr, 0};
}

// rows of the atoms whose first variable is bound at depth d to v
__device__ __forceinline__ void bind_rows(const Desc& D, int d, int v,
                                          Row* rows) {
  for (unsigned m = D.first_mask[d]; m; m &= m - 1) {
    const int a = __ffs(m) - 1;
    rows[a] = lookup(D.atom[a], v);
  }
}

// the candidate source at depth d: the narrowest bound row (lowest atom
// on ties), or the constant row of a starts-only depth (*which = -1)
__device__ __forceinline__ Row source_row(const Desc& D, int d,
                                          const Row* rows, int* which) {
  unsigned m = D.second_mask[d];
  if (!m) {
    *which = -1;
    return Row{D.cst[d], D.n_cst[d]};
  }
  int best = __ffs(m) - 1;
  for (m &= m - 1; m; m &= m - 1) {
    const int a = __ffs(m) - 1;
    if (rows[a].n < rows[best].n) best = a;
  }
  *which = best;
  return rows[best];
}

// v is in the row of every atom bound at depth d other than `skip`
__device__ __forceinline__ bool member_all(const Desc& D, int d,
                                           const Row* rows, int v,
                                           int skip) {
  for (unsigned m = D.second_mask[d]; m; m &= m - 1) {
    const int a = __ffs(m) - 1;
    if (a == skip) continue;
    const Row r = rows[a];
    const long long i = lower_bound(r.p, 0, r.n, v);
    if (i >= r.n || __ldg(r.p + i) != v) return false;
  }
  return true;
}

// |intersection of the rows of the atoms bound at the innermost depth d|
__device__ long long innermost(const Desc& D, int d, const Row* rows) {
  int src_a;
  const Row src = source_row(D, d, rows, &src_a);
  const unsigned others = D.second_mask[d] & ~(1u << src_a);
  if (src.n <= 0 || !others) return src.n > 0 ? src.n : 0;
  long long lo[kMaxAtoms];
  for (unsigned m = others; m; m &= m - 1) lo[__ffs(m) - 1] = 0;
  long long cnt = 0;
  for (long long i = 0; i < src.n; ++i) {
    const int v = __ldg(src.p + i);
    bool hit = true;
    for (unsigned m = others; m; m &= m - 1) {
      const int a = __ffs(m) - 1;
      const Row r = rows[a];
      const long long p = lower_bound(r.p, lo[a], r.n, v);
      lo[a] = p;
      if (p >= r.n) return cnt;  // no larger value left in this row
      if (__ldg(r.p + p) != v) {
        hit = false;
        break;
      }
    }
    cnt += hit ? 1 : 0;
  }
  return cnt;
}

// bindings below one (depth-0 value, depth-1 slot) pair
__device__ long long count_pair(const Desc& D, int v0, long long slot) {
  Row rows[kMaxAtoms];
  bind_rows(D, 0, v0, rows);
  int src_a;
  const Row src = source_row(D, 1, rows, &src_a);
  const int v1 = __ldg(src.p + slot);
  if (!member_all(D, 1, rows, v1, src_a)) return 0;
  const int last = D.n_vars - 1;
  if (last == 1) return 1;
  bind_rows(D, 1, v1, rows);
  if (last == 2) return innermost(D, 2, rows);
  // depths 2..last-1 as an explicit DFS, one cursor per depth
  const int* it_p[kMaxDepth];
  long long it_n[kMaxDepth];
  long long cur[kMaxDepth];
  int it_a[kMaxDepth];
  long long cnt = 0;
  int d = 2;
  {
    const Row s = source_row(D, d, rows, &it_a[d]);
    it_p[d] = s.p;
    it_n[d] = s.n;
    cur[d] = 0;
  }
  while (true) {
    if (cur[d] >= it_n[d]) {
      if (d == 2) break;
      --d;
      continue;
    }
    const int v = __ldg(it_p[d] + cur[d]);
    ++cur[d];
    if (!member_all(D, d, rows, v, it_a[d])) continue;
    bind_rows(D, d, v, rows);
    if (d + 1 == last) {
      cnt += innermost(D, last, rows);
      continue;
    }
    ++d;
    const Row s = source_row(D, d, rows, &it_a[d]);
    it_p[d] = s.p;
    it_n[d] = s.n;
    cur[d] = 0;
  }
  return cnt;
}

// pass 1: the depth-1 candidate source length of every depth-0 row
__global__ void __launch_bounds__(kThreads)
rows_kernel(const __grid_constant__ Desc D, const int* __restrict__ c0,
            long long n_rows, long long* __restrict__ row_len) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  Row rows[kMaxAtoms];
  bind_rows(D, 0, __ldg(c0 + r), rows);
  int which;
  const Row src = source_row(D, 1, rows, &which);
  row_len[r] = src.n > 0 ? src.n : 0;
}

// pass 2: one thread per (depth-0 row, depth-1 slot) pair, grid-stride;
// pair_off is the exclusive scan of pass 1 (n_rows + 1 entries)
__global__ void __launch_bounds__(kThreads)
count_kernel(const __grid_constant__ Desc D, const int* __restrict__ c0,
             long long n_rows, const long long* __restrict__ pair_off,
             long long* __restrict__ partials) {
  const long long n_pairs = __ldg(pair_off + n_rows);
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long acc = 0;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       p < n_pairs; p += stride) {
    // the row r with pair_off[r] <= p < pair_off[r + 1]
    long long lo = 0, hi = n_rows;
    while (hi - lo > 1) {
      const long long mid = (lo + hi) >> 1;
      if (__ldg(pair_off + mid) <= p) {
        lo = mid;
      } else {
        hi = mid;
      }
    }
    acc += count_pair(D, __ldg(c0 + lo), p - __ldg(pair_off + lo));
  }
  __shared__ long long warp_sum[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  }
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    long long s = threadIdx.x < kThreads / 32 ? warp_sum[threadIdx.x] : 0;
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_down_sync(0xffffffffu, s, off);
    }
    if (threadIdx.x == 0) partials[blockIdx.x] = s;
  }
}

// ---------------------------------------------------------------------------
// Listing: the same loop nest, emitting bindings in the reference order,
// in one cooperative launch with one host read per call.
//
// Replaces build_fused_list (src/repro/kernels/lftj_fused/kernel.py:264),
// an XLA program that walks the candidate slots of depths 1..n-2 for all
// depth-0 rows at once and flattens the innermost (T, K) block row-major:
// its bindings come in lexicographic order of (slot_1, ..., slot_{n-2},
// depth-0 row, innermost slot), where slot_d is the position within the
// row of the first atom bound at depth d (or within the constant row of a
// starts-only depth).
//
// What bounds it on this card: not bytes (a call writes a few MB at most)
// but the chain of dependent stages. The TPU program's compiled shapes
// forced a host round trip for every array size; here every stage reads
// its extents from device memory, so the host launches once and reads
// once. list_kernel is a persistent cooperative kernel (every block
// co-resident, cooperative_groups grid syncs between stages) over a
// workspace the wrapper keeps per device:
//
// 1. expansion, depth d = 1..n-2, frontier F_d in (depth-0 row, slot_1,
//    ..., slot_{d-1}) order: each entry's candidate source length (the
//    narrowest bound row, or the constant row) and a device-wide scan give
//    pair_off; each block takes a contiguous chunk of the (entry,
//    candidate) pairs, counts the live ones (membership in the other bound
//    rows), the block counts are scanned, and each block writes its live
//    pairs in order (a block scan of live flags per 256 pairs) as F_{d+1},
//    with the candidate's slot in the first atom's row. Liveness is
//    computed twice rather than stored per pair.
// 2. the innermost depth, split the same way: a scan of the prefixes'
//    innermost source lengths places their (prefix, candidate) pairs, a
//    thread per pair tests membership, and a device-wide scan of the live
//    flags gives every prefix its binding count and every binding its rank
//    within its prefix; also the largest slot of every depth;
// 3. ordering: the prefixes are unique by (slot_1, ..., slot_{n-2},
//    frontier index), and the frontier index rises with the depth-0 row,
//    so a stable LSD radix sort of the frontier indices by slot_{n-2},
//    then ..., then slot_1 (8-bit digits, per-block histograms in shared
//    memory, a scan of the digit-major histogram, stable ranks by warp
//    match) gives the reference order. Digits above a depth's largest slot
//    are skipped;
// 4. a scan of the counts in that order gives each prefix its first
//    output row and the exact int64 total; the rows buffer, min(total,
//    capacity) rows, is taken from the workspace;
// 5. a thread per live pair whose row (its prefix's first row plus its
//    rank) is below the capacity writes it: within a prefix the innermost
//    values ascend (rows are sets, so that is the first atom's slot
//    order).
//
// Scratch: a device-side bump pointer in the workspace header. A stage
// whose allocation would pass the end sets the overflow word; every block
// sees it after the next grid sync and the stages stop. Then a sizing pass
// (a warp per depth-0 row, depth first, as the count kernel walks) counts
// every frontier's size, the innermost pairs and the total, and the words
// the whole call needs are computed from them with the same arithmetic
// the stages allocate by, so one regrowth and one rerun always suffice. Header (int64 words, read
// by the wrapper in one copy): bump, overflow, need, total, rows_at,
// rows. Frontier values are int32 arrays of one row per depth (vals[j * n
// + i] is entry i's depth-j value), slots likewise. Workspace arrays are
// written inside the launch, so they are read with plain loads (never
// __ldg); the atoms and the depth-0 frontier are read-only.

constexpr int kWarps = kThreads / 32;
// grid bound of the listing kernel: the block-sum scan runs in one block
constexpr int kMaxListBlocks = 1024;
constexpr int kDigits = 256;

enum : int {
  kHBump = 0,
  kHOverflow = 1,
  kHNeed = 2,
  kHTotal = 3,
  kHRowsAt = 4,
  kHRows = 5,
  kHAt = 6,                     // word offsets passed between stages
  kHAt2 = 7,
  kHMaxSlot = 8,                // one word per depth
  kHSizeN = kHMaxSlot + kMaxDepth,  // frontier sizes from the sizing pass
  kHSizeTotal = kHSizeN + kMaxDepth + 1,
  kHSizePairs = kHSizeTotal + 1,  // innermost pairs, from the sizing pass
  kHeader = 32,
};

__host__ __device__ __forceinline__ long long words64(long long n) {
  return (n + 1) & ~1LL;
}

__host__ __device__ __forceinline__ long long words32(long long n) {
  return words64((n + 1) >> 1);
}

// the fixed part of the workspace: header, block sums (grid + 2 words) and
// the digit-major radix histogram (kDigits words per block)
__host__ __device__ __forceinline__ long long list_base_words(int grid) {
  return kHeader + words64(grid + 2) + (long long)kDigits * grid;
}

struct ListArgs {
  long long* ws;
  long long ws_words;
  const int* c0;
  long long n0;
  long long cap;
};

// rows of the atoms bound at depth d for frontier entry i (workspace
// frontier: plain loads)
__device__ __forceinline__ void frontier_rows(const Desc& D, int d,
                                              const int* vals, long long n,
                                              long long i, Row* rows) {
  for (unsigned m = D.second_mask[d]; m; m &= m - 1) {
    const int a = __ffs(m) - 1;
    rows[a] = lookup(D.atom[a], vals[(long long)D.fd[a] * n + i]);
  }
}

// exclusive scan of v over the block; *total gets the block's sum
__device__ long long block_scan(long long v, long long* total) {
  __shared__ long long s_warp[kWarps + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long long x = v;
  for (int off = 1; off < 32; off <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const long long w = lane < kWarps ? s_warp[lane] : 0;
    long long z = w;
    for (int off = 1; off < 32; off <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, z, off);
      if (lane >= off) z += y;
    }
    if (lane < kWarps) s_warp[lane] = z - w;
    if (lane == kWarps - 1) s_warp[kWarps] = z;
  }
  __syncthreads();
  const long long out = s_warp[warp] + x - v;
  *total = s_warp[kWarps];
  __syncthreads();
  return out;
}

// [lo, hi) of block b's contiguous chunk of n items
__device__ __forceinline__ void block_chunk(long long n, long long* lo,
                                            long long* hi) {
  const long long c = (n + gridDim.x - 1) / gridDim.x;
  *lo = min(n, (long long)blockIdx.x * c);
  *hi = min(n, *lo + c);
}

// block 0: exclusive scan of sums[0, n) in place, the total at sums[n]
__device__ void scan_block_sums(long long* sums, int n) {
  long long carry = 0;
  for (int base = 0; base < n; base += kThreads) {
    const int i = base + threadIdx.x;
    const long long v = i < n ? sums[i] : 0;
    long long round;
    const long long x = block_scan(v, &round);
    if (i < n) sums[i] = carry + x;
    carry += round;
  }
  if (threadIdx.x == 0) sums[n] = carry;
  __syncthreads();
}

// device-wide exclusive scan of n values src[idx[i]] (or src[i] when idx is
// null) into dst[i] (dst may be src when idx is null); the total lands in
// sums[gridDim.x]. Every thread of the grid calls it; ends synchronised.
__device__ void grid_scan(cg::grid_group& g, const long long* src,
                          const long long* idx, long long* dst, long long n,
                          long long* sums) {
  long long lo, hi, total;
  block_chunk(n, &lo, &hi);
  long long s = 0;
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
    s += src[idx ? idx[i] : i];
  }
  block_scan(s, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
  g.sync();
  if (blockIdx.x == 0) scan_block_sums(sums, gridDim.x);
  g.sync();
  long long carry = sums[blockIdx.x];
  for (long long base = lo; base < hi; base += kThreads) {
    const long long i = base + threadIdx.x;
    const long long v = i < hi ? src[idx ? idx[i] : i] : 0;
    const long long x = block_scan(v, &total);
    if (i < hi) dst[i] = carry + x;
    carry += total;
  }
  g.sync();
}

// one thread of the grid: take `words` from the workspace, or set the
// overflow word; returns the word offset, or -1
__device__ long long take(long long* H, long long ws_words, long long words) {
  if (H[kHOverflow]) return -1;
  const long long at = H[kHBump];
  if (at + words > ws_words) {
    H[kHOverflow] = 1;
    return -1;
  }
  H[kHBump] = at + words;
  return at;
}

__device__ __forceinline__ bool overflowed(const long long* H) {
  return *(volatile const long long*)(H + kHOverflow) != 0;
}

__device__ __forceinline__ bool is_first_thread() {
  return blockIdx.x == 0 && threadIdx.x == 0;
}

// the frontier a stage reads: n entries, depth-j values at vals[j * n + i]
// and depth-j slots at slots[(j - 1) * n + i]
struct Frontier {
  const int* vals;
  const int* slots;
  long long n;
};

// pair p = (entry e, candidate k) of depth d: whether it is live, and its
// value and slot (position in the first bound atom's row)
__device__ __forceinline__ bool expand_pair(const Desc& D, int d,
                                            const Frontier& F,
                                            const long long* pair_off,
                                            long long p, long long* e_out,
                                            int* v_out, long long* slot_out) {
  long long lo = 0, hi = F.n;
  while (hi - lo > 1) {
    const long long mid = (lo + hi) >> 1;
    if (pair_off[mid] <= p) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  const long long e = lo;
  const long long k = p - pair_off[e];
  Row rows[kMaxAtoms];
  frontier_rows(D, d, F.vals, F.n, e, rows);
  int src_a;
  const Row src = source_row(D, d, rows, &src_a);
  const int v = __ldg(src.p + k);
  long long slot = k;  // a starts-only depth: the constant row's slot
  if (src_a >= 0) {
    const int first = __ffs(D.second_mask[d]) - 1;
    for (unsigned m = D.second_mask[d]; m; m &= m - 1) {
      const int a = __ffs(m) - 1;
      if (a == src_a) continue;
      const Row r = rows[a];
      const long long q = lower_bound(r.p, 0, r.n, v);
      if (q >= r.n || __ldg(r.p + q) != v) return false;
      if (a == first) slot = q;
    }
  }
  *e_out = e;
  *v_out = v;
  *slot_out = slot;
  return true;
}

// depth d's expansion of F into the next frontier; false on overflow
__device__ bool expand_depth(cg::grid_group& g, const Desc& D,
                             const ListArgs& A, long long* sums, int d,
                             Frontier* F) {
  long long* H = A.ws;
  if (is_first_thread()) {
    H[kHAt] = take(H, A.ws_words, words64(F->n + 1));  // pair_off
  }
  g.sync();
  if (overflowed(H)) return false;
  long long* pair_off = H + H[kHAt];
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < F->n; i += (long long)gridDim.x * kThreads) {
    Row rows[kMaxAtoms];
    frontier_rows(D, d, F->vals, F->n, i, rows);
    int which;
    const Row src = source_row(D, d, rows, &which);
    pair_off[i] = src.n > 0 ? src.n : 0;
  }
  g.sync();
  grid_scan(g, pair_off, nullptr, pair_off, F->n, sums);
  const long long n_pairs = sums[gridDim.x];
  long long lo, hi, total;
  block_chunk(n_pairs, &lo, &hi);
  long long live = 0;
  for (long long p = lo + threadIdx.x; p < hi; p += kThreads) {
    long long e, slot;
    int v;
    live += expand_pair(D, d, *F, pair_off, p, &e, &v, &slot) ? 1 : 0;
  }
  block_scan(live, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
  g.sync();
  if (blockIdx.x == 0) {
    scan_block_sums(sums, gridDim.x);
    if (threadIdx.x == 0) {
      const long long nn = sums[gridDim.x];
      H[kHAt] = take(H, A.ws_words, words32((d + 1) * nn));
      H[kHAt2] = take(H, A.ws_words, words32(d * nn));
    }
  }
  g.sync();
  if (overflowed(H)) return false;
  const long long nn = sums[gridDim.x];
  int* next_vals = reinterpret_cast<int*>(H + H[kHAt]);
  int* next_slots = reinterpret_cast<int*>(H + H[kHAt2]);
  long long carry = sums[blockIdx.x];
  for (long long base = lo; base < hi; base += kThreads) {
    const long long p = base + threadIdx.x;
    long long e = 0, slot = 0;
    int v = 0;
    const bool ok = p < hi && expand_pair(D, d, *F, pair_off, p, &e, &v,
                                          &slot);
    const long long o = carry + block_scan(ok ? 1 : 0, &total);
    carry += total;
    if (!ok) continue;
    for (int j = 0; j < d; ++j) {
      next_vals[(long long)j * nn + o] = F->vals[(long long)j * F->n + e];
    }
    next_vals[(long long)d * nn + o] = v;
    for (int j = 0; j + 1 < d; ++j) {
      next_slots[(long long)j * nn + o] = F->slots[(long long)j * F->n + e];
    }
    next_slots[(long long)(d - 1) * nn + o] = (int)slot;
  }
  g.sync();
  *F = Frontier{next_vals, next_slots, nn};
  return true;
}

// one stable LSD pass over the 8-bit digit of slot row `key` at `shift`:
// src -> dst (m frontier indices)
__device__ void radix_pass(cg::grid_group& g, const int* key,
                           const long long* src, long long* dst, long long m,
                           int shift, long long* hist, long long* sums) {
  __shared__ int s_hist[kDigits];
  __shared__ int s_cnt[kWarps][kDigits + 1];
  __shared__ long long s_run[kDigits];
  long long lo, hi;
  block_chunk(m, &lo, &hi);
  for (int t = threadIdx.x; t < kDigits; t += kThreads) s_hist[t] = 0;
  __syncthreads();
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
    atomicAdd(&s_hist[(key[src[i]] >> shift) & (kDigits - 1)], 1);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < kDigits; t += kThreads) {
    hist[(long long)t * gridDim.x + blockIdx.x] = s_hist[t];
  }
  g.sync();
  grid_scan(g, hist, nullptr, hist, (long long)kDigits * gridDim.x, sums);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int t = threadIdx.x; t < kDigits; t += kThreads) {
    s_run[t] = hist[(long long)t * gridDim.x + blockIdx.x];
  }
  for (int t = threadIdx.x; t < kWarps * (kDigits + 1); t += kThreads) {
    s_cnt[t / (kDigits + 1)][t % (kDigits + 1)] = 0;
  }
  __syncthreads();
  for (long long base = lo; base < hi; base += kThreads) {
    const long long i = base + threadIdx.x;
    const long long x = i < hi ? src[i] : 0;
    const int dig = i < hi ? (key[x] >> shift) & (kDigits - 1) : kDigits;
    const unsigned peers = __match_any_sync(0xffffffffu, dig);
    const int wrank = __popc(peers & ((1u << lane) - 1));
    if (wrank == 0) s_cnt[warp][dig] = __popc(peers);
    __syncthreads();
    if (i < hi) {
      long long rank = s_run[dig] + wrank;
      for (int w = 0; w < warp; ++w) rank += s_cnt[w][dig];
      dst[rank] = x;
    }
    __syncthreads();
    for (int t = threadIdx.x; t < kDigits; t += kThreads) {
      long long c = 0;
      for (int w = 0; w < kWarps; ++w) {
        c += s_cnt[w][t];
        s_cnt[w][t] = 0;
      }
      s_run[t] += c;
    }
    __syncthreads();
  }
  g.sync();
}

// the entry e of frontier F whose innermost pairs [pair_off[e],
// pair_off[e + 1]) hold pair p (pair_off: plain loads)
__device__ __forceinline__ long long entry_of(const long long* pair_off,
                                              long long n, long long p) {
  long long lo = 0, hi = n;
  while (hi - lo > 1) {
    const long long mid = (lo + hi) >> 1;
    if (pair_off[mid] <= p) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// innermost pair p = (entry e, candidate k) of the last frontier: its
// value, and whether it is in every other bound row
__device__ __forceinline__ bool innermost_pair(const Desc& D,
                                               const Frontier& F,
                                               long long e, long long k,
                                               int* v_out) {
  const int last = D.n_vars - 1;
  Row rows[kMaxAtoms];
  frontier_rows(D, last, F.vals, F.n, e, rows);
  int src_a;
  const Row src = source_row(D, last, rows, &src_a);
  const int v = __ldg(src.p + k);
  *v_out = v;
  return member_all(D, last, rows, v, src_a);
}

// stages 1-5; false when the workspace overflowed. The innermost depth is
// split like an expansion, a thread per (prefix, candidate) pair: a
// prefix's bindings are its live pairs, so one prefix with a long row does
// not hold up the grid.
__device__ bool list_stages(cg::grid_group& g, const Desc& D,
                            const ListArgs& A, long long* sums,
                            long long* hist) {
  long long* H = A.ws;
  const int last = D.n_vars - 1;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  Frontier F{A.c0, nullptr, A.n0};
  for (int d = 1; d < last; ++d) {
    if (!expand_depth(g, D, A, sums, d, &F)) return false;
  }
  const long long m = F.n;
  if (is_first_thread()) H[kHAt] = take(H, A.ws_words, words64(m + 1));
  g.sync();
  if (overflowed(H)) return false;
  long long* pair_off = H + H[kHAt];
  for (long long e = tid; e < m; e += stride) {
    Row rows[kMaxAtoms];
    frontier_rows(D, last, F.vals, m, e, rows);
    int which;
    const Row src = source_row(D, last, rows, &which);
    pair_off[e] = src.n > 0 ? src.n : 0;
  }
  g.sync();
  grid_scan(g, pair_off, nullptr, pair_off, m, sums);
  const long long n_pairs = sums[gridDim.x];
  if (is_first_thread()) {
    pair_off[m] = n_pairs;
    H[kHAt] = take(H, A.ws_words, words64(n_pairs + 1));
    H[kHAt2] = take(H, A.ws_words, 5 * words64(m));
  }
  g.sync();
  if (overflowed(H)) return false;
  // live[p]: 1 for a binding, then its exclusive scan over the pairs
  long long* live = H + H[kHAt];
  long long* counts = H + H[kHAt2];
  long long* order[2] = {counts + words64(m), counts + 2 * words64(m)};
  long long* offsets = counts + 3 * words64(m);
  long long* start = counts + 4 * words64(m);
  for (long long p = tid; p < n_pairs; p += stride) {
    const long long e = entry_of(pair_off, m, p);
    int v;
    live[p] = innermost_pair(D, F, e, p - pair_off[e], &v) ? 1 : 0;
  }
  unsigned max_slot[kMaxDepth] = {};
  for (long long e = tid; e < m; e += stride) {
    order[0][e] = e;
    for (int j = 0; j + 1 < last; ++j) {
      max_slot[j] = max(max_slot[j],
                        (unsigned)F.slots[(long long)j * m + e]);
    }
  }
  for (int j = 0; j + 1 < last; ++j) {
    const unsigned s = __reduce_max_sync(0xffffffffu, max_slot[j]);
    if ((threadIdx.x & 31) == 0 && s) {
      atomicMax(reinterpret_cast<unsigned long long*>(H + kHMaxSlot + j),
                (unsigned long long)s);
    }
  }
  g.sync();
  grid_scan(g, live, nullptr, live, n_pairs, sums);
  if (is_first_thread()) live[n_pairs] = sums[gridDim.x];
  g.sync();
  for (long long e = tid; e < m; e += stride) {
    counts[e] = live[pair_off[e + 1]] - live[pair_off[e]];
  }
  g.sync();
  int cur = 0;
  for (int j = last - 2; j >= 0; --j) {
    const long long top = H[kHMaxSlot + j];
    for (int shift = 0; shift < 32 && (top >> shift) != 0; shift += 8) {
      radix_pass(g, F.slots + (long long)j * m, order[cur], order[cur ^ 1],
                 m, shift, hist, sums);
      cur ^= 1;
    }
  }
  grid_scan(g, counts, order[cur], offsets, m, sums);
  for (long long i = tid; i < m; i += stride) start[order[cur][i]] = offsets[i];
  if (is_first_thread()) {
    const long long total = sums[gridDim.x];
    const long long rows = min(total, A.cap);
    H[kHTotal] = total;
    H[kHRows] = rows;
    H[kHRowsAt] = take(H, A.ws_words, words32(rows * D.n_vars));
  }
  g.sync();
  if (overflowed(H)) return false;
  int* out = reinterpret_cast<int*>(H + H[kHRowsAt]);
  for (long long p = tid; p < n_pairs; p += stride) {
    if (live[p + 1] == live[p]) continue;
    const long long e = entry_of(pair_off, m, p);
    const long long o = start[e] + live[p] - live[pair_off[e]];
    if (o >= A.cap) continue;
    int v;
    innermost_pair(D, F, e, p - pair_off[e], &v);
    int* row = out + o * D.n_vars;
    for (int j = 0; j < last; ++j) row[j] = F.vals[(long long)j * m + e];
    row[last] = v;
  }
  if (is_first_thread()) H[kHNeed] = H[kHBump];
  return true;
}

// a prefix of the last frontier, found by the sizing pass: its innermost
// pairs and bindings
__device__ __forceinline__ void size_prefix(const Desc& D, const Row* rows,
                                            long long* pairs,
                                            long long* total) {
  const int last = D.n_vars - 1;
  int which;
  const Row src = source_row(D, last, rows, &which);
  *pairs += src.n > 0 ? src.n : 0;
  *total += innermost(D, last, rows);
}

// sizing pass after an overflow: for depth-0 row r, the live prefixes of
// every depth (size[d + 1] counts the entries of frontier F_{d + 1}), the
// innermost pairs and the bindings below them, depth first, this lane's
// share of the depth-1 candidates (k = lane, lane + 32, ...)
__device__ void size_row(const Desc& D, int v0, int lane, long long* size,
                         long long* pairs, long long* total) {
  const int last = D.n_vars - 1;
  Row rows[kMaxAtoms];
  bind_rows(D, 0, v0, rows);
  if (last == 1) {
    if (lane == 0) size_prefix(D, rows, pairs, total);
    return;
  }
  int src_a;
  const Row src1 = source_row(D, 1, rows, &src_a);
  const int* it_p[kMaxDepth];
  long long it_n[kMaxDepth];
  long long cur[kMaxDepth];
  int it_a[kMaxDepth];
  for (long long k = lane; k < src1.n; k += 32) {
    const int v1 = __ldg(src1.p + k);
    if (!member_all(D, 1, rows, v1, src_a)) continue;
    ++size[2];
    bind_rows(D, 1, v1, rows);
    if (last == 2) {
      size_prefix(D, rows, pairs, total);
      continue;
    }
    int d = 2;
    {
      const Row s = source_row(D, d, rows, &it_a[d]);
      it_p[d] = s.p;
      it_n[d] = s.n;
      cur[d] = 0;
    }
    while (true) {
      if (cur[d] >= it_n[d]) {
        if (d == 2) break;
        --d;
        continue;
      }
      const int v = __ldg(it_p[d] + cur[d]);
      ++cur[d];
      if (!member_all(D, d, rows, v, it_a[d])) continue;
      ++size[d + 1];
      bind_rows(D, d, v, rows);
      if (d + 1 == last) {
        size_prefix(D, rows, pairs, total);
        continue;
      }
      ++d;
      const Row s = source_row(D, d, rows, &it_a[d]);
      it_p[d] = s.p;
      it_n[d] = s.n;
      cur[d] = 0;
    }
  }
}

__device__ __forceinline__ void warp_add(long long v, long long* to) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  if ((threadIdx.x & 31) == 0 && v) {
    atomicAdd(reinterpret_cast<unsigned long long*>(to),
              (unsigned long long)v);
  }
}

__device__ void size_call(cg::grid_group& g, const Desc& D,
                          const ListArgs& A) {
  long long* H = A.ws;
  long long size[kMaxDepth + 1];
  for (int d = 0; d <= kMaxDepth; ++d) size[d] = 0;
  long long pairs = 0, total = 0;
  const long long warp = ((long long)blockIdx.x * kThreads + threadIdx.x)
      >> 5;
  const long long n_warps = (long long)gridDim.x * kWarps;
  for (long long r = warp; r < A.n0; r += n_warps) {
    size_row(D, __ldg(A.c0 + r), threadIdx.x & 31, size, &pairs, &total);
  }
  for (int d = 2; d <= D.n_vars - 1; ++d) warp_add(size[d], H + kHSizeN + d);
  warp_add(pairs, H + kHSizePairs);
  warp_add(total, H + kHSizeTotal);
  g.sync();
  if (is_first_thread()) {
    // the words list_stages takes, in its order
    const int last = D.n_vars - 1;
    long long need = list_base_words(gridDim.x);
    long long n = A.n0;
    for (int d = 1; d < last; ++d) {
      const long long nn = H[kHSizeN + d + 1];
      need += words64(n + 1) + words32((d + 1) * nn) + words32(d * nn);
      n = nn;
    }
    const long long total_all = H[kHSizeTotal];
    need += words64(n + 1) + words64(H[kHSizePairs] + 1) + 5 * words64(n)
        + words32(min(total_all, A.cap) * D.n_vars);
    H[kHNeed] = need;
    H[kHTotal] = total_all;
  }
}

__global__ void __launch_bounds__(kThreads)
list_kernel(const __grid_constant__ Desc D, const ListArgs A) {
  cg::grid_group g = cg::this_grid();
  long long* H = A.ws;
  long long* sums = H + kHeader;
  long long* hist = sums + words64(gridDim.x + 2);
  if (is_first_thread()) {
    for (int i = 0; i < kHeader; ++i) H[i] = 0;
    H[kHBump] = list_base_words(gridDim.x);
  }
  g.sync();
  if (!list_stages(g, D, A, sums, hist)) {
    g.sync();
    size_call(g, D, A);
  }
}

// descriptor words (ops.py _descriptor): n_vars, n_atoms, per atom (fd,
// sd, keys, off, vals, n_keys), per depth (const row, its length)
bool make_desc(const long long* w, Desc* D) {
  const int n_vars = (int)w[0];
  const int n_atoms = (int)w[1];
  if (n_vars < 2 || n_vars > kMaxDepth || n_atoms < 1 ||
      n_atoms > kMaxAtoms) {
    return false;
  }
  *D = Desc{};
  D->n_vars = n_vars;
  for (int a = 0; a < n_atoms; ++a) {
    const long long* e = w + 2 + 6 * a;
    const int fd = (int)e[0];
    const int sd = (int)e[1];
    if (fd < 0 || fd >= sd || sd >= n_vars) return false;
    D->atom[a] = Atom{(const int*)e[2], (const long long*)e[3],
                      (const int*)e[4], e[5]};
    D->fd[a] = fd;
    D->first_mask[fd] |= 1u << a;
    D->second_mask[sd] |= 1u << a;
  }
  if (!D->second_mask[n_vars - 1]) return false;  // innermost unbound
  const long long* c = w + 2 + 6 * kMaxAtoms;
  for (int d = 0; d < kMaxDepth; ++d) {
    D->cst[d] = (const int*)c[2 * d];
    D->n_cst[d] = c[2 * d + 1];
  }
  return true;
}

}  // namespace

extern "C" int lftj_fused_desc_words() { return kDescWords; }

extern "C" int lftj_fused_n_partials() { return kBlocks; }

extern "C" int lftj_fused_rows_launch(const long long* desc, const void* c0,
                                      long long n_rows, void* row_len,
                                      void* stream) {
  Desc D;
  if (!make_desc(desc, &D)) return (int)cudaErrorInvalidValue;
  if (n_rows <= 0) return 0;
  const long long blocks = (n_rows + kThreads - 1) / kThreads;
  rows_kernel<<<(unsigned int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      D, (const int*)c0, n_rows, (long long*)row_len);
  return (int)cudaGetLastError();
}

extern "C" int lftj_fused_count_launch(const long long* desc, const void* c0,
                                       long long n_rows, const void* pair_off,
                                       void* partials, void* stream) {
  Desc D;
  if (!make_desc(desc, &D)) return (int)cudaErrorInvalidValue;
  count_kernel<<<kBlocks, kThreads, 0, (cudaStream_t)stream>>>(
      D, (const int*)c0, n_rows, (const long long*)pair_off,
      (long long*)partials);
  return (int)cudaGetLastError();
}

// The listing kernel's grid: every block co-resident, as the cooperative
// launch needs; raises (returns an error) when the card cannot launch
// cooperatively.
extern "C" int lftj_list_grid(int* grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int coop = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, list_kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  *grid = per_sm * sms < kMaxListBlocks ? per_sm * sms : kMaxListBlocks;
  return 0;
}

extern "C" long long lftj_list_base_words(int grid) {
  return list_base_words(grid);
}

extern "C" int lftj_list_header_words() { return kHeader; }

// One listing call: the workspace ws (ws_words int64 words, at least
// lftj_list_base_words(grid)) receives the header (bump, overflow, need,
// total, rows_at, rows) and, unless it overflowed, the rows.
extern "C" int lftj_list_launch(const long long* desc, const void* c0,
                                long long n0, void* ws, long long ws_words,
                                long long cap, int grid, void* stream) {
  Desc D;
  if (!make_desc(desc, &D) || grid < 1 || grid > kMaxListBlocks ||
      ws_words < list_base_words(grid) || n0 < 0 || cap < 1) {
    return (int)cudaErrorInvalidValue;
  }
  ListArgs A{(long long*)ws, ws_words, (const int*)c0, n0, cap};
  void* args[] = {&D, &A};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)list_kernel, dim3(grid), dim3(kThreads), args, 0,
      (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
