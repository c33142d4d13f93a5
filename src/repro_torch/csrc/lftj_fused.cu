// Exact binding count and bounded listing of one box's join: the whole
// Leapfrog-Triejoin loop nest of a pattern of at most kMaxDepth variables;
// the count in a cooperative launch and a tile launch, the listing in one
// cooperative launch.
//
// Count. Replaces the TPU kernel src/repro/kernels/lftj_fused/kernel.py
// (make_fused_count_kernel :110 / build_fused_count :198, pallas_call
// :230), which stages every atom as a dense SENTINEL-padded (R, K) matrix
// split into two f32 halves, gathers rows by one-hot MXU products and
// tests membership by K lane rotations, because Mosaic has no vector
// gather. It generates one program per (pattern, padded shape) and walks
// depth-0 tiles in order.
//
// Here atoms stay in compact CSR in device memory: sorted int32 keys,
// int64 offsets, int32 values. A row lookup is a binary search of the key
// array; a membership test is a search of the wider row. The wrapper passes
// a by-value descriptor (__grid_constant__) with n_vars, each atom's
// (first, second) variable as per-depth bit masks, its CSR pointers, and
// the constant row of every starts-only depth.
//
// What bounds it on this card: dependent probe steps at the innermost
// depth. For the triangle a prefix (x, y) costs about
// lo * log2(1 + hi / lo) comparisons (lo <= hi the two bound rows), each a
// step that waits on a load; the bytes of the touched CSR rows, read once,
// take far less time at 3.35 TB/s. The count is a sum, so it needs none of
// the listing's order, and the design spreads those probes over the card
// as the intersect kernel does:
//
// * Expansion. Depths 1..n-2 run breadth first with the listing's own
//   stages (resolve, count_live, write_live below): every entry of a
//   frontier resolves the rows of the atoms bound at its depth once (one
//   key search per atom and entry, the depth-0 rows included), so no
//   (entry, candidate) pair searches a key array; pairs test membership in
//   the resolved rows and the live ones are written, in order, as the next
//   frontier. The listing's slot sort, offset scan and write pass do not
//   run.
// * Bounded memory by chunks, never a regrowth. Each depth d >= 2 has a
//   fixed region of the per-device workspace holding at most `cap`
//   entries. A frontier's (entry, candidate) pairs are expanded in chunks
//   of at most cap pairs, depth first over the chunks, so no frontier
//   outgrows its region whatever the box (walking the depth-0 rows in
//   chunks generalised to every depth; no sizing pass, no rerun); the
//   wrapper sizes the workspace before the launch from the call's sizes,
//   and the host reads only the total.
// * Innermost depth as work chunks. The last frontier's prefixes are
//   items of intersect_core.cuh: a prefix's work is the length of its
//   narrowest bound row, scanned on the device, and every warp of the grid
//   takes an equal contiguous share of that work (probe::warp_chunks), so
//   a hub prefix spans many warps and short prefixes follow each other in
//   one. A warp prepares each prefix's other row in its slice of shared
//   memory and keeps it while the next prefixes share it (the triangle's
//   (x, y) prefixes share x's row): as a bitmap of its ids when they span
//   at most 32 K values (a dense box's rows; a probe is then one coalesced
//   load and one bit test), else as a cp.async copy searched by runs with
//   galloping, else (a hub row) the window the prefix's probes can hit.
//   Further bound rows (the four-clique's third) filter the hits. At the
//   main path's largest triangle box (412,568 prefixes, 120.9 M probes)
//   the intersect kernel's block tiles take 1.44 ms here against the warp
//   chunks' 0.265 (intersect_core.cuh says what picks each scheduler).
//   The probes want many warps an SM, which the cooperative kernel's
//   registers do not leave, so the walk's last chunk (for most boxes its
//   only one) leaves its innermost depth to tiles_kernel, a second launch
//   on the same stream at four blocks an SM, which reads the frontier's
//   size from the workspace. The host reads nothing between the two.
// * Specialised on n_vars (count_kernel<N>, N = 2..6): the walk over the
//   depths is a compile-time recursion, and per-atom data live in the
//   workspace, not in per-thread arrays, so the count kernels keep no
//   stack.
// * Absent keys give empty rows, so a binding dies exactly where the
//   reference's SENTINEL-filled gather kills it (kernel.py:177-188).
// * Counts are int64 per thread and per block (the reference keeps int32
//   per depth-0 row, which a hub row of the triangle query can pass); one
//   int64 partial per block, summed by the wrapper on the device. No
//   atomics, so the sum is the same on every run.
//
// The kernels allocate nothing; the wrapper passes the outputs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "intersect_core.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxDepth = 6;
constexpr int kMaxAtoms = 16;
constexpr int kThreads = probe::kThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kDescWords = 2 + 6 * kMaxAtoms + 2 * kMaxDepth;
// grid bound of the cooperative kernels
constexpr int kMaxListBlocks = 1024;
constexpr int kDigits = 256;

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

__host__ __device__ __forceinline__ int popcount(unsigned m) {
#ifdef __CUDA_ARCH__
  return __popc(m);
#else
  return __builtin_popcount(m);
#endif
}

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

__host__ __device__ __forceinline__ long long words64(long long n) {
  return (n + 1) & ~1LL;
}

__host__ __device__ __forceinline__ long long words32(long long n) {
  return words64((n + 1) >> 1);
}

__device__ __forceinline__ bool is_first_thread() {
  return blockIdx.x == 0 && threadIdx.x == 0;
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
// sums[gridDim.x], and in dst[n] too when total_at_end. Every thread of the
// grid calls it; ends synchronised.
__device__ void grid_scan(cg::grid_group& g, const long long* src,
                          const long long* idx, long long* dst, long long n,
                          long long* sums, bool total_at_end = false) {
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
  if (total_at_end && is_first_thread()) dst[n] = sums[gridDim.x];
  g.sync();
}

// ---------------------------------------------------------------------------
// Frontier stages shared by the count and the listing.
//
// A level is a frontier of n prefixes at depth d (entry i binds variables
// 0..d-1; its depth-j value at vals[j * n + i]). resolve() gives every
// entry, once, the rows of the atoms bound at d, in atom order (row k of
// entry i at sp_ptr[k * stride + i], its length at sp_len[k * stride + i];
// stride >= n is the listing's n and the count's region capacity), the
// narrowest of them (lowest k on ties) as its candidate source (src[i]; -1
// at a starts-only depth, whose source is the constant row), and the
// exclusive scan of the source lengths (pair_off, n + 1 entries): entry i
// owns the (entry, candidate) pairs [pair_off[i], pair_off[i + 1]).
// Workspace arrays are written inside the launch, so they are read with
// plain loads (never __ldg); the atoms and the depth-0 frontier are
// read-only.

struct Level {
  const int* vals;
  const int* slots;     // the listing's slots[(j - 1) * n + i]; null for
                        // the count
  long long n;
  long long stride;     // of the resolve arrays
  long long* pair_off;
  long long* sp_ptr;    // a row's first value (an int pointer) as a word
  int* sp_len;
  int* src;
};

// int64 words of a level's resolve arrays for nb bound atoms and a stride
// of n entries
__host__ __device__ __forceinline__ long long resolve_words(int nb,
                                                            long long n) {
  return words64(n + 1) + words64((long long)nb * n) +
         words32((long long)nb * n) + words32(n);
}

// carve the resolve arrays of L (nb bound atoms, L->stride entries) from
// base
__host__ __device__ __forceinline__ void place_resolve(long long* base,
                                                       int nb, Level* L) {
  const long long n = L->stride;
  L->pair_off = base;
  L->sp_ptr = base + words64(n + 1);
  L->sp_len = reinterpret_cast<int*>(L->sp_ptr + words64((long long)nb * n));
  L->src = L->sp_len + 2 * words32((long long)nb * n);
}

__device__ __forceinline__ void resolve_entry(const Desc& D, int d,
                                              const Level& L, long long i) {
  const unsigned bound = D.second_mask[d];
  if (!bound) {
    L.pair_off[i] = D.n_cst[d];
    L.src[i] = -1;
    return;
  }
  const long long n = L.n;
  const long long st = L.stride;
  int k = 0;
  int best = 0;
  long long best_n = -1;
  for (unsigned m = bound; m; m &= m - 1, ++k) {
    const int a = __ffs(m) - 1;
    const Row r = lookup(D.atom[a], L.vals[(long long)D.fd[a] * n + i]);
    L.sp_ptr[(long long)k * st + i] =
        (long long)reinterpret_cast<uintptr_t>(r.p);
    L.sp_len[(long long)k * st + i] = (int)r.n;
    if (best_n < 0 || r.n < best_n) {
      best = k;
      best_n = r.n;
    }
  }
  L.pair_off[i] = best_n;
  L.src[i] = best;
}

// every entry of L resolved, and pair_off scanned (the pair count at
// pair_off[n] and sums[gridDim.x]); ends synchronised
__device__ void resolve(cg::grid_group& g, const Desc& D, int d,
                        const Level& L, long long* sums) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < L.n;
       i += stride) {
    resolve_entry(D, d, L, i);
  }
  g.sync();
  grid_scan(g, L.pair_off, nullptr, L.pair_off, L.n, sums, true);
}

__device__ __forceinline__ const int* row_at(const Level& L, int k,
                                             long long i) {
  return reinterpret_cast<const int*>(L.sp_ptr[(long long)k * L.stride + i]);
}

__device__ __forceinline__ int len_at(const Level& L, int k, long long i) {
  return L.sp_len[(long long)k * L.stride + i];
}

// the entry e of L whose pairs [pair_off[e], pair_off[e + 1]) hold pair p,
// at or after entry lo (pair_off[lo] <= p): a thread's pairs ascend, so
// its last entry is the hint, and the search gallops from it
__device__ __forceinline__ long long entry_from(const long long* pair_off,
                                                long long lo, long long n,
                                                long long p) {
  long long hi = lo + 1;
  for (long long step = 1; hi < n && pair_off[hi] <= p; step <<= 1) {
    lo = hi;
    hi = lo + step;
  }
  hi = min(hi, n);
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

// pair p of a resolved level (entry e, candidate k): whether the candidate
// is in every bound row, its value, and its slot (its position in the
// first bound atom's row, or k at a starts-only depth). *e_out holds the
// thread's last entry on the way in (0 at first), p's on the way out.
__device__ __forceinline__ bool test_pair(const Desc& D, int d,
                                          const Level& L, long long p,
                                          long long* e_out, int* v_out,
                                          long long* slot_out) {
  const long long e = entry_from(L.pair_off, *e_out, L.n, p);
  const long long k = p - L.pair_off[e];
  const int s = L.src[e];
  *e_out = e;
  *slot_out = k;
  if (s < 0) {
    *v_out = __ldg(D.cst[d] + k);
    return true;
  }
  const int v = __ldg(row_at(L, s, e) + k);
  *v_out = v;
  const int nb = popcount(D.second_mask[d]);
  for (int j = 0; j < nb; ++j) {
    if (j == s) continue;
    const int* r = row_at(L, j, e);
    const int len = len_at(L, j, e);
    const int q = probe::global_lower_bound(r, 0, len, v);
    if (q >= len || __ldg(r + q) != v) return false;
    if (j == 0) *slot_out = q;
  }
  return true;
}

// the live pairs of [P0, P1) of a resolved level: each block counts those
// of its contiguous chunk, the block counts are scanned into sums (the
// total at sums[gridDim.x]), and thread 0 of block 0 then calls
// take(total). Ends synchronised.
template <class Take>
__device__ void count_live(cg::grid_group& g, const Desc& D, int d,
                           const Level& L, long long P0, long long P1,
                           long long* sums, Take take) {
  long long lo, hi, total;
  block_chunk(P1 - P0, &lo, &hi);
  long long live = 0;
  long long e = 0;
  for (long long p = lo + threadIdx.x; p < hi; p += kThreads) {
    long long slot;
    int v;
    live += test_pair(D, d, L, P0 + p, &e, &v, &slot) ? 1 : 0;
  }
  block_scan(live, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
  g.sync();
  if (blockIdx.x == 0) {
    scan_block_sums(sums, gridDim.x);
    if (threadIdx.x == 0) take(sums[gridDim.x]);
  }
  g.sync();
}

// after count_live over the same pairs: each block writes its live pairs
// in order (a block scan of live flags per kThreads pairs) as the next
// frontier of nn entries: values (d + 1 rows) and, for the listing, slots
// (d rows, the new one the candidate's slot). Liveness is computed twice
// rather than stored per pair. Ends synchronised.
__device__ void write_live(cg::grid_group& g, const Desc& D, int d,
                           const Level& L, long long P0, long long P1,
                           long long* sums, int* next_vals, int* next_slots,
                           long long nn) {
  long long lo, hi, total;
  block_chunk(P1 - P0, &lo, &hi);
  long long carry = sums[blockIdx.x];
  long long e = 0;
  for (long long base = lo; base < hi; base += kThreads) {
    const long long p = base + threadIdx.x;
    long long slot = 0;
    int v = 0;
    const bool ok = p < hi && test_pair(D, d, L, P0 + p, &e, &v, &slot);
    const long long o = carry + block_scan(ok ? 1 : 0, &total);
    carry += total;
    if (!ok) continue;
    for (int j = 0; j < d; ++j) {
      next_vals[(long long)j * nn + o] = L.vals[(long long)j * L.n + e];
    }
    next_vals[(long long)d * nn + o] = v;
    if (next_slots) {
      for (int j = 0; j + 1 < d; ++j) {
        next_slots[(long long)j * nn + o] = L.slots[(long long)j * L.n + e];
      }
      next_slots[(long long)(d - 1) * nn + o] = (int)slot;
    }
  }
  g.sync();
}

// ---------------------------------------------------------------------------
// Count: the walk over the depths, chunk by chunk, and the innermost tiles.
//
// Launch pair: count_kernel<N> (cooperative) walks the box; the innermost
// depth of the walk's last chunk, which for most boxes is its only one, is
// left to tiles_kernel, launched right after on the same stream with many
// more warps an SM (the probes wait on loads, and the cooperative kernel's
// register budget leaves it two blocks an SM). count_kernel writes that
// frontier's size and candidate count to the header; earlier chunks'
// innermost depths it counts itself, with the same tile code.

constexpr int kHeader = 32;
// count header words: the deferred last frontier's entries and candidates
constexpr int kHCountN = 0;
constexpr int kHCountW = 1;
// tiles_kernel's grid: four blocks an SM of an H100 (64 registers a
// thread; at 40 it spills)
constexpr int kTileBlocksPerSM = 4;
constexpr int kTileBlocks = 132 * kTileBlocksPerSM;
// values of a warp's slice of the shared window, and the dynamic shared
// memory of both count launches
constexpr int kCountWarpWin = 1024;
constexpr int kCountSmem = kCountWarpWin * kWarps * 4 > probe::kWinBytes
                               ? kCountWarpWin * kWarps * 4
                               : probe::kWinBytes;

struct CountArgs {
  long long* ws;
  const int* c0;
  long long n0;
  long long cap;        // entries of a depth >= 2 region
  long long* partials;  // one per block
};

// words of depth d's region: resolve arrays for cap_d entries, then (d >=
// 2) the frontier's values
__host__ __device__ __forceinline__ long long count_level_words(
    int nb, int d, long long cap_d) {
  return resolve_words(nb, cap_d) + (d >= 2 ? words32((long long)d * cap_d)
                                            : 0);
}

// the count kernel's workspace: header, block sums, then one region per
// depth 1..n_vars-1 (depth 1 holds the n0 depth-0 rows)
__host__ __device__ __forceinline__ long long count_region_at(
    const Desc& D, long long n0, long long cap, int grid, int d) {
  long long at = kHeader + words64(grid + 2);
  for (int j = 1; j < d; ++j) {
    at += count_level_words(popcount(D.second_mask[j]), j, j == 1 ? n0 : cap);
  }
  return at;
}

// depth d's region as a Level with n entries at vals (its resolve arrays
// at the region's start, stride cap_d)
__host__ __device__ __forceinline__ Level count_level(
    const Desc& D, long long* ws, long long n0, long long cap, int grid,
    int d, const int* vals, long long n) {
  Level L{vals, nullptr, n, d == 1 ? n0 : cap,
          nullptr, nullptr, nullptr, nullptr};
  place_resolve(ws + count_region_at(D, n0, cap, grid, d),
                popcount(D.second_mask[d]), &L);
  return L;
}

// the prefixes of the last depth as intersect_core items: the narrowest
// bound row probed into the next one (the first other row in atom order);
// with kRestT, further bound rows filter the hits
template <bool kRestT>
struct PrefixItems {
  const Level& L;
  int nb;
  static constexpr bool kRest = kRestT;
  static constexpr bool kPerItem = false;
  static constexpr int kWarpWin = kCountWarpWin;

  __device__ __forceinline__ long long work(long long p) const {
    return L.pair_off[p];
  }

  __device__ __forceinline__ probe::PairRows rows(long long p) const {
    const int s = L.src[p];
    const int w = s == 0 ? 1 : 0;
    return probe::PairRows{row_at(L, s, p), row_at(L, w, p), len_at(L, w, p)};
  }

  __device__ __forceinline__ bool rest(long long p, int x) const {
    const int s = L.src[p];
    const int w = s == 0 ? 1 : 0;
    for (int j = 0; j < nb; ++j) {
      if (j == s || j == w) continue;
      if (!probe::global_member(row_at(L, j, p), len_at(L, j, p), x)) {
        return false;
      }
    }
    return true;
  }
};

// this thread's bindings of a resolved last frontier of n entries and
// n_pairs candidates (probe::warp_chunks)
__device__ __forceinline__ long long innermost_count(const Level& L, int nb,
                                                     long long n,
                                                     long long n_pairs,
                                                     int* win) {
  if (nb == 1) {  // one bound row: every candidate is a binding
    return blockIdx.x == 0 && threadIdx.x == 0 ? n_pairs : 0;
  }
  if (nb == 2) {
    return probe::warp_chunks(PrefixItems<false>{L, nb}, n, n_pairs, win);
  }
  return probe::warp_chunks(PrefixItems<true>{L, nb}, n, n_pairs, win);
}

// this block's bindings below a frontier of n entries at depth d (its
// values at vals): resolve it; at the last depth count by tiles, or leave
// the count to tiles_kernel when this is the walk's last chunk at every
// depth (`last_chunk`); else expand its pairs in chunks of at most cap
// into depth d + 1's region and recurse. Every block runs the same trip
// counts (all read from the workspace after a grid sync), so every grid
// sync is reached by all.
template <int N, int d>
__device__ __forceinline__ long long count_walk(
    cg::grid_group& g, const Desc& D, const CountArgs& A, long long* sums,
    int* win, const int* vals, long long n, bool last_chunk) {
  const Level L = count_level(D, A.ws, A.n0, A.cap, gridDim.x, d, vals, n);
  resolve(g, D, d, L, sums);
  const long long n_pairs = L.pair_off[n];
  long long acc = 0;
  if constexpr (d == N - 1) {
    if (last_chunk) {
      if (is_first_thread()) {
        A.ws[kHCountN] = n;
        A.ws[kHCountW] = n_pairs;
      }
    } else {
      acc = innermost_count(L, popcount(D.second_mask[d]), n, n_pairs, win);
      g.sync();  // the regions are rewritten by the next chunk
    }
  } else {
    const Level next = count_level(D, A.ws, A.n0, A.cap, gridDim.x, d + 1,
                                   nullptr, 0);
    int* next_vals = reinterpret_cast<int*>(
        next.pair_off + resolve_words(popcount(D.second_mask[d + 1]),
                                      A.cap));
    for (long long P0 = 0; P0 < n_pairs; P0 += A.cap) {
      const long long P1 = min(n_pairs, P0 + A.cap);
      count_live(g, D, d, L, P0, P1, sums, [](long long) {});
      const long long nn = sums[gridDim.x];
      write_live(g, D, d, L, P0, P1, sums, next_vals, nullptr, nn);
      if (nn > 0) {
        acc += count_walk<N, d + 1>(g, D, A, sums, win, next_vals, nn,
                                    last_chunk && P1 == n_pairs);
      }
    }
  }
  return acc;
}

__device__ __forceinline__ void block_partial(long long acc,
                                              long long* partials) {
  __shared__ long long s_part[kWarps];
  acc = probe::warp_sum(acc);
  if ((threadIdx.x & 31) == 0) s_part[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    long long v = threadIdx.x < kWarps ? s_part[threadIdx.x] : 0;
    v = probe::warp_sum(v);
    if (threadIdx.x == 0) partials[blockIdx.x] = v;
  }
}

// N <= 4 fits 128 registers a thread (two blocks an SM); deeper walks
// inline more state and take up to 255 rather than spill
template <int N>
__global__ void __launch_bounds__(kThreads, N <= 4 ? 2 : 1)
count_kernel(const __grid_constant__ Desc D,
             const __grid_constant__ CountArgs A) {
  extern __shared__ __align__(16) int win[];
  cg::grid_group g = cg::this_grid();
  if (is_first_thread()) A.ws[kHCountN] = A.ws[kHCountW] = 0;
  long long acc = count_walk<N, 1>(g, D, A, A.ws + kHeader, win, A.c0, A.n0,
                                   true);
  block_partial(acc, A.partials);
}

// the last frontier count_kernel left: its resolve arrays (stride cap_d,
// placed by the host), its size and candidate count in the header
struct TileArgs {
  Level L;
  int nb;
  const long long* head;
  long long* partials;
};

#ifdef LFTJ_COUNT_BLOCK_TILES
// the deferred innermost depth on the intersect kernel's block tiles
// (probe::count_tiles) instead of warp chunks, for
// scripts/fused_count_probe.py --count-variant
__device__ __forceinline__ long long innermost_tiles(const Level& L, int nb,
                                                     long long n,
                                                     long long n_pairs,
                                                     int* win,
                                                     probe::TileShared& S) {
  if (nb == 1) return blockIdx.x == 0 && threadIdx.x == 0 ? n_pairs : 0;
  if (nb == 2) {
    return probe::count_tiles(PrefixItems<false>{L, nb}, n, n_pairs, win, S,
                              nullptr);
  }
  return probe::count_tiles(PrefixItems<true>{L, nb}, n, n_pairs, win, S,
                            nullptr);
}
#endif

__global__ void __launch_bounds__(kThreads, kTileBlocksPerSM)
tiles_kernel(const __grid_constant__ TileArgs T) {
  extern __shared__ __align__(16) int win[];
#ifdef LFTJ_COUNT_BLOCK_TILES
  __shared__ probe::TileShared S;
  block_partial(innermost_tiles(T.L, T.nb, __ldg(T.head + kHCountN),
                                __ldg(T.head + kHCountW), win, S),
                T.partials);
#else
  block_partial(innermost_count(T.L, T.nb, __ldg(T.head + kHCountN),
                                __ldg(T.head + kHCountW), win),
                T.partials);
#endif
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
//    ..., slot_{d-1}) order: resolve, count_live and write_live above
//    (each entry's bound rows found once, a device-wide scan of the source
//    lengths, per-block live counts, scanned, then each block's live pairs
//    in order as F_{d+1}, with the candidate's slot in the first atom's
//    row);
// 2. the innermost depth, split the same way: the last frontier resolved,
//    a thread per (prefix, candidate) pair tests membership, and a
//    device-wide scan of the live flags gives every prefix its binding
//    count and every binding its rank within its prefix; also the largest
//    slot of every depth;
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
// (a warp per depth-0 row, depth first) counts every frontier's size, the
// innermost pairs and the total, and the words the whole call needs are
// computed from them with the same arithmetic the stages allocate by, so
// one regrowth and one rerun always suffice. Header (int64 words, read by
// the wrapper in one copy): bump, overflow, need, total, rows_at, rows.
// Frontier values are int32 arrays of one row per depth (vals[j * n + i]
// is entry i's depth-j value), slots likewise.

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
};
static_assert(kHSizePairs < kHeader, "listing header");

// the fixed part of the listing's workspace: header, block sums (grid + 2
// words) and the digit-major radix histogram (kDigits words per block)
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

// the frontier a stage reads: n entries, depth-j values at vals[j * n + i]
// and depth-j slots at slots[(j - 1) * n + i]
struct Frontier {
  const int* vals;
  const int* slots;
  long long n;
};

// F resolved at depth d in arrays taken from the workspace; false on
// overflow
__device__ bool take_resolved(cg::grid_group& g, const Desc& D,
                              const ListArgs& A, long long* sums, int d,
                              const Frontier& F, Level* L) {
  long long* H = A.ws;
  const int nb = popcount(D.second_mask[d]);
  if (is_first_thread()) {
    H[kHAt] = take(H, A.ws_words, resolve_words(nb, F.n));
  }
  g.sync();
  if (overflowed(H)) return false;
  *L = Level{F.vals, F.slots, F.n, F.n, nullptr, nullptr, nullptr, nullptr};
  place_resolve(H + H[kHAt], nb, L);
  resolve(g, D, d, *L, sums);
  return true;
}

// depth d's expansion of F into the next frontier; false on overflow
__device__ bool expand_depth(cg::grid_group& g, const Desc& D,
                             const ListArgs& A, long long* sums, int d,
                             Frontier* F) {
  long long* H = A.ws;
  Level L;
  if (!take_resolved(g, D, A, sums, d, *F, &L)) return false;
  const long long n_pairs = L.pair_off[F->n];
  count_live(g, D, d, L, 0, n_pairs, sums, [&](long long nn) {
    H[kHAt] = take(H, A.ws_words, words32((d + 1) * nn));
    H[kHAt2] = take(H, A.ws_words, words32(d * nn));
  });
  if (overflowed(H)) return false;
  const long long nn = sums[gridDim.x];
  int* next_vals = reinterpret_cast<int*>(H + H[kHAt]);
  int* next_slots = reinterpret_cast<int*>(H + H[kHAt2]);
  write_live(g, D, d, L, 0, n_pairs, sums, next_vals, next_slots, nn);
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
  Level L;
  if (!take_resolved(g, D, A, sums, last, F, &L)) return false;
  const long long n_pairs = L.pair_off[m];
  if (is_first_thread()) {
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
  long long e = 0;
  for (long long p = tid; p < n_pairs; p += stride) {
    long long slot;
    int v;
    live[p] = test_pair(D, last, L, p, &e, &v, &slot) ? 1 : 0;
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
  grid_scan(g, live, nullptr, live, n_pairs, sums, true);
  for (long long e = tid; e < m; e += stride) {
    counts[e] = live[L.pair_off[e + 1]] - live[L.pair_off[e]];
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
  e = 0;
  for (long long p = tid; p < n_pairs; p += stride) {
    if (live[p + 1] == live[p]) continue;
    long long slot;
    int v;
    test_pair(D, last, L, p, &e, &v, &slot);
    const long long o = start[e] + live[p] - live[L.pair_off[e]];
    if (o >= A.cap) continue;
    int* row = out + o * D.n_vars;
    for (int j = 0; j < last; ++j) row[j] = F.vals[(long long)j * m + e];
    row[last] = v;
  }
  if (is_first_thread()) H[kHNeed] = H[kHBump];
  return true;
}

// --- the listing's sizing pass after an overflow: a warp per depth-0 row,
// depth first, with the rows of every bound atom kept per thread

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
  long long cnt = 0;
  for (long long i = 0; i < src.n; ++i) {
    cnt += member_all(D, d, rows, __ldg(src.p + i), src_a) ? 1 : 0;
  }
  return cnt;
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

// for depth-0 row r, the live prefixes of every depth (size[d + 1] counts
// the entries of frontier F_{d + 1}), the innermost pairs and the bindings
// below them, depth first, this lane's share of the depth-1 candidates
// (k = lane, lane + 32, ...)
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
      need += resolve_words(popcount(D.second_mask[d]), n) +
              words32((d + 1) * nn) + words32(d * nn);
      n = nn;
    }
    const long long total_all = H[kHSizeTotal];
    need += resolve_words(popcount(D.second_mask[last]), n) +
            words64(H[kHSizePairs] + 1) + 5 * words64(n) +
            words32(min(total_all, A.cap) * D.n_vars);
    H[kHNeed] = need;
    H[kHTotal] = total_all;
  }
}

__global__ void __launch_bounds__(kThreads)
list_kernel(const __grid_constant__ Desc D,
            const __grid_constant__ ListArgs A) {
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

using CountFn = void (*)(const Desc, const CountArgs);

CountFn count_fn(int n_vars) {
  switch (n_vars) {
    case 2: return count_kernel<2>;
    case 3: return count_kernel<3>;
    case 4: return count_kernel<4>;
    case 5: return count_kernel<5>;
    case 6: return count_kernel<6>;
    default: return nullptr;
  }
}

// the co-resident grid of a cooperative kernel with `smem` dynamic shared
// bytes, at most kMaxListBlocks; an error when the card cannot launch
// cooperatively
int coop_grid(const void* kernel, int smem, int* grid) {
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
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  *grid = per_sm * sms < kMaxListBlocks ? per_sm * sms : kMaxListBlocks;
  return 0;
}

}  // namespace

extern "C" int lftj_fused_desc_words() { return kDescWords; }

extern "C" int lftj_list_header_words() { return kHeader; }

// The count kernel's grid for a pattern of n_vars variables (every block
// co-resident, as the cooperative launch needs).
extern "C" int lftj_count_grid(int n_vars, int* grid) {
  const CountFn fn = count_fn(n_vars);
  if (!fn) return (int)cudaErrorInvalidValue;
  return coop_grid((const void*)fn, kCountSmem, grid);
}

// int64 words of the count kernel's workspace for n0 depth-0 rows and
// regions of cap entries (-1 for a malformed descriptor)
extern "C" long long lftj_count_words(const long long* desc, long long n0,
                                      long long cap, int grid) {
  Desc D;
  if (!make_desc(desc, &D)) return -1;
  return count_region_at(D, n0, cap, grid, D.n_vars);
}

// int64 partials of one count call: count_kernel's grid, then tiles_kernel's
extern "C" long long lftj_count_n_partials(int grid) {
  return (long long)grid + kTileBlocks;
}

// One count call, count_kernel then tiles_kernel on the stream: the box's
// bindings as lftj_count_n_partials(grid) int64 partials, in the
// workspace ws (at least lftj_count_words words).
extern "C" int lftj_count_launch(const long long* desc, const void* c0,
                                 long long n0, void* ws, long long ws_words,
                                 long long cap, int grid, void* partials,
                                 void* stream) {
  Desc D;
  if (!make_desc(desc, &D) || grid < 1 || grid > kMaxListBlocks || n0 < 1 ||
      cap < 1 || ws_words < count_region_at(D, n0, cap, grid, D.n_vars)) {
    return (int)cudaErrorInvalidValue;
  }
  CountArgs A{(long long*)ws, (const int*)c0, n0, cap, (long long*)partials};
  void* args[] = {&D, &A};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)count_fn(D.n_vars), dim3(grid), dim3(kThreads), args,
      kCountSmem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const int last = D.n_vars - 1;
  const TileArgs T{count_level(D, A.ws, n0, cap, grid, last, nullptr, 0),
                   popcount(D.second_mask[last]), A.ws, A.partials + grid};
  tiles_kernel<<<kTileBlocks, kThreads, kCountSmem, (cudaStream_t)stream>>>(
      T);
  return (int)cudaGetLastError();
}

// The listing kernel's grid: every block co-resident, as the cooperative
// launch needs; raises (returns an error) when the card cannot launch
// cooperatively.
extern "C" int lftj_list_grid(int* grid) {
  return coop_grid((const void*)list_kernel, 0, grid);
}

extern "C" long long lftj_list_base_words(int grid) {
  return list_base_words(grid);
}

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
