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

#include <cuda_runtime.h>
#include <stdint.h>

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
// Listing: the same loop nest, emitting bindings in the reference order.
//
// Replaces build_fused_list (src/repro/kernels/lftj_fused/kernel.py:264),
// an XLA program that walks the candidate slots of depths 1..n-2 for all
// depth-0 rows at once and flattens the innermost (T, K) block row-major:
// its bindings come in lexicographic order of (slot_1, ..., slot_{n-2},
// depth-0 row, innermost slot), where slot_d is the position within the
// row of the first atom bound at depth d (or within the constant row of a
// starts-only depth). The count kernel's per-thread DFS gives another
// order, so the listing is built breadth first, one launch per stage:
//
// 1. expansion, depth d = 1..n-2: list_rows_kernel writes each frontier
//    entry's candidate source length (the narrowest bound row, or the
//    constant row); the wrapper scans it; list_expand_kernel gives each
//    (entry, candidate) pair a thread that tests membership in the other
//    bound rows and finds the candidate's slot in the first atom's row by
//    the same binary search. A first launch writes a live flag per pair,
//    the wrapper scans the flags, and a second launch writes each live
//    pair as a new frontier entry at its place, so the frontier stays in
//    (depth-0 row, slot_1, ..., slot_d) order;
// 2. list_count_kernel: the number of innermost bindings of every prefix;
// 3. the wrapper sorts the prefixes stably by (slot_1, ..., slot_{n-2}),
//    which leaves the depth-0 row as the last key, and scans the counts in
//    that order into output offsets;
// 4. list_write_kernel: a thread per prefix whose offset is below the
//    capacity writes its bindings there, innermost values ascending (rows
//    are sets, so that is the first atom's slot order).
//
// The total is exact (int64) for any capacity; the buffer holds its first
// min(total, capacity) rows, so a caller that sees total > capacity
// rescans and gets the same prefix, extended. Frontier values are int32
// arrays of one row per depth (vals[j * n + i] is entry i's depth-j
// value), slots likewise.

// rows of the atoms bound at depth d for frontier entry i
__device__ __forceinline__ void bound_rows(const Desc& D, int d,
                                           const int* __restrict__ vals,
                                           long long n, long long i,
                                           Row* rows) {
  for (unsigned m = D.second_mask[d]; m; m &= m - 1) {
    const int a = __ffs(m) - 1;
    rows[a] = lookup(D.atom[a], __ldg(vals + (long long)D.fd[a] * n + i));
  }
}

// the entry e with pair_off[e] <= p < pair_off[e + 1]
__device__ __forceinline__ long long pair_entry(
    const long long* __restrict__ pair_off, long long n, long long p) {
  long long lo = 0, hi = n;
  while (hi - lo > 1) {
    const long long mid = (lo + hi) >> 1;
    if (__ldg(pair_off + mid) <= p) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
list_rows_kernel(const __grid_constant__ Desc D, int d,
                 const int* __restrict__ vals, long long n,
                 long long* __restrict__ row_len) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Row rows[kMaxAtoms];
  bound_rows(D, d, vals, n, i, rows);
  int which;
  const Row src = source_row(D, d, rows, &which);
  row_len[i] = src.n > 0 ? src.n : 0;
}

// one thread per (entry, candidate) pair, grid-stride. With write == 0 it
// writes live[p]; with write == 1 it writes every live pair at pos[p]
// (the exclusive scan of live) into the next frontier.
__global__ void __launch_bounds__(kThreads)
list_expand_kernel(const __grid_constant__ Desc D, int d,
                   const int* __restrict__ vals,
                   const int* __restrict__ slots, long long n,
                   const long long* __restrict__ pair_off,
                   unsigned char* __restrict__ live,
                   const long long* __restrict__ pos, int write,
                   long long n_next, int* __restrict__ next_vals,
                   int* __restrict__ next_slots) {
  const long long n_pairs = __ldg(pair_off + n);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       p < n_pairs; p += stride) {
    if (write && !live[p]) continue;
    const long long e = pair_entry(pair_off, n, p);
    const long long k = p - __ldg(pair_off + e);
    Row rows[kMaxAtoms];
    bound_rows(D, d, vals, n, e, rows);
    int src_a;
    const Row src = source_row(D, d, rows, &src_a);
    const int v = __ldg(src.p + k);
    long long slot = k;  // a starts-only depth: the constant row's slot
    bool ok = true;
    if (src_a >= 0) {
      const int first = __ffs(D.second_mask[d]) - 1;
      for (unsigned m = D.second_mask[d]; m; m &= m - 1) {
        const int a = __ffs(m) - 1;
        if (a == src_a) continue;
        const Row r = rows[a];
        const long long q = lower_bound(r.p, 0, r.n, v);
        if (q >= r.n || __ldg(r.p + q) != v) {
          ok = false;
          break;
        }
        if (a == first) slot = q;
      }
    }
    if (!write) {
      live[p] = ok ? 1 : 0;
      continue;
    }
    const long long o = __ldg(pos + p);
    for (int j = 0; j < d; ++j) {
      next_vals[(long long)j * n_next + o] = __ldg(vals + (long long)j * n + e);
    }
    next_vals[(long long)d * n_next + o] = v;
    for (int j = 0; j + 1 < d; ++j) {
      next_slots[(long long)j * n_next + o] =
          __ldg(slots + (long long)j * n + e);
    }
    next_slots[(long long)(d - 1) * n_next + o] = (int)slot;
  }
}

// innermost bindings of every prefix
__global__ void __launch_bounds__(kThreads)
list_count_kernel(const __grid_constant__ Desc D,
                  const int* __restrict__ vals, long long n,
                  long long* __restrict__ counts) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int last = D.n_vars - 1;
  Row rows[kMaxAtoms];
  bound_rows(D, last, vals, n, i, rows);
  counts[i] = innermost(D, last, rows);
}

// thread i writes the bindings of prefix order[i] at rows offset[i]...,
// keeping those below cap
__global__ void __launch_bounds__(kThreads)
list_write_kernel(const __grid_constant__ Desc D,
                  const int* __restrict__ vals, long long n,
                  const long long* __restrict__ order,
                  const long long* __restrict__ offset, long long n_write,
                  long long cap, int* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_write) return;
  const long long e = __ldg(order + i);
  long long o = __ldg(offset + i);
  const int last = D.n_vars - 1;
  Row rows[kMaxAtoms];
  bound_rows(D, last, vals, n, e, rows);
  int src_a;
  const Row src = source_row(D, last, rows, &src_a);
  const unsigned others = D.second_mask[last] & ~(1u << src_a);
  long long lo[kMaxAtoms];
  for (unsigned m = others; m; m &= m - 1) lo[__ffs(m) - 1] = 0;
  for (long long k = 0; k < src.n && o < cap; ++k) {
    const int v = __ldg(src.p + k);
    bool hit = true, done = false;
    for (unsigned m = others; m; m &= m - 1) {
      const int a = __ffs(m) - 1;
      const Row r = rows[a];
      const long long q = lower_bound(r.p, lo[a], r.n, v);
      lo[a] = q;
      if (q >= r.n) done = true;  // no larger value left in this row
      if (q >= r.n || __ldg(r.p + q) != v) {
        hit = false;
        break;
      }
    }
    if (done) break;
    if (!hit) continue;
    int* row = out + o * D.n_vars;
    for (int j = 0; j < last; ++j) row[j] = __ldg(vals + (long long)j * n + e);
    row[last] = v;
    ++o;
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

extern "C" int lftj_list_rows_launch(const long long* desc, int d,
                                     const void* vals, long long n,
                                     void* row_len, void* stream) {
  Desc D;
  if (!make_desc(desc, &D) || d < 1 || d >= D.n_vars - 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (n <= 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  list_rows_kernel<<<(unsigned int)blocks, kThreads, 0,
                     (cudaStream_t)stream>>>(D, d, (const int*)vals, n,
                                             (long long*)row_len);
  return (int)cudaGetLastError();
}

extern "C" int lftj_list_expand_launch(const long long* desc, int d,
                                       const void* vals, const void* slots,
                                       long long n, const void* pair_off,
                                       void* live, const void* pos,
                                       int write, long long n_next,
                                       void* next_vals, void* next_slots,
                                       void* stream) {
  Desc D;
  if (!make_desc(desc, &D) || d < 1 || d >= D.n_vars - 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (n <= 0) return 0;
  list_expand_kernel<<<kBlocks, kThreads, 0, (cudaStream_t)stream>>>(
      D, d, (const int*)vals, (const int*)slots, n,
      (const long long*)pair_off, (unsigned char*)live,
      (const long long*)pos, write, n_next, (int*)next_vals,
      (int*)next_slots);
  return (int)cudaGetLastError();
}

extern "C" int lftj_list_count_launch(const long long* desc,
                                      const void* vals, long long n,
                                      void* counts, void* stream) {
  Desc D;
  if (!make_desc(desc, &D)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  list_count_kernel<<<(unsigned int)blocks, kThreads, 0,
                      (cudaStream_t)stream>>>(D, (const int*)vals, n,
                                              (long long*)counts);
  return (int)cudaGetLastError();
}

extern "C" int lftj_list_write_launch(const long long* desc,
                                      const void* vals, long long n,
                                      const void* order, const void* offset,
                                      long long n_write, long long cap,
                                      void* out, void* stream) {
  Desc D;
  if (!make_desc(desc, &D)) return (int)cudaErrorInvalidValue;
  if (n_write <= 0) return 0;
  const long long blocks = (n_write + kThreads - 1) / kThreads;
  list_write_kernel<<<(unsigned int)blocks, kThreads, 0,
                      (cudaStream_t)stream>>>(
      D, (const int*)vals, n, (const long long*)order,
      (const long long*)offset, n_write, cap, (int*)out);
  return (int)cudaGetLastError();
}
