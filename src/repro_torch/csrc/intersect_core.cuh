// Probe and work-split machinery of intersect.cu and lftj_fused.cu.
//
// An "item" is one intersection to count: a narrow row whose values are
// probed into a wide row (and, for the fused count, into further rows).
// Its work is the narrow row's length. The caller scans the items' work
// into work_off (n_items + 1 entries, the total at work_off[n_items]).
// Both kernels share the leaf helpers below (searches in global and shared
// memory, cp.async staging, galloping, the item search); each splits the
// work with its own scheduler, the faster one on its own inputs:
//
// * count_tiles (the intersect kernel): tiles of the work over a fixed
//   grid of blocks. The tile size is the least multiple of kThreads probes
//   that spreads the work over the grid, at most kTileMax; a tile finds
//   its first and last item by binary search in work_off, so a hub item
//   spans many blocks and a run of small items shares one block.
//   - One item in the tile whose window fits: the block stages the window
//     of the wide row that the tile's narrow slice [s, e) can hit,
//     [lb(wide, narrow[s]), lb(wide, narrow[e-1]) + 1), into shared memory
//     with cp.async. Each thread takes a contiguous run of tile / kThreads
//     probes, binary-searches the first in the window and gallops from hit
//     to hit: the dependent steps hit shared memory (~30 cycles) instead
//     of L2 or HBM (~300-600).
//   - Tiles of many items (at least one a warp): warp w takes the tile's
//     items w, w + 8, ..., its lanes the item's probes with stride 32.
//   - Every other tile: thread t takes the tile's probes t, t + kThreads,
//     ..., so a warp probes 32 consecutive values of one narrow row
//     (coalesced), each a binary search resumed from the thread's last hit.
// * warp_chunks (the fused count): every warp of the grid takes an equal
//   contiguous share of the work and keeps an item's wide row in its slice
//   of shared memory while the next items share it: a bitmap when its ids
//   span at most 32 K values, else a copy, else a window (details below).
//
// What picks the scheduler is the input (one H100 80GB HBM3 at 700 W; each
// kernel built once more with the other scheduler by a macro and timed in
// one process, own, other, other, own):
// * intersect pairs are few and long, their wide rows hub rows whose ids
//   span the whole box (no bitmap), each met by one pair or a few: block
//   tiles with 16 KB windows at eight blocks an SM. At the rmat box (RMAT
//   scale 20, 30,760 pairs) 0.475 / 0.478 ms against 0.722 / 0.731 on warp
//   chunks; at the largest box of TriangleEngine(backend="intersect") at
//   scale 18 0.200 / 0.205 against 0.344 / 0.325; at its median box a tie
//   (0.153 / 0.154 against 0.148 / 0.170) (scripts/kernel_ab_probe.py
//   --intersect-variant INTERSECT_WARP_CHUNKS).
// * fused-count prefixes are many and short, runs of them share the other
//   row, and a dense box's ids fit a bitmap: warp chunks. At the largest
//   triangle box (412,568 prefixes, 293 probes on average) tiles_kernel
//   takes 0.265 / 0.265 ms against 1.444 / 1.442 on block tiles; on the
//   query phase's small boxes the two differ by at most 0.022 ms either
//   way (scripts/fused_count_probe.py --count-variant
//   LFTJ_COUNT_BLOCK_TILES).
//
// The item source is a policy class:
//   long long work(long long p) const   work_off[p]
//   PairRows rows(long long p) const    item p's narrow and wide rows
//   bool rest(long long p, int x) const x is in every further row of p
//   static constexpr bool kRest         whether rest() filters at all
//   static constexpr bool kPerItem      whether add(p, c) takes per-item
//                                       counts (warp_chunks)
//   static constexpr int kWarpWin       values of a warp's shared slice
//                                       (warp_chunks)
// so the intersect kernel (two rows, read-only inputs, __ldg) and the fused
// count (prefixes with two or more bound rows, plain loads of offsets its
// own launch pair wrote) read their items the same way.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace probe {

constexpr int kThreads = 256;
// probes per work tile at most
constexpr long long kTileMax = 2048;
// shared-memory window of the wide row, in int32 values (16 KB: with the
// intersect kernel held to 32 registers a thread, eight blocks fit an SM;
// latency hiding matters more than wide windows), plus the up to three
// values of alignment padding in front of it; under the 48 KB a launch may
// take without opting in
constexpr int kWin = 4096;
constexpr int kWinBytes = (kWin + 4) * 4;

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

// whether x is in a read-only sorted row of n values
__device__ __forceinline__ bool global_member(const int* __restrict__ row,
                                              int n, int x) {
  const int q = global_lower_bound(row, 0, n, x);
  return q < n && __ldg(row + q) == x;
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

// the item p in [lo, hi) with work(p) <= g < work(p + 1): the last p with
// work(p) <= g, which skips items without work
template <class Items>
__device__ __forceinline__ long long item_of(const Items& I, long long lo,
                                             long long hi, long long g) {
  while (hi - lo > 1) {
    const long long mid = (lo + hi) >> 1;
    if (I.work(mid) <= g) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// an item's rows, narrow (probed) and wide (searched); a row holds fewer
// than 2^31 values (its values are distinct int32 ids)
struct PairRows {
  const int* narrow;
  const int* wide;
  int n_wide;
};

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
__device__ __forceinline__ int stage_window(int* win, const int* src, int n) {
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

// x at q of the wide row, and in every further row of item p
template <class Items>
__device__ __forceinline__ bool hit(const Items& I, long long p,
                                    const PairRows& pr, int q, int x) {
  return q < pr.n_wide && __ldg(pr.wide + q) == x &&
         (!Items::kRest || I.rest(p, x));
}

// the probes [g0, g1) of a tile over items [p0, p1], thread t taking
// probes g0 + t, g0 + t + kThreads, ...: a warp probes consecutive values
// of a narrow row, and its binary searches in the wide row share their
// path (and their loads) down to the last few levels. A probe's search
// starts at the thread's last hit in the same item, or at lo0 (the tile's
// window start when the tile is one item, else 0).
template <class Items>
__device__ __forceinline__ long long strided_probes(
    const Items& I, long long g0, long long g1, long long p0, long long p1,
    int lo0, int* __restrict__ per_item) {
  long long cnt = 0;
  long long p = p0 - 1;     // the item of the thread's last probe
  long long base = 0;       // its first probe, work(p)
  long long next = -1;      // the first probe of the item after it
  PairRows pr{nullptr, nullptr, 0};
  int q = 0;                // the last hit's index in the wide row
  for (long long g = g0 + threadIdx.x; g < g1; g += kThreads) {
    if (g >= next) {        // a later item: the last one starting <= g
      p = item_of(I, max(p + 1, p0), p1 + 1, g);
      base = I.work(p);
      next = I.work(p + 1);
      pr = I.rows(p);
      q = p0 == p1 ? lo0 : 0;
    }
    const int x = __ldg(pr.narrow + (g - base));
    q = global_lower_bound(pr.wide, q, pr.n_wide, x);
    if (hit(I, p, pr, q, x)) {
      ++cnt;
      if (per_item) atomicAdd(per_item + p, 1);
    }
  }
  return cnt;
}

// the items [p0, p1] of a tile [g0, g1), warp w taking items p0 + w,
// p0 + w + 8, ... and its lanes an item's probes in the tile with stride
// 32, each a binary search in the wide row from the lane's last hit (in
// the warp's slice of win when the policy stages wide rows that fit)
template <class Items>
__device__ __forceinline__ long long warp_items(
    const Items& I, long long g0, long long g1, long long p0, long long p1,
    int* __restrict__ per_item) {
  const int lane = threadIdx.x & 31;
  long long cnt = 0;
  for (long long p = p0 + (threadIdx.x >> 5); p <= p1; p += kThreads / 32) {
    const long long base = I.work(p);
    const long long s = max(g0, base) - base;
    const long long e = min(g1, I.work(p + 1)) - base;
    if (s >= e) continue;  // no work: the whole warp skips the item
    const PairRows pr = I.rows(p);
    int q = 0;
    long long c = 0;
    for (long long j = s + lane; j < e; j += 32) {
      const int x = __ldg(pr.narrow + j);
      q = global_lower_bound(pr.wide, q, pr.n_wide, x);
      c += hit(I, p, pr, q, x) ? 1 : 0;
    }
    cnt += c;
    if (per_item) {
      c = warp_sum(c);
      if (lane == 0 && c) atomicAdd(per_item + p, (int)c);
    }
  }
  return cnt;
}

// a warp's cp.async copy of src[0, n) into shared memory: element i lands
// at dst[pad + i], where pad (returned) puts the 16-byte-aligned body of
// src on a 16-byte boundary of dst (dst 16-byte aligned, n + 3 values of
// room). The caller commits and waits.
__device__ __forceinline__ int warp_stage(int* dst, const int* src, int n) {
  const int lane = threadIdx.x & 31;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(src);
  int head = (int)(((16 - (addr & 15)) & 15) >> 2);
  if (head > n) head = n;
  const int pad = (4 - head) & 3;
  const int body = (n - head) >> 2;
  if (lane < head) cp_async4(dst + pad + lane, src + lane);
  for (int i = lane; i < body; i += 32) {
    cp_async16(dst + pad + head + 4 * i, src + head + 4 * i);
  }
  const int tail = head + 4 * body + lane;
  if (tail < n) cp_async4(dst + pad + tail, src + tail);
  return pad;
}

// This warp's hits over its contiguous share of the work space [0,
// w_total) of n_items items: warp g of the grid takes the probes [g·c,
// (g + 1)·c) for c = ceil(w_total / warps), so every warp gets the same
// number of probes and finds its first item with one search. An item's
// wide row is prepared in the warp's kWarpWin words of win once, and kept
// while the next items share it (consecutive prefixes often do):
// * a bitmap of its ids when they span at most 32·kWarpWin values (a
//   dense box's rows): the lanes take the item's probes with stride 32
//   (coalesced loads of the narrow row) and each tests one bit;
// * else the row itself, copied with cp.async, when it fits: each lane
//   takes a contiguous run of the probes, a binary search for the first
//   and galloping after, in shared memory;
// * else, per item, the window of the row that the item's probes can hit,
//   copied the same way when it fits, or, when even that is too long, the
//   lanes stride the probes with searches resumed in global memory.
// With Items::kPerItem the warp's hits in each item go to I.add(p, c),
// which every lane of the warp calls.
template <class Items>
__device__ __forceinline__ long long warp_chunks(const Items& I,
                                                 long long n_items,
                                                 long long w_total,
                                                 int* win) {
  constexpr unsigned kAll = 0xffffffffu;
  constexpr int kWide = Items::kWarpWin - 4;  // room for the copy's pad
  constexpr long long kBits = 32LL * Items::kWarpWin;
  const int lane = threadIdx.x & 31;
  const long long n_warps = (long long)gridDim.x * (kThreads / 32);
  const long long gw = (long long)blockIdx.x * (kThreads / 32) +
                       (threadIdx.x >> 5);
  int* w = win + (threadIdx.x >> 5) * Items::kWarpWin;
  unsigned* bits = reinterpret_cast<unsigned*>(w);
  const long long chunk = (w_total + n_warps - 1) / n_warps;
  const long long g1 = min(w_total, (gw + 1) * chunk);
  long long g = min(w_total, gw * chunk);
  if (g >= g1) return 0;
  long long p = item_of(I, 0, n_items, g);
  long long base = I.work(p);
  long long next = I.work(p + 1);
  PairRows pr = I.rows(p);
  // the row prepared in w: its mode (0 none, 1 bitmap, 2 copy), first
  // value and span (bitmap) or copy's pad (copy)
  const int* st_row = nullptr;
  int st_mode = 0, st_lo = 0, st_pad = 0;
  unsigned st_span = 0;
  long long cnt = 0;
  while (g < g1) {
    while (next <= g) {  // items without work, or the last one done
      ++p;
      base = next;
      next = I.work(p + 1);
      pr = I.rows(p);
    }
    const long long s = g - base;
    const long long e = min(g1, next) - base;
    long long c = 0;  // this lane's hits in the item's probes [s, e)
    if (pr.wide != st_row) {
      const int v0 = __ldg(pr.wide);
      const long long span = (long long)__ldg(pr.wide + pr.n_wide - 1) - v0
                             + 1;
      __syncwarp();  // every lane is done with the last row
      st_row = pr.wide;
      if (span <= kBits) {
        for (int i = lane; i < (int)((span + 31) >> 5); i += 32) bits[i] = 0;
        __syncwarp();
        for (int j = lane; j < pr.n_wide; j += 32) {
          const unsigned v = (unsigned)(__ldg(pr.wide + j) - v0);
          atomicOr(bits + (v >> 5), 1u << (v & 31));
        }
        st_mode = 1;
        st_lo = v0;
        st_span = (unsigned)span;
      } else if (pr.n_wide <= kWide) {
        st_pad = warp_stage(w, pr.wide, pr.n_wide);
        asm volatile("cp.async.commit_group;\n" ::);
        asm volatile("cp.async.wait_group 0;\n" ::);
        st_mode = 2;
      } else {
        st_mode = 0;
      }
      __syncwarp();
    }
    if (st_mode == 1) {
      for (long long j = s + lane; j < e; j += 32) {
        const int x = __ldg(pr.narrow + j);
        const unsigned d = (unsigned)(x - st_lo);
        c += (d < st_span && ((bits[d >> 5] >> (d & 31)) & 1u) &&
              (!Items::kRest || I.rest(p, x))) ? 1 : 0;
      }
    } else {
      int lo = 0, n_win = pr.n_wide;
      const int* ws = w + st_pad;
      if (st_mode == 0) {  // the window the item's probes can hit
        int hi = pr.n_wide;
        if (lane == 0) {
          lo = global_lower_bound(pr.wide, 0, hi, __ldg(pr.narrow + s));
        } else if (lane == 1) {
          hi = min(hi, global_lower_bound(pr.wide, 0, hi,
                                          __ldg(pr.narrow + e - 1)) + 1);
        }
        lo = __shfl_sync(kAll, lo, 0);
        hi = __shfl_sync(kAll, hi, 1);
        n_win = max(0, hi - lo);
        if (n_win <= kWide) {
          __syncwarp();
          ws = w + warp_stage(w, pr.wide + lo, n_win);
          asm volatile("cp.async.commit_group;\n" ::);
          asm volatile("cp.async.wait_group 0;\n" ::);
          __syncwarp();
          st_row = nullptr;  // a window, not the row: not kept
        }
      }
      if (n_win <= kWide) {
        const int n = (int)(e - s);
        const int run = (n + 31) / 32;
        const int j0 = lane * run;
        const int j1 = min(n, j0 + run);
        const int* xs = pr.narrow + s;
        if (j0 < j1) {
          int q = lower_bound<int>(ws, 0, n_win, __ldg(xs + j0));
          for (int j = j0; j < j1; ++j) {
            const int x = __ldg(xs + j);
            q = shared_gallop(ws, q, n_win, x);
            c += (q < n_win && ws[q] == x &&
                  (!Items::kRest || I.rest(p, x))) ? 1 : 0;
          }
        }
      } else {
        int q = lo;
        for (long long j = s + lane; j < e; j += 32) {
          const int x = __ldg(pr.narrow + j);
          q = global_lower_bound(pr.wide, q, pr.n_wide, x);
          c += hit(I, p, pr, q, x) ? 1 : 0;
        }
      }
    }
    cnt += c;
    if constexpr (Items::kPerItem) I.add(p, c);
    g = base + e;
  }
  return cnt;
}

// the block's shared state between a tile's stages
struct TileShared {
  long long p[2];
  int win[2];
};

// This block's hits over the tiles of the work space [0, w_total) of
// n_items items (work(n_items) == w_total); win is kWinBytes of dynamic
// shared memory. per_item (int32, zeroed by the caller) may be null.
// Every thread of the block calls it; it ends with the block synchronised.
template <class Items>
__device__ __forceinline__ long long count_tiles(const Items& I,
                                                 long long n_items,
                                                 long long w_total, int* win,
                                                 TileShared& S,
                                                 int* __restrict__ per_item) {
  const int lane = threadIdx.x & 31;
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
    if (threadIdx.x == 0) S.p[0] = item_of(I, 0, n_items, g0);
    if (threadIdx.x == 32) S.p[1] = item_of(I, 0, n_items, g1 - 1);
    __syncthreads();
    const long long p0 = S.p[0];
    const long long p1 = S.p[1];
    int lo = 0;
    int n_win = kWin + 1;  // several items: no window
    if (p0 == p1) {
      // the window of the wide row that the tile's narrow slice can hit
      const PairRows pr = I.rows(p0);
      const long long base = I.work(p0);
      if (threadIdx.x == 0) {
        S.win[0] = global_lower_bound(pr.wide, 0, pr.n_wide,
                                      __ldg(pr.narrow + (g0 - base)));
      }
      if (threadIdx.x == 32) {
        S.win[1] = min(pr.n_wide,
                       global_lower_bound(pr.wide, 0, pr.n_wide,
                                          __ldg(pr.narrow + (g1 - 1 - base)))
                           + 1);
      }
      __syncthreads();
      lo = S.win[0];
      n_win = max(0, S.win[1] - lo);
    }
    long long cnt = 0;
    if (n_win <= kWin) {
      const PairRows pr = I.rows(p0);
      const long long base = I.work(p0);
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
          cnt += (q < n_win && w[q] == x &&
                  (!Items::kRest || I.rest(p0, x))) ? 1 : 0;
        }
      }
      if (per_item) {
        const long long c = warp_sum(cnt);
        if (lane == 0 && c) atomicAdd(per_item + p0, (int)c);
      }
    } else if (p1 - p0 + 1 >= kThreads / 32) {
      cnt = warp_items(I, g0, g1, p0, p1, per_item);
    } else {
      cnt = strided_probes(I, g0, g1, p0, p1, lo, per_item);
    }
    acc += cnt;
    __syncthreads();  // the tile's shared state is free for the next one
  }
  return acc;
}

}  // namespace probe
