// The table gradient of the EmbeddingBag lookup:
//   grad_table[r] = sum of grad_out[b] over the slots (b, s) with
//   idx[b, s] == r < V,
// each row summed in float32, in ascending (b, s) order from 0, and written
// once in the table's type (float32, or bfloat16 rounded to nearest even).
// Slots >= V are empty, as in the forward (csrc/embedding_bag.cu); rows no
// slot names are zero.
//
// It replaces no Pallas kernel: src/repro/kernels/embedding_bag/ has the
// forward only. The reference trains through jnp.take, and XLA turns that
// gather's gradient into a scatter-add (src/repro/models/dlrm.py:110, and
// :211 in make_sparse_train_step). That scatter-add sits on the training
// path's hottest loop: once per field per step, 26 times a step in the
// dlrm-mlperf configuration. For a bfloat16 table XLA scatter-adds in
// bfloat16; this kernel sums in float32 and casts once (PERF.md records the
// departure).
//
// Input: the flattened indices sorted by a stable sort (keys, and perm,
// their int64 positions in (b, s) order), made by the wrapper
// (kernels/embedding_bag/grad.py) or handed to it by the train step, which
// sorts each field anyway. Equal keys form a run whose positions ascend.
//
// What bounds it: bytes (each slot's index and gradient row read once, the
// V x D output written once), and one floor that exactness sets: a row's
// sum is one chain of float32 adds in slot order, so a run of n slots
// takes at least n dependent adds (4 cycles each) whatever the
// parallelism. Columns are independent; slots are not. So:
//
// - bag_backward_plan (one thread a sorted position) marks each live row
//   that starts a run in a byte map (no atomics: one start a row), and
//   lists every run of more than kLongRun slots as ceil(D / kSlice) work
//   items, one a slice of kSlice columns, appended through an atomic
//   counter to one of two lists: runs of more than kHuge slots, the rest.
// - bag_backward_runs: one launch, three kinds of 128-thread blocks.
//   * Long blocks take the work items. An item of the huge list has a
//     block to itself (while blocks last), so the longest chains start at
//     once and run alone: a 7,000-slot run at D = 128 is 8 items on 8 SMs.
//     The other items go round the remaining long blocks. Warp 0 adds,
//     one column a lane, from a ring of kStages stages of kStage slots'
//     slices in shared memory (48 KB); warps 1-3 fill it in turns, a
//     stage each: one coalesced read of the stage's positions (read a
//     turn early, each item's prefetched into L2), then cp.async copies of
//     each slot's slice (16 bytes a copy; 4 where rows are not 16-byte
//     aligned). mbarriers pair the sides: a stage's "full" completes when
//     its copies land (cp.async.mbarrier.arrive), its "empty" when the
//     adder has read it, so the fillers run up to kStages stages ahead.
//     Stages are 128 slots of 16 columns: the hand-over between the
//     sides has a fixed cost a stage, which 64-slot stages paid twice as
//     often (scripts/kernel_ab_probe.py --bag-variant times the
//     alternatives).
//   * Short blocks: each warp takes the runs that start in its tile of
//     kTile sorted positions, a long one excepted, and walks them as one
//     stream: 32 positions' keys and bags in one coalesced read, kBatch
//     rows in flight a lane (4 columns each, a float4 or 4 scalars 32
//     apart) whatever run each belongs to, added in order, a row stored
//     when the key changes. No run waits out a memory round trip alone.
//   * Zero blocks: each warp writes zeros to the rows of its 32 that the
//     map says no run touched, so the wrapper allocates the output with
//     torch.empty (in the train step every row is touched, and nothing is
//     written twice).
// - Every sum starts from 0 and adds its slots in (b, s) order in float32.
//   No atomics on values and no host synchronisation: the result is the
//   same on every run, and equal bit for bit to the plain version's
//   ordered index_add_ (kernels/embedding_bag/ref.py).
// - Indices are int32 or int64 (the sorted keys, a template parameter);
//   a negative index is skipped (the forward traps on one first).
// A call is one memset (the map and the two counters) and two kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;      // a block of bag_backward_runs
constexpr int kBlocksPerSM = 4;    // resident blocks an SM (registers)
constexpr int kWarps = kThreads / 32;
constexpr int kPlanThreads = 256;
constexpr int kTile = 32;          // sorted positions a short warp takes
constexpr long long kLongRun = 64; // longer runs are split by columns
static_assert(kLongRun >= kTile, "a tile holds at most one long run");
constexpr int kSlice = 16;         // columns of a long run's work item
constexpr int kStage = 128;        // slots a ring stage holds
constexpr int kRingBytes = 48 * 1024;
constexpr int kStages = kRingBytes / (kStage * kSlice * 4);  // 6
constexpr int kChunks = kSlice / 4;     // 16-byte copies a slot's slice
constexpr int kSlotsPerCopy = 32 / kChunks;  // slots a warp-wide copy
constexpr int kFillers = kWarps - 1;
static_assert(kStage % 32 == 0 && kFillers <= kStages, "ring shape");
constexpr int kBatch = 8;          // rows a lane keeps in flight (short)
constexpr int kCols = 4;           // columns a lane owns in a pass
constexpr int kPass = 32 * kCols;  // columns a warp covers in a pass
constexpr long long kHuge = 1024;  // longer runs get blocks alone
constexpr int kLongBlocksPerSM = 2;  // long blocks: 2 an SM
constexpr unsigned kFull = 0xffffffffu;

// a long run's column slice: kSlice columns from slice * kSlice
struct Item {
  long long start;
  int len;
  int slice;
};

template <typename IdxT, typename OutT>
struct Args {
  const float* grad;
  long long g_stride;
  const IdxT* keys;
  const long long* perm;
  long long n, ll, v, d;
  OutT* out;
  const int* counts;  // [0] huge items, [1] the other long items
  const unsigned char* touched;
  const Item* huge;
  const Item* items;
  int long_blocks, short_blocks;
};

__device__ __forceinline__ long long bag_of(long long pos, long long ll) {
  return ll == 1 ? pos : pos / ll;
}

// A compiler barrier: no memory access moves across it, so a batch's
// loads are all issued before its first add
__device__ __forceinline__ void loads_before_adds() {
  asm volatile("" ::: "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(unsigned dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// arrives on `bar` once every cp.async this thread issued has landed
__device__ __forceinline__ void cp_async_arrive(unsigned bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.shared.b64 state, [%0];\n"
      "}\n" ::"r"(bar)
      : "memory");
}

// waits until the phase of `bar` with this parity has completed
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

template <typename OutT>
__device__ __forceinline__ void store1(OutT* p, float a);

template <>
__device__ __forceinline__ void store1<float>(float* p, float a) {
  *p = a;
}

template <>
__device__ __forceinline__ void store1<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float a) {
  *p = __float2bfloat16_rn(a);
}

// a lane's 4 columns of a pass from c0: c0 + 4 lane + k (kVec: one
// 16-byte access) or c0 + lane + 32 k
template <bool kVec>
__device__ __forceinline__ long long col_of(long long c0, int lane, int k) {
  return kVec ? c0 + 4 * lane + k : c0 + lane + 32 * k;
}

// a lane's columns of one gradient row; a column past the row reads
// column 0 (the value is never stored)
template <bool kVec>
__device__ __forceinline__ void load_row(const float* __restrict__ row,
                                         long long c0, int lane, long long d,
                                         float (&x)[kCols]) {
  if (kVec) {
    const long long c = col_of<true>(c0, lane, 0);
    const float4 q = __ldg(reinterpret_cast<const float4*>(row) +
                           (c < d ? c : 0) / 4);
    x[0] = q.x;
    x[1] = q.y;
    x[2] = q.z;
    x[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const long long c = col_of<false>(c0, lane, k);
      x[k] = __ldg(row + (c < d ? c : 0));
    }
  }
}

template <typename OutT, bool kVec>
__device__ __forceinline__ void store_row(OutT* __restrict__ row,
                                          long long c0, int lane,
                                          long long d,
                                          const float (&a)[kCols]) {
  if (kVec) {
    const long long c = col_of<true>(c0, lane, 0);
    if (c >= d) return;
    if constexpr (sizeof(OutT) == 4) {
      *reinterpret_cast<float4*>(row + c) = make_float4(a[0], a[1], a[2],
                                                        a[3]);
    } else {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(a[0], a[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(a[2], a[3]);
      uint2 u;
      u.x = *reinterpret_cast<const unsigned*>(&lo);
      u.y = *reinterpret_cast<const unsigned*>(&hi);
      *reinterpret_cast<uint2*>(row + c) = u;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const long long c = col_of<false>(c0, lane, k);
      if (c < d) store1<OutT>(row + c, a[k]);
    }
  }
}

// the first position in [lo, hi) whose key is >= target (hi if none), by
// the whole warp: 32 probes a round (keys ascend)
template <typename IdxT>
__device__ long long warp_lower_bound(const IdxT* __restrict__ keys,
                                      long long lo, long long hi,
                                      long long target, int lane) {
  while (hi - lo > 32) {
    const long long step = (hi - lo + 31) / 32;
    const long long q = lo + lane * step;
    const bool below = q < hi && (long long)keys[q] < target;
    const int c = __popc(__ballot_sync(kFull, below));
    if (c == 0) return lo;
    const long long nlo = lo + (long long)(c - 1) * step + 1;
    const long long nhi = lo + (long long)c * step + 1;
    lo = nlo;
    hi = nhi < hi ? nhi : hi;
  }
  const long long q = lo + lane;
  const bool below = q < hi && (long long)keys[q] < target;
  return lo + __popc(__ballot_sync(kFull, below));
}

// one thread a sorted position: the touched map and the long runs' items
template <typename IdxT>
__global__ void __launch_bounds__(kPlanThreads)
bag_backward_plan(const IdxT* __restrict__ keys, long long n, long long v,
                  int slices, int* __restrict__ counts,
                  unsigned char* __restrict__ touched, Item* __restrict__ huge,
                  Item* __restrict__ items) {
  const int lane = threadIdx.x & 31;
  const long long p = (long long)blockIdx.x * kPlanThreads + threadIdx.x;
  const bool in = p < n;
  const long long k = in ? (long long)keys[p] : -1;
  const bool start = in && k >= 0 && k < v &&
                     (p == 0 || (long long)keys[p - 1] != k);
  if (start) touched[k] = 1;
  const bool is_long = start && p + kLongRun < n &&
                       (long long)keys[p + kLongRun] == k;
  unsigned m = __ballot_sync(kFull, is_long);
  while (m) {
    const int j = __ffs(m) - 1;
    m &= m - 1;
    const long long s = __shfl_sync(kFull, p, j);
    const long long key = __shfl_sync(kFull, k, j);
    const long long end =
        warp_lower_bound(keys, s + kLongRun + 1, n, key + 1, lane);
    const int len = (int)(end - s);
    const int which = len > kHuge ? 0 : 1;
    int base = 0;
    if (lane == 0) base = atomicAdd(&counts[which], slices);
    base = __shfl_sync(kFull, base, 0);
    Item* list = which == 0 ? huge : items;
    for (int c = lane; c < slices; c += 32) list[base + c] = Item{s, len, c};
  }
}

// the index of long block b's k-th item (-1 past its last): a huge item
// has a block to itself while there are blocks to spare, so the longest
// chains run alone; the other items go round the other blocks
__device__ __forceinline__ long long item_of(long long b, long long k,
                                             long long n_huge,
                                             long long total,
                                             long long blocks) {
  long long it;
  if (n_huge >= blocks) {
    it = b + k * blocks;
  } else if (b < n_huge) {
    it = k == 0 ? b : total;
  } else {
    it = b + k * (blocks - n_huge);
  }
  return it < total ? it : -1;
}

template <typename IdxT, typename OutT>
__device__ __forceinline__ Item item_at(const Args<IdxT, OutT>& a,
                                        long long it, long long n_huge) {
  return it < n_huge ? a.huge[it] : a.items[it - n_huge];
}

// a place in a long block's sequence of stages: stage g, the slots from
// j0 of the block's k-th item (index it, -1 past the last)
struct Walk {
  long long it;
  int g, k, j0;
  Item item;
};

// w at the first stage of the block's k-th item; each filler prefetches
// its third of the item's positions into L2
template <typename IdxT, typename OutT>
__device__ __forceinline__ void walk_item(const Args<IdxT, OutT>& a, Walk& w,
                                          long long b, long long n_huge,
                                          long long total, long long blocks,
                                          int filler, int lane) {
  w.j0 = 0;
  w.it = item_of(b, w.k, n_huge, total, blocks);
  if (w.it < 0) return;
  w.item = item_at(a, w.it, n_huge);
  const long long* first = a.perm + w.item.start;
  for (long long i = 16LL * (filler * 32 + lane); i < w.item.len;
       i += 16LL * 32 * kFillers) {
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(first + i));
  }
}

template <typename IdxT, typename OutT>
__device__ __forceinline__ void walk_step(const Args<IdxT, OutT>& a, Walk& w,
                                          long long b, long long n_huge,
                                          long long total, long long blocks,
                                          int filler, int lane) {
  if (w.it < 0) return;
  ++w.g;
  w.j0 += kStage;
  if (w.j0 >= w.item.len) {
    ++w.k;
    walk_item(a, w, b, n_huge, total, blocks, filler, lane);
  }
}

constexpr int kPosPerLane = kStage / 32;  // a stage's positions a lane

// the positions of w's stage, one coalesced read: lane + 32 i
template <typename IdxT, typename OutT>
__device__ __forceinline__ void read_positions(const Args<IdxT, OutT>& a,
                                               const Walk& w, int lane,
                                               long long (&pos)[kPosPerLane]) {
  const int cnt = w.it < 0 ? 0 : min(kStage, w.item.len - w.j0);
  const long long* p0 = a.perm + w.item.start + w.j0 + lane;
#pragma unroll
  for (int i = 0; i < kPosPerLane; ++i) {
    pos[i] = lane + 32 * i < cnt ? p0[32 * i] : 0;
  }
}

// a long block: warp 0 adds, warps 1-3 fill the ring (file comment)
template <typename IdxT, typename OutT, bool kVec>
__device__ void long_block(const Args<IdxT, OutT>& a, int b) {
  extern __shared__ __align__(128) float ring[];  // kStages x kStage x kSlice
  __shared__ __align__(8) unsigned long long full[kStages], empty[kStages];
  const long long n_huge = a.counts[0];
  const long long total = n_huge + a.counts[1];
  const long long blocks = a.long_blocks;
  if (item_of(b, 0, n_huge, total, blocks) < 0) return;  // the whole block
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_addr(&full[s]), 32);  // a filler warp's lanes
      mbar_init(smem_addr(&empty[s]), 1);  // the adder, once it has read
    }
  }
  __syncthreads();
  if (warp == 0) {
    int s = 0;           // the ring slot of the stage to add
    unsigned phase = 0;  // its round's parity
    long long it;
    for (int k = 0; (it = item_of(b, k, n_huge, total, blocks)) >= 0; ++k) {
      const Item item = item_at(a, it, n_huge);
      const long long key = a.keys[item.start];
      const long long c = (long long)item.slice * kSlice + lane;
      const bool mine = lane < kSlice && c < a.d;
      float acc = 0.f;
      for (int j0 = 0; j0 < item.len; j0 += kStage) {
        mbar_wait(smem_addr(&full[s]), phase);
        const float* src = ring + s * kStage * kSlice + lane % kSlice;
        const int cnt = min(kStage, item.len - j0);
        if (cnt == kStage) {
#pragma unroll
          for (int q = 0; q < kStage; ++q) acc += src[q * kSlice];
        } else {
          for (int q = 0; q < cnt; ++q) acc += src[q * kSlice];
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(smem_addr(&empty[s]));
        if (++s == kStages) {
          s = 0;
          phase ^= 1;
        }
      }
      if (mine) store1<OutT>(a.out + key * a.d + c, acc);
    }
    return;
  }
  // a filler's turns: stages filler, filler + kFillers, ...; the positions
  // of its next turn are read (and each item's prefetched into L2 as its
  // first turn comes up) before it waits to copy this turn's rows
  const int filler = warp - 1;
  Walk cur{0, 0, 0, 0, {}};
  walk_item(a, cur, b, n_huge, total, blocks, filler, lane);
  for (int i = 0; i < filler; ++i) {
    walk_step(a, cur, b, n_huge, total, blocks, filler, lane);
  }
  Walk nxt = cur;
  for (int i = 0; i < kFillers; ++i) {
    walk_step(a, nxt, b, n_huge, total, blocks, filler, lane);
  }
  long long pos[kPosPerLane];
  read_positions(a, cur, lane, pos);
  while (cur.it >= 0) {
    long long pos_next[kPosPerLane];
    read_positions(a, nxt, lane, pos_next);
    const int s = cur.g % kStages;
    const int cnt = min(kStage, cur.item.len - cur.j0);
    const long long c0 = (long long)cur.item.slice * kSlice;
    mbar_wait(smem_addr(&empty[s]), ((cur.g / kStages) & 1) ^ 1);
    long long bag[kPosPerLane];
#pragma unroll
    for (int i = 0; i < kPosPerLane; ++i) bag[i] = bag_of(pos[i], a.ll);
    float* dst = ring + s * kStage * kSlice;
    if (kVec) {
      // kChunks lanes a slot, 16 bytes each: kSlotsPerCopy slots a copy
      const int ch = lane % kChunks;
      const long long col = c0 + 4 * ch;
#pragma unroll
      for (int m = 0; m < kStage / kSlotsPerCopy; ++m) {
        const int q = lane / kChunks + kSlotsPerCopy * m;
        const long long row = __shfl_sync(
            kFull, bag[m * kSlotsPerCopy / 32], q & 31);
        if (q < cnt && col < a.d) {
          cp_async16(smem_addr(dst + q * kSlice + 4 * ch),
                     a.grad + row * a.g_stride + col);
        }
      }
    } else {
      const long long col = c0 + lane;
#pragma unroll 4
      for (int q = 0; q < kStage; ++q) {
        const long long row = __shfl_sync(kFull, bag[q / 32], q & 31);
        if (q < cnt && lane < kSlice && col < a.d) {
          cp_async4(smem_addr(dst + q * kSlice + lane),
                    a.grad + row * a.g_stride + col);
        }
      }
    }
    cp_async_arrive(smem_addr(&full[s]));
    cur = nxt;
#pragma unroll
    for (int i = 0; i < kPosPerLane; ++i) pos[i] = pos_next[i];
    for (int i = 0; i < kFillers; ++i) {
      walk_step(a, nxt, b, n_huge, total, blocks, filler, lane);
    }
  }
  cp_async_wait_all();
}

// a short warp: the runs that start in its tile of kTile sorted positions
// from t0, but a long one, as one stream (file comment)
template <typename IdxT, typename OutT, bool kVec>
__device__ void short_tile(const Args<IdxT, OutT>& a, long long t0,
                           int lane) {
  if (t0 >= a.n) return;
  const long long p = t0 + lane;
  const bool in = p < a.n;
  const long long k = in ? (long long)a.keys[p] : -1;
  long long kp = __shfl_up_sync(kFull, k, 1);
  if (lane == 0) kp = t0 > 0 ? (long long)a.keys[t0 - 1] : -1;
  const unsigned starts =
      __ballot_sync(kFull, in && k >= 0 && k < a.v && (p == 0 || kp != k));
  if (!starts) return;
  const int j_last = 31 - __clz(starts);
  const long long first = t0 + __ffs(starts) - 1;
  const long long last = t0 + j_last;  // the tile's last run start
  const long long k_last = __shfl_sync(kFull, k, j_last);
  // a long run (more than kLongRun slots) is the long blocks'; it is
  // always the last run to start in a tile, as kLongRun >= kTile
  const bool long_last = last + kLongRun < a.n &&
                         (long long)a.keys[last + kLongRun] == k_last;
  for (long long c0 = 0; c0 < a.d; c0 += kPass) {
    float acc[kCols];
#pragma unroll
    for (int i = 0; i < kCols; ++i) acc[i] = 0.f;
    long long cur = -1;  // the key being summed
    for (long long q = first;; q += 32) {
      // the stream's next 32 positions: those before the last start,
      // then the last run unless it is long
      const long long j = q + lane;
      const long long kj = j < a.n ? (long long)a.keys[j] : -1;
      const bool ok = j < a.n && (j < last || (!long_last && kj == k_last));
      const long long bag = ok ? bag_of(a.perm[j], a.ll) : 0;
      const int cnt = __popc(__ballot_sync(kFull, ok));
      for (int s0 = 0; s0 < cnt; s0 += kBatch) {
        float x[kBatch][kCols];
#pragma unroll
        for (int s = 0; s < kBatch; ++s) {
          const int src = min(s0 + s, cnt - 1);
          const long long bs = __shfl_sync(kFull, bag, src);
          load_row<kVec>(a.grad + bs * a.g_stride, c0, lane, a.d, x[s]);
        }
        loads_before_adds();
#pragma unroll
        for (int s = 0; s < kBatch; ++s) {
          const long long ks = __shfl_sync(kFull, kj, min(s0 + s, 31));
          if (s0 + s < cnt) {
            if (ks != cur) {
              if (cur >= 0) store_row<OutT, kVec>(a.out + cur * a.d, c0,
                                                  lane, a.d, acc);
              cur = ks;
#pragma unroll
              for (int i = 0; i < kCols; ++i) acc[i] = 0.f;
            }
#pragma unroll
            for (int i = 0; i < kCols; ++i) acc[i] += x[s][i];
          }
        }
      }
      if (cnt < 32) break;
    }
    if (cur >= 0) store_row<OutT, kVec>(a.out + cur * a.d, c0, lane, a.d,
                                        acc);
  }
}

// a zero warp: the untouched rows of its 32 from r0
template <typename IdxT, typename OutT, bool kVec>
__device__ void zero_tile(const Args<IdxT, OutT>& a, long long r0, int lane) {
  if (r0 >= a.v) return;
  const long long r = r0 + lane;
  unsigned m = __ballot_sync(kFull, r < a.v && !a.touched[r]);
  float zero[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) zero[i] = 0.f;
  while (m) {
    const int i = __ffs(m) - 1;
    m &= m - 1;
    OutT* row = a.out + (r0 + i) * a.d;
    for (long long c0 = 0; c0 < a.d; c0 += kPass) {
      store_row<OutT, kVec>(row, c0, lane, a.d, zero);
    }
  }
}

template <typename IdxT, typename OutT, bool kVec>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
bag_backward_runs(const Args<IdxT, OutT> a) {
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (b < a.long_blocks) {
    long_block<IdxT, OutT, kVec>(a, b);
  } else if (b < a.long_blocks + a.short_blocks) {
    const long long w = (long long)(b - a.long_blocks) * kWarps + warp;
    short_tile<IdxT, OutT, kVec>(a, w * kTile, lane);
  } else {
    const long long w =
        (long long)(b - a.long_blocks - a.short_blocks) * kWarps + warp;
    zero_tile<IdxT, OutT, kVec>(a, w * 32, lane);
  }
}

long long cdiv(long long x, long long y) { return (x + y - 1) / y; }

long long round16(long long x) { return cdiv(x, 16) * 16; }

long long slices_of(long long d) { return cdiv(d, kSlice); }

// the two item lists' capacities: every long run has more than kLongRun
// slots, every huge one more than kHuge
long long item_cap(long long n, long long d) {
  return n / (kLongRun + 1) * slices_of(d);
}

long long huge_cap(long long n, long long d) {
  return n / (kHuge + 1) * slices_of(d);
}

// per device, read once: its SM count, and whether the ring's shared
// memory is allowed yet (an instantiation each)
constexpr int kMaxDevices = 64;

int sm_count(int dev) {
  static int sms[kMaxDevices] = {};
  if (dev < kMaxDevices && sms[dev]) return sms[dev];
  int n = 0;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  n = n < 1 ? 1 : n;
  if (dev < kMaxDevices) sms[dev] = n;
  return n;
}

template <typename IdxT, typename OutT, bool kVec>
int launch(Args<IdxT, OutT> a, unsigned char* work, cudaStream_t s) {
  int* counts = (int*)work;
  unsigned char* touched = work + 16;
  Item* huge = (Item*)(work + 16 + round16(a.v));
  Item* items = huge + huge_cap(a.n, a.d);
  cudaError_t err = cudaMemsetAsync(work, 0, 16 + a.v, s);
  if (err != cudaSuccess) return (int)err;
  if (a.n > 0) {
    bag_backward_plan<IdxT><<<(unsigned)cdiv(a.n, kPlanThreads),
                              kPlanThreads, 0, s>>>(
        a.keys, a.n, a.v, (int)slices_of(a.d), counts, touched, huge,
        items);
  }
  int dev = 0;
  cudaGetDevice(&dev);
  const long long cap = item_cap(a.n, a.d);
  const long long most = (long long)kLongBlocksPerSM * sm_count(dev);
  const long long long_blocks = cap < most ? cap : most;
  const long long short_blocks = cdiv(cdiv(a.n, kTile), kWarps);
  const long long zero_blocks = cdiv(cdiv(a.v, 32), kWarps);
  const long long blocks = long_blocks + short_blocks + zero_blocks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  a.counts = counts;
  a.touched = touched;
  a.huge = huge;
  a.items = items;
  a.long_blocks = (int)long_blocks;
  a.short_blocks = (int)short_blocks;
  const int smem = long_blocks ? kRingBytes : 0;
  static bool ring_allowed[kMaxDevices] = {};
  if (smem && (dev >= kMaxDevices || !ring_allowed[dev])) {
    err = cudaFuncSetAttribute(bag_backward_runs<IdxT, OutT, kVec>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kRingBytes);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) ring_allowed[dev] = true;
  }
  bag_backward_runs<IdxT, OutT, kVec><<<(unsigned)blocks, kThreads, smem,
                                        s>>>(a);
  return (int)cudaGetLastError();
}

template <typename IdxT, typename OutT>
int launch_vec(Args<IdxT, OutT> a, unsigned char* work, cudaStream_t s) {
  // 16-byte accesses where every row and slice starts 16-byte aligned
  const bool vec = a.d % 4 == 0 && a.g_stride % 4 == 0 &&
                   (unsigned long long)a.grad % 16 == 0 &&
                   (unsigned long long)a.out % 16 == 0;
  return vec ? launch<IdxT, OutT, true>(a, work, s)
             : launch<IdxT, OutT, false>(a, work, s);
}

template <typename OutT>
int launch_idx(const float* g, long long g_stride, const void* keys,
               int idx_bytes, const long long* perm, long long n,
               long long ll, long long v, long long d, void* out,
               unsigned char* work, cudaStream_t s) {
  if (idx_bytes == 8) {
    Args<long long, OutT> a{g, g_stride, (const long long*)keys, perm, n, ll,
                            v, d, (OutT*)out};
    return launch_vec(a, work, s);
  }
  Args<int, OutT> a{g, g_stride, (const int*)keys, perm, n, ll, v, d,
                    (OutT*)out};
  return launch_vec(a, work, s);
}

}  // namespace

// bytes of scratch a call needs (the map, the counters, the item lists)
extern "C" long long embedding_bag_backward_workspace(long long n,
                                                      long long v,
                                                      long long d) {
  if (n < 0 || v < 1 || d < 0) return -1;
  return 16 + round16(v) +
         (long long)sizeof(Item) * (huge_cap(n, d) + item_cap(n, d));
}

// grad: (B, D) float32 rows g_stride floats apart; keys: the B * L indices
// sorted ascending (int32 or int64, idx_bytes 4 or 8); perm: their int64
// positions in the flattened (B, L) indices, ascending within equal keys
// (a stable sort); out: (V, D), out_bytes-byte elements, 4 (float32) or 2
// (bfloat16), every element written; work: work_bytes of scratch, at
// least embedding_bag_backward_workspace's
extern "C" int embedding_bag_backward_launch(
    const void* grad, long long g_stride, const void* keys, int idx_bytes,
    const void* perm, long long n, long long ll, long long v, long long d,
    void* out, int out_bytes, void* work, long long work_bytes,
    void* stream) {
  if (v < 1 || v > 0x7fffffffLL || d < 0 || n < 0 || n > 0x7fffffffLL ||
      ll < 1 || g_stride < d || (idx_bytes != 4 && idx_bytes != 8) ||
      (out_bytes != 4 && out_bytes != 2) ||
      work_bytes < embedding_bag_backward_workspace(n, v, d)) {
    return (int)cudaErrorInvalidValue;
  }
  if (d == 0) return 0;
  const float* g = (const float*)grad;
  const long long* p = (const long long*)perm;
  unsigned char* w = (unsigned char*)work;
  cudaStream_t s = (cudaStream_t)stream;
  if (out_bytes == 2) {
    return launch_idx<__nv_bfloat16>(g, g_stride, keys, idx_bytes, p, n, ll,
                                     v, d, out, w, s);
  }
  return launch_idx<float>(g, g_stride, keys, idx_bytes, p, n, ll, v, d, out,
                           w, s);
}
