// The table gradient of the EmbeddingBag lookup:
//   grad_table[r] = sum of grad_out[b] over the slots (b, s) with
//   idx[b, s] == r < V,
// each row summed in float32, in ascending (b, s) order from 0, and written
// once in the table's type (float32, or bfloat16 rounded to nearest even).
// Slots >= V are empty, as in the forward (csrc/embedding_bag.cu).
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
// Design:
// - The wrapper (kernels/embedding_bag/grad.py) sorts the flattened indices
//   with a stable sort on the card. Equal indices then sit in one run whose
//   positions (perm) ascend in (b, s) order. No host synchronisation.
// - One block of 128 threads (4 warps) per tile of 128 sorted positions.
//   Each thread tests its position for the start of a run of a live row;
//   the block lists its tile's starts in shared memory, split by length.
// - A run of at most kLong slots (most rows of a batch) is a warp's: its
//   lanes read the run's indices and positions 32 at a time, and each lane
//   adds 4 columns, 32 apart, of each slot's gradient row (each load a
//   128-byte read a warp), kWarpBatch rows loaded before any is added.
// - A longer run (a popular row: ~11 % of a 65,536-slot batch on a
//   512-row field) is the whole block's, after the short ones: each thread
//   owns one column, the block stages kChunk slots' bag numbers in shared
//   memory (double-buffered, the next chunk's read while this one is
//   added) and each thread loads kBatch rows' values before it adds any.
// - Every sum starts from 0, adds the run's slots in (b, s) order in
//   float32, and is written once in the table's type. No atomics: the
//   result is the same on every run, and equal bit for bit to the plain
//   version's ordered index_add_ (kernels/embedding_bag/ref.py).
// - A batch's loads are unconditional (a slot past the run reads its last
//   one again and adds -0.0, which changes no value), and a compiler
//   barrier stands between them and its adds, so a batch sits in registers
//   with all its loads in flight.
// - Untouched rows are zero: the wrapper allocates the output with zeros.
// - Indices are int32 or int64 (the sorted keys, a template parameter);
//   a negative index is skipped (the forward traps on one first).
// What bounds it: bytes. Each slot's index and gradient row are read once
// (B * L indices, B * L * D floats) and the V * D output is written once.
// A run is a chain of float32 adds in a fixed order, so its loads, not the
// adds, set the time of a long run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // a block: 4 warps, a tile of 128 positions
constexpr int kWarps = kThreads / 32;
constexpr int kLong = 64;      // runs of more slots are the block's
constexpr int kCols = 4;       // a warp's run: columns a lane a pass
constexpr int kWarpBatch = 8;  // a warp's run: rows a lane loads at once
constexpr int kChunk = kThreads;  // the block's run: slots staged at a time
constexpr int kBatch = 64;     // the block's run: rows a thread loads at once
constexpr unsigned kFull = 0xffffffffu;

template <typename OutT>
__device__ __forceinline__ void store(OutT* p, float a);

template <>
__device__ __forceinline__ void store<float>(float* p, float a) {
  *p = a;
}

template <>
__device__ __forceinline__ void store<__nv_bfloat16>(__nv_bfloat16* p,
                                                     float a) {
  *p = __float2bfloat16_rn(a);
}

// A compiler barrier: no memory access moves across it, so a batch's
// loads are all issued before its first add (without it the compiler sank
// each load to its add: 40 registers, one L2 round trip a slot)
__device__ __forceinline__ void loads_before_adds() {
  asm volatile("" ::: "memory");
}

__device__ __forceinline__ long long bag_of(long long pos, long long ll) {
  return ll == 1 ? pos : pos / ll;
}

// the run of at most kLong slots from sorted position p (key `key`), by
// one warp: lane owns columns c0 + lane + 32 k (k < kCols) of each pass of
// 32 * kCols columns; each of its loads is one 128-byte read a warp
template <typename IdxT, typename OutT>
__device__ __forceinline__ void warp_run(
    const float* __restrict__ grad, long long g_stride,
    const IdxT* __restrict__ keys, const long long* __restrict__ perm,
    long long n, long long ll, long long d, long long p, IdxT key,
    OutT* __restrict__ out, int lane) {
  for (long long c0 = 0; c0 < d; c0 += 32 * kCols) {
    long long cc[kCols];  // a column past the row reads column 0
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const long long c = c0 + lane + 32 * k;
      cc[k] = c < d ? c : 0;
    }
    float acc[kCols];
#pragma unroll
    for (int k = 0; k < kCols; ++k) acc[k] = 0.f;
    for (int h = 0; h < kLong / 32; ++h) {
      const long long j = p + h * 32 + lane;
      const bool ok = j < n;
      const IdxT kj = ok ? keys[j] : key;
      const long long pj = ok ? perm[j] : 0;
      const bool in = ok && kj == key;
      // the run's positions are a prefix of the 32 (keys ascend)
      const int cnt = __popc(__ballot_sync(kFull, in));
      const long long b = in ? bag_of(pj, ll) : 0;
      for (int s0 = 0; s0 < cnt; s0 += kWarpBatch) {
        float x[kWarpBatch][kCols];
#pragma unroll
        for (int s = 0; s < kWarpBatch; ++s) {
          const int k = s0 + s < cnt ? s0 + s : cnt - 1;
          const float* row = grad + __shfl_sync(kFull, b, k) * g_stride;
#pragma unroll
          for (int q = 0; q < kCols; ++q) x[s][q] = __ldg(row + cc[q]);
        }
        loads_before_adds();
#pragma unroll
        for (int s = 0; s < kWarpBatch; ++s) {
#pragma unroll
          for (int q = 0; q < kCols; ++q) {
            acc[q] += s0 + s < cnt ? x[s][q] : -0.f;
          }
        }
      }
      if (cnt < 32) break;
    }
    OutT* o = out + (long long)key * d + c0 + lane;
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      if (c0 + lane + 32 * k < d) store<OutT>(o + 32 * k, acc[k]);
    }
  }
}

// a run of any length from sorted position p, by the whole block: thread
// t owns column c0 + t of each pass of kThreads columns
template <typename IdxT, typename OutT>
__device__ __forceinline__ void block_run(
    const float* __restrict__ grad, long long g_stride,
    const IdxT* __restrict__ keys, const long long* __restrict__ perm,
    long long n, long long ll, long long d, long long p, IdxT key,
    OutT* __restrict__ out, long long (&bags)[2][kChunk]) {
  const int t = threadIdx.x;
  for (long long c0 = 0; c0 < d; c0 += kThreads) {
    const long long c = c0 + t;
    const long long cc = c < d ? c : 0;
    float acc = 0.f;
    long long j0 = p;
    int buf = 0;
    bool in;
    {
      const long long j = j0 + t;
      in = j < n && keys[j] == key;
      if (in) bags[0][t] = bag_of(perm[j], ll);
    }
    int cnt = __syncthreads_count(in);
    while (true) {
      // the next chunk's index and position, read while this one is added
      const long long jn = j0 + kChunk + t;
      const bool more = cnt == kChunk && jn < n;
      const IdxT k_next = more ? keys[jn] : key;
      const long long p_next = more ? perm[jn] : 0;
      for (int s0 = 0; s0 < cnt; s0 += kBatch) {
        float x[kBatch];
#pragma unroll
        for (int s = 0; s < kBatch; ++s) {
          const int k = s0 + s < cnt ? s0 + s : cnt - 1;
          x[s] = __ldg(grad + bags[buf][k] * g_stride + cc);
        }
        loads_before_adds();
#pragma unroll
        for (int s = 0; s < kBatch; ++s) acc += s0 + s < cnt ? x[s] : -0.f;
      }
      if (cnt < kChunk) break;
      in = more && k_next == key;
      if (in) bags[buf ^ 1][t] = bag_of(p_next, ll);
      j0 += kChunk;
      buf ^= 1;
      cnt = __syncthreads_count(in);  // also orders this chunk's reads
    }
    if (c < d) store<OutT>(out + (long long)key * d + c, acc);
    __syncthreads();  // the next pass (or run) restages bags[0]
  }
}

template <typename IdxT, typename OutT>
__global__ void __launch_bounds__(kThreads)
bag_backward_kernel(const float* __restrict__ grad, long long g_stride,
                    const IdxT* __restrict__ keys,
                    const long long* __restrict__ perm, long long n,
                    long long ll, long long v, long long d,
                    OutT* __restrict__ out) {
  __shared__ int short_starts[kThreads];
  __shared__ int long_starts[kThreads];
  __shared__ int n_short, n_long;
  __shared__ long long bags[2][kChunk];
  const int tid = threadIdx.x;
  const long long t0 = (long long)blockIdx.x * kThreads;
  const long long p = t0 + tid;
  if (tid == 0) {
    n_short = 0;
    n_long = 0;
  }
  __syncthreads();
  if (p < n) {
    const IdxT key = keys[p];
    if (key >= 0 && (long long)key < v && (p == 0 || keys[p - 1] != key)) {
      if (p + kLong < n && keys[p + kLong] == key) {
        long_starts[atomicAdd(&n_long, 1)] = tid;
      } else {
        short_starts[atomicAdd(&n_short, 1)] = tid;
      }
    }
  }
  __syncthreads();
  const int ns = n_short, nl = n_long;
  for (int r = tid >> 5; r < ns; r += kWarps) {
    const long long q = t0 + short_starts[r];
    warp_run<IdxT, OutT>(grad, g_stride, keys, perm, n, ll, d, q, keys[q],
                         out, tid & 31);
  }
  for (int r = 0; r < nl; ++r) {
    const long long q = t0 + long_starts[r];
    block_run<IdxT, OutT>(grad, g_stride, keys, perm, n, ll, d, q, keys[q],
                          out, bags);
  }
}

template <typename IdxT, typename OutT>
void launch(const float* g, long long g_stride, const void* keys,
            const long long* perm, long long n, long long ll, long long v,
            long long d, void* out, cudaStream_t s) {
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  bag_backward_kernel<IdxT, OutT><<<blocks, kThreads, 0, s>>>(
      g, g_stride, (const IdxT*)keys, perm, n, ll, v, d, (OutT*)out);
}

template <typename OutT>
void launch_idx(const float* g, long long g_stride, const void* keys,
                int idx_bytes, const long long* perm, long long n,
                long long ll, long long v, long long d, void* out,
                cudaStream_t s) {
  if (idx_bytes == 8) {
    launch<long long, OutT>(g, g_stride, keys, perm, n, ll, v, d, out, s);
  } else {
    launch<int, OutT>(g, g_stride, keys, perm, n, ll, v, d, out, s);
  }
}

}  // namespace

// grad: (B, D) float32 rows g_stride floats apart; keys: the B * L indices
// sorted ascending (int32 or int64, idx_bytes 4 or 8); perm: their int64
// positions in the flattened (B, L) indices, ascending within equal keys
// (a stable sort); out: (V, D) zeros of out_bytes-byte elements, 4
// (float32) or 2 (bfloat16)
extern "C" int embedding_bag_backward_launch(
    const void* grad, long long g_stride, const void* keys, int idx_bytes,
    const void* perm, long long n, long long ll, long long v, long long d,
    void* out, int out_bytes, void* stream) {
  if (v < 1 || d < 0 || n < 0 || ll < 1 || g_stride < d ||
      (idx_bytes != 4 && idx_bytes != 8) ||
      (out_bytes != 4 && out_bytes != 2)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0 || d == 0) return 0;
  if ((n + kThreads - 1) / kThreads > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const float* g = (const float*)grad;
  const long long* p = (const long long*)perm;
  cudaStream_t s = (cudaStream_t)stream;
  if (out_bytes == 2) {
    launch_idx<__nv_bfloat16>(g, g_stride, keys, idx_bytes, p, n, ll, v, d,
                              out, s);
  } else {
    launch_idx<float>(g, g_stride, keys, idx_bytes, p, n, ll, v, d, out, s);
  }
  return (int)cudaGetLastError();
}
