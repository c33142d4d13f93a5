// EmbeddingBag: out[b] = sum over slots l of table[idx[b, l]], skipping
// every slot whose index is >= V (the reference's PAD == V). Indices are
// read in place, int32 or int64 (a template parameter); any index >= V is
// PAD, int64 values >= 2^31 included. A negative index traps in both
// kernels (a device-side fault, as PyTorch's own index kernels assert): the
// error surfaces at the next synchronisation, and the CUDA context cannot
// be used after it.
//
// Every bag's sum is kept in float32 registers, starts from 0 and adds
// the slots in order, in both kernels, so they give the same bits on the
// same table and indices, and a bag's sum is the same on every run.
//
// Replaces both TPU kernels of src/repro/kernels/embedding_bag/kernel.py:
//
// * _bag_dma_kernel / embedding_bag_pallas_dma (:35, :56): the table stays
//   in HBM; the bag indices are scalar-prefetched into SMEM and each row is
//   DMA'd into VMEM and added. Here rows_kernel ("dma", and "onehot" where
//   no wide slice fits): one warp per bag loads its bag's indices itself
//   (the TPU's scalar prefetch), 32 at a time, broadcasts them with
//   shuffles and reads each live slot's row with 16-byte loads (float4)
//   when D % 4 == 0 and the table is 16-byte aligned, else 4-byte loads; a
//   PAD slot loads nothing. Row offsets are 64-bit: the largest
//   dlrm-mlperf table is 39,980,032 x 128 floats (20.5 GB). Bound by
//   bytes: each live slot reads one D-wide row.
//
// * _bag_onehot_kernel / embedding_bag_pallas_onehot (:83, :104): the TPU
//   keeps a block of a small table in VMEM and reuses it for a whole tile
//   of bags through a one-hot MXU product. A one-hot product on this card
//   would cost 2 * B * V * D operations (120 GFLOP at V = 7,168, B =
//   65,536), and float32 exactness would take TF32 split three ways. What
//   the design keeps is the reuse of the table in fast memory:
//   slices_kernel holds a column slice of the table in shared memory.
//   - Slices: w floats of every row, the widest power of two from 4 to 128
//     with D % w == 0 and V * w * 4 bytes within a block's 227 KB
//     (ops.onehot_slice_width); the wrapper takes this kernel for w >= 32
//     (ops.onehot_route, whose comment has the measurements). The grid is
//     persistent, one block an SM: D / w slices x floor(SMs / (D / w)) bag
//     ranges (4 x 33 = 132 blocks at w = 32 on 132 SMs).
//   - Each block copies its slice of all V rows into dynamic shared memory
//     once (cp.async, 16 bytes a copy), then gathers from there: w / 4
//     threads a bag, one float4 column each.
//   - Indices: each thread reads its own bag's indices in place, 8 at a
//     time into registers (16-byte loads where the bag length allows);
//     at L = 1 it takes 8 bags at once, so that their loads are in flight
//     together (one at a time, each thread waits out an L2 round trip per
//     16 bytes it gathers).
//   - Output: written once, a w-float piece per (bag, slice), with
//     streaming stores (__stcs), so the output does not push the table and
//     the indices out of L2.
//   What bounds it: the output write (33.5 MB at B = 65,536, D = 128) and
//   the slice copy at L = 1; the shared-memory gathers and the index loads
//   at L = 8, all through the SM's L1/shared-memory data path. Against the
//   row gather, the slices replace B * L * D * 4 bytes of L2 reads (241.6
//   MB at L = 8, 10 % PAD) with one slice copy a block (17.3 MB at V =
//   1,024, w = 32) and D / w reads of the indices. Narrow slices lose
//   that trade: at w = 8 a block copies 229 KB before it gathers, the
//   32-byte output pieces are sector writes, and the random rows of 4
//   bags meet bank conflicts in every 128 bytes read (PERF.md).
//
// The kernels allocate nothing; the wrapper passes the output.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

// A negative index traps: each thread ORs every index it reads into one
// word and tests its sign when it is done, so the gather loops carry no
// branch for it (an assert() on each index made the row gather 0.0180 ms
// at L = 1 against 0.0144 without, a trap on each chunk 0.0173: PERF.md).
// Its bags' sums are written by then, but the launch fails all the same.
template <typename IdxT>
__device__ __forceinline__ void trap_if_negative(IdxT seen) {
  if (seen < 0) __trap();  // embedding_bag: negative index
}

// an index as a row number below v (< 2^31), or v for PAD (>= v) and for
// a negative index, which trap_if_negative then reports
template <typename IdxT>
__device__ __forceinline__ int as_row(IdxT r, long long v) {
  return (unsigned long long)(long long)r >= (unsigned long long)v ? (int)v
                                                                  : (int)r;
}

// ---------------------------------------------------------------------------
// rows_kernel: one warp per bag, rows read from global memory
// ---------------------------------------------------------------------------

constexpr int kWarps = 8;  // bags per CTA
constexpr int kThreads = kWarps * 32;

template <int kVec>
struct VecT;
template <>
struct VecT<1> {
  using T = float;
};
template <>
struct VecT<4> {
  using T = float4;
};

__device__ __forceinline__ void add_to(float* acc, float v) { acc[0] += v; }
__device__ __forceinline__ void add_to(float* acc, float4 v) {
  acc[0] += v.x;
  acc[1] += v.y;
  acc[2] += v.z;
  acc[3] += v.w;
}
__device__ __forceinline__ void store(float* p, const float* acc,
                                      VecT<1>) {
  *p = acc[0];
}
__device__ __forceinline__ void store(float* p, const float* acc,
                                      VecT<4>) {
  *reinterpret_cast<float4*>(p) = make_float4(acc[0], acc[1], acc[2], acc[3]);
}

// kCols: vectors per lane held in registers per pass over the bag's slots
template <int kVec, int kCols, typename IdxT>
__global__ void __launch_bounds__(kThreads)
rows_kernel(const float* __restrict__ table, long long v, long long d,
            const IdxT* __restrict__ idx, long long n_bags, long long ll,
            float* __restrict__ out) {
  using T = typename VecT<kVec>::T;
  const int lane = threadIdx.x & 31;
  const long long bag = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (bag >= n_bags) return;
  const IdxT* bag_idx = idx + bag * ll;
  const long long dv = d / kVec;  // vectors per row
  IdxT seen = 0;
  // columns [c0, c0 + 32 * kCols) of the row, in vectors
  for (long long c0 = 0; c0 < dv; c0 += 32 * kCols) {
    float acc[kCols * kVec];
#pragma unroll
    for (int i = 0; i < kCols * kVec; ++i) acc[i] = 0.f;
    for (long long s0 = 0; s0 < ll; s0 += 32) {
      const IdxT raw =
          s0 + lane < ll ? __ldg(bag_idx + s0 + lane) : (IdxT)v;
      seen |= raw;
      const int mine = as_row(raw, v);
      const int n_s = (int)(ll - s0 < 32 ? ll - s0 : 32);
      for (int s = 0; s < n_s; ++s) {
        const int r = __shfl_sync(0xffffffffu, mine, s);
        if (r >= v) continue;  // PAD: no load
        const T* row = reinterpret_cast<const T*>(table + (long long)r * d);
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          const long long c = c0 + lane + 32 * i;
          if (c < dv) add_to(acc + i * kVec, __ldg(row + c));
        }
      }
    }
    float* orow = out + bag * d;
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const long long c = c0 + lane + 32 * i;
      if (c < dv) store(orow + c * kVec, acc + i * kVec, VecT<kVec>{});
    }
  }
  trap_if_negative(seen);
}

template <typename IdxT>
void launch_rows(const float* t, long long v, long long d, const void* idx,
                 long long n_bags, long long ll, float* o, bool vec4,
                 unsigned blocks, cudaStream_t s) {
  const IdxT* ix = (const IdxT*)idx;
  if (vec4) {
    // D = 128 is one float4 per lane: a whole row in one pass
    rows_kernel<4, 1, IdxT><<<blocks, kThreads, 0, s>>>(t, v, d, ix, n_bags,
                                                        ll, o);
  } else {
    rows_kernel<1, 4, IdxT><<<blocks, kThreads, 0, s>>>(t, v, d, ix, n_bags,
                                                        ll, o);
  }
}

// ---------------------------------------------------------------------------
// slices_kernel: a column slice of the table in shared memory per block
// ---------------------------------------------------------------------------

constexpr int kSliceThreads = 1024;  // one block an SM: 32 warps
constexpr int kSlots = 8;            // indices a stage holds of one bag
constexpr int kMinW = 4, kMaxW = 128;

// how a thread gets its bags' indices
enum IdxMode {
  kOne = 0,     // ll == 1: one load per bag, kOneU bags at once (a bag at
                // a time leaves a thread waiting out an L2 round trip for
                // each 16 bytes it gathers)
  kScalar = 1,  // one load per index
  kVector = 2,  // 16-byte loads (ll % kSlots == 0, idx 16-byte aligned)
};
constexpr int kOneU = 8;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}


__device__ __forceinline__ void add_row(float4& acc, const float4* slice,
                                        int row, int tpb_log, int q) {
  const float4 x = slice[(row << tpb_log) + q];
  acc.x += x.x;
  acc.y += x.y;
  acc.z += x.z;
  acc.w += x.w;
}

// kScalar / kVector: kSlots indices of a thread's own bag from p on
// (`left` slots of the bag remain there), as loaded
template <typename IdxT, int kMode>
struct Stage {
  IdxT r[kSlots];

  __device__ __forceinline__ void load(const IdxT* p, long long left,
                                       long long v) {
    if constexpr (kMode == kVector) {
      constexpr int kPer = 16 / sizeof(IdxT);
#pragma unroll
      for (int c = 0; c < kSlots / kPer; ++c) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + c);
        memcpy(r + c * kPer, &u, 16);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kSlots; ++k) r[k] = k < left ? __ldg(p + k) : (IdxT)v;
    }
  }

  __device__ __forceinline__ void rows(long long v, int (&out)[kSlots],
                                       IdxT& seen) {
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      seen |= r[k];
      out[k] = as_row(r[k], v);
    }
  }
};

// grid: n_slices * n_ranges blocks; block b takes slice b % n_slices of
// the columns (w = 4 << tpb_log floats) and bags [range * per_range, ...)
// of range b / n_slices. Thread t serves bag t >> tpb_log of each step,
// float4 column t & (tpb - 1) of the slice.
template <typename IdxT, int kMode>
__global__ void __launch_bounds__(kSliceThreads, 1)
slices_kernel(const float* __restrict__ table, long long v, long long d,
              int tpb_log, int n_slices, long long per_range,
              const IdxT* __restrict__ idx, long long n_bags, long long ll,
              float* __restrict__ out) {
  extern __shared__ float4 slice[];  // v rows x tpb float4
  const int tpb = 1 << tpb_log;
  const int sl = blockIdx.x % n_slices;
  const long long b0 = (long long)(blockIdx.x / n_slices) * per_range;
  const long long b1 = b0 + per_range < n_bags ? b0 + per_range : n_bags;
  if (b0 >= b1) return;
  const long long row4 = d >> 2;  // float4s a table or output row
  const float4* src = reinterpret_cast<const float4*>(table) +
                      (long long)sl * tpb;
  const int n4 = (int)v << tpb_log;
  for (int i = threadIdx.x; i < n4; i += kSliceThreads) {
    cp_async16(slice + i, src + (long long)(i >> tpb_log) * row4 +
                              (i & (tpb - 1)));
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int q = threadIdx.x & (tpb - 1);
  const int step = kSliceThreads >> tpb_log;  // bags a block step
  float4* o = reinterpret_cast<float4*>(out) + (long long)sl * tpb + q;
  IdxT seen = 0;
  if constexpr (kMode == kOne) {
    for (long long bag = b0 + (threadIdx.x >> tpb_log); bag < b1;
         bag += (long long)step * kOneU) {
      IdxT r[kOneU];
#pragma unroll
      for (int u = 0; u < kOneU; ++u) {
        const long long bu = bag + (long long)u * step;
        r[u] = bu < b1 ? __ldg(idx + bu) : (IdxT)v;
        seen |= r[u];
      }
#pragma unroll
      for (int u = 0; u < kOneU; ++u) {
        const long long bu = bag + (long long)u * step;
        const int row = as_row(r[u], v);
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row < v) add_row(acc, slice, row, tpb_log, q);
        if (bu < b1) __stcs(o + bu * row4, acc);
      }
    }
  } else {
    for (long long bag = b0 + (threadIdx.x >> tpb_log); bag < b1;
         bag += step) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (long long s0 = 0; s0 < ll; s0 += kSlots) {
        Stage<IdxT, kMode> st;
        st.load(idx + bag * ll + s0, ll - s0, v);
        int r[kSlots];
        st.rows(v, r, seen);
#pragma unroll
        for (int k = 0; k < kSlots; ++k) {
          if (r[k] < v) add_row(acc, slice, r[k], tpb_log, q);
        }
      }
      __stcs(o + bag * row4, acc);
    }
  }
  trap_if_negative(seen);
}

// the dynamic shared memory a block of slices_kernel may take on this
// device, raised to that once per device for each instantiation (which)
int slice_smem_limit(const void* kern, int which) {
  static int limit[6][64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (limit[which][dev] == 0) {
    int bytes = 0;
    if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess ||
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes) != cudaSuccess) {
      return 0;
    }
    limit[which][dev] = bytes;
  }
  return limit[which][dev];
}

template <typename IdxT, int kMode>
int launch_slices_as(const float* t, long long v, long long d, int tpb_log,
                     int n_slices, int n_ranges, const void* idx,
                     long long n_bags, long long ll, float* o,
                     cudaStream_t s) {
  const void* kern = (const void*)slices_kernel<IdxT, kMode>;
  const size_t smem = (size_t)v * (size_t)(16 << tpb_log);
  const int which = (sizeof(IdxT) == 8) * 3 + kMode;
  if ((size_t)slice_smem_limit(kern, which) < smem) {
    return (int)cudaErrorInvalidValue;
  }
  const long long per_range = (n_bags + n_ranges - 1) / n_ranges;
  slices_kernel<IdxT, kMode>
      <<<(unsigned)(n_slices * n_ranges), kSliceThreads, smem, s>>>(
          t, v, d, tpb_log, n_slices, per_range, (const IdxT*)idx, n_bags,
          ll, o);
  return 0;
}

template <typename IdxT>
int launch_slices(const float* t, long long v, long long d, int tpb_log,
                  int n_slices, int n_ranges, const void* idx,
                  long long n_bags, long long ll, float* o, cudaStream_t s) {
  if (ll == 1) {
    return launch_slices_as<IdxT, kOne>(t, v, d, tpb_log, n_slices, n_ranges,
                                        idx, n_bags, ll, o, s);
  }
  if (ll == 0 || ll % kSlots != 0 ||
      reinterpret_cast<uintptr_t>(idx) % 16 != 0) {
    return launch_slices_as<IdxT, kScalar>(t, v, d, tpb_log, n_slices,
                                           n_ranges, idx, n_bags, ll, o, s);
  }
  return launch_slices_as<IdxT, kVector>(t, v, d, tpb_log, n_slices,
                                         n_ranges, idx, n_bags, ll, o, s);
}

}  // namespace

// the row gather ("dma", and "onehot" where no slice fits); idx_bytes is
// the index element size, 4 or 8
extern "C" int embedding_bag_rows_launch(const void* table, long long v,
                                         long long d, const void* idx,
                                         int idx_bytes, long long n_bags,
                                         long long ll, void* out,
                                         void* stream) {
  if (v < 1 || d < 0 || n_bags < 0 || ll < 0 ||
      (idx_bytes != 4 && idx_bytes != 8) ||
      (idx_bytes == 4 && v > 0x7fffffffLL)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_bags == 0 || d == 0) return 0;
  const long long blocks = (n_bags + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool vec4 = d % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  const float* t = (const float*)table;
  float* o = (float*)out;
  if (idx_bytes == 8) {
    launch_rows<long long>(t, v, d, idx, n_bags, ll, o, vec4,
                           (unsigned)blocks, s);
  } else {
    launch_rows<int>(t, v, d, idx, n_bags, ll, o, vec4, (unsigned)blocks, s);
  }
  return (int)cudaGetLastError();
}

// the column-sliced "onehot" kernel: slices of w floats, n_ranges bag
// ranges (ops.onehot_slice_width and ops.onehot_grid pick both)
extern "C" int embedding_bag_slices_launch(const void* table, long long v,
                                           long long d, int w, int n_ranges,
                                           const void* idx, int idx_bytes,
                                           long long n_bags, long long ll,
                                           void* out, void* stream) {
  int tpb_log = 0;
  while ((4 << tpb_log) < w) ++tpb_log;
  if (v < 1 || d < 1 || n_bags < 0 || ll < 0 || w < kMinW || w > kMaxW ||
      (4 << tpb_log) != w || d % w != 0 || n_ranges < 1 ||
      (idx_bytes != 4 && idx_bytes != 8) ||
      reinterpret_cast<uintptr_t>(table) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_bags == 0) return 0;
  const long long n_slices = d / w;
  if (n_slices * n_ranges > 0x7fffffffLL || v * w * 4 > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const float* t = (const float*)table;
  float* o = (float*)out;
  const int rc =
      idx_bytes == 8
          ? launch_slices<long long>(t, v, d, tpb_log, (int)n_slices,
                                     n_ranges, idx, n_bags, ll, o, s)
          : launch_slices<int>(t, v, d, tpb_log, (int)n_slices, n_ranges,
                               idx, n_bags, ll, o, s);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
