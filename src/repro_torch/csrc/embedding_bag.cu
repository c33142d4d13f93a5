// EmbeddingBag: out[b] = sum over slots l of table[idx[b, l]], skipping
// every slot whose index is >= V (the reference's PAD == V). Indices are
// read in place, int32 or int64 (a template parameter); any index >= V is
// PAD, int64 values >= 2^31 included. A negative index traps in both
// kernels (a device-side fault, as PyTorch's own index kernels assert): the
// error surfaces at the next synchronisation, and the CUDA context cannot
// be used after it.
//
// Tables are float32 or bfloat16 (a template parameter: float, or the
// bfloat16 bits as uint16_t). A bfloat16 value is widened to float32 (its
// bits in the high half of a float: exact), and the output is float32 for
// both. Every bag's sum is kept in float32 registers, starts from 0 and
// adds the slots in order, in both kernels, so they give the same bits on
// the same table and indices, and a bag's sum is the same on every run. At
// bfloat16 this is the sum the reference DLRM takes (vec.astype(float32),
// then the bag sum: src/repro/models/dlrm.py:110-111), not the TPU dma
// kernel's, which adds in the table's type (kernel.py:48).
//
// Replaces both TPU kernels of src/repro/kernels/embedding_bag/kernel.py:
//
// * _bag_dma_kernel / embedding_bag_pallas_dma (:35, :56): the table stays
//   in HBM; the bag indices are scalar-prefetched into SMEM and each row is
//   DMA'd into VMEM and added. Here rows_kernel ("dma", and "onehot" where
//   no wide slice fits): one warp per bag loads its bag's indices itself
//   (the TPU's scalar prefetch), 32 at a time, broadcasts them with
//   shuffles and reads each live slot's row with 16-byte loads (4 float32
//   or 8 bfloat16 values a lane) when the row is a whole number of 16-byte
//   vectors and the table 16-byte aligned, else one element a load; a PAD
//   slot loads nothing. Row offsets are 64-bit: the largest dlrm-mlperf
//   table is 39,980,032 x 128 (20.5 GB in float32, 10.2 GB in bfloat16).
//   Bound by bytes: each live slot reads one D-wide row.
//
// * _bag_onehot_kernel / embedding_bag_pallas_onehot (:83, :104): the TPU
//   keeps a block of a small table in VMEM and reuses it for a whole tile
//   of bags through a one-hot MXU product. A one-hot product on this card
//   would cost 2 * B * V * D operations (120 GFLOP at V = 7,168, B =
//   65,536), and float32 exactness would take TF32 split three ways. What
//   the design keeps is the reuse of the table in fast memory:
//   slices_kernel holds a column slice of the table in shared memory.
//   - Slices: w elements of every row, the widest power of two from one
//     16-byte vector (4 float32, 8 bfloat16) to 128 with D % w == 0 and
//     V * w * sizeof(element) bytes within a block's 227 KB
//     (ops.onehot_slice_width); the wrapper takes this kernel for w at
//     least its route threshold (ops.onehot_route, whose comment has the
//     measurements). The grid is persistent, one block an SM: D / w slices
//     x floor(SMs / (D / w)) bag ranges (4 x 33 = 132 blocks at w = 32 on
//     132 SMs).
//   - Each block copies its slice of all V rows into dynamic shared memory
//     once (cp.async, 16 bytes a copy), then gathers from there: 4 values a
//     thread (16 bytes of float32, 8 of bfloat16), w / 4 threads a bag, so
//     each thread writes one whole float4 of the output for either type
//     (8 bfloat16 values a thread wrote two float4s at a 32-byte stride,
//     half-sector streaming stores, and took 0.0255 ms at V = 512, L = 1
//     against 0.0146 for the row gather: PERF.md).
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
//   row gather, the slices replace B * L * D * sizeof(element) bytes of L2
//   reads (241.6 MB at L = 8, 10 % PAD, float32) with one slice copy a
//   block (17.3 MB at V = 1,024, w = 32, float32) and D / w reads of the
//   indices. Narrow slices lose that trade: at w = 8 (float32) a block
//   copies 229 KB before it gathers, the 32-byte output pieces are sector
//   writes, and the random rows of 4 bags meet bank conflicts in every 128
//   bytes read (PERF.md).
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

// How a table's elements load and widen to float32: one element, or one
// 16-byte vector of kPer16 elements added into kPer16 float sums.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kPer16 = 4;
  using Piece = uint4;  // 4 values: one output float4
  __device__ static __forceinline__ float one(const float* p) {
    return __ldg(p);
  }
  __device__ static __forceinline__ void add16(float* acc, uint4 u) {
    acc[0] += __uint_as_float(u.x);
    acc[1] += __uint_as_float(u.y);
    acc[2] += __uint_as_float(u.z);
    acc[3] += __uint_as_float(u.w);
  }
  __device__ static __forceinline__ void add4(float* acc, uint4 u) {
    add16(acc, u);
  }
};

// bfloat16, held as its bits: the float32 with those bits in its high half
__device__ __forceinline__ float lo_bf16(unsigned u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float hi_bf16(unsigned u) {
  return __uint_as_float(u & 0xffff0000u);
}

template <>
struct Elem<uint16_t> {
  static constexpr int kPer16 = 8;
  using Piece = uint2;  // 4 values: one output float4
  __device__ static __forceinline__ float one(const uint16_t* p) {
    return __uint_as_float((unsigned)__ldg(p) << 16);
  }
  __device__ static __forceinline__ void add4(float* acc, uint2 u) {
    acc[0] += lo_bf16(u.x);
    acc[1] += hi_bf16(u.x);
    acc[2] += lo_bf16(u.y);
    acc[3] += hi_bf16(u.y);
  }
  __device__ static __forceinline__ void add16(float* acc, uint4 u) {
    // element 2k is the low half of word k (little-endian)
    acc[0] += lo_bf16(u.x);
    acc[1] += hi_bf16(u.x);
    acc[2] += lo_bf16(u.y);
    acc[3] += hi_bf16(u.y);
    acc[4] += lo_bf16(u.z);
    acc[5] += hi_bf16(u.z);
    acc[6] += lo_bf16(u.w);
    acc[7] += hi_bf16(u.w);
  }
};

// n floats from acc to p: float4 stores where n % 4 == 0 (p then 16-byte
// aligned), else one at a time
template <int kN>
__device__ __forceinline__ void store_floats(float* p, const float* acc) {
  if constexpr (kN % 4 == 0) {
#pragma unroll
    for (int j = 0; j < kN / 4; ++j) {
      reinterpret_cast<float4*>(p)[j] = make_float4(
          acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kN; ++j) p[j] = acc[j];
  }
}

// ---------------------------------------------------------------------------
// rows_kernel: one warp per bag, rows read from global memory
// ---------------------------------------------------------------------------

constexpr int kWarps = 8;  // bags per CTA
constexpr int kThreads = kWarps * 32;

// kVec16: 16-byte loads (Elem<T>::kPer16 elements a lane), else one
// element; kCols: loads per lane held in registers per pass over the
// bag's slots
template <typename T, bool kVec16, int kCols, typename IdxT>
__global__ void __launch_bounds__(kThreads)
rows_kernel(const T* __restrict__ table, long long v, long long d,
            const IdxT* __restrict__ idx, long long n_bags, long long ll,
            float* __restrict__ out) {
  constexpr int kPer = kVec16 ? Elem<T>::kPer16 : 1;
  const int lane = threadIdx.x & 31;
  const long long bag = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (bag >= n_bags) return;
  const IdxT* bag_idx = idx + bag * ll;
  const long long dv = d / kPer;  // loads per row
  IdxT seen = 0;
  // loads [c0, c0 + 32 * kCols) of the row
  for (long long c0 = 0; c0 < dv; c0 += 32 * kCols) {
    float acc[kCols * kPer];
#pragma unroll
    for (int i = 0; i < kCols * kPer; ++i) acc[i] = 0.f;
    for (long long s0 = 0; s0 < ll; s0 += 32) {
      const IdxT raw =
          s0 + lane < ll ? __ldg(bag_idx + s0 + lane) : (IdxT)v;
      seen |= raw;
      const int mine = as_row(raw, v);
      const int n_s = (int)(ll - s0 < 32 ? ll - s0 : 32);
      for (int s = 0; s < n_s; ++s) {
        const int r = __shfl_sync(0xffffffffu, mine, s);
        if (r >= v) continue;  // PAD: no load
        const T* row = table + (long long)r * d;
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          const long long c = c0 + lane + 32 * i;
          if (c < dv) {
            if constexpr (kVec16) {
              Elem<T>::add16(acc + i * kPer,
                             __ldg(reinterpret_cast<const uint4*>(row) + c));
            } else {
              acc[i] += Elem<T>::one(row + c);
            }
          }
        }
      }
    }
    float* orow = out + bag * d;
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const long long c = c0 + lane + 32 * i;
      if (c < dv) store_floats<kPer>(orow + c * kPer, acc + i * kPer);
    }
  }
  trap_if_negative(seen);
}

template <typename T, typename IdxT>
void launch_rows(const void* t, long long v, long long d, const void* idx,
                 long long n_bags, long long ll, float* o, bool vec16,
                 unsigned blocks, cudaStream_t s) {
  const T* tab = (const T*)t;
  const IdxT* ix = (const IdxT*)idx;
  if (vec16) {
    // D = 128: a whole row in one pass (float32: 32 lanes x 4; bfloat16:
    // 16 lanes x 8)
    rows_kernel<T, true, 1, IdxT><<<blocks, kThreads, 0, s>>>(
        tab, v, d, ix, n_bags, ll, o);
  } else {
    rows_kernel<T, false, 4, IdxT><<<blocks, kThreads, 0, s>>>(
        tab, v, d, ix, n_bags, ll, o);
  }
}

template <typename T>
void launch_rows_as(const void* t, long long v, long long d, const void* idx,
                    int idx_bytes, long long n_bags, long long ll, float* o,
                    bool vec16, unsigned blocks, cudaStream_t s) {
  if (idx_bytes == 8) {
    launch_rows<T, long long>(t, v, d, idx, n_bags, ll, o, vec16, blocks, s);
  } else {
    launch_rows<T, int>(t, v, d, idx, n_bags, ll, o, vec16, blocks, s);
  }
}

// ---------------------------------------------------------------------------
// slices_kernel: a column slice of the table in shared memory per block
// ---------------------------------------------------------------------------

constexpr int kSliceThreads = 1024;  // one block an SM: 32 warps
constexpr int kSlots = 8;            // indices a stage holds of one bag
constexpr int kMaxW = 128;

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
// the columns (w = 4 << tpb_log values: tpb = 1 << tpb_log pieces of 4
// values a row, a piece 16 bytes of float32 or 8 of bfloat16) and bags
// [range * per_range, ...) of range b / n_slices. Thread t serves bag
// t >> tpb_log of each step, piece t & (tpb - 1) of the slice: 4 columns,
// one float4 of the output, so a warp's stores are whole 16-byte runs for
// either table type.
template <typename T, typename IdxT, int kMode>
__global__ void __launch_bounds__(kSliceThreads, 1)
slices_kernel(const T* __restrict__ table, long long v, long long d,
              int tpb_log, int n_slices, long long per_range,
              const IdxT* __restrict__ idx, long long n_bags, long long ll,
              float* __restrict__ out) {
  using Piece = typename Elem<T>::Piece;
  constexpr int kPer = Elem<T>::kPer16;       // values a 16-byte copy
  extern __shared__ uint4 slice16[];          // v rows x w values
  const Piece* slice = reinterpret_cast<const Piece*>(slice16);
  const int tpb = 1 << tpb_log;
  const int sl = blockIdx.x % n_slices;
  const long long b0 = (long long)(blockIdx.x / n_slices) * per_range;
  const long long b1 = b0 + per_range < n_bags ? b0 + per_range : n_bags;
  if (b0 >= b1) return;
  // the copy, in 16-byte vectors: w / kPer = 1 << vec_log a slice row
  const int vec_log = kPer == 8 ? tpb_log - 1 : tpb_log;
  const long long row16 = d / kPer;  // 16-byte vectors a table row
  const uint4* src = reinterpret_cast<const uint4*>(table) +
                     ((long long)sl << vec_log);
  const int n16 = (int)v << vec_log;
  for (int i = threadIdx.x; i < n16; i += kSliceThreads) {
    cp_async16(slice16 + i, src + (long long)(i >> vec_log) * row16 +
                                (i & ((1 << vec_log) - 1)));
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int q = threadIdx.x & (tpb - 1);
  const int step = kSliceThreads >> tpb_log;  // bags a block step
  const long long out4 = d >> 2;               // float4s an output row
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
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        if (row < v) Elem<T>::add4(acc, slice[(row << tpb_log) + q]);
        if (bu < b1) {
          __stcs(o + bu * out4, make_float4(acc[0], acc[1], acc[2], acc[3]));
        }
      }
    }
  } else {
    for (long long bag = b0 + (threadIdx.x >> tpb_log); bag < b1;
         bag += step) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (long long s0 = 0; s0 < ll; s0 += kSlots) {
        Stage<IdxT, kMode> st;
        st.load(idx + bag * ll + s0, ll - s0, v);
        int r[kSlots];
        st.rows(v, r, seen);
#pragma unroll
        for (int k = 0; k < kSlots; ++k) {
          if (r[k] < v) Elem<T>::add4(acc, slice[(r[k] << tpb_log) + q]);
        }
      }
      __stcs(o + bag * out4, make_float4(acc[0], acc[1], acc[2], acc[3]));
    }
  }
  trap_if_negative(seen);
}

// the dynamic shared memory a block of slices_kernel may take on this
// device, raised to that once per device for each instantiation (which)
int slice_smem_limit(const void* kern, int which) {
  static int limit[12][64];
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

template <typename T, typename IdxT, int kMode>
int launch_slices_as(const void* t, long long v, long long d, int tpb_log,
                     int n_slices, int n_ranges, const void* idx,
                     long long n_bags, long long ll, float* o,
                     cudaStream_t s) {
  const void* kern = (const void*)slices_kernel<T, IdxT, kMode>;
  const size_t smem = (size_t)v * (size_t)(4 << tpb_log) * sizeof(T);
  const int which =
      ((sizeof(T) == 2) * 2 + (sizeof(IdxT) == 8)) * 3 + kMode;
  if ((size_t)slice_smem_limit(kern, which) < smem) {
    return (int)cudaErrorInvalidValue;
  }
  const long long per_range = (n_bags + n_ranges - 1) / n_ranges;
  slices_kernel<T, IdxT, kMode>
      <<<(unsigned)(n_slices * n_ranges), kSliceThreads, smem, s>>>(
          (const T*)t, v, d, tpb_log, n_slices, per_range, (const IdxT*)idx,
          n_bags, ll, o);
  return 0;
}

template <typename T, typename IdxT>
int launch_slices(const void* t, long long v, long long d, int tpb_log,
                  int n_slices, int n_ranges, const void* idx,
                  long long n_bags, long long ll, float* o, cudaStream_t s) {
  if (ll == 1) {
    return launch_slices_as<T, IdxT, kOne>(t, v, d, tpb_log, n_slices,
                                           n_ranges, idx, n_bags, ll, o, s);
  }
  if (ll == 0 || ll % kSlots != 0 ||
      reinterpret_cast<uintptr_t>(idx) % 16 != 0) {
    return launch_slices_as<T, IdxT, kScalar>(t, v, d, tpb_log, n_slices,
                                              n_ranges, idx, n_bags, ll, o,
                                              s);
  }
  return launch_slices_as<T, IdxT, kVector>(t, v, d, tpb_log, n_slices,
                                            n_ranges, idx, n_bags, ll, o, s);
}

template <typename T>
int launch_slices_idx(const void* t, long long v, long long d, int tpb_log,
                      int n_slices, int n_ranges, const void* idx,
                      int idx_bytes, long long n_bags, long long ll,
                      float* o, cudaStream_t s) {
  return idx_bytes == 8
             ? launch_slices<T, long long>(t, v, d, tpb_log, n_slices,
                                           n_ranges, idx, n_bags, ll, o, s)
             : launch_slices<T, int>(t, v, d, tpb_log, n_slices, n_ranges,
                                     idx, n_bags, ll, o, s);
}

}  // namespace

// the row gather ("dma", and "onehot" where no slice fits); elem_bytes is
// the table's element size, 4 (float32) or 2 (bfloat16); idx_bytes the
// index element size, 4 or 8; the output is float32
extern "C" int embedding_bag_rows_launch(const void* table, int elem_bytes,
                                         long long v, long long d,
                                         const void* idx, int idx_bytes,
                                         long long n_bags, long long ll,
                                         void* out, void* stream) {
  if (v < 1 || d < 0 || n_bags < 0 || ll < 0 ||
      (elem_bytes != 4 && elem_bytes != 2) ||
      (idx_bytes != 4 && idx_bytes != 8) ||
      (idx_bytes == 4 && v > 0x7fffffffLL)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_bags == 0 || d == 0) return 0;
  const long long blocks = (n_bags + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int per16 = 16 / elem_bytes;
  const bool vec16 = d % per16 == 0 &&
                     reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  float* o = (float*)out;
  if (elem_bytes == 2) {
    launch_rows_as<uint16_t>(table, v, d, idx, idx_bytes, n_bags, ll, o,
                             vec16, (unsigned)blocks, s);
  } else {
    launch_rows_as<float>(table, v, d, idx, idx_bytes, n_bags, ll, o, vec16,
                          (unsigned)blocks, s);
  }
  return (int)cudaGetLastError();
}

// the column-sliced "onehot" kernel: slices of w elements, n_ranges bag
// ranges (ops.onehot_slice_width and ops.onehot_grid pick both)
extern "C" int embedding_bag_slices_launch(const void* table, int elem_bytes,
                                           long long v, long long d, int w,
                                           int n_ranges, const void* idx,
                                           int idx_bytes, long long n_bags,
                                           long long ll, void* out,
                                           void* stream) {
  if (elem_bytes != 4 && elem_bytes != 2) return (int)cudaErrorInvalidValue;
  const int per16 = 16 / elem_bytes;
  int tpb_log = 0;
  while ((4 << tpb_log) < w) ++tpb_log;
  if (v < 1 || d < 1 || n_bags < 0 || ll < 0 || w < per16 || w > kMaxW ||
      (4 << tpb_log) != w || d % w != 0 || n_ranges < 1 ||
      (idx_bytes != 4 && idx_bytes != 8) ||
      reinterpret_cast<uintptr_t>(table) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_bags == 0) return 0;
  const long long n_slices = d / w;
  if (n_slices * n_ranges > 0x7fffffffLL ||
      v * w * elem_bytes > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  float* o = (float*)out;
  const int rc =
      elem_bytes == 2
          ? launch_slices_idx<uint16_t>(table, v, d, tpb_log, (int)n_slices,
                                        n_ranges, idx, idx_bytes, n_bags, ll,
                                        o, s)
          : launch_slices_idx<float>(table, v, d, tpb_log, (int)n_slices,
                                     n_ranges, idx, idx_bytes, n_bags, ll, o,
                                     s);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
