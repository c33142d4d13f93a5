// EmbeddingBag: out[b] = sum over slots l of table[idx[b, l]], skipping
// every slot whose index is >= V (the reference's PAD == V).
//
// Replaces both TPU kernels of src/repro/kernels/embedding_bag/kernel.py:
// _bag_dma_kernel / embedding_bag_pallas_dma (the table stays in HBM; the
// bag indices are scalar-prefetched into SMEM and each row is DMA'd into
// VMEM and added) and _bag_onehot_kernel / embedding_bag_pallas_onehot (a
// small table is multiplied by the bags' one-hot histograms on the MXU,
// because the TPU's vector unit has no gather). The one-hot product does
// V/bv times the work of the gather only to use the MXU; on this card a
// table of <= 4 MB sits in the 50 MB L2, so the gather is the right design
// for both modes and one kernel serves them.
//
// What bounds it on this card: bytes. Each non-PAD slot reads one D-wide
// row and adds it (D float additions per 4*D bytes), so the card's memory
// (or L2) rate is the limit, and the design keeps every byte moved useful:
//
// * one CTA per tile of kBagsPerCta bags, one warp per bag;
// * the warp loads its bag's indices itself (the TPU's scalar prefetch),
//   32 at a time, one per lane, and broadcasts them with shuffles;
// * lanes run across D with 16-byte loads (float4) when D % 4 == 0 and
//   the table is 16-byte aligned, else 4-byte loads; a PAD slot loads
//   nothing;
// * each lane keeps its columns' sums in float32 registers and adds the
//   slots in order, so a bag's sum is the same on every run;
// * one store per output element.
//
// Row offsets are 64-bit: the largest table of the dlrm-mlperf
// configuration holds 39,884,800 x 128 floats (20.4 GB).
//
// The kernel allocates nothing; the wrapper passes the output.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
template <int kVec, int kCols>
__global__ void __launch_bounds__(kThreads)
bag_kernel(const float* __restrict__ table, long long v, long long d,
           const int* __restrict__ idx, long long n_bags, long long ll,
           float* __restrict__ out) {
  using T = typename VecT<kVec>::T;
  const int lane = threadIdx.x & 31;
  const long long bag = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (bag >= n_bags) return;
  const int* bag_idx = idx + bag * ll;
  const long long dv = d / kVec;  // vectors per row
  // columns [c0, c0 + 32 * kCols) of the row, in vectors
  for (long long c0 = 0; c0 < dv; c0 += 32 * kCols) {
    float acc[kCols * kVec];
#pragma unroll
    for (int i = 0; i < kCols * kVec; ++i) acc[i] = 0.f;
    for (long long s0 = 0; s0 < ll; s0 += 32) {
      const int mine = s0 + lane < ll ? __ldg(bag_idx + s0 + lane) : (int)v;
      const int n_s = (int)(ll - s0 < 32 ? ll - s0 : 32);
      for (int s = 0; s < n_s; ++s) {
        const int r = __shfl_sync(0xffffffffu, mine, s);
        if ((long long)r >= v) continue;  // PAD: no load
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
}

}  // namespace

extern "C" int embedding_bag_launch(const void* table, long long v,
                                    long long d, const void* idx,
                                    long long n_bags, long long ll, void* out,
                                    void* stream) {
  if (v < 1 || d < 0 || n_bags < 0 || ll < 0) {
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
  const int* ix = (const int*)idx;
  float* o = (float*)out;
  if (vec4) {
    // D = 128 is one float4 per lane: a whole row in one pass
    bag_kernel<4, 1><<<(unsigned)blocks, kThreads, 0, s>>>(t, v, d, ix,
                                                           n_bags, ll, o);
  } else {
    bag_kernel<1, 4><<<(unsigned)blocks, kThreads, 0, s>>>(t, v, d, ix,
                                                           n_bags, ll, o);
  }
  return (int)cudaGetLastError();
}
