// Per-row sorted-set intersection counts |row_a(i) ∩ row_b(i)|.
//
// Replaces the TPU kernel src/repro/kernels/intersect/kernel.py
// (_intersect_kernel / intersect_count_pallas), which compares a tile of
// rows against all K lane rotations of the other side: O(K^2) work per
// row, regardless of how many real entries the rows hold.
//
// What bounds it here: memory. Each row pair reads the real entries of its
// narrower row plus ~log2(K) probes into the wider row, and does one
// compare per probe; that is far below the card's integer rate, so the
// reads (L2 / HBM) set the pace.
//
// Design: one warp per row pair. Both rows are sorted, SENTINEL-padded
// sets, so each row's real length is the lower bound of SENTINEL. The
// lanes stride over the narrower row (it ends at its first SENTINEL) and
// binary-search each element in the wider row, each lane resuming from
// its previous hit position because its elements increase: the
// min(d_x, d_y) accounting of Thm. 17, O(K log K) per row instead of
// O(K^2). A warp-shuffle sum gives one int32 per row. Optional row-index
// vectors (ia, ib) let the caller pass the box's padded neighbour matrix
// and its edge endpoints directly, with no gathered (E, K) copies.
// The kernel allocates nothing; the caller passes the output.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSentinel = 0x7fffffff;
constexpr int kThreads = 256;

__device__ __forceinline__ int lower_bound(const int* __restrict__ row,
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

__global__ void __launch_bounds__(kThreads)
intersect_kernel(const int* __restrict__ a, long long lda, int ka,
                 const int* __restrict__ b, long long ldb, int kb,
                 const int* __restrict__ ia, const int* __restrict__ ib,
                 long long n_rows, int* __restrict__ out) {
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_rows) return;  // whole warps leave together
  const long long ra = ia ? (long long)ia[warp] : warp;
  const long long rb = ib ? (long long)ib[warp] : warp;
  const int* pa = a + ra * lda;
  const int* pb = b + rb * ldb;
  int la = lower_bound(pa, 0, ka, kSentinel);
  int lb = lower_bound(pb, 0, kb, kSentinel);
  if (lb < la) {  // probe the narrower row into the wider one
    const int* pt = pa; pa = pb; pb = pt;
    const int lt = la; la = lb; lb = lt;
  }
  int cnt = 0;
  int lo = 0;
  for (int i = lane; i < la; i += 32) {
    const int x = __ldg(pa + i);
    lo = lower_bound(pb, lo, lb, x);
    cnt += (lo < lb && __ldg(pb + lo) == x) ? 1 : 0;
  }
  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
  }
  if (lane == 0) out[warp] = cnt;
}

}  // namespace

extern "C" int intersect_count_launch(const void* a, long long lda, int ka,
                                      const void* b, long long ldb, int kb,
                                      const void* ia, const void* ib,
                                      long long n_rows, void* out,
                                      void* stream) {
  if (n_rows <= 0) return 0;
  const long long warps_per_block = kThreads / 32;
  const long long blocks = (n_rows + warps_per_block - 1) / warps_per_block;
  intersect_kernel<<<(unsigned int)blocks, kThreads, 0,
                     (cudaStream_t)stream>>>(
      (const int*)a, lda, ka, (const int*)b, ldb, kb, (const int*)ia,
      (const int*)ib, n_rows, (int*)out);
  return (int)cudaGetLastError();
}
