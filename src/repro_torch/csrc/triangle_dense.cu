// Masked dense triangle count  Σ mask ⊙ (A · Bᵀ)  over 0/1 uint8 tiles.
//
// Replaces the TPU kernel src/repro/kernels/triangle_dense/kernel.py
// (_tri_kernel / triangle_count_pallas), a float32 matrix-unit product
// with the mask applied at the last k-step and float32 partial sums, which
// is exact only up to 2^24 paths per box.
//
// What bounds it here: operations. The product does 2·nx·ny·d byte
// operations on nx·d + ny·d + nx·ny bytes. Against the int8 tensor-core
// peak a box whose z domain d is much wider than its row counts sits near
// the bytes/operations balance, but this kernel multiplies on the CUDA
// cores (__dp4a), whose rate is far below the tensor cores', so the
// arithmetic sets its pace.
//
// Design: one 256-thread block per 64×64 output tile and k-range. A box's
// one-hots are often a few hundred rows by tens of thousands of columns,
// so the output tiles alone would leave most SMs idle: the k axis is split
// until tiles × splits reaches ~8 blocks per SM. Each block loops over
// 64-byte shared-memory tiles of A and B, packs the bytes four to a 32-bit
// word and multiplies them with __dp4a (four byte products per
// instruction) into unsigned 32-bit accumulators, 4×4 cells per thread:
// exact for 0/1 inputs while d < 2^32. The mask is applied in the
// epilogue of every k-range (the sum is linear in k), each block reduces
// its cells to one 64-bit partial, and the caller sums the partials in
// int64 (the reference also sums its partials outside the kernel). Rows
// whose byte offset is a multiple of 4 take one 32-bit load per word.
// Tensor-core int8 products and bit-packed operands are later work. The
// kernel allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;          // output rows and columns per block
constexpr int kKBytes = 64;        // k-depth per shared-memory step, bytes
constexpr int kKWords = kKBytes / 4;
constexpr int kThreads = 256;      // 16 × 16 threads, 4 × 4 cells each
constexpr long long kTargetBlocks = 1056;  // 8 blocks per SM on 132 SMs
constexpr long long kMinSplitBytes = 4 * kKBytes;

// k-range of one split: bytes per split (a multiple of kKBytes) and the
// number of splits, chosen so tiles × splits reaches kTargetBlocks
__host__ __device__ inline void k_split(int nx, int ny, long long d,
                                        long long* chunk, int* splits) {
  const long long tiles =
      (long long)((nx + kTile - 1) / kTile) * ((ny + kTile - 1) / kTile);
  long long s = (kTargetBlocks + tiles - 1) / tiles;
  const long long s_max = (d + kMinSplitBytes - 1) / kMinSplitBytes;
  if (s > s_max) s = s_max;
  if (s < 1) s = 1;
  long long c = (d + s - 1) / s;
  c = (c + kKBytes - 1) / kKBytes * kKBytes;
  if (c < kKBytes) c = kKBytes;
  *chunk = c;
  *splits = (int)((d + c - 1) / c);
  if (*splits < 1) *splits = 1;
}

// 4 consecutive bytes of one row starting at k0, zero past the row's end
__device__ __forceinline__ uint32_t load_word(const uint8_t* __restrict__ row,
                                              long long d, long long k0) {
  const uint8_t* p = row + k0;
  if (k0 + 3 < d && (reinterpret_cast<uintptr_t>(p) & 3u) == 0) {
    return __ldg(reinterpret_cast<const uint32_t*>(p));
  }
  uint32_t w = 0;
  for (int t = 0; t < 4; ++t) {
    if (k0 + t < d) w |= uint32_t(__ldg(p + t)) << (8 * t);
  }
  return w;
}

__global__ void __launch_bounds__(kThreads)
triangle_dense_kernel(const uint8_t* __restrict__ a,
                      const uint8_t* __restrict__ b,
                      const uint8_t* __restrict__ mask, int nx, int ny,
                      long long d, int tiles_n, int splits,
                      long long k_chunk,
                      unsigned long long* __restrict__ partials) {
  __shared__ uint32_t as[kTile][kKWords + 1];
  __shared__ uint32_t bs[kTile][kKWords + 1];
  __shared__ unsigned long long red[kThreads / 32];

  const long long tile = blockIdx.x / splits;
  const long long k_begin = (blockIdx.x % splits) * k_chunk;
  const long long k_end = k_begin + k_chunk < d ? k_begin + k_chunk : d;
  const int row0 = (int)(tile / tiles_n) * kTile;
  const int col0 = (int)(tile % tiles_n) * kTile;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  uint32_t acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0u;
  }

  for (long long kb = k_begin; kb < k_end; kb += kKBytes) {
#pragma unroll
    for (int s = 0; s < (kTile * kKWords) / kThreads; ++s) {
      const int w = threadIdx.x + s * kThreads;
      const int r = w / kKWords;
      const int kw = w % kKWords;
      const long long k0 = kb + 4LL * kw;
      const int ga = row0 + r;
      const int gb = col0 + r;
      as[r][kw] = ga < nx ? load_word(a + (long long)ga * d, d, k0) : 0u;
      bs[r][kw] = gb < ny ? load_word(b + (long long)gb * d, d, k0) : 0u;
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < kKWords; ++kw) {
      uint32_t av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[ty + 16 * i][kw];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[tx + 16 * j][kw];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  unsigned long long part = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= nx) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c < ny) {
        part += (unsigned long long)acc[i][j] *
                __ldg(mask + (long long)r * ny + c);
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    part += __shfl_down_sync(0xffffffffu, part, off);
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = part;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long s = 0;
    for (int w = 0; w < kThreads / 32; ++w) s += red[w];
    partials[blockIdx.x] = s;
  }
}

}  // namespace

// Number of 64-bit partials (= output tiles × k-splits) a launch writes.
extern "C" long long triangle_dense_n_partials(int nx, int ny, long long d) {
  if (nx <= 0 || ny <= 0) return 0;
  long long chunk;
  int splits;
  k_split(nx, ny, d, &chunk, &splits);
  return (long long)((nx + kTile - 1) / kTile) *
         ((ny + kTile - 1) / kTile) * splits;
}

extern "C" int triangle_dense_launch(const void* a, const void* b,
                                     const void* mask, int nx, int ny,
                                     long long d, void* partials,
                                     void* stream) {
  const long long n_blocks = triangle_dense_n_partials(nx, ny, d);
  if (n_blocks == 0) return 0;
  long long chunk;
  int splits;
  k_split(nx, ny, d, &chunk, &splits);
  const int tiles_n = (ny + kTile - 1) / kTile;
  triangle_dense_kernel<<<(unsigned int)n_blocks, kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const uint8_t*)a, (const uint8_t*)b, (const uint8_t*)mask, nx, ny, d,
      tiles_n, splits, chunk, (unsigned long long*)partials);
  return (int)cudaGetLastError();
}
