// Masked dense triangle count  Σ mask ⊙ (A · Bᵀ)  over 0/1 uint8 tiles, on
// the int8 tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/triangle_dense/kernel.py
// (_tri_kernel :29 / triangle_count_pallas :48, pallas_call :56), a
// float32 matrix-unit product with the mask applied at the last k-step and
// float32 partial sums, which is exact only up to 2^24 paths per box.
//
// What bounds it on this card: bytes. The product does 2·nx·ny·d byte
// operations on nx·d + ny·d + nx·ny bytes; a box's one-hots are a few
// hundred rows by thousands to tens of thousands of columns, so at the
// int8 tensor-core rate (1,979 TOP/s) the arithmetic takes less time than
// reading the operands once at 3.35 TB/s. The design keeps the tensor
// cores fed and the loads streaming:
//
// * Product: wgmma.mma_async m64n128k32 .s32.u8.u8 (sm_90a). A block is
//   two warpgroups over a 128 × 128 output tile; each warpgroup multiplies
//   its 64 rows of A by the block's 128 rows of B. Both operands are
//   K-major tiles of 128 bytes a row in shared memory, in the 128-byte
//   swizzled layout (16-byte chunk c of row r at r·128 + (c ^ r % 8)·16),
//   which the wgmma descriptors name (layout 1, 1024-byte stride between
//   8-row groups; the k32 steps advance the start address by 32 bytes).
// * Loads: cp.async 16-byte copies (zero-filled past the ragged nx, ny and
//   d edges) through a ring of kStages stages. Each stage has two
//   mbarriers: "full" completes when every thread's copies of the stage
//   have landed (cp.async.mbarrier.arrive.noinc), "empty" when both
//   warpgroups' products on it have finished; a thread refills a stage
//   only after "empty". Every thread both loads and multiplies, so the ring
//   needs no block-wide barrier. A wait that does not complete within a
//   few seconds traps rather than hang the card.
// * s32 accumulators are exact for 0/1 inputs while d < 2^31. The mask is
//   applied in the epilogue from registers (the accumulator layout of
//   wgmma: row 16·warp + lane/4 + 8·(j/2 % 2), column 8·(j/4) + 2·(lane %
//   4) + j % 2 of register j); each block reduces to one int64 partial,
//   and the last block to finish (counted on a zeroed word of the call's
//   own output buffer, so no state outlives a call or is shared between
//   streams) sums the partials in index order into the int64 total: no
//   second launch.
// * Split-K: a box's few output tiles would leave most SMs idle, so the k
//   axis is split until tiles × splits reaches two blocks per SM (the sum
//   is linear in k, so every split applies the mask to its own partial).
// * Widths: d must be a multiple of 16 and every row 16-byte aligned, as
//   the executor's one-hots are; the wrapper copies any other input into
//   such a buffer (ops.py).
// The kernel allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;       // output rows per block (two warpgroups)
constexpr int kBN = 128;       // output columns per block (wgmma n128)
constexpr int kBK = 128;       // k bytes per stage: one swizzled row
constexpr int kStages = 3;
constexpr int kThreads = 256;
constexpr int kTileA = kBM * kBK;
constexpr int kStageBytes = kTileA + kBN * kBK;
// stages, then the 2·kStages mbarriers; 1024 bytes of slack to align the
// stages on the swizzle period (97 KB: two blocks fit an SM)
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;
constexpr long long kTargetBlocks = 132 * 2;
constexpr long long kMinSplitTiles = 4;  // k tiles a split takes at least
constexpr long long kSpinLimit = 1LL << 27;
constexpr int kMaxDevices = 64;

// k tiles per split and the number of splits, chosen so tiles × splits
// reaches kTargetBlocks
__host__ __device__ inline void k_split(int nx, int ny, long long d,
                                        long long* chunk, int* splits) {
  const long long tiles =
      (long long)((nx + kBM - 1) / kBM) * ((ny + kBN - 1) / kBN);
  const long long k_tiles = (d + kBK - 1) / kBK;
  long long s = (kTargetBlocks + tiles - 1) / tiles;
  const long long s_max = k_tiles / kMinSplitTiles;
  if (s > s_max) s = s_max;
  if (s < 1) s = 1;
  const long long c = (k_tiles + s - 1) / s;
  *chunk = c;
  *splits = (int)((k_tiles + c - 1) / c);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from src to shared memory, or zeros when bytes == 0
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// one arrival on bar once every cp.async this thread issued has landed
__device__ __forceinline__ void mbar_arrive_copies(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(bar)
               : "memory");
}

// until the phase of parity `parity` of bar has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (long long spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > kSpinLimit) __trap();
  }
}

// wgmma shared-memory descriptor of a K-major operand tile in the 128-byte
// swizzled layout: start address, leading byte offset (unused by this
// layout), 1024-byte stride between 8-row groups, layout type 1
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d += A (64 × 32 bytes) · B (128 × 32 bytes)ᵀ, unsigned bytes into s32
__device__ __forceinline__ void wgmma_u8(uint32_t (&d)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// this thread's share of k tile kt into stage buffer `tile` (A's kBM rows,
// then B's kBN rows, 128 swizzled bytes each); rows past nx / ny and bytes
// past d are zero
__device__ __forceinline__ void load_stage(uint32_t tile,
                                           const uint8_t* __restrict__ a,
                                           const uint8_t* __restrict__ b,
                                           int nx, int ny, long long d,
                                           int row0, int col0, long long kt) {
  const long long k0 = kt * kBK;
#pragma unroll
  for (int i = threadIdx.x; i < (kBM + kBN) * 8; i += kThreads) {
    const int r = i >> 3;                       // row of the stage
    const int c = i & 7;                        // 16-byte chunk of the row
    const bool in_a = r < kBM;
    const int g = in_a ? row0 + r : col0 + (r - kBM);
    const long long k = k0 + 16 * c;
    const bool ok = (in_a ? g < nx : g < ny) && k < d;
    const uint8_t* src = in_a ? a : b;
    if (ok) src += (long long)g * d + k;
    cp_async16(tile + r * kBK + ((c ^ (r & 7)) << 4), src, ok ? 16 : 0);
  }
}

// the block sum of v (every thread gets it), in a fixed order
__device__ __forceinline__ long long block_sum(long long v, long long* red) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  __syncthreads();  // red is free
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  long long s = 0;
  for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  return s;
}

__global__ void __launch_bounds__(kThreads, 2)
triangle_dense_kernel(const uint8_t* __restrict__ a,
                      const uint8_t* __restrict__ b,
                      const uint8_t* __restrict__ mask, int nx, int ny,
                      long long d, int tiles_n, int splits,
                      long long chunk, long long* __restrict__ partials,
                      unsigned* __restrict__ done,
                      long long* __restrict__ total) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ long long red[kThreads / 32];
  __shared__ bool last;
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t full = base + kStages * kStageBytes;
  const uint32_t empty = full + kStages * 8;

  const long long tile = blockIdx.x / splits;
  const long long k_tiles = (d + kBK - 1) / kBK;
  const long long kt0 = (blockIdx.x % splits) * chunk;
  const long long kt1 = kt0 + chunk < k_tiles ? kt0 + chunk : k_tiles;
  const int n_kt = (int)(kt1 - kt0);
  const int row0 = (int)(tile / tiles_n) * kBM;
  const int col0 = (int)(tile % tiles_n) * kBN;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, kThreads);
      mbar_init(empty + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  uint32_t acc[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) acc[j] = 0u;

  for (int i = 0; i < kStages - 1 && i < n_kt; ++i) {
    load_stage(base + i * kStageBytes, a, b, nx, ny, d, row0, col0, kt0 + i);
    mbar_arrive_copies(full + 8 * i);
  }
  for (int i = 0; i < n_kt; ++i) {
    // refill the stage of tile i - 1 with tile i + kStages - 1 once both
    // warpgroups have finished with it
    const int j = i + kStages - 1;
    if (j < n_kt) {
      const int s = j % kStages;
      if (j >= kStages) mbar_wait(empty + 8 * s, ((j / kStages) - 1) & 1);
      load_stage(base + s * kStageBytes, a, b, nx, ny, d, row0, col0,
                 kt0 + j);
      mbar_arrive_copies(full + 8 * s);
    }
    const int s = i % kStages;
    mbar_wait(full + 8 * s, (i / kStages) & 1);
    // the copies are generic-proxy writes; wgmma reads through the async
    // proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const uint32_t ta = base + s * kStageBytes + wg * 64 * kBK;
    const uint32_t tb = base + s * kStageBytes + kTileA;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < kBK / 32; ++k) {
      wgmma_u8(acc, wgmma_desc(ta + 32 * k), wgmma_desc(tb + 32 * k));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    if ((threadIdx.x & 127) == 0) mbar_arrive(empty + 8 * s);
  }

  // Σ mask ⊙ acc over this thread's cells
  const int t = threadIdx.x & 127;
  const int lane = t & 31;
  const int r_base = row0 + wg * 64 + 16 * (t >> 5) + (lane >> 2);
  const int c_base = col0 + 2 * (lane & 3);
  long long part = 0;
#pragma unroll
  for (int j = 0; j < 64; ++j) {
    const int r = r_base + 8 * ((j >> 1) & 1);
    const int c = c_base + 8 * (j >> 2) + (j & 1);
    if (r < nx && c < ny) {
      part += (long long)acc[j] * __ldg(mask + (long long)r * ny + c);
    }
  }
  part = block_sum(part, red);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = part;
    __threadfence();
    last = atomicAdd(done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last) {  // every other block's partial is written
    long long s = 0;
    for (unsigned i = threadIdx.x; i < gridDim.x; i += kThreads) {
      s += __ldcg(partials + i);
    }
    s = block_sum(s, red);
    if (threadIdx.x == 0) *total = s;
  }
}

}  // namespace

// Number of 64-bit partials (= output tiles × k-splits) a launch writes.
extern "C" long long triangle_dense_n_partials(int nx, int ny, long long d) {
  if (nx <= 0 || ny <= 0 || d <= 0) return 0;
  long long chunk;
  int splits;
  k_split(nx, ny, d, &chunk, &splits);
  return (long long)((nx + kBM - 1) / kBM) * ((ny + kBN - 1) / kBN) * splits;
}

// a (nx, d), b (ny, d) and mask (nx, ny) uint8, row-major; d a multiple of
// 16 and a, b 16-byte aligned (else cudaErrorInvalidValue); partials has
// triangle_dense_n_partials entries; done is a zeroed uint32 of this
// call alone (the blocks count themselves on it); total receives the int64
// count.
extern "C" int triangle_dense_launch(const void* a, const void* b,
                                     const void* mask, int nx, int ny,
                                     long long d, void* partials, void* done,
                                     void* total, void* stream) {
  if (d % 16 != 0 || (reinterpret_cast<uintptr_t>(a) & 15) ||
      (reinterpret_cast<uintptr_t>(b) & 15)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n_blocks = triangle_dense_n_partials(nx, ny, d);
  if (n_blocks == 0) return 0;
  long long chunk;
  int splits;
  k_split(nx, ny, d, &chunk, &splits);
  // the shared-memory opt-in, once per device
  static bool opted_in[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(triangle_dense_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    opted_in[dev] = true;
  }
  const int tiles_n = (ny + kBN - 1) / kBN;
  triangle_dense_kernel<<<(unsigned int)n_blocks, kThreads, kSmemBytes,
                          (cudaStream_t)stream>>>(
      (const uint8_t*)a, (const uint8_t*)b, (const uint8_t*)mask, nx, ny, d,
      tiles_n, splits, chunk, (long long*)partials, (unsigned*)done,
      (long long*)total);
  return (int)cudaGetLastError();
}
