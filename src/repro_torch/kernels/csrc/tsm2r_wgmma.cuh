// TSM2R's tensor-core body for Hopper (sm_90a): C[m,n] = A[m,k] @ B[k,n]
// in bf16 with an f32 sum, for outputs wider than 16 columns. tsm2r.cu
// takes it when tsm2r_plan says so (wgmma::fits); every other call keeps
// the CUDA-core body of common.cuh.
//
// Bound on the H100: at n = 256 the product is 2n = 512 FLOP per 2-byte
// element of A, below the card's ridge (989 TFLOP/s over 3.35 TB/s, ~295
// FLOP a byte), so on the tensor cores the bytes of A bound it; B (k x n,
// 2 MB at chatglm3's wk/wv) is read once per row tile, from L2 after the
// first.
//
// Design. One block owns a BM x BN = 64 x 128 output tile and loops over
// k in BK = 64 steps: one warpgroup (4 warps) multiplies, one more warp
// loads.
// - Loads by TMA. A's tile is one 64 x 64 box of the row-major [m, k]
//   tensor map (k innermost), B's two 64 x 64 boxes of the row-major
//   [k, n] map (n innermost), all with the 128-byte swizzle that wgmma
//   reads without bank conflicts. The maps are encoded on the host per
//   call (cuTensorMapEncodeTiled, found through cudaGetDriverEntryPoint,
//   so the library needs no -lcuda) and passed as __grid_constant__
//   parameters. TMA fills out-of-bounds elements with zeros, which masks
//   the ragged tails of m, k and n exactly; the epilogue masks the stores.
//   The TMA and mbarrier helpers live in tma.cuh, shared with the int8
//   and the skinny bodies.
// - A ring of STAGES = 4 stages of 24 KB (96 KB of dynamic shared memory,
//   two blocks an SM), each with a "full" and an "empty" mbarrier. One
//   producer thread waits for "empty", posts the stage's bytes on "full"
//   (expect_tx) and issues the three copies; the consumers wait for
//   "full". Each waits on the parity of its round through the ring.
// - The product: four wgmma.m64n128k16.f32.bf16.bf16 per stage, both
//   operands read from shared memory through descriptors: A K-major, B
//   MN-major (the transpose bit, allowed for 16-bit types), so neither is
//   transposed in memory. A stage's group is committed and waited for
//   with one group still in flight (wait_group 1), so one stage's product
//   overlaps the next stage's copy; every consumer then arrives on the
//   previous stage's "empty".
// - Epilogue: the f32 accumulator fragment, rounded to bf16 (nearest
//   even), stored two columns at a time where row < m and column < n.
// - One block per output tile and a fixed k order: repeats are
//   bit-identical.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>

#include "tma.cuh"

namespace tsm2x {
namespace wgmma {

constexpr int BM = 64, BN = 128, BK = 64, STAGES = 4;
constexpr int BOX = 64;                      // elements in one 128-byte row
constexpr int A_BYTES = BM * BK * 2;         // 8 KB
constexpr int B_BYTES = BK * BN * 2;         // 16 KB: two 64-column boxes
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + alignment slack
constexpr int CONSUMERS = 128;               // one warpgroup
constexpr int THREADS = CONSUMERS + 32;      // and one producer warp
constexpr int MIN_WIDTH = 16;                // n <= 16 stays on the CUDA cores

// Whether a call takes this body: bf16, n > 16, TMA's 16-byte global
// strides (k and n multiples of 8, k > 0) and 16-byte aligned bases.
inline bool fits(int k, int n, bool bf16, const void* a, const void* b) {
  return bf16 && n > MIN_WIDTH && k > 0 && k % 8 == 0 && n % 8 == 0 &&
         reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

inline dim3 grid(int m, int n) {
  return dim3((m + BM - 1) / BM, (n + BN - 1) / BN, 1);
}

// ---------------------------------------------------------------------------
// Device helpers: wgmma (PTX for sm_90a); mbarriers and TMA in tma.cuh
// ---------------------------------------------------------------------------

using tma::mbar_arrive;
using tma::mbar_expect_tx;
using tma::mbar_init;
using tma::mbar_wait;
using tma::smem_u32;
using tma::tma_load;

// A shared-memory matrix descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns the registers.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A (64 x 16, K-major) @ B (16 x 128, MN-major), f32 accumulators.
__device__ __forceinline__ void mma_64x128x16(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,\n"
      " %8, %9, %10, %11, %12, %13, %14, %15,\n"
      " %16, %17, %18, %19, %20, %21, %22, %23,\n"
      " %24, %25, %26, %27, %28, %29, %30, %31,\n"
      " %32, %33, %34, %35, %36, %37, %38, %39,\n"
      " %40, %41, %42, %43, %44, %45, %46, %47,\n"
      " %48, %49, %50, %51, %52, %53, %54, %55,\n"
      " %56, %57, %58, %59, %60, %61, %62, %63},\n"
      " %64, %65, 1, 1, 1, 0, 1;\n"  // scale-d, scale-a, scale-b, tnspA, tnspB
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db));
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS, 1)
    tsm2r_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                       const __grid_constant__ CUtensorMap map_b,
                       __nv_bfloat16* __restrict__ C, int m, int k, int n) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  // The 128-byte swizzle repeats every 1024 bytes; each stage's tiles
  // start on such a boundary.
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* tiles = smem_raw + (base - raw);
  const int tid = threadIdx.x;
  const int steps = (k + BK - 1) / BK;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer warp: one thread issues the copies
    if (tid == CONSUMERS) {
      for (int kt = 0; kt < steps; ++kt) {
        const int s = kt % STAGES;
        // Round r of stage s waits for the consumers' release of round
        // r - 1; round 0 passes at once (parity 1 of a fresh barrier).
        mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
        uint8_t* st = tiles + s * STAGE_BYTES;
        mbar_expect_tx(&full[s], STAGE_BYTES);
        tma_load(st, &map_a, &full[s], kt * BK, row0);
        tma_load(st + A_BYTES, &map_b, &full[s], col0, kt * BK);
        tma_load(st + A_BYTES + B_BYTES / 2, &map_b, &full[s], col0 + BOX,
                 kt * BK);
      }
    }
    return;
  }

  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  for (int kt = 0; kt < steps; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    const uint32_t a = base + s * STAGE_BYTES, b = a + A_BYTES;
    fence_acc(d);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      // A: 16 k values are 32 bytes along a swizzled 128-byte row; 8-row
      // groups lie 1024 bytes apart (SBO; LBO unused). B: 16 k rows of
      // 128 bytes; 8-row groups 1024 bytes apart (SBO), the second
      // 64-column box 8192 bytes on (LBO).
      mma_64x128x16(d, desc(a + kk * 32, 16, 1024),
                    desc(b + kk * 16 * 128, B_BYTES / 2, 1024));
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    fence_acc(d);
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
    fence_acc(d);
    if (kt > 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence_acc(d);

  // The m64nNk16 accumulator fragment: register 4j + 2h + e of thread
  // (warp w, lane l) holds row 16w + l/4 + 8h, column 8j + 2(l%4) + e.
  const int warp = tid / 32, lane = tid % 32;
  const long row = (long)row0 + warp * 16 + lane / 4;
  const int col = col0 + (lane % 4) * 2;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long r = row + 8 * h;
      const int c = col + 8 * j;
      if (r < m && c < n)  // n % 8 == 0: column c + 1 < n too
        *reinterpret_cast<__nv_bfloat162*>(C + r * n + c) =
            __floats2bfloat162_rn(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: the launch
// ---------------------------------------------------------------------------

// A row-major [outer, inner] bf16 tensor in 64 x 64 boxes (tma::encode).
inline bool encode(CUtensorMap* map, const void* ptr, int inner, int outer) {
  return tma::encode(map, ptr, inner, outer,
                     CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, BOX, BOX);
}

// Returns the cudaError_t of the launch; cudaErrorInvalidValue when a
// tensor map cannot be encoded (or the driver has no encoder).
inline int launch(const __nv_bfloat16* a, const __nv_bfloat16* b,
                  __nv_bfloat16* c, int m, int k, int n,
                  cudaStream_t stream) {
  CUtensorMap map_a, map_b;
  if (!encode(&map_a, a, k, m) || !encode(&map_b, b, n, k))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      tsm2r_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  tsm2r_wgmma_kernel<<<grid(m, n), THREADS, SMEM_BYTES, stream>>>(
      map_a, map_b, c, m, k, n);
  return (int)cudaGetLastError();
}

}  // namespace wgmma
}  // namespace tsm2x
