// Int8 TSM2R's tensor-core body for Hopper (sm_90a): C[m,n] =
// int32(A8[m,k] @ B8[k,n]) * sA[row / band] * sB, written as f32 or bf16,
// for outputs wider than 16 columns. tsm2r_q8.cu takes it when
// tsm2r_q8_plan says so (wgmma_s8::fits); every other call keeps the
// __dp4a body of common.cuh.
//
// Bound on the H100: at n = 256 the product is 2n = 512 operations per
// byte of A, below the int8 tensor cores' ridge (1,979 TOP/s over 3.35
// TB/s, ~590 a byte), so the bytes of A bound it; B (n x k, 1 MB at
// chatglm3's wk/wv) is read once per row tile, from L2 after the first.
//
// Design: the bf16 body's machinery (tsm2r_wgmma.cuh: TMA maps encoded on
// the host, a 4-stage full/empty mbarrier ring fed by one producer warp,
// 128-byte-swizzle descriptors, the accumulator fragment map) at 1 byte an
// element. What int8 changes:
// - Both operands K-major. wgmma's transpose bit exists only for 16-bit
//   types, so B reaches shared memory as [n, k] rows: the caller hands a
//   [k, n] tensor whose transpose is contiguous (strides (1, k)), as
//   kernels/quant.py's quantize pass writes B's codes for this body.
// - A BK = 128 stage: one swizzled 128-byte row holds 128 k values, so a
//   stage is A 64 x 128 (8 KB) plus B 128 x 128 (16 KB), the bf16 body's
//   24 KB, with four wgmma.m64n128k32.s32.s8.s8 (K = 32 for 8-bit types).
//   A k32 step moves both descriptors' start 32 bytes along the row.
// - Overflow: one s32 sum is exact up to 133,143 terms of 127 * 127. The
//   s32 fragment is folded into an f32 fragment every FOLD_STAGES = 1,024
//   stages (131,072 k) and at the end, so for k <= 131,072 the f32 value
//   is one rounding of the exact integer: the result is then bit-equal to
//   the plain version (ref.tsm2r_q8_ref), whose epilogue order it keeps:
//   float(acc) * (sA[band] * sB), rounded to nearest even in the output
//   dtype.
// - TMA's zero fill masks the ragged tails of m, k and n; the epilogue
//   masks the stores (any n: B's rows are n, so n needs no alignment).
// - One block per output tile and a fixed k order: repeats are
//   bit-identical.
#pragma once

#include "tsm2r_wgmma.cuh"

namespace tsm2x {
namespace wgmma_s8 {

using tma::mbar_arrive;
using tma::mbar_expect_tx;
using tma::mbar_init;
using tma::mbar_wait;
using tma::smem_u32;
using tma::tma_load;
using wgmma::desc;

constexpr int BM = 64, BN = 128, BK = 128, STAGES = 4;
constexpr int A_BYTES = BM * BK;             // 8 KB
constexpr int B_BYTES = BN * BK;             // 16 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + alignment slack
constexpr int CONSUMERS = 128;               // one warpgroup
constexpr int THREADS = CONSUMERS + 32;      // and one producer warp
constexpr int MIN_WIDTH = 16;                // n <= 16 stays on the CUDA cores
constexpr int FOLD_STAGES = 1024;            // 131,072 k per exact s32 sum

// Whether a call takes this body: n > 16, TMA's 16-byte global strides
// of int8 (k a multiple of 16, k > 0) and 16-byte aligned bases of A and
// of the K-major B.
inline bool fits(int k, int n, const void* a, const void* b) {
  return n > MIN_WIDTH && k > 0 && k % 16 == 0 &&
         reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

inline dim3 grid(int m, int n) {
  return dim3((m + BM - 1) / BM, (n + BN - 1) / BN, 1);
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns the registers.
__device__ __forceinline__ void fence_acc(int32_t (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d += A (64 x 32, K-major) @ B (32 x 128, K-major), s32 accumulators.
__device__ __forceinline__ void mma_64x128x32(int32_t (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,\n"
      " %8, %9, %10, %11, %12, %13, %14, %15,\n"
      " %16, %17, %18, %19, %20, %21, %22, %23,\n"
      " %24, %25, %26, %27, %28, %29, %30, %31,\n"
      " %32, %33, %34, %35, %36, %37, %38, %39,\n"
      " %40, %41, %42, %43, %44, %45, %46, %47,\n"
      " %48, %49, %50, %51, %52, %53, %54, %55,\n"
      " %56, %57, %58, %59, %60, %61, %62, %63},\n"
      " %64, %65, p;\n"  // scale-d: accumulate into d
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Columns c and c + 1 of one row: one 2-element store where n is even
// (then c + 1 < n and the pair is aligned), else each column < n alone.
__device__ __forceinline__ void store2(float* p, float x, float y, bool even,
                                       bool second) {
  if (even) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  } else {
    p[0] = x;
    if (second) p[1] = y;
  }
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y,
                                       bool even, bool second) {
  if (even) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
  } else {
    p[0] = __float2bfloat16_rn(x);
    if (second) p[1] = __float2bfloat16_rn(y);
  }
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

template <typename U>
__global__ void __launch_bounds__(THREADS, 1)
    tsm2r_q8_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                          const __grid_constant__ CUtensorMap map_b,
                          const float* __restrict__ sa,
                          const float* __restrict__ sb, U* __restrict__ C,
                          int m, int k, int n, int band) {
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
        tma_load(st + A_BYTES, &map_b, &full[s], kt * BK, col0);
      }
    }
    return;
  }

  float f[64];
  int32_t d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) f[i] = 0.f;
  for (int k0 = 0; k0 < steps; k0 += FOLD_STAGES) {
    const int k1 = min(steps, k0 + FOLD_STAGES);
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0;
    for (int kt = k0; kt < k1; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(&full[s], (kt / STAGES) & 1);
      const uint32_t a = base + s * STAGE_BYTES, b = a + A_BYTES;
      fence_acc(d);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        // Both K-major: 32 k values are 32 bytes along a swizzled 128-byte
        // row; 8-row groups lie 1024 bytes apart (SBO; LBO unused).
        mma_64x128x32(d, desc(a + kk * 32, 16, 1024),
                      desc(b + kk * 32, 16, 1024));
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      fence_acc(d);
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      fence_acc(d);
      if (kt > 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(d);
#pragma unroll
    for (int i = 0; i < 64; ++i) f[i] += static_cast<float>(d[i]);
  }

  // The m64nNk32 accumulator fragment: register 4j + 2h + e of thread
  // (warp w, lane l) holds row 16w + l/4 + 8h, column 8j + 2(l%4) + e.
  const int warp = tid / 32, lane = tid % 32;
  const long row = (long)row0 + warp * 16 + lane / 4;
  const int col = col0 + (lane % 4) * 2;
  const bool even = n % 2 == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long r = row + 8 * h;
    if (r >= m) continue;
    const float factor = sa[r / band] * sb[0];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = col + 8 * j;
      if (c < n)
        store2(C + r * n + c, f[4 * j + 2 * h] * factor,
               f[4 * j + 2 * h + 1] * factor, even, c + 1 < n);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: tensor maps and the launch
// ---------------------------------------------------------------------------

// a: [m, k] int8 row-major; b: the K-major B, [n, k] int8 row-major.
// Returns the cudaError_t of the launch; cudaErrorInvalidValue when a
// tensor map cannot be encoded (or the driver has no encoder).
template <typename U>
int launch(const int8_t* a, const int8_t* b, const float* sa,
           const float* sb, U* c, int m, int k, int n, int band,
           cudaStream_t stream) {
  // One 128-byte row of k a box row: A in 128 x 64 boxes, B in 128 x 128.
  constexpr CUtensorMapDataType U8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  CUtensorMap map_a, map_b;
  if (!tma::encode(&map_a, a, k, m, U8, 1, BK, BM) ||
      !tma::encode(&map_b, b, k, n, U8, 1, BK, BN))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      tsm2r_q8_wgmma_kernel<U>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  tsm2r_q8_wgmma_kernel<U><<<grid(m, n), THREADS, SMEM_BYTES, stream>>>(
      map_a, map_b, sa, sb, c, m, k, n, band);
  return (int)cudaGetLastError();
}

}  // namespace wgmma_s8
}  // namespace tsm2x
