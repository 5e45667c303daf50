// Helpers shared by the TSM2X kernels: dtype conversion and the register
// micro-tile that every kernel accumulates into.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tsm2x {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // round to nearest even, as torch .to()
}

// acc[i][j] += sum_kk As[row i][kk] * Bs[kk][col j] over one staged chunk.
// Thread (ty, tx) owns rows ty + i*RT and columns tx + j*CT of the tile:
// strided ownership keeps neighbouring threads on neighbouring shared-memory
// words (no bank conflicts) and on neighbouring output columns (coalesced
// stores).
template <int TM, int TN, int RT, int CT>
__device__ __forceinline__ void micro_tile(float (&acc)[TM][TN],
                                           const float* As, int a_row_stride,
                                           const float* Bs, int b_k_stride,
                                           int ty, int tx, int kc) {
#pragma unroll 4
  for (int kk = 0; kk < kc; ++kk) {
    float a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      a[i] = As[(ty + i * RT) * a_row_stride + kk];
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = Bs[kk * b_k_stride + tx + j * CT];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// The chunk's products summed apart, then added to acc: a two-level sum
// whose rounding error grows with sqrt(kc) + sqrt(chunks), not sqrt(k).
template <int TM, int TN, int RT, int CT>
__device__ __forceinline__ void tile_into(float (&acc)[TM][TN],
                                          const float* As, int a_row_stride,
                                          const float* Bs, int b_k_stride,
                                          int ty, int tx, int kc) {
  float part[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) part[i][j] = 0.f;
  micro_tile<TM, TN, RT, CT>(part, As, a_row_stride, Bs, b_k_stride, ty, tx,
                             kc);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] += part[i][j];
}

}  // namespace tsm2x
