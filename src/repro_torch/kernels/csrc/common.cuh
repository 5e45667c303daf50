// Helpers shared by the TSM2X kernels: dtype conversion, the register
// micro-tile every kernel accumulates into, the tile tables and the block
// bodies that the sequential and the split-reduction kernels share.
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

// ---------------------------------------------------------------------------
// Tile tables. One table per kernel family, used by the sequential and the
// split kernel alike and mirrored in Python by
// repro_torch/core/perf_model.py (tsm2r_tile, tsmt_tile), whose block
// counts drive the split chooser. The *_split_grid queries let a caller
// check the mirror against this table.
// ---------------------------------------------------------------------------

template <int BM_, int BN_, int BK_, int TM_, int TN_>
struct Tsm2rTile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, TM = TM_, TN = TN_;
};

// f(Tsm2rTile<...>{}) for the tile TSM2R uses at output width n.
template <typename F>
inline int with_tsm2r_tile(int n, F&& f) {
  if (n <= 16) return f(Tsm2rTile<128, 16, 32, 2, 4>{});  // skinny
  return f(Tsm2rTile<64, 64, 32, 4, 4>{});
}

template <int BA_, int BB_, int TA_, int TB_, int G_>
struct TsmtTile {
  static constexpr int BA = BA_, BB = BB_, TA = TA_, TB = TB_, G = G_;
};

// f(TsmtTile<...>{}) for the tile TSMT uses at output width b: 256 threads
// and a 16 KB partials buffer in every shape.
template <typename F>
inline int with_tsmt_tile(int b_dim, F&& f) {
  if (b_dim <= 4) return f(TsmtTile<128, 4, 4, 4, 8>{});
  if (b_dim <= 16) return f(TsmtTile<64, 16, 4, 4, 4>{});
  return f(TsmtTile<64, 64, 4, 4, 1>{});
}

// ---------------------------------------------------------------------------
// TSM2R block body: one (BM x BN) output tile of A[m,k] @ B[k,n] over the
// reduction range [k_lo, k_hi), written as U at C[row][col] (row stride n).
// The next (BM x BK) A tile and (BK x BN) B tile are prefetched into
// registers while the current one is multiplied out of shared memory
// (paper Algorithm 4). Ragged edges are masked: zero padding is exact.
// ---------------------------------------------------------------------------

template <typename T, typename U, int BM, int BN, int BK, int TM, int TN>
__device__ __forceinline__ void tsm2r_block(const T* __restrict__ A,
                                            const T* __restrict__ B,
                                            U* __restrict__ C, int m, int k,
                                            int n, int k_lo, int k_hi) {
  constexpr int RT = BM / TM;  // threads along rows
  constexpr int CT = BN / TN;  // threads along columns
  constexpr int NT = RT * CT;
  constexpr int LDA = BK + 1;  // odd stride: row reads hit distinct banks
  constexpr int A_PER = BM * BK / NT;
  constexpr int B_PER = BK * BN / NT;
  static_assert((BM * BK) % NT == 0 && (BK * BN) % NT == 0, "tile/threads");

  __shared__ float As[BM * LDA];
  __shared__ float Bs[BK * BN];

  const int tid = threadIdx.x;
  const int tx = tid % CT, ty = tid / CT;
  const long row0 = (long)blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  if (k_hi > k) k_hi = k;

  // The prefetch registers hold the raw input type and are converted only
  // when stored to shared memory: a conversion right after the load would
  // make the warp wait for the load before the FMAs it should overlap.
  T ra[A_PER], rb[B_PER];
  const T zero = from_f32<T>(0.f);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

#define TSM2R_FETCH(k0)                                                  \
  {                                                                      \
    _Pragma("unroll") for (int p = 0; p < A_PER; ++p) {                  \
      const int idx = tid + p * NT, r = idx / BK, c = idx % BK;          \
      const long gr = row0 + r;                                          \
      const int gc = (k0) + c;                                           \
      ra[p] = (gr < m && gc < k_hi) ? A[gr * k + gc] : zero;             \
    }                                                                    \
    _Pragma("unroll") for (int p = 0; p < B_PER; ++p) {                  \
      const int idx = tid + p * NT, r = idx / BN, c = idx % BN;          \
      const int gr = (k0) + r, gc = col0 + c;                            \
      rb[p] = (gr < k_hi && gc < n) ? B[(long)gr * n + gc] : zero;       \
    }                                                                    \
  }

  if (k_lo < k_hi) TSM2R_FETCH(k_lo);
  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
#pragma unroll
    for (int p = 0; p < A_PER; ++p) {
      const int idx = tid + p * NT;
      As[(idx / BK) * LDA + idx % BK] = to_f32(ra[p]);
    }
#pragma unroll
    for (int p = 0; p < B_PER; ++p) Bs[tid + p * NT] = to_f32(rb[p]);
    __syncthreads();
    if (k0 + BK < k_hi) TSM2R_FETCH(k0 + BK);  // in flight during the FMAs
    tile_into<TM, TN, RT, CT>(acc, As, LDA, Bs, BN, ty, tx, BK);
    __syncthreads();
  }
#undef TSM2R_FETCH

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long gr = row0 + ty + i * RT;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + tx + j * CT;
      if (gc < n) C[gr * n + gc] = from_f32<U>(acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// TSMT block body: one (BA x BB) output tile of X[m,a]^T Y[m,b] over the
// rows [lo, hi), written as U at C[a][b] (row stride b_dim). The block's
// threads form G groups; group g reduces rows lo + g, lo + g + G, ... into a
// register micro-tile, reading X and Y straight from global memory
// (neighbouring threads read neighbouring columns of one row, so each warp
// load is coalesced). The G partial tiles are then summed through shared
// memory in a fixed order: bit-identical from run to run, no atomics.
// ---------------------------------------------------------------------------

template <typename T, typename U, int BA, int BB, int TA, int TB, int G>
__device__ __forceinline__ void tsmt_block(const T* __restrict__ X,
                                           const T* __restrict__ Y,
                                           U* __restrict__ C, long lo,
                                           long hi, int a_dim, int b_dim) {
  constexpr int RT = BA / TA, CT = BB / TB, TPG = RT * CT;
  __shared__ float red[G * BA * BB];  // the groups' partial tiles

  const int tid = threadIdx.x;
  const int g = tid / TPG, t = tid % TPG;
  const int tx = t % CT, ty = t / CT;
  const int a0 = blockIdx.x * BA, b0 = blockIdx.y * BB;

  bool a_ok[TA], b_ok[TB];
#pragma unroll
  for (int i = 0; i < TA; ++i) a_ok[i] = a0 + ty + i * RT < a_dim;
#pragma unroll
  for (int j = 0; j < TB; ++j) b_ok[j] = b0 + tx + j * CT < b_dim;

  float acc[TA][TB];
#pragma unroll
  for (int i = 0; i < TA; ++i)
#pragma unroll
    for (int j = 0; j < TB; ++j) acc[i][j] = 0.f;

  // Two-level sum: each run of CH rows is summed apart, then added to acc,
  // so the rounding error grows with sqrt(CH) + sqrt(rows / (G * CH)).
  constexpr int CH = 256;
  for (long r0 = lo + g; r0 < hi; r0 += (long)G * CH) {
    const long r1 = r0 + (long)G * CH < hi ? r0 + (long)G * CH : hi;
    float run[TA][TB];
#pragma unroll
    for (int i = 0; i < TA; ++i)
#pragma unroll
      for (int j = 0; j < TB; ++j) run[i][j] = 0.f;
#pragma unroll 2
    for (long r = r0; r < r1; r += G) {
      const T* xr = X + r * a_dim + a0 + ty;
      const T* yr = Y + r * b_dim + b0 + tx;
      float xv[TA], yv[TB];
#pragma unroll
      for (int i = 0; i < TA; ++i) xv[i] = a_ok[i] ? to_f32(xr[i * RT]) : 0.f;
#pragma unroll
      for (int j = 0; j < TB; ++j) yv[j] = b_ok[j] ? to_f32(yr[j * CT]) : 0.f;
#pragma unroll
      for (int i = 0; i < TA; ++i)
#pragma unroll
        for (int j = 0; j < TB; ++j)
          run[i][j] = fmaf(xv[i], yv[j], run[i][j]);
    }
#pragma unroll
    for (int i = 0; i < TA; ++i)
#pragma unroll
      for (int j = 0; j < TB; ++j) acc[i][j] += run[i][j];
  }

  // Fixed-order reduction of the G group partials.
#pragma unroll
  for (int i = 0; i < TA; ++i)
#pragma unroll
    for (int j = 0; j < TB; ++j)
      red[g * BA * BB + (ty + i * RT) * BB + tx + j * CT] = acc[i][j];
  __syncthreads();
  for (int idx = tid; idx < BA * BB; idx += TPG * G) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < G; ++q) s += red[q * BA * BB + idx];
    const int ga = a0 + idx / BB, gb = b0 + idx % BB;
    if (ga < a_dim && gb < b_dim) C[(long)ga * b_dim + gb] = from_f32<U>(s);
  }
}

}  // namespace tsm2x
