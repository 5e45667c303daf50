// TSM2R on Hopper: C[m,n] = A[m,k] @ B[k,n] with m ~ k >> n.
//
// Replaces src/repro/kernels/tsm2r.py::tsm2r_pallas (body _tsm2r_kernel).
//
// Bound on the H100: at bf16 and n <= 256 the work is ~2n FLOP per A
// element, below the card's ridge, so the bytes of A bound it on the tensor
// cores; this first kernel runs its FMAs on the CUDA cores in f32, so at
// n = 256 the f32 FMA rate (67 TFLOP/s) is its real bound.
//
// Design (paper Algorithm 4: outer product, B staged in shared memory, next
// tile prefetched into registers): one block owns a BM x BN output tile and
// loops over k inside the block, where the TPU ran a sequential grid axis.
// The next (BM x BK) A tile and (BK x BN) B tile are loaded into registers
// while the current tile is multiplied out of shared memory. The paper keeps
// all n outputs of a row in one thread; that only fits n <= ~16, so the n
// columns are spread over the block's threads and over a column grid
// dimension (n / BN blocks), each of which streams its rows of A once.
// Ragged m, k, n are masked on load and store. Accumulation is f32, in two
// levels (each BK tile is summed apart, then added to the running sum), so
// the rounding error grows with sqrt(BK) + sqrt(k / BK), not sqrt(k).

#include "common.cuh"

namespace {

using tsm2x::from_f32;
using tsm2x::to_f32;

template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    tsm2r_kernel(const T* __restrict__ A, const T* __restrict__ B,
                 T* __restrict__ C, int m, int k, int n) {
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

  // Prefetch of tile k0 into registers (masked: zero padding is exact).
#define TSM2R_FETCH(k0)                                                  \
  {                                                                      \
    _Pragma("unroll") for (int p = 0; p < A_PER; ++p) {                  \
      const int idx = tid + p * NT, r = idx / BK, c = idx % BK;          \
      const long gr = row0 + r;                                          \
      const int gc = (k0) + c;                                           \
      ra[p] = (gr < m && gc < k) ? A[gr * k + gc] : zero;                \
    }                                                                    \
    _Pragma("unroll") for (int p = 0; p < B_PER; ++p) {                  \
      const int idx = tid + p * NT, r = idx / BN, c = idx % BN;          \
      const int gr = (k0) + r, gc = col0 + c;                            \
      rb[p] = (gr < k && gc < n) ? B[(long)gr * n + gc] : zero;          \
    }                                                                    \
  }

  TSM2R_FETCH(0);
  for (int k0 = 0; k0 < k; k0 += BK) {
#pragma unroll
    for (int p = 0; p < A_PER; ++p) {
      const int idx = tid + p * NT;
      As[(idx / BK) * LDA + idx % BK] = to_f32(ra[p]);
    }
#pragma unroll
    for (int p = 0; p < B_PER; ++p) Bs[tid + p * NT] = to_f32(rb[p]);
    __syncthreads();
    if (k0 + BK < k) TSM2R_FETCH(k0 + BK);  // in flight during the FMAs
    tsm2x::tile_into<TM, TN, RT, CT>(acc, As, LDA, Bs, BN, ty, tx, BK);
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
      if (gc < n) C[gr * n + gc] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
int launch(const T* a, const T* b, T* c, int m, int k, int n,
           cudaStream_t stream) {
  constexpr int NT = (BM / TM) * (BN / TN);
  dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  tsm2r_kernel<T, BM, BN, BK, TM, TN><<<grid, NT, 0, stream>>>(a, b, c, m, k,
                                                               n);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const T* a, const T* b, T* c, int m, int k, int n,
             cudaStream_t stream) {
  if (n <= 16)  // skinny: 128 rows x 16 columns per block
    return launch<T, 128, 16, 32, 2, 4>(a, b, c, m, k, n, stream);
  return launch<T, 64, 64, 32, 4, 4>(a, b, c, m, k, n, stream);
}

}  // namespace

extern "C" int tsm2r_f32(const void* a, const void* b, void* c, int m, int k,
                         int n, void* stream) {
  return dispatch<float>((const float*)a, (const float*)b, (float*)c, m, k, n,
                         (cudaStream_t)stream);
}

extern "C" int tsm2r_bf16(const void* a, const void* b, void* c, int m, int k,
                          int n, void* stream) {
  return dispatch<__nv_bfloat16>((const __nv_bfloat16*)a,
                                 (const __nv_bfloat16*)b, (__nv_bfloat16*)c, m,
                                 k, n, (cudaStream_t)stream);
}
