// TSM2L on Hopper: C[m,n] = A[m,k] @ B[k,n] with m >> k ~ n (both small).
//
// Replaces src/repro/kernels/tsm2l.py::tsm2l_pallas (body _tsm2l_kernel).
//
// Bound on the H100: ~2n FLOP per A element with k, n <= 256, so the bytes
// of A and C bound it; at the smallest shapes (k = n = 4) the launch and the
// latency of each row tile dominate (the paper's latency-bound case).
//
// Design: the grid runs over m only (plus a column grid dimension for wide
// n), and each block walks row tiles in a grid-stride loop, so the B tile it
// stages into shared memory stays there for the block's whole lifetime. At
// the classifier's limit (k = n = 256) all of B in f32 is 256 KB, more than
// the 227 KB a block may hold, so B is tiled over n (BN columns per block)
// and, past KC rows of k, over k as well (then B is re-staged per chunk).
// The paper's tcf trade (Section 3.2: fewer, fatter threads when k is tiny)
// is answered with three fixed tile shapes picked by n: a tiny n gives each
// thread more rows. Each (BM x k) A tile is contiguous in memory and is
// loaded once, coalesced. Ragged m, k, n are masked. Accumulation is f32.

#include "common.cuh"

namespace {

using tsm2x::from_f32;
using tsm2x::to_f32;

template <typename T, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    tsm2l_kernel(const T* __restrict__ A, const T* __restrict__ B,
                 T* __restrict__ C, int m, int k, int n, int kc) {
  constexpr int RT = BM / TM, CT = BN / TN, NT = RT * CT;
  extern __shared__ float smem[];
  float* Bs = smem;            // kc x BN
  float* As = smem + kc * BN;  // BM x (kc + 1)
  const int lda = kc + 1;
  const bool resident = k <= kc;

  const int tid = threadIdx.x;
  const int tx = tid % CT, ty = tid / CT;
  const int col0 = blockIdx.y * BN;

#define TSM2L_STAGE_B(k0)                                                  \
  for (int idx = tid; idx < kc * BN; idx += NT) {                          \
    const int gr = (k0) + idx / BN, gc = col0 + idx % BN;                  \
    Bs[idx] = (gr < k && gc < n) ? to_f32(B[(long)gr * n + gc]) : 0.f;     \
  }

  if (resident) TSM2L_STAGE_B(0);  // once for the block's lifetime

  for (long row0 = (long)blockIdx.x * BM; row0 < m;
       row0 += (long)gridDim.x * BM) {
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < k; k0 += kc) {
      if (!resident) TSM2L_STAGE_B(k0);
      for (int idx = tid; idx < BM * kc; idx += NT) {
        const int r = idx / kc, c = idx % kc;
        const long gr = row0 + r;
        const int gc = k0 + c;
        As[r * lda + c] = (gr < m && gc < k) ? to_f32(A[gr * k + gc]) : 0.f;
      }
      __syncthreads();
      tsm2x::tile_into<TM, TN, RT, CT>(acc, As, lda, Bs, BN, ty, tx, kc);
      __syncthreads();
    }

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
#undef TSM2L_STAGE_B
}

template <typename T, int BM, int BN, int TM, int TN, int KC>
int launch(const T* a, const T* b, T* c, int m, int k, int n,
           cudaStream_t stream) {
  constexpr int NT = (BM / TM) * (BN / TN);
  auto kern = tsm2l_kernel<T, BM, BN, TM, TN>;
  const int kc = k < KC ? k : KC;
  const size_t smem = sizeof(float) * ((size_t)kc * BN + (size_t)BM * (kc + 1));
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT, smem);
  if (err != cudaSuccess) return (int)err;
  const long tiles = ((long)m + BM - 1) / BM;
  const long resident_blocks = (long)sms * (per_sm > 0 ? per_sm : 1);
  dim3 grid((unsigned)(tiles < resident_blocks ? tiles : resident_blocks),
            (n + BN - 1) / BN);
  kern<<<grid, NT, smem, stream>>>(a, b, c, m, k, n, kc);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const T* a, const T* b, T* c, int m, int k, int n,
             cudaStream_t stream) {
  // Shared memory stays under ~100 KB at every k: BM * (KC + 1) + KC * BN.
  if (n <= 4) return launch<T, 512, 4, 2, 4, 32>(a, b, c, m, k, n, stream);
  if (n <= 16) return launch<T, 256, 16, 4, 4, 64>(a, b, c, m, k, n, stream);
  return launch<T, 64, 64, 4, 4, 256>(a, b, c, m, k, n, stream);
}

}  // namespace

extern "C" int tsm2l_f32(const void* a, const void* b, void* c, int m, int k,
                         int n, void* stream) {
  return dispatch<float>((const float*)a, (const float*)b, (float*)c, m, k, n,
                         (cudaStream_t)stream);
}

extern "C" int tsm2l_bf16(const void* a, const void* b, void* c, int m, int k,
                          int n, void* stream) {
  return dispatch<__nv_bfloat16>((const __nv_bfloat16*)a,
                                 (const __nv_bfloat16*)b, (__nv_bfloat16*)c, m,
                                 k, n, (cudaStream_t)stream);
}
