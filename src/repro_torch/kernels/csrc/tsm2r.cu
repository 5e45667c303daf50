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
// dimension (n / BN blocks), each of which streams its rows of A once. The
// block body and the tile table live in common.cuh, shared with
// tsm2r_split.cu.
// Ragged m, k, n are masked on load and store. Accumulation is f32, in two
// levels (each BK tile is summed apart, then added to the running sum), so
// the rounding error grows with sqrt(BK) + sqrt(k / BK), not sqrt(k).

#include "common.cuh"

namespace {

template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    tsm2r_kernel(const T* __restrict__ A, const T* __restrict__ B,
                 T* __restrict__ C, int m, int k, int n) {
  tsm2x::tsm2r_block<T, T, BM, BN, BK, TM, TN>(A, B, C, m, k, n, 0, k);
}

template <typename T>
int dispatch(const T* a, const T* b, T* c, int m, int k, int n,
             cudaStream_t stream) {
  return tsm2x::with_tsm2r_tile(n, [&](auto tile) {
    using Tl = decltype(tile);
    constexpr int NT = (Tl::BM / Tl::TM) * (Tl::BN / Tl::TN);
    dim3 grid((m + Tl::BM - 1) / Tl::BM, (n + Tl::BN - 1) / Tl::BN);
    tsm2r_kernel<T, Tl::BM, Tl::BN, Tl::BK, Tl::TM, Tl::TN>
        <<<grid, NT, 0, stream>>>(a, b, c, m, k, n);
    return (int)cudaGetLastError();
  });
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
