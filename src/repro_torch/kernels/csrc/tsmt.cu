// TSMT on Hopper: C[a,b] = X[m,a]^T @ Y[m,b] with m >> a, b.
//
// Replaces src/repro/kernels/tsmt.py::tsmt_pallas (body _tsmt_kernel).
//
// Bound on the H100: the bytes of X and Y (each read once); the output is
// tiny. With a, b <= 16 (PowerSGD, ABFT) the output is one tile, so this
// sequential kernel runs on one or a few SMs and is bound by what those SMs
// can pull, far below the card's 3.35 TB/s. Occupying the card takes the
// split-reduction kernel (tsmt_split.cu), which the dispatcher picks when
// the output tiles alone leave SMs idle.
//
// Design: one block per (BA x BB) output tile loops over all of m, where the
// TPU ran a sequential grid axis. The block's threads form G groups; group g
// reduces rows g, g + G, g + 2G, ... into a register micro-tile, reading X
// and Y straight from global memory (neighbouring threads read neighbouring
// columns of one row, so each warp load is coalesced). The G partial tiles
// are then summed through shared memory in a fixed order, so the result is
// bit-identical from run to run: no atomics. Ragged m, a, b are masked.
// The block body and the tile table live in common.cuh, shared with
// tsmt_split.cu.

#include "common.cuh"

namespace {

template <typename T, int BA, int BB, int TA, int TB, int G>
__global__ void __launch_bounds__((BA / TA) * (BB / TB) * G)
    tsmt_kernel(const T* __restrict__ X, const T* __restrict__ Y,
                T* __restrict__ C, int m, int a_dim, int b_dim) {
  tsm2x::tsmt_block<T, T, BA, BB, TA, TB, G>(X, Y, C, 0, m, a_dim, b_dim);
}

template <typename T>
int dispatch(const T* x, const T* y, T* c, int m, int a_dim, int b_dim,
             cudaStream_t stream) {
  return tsm2x::with_tsmt_tile(b_dim, [&](auto tile) {
    using Tl = decltype(tile);
    constexpr int NT = (Tl::BA / Tl::TA) * (Tl::BB / Tl::TB) * Tl::G;
    dim3 grid((a_dim + Tl::BA - 1) / Tl::BA, (b_dim + Tl::BB - 1) / Tl::BB);
    tsmt_kernel<T, Tl::BA, Tl::BB, Tl::TA, Tl::TB, Tl::G>
        <<<grid, NT, 0, stream>>>(x, y, c, m, a_dim, b_dim);
    return (int)cudaGetLastError();
  });
}

}  // namespace

extern "C" int tsmt_f32(const void* x, const void* y, void* c, int m, int a,
                        int b, void* stream) {
  return dispatch<float>((const float*)x, (const float*)y, (float*)c, m, a, b,
                         (cudaStream_t)stream);
}

extern "C" int tsmt_bf16(const void* x, const void* y, void* c, int m, int a,
                         int b, void* stream) {
  return dispatch<__nv_bfloat16>((const __nv_bfloat16*)x,
                                 (const __nv_bfloat16*)y, (__nv_bfloat16*)c, m,
                                 a, b, (cudaStream_t)stream);
}
