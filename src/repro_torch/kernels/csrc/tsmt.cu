// TSMT on Hopper: C[a,b] = X[m,a]^T @ Y[m,b] with m >> a, b, in one launch
// that spreads the m reduction over every SM.
//
// Replaces src/repro/kernels/tsmt.py::tsmt_pallas (body _tsmt_kernel).
//
// Bound on the H100: the bytes of X and Y, each read once, plus the
// 2 * S * a * b * 4 bytes of f32 partials written and read back past one
// slice; the output is tiny.
//
// Design: the output has few tiles (one at a, b <= 4 with a <= 128), so one
// block per tile would pull all of m through one SM. The caller plans S
// slices of m (core/perf_model.py::tsmt_slices: tiles x S about a fixed
// number of blocks per SM, every slice a whole number of 8-row blocks and
// at least a minimum of rows), and the grid is (a-tiles, b-tiles, S).
// Block (i, j, s) runs TSMT's block body (common.cuh: G thread groups over
// strided rows, two-level f32 sum, fixed-order group sum through shared
// memory) over its slice into an f32 (S, a, b) workspace, then draws a
// ticket from its tile's counter; the tile's last block sums the S
// partials of each output element in slice order from 0.f and writes C
// once (common.cuh tsmt_slices_run). The ticket is the only atomic, so
// the same bits come back on every launch. At S = 1 the block body stores
// straight into C, with no workspace. Ragged m, a, b are masked.
// nvcc --resource-usage (sm_90a), both builds of every tile: 96-119
// registers a thread, 16,385 bytes of static shared memory, no spills, so
// two blocks of 256 threads sit on an SM (registers bound it), the
// plan's two blocks per SM.

#include "common.cuh"

namespace {

template <typename T, int BA, int BB, int TA, int TB, int G, bool kSlices>
__global__ void __launch_bounds__((BA / TA) * (BB / TB) * G)
    tsmt_kernel(const T* __restrict__ X, const T* __restrict__ Y,
                T* __restrict__ C, int m, int a_dim, int b_dim, int splits,
                int slice, float* __restrict__ P,
                unsigned* __restrict__ count) {
  if constexpr (kSlices)
    tsm2x::tsmt_slices_run<T, BA, BB, (BA / TA) * (BB / TB) * G>(
        C, P, count, m, a_dim, b_dim, splits, slice,
        [&](float* dst, long lo, long hi) {
          tsm2x::tsmt_block<T, float, BA, BB, TA, TB, G>(X, Y, dst, lo, hi,
                                                         a_dim, b_dim);
        });
  else
    tsm2x::tsmt_block<T, T, BA, BB, TA, TB, G>(X, Y, C, 0, m, a_dim, b_dim);
}

template <typename T>
int dispatch(const T* x, const T* y, T* c, int m, int a_dim, int b_dim,
             int splits, int slice, void* ws, cudaStream_t stream) {
  return tsm2x::with_tsmt_tile(b_dim, [&](auto tile) {
    using Tl = decltype(tile);
    return tsm2x::tsmt_slices_launch<Tl>(
        a_dim, b_dim, splits, ws, stream,
        [&](auto slices, dim3 grid, int nt, float* p, unsigned* count) {
          tsmt_kernel<T, Tl::BA, Tl::BB, Tl::TA, Tl::TB, Tl::G,
                      decltype(slices)::value>
              <<<grid, nt, 0, stream>>>(x, y, c, m, a_dim, b_dim, splits,
                                        slice, p, count);
        });
  });
}

}  // namespace

extern "C" int tsmt_f32(const void* x, const void* y, void* c, int m, int a,
                        int b, int splits, int slice, void* ws,
                        void* stream) {
  return dispatch<float>((const float*)x, (const float*)y, (float*)c, m, a, b,
                         splits, slice, ws, (cudaStream_t)stream);
}

extern "C" int tsmt_bf16(const void* x, const void* y, void* c, int m, int a,
                         int b, int splits, int slice, void* ws,
                         void* stream) {
  return dispatch<__nv_bfloat16>((const __nv_bfloat16*)x,
                                 (const __nv_bfloat16*)y, (__nv_bfloat16*)c, m,
                                 a, b, splits, slice, ws,
                                 (cudaStream_t)stream);
}
