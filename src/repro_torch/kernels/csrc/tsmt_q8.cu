// Int8 TSMT on Hopper: C[a,b] = sum over bands j of the reduction of
// int32(X8[j]^T @ Y8[j]) * sX[j] * sY[j], written as f32 or bf16, in one
// launch that spreads the m reduction over every SM.
//
// Replaces src/repro/kernels/quant.py::tsmt_q8_pallas (body
// _tsmt_q8_kernel): both operands are tall, so both scales vary along the
// reduced m axis, and each band's sum is dequantized before it is added.
//
// Bound on the H100: the bytes of X and Y at 1 byte an element (each read
// once) and the two (bands, 1) f32 sidecars, plus the 2 * S * a * b * 4
// bytes of f32 partials written and read back past one slice; the output
// is tiny. Each int8 value is loaded and widened on its own, so the kernel
// issues four times the load instructions of the f32 build per byte.
//
// Design: as tsmt.cu. The output has few tiles, so the caller plans S
// slices of m (core/perf_model.py::tsmt_slices, here in whole bands of the
// scales, so no band straddles two slices) and the grid is (a-tiles,
// b-tiles, S). Block (i, j, s) runs TSMT's block body at the int8 load
// type with a BandFold over its slice: each thread group sums its rows of
// one band as an exact int32 (int8 values widened, one multiply-add each),
// multiplies the sum by sX[band] * sY[band] and adds it to its f32 tile;
// the G group tiles are summed in a fixed order into an f32 (S, a, b)
// workspace. The tile's last block (a ticket, the only atomic) sums the S
// partials in slice order from 0.f and writes C once (common.cuh
// tsmt_slices_block); the same bits on every launch. At S = 1 the block
// body stores straight into C, with no workspace. nvcc --resource-usage
// (sm_90a): 86-105 registers a thread, 16,385 bytes of static shared
// memory, no spills: two blocks of 256 threads an SM.

#include "common.cuh"

namespace {

template <typename U, int BA, int BB, int TA, int TB, int G, bool kSlices>
__global__ void __launch_bounds__((BA / TA) * (BB / TB) * G)
    tsmt_q8_kernel(const int8_t* __restrict__ X,
                   const int8_t* __restrict__ Y, U* __restrict__ C, int m,
                   int a_dim, int b_dim, int splits, int slice,
                   float* __restrict__ P, unsigned* __restrict__ count,
                   tsm2x::BandFold fold) {
  if constexpr (kSlices)
    tsm2x::tsmt_slices_block<int8_t, U, BA, BB, TA, TB, G>(
        X, Y, C, P, count, m, a_dim, b_dim, splits, slice, fold);
  else
    tsm2x::tsmt_block<int8_t, U, BA, BB, TA, TB, G>(X, Y, C, 0, m, a_dim,
                                                    b_dim, fold);
}

template <typename U>
int run(const void* x, const void* y, const void* sx, const void* sy, void* c,
        int m, int a_dim, int b_dim, int band, int splits, int slice,
        void* ws, void* stream) {
  const tsm2x::BandFold fold{(const float*)sx, (const float*)sy, band};
  const cudaStream_t st = (cudaStream_t)stream;
  return tsm2x::with_tsmt_tile(b_dim, [&](auto tile) {
    using Tl = decltype(tile);
    return tsm2x::tsmt_slices_launch<Tl>(
        a_dim, b_dim, splits, ws, st,
        [&](auto slices, dim3 grid, int nt, float* p, unsigned* count) {
          tsmt_q8_kernel<U, Tl::BA, Tl::BB, Tl::TA, Tl::TB, Tl::G,
                         decltype(slices)::value>
              <<<grid, nt, 0, st>>>((const int8_t*)x, (const int8_t*)y,
                                    (U*)c, m, a_dim, b_dim, splits, slice, p,
                                    count, fold);
        });
  });
}

}  // namespace

extern "C" int tsmt_q8_f32(const void* x, const void* y, const void* sx,
                           const void* sy, void* c, int m, int a, int b,
                           int band, int splits, int slice, void* ws,
                           void* stream) {
  return run<float>(x, y, sx, sy, c, m, a, b, band, splits, slice, ws,
                    stream);
}

extern "C" int tsmt_q8_bf16(const void* x, const void* y, const void* sx,
                            const void* sy, void* c, int m, int a, int b,
                            int band, int splits, int slice, void* ws,
                            void* stream) {
  return run<__nv_bfloat16>(x, y, sx, sy, c, m, a, b, band, splits, slice,
                            ws, stream);
}
