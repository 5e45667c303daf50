// Int8 TSMT on Hopper: C[a,b] = sum over bands j of the reduction of
// int32(X8[j]^T @ Y8[j]) * sX[j] * sY[j], written as f32 or bf16.
//
// Replaces src/repro/kernels/quant.py::tsmt_q8_pallas (body
// _tsmt_q8_kernel): both operands are tall, so both scales vary along the
// reduced m axis, and each band's sum is dequantized before it is added.
//
// Bound on the H100: the bytes of X and Y at 1 byte an element (each read
// once) plus the two (bands, 1) f32 sidecars; the output is tiny. As for
// tsmt.cu, at a, b <= 16 the output is a few tiles, so this sequential
// kernel runs on a few SMs and reaches a small share of that bound; the
// split kernel (tsmt_q8_split.cu) occupies the card.
//
// Design: TSMT's block body and tile table (common.cuh) at the int8 load
// type, with a BandFold: each thread group sums its rows of one band as an
// exact int32 (int8 values widened, one multiply-add each: X and Y are read
// straight from global memory, so there is no packed word for __dp4a),
// multiplies the sum by sX[band] * sY[band] and adds it to its f32 tile;
// the G group tiles are summed in a fixed order. No atomics: the same bits
// on every launch.

#include "common.cuh"

namespace {

template <typename U, int BA, int BB, int TA, int TB, int G>
__global__ void __launch_bounds__((BA / TA) * (BB / TB) * G)
    tsmt_q8_kernel(const int8_t* __restrict__ X,
                   const int8_t* __restrict__ Y, U* __restrict__ C, int m,
                   int a_dim, int b_dim, tsm2x::BandFold fold) {
  tsm2x::tsmt_block<int8_t, U, BA, BB, TA, TB, G>(X, Y, C, 0, m, a_dim,
                                                  b_dim, fold);
}

template <typename U>
int run(const void* x, const void* y, const void* sx, const void* sy, void* c,
        int m, int a_dim, int b_dim, int band, void* stream) {
  const tsm2x::BandFold fold{(const float*)sx, (const float*)sy, band};
  return tsm2x::with_tsmt_tile(b_dim, [&](auto tile) {
    using Tl = decltype(tile);
    constexpr int NT = (Tl::BA / Tl::TA) * (Tl::BB / Tl::TB) * Tl::G;
    dim3 grid((a_dim + Tl::BA - 1) / Tl::BA, (b_dim + Tl::BB - 1) / Tl::BB);
    tsmt_q8_kernel<U, Tl::BA, Tl::BB, Tl::TA, Tl::TB, Tl::G>
        <<<grid, NT, 0, (cudaStream_t)stream>>>(
            (const int8_t*)x, (const int8_t*)y, (U*)c, m, a_dim, b_dim, fold);
    return (int)cudaGetLastError();
  });
}

}  // namespace

extern "C" int tsmt_q8_f32(const void* x, const void* y, const void* sx,
                           const void* sy, void* c, int m, int a, int b,
                           int band, void* stream) {
  return run<float>(x, y, sx, sy, c, m, a, b, band, stream);
}

extern "C" int tsmt_q8_bf16(const void* x, const void* y, const void* sx,
                            const void* sy, void* c, int m, int a, int b,
                            int band, void* stream) {
  return run<__nv_bfloat16>(x, y, sx, sy, c, m, a, b, band, stream);
}
