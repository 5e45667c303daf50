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
// is tiny. At [65536,128]^T [65536,4] the 8 MB of X take 2.6 us at the
// card's rate, so the launch, the slices' short blocks and the last
// block's ordered sum of 128 partials take most of the time.
//
// Design: as tsmt.cu. The output has few tiles, so the caller plans S
// slices of m (core/perf_model.py::tsmt_slices, here in whole bands of the
// scales, so no band straddles two slices) and the grid is (a-tiles,
// b-tiles, S). Block (i, j, s) runs one of tsmt_q8_split.cu's two block
// bodies over its slice, picked by the same rule (tsmt_q8_plan, which
// reads neither m nor S): "packed" (tsmt_q8_packed.cuh: 8 bytes of a row
// of X a thread in one load, 16 rows in flight, four rows a __dp4a after
// a 4 x 4 byte transpose) at b in {4, 8, 12, 16} with a a multiple of 16
// and aligned X and Y; else "simt" (common.cuh's tsmt_block: each int8
// value loaded and widened on its own, one multiply-add a product). Either sums each
// thread's rows of one band as an exact int32, multiplies the sum by
// sX[band] * sY[band] and adds it to its f32 tile; the thread groups'
// tiles are summed in a fixed order into an f32 (S, a, b) workspace. The
// tile's last block (a ticket, the only atomic) sums the S partials in
// slice order from 0.f and writes C once (common.cuh tsmt_slices_run); the
// same bits on every launch, and those of tsmt_q8_split's partials summed
// in slice order. At S = 1 the block body stores straight into C, with no
// workspace. nvcc --resource-usage (sm_90a; chip_smoke.py's resources
// line), f32 and bf16 outputs: the packed body 128 registers a thread
// and 32,768 bytes of static shared memory (32,769 with the slices'
// flag), the simt body 85-123 and 16,384-16,385; no spills, so two
// blocks of 256 threads sit on an SM (the launch bounds' cap).

#include "common.cuh"
#include "tsmt_q8_packed.cuh"

namespace {

namespace pk = tsm2x::packed;

template <typename U, int BA, int BB, int TA, int TB, int G, bool kSlices,
          bool kPacked>
__global__ void __launch_bounds__(pk::NT, 2)
    tsmt_q8_kernel(const int8_t* __restrict__ X,
                   const int8_t* __restrict__ Y, U* __restrict__ C, int m,
                   int a_dim, int b_dim, int splits, int slice,
                   float* __restrict__ P, unsigned* __restrict__ count,
                   tsm2x::BandFold fold) {
  const auto body = [&](auto* dst, long lo, long hi) {
    using V = std::remove_pointer_t<decltype(dst)>;
    if constexpr (kPacked)
      pk::block<V, BA, BB, pk::AW_DEFAULT, pk::RU_DEFAULT>(
          X, Y, dst, lo, hi, a_dim, b_dim, fold);
    else
      tsm2x::tsmt_block<int8_t, V, BA, BB, TA, TB, G>(X, Y, dst, lo, hi,
                                                      a_dim, b_dim, fold);
  };
  if constexpr (kSlices)
    tsm2x::tsmt_slices_run<U, BA, BB, pk::NT>(C, P, count, m, a_dim, b_dim,
                                              splits, slice, body);
  else
    body(C, 0, m);
}

template <typename U>
int run(const void* x, const void* y, const void* sx, const void* sy, void* c,
        int m, int a_dim, int b_dim, int band, int splits, int slice,
        void* ws, void* stream) {
  const tsm2x::BandFold fold{(const float*)sx, (const float*)sy, band};
  const cudaStream_t st = (cudaStream_t)stream;
  const bool packed = pk::fits(a_dim, b_dim, x, y);
  return tsm2x::with_tsmt_tile(b_dim, [&](auto tile) {
    using Tl = decltype(tile);
    return tsm2x::tsmt_slices_launch<Tl>(
        a_dim, b_dim, splits, ws, st,
        [&](auto slices, dim3 grid, int nt, float* p, unsigned* count) {
          constexpr bool kSlices = decltype(slices)::value;
          const auto go = [&](auto kern) {
            kern<<<grid, nt, 0, st>>>((const int8_t*)x, (const int8_t*)y,
                                      (U*)c, m, a_dim, b_dim, splits, slice,
                                      p, count, fold);
          };
          if constexpr (Tl::BB <= 16)
            if (packed)
              return go(tsmt_q8_kernel<U, Tl::BA, Tl::BB, Tl::TA, Tl::TB,
                                       Tl::G, kSlices, true>);
          go(tsmt_q8_kernel<U, Tl::BA, Tl::BB, Tl::TA, Tl::TB, Tl::G, kSlices,
                            false>);
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

// The body a tsmt_q8 call on X at x and Y at y launches: out = {body (0
// simt, 1 packed), a-tiles, b-tiles} (the grid's third dimension is the
// plan's S). The rule (packed::fits) reads neither m nor S, so it is
// tsmt_q8_split_plan's; core/perf_model.py::tsmt_q8_plan mirrors it.
extern "C" int tsmt_q8_plan(int m, int a, int b, const void* x, const void* y,
                            int* out) {
  (void)m;
  out[0] = pk::fits(a, b, x, y) ? 1 : 0;
  return tsm2x::with_tsmt_tile(b, [&](auto tile) {
    using Tl = decltype(tile);
    out[1] = (a + Tl::BA - 1) / Tl::BA;
    out[2] = (b + Tl::BB - 1) / Tl::BB;
    return 0;
  });
}
