// Split-reduction int8 TSMT on Hopper: P[s] = sum over the bands j of slice
// M_s of int32(X8[j]^T @ Y8[j]) * sX[j] * sY[j], for S contiguous slices of
// whole bands, written as (S, a, b) f32 partials in real units.
//
// Replaces src/repro/kernels/quant.py::tsmt_q8_pallas_split (body
// _tsmt_q8_split_kernel). The partials are summed in kernels/reduce.py.
//
// Bound on the H100: the bytes of X and Y at 1 byte an element, each read
// once, plus the scale sidecars (the (S, a, b) partials are tiny at
// PowerSGD's shapes). Splitting m multiplies the blocks by S, so at
// PowerSGD's Q projection (32 output tiles) the card's SMs all pull from
// memory.
//
// Design: grid (a-tiles, b-tiles, S); block (i, j, s) runs TSMT's block
// body (common.cuh) at the int8 load type with a BandFold over its slice's
// rows only: exact int32 sums per band and thread group, dequantized with
// the band's two scales before they are added in f32, then the fixed-order
// group sum. A slice is a whole number of bands (the wrapper passes a
// band-multiple slice length), so no band straddles two slices. The last
// slice is masked at m. One writer per output element: no atomics, the
// same bits on every launch. Same tile table as tsmt.cu.

#include "common.cuh"

namespace {

template <int BA, int BB, int TA, int TB, int G>
__global__ void __launch_bounds__((BA / TA) * (BB / TB) * G)
    tsmt_q8_split_kernel(const int8_t* __restrict__ X,
                         const int8_t* __restrict__ Y, float* __restrict__ P,
                         int m, int a_dim, int b_dim, int slice,
                         tsm2x::BandFold fold) {
  const long s = blockIdx.z;
  const long lo = s * slice < m ? s * slice : m;
  const long hi = lo + slice < m ? lo + slice : m;
  tsm2x::tsmt_block<int8_t, float, BA, BB, TA, TB, G>(
      X, Y, P + s * (long)a_dim * b_dim, lo, hi, a_dim, b_dim, fold);
}

}  // namespace

extern "C" int tsmt_q8_split_f32(const void* x, const void* y,
                                 const void* sx, const void* sy, void* p,
                                 int m, int a, int b, int band, int splits,
                                 int slice, void* stream) {
  const tsm2x::BandFold fold{(const float*)sx, (const float*)sy, band};
  return tsm2x::with_tsmt_tile(b, [&](auto tile) {
    using Tl = decltype(tile);
    constexpr int NT = (Tl::BA / Tl::TA) * (Tl::BB / Tl::TB) * Tl::G;
    dim3 grid((a + Tl::BA - 1) / Tl::BA, (b + Tl::BB - 1) / Tl::BB, splits);
    tsmt_q8_split_kernel<Tl::BA, Tl::BB, Tl::TA, Tl::TB, Tl::G>
        <<<grid, NT, 0, (cudaStream_t)stream>>>(
            (const int8_t*)x, (const int8_t*)y, (float*)p, m, a, b, slice,
            fold);
    return (int)cudaGetLastError();
  });
}

// The launch grid for (m, a, b, splits): out[0..2] = (a-tiles, b-tiles,
// splits), from the tile table the kernel uses (core/perf_model.py mirrors
// it in tsmt_grid).
extern "C" int tsmt_q8_split_grid(int m, int a, int b, int splits,
                                  int* out) {
  (void)m;
  return tsm2x::with_tsmt_tile(b, [&](auto tile) {
    using Tl = decltype(tile);
    out[0] = (a + Tl::BA - 1) / Tl::BA;
    out[1] = (b + Tl::BB - 1) / Tl::BB;
    out[2] = splits;
    return 0;
  });
}
