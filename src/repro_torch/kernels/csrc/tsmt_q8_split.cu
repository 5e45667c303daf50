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
// memory. What kept the byte-a-value body at 30% of that bound: one
// 32-byte sector a warp load, 16 bytes of X a thread in flight, and one
// multiply-add a product (80% of the bound's time on its own). The packed
// body below loads 8 bytes a thread, keeps 128 in flight and does four
// products a __dp4a: 88% of the bound at Q (PERF.md §6).
//
// Design: grid (a-tiles, b-tiles, S); block (i, j, s) runs one of two
// block bodies over its slice's rows, picked before the launch by
// tsmt_q8_split_plan (the same rule as tsmt_q8.cu's tsmt_q8_plan):
// - "packed" (tsmt_q8_packed.cuh) at b in {4, 8, 12, 16} with a a multiple
//   of 16 and 16-byte aligned X and Y, as PowerSGD's Q: each thread loads
//   8 bytes of a row of X as one uint2 and the row's word of Y, 16 rows
//   before it multiplies; four rows at a time go through a 4 x 4 byte
//   transpose into words of four rows of one column, and each __dp4a does
//   four products into an exact int32 band sum.
// - "simt" (common.cuh's tsmt_block at the int8 load type: one byte
//   loaded and widened a value, one multiply-add a product) for every
//   other call.
// Both sum each thread's rows of one band exactly in int32 and multiply
// the sum by the band's two scales before they add it in f32, then sum
// the thread groups in a fixed order. A slice is a whole number of bands
// (the wrapper passes a band-multiple slice length), so no band straddles
// two slices. The last slice is masked at m. One writer per output
// element: no atomics, the same bits on every launch. Same tile table as
// tsmt.cu, so the grid does not depend on the body.
//
// nvcc --resource-usage (sm_90a; chip_smoke.py's resources line): the
// packed body at its default 128 registers a thread (the cap that launch
// bounds of 256 threads and two blocks an SM set) and 32,768 bytes of
// static shared memory, the simt body 89-92 and 16,384; no spills (the
// sweep's variants 94-128, 16,384-32,768).
//
// tsmt_q8_split_sweep_f32 launches the packed body's variants (bytes of a
// row of X a thread, rows loaded before any is multiplied;
// tsmt_q8_split_sweep_variant lists them), for chip_smoke.py's sweep.

#include "common.cuh"
#include "tsmt_q8_packed.cuh"

namespace {

namespace pk = tsm2x::packed;

template <int BA, int BB, int TA, int TB, int G, bool kPacked, int AW, int RU>
__global__ void __launch_bounds__(pk::NT, 2)
    tsmt_q8_split_kernel(const int8_t* __restrict__ X,
                         const int8_t* __restrict__ Y, float* __restrict__ P,
                         int m, int a_dim, int b_dim, int slice,
                         tsm2x::BandFold fold) {
  const long s = blockIdx.z;
  const long lo = s * slice < m ? s * slice : m;
  const long hi = lo + slice < m ? lo + slice : m;
  float* dst = P + s * (long)a_dim * b_dim;
  if constexpr (kPacked)
    pk::block<float, BA, BB, AW, RU>(X, Y, dst, lo, hi, a_dim, b_dim, fold);
  else
    tsm2x::tsmt_block<int8_t, float, BA, BB, TA, TB, G>(X, Y, dst, lo, hi,
                                                        a_dim, b_dim, fold);
}

// The packed body at variant (AW, RU) where packed is set (the plan's
// choice), else tsmt_block.
template <int AW, int RU>
int run(const void* x, const void* y, const void* sx, const void* sy,
        void* p, int m, int a, int b, int band, int splits, int slice,
        bool packed, void* stream) {
  const tsm2x::BandFold fold{(const float*)sx, (const float*)sy, band};
  return tsm2x::with_tsmt_tile(b, [&](auto tile) {
    using Tl = decltype(tile);
    dim3 grid((a + Tl::BA - 1) / Tl::BA, (b + Tl::BB - 1) / Tl::BB, splits);
    const auto args = [&](auto kern) {
      kern<<<grid, pk::NT, 0, (cudaStream_t)stream>>>(
          (const int8_t*)x, (const int8_t*)y, (float*)p, m, a, b, slice,
          fold);
      return (int)cudaGetLastError();
    };
    if constexpr (Tl::BB <= 16)
      if (packed)
        return args(tsmt_q8_split_kernel<Tl::BA, Tl::BB, Tl::TA, Tl::TB,
                                         Tl::G, true, AW, RU>);
    return args(tsmt_q8_split_kernel<Tl::BA, Tl::BB, Tl::TA, Tl::TB, Tl::G,
                                     false, pk::AW_DEFAULT, pk::RU_DEFAULT>);
  });
}

}  // namespace

extern "C" int tsmt_q8_split_f32(const void* x, const void* y,
                                 const void* sx, const void* sy, void* p,
                                 int m, int a, int b, int band, int splits,
                                 int slice, void* stream) {
  return run<pk::AW_DEFAULT, pk::RU_DEFAULT>(x, y, sx, sy, p, m, a, b, band,
                                             splits, slice,
                                             pk::fits(a, b, x, y), stream);
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

// The body a tsmt_q8_split call on X at x and Y at y launches: out = {body
// (0 simt, 1 packed), a-tiles, b-tiles}. The rule (packed::fits) reads
// neither m nor S; core/perf_model.py::tsmt_q8_plan mirrors it.
extern "C" int tsmt_q8_split_plan(int m, int a, int b, const void* x,
                                  const void* y, int* out) {
  int grid[3];
  tsmt_q8_split_grid(m, a, b, 1, grid);
  out[0] = pk::fits(a, b, x, y) ? 1 : 0;
  out[1] = grid[0], out[2] = grid[1];
  return 0;
}

// Sweep variant i of the packed body: out = {bytes of a row of X a thread,
// rows a thread loads before it multiplies}; non-zero past the last.
extern "C" int tsmt_q8_split_sweep_variant(int i, int* out) {
  if (i < 0 || i >= pk::N_SWEEP) return (int)cudaErrorInvalidValue;
  out[0] = pk::SWEEP[i][0], out[1] = pk::SWEEP[i][1];
  return 0;
}

// tsmt_q8_split_f32 on the packed body at sweep variant i; refuses
// operands the packed body does not take.
extern "C" int tsmt_q8_split_sweep_f32(int i, const void* x, const void* y,
                                       const void* sx, const void* sy,
                                       void* p, int m, int a, int b, int band,
                                       int splits, int slice, void* stream) {
  if (!pk::fits(a, b, x, y)) return (int)cudaErrorInvalidValue;
  return pk::with_variant(i, [&](auto aw, auto ru) {
    return run<decltype(aw)::value, decltype(ru)::value>(
        x, y, sx, sy, p, m, a, b, band, splits, slice, true, stream);
  });
}
