// Split-reduction int8 TSM2R on Hopper: P[s] = int32(A8[:, K_s] @ B8[K_s, :])
// * sA[band of row] * sB for S contiguous slices K_s of the reduction,
// written as (S, m, n) f32 partials, already in real units.
//
// Replaces src/repro/kernels/quant.py::tsm2r_q8_pallas_split (body
// _tsm2r_q8_split_kernel). The partials are summed by reduce.cu (or a plain
// sum for small stacks) in kernels/reduce.py, which sees nothing different
// from the f32 split: the scales are folded before the partials leave.
//
// Bound on the H100: the bytes of A at 1 byte an element, plus the (S, m,
// n) f32 partials written here and read back by the epilogue. It pays off
// where the output tiles alone leave SMs idle.
//
// Design: grid (m-tiles, n-tiles, S); block (i, j, s) runs TSM2R's block
// body (common.cuh) at the int8 load type (__dp4a on words of four packed
// k values, exact int32 per BK tile, folded into f32) over its slice's k
// range only, and multiplies its tile by sA[row / band] * sB once at the
// store (the JAX kernel folds per k step: the same value up to f32
// rounding). The last slice is masked at k. One writer per output element:
// no atomics, the same bits on every launch. Same tile table as tsm2r.cu.

#include "common.cuh"

namespace {

template <int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    tsm2r_q8_split_kernel(const int8_t* __restrict__ A,
                          const int8_t* __restrict__ B, float* __restrict__ P,
                          int m, int k, int n, int slice,
                          tsm2x::RowFold fold) {
  const long s = blockIdx.z;
  const long lo = s * slice;
  const int k_lo = lo < k ? (int)lo : k;
  const long hi = lo + slice;
  const int k_hi = hi < k ? (int)hi : k;
  tsm2x::tsm2r_block<int8_t, float, BM, BN, BK, TM, TN>(
      A, B, P + s * (long)m * n, m, k, n, k_lo, k_hi, fold);
}

}  // namespace

extern "C" int tsm2r_q8_split_f32(const void* a, const void* b,
                                  const void* sa, const void* sb, void* p,
                                  int m, int k, int n, int band, int splits,
                                  int slice, void* stream) {
  const tsm2x::RowFold fold{(const float*)sa, (const float*)sb, band};
  return tsm2x::with_tsm2r_tile(n, [&](auto tile) {
    using Tl = decltype(tile);
    constexpr int NT = (Tl::BM / Tl::TM) * (Tl::BN / Tl::TN);
    dim3 grid((m + Tl::BM - 1) / Tl::BM, (n + Tl::BN - 1) / Tl::BN, splits);
    tsm2r_q8_split_kernel<Tl::BM, Tl::BN, Tl::BK, Tl::TM, Tl::TN>
        <<<grid, NT, 0, (cudaStream_t)stream>>>(
            (const int8_t*)a, (const int8_t*)b, (float*)p, m, k, n, slice,
            fold);
    return (int)cudaGetLastError();
  });
}

// The launch grid for (m, k, n, splits): out[0..2] = (m-tiles, n-tiles,
// splits), from the tile table the kernel uses (core/perf_model.py mirrors
// it in tsm2r_grid).
extern "C" int tsm2r_q8_split_grid(int m, int k, int n, int splits,
                                   int* out) {
  (void)k;
  return tsm2x::with_tsm2r_tile(n, [&](auto tile) {
    using Tl = decltype(tile);
    out[0] = (m + Tl::BM - 1) / Tl::BM;
    out[1] = (n + Tl::BN - 1) / Tl::BN;
    out[2] = splits;
    return 0;
  });
}
