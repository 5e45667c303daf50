// Split-reduction TSM2R on Hopper: P[s] = A[:, K_s] @ B[K_s, :] for S
// contiguous slices K_s of the reduction, written as (S, m, n) f32 partials.
//
// Replaces src/repro/kernels/tsm2r.py::tsm2r_pallas_split (body
// _tsm2r_split_kernel). The partials are summed by reduce.cu (or a plain
// sum for small stacks) in kernels/reduce.py.
//
// Bound on the H100: the bytes of A, as for TSM2R, plus the (S, m, n) f32
// partials written here and read back by the epilogue. It pays off where
// TSM2R's output tiles alone leave SMs idle: the paper's [16384^2] @
// [16384, 16] has 128 row tiles for 132 SMs.
//
// Design: grid (m-tiles, n-tiles, S). Block (i, j, s) runs TSM2R's block
// body (common.cuh: register prefetch of the next tile, shared-memory
// staging, two-level f32 sum) over its slice's k range
// [s * slice, (s + 1) * slice) only, and stores its f32 tile to partials[s].
// The slice length is a whole number of BK-deep k tiles; the last slice is
// masked at k, which equals zero padding of k to S whole slices (the TPU
// kernel's padded layout) without copying A. No block shares an output
// element with another, so there are no atomics and every launch gives the
// same bits. Same tile table as tsm2r.cu.

#include "common.cuh"

namespace {

template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    tsm2r_split_kernel(const T* __restrict__ A, const T* __restrict__ B,
                       float* __restrict__ P, int m, int k, int n,
                       int slice) {
  const long s = blockIdx.z;
  const long lo = s * slice;
  const int k_lo = lo < k ? (int)lo : k;
  const long hi = lo + slice;
  const int k_hi = hi < k ? (int)hi : k;
  tsm2x::tsm2r_block<T, float, BM, BN, BK, TM, TN>(
      A, B, P + s * (long)m * n, m, k, n, k_lo, k_hi);
}

template <typename T>
int dispatch(const T* a, const T* b, float* p, int m, int k, int n,
             int splits, int slice, cudaStream_t stream) {
  return tsm2x::with_tsm2r_tile(n, [&](auto tile) {
    using Tl = decltype(tile);
    constexpr int NT = (Tl::BM / Tl::TM) * (Tl::BN / Tl::TN);
    dim3 grid((m + Tl::BM - 1) / Tl::BM, (n + Tl::BN - 1) / Tl::BN, splits);
    tsm2r_split_kernel<T, Tl::BM, Tl::BN, Tl::BK, Tl::TM, Tl::TN>
        <<<grid, NT, 0, stream>>>(a, b, p, m, k, n, slice);
    return (int)cudaGetLastError();
  });
}

}  // namespace

extern "C" int tsm2r_split_f32(const void* a, const void* b, void* p, int m,
                               int k, int n, int splits, int slice,
                               void* stream) {
  return dispatch<float>((const float*)a, (const float*)b, (float*)p, m, k, n,
                         splits, slice, (cudaStream_t)stream);
}

extern "C" int tsm2r_split_bf16(const void* a, const void* b, void* p, int m,
                                int k, int n, int splits, int slice,
                                void* stream) {
  return dispatch<__nv_bfloat16>((const __nv_bfloat16*)a,
                                 (const __nv_bfloat16*)b, (float*)p, m, k, n,
                                 splits, slice, (cudaStream_t)stream);
}

// The launch grid for (m, k, n, splits), from the tile table the kernels
// use: out[0..2] = (m-tiles, n-tiles, splits). Python mirrors it in
// core/perf_model.py::tsm2r_grid.
extern "C" int tsm2r_split_grid(int m, int k, int n, int splits, int* out) {
  (void)k;
  return tsm2x::with_tsm2r_tile(n, [&](auto tile) {
    using Tl = decltype(tile);
    out[0] = (m + Tl::BM - 1) / Tl::BM;
    out[1] = (n + Tl::BN - 1) / Tl::BN;
    out[2] = splits;
    return 0;
  });
}
