// Split-reduction TSMT on Hopper: P[s] = X[M_s, :]^T @ Y[M_s, :] for S
// contiguous slices M_s of the reduction, written as (S, a, b) f32
// partials.
//
// Replaces src/repro/kernels/tsmt.py::tsmt_pallas_split (body
// _tsmt_split_kernel). The partials are summed in kernels/reduce.py.
//
// Bound on the H100: the bytes of X and Y, each read once (the (S, a, b)
// partials are tiny at PowerSGD and ABFT shapes). The sequential tsmt.cu
// gives one block per output tile: 32 blocks for PowerSGD's Q projection
// of a [65024, 4096] gradient, 1 block at [2^20, 128]^T [2^20, 4], on a
// 132-SM card. Splitting m multiplies the blocks by S, so S slices let
// the card's SMs all pull from memory.
//
// Design: grid (a-tiles, b-tiles, S). Block (i, j, s) runs TSMT's block
// body (common.cuh: G thread groups over strided rows, two-level f32 sum,
// fixed-order group sum through shared memory) over its slice's rows
// [s * slice, (s + 1) * slice) only, and stores its f32 tile to
// partials[s]. The last slice is masked at m, which equals zero padding of
// m to S whole slices (the TPU kernel's layout) without copying X and Y.
// Every output element has one writer: no atomics, the same bits on every
// launch. Same tile table as tsmt.cu.

#include "common.cuh"

namespace {

template <typename T, int BA, int BB, int TA, int TB, int G>
__global__ void __launch_bounds__((BA / TA) * (BB / TB) * G)
    tsmt_split_kernel(const T* __restrict__ X, const T* __restrict__ Y,
                      float* __restrict__ P, int m, int a_dim, int b_dim,
                      int slice) {
  const long s = blockIdx.z;
  const long lo = s * slice < m ? s * slice : m;
  const long hi = lo + slice < m ? lo + slice : m;
  tsm2x::tsmt_block<T, float, BA, BB, TA, TB, G>(
      X, Y, P + s * (long)a_dim * b_dim, lo, hi, a_dim, b_dim);
}

template <typename T>
int dispatch(const T* x, const T* y, float* p, int m, int a_dim, int b_dim,
             int splits, int slice, cudaStream_t stream) {
  return tsm2x::with_tsmt_tile(b_dim, [&](auto tile) {
    using Tl = decltype(tile);
    constexpr int NT = (Tl::BA / Tl::TA) * (Tl::BB / Tl::TB) * Tl::G;
    dim3 grid((a_dim + Tl::BA - 1) / Tl::BA, (b_dim + Tl::BB - 1) / Tl::BB,
              splits);
    tsmt_split_kernel<T, Tl::BA, Tl::BB, Tl::TA, Tl::TB, Tl::G>
        <<<grid, NT, 0, stream>>>(x, y, p, m, a_dim, b_dim, slice);
    return (int)cudaGetLastError();
  });
}

}  // namespace

extern "C" int tsmt_split_f32(const void* x, const void* y, void* p, int m,
                              int a, int b, int splits, int slice,
                              void* stream) {
  return dispatch<float>((const float*)x, (const float*)y, (float*)p, m, a, b,
                         splits, slice, (cudaStream_t)stream);
}

extern "C" int tsmt_split_bf16(const void* x, const void* y, void* p, int m,
                               int a, int b, int splits, int slice,
                               void* stream) {
  return dispatch<__nv_bfloat16>((const __nv_bfloat16*)x,
                                 (const __nv_bfloat16*)y, (float*)p, m, a, b,
                                 splits, slice, (cudaStream_t)stream);
}

// The launch grid for (m, a, b, splits), from the tile table the kernels
// use: out[0..2] = (a-tiles, b-tiles, splits). Python mirrors it in
// core/perf_model.py::tsmt_grid.
extern "C" int tsmt_split_grid(int m, int a, int b, int splits, int* out) {
  (void)m;
  return tsm2x::with_tsmt_tile(b, [&](auto tile) {
    using Tl = decltype(tile);
    out[0] = (a + Tl::BA - 1) / Tl::BA;
    out[1] = (b + Tl::BB - 1) / Tl::BB;
    out[2] = splits;
    return 0;
  });
}
