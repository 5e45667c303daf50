// Int8 TSM2R on Hopper: C[m,n] = int32(A8[m,k] @ B8[k,n]) * sA[band of
// row] * sB with m ~ k >> n, written as f32 or bf16.
//
// Replaces src/repro/kernels/quant.py::tsm2r_q8_pallas (body
// _tsm2r_q8_kernel): A's scale is constant along a row, so both scales fold
// in once at the flush.
//
// Bound on the H100: the bytes of A at 1 byte an element (a quarter of the
// f32 stream), plus B, the sA sidecar (4 bytes a band of rows) and the
// output in the caller's dtype. At n = 256 the work is 2n operations an A
// byte, far below the tensor cores' int8 ridge, so bytes bound it there;
// this first kernel multiplies on the CUDA cores, where __dp4a runs four
// int8 products an instruction at the int32 issue rate.
//
// Design: TSM2R's block body and tile table (common.cuh) at the int8 load
// type. The raw int8 tile is prefetched into registers while the current
// one is multiplied; staging packs four consecutive k values of A (a row)
// and of B (a column) into one 32-bit word of shared memory, so each
// __dp4a does four exact products. A BK = 32 tile's sum is an exact int32
// (at most 127^2 * 32), folded into the f32 sum once a tile, so no depth
// overflows. The RowFold epilogue multiplies by sA[row / band] * sB.

#include "common.cuh"

namespace {

template <typename U, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    tsm2r_q8_kernel(const int8_t* __restrict__ A,
                    const int8_t* __restrict__ B, U* __restrict__ C, int m,
                    int k, int n, tsm2x::RowFold fold) {
  tsm2x::tsm2r_block<int8_t, U, BM, BN, BK, TM, TN>(A, B, C, m, k, n, 0, k,
                                                    fold);
}

template <typename U>
int run(const void* a, const void* b, const void* sa, const void* sb, void* c,
        int m, int k, int n, int band, void* stream) {
  const tsm2x::RowFold fold{(const float*)sa, (const float*)sb, band};
  return tsm2x::with_tsm2r_tile(n, [&](auto tile) {
    using Tl = decltype(tile);
    constexpr int NT = (Tl::BM / Tl::TM) * (Tl::BN / Tl::TN);
    dim3 grid((m + Tl::BM - 1) / Tl::BM, (n + Tl::BN - 1) / Tl::BN);
    tsm2r_q8_kernel<U, Tl::BM, Tl::BN, Tl::BK, Tl::TM, Tl::TN>
        <<<grid, NT, 0, (cudaStream_t)stream>>>(
            (const int8_t*)a, (const int8_t*)b, (U*)c, m, k, n, fold);
    return (int)cudaGetLastError();
  });
}

}  // namespace

extern "C" int tsm2r_q8_f32(const void* a, const void* b, const void* sa,
                            const void* sb, void* c, int m, int k, int n,
                            int band, void* stream) {
  return run<float>(a, b, sa, sb, c, m, k, n, band, stream);
}

extern "C" int tsm2r_q8_bf16(const void* a, const void* b, const void* sa,
                             const void* sb, void* c, int m, int k, int n,
                             int band, void* stream) {
  return run<__nv_bfloat16>(a, b, sa, sb, c, m, k, n, band, stream);
}
