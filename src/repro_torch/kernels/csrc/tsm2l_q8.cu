// Int8 TSM2L on Hopper: C[m,n] = int32(A8[m,k] @ B8[k,n]) * sA[band of row]
// * sB with m >> k ~ n (both small), written as f32 or bf16.
//
// Replaces src/repro/kernels/quant.py::tsm2l_q8_pallas (body
// _tsm2l_q8_kernel): a single-shot product whose scales fold into the one
// store.
//
// Bound on the H100: the bytes of A (1 byte an element) and of C (4 or 2
// bytes an element, more than A at n >= k / 4), plus the sA sidecar (4
// bytes a band); at the smallest shapes (k = n = 4) the launch and the
// latency of each row tile, as for tsm2l.
//
// Design: TSM2L's kernel body and launch (common.cuh) at the int8 load
// type: B stays resident in shared memory for the block's lifetime, four
// consecutive k values of A and of B packed into each 32-bit word, so one
// __dp4a does four exact products into an int32 sum (at most 127^2 * KC
// per staged chunk, so no depth overflows: chunks fold into f32). The
// RowFold epilogue multiplies each output by sA[row / band] * sB once.

#include "common.cuh"

namespace {

template <typename U>
int run(const void* a, const void* b, const void* sa, const void* sb, void* c,
        int m, int k, int n, int band, void* stream) {
  const tsm2x::RowFold fold{(const float*)sa, (const float*)sb, band};
  return tsm2x::tsm2l_dispatch((const int8_t*)a, (const int8_t*)b, (U*)c, m,
                               k, n, fold, (cudaStream_t)stream);
}

}  // namespace

extern "C" int tsm2l_q8_f32(const void* a, const void* b, const void* sa,
                            const void* sb, void* c, int m, int k, int n,
                            int band, void* stream) {
  return run<float>(a, b, sa, sb, c, m, k, n, band, stream);
}

extern "C" int tsm2l_q8_bf16(const void* a, const void* b, const void* sa,
                             const void* sb, void* c, int m, int k, int n,
                             int band, void* stream) {
  return run<__nv_bfloat16>(a, b, sa, sb, c, m, k, n, band, stream);
}
