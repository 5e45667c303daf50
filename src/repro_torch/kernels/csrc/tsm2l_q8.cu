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
// TSM2L's two bodies at the int8 load type, picked by tsm2l_q8_plan as
// tsm2l_plan picks them (tsm2l.cu):
// - "stream" (tsm2l_stream.cuh): n in 1..16, k in 1..256, a 16-byte
//   aligned A. A row word of A holds four consecutive k values of one row
//   and B is staged as packed words of four k values of a column, so each
//   __dp4a multiplies A's row words as they lie: four exact products into
//   an int32 sum (127^2 * 256 << 2^31), converted once and multiplied by
//   sA[row / band] * sB: bit-equal to the plain version.
// - "tile" (common.cuh): every other call. B stays resident in shared
//   memory for the block's lifetime, four consecutive k values of A and of
//   B packed into each 32-bit word, __dp4a into an int32 sum per staged
//   chunk of at most KC k values (folded into f32 between chunks, so no
//   depth overflows); the RowFold epilogue multiplies each output by
//   sA[row / band] * sB once.

#include "common.cuh"
#include "tsm2l_stream.cuh"

namespace {

template <typename U>
int run(const void* a, const void* b, const void* sa, const void* sb, void* c,
        int m, int k, int n, int band, void* stream) {
  const tsm2x::RowFold fold{(const float*)sa, (const float*)sb, band};
  if (tsm2x::stream::fits(k, n, a))
    return tsm2x::stream::launch((const int8_t*)a, (const int8_t*)b, (U*)c,
                                 m, k, n, fold, (cudaStream_t)stream);
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

// tsm2l_plan's query (tsm2l.cu) for a tsm2l_q8 call writing out_tag (0
// f32, 1 bf16).
extern "C" int tsm2l_q8_plan(int m, int k, int n, int out_tag, const void* a,
                             int* out) {
  return tsm2x::tsm2l_plan_query(m, k, n, 1, out_tag == 1 ? 2 : 4, a, out);
}
