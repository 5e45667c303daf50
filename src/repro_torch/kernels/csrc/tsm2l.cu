// TSM2L on Hopper: C[m,n] = A[m,k] @ B[k,n] with m >> k ~ n (both small).
//
// Replaces src/repro/kernels/tsm2l.py::tsm2l_pallas (body _tsm2l_kernel).
//
// Bound on the H100: ~2n FLOP per A element with k, n <= 256, so the bytes
// of A and C bound it; at the smallest shapes (k = n = 4) the launch and the
// latency of each row tile dominate (the paper's latency-bound case).
//
// Design: the kernel body and its launch (tsm2l_kernel, tsm2l_dispatch in
// common.cuh, shared with tsm2l_q8.cu): blocks stride over row tiles so the
// B tile staged into shared memory stays there for the block's lifetime; B
// is tiled over n, and over k past a chunk, to fit a block's shared memory;
// three tile shapes picked by n answer the paper's tcf trade. Ragged m, k,
// n are masked. Accumulation is f32.

#include "common.cuh"

extern "C" int tsm2l_f32(const void* a, const void* b, void* c, int m, int k,
                         int n, void* stream) {
  return tsm2x::tsm2l_dispatch((const float*)a, (const float*)b, (float*)c, m,
                               k, n, tsm2x::NoFold(), (cudaStream_t)stream);
}

extern "C" int tsm2l_bf16(const void* a, const void* b, void* c, int m, int k,
                          int n, void* stream) {
  return tsm2x::tsm2l_dispatch((const __nv_bfloat16*)a,
                               (const __nv_bfloat16*)b, (__nv_bfloat16*)c, m,
                               k, n, tsm2x::NoFold(), (cudaStream_t)stream);
}
