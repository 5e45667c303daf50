// TSM2R on Hopper: C[m,n] = A[m,k] @ B[k,n] with m ~ k >> n.
//
// Replaces src/repro/kernels/tsm2r.py::tsm2r_pallas (body _tsm2r_kernel).
//
// Two bodies; tsm2r_plan picks one from the shape, the dtype and the
// operands' alignment before the launch (never after a failure):
// - "wgmma" (tsm2r_wgmma.cuh): bf16 with n > 16, k and n multiples of 8
//   and 16-byte aligned bases. TMA copies 64 x 64 swizzled boxes of A and
//   B into a 4-stage shared-memory ring guarded by full/empty mbarriers;
//   one warpgroup multiplies them on the tensor cores
//   (wgmma.m64n128k16.f32.bf16.bf16, B read MN-major through the transpose
//   bit) into f32 registers. Bound on the H100 by the bytes of A plus B's
//   re-reads from L2, one per 64-row tile (at n = 256 the work is 512 FLOP
//   per element of A, below the card's ridge of ~295 FLOP a byte).
// - "simt" (common.cuh's tsm2r_block): every other call: f32 (PowerSGD's
//   P at n = 4), n <= 16, and strides or bases TMA cannot take. Its FMAs
//   run on the CUDA cores in f32: bound by the bytes of A at n <= 16 and
//   by the f32 FMA rate (67 TFLOP/s) at wide n, which is why bf16's wide
//   outputs go to the tensor cores.
//
// simt design (paper Algorithm 4: outer product, B staged in shared memory,
// next tile prefetched into registers): one block owns a BM x BN output tile
// and loops over k inside the block, where the TPU ran a sequential grid
// axis. The next (BM x BK) A tile and (BK x BN) B tile are loaded into
// registers while the current tile is multiplied out of shared memory. The
// paper keeps all n outputs of a row in one thread; that only fits n <= ~16,
// so the n columns are spread over the block's threads and over a column
// grid dimension (n / BN blocks), each of which streams its rows of A once.
// The block body and the tile table live in common.cuh, shared with
// tsm2r_split.cu and the int8 kernels.
// Ragged m, k, n are masked on load and store (TMA's zero fill in the wgmma
// body). Accumulation is f32; in the simt body in two levels (each BK tile
// is summed apart, then added to the running sum), so the rounding error
// grows with sqrt(BK) + sqrt(k / BK), not sqrt(k). Both bodies are
// deterministic: one block per output tile, a fixed k order.

#include "common.cuh"
#include "tsm2r_wgmma.cuh"

namespace {

template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    tsm2r_kernel(const T* __restrict__ A, const T* __restrict__ B,
                 T* __restrict__ C, int m, int k, int n) {
  tsm2x::tsm2r_block<T, T, BM, BN, BK, TM, TN>(A, B, C, m, k, n, 0, k);
}

template <typename T>
int dispatch(const T* a, const T* b, T* c, int m, int k, int n,
             cudaStream_t stream) {
  return tsm2x::with_tsm2r_tile(n, [&](auto tile) {
    using Tl = decltype(tile);
    constexpr int NT = (Tl::BM / Tl::TM) * (Tl::BN / Tl::TN);
    dim3 grid((m + Tl::BM - 1) / Tl::BM, (n + Tl::BN - 1) / Tl::BN);
    tsm2r_kernel<T, Tl::BM, Tl::BN, Tl::BK, Tl::TM, Tl::TN>
        <<<grid, NT, 0, stream>>>(a, b, c, m, k, n);
    return (int)cudaGetLastError();
  });
}

}  // namespace

extern "C" int tsm2r_f32(const void* a, const void* b, void* c, int m, int k,
                         int n, void* stream) {
  return dispatch<float>((const float*)a, (const float*)b, (float*)c, m, k, n,
                         (cudaStream_t)stream);
}

extern "C" int tsm2r_bf16(const void* a, const void* b, void* c, int m, int k,
                          int n, void* stream) {
  if (tsm2x::wgmma::fits(k, n, true, a, b))
    return tsm2x::wgmma::launch((const __nv_bfloat16*)a,
                                (const __nv_bfloat16*)b, (__nv_bfloat16*)c, m,
                                k, n, (cudaStream_t)stream);
  return dispatch<__nv_bfloat16>((const __nv_bfloat16*)a,
                                 (const __nv_bfloat16*)b, (__nv_bfloat16*)c, m,
                                 k, n, (cudaStream_t)stream);
}

// The body and grid a tsm2r call of this shape, dtype (0 f32, 1 bf16) and
// these operand pointers launches: out = {body (0 simt, 1 wgmma), grid x,
// grid y, grid z}. core/perf_model.py::tsm2r_plan mirrors it.
extern "C" int tsm2r_plan(int m, int k, int n, int dtype_tag, const void* a,
                          const void* b, int* out) {
  if (tsm2x::wgmma::fits(k, n, dtype_tag == 1, a, b)) {
    const dim3 g = tsm2x::wgmma::grid(m, n);
    out[0] = 1, out[1] = g.x, out[2] = g.y, out[3] = g.z;
    return 0;
  }
  return tsm2x::with_tsm2r_tile(n, [&](auto tile) {
    using Tl = decltype(tile);
    out[0] = 0;
    out[1] = (m + Tl::BM - 1) / Tl::BM;
    out[2] = (n + Tl::BN - 1) / Tl::BN;
    out[3] = 1;
    return 0;
  });
}
