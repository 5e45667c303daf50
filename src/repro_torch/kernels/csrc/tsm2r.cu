// TSM2R on Hopper: C[m,n] = A[m,k] @ B[k,n] with m ~ k >> n.
//
// Replaces src/repro/kernels/tsm2r.py::tsm2r_pallas (body _tsm2r_kernel).
//
// Three bodies; tsm2r_plan picks one from the shape, the dtype and the
// operands' alignment before the launch (never after a failure):
// - "wgmma" (tsm2r_wgmma.cuh): bf16 with n > 16, k and n multiples of 8
//   and 16-byte aligned bases. TMA copies 64 x 64 swizzled boxes of A and
//   B into a 4-stage shared-memory ring guarded by full/empty mbarriers;
//   one warpgroup multiplies them on the tensor cores
//   (wgmma.m64n128k16.f32.bf16.bf16, B read MN-major through the transpose
//   bit) into f32 registers. Bound on the H100 by the bytes of A plus B's
//   re-reads from L2, one per 64-row tile (at n = 256 the work is 512 FLOP
//   per element of A, below the card's ridge of ~295 FLOP a byte).
// - "skinny" (tsm2r_skinny.cuh): f32 or bf16 with n <= 16 (PowerSGD's P at
//   n = 4, the paper's n = 16), k * size a multiple of 16 bytes and a
//   16-byte aligned A. The paper's design: TMA streams 128-row boxes of A
//   through a ring of stages fed by producer warps, each thread keeps all
//   n outputs (rounded up to 1, 2, 4, 8 or 16) of its rows in registers,
//   B is broadcast from shared memory, and groups of threads split each
//   stage's k and sum their tiles in group order at the end (the header
//   sets the defaults: 3 stages, 2 producer warps, 2 rows a thread, 2
//   groups). Bound by the bytes of A.
// - "simt" (common.cuh's tsm2r_block): every other call: f32 at n > 16,
//   and strides or bases TMA cannot take (a ragged k such as 777, a
//   misaligned view). Paper Algorithm 4 spread over the threads: one
//   block owns a BM x BN output tile (128 x 16 at n <= 16, else 64 x 64)
//   and loops over k inside the block, where the TPU ran a sequential
//   grid axis; the next (BM x BK) A tile and (BK x BN) B tile are loaded
//   into registers while the current tile is multiplied out of shared
//   memory by 2 x 4 or 4 x 4 register micro-tiles. Its FMAs run on the
//   CUDA cores in f32: bound by the FMA rate (67 TFLOP/s) at wide n,
//   which is why bf16's wide outputs go to the tensor cores.
// The simt block body and tile table live in common.cuh, shared with
// tsm2r_split.cu and the int8 kernels; tsm2r_split.cu shares the skinny
// body too.
// Ragged m, k, n are masked on load and store (TMA's zero fill where TMA
// loads). Accumulation is f32, in two levels in the simt and skinny
// bodies (each k tile is summed apart, then added to the running sum), so
// the rounding error grows with sqrt(BK) + sqrt(k / BK), not sqrt(k). All
// bodies are deterministic: one block per output tile, a fixed k order.

#include "common.cuh"
#include "tsm2r_skinny.cuh"
#include "tsm2r_wgmma.cuh"

namespace {

template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    tsm2r_kernel(const T* __restrict__ A, const T* __restrict__ B,
                 T* __restrict__ C, int m, int k, int n) {
  tsm2x::tsm2r_block<T, T, BM, BN, BK, TM, TN>(A, B, C, m, k, n, 0, k);
}

template <typename T, int NW, int R, int G>
__global__ void __launch_bounds__(
    tsm2x::skinny::threads(R, G, tsm2x::skinny::MAX_PRODUCERS))
    tsm2r_skinny_kernel(const __grid_constant__ CUtensorMap map_a,
                        const T* __restrict__ B, T* __restrict__ C, int m,
                        int k, int n, int slice, int stages,
                        int producers) {
  tsm2x::skinny::body<T, T, NW, R, G>(&map_a, B, C, m, k, n, slice, stages,
                                      producers);
}

template <typename T>
int skinny(const T* a, const T* b, T* c, int m, int k, int n,
           cudaStream_t stream) {
  namespace sk = tsm2x::skinny;
  return sk::with_width(n, [&](auto w) {
    constexpr int NW = decltype(w)::value, R = sk::R_DEFAULT,
                  G = sk::G_DEFAULT;
    return sk::launch<T, NW, R, G>(tsm2r_skinny_kernel<T, NW, R, G>, a, b, c,
                                   m, k, n, 1, k, sk::STAGES_DEFAULT,
                                   sk::PRODUCERS_DEFAULT, stream);
  });
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
  if (tsm2x::skinny::fits(k, n, 4, a, k))
    return skinny<float>((const float*)a, (const float*)b, (float*)c, m, k, n,
                         (cudaStream_t)stream);
  return dispatch<float>((const float*)a, (const float*)b, (float*)c, m, k, n,
                         (cudaStream_t)stream);
}

extern "C" int tsm2r_bf16(const void* a, const void* b, void* c, int m, int k,
                          int n, void* stream) {
  if (tsm2x::wgmma::fits(k, n, true, a, b))
    return tsm2x::wgmma::launch((const __nv_bfloat16*)a,
                                (const __nv_bfloat16*)b, (__nv_bfloat16*)c, m,
                                k, n, (cudaStream_t)stream);
  if (tsm2x::skinny::fits(k, n, 2, a, k))
    return skinny<__nv_bfloat16>((const __nv_bfloat16*)a,
                                 (const __nv_bfloat16*)b, (__nv_bfloat16*)c,
                                 m, k, n, (cudaStream_t)stream);
  return dispatch<__nv_bfloat16>((const __nv_bfloat16*)a,
                                 (const __nv_bfloat16*)b, (__nv_bfloat16*)c, m,
                                 k, n, (cudaStream_t)stream);
}

// The body and grid a tsm2r call of this shape, dtype (0 f32, 1 bf16) and
// these operand pointers launches: out = {body (0 simt, 1 wgmma, 2 skinny),
// grid x, grid y, grid z}. core/perf_model.py::tsm2r_plan mirrors it.
extern "C" int tsm2r_plan(int m, int k, int n, int dtype_tag, const void* a,
                          const void* b, int* out) {
  if (tsm2x::wgmma::fits(k, n, dtype_tag == 1, a, b)) {
    const dim3 g = tsm2x::wgmma::grid(m, n);
    out[0] = 1, out[1] = g.x, out[2] = g.y, out[3] = g.z;
    return 0;
  }
  if (tsm2x::skinny::fits(k, n, dtype_tag == 1 ? 2 : 4, a, k)) {
    const dim3 g = tsm2x::skinny::grid(m, 1);
    out[0] = 2, out[1] = g.x, out[2] = g.y, out[3] = g.z;
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
