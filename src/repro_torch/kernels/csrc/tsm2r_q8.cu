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
// byte, below the tensor cores' int8 ridge, so bytes bound it there.
//
// Three bodies; tsm2r_q8_plan picks one from the shape and the operands'
// alignment before the launch (never after a failure):
// - "wgmma" (tsm2r_q8_wgmma.cuh): n > 16, k a multiple of 16 (k > 0) and
//   16-byte aligned bases. TMA copies swizzled 128-byte rows of A and of a
//   K-major B ([n, k] rows) into a 4-stage ring; one warpgroup multiplies
//   them on the tensor cores (wgmma.m64n128k32.s32.s8.s8), folding the
//   exact s32 sums into f32 every 131,072 k.
// - "skinny" (tsm2r_skinny.cuh's int8 stage): n <= 16, k a multiple of 16
//   and a 16-byte aligned A, such as PowerSGD's P at n = 4, with a
//   row-major B. TMA streams 128-row x 128-byte boxes of A (128 k values)
//   through a 3-stage ring fed by two producer warps, which also store
//   each stage's B as packed words (four k values of a column a word);
//   each consumer thread keeps all n outputs of its rows as exact int32
//   sums, one __dp4a (four products) per word of A and column. Up to
//   131,072 k the sums never fold, and the epilogue converts each exact
//   sum once: bit-equal to the plain version.
// - "simt" (common.cuh's tsm2r_block at the int8 load type): every other
//   call with a row-major B (k % 16 != 0, a misaligned A, or n > 16 where
//   the wgmma body does not fit). The raw int8 tile is prefetched into
//   registers while the current one is multiplied; staging packs four
//   consecutive k values of A (a row) and of B (a column) into one 32-bit
//   word of shared memory, so each __dp4a does four exact products. A BK
//   = 32 tile's sum is an exact int32 (at most 127^2 * 32), folded into
//   the f32 sum once a tile, so no depth overflows.
// Every body multiplies by sA[row / band] * sB at the store (RowFold).
//
// The launcher is told B's layout, which the wrapper makes match the
// plan: a K-major B runs the wgmma body (refused where it does not fit), a
// row-major B the skinny body where it fits, else the simt body.
//
// tsm2r_q8_transpose copies an int8 [rows, cols] matrix to [cols, rows]:
// the wrapper's change of B's layout where the caller's B does not match
// the plan (a row-major B on the wgmma body).

#include "common.cuh"
#include "tsm2r_q8_wgmma.cuh"
#include "tsm2r_skinny.cuh"

namespace {

template <typename U, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    tsm2r_q8_kernel(const int8_t* __restrict__ A,
                    const int8_t* __restrict__ B, U* __restrict__ C, int m,
                    int k, int n, tsm2x::RowFold fold) {
  tsm2x::tsm2r_block<int8_t, U, BM, BN, BK, TM, TN>(A, B, C, m, k, n, 0, k,
                                                    fold);
}

template <typename U, int NW, int R, int G>
__global__ void __launch_bounds__(
    tsm2x::skinny::threads(R, G, tsm2x::skinny::MAX_PRODUCERS))
    tsm2r_q8_skinny_kernel(const __grid_constant__ CUtensorMap map_a,
                           const int8_t* __restrict__ B, U* __restrict__ C,
                           int m, int k, int n, int slice, int stages,
                           int producers, tsm2x::RowFold fold) {
  tsm2x::skinny::body<int8_t, U, NW, R, G>(&map_a, B, C, m, k, n, slice,
                                           stages, producers, fold);
}

// The skinny body at its default variant over the whole of k.
template <typename U>
int skinny(const int8_t* a, const int8_t* b, U* c, int m, int k, int n,
           const tsm2x::RowFold& fold, cudaStream_t stream) {
  namespace sk = tsm2x::skinny;
  return sk::with_width(n, [&](auto w) {
    constexpr int NW = decltype(w)::value, R = sk::R_DEFAULT,
                  G = sk::G_DEFAULT;
    return sk::launch<int8_t, NW, R, G>(tsm2r_q8_skinny_kernel<U, NW, R, G>,
                                        a, b, c, m, k, n, 1, k,
                                        sk::STAGES_DEFAULT,
                                        sk::PRODUCERS_DEFAULT, stream, fold);
  });
}

template <typename U>
int run(const void* a, const void* b, const void* sa, const void* sb, void* c,
        int m, int k, int n, int band, int b_kmajor, void* stream) {
  if (b_kmajor) {
    if (!tsm2x::wgmma_s8::fits(k, n, a, b)) return (int)cudaErrorInvalidValue;
    return tsm2x::wgmma_s8::launch<U>((const int8_t*)a, (const int8_t*)b,
                                      (const float*)sa, (const float*)sb,
                                      (U*)c, m, k, n, band,
                                      (cudaStream_t)stream);
  }
  const tsm2x::RowFold fold{(const float*)sa, (const float*)sb, band};
  if (tsm2x::skinny::fits(k, n, 1, a, k))
    return skinny<U>((const int8_t*)a, (const int8_t*)b, (U*)c, m, k, n, fold,
                     (cudaStream_t)stream);
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

constexpr int T_TILE = 64;

// dst[c][r] = src[r][c] over one 64 x 64 tile: loads along c and stores
// along r both coalesced, through shared memory.
__global__ void __launch_bounds__(256)
    tsm2r_q8_transpose_kernel(const int8_t* __restrict__ src,
                              int8_t* __restrict__ dst, int rows, int cols) {
  __shared__ int8_t tile[T_TILE][T_TILE + 4];
  const long r0 = (long)blockIdx.y * T_TILE, c0 = (long)blockIdx.x * T_TILE;
  const int tx = threadIdx.x % T_TILE, ty = threadIdx.x / T_TILE;
  for (int i = ty; i < T_TILE; i += 256 / T_TILE) {
    const long r = r0 + i, c = c0 + tx;
    if (r < rows && c < cols) tile[tx][i] = src[r * cols + c];
  }
  __syncthreads();
  for (int i = ty; i < T_TILE; i += 256 / T_TILE) {
    const long c = c0 + i, r = r0 + tx;
    if (r < rows && c < cols) dst[c * rows + r] = tile[i][tx];
  }
}

}  // namespace

extern "C" int tsm2r_q8_f32(const void* a, const void* b, const void* sa,
                            const void* sb, void* c, int m, int k, int n,
                            int band, int b_kmajor, void* stream) {
  return run<float>(a, b, sa, sb, c, m, k, n, band, b_kmajor, stream);
}

extern "C" int tsm2r_q8_bf16(const void* a, const void* b, const void* sa,
                             const void* sb, void* c, int m, int k, int n,
                             int band, int b_kmajor, void* stream) {
  return run<__nv_bfloat16>(a, b, sa, sb, c, m, k, n, band, b_kmajor,
                            stream);
}

// The body and grid a tsm2r_q8 call of this shape launches, with A at `a`
// and B at `b` (the K-major B's address, which the wgmma body reads): out =
// {body (0 simt, 1 wgmma, 2 skinny), grid x, grid y, grid z}.
// core/perf_model.py::tsm2r_plan mirrors it at dtype int8.
extern "C" int tsm2r_q8_plan(int m, int k, int n, const void* a,
                             const void* b, int* out) {
  if (tsm2x::wgmma_s8::fits(k, n, a, b)) {
    const dim3 g = tsm2x::wgmma_s8::grid(m, n);
    out[0] = 1, out[1] = g.x, out[2] = g.y, out[3] = g.z;
    return 0;
  }
  if (tsm2x::skinny::fits(k, n, 1, a, k)) {
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

extern "C" int tsm2r_q8_transpose(const void* src, void* dst, int rows,
                                  int cols, void* stream) {
  const dim3 grid((cols + T_TILE - 1) / T_TILE, (rows + T_TILE - 1) / T_TILE);
  tsm2r_q8_transpose_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const int8_t*)src, (int8_t*)dst, rows, cols);
  return (int)cudaGetLastError();
}
