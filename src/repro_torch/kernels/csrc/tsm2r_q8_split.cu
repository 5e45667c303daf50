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
// Design: grid (m-tiles, n-tiles, S); block (i, j, s) runs one of TSM2R's
// int8 bodies over its slice's k range only, and multiplies its tile by
// sA[row / band] * sB once at the store (the JAX kernel folds per k step:
// the same value up to f32 rounding). tsm2r_q8_split_plan picks the body
// before the launch, as tsm2r_split_plan does for f32 and bf16:
// - "skinny" (tsm2r_skinny.cuh's int8 stage) at n <= 16 with k a multiple
//   of 16 and a 16-byte aligned A (int8 slices, whole 32-value blocks, are
//   then whole 16-byte chunks): TMA streams 128-row boxes of A (128 k
//   values) through a ring, each thread keeps all n outputs of its rows as
//   exact int32 sums of __dp4a, B is broadcast from shared memory as
//   packed words. A slice need not start on a box (800-deep slices start
//   mid-box): the body takes only the chunks inside it. A slice up to
//   131,072 deep never folds its int32 sums, so each partial is bit-equal
//   to the plain version's.
// - "simt" (common.cuh's tsm2r_block at the int8 load type: __dp4a on
//   words of four packed k values, exact int32 per BK tile, folded into
//   f32) for every other call.
// The last slice is masked at k. One writer per output element: no
// atomics, the same bits on every launch. Both bodies have one row of
// blocks per 128 rows at n <= 16 (tsm2r.cu's tile table), so the grid
// does not depend on the body.
//
// tsm2r_q8_split_sweep_f32 launches the skinny body's variants
// (skinny::SWEEP) at n = 4 and n = 16, for chip_smoke.py's sweep.

#include "common.cuh"
#include "tsm2r_skinny.cuh"

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

template <int NW, int R, int G>
__global__ void __launch_bounds__(
    tsm2x::skinny::threads(R, G, tsm2x::skinny::MAX_PRODUCERS))
    tsm2r_q8_split_skinny_kernel(const __grid_constant__ CUtensorMap map_a,
                                 const int8_t* __restrict__ B,
                                 float* __restrict__ P, int m, int k, int n,
                                 int slice, int stages, int producers,
                                 tsm2x::RowFold fold) {
  tsm2x::skinny::body<int8_t, float, NW, R, G>(&map_a, B, P, m, k, n, slice,
                                               stages, producers, fold);
}

// The skinny body at variant (R, G, stages, producers).
template <int NW, int R, int G>
int skinny_at(const int8_t* a, const int8_t* b, float* p, int m, int k, int n,
              int splits, int slice, int stages, int producers,
              const tsm2x::RowFold& fold, cudaStream_t stream) {
  return tsm2x::skinny::launch<int8_t, NW, R, G>(
      tsm2r_q8_split_skinny_kernel<NW, R, G>, a, b, p, m, k, n, splits, slice,
      stages, producers, stream, fold);
}

}  // namespace

extern "C" int tsm2r_q8_split_f32(const void* a, const void* b,
                                  const void* sa, const void* sb, void* p,
                                  int m, int k, int n, int band, int splits,
                                  int slice, void* stream) {
  namespace sk = tsm2x::skinny;
  const tsm2x::RowFold fold{(const float*)sa, (const float*)sb, band};
  if (sk::fits(k, n, 1, a, slice))
    return sk::with_width(n, [&](auto w) {
      return skinny_at<decltype(w)::value, sk::R_DEFAULT, sk::G_DEFAULT>(
          (const int8_t*)a, (const int8_t*)b, (float*)p, m, k, n, splits,
          slice, sk::STAGES_DEFAULT, sk::PRODUCERS_DEFAULT, fold,
          (cudaStream_t)stream);
    });
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

// The body and grid a tsm2r_q8_split call of this shape, slice length and
// A pointer launches: out = {body (0 simt, 2 skinny, tsm2r_q8_plan's
// codes), grid x, grid y, grid z}. core/perf_model.py::tsm2r_plan mirrors
// it at dtype int8 (its splits argument).
extern "C" int tsm2r_q8_split_plan(int m, int k, int n, int splits,
                                   int slice, const void* a, int* out) {
  if (tsm2x::skinny::fits(k, n, 1, a, slice)) {
    const dim3 g = tsm2x::skinny::grid(m, splits);
    out[0] = 2, out[1] = g.x, out[2] = g.y, out[3] = g.z;
    return 0;
  }
  out[0] = 0;
  return tsm2r_q8_split_grid(m, k, n, splits, out + 1);
}

// tsm2r_q8_split_f32 on the skinny body at sweep variant i (the tsm2r_split
// library's tsm2r_split_sweep_variant lists them), n = 4 or 16.
extern "C" int tsm2r_q8_split_sweep_f32(int i, const void* a, const void* b,
                                        const void* sa, const void* sb,
                                        void* p, int m, int k, int n,
                                        int band, int splits, int slice,
                                        void* stream) {
  namespace sk = tsm2x::skinny;
  const tsm2x::RowFold fold{(const float*)sa, (const float*)sb, band};
  return sk::with_variant(i, [&](auto r, auto g) {
    constexpr int R = decltype(r)::value, G = decltype(g)::value;
    const int8_t *qa = (const int8_t*)a, *qb = (const int8_t*)b;
    const int stages = sk::SWEEP[i][2], producers = sk::SWEEP[i][3];
    const cudaStream_t st = (cudaStream_t)stream;
    if (n == 16)
      return skinny_at<16, R, G>(qa, qb, (float*)p, m, k, n, splits, slice,
                                 stages, producers, fold, st);
    if (n == 4)
      return skinny_at<4, R, G>(qa, qb, (float*)p, m, k, n, splits, slice,
                                stages, producers, fold, st);
    return (int)cudaErrorInvalidValue;
  });
}
