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
// Design: grid (m-tiles, n-tiles, S). Block (i, j, s) runs one of TSM2R's
// bodies over its slice's k range [s * slice, (s + 1) * slice) only, and
// stores its f32 tile to partials[s]. tsm2r_split_plan picks the body
// before the launch, as tsm2r_plan does for the sequential kernel:
// - "skinny" (tsm2r_skinny.cuh) for f32 or bf16 at n <= 16 with A's rows
//   and the slice whole 16-byte chunks and A 16-byte aligned: TMA streams
//   128-row boxes of A through a ring, each thread keeps all n outputs of
//   its rows, B is broadcast from shared memory. A slice need not start
//   on a box (bf16 boxes hold 64 k values, slices are multiples of 32):
//   the body takes only the chunks inside the slice.
// - "simt" (common.cuh's tsm2r_block: register prefetch of the next
//   tile, shared-memory staging, two-level f32 sum) for every other call.
// The slice length is a whole number of 32-deep k tiles; the last slice
// is masked at k, which equals zero padding of k to S whole slices (the
// TPU kernel's padded layout) without copying A. No block shares an
// output element with another, so there are no atomics and every launch
// gives the same bits. Both bodies have one row of blocks per 128 rows at
// n <= 16 (the tile table of tsm2r.cu), so the grid does not depend on
// the body.
//
// tsm2r_split_sweep_f32 launches the skinny body's variants (rows a
// thread, k-splitting groups, stages, producer warps;
// tsm2r_split_sweep_variant lists them) at n = 4 and n = 16, for
// chip_smoke.py's sweep.

#include "common.cuh"
#include "tsm2r_skinny.cuh"

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

template <typename T, int NW, int R, int G>
__global__ void __launch_bounds__(
    tsm2x::skinny::threads(R, G, tsm2x::skinny::MAX_PRODUCERS))
    tsm2r_split_skinny_kernel(const __grid_constant__ CUtensorMap map_a,
                              const T* __restrict__ B, float* __restrict__ P,
                              int m, int k, int n, int slice, int stages,
                              int producers) {
  tsm2x::skinny::body<T, float, NW, R, G>(&map_a, B, P, m, k, n, slice,
                                          stages, producers);
}

template <typename T, int NW, int R, int G>
int skinny_at(const T* a, const T* b, float* p, int m, int k, int n,
              int splits, int slice, int stages, int producers,
              cudaStream_t stream) {
  return tsm2x::skinny::launch<T, NW, R, G>(
      tsm2r_split_skinny_kernel<T, NW, R, G>, a, b, p, m, k, n, splits, slice,
      stages, producers, stream);
}

template <typename T>
int skinny(const T* a, const T* b, float* p, int m, int k, int n, int splits,
           int slice, cudaStream_t stream) {
  namespace sk = tsm2x::skinny;
  return sk::with_width(n, [&](auto w) {
    constexpr int NW = decltype(w)::value;
    return skinny_at<T, NW, sk::R_DEFAULT, sk::G_DEFAULT>(
        a, b, p, m, k, n, splits, slice, sk::STAGES_DEFAULT,
        sk::PRODUCERS_DEFAULT, stream);
  });
}

template <typename T>
int run(const T* a, const T* b, float* p, int m, int k, int n, int splits,
        int slice, cudaStream_t stream) {
  if (tsm2x::skinny::fits(k, n, sizeof(T), a, slice))
    return skinny<T>(a, b, p, m, k, n, splits, slice, stream);
  return dispatch<T>(a, b, p, m, k, n, splits, slice, stream);
}

template <int R, int G>
int sweep_at(const float* a, const float* b, float* p, int m, int k, int n,
             int splits, int slice, int stages, int producers,
             cudaStream_t stream) {
  if (n == 16)
    return skinny_at<float, 16, R, G>(a, b, p, m, k, n, splits, slice, stages,
                                      producers, stream);
  if (n == 4)
    return skinny_at<float, 4, R, G>(a, b, p, m, k, n, splits, slice, stages,
                                     producers, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int tsm2r_split_f32(const void* a, const void* b, void* p, int m,
                               int k, int n, int splits, int slice,
                               void* stream) {
  return run<float>((const float*)a, (const float*)b, (float*)p, m, k, n,
                    splits, slice, (cudaStream_t)stream);
}

extern "C" int tsm2r_split_bf16(const void* a, const void* b, void* p, int m,
                                int k, int n, int splits, int slice,
                                void* stream) {
  return run<__nv_bfloat16>((const __nv_bfloat16*)a, (const __nv_bfloat16*)b,
                            (float*)p, m, k, n, splits, slice,
                            (cudaStream_t)stream);
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

// The body and grid a tsm2r_split call of this shape, dtype (0 f32, 1
// bf16), slice length and A pointer launches: out = {body (0 simt, 2
// skinny, tsm2r_plan's codes), grid x, grid y, grid z}.
// core/perf_model.py::tsm2r_plan mirrors it (its splits argument).
extern "C" int tsm2r_split_plan(int m, int k, int n, int splits, int slice,
                                int dtype_tag, const void* a, int* out) {
  if (tsm2x::skinny::fits(k, n, dtype_tag == 1 ? 2 : 4, a, slice)) {
    const dim3 g = tsm2x::skinny::grid(m, splits);
    out[0] = 2, out[1] = g.x, out[2] = g.y, out[3] = g.z;
    return 0;
  }
  out[0] = 0;
  return tsm2r_split_grid(m, k, n, splits, out + 1);
}

// Sweep variant i of the skinny body (skinny::SWEEP): out = {rows a
// thread, groups, stages, producer warps}; cudaErrorInvalidValue past the
// last.
extern "C" int tsm2r_split_sweep_variant(int i, int* out) {
  namespace sk = tsm2x::skinny;
  if (i < 0 || i >= sk::SWEEP_N) return (int)cudaErrorInvalidValue;
  for (int q = 0; q < 4; ++q) out[q] = sk::SWEEP[i][q];
  return 0;
}

// tsm2r_split_f32 on the skinny body at sweep variant i, n = 4 or 16.
extern "C" int tsm2r_split_sweep_f32(int i, const void* a, const void* b,
                                     void* p, int m, int k, int n, int splits,
                                     int slice, void* stream) {
  namespace sk = tsm2x::skinny;
  return sk::with_variant(i, [&](auto r, auto g) {
    return sweep_at<decltype(r)::value, decltype(g)::value>(
        (const float*)a, (const float*)b, (float*)p, m, k, n, splits, slice,
        sk::SWEEP[i][2], sk::SWEEP[i][3], (cudaStream_t)stream);
  });
}
