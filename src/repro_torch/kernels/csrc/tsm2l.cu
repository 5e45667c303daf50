// TSM2L on Hopper: C[m,n] = A[m,k] @ B[k,n] with m >> k ~ n (both small).
//
// Replaces src/repro/kernels/tsm2l.py::tsm2l_pallas (body _tsm2l_kernel).
//
// Bound on the H100: ~2n FLOP per A element with k, n <= 256, so the bytes
// of A and C bound it; at the smallest shapes (k = n = 4) the launch and the
// latency of each row tile dominate (the paper's latency-bound case).
//
// Two bodies; tsm2l_plan picks one from the shape and A's alignment before
// the launch (never after a failure):
// - "stream" (tsm2l_stream.cuh): n in 1..16, k in 1..256 (every k the
//   classifier routes here) and a 16-byte aligned A: the paper's shape.
//   Persistent blocks, two an SM; one producer thread streams row tiles of
//   A into a ring of shared-memory stages with 1-D cp.async.bulk copies;
//   each consumer thread keeps all n outputs of its rows (the paper's tcf:
//   4 rows of at most 32 bytes a thread, 2 of at most 256, else 1) and
//   reads B broadcast from shared memory;
//   the tile's C goes back through shared memory with bulk stores.
// - "tile" (common.cuh's tsm2l_kernel, tsm2l_dispatch): every other call
//   (n > 16, k > 256, a misaligned A). Blocks stride over row tiles so the
//   B tile staged into shared memory stays there for the block's lifetime;
//   B is tiled over n, and over k past a chunk, to fit a block's shared
//   memory; three tile shapes picked by n answer the paper's tcf trade.
// Ragged m, k, n are handled by both. Accumulation is f32, in a fixed
// order: a launch repeats its bits.

#include "common.cuh"
#include "tsm2l_stream.cuh"

namespace {

template <typename T>
int run(const T* a, const T* b, T* c, int m, int k, int n,
        cudaStream_t stream) {
  if (tsm2x::stream::fits(k, n, a))
    return tsm2x::stream::launch(a, b, c, m, k, n, tsm2x::NoFold(), stream);
  return tsm2x::tsm2l_dispatch(a, b, c, m, k, n, tsm2x::NoFold(), stream);
}

}  // namespace

extern "C" int tsm2l_f32(const void* a, const void* b, void* c, int m, int k,
                         int n, void* stream) {
  return run((const float*)a, (const float*)b, (float*)c, m, k, n,
             (cudaStream_t)stream);
}

extern "C" int tsm2l_bf16(const void* a, const void* b, void* c, int m, int k,
                          int n, void* stream) {
  return run((const __nv_bfloat16*)a, (const __nv_bfloat16*)b,
             (__nv_bfloat16*)c, m, k, n, (cudaStream_t)stream);
}

// The body, grid and geometry a tsm2l call of this shape, dtype (0 f32, 1
// bf16) and A pointer launches on the current card: out = {body (0 tile, 1
// stream), grid x, grid y, grid z, rows a thread, groups, rows a tile,
// stages}; the tile body's grid is its table's row and column tiles (its
// launch runs at most the resident blocks over the rows) and its geometry
// {0, 0, BM, 0}. core/perf_model.py::tsm2l_plan mirrors it.
extern "C" int tsm2l_plan(int m, int k, int n, int dtype_tag, const void* a,
                          int* out) {
  return tsm2x::tsm2l_plan_query(m, k, n, dtype_tag == 1 ? 2 : 4,
                                 dtype_tag == 1 ? 2 : 4, a, out);
}

// The tile body alone, whatever the shape (chip_smoke.py's tsm2l_sweep
// times it beside the stream body).
extern "C" int tsm2l_tile_f32(const void* a, const void* b, void* c, int m,
                              int k, int n, void* stream) {
  return tsm2x::tsm2l_dispatch((const float*)a, (const float*)b, (float*)c, m,
                               k, n, tsm2x::NoFold(), (cudaStream_t)stream);
}

// The stream body's sweep (chip_smoke.py's tsm2l_sweep line): the rows a
// thread of variant i (the paper's tcf), and a launch at any rows a thread
// (1, 2, 4 or 8) with the launcher's arguments after it; n = 16 and
// 16-byte rows only.
extern "C" int tsm2l_sweep_variant(int i, int* out) {
  if (i < 0 || i >= tsm2x::stream::SWEEP_N) return 1;
  out[0] = tsm2x::stream::SWEEP_ROWS[i];
  return 0;
}

namespace {

template <typename T>
int variant(int rows, const void* a, const void* b, void* c, int m, int k,
            int n, void* stream) {
  namespace st = tsm2x::stream;
  if (!st::fits(k, n, a) || k * (int)sizeof(T) % 16 != 0 || n != 16 ||
      reinterpret_cast<uintptr_t>(c) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const st::Plan p = st::plan(k, n, sizeof(T), sizeof(T), rows);
  auto go = [&](auto r) {
    return st::launch_at<T, T, 16, decltype(r)::value, true>(
        (const T*)a, (const T*)b, (T*)c, m, k, n, tsm2x::NoFold(), p,
        (cudaStream_t)stream);
  };
  switch (rows) {
    case 1: return go(std::integral_constant<int, 1>{});
    case 2: return go(std::integral_constant<int, 2>{});
    case 4: return go(std::integral_constant<int, 4>{});
    case 8: return go(std::integral_constant<int, 8>{});
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int tsm2l_variant_f32(int rows, const void* a, const void* b,
                                 void* c, int m, int k, int n, void* stream) {
  return variant<float>(rows, a, b, c, m, k, n, stream);
}

extern "C" int tsm2l_variant_bf16(int rows, const void* a, const void* b,
                                  void* c, int m, int k, int n, void* stream) {
  return variant<__nv_bfloat16>(rows, a, b, c, m, k, n, stream);
}
