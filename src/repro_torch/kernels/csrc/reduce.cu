// Sum of split partials on Hopper: C[r, c] = sum_s P[s, r, c] in f32, cast
// once to the output dtype (f32 or bf16).
//
// Replaces src/repro/kernels/reduce.py::sum_partials_pallas (body
// _sum_lead_kernel).
//
// Bound on the H100: bytes. The kernel reads the S * rows * cols * 4 bytes
// of partials once and writes the rows * cols outputs once (4 or 2 bytes
// each); one f32 add per element read is far below the f32 rate. The
// split kernels' stacks are a few MB (the split TSM2R's (2, 16384, 16) is
// 3 MB, 0.94 us at 3.35 TB/s), so memory latency and the launch weigh as
// much as the bytes.
//
// Design (sum_partials_kernel):
// - Vectors on the flat index. The sum is elementwise over e = r * cols +
//   c, so a thread owns VEC consecutive outputs whatever cols is: VEC is
//   the widest of 4, 2 and 1 that divides rows * cols (so every slab
//   starts on a vector) and to whose vectors P and C are aligned. A
//   16-byte vector of each slab at VEC = 4; cols = 2, 3 or 5 vectorize as
//   well as 16 when the rows allow.
// - A grid sized to the card: one vector a thread, THREADS threads a
//   block, at most BLOCKS_PER_SM blocks an SM and a grid-stride loop past
//   that. (16, 256, 256) runs 128 blocks, (2, 16384, 16) 512, where the
//   rows body below gave every block 4,096 outputs: 16 and 64 blocks for
//   132 SMs.
// - Every slice's load in flight: slices go in chunks of CHUNK; all of a
//   chunk's loads are issued before its adds (unrolled, predicated past
//   S), so a thread waits on one memory latency a chunk, not one a slice.
// - Adds run s = 0, 1, ..., S-1 from +0.0f, so a launch gives the bits of
//   the slice-order sum on every grid: no atomics, no tree whose shape
//   depends on the launch.
// - One store a vector: 16 bytes of f32, or four bf16 rounded to nearest
//   even (tsm2x::from_f32) in one 8-byte store.
// - STREAMING: the partials are dead after this kernel, so they may be
//   loaded with the evict-first hint (__ldcs); the sweep times both.
//
// by_rows::sum_partials_kernel is the first body of this file (block_r
// rows of all cols a block, 256 threads, each thread its outputs one after
// another and, at cols % 4 == 0, float4 loads with four scalar stores). It
// stays for comparison only (reduce_rows_<tag>, which chip_smoke.py's
// reduce_sweep times beside the plan's body); the plan never picks it.

#include <utility>

#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int BLOCKS_PER_SM = 8;
constexpr int CHUNK = 8;
constexpr bool STREAMING = true;

template <int VEC>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
};
template <>
struct Vec<2> {
  using T = float2;
};
template <>
struct Vec<1> {
  using T = float;
};

template <int VEC, bool CS>
__device__ __forceinline__ void load(const float* p, float (&x)[VEC]) {
  using V = typename Vec<VEC>::T;
  const V* q = reinterpret_cast<const V*>(p);
  V v;
  if constexpr (CS)
    v = __ldcs(q);
  else
    v = *q;
  if constexpr (VEC == 4) {
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else if constexpr (VEC == 2) {
    x[0] = v.x, x[1] = v.y;
  } else {
    x[0] = v;
  }
}

template <typename U, int VEC>
__device__ __forceinline__ void store(U* c, const float (&a)[VEC]) {
  if constexpr (std::is_same_v<U, float>) {
    if constexpr (VEC == 4)
      *reinterpret_cast<float4*>(c) = make_float4(a[0], a[1], a[2], a[3]);
    else if constexpr (VEC == 2)
      *reinterpret_cast<float2*>(c) = make_float2(a[0], a[1]);
    else
      *c = a[0];
  } else if constexpr (VEC == 1) {
    *c = tsm2x::from_f32<U>(a[0]);
  } else {
    // Two bf16 a 32-bit word, the lower address in the low half.
    uint32_t w[VEC / 2];
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i)
      w[i] = (uint32_t)__bfloat16_as_ushort(tsm2x::from_f32<U>(a[2 * i])) |
             (uint32_t)__bfloat16_as_ushort(tsm2x::from_f32<U>(a[2 * i + 1]))
                 << 16;
    if constexpr (VEC == 4)
      *reinterpret_cast<uint2*>(c) = make_uint2(w[0], w[1]);
    else
      *reinterpret_cast<uint32_t*>(c) = w[0];
  }
}

template <typename U, int VEC, int NT, int CH, bool CS>
__global__ void __launch_bounds__(NT)
    sum_partials_kernel(const float* __restrict__ P, U* __restrict__ C,
                        int splits, long n_elems) {
  const long n_vec = n_elems / VEC;
  const long stride = (long)gridDim.x * NT;
  for (long v = (long)blockIdx.x * NT + threadIdx.x; v < n_vec; v += stride) {
    TSM2X_BLOCK_RECORD(C, tsm2x::block_map::REDUCE, v * VEC,
                       (v + NT < n_vec ? v + NT : n_vec) * VEC, 0, 1, 0,
                       splits, 4, 0, 0, 0, v / NT);
    const float* p = P + v * VEC;
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    for (int s0 = 0; s0 < splits; s0 += CH) {
      float x[CH][VEC];
#pragma unroll
      for (int j = 0; j < CH; ++j)
        if (s0 + j < splits)
          load<VEC, CS>(p + (long)(s0 + j) * n_elems, x[j]);
#pragma unroll
      for (int j = 0; j < CH; ++j)
        if (s0 + j < splits) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[i] += x[j][i];
        }
    }
    store<U, VEC>(C + v * VEC, acc);
  }
}

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)err;
}

// The widest vector (4, 2 or 1 outputs) that divides the n outputs and to
// which P (f32) and C (usize bytes an element) are aligned.
int vec_width(long n, const void* p, const void* c, int usize) {
  for (int w = 4; w > 1; w /= 2)
    if (n % w == 0 && reinterpret_cast<uintptr_t>(p) % (4 * w) == 0 &&
        reinterpret_cast<uintptr_t>(c) % (usize * w) == 0)
      return w;
  return 1;
}

int blocks_for(long n, int vec, int threads, int blocks_per_sm, int sms) {
  const long want = (n / vec + threads - 1) / threads;
  const long cap = (long)blocks_per_sm * sms;
  return (int)(want < 1 ? 1 : want < cap ? want : cap);
}

template <typename U, int NT, int CH, bool CS>
int run_body(const float* p, U* c, int splits, int rows, int cols,
             int blocks_per_sm, cudaStream_t stream) {
  int sms = 0;
  const int err = sm_count(&sms);
  if (err != 0) return err;
  const long n = (long)rows * cols;
  const int vec = vec_width(n, p, c, (int)sizeof(U));
  const dim3 grid((unsigned)blocks_for(n, vec, NT, blocks_per_sm, sms));
  if (vec == 4)
    sum_partials_kernel<U, 4, NT, CH, CS>
        <<<grid, NT, 0, stream>>>(p, c, splits, n);
  else if (vec == 2)
    sum_partials_kernel<U, 2, NT, CH, CS>
        <<<grid, NT, 0, stream>>>(p, c, splits, n);
  else
    sum_partials_kernel<U, 1, NT, CH, CS>
        <<<grid, NT, 0, stream>>>(p, c, splits, n);
  return (int)cudaGetLastError();
}

// The sweep's variants: threads a block, blocks an SM, slices a chunk and
// the cache hint; the first is the plan's.
struct Variant {
  int threads, blocks_per_sm, chunk;
  bool streaming;
};
constexpr Variant SWEEP[] = {
    {THREADS, BLOCKS_PER_SM, CHUNK, STREAMING},
    {THREADS, BLOCKS_PER_SM, 4, STREAMING},
    {THREADS, BLOCKS_PER_SM, CHUNK, !STREAMING},
    {2 * THREADS, BLOCKS_PER_SM / 2, CHUNK, STREAMING},
    {THREADS, BLOCKS_PER_SM / 2, CHUNK, STREAMING},
    {THREADS, 2 * BLOCKS_PER_SM, CHUNK, STREAMING},
};
constexpr int SWEEP_N = sizeof(SWEEP) / sizeof(SWEEP[0]);

template <int I>
int run_variant(const float* p, float* c, int splits, int rows, int cols,
                cudaStream_t stream) {
  constexpr Variant v = SWEEP[I];
  return run_body<float, v.threads, v.chunk, v.streaming>(
      p, c, splits, rows, cols, v.blocks_per_sm, stream);
}

template <int... I>
int sweep_dispatch(int i, const float* p, float* c, int splits, int rows,
                   int cols, cudaStream_t stream,
                   std::integer_sequence<int, I...>) {
  int err = (int)cudaErrorInvalidValue;
  ((i == I ? (err = run_variant<I>(p, c, splits, rows, cols, stream), 0)
           : 0),
   ...);
  return err;
}

namespace by_rows {

constexpr int THREADS = 256;
constexpr int BLOCK_ELEMS = 4096;   // outputs a block: block_r rows of cols

template <typename U, int VEC>
__global__ void __launch_bounds__(THREADS)
    sum_partials_kernel(const float* __restrict__ P, U* __restrict__ C,
                        int splits, long n_elems, long block_elems) {
  const long lo = (long)blockIdx.x * block_elems;
  const long hi = lo + block_elems < n_elems ? lo + block_elems : n_elems;
  for (long e = lo + (long)threadIdx.x * VEC; e < hi;
       e += (long)THREADS * VEC) {
    if (VEC == 4) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int s = 0; s < splits; ++s) {
        const float4 v = *reinterpret_cast<const float4*>(P + s * n_elems + e);
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
      C[e] = tsm2x::from_f32<U>(acc.x);
      C[e + 1] = tsm2x::from_f32<U>(acc.y);
      C[e + 2] = tsm2x::from_f32<U>(acc.z);
      C[e + 3] = tsm2x::from_f32<U>(acc.w);
    } else {
      float acc = 0.f;
      for (int s = 0; s < splits; ++s) acc += P[s * n_elems + e];
      C[e] = tsm2x::from_f32<U>(acc);
    }
  }
}

template <typename U>
int run(const float* p, U* c, int splits, int rows, int cols,
        cudaStream_t stream) {
  const int cap = BLOCK_ELEMS / (cols > 1 ? cols : 1);
  const int block_r = cap < 1 ? 1 : cap < rows ? cap : rows;
  const long n_elems = (long)rows * cols;
  const long block_elems = (long)block_r * cols;
  const dim3 grid((unsigned)((rows + block_r - 1) / block_r));
  if (cols % 4 == 0)
    sum_partials_kernel<U, 4>
        <<<grid, THREADS, 0, stream>>>(p, c, splits, n_elems, block_elems);
  else
    sum_partials_kernel<U, 1>
        <<<grid, THREADS, 0, stream>>>(p, c, splits, n_elems, block_elems);
  return (int)cudaGetLastError();
}

}  // namespace by_rows

}  // namespace

extern "C" int reduce_f32(const void* p, void* c, int splits, int rows,
                          int cols, void* stream) {
  return run_body<float, THREADS, CHUNK, STREAMING>(
      (const float*)p, (float*)c, splits, rows, cols, BLOCKS_PER_SM,
      (cudaStream_t)stream);
}

extern "C" int reduce_bf16(const void* p, void* c, int splits, int rows,
                           int cols, void* stream) {
  return run_body<__nv_bfloat16, THREADS, CHUNK, STREAMING>(
      (const float*)p, (__nv_bfloat16*)c, splits, rows, cols, BLOCKS_PER_SM,
      (cudaStream_t)stream);
}

// What a reduce_<tag> call launches for this stack, output dtype (0 f32, 1
// bf16) and P and C on the current card: out = {blocks, threads a block,
// vector width, slices a chunk}. core/perf_model.py::reduce_plan mirrors
// it.
extern "C" int reduce_plan(int splits, int rows, int cols, int out_tag,
                           const void* p, const void* c, int* out) {
  int sms = 0;
  const int err = sm_count(&sms);
  if (err != 0) return err;
  (void)splits;
  const long n = (long)rows * cols;
  const int vec = vec_width(n, p, c, out_tag == 1 ? 2 : 4);
  out[0] = blocks_for(n, vec, THREADS, BLOCKS_PER_SM, sms);
  out[1] = THREADS, out[2] = vec, out[3] = CHUNK;
  return 0;
}

// The sweep (chip_smoke.py's reduce_sweep line): variant i's {threads a
// block, blocks an SM, slices a chunk, streaming loads}, and an f32 launch
// of it with reduce_f32's arguments after i.
extern "C" int reduce_sweep_variant(int i, int* out) {
  if (i < 0 || i >= SWEEP_N) return 1;
  out[0] = SWEEP[i].threads, out[1] = SWEEP[i].blocks_per_sm;
  out[2] = SWEEP[i].chunk, out[3] = SWEEP[i].streaming;
  return 0;
}

extern "C" int reduce_sweep_f32(int i, const void* p, void* c, int splits,
                                int rows, int cols, void* stream) {
  return sweep_dispatch(i, (const float*)p, (float*)c, splits, rows, cols,
                        (cudaStream_t)stream,
                        std::make_integer_sequence<int, SWEEP_N>{});
}

// The rows body (the comparison arm), whatever the stack.
extern "C" int reduce_rows_f32(const void* p, void* c, int splits, int rows,
                               int cols, void* stream) {
  return by_rows::run<float>((const float*)p, (float*)c, splits, rows,
                             cols, (cudaStream_t)stream);
}

extern "C" int reduce_rows_bf16(const void* p, void* c, int splits, int rows,
                                int cols, void* stream) {
  return by_rows::run<__nv_bfloat16>((const float*)p, (__nv_bfloat16*)c,
                                     splits, rows, cols,
                                     (cudaStream_t)stream);
}
