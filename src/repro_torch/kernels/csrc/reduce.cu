// Sum of split partials on Hopper: C[r, c] = sum_s P[s, r, c] in f32, cast
// to the output dtype.
//
// Replaces src/repro/kernels/reduce.py::sum_partials_pallas (body
// _sum_lead_kernel).
//
// Bound on the H100: reading the S * rows * cols * 4 bytes of partials
// (plus writing rows * cols outputs); one add per element read.
//
// Design: blocks tile the output rows (block_r rows of all cols a block);
// each thread owns output elements (four neighbours at once with float4
// loads when cols is a multiple of 4) and adds P[0], P[1], ..., P[S-1] in
// that fixed order, so the result is the same bits on every launch: no
// atomics, no tree whose shape depends on the launch.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

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
int launch(const float* p, U* c, int splits, int rows, int cols, int block_r,
           cudaStream_t stream) {
  const long n_elems = (long)rows * cols;
  const long block_elems = (long)block_r * cols;
  dim3 grid((unsigned)((rows + block_r - 1) / block_r));
  if (cols % 4 == 0)
    sum_partials_kernel<U, 4>
        <<<grid, THREADS, 0, stream>>>(p, c, splits, n_elems, block_elems);
  else
    sum_partials_kernel<U, 1>
        <<<grid, THREADS, 0, stream>>>(p, c, splits, n_elems, block_elems);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int reduce_f32(const void* p, void* c, int splits, int rows,
                          int cols, int block_r, void* stream) {
  return launch<float>((const float*)p, (float*)c, splits, rows, cols, block_r,
                       (cudaStream_t)stream);
}

extern "C" int reduce_bf16(const void* p, void* c, int splits, int rows,
                           int cols, int block_r, void* stream) {
  return launch<__nv_bfloat16>((const float*)p, (__nv_bfloat16*)c, splits,
                               rows, cols, block_r, (cudaStream_t)stream);
}
