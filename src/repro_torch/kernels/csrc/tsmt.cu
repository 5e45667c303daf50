// TSMT on Hopper: C[a,b] = X[m,a]^T @ Y[m,b] with m >> a, b.
//
// Replaces src/repro/kernels/tsmt.py::tsmt_pallas (body _tsmt_kernel).
//
// Bound on the H100: the bytes of X and Y (each read once); the output is
// tiny. With a, b <= 16 (PowerSGD, ABFT) the output is one tile, so this
// sequential kernel runs on one or a few SMs and is bound by what those SMs
// can pull, far below the card's 3.35 TB/s. Occupying the card needs the
// split-reduction kernel, which is a later port.
//
// Design: one block per (BA x BB) output tile loops over all of m, where the
// TPU ran a sequential grid axis. The block's threads form G groups; group g
// reduces rows g, g + G, g + 2G, ... into a register micro-tile, reading X
// and Y straight from global memory (neighbouring threads read neighbouring
// columns of one row, so each warp load is coalesced). The G partial tiles
// are then summed through shared memory in a fixed order, so the result is
// bit-identical from run to run: no atomics. Ragged m, a, b are masked.

#include "common.cuh"

namespace {

using tsm2x::from_f32;
using tsm2x::to_f32;

template <typename T, int BA, int BB, int TA, int TB, int G>
__global__ void __launch_bounds__((BA / TA) * (BB / TB) * G)
    tsmt_kernel(const T* __restrict__ X, const T* __restrict__ Y,
                T* __restrict__ C, int m, int a_dim, int b_dim) {
  constexpr int RT = BA / TA, CT = BB / TB, TPG = RT * CT;
  __shared__ float red[G * BA * BB];  // the groups' partial tiles

  const int tid = threadIdx.x;
  const int g = tid / TPG, t = tid % TPG;
  const int tx = t % CT, ty = t / CT;
  const int a0 = blockIdx.x * BA, b0 = blockIdx.y * BB;

  bool a_ok[TA], b_ok[TB];
#pragma unroll
  for (int i = 0; i < TA; ++i) a_ok[i] = a0 + ty + i * RT < a_dim;
#pragma unroll
  for (int j = 0; j < TB; ++j) b_ok[j] = b0 + tx + j * CT < b_dim;

  float acc[TA][TB];
#pragma unroll
  for (int i = 0; i < TA; ++i)
#pragma unroll
    for (int j = 0; j < TB; ++j) acc[i][j] = 0.f;

  // Two-level sum: each run of CH rows is summed apart, then added to acc,
  // so the rounding error grows with sqrt(CH) + sqrt(m / (G * CH)).
  constexpr int CH = 256;
  for (long r0 = g; r0 < m; r0 += (long)G * CH) {
    const long r1 = r0 + (long)G * CH < m ? r0 + (long)G * CH : m;
    float run[TA][TB];
#pragma unroll
    for (int i = 0; i < TA; ++i)
#pragma unroll
      for (int j = 0; j < TB; ++j) run[i][j] = 0.f;
#pragma unroll 2
    for (long r = r0; r < r1; r += G) {
      const T* xr = X + r * a_dim + a0 + ty;
      const T* yr = Y + r * b_dim + b0 + tx;
      float xv[TA], yv[TB];
#pragma unroll
      for (int i = 0; i < TA; ++i) xv[i] = a_ok[i] ? to_f32(xr[i * RT]) : 0.f;
#pragma unroll
      for (int j = 0; j < TB; ++j) yv[j] = b_ok[j] ? to_f32(yr[j * CT]) : 0.f;
#pragma unroll
      for (int i = 0; i < TA; ++i)
#pragma unroll
        for (int j = 0; j < TB; ++j)
          run[i][j] = fmaf(xv[i], yv[j], run[i][j]);
    }
#pragma unroll
    for (int i = 0; i < TA; ++i)
#pragma unroll
      for (int j = 0; j < TB; ++j) acc[i][j] += run[i][j];
  }

  // Fixed-order reduction of the G group partials.
#pragma unroll
  for (int i = 0; i < TA; ++i)
#pragma unroll
    for (int j = 0; j < TB; ++j)
      red[g * BA * BB + (ty + i * RT) * BB + tx + j * CT] = acc[i][j];
  __syncthreads();
  for (int idx = tid; idx < BA * BB; idx += TPG * G) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < G; ++q) s += red[q * BA * BB + idx];
    const int ga = a0 + idx / BB, gb = b0 + idx % BB;
    if (ga < a_dim && gb < b_dim) C[(long)ga * b_dim + gb] = from_f32<T>(s);
  }
}

template <typename T, int BA, int BB, int TA, int TB, int G>
int launch(const T* x, const T* y, T* c, int m, int a_dim, int b_dim,
           cudaStream_t stream) {
  constexpr int NT = (BA / TA) * (BB / TB) * G;
  dim3 grid((a_dim + BA - 1) / BA, (b_dim + BB - 1) / BB);
  tsmt_kernel<T, BA, BB, TA, TB, G><<<grid, NT, 0, stream>>>(x, y, c, m, a_dim,
                                                             b_dim);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const T* x, const T* y, T* c, int m, int a_dim, int b_dim,
             cudaStream_t stream) {
  // 256 threads and a 16 KB partials buffer in every shape.
  if (b_dim <= 4)
    return launch<T, 128, 4, 4, 4, 8>(x, y, c, m, a_dim, b_dim, stream);
  if (b_dim <= 16)
    return launch<T, 64, 16, 4, 4, 4>(x, y, c, m, a_dim, b_dim, stream);
  return launch<T, 64, 64, 4, 4, 1>(x, y, c, m, a_dim, b_dim, stream);
}

}  // namespace

extern "C" int tsmt_f32(const void* x, const void* y, void* c, int m, int a,
                        int b, void* stream) {
  return dispatch<float>((const float*)x, (const float*)y, (float*)c, m, a, b,
                         (cudaStream_t)stream);
}

extern "C" int tsmt_bf16(const void* x, const void* y, void* c, int m, int a,
                         int b, void* stream) {
  return dispatch<__nv_bfloat16>((const __nv_bfloat16*)x,
                                 (const __nv_bfloat16*)y, (__nv_bfloat16*)c, m,
                                 a, b, (cudaStream_t)stream);
}
