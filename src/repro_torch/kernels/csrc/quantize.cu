// The int8 kernels' quantize pass on Hopper: symmetric int8 codes and f32
// scales of an f32 or bf16 operand, one scale per band of rows, in two
// launches.
//
// Not a TPU kernel: it replaces the plain-torch body of
// kernels/quant.py::quantize_blocks and quantize_tensor for CUDA tensors
// (the JAX package computes them with jnp, src/repro/kernels/quant.py:56
// and :83). Its bits are the plain code's: absmax in f32; scale = absmax /
// 127 by IEEE division (1 for an all-zero band); code = round half to even
// of x / scale, again by IEEE division (nvcc's default -prec-div=true; no
// reciprocal and no --use_fast_math), clipped to +-127. A short last band
// holds only the real rows.
//
// Bound on the H100: the bytes of the operand, read twice (once for the
// absmax, once for the codes), plus the codes written at 1 byte an
// element; at chatglm3's serving activations ([8192, 4096] bf16) 160 MB,
// ~0.048 ms at 3.35 TB/s.
//
// Design. The operand is [rows, cols] row-major, so band j is one
// contiguous run of band * cols elements. Both launches cut it into
// (band, chunk) blocks of CHUNK elements that never straddle a band:
// 1. absmax: each block reduces |x| over its chunk (16-byte loads where
//    the operand allows), then one atomicMax on the f32 bits into the
//    band's slot of a zeroed workspace (non-negative f32 values order as
//    their unsigned bits, so the max is exact and independent of order);
// 2. codes: each block reads its band's absmax, forms the scale and
//    writes the chunk's codes (8 or 4 bytes a store); block 0 also writes
//    every band's scale. With kmajor (one band, 2-D [k, n]) the codes go
//    out K-major, [n, k], through 64 x 64 shared-memory tiles, as the
//    int8 TSM2R's wgmma body reads its B.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr long CHUNK = 8192;   // elements a block, a multiple of every V
constexpr int T_TILE = 64;     // the K-major tile

struct Layout {
  long band_elems;   // band * cols
  long total;        // rows * cols
  long chunks;       // blocks a band
  int bands;
};

// The (band, chunk) block `b` covers [begin, end); empty past the rows.
__device__ __forceinline__ void chunk_of(const Layout& l, long b, int& band,
                                         long& begin, long& end) {
  band = (int)(b / l.chunks);
  long band_end = (long)(band + 1) * l.band_elems;
  band_end = band_end < l.total ? band_end : l.total;
  begin = (long)band * l.band_elems + (b % l.chunks) * CHUNK;
  end = begin + CHUNK < band_end ? begin + CHUNK : band_end;
}

template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = tsm2x::to_f32(p[0]);
  } else {
    static_assert(V * sizeof(T) == 16, "one 16-byte load");
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = tsm2x::to_f32(e[i]);
  }
}

__device__ __forceinline__ float scale_of(unsigned bits) {
  const float a = __uint_as_float(bits);
  return a > 0.f ? a / 127.f : 1.f;
}

__device__ __forceinline__ int8_t code_of(float x, float scale) {
  const float v = rintf(x / scale);   // round half to even
  return static_cast<int8_t>(fminf(fmaxf(v, -127.f), 127.f));
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
    quantize_absmax_kernel(const T* __restrict__ x,
                           unsigned* __restrict__ amax, Layout l) {
  int band;
  long begin, end;
  chunk_of(l, blockIdx.x, band, begin, end);
  if (begin >= end) return;
  TSM2X_BLOCK_RECORD(amax, tsm2x::block_map::QUANT_ABSMAX, band, band + 1, 0,
                     1, begin, end, 4, 0);
  float mx = 0.f;
  for (long i = begin + (long)threadIdx.x * V; i < end;
       i += (long)THREADS * V) {
    float v[V];
    load_vec<T, V>(x + i, v);
#pragma unroll
    for (int e = 0; e < V; ++e) mx = fmaxf(mx, fabsf(v[e]));
  }
#pragma unroll
  for (int o = 16; o > 0; o /= 2)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  __shared__ float warp_max[THREADS / 32];
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = mx;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < THREADS / 32; ++w) mx = fmaxf(mx, warp_max[w]);
    atomicMax(amax + band, __float_as_uint(mx));
  }
}

template <int V>
struct alignas(V) Codes {
  int8_t q[V];
};

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
    quantize_codes_kernel(const T* __restrict__ x,
                          const unsigned* __restrict__ amax,
                          float* __restrict__ scale, int8_t* __restrict__ q,
                          Layout l) {
  if (blockIdx.x == 0) {
    TSM2X_BLOCK_RECORD(scale, tsm2x::block_map::QUANT_SCALES, 0, l.bands, 0,
                       1, 0, 0, 0, 0);
    for (int j = threadIdx.x; j < l.bands; j += THREADS)
      scale[j] = scale_of(amax[j]);
  }
  int band;
  long begin, end;
  chunk_of(l, blockIdx.x, band, begin, end);
  if (begin >= end) return;
  TSM2X_BLOCK_RECORD(q, tsm2x::block_map::QUANT_CODES, begin, end, 0, 1, 0,
                     0, 0, 0);
  const float s = scale_of(amax[band]);
  for (long i = begin + (long)threadIdx.x * V; i < end;
       i += (long)THREADS * V) {
    float v[V];
    load_vec<T, V>(x + i, v);
    Codes<V> c;
#pragma unroll
    for (int e = 0; e < V; ++e) c.q[e] = code_of(v[e], s);
    *reinterpret_cast<Codes<V>*>(q + i) = c;
  }
}

// One band, x [rows = k, cols = n] row-major: codes written K-major,
// q[c * rows + r]; loads along c and stores along r both coalesced.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    quantize_codes_kmajor_kernel(const T* __restrict__ x,
                                 const unsigned* __restrict__ amax,
                                 float* __restrict__ scale,
                                 int8_t* __restrict__ q, int rows, int cols) {
  __shared__ int8_t tile[T_TILE][T_TILE + 4];
  const float s = scale_of(amax[0]);
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) scale[0] = s;
  const long r0 = (long)blockIdx.y * T_TILE, c0 = (long)blockIdx.x * T_TILE;
  if (blockIdx.x == 0 && blockIdx.y == 0)
    TSM2X_BLOCK_RECORD(scale, tsm2x::block_map::QUANT_SCALES, 0, 1, 0, 1, 0,
                       0, 0, 0);
  TSM2X_BLOCK_RECORD(q, tsm2x::block_map::QUANT_KMAJOR, c0,
                     c0 + T_TILE < cols ? c0 + T_TILE : cols, r0,
                     r0 + T_TILE < rows ? r0 + T_TILE : rows, 0, 0, 0, 0);
  const int tx = threadIdx.x % T_TILE, ty = threadIdx.x / T_TILE;
  for (int i = ty; i < T_TILE; i += THREADS / T_TILE) {
    const long r = r0 + i, c = c0 + tx;
    if (r < rows && c < cols)
      tile[tx][i] = code_of(tsm2x::to_f32(x[r * cols + c]), s);
  }
  __syncthreads();
  for (int i = ty; i < T_TILE; i += THREADS / T_TILE) {
    const long c = c0 + i, r = r0 + tx;
    if (r < rows && c < cols) q[c * rows + r] = tile[i][tx];
  }
}

template <typename T, int V>
int run_v(const T* x, unsigned* amax, float* scale, int8_t* q, int rows,
          int cols, int band, bool kmajor, cudaStream_t stream) {
  Layout l;
  l.band_elems = (long)band * cols;
  l.total = (long)rows * cols;
  l.chunks = (l.band_elems + CHUNK - 1) / CHUNK;
  l.bands = (rows + band - 1) / band;
  const long blocks = (long)l.bands * l.chunks;
  quantize_absmax_kernel<T, V><<<(unsigned)blocks, THREADS, 0, stream>>>(
      x, amax, l);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (kmajor) {
    const dim3 grid((cols + T_TILE - 1) / T_TILE,
                    (rows + T_TILE - 1) / T_TILE);
    quantize_codes_kmajor_kernel<T><<<grid, THREADS, 0, stream>>>(
        x, amax, scale, q, rows, cols);
  } else {
    quantize_codes_kernel<T, V><<<(unsigned)blocks, THREADS, 0, stream>>>(
        x, amax, scale, q, l);
  }
  return (int)cudaGetLastError();
}

// x [rows, cols] row-major; amax: `bands` u32 of workspace; scale: `bands`
// f32; q: the codes, [rows, cols], or [cols, rows] with kmajor (which
// needs one band: band >= rows).
template <typename T>
int run(const void* x, void* amax, void* scale, void* q, int rows, int cols,
        int band, int kmajor, void* stream) {
  if (rows <= 0 || cols <= 0 || band <= 0 || (kmajor && band < rows))
    return (int)cudaErrorInvalidValue;
  const int bands = (rows + band - 1) / band;
  const cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(unsigned) * bands,
                                          (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  constexpr int V = 16 / sizeof(T);
  // 16-byte vectors where every band starts on one: aligned bases and
  // band and operand lengths that are whole vectors.
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   ((long)band * cols) % V == 0 && ((long)rows * cols) % V == 0;
  if (vec)
    return run_v<T, V>((const T*)x, (unsigned*)amax, (float*)scale,
                       (int8_t*)q, rows, cols, band, kmajor,
                       (cudaStream_t)stream);
  return run_v<T, 1>((const T*)x, (unsigned*)amax, (float*)scale, (int8_t*)q,
                     rows, cols, band, kmajor, (cudaStream_t)stream);
}

}  // namespace

extern "C" int quantize_f32(const void* x, void* amax, void* scale, void* q,
                            int rows, int cols, int band, int kmajor,
                            void* stream) {
  return run<float>(x, amax, scale, q, rows, cols, band, kmajor, stream);
}

extern "C" int quantize_bf16(const void* x, void* amax, void* scale, void* q,
                             int rows, int cols, int band, int kmajor,
                             void* stream) {
  return run<__nv_bfloat16>(x, amax, scale, q, rows, cols, band, kmajor,
                            stream);
}
