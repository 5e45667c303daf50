// Helpers shared by the TSM2X kernels: dtype conversion, how each input
// type is staged and multiplied, the register micro-tile every kernel
// accumulates into, the tile tables and the block bodies that the
// sequential, split-reduction and int8 kernels share.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "block_map.cuh"

namespace tsm2x {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // round to nearest even, as torch .to()
}

template <typename T>
__device__ __forceinline__ T zero_of() { return from_f32<T>(0.f); }
template <>
__device__ __forceinline__ int8_t zero_of<int8_t>() { return 0; }

// How an input type T is staged in shared memory and multiplied.
// f32 and bf16 stage as one f32 per 32-bit word and multiply with f32 FMAs.
// int8 stages PACK = 4 consecutive reduction values per 32-bit word (byte
// lane = position mod 4, in both operands) and multiplies with __dp4a into
// an int32 sum: four products per instruction, exact. Values read straight
// from global memory (TSMT) widen to V and multiply-add one at a time.
template <typename T>
struct Stage {
  using S = float;    // shared-memory word
  using Acc = float;  // a staged chunk's sum
  using V = float;    // one value read from global memory
  static constexpr int PACK = 1;
  __device__ __forceinline__ static void put(S* base, int word, int lane,
                                             T v) {
    (void)lane;
    base[word] = to_f32(v);
  }
  __device__ __forceinline__ static Acc mac(S a, S b, Acc acc) {
    return fmaf(a, b, acc);
  }
  __device__ __forceinline__ static V val(T v) { return to_f32(v); }
  __device__ __forceinline__ static V fma(V a, V b, V acc) {
    return fmaf(a, b, acc);
  }
};

template <>
struct Stage<int8_t> {
  using S = int;
  using Acc = int;
  using V = int;
  static constexpr int PACK = 4;
  __device__ __forceinline__ static void put(S* base, int word, int lane,
                                             int8_t v) {
    reinterpret_cast<int8_t*>(base)[word * 4 + lane] = v;
  }
  __device__ __forceinline__ static Acc mac(S a, S b, Acc acc) {
    return __dp4a(a, b, acc);
  }
  __device__ __forceinline__ static V val(int8_t v) { return v; }
  __device__ __forceinline__ static V fma(V a, V b, V acc) {
    return a * b + acc;
  }
};

// Scale folds of the int8 kernels. NoFold leaves a sum as it is (the f32
// and bf16 kernels). RowFold multiplies an output of row `row` by
// sA[row / band] * sB, as the JAX tsm2r/tsm2l int8 kernels fold both scales
// once at the flush. BandFold multiplies the sum over one band of the
// reduction that starts at row `r0` by sX[band] * sY[band], as the JAX tsmt
// int8 kernel dequantizes each step before it adds it.
struct NoFold {
  static constexpr bool kBanded = false;
  __device__ __forceinline__ float operator()(long, float v) const {
    return v;
  }
};

struct RowFold {
  const float* sa;
  const float* sb;
  int band;
  // Rows fit an int (m does): a 32-bit division, where a 64-bit one costs
  // a long sequence of instructions.
  __device__ __forceinline__ float operator()(long row, float v) const {
    return v * (sa[(int)row / band] * sb[0]);
  }
};

struct BandFold {
  static constexpr bool kBanded = true;
  const float* sx;
  const float* sy;
  int band;
  __device__ __forceinline__ float operator()(long r0, float v) const {
    const long j = r0 / band;
    return v * (sx[j] * sy[j]);
  }
};

// acc[i][j] += sum_kk As[row i][kk] * Bs[kk][col j] over one staged chunk.
// Thread (ty, tx) owns rows ty + i*RT and columns tx + j*CT of the tile:
// strided ownership keeps neighbouring threads on neighbouring shared-memory
// words (no bank conflicts) and on neighbouring output columns (coalesced
// stores).
// kc counts staged words (Stage::PACK reduction values each).
template <int TM, int TN, int RT, int CT, typename St = Stage<float>>
__device__ __forceinline__ void micro_tile(typename St::Acc (&acc)[TM][TN],
                                           const typename St::S* As,
                                           int a_row_stride,
                                           const typename St::S* Bs,
                                           int b_k_stride, int ty, int tx,
                                           int kc) {
#pragma unroll 4
  for (int kk = 0; kk < kc; ++kk) {
    typename St::S a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      a[i] = As[(ty + i * RT) * a_row_stride + kk];
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = Bs[kk * b_k_stride + tx + j * CT];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = St::mac(a[i], b[j], acc[i][j]);
  }
}

// The chunk's products summed apart, then added to acc: a two-level sum
// whose rounding error grows with sqrt(kc) + sqrt(chunks), not sqrt(k).
// For int8 the chunk's sum is an exact int32 (at most 127^2 * 4 * kc), so
// folding it into f32 once a chunk keeps any depth from overflowing.
template <int TM, int TN, int RT, int CT, typename St = Stage<float>>
__device__ __forceinline__ void tile_into(float (&acc)[TM][TN],
                                          const typename St::S* As,
                                          int a_row_stride,
                                          const typename St::S* Bs,
                                          int b_k_stride, int ty, int tx,
                                          int kc) {
  typename St::Acc part[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) part[i][j] = 0;
  micro_tile<TM, TN, RT, CT, St>(part, As, a_row_stride, Bs, b_k_stride, ty,
                                 tx, kc);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] += static_cast<float>(part[i][j]);
}

// ---------------------------------------------------------------------------
// Tile tables. One table per kernel family, used by the sequential and the
// split kernel alike and mirrored in Python by
// repro_torch/core/perf_model.py (tsm2r_tile, tsmt_tile), whose block
// counts drive the split chooser. The *_split_grid queries let a caller
// check the mirror against this table.
// ---------------------------------------------------------------------------

template <int BM_, int BN_, int BK_, int TM_, int TN_>
struct Tsm2rTile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, TM = TM_, TN = TN_;
};

// f(Tsm2rTile<...>{}) for the tile TSM2R uses at output width n.
template <typename F>
inline int with_tsm2r_tile(int n, F&& f) {
  if (n <= 16) return f(Tsm2rTile<128, 16, 32, 2, 4>{});  // n <= 16
  return f(Tsm2rTile<64, 64, 32, 4, 4>{});
}

template <int BA_, int BB_, int TA_, int TB_, int G_>
struct TsmtTile {
  static constexpr int BA = BA_, BB = BB_, TA = TA_, TB = TB_, G = G_;
};

// f(TsmtTile<...>{}) for the tile TSMT uses at output width b: 256 threads
// and a 16 KB partials buffer in every shape.
template <typename F>
inline int with_tsmt_tile(int b_dim, F&& f) {
  if (b_dim <= 4) return f(TsmtTile<128, 4, 4, 4, 8>{});
  if (b_dim <= 16) return f(TsmtTile<64, 16, 4, 4, 4>{});
  return f(TsmtTile<64, 64, 4, 4, 1>{});
}

// ---------------------------------------------------------------------------
// TSM2R block body: one (BM x BN) output tile of A[m,k] @ B[k,n] over the
// reduction range [k_lo, k_hi), written as U at C[row][col] (row stride n),
// each value passed through fold(row, value) first. The next (BM x BK) A
// tile and (BK x BN) B tile are prefetched into registers while the
// current one is multiplied out of shared memory (paper Algorithm 4).
// Ragged edges are masked: zero padding is exact. T is the input type;
// Stage<T> says how it is staged (int8: four k values a word, __dp4a).
// ---------------------------------------------------------------------------

template <typename T, typename U, int BM, int BN, int BK, int TM, int TN,
          typename Fold = NoFold>
__device__ __forceinline__ void tsm2r_block(const T* __restrict__ A,
                                            const T* __restrict__ B,
                                            U* __restrict__ C, int m, int k,
                                            int n, int k_lo, int k_hi,
                                            const Fold fold = Fold()) {
  using St = Stage<T>;
  using S = typename St::S;
  constexpr int P = St::PACK;
  constexpr int RT = BM / TM;  // threads along rows
  constexpr int CT = BN / TN;  // threads along columns
  constexpr int NT = RT * CT;
  constexpr int KW = BK / P;   // staged words along k
  constexpr int LDA = KW + 1;  // odd stride: row reads hit distinct banks
  constexpr int A_PER = BM * BK / NT;
  constexpr int B_PER = BK * BN / NT;
  static_assert((BM * BK) % NT == 0 && (BK * BN) % NT == 0, "tile/threads");
  static_assert(BK % P == 0, "BK must hold whole staged words");

  __shared__ S As[BM * LDA];
  __shared__ S Bs[KW * BN];

  const int tid = threadIdx.x;
  const int tx = tid % CT, ty = tid / CT;
  const long row0 = (long)blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  if (k_hi > k) k_hi = k;
  TSM2X_BLOCK_RECORD(C, tsm2x::block_map::TSM2R_SIMT, row0,
                     row0 + BM < m ? row0 + BM : m, col0,
                     col0 + BN < n ? col0 + BN : n, k_lo, k_hi,
                     block_map::acc_bytes<typename St::Acc>(),
                     block_map::acc_int<typename St::Acc>());

  // The prefetch registers hold the raw input type and are converted only
  // when stored to shared memory: a conversion right after the load would
  // make the warp wait for the load before the FMAs it should overlap.
  T ra[A_PER], rb[B_PER];
  const T zero = zero_of<T>();
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

#define TSM2R_FETCH(k0)                                                  \
  {                                                                      \
    _Pragma("unroll") for (int p = 0; p < A_PER; ++p) {                  \
      const int idx = tid + p * NT, r = idx / BK, c = idx % BK;          \
      const long gr = row0 + r;                                          \
      const int gc = (k0) + c;                                           \
      ra[p] = (gr < m && gc < k_hi) ? A[gr * k + gc] : zero;             \
    }                                                                    \
    _Pragma("unroll") for (int p = 0; p < B_PER; ++p) {                  \
      const int idx = tid + p * NT, r = idx / BN, c = idx % BN;          \
      const int gr = (k0) + r, gc = col0 + c;                            \
      rb[p] = (gr < k_hi && gc < n) ? B[(long)gr * n + gc] : zero;       \
    }                                                                    \
  }

  if (k_lo < k_hi) TSM2R_FETCH(k_lo);
  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
#pragma unroll
    for (int p = 0; p < A_PER; ++p) {
      const int idx = tid + p * NT, r = idx / BK, c = idx % BK;
      St::put(As, r * LDA + c / P, c % P, ra[p]);
    }
#pragma unroll
    for (int p = 0; p < B_PER; ++p) {
      const int idx = tid + p * NT, r = idx / BN, c = idx % BN;
      St::put(Bs, (r / P) * BN + c, r % P, rb[p]);
    }
    __syncthreads();
    if (k0 + BK < k_hi) TSM2R_FETCH(k0 + BK);  // in flight during the FMAs
    tile_into<TM, TN, RT, CT, St>(acc, As, LDA, Bs, BN, ty, tx, KW);
    __syncthreads();
  }
#undef TSM2R_FETCH

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long gr = row0 + ty + i * RT;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + tx + j * CT;
      if (gc < n) C[gr * n + gc] = from_f32<U>(fold(gr, acc[i][j]));
    }
  }
}

// ---------------------------------------------------------------------------
// TSMT block body: one (BA x BB) output tile of X[m,a]^T Y[m,b] over the
// rows [lo, hi), written as U at C[a][b] (row stride b_dim). The block's
// threads form G groups; group g reduces rows lo + g, lo + g + G, ... into a
// register micro-tile, reading X and Y straight from global memory
// (neighbouring threads read neighbouring columns of one row, so each warp
// load is coalesced). The rows are taken in chunks; each chunk's sum is
// kept apart and then added to the running sum through fold(chunk start,
// sum). f32/bf16: chunks of G * 256 rows, a two-level sum whose rounding
// error grows with sqrt(256) + sqrt(rows / (G * 256)). int8 (a banded
// Fold): one chunk per band of the scales, summed exactly in int32 and
// dequantized before it is added, so lo must start a band. The G partial
// tiles are then summed through shared memory in a fixed order:
// bit-identical from run to run, no atomics.
// ---------------------------------------------------------------------------

template <typename T, typename U, int BA, int BB, int TA, int TB, int G,
          typename Fold = NoFold>
__device__ __forceinline__ void tsmt_block(const T* __restrict__ X,
                                           const T* __restrict__ Y,
                                           U* __restrict__ C, long lo,
                                           long hi, int a_dim, int b_dim,
                                           const Fold fold = Fold()) {
  using St = Stage<T>;
  using V = typename St::V;
  constexpr int RT = BA / TA, CT = BB / TB, TPG = RT * CT;
  constexpr int CH = 256;
  constexpr int RU = 4;  // rows a thread loads before it multiplies
  __shared__ float red[G * BA * BB];  // the groups' partial tiles
  const T zero = zero_of<T>();

  const int tid = threadIdx.x;
  const int g = tid / TPG, t = tid % TPG;
  const int tx = t % CT, ty = t / CT;
  const int a0 = blockIdx.x * BA, b0 = blockIdx.y * BB;
  TSM2X_BLOCK_RECORD(C, tsm2x::block_map::TSMT_SIMT, a0,
                     a0 + BA < a_dim ? a0 + BA : a_dim, b0,
                     b0 + BB < b_dim ? b0 + BB : b_dim, lo, hi,
                     block_map::acc_bytes<V>(), block_map::acc_int<V>());

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

  long chunk = (long)G * CH;
  if constexpr (Fold::kBanded) chunk = fold.band;
  for (long c0 = lo; c0 < hi; c0 += chunk) {
    const long c1 = c0 + chunk < hi ? c0 + chunk : hi;
    V run[TA][TB];
#pragma unroll
    for (int i = 0; i < TA; ++i)
#pragma unroll
      for (int j = 0; j < TB; ++j) run[i][j] = 0;
    // RU rows' raw values are loaded into registers before any of them is
    // multiplied, so every build keeps RU rows of loads in flight (left to
    // the compiler, one build issued each row's loads after the previous
    // row's FMAs: 3-4x slower). Rows are multiplied in order; a row past
    // c1 multiplies zeros, which adds exactly nothing.
    for (long r = c0 + g; r < c1; r += (long)RU * G) {
      T xr[RU][TA], yr[RU][TB];
#pragma unroll
      for (int u = 0; u < RU; ++u) {
        const long ru = r + (long)u * G;
        const bool live = ru < c1;
        const T* xp = X + ru * a_dim + a0 + ty;
        const T* yp = Y + ru * b_dim + b0 + tx;
#pragma unroll
        for (int i = 0; i < TA; ++i)
          xr[u][i] = (live && a_ok[i]) ? xp[i * RT] : zero;
#pragma unroll
        for (int j = 0; j < TB; ++j)
          yr[u][j] = (live && b_ok[j]) ? yp[j * CT] : zero;
      }
#pragma unroll
      for (int u = 0; u < RU; ++u)
#pragma unroll
        for (int i = 0; i < TA; ++i)
#pragma unroll
          for (int j = 0; j < TB; ++j)
            run[i][j] = St::fma(St::val(xr[u][i]), St::val(yr[u][j]),
                                run[i][j]);
    }
#pragma unroll
    for (int i = 0; i < TA; ++i)
#pragma unroll
      for (int j = 0; j < TB; ++j)
        acc[i][j] += fold(c0, static_cast<float>(run[i][j]));
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
    if (ga < a_dim && gb < b_dim) C[(long)ga * b_dim + gb] = from_f32<U>(s);
  }
}

// ---------------------------------------------------------------------------
// One-launch TSMT over S slices of m, shared by tsmt.cu and tsmt_q8.cu.
// Block (i, j, s) runs body(P[s], lo, hi), a block body over the rows
// [lo, hi) = [s * slice, min((s + 1) * slice, m)) into P[s], an f32 (S,
// a, b) workspace (the split kernels' layout), then draws a ticket from
// its tile's counter. The block that draws S - 1 is the tile's last:
// every other slice of the tile has stored and fenced its partials, so it
// sums each output element over s = 0, 1, ..., S - 1 from 0.f, in that
// order, and writes C once. It reads the
// partials through L2 (__ldcg): another SM's stores are not coherent in
// this SM's L1. The only atomic is the ticket, never data, so the sum's
// order is fixed and every launch repeats its bits. count holds one zeroed
// counter per output tile (the launcher clears it on the stream).
// ---------------------------------------------------------------------------

template <typename U, int BA, int BB, int NT, typename Body>
__device__ __forceinline__ void tsmt_slices_run(
    U* __restrict__ C, float* __restrict__ P, unsigned* __restrict__ count,
    int m, int a_dim, int b_dim, int splits, int slice, Body&& body) {
  constexpr int EPT = (BA * BB + NT - 1) / NT;  // output elements a thread
  constexpr int UN = EPT >= 32 ? 1 : 32 / EPT;  // slices loaded at once
  __shared__ bool last;
  const long ab = (long)a_dim * b_dim;
  const long s = blockIdx.z;
  const long lo = s * slice < m ? s * slice : m;
  const long hi = lo + slice < m ? lo + slice : m;
  body(P + s * ab, lo, hi);
  __threadfence();  // this block's partials, before its ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned ticket =
        atomicAdd(&count[blockIdx.y * gridDim.x + blockIdx.x], 1u);
    last = ticket == (unsigned)(splits - 1);
    if (last)
      TSM2X_BLOCK_RECORD(
          C, tsm2x::block_map::TSMT_FINAL, blockIdx.x * BA,
          blockIdx.x * BA + BA < a_dim ? blockIdx.x * BA + BA : a_dim,
          blockIdx.y * BB,
          blockIdx.y * BB + BB < b_dim ? blockIdx.y * BB + BB : b_dim, 0, m,
          4, 0, 1, (int)ticket);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();  // the other slices' partials, before they are read

  const int a0 = blockIdx.x * BA, b0 = blockIdx.y * BB;
  long off[EPT];
  bool ok[EPT];
  float acc[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int idx = threadIdx.x + e * NT;
    const int ga = a0 + idx / BB, gb = b0 + idx % BB;
    ok[e] = idx < BA * BB && ga < a_dim && gb < b_dim;
    off[e] = ok[e] ? (long)ga * b_dim + gb : 0;
    acc[e] = 0.f;
  }
  // UN slices' loads are issued before any of them is added, so the L2
  // round trips overlap; the adds stay in slice order.
  for (int s0 = 0; s0 < splits; s0 += UN) {
    float v[UN][EPT];
#pragma unroll
    for (int u = 0; u < UN; ++u)
#pragma unroll
      for (int e = 0; e < EPT; ++e)
        v[u][e] = (ok[e] && s0 + u < splits)
                      ? __ldcg(P + (long)(s0 + u) * ab + off[e])
                      : 0.f;
#pragma unroll
    for (int u = 0; u < UN; ++u)
#pragma unroll
      for (int e = 0; e < EPT; ++e)
        if (s0 + u < splits) acc[e] += v[u][e];
  }
#pragma unroll
  for (int e = 0; e < EPT; ++e)
    if (ok[e]) C[off[e]] = from_f32<U>(acc[e]);
}

// The launch of a one-launch TSMT kernel at tile Tl. S = 1 calls
// launch(false_type, grid, threads, nullptr, nullptr): a block body straight
// into C, no workspace. Past one slice it clears the tile counters that
// follow the (S, a, b) f32 partials in ws, on the stream, and calls
// launch(true_type, grid, threads, partials, counters) over the (a-tiles,
// b-tiles, S) grid. Returns the cudaError_t of the memset or the launch.
template <typename Tl, typename Launch>
int tsmt_slices_launch(int a_dim, int b_dim, int splits, void* ws,
                       cudaStream_t stream, Launch&& launch) {
  constexpr int NT = (Tl::BA / Tl::TA) * (Tl::BB / Tl::TB) * Tl::G;
  dim3 grid((a_dim + Tl::BA - 1) / Tl::BA, (b_dim + Tl::BB - 1) / Tl::BB,
            splits > 1 ? splits : 1);
  if (splits <= 1) {
    launch(std::false_type{}, grid, NT, (float*)nullptr, (unsigned*)nullptr);
    return (int)cudaGetLastError();
  }
  float* p = (float*)ws;
  unsigned* count = (unsigned*)(p + (size_t)splits * a_dim * b_dim);
  const cudaError_t err = cudaMemsetAsync(
      count, 0, sizeof(unsigned) * grid.x * grid.y, stream);
  if (err != cudaSuccess) return (int)err;
  launch(std::true_type{}, grid, NT, p, count);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// TSM2L: C[m,n] = A[m,k] @ B[k,n] with m >> k ~ n, shared by tsm2l.cu and
// tsm2l_q8.cu. The grid runs over m only (plus a column grid dimension for
// wide n), and each block walks row tiles in a grid-stride loop, so the B
// tile it stages into shared memory stays there for the block's whole
// lifetime. At the classifier's limit (k = n = 256) all of B in f32 is
// 256 KB, more than the 227 KB a block may hold, so B is tiled over n (BN
// columns per block) and, past KC rows of k, over k as well (then B is
// re-staged per chunk). The paper's tcf trade (Section 3.2: fewer, fatter
// threads when k is tiny) is answered with three fixed tile shapes picked
// by n: a tiny n gives each thread more rows. Each (BM x k) A tile is
// contiguous in memory and is loaded once, coalesced. Ragged m, k, n are
// masked. Accumulation is f32 (int8: exact int32 per staged chunk of at
// most KC k values, then f32); outputs pass through fold(row, value).
// ---------------------------------------------------------------------------

template <typename T, typename U, int BM, int BN, int TM, int TN,
          typename Fold>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    tsm2l_kernel(const T* __restrict__ A, const T* __restrict__ B,
                 U* __restrict__ C, int m, int k, int n, int kc,
                 const Fold fold) {
  using St = Stage<T>;
  using S = typename St::S;
  constexpr int P = St::PACK;
  constexpr int RT = BM / TM, CT = BN / TN, NT = RT * CT;
  extern __shared__ __align__(16) unsigned char tsm2l_smem[];
  const int kw = (kc + P - 1) / P;  // staged words of one chunk
  const int kp = kw * P;            // chunk length padded to whole words
  S* Bs = reinterpret_cast<S*>(tsm2l_smem);  // kw x BN
  S* As = Bs + kw * BN;                       // BM x (kw + 1)
  const int lda = kw + 1;
  const bool resident = k <= kc;
  const T zero = zero_of<T>();

  const int tid = threadIdx.x;
  const int tx = tid % CT, ty = tid / CT;
  const int col0 = blockIdx.y * BN;

#define TSM2L_STAGE_B(k0)                                                  \
  for (int idx = tid; idx < kp * BN; idx += NT) {                          \
    const int r = idx / BN, gr = (k0) + r, gc = col0 + idx % BN;           \
    St::put(Bs, (r / P) * BN + idx % BN, r % P,                            \
            (gr < k && gc < n) ? B[(long)gr * n + gc] : zero);             \
  }

  if (resident) TSM2L_STAGE_B(0);  // once for the block's lifetime

  for (long row0 = (long)blockIdx.x * BM; row0 < m;
       row0 += (long)gridDim.x * BM) {
    TSM2X_BLOCK_RECORD(C, tsm2x::block_map::TSM2L_TILE, row0,
                       row0 + BM < m ? row0 + BM : m, col0,
                       col0 + BN < n ? col0 + BN : n, 0, k,
                       block_map::acc_bytes<typename St::Acc>(),
                       block_map::acc_int<typename St::Acc>(), 0, 0,
                       row0 / BM);
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < k; k0 += kc) {
      if (!resident) TSM2L_STAGE_B(k0);
      for (int idx = tid; idx < BM * kp; idx += NT) {
        const int r = idx / kp, c = idx % kp;
        const long gr = row0 + r;
        const int gc = k0 + c;
        St::put(As, r * lda + c / P, c % P,
                (gr < m && gc < k && c < kc) ? A[gr * k + gc] : zero);
      }
      __syncthreads();
      tile_into<TM, TN, RT, CT, St>(acc, As, lda, Bs, BN, ty, tx, kw);
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const long gr = row0 + ty + i * RT;
      if (gr >= m) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int gc = col0 + tx + j * CT;
        if (gc < n) C[gr * n + gc] = from_f32<U>(fold(gr, acc[i][j]));
      }
    }
  }
#undef TSM2L_STAGE_B
}

template <typename T, typename U, int BM, int BN, int TM, int TN, int KC,
          typename Fold>
int tsm2l_launch(const T* a, const T* b, U* c, int m, int k, int n,
                 const Fold fold, cudaStream_t stream) {
  using S = typename Stage<T>::S;
  constexpr int P = Stage<T>::PACK;
  constexpr int NT = (BM / TM) * (BN / TN);
  auto kern = tsm2l_kernel<T, U, BM, BN, TM, TN, Fold>;
  const int kc = k < KC ? k : KC;
  const int kw = (kc + P - 1) / P;
  const size_t smem = sizeof(S) * ((size_t)kw * BN + (size_t)BM * (kw + 1));
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT, smem);
  if (err != cudaSuccess) return (int)err;
  const long tiles = ((long)m + BM - 1) / BM;
  const long resident_blocks = (long)sms * (per_sm > 0 ? per_sm : 1);
  dim3 grid((unsigned)(tiles < resident_blocks ? tiles : resident_blocks),
            (n + BN - 1) / BN);
  kern<<<grid, NT, smem, stream>>>(a, b, c, m, k, n, kc, fold);
  return (int)cudaGetLastError();
}

template <int BM_, int BN_, int TM_, int TN_, int KC_>
struct Tsm2lTile {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_, KC = KC_;
};

// f(Tsm2lTile<...>{}) for the tile TSM2L's tile body uses at output width
// n (mirrored by core/perf_model.py's tsm2l_tile). Shared memory stays
// under ~100 KB at every k: BM * (KC + 1) + KC * BN words (a quarter of
// the words for int8).
template <typename F>
inline int with_tsm2l_tile(int n, F&& f) {
  if (n <= 4) return f(Tsm2lTile<512, 4, 2, 4, 32>{});
  if (n <= 16) return f(Tsm2lTile<256, 16, 4, 4, 64>{});
  return f(Tsm2lTile<64, 64, 4, 4, 256>{});
}

template <typename T, typename U, typename Fold>
int tsm2l_dispatch(const T* a, const T* b, U* c, int m, int k, int n,
                   const Fold fold, cudaStream_t stream) {
  return with_tsm2l_tile(n, [&](auto tile) {
    using Tl = decltype(tile);
    return tsm2l_launch<T, U, Tl::BM, Tl::BN, Tl::TM, Tl::TN, Tl::KC>(
        a, b, c, m, k, n, fold, stream);
  });
}

}  // namespace tsm2x
