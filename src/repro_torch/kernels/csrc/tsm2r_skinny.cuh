// TSM2R's streaming body for outputs at most 16 wide (sm_90): C = A[m,k] @
// B[k,n] over one reduction range. f32 or bf16 inputs sum in f32; int8
// inputs sum exactly in int32 and fold their scales at the store. The
// sequential kernels (tsm2r.cu, tsm2r_q8.cu: the whole of k) and the split
// kernels (tsm2r_split.cu, tsm2r_q8_split.cu: slice s of S) take it when
// their plan says so (fits); every other call with a row-major B keeps
// common.cuh's tsm2r_block.
//
// Bound on the H100: the bytes of A. At n = 16 an f32 element of A feeds
// 16 FMAs, 4 a byte: 40% of the CUDA cores' f32 rate at 3.35 TB/s (a bf16
// element feeds 8 a byte, 80% of the rate, so bf16 at n = 16 sits near
// the FMA floor). An int8 byte feeds NW / 4 __dp4a (four exact products
// each): at n = 16, 4 a byte, 79% of the 64 int32 lanes an SM a clock at
// 3.35 TB/s; at n = 4, 20%. What has to stay below that rate is
// shared-memory traffic and the instructions around the products.
//
// Design (the paper's TSM2R: each thread keeps all n outputs of its rows,
// B broadcast to the threads):
// - One block owns BM = 128 rows (the tile table's one column tile), so
//   the grid is (ceil(m / 128), 1, S), the simt body's at n <= 16.
// - A by TMA (tma.cuh): one 128-row x 128-byte box a stage (32 f32, 64
//   bf16 or 128 int8 k values) with the 128-byte swizzle, into a ring of
//   `stages` stages (3 by default: 48 KB of A in flight a block), each
//   with a full and an empty mbarrier. P producer warps (2 by default)
//   take the stages in turn. The stage's warp waits for "empty", posts
//   the box's bytes and issues the copy, then stores the stage's B (BK x
//   n values, contiguous in global memory, loaded into its 32 lanes'
//   registers one of its stages ahead), zero-padded to the template width
//   NW in {1, 2, 4, 8, 16}, and arrives on "full" once more. f32 and bf16
//   B is stored widened to f32, a value a word; int8 B as packed words,
//   word (q, j) holding B[4q ... 4q + 3, j] (byte b = k 4q + b), so one
//   word is one __dp4a operand. One warp alone waits out a load of B
//   every stage, which caps what one block streams (chip_smoke.py's
//   skinny_sweep holds one producer against two). B needs no TMA (n = 1
//   or 3 rows are narrower than TMA's 16-byte strides).
// - Barriers are waited on by parity, which names a phase only while the
//   barrier is at most one phase from it. A producer's previous stage, P
//   stages back, shows that the consumers released stage kt - P - stages,
//   so its wait for the release of kt - stages is unambiguous only if P <=
//   stages; the launcher refuses more producers than stages.
// - Consumers: G groups of BM / R threads. Thread t of group g owns rows
//   t + i * BM / R (i < R) and all NW columns, and takes the 16-byte
//   chunks g * 8 / G ... (g + 1) * 8 / G - 1 of each stage's 8. Per chunk
//   it reads each row's 16 bytes of A (the swizzle puts the 32 rows of a
//   warp on distinct banks: 4 wavefronts a row load) and, per k value
//   (f32, bf16) or per 4-value word (int8), the NW words of B as 16-byte
//   loads that every lane takes from one address (one wavefront each). At
//   R = 2, NW = 16 that is (8 + 16) wavefronts for 128 warp-FMAs (f32),
//   0.19 a warp-FMA, against 0.75 in tsm2r_block's 2 x 4 micro-tile; int8
//   moves the same wavefronts a chunk for 128 warp-__dp4a, four times the
//   products.
// - f32 and bf16: each stage's products are summed apart and then added
//   to the running sum (a two-level sum, as tsm2r_block's). int8: the
//   __dp4a sums are exact int32; a slice deeper than FOLD_K = 131,072 k
//   folds them into an f32 running sum every FOLD_STAGES = 1,024 stages
//   (so no int32 sum overflows), a shallower one never folds. After the
//   last stage every group stores its partial tile in the ring's shared
//   memory and the block sums the G tiles in group order into C:
//   coalesced stores, no atomics, the same bits on every launch. int8
//   sums the groups' int32 tiles in int32, converts once
//   (__int2float_rn) and multiplies by the fold (RowFold: sA[row / band]
//   * sB), so up to FOLD_K deep its result is bit-equal to the plain
//   version (ref.tsm2r_q8_ref, one rounding of the exact integer); a
//   deeper slice sums the groups' f32 tiles instead.
// - Slice edges: a slice [k_lo, k_hi) need not start or end on a box
//   (bf16 boxes are 64 deep and int8 boxes 128, slices any whole number
//   of 16-byte chunks). A box that crosses k_hi holds the next slice's
//   values, and TMA zero-fills only past the tensor's edge, so each chunk
//   is taken only if it lies in [k_lo, k_hi): the sum never relies on the
//   fill.
// - Input types come in through In<T>: how many values a 16-byte chunk
//   holds, the tensor map's type, the bytes of staged B a k value and
//   column, and (f32, bf16) the widening.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>

#include "common.cuh"
#include "tma.cuh"

namespace tsm2x {
namespace skinny {

constexpr int BM = 128;         // rows a block
constexpr int ROW_BYTES = 128;  // one swizzled box row
constexpr int CHUNKS = ROW_BYTES / 16;
constexpr int A_BYTES = BM * ROW_BYTES;  // 16 KB of A a stage
constexpr int MAX_STAGES = 8;
constexpr int MAX_PRODUCERS = 4;
constexpr int MAX_WIDTH = 16;

// The default variant: rows a thread, k-splitting groups, stages,
// producer warps.
constexpr int R_DEFAULT = 2, G_DEFAULT = 2, STAGES_DEFAULT = 3,
              PRODUCERS_DEFAULT = 2;

// The variants chip_smoke.py's sweep times: {rows a thread, k-splitting
// groups, stages, producer warps}; variant 0 is the default.
constexpr int SWEEP[][4] = {{2, 2, 3, 2}, {2, 2, 3, 1}, {2, 2, 3, 3},
                            {2, 2, 4, 4}, {2, 2, 4, 2}, {2, 2, 6, 2},
                            {1, 2, 3, 2}, {4, 2, 3, 2}, {2, 4, 3, 2},
                            {2, 8, 3, 2}};
constexpr int SWEEP_N = sizeof(SWEEP) / sizeof(SWEEP[0]);

// int8: the most stages of one exact int32 sum (131,072 k: 1,024 x 128
// products of at most 127^2 stay below 2^31), and the deepest slice that
// never folds.
constexpr int FOLD_STAGES = 1024;
constexpr int FOLD_K = FOLD_STAGES * 128;

// Word q of a 16-byte chunk (q a constant once the loops are unrolled, so
// the chunk stays in registers).
__device__ __forceinline__ uint32_t word(const uint4& c, int q) {
  return q == 0 ? c.x : q == 1 ? c.y : q == 2 ? c.z : c.w;
}

template <typename T>
struct In;

template <>
struct In<float> {
  static constexpr int CK = 4;  // k values a 16-byte chunk
  static constexpr int B_BYTES = 4;  // staged B a k value and column
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  __device__ __forceinline__ static float at(const uint4& c, int e) {
    return __uint_as_float(word(c, e));
  }
};

template <>
struct In<__nv_bfloat16> {
  static constexpr int CK = 8;
  static constexpr int B_BYTES = 4;  // widened to f32
  static constexpr CUtensorMapDataType MAP =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  __device__ __forceinline__ static float at(const uint4& c, int e) {
    const uint32_t w = word(c, e / 2);  // element 2q in the low half
    return __uint_as_float(e % 2 ? (w & 0xffff0000u) : (w << 16));
  }
};

// int8 multiplies packed words (four k values each) with __dp4a: no
// widening.
template <>
struct In<int8_t> {
  static constexpr int CK = 16;
  static constexpr int B_BYTES = 1;  // four k values a word
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_UINT8;
};

// Threads of a block: the consumers, then the producer warps.
__host__ __device__ constexpr int threads(int r, int g, int producers) {
  return BM / r * g + 32 * producers;
}

// Whether a call takes this body: n in 1..16, k > 0, A's rows (k * size
// bytes) and slices (slice * size) whole 16-byte chunks, A 16-byte aligned.
// The sequential kernel passes slice = k.
inline bool fits(int k, int n, int size, const void* a, int slice) {
  return n >= 1 && n <= MAX_WIDTH && k > 0 && slice > 0 &&
         (long)k * size % 16 == 0 && (long)slice * size % 16 == 0 &&
         reinterpret_cast<uintptr_t>(a) % 16 == 0;
}

inline dim3 grid(int m, int splits) {
  return dim3((m + BM - 1) / BM, 1, splits > 1 ? splits : 1);
}

// f(std::integral_constant<int, NW>) for the template width that holds n.
template <typename F>
int with_width(int n, F&& f) {
  if (n <= 1) return f(std::integral_constant<int, 1>{});
  if (n <= 2) return f(std::integral_constant<int, 2>{});
  if (n <= 4) return f(std::integral_constant<int, 4>{});
  if (n <= 8) return f(std::integral_constant<int, 8>{});
  return f(std::integral_constant<int, 16>{});
}

// One k row of the staged B: NW f32 from one shared address for the warp.
template <int NW>
__device__ __forceinline__ void b_row(const float* p, float (&b)[NW]) {
  if constexpr (NW >= 4) {
#pragma unroll
    for (int q = 0; q < NW / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(p)[q];
      b[4 * q] = v.x, b[4 * q + 1] = v.y, b[4 * q + 2] = v.z,
      b[4 * q + 3] = v.w;
    }
  } else if constexpr (NW == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    b[0] = v.x, b[1] = v.y;
  } else {
    b[0] = p[0];
  }
}

// One 4-value word row of the staged int8 B: NW packed words from one
// shared address for the warp.
template <int NW>
__device__ __forceinline__ void b_words(const uint32_t* p, int (&b)[NW]) {
  if constexpr (NW >= 4) {
#pragma unroll
    for (int q = 0; q < NW / 4; ++q) {
      const int4 v = reinterpret_cast<const int4*>(p)[q];
      b[4 * q] = v.x, b[4 * q + 1] = v.y, b[4 * q + 2] = v.z,
      b[4 * q + 3] = v.w;
    }
  } else if constexpr (NW == 2) {
    const int2 v = *reinterpret_cast<const int2*>(p);
    b[0] = v.x, b[1] = v.y;
  } else {
    b[0] = (int)p[0];
  }
}

__device__ __forceinline__ void consumers_sync(int count) {
  asm volatile("bar.sync 1, %0;" ::"r"(count) : "memory");
}

template <typename T>
__host__ __device__ constexpr int stage_k() {  // k values a stage
  return CHUNKS * In<T>::CK;
}

template <typename T, int NW, int G>
size_t smem_bytes(int stages) {
  const size_t ring =
      (size_t)stages * (A_BYTES + stage_k<T>() * NW * In<T>::B_BYTES);
  const size_t red = (size_t)G * BM * NW * 4;
  return (ring > red ? ring : red) + 1024;  // + alignment slack
}

// The block body: rows [blockIdx.x * BM, + BM) of A (map_a: [m, k], boxes
// of BM rows x 128 bytes) times B over the reduction slice blockIdx.z,
// [z * slice, min((z + 1) * slice, k)), stored as U at C + z * m * n (row
// stride n). Launched with threads(R, G, producers) threads and
// smem_bytes<T, NW, G>(stages) bytes of dynamic shared memory. int8 (T =
// int8_t) multiplies each output by fold(row, value) at the store.
template <typename T, typename U, int NW, int R, int G, typename F = NoFold>
__device__ __forceinline__ void body(const CUtensorMap* map_a,
                                     const T* __restrict__ B,
                                     U* __restrict__ C, int m, int k, int n,
                                     int slice, int stages, int producers,
                                     F fold = F{}) {
  using I = In<T>;
  constexpr bool Q8 = std::is_same<T, int8_t>::value;
  constexpr int CK = I::CK, BK = stage_k<T>();
  constexpr int TPG = BM / R, NC = TPG * G, CPG = CHUNKS / G;
  static_assert(BM % R == 0 && TPG % 32 == 0 && CHUNKS % G == 0,
                "rows a thread and groups must tile the block");
  extern __shared__ uint8_t skinny_smem[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES], empty[MAX_STAGES];
  // The 128-byte swizzle repeats every 1024 bytes: the ring starts on one.
  const uint32_t raw = tma::smem_u32(skinny_smem);
  uint8_t* ring = skinny_smem + (((raw + 1023) & ~1023u) - raw);
  float* bs = reinterpret_cast<float*>(ring + stages * A_BYTES);

  const long z = blockIdx.z;
  const long lo = z * slice, hi = lo + slice;
  const int k_lo = lo < k ? (int)lo : k;
  const int k_hi = hi < k ? (int)hi : k;
  const int kb = k_lo / BK * BK;  // the first box's k
  const int steps = k_hi > k_lo ? (k_hi - kb + BK - 1) / BK : 0;
  const int row0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  TSM2X_BLOCK_RECORD(C + z * m * n, tsm2x::block_map::SKINNY, row0,
                     row0 + BM < m ? row0 + BM : m, 0, n, k_lo, k_hi, 4,
                     Q8 ? 1 : 0);

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      tma::mbar_init(&full[s], 2);  // its producer's two arrivals
      tma::mbar_init(&empty[s], NC / 32);  // one a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= NC) {  // the producer warps: warp w takes stages w, w + P, ...
    const int lane = (tid - NC) % 32, w = (tid - NC) / 32;
    // Each lane stages BPL values of B a stage. They are loaded one of
    // the warp's stages ahead, in the raw input type (a conversion right
    // after the load would wait for it), so their latency passes during
    // the other warps' P - 1 stages and while the ring is full. int8
    // values go four to a word: value p of a lane is byte p % 4 of the
    // stage's word lane + 32 * (p / 4).
    constexpr int BPL = (BK * NW + 31) / 32;
    const T zero = zero_of<T>();
    T rb[BPL];
    auto fetch = [&](int k0) {
#pragma unroll
      for (int p = 0; p < BPL; ++p) {
        if constexpr (Q8) {
          const int wi = lane + 32 * (p / 4), j = wi % NW;
          const int gk = k0 + 4 * (wi / NW) + p % 4;
          rb[p] = (j < n && gk >= k_lo && gk < k_hi) ? B[(long)gk * n + j]
                                                     : zero;
        } else {
          const int idx = lane + 32 * p, kk = idx / NW, j = idx % NW;
          const int gk = k0 + kk;
          rb[p] = (idx < BK * NW && j < n && gk >= k_lo && gk < k_hi)
                      ? B[(long)gk * n + j]
                      : zero;
        }
      }
    };
    if (w < steps) fetch(kb + w * BK);
    // Stage kt's slot s of the ring and its lap (the parity of its phase).
    int s = w % stages;
    uint32_t lap = w / stages;
    for (int kt = w; kt < steps; kt += producers) {
      const int k0 = kb + kt * BK;
      // Round r of stage s waits for the consumers' release of round
      // r - 1; round 0 passes at once (parity 1 of a fresh barrier).
      tma::mbar_wait(&empty[s], (lap & 1) ^ 1);
      if (lane == 0) {
        tma::mbar_expect_tx(&full[s], A_BYTES);
        tma::tma_load(ring + s * A_BYTES, map_a, &full[s], k0, row0);
      }
      if constexpr (Q8) {
        uint32_t* bw = reinterpret_cast<uint32_t*>(bs) + s * (BK / 4) * NW;
#pragma unroll
        for (int p = 0; p < BPL / 4; ++p)
          bw[lane + 32 * p] = (uint32_t)(uint8_t)rb[4 * p] |
                              (uint32_t)(uint8_t)rb[4 * p + 1] << 8 |
                              (uint32_t)(uint8_t)rb[4 * p + 2] << 16 |
                              (uint32_t)(uint8_t)rb[4 * p + 3] << 24;
      } else {
        float* bst = bs + s * BK * NW;
#pragma unroll
        for (int p = 0; p < BPL; ++p)
          if (lane + 32 * p < BK * NW) bst[lane + 32 * p] = to_f32(rb[p]);
      }
      __syncwarp();
      if (lane == 0) tma::mbar_arrive(&full[s]);  // B's stores released
      if (kt + producers < steps) fetch(k0 + producers * BK);
      for (s += producers; s >= stages; s -= stages) ++lap;
    }
    return;
  }

  const int g = tid / TPG, t = tid % TPG, lane = tid % 32;
  if constexpr (Q8) {
    // Exact int32 sums; a slice deeper than FOLD_K folds them into f32
    // every FOLD_STAGES stages, a shallower one never.
    const bool deep = k_hi - k_lo > FOLD_K;
    int acc[R][NW];
    float folded[R][NW];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < NW; ++j) acc[i][j] = 0, folded[i][j] = 0.f;

    int s = 0;
    uint32_t lap = 0;
    for (int kt = 0; kt < steps; ++kt) {
      const int k0 = kb + kt * BK;
      tma::mbar_wait(&full[s], lap & 1);
      const uint8_t* as = ring + s * A_BYTES;
      const uint32_t* bw =
          reinterpret_cast<const uint32_t*>(bs) + s * (BK / 4) * NW;
#pragma unroll
      for (int cc = 0; cc < CPG; ++cc) {
        const int c = g * CPG + cc, kc = k0 + c * CK;
        if (kc < k_lo || kc >= k_hi) continue;  // outside the slice
        uint4 av[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int r = t + i * TPG;  // r % 8 == t % 8
          av[i] = *reinterpret_cast<const uint4*>(as + r * ROW_BYTES +
                                                  ((c ^ (r & 7)) << 4));
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // the chunk's words: 4 k values each
          int b[NW];
          b_words<NW>(bw + (c * 4 + e) * NW, b);
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const int a = (int)word(av[i], e);
#pragma unroll
            for (int j = 0; j < NW; ++j)
              acc[i][j] = __dp4a(a, b[j], acc[i][j]);
          }
        }
      }
      __syncwarp();  // the warp's reads of stage s are done
      if (lane == 0) tma::mbar_arrive(&empty[s]);
      if (++s == stages) s = 0, ++lap;
      if (deep && (kt + 1) % FOLD_STAGES == 0) {
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < NW; ++j)
            folded[i][j] += __int2float_rn(acc[i][j]), acc[i][j] = 0;
      }
    }

    // Every group is done with the ring before it holds the partial
    // tiles: int32 (summed exactly, converted once) or, past FOLD_K, f32.
    consumers_sync(NC);
    int* red_i = reinterpret_cast<int*>(ring);  // G x BM x NW
    float* red_f = reinterpret_cast<float*>(ring);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        const int at = (g * BM + t + i * TPG) * NW + j;
        if (deep)
          red_f[at] = folded[i][j] + __int2float_rn(acc[i][j]);
        else
          red_i[at] = acc[i][j];
      }
    consumers_sync(NC);
    U* out = C + z * m * n + (long)row0 * n;
    const int rows = m - row0 < BM ? m - row0 : BM;
    for (int idx = tid; idx < rows * n; idx += NC) {
      const int r = idx / n, j = idx % n;
      float v;
      if (deep) {
        v = red_f[r * NW + j];
#pragma unroll
        for (int q = 1; q < G; ++q) v += red_f[(q * BM + r) * NW + j];
      } else {
        int iv = red_i[r * NW + j];
#pragma unroll
        for (int q = 1; q < G; ++q) iv += red_i[(q * BM + r) * NW + j];
        v = __int2float_rn(iv);
      }
      out[idx] = from_f32<U>(fold(row0 + r, v));
    }
  } else {
    float acc[R][NW];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < NW; ++j) acc[i][j] = 0.f;

    int s = 0;
    uint32_t lap = 0;
    for (int kt = 0; kt < steps; ++kt) {
      const int k0 = kb + kt * BK;
      tma::mbar_wait(&full[s], lap & 1);
      const uint8_t* as = ring + s * A_BYTES;
      const float* bst = bs + s * BK * NW;
      float part[R][NW];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < NW; ++j) part[i][j] = 0.f;
#pragma unroll
      for (int cc = 0; cc < CPG; ++cc) {
        const int c = g * CPG + cc, kc = k0 + c * CK;
        if (kc < k_lo || kc >= k_hi) continue;  // outside the slice
        uint4 av[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int r = t + i * TPG;  // r % 8 == t % 8
          av[i] = *reinterpret_cast<const uint4*>(as + r * ROW_BYTES +
                                                  ((c ^ (r & 7)) << 4));
        }
#pragma unroll
        for (int e = 0; e < CK; ++e) {
          float b[NW];
          b_row<NW>(bst + (c * CK + e) * NW, b);
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const float a = I::at(av[i], e);
#pragma unroll
            for (int j = 0; j < NW; ++j)
              part[i][j] = fmaf(a, b[j], part[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < NW; ++j) acc[i][j] += part[i][j];
      __syncwarp();  // the warp's reads of stage s are done
      if (lane == 0) tma::mbar_arrive(&empty[s]);
      if (++s == stages) s = 0, ++lap;
    }

    // Every group is done with the ring before it holds the partial tiles.
    consumers_sync(NC);
    float* red = reinterpret_cast<float*>(ring);  // G x BM x NW
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < NW; ++j)
        red[(g * BM + t + i * TPG) * NW + j] = acc[i][j];
    consumers_sync(NC);
    U* out = C + z * m * n + (long)row0 * n;
    const int rows = m - row0 < BM ? m - row0 : BM;
    for (int idx = tid; idx < rows * n; idx += NC) {
      const int r = idx / n, j = idx % n;
      float v = red[r * NW + j];
#pragma unroll
      for (int q = 1; q < G; ++q) v += red[(q * BM + r) * NW + j];
      out[idx] = from_f32<U>(v);
    }
  }
}

// Launch `kern` (a __global__ wrapper of body<T, U, NW, R, G>) over the
// grid (m tiles, 1, splits), with `extra` (int8: the fold) after its
// producers. Returns the cudaError_t of the launch, or
// cudaErrorInvalidValue when the call does not fit or A's tensor map cannot
// be encoded.
template <typename T, int NW, int R, int G, typename Kernel, typename U,
          typename... Extra>
int launch(Kernel kern, const T* a, const T* b, U* c, int m, int k, int n,
           int splits, int slice, int stages, int producers,
           cudaStream_t stream, Extra... extra) {
  if (!fits(k, n, sizeof(T), a, slice) || stages < 2 ||
      stages > MAX_STAGES || producers < 1 || producers > MAX_PRODUCERS ||
      producers > stages)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_a;
  if (!tma::encode(&map_a, a, k, m, In<T>::MAP, sizeof(T),
                   ROW_BYTES / sizeof(T), BM))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T, NW, G>(stages);
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid(m, splits), threads(R, G, producers), smem, stream>>>(
      map_a, b, c, m, k, n, slice, stages, producers, extra...);
  return (int)cudaGetLastError();
}

// f(std::integral_constant<int, R>, std::integral_constant<int, G>) for
// sweep variant i's rows a thread and groups; cudaErrorInvalidValue for
// an i out of range.
template <typename F>
int with_variant(int i, F&& f) {
  if (i < 0 || i >= SWEEP_N) return (int)cudaErrorInvalidValue;
  using std::integral_constant;
#define TSM2R_SWEEP_CASE(R, G) \
  case R * 100 + G:            \
    return f(integral_constant<int, R>{}, integral_constant<int, G>{});
  switch (SWEEP[i][0] * 100 + SWEEP[i][1]) {
    TSM2R_SWEEP_CASE(2, 2)
    TSM2R_SWEEP_CASE(1, 2)
    TSM2R_SWEEP_CASE(4, 2)
    TSM2R_SWEEP_CASE(2, 4)
    TSM2R_SWEEP_CASE(2, 8)
  }
#undef TSM2R_SWEEP_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace skinny
}  // namespace tsm2x
