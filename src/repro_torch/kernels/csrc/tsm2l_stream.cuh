// TSM2L's streaming body for outputs at most 16 wide (sm_90): C[m,n] =
// A[m,k] @ B[k,n] with m >> k, k in 1..256. f32 or bf16 inputs sum in f32;
// int8 inputs sum exactly in int32 and fold their scales at the store. The
// kernels tsm2l.cu and tsm2l_q8.cu take it when stream::fits (n <= 16, k <=
// 256, a 16-byte aligned A); every other call keeps common.cuh's tile body
// (tsm2l_kernel).
//
// Bound on the H100: the bytes of A and C. At k = n = 16 an f32 element of
// A feeds 16 FMAs: with C's bytes beside A's, about a quarter of the CUDA
// cores' f32 rate at 3.35 TB/s (bf16 about half). An int8 word of A feeds
// n __dp4a. What has to stay below that rate is shared-memory traffic and
// the instructions around the products.
//
// Design (the paper's TSM2L: each thread computes whole rows, R rows a
// thread, B broadcast):
// - Persistent blocks: BLOCKS_PER_SM blocks an SM (the plan keeps a
//   block's dynamic shared memory within SMEM_BYTES, and the launch bounds
//   keep its registers within half an SM), each walking row tiles of BM
//   rows in a grid-stride loop. B is staged once a block, rows past k and
//   columns past n zero: f32 and bf16 widened to f32, a value a word;
//   int8 as packed words, word (q, j) holding B[4q ... 4q + 3, j], one
//   __dp4a operand.
// - A through a ring of `stages` stages, each with a full and an empty
//   mbarrier. A row tile is BM whole rows, contiguous in memory, so one
//   producer thread copies it with 1-D cp.async.bulk, no tensor map. The
//   tile goes as PIECES = 8 copies of BM / 8 rows each (always a whole
//   number of 16-byte units: the plan keeps BM / 8 * k * size a multiple
//   of 16), piece p at p * ps in the stage, ps an odd number of 16-byte
//   units. The last, ragged tile copies each piece's whole 16-byte
//   multiple and stores the rest (under 16 bytes) with plain loads before
//   it arrives; nothing reads past A's end.
// - Consumers: 128 threads in G groups (1, 2 or 4, the fewest that keep a
//   stage within STAGE_BYTES); group g takes its share of each row's k.
//   Thread t of a group owns R rows (the plan's: 4 rows of at most 32
//   bytes of A, 2 of at most 256, else 1; more rows a thread share each
//   read of B and make tiles, and bulk copies, larger), row i at piece
//   t % 8, index i * T / 8 + t / 8 of the piece (T threads a group), and
//   all NW outputs of each.
// - Reading A: when a row is whole 16-byte chunks ("vec") a thread reads
//   it 16 bytes at a time. The 8 lanes of a quarter warp, which one
//   shared-memory wavefront serves, read one chunk at one index in 8
//   pieces; an odd number of 16-byte units apart, they fall in 8 distinct
//   16-byte bank groups, so the read is conflict-free at every k. Else (k
//   * size not a multiple of 16) a thread reads aligned 32-bit words and
//   funnel-shifts them into place: conflict-free for f32 at odd k (8
//   pieces at distinct multiples of 4 banks, 4 indices at distinct banks
//   mod 4), 2-way at k = 2 mod 4. B is read as 16-byte words that every
//   lane of a warp takes from one address (one wavefront).
// - f32 and bf16 run f32 FMAs in k order into a running sum (bf16 on
//   mma.sync's tensor cores, 16-row tiles, ran slower than at four rows a
//   thread on the CUDA cores, so it is not used); int8 runs __dp4a on A's
//   row words (four consecutive k values of one row) against B's packed
//   words, exact in int32 (127^2 * 256 << 2^31),
//   converted once and multiplied by the fold (RowFold: sA[row / band] *
//   sB), so the result is bit-equal to the plain version
//   (ref.tsm2l_q8_ref). Each row's fold factor is read before any output
//   is stored. Groups past the first store their partial rows
//   thread-major (conflict-free) and group 0 adds them in group order.
// - Output: group 0 writes its rows' outputs into a shared-memory tile in
//   C's layout, cut like A into 8 pieces an odd
//   number of 16-byte units apart where a piece of C is a whole number of
//   16-byte units (so a quarter warp's 16-byte stores are conflict-free
//   too), and one thread writes each piece back with 1-D cp.async.bulk
//   stores (whole lines, each output once, no atomics; the ragged tail
//   under 16 bytes by plain stores). The next tile's outputs wait only
//   until those stores have read the tile (a second output tile read no
//   faster on the card). A launch repeats its bits.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>

#include "common.cuh"
#include "tma.cuh"
#include "tsm2r_skinny.cuh"

namespace tsm2x {
namespace stream {

constexpr int NC = 128;           // consumer threads a block
constexpr int THREADS = NC + 32;  // and one producer warp
constexpr int PIECES = 8;         // bulk copies a stage of A
constexpr int MAX_WIDTH = 16;
constexpr int MAX_K = 256;
constexpr int STAGE_BYTES = 16384;     // bytes of A a stage aims at
constexpr int SMEM_BYTES = 110 * 1024;  // dynamic shared memory a block
constexpr int MAX_STAGES = 6;
constexpr int ROWS_DEFAULT = 2;
constexpr int BLOCKS_PER_SM = 2;
// Rows a thread of chip_smoke.py's sweep variants (the paper's tcf);
// variant 0 is the default.
constexpr int SWEEP_ROWS[] = {2, 1, 4, 8};
constexpr int SWEEP_N = sizeof(SWEEP_ROWS) / sizeof(SWEEP_ROWS[0]);

// Whether a call takes this body.
inline bool fits(int k, int n, const void* a) {
  return n >= 1 && n <= MAX_WIDTH && k >= 1 && k <= MAX_K &&
         reinterpret_cast<uintptr_t>(a) % 16 == 0;
}

// A launch's geometry, in bytes where not said. core/perf_model.py's
// tsm2l_stream_geometry mirrors it.
struct Plan {
  int rows, groups, bm, bmp;  // rows a thread, k groups, rows a tile, a piece
  int rs, vec, units;         // A a row; 16-byte reads; units a row
  int ps, stage;              // piece stride and stage of A
  int cb, psc, c_bytes;       // C a row, piece stride, tile
  int b_bytes, red_bytes, stages, smem;
};

inline int up16(long x) { return (int)((x + 15) / 16 * 16); }

inline int odd16(long x) {  // up to 16 bytes, then an odd number of them
  const int y = up16(x);
  return (y / 16) % 2 ? y : y + 16;
}

inline int width(int n) {
  int w = 1;
  while (w < n) w *= 2;
  return w;
}

// size, usize: bytes of an element of A and of C; rows: 0 for the
// default.
inline Plan plan(int k, int n, int size, int usize, int rows) {
  Plan p{};
  p.rs = k * size;
  p.vec = p.rs % 16 == 0;
  p.units = p.vec ? p.rs / 16 : (p.rs + 3) / 4;
  const int kp = p.units * (p.vec ? 16 : 4) / size;  // k padded to units
  p.rows = rows > 0 ? rows : p.rs <= 32 ? 4 : p.rs <= 256 ? ROWS_DEFAULT : 1;
  p.groups = 4;
  for (int g = 1; g <= 4; g *= 2)
    if (NC / g * p.rows * p.rs <= STAGE_BYTES) {
      p.groups = g;
      break;
    }
  while (p.groups > 1 &&
         (p.groups > p.units ||
          (long)(NC / p.groups * p.rows / PIECES) * p.rs % 16 != 0))
    p.groups /= 2;
  p.bm = NC / p.groups * p.rows;
  p.bmp = p.bm / PIECES;
  p.ps = odd16((long)p.bmp * p.rs);
  p.stage = PIECES * p.ps;
  const int nw = width(n);
  p.b_bytes = up16(size > 1 ? (long)kp * nw * 4 : (long)(kp + 3) / 4 * nw * 4);
  p.cb = n * usize;
  const bool pieced = (long)p.bmp * p.cb % 16 == 0;
  p.psc = pieced ? odd16((long)p.bmp * p.cb) : p.bmp * p.cb;
  p.c_bytes = pieced ? PIECES * p.psc : up16((long)p.bm * p.cb);
  p.red_bytes = (p.groups - 1) * p.bm * nw * 4;
  // 128 bytes to align the ring, 16 after it for the word reads' overrun.
  const int fixed = p.c_bytes + p.b_bytes + p.red_bytes + 128 + 16;
  const int st = (SMEM_BYTES - fixed) / p.stage;
  p.stages = st < 2 ? 2 : st > MAX_STAGES ? MAX_STAGES : st;
  p.smem = p.stages * p.stage + fixed;
  return p;
}

// Persistent blocks over the row tiles, given the card's SM count.
inline int blocks(int m, const Plan& p, int sms) {
  const long tiles = ((long)m + p.bm - 1) / p.bm;
  const long most = (long)BLOCKS_PER_SM * sms;
  return (int)(tiles < most ? tiles : most);
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(tma::smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(tma::smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
          dst),
      "r"(tma::smem_u32(src)), "r"(bytes)
      : "memory");
}

// `bytes` from shared src to global dst: the whole 16-byte multiple by one
// bulk store (both 16-byte aligned), the rest by plain stores.
__device__ __forceinline__ void store_piece(uint8_t* dst, const uint8_t* src,
                                            int bytes) {
  const int bulk = bytes & ~15;
  if (bulk > 0) bulk_store(dst, src, bulk);
  for (int b = bulk; b < bytes; ++b) dst[b] = src[b];
}

// The output tile of rows [row0, row0 + rows) from shared memory (cst,
// cut in pieces of p.bmp rows p.psc bytes apart, or one piece) to C, and
// commit the stores as one bulk group.
template <typename U>
__device__ __forceinline__ void store_tile(U* C, const uint8_t* cst,
                                           long row0, int rows,
                                           const Plan& p) {
  uint8_t* c8 = reinterpret_cast<uint8_t*>(C) + row0 * p.cb;
  if (p.psc == p.bmp * p.cb) {  // one piece: the tile as it lies in C
    store_piece(c8, cst, rows * p.cb);
  } else {
    for (int q = 0; q < PIECES; ++q) {
      const int r0 = q * p.bmp;
      const int rq = rows - r0 < 0 ? 0 : rows - r0 < p.bmp ? rows - r0
                                                            : p.bmp;
      store_piece(c8 + (long)r0 * p.cb, cst + q * p.psc, rq * p.cb);
    }
  }
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Value e of a 32-bit word of A (f32: the word; bf16: its halves).
template <typename T>
__device__ __forceinline__ float word_value(uint32_t w, int e) {
  if constexpr (std::is_same<T, float>::value) {
    (void)e;
    return __uint_as_float(w);
  } else {
    return __uint_as_float(e % 2 ? (w & 0xffff0000u) : (w << 16));
  }
}

// One row's NW outputs into the shared output tile at dst (n == NW: one
// store a 16 bytes, or one narrower store; else element by element).
template <typename U, int NW>
__device__ __forceinline__ void put_row(uint8_t* dst, const float (&v)[NW],
                                        int n) {
  if (n != NW) {
#pragma unroll
    for (int j = 0; j < NW; ++j)
      if (j < n) reinterpret_cast<U*>(dst)[j] = from_f32<U>(v[j]);
    return;
  }
  constexpr int BYTES = NW * (int)sizeof(U);
  uint32_t w[(BYTES + 3) / 4];
  if constexpr (sizeof(U) == 4) {
#pragma unroll
    for (int j = 0; j < NW; ++j) w[j] = __float_as_uint(v[j]);
  } else {
    if constexpr (NW == 1) {
      *reinterpret_cast<__nv_bfloat16*>(dst) = from_f32<U>(v[0]);
      return;
    } else {
#pragma unroll
      for (int j = 0; j < NW; j += 2) w[j / 2] = bf16_pair(v[j], v[j + 1]);
    }
  }
  if constexpr (BYTES >= 16) {
#pragma unroll
    for (int q = 0; q < BYTES / 16; ++q)
      reinterpret_cast<uint4*>(dst)[q] =
          make_uint4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
  } else if constexpr (BYTES == 8) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  } else {
    *reinterpret_cast<uint32_t*>(dst) = w[0];
  }
}

// The kernel: persistent blocks over the row tiles of A[m,k] @ B[k,n] into
// C (row stride n) as U, each output through fold(row, value). Launched
// with THREADS threads and p.smem bytes of dynamic shared memory.
template <typename T, typename U, int NW, int R, bool VEC, typename F>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    tsm2l_stream_kernel(const T* __restrict__ A, const T* __restrict__ B,
                        U* __restrict__ C, int m, int k, int n, const Plan p,
                        const F fold) {
  constexpr bool Q8 = std::is_same<T, int8_t>::value;
  using I = skinny::In<T>;
  extern __shared__ uint8_t stream_smem[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES], empty[MAX_STAGES];
  const uint32_t raw = tma::smem_u32(stream_smem);
  uint8_t* ring = stream_smem + (((raw + 127) & ~127u) - raw);
  uint8_t* cst = ring + p.stages * p.stage + 16;  // the output tile
  float* bs = reinterpret_cast<float*>(cst + p.c_bytes);
  uint32_t* red = reinterpret_cast<uint32_t*>(
      reinterpret_cast<uint8_t*>(bs) + p.b_bytes);
  const int tid = threadIdx.x;
  const long tiles = ((long)m + p.bm - 1) / p.bm;

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      tma::mbar_init(&full[s], 1);         // the producer's arrival
      tma::mbar_init(&empty[s], NC / 32);  // one a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // B, once a block, zero past k and n.
  if constexpr (Q8) {
    const int words = p.b_bytes / 4;
    for (int idx = tid; idx < words; idx += THREADS) {
      const int q = idx / NW, j = idx % NW;
      uint32_t wv = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int kk = 4 * q + b;
        if (kk < k && j < n)
          wv |= (uint32_t)(uint8_t)B[(long)kk * n + j] << (8 * b);
      }
      reinterpret_cast<uint32_t*>(bs)[idx] = wv;
    }
  } else {
    const int words = p.b_bytes / 4;
    for (int idx = tid; idx < words; idx += THREADS) {
      const int kk = idx / NW, j = idx % NW;
      bs[idx] = (kk < k && j < n) ? to_f32(B[(long)kk * n + j]) : 0.f;
    }
  }
  __syncthreads();

  if (tid >= NC) {  // the producer: one thread copies every stage
    if (tid != NC) return;
    const uint8_t* a8 = reinterpret_cast<const uint8_t*>(A);
    int s = 0;
    uint32_t lap = 0;
    for (long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      // Round r of stage s waits for the consumers' release of round
      // r - 1; round 0 passes at once (parity 1 of a fresh barrier).
      tma::mbar_wait(&empty[s], (lap & 1) ^ 1);
      uint8_t* st = ring + s * p.stage;
      const long row0 = tile * p.bm;
      const int rows = m - row0 < p.bm ? (int)(m - row0) : p.bm;
      uint32_t total = 0;
      for (int q = 0; q < PIECES; ++q) {
        const int r0 = q * p.bmp;
        const int rq = rows - r0 < 0 ? 0 : rows - r0 < p.bmp ? rows - r0
                                                              : p.bmp;
        const int bytes = rq * p.rs, bulk = bytes & ~15;
        total += bulk;
        const uint8_t* src = a8 + (row0 + r0) * p.rs;
        for (int b = bulk; b < bytes; ++b) st[q * p.ps + b] = src[b];
      }
      tma::mbar_expect_tx(&full[s], total);  // the tails' stores released
      for (int q = 0; q < PIECES; ++q) {
        const int r0 = q * p.bmp;
        const int rq = rows - r0 < 0 ? 0 : rows - r0 < p.bmp ? rows - r0
                                                              : p.bmp;
        const int bulk = (rq * p.rs) & ~15;
        if (bulk > 0)
          bulk_load(st + q * p.ps, a8 + (row0 + r0) * p.rs, bulk, &full[s]);
      }
      if (++s == p.stages) s = 0, ++lap;
    }
    return;
  }

  const int tpg = NC / p.groups;
  const int g = tid / tpg, t = tid % tpg, lane = tid % 32;
  int aoff[R], coff[R], row[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int idx = i * (tpg / 8) + t / 8;
    row[i] = (t % 8) * p.bmp + idx;
    aoff[i] = (t % 8) * p.ps + idx * p.rs;
    coff[i] = (t % 8) * p.psc + idx * p.cb;
  }
  const int per = (p.units + p.groups - 1) / p.groups;
  const int u0 = g * per < p.units ? g * per : p.units;
  const int u1 = u0 + per < p.units ? u0 + per : p.units;
  using Acc = typename std::conditional<Q8, int, float>::type;
  const uint32_t* bw = reinterpret_cast<const uint32_t*>(bs);

  int s = 0;
  uint32_t lap = 0;
  for (long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long row0 = tile * p.bm;
    const int rows = m - row0 < p.bm ? (int)(m - row0) : p.bm;
    tma::mbar_wait(&full[s], lap & 1);
    const uint8_t* st = ring + s * p.stage;
    Acc acc[R][NW];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < NW; ++j) acc[i][j] = 0;

    if constexpr (VEC) {
      auto chunk = [&](int u) {  // the 16-byte chunk u of each row
        uint4 av[R];
#pragma unroll
        for (int i = 0; i < R; ++i)
          av[i] = *reinterpret_cast<const uint4*>(st + aoff[i] + u * 16);
        if constexpr (Q8) {
          auto word = [&](int e) {  // the chunk's word e: 4 k values
            int b[NW];
            skinny::b_words<NW>(bw + (u * 4 + e) * NW, b);
#pragma unroll
            for (int i = 0; i < R; ++i) {
              const int a = (int)skinny::word(av[i], e);
#pragma unroll
              for (int j = 0; j < NW; ++j)
                acc[i][j] = __dp4a(a, b[j], acc[i][j]);
            }
          };
          // At four rows a thread the int32 sums take 64 registers: one
          // word's B at a time, else its loads for all four spill.
          if constexpr (R <= 2) {
#pragma unroll
            for (int e = 0; e < 4; ++e) word(e);
          } else {
#pragma unroll 1
            for (int e = 0; e < 4; ++e) word(e);
          }
        } else {
#pragma unroll
          for (int e = 0; e < I::CK; ++e) {
            float b[NW];
            skinny::b_row<NW>(bs + (u * I::CK + e) * NW, b);
#pragma unroll
            for (int i = 0; i < R; ++i) {
              const float a = I::at(av[i], e);
#pragma unroll
              for (int j = 0; j < NW; ++j)
                acc[i][j] = fmaf(a, b[j], acc[i][j]);
            }
          }
        }
      };
      // Two chunks in flight at R <= 2; fatter threads hold enough
      // registers with one.
      if constexpr (R <= 2) {
#pragma unroll 2
        for (int u = u0; u < u1; ++u) chunk(u);
      } else {
#pragma unroll 1
        for (int u = u0; u < u1; ++u) chunk(u);
      }
    } else {
      // 32-bit words of each row, funnel-shifted from the aligned words
      // around them (f32 rows are word-aligned: a shift of 0).
      const uint8_t* base[R];
      uint32_t lo[R];
      int sh[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        base[i] = st + (aoff[i] & ~3);
        sh[i] = (aoff[i] & 3) * 8;
        lo[i] = lds32(base[i] + 4 * u0);
      }
      for (int u = u0; u < u1; ++u) {
        uint32_t w[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const uint32_t hi = lds32(base[i] + 4 * u + 4);
          w[i] = __funnelshift_r(lo[i], hi, sh[i]);
          lo[i] = hi;
        }
        if constexpr (Q8) {  // four k values a word; B is zero past k
          int b[NW];
          skinny::b_words<NW>(bw + u * NW, b);
#pragma unroll
          for (int i = 0; i < R; ++i)
#pragma unroll
            for (int j = 0; j < NW; ++j)
              acc[i][j] = __dp4a((int)w[i], b[j], acc[i][j]);
        } else {
          constexpr int VPW = 4 / (int)sizeof(T);
#pragma unroll
          for (int e = 0; e < VPW; ++e) {
            const int kk = u * VPW + e;
            float b[NW];
            skinny::b_row<NW>(bs + kk * NW, b);
#pragma unroll
            for (int i = 0; i < R; ++i) {
              // Past k the word holds the next row's bytes: taken as 0.
              const float a = kk < k ? word_value<T>(w[i], e) : 0.f;
#pragma unroll
              for (int j = 0; j < NW; ++j)
                acc[i][j] = fmaf(a, b[j], acc[i][j]);
            }
          }
        }
      }
    }
    __syncwarp();  // the warp's reads of stage s are done
    if (lane == 0) tma::mbar_arrive(&empty[s]);
    if (++s == p.stages) s = 0, ++lap;

    // The previous tile's stores have read the output tile before anyone
    // writes it again; groups past the first hand their rows to group 0.
    if (tid == 0)
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    if (g > 0) {
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < NW; ++j) {
          uint32_t x;
          if constexpr (Q8)
            x = (uint32_t)acc[i][j];
          else
            x = __float_as_uint(acc[i][j]);
          red[(((g - 1) * R + i) * NW + j) * tpg + t] = x;
        }
    }
    skinny::consumers_sync(NC);
    if (g == 0) {
      // Each row's fold factor (1, or sA[row / band] * sB: fold(row, 1)
      // is that factor, exactly), read before any output is stored so
      // the loads need not wait behind the stores; a row past m is not
      // stored.
      float scale[R];
#pragma unroll
      for (int i = 0; i < R; ++i)
        scale[i] = row[i] < rows ? fold(row0 + row[i], 1.f) : 0.f;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (row[i] >= rows) continue;
        float v[NW];
#pragma unroll
        for (int j = 0; j < NW; ++j) {
          Acc sum = acc[i][j];
          for (int q = 1; q < p.groups; ++q) {
            const uint32_t x = red[(((q - 1) * R + i) * NW + j) * tpg + t];
            if constexpr (Q8)
              sum += (int)x;
            else
              sum += __uint_as_float(x);
          }
          float f;
          if constexpr (Q8)
            f = __int2float_rn(sum);
          else
            f = sum;
          v[j] = f * scale[i];
        }
        put_row<U, NW>(cst + coff[i], v, n);
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    }
    skinny::consumers_sync(NC);
    if (tid == 0) store_tile(C, cst, row0, rows, p);
  }
  // Kernel completion makes the bulk stores visible; the block waits
  // only until they have read its shared memory.
  if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// Persistent blocks of `p` on the current card, or a cudaError_t (< 0 as
// its negation).
inline int blocks_here(int m, const Plan& p) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return err == cudaSuccess ? blocks(m, p, sms) : -(int)err;
}

// One instantiation of the kernel at plan p.
template <typename T, typename U, int NW, int R, bool VEC, typename F>
int launch_at(const T* a, const T* b, U* c, int m, int k, int n, F fold,
              const Plan& p, cudaStream_t stream) {
  const int grid = blocks_here(m, p);
  if (grid <= 0) return -grid;
  auto kern = tsm2l_stream_kernel<T, U, NW, R, VEC, F>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, THREADS, p.smem, stream>>>(a, b, c, m, k, n, p, fold);
  return (int)cudaGetLastError();
}

// Launch the body for A[m,k] @ B[k,n] into C at the plan's rows a thread
// (1, 2 or 4). Returns the cudaError_t of the launch, or
// cudaErrorInvalidValue when the call does not fit or C is not 16-byte
// aligned.
template <typename T, typename U, typename F>
int launch(const T* a, const T* b, U* c, int m, int k, int n, F fold,
           cudaStream_t stream) {
  if (!fits(k, n, a) || reinterpret_cast<uintptr_t>(c) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(k, n, sizeof(T), sizeof(U), 0);
  return skinny::with_width(n, [&](auto w) {
    constexpr int NW = decltype(w)::value;
    auto go = [&](auto r) {
      constexpr int R = decltype(r)::value;
      return p.vec ? launch_at<T, U, NW, R, true>(a, b, c, m, k, n, fold, p,
                                                  stream)
                   : launch_at<T, U, NW, R, false>(a, b, c, m, k, n, fold,
                                                   p, stream);
    };
    return p.rows == 1   ? go(std::integral_constant<int, 1>{})
           : p.rows == 2 ? go(std::integral_constant<int, 2>{})
                         : go(std::integral_constant<int, 4>{});
  });
}

// The body and geometry of a call on `sms` SMs: out = {1 (stream), grid x,
// 1, 1, rows a thread, groups, rows a tile, stages}.
inline void plan_query(int m, int k, int n, int size, int usize, int sms,
                       int* out) {
  const Plan p = plan(k, n, size, usize, 0);
  out[0] = 1, out[1] = blocks(m, p, sms), out[2] = 1, out[3] = 1;
  out[4] = p.rows, out[5] = p.groups, out[6] = p.bm, out[7] = p.stages;
}

}  // namespace stream

// The body, grid and geometry of a tsm2l or tsm2l_q8 call on the current
// card (size, usize: bytes of an element of A and of C): out = {body (0
// tile, 1 stream), grid x, y, z, rows a thread, groups, rows a tile,
// stages}; for the tile body its table's row and column tiles and {0, 0,
// BM, 0}. Returns a cudaError_t.
inline int tsm2l_plan_query(int m, int k, int n, int size, int usize,
                            const void* a, int* out) {
  if (stream::fits(k, n, a)) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    stream::plan_query(m, k, n, size, usize, sms, out);
    return 0;
  }
  return with_tsm2l_tile(n, [&](auto tile) {
    using Tl = decltype(tile);
    out[0] = 0, out[1] = (int)(((long)m + Tl::BM - 1) / Tl::BM);
    out[2] = (n + Tl::BN - 1) / Tl::BN, out[3] = 1;
    out[4] = 0, out[5] = 0, out[6] = Tl::BM, out[7] = 0;
    return 0;
  });
}

}  // namespace tsm2x
