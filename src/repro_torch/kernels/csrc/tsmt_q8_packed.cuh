// The packed int8 TSMT block body, shared by tsmt_q8.cu and
// tsmt_q8_split.cu for outputs at most 16 wide: one (BA x BB) output tile
// of sum over the bands j of [lo, hi) of int32(X8[j]^T Y8[j]) * sX[j] *
// sY[j], written as U at C[a][b] (row stride b_dim).
//
// What it fixes in common.cuh's tsmt_block at the int8 load type: that
// body loads one byte of X a thread and a warp load moves one 32-byte
// sector, keeps 16 bytes of X a thread in flight, and does one integer
// multiply-add a product; at PowerSGD's Q it ran at 30% of its bytes
// bound, and at core/perf_model.py's multiply-add rate the products alone
// take 80% of that bound's time.
//
// Design, 256 threads a block and the tile table of with_tsmt_tile:
// - Each thread owns AW consecutive a columns (8 bytes by default: one
//   uint2 of a row of X) and BW = 4 b columns (one 32-bit word of a row of
//   Y, a broadcast among the threads that share it). At b <= 4 (a 128 x 4
//   tile) 16 threads cover the tile's 128 bytes of a row and form a group;
//   at b <= 16 (64 x 16) 8 x 4 threads do. G = 256 / (group size) groups.
// - Within each band, group g takes the 4-row packets g, g + G, g + 2G,
//   ... (packet p = rows c0 + 4p .. c0 + 4p + 3), so a warp load covers
//   one or two whole 128-byte rows of the tile. RU rows (RU / 4 packets)
//   are loaded into registers before any is multiplied: 16 by default,
//   128 bytes of X a thread, 64 KB an SM at two blocks (at b <= 4 one
//   iteration takes a whole 256-row band). Half that, the bytes in
//   flight of the f32 build, ran 7% slower at PowerSGD's Q on an H100
//   80GB HBM3 at 700 W (PERF.md §6, chip_smoke.py's tsmt_q8_sweep).
// - A packet's four words of one a column group are turned into four
//   words that each hold four rows of one a column (a 4 x 4 byte
//   transpose, 8 prmt); Y's four row words likewise into its b columns.
//   Then acc[i][j] = __dp4a(xcol[i], ycol[j], acc[i][j]): four products
//   an instruction. A row past the band's end or past the tile's columns
//   loads as zero, which adds nothing exactly.
// - Numerics as tsmt_block's: each thread sums its rows of one band
//   exactly in int32 (at most 256 * 127^2 per band), converts the sum
//   once and multiplies it by sX[band] * sY[band] (BandFold) before it
//   adds it to its f32 tile. The G group tiles are summed through shared
//   memory in group order, no atomics: a repeat gives the same bits.
// nvcc --resource-usage (sm_90a; chip_smoke.py's resources line): 128
// registers a thread at the default, the launch bounds' cap for two
// blocks of 256 threads an SM, no spills; 32 KB of static shared memory
// for the group tiles (8 x 4 outputs a thread).
// fits() is the rule that picks this body: b in {4, 8, 12, 16}, a a
// multiple of 16 bytes, X and Y 16-byte aligned. It depends on neither m
// nor the slice, so tsmt_q8 and tsmt_q8_split always take the same body
// for the same operands.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace tsm2x {
namespace packed {

constexpr int NT = 256;   // threads a block, every TSMT tile
constexpr int BW = 4;     // b columns a thread: one word of a row of Y
constexpr int AW_DEFAULT = 8, RU_DEFAULT = 16;

// The sweep's variants, (AW, RU): bytes of a row of X a thread, rows a
// thread loads before it multiplies. The first is the default; the
// second and third keep half its bytes in flight.
constexpr int SWEEP[][2] = {{8, 16}, {8, 8}, {4, 16}, {4, 32}};
constexpr int N_SWEEP = sizeof(SWEEP) / sizeof(SWEEP[0]);

inline bool fits(int a_dim, int b_dim, const void* x, const void* y) {
  return a_dim > 0 && a_dim % 16 == 0 && b_dim >= 4 && b_dim <= 16 &&
         b_dim % 4 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0;
}

// f(integral_constant AW, integral_constant RU) for sweep variant i.
template <typename F>
int with_variant(int i, F&& f) {
  switch (i) {
    case 0: return f(std::integral_constant<int, SWEEP[0][0]>{},
                     std::integral_constant<int, SWEEP[0][1]>{});
    case 1: return f(std::integral_constant<int, SWEEP[1][0]>{},
                     std::integral_constant<int, SWEEP[1][1]>{});
    case 2: return f(std::integral_constant<int, SWEEP[2][0]>{},
                     std::integral_constant<int, SWEEP[2][1]>{});
    case 3: return f(std::integral_constant<int, SWEEP[3][0]>{},
                     std::integral_constant<int, SWEEP[3][1]>{});
  }
  return (int)cudaErrorInvalidValue;
}

// t[k] = byte k of each of w[0..3], byte u of t[k] from w[u].
__device__ __forceinline__ void transpose4(const uint32_t (&w)[4],
                                           uint32_t (&t)[4]) {
  const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t hi01 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t hi23 = __byte_perm(w[2], w[3], 0x7362);
  t[0] = __byte_perm(lo01, lo23, 0x5410);
  t[1] = __byte_perm(lo01, lo23, 0x7632);
  t[2] = __byte_perm(hi01, hi23, 0x5410);
  t[3] = __byte_perm(hi01, hi23, 0x7632);
}

// W words from p (aligned to 4 * W bytes), or zeros unless ok.
template <int W>
__device__ __forceinline__ void load_words(const int8_t* p, bool ok,
                                           uint32_t (&w)[W]) {
  if constexpr (W == 1) {
    w[0] = ok ? *reinterpret_cast<const uint32_t*>(p) : 0u;
  } else if constexpr (W == 2) {
    const uint2 v = ok ? *reinterpret_cast<const uint2*>(p) : make_uint2(0, 0);
    w[0] = v.x, w[1] = v.y;
  } else {
    static_assert(W == 4, "1, 2 or 4 words");
    const uint4 v =
        ok ? *reinterpret_cast<const uint4*>(p) : make_uint4(0, 0, 0, 0);
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  }
}

template <typename U, int BA, int BB, int AW, int RU>
__device__ __forceinline__ void block(const int8_t* __restrict__ X,
                                      const int8_t* __restrict__ Y,
                                      U* __restrict__ C, long lo, long hi,
                                      int a_dim, int b_dim,
                                      const BandFold fold) {
  constexpr int TX = BA / AW;     // threads along a
  constexpr int TY = BB / BW;     // threads along b
  constexpr int TPG = TX * TY;    // threads of a group
  constexpr int G = NT / TPG;     // groups
  constexpr int AWW = AW / 4;     // words of a row of X a thread loads
  constexpr int PK = RU / 4;      // packets loaded before any is multiplied
  constexpr int E = AW * BW;      // outputs a thread
  static_assert(BA % AW == 0 && BB % BW == 0 && NT % TPG == 0 && G >= 1 &&
                    RU % 4 == 0 && RU >= 4,
                "packed TSMT tile");
  // The groups' tiles, thread-major (red[g][e][t]: output e of thread t),
  // so that both the stores and the group sum hit distinct banks.
  __shared__ float red[G * E * TPG];

  const int tid = threadIdx.x;
  const int g = tid / TPG, t = tid % TPG;
  const int tx = t % TX, ty = t / TX;
  const int ca = blockIdx.x * BA + tx * AW;   // this thread's first a column
  const int cb = blockIdx.y * BB + ty * BW;   // and first b column
  const bool a_ok = ca < a_dim, b_ok = cb < b_dim;
  TSM2X_BLOCK_RECORD(
      C, tsm2x::block_map::TSMT_PACKED, blockIdx.x * BA,
      blockIdx.x * BA + BA < a_dim ? blockIdx.x * BA + BA : a_dim,
      blockIdx.y * BB,
      blockIdx.y * BB + BB < b_dim ? blockIdx.y * BB + BB : b_dim, lo, hi, 4,
      1);
  const int8_t* xp = X + ca;
  const int8_t* yp = Y + cb;

  float acc[AW][BW];
#pragma unroll
  for (int i = 0; i < AW; ++i)
#pragma unroll
    for (int j = 0; j < BW; ++j) acc[i][j] = 0.f;

  long band = lo / fold.band;   // lo starts a band
  for (long c0 = lo; c0 < hi; c0 += fold.band, ++band) {
    const long c1 = c0 + fold.band < hi ? c0 + fold.band : hi;
    int run[AW][BW];
#pragma unroll
    for (int i = 0; i < AW; ++i)
#pragma unroll
      for (int j = 0; j < BW; ++j) run[i][j] = 0;
    for (long r = c0 + 4 * g; r < c1; r += 4L * G * PK) {
      uint32_t xw[PK][4][AWW], yw[PK][4];
#pragma unroll
      for (int p = 0; p < PK; ++p)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const long row = r + 4L * G * p + u;
          const bool live = row < c1;
          load_words<AWW>(xp + row * a_dim, live && a_ok, xw[p][u]);
          uint32_t y1[1];
          load_words<1>(yp + row * b_dim, live && b_ok, y1);
          yw[p][u] = y1[0];
        }
#pragma unroll
      for (int p = 0; p < PK; ++p) {
        uint32_t yc[4];
        transpose4(yw[p], yc);
#pragma unroll
        for (int q = 0; q < AWW; ++q) {
          const uint32_t w[4] = {xw[p][0][q], xw[p][1][q], xw[p][2][q],
                                 xw[p][3][q]};
          uint32_t xc[4];
          transpose4(w, xc);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < BW; ++j)
              run[4 * q + i][j] =
                  __dp4a((int)xc[i], (int)yc[j], run[4 * q + i][j]);
        }
      }
    }
    // BandFold's arithmetic, v * (sX[band] * sY[band]), without its
    // division of the row by the band.
    const float scale = fold.sx[band] * fold.sy[band];
#pragma unroll
    for (int i = 0; i < AW; ++i)
#pragma unroll
      for (int j = 0; j < BW; ++j)
        acc[i][j] += static_cast<float>(run[i][j]) * scale;
  }

  // Fixed-order sum of the G group tiles: output e = i * BW + j of thread
  // t is a0 + tx * AW + i, b0 + ty * BW + j.
#pragma unroll
  for (int i = 0; i < AW; ++i)
#pragma unroll
    for (int j = 0; j < BW; ++j)
      red[(g * E + i * BW + j) * TPG + t] = acc[i][j];
  __syncthreads();
  for (int idx = tid; idx < E * TPG; idx += NT) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < G; ++q) s += red[q * E * TPG + idx];
    const int e = idx / TPG, tt = idx % TPG;
    const int ga = blockIdx.x * BA + (tt % TX) * AW + e / BW;
    const int gb = blockIdx.y * BB + (tt / TX) * BW + e % BW;
    if (ga < a_dim && gb < b_dim) C[(long)ga * b_dim + gb] = from_f32<U>(s);
  }
}

}  // namespace packed
}  // namespace tsm2x
