// Block records of the dataflow build: what each block of a kernel writes
// and sums, as the kernel itself computes it.
//
// Built with -DTSM2X_BLOCK_MAP (kernels/_build.py's block-map libraries),
// thread 0 of each block appends one Record for every output tile it
// visits to a device buffer that tsm2x_block_map() points the library at:
// two u64 words, the count of records appended and the capacity, then the
// records. A record past the capacity is counted and dropped. Without the
// flag TSM2X_BLOCK_RECORD expands to nothing, its arguments are never
// evaluated, and the kernels compute what they compute without it.
// analysis/kernel_verify.py states the same records from the port's plans
// (block_map); chip_smoke.py's dataflow phase holds the two against each
// other set for set.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace tsm2x {
namespace block_map {

// The body a record comes from (kernel_verify.BODY_CODES).
enum Body : int {
  TSM2R_SIMT = 1,      // common.cuh tsm2r_block (tsm2r, tsm2r_split, int8)
  TSM2R_WGMMA = 2,     // tsm2r_wgmma.cuh
  TSM2R_Q8_WGMMA = 3,  // tsm2r_q8_wgmma.cuh
  SKINNY = 4,          // tsm2r_skinny.cuh body (f32, bf16, int8)
  TSM2L_TILE = 5,      // common.cuh tsm2l_kernel
  TSM2L_STREAM = 6,    // tsm2l_stream.cuh
  TSMT_SIMT = 7,       // common.cuh tsmt_block
  TSMT_PACKED = 8,     // tsmt_q8_packed.cuh block
  TSMT_FINAL = 9,      // common.cuh tsmt_slices_run: the last block's sum
  REDUCE = 10,         // reduce.cu sum_partials_kernel
  QUANT_ABSMAX = 11,   // quantize.cu: a chunk's absmax into its band
  QUANT_CODES = 12,    // quantize.cu: a chunk's codes
  QUANT_KMAJOR = 13,   // quantize.cu: a 64 x 64 tile of K-major codes
  QUANT_SCALES = 14,   // quantize.cu: block 0's scales
  TRANSPOSE = 15,      // tsm2r_q8.cu: a 64 x 64 tile of the int8 copy
};

// One visit of a block to one output tile: rows [r0, r1) and columns
// [c0, c1) of the matrix that starts at dst (row stride: the output's
// columns; flat buffers have one column), summed over the reduction
// [lo, hi), with an accumulator of acc_bytes bytes (acc_int: an integer
// type; 0 bytes for a pass that sums nothing). final_: the block summed
// the tile's slices into C (ticket: the ticket it drew). tile: the loop's
// tile index of a persistent body (-1 elsewhere).
struct Record {
  unsigned long long dst;
  int body, bx, by, bz, gx, gy, gz;
  int r0, r1, c0, c1, lo, hi;
  int acc_bytes, acc_int, final_, ticket, tile;
};
static_assert(sizeof(Record) == 80, "kernel_verify.RECORD_DTYPE");

template <typename A>
__host__ __device__ constexpr int acc_bytes() {
  return (int)sizeof(A);
}
template <typename A>
__host__ __device__ constexpr int acc_int() {
  return std::is_integral<A>::value ? 1 : 0;
}

#ifdef TSM2X_BLOCK_MAP
__device__ unsigned long long* g_map = nullptr;

__device__ __forceinline__ void record(const void* dst, int body, long r0,
                                       long r1, long c0, long c1, long lo,
                                       long hi, int bytes, int is_int,
                                       int final_ = 0, int ticket = 0,
                                       long tile = -1) {
  unsigned long long* m = g_map;
  if (m == nullptr) return;
  const unsigned long long i = atomicAdd(m, 1ull);
  if (i >= m[1]) return;
  Record* r = reinterpret_cast<Record*>(m + 2) + i;
  r->dst = reinterpret_cast<unsigned long long>(dst);
  r->body = body;
  r->bx = blockIdx.x, r->by = blockIdx.y, r->bz = blockIdx.z;
  r->gx = gridDim.x, r->gy = gridDim.y, r->gz = gridDim.z;
  r->r0 = (int)r0, r->r1 = (int)r1, r->c0 = (int)c0, r->c1 = (int)c1;
  r->lo = (int)lo, r->hi = (int)hi;
  r->acc_bytes = bytes, r->acc_int = is_int;
  r->final_ = final_, r->ticket = ticket, r->tile = (int)tile;
}
#endif

}  // namespace block_map
}  // namespace tsm2x

#ifdef TSM2X_BLOCK_MAP
#define TSM2X_BLOCK_RECORD(...)                                     \
  do {                                                              \
    if (threadIdx.x == 0) ::tsm2x::block_map::record(__VA_ARGS__);  \
  } while (0)

// Points this library's records at buf (null: record nothing). Returns a
// cudaError_t.
extern "C" int tsm2x_block_map(void* buf) {
  unsigned long long* p = static_cast<unsigned long long*>(buf);
  return (int)cudaMemcpyToSymbol(::tsm2x::block_map::g_map, &p, sizeof(p));
}
#else
#define TSM2X_BLOCK_RECORD(...) \
  do {                          \
  } while (0)
#endif
