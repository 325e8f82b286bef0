// The adaptive order-0 model of the ari codec, held by one warp.
//
// Lane l keeps entries 8l .. 8l+7 of the INCLUSIVE cumulative frequency
// table C (C[255] == total) as eight u32 registers.  Unpacked u32 entries
// take any knobs with threshold + increment <= 2^16, the bound of the
// range coder itself (the TPU kernels' u16-pair packing stopped at 2^15).
// Every function here is called by all 32 lanes with warp-uniform
// arguments, so the shuffles are always full-warp.

#pragma once

#include <cstdint>

namespace ari {

constexpr uint32_t TOP = 1u << 24;
constexpr uint32_t BOT = 1u << 16;
constexpr unsigned FULL = 0xffffffffu;
constexpr int CHUNK_STEPS = 64;   // symbols per chunk-index entry

// c[j] for a warp-uniform j, as a chain of selects: the table stays in
// registers (a dynamic index would send it to local memory).
__device__ __forceinline__ uint32_t pick(const uint32_t (&c)[8], int j) {
  uint32_t v = c[0];
#pragma unroll
  for (int k = 1; k < 8; ++k) v = (j == k) ? c[k] : v;
  return v;
}

__device__ __forceinline__ void init(uint32_t (&c)[8], int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) c[j] = 8u * lane + j + 1;   // C[k] = k+1
}

// C[s] for a warp-uniform s in [0, 256).
__device__ __forceinline__ uint32_t cum_at(const uint32_t (&c)[8], int s) {
  return __shfl_sync(FULL, pick(c, s & 7), s >> 3);
}

// freq[sym] += inc  <=>  C[k] += inc for every k >= sym: one add a lane.
__device__ __forceinline__ void add(uint32_t (&c)[8], int lane, int sym,
                                    uint32_t inc) {
#pragma unroll
  for (int j = 0; j < 8; ++j) c[j] += (8 * lane + j >= sym) ? inc : 0u;
}

// The inclusive cumulative table of the frequencies f (lane l holds
// f[8l .. 8l+7]): eight sums in the lane, then a warp scan of the lane
// totals.  Returns this lane's inclusive total (lane 31's is the table's).
__device__ __forceinline__ uint32_t prefix(uint32_t (&c)[8],
                                           const uint32_t (&f)[8], int lane) {
  uint32_t run = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    run += f[j];
    c[j] = run;
  }
  uint32_t incl = run;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += y;
  }
  const uint32_t excl = incl - run;
#pragma unroll
  for (int j = 0; j < 8; ++j) c[j] += excl;
  return incl;
}

// The oracle's downscale: every frequency f -> (f+1)>>1, then the table is
// summed again with prefix().  Returns the new total.
__device__ __forceinline__ uint32_t halve(uint32_t (&c)[8], int lane) {
  uint32_t prev = __shfl_up_sync(FULL, c[7], 1);
  if (lane == 0) prev = 0;
  uint32_t f[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) f[j] = (c[j] - (j ? c[j - 1] : prev) + 1) >> 1;
  return __shfl_sync(FULL, prefix(c, f, lane), 31);
}

// Model update after coding sym: add, then halve once the total reaches
// the threshold.  Returns the new total.
__device__ __forceinline__ uint32_t update(uint32_t (&c)[8], int lane,
                                           int sym, uint32_t tot,
                                           uint32_t inc, uint32_t threshold) {
  add(c, lane, sym, inc);
  tot += inc;
  return tot >= threshold ? halve(c, lane) : tot;
}

}  // namespace ari
