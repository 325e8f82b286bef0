// The binary adaptive model of the bin and apm codecs (bin_encode.cu,
// bin_decode.cu).
//
// p0 is the probability of a 0 bit scaled by 2^bits (bin.rs); with the
// APM gate (apm.rs) it is refined through 33 cells of 12 bits by linear
// interpolation, and the range split's denominator is 2^12.  Formats:
// tpuzip.oracle.ari BinaryModel / ApmGate.

#pragma once

#include <cstdint>

namespace bin {

constexpr uint32_t TOP = 1u << 24;
constexpr uint32_t BOT = 1u << 16;
constexpr int CHUNK_BYTES = 32;   // 256 bits per chunk-index entry
constexpr int APM_BITS = 12;
constexpr int APM_SLOTS = 33;
constexpr int APM_RATE = 5;

// The shift update of a probability of 0 scaled by 2^bits.
__device__ __forceinline__ int adapt(int p, int bit, int bits, int rate) {
  const int top = 1 << bits;
  p = bit ? p - (p >> rate) : p + ((top - p) >> rate);
  return min(max(p, 1), top - 1);
}

// APM gate cell s as it starts.
__device__ __forceinline__ int cell_init(int s) {
  return min(max(s * (1 << APM_BITS) / (APM_SLOTS - 1), 1),
             (1 << APM_BITS) - 1);
}

}  // namespace bin
