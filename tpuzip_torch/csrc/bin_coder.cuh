// The binary adaptive model of the bin and apm codecs, held by one thread.
//
// p0 is the probability of a 0 bit scaled by 2^bits (bin.rs); with the
// APM gate (apm.rs) it is refined through 33 cells of 12 bits by linear
// interpolation, and the range split's denominator is 2^12.  The cells of
// a block's streams live in shared memory, laid out [slot][thread], so a
// slot picked at run time is an address and not a register index (which
// would spill).  Formats: tpuzip.oracle.ari BinaryModel / ApmGate.

#pragma once

#include <cstdint>

namespace bin {

constexpr uint32_t TOP = 1u << 24;
constexpr uint32_t BOT = 1u << 16;
constexpr int CHUNK_BYTES = 32;   // 256 bits per chunk-index entry
constexpr int APM_BITS = 12;
constexpr int APM_SLOTS = 33;
constexpr int APM_RATE = 5;
constexpr int THREADS = 32;       // streams a block

// The shift update of a probability of 0 scaled by 2^bits.
__device__ __forceinline__ int adapt(int p, int bit, int bits, int rate) {
  const int top = 1 << bits;
  p = bit ? p - (p >> rate) : p + ((top - p) >> rate);
  return min(max(p, 1), top - 1);
}

template <bool USE_APM>
struct Model {
  int p0, bits, rate;
  int* gate;   // this thread's column: slot s at gate[s * THREADS]
  int last;    // the slot the current bit's update adapts

  __device__ __forceinline__ Model(int model_bits, int shift, int* column)
      : p0(1 << (model_bits - 1)), bits(model_bits), rate(shift),
        gate(column), last(0) {
    if (USE_APM)
      for (int s = 0; s < APM_SLOTS; ++s)
        gate[s * THREADS] =
            min(max(s * (1 << APM_BITS) / (APM_SLOTS - 1), 1),
                (1 << APM_BITS) - 1);
  }

  __device__ __forceinline__ int denom_bits() const {
    return USE_APM ? APM_BITS : bits;
  }

  // p(bit = 0) scaled by 2^denom_bits().
  __device__ __forceinline__ int split() {
    if (!USE_APM) return p0;
    const int scaled = p0 * (APM_SLOTS - 1);
    const int idx = min(scaled >> APM_BITS, APM_SLOTS - 2);
    const int frac = scaled & ((1 << APM_BITS) - 1);
    const int a = gate[idx * THREADS], b = gate[(idx + 1) * THREADS];
    last = frac < (1 << (APM_BITS - 1)) ? idx : idx + 1;
    const int p = (a * ((1 << APM_BITS) - frac) + b * frac) >> APM_BITS;
    return min(max(p, 1), (1 << APM_BITS) - 1);
  }

  __device__ __forceinline__ void update(int bit) {
    p0 = adapt(p0, bit, bits, rate);
    if (USE_APM)
      gate[last * THREADS] = adapt(gate[last * THREADS], bit, APM_BITS,
                                   APM_RATE);
  }
};

}  // namespace bin
