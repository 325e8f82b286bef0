// bin_decode.cu — chunk-indexed binary adaptive range DECODER (codecs bin
// and apm), one warp per stream.
//
// Replaces tpuzip/kernels/bin_coder.py:341 `_bin_decode_kernel` (its
// pallas_call is in `bin_decode_lanes`, :401; step `_bin_decode_step`,
// :258).  Same function: bits (here packed MSB-first into bytes) from the
// streams, the chunk index and each stream's bit count, with the model of
// bin_coder.cuh, which mirrors the encoder's.
//
// Read position, as the TPU kernel reads its windows: chunk k (256 bits)
// starts at 4 + the deltas of the chunks before it, advances by the bytes
// the coder pulls, and a byte at or past the row width reads as 0.
// Without the chunk index (a null deltas: tpuzip.codecs.bin_apm.
// decode_batch, the XLA scan tpuzip runs on containers with flag 2 clear)
// the position runs on from 4, and a byte at or past the row width reads
// as the row's last byte, as that scan clips its index to the row.  A
// stream is read by its own warp, so the TPU's window prepack, one-hot byte
// fetch and f32 divider are gone.
//
// What bounds it on this card: not bytes but the latency of one serial
// chain of bits a stream (the range split, the renormalisation with its
// byte pulls and the model update a bit).  The earlier apm bit, stamped
// with clock64 (tools/step_clocks.py; NVIDIA H100 80GB HBM3, 700 W): 559
// cycles, of which the division 140, the four byte loads 143, the model's
// split and update 154, the renormalisation 64.
//
// What the design does about it:
//   - no division: with r = rng >> dbits >= 1 and 1 <= split <= 2^dbits - 1,
//     min((code - low) / r, 2^dbits - 1) >= split holds exactly when
//     code - low >= r * split, and r * split < rng never overflows.  It
//     rests on rng >= 2^16 >= 2^dbits after every renormalisation
//     (tests/test_torch_step_identities.py checks both through the plain
//     coder);
//   - the stream's next bytes sit in a register window (8 bytes, and the 4
//     after them loaded a refill ahead), so a bit pulls its bytes from
//     registers and a load is issued once every 4 bytes, not 4 a bit; with
//     the index, the next chunk's first 12 bytes are loaded a chunk ahead;
//   - one warp a stream, one warp a block, the stream index from
//     blockIdx.x alone: its branches never diverge, and 1024 streams spread
//     over all 132 SMs, not 32;
//   - the APM gate in registers, lane l holding cells l and l + 1, read by
//     two shuffles; the cell the split reads is kept for the update, and
//     the clamps that cannot bind are left out; one branch tests whether a
//     bit pulls any byte; bits are shifted into their byte.
// Measured in turns (chip_smoke.py --ab; NVIDIA H100 80GB HBM3, 700 W;
// PERF.md, section 6): 32, 8, 4 or 2 streams a warp ran 1.06-2.0x slower
// than one; left out as slower: both successors of the model computed
// before the bit is known (twice, on two forms of the step), the
// renormalisation test as a warp vote.  8 bits are collected in a
// register and written as one byte, as before.

#include <cuda_runtime.h>

#include <cstdint>

#include "bin_coder.cuh"

namespace {

using namespace bin;

// A stream row's bytes as the decoder reads them (see the head note).
template <bool INDEXED>
struct Row {
  const uint8_t* p;
  int cap;
  __device__ __forceinline__ uint32_t at(int i) const {
    if (INDEXED) return i < cap ? p[i] : 0u;
    return p[min(i, cap - 1)];
  }
  // bytes i .. i+3, the first in the top byte
  __device__ __forceinline__ uint32_t word(int i) const {
    return (at(i) << 24) | (at(i + 1) << 16) | (at(i + 2) << 8) | at(i + 3);
  }
};

template <bool USE_APM, bool INDEXED>
__global__ void __launch_bounds__(32)
bin_decode_kernel(const uint8_t* __restrict__ streams,
                  const int32_t* __restrict__ deltas,
                  const int32_t* __restrict__ nbits, int cap, int nc,
                  uint8_t* __restrict__ out, int bits, int rate) {
  const int lane = threadIdx.x;  // one warp a block, one block a stream
  const int b = blockIdx.x;      // from blockIdx alone
  const int nbytes_row = nc * CHUNK_BYTES;
  const Row<INDEXED> src{streams + static_cast<size_t>(b) * cap, cap};
  const int32_t* drow = INDEXED ? deltas + static_cast<size_t>(b) * nc
                                : nullptr;
  uint8_t* orow = out + static_cast<size_t>(b) * nbytes_row;
  const int len = max(0, min(nbits[b], 8 * nbytes_row));

  // bin_coder.cuh's model: p0, and the APM gate in registers, lane l
  // holding cells l and l + 1; the clamps that cannot bind are left out
  // (an interpolation of two cells in [1, 4095] and a cell's update at
  // rate 5 stay in it: tests/test_torch_step_identities.py)
  int p0 = 1 << (bits - 1);
  int ca = cell_init(lane), cb = cell_init(lane + 1);
  const int dbits = USE_APM ? APM_BITS : bits;
  const uint32_t dmask = ~((1u << dbits) - 1);   // (rng >> dbits) << dbits
  uint32_t low = 0, rng = 0xffffffffu;
  uint32_t code = src.word(0);
  // The window: `have` bytes at the read position, the first in the top
  // byte of win; next, the 4 bytes after them; fetch, the address after
  // those.  pre0..2: the 12 bytes at `start`, the next chunk's first.
  int start = 4;
  uint32_t pre0 = src.word(4), pre1 = src.word(8), pre2 = src.word(12);
  uint64_t win = (static_cast<uint64_t>(pre0) << 32) | pre1;
  uint32_t next = pre2;
  int have = 8, fetch = 16;

  const int nbytes = (len + 7) / 8;
  for (int i = 0; i < nbytes; ++i) {
    if (INDEXED && i % CHUNK_BYTES == 0) {  // rebase on the chunk index
      win = (static_cast<uint64_t>(pre0) << 32) | pre1;
      next = pre2;
      have = 8;
      fetch = start + 12;
      start += drow[i / CHUNK_BYTES];
      pre0 = src.word(start);
      pre1 = src.word(start + 4);
      pre2 = src.word(start + 8);
    }
    uint32_t byte = 0;
    const int kbits = min(8, len - 8 * i);
    for (int k = 0; k < kbits; ++k) {
      uint32_t split = static_cast<uint32_t>(p0);
      int slot = 0, cell = 0;
      if (USE_APM) {
        const int scaled = p0 * (APM_SLOTS - 1);
        const int idx = min(scaled >> APM_BITS, APM_SLOTS - 2);
        const int frac = scaled & ((1 << APM_BITS) - 1);
        const int a = __shfl_sync(0xffffffffu, ca, idx);
        const int a1 = __shfl_sync(0xffffffffu, cb, idx);
        const bool upper = frac >= 1 << (APM_BITS - 1);
        slot = upper ? idx + 1 : idx;
        cell = upper ? a1 : a;
        // (a * (4096 - frac) + a1 * frac) >> 12, between a and a1
        split = static_cast<uint32_t>(a + (((a1 - a) * frac) >> APM_BITS));
      }
      const uint32_t rs = (rng >> dbits) * split;
      const int bit = code - low >= rs;   // v >= split, with no division
      if (bit) {
        low += rs;
        rng = (rng & dmask) - rs;
      } else {
        rng = rs;
      }
      if ((low ^ (low + rng)) < TOP || rng < BOT) {   // bytes to pull
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if ((low ^ (low + rng)) >= TOP) {
            if (rng >= BOT) break;
            rng = (0u - low) & (BOT - 1);
          }
          code = (code << 8) | static_cast<uint32_t>(win >> 56);
          win <<= 8;
          --have;
          low <<= 8;
          rng <<= 8;
        }
        if (have < 4) {   // refill from `next`, and load the 4 after it
          win |= static_cast<uint64_t>(next) << (32 - 8 * have);
          have += 4;
          next = src.word(fetch);
          fetch += 4;
        }
      }
      p0 = adapt(p0, bit, bits, rate);
      if (USE_APM) {
        const int v = bit ? cell - (cell >> APM_RATE)
                          : cell + (((1 << APM_BITS) - cell) >> APM_RATE);
        if (lane == slot) ca = v;
        if (lane + 1 == slot) cb = v;
      }
      byte = 2 * byte + bit;
    }
    if (lane == 0) orow[i] = static_cast<uint8_t>(byte << (8 - kbits));
  }
  for (int i = nbytes + lane; i < nbytes_row; i += 32) orow[i] = 0;
}

}  // namespace

// streams (B, cap) u8, deltas (B, nc) i32 or null (no chunk index: then
// cap >= 1) and nbits (B,) i32 in; out
// (B, nc*32) u8, the bits MSB-first, every byte written (0 past each
// stream's bits).  Launches on `stream` and returns cudaGetLastError().
extern "C" int tpz_bin_decode(const void* streams, const void* deltas,
                              const void* nbits, int B, int cap, int nc,
                              void* out, int model_bits, int rate,
                              int use_apm, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const uint8_t*>(streams);
  const auto* d = static_cast<const int32_t*>(deltas);
  const auto* nb = static_cast<const int32_t*>(nbits);
  auto* y = static_cast<uint8_t*>(out);
  if (use_apm && d)
    bin_decode_kernel<true, true><<<B, 32, 0, s>>>(
        x, d, nb, cap, nc, y, model_bits, rate);
  else if (d)
    bin_decode_kernel<false, true><<<B, 32, 0, s>>>(
        x, d, nb, cap, nc, y, model_bits, rate);
  else if (use_apm)
    bin_decode_kernel<true, false><<<B, 32, 0, s>>>(
        x, d, nb, cap, nc, y, model_bits, rate);
  else
    bin_decode_kernel<false, false><<<B, 32, 0, s>>>(
        x, d, nb, cap, nc, y, model_bits, rate);
  return static_cast<int>(cudaGetLastError());
}
