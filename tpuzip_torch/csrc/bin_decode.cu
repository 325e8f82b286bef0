// bin_decode.cu — chunk-indexed binary adaptive range DECODER (codecs bin
// and apm), one thread per stream.
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
// thread reads its own stream, so the TPU's window prepack, one-hot byte
// fetch and f32 divider are gone: the u32 division is native.
//
// What bounds it on this card: as for the encoder, a stream is a serial
// chain of bits (a division, the renormalisation with its byte pulls and
// the model update a bit), so it runs at the chain's latency.
//
// What the design does about it: every stream in flight at once, one
// thread each; the four bytes a bit may pull are loaded before its
// division, so their latency hides behind the arithmetic; 8 bits are
// collected in a register and written as one byte.

#include <cuda_runtime.h>

#include <cstdint>

#include "bin_coder.cuh"

namespace {

using namespace bin;

template <bool USE_APM, bool INDEXED>
__global__ void __launch_bounds__(THREADS)
bin_decode_kernel(const uint8_t* __restrict__ streams,
                  const int32_t* __restrict__ deltas,
                  const int32_t* __restrict__ nbits, int B, int cap, int nc,
                  uint8_t* __restrict__ out, int bits, int rate) {
  __shared__ int cells[USE_APM ? APM_SLOTS * THREADS : 1];
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= B) return;  // no block-wide barrier follows
  const int nbytes_row = nc * CHUNK_BYTES;
  const uint8_t* row = streams + static_cast<size_t>(b) * cap;
  const int32_t* drow = INDEXED ? deltas + static_cast<size_t>(b) * nc
                                : nullptr;
  uint8_t* orow = out + static_cast<size_t>(b) * nbytes_row;
  const int len = max(0, min(nbits[b], 8 * nbytes_row));
  auto byte_at = [&](int p) -> uint32_t {
    if (INDEXED) return p < cap ? row[p] : 0u;
    return row[min(p, cap - 1)];
  };

  Model<USE_APM> m(bits, rate, cells + threadIdx.x);
  const int dbits = m.denom_bits();
  const uint32_t denom = 1u << dbits;
  uint32_t low = 0, rng = 0xffffffffu;
  uint32_t code = (byte_at(0) << 24) | (byte_at(1) << 16) |
                  (byte_at(2) << 8) | byte_at(3);
  int start = 4, pos = 4;

  const int nbytes = (len + 7) / 8;
  for (int i = 0; i < nbytes; ++i) {
    if (INDEXED && i % CHUNK_BYTES == 0) {  // rebase on the chunk index
      pos = start;
      start += drow[i / CHUNK_BYTES];
    }
    uint32_t byte = 0;
    const int kbits = min(8, len - 8 * i);
    for (int k = 0; k < kbits; ++k) {
      uint32_t next = (byte_at(pos) << 24) | (byte_at(pos + 1) << 16) |
                      (byte_at(pos + 2) << 8) | byte_at(pos + 3);
      const uint32_t split = static_cast<uint32_t>(m.split());
      const uint32_t r = rng >> dbits;
      const uint32_t v = min((code - low) / r, denom - 1);
      const int bit = v >= split;
      if (bit) low += r * split;
      rng = r * (bit ? denom - split : split);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if ((low ^ (low + rng)) >= TOP) {
          if (rng >= BOT) break;
          rng = (0u - low) & (BOT - 1);
        }
        code = (code << 8) | (next >> 24);
        next <<= 8;
        ++pos;
        low <<= 8;
        rng <<= 8;
      }
      m.update(bit);
      byte |= static_cast<uint32_t>(bit) << (7 - k);
    }
    orow[i] = static_cast<uint8_t>(byte);
  }
  for (int i = nbytes; i < nbytes_row; ++i) orow[i] = 0;
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
  const int grid = (B + THREADS - 1) / THREADS;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const uint8_t*>(streams);
  const auto* d = static_cast<const int32_t*>(deltas);
  const auto* nb = static_cast<const int32_t*>(nbits);
  auto* y = static_cast<uint8_t*>(out);
  if (use_apm && d)
    bin_decode_kernel<true, true><<<grid, THREADS, 0, s>>>(
        x, d, nb, B, cap, nc, y, model_bits, rate);
  else if (d)
    bin_decode_kernel<false, true><<<grid, THREADS, 0, s>>>(
        x, d, nb, B, cap, nc, y, model_bits, rate);
  else if (use_apm)
    bin_decode_kernel<true, false><<<grid, THREADS, 0, s>>>(
        x, d, nb, B, cap, nc, y, model_bits, rate);
  else
    bin_decode_kernel<false, false><<<grid, THREADS, 0, s>>>(
        x, d, nb, B, cap, nc, y, model_bits, rate);
  return static_cast<int>(cudaGetLastError());
}
