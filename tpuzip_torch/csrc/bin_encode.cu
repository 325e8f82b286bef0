// bin_encode.cu — binary adaptive range ENCODER (codecs bin and apm), one
// thread per stream.
//
// Replaces tpuzip/kernels/bin_coder.py:38 `_bin_kernel` (its pallas_call
// is in `bin_encode_lanes`, :157) together with the host compaction and
// the 4 finish bytes of `bin_encode_streams` (:216-227).  Bit-exact
// tpuzip.oracle.ari streams (BinaryModel, or ApmGate over it, through the
// carryless range coder), and the same chunk index: the bytes emitted in
// each 256 bits.
//
// What bounds it on this card: a stream is a serial chain of bits — each
// bit's range split, renormalisation and model update feed the next — so
// it runs at the latency of that chain, eight steps a byte, not at a byte
// or operation rate.
//
// What the design does about it: a bit's state is a few registers, so a
// stream gets one thread and every stream of the batch is in flight at
// once (32 a block, so 1024 streams spread over 32 SMs); the denominator
// is a power of two, so the split is a shift; the block's bytes are read
// MSB-first one byte every 8 steps (the next byte loaded a byte ahead), so
// no bit tensor is built; and since a thread knows its write position it
// writes its bytes in place, which replaces the TPU's fixed 4-byte slots
// and the host compaction.  The APM cells are in shared memory ([slot]
// [thread]).

#include <cuda_runtime.h>

#include <cstdint>

#include "bin_coder.cuh"

namespace {

using namespace bin;

template <bool USE_APM>
__global__ void __launch_bounds__(THREADS)
bin_encode_kernel(const uint8_t* __restrict__ blocks,
                  const int32_t* __restrict__ lengths, int B, int N,
                  uint8_t* __restrict__ streams, int cap,
                  int32_t* __restrict__ stream_lens,
                  int32_t* __restrict__ deltas, int nc, int bits, int rate) {
  __shared__ int cells[USE_APM ? APM_SLOTS * THREADS : 1];
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= B) return;  // no block-wide barrier follows
  const uint8_t* row = blocks + static_cast<size_t>(b) * N;
  uint8_t* out = streams + static_cast<size_t>(b) * cap;
  int32_t* drow = deltas + static_cast<size_t>(b) * nc;
  const int len = max(0, min(lengths[b], N));

  Model<USE_APM> m(bits, rate, cells + threadIdx.x);
  const int dbits = m.denom_bits();
  const uint32_t denom = 1u << dbits;
  uint32_t low = 0, rng = 0xffffffffu;
  int pos = 0, chunk_pos = 0;
  uint32_t next = len > 0 ? row[0] : 0u;

  for (int i = 0; i < len; ++i) {
    const uint32_t byte = next;
    if (i + 1 < len) next = row[i + 1];
    for (int k = 7; k >= 0; --k) {
      const int bit = (byte >> k) & 1;
      const uint32_t split = static_cast<uint32_t>(m.split());
      const uint32_t r = rng >> dbits;
      if (bit) low += r * split;
      rng = r * (bit ? denom - split : split);
      // carryless renormalisation: <= 4 bytes, written in place
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if ((low ^ (low + rng)) >= TOP) {
          if (rng >= BOT) break;
          rng = (0u - low) & (BOT - 1);
        }
        if (pos < cap) out[pos] = static_cast<uint8_t>(low >> 24);
        ++pos;
        low <<= 8;
        rng <<= 8;
      }
      m.update(bit);
    }
    if ((i + 1) % CHUNK_BYTES == 0 || i + 1 == len) {
      drow[i / CHUNK_BYTES] = pos - chunk_pos;
      chunk_pos = pos;
    }
  }
  for (int k = (len + CHUNK_BYTES - 1) / CHUNK_BYTES; k < nc; ++k) drow[k] = 0;
  // finish(): the 4 bytes of low, most significant first
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (pos + k < cap)
      out[pos + k] = static_cast<uint8_t>(low >> (24 - 8 * k));
  stream_lens[b] = pos + 4;
}

}  // namespace

// blocks (B, N) u8 and lengths (B,) i32 (bytes) in; streams (B, cap) u8
// (zeroed by the caller), stream_lens (B,) i32 and deltas (B, nc) i32 out,
// nc = ceil(8N / 256).  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int tpz_bin_encode(const void* blocks, const void* lengths, int B,
                              int N, void* streams, int cap,
                              void* stream_lens, void* deltas, int nc,
                              int model_bits, int rate, int use_apm,
                              void* stream) {
  const int grid = (B + THREADS - 1) / THREADS;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const uint8_t*>(blocks);
  const auto* lens = static_cast<const int32_t*>(lengths);
  auto* y = static_cast<uint8_t*>(streams);
  auto* ylen = static_cast<int32_t*>(stream_lens);
  auto* d = static_cast<int32_t*>(deltas);
  if (use_apm)
    bin_encode_kernel<true><<<grid, THREADS, 0, s>>>(
        x, lens, B, N, y, cap, ylen, d, nc, model_bits, rate);
  else
    bin_encode_kernel<false><<<grid, THREADS, 0, s>>>(
        x, lens, B, N, y, cap, ylen, d, nc, model_bits, rate);
  return static_cast<int>(cudaGetLastError());
}
