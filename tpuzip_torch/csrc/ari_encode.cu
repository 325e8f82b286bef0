// ari_encode.cu — adaptive order-0 range ENCODER, one warp per stream.
//
// Replaces tpuzip/kernels/range_coder.py:128 `_ari_encode_kernel` (its
// pallas_call is in `ari_encode_lanes`, :244) together with the stream
// compaction and the 4 finish bytes of `_encode_lanes_packed_core`
// (:339-380).  Bit-exact tpuzip.oracle.ari streams, and the same chunk
// index (bytes emitted per 64 symbols) as
// `ari_encode_lanes_packed_indexed`.
//
// What bounds it on this card: a stream is a serial chain — each symbol's
// division, renormalisation and model update feed the next — so it runs
// at the latency of that chain, not at a byte or FLOP rate.  A 64 KiB
// block is 65536 dependent steps.
//
// What the design does about it: every stream of the batch is in flight at
// once (one warp each, two warps a block), so the schedulers interleave
// many chains; the 256-entry cumulative table stays in registers, eight
// u32 a lane, so a step reads one shuffled symbol and touches memory only
// for its output bytes; the u32 division is native (the TPU needed a
// schoolbook divider); and since a warp knows its own write position, the
// TPU's fixed 4-byte emission slots and the sort that compacted them are
// gone.

#include <cuda_runtime.h>

#include <cstdint>

#include "ari_model.cuh"

namespace {

constexpr int WARPS_PER_BLOCK = 2;
constexpr int GROUP = 128;   // symbols a warp loads at once, 4 a lane

__global__ void __launch_bounds__(32 * WARPS_PER_BLOCK)
ari_encode_kernel(const uint8_t* __restrict__ blocks,
                  const int32_t* __restrict__ lengths, int B, int N,
                  uint8_t* __restrict__ streams, int cap,
                  int32_t* __restrict__ stream_lens,
                  int32_t* __restrict__ deltas, int nc, uint32_t inc,
                  uint32_t threshold) {
  using namespace ari;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp leaves together
  const uint8_t* row = blocks + static_cast<size_t>(b) * N;
  uint8_t* out = streams + static_cast<size_t>(b) * cap;
  int32_t* drow = deltas + static_cast<size_t>(b) * nc;
  const int len = max(0, min(lengths[b], N));

  uint32_t c[8];
  init(c, lane);
  uint32_t tot = 256, low = 0, rng = 0xffffffffu;
  int pos = 0, chunk_pos = 0;

  for (int t0 = 0; t0 < len; t0 += GROUP) {
    uint32_t word = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = t0 + 4 * lane + k;
      if (i < len) word |= static_cast<uint32_t>(row[i]) << (8 * k);
    }
    const int steps = min(GROUP, len - t0);
    for (int j = 0; j < steps; ++j) {
      const int sym =
          (__shfl_sync(FULL, word, j >> 2) >> (8 * (j & 3))) & 0xff;
      const uint32_t hi = cum_at(c, sym);
      const uint32_t below = cum_at(c, max(sym - 1, 0));
      const uint32_t lo = sym > 0 ? below : 0u;
      const uint32_t r = rng / tot;
      low += r * lo;
      rng = r * (hi - lo);
      // carryless renormalisation: <= 4 bytes, lane 0 writes them
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if ((low ^ (low + rng)) >= TOP) {
          if (rng >= BOT) break;
          rng = (0u - low) & (BOT - 1);
        }
        if (lane == 0 && pos < cap) out[pos] = static_cast<uint8_t>(low >> 24);
        ++pos;
        low <<= 8;
        rng <<= 8;
      }
      tot = update(c, lane, sym, tot, inc, threshold);
      const int t = t0 + j;
      if ((t + 1) % CHUNK_STEPS == 0 || t + 1 == len) {
        if (lane == 0) drow[t / CHUNK_STEPS] = pos - chunk_pos;
        chunk_pos = pos;
      }
    }
  }
  for (int k = (len + CHUNK_STEPS - 1) / CHUNK_STEPS + lane; k < nc; k += 32)
    drow[k] = 0;
  // finish(): the 4 bytes of low, most significant first
  if (lane < 4 && pos + lane < cap)
    out[pos + lane] = static_cast<uint8_t>(low >> (24 - 8 * lane));
  if (lane == 0) stream_lens[b] = pos + 4;
}

}  // namespace

// blocks (B, N) u8 and lengths (B,) i32 in; streams (B, cap) u8 (zeroed by
// the caller), stream_lens (B,) i32 and deltas (B, nc) i32 out.  Launches
// on `stream` and returns cudaGetLastError().
extern "C" int tpz_ari_encode(const void* blocks, const void* lengths, int B,
                              int N, void* streams, int cap,
                              void* stream_lens, void* deltas, int nc,
                              int increment, int threshold, void* stream) {
  const int grid = (B + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  ari_encode_kernel<<<grid, 32 * WARPS_PER_BLOCK, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(blocks),
      static_cast<const int32_t*>(lengths), B, N,
      static_cast<uint8_t*>(streams), cap,
      static_cast<int32_t*>(stream_lens), static_cast<int32_t*>(deltas), nc,
      static_cast<uint32_t>(increment), static_cast<uint32_t>(threshold));
  return static_cast<int>(cudaGetLastError());
}
