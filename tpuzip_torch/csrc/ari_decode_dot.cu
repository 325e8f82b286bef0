// ari_decode_dot.cu — chunk-indexed adaptive range DECODER on frequency
// state, one warp per stream.
//
// Replaces tpuzip/kernels/range_decoder.py:559 `_ari_decode_kernel`, the v1
// decoder, launched from `ari_decode_lanes` (:665) with algo="dot".  It
// computes the function of ari_decode.cu (symbols from streams + chunk
// index) and reads the stream as that kernel does.  The model differs:
// this kernel carries the FREQUENCY table and rebuilds the inclusive
// cumulative table from it every step; ari_decode.cu carries the
// cumulative table and updates it in place.
//
// The TPU kernel rebuilt the table as a triangular product tri(256x256) .
// freq on its matrix unit, because its vector unit has no scan across
// sublanes; it split every frequency into a hi and a lo byte only because
// the matrix unit truncates f32 operands to bf16.  On Hopper a 256-entry
// prefix sum for one stream is about a dozen dependent instructions in
// registers: 7 adds in the lane, a 5-round __shfl_up_sync scan of the lane
// totals and one add (ari::prefix).  A tensor-core product would spend
// 256*256 multiply-adds a stream a step, and a table in shared memory, on
// the same 256 sums.
//
// What bounds it on this card: as for ari_decode.cu, a stream is a serial
// chain (two divisions, the symbol search, the byte pull and the model
// update per symbol), so it runs at the chain's latency, not at a byte
// rate.
//
// What the design does about it: all streams in flight at once, one warp
// each; the frequencies in registers, eight u32 a lane (lane l holds
// f[8l .. 8l+7]).  The total is a carried warp-uniform scalar, so the two
// divisions never wait on the scan, and the scan, which needs only the
// model of the step before, is issued ahead of them so that its shuffles
// overlap them.  The update is one predicated add a lane; a halving is
// local to each lane but for a 5-round sum of the new total.  The four
// bytes a step may pull are loaded before its divisions, and symbols are
// stored 128 at a time, as in ari_decode.cu.  All arithmetic is u32: knobs
// with threshold + increment <= 2^16 keep the total, and so every C, below
// 2^16.

#include <cuda_runtime.h>

#include <cstdint>

#include "ari_model.cuh"

namespace {

constexpr int WARPS_PER_BLOCK = 2;
constexpr int GROUP = 128;   // symbols a warp stores at once, 4 a lane

__global__ void __launch_bounds__(32 * WARPS_PER_BLOCK)
ari_decode_dot_kernel(const uint8_t* __restrict__ streams,
                      const int32_t* __restrict__ deltas,
                      const int32_t* __restrict__ lengths, int B, int cap,
                      int nc, uint8_t* __restrict__ out, uint32_t inc,
                      uint32_t threshold) {
  using namespace ari;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp leaves together
  const int n = nc * CHUNK_STEPS;
  const uint8_t* row = streams + static_cast<size_t>(b) * cap;
  const int32_t* drow = deltas + static_cast<size_t>(b) * nc;
  // n is a multiple of 64, so every row is 4-byte aligned
  uint32_t* orow = reinterpret_cast<uint32_t*>(out + static_cast<size_t>(b) * n);
  const int len = max(0, min(lengths[b], n));
  auto byte_at = [&](int p) -> uint32_t { return p < cap ? row[p] : 0u; };

  uint32_t f[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) f[k] = 1;
  uint32_t tot = 256, low = 0, rng = 0xffffffffu;
  uint32_t code = (byte_at(0) << 24) | (byte_at(1) << 16) |
                  (byte_at(2) << 8) | byte_at(3);
  int start = 4, pos = 4;

  for (int g = 0; g < n; g += GROUP) {
    uint32_t word = 0;
    const int steps = max(0, min(GROUP, len - g));
    for (int j = 0; j < steps; ++j) {
      const int t = g + j;
      if (t % CHUNK_STEPS == 0) {  // rebase on the chunk index
        pos = start;
        start += drow[t / CHUNK_STEPS];
      }
      uint32_t next = (byte_at(pos) << 24) | (byte_at(pos + 1) << 16) |
                      (byte_at(pos + 2) << 8) | byte_at(pos + 3);
      // the rebuild (tri . freq on the TPU), ahead of the divisions
      uint32_t c[8];
      prefix(c, f, lane);
      const uint32_t r = rng / tot;
      const uint32_t v = min((code - low) / r, tot - 1);
      // find_value: sym counts the entries <= v; the first lane whose last
      // entry exceeds v holds it
      const unsigned above = __ballot_sync(FULL, c[7] > v);
      const int owner = __ffs(above) - 1;   // lane 31 holds C[255] = tot > v
      int below = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) below += c[k] <= v;
      uint32_t prev = __shfl_up_sync(FULL, c[7], 1);
      if (lane == 0) prev = 0;
      const int idx = below & 7;  // below <= 7 in the owner lane
      const uint32_t hi_l = pick(c, idx);
      const uint32_t lo_l = idx ? pick(c, idx - 1) : prev;
      const int sym = 8 * owner + __shfl_sync(FULL, below, owner);
      const uint32_t hi = __shfl_sync(FULL, hi_l, owner);
      const uint32_t lo = __shfl_sync(FULL, lo_l, owner);
      low += r * lo;
      rng = r * (hi - lo);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
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
      // freq[sym] += inc (selects: a dynamic register index would spill),
      // then the halving of every frequency once the total reaches the
      // threshold
#pragma unroll
      for (int k = 0; k < 8; ++k) f[k] += (8 * lane + k == sym) ? inc : 0u;
      tot += inc;
      if (tot >= threshold) {
        uint32_t sum = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          f[k] = (f[k] + 1) >> 1;
          sum += f[k];
        }
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) sum += __shfl_xor_sync(FULL, sum, d);
        tot = sum;
      }
      if (lane == (j >> 2)) word |= static_cast<uint32_t>(sym) << (8 * (j & 3));
    }
    const int w = g / 4 + lane;
    if (w < n / 4) orow[w] = word;  // 0 past the length
  }
}

}  // namespace

// The arguments of tpz_ari_decode (ari_decode.cu): streams (B, cap) u8,
// deltas (B, nc) i32 and lengths (B,) i32 in; out (B, nc*64) u8 symbols,
// every byte written.  Launches on `stream` and returns cudaGetLastError().
extern "C" int tpz_ari_decode_dot(const void* streams, const void* deltas,
                                  const void* lengths, int B, int cap, int nc,
                                  void* out, int increment, int threshold,
                                  void* stream) {
  const int grid = (B + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  ari_decode_dot_kernel<<<grid, 32 * WARPS_PER_BLOCK, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(streams),
      static_cast<const int32_t*>(deltas),
      static_cast<const int32_t*>(lengths), B, cap, nc,
      static_cast<uint8_t*>(out), static_cast<uint32_t>(increment),
      static_cast<uint32_t>(threshold));
  return static_cast<int>(cudaGetLastError());
}
