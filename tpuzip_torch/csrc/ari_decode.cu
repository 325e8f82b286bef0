// ari_decode.cu — adaptive range DECODER, one warp per stream, with the
// container's chunk index or without it.
//
// Replaces tpuzip/kernels/range_decoder.py:469 `_ari_decode_kernel_v3`
// (packed table, the default knobs) and :514 `_ari_decode_kernel_v2`
// (f32 table, taken when threshold + increment > 2^15); both are launched
// from `ari_decode_lanes` (:665) and compute one function, symbols from
// streams + chunk index.  The u32 table here serves every knob pair up to
// 2^16.  Without the index it computes tpuzip.codecs.ari.decode_batch
// (the XLA scan tpuzip runs on containers with flag 2 clear).
//
// Read position.  With the index, exactly as the TPU kernels read their
// windows: chunk k starts at 4 + exclusive_cumsum(deltas)[k], advances by
// the bytes the coder pulls, and a byte at or past the row width reads as
// 0.  Without it the position just runs on from 4, and a byte at or past
// the row width reads as the row's last byte (tpuzip.codecs.ari.decode
// clips its index to the row).
//
// What bounds it on this card: not bytes (it runs 2-4 orders of magnitude
// above its byte bound) but the latency of one serial chain a stream:
// each symbol's coder state waits on the last one's, so a step costs its
// dependent instructions plus the ones a warp issues in order beside them,
// and 64 streams take about the time of 1024.  The design shortens the
// chain and keeps the step's instructions few:
//   - no second division: v = min((code-low) / r, tot-1) >= C holds
//     exactly when r*C <= code-low and C < tot, so each lane compares its
//     eight r*C[k] with code-low (eight independent multiply-adds), and the
//     products are the r*lo and r*hi the coder needs.
//   - the symbol search is three independent warp reductions (redux.sync):
//     the count of entries below (sym), the largest product below (r*lo)
//     and the smallest product not below (r*hi), each first a 3-level tree
//     over the lane's eight entries, in place of a ballot, a find-first and
//     three dependent shuffles from the owner lane.  The table is strictly
//     increasing (frequencies never fall below 1), and lane 31's C[255] =
//     tot is never below, which is the clamp at tot-1.
//   - the chunk test runs once a chunk (64 steps), not every step.
//   - one warp a block: 64 streams spread over 64 SMs.  The stream index
//     comes from blockIdx.x alone, so the loop's bounds and the row
//     pointers are the same in every lane of the warp; computed from
//     threadIdx.x as well (b = blockIdx.x + (threadIdx.x >> 5), lane =
//     threadIdx.x & 31) the same step ran 11-15% slower (H100 80GB HBM3,
//     700 W; PERF.md, section 6).
// Measured and left out (PERF.md, section 6): r by a multiply with the next
// total's reciprocal computed off the chain, and the next step's bytes
// loaded a step ahead, each slower at every width; the step loop unrolled
// by 4, faster at 1024 streams but slower at 64 and 128; the ballot search,
// and 2 or 4 warps a block, slower at 64 and 128 streams.  The rest stays:
// all streams in flight at once, one warp each; the table in registers,
// eight u32 a lane; the four bytes a step may pull loaded before its
// arithmetic; symbols gathered 4 a lane and stored 128 at a time.

#include <cuda_runtime.h>

#include <cstdint>

#include "ari_model.cuh"

namespace {

using namespace ari;

constexpr int GROUP = 128;   // symbols a warp stores at once, 4 a lane

template <bool INDEXED>
__global__ void __launch_bounds__(32)
ari_decode_kernel(const uint8_t* __restrict__ streams,
                  const int32_t* __restrict__ deltas,
                  const int32_t* __restrict__ lengths, int B, int cap,
                  int nc, uint8_t* __restrict__ out, uint32_t inc,
                  uint32_t threshold) {
  const int lane = threadIdx.x;  // one warp a block, one block a stream
  const int b = blockIdx.x;      // from blockIdx alone: see the head note
  const int n = nc * CHUNK_STEPS;
  const uint8_t* row = streams + static_cast<size_t>(b) * cap;
  const int32_t* drow = INDEXED ? deltas + static_cast<size_t>(b) * nc
                                : nullptr;
  // n is a multiple of 64, so every row is 4-byte aligned
  uint32_t* orow = reinterpret_cast<uint32_t*>(out + static_cast<size_t>(b) * n);
  const int len = max(0, min(lengths[b], n));
  auto byte_at = [&](int p) -> uint32_t {
    if (INDEXED) return p < cap ? row[p] : 0u;
    return row[min(p, cap - 1)];
  };
  uint32_t c[8];
  init(c, lane);
  uint32_t tot = 256, low = 0, rng = 0xffffffffu;
  uint32_t code = (byte_at(0) << 24) | (byte_at(1) << 16) |
                  (byte_at(2) << 8) | byte_at(3);
  int start = 4, pos = 4;
  // C[255] = tot, lane 31's last entry, is never below v
  const uint32_t last_ok = lane == 31 ? 0u : 1u;

  for (int g = 0; g < n; g += GROUP) {
    uint32_t word = 0;
    for (int h = 0; h < GROUP; h += CHUNK_STEPS) {
      const int t0 = g + h;
      const int steps = max(0, min(CHUNK_STEPS, len - t0));
      if (INDEXED && steps > 0) {  // rebase on the chunk index
        pos = start;
        start += drow[t0 / CHUNK_STEPS];
      }
#pragma unroll 1  // by 4 was slower at 64 and 128 streams
      for (int j = 0; j < steps; ++j) {
        uint32_t next = (byte_at(pos) << 24) | (byte_at(pos + 1) << 16) |
                        (byte_at(pos + 2) << 8) | byte_at(pos + 3);
        const uint32_t r = rng / tot;
        const uint32_t d = code - low;
        // entry k is below v  <=>  r*C[k] <= d (and C[k] < tot)
        uint32_t lo_k[8], hi_k[8];
        int cnt[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const uint32_t rc = r * c[k];
          const bool below = rc <= d && (k < 7 || last_ok);
          cnt[k] = below;
          lo_k[k] = below ? rc : 0u;
          hi_k[k] = below ? 0xffffffffu : rc;
        }
        // trees, not chains, over the lane's eight entries
#pragma unroll
        for (int s = 1; s < 8; s <<= 1) {
#pragma unroll
          for (int k = 0; k < 8; k += 2 * s) {
            cnt[k] += cnt[k + s];
            lo_k[k] = max(lo_k[k], lo_k[k + s]);
            hi_k[k] = min(hi_k[k], hi_k[k + s]);
          }
        }
        const int sym = static_cast<int>(
            __reduce_add_sync(FULL, static_cast<unsigned>(cnt[0])));
        const uint32_t rlo = __reduce_max_sync(FULL, lo_k[0]);
        const uint32_t rhi = __reduce_min_sync(FULL, hi_k[0]);
        low += rlo;
        rng = rhi - rlo;
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
        tot = update(c, lane, sym, tot, inc, threshold);
        const int q = h + j;
        if (lane == (q >> 2)) word |= static_cast<uint32_t>(sym) << (8 * (q & 3));
      }
    }
    const int w = g / 4 + lane;
    if (w < n / 4) orow[w] = word;  // 0 past the length
  }
}

}  // namespace

// streams (B, cap) u8, deltas (B, nc) i32 or null (no chunk index) and
// lengths (B,) i32 in; out (B, nc*64) u8 symbols, every byte written.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int tpz_ari_decode(const void* streams, const void* deltas,
                              const void* lengths, int B, int cap, int nc,
                              void* out, int increment, int threshold,
                              void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const uint8_t*>(streams);
  const auto* d = static_cast<const int32_t*>(deltas);
  const auto* l = static_cast<const int32_t*>(lengths);
  auto* y = static_cast<uint8_t*>(out);
  const auto inc = static_cast<uint32_t>(increment);
  const auto thr = static_cast<uint32_t>(threshold);
  if (d != nullptr)
    ari_decode_kernel<true><<<B, 32, 0, s>>>(
        x, d, l, B, cap, nc, y, inc, thr);
  else
    ari_decode_kernel<false><<<B, 32, 0, s>>>(
        x, d, l, B, cap, nc, y, inc, thr);
  return static_cast<int>(cudaGetLastError());
}
