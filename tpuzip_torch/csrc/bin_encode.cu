// bin_encode.cu — binary adaptive range ENCODER (codecs bin and apm), one
// warp per stream.
//
// Replaces tpuzip/kernels/bin_coder.py:38 `_bin_kernel` (its pallas_call
// is in `bin_encode_lanes`, :157) together with the host compaction and
// the 4 finish bytes of `bin_encode_streams` (:216-227).  Bit-exact
// tpuzip.oracle.ari streams (BinaryModel, or ApmGate over it, through the
// carryless range coder), and the same chunk index: the bytes emitted in
// each 256 bits.
//
// What bounds it on this card: a stream is a serial chain of bits — each
// bit's range split and renormalisation feed the next — so it runs at the
// latency of that chain, eight steps a byte, not at a byte or operation
// rate.  The port's first kernel ran a stream a thread, 32 a warp, so
// 1024 streams sat on 32 SMs, the renormalisation diverged and every byte
// was a one-byte store: 203 ns a bit for apm, 157 for bin (NVIDIA H100
// 80GB HBM3, 700 W).
//
// What the design does about it:
//   - one warp a stream, one warp a block, the stream index from
//     blockIdx.x alone: no branch diverges and 1024 streams spread over
//     all 132 SMs;
//   - the model runs a bit ahead of the coder: p0 and the APM gate depend
//     only on the input bits, so the next bit's split is computed before
//     the coder's products, and the two chains interleave;
//   - the APM gate in registers, lane l holding cells l and l + 1, read by
//     two shuffles; the cell the split reads is kept for the update, and
//     the gate's clamps that cannot bind are left out (the interpolation of
//     two cells in [1, 4095] and a cell's update at rate 5 stay in it:
//     tests/test_torch_step_identities.py), as in bin_decode.cu;
//   - the split's denominator is a power of two, so r is a shift, and
//     r * (2^dbits - split) is (rng & ~(2^dbits - 1)) - r * split; one
//     branch tests whether a bit emits any byte, and the renormalisation
//     loop has no break;
//   - the input is loaded 128 bytes a warp at a time and broadcast by
//     shuffle; the output is collected 4 bytes a lane and stored 128 bytes
//     at a time by the warp, in place in the stream row (which replaces
//     the TPU's fixed 4-byte slots and the host compaction).
//
// Measured in turns (chip_smoke.py --ab; NVIDIA H100 80GB HBM3, 700 W;
// PERF.md, section 6): apm 40.69 ms and bin 30.35 at 1024 x 64 KiB,
// against 106.62 and 82.15 for a thread a stream.  The coder's control
// flow now sets the step: alone, its split fixed, it takes 117 cycles a
// bit.  The loop without its break ran bin 1.19x faster and apm 1.04x
// slower.  Left out as slower: a model pass into shared memory, then a
// coder pass, 1.28-1.33x; the gate read before the bit's update, the
// update forwarded, 1.33x (apm); each lane interpolating its own cells,
// the update in the owning lanes, 1.10x; the emit test as a warp vote,
// 1.08x; the 128-byte store once an input byte, 1.06x (apm).

#include <cuda_runtime.h>

#include <cstdint>

#include "bin_coder.cuh"

namespace {

using namespace bin;

constexpr unsigned FULL = 0xffffffffu;

template <bool USE_APM>
__global__ void __launch_bounds__(32)
bin_encode_kernel(const uint8_t* __restrict__ blocks,
                  const int32_t* __restrict__ lengths, int N,
                  uint8_t* __restrict__ streams, int cap,
                  int32_t* __restrict__ stream_lens,
                  int32_t* __restrict__ deltas, int nc, int bits, int rate) {
  const int lane = threadIdx.x;  // one warp a block, one block a stream
  const int b = blockIdx.x;      // from blockIdx alone
  const uint8_t* row = blocks + static_cast<size_t>(b) * N;
  uint32_t* out = reinterpret_cast<uint32_t*>(streams +
                                              static_cast<size_t>(b) * cap);
  const int words = cap / 4;
  int32_t* drow = deltas + static_cast<size_t>(b) * nc;
  const int len = max(0, min(lengths[b], N));

  // bin_coder.cuh's model: p0 in every lane, and the gate, lane l holding
  // cells l and l + 1; `slot` and `cell` are the cell the split read and
  // that the bit's update adapts
  int p0 = 1 << (bits - 1);
  int ca = cell_init(lane), cb = cell_init(lane + 1);
  int slot = 0, cell = 0;
  auto split_of = [&]() -> uint32_t {
    if (!USE_APM) return static_cast<uint32_t>(p0);
    const int scaled = p0 * (APM_SLOTS - 1);
    const int idx = min(scaled >> APM_BITS, APM_SLOTS - 2);
    const int frac = scaled & ((1 << APM_BITS) - 1);
    const int a = __shfl_sync(FULL, ca, idx);
    const int a1 = __shfl_sync(FULL, cb, idx);
    const bool upper = frac >= 1 << (APM_BITS - 1);
    slot = upper ? idx + 1 : idx;
    cell = upper ? a1 : a;
    // (a * (4096 - frac) + a1 * frac) >> 12, between a and a1
    return static_cast<uint32_t>(a + (((a1 - a) * frac) >> APM_BITS));
  };
  auto update = [&](int bit) {
    p0 = adapt(p0, bit, bits, rate);
    if (USE_APM) {
      const int v = bit ? cell - (cell >> APM_RATE)
                        : cell + (((1 << APM_BITS) - cell) >> APM_RATE);
      if (lane == slot) ca = v;
      if (lane + 1 == slot) cb = v;
    }
  };

  // the stream's bytes: lane l collects bytes 4 l .. 4 l + 3 of the
  // current 128, and the warp stores them once the 128 are out
  uint32_t buf = 0;
  int pos = 0, chunk_pos = 0;
  auto put = [&](uint32_t byte) {
    if (lane == ((pos >> 2) & 31)) buf |= byte << (8 * (pos & 3));
    ++pos;
    if ((pos & 127) == 0) {
      const int w = (pos >> 2) - 32 + lane;
      if (w < words) out[w] = buf;
      buf = 0;
    }
  };

  const int dbits = USE_APM ? APM_BITS : bits;
  const uint32_t dmask = ~((1u << dbits) - 1);  // (rng >> dbits) << dbits
  uint32_t low = 0, rng = 0xffffffffu;
  uint32_t split = split_of();
  for (int t = 0; t < len; t += 128) {
    uint32_t word = 0;  // bytes t + 4 lane .. + 3
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = t + 4 * lane + q;
      if (i < len) word |= static_cast<uint32_t>(row[i]) << (8 * q);
    }
    const int n = min(128, len - t);
    for (int j = 0; j < n; ++j) {
      const uint32_t byte =
          (__shfl_sync(FULL, word, j >> 2) >> (8 * (j & 3))) & 0xffu;
#pragma unroll
      for (int k = 7; k >= 0; --k) {
        const int bit = (byte >> k) & 1;
        const uint32_t s = split;
        update(bit);        // the model, one bit ahead of the coder
        split = split_of();
        const uint32_t rs = (rng >> dbits) * s;
        if (bit) {
          low += rs;
          rng = (rng & dmask) - rs;
        } else {
          rng = rs;
        }
        if ((low ^ (low + rng)) < TOP || rng < BOT) {  // bytes to emit
          // carryless renormalisation: <= 4 bytes
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            // a pass that moves no byte changes nothing, so no later one
            // moves one: no break, which costs a convergence barrier
            const bool settled = (low ^ (low + rng)) < TOP;
            if (settled || rng < BOT) {
              if (!settled) rng = (0u - low) & (BOT - 1);
              put(low >> 24);
              low <<= 8;
              rng <<= 8;
            }
          }
        }
      }
      const int i = t + j;
      if ((i + 1) % CHUNK_BYTES == 0 || i + 1 == len) {
        if (lane == 0) drow[i / CHUNK_BYTES] = pos - chunk_pos;
        chunk_pos = pos;
      }
    }
  }
  for (int k = (len + CHUNK_BYTES - 1) / CHUNK_BYTES + lane; k < nc; k += 32)
    drow[k] = 0;
  // finish(): the 4 bytes of low, most significant first
#pragma unroll
  for (int q = 0; q < 4; ++q) put((low >> (24 - 8 * q)) & 0xffu);
  const int w = ((pos >> 7) << 5) + lane;  // the last, partial 128
  if (4 * lane < (pos & 127) && w < words) out[w] = buf;
  if (lane == 0) stream_lens[b] = pos;
}

}  // namespace

// blocks (B, N) u8 and lengths (B,) i32 (bytes) in; streams (B, cap) u8
// (zeroed by the caller; cap a multiple of 4), stream_lens (B,) i32 and
// deltas (B, nc) i32 out, nc = ceil(8N / 256).  Launches on `stream` and
// returns cudaGetLastError().
extern "C" int tpz_bin_encode(const void* blocks, const void* lengths, int B,
                              int N, void* streams, int cap,
                              void* stream_lens, void* deltas, int nc,
                              int model_bits, int rate, int use_apm,
                              void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const uint8_t*>(blocks);
  const auto* lens = static_cast<const int32_t*>(lengths);
  auto* y = static_cast<uint8_t*>(streams);
  auto* ylen = static_cast<int32_t*>(stream_lens);
  auto* d = static_cast<int32_t*>(deltas);
  if (use_apm)
    bin_encode_kernel<true><<<B, 32, 0, s>>>(x, lens, N, y, cap, ylen, d, nc,
                                             model_bits, rate);
  else
    bin_encode_kernel<false><<<B, 32, 0, s>>>(x, lens, N, y, cap, ylen, d,
                                              nc, model_bits, rate);
  return static_cast<int>(cudaGetLastError());
}
