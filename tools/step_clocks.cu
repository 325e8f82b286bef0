// step_clocks.cu — clock64-stamped copies of sixteen kernels' steps, as they
// stood before their redesign: the ari encoder's (csrc/ari_encode.cu), the
// apm bit decoder's (csrc/bin_decode.cu, indexed), the apm bit encoder's
// (csrc/bin_encode.cu, one thread a stream), the DC walk's
// (csrc/dc_decode.cu, eight compares and two reductions a run), the
// lz4 encoder's (csrc/lz4_encode.cu, lane 0 probing a position at a time),
// the lz4 decoder's (csrc/lz4_decode.cu, a sequence at a time), the rle
// decoder's (csrc/rle.cu, one thread a row), the chained lz4 parse's
// (csrc/lz4_chain.cu, a window of 32 chain walks), the dense lz4
// candidates step (csrc/lz4_dense.cu, a table in device memory), the
// deflate decoder's (csrc/inflate.cu, lane 0 decoding a symbol at a time),
// lz4p's pack (csrc/lz4p.cu, two walks a sequence at a time), lz4p's
// decode (csrc/lz4p.cu, a sequence at a time after a pass of prefix sums),
// the deflate links (csrc/deflate_encode.cu, a keyed table in device
// memory), the deflate tables (csrc/deflate_encode.cu, lane 0's
// package-merge), the deflate device rule's tuple-order tables
// (csrc/deflate_encode.cu, their pools in shared memory, their own
// histograms) and its greedy parse (csrc/deflate_encode.cu, a warp a row
// over windows of best values);
// and the redesigned ari encoder, DC walk, lz4 step, lz4 decoder,
// deflate decoder and lz4p decode, built from their own sources, the
// encoder stamped by warp, the others by part.  One stream each (one warp, one thread; the lz4 and rle copies
// stamp row 0 of B).  Each part of a
// step is stamped after its
// result is ready (the stamp waits on it), and its cycles are summed over
// the stream; STAMP=false runs the same copy with only the two stamps around
// the whole loop, for the step's cycles as the kernel runs it.  The
// outputs are the kernels' own, so tools/step_clocks.py holds them against
// the real kernels.  Built and run by tools/step_clocks.py.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "../tpuzip_torch/csrc/ari_encode.cu"
#include "../tpuzip_torch/csrc/bin_coder.cuh"
#include "../tpuzip_torch/csrc/dc_decode.cu"
// before namespace dfe below: deflate_encode.cu's own include of it is then
// skipped there, and its lz4s:: names are these
#include "../tpuzip_torch/csrc/lz4_shared.cuh"

// The bit model as the one-thread-a-stream kernels held it: p0 in a
// register, the APM cells of a block's 32 streams in shared memory, laid
// out [slot][thread], so a slot picked at run time is an address and not
// a register index.
namespace bin {

constexpr int THREADS = 32;  // streams a block

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
        gate[s * THREADS] = cell_init(s);
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

namespace {

namespace lz4d {
#include "../tpuzip_torch/csrc/lz4_decode.cu"
}  // namespace lz4d

namespace infl {
#include "../tpuzip_torch/csrc/inflate.cu"
}  // namespace infl

namespace lz4pn {
#include "../tpuzip_torch/csrc/lz4p.cu"
}  // namespace lz4pn

namespace dfe {
#include "../tpuzip_torch/csrc/deflate_encode.cu"
}  // namespace dfe

// clock64 once `dep` is ready: the setp waits on it, the mov after it.
__device__ __forceinline__ long long stamp(uint32_t dep) {
  long long t;
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.eq.u32 p, %1, 0x7fffffff;\n\t"
      "mov.u64 %0, %%clock64;\n\t@p add.s64 %0, %0, 1;\n\t}"
      : "=l"(t) : "r"(dep) : "memory");
  return t;
}

template <bool STAMP>
struct Clocks {
  long long t, sum[8];
  __device__ __forceinline__ void start(uint32_t dep) {
    t = stamp(dep);
    for (int i = 0; i < 8; ++i) sum[i] = 0;
  }
  __device__ __forceinline__ void lap(int part, uint32_t dep) {
    if (!STAMP) return;
    const long long now = stamp(dep);
    sum[part] += now - t;
    t = now;
  }
};

// ari encode, parts: 0 symbol, 1 table reads, 2 division, 3 multiplies,
// 4 renormalisation, 5 update, 6 chunk test and loop; 7 the whole loop.
template <bool STAMP>
__global__ void __launch_bounds__(32)
ari_encode_clocks(const uint8_t* row, int len, uint8_t* out, int cap,
                  int32_t* drow, int32_t* slen, long long* cycles,
                  uint32_t inc, uint32_t threshold) {
  using namespace ari;
  const int lane = threadIdx.x;
  uint32_t c[8];
  init(c, lane);
  uint32_t tot = 256, low = 0, rng = 0xffffffffu;
  int pos = 0, chunk_pos = 0;
  Clocks<STAMP> k;
  k.start(0);
  const long long t0 = k.t;
  for (int t0g = 0; t0g < len; t0g += 128) {
    uint32_t word = 0;
    for (int q = 0; q < 4; ++q) {
      const int i = t0g + 4 * lane + q;
      if (i < len) word |= static_cast<uint32_t>(row[i]) << (8 * q);
    }
    const int steps = min(128, len - t0g);
    for (int j = 0; j < steps; ++j) {
      const int sym =
          (__shfl_sync(FULL, word, j >> 2) >> (8 * (j & 3))) & 0xff;
      k.lap(0, sym);
      const uint32_t hi = cum_at(c, sym);
      const uint32_t below = cum_at(c, max(sym - 1, 0));
      const uint32_t lo = sym > 0 ? below : 0u;
      k.lap(1, hi ^ lo);
      const uint32_t r = rng / tot;
      k.lap(2, r);
      low += r * lo;
      rng = r * (hi - lo);
      k.lap(3, low ^ rng);
      for (int q = 0; q < 4; ++q) {
        if ((low ^ (low + rng)) >= TOP) {
          if (rng >= BOT) break;
          rng = (0u - low) & (BOT - 1);
        }
        if (lane == 0 && pos < cap) out[pos] = static_cast<uint8_t>(low >> 24);
        ++pos;
        low <<= 8;
        rng <<= 8;
      }
      k.lap(4, low ^ rng);
      tot = update(c, lane, sym, tot, inc, threshold);
      k.lap(5, tot ^ c[0] ^ c[7]);
      const int t = t0g + j;
      if ((t + 1) % CHUNK_STEPS == 0 || t + 1 == len) {
        if (lane == 0) drow[t / CHUNK_STEPS] = pos - chunk_pos;
        chunk_pos = pos;
      }
      k.lap(6, static_cast<uint32_t>(chunk_pos));
    }
  }
  const long long t1 = stamp(low ^ rng);
  if (lane < 4 && pos + lane < cap)
    out[pos + lane] = static_cast<uint8_t>(low >> (24 - 8 * lane));
  if (lane == 0) {
    *slen = pos + 4;
    for (int i = 0; i < 7; ++i) cycles[i] = k.sum[i];
    cycles[7] = t1 - t0;
  }
}

// apm decode (indexed), parts: 0 byte loads, 1 split, 2 division,
// 3 bit and coder update, 4 renormalisation, 5 model update, 6 bit packing
// and loop; 7 the whole loop.
template <bool STAMP>
__global__ void __launch_bounds__(1)
apm_decode_clocks(const uint8_t* row, const int32_t* drow, int cap, int len,
                  uint8_t* orow, long long* cycles, int bits, int rate) {
  using namespace bin;
  __shared__ int cells[APM_SLOTS * THREADS];
  auto byte_at = [&](int p) -> uint32_t { return p < cap ? row[p] : 0u; };
  Model<true> m(bits, rate, cells);
  const uint32_t denom = 1u << APM_BITS;
  uint32_t low = 0, rng = 0xffffffffu;
  uint32_t code = (byte_at(0) << 24) | (byte_at(1) << 16) |
                  (byte_at(2) << 8) | byte_at(3);
  int start = 4, pos = 4;
  Clocks<STAMP> k;
  k.start(code);
  const long long t0 = k.t;
  const int nbytes = (len + 7) / 8;
  for (int i = 0; i < nbytes; ++i) {
    if (i % CHUNK_BYTES == 0) {
      pos = start;
      start += drow[i / CHUNK_BYTES];
    }
    uint32_t byte = 0;
    const int kbits = min(8, len - 8 * i);
    for (int q = 0; q < kbits; ++q) {
      uint32_t next = (byte_at(pos) << 24) | (byte_at(pos + 1) << 16) |
                      (byte_at(pos + 2) << 8) | byte_at(pos + 3);
      k.lap(0, next);
      const uint32_t split = static_cast<uint32_t>(m.split());
      k.lap(1, split);
      const uint32_t r = rng >> APM_BITS;
      const uint32_t v = min((code - low) / r, denom - 1);
      k.lap(2, v);
      const int bit = v >= split;
      if (bit) low += r * split;
      rng = r * (bit ? denom - split : split);
      k.lap(3, low ^ rng);
      for (int j = 0; j < 4; ++j) {
        if ((low ^ (low + rng)) >= bin::TOP) {
          if (rng >= bin::BOT) break;
          rng = (0u - low) & (bin::BOT - 1);
        }
        code = (code << 8) | (next >> 24);
        next <<= 8;
        ++pos;
        low <<= 8;
        rng <<= 8;
      }
      k.lap(4, low ^ rng ^ code);
      m.update(bit);
      k.lap(5, static_cast<uint32_t>(m.p0));
      byte |= static_cast<uint32_t>(bit) << (7 - q);
      k.lap(6, byte);
    }
    orow[i] = static_cast<uint8_t>(byte);
  }
  const long long t1 = stamp(low ^ rng);
  for (int i = 0; i < 7; ++i) cycles[i] = k.sum[i];
  cycles[7] = t1 - t0;
}

// apm encode (one thread a stream, the gate in shared memory), parts:
// 0 input byte, 1 split with the gate, 2 coder products, 3 renormalisation
// with its byte stores, 4 model update, 5 chunk test and loop; 7 the
// whole loop.
template <bool STAMP>
__global__ void __launch_bounds__(1)
apm_encode_clocks(const uint8_t* row, int len, uint8_t* out, int cap,
                  int32_t* drow, int32_t* slen, long long* cycles, int bits,
                  int rate) {
  using namespace bin;
  __shared__ int cells[APM_SLOTS * THREADS];
  Model<true> m(bits, rate, cells);
  const uint32_t denom = 1u << APM_BITS;
  uint32_t low = 0, rng = 0xffffffffu;
  int pos = 0, chunk_pos = 0;
  uint32_t next = len > 0 ? row[0] : 0u;
  Clocks<STAMP> k;
  k.start(next);
  const long long t0 = k.t;
  for (int i = 0; i < len; ++i) {
    const uint32_t byte = next;
    if (i + 1 < len) next = row[i + 1];
    k.lap(0, byte);
    for (int q = 7; q >= 0; --q) {
      const int bit = (byte >> q) & 1;
      const uint32_t split = static_cast<uint32_t>(m.split());
      k.lap(1, split);
      const uint32_t r = rng >> APM_BITS;
      if (bit) low += r * split;
      rng = r * (bit ? denom - split : split);
      k.lap(2, low ^ rng);
      for (int j = 0; j < 4; ++j) {
        if ((low ^ (low + rng)) >= bin::TOP) {
          if (rng >= bin::BOT) break;
          rng = (0u - low) & (bin::BOT - 1);
        }
        if (pos < cap) out[pos] = static_cast<uint8_t>(low >> 24);
        ++pos;
        low <<= 8;
        rng <<= 8;
      }
      k.lap(3, low ^ rng);
      m.update(bit);
      k.lap(4, static_cast<uint32_t>(m.p0));
    }
    if ((i + 1) % CHUNK_BYTES == 0 || i + 1 == len) {
      drow[i / CHUNK_BYTES] = pos - chunk_pos;
      chunk_pos = pos;
    }
    k.lap(5, static_cast<uint32_t>(chunk_pos));
  }
  const long long t1 = stamp(low ^ rng);
  for (int q = 0; q < 4; ++q)
    if (pos + q < cap)
      out[pos + q] = static_cast<uint8_t>(low >> (24 - 8 * q));
  *slen = pos + 4;
  for (int i = 0; i < 7; ++i) cycles[i] = k.sum[i];
  cycles[7] = t1 - t0;
}

// The redesigned encoder (csrc/ari_encode.cu's kernel, its helpers taken
// from that source), stamped by warp: 0 the model warp's time in the
// model, 1 its waits for an empty slot, 2 the coder warp's time in its
// steps, 3 its waits for a full slot; 7 the coder warp's whole loop.
// FINE also stamps the coder's step: 4 the quotient, 5 the products and
// the correction, 6 the renormalisation (part 2 then keeps the rest).
template <bool FINE>
__global__ void __launch_bounds__(128)
ari_encode_warps(const uint8_t* row, int len, uint8_t* out, int cap,
                 int32_t* drow, int32_t* slen, long long* cycles,
                 uint32_t inc, uint32_t threshold) {
  __shared__ uint4 plan[2][ari::CHUNK_STEPS];
  __shared__ __align__(16) uint32_t tab[256], hist[256];
  const int lane = threadIdx.x & 31;
  const int nchunks = (len + ari::CHUNK_STEPS - 1) / ari::CHUNK_STEPS;
  Clocks<true> k;
  k.start(0);
  if (threadIdx.x < 32) {
    auto pair_at = [&](int q) -> uint32_t {
      const int i = q * ari::CHUNK_STEPS + 2 * lane;
      return (i < len ? row[i] : 0u) | (i + 1 < len ? row[i + 1] << 8 : 0u);
    };
    uint32_t c[8];
    ari::init(c, lane);
    uint32_t tot = 256, next = pair_at(0);
    for (int q = 0; q < nchunks; ++q) {
      const uint32_t pair = next;
      if (q + 1 < nchunks) next = pair_at(q + 1);
      k.lap(0, pair);
      if (q >= 2) bar_sync(3 + (q & 1));
      k.lap(1, 0);
      model(c, tot, pair, lane,
            min(ari::CHUNK_STEPS, len - q * ari::CHUNK_STEPS), inc,
            threshold, plan[q & 1], tab, hist);
      k.lap(0, tot ^ c[0]);
      bar_arrive(1 + (q & 1));
    }
    if (lane == 0)
      for (int i = 0; i < 2; ++i) cycles[i] = k.sum[i];
    return;
  }
  if (threadIdx.x < 64 || threadIdx.x >= 96) return;
  const long long t0 = k.t;
  uint32_t low = 0, rng = 0xffffffffu;
  int pos = 0, chunk_pos = 0;
  for (int q = 0; q < nchunks; ++q) {
    const uint4* ring = plan[q & 1];
    const int n = min(ari::CHUNK_STEPS, len - q * ari::CHUNK_STEPS);
    k.lap(2, 0);
    bar_sync(1 + (q & 1));
    k.lap(3, 0);
    uint4 s = ring[0];
#pragma unroll 2
    for (int j = 0; j < n; ++j) {
      const uint4 next = ring[min(j + 1, ari::CHUNK_STEPS - 1)];
      if (FINE) k.lap(2, s.w);
      const uint32_t r = __umulhi(rng, s.w);
      if (FINE) k.lap(4, r);
      const bool short_by_one = rng + r * s.z >= 0u - s.z;
      low += r * s.x;
      rng = r * s.y;
      if (short_by_one) {
        low += s.x;
        rng += s.y;
      }
      if (FINE) k.lap(5, low ^ rng);
      if ((low ^ (low + rng)) < ari::TOP || rng < ari::BOT) {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if ((low ^ (low + rng)) >= ari::TOP) {
            if (rng >= ari::BOT) break;
            rng = (0u - low) & (ari::BOT - 1);
          }
          if (lane == 0 && pos < cap)
            out[pos] = static_cast<uint8_t>(low >> 24);
          ++pos;
          low <<= 8;
          rng <<= 8;
        }
      }
      if (FINE) k.lap(6, low ^ rng);
      s = next;
    }
    k.lap(2, low ^ rng);
    if (q + 2 < nchunks) bar_arrive(3 + (q & 1));
    if (lane == 0) drow[q] = pos - chunk_pos;
    chunk_pos = pos;
  }
  const long long t1 = stamp(low ^ rng);
  if (lane < 4 && pos + lane < cap)
    out[pos + lane] = static_cast<uint8_t>(low >> (24 - 8 * lane));
  if (lane == 0) {
    *slen = pos + 4;
    for (int i = 2; i < 7; ++i) cycles[i] = k.sum[i];
    cycles[7] = t1 - t0;
  }
}

// The DC walk as it stood before its redesign (csrc/dc_decode.cu as ported),
// one stream, by part: 0 the compares and the lane minimum, 1 the vote,
// 2 the min reduction, 3 the target and bad, 4 the add reduction, 5 the
// update, 6 the output select with the 32-step load and store, 7 the loop
// test (`j < steps && pos < length`); cycles[8] the whole loop.
template <bool STAMP>
__global__ void __launch_bounds__(32)
dc_walk_clocks(const int32_t* vals, const int32_t* first, int length, int T,
               int32_t* starts, int32_t* run_lens, int32_t* syms,
               int32_t* err_out, long long* cycles) {
  constexpr int INF = 0x7fffffff;
  constexpr unsigned FULL = dc::FULL;
  const int lane = threadIdx.x;
  int sched[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int f = first[8 * lane + k];
    sched[k] = f < length ? f : INF;
  }
  int pos = 0;
  bool err = false;
  Clocks<STAMP> c;
  c.start(static_cast<uint32_t>(sched[0]));
  const long long t0 = c.t;
  for (int g0 = 0; g0 < T; g0 += 32) {
    const int t = g0 + lane;
    const int v = t < T ? vals[t] : 0;
    int o_start = 0, o_len = 0, o_sym = 0;
    const int steps = min(32, T - g0);
    c.lap(6, static_cast<uint32_t>(v));
    for (int j = 0; j < steps && pos < length; ++j) {
      c.lap(7, static_cast<uint32_t>(j));
      const int d = __shfl_sync(FULL, v, j);
      unsigned hit = 0;
      int low_min = INF, hit_sum = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (sched[k] == pos) {
          hit |= 1u << k;
          hit_sum += 8 * lane + k;
        } else {
          low_min = min(low_min, sched[k]);
        }
      }
      c.lap(0, hit ^ static_cast<uint32_t>(low_min ^ hit_sum ^ d));
      const bool any = __any_sync(FULL, hit != 0);
      c.lap(1, any);
      const int nxt = min(__reduce_min_sync(FULL, low_min), length);
      c.lap(2, static_cast<uint32_t>(nxt));
      const int target = static_cast<int>(static_cast<unsigned>(nxt) - 1u +
                                          static_cast<unsigned>(d));
      const bool bad = !any || (d > 0 && (target >= length || target < nxt));
      const int put = (d > 0 && !bad) ? target : INF;
      c.lap(3, static_cast<uint32_t>(put) ^ bad);
      const int sym = __reduce_add_sync(FULL, hit_sum);
      c.lap(4, static_cast<uint32_t>(sym));
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (hit & (1u << k)) sched[k] = put;
      c.lap(5, static_cast<uint32_t>(sched[0] ^ sched[1] ^ sched[2] ^
                                     sched[3] ^ sched[4] ^ sched[5] ^
                                     sched[6] ^ sched[7]));
      if (lane == j) {
        o_start = pos;
        o_len = static_cast<int>(static_cast<unsigned>(nxt) -
                                 static_cast<unsigned>(pos));
        o_sym = sym;
      }
      pos = nxt;
      err |= bad;
      c.lap(6, static_cast<uint32_t>(o_start ^ o_len ^ o_sym ^ pos));
    }
    c.lap(7, static_cast<uint32_t>(pos));
    if (t < T) {
      starts[t] = o_start;
      run_lens[t] = o_len;
      syms[t] = o_sym;
    }
    c.lap(6, static_cast<uint32_t>(o_start));
  }
  const long long t1 = stamp(static_cast<uint32_t>(pos));
  if (lane == 0) {
    *err_out = (err || pos < length) ? 1 : 0;
    for (int i = 0; i < 8; ++i) cycles[i] = c.sum[i];
    cycles[8] = t1 - t0;
  }
}

// The redesigned walk (csrc/dc_decode.cu's helpers), one stream.  Stamped,
// by part: 0 the distances' shuffles, the key and the test for the exact
// step, 1 the min reduction, 2 the limit test and the entry put back, 3 the
// merge, 4 the head kept, 5 the group's load and vote, 6 its triples, err
// and store, 7 the exact redo of a group; cycles[8] the whole loop.
// Unstamped, the kernel's own dc::walk_keyed.
template <bool STAMP>
__global__ void __launch_bounds__(32)
dc_keyed_clocks(const int32_t* vals, const int32_t* first, int length, int T,
                int32_t* starts, int32_t* run_lens, int32_t* syms,
                int32_t* err_out, long long* cycles) {
  constexpr unsigned FULL = dc::FULL;
  const int lane = threadIdx.x;
  const dc::Rows rows = {starts, run_lens, syms};
  dc::Walk w;
  dc::init(w, first, length, lane);
  Clocks<STAMP> c;
  c.start(static_cast<uint32_t>(w.s[0]));
  const long long t0 = c.t;
  if (!STAMP) {
    dc::walk_keyed(w, vals, T, length, lane, rows);
  } else {
    dc::Packed k;
    dc::pack(k, w);
    const int L8 = dc::shl8(length);
    for (int g0 = 0; g0 < T; g0 += dc::GROUP) {
      const int t = g0 + lane;
      dc::Out o = {0, 0, 0};
      if (k.ppos < L8) {
        const int v = t < T ? vals[t] : 0;
        const int steps = min(dc::GROUP, T - g0);
        const dc::Packed start = k;
        const int lim = dc::limit(v, length);
        const int lim8 = lim > -dc::SPAN ? dc::shl8(lim) : INT_MIN;
        const unsigned d8 = (static_cast<unsigned>(v) - 1u) << 8;
        int o_h = L8;
        bool odd = (k.head & ~255) != k.ppos;
        c.lap(5, static_cast<uint32_t>(lim8) ^ d8 ^ odd);
        for (int j = 0; j < steps; ++j) {
          const int lim8j = __shfl_sync(FULL, lim8, j);
          const unsigned d8j = __shfl_sync(FULL, d8, j);
          const int head = k.head, phi = head | 255;
          const int p0 = k.p[0], p1 = k.p[1];
          const bool hit = p0 == head;
          const int key = hit ? p1 : p0;
          odd |= ((head & ~255) < L8) & (((p0 <= phi) & !hit) | (p1 <= phi));
          const int kept = hit ? (L8 | (p0 & 255)) : p0;
          const unsigned moved = d8j + static_cast<unsigned>(p0 & 255);
          c.lap(0, static_cast<uint32_t>(key ^ kept ^ lim8j) ^ moved ^ odd);
          const int r = __reduce_min_sync(FULL, key);
          c.lap(1, static_cast<uint32_t>(r));
          const int x =
              (hit && r < lim8j)
                  ? static_cast<int>(static_cast<unsigned>(r & ~255) + moved)
                  : kept;
          c.lap(2, static_cast<uint32_t>(x));
          int q[8];
          q[0] = min(p1, x);
#pragma unroll
          for (int i = 1; i < 7; ++i) q[i] = max(k.p[i], min(k.p[i + 1], x));
          q[7] = max(k.p[7], x);
#pragma unroll
          for (int i = 0; i < 8; ++i) k.p[i] = q[i];
          c.lap(3, static_cast<uint32_t>(q[0] ^ q[1] ^ q[2] ^ q[3] ^ q[4] ^
                                         q[5] ^ q[6] ^ q[7]));
          if (lane == j) o_h = head;
          k.head = r;
          c.lap(4, static_cast<uint32_t>(o_h));
        }
        const bool redo = __any_sync(FULL, odd);
        c.lap(5, redo);
        if (redo) {
          dc::Walk u;
          dc::unpack(u, start);
          for (int j = 0; j < steps; ++j)
            dc::exact_step(u, o, lane == j, __shfl_sync(FULL, v, j), length);
          dc::pack(k, u);
          c.lap(7, static_cast<uint32_t>(k.ppos ^ o.sym));
        } else {
          k.ppos = k.head & ~255;
          const int down = __shfl_down_sync(FULL, o_h, 1);
          const int next = (lane == steps - 1 ? k.head : down) & ~255;
          const bool active = o_h < L8;
          if (active) {
            o.start = o_h >> 8;
            o.len = static_cast<int>((static_cast<unsigned>(next) -
                                      static_cast<unsigned>(o_h & ~255)) >>
                                     8);
            o.sym = o_h & 255;
          }
          k.err |= __any_sync(FULL, active && v > 0 && next >= lim8);
        }
      }
      dc::store(rows, t, T, o);
      c.lap(6, static_cast<uint32_t>(o.start ^ o.len ^ k.err));
    }
    w.pos = k.ppos >> 8;
    w.err = k.err;
  }
  const long long t1 = stamp(static_cast<uint32_t>(w.pos));
  if (lane == 0) {
    *err_out = (w.err || w.pos < length) ? 1 : 0;
    for (int i = 0; i < 8; ++i) cycles[i] = c.sum[i];
    cycles[8] = t1 - t0;
  }
}

// The lz4 encoder as it stood before its redesign (csrc/lz4_encode.cu as
// ported: lane 0 probes one position at a time, the table in device
// memory), one warp a row and a table a row, B rows at once.  Block 0's
// cycles by part: 0 the 4 bytes at i and their hash, 1 the table read, 2
// the table write (a store, not awaited), 3 the candidate's 4 bytes and
// the compare, 4 the match extension, 5 the writes of a sequence, 6 the
// shuffles and the test after a probe run; cycles[7] the whole row, [8]
// its probes, [9] its matches.
namespace lz4_old {

constexpr int MIN_MATCH = 4, MF_LIMIT = 12, LAST_LITERALS = 5;
constexpr uint32_t HASH_MUL = 2654435761u;
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t load4(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (uint32_t(p[3]) << 24);
}

__device__ __forceinline__ int put_ext(uint8_t* dst, int o, int len,
                                       int lane) {
  const int rem = len - 15;
  const int cnt = rem / 255 + 1;
  for (int k = lane; k < cnt; k += 32)
    dst[o + k] = static_cast<uint8_t>(k < cnt - 1 ? 255 : rem % 255);
  return cnt;
}

__device__ __forceinline__ int put_literals(uint8_t* dst, int o,
                                            const uint8_t* src, int anchor,
                                            int lit, int ml_nibble,
                                            int lane) {
  if (lane == 0)
    dst[o] = static_cast<uint8_t>((min(lit, 15) << 4) | ml_nibble);
  ++o;
  if (lit >= 15) o += put_ext(dst, o, lit, lane);
  for (int k = lane; k < lit; k += 32) dst[o + k] = src[anchor + k];
  return o + lit;
}

}  // namespace lz4_old

template <bool STAMP>
__global__ void __launch_bounds__(32)
lz4_encode_clocks(const uint8_t* blocks, const int32_t* lengths, int n,
                  uint8_t* comp, int cap, int32_t* clens, int32_t* tables,
                  int hash_log, long long* cycles) {
  using namespace lz4_old;
  const int lane = threadIdx.x;
  const int row = blockIdx.x;
  int32_t* table = tables + (static_cast<size_t>(row) << hash_log);
  const uint8_t* src = blocks + static_cast<size_t>(row) * n;
  uint8_t* dst = comp + static_cast<size_t>(row) * cap;
  const int len = min(max(lengths[row], 0), n);
  for (int k = lane; k < (1 << hash_log) / 4; k += 32)
    reinterpret_cast<int4*>(table)[k] = make_int4(-1, -1, -1, -1);
  __syncwarp();
  const int limit = max(len - MF_LIMIT, 0);
  const int end = len - LAST_LITERALS;
  int i = 0, anchor = 0, o = 0;
  long long probes = 0, matches = 0;
  Clocks<STAMP> k;
  k.start(0);
  const long long t0 = k.t;
  for (;;) {
    int cand = -1;
    if (lane == 0) {
      for (; i < limit; ++i) {
        ++probes;
        const uint32_t seq = load4(src + i);
        const uint32_t h = (seq * HASH_MUL) >> (32 - hash_log);
        k.lap(0, h);
        const int c = table[h];
        k.lap(1, static_cast<uint32_t>(c));
        table[h] = i;
        k.lap(2, static_cast<uint32_t>(i));
        const bool ok = c >= 0 && i - c <= 0xFFFF && load4(src + c) == seq;
        k.lap(3, ok);
        if (ok) {
          cand = c;
          break;
        }
      }
    }
    i = __shfl_sync(FULL, i, 0);
    cand = __shfl_sync(FULL, cand, 0);
    k.lap(6, static_cast<uint32_t>(i ^ cand));
    if (cand < 0) break;
    ++matches;
    int m = i + MIN_MATCH;
    for (int c = cand + MIN_MATCH;; m += 32, c += 32) {
      const int p = m + lane;
      const bool stop = p >= end || src[p] != src[c + lane];
      const unsigned hit = __ballot_sync(FULL, stop);
      if (hit) {
        m += __ffs(hit) - 1;
        break;
      }
    }
    k.lap(4, static_cast<uint32_t>(m));
    const int ml = m - i - MIN_MATCH;
    o = put_literals(dst, o, src, anchor, i - anchor, min(ml, 15), lane);
    if (lane == 0) {
      dst[o] = static_cast<uint8_t>((i - cand) & 0xFF);
      dst[o + 1] = static_cast<uint8_t>((i - cand) >> 8);
    }
    o += 2;
    if (ml >= 15) o += put_ext(dst, o, ml, lane);
    i = anchor = m;
    k.lap(5, static_cast<uint32_t>(o));
  }
  o = put_literals(dst, o, src, anchor, len - anchor, 0, lane);
  const long long t1 = stamp(static_cast<uint32_t>(o));
  if (lane == 0) {
    clens[row] = o;
    if (row == 0) {
      for (int p = 0; p < 7; ++p) cycles[p] = k.sum[p];
      cycles[7] = t1 - t0;
      cycles[8] = probes;
      cycles[9] = matches;
    }
  }
}

// The redesigned lz4 step (csrc/lz4_encode.cu's encode_row, copied here
// with its stamps), one warp a row, B rows at once, the table in device
// memory (one a row, int32) or, with SHARED, in shared memory as u16
// beside the row's bytes; the window first_width positions wide at the
// row's start and after a match (the source's FIRST_WIDTH), 32 after a
// window without one.  Block 0's cycles by part: 0 the 4 bytes at each
// lane's position and their hash, 1 __match_any_sync, 2 the table read,
// 3 the candidate's 4 bytes, the compare and the ballots, 4 the table
// write and __syncwarp, 5 the match extension, 6 the writes of a sequence;
// cycles[7] the whole row, [8] its steps, [9] its matches.
namespace lz4_new {

struct SharedTable {
  uint16_t* slot;
  __device__ __forceinline__ int get(uint32_t h) const {
    return static_cast<int>(slot[h]) - 1;
  }
  __device__ __forceinline__ void put(uint32_t h, int pos) const {
    slot[h] = static_cast<uint16_t>(pos + 1);
  }
};

struct DeviceTable {
  int32_t* slot;
  __device__ __forceinline__ int get(uint32_t h) const { return slot[h]; }
  __device__ __forceinline__ void put(uint32_t h, int pos) const {
    slot[h] = pos;
  }
};

}  // namespace lz4_new

template <bool SHARED, bool STAMP>
__global__ void __launch_bounds__(32)
lz4_step_clocks(const uint8_t* blocks, const int32_t* lengths, int n,
                uint8_t* comp, int cap, int32_t* clens, int32_t* tables,
                int hash_log, int first_width, long long* cycles) {
  using namespace lz4_old;
  using Table = std::conditional_t<SHARED, lz4_new::SharedTable,
                                   lz4_new::DeviceTable>;
  extern __shared__ int4 smem[];
  const int lane = threadIdx.x;
  const int row = blockIdx.x;
  const uint8_t* src = blocks + static_cast<size_t>(row) * n;
  uint8_t* dst = comp + static_cast<size_t>(row) * cap;
  const int len = min(max(lengths[row], 0), n);
  Table table;
  if constexpr (SHARED) {
    table.slot = reinterpret_cast<uint16_t*>(smem);
    int4* buf = smem + (2 << hash_log) / 16;
    for (int k = lane; k < (2 << hash_log) / 16; k += 32)
      smem[k] = make_int4(0, 0, 0, 0);
    for (int k = lane; k < (len + 15) / 16; k += 32)
      buf[k] = reinterpret_cast<const int4*>(src)[k];
    src = reinterpret_cast<const uint8_t*>(buf);
  } else {
    table.slot = tables + (static_cast<size_t>(row) << hash_log);
    for (int k = lane; k < (1 << hash_log) / 4; k += 32)
      reinterpret_cast<int4*>(table.slot)[k] = make_int4(-1, -1, -1, -1);
  }
  __syncwarp();
  const int limit = max(len - MF_LIMIT, 0);
  const int end = len - LAST_LITERALS;
  const unsigned upto_me = (2u << lane) - 1;
  int i = 0, anchor = 0, o = 0, width = first_width;
  long long steps = 0, matches = 0;
  Clocks<STAMP> k;
  k.start(0);
  const long long t0 = k.t;
  while (i < limit) {
    ++steps;
    const int p = i + lane;
    const bool live = lane < width && p < limit;
    const uint32_t seq = live ? load4(src + p) : 0;
    const uint32_t h = live ? (seq * HASH_MUL) >> (32 - hash_log) : FULL;
    k.lap(0, h);
    const unsigned group = __match_any_sync(FULL, h);
    k.lap(1, group);
    const unsigned earlier = group & upto_me & ~(1u << lane);
    const int c = earlier ? i + 31 - __clz(earlier)
                          : (live ? table.get(h) : -1);
    k.lap(2, static_cast<uint32_t>(c));
    const bool ok = live && c >= 0 && p - c <= 0xFFFF &&
                    load4(src + c) == seq;
    const unsigned hits = __ballot_sync(FULL, ok);
    const unsigned first = hits & (0u - hits);
    const unsigned probed = __ballot_sync(FULL, live) & (first | (first - 1));
    k.lap(3, hits ^ probed);
    if ((probed >> lane & 1) && !(group & probed & ~upto_me))
      table.put(h, p);
    __syncwarp();
    k.lap(4, probed);
    if (!hits) {
      i += width;
      width = 32;
      continue;
    }
    ++matches;
    const int kk = __ffs(hits) - 1;
    const int at = i + kk;
    const int cand = __shfl_sync(FULL, c, kk);
    int m = at + MIN_MATCH;
    for (int cc = cand + MIN_MATCH;; m += 32, cc += 32) {
      const int q = m + lane;
      const bool stop = q >= end || src[q] != src[cc + lane];
      const unsigned hit = __ballot_sync(FULL, stop);
      if (hit) {
        m += __ffs(hit) - 1;
        break;
      }
    }
    k.lap(5, static_cast<uint32_t>(m));
    const int ml = m - at - MIN_MATCH;
    o = put_literals(dst, o, src, anchor, at - anchor, min(ml, 15), lane);
    if (lane == 0) {
      dst[o] = static_cast<uint8_t>((at - cand) & 0xFF);
      dst[o + 1] = static_cast<uint8_t>((at - cand) >> 8);
    }
    o += 2;
    if (ml >= 15) o += put_ext(dst, o, ml, lane);
    i = anchor = m;
    width = first_width;
    k.lap(6, static_cast<uint32_t>(o));
  }
  o = put_literals(dst, o, src, anchor, len - anchor, 0, lane);
  const long long t1 = stamp(static_cast<uint32_t>(o));
  if (lane == 0) {
    clens[row] = o;
    if (row == 0) {
      for (int q = 0; q < 7; ++q) cycles[q] = k.sum[q];
      cycles[7] = t1 - t0;
      cycles[8] = steps;
      cycles[9] = matches;
    }
  }
}

// The lz4 decoder as it stood before its redesign (csrc/lz4_decode.cu as
// ported: one warp a row, a sequence at a time, every byte from device
// memory), B rows at once.  Block 0's cycles by part: 0 the token load,
// 1 the literal and match length extensions, 2 the literal copy, 3 the
// offset load, 4 the match copy, 5 the two __syncwarp()s; cycles[7] the
// whole row, [8] its sequences, [9] its matches.
namespace lz4_dec_old {

constexpr int MIN_MATCH = 4;

__device__ __forceinline__ bool length_ext(const uint8_t* src, int n, int& i,
                                           long long& len) {
  for (;;) {
    if (i >= n) return false;
    const int b = src[i++];
    len += b;
    if (b != 255) return true;
  }
}

}  // namespace lz4_dec_old

template <bool STAMP>
__global__ void __launch_bounds__(32)
lz4_decode_clocks(const uint8_t* comp, const int32_t* clens, int w,
                  uint8_t* out, int out_cap, int64_t* status,
                  long long* cycles) {
  using namespace lz4_dec_old;
  const int lane = threadIdx.x;
  const int row = blockIdx.x;
  const uint8_t* src = comp + static_cast<size_t>(row) * w;
  uint8_t* dst = out + static_cast<size_t>(row) * out_cap;
  const int n = min(max(clens[row], 0), w);
  int i = 0, o = 0;
  bool bad = false;
  long long seqs = 0, matches = 0;
  Clocks<STAMP> c;
  c.start(0);
  const long long t0 = c.t;
  while (i < n) {
    ++seqs;
    const int token = src[i++];
    c.lap(0, token);
    long long lit = token >> 4;
    if (lit == 15 && !length_ext(src, n, i, lit)) {
      bad = true;
      break;
    }
    c.lap(1, static_cast<uint32_t>(lit));
    if (i + lit > n || o + lit > out_cap) {
      bad = true;
      break;
    }
    for (int k = lane; k < lit; k += 32) dst[o + k] = src[i + k];
    i += static_cast<int>(lit);
    o += static_cast<int>(lit);
    c.lap(2, static_cast<uint32_t>(o));
    if (i >= n) break;
    if (i + 2 > n) {
      bad = true;
      break;
    }
    const int off = src[i] | (src[i + 1] << 8);
    i += 2;
    c.lap(3, off);
    if (off == 0 || off > o) {
      bad = true;
      break;
    }
    long long ml = (token & 15) + MIN_MATCH;
    if ((token & 15) == 15 && !length_ext(src, n, i, ml)) {
      bad = true;
      break;
    }
    c.lap(1, static_cast<uint32_t>(ml));
    if (o + ml > out_cap) {
      bad = true;
      break;
    }
    ++matches;
    __syncwarp();
    c.lap(5, static_cast<uint32_t>(o));
    const int from = o - off;
    const int mlen = static_cast<int>(ml);
    if (off >= mlen) {
      for (int k = lane; k < mlen; k += 32) dst[o + k] = dst[from + k];
    } else {
      for (int k = lane; k < mlen; k += 32) dst[o + k] = dst[from + k % off];
    }
    o += mlen;
    c.lap(4, static_cast<uint32_t>(o));
    __syncwarp();
    c.lap(5, static_cast<uint32_t>(o));
  }
  const long long t1 = stamp(static_cast<uint32_t>(o));
  __syncwarp();
  for (int k = (bad ? 0 : o) + lane; k < out_cap; k += 32) dst[k] = 0;
  if (lane == 0) {
    status[row] = bad ? -1 : o;
    if (row == 0) {
      for (int p = 0; p < 7; ++p) cycles[p] = c.sum[p];
      cycles[7] = t1 - t0;
      cycles[8] = seqs;
      cycles[9] = matches;
    }
  }
}

// The rle decoder as it stood before its redesign (csrc/rle.cu's
// rle_decode_kernel as ported: one thread a row, a byte loop), B rows at
// once.  Block 0's cycles by part: 0 the byte's load, 1 the out_cap test
// and the byte's store, 2 the compare with the byte before it, 3 a
// count's bytes (loads), 4 the fill's stores; cycles[7] the whole loop,
// [8] its stream bytes, [9] its counts.
template <bool STAMP>
__global__ void __launch_bounds__(1)
rle_decode_clocks(const uint8_t* comp, const int32_t* clens, int w,
                  uint8_t* out, int out_cap, int64_t* status,
                  long long* cycles) {
  const int row = blockIdx.x;
  const uint8_t* src = comp + static_cast<size_t>(row) * w;
  uint8_t* dst = out + static_cast<size_t>(row) * out_cap;
  const int n = min(max(clens[row], 0), w);
  int i = 0, o = 0, prev = -1;
  bool bad = false;
  long long counts = 0;
  Clocks<STAMP> c;
  c.start(0);
  const long long t0 = c.t;
  while (i < n && !bad) {
    const int b = src[i++];
    c.lap(0, b);
    if (o >= out_cap) {
      bad = true;
      break;
    }
    dst[o++] = static_cast<uint8_t>(b);
    c.lap(1, o);
    if (b != prev) {
      prev = b;
      c.lap(2, prev);
      continue;
    }
    c.lap(2, prev);
    ++counts;
    long long extra = 0;
    for (;;) {
      if (i >= n) {
        bad = true;
        break;
      }
      const int x = src[i++];
      extra += x;
      if (x != 255) break;
    }
    c.lap(3, static_cast<uint32_t>(extra));
    if (bad || o + extra > out_cap) {
      bad = true;
      break;
    }
    for (int k = 0; k < extra; ++k) dst[o + k] = static_cast<uint8_t>(b);
    o += static_cast<int>(extra);
    prev = -1;
    c.lap(4, o);
  }
  const long long t1 = stamp(static_cast<uint32_t>(o));
  for (int k = bad ? 0 : o; k < out_cap; ++k) dst[k] = 0;
  status[row] = bad ? -1 : o;
  if (row == 0) {
    for (int p = 0; p < 7; ++p) cycles[p] = c.sum[p];
    cycles[7] = t1 - t0;
    cycles[8] = i;
    cycles[9] = counts;
  }
}

// The redesigned lz4 decoder (csrc/lz4_decode.cu's kernel, copied here
// with its stamps, its helpers taken from that source), one warp a row,
// B rows at once.  Block 0's cycles by part: 0 the stream's staging and
// each lane's 4 places, 1 the jump tables and the batch's starts, 2 each
// lane's sequence, the scan and the checks, 3 the literals into the
// history, 4 the matches' rounds, 5 the batch's bytes out to device
// memory, 6 the sequences parsed alone; cycles[7] the whole row, [8] its
// batches, [9] their rounds, [10] its sequences parsed alone, [11] its
// sequences in batches.
template <bool STAMP>
__global__ void __launch_bounds__(32)
lz4_decode_new_clocks(const uint8_t* comp, const int32_t* clens, int w,
                      uint8_t* out, int out_cap, int64_t* status,
                      long long* cycles) {
  using namespace lz4d;
  __shared__ __align__(16) uint8_t ring[RING];
  __shared__ __align__(16) uint8_t hist[HIST + 16];
  const int lane = threadIdx.x;
  const int row = blockIdx.x;
  const uint8_t* src = comp + static_cast<size_t>(row) * w;
  uint8_t* dst = out + static_cast<size_t>(row) * out_cap;
  const int skew = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  Stream s{ring, src - skew, skew, min(max(clens[row], 0), w), 0};
  s.start();
  const int n = s.n;
  int i = 0, o = 0;
  int hist_lo = 0;
  bool bad = false;
  long long batches = 0, rounds = 0, alone = 0, seqs = 0;
  Clocks<STAMP> c;
  c.start(0);
  const long long t0 = c.t;
  while (i < n) {
    s.need(min(i + 2 * END_MAX, n - 1));
    const int lim = min(min(n, s.end()) - i, END_MAX);
    unsigned jump = 0;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int q = 4 * lane + r;
      const Sequence sq(s, i + q);
      const int e = sq.end - i;
      jump |= static_cast<unsigned>(e <= lim && !sq.long_ext ? e : q)
              << (8 * r);
    }
    c.lap(0, jump);
    unsigned jumps[5];
    jumps[0] = jump;
#pragma unroll
    for (int l = 1; l < 5; ++l) {
      jumps[l] = 0;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        jumps[l] |= static_cast<unsigned>(hop(
                        jumps[l - 1], (jumps[l - 1] >> (8 * r)) & 255))
                    << (8 * r);
    }
    int pos = 0;
#pragma unroll
    for (int l = 0; l < 5; ++l) {
      const int p = hop(jumps[l], pos);
      if ((lane >> l) & 1) pos = p;
    }
    const int next = hop(jump, pos);
    const int count = __popc(__ballot_sync(
        FULL, pos < WIN && next != pos && lane < BATCH));
    const int p = count < 32 ? __shfl_sync(FULL, pos, count & 31)
                             : __shfl_sync(FULL, next, 31);
    const bool stopped = count < BATCH && p < WIN;
    c.lap(1, p + count);
    ++batches;
    seqs += count;
    int lit = 0, ml = 0, off = 1, from = 0;
    if (lane < count) {
      const Sequence sq(s, i + pos);
      lit = sq.lit;
      ml = sq.ml;
      from = sq.from;
      off = s.at(sq.off_at) | (s.at(sq.off_at + 1) << 8);
    }
    int incl = lit + ml;
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += u;
    }
    const int start = o + incl - lit - ml;
    const int mo = start + lit;
    if (__any_sync(FULL, lane < count && (off == 0 || off > mo ||
                                          mo + ml > out_cap))) {
      bad = true;
      break;
    }
    c.lap(2, start);
#pragma unroll
    for (int r = 0; r < 16; ++r)
      hist[r < lit ? (start + r) & (HIST - 1) : HIST] = s.at(from + r);
    for (int r = 16; r < lit; ++r)
      hist[(start + r) & (HIST - 1)] = s.at(from + r);
    c.lap(3, lit);
    const int end = o + __shfl_sync(FULL, incl, 31);
    {
      const Out h{dst, hist, max(hist_lo, end - HIST), o};
      bool pending = lane < count;
      __syncwarp();
      for (;;) {
        const int first = __reduce_min_sync(FULL, pending ? mo : NONE);
        if (first == NONE) break;
        ++rounds;
        const bool ready = pending && mo - off + min(off, ml) <= first;
        if (ready && ml <= LANE_BYTES) copy_lane<true>(h, mo, off, ml);
        for (unsigned wide = __ballot_sync(FULL, ready && ml > LANE_BYTES);
             wide; wide &= wide - 1) {
          const int l = __ffs(wide) - 1;
          copy_warp<true>(h, __shfl_sync(FULL, mo, l),
                          __shfl_sync(FULL, off, l),
                          __shfl_sync(FULL, ml, l));
        }
        pending = pending && !ready;
        __syncwarp();
      }
    }
    c.lap(4, static_cast<uint32_t>(rounds));
    for (int k = o + lane; k < end; k += 32) dst[k] = hist[k & (HIST - 1)];
    o = end;
    i += p;
    c.lap(5, o);
    if (!stopped || i >= n) continue;
    ++alone;
    s.need(i);
    const int token = s.at(i++);
    long long run = token >> 4;
    if (run == 15 && !length_ext(s, i, run)) {
      bad = true;
      break;
    }
    if (i + run > n || o + run > out_cap) {
      bad = true;
      break;
    }
    for (int left = static_cast<int>(run); left > 0;) {
      s.need(i);
      const int part = min(left, s.end() - i);
      for (int k = lane; k < part; k += 32) dst[o + k] = s.at(i + k);
      i += part;
      o += part;
      left -= part;
    }
    hist_lo = o;
    if (i >= n) break;
    if (i + 2 > n) {
      bad = true;
      break;
    }
    s.need(i + 1);
    const int offset = s.at(i) | (s.at(i + 1) << 8);
    i += 2;
    if (offset == 0 || offset > o) {
      bad = true;
      break;
    }
    long long len = (token & 15) + MIN_MATCH;
    if ((token & 15) == 15 && !length_ext(s, i, len)) {
      bad = true;
      break;
    }
    if (o + len > out_cap) {
      bad = true;
      break;
    }
    resolve<false>(Out{dst, hist, NONE, o}, o, offset,
                   static_cast<int>(len), 1);
    o += static_cast<int>(len);
    hist_lo = o;
    c.lap(6, o);
  }
  const long long t1 = stamp(static_cast<uint32_t>(o));
  cp_wait<0>();
  __syncwarp();
  warp_zero(dst, bad ? 0 : o, out_cap);
  if (lane == 0) {
    status[row] = bad ? -1 : o;
    if (row == 0) {
      for (int k = 0; k < 7; ++k) cycles[k] = c.sum[k];
      cycles[7] = t1 - t0;
      cycles[8] = batches;
      cycles[9] = rounds;
      cycles[10] = alone;
      cycles[11] = seqs;
    }
  }
}

// The chained lz4 parse as it stood before its redesign (csrc/lz4_chain.cu's
// parse kernel: one warp a row, a window of 32 positions probed a lane
// each, every link and byte from device memory), B rows at once, the
// lanes' chain walks run in lock step (a lane whose walk has ended idles)
// so that each part is the warp's.  Block 0's cycles by part: 0 the links'
// loads (prev[p], then prev[c] a link), 1 the cheap rejects' byte loads and
// compares, 2 the extensions, 3 the parse's ballots, shuffles and lazy
// tests, 4 the writes of a sequence; cycles[7] the whole row, [8] its
// windows, [9] the positions probed, [10] those whose best the parse read,
// [11] its matches, [12] the links walked over all lanes, [13] those walked
// for positions the parse read.
namespace chain_old {

constexpr int WINDOW = 0xFFFF;

__device__ __forceinline__ uint32_t load4_aligned(const uint8_t* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~uintptr_t{3});
  const unsigned shift = (a & 3) * 8;
  return shift ? __funnelshift_r(w[0], w[1], shift) : w[0];
}

__device__ __forceinline__ int extend(const uint8_t* src, int c, int p,
                                      int most) {
  for (int m = 0; m < most; m += 4) {
    const uint32_t d = load4_aligned(src + c + m) ^ load4_aligned(src + p + m);
    if (d) return min(m + ((__ffs(d) - 1) >> 3), most);
  }
  return max(most, 0);
}

}  // namespace chain_old

template <bool STAMP>
__global__ void __launch_bounds__(32)
chain_parse_clocks(const uint8_t* blocks, const int32_t* lengths,
                   const int32_t* prev, int n, int max_chain, uint8_t* comp,
                   int cap, int32_t* clens, long long* cycles) {
  using namespace lz4_old;
  using namespace chain_old;
  const int lane = threadIdx.x;
  const int row = blockIdx.x;
  const uint8_t* src = blocks + static_cast<size_t>(row) * n;
  const int32_t* prv = prev + static_cast<size_t>(row) * n;
  uint8_t* dst = comp + static_cast<size_t>(row) * cap;
  const int len = min(max(lengths[row], 0), n);
  const int limit = max(len - MF_LIMIT, 0);
  const int lim = len - LAST_LITERALS;
  long long windows = 0, probed = 0, read = 0, matches = 0, links = 0,
            links_read = 0;
  Clocks<STAMP> k;
  k.start(0);
  const long long t0 = k.t;
  int wbase = 0, best_l = 0, at_l = -1, walked = 0;
  bool used = false;
  // the window just left: its lanes' links, and those of the lanes read
  auto account = [&]() {
    links += __reduce_add_sync(FULL, walked);
    links_read += __reduce_add_sync(FULL, used ? walked : 0);
    read += __popc(__ballot_sync(FULL, used));
  };
  auto probe = [&](int from) {
    account();
    ++windows;
    wbase = from;
    used = false;
    walked = 0;
    const int p = from + lane;
    bool on = p < limit;
    probed += __popc(__ballot_sync(FULL, on));
    int best = 0, at = -1, chain = max_chain;
    int c = on ? prv[p] : -1;
    k.lap(0, static_cast<uint32_t>(c));
    on = on && c >= 0 && c < p && p - c <= WINDOW && chain > 0;
    while (__any_sync(FULL, on)) {
      walked += on;
      const bool pass = on && src[c + best] == src[p + best];
      k.lap(1, pass);
      bool stop = false;
      if (__any_sync(FULL, pass)) {
        const int m = pass ? extend(src, c, p, lim - p) : 0;
        k.lap(2, static_cast<uint32_t>(m));
        if (pass && m > best) {
          best = m;
          at = c;
          stop = p + m >= lim;
        }
      }
      if (on && !stop) c = prv[c];
      k.lap(0, static_cast<uint32_t>(c));
      --chain;
      on = on && !stop && c >= 0 && c < p && p - c <= WINDOW && chain > 0;
    }
    best_l = best;
    at_l = at;
  };
  probe(0);
  int i = 0, anchor = 0, o = 0;
  while (i < limit) {
    if (i >= wbase + 32) probe(i);
    const unsigned hits =
        __ballot_sync(FULL, best_l >= MIN_MATCH && wbase + lane >= i);
    if (!hits) {
      used |= wbase + lane >= i && wbase + lane < limit;
      i = wbase + 32;
      k.lap(3, hits);
      continue;
    }
    ++matches;
    int at = wbase + __ffs(hits) - 1;
    used |= wbase + lane >= i && wbase + lane <= at;
    int best = __shfl_sync(FULL, best_l, at - wbase);
    while (at + 1 < limit) {
      if (at + 1 >= wbase + 32) probe(at);
      const int next = __shfl_sync(FULL, best_l, at + 1 - wbase);
      used |= wbase + lane == at + 1;
      if (next <= best) break;
      ++at;
      best = next;
    }
    const int c = __shfl_sync(FULL, at_l, at - wbase);
    used |= wbase + lane == at;
    k.lap(3, static_cast<uint32_t>(c));
    const int ml = best - MIN_MATCH;
    o = put_literals(dst, o, src, anchor, at - anchor, min(ml, 15), lane);
    if (lane == 0) {
      dst[o] = static_cast<uint8_t>((at - c) & 0xFF);
      dst[o + 1] = static_cast<uint8_t>((at - c) >> 8);
    }
    o += 2;
    if (ml >= 15) o += put_ext(dst, o, ml, lane);
    i = anchor = at + best;
    k.lap(4, static_cast<uint32_t>(o));
  }
  o = put_literals(dst, o, src, anchor, len - anchor, 0, lane);
  account();
  const long long t1 = stamp(static_cast<uint32_t>(o));
  if (lane == 0) {
    clens[row] = o;
    if (row == 0) {
      for (int q = 0; q < 7; ++q) cycles[q] = k.sum[q];
      cycles[7] = t1 - t0;
      cycles[8] = windows;
      cycles[9] = probed;
      cycles[10] = read;
      cycles[11] = matches;
      cycles[12] = links;
      cycles[13] = links_read;
    }
  }
}

// The dense lz4 encoder's candidates step as it stood before its redesign
// (csrc/lz4_dense.cu's keyed instance, the route of compress_from_device's
// 15 bits: one warp a row, 32 positions a step, a keyed table of 8-byte
// slots in device memory), B rows at once.  Block 0's cycles by part: 0 the
// 4 bytes at each lane's position, the hash and __match_any_sync, 1 the
// table read (keyed_find, or the group's earlier lane), 2 the table write
// (keyed_put between the two __syncwarp), 3 the verify load of the
// candidate's 4 bytes, the filter and the store of cand, 4 the closing
// __syncwarp; cycles[7] the whole row, [8] its steps, [9] the keyed slots
// read past the first (probe lengths over the lanes).  KEYED=false runs the
// direct route instead (2^bits int32 slots a row in device memory, salted
// as the source salted them), which the source took at 15 bits before it
// lost to the keyed tables (PERF.md section 6).
namespace dense_old {

constexpr uint32_t SLOT_MUL = 0x9E3779B1u;
constexpr unsigned long long EMPTY = ~0ull;

__device__ __forceinline__ uint32_t keyed_slot(uint32_t h, uint32_t salt,
                                               int slots_log) {
  return ((h ^ salt) * SLOT_MUL) >> (32 - slots_log);
}

__device__ __forceinline__ int keyed_find(const unsigned long long* t,
                                          uint32_t h, uint32_t salt,
                                          int slots_log, int& extra) {
  const uint32_t mask = (1u << slots_log) - 1;
  for (uint32_t s = keyed_slot(h, salt, slots_log);; s = (s + 1) & mask) {
    const unsigned long long v = t[s];
    if (v == EMPTY) return -1;
    if (static_cast<uint32_t>(v) == h) return static_cast<int>(v >> 32);
    ++extra;
  }
}

__device__ __forceinline__ void keyed_put(unsigned long long* t, uint32_t h,
                                          uint32_t salt, int p,
                                          int slots_log) {
  const uint32_t mask = (1u << slots_log) - 1;
  const unsigned long long entry =
      static_cast<unsigned long long>(static_cast<uint32_t>(p)) << 32 | h;
  for (uint32_t s = keyed_slot(h, salt, slots_log);; s = (s + 1) & mask) {
    unsigned long long v = t[s];
    if (v == EMPTY) {
      v = atomicCAS(t + s, EMPTY, entry);
      if (v == EMPTY) return;
    }
    if (static_cast<uint32_t>(v) == h) {
      t[s] = entry;
      return;
    }
  }
}

}  // namespace dense_old

template <bool KEYED, bool STAMP>
__global__ void __launch_bounds__(32)
dense_candidates_clocks(const uint8_t* blocks, const int32_t* lengths,
                        int n, int32_t* cand, unsigned long long* tables,
                        int bits, int slots_log, long long* cycles) {
  using namespace lz4_old;
  using namespace dense_old;
  const int lane = threadIdx.x;
  const int row = blockIdx.x;
  const unsigned below = (1u << lane) - 1;
  const unsigned above = ~((2u << lane) - 1);
  const int tlog = KEYED ? slots_log : bits;
  const size_t words =
      max((size_t{1} << tlog) * (KEYED ? 8 : 4) / 16, size_t{1});
  int4* table = reinterpret_cast<int4*>(tables) + row * words;
  unsigned long long* keyed = reinterpret_cast<unsigned long long*>(table);
  int32_t* direct = reinterpret_cast<int32_t*>(table);
  for (size_t q = lane; q < words; q += 32)
    table[q] = make_int4(-1, -1, -1, -1);
  __syncwarp();
  const uint8_t* src = blocks + static_cast<size_t>(row) * n;
  int32_t* out = cand + static_cast<size_t>(row) * n;
  const int len = min(max(lengths[row], 0), n);
  const int limit = max(len - MF_LIMIT, 0);
  const uint32_t salt = static_cast<uint32_t>(row) * SLOT_MUL;
  const uint32_t dslot_salt = bits ? salt >> (32 - bits) : 0u;
  long long steps = 0;
  int extra = 0;
  Clocks<STAMP> k;
  k.start(0);
  const long long t0 = k.t;
  for (int base = 0; base < limit; base += 32) {
    ++steps;
    const int p = base + lane;
    const bool live = p < limit;
    const uint32_t seq = live ? load4(src + p) : 0;
    const uint32_t h = bits ? (seq * HASH_MUL) >> (32 - bits) : 0u;
    const unsigned lanes = __ballot_sync(FULL, live);
    unsigned group = 0;
    if (live) group = __match_any_sync(lanes, h);
    k.lap(0, group);
    const unsigned earlier = group & below;
    int c = -1;
    if (live)
      c = earlier ? base + 31 - __clz(earlier)
            : KEYED ? keyed_find(keyed, h, salt, slots_log, extra)
                    : direct[h ^ dslot_salt];
    k.lap(1, static_cast<uint32_t>(c));
    __syncwarp();
    if (live && !(group & above)) {
      if (KEYED)
        keyed_put(keyed, h, salt, p, slots_log);
      else
        direct[h ^ dslot_salt] = p;
    }
    __syncwarp();
    k.lap(2, group);
    const int kept =
        live && c >= 0 && p - c <= 0xFFFF && load4(src + c) == seq ? c : -1;
    if (live) out[p] = kept;
    k.lap(3, static_cast<uint32_t>(kept));
    __syncwarp();
    k.lap(4, 0);
  }
  for (int p = limit + lane; p < n; p += 32) out[p] = -1;
  const long long t1 = stamp(static_cast<uint32_t>(steps));
  const int extra_all = __reduce_add_sync(FULL, extra);
  if (lane == 0 && row == 0) {
    for (int q = 0; q < 7; ++q) cycles[q] = k.sum[q];
    cycles[7] = t1 - t0;
    cycles[8] = steps;
    cycles[9] = extra_all;
  }
}
// The deflate decoder as it stood before its redesign (csrc/inflate.cu as
// ported: one warp a stream, lane 0 decoding from a byte-at-a-time bit
// reader and the canonical tables (a 10-bit root table and the count/
// symbol walk past it), the warp copying each match), B rows at once, one
// warp a block.  Lane 0 of block 0 stamps by part: 0 the byte fill, 1 the
// root lookup, 2 the walk past the root, 3 the literal store, 4 the extra
// bits and the match's checks, 5 the match's hand-off to the warp (its
// shuffles and two __syncwarp) and its copy, 6 block headers and table
// builds and stored blocks; cycles[7] the whole stream, [8] its symbols
// (literals, matches and block ends), [9] its matches, [10] its literals.
namespace inflate_old {

constexpr int FAST_BITS = 10;

__constant__ int16_t kLenBase[29] = {3,   4,   5,   6,   7,  8,  9,  10,
                                     11,  13,  15,  17,  19, 23, 27, 31,
                                     35,  43,  51,  59,  67, 83, 99, 115,
                                     131, 163, 195, 227, 258};
__constant__ int8_t kLenEb[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                                  2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
__constant__ int32_t kDistBase[30] = {
    1,    2,    3,    4,    5,    7,     9,     13,    17,    25,
    33,   49,   65,   97,   129,  193,   257,   385,   513,   769,
    1025, 1537, 2049, 3073, 4097, 6145,  8193,  12289, 16385, 24577};
__constant__ int8_t kDistEb[30] = {0, 0, 0, 0, 1, 1, 2,  2,  3,  3,
                                   4, 4, 5, 5, 6, 6, 7,  7,  8,  8,
                                   9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
__constant__ int8_t kOrder[19] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                                  11, 4,  12, 3, 13, 2, 14, 1, 15};

template <bool STAMP>
struct Reader {
  const uint8_t* p;
  int n;
  Clocks<STAMP>* k;
  int next = 0;
  unsigned long long buf = 0;
  int cnt = 0;
  __device__ void fill() {
    while (cnt <= 56 && next < n) {
      buf |= static_cast<unsigned long long>(p[next++]) << cnt;
      cnt += 8;
    }
    k->lap(0, static_cast<uint32_t>(buf));
  }
  __device__ bool bits(int kk, int& v) {
    if (cnt < kk) fill();
    if (cnt < kk) return false;
    v = static_cast<int>(buf & ((1ull << kk) - 1));
    buf >>= kk;
    cnt -= kk;
    return true;
  }
};

struct Huf {
  int16_t count[16];
  int16_t sym[288];
  uint16_t fast[1 << FAST_BITS];
  bool ok;
};

__device__ bool build(Huf& h, const uint8_t* lengths, int n) {
  for (int i = 0; i < 16; ++i) h.count[i] = 0;
  for (int i = 0; i < n; ++i) h.count[lengths[i]]++;
  h.ok = false;
  if (h.count[0] == n) return false;
  int left = 1;
  for (int l = 1; l < 16; ++l) {
    left = (left << 1) - h.count[l];
    if (left < 0) return false;
  }
  int16_t offs[16];
  offs[1] = 0;
  for (int l = 1; l < 15; ++l) offs[l + 1] = offs[l] + h.count[l];
  for (int i = 0; i < n; ++i)
    if (lengths[i]) h.sym[offs[lengths[i]]++] = static_cast<int16_t>(i);
  for (int j = 0; j < (1 << FAST_BITS); ++j) h.fast[j] = 0;
  int code = 0, index = 0;
  for (int l = 1; l <= FAST_BITS; ++l) {
    code <<= 1;
    for (int q = 0; q < h.count[l]; ++q, ++code, ++index) {
      const uint32_t rev = __brev(static_cast<uint32_t>(code)) >> (32 - l);
      const uint16_t entry = static_cast<uint16_t>((l << 12) | h.sym[index]);
      for (uint32_t j = rev; j < (1u << FAST_BITS); j += 1u << l)
        h.fast[j] = entry;
    }
  }
  h.ok = true;
  return true;
}

template <bool STAMP>
__device__ int decode(const Huf& h, Reader<STAMP>& r) {
  if (!h.ok) return -1;
  if (r.cnt < FAST_BITS) r.fill();
  const uint16_t e = h.fast[r.buf & ((1u << FAST_BITS) - 1)];
  r.k->lap(1, e);
  if (e) {
    const int l = e >> 12;
    if (r.cnt < l) return -1;
    r.buf >>= l;
    r.cnt -= l;
    return e & 0xFFF;
  }
  int code = 0, first = 0, index = 0;
  for (int l = 1; l < 16; ++l) {
    int b;
    if (!r.bits(1, b)) return -1;
    code |= b;
    const int c = h.count[l];
    if (code - first < c) {
      const int s = h.sym[index + (code - first)];
      r.k->lap(2, static_cast<uint32_t>(s));
      return s;
    }
    index += c;
    first = (first + c) << 1;
    code <<= 1;
  }
  return -1;
}

struct Shared {
  Huf lit, dist;
  uint8_t lens[320];
};

enum Action { COPY_MATCH, COPY_STORED, DONE };

struct State {
  int block = 0;
  bool last = false;
  bool ended = false;
  long long o = 0;
};

template <bool STAMP>
__device__ Action step(Shared& sh, Reader<STAMP>& r, State& st, uint8_t* dst,
                       int cap, int& a, int& len, long long& status,
                       long long* counts) {
  Clocks<STAMP>& k = *r.k;
  for (;;) {
    if (st.block == 0) {
      if (st.ended) {
        status = st.o;
        return DONE;
      }
      int fin, btype;
      if (!r.bits(1, fin) || !r.bits(2, btype)) break;
      st.last = fin;
      if (btype == 0) {
        const int drop = r.cnt & 7;
        r.buf >>= drop;
        r.cnt -= drop;
        int at = r.next - r.cnt / 8;
        if (at + 4 > r.n) break;
        const int ln = r.p[at] | (r.p[at + 1] << 8);
        const int nln = r.p[at + 2] | (r.p[at + 3] << 8);
        if (ln != (~nln & 0xFFFF)) break;
        at += 4;
        if (at + ln > r.n || st.o + ln > cap) break;
        r.next = at + ln;
        r.buf = 0;
        r.cnt = 0;
        st.ended = fin;
        a = at;
        len = ln;
        k.lap(6, static_cast<uint32_t>(ln));
        return COPY_STORED;
      }
      if (btype == 3) break;
      if (btype == 1) {
        for (int i = 0; i < 288; ++i)
          sh.lens[i] = i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : 8;
        build(sh.lit, sh.lens, 288);
        for (int i = 0; i < 30; ++i) sh.lens[i] = 5;
        build(sh.dist, sh.lens, 30);
      } else {
        int hlit, hdist, hclen;
        if (!r.bits(5, hlit) || !r.bits(5, hdist) || !r.bits(4, hclen))
          break;
        hlit += 257;
        hdist += 1;
        hclen += 4;
        if (hlit > 286 || hdist > 30) break;
        uint8_t* cl = sh.lens + 300;
        for (int i = 0; i < 19; ++i) cl[i] = 0;
        bool ok = true;
        for (int i = 0; i < hclen && ok; ++i) {
          int v;
          ok = r.bits(3, v);
          cl[kOrder[i]] = static_cast<uint8_t>(v);
        }
        Huf& clh = sh.dist;
        if (!ok || !build(clh, cl, 19)) break;
        int i = 0;
        while (i < hlit + hdist && ok) {
          const int s = decode(clh, r);
          if (s < 0) {
            ok = false;
            break;
          }
          if (s < 16) {
            sh.lens[i++] = static_cast<uint8_t>(s);
            continue;
          }
          int rep, val = 0;
          if (s == 16) {
            if (i == 0) {
              ok = false;
              break;
            }
            val = sh.lens[i - 1];
            ok = r.bits(2, rep);
            rep += 3;
          } else if (s == 17) {
            ok = r.bits(3, rep);
            rep += 3;
          } else {
            ok = r.bits(7, rep);
            rep += 11;
          }
          if (!ok || i + rep > hlit + hdist) {
            ok = false;
            break;
          }
          while (rep--) sh.lens[i++] = static_cast<uint8_t>(val);
        }
        if (!ok || !build(sh.lit, sh.lens, hlit)) break;
        uint8_t* dl = sh.lens + 288;
        for (int q = hdist - 1; q >= 0; --q) dl[q] = sh.lens[hlit + q];
        for (int q = hdist; q < 30; ++q) dl[q] = 0;
        build(sh.dist, dl, 30);
      }
      st.block = 1;
      k.lap(6, static_cast<uint32_t>(sh.lit.fast[0]));
    }
    const int s = decode(sh.lit, r);
    if (s < 0) break;
    ++counts[0];
    if (s < 256) {
      if (st.o >= cap) break;
      dst[st.o++] = static_cast<uint8_t>(s);
      ++counts[2];
      k.lap(3, static_cast<uint32_t>(st.o));
      continue;
    }
    if (s == 256) {
      st.block = 0;
      st.ended = st.last;
      continue;
    }
    const int lc = s - 257;
    if (lc >= 29) break;
    int extra;
    const bool got_len = r.bits(kLenEb[lc], extra);
    const int mlen = kLenBase[lc] + (got_len ? extra : 0);
    k.lap(4, static_cast<uint32_t>(mlen));
    const int ds = decode(sh.dist, r);
    if (ds < 0 || ds >= 30) break;
    int dextra;
    const bool got_dist = r.bits(kDistEb[ds], dextra);
    if (!got_len || !got_dist) break;
    const long long d = kDistBase[ds] + dextra;
    if (d > st.o || st.o + mlen > cap) break;
    a = static_cast<int>(d);
    len = mlen;
    ++counts[1];
    k.lap(4, static_cast<uint32_t>(d));
    return COPY_MATCH;
  }
  status = -1;
  return DONE;
}

}  // namespace inflate_old

template <bool STAMP>
__global__ void __launch_bounds__(32)
inflate_clocks(const uint8_t* streams, const int32_t* lens, int w,
               uint8_t* out, int cap, long long* status, long long* cycles) {
  using namespace inflate_old;
  __shared__ Shared sh;
  const int lane = threadIdx.x;
  const int row = blockIdx.x;
  const uint8_t* src = streams + static_cast<size_t>(row) * w;
  uint8_t* dst = out + static_cast<size_t>(row) * cap;
  const int n = min(max(lens[row], 0), w);
  if (n == 0) {
    if (lane == 0) status[row] = 0;
    return;
  }
  Clocks<STAMP> k;
  k.start(0);
  const long long t0 = k.t;
  long long counts[3] = {0, 0, 0};   // symbols, matches, literals
  Reader<STAMP> r{src, n, &k};
  State st;
  long long done = 0;
  for (;;) {
    int action = DONE, a = 0, len = 0;
    long long o = 0;
    if (lane == 0) {
      action = step(sh, r, st, dst, cap, a, len, done, counts);
      o = st.o;
      if (action != DONE) st.o += len;
    }
    action = __shfl_sync(FULL, action, 0);
    if (action == DONE) break;
    a = __shfl_sync(FULL, a, 0);
    len = __shfl_sync(FULL, len, 0);
    o = __shfl_sync(FULL, o, 0);
    __syncwarp();
    if (action == COPY_MATCH) {
      for (int q = lane; q < len; q += 32) dst[o + q] = dst[o - a + q % a];
    } else {
      for (int q = lane; q < len; q += 32) dst[o + q] = src[a + q];
    }
    __syncwarp();
    k.lap(action == COPY_MATCH ? 5 : 6, static_cast<uint32_t>(o));
  }
  const long long t1 = stamp(static_cast<uint32_t>(done));
  if (lane == 0) {
    status[row] = done;
    if (row == 0) {
      for (int p = 0; p < 7; ++p) cycles[p] = k.sum[p];
      cycles[7] = t1 - t0;
      cycles[8] = counts[0];
      cycles[9] = counts[1];
      cycles[10] = counts[2];
    }
  }
}

// lz4p's pack as it stood before its redesign (csrc/lz4p.cu's pack kernel as
// ported: one warp a row, two walks of the LZ4 stream, a sequence at a time
// from device memory, every lane in step), B rows at once.  Block 0's
// cycles by part: 0 the first walk's sequence reads, 1 its sums, 2 the
// header, 3 the second walk's sequence reads, 4 its column writes, 5 its
// literal copies; cycles[7] the whole row, [8] its sequences, [9] its
// column entries S.
namespace pack_old {

constexpr int HDR = 8;
constexpr int U16 = 0xFFFF;
constexpr int MIN_MATCH = 4;

struct Sequence {
  int lit_src, lit, ml, off, next;
  bool last;
};

__device__ __forceinline__ Sequence read_sequence(const uint8_t* s, int i,
                                                  int n) {
  auto at = [&](int q) { return q < n ? static_cast<int>(s[q]) : 0; };
  Sequence q;
  const int token = at(i++);
  q.lit = token >> 4;
  if (q.lit == 15) {
    int b;
    do {
      b = at(i++);
      q.lit += b;
    } while (b == 255 && i < n);
  }
  q.lit_src = i;
  i += q.lit;
  q.last = i >= n;
  q.ml = q.off = 0;
  if (!q.last) {
    q.off = at(i) | (at(i + 1) << 8);
    i += 2;
    q.ml = (token & 15) + MIN_MATCH;
    if ((token & 15) == 15) {
      int b;
      do {
        b = at(i++);
        q.ml += b;
      } while (b == 255 && i < n);
    }
  }
  q.next = i;
  return q;
}

__device__ __forceinline__ int extra_pieces(int len, bool split) {
  return split && len > U16 ? (len - 1) / U16 : 0;
}

__device__ __forceinline__ void put_u16(uint8_t* p, int v) {
  p[0] = static_cast<uint8_t>(v & 0xFF);
  p[1] = static_cast<uint8_t>((v >> 8) & 0xFF);
}

}  // namespace pack_old

template <bool STAMP>
__global__ void __launch_bounds__(32)
pack_clocks(const uint8_t* comp, const int32_t* clens, int w, uint8_t* out,
            int cap, int32_t* olens, bool split, long long* cycles) {
  using namespace pack_old;
  const int lane = threadIdx.x;
  const int row = blockIdx.x;
  const uint8_t* s = comp + static_cast<size_t>(row) * w;
  uint8_t* dst = out + static_cast<size_t>(row) * cap;
  const int n = min(max(clens[row], 0), w);
  Clocks<STAMP> k;
  k.start(0);
  const long long t0 = k.t;
  long long nseq = 0, lits = 0, orig = 0, seqs = 0;
  bool over = false, bad = false;
  for (int i = 0; i < n;) {
    const Sequence q = read_sequence(s, i, n);
    k.lap(0, static_cast<uint32_t>(q.next));
    ++seqs;
    nseq += 1 + extra_pieces(q.lit, split) + extra_pieces(q.ml, split);
    over |= q.lit > U16 || q.ml > U16;
    bad |= q.lit_src + q.lit > n;
    lits += q.lit;
    orig += q.lit + q.ml;
    i = q.next;
    k.lap(1, static_cast<uint32_t>(orig));
    if (q.last) break;
  }
  const long long base = HDR + 6 * nseq;
  if ((over && !split) || bad || base + lits > cap) {
    if (lane == 0) olens[row] = -1;
  } else {
    if (lane < 8)
      dst[lane] = static_cast<uint8_t>(
          ((lane < 4 ? nseq : orig) >> (8 * (lane & 3))) & 0xFF);
    if (lane == 0) olens[row] = static_cast<int32_t>(base + lits);
    k.lap(2, static_cast<uint32_t>(base));
    long long e = 0, lo = 0;
    for (int i = 0; i < n;) {
      const Sequence q = read_sequence(s, i, n);
      k.lap(3, static_cast<uint32_t>(q.next));
      const int xl = extra_pieces(q.lit, split);
      const int xm = extra_pieces(q.ml, split);
      for (int j = lane; j <= xl + xm; j += 32) {
        const int mp = j - xl;
        const int ll = j < xl ? U16 : mp == 0 ? q.lit - U16 * xl : 0;
        const int ml = mp < 0 ? 0 : mp < xm ? U16 : q.ml - U16 * xm;
        uint8_t* col = dst + HDR + 2 * (e + j);
        put_u16(col, ll);
        put_u16(col + 2 * nseq, ml);
        put_u16(col + 4 * nseq, ml > 0 ? q.off : 0);
      }
      k.lap(4, static_cast<uint32_t>(e));
      for (int q2 = lane; q2 < q.lit; q2 += 32)
        dst[base + lo + q2] = s[q.lit_src + q2];
      e += 1 + xl + xm;
      lo += q.lit;
      i = q.next;
      k.lap(5, static_cast<uint32_t>(lo));
      if (q.last) break;
    }
  }
  const long long t1 = stamp(static_cast<uint32_t>(nseq));
  if (lane == 0 && row == 0) {
    for (int p = 0; p < 7; ++p) cycles[p] = k.sum[p];
    cycles[7] = t1 - t0;
    cycles[8] = seqs;
    cycles[9] = nseq;
  }
}

// The redesigned deflate decoder (csrc/inflate.cu, included above in
// namespace infl; this kernel body and its batch step are copies: keep them
// in step with the source), B rows at once.  Block 0's cycles by part: 0
// the batch's symbols (tokens) less what follows, 1 the scan of the
// tokens' lengths and the literals' stores, 2 the match rounds, 3 the
// batch's bytes out to device memory, 4 block headers, tables, the
// batch's staging and stored blocks, 5 the bit window's reads, 6 the
// table lookups with their fault tests; cycles[7] the whole stream, [8]
// its batches, [9] its tokens, [10] its match rounds, [11] its matches.
namespace infl_clocks {

using namespace infl;

template <bool STAMP>
__device__ __forceinline__ Stop batch(Inflater& f, int& nq, int& ql, int& qv,
                                      Clocks<STAMP>& k) {
  const int lane = threadIdx.x;
  nq = 0;
  for (;;) {
    if (!f.in_block) {
      if (f.ended) return S_END;
      int fin, btype;
      if (!f.r.take(f.s, 1, fin) || !f.r.take(f.s, 2, btype)) return S_FAULT;
      f.last = fin;
      if (btype == 0) return S_STORED;
      if (btype == 3) return S_FAULT;
      if (btype == 1)
        f.fixed_tables();
      else if (!f.dynamic_tables())
        return S_FAULT;
      f.in_block = true;
    }
    f.s.need((f.r.pos >> 3) + LOOKAHEAD);
    k.lap(4, static_cast<uint32_t>(f.r.pos));
    for (;;) {
      const unsigned long long buf = f.r.peek(f.s);
      const int left = f.r.end - f.r.pos;
      k.lap(5, static_cast<uint32_t>(buf));
      uint32_t e = s_root[buf & ((1u << LIT_ROOT) - 1)];
      if (((e >> 4) & 7) >= K_END || (e & 15) > left ||
          (((e >> 4) & 7) == K_LIT && f.o >= f.cap)) {
        e = past_root<0, T_LIT>(e, buf);
        const int kind = (e >> 4) & 7;
        if (kind == K_BAD || (e & 15) > left ||
            (kind == K_LIT && f.o >= f.cap))
          return S_FAULT;
        if (kind == K_END) {
          f.r.pos += e & 15;
          f.in_block = false;
          f.ended = f.last;
          break;
        }
      }
      k.lap(6, e);
      const int l = e & 15;
      f.r.pos += l;
      if (((e >> 4) & 7) == K_LIT) {
        if (lane == nq) {
          ql = 1;
          qv = e >> 16;
        }
        ++f.o;
        k.lap(0, static_cast<uint32_t>(f.r.pos));
        if (++nq == 32) return S_FULL;
        continue;
      }
      const int eb = (e >> 8) & 15;
      const int mlen = (e >> 16) + static_cast<int>((buf >> l) &
                                                    ((1u << eb) - 1));
      const unsigned long long dbuf = buf >> (l + eb);
      k.lap(0, static_cast<uint32_t>(dbuf));
      uint32_t g = s_root[(1 << LIT_ROOT) + (dbuf & ((1u << DIST_ROOT) - 1))];
      int dl = g & 15, deb = (g >> 8) & 15;
      int d = (g >> 16) + static_cast<int>((dbuf >> dl) & ((1u << deb) - 1));
      if (((g >> 4) & 7) != K_BASE || l + eb + dl + deb > left || d > f.o ||
          f.o + mlen > f.cap) {
        g = past_root<1, T_DIST>(g, dbuf);
        dl = g & 15;
        deb = (g >> 8) & 15;
        d = (g >> 16) + static_cast<int>((dbuf >> dl) & ((1u << deb) - 1));
        if (((g >> 4) & 7) != K_BASE || l + eb + dl + deb > left ||
            d > f.o || f.o + mlen > f.cap)
          return S_FAULT;
      }
      k.lap(6, g);
      f.r.pos += eb + dl + deb;
      if (lane == nq) {
        ql = mlen;
        qv = d;
      }
      f.o += mlen;
      k.lap(0, static_cast<uint32_t>(f.r.pos));
      if (++nq == 32) return S_FULL;
    }
  }
}

// resolve(), counting its rounds.
__device__ __forceinline__ int resolve_counted(const Out& out, int mo,
                                               int off, int ml,
                                               bool pending) {
  int rounds = 0;
  const int lane = threadIdx.x;
  __syncwarp();   // the literals, every lane's, are written
  for (;;) {
    const int first = __reduce_min_sync(FULL, pending ? mo : NONE);
    if (first == NONE) break;
    ++rounds;
    const bool ready = pending && mo - off + min(off, ml) <= first;
    if (ready && ml <= LANE_BYTES) copy_lane(out, mo, off, ml);
    if (__any_sync(FULL, ready && ml > LANE_BYTES)) {
      const int len = ready && ml > LANE_BYTES ? ml : 0;
      int incl = len;
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(FULL, incl, d);
        if (lane >= d) incl += u;
      }
      const int total = __shfl_sync(FULL, incl, 31);
      const int excl = incl - len;
      for (int t0 = 0; t0 < total; t0 += 32) {
        const int t = t0 + lane;
        int j = 0;
#pragma unroll
        for (int step = 16; step > 0; step >>= 1)
          if (__shfl_sync(FULL, incl, j + step - 1) <= t) j += step;
        const int m = t - __shfl_sync(FULL, excl, j);
        const int jo = __shfl_sync(FULL, mo, j);
        const int joff = __shfl_sync(FULL, off, j);
        if (t < total)
          s_hist[(jo + m) & (HIST - 1)] =
              out.get(jo - joff + (m < joff ? m : m % joff));
      }
    }
    pending = pending && !ready;
    __syncwarp();
  }
  return rounds;
}

}  // namespace infl_clocks

template <bool STAMP>
__global__ void __launch_bounds__(32)
inflate_new_clocks(const uint8_t* streams, const int32_t* lens, int w,
                   uint8_t* out, int cap, long long* status,
                   long long* cycles) {
  using namespace infl;
  using namespace infl_clocks;
  const int lane = threadIdx.x;
  const int row = blockIdx.x;
  const uint8_t* src = streams + static_cast<size_t>(row) * w;
  uint8_t* dst = out + static_cast<size_t>(row) * cap;
  const int n = min(max(lens[row], 0), w);
  if (n == 0) {
    if (lane == 0) status[row] = 0;
    return;
  }
  Clocks<STAMP> k;
  k.start(0);
  const long long t0 = k.t;
  long long batches = 0, tokens = 0, rounds = 0, matches = 0;
  const int skew = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  Inflater f;
  f.s = Stream{src - skew, skew, n, 0};
  f.s.start();
  f.r = Bits{0, 8 * n};
  f.cap = cap;
  f.o = 0;
  f.in_block = f.last = f.ended = false;
  int hist_lo = 0;
  long long result;
  for (;;) {
    const int o0 = f.o;
    int nq, ql = 0, qv = 0;
    const Stop stop = infl_clocks::batch(f, nq, ql, qv, k);
    if (nq) {
      ++batches;
      tokens += nq;
      matches += __popc(__ballot_sync(FULL, ql > 1));
      int incl = ql;
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(FULL, incl, d);
        if (lane >= d) incl += u;
      }
      const int at = o0 + incl - ql;
      if (ql == 1) s_hist[at & (HIST - 1)] = static_cast<uint8_t>(qv);
      const int end = f.o;
      k.lap(1, static_cast<uint32_t>(incl));
      rounds += resolve_counted(Out{dst, max(hist_lo, end - HIST), o0}, at,
                                qv, ql, ql > 1);
      k.lap(2, s_hist[o0 & (HIST - 1)]);
      for (int q = o0 + lane; q < end; q += 32)
        dst[q] = s_hist[q & (HIST - 1)];
      k.lap(3, static_cast<uint32_t>(end));
    }
    if (stop == S_FULL) continue;
    if (stop == S_END) {
      result = f.o;
      break;
    }
    if (stop == S_FAULT) {
      result = -1;
      break;
    }
    Stream& s = f.s;
    int at = (f.r.pos + 7) >> 3;
    if (at + 4 > n) {
      result = -1;
      break;
    }
    s.need(at + 3);
    const int ln = s.at(at) | (s.at(at + 1) << 8);
    const int nln = s.at(at + 2) | (s.at(at + 3) << 8);
    at += 4;
    if (ln != (~nln & 0xFFFF) || at + ln > n || f.o + ln > cap) {
      result = -1;
      break;
    }
    for (int left = ln; left > 0;) {
      s.need(at);
      const int part = min(left, s.end() - at);
      for (int q = lane; q < part; q += 32) dst[f.o + q] = s.at(at + q);
      at += part;
      f.o += part;
      left -= part;
    }
    __syncwarp();
    hist_lo = f.o;
    f.r.pos = 8 * at;
    f.ended = f.last;
    k.lap(4, static_cast<uint32_t>(at));
  }
  cp_wait<0>();
  const long long t1 = stamp(static_cast<uint32_t>(result));
  if (lane == 0) {
    status[row] = result;
    if (row == 0) {
      for (int p = 0; p < 7; ++p) cycles[p] = k.sum[p];
      cycles[7] = t1 - t0;
      cycles[8] = batches;
      cycles[9] = tokens;
      cycles[10] = rounds;
      cycles[11] = matches;
    }
  }
}

// lz4p's decode as it stood before its redesign (csrc/lz4p.cu: a warp a
// row, a first pass checking every sequence's faults 32 at once by prefix
// sums, then a second copying each sequence's literals and its match in
// order, 32 bytes a step, five shuffles and two __syncwarp a sequence),
// B rows at once.  Block 0's cycles by part: 0 pass 1, 1 pass 2's column
// entries and their scans, 2 the five shuffles of a sequence, 3 its
// literals, 4 its match, 5 the two __syncwarp, 6 the zeros after the
// output; cycles[7] the whole row, [8] its sequences, [9] its literal
// bytes, [10] its match bytes.
namespace lz4p_old {

using lz4_old::FULL;
constexpr int HDR = 8;

__device__ __forceinline__ long long warp_scan(long long v, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const long long u = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

struct Entry {
  long long o, lp;
  int ll, ml, off;
};

__device__ __forceinline__ Entry column_entry(const uint8_t* s, long long S,
                                              long long t0, int lane,
                                              long long& o_carry,
                                              long long& lp_carry) {
  Entry q;
  const long long t = t0 + lane;
  q.ll = q.ml = q.off = 0;
  if (t < S) {
    const uint8_t* c = s + HDR + 2 * t;
    q.ll = c[0] | (c[1] << 8);
    q.ml = c[2 * S] | (c[2 * S + 1] << 8);
    q.off = c[4 * S] | (c[4 * S + 1] << 8);
  }
  const long long size = warp_scan(q.ll + q.ml, lane);
  const long long lit = warp_scan(q.ll, lane);
  q.o = o_carry + size - (q.ll + q.ml);
  q.lp = lp_carry + lit - q.ll;
  o_carry += __shfl_sync(FULL, size, 31);
  lp_carry += __shfl_sync(FULL, lit, 31);
  return q;
}

}  // namespace lz4p_old

template <bool STAMP>
__global__ void __launch_bounds__(32)
lz4p_decode_clocks(const uint8_t* comp, const int32_t* clens, int w,
                   uint8_t* out, int out_cap, int64_t* status,
                   long long* cycles) {
  using namespace lz4p_old;
  const int lane = threadIdx.x;
  const int row = blockIdx.x;
  const uint8_t* s = comp + static_cast<size_t>(row) * w;
  uint8_t* dst = out + static_cast<size_t>(row) * out_cap;
  const int n = min(max(clens[row], 0), w);
  Clocks<STAMP> k;
  k.start(0);
  const long long t0 = k.t;
  long long S = 0, orig = 0, st;
  if (n == 0) {
    st = 0;
  } else if (n < HDR) {
    st = -1;
  } else {
    S = s[0] | (s[1] << 8) | (s[2] << 16) | (static_cast<uint32_t>(s[3])
                                             << 24);
    orig = s[4] | (s[5] << 8) | (s[6] << 16) | (static_cast<uint32_t>(s[7])
                                                << 24);
    st = orig > out_cap || HDR + 6 * S > n ? -1 : orig;
  }
  const long long base = HDR + 6 * S;
  long long o_carry = 0, lp_carry = 0;
  for (long long b0 = 0; st > 0 && b0 < S; b0 += 32) {
    const Entry q = column_entry(s, S, b0, lane, o_carry, lp_carry);
    const long long ms = q.o + q.ll;
    const bool fault = b0 + lane < S &&
                       (base + q.lp + q.ll > n || ms > orig ||
                        (q.ml > 0 && (q.off == 0 || q.off > ms ||
                                      ms + q.ml > orig)));
    if (__ballot_sync(FULL, fault)) st = -1;
  }
  if (st > 0 && o_carry != orig) st = -1;
  if (lane == 0) status[row] = st;
  const long long end = st > 0 ? st : 0;
  k.lap(0, static_cast<uint32_t>(end));
  long long lit_bytes = 0, match_bytes = 0;
  o_carry = lp_carry = 0;
  for (long long b0 = 0; end > 0 && b0 < S; b0 += 32) {
    const Entry q = column_entry(s, S, b0, lane, o_carry, lp_carry);
    k.lap(1, static_cast<uint32_t>(q.o ^ q.lp));
    const int count = static_cast<int>(min(S - b0, 32LL));
    for (int j = 0; j < count; ++j) {
      const long long o = __shfl_sync(FULL, q.o, j);
      const long long lp = __shfl_sync(FULL, q.lp, j);
      const int ll = __shfl_sync(FULL, q.ll, j);
      const int ml = __shfl_sync(FULL, q.ml, j);
      const int off = __shfl_sync(FULL, q.off, j);
      k.lap(2, static_cast<uint32_t>(o ^ lp ^ ll ^ ml ^ off));
      uint32_t v = 0;
      for (int c = lane; c < ll; c += 32) {
        const uint8_t b = s[base + lp + c];
        dst[o + c] = b;
        v ^= b;
      }
      k.lap(3, v);
      __syncwarp();   // the literals before a match that reads them
      k.lap(5, 0);
      const long long ms = o + ll;
      for (int c = lane; c < ml; c += 32) {
        const uint8_t b = dst[ms - off + (c < off ? c : c % off)];
        dst[ms + c] = b;
        v ^= b;
      }
      k.lap(4, v);
      __syncwarp();   // this match before the next sequence's reads
      k.lap(5, 0);
      lit_bytes += ll;
      match_bytes += ml;
    }
  }
  for (long long p = end + lane; p < out_cap; p += 32) dst[p] = 0;
  k.lap(6, 0);
  const long long t1 = stamp(static_cast<uint32_t>(end));
  if (lane == 0 && row == 0) {
    for (int p = 0; p < 7; ++p) cycles[p] = k.sum[p];
    cycles[7] = t1 - t0;
    cycles[8] = S;
    cycles[9] = lit_bytes;
    cycles[10] = match_bytes;
  }
}

// The deflate links as they stood before their redesign
// (csrc/deflate_encode.cu: a warp a row, 32 positions a step, the lanes of
// one 3-byte hash grouped by __match_any_sync, a keyed table of 8-byte
// slots in device memory), ntab tables and warps walking B rows.  Block
// 0's row 0 cycles by part: 0 the 3 bytes and the hash, 1 the ballot and
// __match_any_sync, 2 keyed_find (or the group's earlier lane), 3 the
// first __syncwarp and keyed_put, 4 the prev store and the second
// __syncwarp, 5 the table's reset, 6 the -1 past the limit; cycles[7] the
// whole row, [8] its steps, [9] the keyed slots read past each lane's
// first (probe lengths over the lanes of row 0).
namespace links_old {

using lz4_old::FULL;
using lz4_old::HASH_MUL;
constexpr int HASH_BITS = 15;
constexpr uint32_t SLOT_MUL = 0x9E3779B1u;
constexpr unsigned long long EMPTY = ~0ull;

__device__ __forceinline__ uint32_t keyed_slot(uint32_t h, uint32_t salt,
                                               int slots_log) {
  return ((h ^ salt) * SLOT_MUL) >> (32 - slots_log);
}

__device__ __forceinline__ int keyed_find(const unsigned long long* t,
                                          uint32_t h, uint32_t salt,
                                          int slots_log, int& extra) {
  const uint32_t mask = (1u << slots_log) - 1;
  for (uint32_t s = keyed_slot(h, salt, slots_log);; s = (s + 1) & mask) {
    const unsigned long long v = t[s];
    if (v == EMPTY) return -1;
    if (static_cast<uint32_t>(v) == h) return static_cast<int>(v >> 32);
    ++extra;
  }
}

__device__ __forceinline__ void keyed_put(unsigned long long* t, uint32_t h,
                                          uint32_t salt, int p,
                                          int slots_log) {
  const uint32_t mask = (1u << slots_log) - 1;
  const unsigned long long entry =
      static_cast<unsigned long long>(static_cast<uint32_t>(p)) << 32 | h;
  for (uint32_t s = keyed_slot(h, salt, slots_log);; s = (s + 1) & mask) {
    unsigned long long v = t[s];
    if (v == EMPTY) {
      v = atomicCAS(t + s, EMPTY, entry);
      if (v == EMPTY) return;
    }
    if (static_cast<uint32_t>(v) == h) {
      t[s] = entry;
      return;
    }
  }
}

}  // namespace links_old

template <bool STAMP>
__global__ void __launch_bounds__(32)
deflate_links_clocks(const uint8_t* blocks, const int32_t* lengths, int B,
                     int n, int32_t* prev, unsigned long long* tables,
                     int slots_log, long long* cycles) {
  using namespace links_old;
  const int lane = threadIdx.x;
  const unsigned below = (1u << lane) - 1;
  const unsigned above = ~((2u << lane) - 1);
  const size_t words = (size_t{1} << slots_log) / 2;
  int4* table = reinterpret_cast<int4*>(tables) + blockIdx.x * words;
  unsigned long long* keyed = reinterpret_cast<unsigned long long*>(table);
  for (int row = blockIdx.x; row < B; row += gridDim.x) {
    Clocks<STAMP> k;
    k.start(0);
    const long long t0 = k.t;
    for (size_t q = lane; q < words; q += 32)
      table[q] = make_int4(-1, -1, -1, -1);
    __syncwarp();
    k.lap(5, 0);
    const uint8_t* src = blocks + static_cast<size_t>(row) * n;
    int32_t* out = prev + static_cast<size_t>(row) * n;
    const int len = min(max(lengths[row], 0), n);
    const int limit = max(len - 2, 0);
    const uint32_t salt = static_cast<uint32_t>(row) * SLOT_MUL;
    long long steps = 0;
    int extra = 0;
    for (int base = 0; base < limit; base += 32) {
      ++steps;
      const int p = base + lane;
      const bool live = p < limit;
      const uint32_t v = live ? src[p] | (src[p + 1] << 8) |
                                    (uint32_t(src[p + 2]) << 16)
                              : 0u;
      const uint32_t h = (v * HASH_MUL) >> (32 - HASH_BITS);
      k.lap(0, h);
      const unsigned lanes = __ballot_sync(FULL, live);
      unsigned group = 0;
      if (live) group = __match_any_sync(lanes, h);
      k.lap(1, group);
      const unsigned earlier = group & below;
      int c = -1;
      if (live)
        c = earlier ? base + 31 - __clz(earlier)
                    : keyed_find(keyed, h, salt, slots_log, extra);
      k.lap(2, static_cast<uint32_t>(c));
      __syncwarp();
      if (live && !(group & above)) keyed_put(keyed, h, salt, p, slots_log);
      k.lap(3, 0);
      if (live) out[p] = c;
      __syncwarp();
      k.lap(4, 0);
    }
    for (int p = limit + lane; p < n; p += 32) out[p] = -1;
    __syncwarp();
    k.lap(6, 0);
    const long long t1 = stamp(static_cast<uint32_t>(steps));
    const int extra_all = __reduce_add_sync(FULL, extra);
    if (lane == 0 && row == 0) {
      for (int q = 0; q < 7; ++q) cycles[q] = k.sum[q];
      cycles[7] = t1 - t0;
      cycles[8] = steps;
      cycles[9] = extra_all;
    }
  }
}

// The deflate device rule's greedy parse as it stood before its redesign
// (csrc/deflate_encode.cu's deflate_parse_kernel<false>: a warp a row over
// windows of 32 best values read from device memory, a ballot for the
// next match, literals and the match written by the warp).  Row 0's
// cycles by part: 0 a window's load, 1 the ballot and shuffles of a step,
// 2 the literals' loads and stores, 3 the match's token and the jump;
// cycles[7] the whole row, [8] its tokens, [9] its matches, [10] its
// windows loaded.
template <bool STAMP>
__global__ void __launch_bounds__(32)
deflate_greedy_clocks(const uint8_t* __restrict__ blocks,
                      const int32_t* __restrict__ lengths,
                      const int32_t* __restrict__ best_at, int n,
                      int32_t* __restrict__ tokens,
                      int32_t* __restrict__ ntok, long long* cycles) {
  using lz4_old::FULL;
  const int lane = threadIdx.x;
  const int row = blockIdx.x;
  const uint8_t* src = blocks + static_cast<size_t>(row) * n;
  const int32_t* ba = best_at + static_cast<size_t>(row) * n;
  int32_t* tok = tokens + static_cast<size_t>(row) * n;
  const int len = min(max(lengths[row], 0), n);
  const int limit = max(len - 2, 0);
  Clocks<STAMP> k;
  k.start(0);
  const long long t0 = k.t;
  long long windows = 0, matches = 0;
  int wbase = 0, best_l = 0, dist_l = 0;
  auto window = [&](int from) {
    wbase = from;
    const int p = from + lane;
    const int v = p < limit ? ba[p] : 0;
    best_l = v >> 16;
    dist_l = v & 0xFFFF;
    ++windows;
  };
  window(0);
  k.lap(0, static_cast<uint32_t>(best_l));
  int i = 0, anchor = 0, t = 0;
  while (i < limit) {
    if (i >= wbase + 32) {
      window(i);
      k.lap(0, static_cast<uint32_t>(best_l));
    }
    const unsigned hits =
        __ballot_sync(FULL, best_l >= 3 && wbase + lane >= i);
    if (!hits) {
      i = wbase + 32;
      k.lap(1, hits);
      continue;
    }
    const int at = wbase + __ffs(hits) - 1;
    const int best = __shfl_sync(FULL, best_l, at - wbase);
    const int d = __shfl_sync(FULL, dist_l, at - wbase);
    k.lap(1, static_cast<uint32_t>(d));
    for (int q = lane; q < at - anchor; q += 32) tok[t + q] = src[anchor + q];
    t += at - anchor;
    k.lap(2, 0);
    if (lane == 0) tok[t] = best << 16 | d;
    ++t;
    ++matches;
    i = anchor = at + best;
    k.lap(3, static_cast<uint32_t>(i));
  }
  for (int q = lane; q < len - anchor; q += 32) tok[t + q] = src[anchor + q];
  t += len - anchor;
  k.lap(2, 0);
  if (lane == 0) ntok[row] = t;
  const long long t1 = stamp(static_cast<uint32_t>(t));
  if (lane == 0 && row == 0) {
    for (int q = 0; q < 7; ++q) cycles[q] = k.sum[q];
    cycles[7] = t1 - t0;
    cycles[8] = t;
    cycles[9] = matches;
    cycles[10] = windows;
  }
}

// The redesigned lz4p decode (csrc/lz4p.cu, included above in namespace
// lz4pn; this kernel body is a copy of its lz4p_decode_kernel: keep the two
// in step), B rows at once.  Block 0's cycles by part: 0 pass 1, 1 pass
// 2's column entries, 2 the literals with the first round's matches whose
// sources lie before the batch, 3 the other matches' rounds, 4 the bytes
// out of the history, 5 the batches built in device memory (past HIST
// bytes), 6 the zeros after the output; cycles[7] the whole row, [8] its
// batches, [9] their match rounds past the first round's early matches,
// [10] its sequences, [11] its literal bytes, [12] its early matches.
template <bool STAMP>
__global__ void __launch_bounds__(32)
lz4p_decode_new_clocks(const uint8_t* __restrict__ comp,
                       const int32_t* __restrict__ clens, int w,
                       uint8_t* __restrict__ out, int out_cap,
                       int64_t* __restrict__ status, long long* cycles) {
  using namespace lz4pn;
  __shared__ __align__(16) uint8_t hist[HIST];
  const int lane = threadIdx.x;
  const int row = blockIdx.x;
  const uint8_t* s = comp + static_cast<size_t>(row) * w;
  uint8_t* dst = out + static_cast<size_t>(row) * out_cap;
  const int n = min(max(clens[row], 0), w);
  Clocks<STAMP> k;
  k.start(0);
  const long long t0c = k.t;
  long long S = 0, orig = 0, st;
  if (n == 0) {
    st = 0;
  } else if (n < HDR) {
    st = -1;
  } else {
    S = s[0] | (s[1] << 8) | (s[2] << 16) | (static_cast<uint32_t>(s[3])
                                             << 24);
    orig = s[4] | (s[5] << 8) | (s[6] << 16) | (static_cast<uint32_t>(s[7])
                                                << 24);
    st = orig > out_cap || HDR + 6 * S > n ? -1 : orig;
  }
  const long long base = HDR + 6 * S;
  long long o_carry = 0, lp_carry = 0;
  Cols next = st > 0 ? load_cols(s, S, lane) : Cols{0, 0, 0};
  for (long long t0 = 0; st > 0 && t0 < S; t0 += 32) {
    const Cols cur = next;
    next = load_cols(s, S, t0 + 32 + lane);
    const Entry q = column_entry(cur, lane, o_carry, lp_carry);
    const long long ms = q.o + q.ll;
    const bool fault = t0 + lane < S &&
                       (base + q.lp + q.ll > n || ms > orig ||
                        (q.ml > 0 && (q.off == 0 || q.off > ms ||
                                      ms + q.ml > orig)));
    if (__ballot_sync(FULL, fault)) st = -1;
  }
  if (st > 0 && o_carry != orig) st = -1;
  if (lane == 0) status[row] = st;
  const long long end = st > 0 ? st : 0;
  k.lap(0, static_cast<uint32_t>(end));
  long long batches = 0, rounds = 0, lit_bytes = 0, earlies = 0;
  o_carry = lp_carry = 0;
  int hist_lo = 0;
  if (end > 0) next = load_cols(s, S, lane);
  for (long long t0 = 0; end > 0 && t0 < S; t0 += 32) {
    const long long lp0 = lp_carry;
    const uint8_t* from = s + base + lp0;
    const uint8_t lit0 = base + lp0 + lane < n ? from[lane] : 0;
    const uint8_t lit1 = base + lp0 + 32 + lane < n ? from[32 + lane] : 0;
    const Cols cur = next;
    next = load_cols(s, S, t0 + 32 + lane);
    const Entry q = column_entry(cur, lane, o_carry, lp_carry);
    const int o0 = static_cast<int>(__shfl_sync(FULL, q.o, 0));
    const int o1 = static_cast<int>(o_carry);
    const int lits = static_cast<int>(lp_carry - lp0);
    const int lit_end = static_cast<int>(q.lp - lp0) + q.ll;
    const int shift = static_cast<int>(q.o - (q.lp - lp0));
    const bool direct = o1 - o0 > HIST;
    const Out o{dst, hist, direct ? NONE : max(hist_lo, o1 - HIST),
                direct ? o1 : o0};
    k.lap(1, static_cast<uint32_t>(o1 ^ lits ^ shift));
    const int mo = static_cast<int>(q.o) + q.ll;
    const bool has = t0 + lane < S && q.ml > 0;
    const bool early =
        has && q.ml <= LANE_BYTES && mo - q.off + min(q.off, q.ml) <= o0;
    uint8_t v[LANE_BYTES];
    if (early) load_lane(o, mo, q.off, q.ml, v);
    uint32_t x0 = 0;
    for (int b0 = 0; b0 < lits; b0 += 32) {
      const int b = b0 + lane;
      int j = 0;
#pragma unroll
      for (int step = 16; step > 0; step >>= 1)
        if (__shfl_sync(FULL, lit_end, j + step - 1) <= b) j += step;
      const int at = __shfl_sync(FULL, shift, j) + b;
      if (b < lits) {
        const uint8_t x = b0 == 0 ? lit0 : b0 == 32 ? lit1 : from[b];
        if (direct)
          o.put<false>(at, x);
        else
          o.put<true>(at, x);
        x0 ^= x;
      }
    }
    if (early) {
      if (direct)
        store_lane<false>(o, mo, q.ml, v);
      else
        store_lane<true>(o, mo, q.ml, v);
      x0 ^= v[0];
    }
    k.lap(direct ? 5 : 2, x0);
    bool pending = has && !early;
    __syncwarp();
    for (;;) {
      const int first = __reduce_min_sync(FULL, pending ? mo : NONE);
      if (first == NONE) break;
      ++rounds;
      const bool ready = pending && mo - q.off + min(q.off, q.ml) <= first;
      if (ready && q.ml <= LANE_BYTES) {
        if (direct)
          copy_lane<false>(o, mo, q.off, q.ml);
        else
          copy_lane<true>(o, mo, q.off, q.ml);
      }
      for (unsigned wide = __ballot_sync(FULL, ready && q.ml > LANE_BYTES);
           wide; wide &= wide - 1) {
        const int l = __ffs(wide) - 1;
        const int wmo = __shfl_sync(FULL, mo, l);
        const int woff = __shfl_sync(FULL, q.off, l);
        const int wml = __shfl_sync(FULL, q.ml, l);
        if (direct)
          copy_warp<false>(o, wmo, woff, wml);
        else
          copy_warp<true>(o, wmo, woff, wml);
      }
      pending = pending && !ready;
      __syncwarp();
    }
    k.lap(direct ? 5 : 3, static_cast<uint32_t>(rounds));
    if (direct) {
      hist_lo = o1;
    } else {
      for (int c = o0 + lane; c < o1; c += 32) dst[c] = hist[c & (HIST - 1)];
      k.lap(4, 0);
    }
    ++batches;
    lit_bytes += lits;
    earlies += __popc(__ballot_sync(FULL, early));
  }
  __syncwarp();
  warp_zero(dst, static_cast<int>(end), out_cap);
  k.lap(6, 0);
  const long long t1 = stamp(static_cast<uint32_t>(end));
  if (lane == 0 && row == 0) {
    for (int p = 0; p < 7; ++p) cycles[p] = k.sum[p];
    cycles[7] = t1 - t0c;
    cycles[8] = batches;
    cycles[9] = rounds;
    cycles[10] = S;
    cycles[11] = lit_bytes;
    cycles[12] = earlies;
  }
}

// The deflate tables as they stood before their redesign
// (csrc/deflate_encode.cu: a warp a row, two rows a block; the warp's
// histograms by shared-memory atomics, then lane 0 alone runs
// package-merge with the std::sort replica on (weight, node) items in
// shared memory, each level's order stored to device memory and marked
// level by level), writing its record where the source's emit kernel
// (included above in namespace dfe) reads it, so that
// tpz_deflate_tables_clocks can run that kernel after the copy for the
// stream's bytes.  Block 0's row 0 cycles by part: 0 the histograms, 1 the
// literal tree's partitions (the median of three, the unguarded partition
// and the stack), 2 its final insertion sort, 3 its heap-sort fallback, 4
// building each of its levels' items, 5 storing its levels' orders, 6 its
// marking, 7 the distance tree, 8 the lengths run-length coded with the
// code-length tree, 9 the degenerate tables' fixes, the canonical codes,
// the header's bits and the record's store; cycles[10] the whole row;
// from [11] the counters of row 0 (tools/step_clocks.py's TABLE_COUNTERS).
namespace tables_old {

constexpr int PKG = 1 << 10;
constexpr int LV = 576;
constexpr int THRESHOLD = 16;
constexpr int TABLE_WARPS = 2;
constexpr int LEVEL_BYTES = 20480;   // a row's levels' orders, then the
constexpr int PREV_PK = 17408;       // previous level's package weights
constexpr int PARTS = 10;
constexpr int NCOUNT = 9;
// counters: 0 literal levels sorted, 1 literal items sorted, 2-4 literal
// partitions of ranges of 17-32, 33-64 and more items, 5 literal heap
// sorts, 6 literal levels whose items equal the previous level's, 7 the
// same for the distance tree, 8 distance items sorted

__constant__ int8_t kOrder[19] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                                  11, 4,  12, 3, 13, 2, 14, 1, 15};

template <bool STAMP>
struct TClocks {
  long long t, sum[PARTS], cnt[NCOUNT];
  __device__ __forceinline__ void start() {
    t = stamp(0);
    for (int i = 0; i < PARTS; ++i) sum[i] = 0;
    for (int i = 0; i < NCOUNT; ++i) cnt[i] = 0;
  }
  __device__ __forceinline__ void lap(int part, uint32_t dep) {
    if (!STAMP) return;
    const long long now = stamp(dep);
    sum[part] += now - t;
    t = now;
  }
  __device__ __forceinline__ void count(int c, long long v) {
    if (STAMP && c >= 0) cnt[c] += v;
  }
};

// the parts (and counters, -1 for none) a tree's work is stamped to
struct TreeParts {
  int build, store, mark, part, ins, heap;
  int c_levels, c_items, c_parts, c_heap, c_equal;
};

struct Items {
  unsigned long long* w;
  uint16_t* id;
  __device__ __forceinline__ void swap(int a, int b) const {
    const unsigned long long tw = w[a];
    w[a] = w[b];
    w[b] = tw;
    const uint16_t ti = id[a];
    id[a] = id[b];
    id[b] = ti;
  }
};

__device__ void adjust_heap(const Items& a, int first, int hole, int len,
                            unsigned long long vw, uint16_t vid) {
  const int top = hole;
  int child = hole;
  while (child < (len - 1) / 2) {
    child = 2 * (child + 1);
    if (a.w[first + child] < a.w[first + child - 1]) --child;
    a.w[first + hole] = a.w[first + child];
    a.id[first + hole] = a.id[first + child];
    hole = child;
  }
  if ((len & 1) == 0 && child == (len - 2) / 2) {
    child = 2 * (child + 1);
    a.w[first + hole] = a.w[first + child - 1];
    a.id[first + hole] = a.id[first + child - 1];
    hole = child - 1;
  }
  int parent = (hole - 1) / 2;
  while (hole > top && a.w[first + parent] < vw) {
    a.w[first + hole] = a.w[first + parent];
    a.id[first + hole] = a.id[first + parent];
    hole = parent;
    parent = (hole - 1) / 2;
  }
  a.w[first + hole] = vw;
  a.id[first + hole] = vid;
}

__device__ void heap_sort(const Items& a, int first, int last) {
  const int len = last - first;
  if (len >= 2) {
    for (int parent = (len - 2) / 2;; --parent) {
      adjust_heap(a, first, parent, len, a.w[first + parent],
                  a.id[first + parent]);
      if (parent == 0) break;
    }
  }
  while (last - first > 1) {
    --last;
    const unsigned long long vw = a.w[last];
    const uint16_t vid = a.id[last];
    a.w[last] = a.w[first];
    a.id[last] = a.id[first];
    adjust_heap(a, first, 0, last - first, vw, vid);
  }
}

__device__ void unguarded_linear_insert(const Items& a, int last) {
  const unsigned long long vw = a.w[last];
  const uint16_t vid = a.id[last];
  int next = last - 1;
  while (vw < a.w[next]) {
    a.w[last] = a.w[next];
    a.id[last] = a.id[next];
    last = next;
    --next;
  }
  a.w[last] = vw;
  a.id[last] = vid;
}

__device__ void insertion_sort(const Items& a, int first, int last) {
  for (int i = first + 1; i < last; ++i) {
    if (a.w[i] < a.w[first]) {
      const unsigned long long vw = a.w[i];
      const uint16_t vid = a.id[i];
      for (int k = i; k > first; --k) {
        a.w[k] = a.w[k - 1];
        a.id[k] = a.id[k - 1];
      }
      a.w[first] = vw;
      a.id[first] = vid;
    } else {
      unguarded_linear_insert(a, i);
    }
  }
}

template <bool STAMP>
__device__ void std_sort(const Items& a, int n, TClocks<STAMP>& k,
                         const TreeParts& tp) {
  if (n == 0) return;
  k.count(tp.c_levels, 1);
  k.count(tp.c_items, n);
  struct Range {
    int16_t first, last, depth;
  } stack[48];
  int sp = 0;
  stack[sp++] = {0, static_cast<int16_t>(n),
                 static_cast<int16_t>(2 * (31 - __clz(n)))};
  while (sp) {
    const Range r = stack[--sp];
    int first = r.first, last = r.last, depth = r.depth;
    while (last - first > THRESHOLD) {
      if (depth == 0) {
        k.lap(tp.part, static_cast<uint32_t>(a.w[first]));
        heap_sort(a, first, last);
        k.count(tp.c_heap, 1);
        k.lap(tp.heap, static_cast<uint32_t>(a.w[first]));
        break;
      }
      if (tp.c_parts >= 0)
        k.count(tp.c_parts + (last - first > 64 ? 2
                              : last - first > 32 ? 1 : 0), 1);
      --depth;
      const int x = first + 1, y = first + (last - first) / 2, z = last - 1;
      int pick;
      if (a.w[x] < a.w[y])
        pick = a.w[y] < a.w[z] ? y : a.w[x] < a.w[z] ? z : x;
      else
        pick = a.w[x] < a.w[z] ? x : a.w[y] < a.w[z] ? z : y;
      a.swap(first, pick);
      const unsigned long long pivot = a.w[first];
      int lo = first + 1, hi = last;
      for (;;) {
        while (a.w[lo] < pivot) ++lo;
        --hi;
        while (pivot < a.w[hi]) --hi;
        if (!(lo < hi)) break;
        a.swap(lo, hi);
        ++lo;
      }
      stack[sp++] = {static_cast<int16_t>(lo), static_cast<int16_t>(last),
                     static_cast<int16_t>(depth)};
      last = lo;
    }
  }
  k.lap(tp.part, static_cast<uint32_t>(a.w[0]));
  if (n > THRESHOLD) {
    insertion_sort(a, 0, THRESHOLD);
    for (int i = THRESHOLD; i < n; ++i) unguarded_linear_insert(a, i);
  } else {
    insertion_sort(a, 0, n);
  }
  k.lap(tp.ins, static_cast<uint32_t>(a.w[n - 1]));
}

struct Merge {
  Items items;
  unsigned long long* pk;
  uint8_t* mark;
  uint16_t* lv;                 // every level's order (device memory)
  unsigned long long* prev_pk;  // the previous level's packages (stamped)
};

template <bool STAMP>
__device__ void package_merge(const uint32_t* freq, int n, int maxbits,
                              uint8_t* lens, const Merge& s,
                              TClocks<STAMP>& k, const TreeParts& tp) {
  int na = 0, only = 0;
  for (int q = 0; q < n; ++q) {
    lens[q] = 0;
    if (freq[q]) {
      ++na;
      only = q;
    }
  }
  if (na < 2) {
    if (na) lens[only] = 1;
    k.lap(tp.build, static_cast<uint32_t>(na));
    return;
  }
  int size[16];
  int m = 0, prev_np = -1;
  for (int level = 0; level < maxbits; ++level) {
    const int np = m / 2;
    for (int q = 0; q < np; ++q)
      s.pk[q] = s.items.w[2 * q] + s.items.w[2 * q + 1];
    if (STAMP && tp.c_equal >= 0) {
      bool same = np == prev_np;
      for (int q = 0; q < np; ++q) {
        same = same && s.prev_pk[q] == s.pk[q];
        s.prev_pk[q] = s.pk[q];
      }
      k.count(tp.c_equal, same);
      prev_np = np;
    }
    int j = 0;
    for (int q = 0; q < n; ++q)
      if (freq[q]) {
        s.items.w[j] = freq[q];
        s.items.id[j++] = static_cast<uint16_t>(q);
      }
    for (int q = 0; q < np; ++q) {
      s.items.w[j] = s.pk[q];
      s.items.id[j++] = static_cast<uint16_t>(PKG + q);
    }
    m = size[level] = j;
    k.lap(tp.build, static_cast<uint32_t>(s.items.w[j - 1]));
    std_sort(s.items, m, k, tp);
    for (int q = 0; q < m; ++q) s.lv[level * LV + q] = s.items.id[q];
    k.lap(tp.store, static_cast<uint32_t>(m));
  }
  uint8_t* cur = s.mark;
  uint8_t* below = s.mark + LV;
  const int take = min(2 * na - 2, m);
  for (int q = 0; q < m; ++q) cur[q] = q < take;
  for (int level = maxbits - 1; level >= 0; --level) {
    const int nb = level ? size[level - 1] : 0;
    for (int q = 0; q < nb; ++q) below[q] = 0;
    for (int q = 0; q < size[level]; ++q) {
      if (!cur[q]) continue;
      const int node = s.lv[level * LV + q];
      if (node < PKG) {
        ++lens[node];
      } else {
        below[2 * (node - PKG)] = 1;
        below[2 * (node - PKG) + 1] = 1;
      }
    }
    uint8_t* t = cur;
    cur = below;
    below = t;
  }
  k.lap(tp.mark, static_cast<uint32_t>(lens[0]));
}

__device__ void one_code(uint8_t* lens, int n) {
  int nz = 0, s0 = 0;
  for (int s = n - 1; s >= 0; --s)
    if (lens[s]) {
      ++nz;
      s0 = s;
    }
  if (nz == 1) {
    lens[s0] = 1;
    lens[s0 ? 0 : 1] = 1;
  }
}

__device__ void canon_codes(const uint8_t* lens, int n, uint16_t* codes) {
  int cnt[16] = {0};
  for (int i = 0; i < n; ++i) cnt[lens[i]]++;
  cnt[0] = 0;
  uint32_t next[16] = {0};
  uint32_t code = 0;
  for (int l = 1; l < 16; ++l) {
    code = (code + cnt[l - 1]) << 1;
    next[l] = code;
  }
  for (int i = 0; i < n; ++i) {
    const int l = lens[i];
    codes[i] = l ? static_cast<uint16_t>(__brev(next[l]++) >> (32 - l)) : 0;
  }
}

struct BitWr {
  uint8_t* p;
  int pos = 0;
  unsigned long long buf = 0;
  int cnt = 0;
  __device__ void bits(uint32_t v, int k) {
    buf |= static_cast<unsigned long long>(v) << cnt;
    cnt += k;
    while (cnt >= 8) {
      p[pos++] = static_cast<uint8_t>(buf);
      buf >>= 8;
      cnt -= 8;
    }
  }
  __device__ int flush() {
    if (cnt) p[pos] = static_cast<uint8_t>(buf);
    return 8 * pos + cnt;
  }
};

struct TableShared {
  uint32_t lfreq[288];
  uint32_t dfreq[32];
  unsigned long long w[LV];
  unsigned long long pk[LV / 2];
  uint16_t id[LV];
  uint16_t codes[320];
  uint8_t lens[320];
  uint8_t mark[2 * LV];
  uint8_t clsym[320];
  uint8_t clextra[320];
  uint8_t cllen[20];
  uint16_t clcode[20];
};

}  // namespace tables_old

template <bool STAMP>
__global__ void __launch_bounds__(32 * tables_old::TABLE_WARPS)
deflate_tables_clocks(const int32_t* __restrict__ tokens,
                      const int32_t* __restrict__ ntok, int B, int n,
                      int mode, uint8_t* __restrict__ comp, int pitch,
                      uint8_t* __restrict__ scratch,
                      uint8_t* __restrict__ levels, long long* cycles) {
  using namespace tables_old;
  __shared__ TableShared sh_all[TABLE_WARPS];
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * TABLE_WARPS + threadIdx.x / 32;
  if (row >= B) return;
  TableShared& sh = sh_all[threadIdx.x / 32];
  uint8_t* rec = scratch + static_cast<size_t>(row) * dfe::SCRATCH_BYTES;
  uint8_t* lvl = levels + static_cast<size_t>(row) * LEVEL_BYTES;
  uint8_t* dst = comp + static_cast<size_t>(row) * pitch;
  uint8_t* llen = sh.lens;
  uint8_t* dlen = sh.lens + 288;
  TClocks<STAMP> k;
  k.start();
  const long long t0 = k.t;
  for (int q = lane; q < 320; q += 32) {
    sh.lens[q] = 0;
    sh.codes[q] = 0;
    if (q < 288) sh.lfreq[q] = 0;
    if (q < 32) sh.dfreq[q] = 0;
  }
  __syncwarp();
  if (mode == 0) {
    const int32_t* tok = tokens + static_cast<size_t>(row) * n;
    const int nt = ntok[row];
    for (int t = lane; t < nt; t += 32) {
      const int v = tok[t];
      if (v < 256) {
        atomicAdd(&sh.lfreq[v], 1u);
      } else {
        atomicAdd(&sh.lfreq[257 + dfe::len_code(v >> 16)], 1u);
        atomicAdd(&sh.dfreq[dfe::dist_code(v & 0xFFFF)], 1u);
      }
    }
  }
  __syncwarp();
  k.lap(0, sh.lfreq[0]);
  if (lane == 0) {
    BitWr bw{dst};
    if (mode == 1) {
      for (int s = 0; s < 288; ++s)
        llen[s] = s < 144 ? 8 : s < 256 ? 9 : s < 280 ? 7 : 8;
      for (int s = 0; s < 30; ++s) dlen[s] = 5;
      canon_codes(llen, 288, sh.codes);
      canon_codes(dlen, 30, sh.codes + 288);
      bw.bits(1, 1);
      bw.bits(1, 2);
    } else {
      const Merge s{{sh.w, sh.id}, sh.pk, sh.mark,
                    reinterpret_cast<uint16_t*>(lvl),
                    reinterpret_cast<unsigned long long*>(lvl + PREV_PK)};
      const TreeParts lit{4, 5, 6, 1, 2, 3, 0, 1, 2, 5, 6};
      const TreeParts dist{7, 7, 7, 7, 7, 7, -1, 8, -1, -1, 7};
      const TreeParts cl{8, 8, 8, 8, 8, 8, -1, -1, -1, -1, -1};
      sh.lfreq[256] = 1;
      package_merge(sh.lfreq, 286, 15, llen, s, k, lit);
      package_merge(sh.dfreq, 30, 15, dlen, s, k, dist);
      one_code(llen, 286);
      int nd = 0;
      for (int q = 0; q < 30; ++q) nd += dlen[q] != 0;
      if (nd == 0) dlen[0] = 1;
      canon_codes(llen, 286, sh.codes);
      canon_codes(dlen, 30, sh.codes + 288);
      int hlit = 286, hdist = 30;
      while (hlit > 257 && llen[hlit - 1] == 0) --hlit;
      while (hdist > 1 && dlen[hdist - 1] == 0) --hdist;
      k.lap(9, sh.codes[0]);
      const int nall = hlit + hdist;
      auto at = [&](int q) { return q < hlit ? llen[q] : dlen[q - hlit]; };
      uint32_t* clfreq = sh.lfreq;
      for (int q = 0; q < 19; ++q) clfreq[q] = 0;
      int ncl = 0;
      for (int q = 0; q < nall;) {
        const int v = at(q);
        int run = 1;
        while (q + run < nall && at(q + run) == v) ++run;
        q += run;
        if (v == 0) {
          while (run >= 3) {
            const int take = min(run, 138);
            sh.clsym[ncl] = take >= 11 ? 18 : 17;
            sh.clextra[ncl++] = take - (take >= 11 ? 11 : 3);
            clfreq[take >= 11 ? 18 : 17]++;
            run -= take;
          }
        } else {
          sh.clsym[ncl] = v;
          sh.clextra[ncl++] = 0;
          clfreq[v]++;
          --run;
          while (run >= 3) {
            const int take = min(run, 6);
            sh.clsym[ncl] = 16;
            sh.clextra[ncl++] = take - 3;
            clfreq[16]++;
            run -= take;
          }
        }
        for (; run > 0; --run) {
          sh.clsym[ncl] = v;
          sh.clextra[ncl++] = 0;
          clfreq[v]++;
        }
      }
      package_merge(clfreq, 19, 7, sh.cllen, s, k, cl);
      one_code(sh.cllen, 19);
      canon_codes(sh.cllen, 19, sh.clcode);
      int hclen = 19;
      while (hclen > 4 && sh.cllen[kOrder[hclen - 1]] == 0) --hclen;
      k.lap(8, sh.clcode[0]);
      bw.bits(1, 1);
      bw.bits(2, 2);
      bw.bits(hlit - 257, 5);
      bw.bits(hdist - 1, 5);
      bw.bits(hclen - 4, 4);
      for (int q = 0; q < hclen; ++q) bw.bits(sh.cllen[kOrder[q]], 3);
      for (int q = 0; q < ncl; ++q) {
        const int sym = sh.clsym[q];
        bw.bits(sh.clcode[sym], sh.cllen[sym]);
        if (sym >= 16)
          bw.bits(sh.clextra[q], sym == 16 ? 2 : sym == 17 ? 3 : 7);
      }
    }
    *reinterpret_cast<int32_t*>(rec + dfe::REC_HBITS) = bw.flush();
  }
  __syncwarp();
  uint16_t* codes = reinterpret_cast<uint16_t*>(rec + dfe::REC_CODES);
  for (int q = lane; q < 320; q += 32) {
    codes[q] = sh.codes[q];
    rec[dfe::REC_LENS + q] = sh.lens[q];
  }
  __syncwarp();
  k.lap(9, codes[lane]);
  const long long t1 = stamp(static_cast<uint32_t>(rec[dfe::REC_LENS]));
  if (lane == 0 && row == 0) {
    for (int p = 0; p < PARTS; ++p) cycles[p] = k.sum[p];
    cycles[PARTS] = t1 - t0;
    for (int c = 0; c < NCOUNT; ++c) cycles[PARTS + 1 + c] = k.cnt[c];
  }
}

// The redesigned deflate tables (csrc/deflate_encode.cu, included above in
// namespace dfe): this kernel body, its warp_sort and its package_merge
// are copies of the source's (keep them in step), stamped by part; the
// rest is the source's own functions.  Row 0's cycles by part, on each
// warp's lane 0 (warp 0 the literal/length tree then the header, warp 1
// the distance tree then the canonical codes): 0 the histograms, 1 each
// level's packages, the test against the last level's and the items, 2
// the warp's partitions, 3 the final ranges' pass, 4 the level stores, 5
// the marking, 6 the wait for the other warp's tree, 7 the degenerate
// tables' fixes, 8 the header (warp 0) or the canonical codes (warp 1), 9
// the record's store (a lap after a __syncthreads may hold some of the
// wait before it); then the whole row, and counters: levels sorted,
// levels skipped, warp partitions, final ranges of 2 items or more, heap
// sorts.  Warp 0's 16 entries first, then warp 1's.
namespace tables_new {

constexpr int PARTS = 10;
constexpr int NCOUNT = 5;

template <bool STAMP>
struct NClocks {
  long long t, sum[PARTS], cnt[NCOUNT];
  __device__ __forceinline__ void start() {
    t = stamp(0);
    for (int i = 0; i < PARTS; ++i) sum[i] = 0;
    for (int i = 0; i < NCOUNT; ++i) cnt[i] = 0;
  }
  __device__ __forceinline__ void lap(int part, uint32_t dep) {
    if (!STAMP) return;
    const long long now = stamp(dep);
    sum[part] += now - t;
    t = now;
  }
  __device__ __forceinline__ void count(int c, long long v) {
    if (STAMP) cnt[c] += v;
  }
};

template <int NV, bool STAMP>
__device__ __forceinline__ void warp_sort(unsigned long long* a, int n,
                                          const dfe::SortSpace& s, int lane,
                                          NClocks<STAMP>& k) {
  using dfe::THRESHOLD;
  if (n < 2) return;
  for (int p = lane; p < n; p += 32) s.block[p] = p | (p + 1) << 16;
  __syncwarp();
  int sp = 0;
  int first = 0, last = n, depth = 2 * (31 - __clz(n));
  for (;;) {
    while (last - first > THRESHOLD) {
      if (depth == 0) {
        if (lane == 0) dfe::heap_sort(a, first, last);
        __syncwarp();
        k.count(4, 1);
        first = last;
        break;
      }
      --depth;
      const int cut = dfe::pair_partition(a, first, last, s, lane);
      k.count(2, 1);
      if (last - cut > THRESHOLD) {
        if (lane == 0) s.stack[sp] = dfe::range(cut, last, depth);
        ++sp;
      } else {
        dfe::add_block(s, cut, last, lane);
        k.count(3, last - cut > 1);
      }
      last = cut;
    }
    dfe::add_block(s, first, last, lane);
    k.count(3, last - first > 1);
    if (sp == 0) break;
    __syncwarp();
    const uint32_t r = s.stack[--sp];
    first = r & 1023;
    last = (r >> 10) & 1023;
    depth = r >> 20;
  }
  __syncwarp();
  k.lap(2, static_cast<uint32_t>(a[0]));
  unsigned long long v[(NV + 31) / 32];
  int at[(NV + 31) / 32];
#pragma unroll
  for (int j = 0; j < (NV + 31) / 32; ++j) {
    const int p = j * 32 + lane;
    at[j] = -1;
    if (p < n) {
      const uint32_t b = s.block[p];
      const int f = b & 0xFFFF, l = b >> 16;
      v[j] = a[p];
      const unsigned long long w = dfe::wt(v[j]);
      int r = f;
      for (int q = f; q < l; ++q) {
        const unsigned long long x = dfe::wt(a[q]);
        r += x < w || (x == w && q < p);
      }
      at[j] = r;
    }
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < (NV + 31) / 32; ++j)
    if (at[j] >= 0) a[at[j]] = v[j];
  __syncwarp();
  k.lap(3, static_cast<uint32_t>(a[0]));
}

template <int NSYM, int LVN, int MAXBITS, bool STAMP>
__device__ __forceinline__ void package_merge(const uint32_t* freq,
                                              uint8_t* lens,
                                              dfe::Tree<NSYM, LVN>& t,
                                              uint16_t* lv, int lane,
                                              NClocks<STAMP>& k) {
  using dfe::FULL;
  using dfe::KEY_SHIFT;
  using dfe::PKG;
  using dfe::wt;
  const unsigned below = (1u << lane) - 1;
  const dfe::SortSpace s{t.left, t.right, t.stack, t.block};
  int na = 0;
  for (int s0 = 0; s0 < NSYM; s0 += 32) {
    const int sym = s0 + lane;
    const uint32_t f = sym < NSYM ? freq[sym] : 0;
    if (sym < NSYM) lens[sym] = 0;
    const unsigned act = __ballot_sync(FULL, f != 0);
    if (f)
      t.leaf[na + __popc(act & below)] =
          static_cast<unsigned long long>(f) << KEY_SHIFT | sym;
    na += __popc(act);
  }
  __syncwarp();
  if (na < 2) {
    if (na && lane == 0) lens[t.leaf[0] & 0xFFFF] = 1;
    __syncwarp();
    k.lap(1, static_cast<uint32_t>(na));
    return;
  }
  int m = 0, last_np = -1;
  for (int level = 0; level < MAXBITS; ++level) {
    const int np = m / 2;
    unsigned long long* pk = t.pk[level & 1];
    const unsigned long long* was = t.pk[(level & 1) ^ 1];
    bool same = np == last_np;
    for (int k0 = 0; k0 < np; k0 += 32) {
      const int q = k0 + lane;
      bool differs = false;
      if (q < np) {
        pk[q] = wt(t.a[2 * q]) + wt(t.a[2 * q + 1]);
        differs = pk[q] != was[q];
      }
      same = same && !__any_sync(FULL, differs);
    }
    last_np = np;
    __syncwarp();
    if (!same) {
      for (int q = lane; q < na; q += 32) t.a[q] = t.leaf[q];
      for (int q = lane; q < np; q += 32)
        t.a[na + q] = pk[q] << KEY_SHIFT | (PKG + q);
      m = na + np;
      __syncwarp();
      k.lap(1, static_cast<uint32_t>(t.a[0]));
      warp_sort<LVN>(t.a, m, s, lane, k);
      k.count(0, 1);
    } else {
      k.count(1, 1);
      k.lap(1, 0);
    }
    if (lane == 0) t.size[level] = m;
    for (int q = lane; q < m; q += 32)
      lv[level * LVN + q] = static_cast<uint16_t>(t.a[q] & 0xFFFF);
    k.lap(4, static_cast<uint32_t>(m));
  }
  uint8_t* cur = t.mark[0];
  uint8_t* under = t.mark[1];
  const int take = min(2 * na - 2, m);
  for (int q = lane; q < m; q += 32) cur[q] = q < take;
  __syncwarp();
  for (int level = MAXBITS - 1; level >= 0; --level) {
    const int nb = level ? t.size[level - 1] : 0, nl = t.size[level];
    for (int q = lane; q < nb; q += 32) under[q] = 0;
    uint16_t node[(LVN + 31) / 32];
#pragma unroll
    for (int j = 0; j < (LVN + 31) / 32; ++j) {
      const int q = j * 32 + lane;
      node[j] = q < nl ? lv[level * LVN + q] : 0;
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < (LVN + 31) / 32; ++j) {
      const int q = j * 32 + lane;
      if (q < nl && cur[q]) {
        const int nd = node[j];
        if (nd < PKG) {
          ++lens[nd];
        } else {
          under[2 * (nd - PKG)] = 1;
          under[2 * (nd - PKG) + 1] = 1;
        }
      }
    }
    __syncwarp();
    uint8_t* tmp = cur;
    cur = under;
    under = tmp;
  }
  k.lap(5, lens[0]);
}

}  // namespace tables_new

template <bool STAMP>
__global__ void __launch_bounds__(dfe::TABLE_THREADS)
deflate_tables_new_clocks(const int32_t* __restrict__ tokens,
                          const int32_t* __restrict__ ntok, int n,
                          uint8_t* __restrict__ comp, int pitch,
                          uint8_t* __restrict__ scratch, long long* cycles) {
  using namespace dfe;
  using tables_new::NClocks;
  __shared__ TableShared sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.x;
  uint8_t* rec = scratch + static_cast<size_t>(row) * SCRATCH_BYTES;
  uint8_t* dst = comp + static_cast<size_t>(row) * pitch;
  uint8_t* llen = sh.lens;
  uint8_t* dlen = sh.lens + 288;
  NClocks<STAMP> k;
  k.start();
  const long long t0 = k.t;
  for (int q = tid; q < 320; q += TABLE_THREADS) {
    sh.lens[q] = 0;
    sh.codes[q] = 0;
    if (q < 288) sh.lfreq[q] = 0;
    if (q < 32) sh.dfreq[q] = 0;
  }
  for (int q = tid; q < HDR_WORDS; q += TABLE_THREADS) sh.hdr[q] = 0;
  __syncthreads();
  const int32_t* tok = tokens + static_cast<size_t>(row) * n;
  const int nt = ntok[row];
  for (int t0g = 0; t0g < nt; t0g += TABLE_THREADS * HIST_BATCH) {
    int v[HIST_BATCH];
#pragma unroll
    for (int j = 0; j < HIST_BATCH; ++j) {
      const int t = t0g + j * TABLE_THREADS + tid;
      v[j] = t < nt ? tok[t] : -1;
    }
#pragma unroll
    for (int j = 0; j < HIST_BATCH; ++j) {
      if (v[j] < 0) continue;
      if (v[j] < 256) {
        atomicAdd(&sh.lfreq[v[j]], 1u);
      } else {
        atomicAdd(&sh.lfreq[257 + len_code(v[j] >> 16)], 1u);
        atomicAdd(&sh.dfreq[dist_code(v[j] & 0xFFFF)], 1u);
      }
    }
  }
  __syncthreads();
  if (tid == 0) sh.lfreq[256] = 1;
  __syncthreads();
  k.lap(0, sh.lfreq[0]);
  if (warp == 0)
    tables_new::package_merge<286, LIT_LV, 15>(
        sh.lfreq, llen, sh.lit, reinterpret_cast<uint16_t*>(rec), lane, k);
  else
    tables_new::package_merge<30, DIST_LV, 15>(sh.dfreq, dlen, sh.dist,
                                               sh.dlv, lane, k);
  __syncthreads();
  k.lap(6, sh.lens[lane]);
  if (warp == 0) {
    one_code(llen, 286, lane);
    if (!__any_sync(FULL, lane < 30 && dlen[lane]) && lane == 0) dlen[0] = 1;
  }
  __syncthreads();
  k.lap(7, sh.lens[lane]);
  if (warp == 1) {
    canon_codes(llen, 286, sh.codes, sh.cnt[1], sh.next[1], lane);
    canon_codes(dlen, 30, sh.codes + 288, sh.cnt[1], sh.next[1], lane);
  } else {
    const int hbits = dynamic_header(sh, dst, lane);
    if (lane == 0) *reinterpret_cast<int32_t*>(rec + REC_HBITS) = hbits;
  }
  k.lap(8, sh.codes[lane]);
  __syncthreads();
  uint16_t* codes = reinterpret_cast<uint16_t*>(rec + REC_CODES);
  for (int q = tid; q < 320; q += TABLE_THREADS) {
    codes[q] = sh.codes[q];
    rec[REC_LENS + q] = sh.lens[q];
  }
  __syncthreads();
  k.lap(9, codes[lane]);
  const long long t1 = stamp(static_cast<uint32_t>(rec[REC_LENS]));
  if (lane == 0 && row == 0) {
    long long* c = cycles + 16 * warp;
    for (int p = 0; p < tables_new::PARTS; ++p) c[p] = k.sum[p];
    c[tables_new::PARTS] = t1 - t0;
    for (int q = 0; q < tables_new::NCOUNT; ++q)
      c[tables_new::PARTS + 1 + q] = k.cnt[q];
  }
}


// The device rule's tables (csrc/deflate_encode.cu's
// deflate_tables_kernel<TupleShared>) as they stood before their redesign:
// a CTA of two warps a row, each tree's levels as tuples in pools of
// shared memory (36,160 B a CTA), the leaves ranked by counting every
// leaf a lane (O(na^2)).  Copies of its TupleTree, tuple_merge, shared
// struct and dynamic_header, stamped by part; the rest is the source's own
// functions.  Row 0's cycles by part, on each warp's lane 0 (warp 0 the
// literal/length tree then the header, warp 1 the distance tree then the
// canonical codes): 0 the histograms, 1 the leaves' rank, 2 the levels'
// ranking, 3 the offsets scan, 4 the pool build, 5 the lengths' count, 6
// the wait for the other warp's tree, 7 the degenerate tables' fixes, 8
// the header (warp 0) or the canonical codes (warp 1), 9 the record's
// store; then the whole row, and counters: active symbols, levels,
// items ranked, pool symbols written, equal-weight tuple compares (summed
// over the warp).  Warp 0's 16 entries first, then warp 1's.
namespace tuple_old {

using dfe::FULL;
using dfe::LEAF;
using dfe::partition_point;
using dfe::tuple_cmp;

template <int NSYM, int LVN, int POOL>
struct TupleTree {
  uint32_t lw[NSYM];
  uint32_t w[2][LVN];
  uint32_t starts[(POOL + 31) / 32];
  uint16_t ls[NSYM];
  uint16_t off[2][LVN + 1];
  uint16_t src[LVN];
  uint16_t pool[2][POOL];
};

template <int NSYM, int LVN, int POOL, int LIMIT, bool STAMP>
__device__ __forceinline__ void tuple_merge(
    uint32_t* freq, uint8_t* lens, TupleTree<NSYM, LVN, POOL>& t, int lane,
    tables_new::NClocks<STAMP>& k) {
  const unsigned below = (1u << lane) - 1;
  int na = 0;
  for (int s0 = 0; s0 < NSYM; s0 += 32) {
    const int sym = s0 + lane;
    const uint32_t f = sym < NSYM ? freq[sym] : 0;
    if (sym < NSYM) lens[sym] = 0;
    const unsigned act = __ballot_sync(FULL, f != 0);
    if (f) {
      t.w[1][na + __popc(act & below)] = f;
      t.src[na + __popc(act & below)] = static_cast<uint16_t>(sym);
    }
    na += __popc(act);
  }
  __syncwarp();
  k.count(0, na);
  if (na < 2) {
    if (na && lane == 0) lens[t.src[0]] = 1;
    __syncwarp();
    k.lap(1, static_cast<uint32_t>(na));
    return;
  }
  for (int q = lane; q < na; q += 32) {
    const uint32_t f = t.w[1][q];
    int r = 0;
    for (int j = 0; j < na; ++j) {
      const uint32_t g = t.w[1][j];
      r += g < f || (g == f && j < q);
    }
    t.lw[r] = f;
    t.ls[r] = t.src[q];
  }
  __syncwarp();
  for (int q = lane; q < na; q += 32) {
    t.w[0][q] = t.lw[q];
    t.pool[0][q] = t.ls[q];
    t.off[0][q] = static_cast<uint16_t>(q);
  }
  if (lane == 0) t.off[0][na] = static_cast<uint16_t>(na);
  __syncwarp();
  k.lap(1, t.w[0][0]);
  int m = na, cur = 0;
  for (int level = 1; level < LIMIT; ++level) {
    const int np = m / 2, mm = na + np, nxt = cur ^ 1;
    const uint32_t* w = t.w[cur];
    const uint16_t* off = t.off[cur];
    const uint16_t* pool = t.pool[cur];
    auto pw = [&](int j) { return w[2 * j] + w[2 * j + 1]; };
    const int total = na + off[2 * np];
    for (int q = lane; q < (total + 31) / 32; q += 32) t.starts[q] = 0;
    int cmps = 0;
    for (int q = lane; q < mm; q += 32) {
      uint32_t wk;
      int r, len, from;
      if (q < na) {
        wk = t.lw[q];
        const int s = t.ls[q];
        int p = partition_point(0, np, [&](int j) { return pw(j) < wk; });
        r = q + p;
        for (; p < np && pw(p) == wk; ++p) r += pool[off[2 * p]] < s;
        len = 1;
        from = s | LEAF;
      } else {
        const int j = q - na;
        wk = pw(j);
        from = off[2 * j];
        len = off[2 * j + 2] - from;
        const int t0 = pool[from];
        const int llo =
            partition_point(0, na, [&](int i) { return t.lw[i] < wk; });
        r = partition_point(llo, na, [&](int i) {
          return t.lw[i] == wk && t.ls[i] <= t0;
        });
        int p = partition_point(0, np, [&](int i) { return pw(i) < wk; });
        r += p;
        for (; p < np && pw(p) == wk; ++p) {
          if (p == j) continue;
          const int b0 = off[2 * p];
          const int c = tuple_cmp(pool, b0, off[2 * p + 2] - b0, from, len);
          r += c < 0 || (c == 0 && p < j);
          ++cmps;
        }
      }
      t.w[nxt][r] = wk;
      t.src[r] = static_cast<uint16_t>(from);
      t.off[nxt][r + 1] = static_cast<uint16_t>(len);
    }
    __syncwarp();
    k.count(1, 1);
    k.count(2, mm);
    k.count(3, total);
    if constexpr (STAMP) k.count(4, __reduce_add_sync(FULL, cmps));
    k.lap(2, t.w[nxt][0]);
    int base = 0;
    for (int k0 = 0; k0 < mm; k0 += 32) {
      const int q = k0 + lane;
      const int len = q < mm ? t.off[nxt][q + 1] : 0;
      int incl = len;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += y;
      }
      if (q < mm) {
        const int at = base + incl - len;
        t.off[nxt][q + 1] = static_cast<uint16_t>(base + incl);
        atomicOr(&t.starts[at >> 5], 1u << (at & 31));
      }
      base += __shfl_sync(FULL, incl, 31);
    }
    if (lane == 0) t.off[nxt][0] = 0;
    __syncwarp();
    k.lap(3, t.starts[0]);
    int seen = -1;
    for (int q0 = 0; q0 < total; q0 += 32) {
      const unsigned bits = t.starts[q0 >> 5];
      const int q = q0 + lane;
      if (q < total) {
        const int r = seen + __popc(bits & ((2u << lane) - 1));
        const int v = t.src[r];
        t.pool[nxt][q] = v & LEAF ? static_cast<uint16_t>(v & ~LEAF)
                                  : pool[v + q - t.off[nxt][r]];
      }
      seen += __popc(bits);
    }
    __syncwarp();
    k.lap(4, t.pool[nxt][0]);
    m = mm;
    cur = nxt;
  }
  const int end = t.off[cur][min(2 * na - 2, m)];
  for (int s = lane; s < NSYM; s += 32) freq[s] = 0;
  __syncwarp();
  for (int q = lane; q < end; q += 32) atomicAdd(&freq[t.pool[cur][q]], 1u);
  __syncwarp();
  for (int s = lane; s < NSYM; s += 32)
    lens[s] = static_cast<uint8_t>(freq[s]);
  __syncwarp();
  k.lap(5, lens[0]);
}

struct TupleShared {
  static constexpr bool TUPLE = true;
  uint32_t lfreq[288];
  uint32_t dfreq[32];
  uint32_t clfreq[20];
  uint16_t codes[320];
  uint8_t lens[320];
  TupleTree<286, dfe::LIT_LV, 15 * 286> lit;
  TupleTree<30, dfe::DIST_LV, 15 * 30> dist;
  TupleTree<19, dfe::CL_LV, 7 * 19> cl;
  uint16_t runs[320];
  uint8_t clsym[320];
  uint8_t clextra[320];
  uint8_t cllen[20];
  uint16_t clcode[20];
  int cnt[2][16], next[2][16];
  uint32_t hdr[dfe::HDR_WORDS];
};

// dfe::dynamic_header with this copy's code-length tree (unstamped).
__device__ __forceinline__ int dynamic_header(TupleShared& sh, uint8_t* dst,
                                              int lane) {
  using dfe::kOrder;
  using dfe::HDR_WORDS;
  const unsigned below = (1u << lane) - 1;
  const uint8_t* llen = sh.lens;
  const uint8_t* dlen = sh.lens + 288;
  int lt = -1, dt = -1;
  for (int s = lane; s < 286; s += 32)
    if (llen[s]) lt = s;
  if (lane < 30 && dlen[lane]) dt = lane;
  const int hlit = max(257, __reduce_max_sync(FULL, lt) + 1);
  const int hdist = max(1, __reduce_max_sync(FULL, dt) + 1);
  const int nall = hlit + hdist;
  auto at = [&](int q) { return q < hlit ? llen[q] : dlen[q - hlit]; };
  if (lane < 20) sh.clfreq[lane] = 0;
  int nrun = 0;
  for (int q0 = 0; q0 < nall; q0 += 32) {
    const int q = q0 + lane;
    const bool start = q < nall && (q == 0 || at(q) != at(q - 1));
    const unsigned b = __ballot_sync(FULL, start);
    if (start) sh.runs[nrun + __popc(b & below)] = static_cast<uint16_t>(q);
    nrun += __popc(b);
  }
  if (lane == 0) sh.runs[nrun] = static_cast<uint16_t>(nall);
  __syncwarp();
  int ncl = 0;
  for (int j0 = 0; j0 < nrun; j0 += 32) {
    const int j = j0 + lane;
    int v = 0, r = 0, c = 0;
    if (j < nrun) {
      v = at(sh.runs[j]);
      r = sh.runs[j + 1] - sh.runs[j];
      c = dfe::run_codes<false>(v, r, nullptr, nullptr, nullptr, 0);
    }
    int incl = c;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += y;
    }
    if (j < nrun)
      dfe::run_codes<true>(v, r, sh.clsym, sh.clextra, sh.clfreq,
                           ncl + incl - c);
    ncl += __shfl_sync(FULL, incl, 31);
  }
  __syncwarp();
  tables_new::NClocks<false> none;
  tuple_merge<19, dfe::CL_LV, 7 * 19, 7>(sh.clfreq, sh.cllen, sh.cl, lane,
                                         none);
  dfe::one_code(sh.cllen, 19, lane);
  dfe::canon_codes(sh.cllen, 19, sh.clcode, sh.cnt[0], sh.next[0], lane);
  int hclen = 19;
  while (hclen > 4 && sh.cllen[kOrder[hclen - 1]] == 0) --hclen;
  const int nf = 1 + hclen + ncl;
  int base = 0;
  for (int f0 = 0; f0 < nf; f0 += 32) {
    const int f = f0 + lane;
    uint32_t v = 0;
    int bits = 0;
    if (f == 0) {
      v = 1 | 2 << 1 | (hlit - 257) << 3 | (hdist - 1) << 8 |
          (hclen - 4) << 13;
      bits = 17;
    } else if (f <= hclen) {
      v = sh.cllen[kOrder[f - 1]];
      bits = 3;
    } else if (f < nf) {
      const int q = f - 1 - hclen, sym = sh.clsym[q];
      v = sh.clcode[sym] | static_cast<uint32_t>(sh.clextra[q])
                               << sh.cllen[sym];
      bits = sh.cllen[sym] + (sym < 16 ? 0 : sym == 16 ? 2 : sym == 17 ? 3 : 7);
    }
    int incl = bits;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += y;
    }
    dfe::put(sh.hdr, HDR_WORDS, base + incl - bits, v, bits);
    base += __shfl_sync(FULL, incl, 31);
  }
  __syncwarp();
  const uint8_t* bytes = reinterpret_cast<const uint8_t*>(sh.hdr);
  for (int q = lane; q < (base + 7) / 8; q += 32) dst[q] = bytes[q];
  return base;
}

}  // namespace tuple_old

template <bool STAMP>
__global__ void __launch_bounds__(dfe::TABLE_THREADS)
deflate_tables_tuple_clocks(const int32_t* __restrict__ tokens,
                            const int32_t* __restrict__ ntok, int n,
                            uint8_t* __restrict__ comp, int pitch,
                            uint8_t* __restrict__ scratch, long long* cycles) {
  using namespace dfe;
  __shared__ tuple_old::TupleShared sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.x;
  uint8_t* rec = scratch + static_cast<size_t>(row) * SCRATCH_BYTES;
  uint8_t* dst = comp + static_cast<size_t>(row) * pitch;
  uint8_t* llen = sh.lens;
  uint8_t* dlen = sh.lens + 288;
  tables_new::NClocks<STAMP> k;
  k.start();
  const long long t0 = k.t;
  for (int q = tid; q < 320; q += TABLE_THREADS) {
    sh.lens[q] = 0;
    sh.codes[q] = 0;
    if (q < 288) sh.lfreq[q] = 0;
    if (q < 32) sh.dfreq[q] = 0;
  }
  for (int q = tid; q < HDR_WORDS; q += TABLE_THREADS) sh.hdr[q] = 0;
  __syncthreads();
  const int32_t* tok = tokens + static_cast<size_t>(row) * n;
  const int nt = ntok[row];
  for (int t0g = 0; t0g < nt; t0g += TABLE_THREADS * HIST_BATCH) {
    int v[HIST_BATCH];
#pragma unroll
    for (int j = 0; j < HIST_BATCH; ++j) {
      const int t = t0g + j * TABLE_THREADS + tid;
      v[j] = t < nt ? tok[t] : -1;
    }
#pragma unroll
    for (int j = 0; j < HIST_BATCH; ++j) {
      if (v[j] < 0) continue;
      if (v[j] < 256) {
        atomicAdd(&sh.lfreq[v[j]], 1u);
      } else {
        atomicAdd(&sh.lfreq[257 + len_code(v[j] >> 16)], 1u);
        atomicAdd(&sh.dfreq[dist_code(v[j] & 0xFFFF)], 1u);
      }
    }
  }
  __syncthreads();
  if (tid == 0) sh.lfreq[256] = 1;
  __syncthreads();
  k.lap(0, sh.lfreq[0]);
  if (warp == 0)
    tuple_old::tuple_merge<286, LIT_LV, 15 * 286, 15>(sh.lfreq, llen, sh.lit,
                                                      lane, k);
  else
    tuple_old::tuple_merge<30, DIST_LV, 15 * 30, 15>(sh.dfreq, dlen, sh.dist,
                                                     lane, k);
  __syncthreads();
  k.lap(6, sh.lens[lane]);
  if (warp == 0) {
    one_code(llen, 286, lane);
    if (!__any_sync(FULL, lane < 30 && dlen[lane]) && lane == 0) dlen[0] = 1;
  }
  __syncthreads();
  k.lap(7, sh.lens[lane]);
  if (warp == 1) {
    canon_codes(llen, 286, sh.codes, sh.cnt[1], sh.next[1], lane);
    canon_codes(dlen, 30, sh.codes + 288, sh.cnt[1], sh.next[1], lane);
  } else {
    const int hbits = tuple_old::dynamic_header(sh, dst, lane);
    if (lane == 0) *reinterpret_cast<int32_t*>(rec + REC_HBITS) = hbits;
  }
  k.lap(8, sh.codes[lane]);
  __syncthreads();
  uint16_t* codes = reinterpret_cast<uint16_t*>(rec + REC_CODES);
  for (int q = tid; q < 320; q += TABLE_THREADS) {
    codes[q] = sh.codes[q];
    rec[REC_LENS + q] = sh.lens[q];
  }
  __syncthreads();
  k.lap(9, codes[lane]);
  const long long t1 = stamp(static_cast<uint32_t>(rec[REC_LENS]));
  if (lane == 0 && row == 0) {
    long long* c = cycles + 16 * warp;
    for (int p = 0; p < tables_new::PARTS; ++p) c[p] = k.sum[p];
    c[tables_new::PARTS] = t1 - t0;
    for (int q = 0; q < tables_new::NCOUNT; ++q)
      c[tables_new::PARTS + 1 + q] = k.cnt[q];
  }
}

}  // namespace

extern "C" int tpz_ari_encode_clocks(const void* row, int len, void* out,
                                     int cap, void* drow, void* slen,
                                     void* cycles, int inc, int thr,
                                     int stamped) {
  auto* r = static_cast<const uint8_t*>(row);
  auto* o = static_cast<uint8_t*>(out);
  auto* d = static_cast<int32_t*>(drow);
  auto* s = static_cast<int32_t*>(slen);
  auto* c = static_cast<long long*>(cycles);
  if (stamped == 3)
    ari_encode_warps<true><<<1, 128>>>(r, len, o, cap, d, s, c, inc, thr);
  else if (stamped == 2)
    ari_encode_warps<false><<<1, 128>>>(r, len, o, cap, d, s, c, inc, thr);
  else if (stamped)
    ari_encode_clocks<true><<<1, 32>>>(r, len, o, cap, d, s, c, inc, thr);
  else
    ari_encode_clocks<false><<<1, 32>>>(r, len, o, cap, d, s, c, inc, thr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpz_apm_decode_clocks(const void* row, const void* drow,
                                     int cap, int len, void* out,
                                     void* cycles, int bits, int rate,
                                     int stamped) {
  auto* r = static_cast<const uint8_t*>(row);
  auto* d = static_cast<const int32_t*>(drow);
  auto* o = static_cast<uint8_t*>(out);
  auto* c = static_cast<long long*>(cycles);
  if (stamped)
    apm_decode_clocks<true><<<1, 1>>>(r, d, cap, len, o, c, bits, rate);
  else
    apm_decode_clocks<false><<<1, 1>>>(r, d, cap, len, o, c, bits, rate);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpz_apm_encode_clocks(const void* row, int len, void* out,
                                     int cap, void* drow, void* slen,
                                     void* cycles, int bits, int rate,
                                     int stamped) {
  auto* r = static_cast<const uint8_t*>(row);
  auto* o = static_cast<uint8_t*>(out);
  auto* d = static_cast<int32_t*>(drow);
  auto* s = static_cast<int32_t*>(slen);
  auto* c = static_cast<long long*>(cycles);
  if (stamped)
    apm_encode_clocks<true><<<1, 1>>>(r, len, o, cap, d, s, c, bits, rate);
  else
    apm_encode_clocks<false><<<1, 1>>>(r, len, o, cap, d, s, c, bits, rate);
  return static_cast<int>(cudaGetLastError());
}

// One DC stream: which = 3 the earlier walk stamped, 2 unstamped; 1 the
// redesign stamped, 0 unstamped.  cycles holds 9 int64.
extern "C" int tpz_dc_walk_clocks(const void* vals, const void* first,
                                  int length, int T, void* starts,
                                  void* run_lens, void* syms, void* err,
                                  void* cycles, int which) {
  auto* v = static_cast<const int32_t*>(vals);
  auto* f = static_cast<const int32_t*>(first);
  auto* s = static_cast<int32_t*>(starts);
  auto* l = static_cast<int32_t*>(run_lens);
  auto* y = static_cast<int32_t*>(syms);
  auto* e = static_cast<int32_t*>(err);
  auto* c = static_cast<long long*>(cycles);
  if (which == 3)
    dc_walk_clocks<true><<<1, 32>>>(v, f, length, T, s, l, y, e, c);
  else if (which == 2)
    dc_walk_clocks<false><<<1, 32>>>(v, f, length, T, s, l, y, e, c);
  else if (which == 1)
    dc_keyed_clocks<true><<<1, 32>>>(v, f, length, T, s, l, y, e, c);
  else
    dc_keyed_clocks<false><<<1, 32>>>(v, f, length, T, s, l, y, e, c);
  return static_cast<int>(cudaGetLastError());
}

// B lz4 rows of the earlier encoder, one warp and one table (2^hash_log
// int32 of `tables`) a row; block 0's cycles into cycles (10 int64).
extern "C" int tpz_lz4_encode_clocks(const void* blocks, const void* lengths,
                                     int B, int n, void* comp, int cap,
                                     void* clens, void* tables, int hash_log,
                                     void* cycles, int stamped) {
  auto* x = static_cast<const uint8_t*>(blocks);
  auto* l = static_cast<const int32_t*>(lengths);
  auto* c = static_cast<uint8_t*>(comp);
  auto* cl = static_cast<int32_t*>(clens);
  auto* t = static_cast<int32_t*>(tables);
  auto* cy = static_cast<long long*>(cycles);
  if (stamped)
    lz4_encode_clocks<true><<<B, 32>>>(x, l, n, c, cap, cl, t, hash_log, cy);
  else
    lz4_encode_clocks<false><<<B, 32>>>(x, l, n, c, cap, cl, t, hash_log,
                                         cy);
  return static_cast<int>(cudaGetLastError());
}

// B lz4 rows of the redesigned step, one warp a row: which = 3 the table in
// shared memory stamped, 2 unstamped (the rows 16-byte aligned, n a
// multiple of 16, hash_log <= 16); 1 the table in device memory (2^hash_log
// int32 of `tables` a row) stamped, 0 unstamped.  Block 0's cycles into
// cycles (10 int64).
extern "C" int tpz_lz4_step_clocks(const void* blocks, const void* lengths,
                                   int B, int n, void* comp, int cap,
                                   void* clens, void* tables, int hash_log,
                                   int first_width, void* cycles,
                                   int which) {
  auto* x = static_cast<const uint8_t*>(blocks);
  auto* l = static_cast<const int32_t*>(lengths);
  auto* c = static_cast<uint8_t*>(comp);
  auto* cl = static_cast<int32_t*>(clens);
  auto* t = static_cast<int32_t*>(tables);
  auto* cy = static_cast<long long*>(cycles);
  const int smem = (2 << hash_log) + n;
  if (which >= 2) {
    auto kern = which == 3 ? lz4_step_clocks<true, true>
                           : lz4_step_clocks<true, false>;
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<B, 32, smem>>>(x, l, n, c, cap, cl, t, hash_log, first_width,
                          cy);
  } else {
    auto kern = which == 1 ? lz4_step_clocks<false, true>
                           : lz4_step_clocks<false, false>;
    kern<<<B, 32>>>(x, l, n, c, cap, cl, t, hash_log, first_width, cy);
  }
  return static_cast<int>(cudaGetLastError());
}

// B rows of the earlier lz4 decoder (decode = 1) or rle decoder (0), each
// as its kernel was launched; block 0's cycles into cycles (10 int64).
extern "C" int tpz_decode_clocks(const void* comp, const void* clens, int B,
                                 int w, void* out, int out_cap, void* status,
                                 void* cycles, int lz4, int stamped) {
  auto* x = static_cast<const uint8_t*>(comp);
  auto* l = static_cast<const int32_t*>(clens);
  auto* o = static_cast<uint8_t*>(out);
  auto* st = static_cast<int64_t*>(status);
  auto* cy = static_cast<long long*>(cycles);
  if (lz4 && stamped)
    lz4_decode_clocks<true><<<B, 32>>>(x, l, w, o, out_cap, st, cy);
  else if (lz4)
    lz4_decode_clocks<false><<<B, 32>>>(x, l, w, o, out_cap, st, cy);
  else if (stamped)
    rle_decode_clocks<true><<<B, 1>>>(x, l, w, o, out_cap, st, cy);
  else
    rle_decode_clocks<false><<<B, 1>>>(x, l, w, o, out_cap, st, cy);
  return static_cast<int>(cudaGetLastError());
}

// B rows of the redesigned lz4 decoder; block 0's cycles into cycles (12
// int64).
extern "C" int tpz_lz4_decode_new_clocks(const void* comp, const void* clens,
                                         int B, int w, void* out,
                                         int out_cap, void* status,
                                         void* cycles, int stamped) {
  auto* x = static_cast<const uint8_t*>(comp);
  auto* l = static_cast<const int32_t*>(clens);
  auto* o = static_cast<uint8_t*>(out);
  auto* st = static_cast<int64_t*>(status);
  auto* cy = static_cast<long long*>(cycles);
  auto kern = stamped ? lz4_decode_new_clocks<true>
                      : lz4_decode_new_clocks<false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<B, 32>>>(x, l, w, o, out_cap, st, cy);
  return static_cast<int>(cudaGetLastError());
}

// B rows of the chained lz4 parse as it stood before its redesign, over
// prev from csrc/lz4_chain.cu's links; block 0's cycles into cycles (14
// int64).
extern "C" int tpz_chain_parse_clocks(const void* blocks, const void* lengths,
                                      const void* prev, int B, int n,
                                      int max_chain, void* comp, int cap,
                                      void* clens, void* cycles,
                                      int stamped) {
  auto kern = stamped ? chain_parse_clocks<true> : chain_parse_clocks<false>;
  kern<<<B, 32>>>(static_cast<const uint8_t*>(blocks),
                  static_cast<const int32_t*>(lengths),
                  static_cast<const int32_t*>(prev), n, max_chain,
                  static_cast<uint8_t*>(comp), cap,
                  static_cast<int32_t*>(clens),
                  static_cast<long long*>(cycles));
  return static_cast<int>(cudaGetLastError());
}

// B rows of the dense candidates step as it stood before its redesign:
// keyed, 2^slots_log slots of 8 bytes of `tables` a row, or direct, 2^bits
// int32 a row (bits >= 2); block 0's cycles into cycles (10 int64).
extern "C" int tpz_dense_candidates_clocks(const void* blocks,
                                           const void* lengths, int B, int n,
                                           void* cand, void* tables,
                                           int bits, int slots_log,
                                           int keyed, void* cycles,
                                           int stamped) {
  auto kern = keyed ? (stamped ? dense_candidates_clocks<true, true>
                               : dense_candidates_clocks<true, false>)
                    : (stamped ? dense_candidates_clocks<false, true>
                               : dense_candidates_clocks<false, false>);
  kern<<<B, 32>>>(static_cast<const uint8_t*>(blocks),
                  static_cast<const int32_t*>(lengths), n,
                  static_cast<int32_t*>(cand),
                  static_cast<unsigned long long*>(tables), bits, slots_log,
                  static_cast<long long*>(cycles));
  return static_cast<int>(cudaGetLastError());
}

// B rows of the deflate decoder as it stood before its redesign; block 0's
// cycles into cycles (11 int64).
extern "C" int tpz_inflate_clocks(const void* streams, const void* lens,
                                  int B, int w, void* out, int cap,
                                  void* status, void* cycles, int stamped) {
  auto kern = stamped ? inflate_clocks<true> : inflate_clocks<false>;
  kern<<<B, 32>>>(static_cast<const uint8_t*>(streams),
                  static_cast<const int32_t*>(lens), w,
                  static_cast<uint8_t*>(out), cap,
                  static_cast<long long*>(status),
                  static_cast<long long*>(cycles));
  return static_cast<int>(cudaGetLastError());
}

// B rows of lz4p's pack as it stood before its redesign; block 0's cycles
// into cycles (10 int64).
extern "C" int tpz_pack_clocks(const void* comp, const void* clens, int B,
                               int w, void* out, int cap, void* olens,
                               int split, void* cycles, int stamped) {
  auto kern = stamped ? pack_clocks<true> : pack_clocks<false>;
  kern<<<B, 32>>>(static_cast<const uint8_t*>(comp),
                  static_cast<const int32_t*>(clens), w,
                  static_cast<uint8_t*>(out), cap,
                  static_cast<int32_t*>(olens), split != 0,
                  static_cast<long long*>(cycles));
  return static_cast<int>(cudaGetLastError());
}

// B rows of the redesigned deflate decoder; block 0's cycles into cycles
// (12 int64).
extern "C" int tpz_inflate_new_clocks(const void* streams, const void* lens,
                                      int B, int w, void* out, int cap,
                                      void* status, void* cycles,
                                      int stamped) {
  auto kern = stamped ? inflate_new_clocks<true> : inflate_new_clocks<false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<B, 32>>>(static_cast<const uint8_t*>(streams),
                  static_cast<const int32_t*>(lens), w,
                  static_cast<uint8_t*>(out), cap,
                  static_cast<long long*>(status),
                  static_cast<long long*>(cycles));
  return static_cast<int>(cudaGetLastError());
}

// B rows of lz4p's decode as it stood before its redesign; block 0's cycles
// into cycles (11 int64).
extern "C" int tpz_lz4p_decode_clocks(const void* comp, const void* clens,
                                      int B, int w, void* out, int out_cap,
                                      void* status, void* cycles,
                                      int stamped) {
  auto kern = stamped ? lz4p_decode_clocks<true> : lz4p_decode_clocks<false>;
  kern<<<B, 32>>>(static_cast<const uint8_t*>(comp),
                  static_cast<const int32_t*>(clens), w,
                  static_cast<uint8_t*>(out), out_cap,
                  static_cast<int64_t*>(status),
                  static_cast<long long*>(cycles));
  return static_cast<int>(cudaGetLastError());
}

// B rows of the deflate links as they stood before their redesign, ntab
// keyed tables of 2^slots_log slots of 8 bytes; block 0's row 0 cycles
// into cycles (10 int64).
extern "C" int tpz_deflate_links_clocks(const void* blocks,
                                        const void* lengths, int B, int n,
                                        void* prev, void* tables, int ntab,
                                        int slots_log, void* cycles,
                                        int stamped) {
  auto kern =
      stamped ? deflate_links_clocks<true> : deflate_links_clocks<false>;
  kern<<<ntab, 32>>>(static_cast<const uint8_t*>(blocks),
                     static_cast<const int32_t*>(lengths), B, n,
                     static_cast<int32_t*>(prev),
                     static_cast<unsigned long long*>(tables), slots_log,
                     static_cast<long long*>(cycles));
  return static_cast<int>(cudaGetLastError());
}

// B rows of the deflate device rule's greedy parse as it stood before its
// redesign, over best_at; tokens (zeroed by the caller) and ntok out;
// block 0's cycles into cycles (11 int64).
extern "C" int tpz_deflate_greedy_clocks(const void* blocks,
                                         const void* lengths,
                                         const void* best_at, int B, int n,
                                         void* tokens, void* ntok,
                                         void* cycles, int stamped) {
  auto kern =
      stamped ? deflate_greedy_clocks<true> : deflate_greedy_clocks<false>;
  kern<<<B, 32>>>(static_cast<const uint8_t*>(blocks),
                  static_cast<const int32_t*>(lengths),
                  static_cast<const int32_t*>(best_at), n,
                  static_cast<int32_t*>(tokens), static_cast<int32_t*>(ntok),
                  static_cast<long long*>(cycles));
  return static_cast<int>(cudaGetLastError());
}

// csrc/deflate_encode.cu's greedy parse after its best kernel (the
// segments' maps, chain and emit over best_at) on the default stream;
// scratch of tpz_deflate_parse_scratch bytes.
extern "C" int tpz_deflate_segments_source(const void* blocks,
                                           const void* lengths,
                                           const void* best_at, int B, int n,
                                           void* tokens, void* ntok,
                                           void* scratch) {
  return dfe::launch_segments(blocks, lengths, best_at, B, n, tokens, ntok,
                              scratch, 0);
}

// csrc/deflate_encode.cu's tpz_deflate_parse_scratch (the source's entry
// points lie in an unnamed namespace here).
extern "C" long long tpz_deflate_parse_scratch_source(int B, int n) {
  return dfe::tpz_deflate_parse_scratch(B, n);
}

// csrc/deflate_encode.cu's best kernel alone (best_at of every position at
// max_chain, the greedy parse's input).
extern "C" int tpz_deflate_best_source(const void* blocks,
                                       const void* lengths, const void* prev,
                                       int B, int n, int max_chain,
                                       void* best_at) {
  const long long grid = static_cast<long long>(B) *
                         ((n + dfe::BEST_THREADS - 1) / dfe::BEST_THREADS);
  dfe::deflate_best_kernel<<<static_cast<unsigned>(grid),
                             dfe::BEST_THREADS>>>(
      static_cast<const uint8_t*>(blocks),
      static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(prev), n, max_chain,
      static_cast<int32_t*>(best_at));
  return static_cast<int>(cudaGetLastError());
}

// B rows of the redesigned lz4p decode; block 0's cycles into cycles (13
// int64).
extern "C" int tpz_lz4p_decode_new_clocks(const void* comp, const void* clens,
                                          int B, int w, void* out,
                                          int out_cap, void* status,
                                          void* cycles, int stamped) {
  auto kern = stamped ? lz4p_decode_new_clocks<true>
                      : lz4p_decode_new_clocks<false>;
  kern<<<B, 32>>>(static_cast<const uint8_t*>(comp),
                  static_cast<const int32_t*>(clens), w,
                  static_cast<uint8_t*>(out), out_cap,
                  static_cast<int64_t*>(status),
                  static_cast<long long*>(cycles));
  return static_cast<int>(cudaGetLastError());
}

// B rows of the deflate tables as they stood before their redesign (mode
// 0 or 1): their records into scratch (the source's layout,
// dfe::SCRATCH_BYTES a row), their levels' orders into levels
// (tables_old::LEVEL_BYTES a row), and with emit the source's emit kernel
// on those records into comp (zeroed) and clens; block 0's row 0 cycles
// into cycles (20 int64).
extern "C" int tpz_deflate_tables_clocks(const void* tokens, const void* ntok,
                                         int B, int n, int mode, void* comp,
                                         int pitch, void* clens,
                                         void* scratch, void* levels,
                                         void* cycles, int stamped,
                                         int emit) {
  auto kern = stamped ? deflate_tables_clocks<true>
                      : deflate_tables_clocks<false>;
  kern<<<(B + tables_old::TABLE_WARPS - 1) / tables_old::TABLE_WARPS,
         32 * tables_old::TABLE_WARPS>>>(
      static_cast<const int32_t*>(tokens), static_cast<const int32_t*>(ntok),
      B, n, mode, static_cast<uint8_t*>(comp), pitch,
      static_cast<uint8_t*>(scratch), static_cast<uint8_t*>(levels),
      static_cast<long long*>(cycles));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !emit) return static_cast<int>(err);
  dfe::deflate_emit_kernel<false><<<B, dfe::EMIT_THREADS>>>(
      static_cast<const int32_t*>(tokens), static_cast<const int32_t*>(ntok),
      n, static_cast<uint8_t*>(comp), pitch, 2 * n + 4096,
      static_cast<int32_t*>(clens), static_cast<const uint8_t*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

// csrc/deflate_encode.cu's own tables and emit (its tpz_deflate_emit) with
// a scratch of the caller's, so that the records can be read.
extern "C" int tpz_deflate_emit_source(const void* blocks, const void* lengths,
                                       const void* tokens, const void* ntok,
                                       int B, int n, int mode, void* comp,
                                       int pitch, void* clens, void* scratch,
                                       void* stream) {
  return dfe::tpz_deflate_emit(blocks, lengths, tokens, ntok, B, n, mode,
                               comp, pitch, clens, scratch, stream);
}

// The source's scratch layout: a row's bytes, its record's first byte and
// the record's end (the header's bit count its last 4 bytes).
extern "C" void tpz_deflate_record_layout(int* out) {
  out[0] = dfe::SCRATCH_BYTES;
  out[1] = dfe::REC_CODES;
  out[2] = dfe::REC_HBITS + 4;
}

// B rows of the redesigned deflate tables (dynamic blocks) stamped by
// part: their records into scratch, then with emit the source's emit
// kernel on them into comp (zeroed) and clens; block 0's row 0 cycles into
// cycles (32 int64: warp 0's 16, then warp 1's).
extern "C" int tpz_deflate_tables_new_clocks(const void* tokens,
                                             const void* ntok, int B, int n,
                                             void* comp, int pitch,
                                             void* clens, void* scratch,
                                             void* cycles, int stamped,
                                             int emit) {
  auto kern = stamped ? deflate_tables_new_clocks<true>
                      : deflate_tables_new_clocks<false>;
  kern<<<B, dfe::TABLE_THREADS>>>(
      static_cast<const int32_t*>(tokens), static_cast<const int32_t*>(ntok),
      n, static_cast<uint8_t*>(comp), pitch, static_cast<uint8_t*>(scratch),
      static_cast<long long*>(cycles));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !emit) return static_cast<int>(err);
  dfe::deflate_emit_kernel<false><<<B, dfe::EMIT_THREADS>>>(
      static_cast<const int32_t*>(tokens), static_cast<const int32_t*>(ntok),
      n, static_cast<uint8_t*>(comp), pitch, 2 * n + 4096,
      static_cast<int32_t*>(clens), static_cast<const uint8_t*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

// B rows of the device rule's tables as they stood before their redesign
// (tuple_old), stamped by part: their records into scratch, then with emit
// the source's row emit kernel on them into comp (zeroed) and clens; block
// 0's row 0 cycles into cycles (32 int64: warp 0's 16, then warp 1's).
extern "C" int tpz_deflate_tables_tuple_clocks(const void* tokens,
                                               const void* ntok, int B, int n,
                                               void* comp, int pitch,
                                               void* clens, void* scratch,
                                               void* cycles, int stamped,
                                               int emit) {
  auto kern = stamped ? deflate_tables_tuple_clocks<true>
                      : deflate_tables_tuple_clocks<false>;
  kern<<<B, dfe::TABLE_THREADS>>>(
      static_cast<const int32_t*>(tokens), static_cast<const int32_t*>(ntok),
      n, static_cast<uint8_t*>(comp), pitch, static_cast<uint8_t*>(scratch),
      static_cast<long long*>(cycles));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !emit) return static_cast<int>(err);
  dfe::deflate_emit_kernel<false><<<B, dfe::EMIT_THREADS>>>(
      static_cast<const int32_t*>(tokens), static_cast<const int32_t*>(ntok),
      n, static_cast<uint8_t*>(comp), pitch, 2 * n + 4096,
      static_cast<int32_t*>(clens), static_cast<const uint8_t*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

// csrc/deflate_encode.cu's own tuple tables and emit (its
// tpz_deflate_emit_tuple) with a scratch of the caller's.
extern "C" int tpz_deflate_emit_tuple_source(const void* tokens,
                                             const void* ntok, int B, int n,
                                             void* comp, int pitch,
                                             void* clens, void* scratch,
                                             void* stream) {
  return dfe::tpz_deflate_emit_tuple(tokens, ntok, B, n, comp, pitch, clens,
                                     scratch, stream);
}

// CTAs an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and static
// shared bytes of csrc/deflate_encode.cu's tables and emit kernels, and of
// the device rule's tables before their redesign (tuple_old), in the
// order tpz_deflate_tables_kernels names them (8 pairs).
constexpr int TABLE_KERNELS = 8;

extern "C" const char* tpz_deflate_tables_kernels() {
  return "tables<TableShared>,tables<Counted<TableShared>>,"
         "tables<Counted<TupleShared>>,tables before the redesign (tuple),"
         "row emit,tiled histograms,tiles' bits,tiles' fields";
}

extern "C" int tpz_deflate_tables_occupancy(int* out) {
  const void* kerns[TABLE_KERNELS] = {
      reinterpret_cast<const void*>(
          dfe::deflate_tables_kernel<dfe::TableShared>),
      reinterpret_cast<const void*>(
          dfe::deflate_tables_kernel<dfe::Counted<dfe::TableShared>>),
      reinterpret_cast<const void*>(
          dfe::deflate_tables_kernel<dfe::Counted<dfe::TupleShared>>),
      reinterpret_cast<const void*>(deflate_tables_tuple_clocks<false>),
      reinterpret_cast<const void*>(dfe::deflate_emit_kernel<false>),
      reinterpret_cast<const void*>(dfe::deflate_hist_kernel),
      reinterpret_cast<const void*>(dfe::deflate_emit_sums_kernel),
      reinterpret_cast<const void*>(dfe::deflate_emit_tiles_kernel)};
  const int threads[TABLE_KERNELS] = {
      dfe::TABLE_THREADS, dfe::TABLE_THREADS, dfe::TABLE_THREADS,
      dfe::TABLE_THREADS, dfe::EMIT_THREADS,  dfe::TILE_THREADS,
      dfe::TILE_THREADS,  dfe::TILE_THREADS};
  for (int i = 0; i < TABLE_KERNELS; ++i) {
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out + 2 * i, kerns[i], threads[i], 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kerns[i]);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[2 * i + 1] = static_cast<int>(attr.sharedSizeBytes);
  }
  return 0;
}
