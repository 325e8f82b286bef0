// ari_encode.cu — adaptive order-0 range ENCODER, two warps per stream.
//
// Replaces tpuzip/kernels/range_coder.py:128 `_ari_encode_kernel` (its
// pallas_call is in `ari_encode_lanes`, :244) together with the stream
// compaction and the 4 finish bytes of `_encode_lanes_packed_core`
// (:339-380).  Bit-exact tpuzip.oracle.ari streams, and the same chunk
// index (bytes emitted per 64 symbols) as
// `ari_encode_lanes_packed_indexed`.
//
// What bounds it on this card: not bytes (it runs 2-4 orders of magnitude
// above its byte bound) but one serial chain a stream: each symbol's coder
// state (low, rng) waits on the last one's.  A warp issues in order, so a
// step costs its dependent latencies plus whatever else the warp issues
// between them; at 1024 streams the SMs' issue slots are shared as well.
// The earlier one-warp step, stamped with clock64 (tools/step_clocks.py;
// NVIDIA H100 80GB HBM3, 700 W): 563 cycles, of which the model (symbol
// shuffle, table reads, update) 257, the division 133, the
// renormalisation 80.
//
// What the design does about it.  The model (the cumulative table) never
// depends on the coder, only on the symbols, so it leaves the coder's
// warp:
//   - warp specialisation: warp 0 of a block runs the model a chunk (64
//     steps) ahead into a two-slot ring in shared memory, a step's (lo,
//     hi - lo, -tot, inv) in 16 bytes; warp 2 runs the coder on it (warps
//     1 and 3 leave at once: 1.01-1.04x faster than a 2-warp block, so the
//     two warps likely sit on different SM sub-partitions).  Named
//     barriers mark a slot full (1, 2) and empty (3, 4), so a step costs
//     the longer of the two warps' steps, not their sum;
//   - the model runs the lanes side by side: between two halvings the
//     total grows by inc a step, so those steps are known ahead; step t's
//     entries are the table at the run's start plus inc times the count of
//     the run's earlier symbols below (a lane counts for its 2 steps), and
//     the table after the run is that table plus inc times the run's
//     histogram, summed; a halving step runs alone;
//   - the coder takes r = rng / tot exactly as umulhi(rng, inv) plus one
//     correction (inv = floor((2^32-1)/tot) gives r or r - 1 for every u32
//     rng and tot in [1, 2^16]; tests/test_torch_step_identities.py checks
//     it), adds the correction to the products after them, tests in one
//     branch whether a step pulls any byte, and runs unrolled by 2;
//   - the chunk index is written once a chunk, not tested every step;
//   - one block a stream, the stream index from blockIdx.x alone.
// Measured in turns against the earlier form (chip_smoke.py --ab; NVIDIA
// H100 80GB HBM3, 700 W; PERF.md, section 6): the model alone takes 22 ns
// a step at 64 streams, so the coder's chain sets the step (58-85 ns at
// 64 and 128 streams, 168 at 1024).  Measured and left out, each slower: the
// model and the coder in one warp, one pass after the other (1.44x faster
// than this form at 1024 streams, 1.22-1.48x slower at 64 and 128); the
// roles of the two warps picked by their SM slots; the renormalisation
// test as a warp vote; the equal leading bytes shifted out at once by a
// count of leading zeros; the coder loop rolled.  The table stays in
// registers, eight u32 a lane; a warp knows its write position, so the
// TPU's fixed 4-byte emission slots and the sort that compacted them are
// gone.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "ari_model.cuh"

namespace {

using namespace ari;

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 64;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 64;" ::"r"(id) : "memory");
}

// A step's plan entry: lo, hi - lo, -tot and floor((2^32-1)/tot).
__device__ __forceinline__ uint4 entry(uint32_t lo, uint32_t hi,
                                       uint32_t tot) {
  return make_uint4(lo, hi - lo, 0u - tot, 0xffffffffu / tot);
}

// C[s] for a warp-uniform s in [0, 256): the lane's entry picked by a
// 3-level tree of selects, then shuffled from the owner lane.
__device__ __forceinline__ uint32_t table_at(const uint32_t (&c)[8], int s) {
  const uint32_t a0 = (s & 1) ? c[1] : c[0], a1 = (s & 1) ? c[3] : c[2];
  const uint32_t a2 = (s & 1) ? c[5] : c[4], a3 = (s & 1) ? c[7] : c[6];
  const uint32_t b0 = (s & 2) ? a1 : a0, b1 = (s & 2) ? a3 : a2;
  return __shfl_sync(FULL, (s & 4) ? b1 : b0, s >> 3);
}

// Symbol j of a chunk (lane l holds symbols 2l and 2l+1 in `pair`).
__device__ __forceinline__ int symbol(uint32_t pair, int j) {
  return __byte_perm(__shfl_sync(FULL, pair, j >> 1), 0, 0x4440 | (j & 1));
}

// The step whose update reaches the threshold, alone: its plan entry,
// then the update and the halving.  Returns the new total.
__device__ __forceinline__ uint32_t halving_step(uint32_t (&c)[8], int lane,
                                                 uint32_t pair, int j,
                                                 uint32_t tot, uint32_t inc,
                                                 uint4* plan) {
  const int sym = symbol(pair, j);
  const uint32_t hi = table_at(c, sym);
  const uint32_t below = table_at(c, max(sym - 1, 0));
  if (lane == (j & 31)) plan[j] = entry(sym > 0 ? below : 0u, hi, tot);
  add(c, lane, sym, inc);
  return halve(c, lane);
}

// Steps [j0, j1) of a chunk, none of whose updates halves, all lanes at
// once (see the head note).  tab and hist: 256 u32 of scratch.
__device__ __forceinline__ void model_run(uint32_t (&c)[8], uint32_t& tot,
                                          uint32_t pair, int lane, int j0,
                                          int j1, uint32_t inc, uint4* plan,
                                          uint32_t* tab, uint32_t* hist) {
  uint4* tab4 = reinterpret_cast<uint4*>(tab);
  uint4* hist4 = reinterpret_cast<uint4*>(hist);
  tab4[2 * lane] = make_uint4(c[0], c[1], c[2], c[3]);
  tab4[2 * lane + 1] = make_uint4(c[4], c[5], c[6], c[7]);
  hist4[2 * lane] = make_uint4(0, 0, 0, 0);
  hist4[2 * lane + 1] = make_uint4(0, 0, 0, 0);
  const int mine = 2 * lane;
  const int sym[2] = {static_cast<int>(pair & 0xff),
                      static_cast<int>(pair >> 8)};
  // earlier symbols of the run below / not above each of the lane's two
  uint32_t lt[2] = {0, 0}, le[2] = {0, 0};
  const int end = min(j1, mine);   // the run's steps in the lanes before
#pragma unroll 4
  for (int i = j0; i < min(j1, CHUNK_STEPS - 2); ++i) {
    const int s = symbol(pair, i);
    const bool before = i < end;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      lt[u] += before && s < sym[u];
      le[u] += before && s <= sym[u];
    }
  }
  if (mine >= j0) {   // and the lane's own first step
    lt[1] += sym[0] < sym[1];
    le[1] += sym[0] <= sym[1];
  }
  __syncwarp();
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int t = mine + u;
    if (t >= j0 && t < j1) {
      const uint32_t hi = tab[sym[u]] + inc * le[u];
      const uint32_t lo = sym[u] > 0 ? tab[sym[u] - 1] + inc * lt[u] : 0u;
      plan[t] = entry(lo, hi, tot + inc * static_cast<uint32_t>(t - j0));
      atomicAdd(&hist[sym[u]], 1u);
    }
  }
  __syncwarp();
  // the table after the run: + inc times the histogram, summed
  const uint4 h0 = hist4[2 * lane], h1 = hist4[2 * lane + 1];
  const uint32_t h[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
  uint32_t run = 0, p[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) p[k] = (run += h[k]);
  uint32_t incl = run;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += y;
  }
  const uint32_t excl = incl - run;
#pragma unroll
  for (int k = 0; k < 8; ++k) c[k] += inc * (excl + p[k]);
  tot += inc * static_cast<uint32_t>(j1 - j0);
  __syncwarp();   // tab and hist are rewritten by the next run
}

// The model of a chunk's n steps into plan.
__device__ __forceinline__ void model(uint32_t (&c)[8], uint32_t& tot,
                                      uint32_t pair, int lane, int n,
                                      uint32_t inc, uint32_t threshold,
                                      uint4* plan, uint32_t* tab,
                                      uint32_t* hist) {
  for (int j = 0; j < n;) {
    // steps before the next whose update reaches the threshold
    const int gap = static_cast<int>(threshold - 1 - tot);   // may be < 0
    const int free = inc ? max(0, gap) / static_cast<int>(inc)
                         : (gap >= 0 ? INT_MAX : 0);
    const int run = min(n - j, free);
    if (run > 0)
      model_run(c, tot, pair, lane, j, j + run, inc, plan, tab, hist);
    j += run;
    if (j < n) {
      tot = halving_step(c, lane, pair, j, tot, inc, plan);
      ++j;
    }
  }
}

__global__ void __launch_bounds__(128)
ari_encode_kernel(const uint8_t* __restrict__ blocks,
                  const int32_t* __restrict__ lengths, int N,
                  uint8_t* __restrict__ streams, int cap,
                  int32_t* __restrict__ stream_lens,
                  int32_t* __restrict__ deltas, int nc, uint32_t inc,
                  uint32_t threshold) {
  __shared__ uint4 plan[2][CHUNK_STEPS];
  __shared__ __align__(16) uint32_t tab[256], hist[256];
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x;   // from blockIdx alone: see the head note
  const int len = max(0, min(lengths[b], N));
  const int nchunks = (len + CHUNK_STEPS - 1) / CHUNK_STEPS;
  if (threadIdx.x < 32) {   // warp 0: the model
    const uint8_t* row = blocks + static_cast<size_t>(b) * N;
    // a chunk's symbols, 2 a lane, loaded a chunk ahead
    auto pair_at = [&](int k) -> uint32_t {
      const int i = k * CHUNK_STEPS + 2 * lane;
      return (i < len ? row[i] : 0u) | (i + 1 < len ? row[i + 1] << 8 : 0u);
    };
    uint32_t c[8];
    init(c, lane);
    uint32_t tot = 256, next = pair_at(0);
    for (int k = 0; k < nchunks; ++k) {
      const uint32_t pair = next;
      if (k + 1 < nchunks) next = pair_at(k + 1);
      if (k >= 2) bar_sync(3 + (k & 1));   // the coder is done with it
      model(c, tot, pair, lane, min(CHUNK_STEPS, len - k * CHUNK_STEPS), inc,
            threshold, plan[k & 1], tab, hist);
      bar_arrive(1 + (k & 1));
    }
    return;
  }
  if (threadIdx.x < 64 || threadIdx.x >= 96) return;
  // warp 2: the coder
  uint8_t* out = streams + static_cast<size_t>(b) * cap;
  int32_t* drow = deltas + static_cast<size_t>(b) * nc;
  uint32_t low = 0, rng = 0xffffffffu;
  int pos = 0, chunk_pos = 0;
  for (int k = 0; k < nchunks; ++k) {
    const uint4* ring = plan[k & 1];
    const int n = min(CHUNK_STEPS, len - k * CHUNK_STEPS);
    bar_sync(1 + (k & 1));   // the model has filled it
    uint4 s = ring[0];
#pragma unroll 2   // faster than 1 at all four path shapes
    for (int j = 0; j < n; ++j) {
      const uint4 next = ring[min(j + 1, CHUNK_STEPS - 1)];
      // r = rng / tot: umulhi(rng, inv) is r or r - 1
      const uint32_t q = __umulhi(rng, s.w);
      const bool short_by_one = rng + q * s.z >= 0u - s.z;
      low += q * s.x;
      rng = q * s.y;
      if (short_by_one) {
        low += s.x;
        rng += s.y;
      }
      if ((low ^ (low + rng)) < TOP || rng < BOT) {
        // carryless renormalisation: <= 4 bytes, lane 0 writes them
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if ((low ^ (low + rng)) >= TOP) {
            if (rng >= BOT) break;
            rng = (0u - low) & (BOT - 1);
          }
          if (lane == 0 && pos < cap)
            out[pos] = static_cast<uint8_t>(low >> 24);
          ++pos;
          low <<= 8;
          rng <<= 8;
        }
      }
      s = next;
    }
    if (k + 2 < nchunks) bar_arrive(3 + (k & 1));
    if (lane == 0) drow[k] = pos - chunk_pos;
    chunk_pos = pos;
  }
  for (int k = nchunks + lane; k < nc; k += 32) drow[k] = 0;
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
  ari_encode_kernel<<<B, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(blocks),
      static_cast<const int32_t*>(lengths), N,
      static_cast<uint8_t*>(streams), cap,
      static_cast<int32_t*>(stream_lens), static_cast<int32_t*>(deltas), nc,
      static_cast<uint32_t>(increment), static_cast<uint32_t>(threshold));
  return static_cast<int>(cudaGetLastError());
}
