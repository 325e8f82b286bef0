// dc_decode.cu — the DC (distance coding) run walk, one warp per stream.
//
// Replaces tpuzip/kernels/dc_scan.py:37 `_dc_decode_kernel` (its
// pallas_call is in `dc_decode_lanes`, :106; caller
// tpuzip/codecs/dc.py `decode_batch_kernel`).  Same function: from the
// pre-parsed varint distances, the per-symbol first occurrences and the
// length of each stream, the run triples (start, length, symbol) of every
// step and an error flag per stream; the scheduler rule and the int32
// arithmetic (two's-complement wrap, INF = 0x7FFFFFFF) are the TPU
// kernel's, so corrupt streams give the same bits too.
//
// What bounds it on this card: a stream is a serial chain — a run's end is
// the minimum of the scheduler that the previous run left — so it runs at
// the latency of a compare, two warp reductions and a select a run, not at
// a byte rate.
//
// What the design does about it: the 256-entry scheduler never leaves
// registers (lane l holds sched[8l .. 8l+7]); a step is 8 compares a lane,
// one vote, and one min- and one add-reduction across the warp (the sum of
// the hit symbols is the TPU kernel's symbol, one symbol in a well-formed
// stream).  The TPU's one-hot passes over 256 rows are gone.  Distances
// are loaded 32 steps at a time (one coalesced load, then shuffles), and
// the triples of those 32 steps are stored together; once the walk has
// reached its length the remaining steps only store zeros.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int INF = 0x7fffffff;
constexpr int WARPS_PER_BLOCK = 2;

__global__ void __launch_bounds__(32 * WARPS_PER_BLOCK)
dc_decode_kernel(const int32_t* __restrict__ vals,
                 const int32_t* __restrict__ first,
                 const int32_t* __restrict__ lengths, int B, int T,
                 int32_t* __restrict__ starts, int32_t* __restrict__ run_lens,
                 int32_t* __restrict__ syms, int32_t* __restrict__ err_out) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp leaves together
  const size_t row = static_cast<size_t>(b) * T;
  const int length = lengths[b];

  int sched[8];  // sched[8 * lane + k]
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int f = first[static_cast<size_t>(b) * 256 + 8 * lane + k];
    sched[k] = f < length ? f : INF;
  }
  int pos = 0;
  bool err = false;

  for (int t0 = 0; t0 < T; t0 += 32) {
    const int t = t0 + lane;
    const int v = t < T ? vals[row + t] : 0;
    int o_start = 0, o_len = 0, o_sym = 0;  // this lane's step t0 + lane
    const int steps = min(32, T - t0);
    for (int j = 0; j < steps && pos < length; ++j) {  // warp-uniform
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
      const bool any = __any_sync(FULL, hit != 0);
      const int nxt = min(__reduce_min_sync(FULL, low_min), length);
      const int target = static_cast<int>(static_cast<unsigned>(nxt) - 1u +
                                          static_cast<unsigned>(d));
      const bool bad = !any || (d > 0 && (target >= length || target < nxt));
      const int sym = __reduce_add_sync(FULL, hit_sum);
      const int put = (d > 0 && !bad) ? target : INF;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (hit & (1u << k)) sched[k] = put;
      if (lane == j) {
        o_start = pos;
        o_len = static_cast<int>(static_cast<unsigned>(nxt) -
                                 static_cast<unsigned>(pos));
        o_sym = sym;
      }
      pos = nxt;
      err |= bad;
    }
    if (t < T) {
      starts[row + t] = o_start;
      run_lens[row + t] = o_len;
      syms[row + t] = o_sym;
    }
  }
  // an unfinished walk (steps exhausted before the length) is an error
  if (lane == 0) err_out[b] = (err || pos < length) ? 1 : 0;
}

}  // namespace

// vals (B, T), first (B, 256) and lengths (B,) i32 in; starts, run_lens,
// syms (B, T) i32 and err (B,) i32 out, every element written.  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int tpz_dc_decode(const void* vals, const void* first,
                             const void* lengths, int B, int T, void* starts,
                             void* run_lens, void* syms, void* err,
                             void* stream) {
  const int grid = (B + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  dc_decode_kernel<<<grid, 32 * WARPS_PER_BLOCK, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(vals), static_cast<const int32_t*>(first),
      static_cast<const int32_t*>(lengths), B, T,
      static_cast<int32_t*>(starts), static_cast<int32_t*>(run_lens),
      static_cast<int32_t*>(syms), static_cast<int32_t*>(err));
  return static_cast<int>(cudaGetLastError());
}
