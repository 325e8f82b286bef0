// dc_decode.cu — the DC (distance coding) run walk, one warp a stream.
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
// the latency of one run's chain, not at a byte rate; the bwtdc path's 64
// streams hold 64 of the 132 SMs, one warp each.  The chain is one warp
// min-reduction and seven dependent integer operations a run.
//
// What the design does about it: one warp a block, the stream index from
// blockIdx.x.  The 256-entry scheduler stays in registers, eight entries a
// lane, and a symbol with no run to come holds `length` (the walk's end,
// which no step before it can hit) in place of INF.  While the length is
// below 2^23 and no entry below -2^23 (every stream of a real block) an
// entry is one int, position << 8 | symbol, and a lane keeps its eight in
// ascending order.  The head, the least entry of the warp, is the run at
// pos with its symbol.  While it is the one entry at pos and no entry is
// below it, as in every well-formed stream, a run is the keyed step: a
// lane's key is its second entry if its first is the head, else its first;
// the least key, one min-reduction, is the next run's head; the head's
// lane drops its first entry and merges the target in (14 min/max, two
// deep).  No add-reduction and no vote: a run's start, symbol, length and
// err come once a group of 32 runs, from the heads the lanes kept.  The
// distances are loaded 32 at a time, one group ahead (one coalesced load,
// then shuffles), and the triples of a group stored together; a walk that
// has ended leaves its state as it is, so no step tests the end.  A group
// that starts off its head, or in which a lane saw another entry at pos
// or below it, is run again from its start by the exact step (every entry
// compared, every hit rescheduled, on the unpacked entries, then sorted
// once): corrupt streams cost a redo, not a test a step.  Streams whose
// positions do not fit the packing take the exact step throughout.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace dc {

constexpr unsigned FULL = 0xffffffffu;
constexpr int GROUP = 32;      // steps loaded, walked and stored together
constexpr int SPAN = 1 << 23;  // packed positions lie in [-SPAN, SPAN)

// This lane's eight scheduler entries (position, symbol) in any order;
// pos and err are warp-uniform.
struct Walk {
  int s[8], y[8];
  int pos;
  bool err;
};

// The same state packed: entry position << 8 | symbol, ascending; ppos is
// pos << 8, head the least entry of the warp (the run at pos and its
// symbol, while the keyed step holds).
struct Packed {
  int p[8];
  int ppos, head;
  bool err;
};

// The triple of the step whose index in the group is this lane's.
struct Out {
  int start, len, sym;
};

// The output rows of one stream.
struct Rows {
  int32_t *starts, *run_lens, *syms;
};

__device__ __forceinline__ void store(const Rows& r, int t, int T,
                                      const Out& o) {
  if (t < T) {
    r.starts[t] = o.start;
    r.run_lens[t] = o.len;
    r.syms[t] = o.sym;
  }
}

__device__ __forceinline__ void init(Walk& w, const int32_t* first,
                                     int length, int lane) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int f = first[8 * lane + k];
    w.s[k] = f < length ? f : length;
    w.y[k] = 8 * lane + k;
  }
  w.pos = 0;
  w.err = false;
}

// x << 8 in two's complement (a left shift of a negative int is not
// defined in C++17).
__device__ __forceinline__ int shl8(int x) {
  return static_cast<int>(static_cast<unsigned>(x) << 8);
}

// The run's end plus d is a valid target (d > 0, no wrap, below length)
// iff nxt < limit(d, length); length >= 1.
__device__ __forceinline__ int limit(int d, int length) {
  return d > 0 ? length - (d - 1) : INT_MIN;
}

// One run of the TPU kernel's step on any state: every entry compared, the
// sum of the hit symbols, every hit rescheduled.  This lane's triple if
// `mine`.
__device__ __forceinline__ void exact_step(Walk& w, Out& o, bool mine, int d,
                                           int length) {
  const bool active = w.pos < length;
  int low = length, hits = 0;
  bool hit = false;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (w.s[k] == w.pos) {
      hits += w.y[k];
      hit = true;
    } else {
      low = min(low, w.s[k]);
    }
  }
  const int nxt = __reduce_min_sync(FULL, low);
  const bool any = __any_sync(FULL, hit);
  const int sym = __reduce_add_sync(FULL, hits);
  const bool ok = nxt < limit(d, length);
  if (!active) return;  // the walk has ended: nothing changes
  const int put = ok ? nxt + (d - 1) : length;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (w.s[k] == w.pos) w.s[k] = put;
  if (mine) {
    o.start = w.pos;
    o.len = static_cast<int>(static_cast<unsigned>(nxt) -
                             static_cast<unsigned>(w.pos));
    o.sym = sym;
  }
  w.err |= !any || (d > 0 && !ok);
  w.pos = nxt;
}

// Ascending order of the eight packed entries (a 19-comparator network).
__device__ __forceinline__ void sort8(int (&p)[8]) {
#define DC_ORDER(i, j)                  \
  {                                     \
    const int lo = min(p[i], p[j]);     \
    p[j] = max(p[i], p[j]);             \
    p[i] = lo;                          \
  }
  DC_ORDER(0, 2) DC_ORDER(1, 3) DC_ORDER(4, 6) DC_ORDER(5, 7)
  DC_ORDER(0, 4) DC_ORDER(1, 5) DC_ORDER(2, 6) DC_ORDER(3, 7)
  DC_ORDER(0, 1) DC_ORDER(2, 3) DC_ORDER(4, 5) DC_ORDER(6, 7)
  DC_ORDER(2, 4) DC_ORDER(3, 5)
  DC_ORDER(1, 4) DC_ORDER(3, 6)
  DC_ORDER(1, 2) DC_ORDER(3, 4) DC_ORDER(5, 6)
#undef DC_ORDER
}

__device__ __forceinline__ void pack(Packed& k, const Walk& w) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
    k.p[i] = shl8(w.s[i]) | w.y[i];
  sort8(k.p);
  k.ppos = shl8(w.pos);
  k.head = __reduce_min_sync(FULL, k.p[0]);
  k.err = w.err;
}

__device__ __forceinline__ void unpack(Walk& w, const Packed& k) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    w.s[i] = k.p[i] >> 8;
    w.y[i] = k.p[i] & 255;
  }
  w.pos = k.ppos >> 8;
  w.err = k.err;
}

// One run, exact while the head is the one entry at pos and no entry is
// below it; `odd` records a step where that did not hold (for a walk that
// goes on).  Then the head's lane is the one hit, its symbol the run's, and
// the least key is the next run's head.  lim8 is limit(d) << 8 (INT_MIN if
// no target can be valid), d8 is (d - 1) << 8, L8 is length << 8.  The
// lane of the step keeps the run's head.  Once the walk has ended every
// entry is length and the step changes no entry.
__device__ __forceinline__ void keyed_step(Packed& k, bool& odd, int& o_h,
                                           bool mine, int lim8, unsigned d8,
                                           int L8) {
  const int head = k.head, phi = head | 255;
  const int p0 = k.p[0], p1 = k.p[1];
  const bool hit = p0 == head;
  const int key = hit ? p1 : p0;
  // another entry at pos or below it: the keyed step does not cover it
  odd |= ((head & ~255) < L8) & (((p0 <= phi) & !hit) | (p1 <= phi));
  const int kept = hit ? (L8 | (p0 & 255)) : p0;  // no valid target, no hit
  const unsigned moved = d8 + static_cast<unsigned>(p0 & 255);
  const int r = __reduce_min_sync(FULL, key);
  const int x = (hit && r < lim8)
                    ? static_cast<int>(static_cast<unsigned>(r & ~255) + moved)
                    : kept;
  // drop p[0] and merge x in: a lane without a hit gets its entries back
  int q[8];
  q[0] = min(p1, x);
#pragma unroll
  for (int i = 1; i < 7; ++i) q[i] = max(k.p[i], min(k.p[i + 1], x));
  q[7] = max(k.p[7], x);
#pragma unroll
  for (int i = 0; i < 8; ++i) k.p[i] = q[i];
  if (mine) o_h = head;
  k.head = r;
}

// The group's `steps` runs from the distances v (lane j holds step j's):
// keyed, then the triples and err from the heads the lanes kept; or, if
// the group starts off its head or a lane saw an entry the keyed step does
// not cover, again from the group's start by the exact step.  Returns
// this lane's triple.
template <bool WHOLE>
__device__ __forceinline__ Out keyed_group(Packed& k, int v, int steps,
                                           int length, int lane) {
  const Packed start = k;
  const int L8 = shl8(length);
  const int lim = limit(v, length);  // this lane's step's
  const int lim8 = lim > -SPAN ? shl8(lim) : INT_MIN;
  const unsigned d8 = (static_cast<unsigned>(v) - 1u) << 8;
  int o_h = L8;
  bool odd = (k.head & ~255) != k.ppos;  // the head is not at pos
  if (WHOLE) {
#pragma unroll
    for (int j = 0; j < GROUP; ++j)
      keyed_step(k, odd, o_h, lane == j, __shfl_sync(FULL, lim8, j),
                 __shfl_sync(FULL, d8, j), L8);
  } else {
    for (int j = 0; j < steps; ++j)
      keyed_step(k, odd, o_h, lane == j, __shfl_sync(FULL, lim8, j),
                 __shfl_sync(FULL, d8, j), L8);
  }
  Out o = {0, 0, 0};
  if (__any_sync(FULL, odd)) {
    Walk w;
    unpack(w, start);
    for (int j = 0; j < steps; ++j)
      exact_step(w, o, lane == j, __shfl_sync(FULL, v, j), length);
    pack(k, w);
    return o;
  }
  k.ppos = k.head & ~255;
  // the next run's start: the next lane's head, the last one's the state's
  const int down = __shfl_down_sync(FULL, o_h, 1);
  const int next = (lane == steps - 1 ? k.head : down) & ~255;
  const bool active = o_h < L8;
  if (active) {
    o.start = o_h >> 8;
    o.len = static_cast<int>(
        (static_cast<unsigned>(next) - static_cast<unsigned>(o_h & ~255)) >>
        8);
    o.sym = o_h & 255;
  }
  // bad: a positive distance's target out of range (every run hits)
  k.err |= __any_sync(FULL, active && v > 0 && next >= lim8);
  return o;
}

__device__ __forceinline__ void walk_keyed(Walk& w, const int32_t* vals,
                                           int T, int length, int lane,
                                           const Rows& rows) {
  Packed k;
  pack(k, w);
  int ahead = lane < T ? vals[lane] : 0;  // the next group's distances
  for (int t0 = 0; t0 < T; t0 += GROUP) {
    const int t = t0 + lane;
    Out o = {0, 0, 0};
    if (k.ppos < shl8(length)) {  // warp-uniform: the walk goes on
      const int v = ahead;
      ahead = t + GROUP < T ? vals[t + GROUP] : 0;
      const int steps = min(GROUP, T - t0);
      o = steps == GROUP ? keyed_group<true>(k, v, steps, length, lane)
                         : keyed_group<false>(k, v, steps, length, lane);
    }
    store(rows, t, T, o);
  }
  w.pos = k.ppos >> 8;
  w.err = k.err;
}

__device__ __forceinline__ void walk_exact(Walk& w, const int32_t* vals,
                                           int T, int length, int lane,
                                           const Rows& rows) {
  for (int t0 = 0; t0 < T; t0 += GROUP) {
    const int t = t0 + lane;
    Out o = {0, 0, 0};
    if (w.pos < length) {  // warp-uniform: the walk goes on
      const int v = t < T ? vals[t] : 0;
      const int steps = min(GROUP, T - t0);
      for (int j = 0; j < steps; ++j)
        exact_step(w, o, lane == j, __shfl_sync(FULL, v, j), length);
    }
    store(rows, t, T, o);
  }
}

// Whether the walk goes on and every position of it fits the packing: the
// length and the entries (its positions never leave [least entry,
// length]).
__device__ __forceinline__ bool packable(const Walk& w, int length) {
  int least = w.s[0];
#pragma unroll
  for (int k = 1; k < 8; ++k) least = min(least, w.s[k]);
  return __all_sync(FULL, 0 < length && length < SPAN && least >= -SPAN);
}

}  // namespace dc

namespace {

__global__ void __launch_bounds__(32)
dc_decode_kernel(const int32_t* __restrict__ vals,
                 const int32_t* __restrict__ first,
                 const int32_t* __restrict__ lengths, int T,
                 int32_t* __restrict__ starts, int32_t* __restrict__ run_lens,
                 int32_t* __restrict__ syms, int32_t* __restrict__ err_out) {
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const size_t row = static_cast<size_t>(b) * T;
  const int length = lengths[b];
  const dc::Rows rows = {starts + row, run_lens + row, syms + row};
  dc::Walk w;
  dc::init(w, first + static_cast<size_t>(b) * 256, length, lane);
  if (dc::packable(w, length))
    dc::walk_keyed(w, vals + row, T, length, lane, rows);
  else
    dc::walk_exact(w, vals + row, T, length, lane, rows);
  // an unfinished walk (steps exhausted before the length) is an error
  if (lane == 0) err_out[b] = (w.err || w.pos < length) ? 1 : 0;
}

}  // namespace

// vals (B, T), first (B, 256) and lengths (B,) i32 in; starts, run_lens,
// syms (B, T) i32 and err (B,) i32 out, every element written.  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int tpz_dc_decode(const void* vals, const void* first,
                             const void* lengths, int B, int T, void* starts,
                             void* run_lens, void* syms, void* err,
                             void* stream) {
  dc_decode_kernel<<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(vals), static_cast<const int32_t*>(first),
      static_cast<const int32_t*>(lengths), T, static_cast<int32_t*>(starts),
      static_cast<int32_t*>(run_lens), static_cast<int32_t*>(syms),
      static_cast<int32_t*>(err));
  return static_cast<int>(cudaGetLastError());
}
