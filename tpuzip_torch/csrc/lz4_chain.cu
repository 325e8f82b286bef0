// lz4_chain.cu — tpuzip's chained LZ4 block ENCODER (codec "lz4" at
// config.codec.lz4.max_chain > 1), one warp a row, in two launches.
//
// It replaces tpuzip's host C++ `tpz_lz4_compress_chained` (csrc/
// tpuzip_host.cpp:463-568, called from tpuzip/dist/runner.py:967-981
// through native.lz4_compress_batch); tpuzip has no Pallas or XLA form of
// it.  Same bytes (kernels/lz4_chain.py is the plain version, chip_smoke.py
// holds the two equal):
//   - links: prev[p] for every position p < length - 12, the last earlier
//     position whose 4 bytes hash as p's, h = (seq * 2654435761) >> (32 -
//     hash_log) (hash_log 4..24, the wrapper clamps as the C++ does); -1
//     where there is none and from length - 12 on.  The C++ inserts every
//     position into its chain once, before its parse passes it, so when it
//     probes p the chain is exactly prev[p], prev[prev[p]], ...;
//   - parse: best(p), the longest match over the first max_chain links that
//     lie at most 65535 back (the nearest on ties), extended while the bytes
//     agree before length - 5.  At i < length - 12: best(i) under 4 makes i
//     a literal; else the match is deferred to i + 1 while best(i + 1) is
//     longer and i + 1 < length - 12 (one-step lazy matching), emitted, and
//     the parse goes on at its end.  The last literals end the stream; an
//     empty block is the byte 0.
//
// What bounds it on this card: not bytes but chains of dependent loads.  A
// probe walks its chain (each link a load of prev, then the candidate's
// bytes), and the parse's next probe depends on the match it found.
//
// What the design does about it:
//   - links, 32 positions a warp step: lz4_dense.cu's candidates step (the
//     lanes of one hash grouped by __match_any_sync, a lane's link the
//     highest earlier lane of its group, else the table's slot read before
//     the step writes it) with its keyed table, copied, and no filter on
//     the link's bytes or distance.  The table is always keyed (open
//     addressing on the full h, at most half full): hash_log reaches 24,
//     and a direct table of 2^24 slots would be 64 MiB a row;
//   - parse: best(p) does not depend on the parse, so the warp computes it
//     for a window of 32 positions at once, a lane each (each lane walks its
//     own chain, with the C++'s cheap reject at the current best and its
//     stop at the first match that reaches length - 5), and the parse reads
//     the window: the first position with a match, then the lazy steps by
//     shuffles; a new window starts where the parse leaves this one.  So a
//     literal run costs one walk a window, not one a position.  Only the
//     positions of the window ahead of the parse are probed, never every
//     position of the row: on a run every position's first link extends to
//     the row's end, which would be quadratic in the row;
//   - a lane extends its match 4 bytes a step from two aligned words;
//     token, literals and extensions are written 32 bytes a step, as
//     lz4_encode.cu writes them (its put_ext and put_literals, copied).
// The output never passes n + n/255 + 16, the row's capacity (the argument
// at the end of lz4_encode.cu's note holds for any greedy parse).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int MIN_MATCH = 4;
constexpr int MF_LIMIT = 12;
constexpr int LAST_LITERALS = 5;
constexpr int WINDOW = 0xFFFF;              // a link further back ends a walk
constexpr uint32_t HASH_MUL = 2654435761u;
constexpr uint32_t SLOT_MUL = 0x9E3779B1u;   // spreads h over keyed slots
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr unsigned long long EMPTY = ~0ull;   // a keyed slot's empty value

__device__ __forceinline__ uint32_t load4(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (uint32_t(p[3]) << 24);
}

// The 4 bytes at p as a little-endian word, from the aligned words that
// hold them (the second only when p is not aligned, so no word is read
// whose first byte lies past p + 3).
__device__ __forceinline__ uint32_t load4_aligned(const uint8_t* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~uintptr_t{3});
  const unsigned shift = (a & 3) * 8;
  return shift ? __funnelshift_r(w[0], w[1], shift) : w[0];
}

// The keyed table's helpers (as in lz4_dense.cu): a row's salt, h's first
// slot, its last position or -1, and p as its last position.
__device__ __forceinline__ uint32_t row_salt(int row) {
  return static_cast<uint32_t>(row) * SLOT_MUL;
}

__device__ __forceinline__ uint32_t keyed_slot(uint32_t h, uint32_t salt,
                                               int slots_log) {
  return ((h ^ salt) * SLOT_MUL) >> (32 - slots_log);
}

__device__ __forceinline__ int keyed_find(const unsigned long long* t,
                                          uint32_t h, uint32_t salt,
                                          int slots_log) {
  const uint32_t mask = (1u << slots_log) - 1;
  for (uint32_t s = keyed_slot(h, salt, slots_log);; s = (s + 1) & mask) {
    const unsigned long long v = t[s];
    if (v == EMPTY) return -1;
    if (static_cast<uint32_t>(v) == h) return static_cast<int>(v >> 32);
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

// Rows blockIdx.x, + gridDim.x, ...; table blockIdx.x of `tables`, 2^
// slots_log slots of 8 bytes (slots_log >= 6).
__global__ void __launch_bounds__(32)
lz4_chain_links_kernel(const uint8_t* __restrict__ blocks,
                       const int32_t* __restrict__ lengths, int B, int n,
                       int32_t* __restrict__ prev,
                       unsigned long long* __restrict__ tables, int bits,
                       int slots_log) {
  const int lane = threadIdx.x;
  const unsigned below = (1u << lane) - 1;     // lanes before this one
  const unsigned above = ~((2u << lane) - 1);  // lanes after it
  const size_t words = (size_t{1} << slots_log) / 2;   // 16-byte words
  int4* table = reinterpret_cast<int4*>(tables) + blockIdx.x * words;
  unsigned long long* keyed = reinterpret_cast<unsigned long long*>(table);
  for (int row = blockIdx.x; row < B; row += gridDim.x) {
    for (size_t k = lane; k < words; k += 32)   // every slot EMPTY
      table[k] = make_int4(-1, -1, -1, -1);
    __syncwarp();
    const uint8_t* src = blocks + static_cast<size_t>(row) * n;
    int32_t* out = prev + static_cast<size_t>(row) * n;
    const int len = min(max(lengths[row], 0), n);
    const int limit = max(len - MF_LIMIT, 0);
    const uint32_t salt = row_salt(row);
    // positions from limit on take no link and are no one's: a link lies
    // before a position below limit
    for (int base = 0; base < limit; base += 32) {
      const int p = base + lane;
      const bool live = p < limit;               // p + 3 < n: in the row
      const uint32_t h = live ? (load4(src + p) * HASH_MUL) >> (32 - bits)
                              : 0u;
      const unsigned lanes = __ballot_sync(FULL, live);
      unsigned group = 0;
      if (live) group = __match_any_sync(lanes, h);
      const unsigned earlier = group & below;
      int c = -1;
      if (live)
        c = earlier ? base + 31 - __clz(earlier)
                    : keyed_find(keyed, h, salt, slots_log);
      __syncwarp();   // every slot read before this step writes one
      if (live && !(group & above)) keyed_put(keyed, h, salt, p, slots_log);
      if (live) out[p] = c;
      __syncwarp();   // this step's writes before the next step's reads
    }
    for (int p = limit + lane; p < n; p += 32) out[p] = -1;
    __syncwarp();     // this row's table writes before the next row's reset
  }
}

// The bytes that agree from src + c and src + p, at most `most`: 4 a step,
// the first that differs by the lowest set byte of the words' xor (the
// C++'s match_extend).  p + most stays 5 bytes inside the row, so every
// word read starts inside it.
__device__ __forceinline__ int extend(const uint8_t* src, int c, int p,
                                      int most) {
  for (int m = 0; m < most; m += 4) {
    const uint32_t d = load4_aligned(src + c + m) ^ load4_aligned(src + p + m);
    if (d) return min(m + ((__ffs(d) - 1) >> 3), most);
  }
  return max(most, 0);
}

// best(p) and the link that gives it (-1 with best 0 where none does):
// the C++'s find_best over prev's chain.  A link at or past p ends the
// walk as one past the window does (links() writes none; so a prev from
// elsewhere reads nothing outside the row).
__device__ __forceinline__ int find_best(const uint8_t* src,
                                         const int32_t* prv, int p, int lim,
                                         int max_chain, int& at) {
  int best = 0;
  at = -1;
  int c = prv[p];
  for (int chain = max_chain; c >= 0 && c < p && p - c <= WINDOW &&
                              chain > 0;
       --chain) {
    if (src[c + best] == src[p + best]) {   // cheap reject at the best
      const int m = extend(src, c, p, lim - p);
      if (m > best) {
        best = m;
        at = c;
        if (p + m >= lim) break;
      }
    }
    c = prv[c];
  }
  return best;
}

// Writes the extension bytes of a length >= 15 at dst + o, the lanes side
// by side (255 each, then the remainder); returns their count.  (As in
// lz4_encode.cu.)
__device__ __forceinline__ int put_ext(uint8_t* dst, int o, int len,
                                       int lane) {
  const int rem = len - 15;
  const int cnt = rem / 255 + 1;
  for (int k = lane; k < cnt; k += 32)
    dst[o + k] = static_cast<uint8_t>(k < cnt - 1 ? 255 : rem % 255);
  return cnt;
}

// Token, literal run and its extension; the caller adds the match's part.
// (As in lz4_encode.cu.)
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

__global__ void __launch_bounds__(32)
lz4_chain_parse_kernel(const uint8_t* __restrict__ blocks,
                       const int32_t* __restrict__ lengths,
                       const int32_t* __restrict__ prev, int n,
                       int max_chain, uint8_t* __restrict__ comp, int cap,
                       int32_t* __restrict__ clens) {
  const int lane = threadIdx.x;
  const int row = blockIdx.x;
  const uint8_t* src = blocks + static_cast<size_t>(row) * n;
  const int32_t* prv = prev + static_cast<size_t>(row) * n;
  uint8_t* dst = comp + static_cast<size_t>(row) * cap;
  const int len = min(max(lengths[row], 0), n);
  const int limit = max(len - MF_LIMIT, 0);
  const int lim = len - LAST_LITERALS;
  // the window: best(wbase + lane) and its link, a lane each
  int wbase = 0, best_l = 0, at_l = -1;
  auto probe = [&](int from) {
    wbase = from;
    const int p = from + lane;
    best_l = p < limit ? find_best(src, prv, p, lim, max_chain, at_l) : 0;
  };
  probe(0);
  int i = 0, anchor = 0, o = 0;
  while (i < limit) {
    if (i >= wbase + 32) probe(i);
    const unsigned hits =
        __ballot_sync(FULL, best_l >= MIN_MATCH && wbase + lane >= i);
    if (!hits) {
      i = wbase + 32;
      continue;
    }
    int at = wbase + __ffs(hits) - 1;
    int best = __shfl_sync(FULL, best_l, at - wbase);
    // one-step lazy matching: defer while the next position's is longer
    while (at + 1 < limit) {
      if (at + 1 >= wbase + 32) probe(at);
      const int next = __shfl_sync(FULL, best_l, at + 1 - wbase);
      if (next <= best) break;
      ++at;
      best = next;
    }
    const int c = __shfl_sync(FULL, at_l, at - wbase);
    const int ml = best - MIN_MATCH;
    o = put_literals(dst, o, src, anchor, at - anchor, min(ml, 15), lane);
    if (lane == 0) {
      dst[o] = static_cast<uint8_t>((at - c) & 0xFF);
      dst[o + 1] = static_cast<uint8_t>((at - c) >> 8);
    }
    o += 2;
    if (ml >= 15) o += put_ext(dst, o, ml, lane);
    i = anchor = at + best;
  }
  o = put_literals(dst, o, src, anchor, len - anchor, 0, lane);
  if (lane == 0) clens[row] = o;
}

}  // namespace

// blocks (B, n) u8 and lengths (B,) i32 in; prev (B, n) i32 out, every
// entry written.  tables: ntab keyed tables of scratch (1 <= ntab <= B),
// each 2^slots_log slots of 8 bytes, 2^slots_log at least twice min(n,
// 2^bits) and 6 <= slots_log <= 31; bits 4..24, the hash's.  Launches ntab
// blocks of one warp on `stream` and returns cudaGetLastError().
extern "C" int tpz_lz4_chain_links(const void* blocks, const void* lengths,
                                   int B, int n, void* prev, void* tables,
                                   int ntab, int bits, int slots_log,
                                   void* stream) {
  lz4_chain_links_kernel<<<ntab, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(blocks),
      static_cast<const int32_t*>(lengths), B, n, static_cast<int32_t*>(prev),
      static_cast<unsigned long long*>(tables), bits, slots_log);
  return static_cast<int>(cudaGetLastError());
}

// blocks (B, n) u8, lengths (B,) i32 and prev (B, n) i32 from
// tpz_lz4_chain_links in; max_chain >= 1 links a walk; comp (B, cap) u8,
// zeroed by the caller (cap >= n + n/255 + 16), and clens (B,) i32 out.
// Launches B blocks of one warp on `stream` and returns cudaGetLastError().
extern "C" int tpz_lz4_chain_parse(const void* blocks, const void* lengths,
                                   const void* prev, int B, int n,
                                   int max_chain, void* comp, int cap,
                                   void* clens, void* stream) {
  lz4_chain_parse_kernel<<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(blocks),
      static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(prev), n, max_chain,
      static_cast<uint8_t*>(comp), cap, static_cast<int32_t*>(clens));
  return static_cast<int>(cudaGetLastError());
}
