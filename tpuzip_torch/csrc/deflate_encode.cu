// deflate_encode.cu — tpuzip's deflate ENCODERS (codec "deflate", id 5),
// in four steps: links (8 warps a row, or 8 warps a tile of 32 Ki
// positions on rows past 64 KiB, then a carry pass), parse (best a thread
// a position, then one warp a row, or segments of 2,048 positions on
// tpuzip's device rule), tables a block of two warps a row, emit one block
// a row (or, for stored blocks, the stored kernel alone), the histograms
// and the emit by tiles of a row's tokens on rows past 64 KiB; the parse
// and the tables in a form for each of tpuzip's two rules.
//
// It replaces tpuzip's host C++ `tpz_deflate` (csrc/tpuzip_host.cpp:
// 1314-1583, called from tpuzip/dist/runner.py:884-900 through
// native.deflate_batch_native); tpuzip has no Pallas form of it.  Same
// bytes (kernels/deflate_coder.py is the plain version, chip_smoke.py
// holds the two equal):
//   - links: prev[p] for every p with p + 2 < length, the last earlier
//     position whose 3 bytes hash as p's, h = (v * 2654435761) >> 17; -1
//     where there is none and from length - 2 on.  The C++ inserts every
//     position into its chain once, before its parse reaches it (the lazy
//     step inserts i before it probes i + 1), so when it probes p the chain
//     is exactly prev[p], prev[prev[p]], ...;
//   - parse: best(p), the longest match over the first max_chain links
//     that lie at most 32768 back, at most min(258, length - p) bytes (the
//     first link on ties).  At i: best(i) under 3 makes i a literal; else
//     the match is deferred while i + 4 <= length and best(i + 1) is
//     longer (i becomes a literal), then emitted.  Tokens, an i32 each: a
//     literal's byte, or length << 16 | distance;
//   - tables: histograms (EOB once), package-merge lengths (286 symbols at
//     15 bits, 30 at 15), the C++'s fixes of degenerate tables, canonical
//     codes, hlit/hdist trimmed, the lengths run-length coded (16/17/18),
//     their code (19 at 7 bits), hclen trimmed, and the header's bits; in
//     fixed mode the RFC's codes and a 3-bit header;
//   - emit: each token's bits behind the header, then EOB;
//   - stored: blocks of at most 65535 raw bytes, BFINAL on the last;
//   - the fragment mode (tpz_deflate_fragment, the batches of tpuzip's
//     ZlibWriter, tpuzip/io.py:258-262): no block sets BFINAL, and a
//     dynamic or fixed row ends byte-aligned after an empty stored block,
//     so that rows splice into one zlib stream.
// And tpuzip's device rule (its deflate_batch, tpuzip/codecs/deflate.py:
// 523: compress_from_device, deflate() and the zlib wrapper), the same
// links, best at max_chain 1 and emit around two instances: the parse
// without the lazy step (lz77_stage, :250), and the tables with
// package-merge's levels in the order of tpuzip's oracle, (weight, symbol
// tuple) (tpuzip/oracle/deflate.py:273), for the three trees.
//
// What bounds it on this card: not bytes but chains of dependent steps.  A
// probe walks its chain (each link a load of prev, then the candidate's
// bytes); the parse's next probe depends on the match it found; and
// package-merge sorts each level with std::sort, whose order of equal
// weights decides the code lengths: an introsort, serial as written.
//
// What the design does about it:
//   - links, on rows of at most 65,536 bytes (the path's 64 KiB blocks):
//     lz4_shared.cuh's split_row under the 3-byte key, as lz4_chain.cu's
//     shared links: a CTA of 8 warps a row beside a direct table of 2^15
//     u16 slots (64 KiB) in shared memory, the row read through L1 (staged
//     beside the table too, one CTA an SM took 2.24 ms against 1.65 at the
//     path's shape); warp w takes the positions whose hash is w mod 8, so
//     each runs an eighth of the row's table steps, and 128 positions
//     inside a run of one hash skip them.  As first ported, the links were
//     one warp a row over a keyed table of 8-byte slots in device memory,
//     512 KiB a row (PERF.md §6, row 18);
//   - links, on wider rows (tiled, lz4_shared.cuh's template, which the
//     lz4 encoders share): the row cut into tiles of LINK_TILE
//     positions, each run by split_row as a row of its own (positions
//     relative to the tile, so each fits the u16 slot), a CTA a tile, so
//     one 8 MiB row fills the card.  Each tile writes out its table (the
//     tile's last position of each hash) and, for each hash, the first
//     position that found no link inside it; a carry pass, a thread a
//     hash of a row, walks the row's tiles in order with the last position
//     seen before each and gives that first position its link: prev is
//     the shared route's at any distance.  The tables and first positions
//     take 4 B x 2^15 a tile of device memory.  The keyed warp a row it
//     replaced ran 32 positions a step, each step waiting on the keyed
//     table in device memory;
//   - parse, in two kernels: best(p) does not depend on the parse, so the
//     best kernel computes it for every position, a thread a position, the
//     whole card's worth of warps (each thread walks its own chain, with a
//     cheap reject at its current best, which keeps every longer match; a
//     match stops at 258 bytes, so probing every position of a run costs
//     one extension of 258 bytes a position).  The parse kernel, a warp a
//     row, reads windows of 32 of them by ballots and shuffles, the lazy
//     steps included; literals and tokens are written 32 a step.  A first
//     form probed only the window ahead of the parse, a lane a position,
//     inside the parse's warp: one warp a row is 8 warps an SM at 1024
//     rows, and its chain walks' loads waited one after another (174 ms at
//     1024 x 64 KiB of text at max_chain 128 on the H100);
//   - the device rule's greedy parse: next(i) = i + best(i) where best(i)
//     reaches 3, else i + 1, is a function of position alone, so the row
//     is cut into segments of PARSE_SEG positions, and a token from before
//     a segment lands on one of its first 258 positions (its entries).
//     Three launches: the maps, a warp a segment taking its positions
//     backward 32 a window, each position's exit and token count from its
//     next's (a literal run's at once from the match start after it, a
//     later lane's by pointer jumping, or the warp's ring of the values
//     ahead), those of the entries written out; the chain, a CTA a row,
//     one lookup a segment from the row's start through maps staged by
//     TMA, for each segment its true entry and its first token (the only
//     serial part); the emit, a warp a segment marking its true path's
//     positions 32 a window by doubling and writing their tokens at their
//     ranks.  A walk from a segment's start alone would not do: on a zero
//     row the true path is 1 + 258j, which a walk from k * PARSE_SEG meets
//     only when (k * PARSE_SEG - 1) mod 258 is 0.  Lost (PERF.md §6, row
//     23): a lane a segment in the maps (a ring of 258 a lane, 6 warps an
//     SM) and in the emit (each lane's loads and stores 32 lines a warp
//     instruction), four windows in flight, and an emit that walks from
//     match start to match start by ballots (a shuffle's latency a match).
//     The first form ran a warp a row over windows of 32 best values in
//     device memory, a window's load waited on at nearly every match: one
//     warp on the card for a single row;
//   - tables: a block of two warps a row.  Both build the histograms
//     (8 tokens a thread loaded at once, shared-memory atomics); then warp
//     0 runs package-merge for the literal/length tree while warp 1 runs
//     it for the distance tree, each sort of a level by the whole warp
//     with libstdc++'s permutation exactly (the sort's note below: its
//     partitions pair up, its ranges are disjoint, its final insertion
//     sort is stable within each range); a level whose packages equal the
//     last level's keeps its order unsorted; the marking takes a level's
//     taken items at once.  Then warp 0 codes the lengths' runs a lane a
//     run, builds the code-length tree and writes the header's fields a
//     lane a field (offsets by a scan), while warp 1 writes the canonical
//     codes.  As first ported lane 0 ran all of it alone: 2.78 M cycles a
//     row beside 1023 rows, the distance tree a quarter of them after the
//     literal tree (tools/step_clocks.py deflate_tables);
//   - the device rule's tables: the same CTA, each tree's levels kept as
//     tuples in a pool in shared memory, each item ranked by counting the
//     items below it (tuple_merge's note below); the literal/length tree's
//     next level built in the row's scratch, then copied into its pool,
//     so that 8 CTAs fit an SM and 1024 rows the card at once;
//   - emit: a block of 256 threads a row; each token's bit count, a block
//     scan for its offset, and its fields OR-ed into the aligned 32-bit
//     words that hold the row (zeroed by the caller; a word shared with
//     the row before gets no bit of it);
//   - rows past 64 KiB (tiled): one CTA a row for the histograms and the
//     bits left one 8 MiB row (1.8 M tokens) on one SM, 13 ms.  The row's
//     tokens are cut into tiles of 4,096, a CTA a tile: the histograms
//     counted into a copy a warp in shared memory and added once into the
//     row's record, the tables kernel reading them; then each tile's bits,
//     a scan of the row's tiles (a block a row) for each tile's first bit,
//     and each tile's fields, a thread a run of 16 tokens, gathered in a
//     64-bit register and written a word at a time (a word two runs share
//     OR-ed).

#include <cuda_runtime.h>

#include <cstdint>

#include "lz4_shared.cuh"

namespace {

constexpr int MIN_MATCH = 3;
constexpr int MAX_MATCH = 258;
constexpr int WINDOW = 32768;              // a link further back ends a walk
constexpr int HASH_BITS = 15;
constexpr int STORED_MAX = 65535;
constexpr uint32_t HASH_MUL = 2654435761u;
constexpr unsigned FULL = 0xFFFFFFFFu;
// the device rule's greedy parse in segments
constexpr int PARSE_SEG = 2048;     // positions a segment
constexpr int ENTRIES = MAX_MATCH;  // a segment's first positions a token
                                    // from before it can land on
constexpr int MAP_STRIDE = 260;     // u32 a segment's map (16-byte rows)
constexpr int MAP_CHUNK = 32;       // maps the chain stages at once
constexpr int MAP_WARPS = 8;        // segments a block of the maps
constexpr int RING = 512;           // a maps warp's values ahead, > 32 + 258
constexpr int MAP_BUFS = 4;         // map chunks the chain holds, at most
constexpr int EMIT_WARPS = 4;       // segments a block of the emit

// package-merge items: a leaf s, or PKG + k for the k-th package
constexpr int PKG = 1 << 10;
constexpr int LV = 576;             // items a level holds, at most (286 + 285)
constexpr int THRESHOLD = 16;       // libstdc++'s _S_threshold
constexpr int TABLE_THREADS = 64;   // a tables block: a row, two warps
constexpr int HIST_BATCH = 8;       // tokens a thread loads at once
constexpr int EMIT_THREADS = 256;
constexpr int BEST_THREADS = 128;   // positions a best block
// rows past lz4s::STAGE_MAX bytes: the histograms and the emit by tiles of
// a row's tokens, TILE_RUN consecutive tokens a thread
constexpr int TILE_THREADS = 256;
constexpr int TILE_RUN = 16;
constexpr int TOKEN_TILE = TILE_THREADS * TILE_RUN;
constexpr int SCAN_THREADS = 256;   // a row's tile offsets, a block a row

// a row's scratch (bytes): the levels' orders (the C++ rule) or the
// literal/length tree's next level (the device rule), then the record the
// emit kernel reads: codes (literal/length 0..287, distance at 288..319),
// their lengths, and the header's bits; past it the tiled histograms'
// counts (in the codes' order).  Past the rows' scratch, on the tiled
// route, each tile's first bit (an int a tile).
constexpr int SCRATCH_BYTES = 20480;
constexpr int REC_CODES = 17408;
constexpr int REC_LENS = REC_CODES + 640;
constexpr int REC_HBITS = REC_LENS + 320;
constexpr int REC_FREQ = REC_HBITS + 16;
static_assert(REC_FREQ + 320 * 4 <= SCRATCH_BYTES, "the counts fit the row");

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

__device__ __forceinline__ int len_code(int l) {   // 3..258 -> 0..28
  const int x = l - 3;
  if (x < 8) return x;
  if (l == MAX_MATCH) return 28;
  const int k = 31 - __clz(x);
  return 4 * (k - 1) + ((x >> (k - 2)) & 3);
}

__device__ __forceinline__ int dist_code(int d) {  // 1..32768 -> 0..29
  const int x = d - 1;
  if (x < 4) return x;
  const int k = 31 - __clz(x);
  return 2 * k + ((x >> (k - 1)) & 1);
}

// The 4 bytes at p as a little-endian word, from the aligned words that
// hold them.
__device__ __forceinline__ uint32_t load4_aligned(const uint8_t* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~uintptr_t{3});
  const unsigned shift = (a & 3) * 8;
  return shift ? __funnelshift_r(w[0], w[1], shift) : w[0];
}

// links on the shared route (n <= 65536), rows blockIdx.x, + gridDim.x,
// ...: a direct table of 2^15 u16 slots in shared memory (64 KiB, three
// CTAs an SM), lz4_shared.cuh's split_row over SPLIT_CLASSES warps under
// deflate's key (its hash is hash_bits of the 3 bytes at 15 bits), the row
// read through L1, 3 bytes a position, none past the row.
struct Key3 {
  static constexpr bool ALIGNED = false;   // read byte by byte from the row
  __device__ __forceinline__ uint32_t operator()(const uint8_t* row,
                                                 int q) const {
    return row[q] | row[q + 1] << 8 | static_cast<uint32_t>(row[q + 2]) << 16;
  }
};

__global__ void __launch_bounds__(32 * lz4s::SPLIT_CLASSES)
deflate_links_shared_kernel(const uint8_t* __restrict__ blocks,
                            const int32_t* __restrict__ lengths, int B,
                            int n, int32_t* __restrict__ prev) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int THREADS = 32 * lz4s::SPLIT_CLASSES;
  uint32_t* queues = reinterpret_cast<uint32_t*>(smem);
  uint16_t* table = reinterpret_cast<uint16_t*>(smem + lz4s::QUEUE_BYTES);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int row = blockIdx.x; row < B; row += gridDim.x) {
    const uint8_t* src = blocks + static_cast<size_t>(row) * n;
    int32_t* out = prev + static_cast<size_t>(row) * n;
    const int len = min(max(lengths[row], 0), n);
    const int limit = max(len - (MIN_MATCH - 1), 0);   // p + 2 < len
    __syncthreads();   // the last row's steps on the table done
    for (int k = tid; k < lz4s::table_bytes(HASH_BITS) / 16; k += THREADS)
      reinterpret_cast<int4*>(table)[k] = make_int4(0, 0, 0, 0);
    for (int p = limit + tid; p < n; p += THREADS) out[p] = -1;
    __syncthreads();
    lz4s::split_row<Key3>(src, 0, limit, HASH_BITS, table,
                          queues + 64 * warp, warp, lane,
                          [&](int p, int c) { out[p] = c; });
  }
}

// The bytes that agree from src + c and src + p (c < p), at most `most`
// (p + most <= len): 4 a step from aligned words while both words of p's
// lie inside the row, then byte by byte (the C++'s match_extend).
__device__ __forceinline__ int extend(const uint8_t* src, int c, int p,
                                      int most, int len) {
  int m = 0;
  for (; m < most && p + m + 8 <= len; m += 4) {
    const uint32_t d = load4_aligned(src + c + m) ^ load4_aligned(src + p + m);
    if (d) return min(m + ((__ffs(d) - 1) >> 3), most);
  }
  while (m < most && src[c + m] == src[p + m]) ++m;
  return min(m, most);
}

// best(p) and the link that gives it (-1 with best 0 where none does):
// the C++'s best_at over prev's chain.  A link at or past p ends the walk
// as one past the window does.
__device__ __forceinline__ int find_best(const uint8_t* src,
                                         const int32_t* prv, int p, int len,
                                         int max_chain, int& at) {
  int best = 0;
  at = -1;
  const int most = min(MAX_MATCH, len - p);
  int c = prv[p];
  for (int chain = max_chain; c >= 0 && c < p && p - c <= WINDOW &&
                              chain > 0;
       --chain) {
    if (src[c + best] == src[p + best]) {   // a longer match agrees there
      const int m = extend(src, c, p, most, len);
      if (m > best) {
        best = m;
        at = c;
        if (m >= most) break;
      }
    }
    c = prv[c];
  }
  return best;
}

// best(p) of every position of every row, a thread a position: blocks of
// BEST_THREADS positions, ceil(n / BEST_THREADS) a row.  best_at[p] is
// best << 16 | the distance of its link, 0 where there is no match and
// from length - 2 on.
__global__ void __launch_bounds__(BEST_THREADS)
deflate_best_kernel(const uint8_t* __restrict__ blocks,
                    const int32_t* __restrict__ lengths,
                    const int32_t* __restrict__ prev, int n, int max_chain,
                    int32_t* __restrict__ best_at) {
  const int per_row = (n + BEST_THREADS - 1) / BEST_THREADS;
  const int row = blockIdx.x / per_row;
  const int p = (blockIdx.x % per_row) * BEST_THREADS + threadIdx.x;
  if (p >= n) return;
  const uint8_t* src = blocks + static_cast<size_t>(row) * n;
  const int32_t* prv = prev + static_cast<size_t>(row) * n;
  const int len = min(max(lengths[row], 0), n);
  int v = 0;
  if (p < len - 2) {
    int at;
    const int best = find_best(src, prv, p, len, max_chain, at);
    if (best) v = best << 16 | (p - at);
  }
  best_at[static_cast<size_t>(row) * n + p] = v;
}

// The C++ rule's parse over best_at, a warp a row, with its lazy step (a
// match deferred while the next position's is longer).
__global__ void __launch_bounds__(32)
deflate_parse_kernel(const uint8_t* __restrict__ blocks,
                     const int32_t* __restrict__ lengths,
                     const int32_t* __restrict__ best_at, int n,
                     int32_t* __restrict__ tokens,
                     int32_t* __restrict__ ntok) {
  const int lane = threadIdx.x;
  const int row = blockIdx.x;
  const uint8_t* src = blocks + static_cast<size_t>(row) * n;
  const int32_t* ba = best_at + static_cast<size_t>(row) * n;
  int32_t* tok = tokens + static_cast<size_t>(row) * n;
  const int len = min(max(lengths[row], 0), n);
  const int limit = max(len - 2, 0);     // positions that may match
  // the window: best(wbase + lane) and its link's distance, a lane each
  int wbase = 0, best_l = 0, dist_l = 0;
  auto window = [&](int from) {
    wbase = from;
    const int p = from + lane;
    const int v = p < limit ? ba[p] : 0;
    best_l = v >> 16;
    dist_l = v & 0xFFFF;
  };
  window(0);
  int i = 0, anchor = 0, t = 0;
  while (i < limit) {
    if (i >= wbase + 32) window(i);
    const unsigned hits =
        __ballot_sync(FULL, best_l >= MIN_MATCH && wbase + lane >= i);
    if (!hits) {
      i = wbase + 32;
      continue;
    }
    int at = wbase + __ffs(hits) - 1;
    int best = __shfl_sync(FULL, best_l, at - wbase);
    {
      // lazy matching: defer while the next position's match is longer
      while (at + 1 < limit) {
        if (at + 1 >= wbase + 32) window(at);
        const int next = __shfl_sync(FULL, best_l, at + 1 - wbase);
        if (next <= best) break;
        ++at;
        best = next;
      }
    }
    const int d = __shfl_sync(FULL, dist_l, at - wbase);
    for (int k = lane; k < at - anchor; k += 32) tok[t + k] = src[anchor + k];
    t += at - anchor;
    if (lane == 0) tok[t] = best << 16 | d;
    ++t;
    i = anchor = at + best;
  }
  for (int k = lane; k < len - anchor; k += 32) tok[t + k] = src[anchor + k];
  t += len - anchor;
  if (lane == 0) ntok[row] = t;
}

// The greedy parse's maps, a warp a segment (segments blockIdx.x *
// MAP_WARPS + warp of the B rows' nseg each, total in all): the segment's
// positions below the row's length taken backward, 32 a window, each
// one's token count to the segment's exit and the exit's offset past the
// segment's end (count << 16 | offset).  A match start's value is its
// next's, one token more; a literal's is that of the next match start in
// the window (a ballot finds it), a token a literal more, or, where the
// run leaves the window, that of the position past it.  A value past the
// window is read from the warp's ring of the values ahead in shared
// memory; one inside it is a later lane's, and those links resolve by
// pointer jumping over the window's lanes (two shuffles a round; only
// matches chain, so a window of literals or of long matches takes no
// round).  The window's best values are one coalesced load, the next
// window's in flight.  The entries' values go to maps (a map of
// MAP_STRIDE u32 a segment; 0 for an entry at or past the row's length).
__global__ void __launch_bounds__(32 * MAP_WARPS)
deflate_segment_maps_kernel(const int32_t* __restrict__ lengths,
                            const int32_t* __restrict__ best_at, int n,
                            int nseg, long long total,
                            uint32_t* __restrict__ maps) {
  __shared__ uint32_t rings[MAP_WARPS][RING];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned after = ~((2u << lane) - 1);   // the lanes after this one
  const long long seg = blockIdx.x * static_cast<long long>(MAP_WARPS) +
                        warp;
  if (seg >= total) return;
  const int row = static_cast<int>(seg / nseg);
  const int s0 = static_cast<int>(seg % nseg) * PARSE_SEG;
  const int len = min(max(lengths[row], 0), n);
  const int end = min(PARSE_SEG, len - s0);   // positions below the length
  if (end <= 0) return;
  const int32_t* ba = best_at + static_cast<size_t>(row) * n + s0;
  uint32_t* map = maps + seg * MAP_STRIDE;
  uint32_t* ring = rings[warp];
  // the value at a position past the window or at the end: its count and
  // the exit's offset (the end of the last segment: offset 0)
  const uint32_t at_end = static_cast<uint32_t>(max(end - PARSE_SEG, 0));
  for (int j = end + lane; j < ENTRIES; j += 32) map[j] = 0;
  int w = (end - 1) & ~31;   // the last window
  int next = w + lane < end ? ba[w + lane] >> 16 : 0;
  for (; w >= 0; w -= 32) {
    const int i = w + lane;
    const int b = next;
    if (w > 0) next = ba[i - 32] >> 16;   // the next window's load in flight
    const unsigned starts = __ballot_sync(FULL, i < end && b >= MIN_MATCH);
    // st: the value where ptr is this lane (resolved), else the tokens to
    // add to lane ptr's value
    uint32_t st = 0;
    int ptr = lane;
    if (i < end) {
      if (b >= MIN_MATCH) {
        const int nx = i + b;
        if (nx >= end)
          st = 1u << 16 | static_cast<uint32_t>(max(nx - PARSE_SEG, 0));
        else if (nx >= w + 32)
          st = ring[nx & (RING - 1)] + (1u << 16);
        else {
          st = 1;
          ptr = nx - w;
        }
      } else if (starts & after) {   // literals up to a match start
        ptr = __ffs(starts & after) - 1;
        st = static_cast<uint32_t>(ptr - lane);
      } else if (w + 32 >= end) {    // literals up to the end
        st = static_cast<uint32_t>(end - i) << 16 | at_end;
      } else {                       // literals out of the window
        st = ring[(w + 32) & (RING - 1)] +
             (static_cast<uint32_t>(w + 32 - i) << 16);
      }
    }
    while (__any_sync(FULL, ptr != lane)) {
      const uint32_t ts = __shfl_sync(FULL, st, ptr);
      const int tp = __shfl_sync(FULL, ptr, ptr);
      if (ptr != lane) {
        if (tp == ptr) {   // the target is resolved
          st = ts + (st << 16);
          ptr = lane;
        } else {
          st += ts;
          ptr = tp;
        }
      }
    }
    if (i < end) {
      ring[i & (RING - 1)] = st;
      if (i < ENTRIES) map[i] = st;
    }
    __syncwarp();   // the window's values before the next window reads them
  }
}

// The greedy parse's chain, a CTA a row: lane 0 walks the row's segments
// from entry 0 of the first, each segment's true entry and first token
// into segs (x the entry's position, y the token), the next entry and
// token from the segment's map at its entry; ntok the row's tokens.  The
// maps come into shared memory MAP_CHUNK segments a TMA bulk copy, into
// bufs buffers (1 <= bufs <= MAP_BUFS), the next chunks loading while
// lane 0 walks one.
__global__ void __launch_bounds__(32)
deflate_segment_chain_kernel(const int32_t* __restrict__ lengths, int n,
                             int nseg, int bufs,
                             const uint32_t* __restrict__ maps,
                             int2* __restrict__ segs,
                             int32_t* __restrict__ ntok) {
  constexpr int CHUNK = MAP_CHUNK * MAP_STRIDE;   // u32 a buffer
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* buf = reinterpret_cast<uint32_t*>(smem);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + bufs * CHUNK *
                                                         sizeof(uint32_t));
  if (threadIdx.x != 0) return;
  const int row = blockIdx.x;
  const int len = min(max(lengths[row], 0), n);
  const int used = (len + PARSE_SEG - 1) / PARSE_SEG;   // segments to walk
  const int chunks = (used + MAP_CHUNK - 1) / MAP_CHUNK;
  const uint32_t* row_maps = maps + static_cast<size_t>(row) * nseg *
                                        MAP_STRIDE;
  int2* row_segs = segs + static_cast<size_t>(row) * nseg;
  for (int b = 0; b < bufs; ++b) lz4s::bar_init(bar + b, 1);
  lz4s::bar_init_fence();
  auto load = [&](int c) {
    const int count = min(MAP_CHUNK, used - c * MAP_CHUNK);
    lz4s::bulk_load(buf + (c % bufs) * CHUNK,
                    row_maps + static_cast<size_t>(c) * CHUNK,
                    count * MAP_STRIDE * sizeof(uint32_t), bar + c % bufs);
  };
  for (int c = 0; c < min(bufs, chunks); ++c) load(c);
  unsigned phases = 0;   // bit b: the parity of buffer b's next phase
  int e = 0, t = 0;
  for (int c = 0; c < chunks; ++c) {
    const int b = c % bufs;
    lz4s::bar_wait(bar + b, (phases >> b) & 1);
    phases ^= 1u << b;
    const uint32_t* m = buf + b * CHUNK;
    const int count = min(MAP_CHUNK, used - c * MAP_CHUNK);
    for (int j = 0; j < count; ++j) {
      const int k = c * MAP_CHUNK + j;
      row_segs[k] = make_int2(k * PARSE_SEG + e, t);
      const uint32_t v = m[j * MAP_STRIDE + e];
      t += static_cast<int>(v >> 16);
      e = static_cast<int>(v & 0xFFFF);
    }
    if (c + bufs < chunks) load(c + bufs);   // buffer b read through
  }
  ntok[row] = t;
}

// The greedy parse's tokens, a warp a segment: its true path from its
// entry to the row's length or the segment's end, 32 positions a window.
// Each lane takes a position of the window and its next (next(i) = i +
// best(i) where best(i) reaches 3, else i + 1); the path's positions in the
// window are marked from its entry by doubling, a lane's 2^r-th successor
// inside the window for r < 5, each round a reduce-or of the marked lanes'
// jumps (a path inside 32 positions takes at most 31 steps); each marked
// position is a token, a match as best_at[p] (length << 16 | distance),
// a literal as its byte, written at its rank among them; the last one's
// next is the next window's entry.  The window after this one is loaded
// while this one is worked.
__global__ void __launch_bounds__(32 * EMIT_WARPS)
deflate_segment_emit_kernel(const uint8_t* __restrict__ blocks,
                            const int32_t* __restrict__ lengths,
                            const int32_t* __restrict__ best_at, int n,
                            int nseg, long long total,
                            const int2* __restrict__ segs,
                            int32_t* __restrict__ tokens) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;
  const long long seg = blockIdx.x * static_cast<long long>(EMIT_WARPS) +
                        warp;
  if (seg >= total) return;
  const int row = static_cast<int>(seg / nseg);
  const int s0 = static_cast<int>(seg % nseg) * PARSE_SEG;
  const int len = min(max(lengths[row], 0), n);
  if (s0 >= len) return;
  const int end = min(s0 + PARSE_SEG, len);
  const uint8_t* src = blocks + static_cast<size_t>(row) * n;
  const int32_t* ba = best_at + static_cast<size_t>(row) * n;
  int32_t* tok = tokens + static_cast<size_t>(row) * n;
  const int2 at = segs[seg];
  int p = at.x, t = at.y;
  int ahead = -1, v_ahead = 0, c_ahead = 0;   // the window after the last
  while (p < end) {
    const int w = p & ~31, q = w + lane;
    int v = v_ahead, c = c_ahead;
    if (w != ahead) {
      v = q < end ? ba[q] : 0;
      c = q < end ? src[q] : 0;
    }
    ahead = w + 32;
    v_ahead = ahead + lane < end ? ba[ahead + lane] : 0;
    c_ahead = ahead + lane < end ? src[ahead + lane] : 0;
    const int nx = q + (v >> 16 >= MIN_MATCH ? v >> 16 : 1);
    int jump = nx < min(end, w + 32) ? nx - w : 32;   // 32: out
    unsigned mask = 1u << (p - w);
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      mask |= __reduce_or_sync(
          FULL, (mask >> lane & 1) && jump < 32 ? 1u << jump : 0u);
      if (r < 4) {
        const int twice = __shfl_sync(FULL, jump, jump & 31);
        jump = jump < 32 ? twice : jump;
      }
    }
    if (mask >> lane & 1)
      tok[t + __popc(mask & below)] = v >> 16 >= MIN_MATCH ? v : c;
    t += __popc(mask);
    p = __shfl_sync(FULL, nx, 31 - __clz(mask));
  }
}

// ---------------------------------------------------------------- sort

// libstdc++'s std::sort (bits/stl_algo.h, bits/stl_heap.h) of package-merge
// items ordered by weight alone, run by a warp.  An item is one key,
// weight << KEY_SHIFT | node, and only key >> KEY_SHIFT is compared, so the
// order of equal weights is libstdc++'s, exactly:
//   - __introsort_loop partitions every range past THRESHOLD items; here
//     the whole warp does each: the median of three to its first place
//     (one lane), then __unguarded_partition by pairs.  Its k-th swap
//     exchanges the k-th position from the left whose weight is not below
//     the pivot with the k-th from the right whose weight is not above it,
//     for every k while the two have not crossed; both lists come from
//     ballots and prefix counts, and a lane swaps a pair.  Its left scan
//     stops at the next position of the left list past the last pair, or
//     at that pair's right position if it comes first (the cut);
//   - its ranges are disjoint, so the order they are taken in does not
//     change the result: pending ones wait on a stack in shared memory;
//   - the final __insertion_sort moves an element left only past strictly
//     larger ones, and after the introsort loop each element lies in its
//     final range of at most THRESHOLD items (or in a heap-sorted one), no
//     item of a range larger than any of a later range: so it equals a
//     stable sort of each final range on its own, which places each item
//     by counting the items of its range below it and the equal ones
//     before it (a lane an item);
//   - the heap-sort fallback at depth 0 (2 floor(log2 n) at the top) runs
//     on one lane: only adversarial inputs reach it.
// Ranges of at most 32 items sorted each by one lane, the serial loop and
// then an insertion sort, took 1.23 times as long at the deflate path's
// rows (the lanes' loops diverge); ranges of at most 16 by one lane 1.06
// times (PERF.md §6, row 20).  tests/test_torch_deflate_sort.py replicates
// this form in Python and holds its permutation equal to
// kernels/deflate_coder.std_sort's.

constexpr int KEY_SHIFT = 16;
constexpr int WARP_STACK = 34;     // pending ranges, at most (LV / 17)

__device__ __forceinline__ unsigned long long wt(unsigned long long key) {
  return key >> KEY_SHIFT;
}

// a range: first, last (10 bits each) and its depth
__device__ __forceinline__ uint32_t range(int first, int last, int depth) {
  return first | last << 10 | depth << 20;
}

__device__ __forceinline__ void adjust_heap(unsigned long long* a, int first,
                                            int hole, int len,
                                            unsigned long long v) {
  const int top = hole;
  int child = hole;
  while (child < (len - 1) / 2) {
    child = 2 * (child + 1);
    if (wt(a[first + child]) < wt(a[first + child - 1])) --child;
    a[first + hole] = a[first + child];
    hole = child;
  }
  if ((len & 1) == 0 && child == (len - 2) / 2) {
    child = 2 * (child + 1);
    a[first + hole] = a[first + child - 1];
    hole = child - 1;
  }
  int parent = (hole - 1) / 2;
  while (hole > top && wt(a[first + parent]) < wt(v)) {
    a[first + hole] = a[first + parent];
    hole = parent;
    parent = (hole - 1) / 2;
  }
  a[first + hole] = v;
}

// __partial_sort(first, last, last): __make_heap, then __sort_heap.
__device__ __forceinline__ void heap_sort(unsigned long long* a, int first,
                                          int last) {
  const int len = last - first;
  if (len >= 2) {
    for (int parent = (len - 2) / 2;; --parent) {
      adjust_heap(a, first, parent, len, a[first + parent]);
      if (parent == 0) break;
    }
  }
  while (last - first > 1) {
    --last;
    const unsigned long long v = a[last];
    a[last] = a[first];
    adjust_heap(a, first, 0, last - first, v);
  }
}

// A warp's scratch for its sorts (shared memory).
struct SortSpace {
  uint16_t* left;     // positions not below the pivot, left to right
  uint16_t* right;    // positions not above it, left to right
  uint32_t* stack;    // pending ranges past THRESHOLD
  uint32_t* block;    // each position's final range: first | last << 16
};

// The warp: __unguarded_partition_pivot(first, last) by pairs; returns the
// cut.  Ends with the warp converged and every swap visible.
__device__ __forceinline__ int pair_partition(unsigned long long* a,
                                              int first, int last,
                                              const SortSpace& s, int lane) {
  const unsigned below = (1u << lane) - 1;
  const int x = first + 1, y = first + (last - first) / 2, z = last - 1;
  const unsigned long long wx = wt(a[x]), wy = wt(a[y]), wz = wt(a[z]);
  int pick;
  if (wx < wy)
    pick = wy < wz ? y : wx < wz ? z : x;
  else
    pick = wx < wz ? x : wy < wz ? z : y;
  const unsigned long long head = a[first], med = a[pick];
  __syncwarp();
  if (lane == 0) {
    a[first] = med;
    a[pick] = head;
  }
  __syncwarp();
  const unsigned long long pivot = wt(med);
  int nge = 0, nle = 0;
  for (int base = first + 1; base < last; base += 32) {
    const int i = base + lane;
    const unsigned long long w = i < last ? wt(a[i]) : 0;
    const bool ge = i < last && w >= pivot, le = i < last && w <= pivot;
    const unsigned bge = __ballot_sync(FULL, ge);
    const unsigned ble = __ballot_sync(FULL, le);
    if (ge) s.left[nge + __popc(bge & below)] = static_cast<uint16_t>(i);
    if (le) s.right[nle + __popc(ble & below)] = static_cast<uint16_t>(i);
    nge += __popc(bge);
    nle += __popc(ble);
  }
  __syncwarp();
  // pairs: k (from 0) while left[k] < the k-th from the right (a prefix)
  const int kmax = min(nge, nle);
  int pairs = 0;
  for (int k0 = 0; k0 < kmax; k0 += 32) {
    const int k = k0 + lane;
    const unsigned b = __ballot_sync(
        FULL, k < kmax && s.left[k] < s.right[nle - 1 - k]);
    pairs += __popc(b);
    if (b != FULL) break;
  }
  for (int k = lane; k < pairs; k += 32) {   // disjoint pairs
    const int i = s.left[k], j = s.right[nle - 1 - k];
    const unsigned long long t = a[i];
    a[i] = a[j];
    a[j] = t;
  }
  __syncwarp();
  if (pairs == 0) return s.left[0];
  const int r = s.right[nle - pairs];
  return pairs < nge ? min(static_cast<int>(s.left[pairs]), r) : r;
}

// The warp: [first, last), of at most THRESHOLD items, is a final range.
__device__ __forceinline__ void add_block(const SortSpace& s, int first,
                                          int last, int lane) {
  if (lane < last - first) s.block[first + lane] = first | last << 16;
}

// std::sort of a[0, n) (n <= NV) by the whole warp, as the note says; the
// final insertion sort as a stable sort of each final range, an item's
// place in it counted (the items below it, and the equal ones before
// it).  Starts and ends converged, a's items visible to every lane.
template <int NV>
__device__ __forceinline__ void warp_sort(unsigned long long* a, int n,
                                          const SortSpace& s, int lane) {
  if (n < 2) return;
  for (int p = lane; p < n; p += 32) s.block[p] = p | (p + 1) << 16;
  __syncwarp();
  int sp = 0;
  int first = 0, last = n, depth = 2 * (31 - __clz(n));
  for (;;) {
    while (last - first > THRESHOLD) {
      if (depth == 0) {
        if (lane == 0) heap_sort(a, first, last);
        __syncwarp();
        first = last;
        break;
      }
      --depth;
      const int cut = pair_partition(a, first, last, s, lane);
      if (last - cut > THRESHOLD) {
        if (lane == 0) s.stack[sp] = range(cut, last, depth);
        ++sp;
      } else {
        add_block(s, cut, last, lane);
      }
      last = cut;
    }
    add_block(s, first, last, lane);
    if (sp == 0) break;
    __syncwarp();
    const uint32_t r = s.stack[--sp];
    first = r & 1023;
    last = (r >> 10) & 1023;
    depth = r >> 20;
  }
  __syncwarp();
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
      const unsigned long long w = wt(v[j]);
      int r = f;
      for (int q = f; q < l; ++q) {
        const unsigned long long x = wt(a[q]);
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
}

// ---------------------------------------------------------------- tables

// A tree's package-merge space (shared memory): NSYM symbols, levels of at
// most LVN items.
template <int NSYM, int LVN>
struct Tree {
  unsigned long long a[LVN];          // the level being sorted (keys)
  unsigned long long leaf[NSYM];      // the active symbols' keys, in order
  unsigned long long pk[2][LVN / 2];  // this level's package weights, the last's
  uint16_t left[LVN], right[LVN];
  uint32_t stack[WARP_STACK], block[LVN];
  uint8_t mark[2][LVN];               // taken flags of two levels
  int size[16];                       // each level's items
};

// tpuzip's package_merge (tpuzip_host.cpp:1244-1271), by a warp: code
// lengths of at most MAXBITS for the symbols with freq > 0 (a lone one
// gets 1) into lens; lv holds each level's order (LVN a level).  A level
// whose packages equal the last level's has the last level's items, so
// its order is the last level's and its sort is skipped.  The marking
// takes a level's taken items at once: a leaf's length grows, a package
// marks its pair below.  Starts and ends converged.
template <int NSYM, int LVN, int MAXBITS>
__device__ __forceinline__ void package_merge(const uint32_t* freq,
                                              uint8_t* lens,
                                              Tree<NSYM, LVN>& t,
                                              uint16_t* lv, int lane) {
  const unsigned below = (1u << lane) - 1;
  const SortSpace s{t.left, t.right, t.stack, t.block};
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
    return;
  }
  int m = 0, last_np = -1;
  for (int level = 0; level < MAXBITS; ++level) {
    const int np = m / 2;
    unsigned long long* pk = t.pk[level & 1];
    const unsigned long long* was = t.pk[(level & 1) ^ 1];
    bool same = np == last_np;
    for (int k0 = 0; k0 < np; k0 += 32) {
      const int k = k0 + lane;
      bool differs = false;
      if (k < np) {
        pk[k] = wt(t.a[2 * k]) + wt(t.a[2 * k + 1]);
        differs = pk[k] != was[k];
      }
      same = same && !__any_sync(FULL, differs);
    }
    last_np = np;
    __syncwarp();
    if (!same) {
      for (int k = lane; k < na; k += 32) t.a[k] = t.leaf[k];
      for (int k = lane; k < np; k += 32)
        t.a[na + k] = pk[k] << KEY_SHIFT | (PKG + k);
      m = na + np;
      __syncwarp();
      warp_sort<LVN>(t.a, m, s, lane);
    }
    if (lane == 0) t.size[level] = m;
    for (int k = lane; k < m; k += 32)
      lv[level * LVN + k] = static_cast<uint16_t>(t.a[k] & 0xFFFF);
  }
  uint8_t* cur = t.mark[0];
  uint8_t* under = t.mark[1];
  const int take = min(2 * na - 2, m);
  for (int k = lane; k < m; k += 32) cur[k] = k < take;
  __syncwarp();
  for (int level = MAXBITS - 1; level >= 0; --level) {
    const int nb = level ? t.size[level - 1] : 0, nl = t.size[level];
    for (int k = lane; k < nb; k += 32) under[k] = 0;
    // the level's order first, every load at once (lv may be in device
    // memory)
    uint16_t node[(LVN + 31) / 32];
#pragma unroll
    for (int j = 0; j < (LVN + 31) / 32; ++j) {
      const int k = j * 32 + lane;
      node[j] = k < nl ? lv[level * LVN + k] : 0;
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < (LVN + 31) / 32; ++j) {
      const int k = j * 32 + lane;
      if (k < nl && cur[k]) {
        const int nd = node[j];
        if (nd < PKG) {
          ++lens[nd];   // a leaf is once on a level
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
}

// A table with one code gets a second: both of length 1 (:1474).  A warp.
__device__ __forceinline__ void one_code(uint8_t* lens, int n, int lane) {
  int nz = 0, s0 = 0;
  for (int c0 = 0; c0 < n; c0 += 32) {
    const int s = c0 + lane;
    const unsigned b = __ballot_sync(FULL, s < n && lens[s]);
    if (nz == 0 && b) s0 = c0 + __ffs(b) - 1;
    nz += __popc(b);
  }
  if (nz == 1 && lane == 0) {
    lens[s0] = 1;
    lens[s0 ? 0 : 1] = 1;
  }
  __syncwarp();
}

// ---------------------------------------------------------------- tuple order

// tpuzip's device rule takes its code lengths from its oracle's
// package_merge (tpuzip/oracle/deflate.py:273), which sorts each level by
// (weight, symbol tuple) with Python's sorted: an item's tuple is its
// leaf's symbol, or a package's pair's tuples one after the other; tuples
// compare lexicographically, a proper prefix first.  Equal items are
// equal tuples, so the order is total and every sort gives the same
// lengths; the last level's first 2n - 2 tuples count each symbol's length.
// By a warp, a level at a time: a level's tuples lie one after another in
// its pool, in order, so a package's tuple is a slice of the last level's
// pool; each item's rank counts the items below it (a lane an item),
// then its tuple is written at its rank's offset (a lane a symbol).  The
// leaves stay sorted and the packages' weights do not fall (each sums
// two neighbours of a sorted level), so the items of lower weight are
// counted by binary searches (a package's packages below it only where
// the package before it has its weight); among equal weights a leaf (s,)
// comes after the packages whose tuple starts below s and before the
// others, and a package is compared with the equal-weight packages one by
// one (their tuples need not be in order: one may be a proper prefix of
// the next).  Each level is read from its pool in shared memory and the
// next built beside it, then copied into the pool: for the literal/length
// tree (8,580 B a pool) beside it in the row's scratch, so that a CTA
// holds 27,584 B and 8 CTAs fit an SM (1024 rows the card at once; with
// both of its pools in shared memory, 36,160 B, 6 CTAs an SM and a second
// wave; with both in the scratch, 11 CTAs an SM, but each compare of two
// packages' tuples read device memory).
constexpr uint16_t LEAF = 0x8000;   // a ranked item's source: a leaf's symbol
constexpr int COPY_BATCH = 8;       // words a lane copies at once

// A tree's tuple-order space (shared memory): NSYM symbols, levels of at
// most LVN items, pools of at most POOL symbols (a level's symbols grow by
// at most NSYM a level); the pool itself (a level's tuples in order) and
// the next level's lie beside it.
template <int NSYM, int LVN, int POOL>
struct TupleTree {
  uint32_t lw[NSYM];                 // the leaves' weights, by (weight, symbol)
  uint32_t w[2][LVN];                // a level's weights in order, the last's
  uint32_t starts[(POOL + 31) / 32];  // bits: where the new level's tuples start
  uint16_t ls[NSYM];                 // the leaves' symbols, in that order
  uint16_t off[2][LVN + 1];          // a level's tuples' offsets, then the end
  uint16_t src[LVN];                 // the new level's items by rank: a leaf's
                                     // symbol | LEAF, or a package's offset
};

// The first i in [lo, hi) where pred(i) is false (pred true on a prefix).
template <class Pred>
__device__ __forceinline__ int partition_point(int lo, int hi, Pred pred) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (pred(mid))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Python's order of the tuples pool[a0, a0 + al) and pool[b0, b0 + bl):
// -1, 0 or 1.
__device__ __forceinline__ int tuple_cmp(const uint16_t* pool, int a0, int al,
                                         int b0, int bl) {
  const int k = min(al, bl);
  for (int i = 0; i < k; ++i) {
    const int x = pool[a0 + i], y = pool[b0 + i];
    if (x != y) return x < y ? -1 : 1;
  }
  return al < bl ? -1 : al > bl;
}

// The oracle's package_merge by a warp, as the note says: code lengths of
// at most LIMIT for the symbols with freq > 0 (a lone one gets 1) into
// lens; freq is overwritten (with the lengths); pool: POOL u16 of shared
// memory, the level's tuples; build: POOL u16 (shared memory or the row's
// scratch), where the next level's are built before their copy into pool.
// POOL even, both 4-byte aligned.  Starts and ends converged.
template <int NSYM, int LVN, int POOL, int LIMIT>
__device__ __forceinline__ void tuple_merge(uint32_t* freq, uint8_t* lens,
                                            TupleTree<NSYM, LVN, POOL>& t,
                                            uint16_t* pool, uint16_t* build,
                                            int lane) {
  const unsigned below = (1u << lane) - 1;
  int na = 0;   // the active symbols, in symbol order (w[1], src for now)
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
  if (na < 2) {
    if (na && lane == 0) lens[t.src[0]] = 1;
    __syncwarp();
    return;
  }
  for (int k = lane; k < na; k += 32) {   // the leaves by (weight, symbol)
    const uint32_t f = t.w[1][k];
    int r = 0;
    for (int j = 0; j < na; ++j) {
      const uint32_t g = t.w[1][j];
      r += g < f || (g == f && j < k);
    }
    t.lw[r] = f;
    t.ls[r] = t.src[k];
  }
  __syncwarp();
  for (int k = lane; k < na; k += 32) {   // level 0: the leaves
    t.w[0][k] = t.lw[k];
    pool[k] = t.ls[k];
    t.off[0][k] = static_cast<uint16_t>(k);
  }
  if (lane == 0) t.off[0][na] = static_cast<uint16_t>(na);
  __syncwarp();
  int m = na, cur = 0;
  for (int level = 1; level < LIMIT; ++level) {
    const int np = m / 2, mm = na + np, nxt = cur ^ 1;
    const uint32_t* w = t.w[cur];
    const uint16_t* off = t.off[cur];
    auto pw = [&](int j) { return w[2 * j] + w[2 * j + 1]; };
    const int total = na + off[2 * np];   // the new level's symbols
    for (int k = lane; k < (total + 31) / 32; k += 32) t.starts[k] = 0;
    for (int k = lane; k < mm; k += 32) {
      uint32_t wk;
      int r, len, from;
      if (k < na) {   // leaf k: the leaves before it, the packages below it
        wk = t.lw[k];
        const int s = t.ls[k];
        int q = partition_point(0, np, [&](int j) { return pw(j) < wk; });
        r = k + q;
        for (; q < np && pw(q) == wk; ++q) r += pool[off[2 * q]] < s;
        len = 1;
        from = s | LEAF;
      } else {        // package j: its pair's tuples, a slice of the pool
        const int j = k - na;
        wk = pw(j);
        from = off[2 * j];
        len = off[2 * j + 2] - from;
        const int t0 = pool[from];
        const int llo =
            partition_point(0, na, [&](int i) { return t.lw[i] < wk; });
        r = partition_point(llo, na, [&](int i) {
          return t.lw[i] == wk && t.ls[i] <= t0;
        });
        // the packages below it: those before its run of equal weight
        // (the packages' weights do not fall), searched only where the
        // package before it has its weight
        int q = j;
        if (q > 0 && pw(q - 1) == wk)
          q = partition_point(0, q - 1, [&](int i) { return pw(i) < wk; });
        r += q;
        for (; q < np && pw(q) == wk; ++q) {
          if (q == j) continue;
          const int b0 = off[2 * q];
          const int c = tuple_cmp(pool, b0, off[2 * q + 2] - b0, from, len);
          r += c < 0 || (c == 0 && q < j);
        }
      }
      t.w[nxt][r] = wk;
      t.src[r] = static_cast<uint16_t>(from);
      t.off[nxt][r + 1] = static_cast<uint16_t>(len);
    }
    __syncwarp();
    // the offsets, a scan of the lengths; a bit where each tuple starts
    int base = 0;
    for (int k0 = 0; k0 < mm; k0 += 32) {
      const int k = k0 + lane;
      const int len = k < mm ? t.off[nxt][k + 1] : 0;
      int incl = len;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += y;
      }
      if (k < mm) {
        const int at = base + incl - len;
        t.off[nxt][k + 1] = static_cast<uint16_t>(base + incl);
        atomicOr(&t.starts[at >> 5], 1u << (at & 31));
      }
      base += __shfl_sync(FULL, incl, 31);
    }
    if (lane == 0) t.off[nxt][0] = 0;
    __syncwarp();
    // the new pool: symbol q of the item whose tuple starts last at or
    // before q
    int seen = -1;
    for (int q0 = 0; q0 < total; q0 += 32) {
      const unsigned bits = t.starts[q0 >> 5];
      const int q = q0 + lane;
      if (q < total) {
        const int r = seen + __popc(bits & ((2u << lane) - 1));
        const int v = t.src[r];
        build[q] = v & LEAF ? static_cast<uint16_t>(v & ~LEAF)
                            : pool[v + q - t.off[nxt][r]];
      }
      seen += __popc(bits);
    }
    __syncwarp();
    // into the pool, two symbols a word, COPY_BATCH words a lane loaded
    // at once (the scratch's round trip is one latency a batch)
    const uint32_t* from = reinterpret_cast<const uint32_t*>(build);
    uint32_t* to = reinterpret_cast<uint32_t*>(pool);
    const int words = (total + 1) / 2;
    for (int q0 = lane; q0 < words; q0 += 32 * COPY_BATCH) {
      uint32_t v[COPY_BATCH];
#pragma unroll
      for (int j = 0; j < COPY_BATCH; ++j) {
        const int q = q0 + 32 * j;
        v[j] = q < words ? from[q] : 0;
      }
#pragma unroll
      for (int j = 0; j < COPY_BATCH; ++j)
        if (q0 + 32 * j < words) to[q0 + 32 * j] = v[j];
    }
    __syncwarp();
    m = mm;
    cur = nxt;
  }
  // each symbol's length: its count in the first 2n - 2 items' tuples
  const int end = t.off[cur][min(2 * na - 2, m)];
  for (int s = lane; s < NSYM; s += 32) freq[s] = 0;
  __syncwarp();
  for (int q = lane; q < end; q += 32) atomicAdd(&freq[pool[q]], 1u);
  __syncwarp();
  for (int s = lane; s < NSYM; s += 32)
    lens[s] = static_cast<uint8_t>(freq[s]);
  __syncwarp();
}

// Canonical codes, bit-reversed for LSB-first emission (canon_codes), by a
// warp: a symbol's code is its length's first code plus the symbols of its
// length before it (__match_any_sync and a running count a length); cnt
// and next are the warp's 16 ints each of shared memory.
__device__ __forceinline__ void canon_codes(const uint8_t* lens, int n,
                                            uint16_t* codes, int* cnt,
                                            int* next, int lane) {
  const unsigned below = (1u << lane) - 1;
  if (lane < 16) cnt[lane] = 0;
  __syncwarp();
  for (int s = lane; s < n; s += 32)
    if (lens[s]) atomicAdd(&cnt[lens[s]], 1);
  __syncwarp();
  if (lane == 0) {
    int code = 0;
    for (int l = 1; l < 16; ++l) {
      code = (code + cnt[l - 1]) << 1;   // cnt[0] stays 0
      next[l] = code;
    }
  }
  __syncwarp();
  for (int c0 = 0; c0 < n; c0 += 32) {
    const int s = c0 + lane;
    const int l = s < n ? lens[s] : 0;
    const unsigned group = __match_any_sync(FULL, l);
    const int rank = __popc(group & below);
    if (s < n)
      codes[s] = l ? static_cast<uint16_t>(
                         __brev(static_cast<uint32_t>(next[l] + rank)) >>
                         (32 - l))
                   : 0;
    __syncwarp();
    if (l && rank == 0) next[l] += __popc(group);
    __syncwarp();
  }
}

// One run of v in the code-length sequence, r long, as the C++ codes it
// (:1496-1528): with WRITE its symbols and extra values from out on, and
// their counts into freq; returns how many.
template <bool WRITE>
__device__ __forceinline__ int run_codes(int v, int r, uint8_t* sym,
                                         uint8_t* extra, uint32_t* freq,
                                         int out) {
  int c = 0;
  auto put = [&](int s, int e) {
    if (WRITE) {
      sym[out + c] = static_cast<uint8_t>(s);
      extra[out + c] = static_cast<uint8_t>(e);
      atomicAdd(&freq[s], 1u);
    }
    ++c;
  };
  if (v == 0) {
    while (r >= 3) {
      const int take = min(r, 138);
      put(take >= 11 ? 18 : 17, take - (take >= 11 ? 11 : 3));
      r -= take;
    }
  } else {
    put(v, 0);
    --r;
    while (r >= 3) {
      const int take = min(r, 6);
      put(16, take - 3);
      r -= take;
    }
  }
  for (; r > 0; --r) put(v, 0);
  return c;
}

constexpr int LIT_LV = LV;         // literal/length levels' items, at most
constexpr int DIST_LV = 64;        // distance levels' (30 + 29)
constexpr int CL_LV = 40;          // code-length levels' (19 + 18)
constexpr int HDR_WORDS = 144;     // a dynamic header's bits, at most 4,498

// A tables CTA's shared memory.  TUPLE: the rule's order; COUNTED: the
// histograms come from the row's record (deflate_hist_kernel's counts),
// as Counted<> says: the device rule's rows and rows past lz4s::STAGE_MAX
// bytes.
struct TableShared {   // the C++ rule's (std::sort on the weight)
  static constexpr bool TUPLE = false;
  static constexpr bool COUNTED = false;
  uint32_t lfreq[288];
  uint32_t dfreq[32];
  uint32_t clfreq[20];
  uint16_t codes[320];
  uint8_t lens[320];               // literal/length 0..287, distance at 288..
  Tree<286, LIT_LV> lit;
  Tree<30, DIST_LV> dist;
  Tree<19, CL_LV> cl;
  uint16_t dlv[15 * DIST_LV];      // the distance levels' orders
  uint16_t cllv[7 * CL_LV];        // the code-length levels'
  uint16_t runs[320];              // the run starts of the length sequence
  uint8_t clsym[320];
  uint8_t clextra[320];
  uint8_t cllen[20];
  uint16_t clcode[20];
  int cnt[2][16], next[2][16];     // canon_codes' of each warp
  uint32_t hdr[HDR_WORDS];         // the header's bits
};

// u16 a pool of each tree (even: the pools are copied a word at a time)
constexpr int LIT_POOL = 15 * 286;
constexpr int DIST_POOL = 15 * 30;
constexpr int CL_POOL = 7 * 19 + 1;
static_assert(LIT_POOL * 2 <= REC_CODES, "its next level fits the scratch");

struct TupleShared {   // the device rule's (the tuple order)
  static constexpr bool TUPLE = true;
  static constexpr bool COUNTED = false;
  uint32_t lfreq[288];
  uint32_t dfreq[32];
  uint32_t clfreq[20];
  uint16_t codes[320];
  uint8_t lens[320];               // literal/length 0..287, distance at 288..
  TupleTree<286, LIT_LV, LIT_POOL> lit;   // its next level in the scratch
  TupleTree<30, DIST_LV, DIST_POOL> dist;
  TupleTree<19, CL_LV, CL_POOL> cl;
  alignas(4) uint16_t lpool[LIT_POOL];
  alignas(4) uint16_t dpool[2 * DIST_POOL];   // the pool, then the next's
  alignas(4) uint16_t clpool[2 * CL_POOL];
  uint16_t runs[320];              // the run starts of the length sequence
  uint8_t clsym[320];
  uint8_t clextra[320];
  uint8_t cllen[20];
  uint16_t clcode[20];
  int cnt[2][16], next[2][16];     // canon_codes' of each warp
  uint32_t hdr[HDR_WORDS];         // the header's bits
};

template <class Shared>
struct Counted : Shared {
  static constexpr bool COUNTED = true;
};

// OR the low `bits` bits of v (bits <= 32) into words at bit pos
// (nwords of them: bits past them are dropped).
__device__ __forceinline__ void put(uint32_t* words, int nwords, int pos,
                                    uint32_t v, int bits) {
  if (!bits) return;
  const int w = pos >> 5, sh = pos & 31;
  if (w < nwords) atomicOr(words + w, v << sh);
  if (sh + bits > 32 && w + 1 < nwords) atomicOr(words + w + 1, v >> (32 - sh));
}

// Warp 0 of a dynamic block, after the trees: hlit and hdist, the lengths
// run-length coded (a lane a run), the code-length tree (in the order of
// sh's rule, Shared::TUPLE), its codes, hclen,
// and the header's bits into sh.hdr (a lane a field, offsets by a scan)
// and on to dst; returns the header's bits.
template <class Shared>
__device__ __forceinline__ int dynamic_header(Shared& sh, uint8_t* dst,
                                              int lane) {
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
      c = run_codes<false>(v, r, nullptr, nullptr, nullptr, 0);
    }
    int incl = c;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += y;
    }
    if (j < nrun)
      run_codes<true>(v, r, sh.clsym, sh.clextra, sh.clfreq, ncl + incl - c);
    ncl += __shfl_sync(FULL, incl, 31);
  }
  __syncwarp();
  if constexpr (Shared::TUPLE)
    tuple_merge<19, CL_LV, CL_POOL, 7>(sh.clfreq, sh.cllen, sh.cl, sh.clpool,
                                       sh.clpool + CL_POOL, lane);
  else
    package_merge<19, CL_LV, 7>(sh.clfreq, sh.cllen, sh.cl, sh.cllv, lane);
  one_code(sh.cllen, 19, lane);
  canon_codes(sh.cllen, 19, sh.clcode, sh.cnt[0], sh.next[0], lane);
  int hclen = 19;
  while (hclen > 4 && sh.cllen[kOrder[hclen - 1]] == 0) --hclen;
  // fields: the 17 bits of BFINAL, BTYPE, hlit, hdist and hclen; hclen
  // lengths of 3 bits; a code and its extra bits a symbol
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
    put(sh.hdr, HDR_WORDS, base + incl - bits, v, bits);
    base += __shfl_sync(FULL, incl, 31);
  }
  __syncwarp();
  const uint8_t* bytes = reinterpret_cast<const uint8_t*>(sh.hdr);
  for (int k = lane; k < (base + 7) / 8; k += 32) dst[k] = bytes[k];
  return base;
}

// The tables of a block of two warps a row, package-merge's levels in the
// C++ rule's order (std::sort on the weight; Shared TableShared) or in the
// device rule's (the tuple order, the literal/length tree's next level
// built in the row's scratch; TupleShared); the histograms counted here,
// or (Counted<>) read from the row's record, where deflate_hist_kernel
// counted them.  The rule and the counts are picked by `if constexpr` on
// Shared::TUPLE and Shared::COUNTED, so the C++ rule's row instance keeps
// its SASS.
template <class Shared>
__global__ void __launch_bounds__(TABLE_THREADS)
deflate_tables_kernel(const int32_t* __restrict__ tokens,
                      const int32_t* __restrict__ ntok, int n, int mode,
                      uint8_t* __restrict__ comp, int pitch,
                      uint8_t* __restrict__ scratch) {
  __shared__ Shared sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.x;
  uint8_t* rec = scratch + static_cast<size_t>(row) * SCRATCH_BYTES;
  uint8_t* dst = comp + static_cast<size_t>(row) * pitch;
  uint8_t* llen = sh.lens;
  uint8_t* dlen = sh.lens + 288;
  for (int k = tid; k < 320; k += TABLE_THREADS) {
    sh.lens[k] = 0;
    sh.codes[k] = 0;
    if (k < 288) sh.lfreq[k] = 0;
    if (k < 32) sh.dfreq[k] = 0;
  }
  for (int k = tid; k < HDR_WORDS; k += TABLE_THREADS) sh.hdr[k] = 0;
  __syncthreads();
  if (mode == 1) {
    if (warp == 0) {
      for (int s = lane; s < 288; s += 32)
        llen[s] = s < 144 ? 8 : s < 256 ? 9 : s < 280 ? 7 : 8;
      if (lane < 30) dlen[lane] = 5;
      __syncwarp();
      canon_codes(llen, 288, sh.codes, sh.cnt[0], sh.next[0], lane);
      canon_codes(dlen, 30, sh.codes + 288, sh.cnt[0], sh.next[0], lane);
      if (lane == 0) {
        dst[0] = 1 | 1 << 1;   // BFINAL, fixed
        *reinterpret_cast<int32_t*>(rec + REC_HBITS) = 3;
      }
    }
  } else {
    if constexpr (Shared::COUNTED) {
      const uint32_t* f = reinterpret_cast<const uint32_t*>(rec + REC_FREQ);
      for (int k = tid; k < 320; k += TABLE_THREADS) {
        if (k < 288)
          sh.lfreq[k] = f[k];
        else
          sh.dfreq[k - 288] = f[k];
      }
    } else {
      // the histograms: HIST_BATCH tokens a thread loaded at once, then
      // counted by shared-memory atomics
      const int32_t* tok = tokens + static_cast<size_t>(row) * n;
      const int nt = ntok[row];
      for (int t0 = 0; t0 < nt; t0 += TABLE_THREADS * HIST_BATCH) {
        int v[HIST_BATCH];
#pragma unroll
        for (int j = 0; j < HIST_BATCH; ++j) {
          const int t = t0 + j * TABLE_THREADS + tid;
          v[j] = t < nt ? tok[t] : -1;   // a token is never negative
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
    }
    __syncthreads();
    if (tid == 0) sh.lfreq[256] = 1;   // EOB
    __syncthreads();
    // the two trees side by side; the literal tree's levels' orders (or
    // next levels) in the row's scratch, the distance tree's in shared
    // memory
    if constexpr (Shared::TUPLE) {
      if (warp == 0)
        tuple_merge<286, LIT_LV, LIT_POOL, 15>(
            sh.lfreq, llen, sh.lit, sh.lpool,
            reinterpret_cast<uint16_t*>(rec), lane);
      else
        tuple_merge<30, DIST_LV, DIST_POOL, 15>(sh.dfreq, dlen, sh.dist,
                                                sh.dpool,
                                                sh.dpool + DIST_POOL, lane);
    } else {
      if (warp == 0)
        package_merge<286, LIT_LV, 15>(sh.lfreq, llen, sh.lit,
                                       reinterpret_cast<uint16_t*>(rec), lane);
      else
        package_merge<30, DIST_LV, 15>(sh.dfreq, dlen, sh.dist, sh.dlv, lane);
    }
    __syncthreads();
    if (warp == 0) {
      one_code(llen, 286, lane);
      if (!__any_sync(FULL, lane < 30 && dlen[lane]) && lane == 0)
        dlen[0] = 1;
    }
    __syncthreads();
    if (warp == 1) {
      canon_codes(llen, 286, sh.codes, sh.cnt[1], sh.next[1], lane);
      canon_codes(dlen, 30, sh.codes + 288, sh.cnt[1], sh.next[1], lane);
    } else {
      const int hbits = dynamic_header(sh, dst, lane);
      if (lane == 0) *reinterpret_cast<int32_t*>(rec + REC_HBITS) = hbits;
    }
  }
  __syncthreads();
  uint16_t* codes = reinterpret_cast<uint16_t*>(rec + REC_CODES);
  for (int k = tid; k < 320; k += TABLE_THREADS) {
    codes[k] = sh.codes[k];
    rec[REC_LENS + k] = sh.lens[k];
  }
}

// A fragment's end (deflate_impl with final_flag 0, tpz_deflate_fragment,
// tpuzip_host.cpp:1444-1450, :1572-1580): BFINAL, bit 0 of the stream
// (bit `skip` of its first word), cleared; after the EOB, which ends at
// bit `end` of the words, the 3 bits of an empty stored block's header
// (0), the byte boundary, LEN 0 and NLEN 0xFFFF.  The row (dst, its
// first byte) is zero past the EOB (the caller zeroed comp), so only the
// NLEN bytes are written.  Returns the row's length, or -1 past cap.
__device__ __forceinline__ int fragment_end(uint32_t* words, int skip,
                                            int end, uint8_t* dst, int cap) {
  atomicAnd(words, ~(1u << skip));
  const int bytes = (end - skip + 3 + 7) / 8;
  if (bytes + 4 > cap) return -1;
  dst[bytes + 2] = 0xFF;
  dst[bytes + 3] = 0xFF;
  return bytes + 4;
}

// The row emit; FRAGMENT (picked by `if constexpr`, so the stream's
// instance keeps its SASS) ends the row as a fragment.
template <bool FRAGMENT>
__global__ void __launch_bounds__(EMIT_THREADS)
deflate_emit_kernel(const int32_t* __restrict__ tokens,
                    const int32_t* __restrict__ ntok, int n,
                    uint8_t* __restrict__ comp, int pitch, int cap,
                    int32_t* __restrict__ clens,
                    const uint8_t* __restrict__ scratch) {
  __shared__ uint16_t codes[320];
  __shared__ uint8_t lens[320];
  __shared__ int warp_sums[EMIT_THREADS / 32];
  const int row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the row from the aligned word that holds its first byte: bit offsets
  // count from that word
  const uintptr_t at =
      reinterpret_cast<uintptr_t>(comp + static_cast<size_t>(row) * pitch);
  uint32_t* words = reinterpret_cast<uint32_t*>(at & ~uintptr_t{3});
  const int skip = static_cast<int>(at & 3) * 8;
  const int nwords = (skip / 8 + cap + 3) / 4;
  const uint8_t* rec = scratch + static_cast<size_t>(row) * SCRATCH_BYTES;
  for (int k = tid; k < 320; k += EMIT_THREADS) {
    codes[k] = reinterpret_cast<const uint16_t*>(rec + REC_CODES)[k];
    lens[k] = rec[REC_LENS + k];
  }
  __syncthreads();
  const int32_t* tok = tokens + static_cast<size_t>(row) * n;
  const int nt = ntok[row];
  int base = skip + *reinterpret_cast<const int32_t*>(rec + REC_HBITS);
  for (int from = 0; from < nt; from += EMIT_THREADS) {
    const int t = from + tid;
    uint32_t f1 = 0, f2 = 0;
    int n1 = 0, n2 = 0;
    if (t < nt) {
      const int v = tok[t];
      if (v < 256) {
        f1 = codes[v];
        n1 = lens[v];
      } else {
        const int l = v >> 16, d = v & 0xFFFF;
        const int lc = len_code(l), dc = dist_code(d);
        const int ll = lens[257 + lc], dl = lens[288 + dc];
        f1 = codes[257 + lc] | static_cast<uint32_t>(l - kLenBase[lc]) << ll;
        n1 = ll + kLenEb[lc];
        f2 = codes[288 + dc] | static_cast<uint32_t>(d - kDistBase[dc]) << dl;
        n2 = dl + kDistEb[dc];
      }
    }
    // exclusive scan of the tokens' bit counts over the block
    const int nb = n1 + n2;
    int incl = nb;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    int before = 0, total = 0;
    for (int k = 0; k < EMIT_THREADS / 32; ++k) {
      before += k < warp ? warp_sums[k] : 0;
      total += warp_sums[k];
    }
    const int pos = base + before + incl - nb;
    put(words, nwords, pos, f1, n1);
    put(words, nwords, pos + n1, f2, n2);
    base += total;
    __syncthreads();   // warp_sums read before the next chunk's writes
  }
  if (tid == 0) {
    put(words, nwords, base, codes[256], lens[256]);   // EOB
    if constexpr (FRAGMENT) {
      clens[row] = fragment_end(words, skip, base + lens[256],
                                reinterpret_cast<uint8_t*>(at), cap);
    } else {
      const int bytes = (base - skip + lens[256] + 7) / 8;
      clens[row] = bytes <= cap ? bytes : -1;
    }
  }
}

// ---------------------------------------------------------------- tiles
// The histograms of the device rule's rows and of rows past
// lz4s::STAGE_MAX bytes, and the bits of the latter (one 8 MiB zlib row is
// 1.8 M tokens): a row's tokens cut into tiles of TOKEN_TILE, a CTA a
// tile, so that one row fills the card.  Launches over B x tiles CTAs
// (tiles = ceil(n / TOKEN_TILE), the most a row can hold); a tile past
// its row's tokens exits at once.

// A tile's row, its first token and its tokens; false past the row's.
__device__ __forceinline__ bool token_tile(const int32_t* ntok, int tiles,
                                           int& row, int& from, int& count) {
  row = blockIdx.x / tiles;
  from = (blockIdx.x - row * tiles) * TOKEN_TILE;
  count = min(TOKEN_TILE, ntok[row] - from);
  return count > 0;
}

// The histograms of a tile: each warp counts into its own copy in shared
// memory (the hot bins of a text contend within a warp, not across them),
// then the copies' sums go once into the row's counts in its record
// (REC_FREQ, zeroed by the caller; literal/length 0..287, distance at
// 288..).
__global__ void __launch_bounds__(TILE_THREADS)
deflate_hist_kernel(const int32_t* __restrict__ tokens,
                    const int32_t* __restrict__ ntok, int n, int tiles,
                    uint8_t* __restrict__ scratch) {
  __shared__ uint32_t hist[TILE_THREADS / 32][320];
  int row, from, count;
  if (!token_tile(ntok, tiles, row, from, count)) return;
  const int tid = threadIdx.x;
  uint32_t* h = hist[tid >> 5];
  for (int k = tid; k < (TILE_THREADS / 32) * 320; k += TILE_THREADS)
    (&hist[0][0])[k] = 0;
  const int32_t* tok = tokens + static_cast<size_t>(row) * n + from;
  int v[TILE_RUN];
#pragma unroll
  for (int j = 0; j < TILE_RUN; ++j) {
    const int t = j * TILE_THREADS + tid;
    v[j] = t < count ? tok[t] : -1;   // a token is never negative
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < TILE_RUN; ++j) {
    if (v[j] < 0) continue;
    if (v[j] < 256) {
      atomicAdd(&h[v[j]], 1u);
    } else {
      atomicAdd(&h[257 + len_code(v[j] >> 16)], 1u);
      atomicAdd(&h[288 + dist_code(v[j] & 0xFFFF)], 1u);
    }
  }
  __syncthreads();
  uint32_t* freq = reinterpret_cast<uint32_t*>(
      scratch + static_cast<size_t>(row) * SCRATCH_BYTES + REC_FREQ);
  for (int k = tid; k < 320; k += TILE_THREADS) {
    uint32_t sum = 0;
#pragma unroll
    for (int w = 0; w < TILE_THREADS / 32; ++w) sum += hist[w][k];
    if (sum) atomicAdd(freq + k, sum);
  }
}

// A token's fields from the row's codes and lengths (in shared memory):
// (f1, n1) the literal or the length code with its extra bits, (f2, n2)
// the distance's (n2 0 for a literal).
__device__ __forceinline__ void token_fields(int v, const uint16_t* codes,
                                             const uint8_t* lens,
                                             uint32_t& f1, int& n1,
                                             uint32_t& f2, int& n2) {
  if (v < 256) {
    f1 = codes[v];
    n1 = lens[v];
    f2 = 0;
    n2 = 0;
  } else {
    const int l = v >> 16, d = v & 0xFFFF;
    const int lc = len_code(l), dc = dist_code(d);
    const int ll = lens[257 + lc], dl = lens[288 + dc];
    f1 = codes[257 + lc] | static_cast<uint32_t>(l - kLenBase[lc]) << ll;
    n1 = ll + kLenEb[lc];
    f2 = codes[288 + dc] | static_cast<uint32_t>(d - kDistBase[dc]) << dl;
    n2 = dl + kDistEb[dc];
  }
}

// Exclusive sum of v over the block (TILE_THREADS threads); total gets the
// whole.  warp_sums: TILE_THREADS / 32 ints of shared memory.  Ends with a
// barrier.
__device__ __forceinline__ int tile_scan(int v, int* warp_sums, int& total) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int k = 0; k < TILE_THREADS / 32; ++k) {
    before += k < warp ? warp_sums[k] : 0;
    total += warp_sums[k];
  }
  __syncthreads();
  return before + incl - v;
}

// The row's codes and lengths from its record into shared memory.
__device__ __forceinline__ void load_codes(const uint8_t* rec,
                                           uint16_t* codes, uint8_t* lens) {
  for (int k = threadIdx.x; k < 320; k += TILE_THREADS) {
    codes[k] = reinterpret_cast<const uint16_t*>(rec + REC_CODES)[k];
    lens[k] = rec[REC_LENS + k];
  }
  __syncthreads();
}

// Each tile's bits: thread t takes tokens t * TILE_RUN .. + TILE_RUN of
// the tile; the sum into firsts[row * tiles + tile].
__global__ void __launch_bounds__(TILE_THREADS)
deflate_emit_sums_kernel(const int32_t* __restrict__ tokens,
                         const int32_t* __restrict__ ntok, int n, int tiles,
                         const uint8_t* __restrict__ scratch,
                         int* __restrict__ firsts) {
  __shared__ uint16_t codes[320];
  __shared__ uint8_t lens[320];
  __shared__ int warp_sums[TILE_THREADS / 32];
  int row, from, count;
  if (!token_tile(ntok, tiles, row, from, count)) return;
  load_codes(scratch + static_cast<size_t>(row) * SCRATCH_BYTES, codes, lens);
  const int32_t* tok = tokens + static_cast<size_t>(row) * n + from;
  const int t0 = threadIdx.x * TILE_RUN;
  int bits = 0;
#pragma unroll
  for (int j = 0; j < TILE_RUN; ++j) {
    if (t0 + j < count) {
      uint32_t f1, f2;
      int n1, n2;
      token_fields(tok[t0 + j], codes, lens, f1, n1, f2, n2);
      bits += n1 + n2;
    }
  }
  int total;
  tile_scan(bits, warp_sums, total);
  if (threadIdx.x == 0) firsts[blockIdx.x] = total;
}

// A row's stream from the aligned word that holds its first byte: the
// words, their count, and the bit its header starts at.
struct RowWords {
  uint32_t* words;
  int nwords, skip;
  __device__ __forceinline__ RowWords(uint8_t* comp, int row, int pitch,
                                      int cap) {
    const uintptr_t at =
        reinterpret_cast<uintptr_t>(comp + static_cast<size_t>(row) * pitch);
    words = reinterpret_cast<uint32_t*>(at & ~uintptr_t{3});
    skip = static_cast<int>(at & 3) * 8;
    nwords = (skip / 8 + cap + 3) / 4;
  }
};

// A row's tile offsets, a block a row: the tiles' bits (firsts, from the
// sums kernel) become each tile's first bit, from the header's end on; then
// the EOB and the row's length in bytes (-1 past cap).
template <bool FRAGMENT>
__global__ void __launch_bounds__(SCAN_THREADS)
deflate_emit_scan_kernel(const int32_t* __restrict__ ntok, int tiles,
                         uint8_t* __restrict__ comp, int pitch, int cap,
                         int32_t* __restrict__ clens,
                         const uint8_t* __restrict__ scratch,
                         int* __restrict__ firsts) {
  static_assert(SCAN_THREADS == TILE_THREADS, "tile_scan's block");
  __shared__ int warp_sums[SCAN_THREADS / 32];
  const int row = blockIdx.x;
  const RowWords out(comp, row, pitch, cap);
  const uint8_t* rec = scratch + static_cast<size_t>(row) * SCRATCH_BYTES;
  const int nt = ntok[row];
  const int used = (nt + TOKEN_TILE - 1) / TOKEN_TILE;
  int* f = firsts + static_cast<size_t>(row) * tiles;
  int base = out.skip + *reinterpret_cast<const int32_t*>(rec + REC_HBITS);
  for (int k0 = 0; k0 < used; k0 += SCAN_THREADS) {
    const int k = k0 + threadIdx.x;
    const int bits = k < used ? f[k] : 0;
    int total;
    const int before = tile_scan(bits, warp_sums, total);
    if (k < used) f[k] = base + before;
    base += total;
  }
  if (threadIdx.x == 0) {
    const uint16_t eob =
        reinterpret_cast<const uint16_t*>(rec + REC_CODES)[256];
    const int eob_bits = rec[REC_LENS + 256];
    put(out.words, out.nwords, base, eob, eob_bits);
    if constexpr (FRAGMENT) {
      clens[row] = fragment_end(out.words, out.skip, base + eob_bits,
                                comp + static_cast<size_t>(row) * pitch, cap);
    } else {
      const int bytes = (base - out.skip + eob_bits + 7) / 8;
      clens[row] = bytes <= cap ? bytes : -1;
    }
  }
}

// Each tile's fields at its first bit: thread t's run of TILE_RUN tokens
// at its offset (a block scan of the runs' bits), its fields gathered in a
// 64-bit register and written a word at a time: the first word it touches
// and its last partial word by atomicOr (they may hold a neighbour's
// bits), the words between by a store.
__global__ void __launch_bounds__(TILE_THREADS)
deflate_emit_tiles_kernel(const int32_t* __restrict__ tokens,
                          const int32_t* __restrict__ ntok, int n, int tiles,
                          uint8_t* __restrict__ comp, int pitch, int cap,
                          const uint8_t* __restrict__ scratch,
                          const int* __restrict__ firsts) {
  __shared__ uint16_t codes[320];
  __shared__ uint8_t lens[320];
  __shared__ int warp_sums[TILE_THREADS / 32];
  int row, from, count;
  if (!token_tile(ntok, tiles, row, from, count)) return;
  load_codes(scratch + static_cast<size_t>(row) * SCRATCH_BYTES, codes, lens);
  const RowWords out(comp, row, pitch, cap);
  const int32_t* tok = tokens + static_cast<size_t>(row) * n + from;
  const int t0 = threadIdx.x * TILE_RUN;
  int v[TILE_RUN];
  int bits = 0;
#pragma unroll
  for (int j = 0; j < TILE_RUN; ++j) {
    v[j] = t0 + j < count ? tok[t0 + j] : -1;
    if (v[j] >= 0) {
      uint32_t f1, f2;
      int n1, n2;
      token_fields(v[j], codes, lens, f1, n1, f2, n2);
      bits += n1 + n2;
    }
  }
  int total;
  const int pos = firsts[blockIdx.x] + tile_scan(bits, warp_sums, total);
  if (bits == 0) return;
  int w = pos >> 5, fill = pos & 31;
  unsigned long long acc = 0;
  bool first = true;
  auto field = [&](uint32_t f, int nb) {
    acc |= static_cast<unsigned long long>(f) << fill;
    fill += nb;
    if (fill >= 32) {
      if (w < out.nwords) {
        if (first)
          atomicOr(out.words + w, static_cast<uint32_t>(acc));
        else
          out.words[w] = static_cast<uint32_t>(acc);
      }
      first = false;
      acc >>= 32;
      fill -= 32;
      ++w;
    }
  };
#pragma unroll
  for (int j = 0; j < TILE_RUN; ++j) {
    if (v[j] < 0) continue;
    uint32_t f1, f2;
    int n1, n2;
    token_fields(v[j], codes, lens, f1, n1, f2, n2);
    field(f1, n1);
    field(f2, n2);
  }
  if (fill && w < out.nwords)
    atomicOr(out.words + w, static_cast<uint32_t>(acc));
}

// Stored blocks (deflate_impl's mode 2): [BFINAL][LEN][NLEN][bytes] each;
// BFINAL never set in a FRAGMENT, which needs no sync block after them.
template <bool FRAGMENT>
__global__ void __launch_bounds__(EMIT_THREADS)
deflate_stored_kernel(const uint8_t* __restrict__ blocks,
                      const int32_t* __restrict__ lengths, int n,
                      uint8_t* __restrict__ comp, int pitch,
                      int32_t* __restrict__ clens) {
  const int row = blockIdx.x;
  const uint8_t* src = blocks + static_cast<size_t>(row) * n;
  uint8_t* dst = comp + static_cast<size_t>(row) * pitch;
  const int len = min(max(lengths[row], 0), n);
  const int nblk = max(1, (len + STORED_MAX - 1) / STORED_MAX);
  const int total = len + 5 * nblk;
  for (int j = threadIdx.x; j < total; j += EMIT_THREADS) {
    const int k = j / (STORED_MAX + 5), r = j - k * (STORED_MAX + 5);
    uint8_t byte;
    if (r >= 5) {
      byte = src[k * STORED_MAX + r - 5];
    } else {
      const int take = min(STORED_MAX, len - k * STORED_MAX);
      const uint32_t field = r == 0 ? (!FRAGMENT && k == nblk - 1)
                                    : (r < 3 ? take : ~take) >> (r & 1 ? 0 : 8);
      byte = static_cast<uint8_t>(field);
    }
    dst[j] = byte;
  }
  if (threadIdx.x == 0) clens[row] = total;
}

}  // namespace

// links on the shared route: blocks (B, n) u8 and lengths (B,) i32 in,
// prev (B, n) i32 out, every entry written; n <= 65536.  Sets the kernel's
// dynamic shared memory, launches as many CTAs of SPLIT_CLASSES warps as
// fit the card at once (at most B), each walking rows, on `stream`, and
// returns the first CUDA error.
extern "C" int tpz_deflate_links_shared(const void* blocks,
                                        const void* lengths, int B, int n,
                                        void* prev, void* stream) {
  if (n > lz4s::STAGE_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 32 * lz4s::SPLIT_CLASSES;
  const int smem = lz4s::QUEUE_BYTES + lz4s::table_bytes(HASH_BITS);
  int grid = 0;
  const cudaError_t err = lz4s::persistent_grid(
      reinterpret_cast<const void*>(deflate_links_shared_kernel), threads,
      smem, B, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  deflate_links_shared_kernel<<<grid, threads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(blocks),
      static_cast<const int32_t*>(lengths), B, n,
      static_cast<int32_t*>(prev));
  return static_cast<int>(cudaGetLastError());
}

// links on the tiled route (lz4_shared.cuh's links_tiled_kernel and
// links_carry_kernel under Key3 at 15 bits): blocks (B, n) u8 and lengths
// (B,) i32 in, prev (B, n) i32 out, every entry written; scratch: 2 x B x
// ceil(n / LINK_TILE) x 2^15 u16 (tpz_deflate_links_tiled_scratch bytes),
// the tiles' tables then their first positions.  Launches as many CTAs of
// SPLIT_CLASSES warps as fit the card at once (at most the tiles), each
// walking tiles, then the carry kernel (a thread a hash of a row), on
// `stream`; returns the first CUDA error.
extern "C" int tpz_deflate_links_tiled(const void* blocks,
                                       const void* lengths, int B, int n,
                                       void* prev, void* scratch,
                                       void* stream) {
  return static_cast<int>(
      lz4s::launch_links_tiled<Key3, MIN_MATCH - 1, HASH_BITS>(
          blocks, lengths, B, n, HASH_BITS, prev, scratch,
          static_cast<cudaStream_t>(stream)));
}

// Bytes of tpz_deflate_links_tiled's scratch for B rows of n bytes.
extern "C" long long tpz_deflate_links_tiled_scratch(int B, int n) {
  return lz4s::links_tiled_scratch(B, n, HASH_BITS);
}

// Bytes of tpz_deflate_parse_greedy's scratch for B rows of n bytes: the
// segments' maps, then their entries and first tokens.
extern "C" long long tpz_deflate_parse_scratch(int B, int n) {
  const long long segs =
      static_cast<long long>(B) * ((n + PARSE_SEG - 1) / PARSE_SEG);
  return segs * (MAP_STRIDE * sizeof(uint32_t) + sizeof(int2));
}

namespace {

// The best kernel on `stream`.
int launch_best(const void* blocks, const void* lengths, const void* prev,
                int B, int n, int max_chain, void* best_at,
                cudaStream_t s) {
  const long long grid =
      static_cast<long long>(B) * ((n + BEST_THREADS - 1) / BEST_THREADS);
  if (grid > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  if (grid > 0)
    deflate_best_kernel<<<static_cast<unsigned>(grid), BEST_THREADS, 0, s>>>(
        static_cast<const uint8_t*>(blocks),
        static_cast<const int32_t*>(lengths),
        static_cast<const int32_t*>(prev), n, max_chain,
        static_cast<int32_t*>(best_at));
  return static_cast<int>(cudaGetLastError());
}

// The greedy parse's three launches over best_at (the maps, the chain, the
// emit), on `stream`.
int launch_segments(const void* blocks, const void* lengths,
                    const void* best_at, int B, int n, void* tokens,
                    void* ntok, void* scratch, cudaStream_t s) {
  const int nseg = (n + PARSE_SEG - 1) / PARSE_SEG;
  const long long total = static_cast<long long>(B) * nseg;
  if (total == 0) return static_cast<int>(cudaSuccess);
  if ((total + EMIT_WARPS - 1) / EMIT_WARPS > 0x7FFFFFFF)
    return static_cast<int>(cudaErrorInvalidValue);
  uint32_t* maps = static_cast<uint32_t*>(scratch);
  int2* segs = reinterpret_cast<int2*>(maps + total * MAP_STRIDE);
  deflate_segment_maps_kernel<<<static_cast<unsigned>(
                                    (total + MAP_WARPS - 1) / MAP_WARPS),
                                32 * MAP_WARPS, 0, s>>>(
      static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(best_at), n, nseg, total, maps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // as many buffers as a whole row's chunks, at most MAP_BUFS
  const int bufs = min(MAP_BUFS, (nseg + MAP_CHUNK - 1) / MAP_CHUNK);
  const int smem = bufs * (MAP_CHUNK * MAP_STRIDE * sizeof(uint32_t) +
                           sizeof(uint64_t));
  err = cudaFuncSetAttribute(deflate_segment_chain_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  deflate_segment_chain_kernel<<<B, 32, smem, s>>>(
      static_cast<const int32_t*>(lengths), n, nseg, bufs, maps, segs,
      static_cast<int32_t*>(ntok));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  deflate_segment_emit_kernel<<<static_cast<unsigned>(
                                    (total + EMIT_WARPS - 1) / EMIT_WARPS),
                                32 * EMIT_WARPS, 0, s>>>(
      static_cast<const uint8_t*>(blocks),
      static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(best_at), n, nseg, total, segs,
      static_cast<int32_t*>(tokens));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// blocks (B, n) u8, lengths (B,) i32 and prev (B, n) i32 from
// tpz_deflate_links_shared or tpz_deflate_links_tiled in; max_chain >= 0
// links a walk; best_at (B, n) i32 scratch; tokens (B, n) i32, zeroed by
// the caller, and ntok (B,) i32 out.  Launches the best kernel (a thread a
// position), then the lazy parse kernel (B blocks of one warp), on
// `stream`; returns cudaGetLastError().
extern "C" int tpz_deflate_parse(const void* blocks, const void* lengths,
                                 const void* prev, int B, int n,
                                 int max_chain, void* tokens, void* ntok,
                                 void* best_at, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err =
      launch_best(blocks, lengths, prev, B, n, max_chain, best_at, s);
  if (err != cudaSuccess) return err;
  deflate_parse_kernel<<<B, 32, 0, s>>>(
      static_cast<const uint8_t*>(blocks),
      static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(best_at), n,
      static_cast<int32_t*>(tokens), static_cast<int32_t*>(ntok));
  return static_cast<int>(cudaGetLastError());
}

// tpuzip's device rule's greedy parse (at max_chain 1): the arguments and
// outputs of tpz_deflate_parse and scratch of tpz_deflate_parse_scratch
// bytes.  Launches the best kernel, then the segments' maps, chain and
// emit, on `stream`; returns the first CUDA error.
extern "C" int tpz_deflate_parse_greedy(const void* blocks,
                                        const void* lengths, const void* prev,
                                        int B, int n, int max_chain,
                                        void* tokens, void* ntok,
                                        void* best_at, void* scratch,
                                        void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err =
      launch_best(blocks, lengths, prev, B, n, max_chain, best_at, s);
  if (err != cudaSuccess) return err;
  return launch_segments(blocks, lengths, best_at, B, n, tokens, ntok,
                         scratch, s);
}

namespace {

// The tile CTAs of B rows of n tokens (B x ceil(n / TOKEN_TILE)), or -1
// past a grid's reach.
long long token_tiles(int B, int n) {
  const long long grid =
      static_cast<long long>(B) * ((n + TOKEN_TILE - 1) / TOKEN_TILE);
  return grid > 0x7FFFFFFF ? -1 : grid;
}

// The tables kernel in the order of the rule whose shared memory is Shared,
// then the emit, on `stream`.  The histograms: counted by the tables
// kernel itself on the C++ rule's rows of at most lz4s::STAGE_MAX bytes,
// else (the device rule, wider rows) by tiles (the counts zeroed, the
// tiled histograms in mode 0, then the tables kernel reading them,
// Counted<Shared>).  The bits: rows of at most lz4s::STAGE_MAX bytes by
// the row emit kernel (a block a row), wider ones by tiles: each tile's
// bits, each row's tile offsets with its EOB and length, each tile's
// fields.
template <class Shared, bool FRAGMENT>
int launch_emit(const void* tokens, const void* ntok, int B, int n, int mode,
                void* comp, int pitch, void* clens, void* scratch,
                cudaStream_t s) {
  const int32_t* tok = static_cast<const int32_t*>(tokens);
  const int32_t* nt = static_cast<const int32_t*>(ntok);
  uint8_t* out = static_cast<uint8_t*>(comp);
  uint8_t* rec = static_cast<uint8_t*>(scratch);
  const int cap = 2 * n + 4096;
  const bool wide = n > lz4s::STAGE_MAX;
  const long long grid = token_tiles(B, n);
  if (grid < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (n + TOKEN_TILE - 1) / TOKEN_TILE;
  cudaError_t err;
  if (Shared::TUPLE || wide) {
    if (mode == 0) {
      err = cudaMemset2DAsync(rec + REC_FREQ, SCRATCH_BYTES, 0,
                              320 * sizeof(uint32_t), B, s);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (grid > 0)
        deflate_hist_kernel<<<static_cast<unsigned>(grid), TILE_THREADS, 0,
                              s>>>(tok, nt, n, tiles, rec);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    deflate_tables_kernel<Counted<Shared>><<<B, TABLE_THREADS, 0, s>>>(
        tok, nt, n, mode, out, pitch, rec);
  } else if constexpr (!Shared::TUPLE) {
    deflate_tables_kernel<Shared><<<B, TABLE_THREADS, 0, s>>>(
        tok, nt, n, mode, out, pitch, rec);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!wide) {
    deflate_emit_kernel<FRAGMENT><<<B, EMIT_THREADS, 0, s>>>(
        tok, nt, n, out, pitch, cap, static_cast<int32_t*>(clens), rec);
    return static_cast<int>(cudaGetLastError());
  }
  int* firsts = reinterpret_cast<int*>(
      rec + static_cast<size_t>(B) * SCRATCH_BYTES);
  deflate_emit_sums_kernel<<<static_cast<unsigned>(grid), TILE_THREADS, 0,
                             s>>>(tok, nt, n, tiles, rec, firsts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  deflate_emit_scan_kernel<FRAGMENT><<<B, SCAN_THREADS, 0, s>>>(
      nt, tiles, out, pitch, cap, static_cast<int32_t*>(clens), rec, firsts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  deflate_emit_tiles_kernel<<<static_cast<unsigned>(grid), TILE_THREADS, 0,
                              s>>>(tok, nt, n, tiles, out, pitch, cap, rec,
                                   firsts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of tpz_deflate_emit's and tpz_deflate_emit_tuple's scratch for B
// rows of n bytes: SCRATCH_BYTES a row, and past lz4s::STAGE_MAX bytes an
// int a tile of TOKEN_TILE tokens.
extern "C" long long tpz_deflate_emit_scratch(int B, int n) {
  const long long rows = static_cast<long long>(B) * SCRATCH_BYTES;
  if (n <= lz4s::STAGE_MAX) return rows;
  return rows + static_cast<long long>(B) *
                    ((n + TOKEN_TILE - 1) / TOKEN_TILE) * sizeof(int);
}

namespace {

// The C++ rule's emit or stored blocks, as a stream or as a fragment.
template <bool FRAGMENT>
int launch_encode_emit(const void* blocks, const void* lengths,
                       const void* tokens, const void* ntok, int B, int n,
                       int mode, void* comp, int pitch, void* clens,
                       void* scratch, cudaStream_t s) {
  if (mode == 2) {
    deflate_stored_kernel<FRAGMENT><<<B, EMIT_THREADS, 0, s>>>(
        static_cast<const uint8_t*>(blocks),
        static_cast<const int32_t*>(lengths), n,
        static_cast<uint8_t*>(comp), pitch, static_cast<int32_t*>(clens));
    return static_cast<int>(cudaGetLastError());
  }
  return launch_emit<TableShared, FRAGMENT>(tokens, ntok, B, n, mode, comp,
                                            pitch, clens, scratch, s);
}

}  // namespace

// Mode 0 (dynamic) or 1 (fixed): tokens (B, n) i32 and ntok (B,) i32 from
// tpz_deflate_parse in, scratch of tpz_deflate_emit_scratch bytes; the
// tables kernel, then the emit (by rows, or by tiles past lz4s::STAGE_MAX
// bytes: launch_emit).  Mode 2 (stored): blocks (B, n) u8 and lengths
// (B,) i32 in, the stored kernel alone.  comp (B, pitch) u8, zeroed by the
// caller (pitch at least 2n + 4096), and clens (B,) i32 out (-1 past
// 2n + 4096).  Returns cudaGetLastError().
extern "C" int tpz_deflate_emit(const void* blocks, const void* lengths,
                                const void* tokens, const void* ntok, int B,
                                int n, int mode, void* comp, int pitch,
                                void* clens, void* scratch, void* stream) {
  return launch_encode_emit<false>(blocks, lengths, tokens, ntok, B, n, mode,
                                   comp, pitch, clens, scratch,
                                   static_cast<cudaStream_t>(stream));
}

// The fragment mode (tpz_deflate_fragment, tpuzip_host.cpp:1592-1604): as
// tpz_deflate_emit, but no block sets BFINAL and a dynamic or fixed row
// ends with an empty stored block, byte-aligned (00 00 FF FF after its 3
// header bits); a stored row writes no sync block.
extern "C" int tpz_deflate_emit_fragment(const void* blocks,
                                         const void* lengths,
                                         const void* tokens, const void* ntok,
                                         int B, int n, int mode, void* comp,
                                         int pitch, void* clens,
                                         void* scratch, void* stream) {
  return launch_encode_emit<true>(blocks, lengths, tokens, ntok, B, n, mode,
                                  comp, pitch, clens, scratch,
                                  static_cast<cudaStream_t>(stream));
}

// tpz_deflate_emit in mode 0 (dynamic) with the tables in tpuzip's device
// rule's order (the tuple order): the same arguments, scratch and outputs.
extern "C" int tpz_deflate_emit_tuple(const void* tokens, const void* ntok,
                                      int B, int n, void* comp, int pitch,
                                      void* clens, void* scratch,
                                      void* stream) {
  return launch_emit<TupleShared, false>(tokens, ntok, B, n, 0, comp, pitch,
                                         clens, scratch,
                                         static_cast<cudaStream_t>(stream));
}
