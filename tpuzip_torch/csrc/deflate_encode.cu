// deflate_encode.cu — tpuzip's deflate ENCODER (codec "deflate", id 5),
// in four kernels: links (8 warps a row, or one on rows past 64 KiB),
// parse one warp a row, tables one warp a row, emit one block a row (or,
// for stored blocks, the stored kernel alone).
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
//   - stored: blocks of at most 65535 raw bytes, BFINAL on the last.
//
// What bounds it on this card: not bytes but chains of dependent steps.  A
// probe walks its chain (each link a load of prev, then the candidate's
// bytes); the parse's next probe depends on the match it found; and
// package-merge sorts each level with std::sort, whose order of equal
// weights decides the code lengths: an introsort, serial by nature.
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
//     512 KiB a row (PERF.md §6, row 18); wider rows keep that form, 32
//     positions a warp step: lz4_chain.cu's keyed step (the lanes of one
//     hash grouped by __match_any_sync, a lane's link the highest earlier
//     lane of its group, else the keyed table's slot read before the step
//     writes it), copied with the 3-byte hash (open addressing on h, at
//     most half full);
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
//   - tables: the warp builds the histograms with shared-memory atomics;
//     lane 0 runs package-merge with a replica of libstdc++'s std::sort
//     (median of three to the first place, unguarded partition, threshold
//     16, final insertion sort, heap sort at depth 2 floor(log2 n)) on
//     (weight, node) items in shared memory, each level's order kept in
//     global scratch to mark the taken items level by level.  Only the
//     weights are compared, so the permutation is the C++'s;
//   - emit: a block of 256 threads a row; each token's bit count, a block
//     scan for its offset, and its fields OR-ed into the aligned 32-bit
//     words that hold the row (zeroed by the caller; a word shared with
//     the row before gets no bit of it).

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
constexpr uint32_t SLOT_MUL = 0x9E3779B1u;  // spreads h over keyed slots
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr unsigned long long EMPTY = ~0ull;  // a keyed slot's empty value

// package-merge items: a leaf s, or PKG + k for the k-th package
constexpr int PKG = 1 << 10;
constexpr int LV = 576;             // items a level holds, at most (286 + 285)
constexpr int THRESHOLD = 16;       // libstdc++'s _S_threshold
constexpr int TABLE_WARPS = 2;      // rows of a tables block
constexpr int EMIT_THREADS = 256;
constexpr int BEST_THREADS = 128;   // positions a best block

// a row's scratch (bytes): the levels' orders, then the record the emit
// kernel reads: codes (literal/length 0..287, distance at 288..319), their
// lengths, and the header's bits
constexpr int SCRATCH_BYTES = 20480;
constexpr int REC_CODES = 17408;
constexpr int REC_LENS = REC_CODES + 640;
constexpr int REC_HBITS = REC_LENS + 320;

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

// The keyed table's helpers (as in lz4_chain.cu).
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
deflate_links_kernel(const uint8_t* __restrict__ blocks,
                     const int32_t* __restrict__ lengths, int B, int n,
                     int32_t* __restrict__ prev,
                     unsigned long long* __restrict__ tables, int slots_log) {
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
    const int limit = max(len - 2, 0);
    const uint32_t salt = static_cast<uint32_t>(row) * SLOT_MUL;
    for (int base = 0; base < limit; base += 32) {
      const int p = base + lane;
      const bool live = p < limit;               // p + 2 < len: in the row
      const uint32_t v = live ? src[p] | (src[p + 1] << 8) |
                                    (uint32_t(src[p + 2]) << 16)
                              : 0u;
      const uint32_t h = (v * HASH_MUL) >> (32 - HASH_BITS);
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

// links on the shared route (n <= 65536), rows blockIdx.x, + gridDim.x,
// ...: a direct table of 2^15 u16 slots in shared memory (64 KiB, three
// CTAs an SM), lz4_shared.cuh's split_row over SPLIT_CLASSES warps under
// deflate's key (its hash is hash_bits of the 3 bytes at 15 bits), the row
// read through L1, 3 bytes a position, none past the row.
struct Key3 {
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
    // lazy matching: defer while the next position's match is longer
    while (at + 1 < limit) {
      if (at + 1 >= wbase + 32) window(at);
      const int next = __shfl_sync(FULL, best_l, at + 1 - wbase);
      if (next <= best) break;
      ++at;
      best = next;
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

// ---------------------------------------------------------------- sort

// libstdc++'s std::sort of (w, id) items ordered by w alone (bits/
// stl_algo.h, bits/stl_heap.h).  An explicit stack takes the recursion of
// __introsort_loop: its ranges are disjoint, so the order they are taken
// in does not change the result.
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

// __partial_sort(first, last, last): __make_heap, then __sort_heap.
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

__device__ void std_sort(const Items& a, int n) {
  if (n == 0) return;
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
        heap_sort(a, first, last);
        break;
      }
      --depth;
      // __move_median_to_first(first, first + 1, mid, last - 1)
      const int x = first + 1, y = first + (last - first) / 2, z = last - 1;
      int pick;
      if (a.w[x] < a.w[y])
        pick = a.w[y] < a.w[z] ? y : a.w[x] < a.w[z] ? z : x;
      else
        pick = a.w[x] < a.w[z] ? x : a.w[y] < a.w[z] ? z : y;
      a.swap(first, pick);
      // __unguarded_partition(first + 1, last, first)
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
  // __final_insertion_sort
  if (n > THRESHOLD) {
    insertion_sort(a, 0, THRESHOLD);
    for (int i = THRESHOLD; i < n; ++i) unguarded_linear_insert(a, i);
  } else {
    insertion_sort(a, 0, n);
  }
}

// ---------------------------------------------------------------- tables

struct Merge {
  Items items;              // the level being sorted (shared memory)
  unsigned long long* pk;   // the next level's package weights
  uint8_t* mark;            // taken flags of two levels, LV each
  uint16_t* lv;             // every level's order (global scratch)
};

// tpuzip's package_merge (tpuzip_host.cpp:1244-1271): code lengths of at
// most maxbits for the symbols with freq > 0 (a lone one gets 1).  Lane 0.
__device__ void package_merge(const uint32_t* freq, int n, int maxbits,
                              uint8_t* lens, const Merge& s) {
  int na = 0, only = 0;
  for (int k = 0; k < n; ++k) {
    lens[k] = 0;
    if (freq[k]) {
      ++na;
      only = k;
    }
  }
  if (na < 2) {
    if (na) lens[only] = 1;
    return;
  }
  int size[16];
  int m = 0;
  for (int level = 0; level < maxbits; ++level) {
    const int np = m / 2;
    for (int k = 0; k < np; ++k)
      s.pk[k] = s.items.w[2 * k] + s.items.w[2 * k + 1];
    int j = 0;
    for (int k = 0; k < n; ++k)
      if (freq[k]) {
        s.items.w[j] = freq[k];
        s.items.id[j++] = static_cast<uint16_t>(k);
      }
    for (int k = 0; k < np; ++k) {
      s.items.w[j] = s.pk[k];
      s.items.id[j++] = static_cast<uint16_t>(PKG + k);
    }
    m = size[level] = j;
    std_sort(s.items, m);
    for (int k = 0; k < m; ++k) s.lv[level * LV + k] = s.items.id[k];
  }
  uint8_t* cur = s.mark;
  uint8_t* below = s.mark + LV;
  const int take = min(2 * na - 2, m);
  for (int k = 0; k < m; ++k) cur[k] = k < take;
  for (int level = maxbits - 1; level >= 0; --level) {
    const int nb = level ? size[level - 1] : 0;
    for (int k = 0; k < nb; ++k) below[k] = 0;
    for (int k = 0; k < size[level]; ++k) {
      if (!cur[k]) continue;
      const int node = s.lv[level * LV + k];
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
}

// A table with one code gets a second: both of length 1 (:1474).
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

// Canonical codes, bit-reversed for LSB-first emission (canon_codes).
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

// LSB-first bits into a zeroed row, by one thread.
struct BitWr {
  uint8_t* p;
  int pos = 0;             // whole bytes written
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
  __device__ int flush() {   // the header's bits; its last byte written
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
  uint8_t lens[320];       // literal/length 0..287, distance at 288..
  uint8_t mark[2 * LV];
  uint8_t clsym[320];
  uint8_t clextra[320];
  uint8_t cllen[20];
  uint16_t clcode[20];
};

__global__ void __launch_bounds__(32 * TABLE_WARPS)
deflate_tables_kernel(const int32_t* __restrict__ tokens,
                      const int32_t* __restrict__ ntok, int B, int n,
                      int mode, uint8_t* __restrict__ comp, int pitch,
                      uint8_t* __restrict__ scratch) {
  __shared__ TableShared sh_all[TABLE_WARPS];
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * TABLE_WARPS + threadIdx.x / 32;
  if (row >= B) return;   // whole warps
  TableShared& sh = sh_all[threadIdx.x / 32];
  uint8_t* rec = scratch + static_cast<size_t>(row) * SCRATCH_BYTES;
  uint8_t* dst = comp + static_cast<size_t>(row) * pitch;
  uint8_t* llen = sh.lens;
  uint8_t* dlen = sh.lens + 288;
  for (int k = lane; k < 320; k += 32) {
    sh.lens[k] = 0;
    sh.codes[k] = 0;
    if (k < 288) sh.lfreq[k] = 0;
    if (k < 32) sh.dfreq[k] = 0;
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
        atomicAdd(&sh.lfreq[257 + len_code(v >> 16)], 1u);
        atomicAdd(&sh.dfreq[dist_code(v & 0xFFFF)], 1u);
      }
    }
  }
  __syncwarp();
  if (lane == 0) {
    BitWr bw{dst};
    if (mode == 1) {
      for (int s = 0; s < 288; ++s)
        llen[s] = s < 144 ? 8 : s < 256 ? 9 : s < 280 ? 7 : 8;
      for (int s = 0; s < 30; ++s) dlen[s] = 5;
      canon_codes(llen, 288, sh.codes);
      canon_codes(dlen, 30, sh.codes + 288);
      bw.bits(1, 1);   // BFINAL
      bw.bits(1, 2);   // fixed
    } else {
      const Merge s{{sh.w, sh.id}, sh.pk, sh.mark,
                    reinterpret_cast<uint16_t*>(rec)};
      sh.lfreq[256] = 1;   // EOB
      package_merge(sh.lfreq, 286, 15, llen, s);
      package_merge(sh.dfreq, 30, 15, dlen, s);
      one_code(llen, 286);
      int nd = 0;
      for (int k = 0; k < 30; ++k) nd += dlen[k] != 0;
      if (nd == 0) dlen[0] = 1;
      canon_codes(llen, 286, sh.codes);
      canon_codes(dlen, 30, sh.codes + 288);
      int hlit = 286, hdist = 30;
      while (hlit > 257 && llen[hlit - 1] == 0) --hlit;
      while (hdist > 1 && dlen[hdist - 1] == 0) --hdist;
      // the code-length sequence run-length coded (:1496-1528)
      const int nall = hlit + hdist;
      auto at = [&](int k) { return k < hlit ? llen[k] : dlen[k - hlit]; };
      uint32_t* clfreq = sh.lfreq;   // the histograms are spent
      for (int k = 0; k < 19; ++k) clfreq[k] = 0;
      int ncl = 0;
      for (int k = 0; k < nall;) {
        const int v = at(k);
        int run = 1;
        while (k + run < nall && at(k + run) == v) ++run;
        k += run;
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
      package_merge(clfreq, 19, 7, sh.cllen, s);
      one_code(sh.cllen, 19);
      canon_codes(sh.cllen, 19, sh.clcode);
      int hclen = 19;
      while (hclen > 4 && sh.cllen[kOrder[hclen - 1]] == 0) --hclen;
      bw.bits(1, 1);   // BFINAL
      bw.bits(2, 2);   // dynamic
      bw.bits(hlit - 257, 5);
      bw.bits(hdist - 1, 5);
      bw.bits(hclen - 4, 4);
      for (int k = 0; k < hclen; ++k) bw.bits(sh.cllen[kOrder[k]], 3);
      for (int k = 0; k < ncl; ++k) {
        const int sym = sh.clsym[k];
        bw.bits(sh.clcode[sym], sh.cllen[sym]);
        if (sym >= 16) bw.bits(sh.clextra[k], sym == 16 ? 2 : sym == 17 ? 3 : 7);
      }
    }
    *reinterpret_cast<int32_t*>(rec + REC_HBITS) = bw.flush();
  }
  __syncwarp();
  uint16_t* codes = reinterpret_cast<uint16_t*>(rec + REC_CODES);
  for (int k = lane; k < 320; k += 32) {
    codes[k] = sh.codes[k];
    rec[REC_LENS + k] = sh.lens[k];
  }
}

// OR the low `bits` bits of v (bits <= 32) into the row's words at bit pos.
__device__ __forceinline__ void put(uint32_t* words, int nwords, int pos,
                                    uint32_t v, int bits) {
  if (!bits) return;
  const int w = pos >> 5, sh = pos & 31;
  if (w < nwords) atomicOr(words + w, v << sh);
  if (sh + bits > 32 && w + 1 < nwords) atomicOr(words + w + 1, v >> (32 - sh));
}

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
    const int bytes = (base - skip + lens[256] + 7) / 8;
    clens[row] = bytes <= cap ? bytes : -1;
  }
}

// Stored blocks (deflate_impl's mode 2): [BFINAL][LEN][NLEN][bytes] each.
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
      const uint32_t field = r == 0 ? (k == nblk - 1)
                                    : (r < 3 ? take : ~take) >> (r & 1 ? 0 : 8);
      byte = static_cast<uint8_t>(field);
    }
    dst[j] = byte;
  }
  if (threadIdx.x == 0) clens[row] = total;
}

}  // namespace

// blocks (B, n) u8 and lengths (B,) i32 in; prev (B, n) i32 out, every
// entry written.  tables: ntab keyed tables of scratch (1 <= ntab <= B),
// each 2^slots_log slots of 8 bytes, 2^slots_log at least twice min(n,
// 2^15) and 6 <= slots_log <= 31.  Launches ntab blocks of one warp on
// `stream` and returns cudaGetLastError().
extern "C" int tpz_deflate_links(const void* blocks, const void* lengths,
                                 int B, int n, void* prev, void* tables,
                                 int ntab, int slots_log, void* stream) {
  deflate_links_kernel<<<ntab, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(blocks),
      static_cast<const int32_t*>(lengths), B, n, static_cast<int32_t*>(prev),
      static_cast<unsigned long long*>(tables), slots_log);
  return static_cast<int>(cudaGetLastError());
}

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

// blocks (B, n) u8, lengths (B,) i32 and prev (B, n) i32 from
// tpz_deflate_links or tpz_deflate_links_shared in; max_chain >= 0 links a walk; best_at (B, n) i32
// scratch; tokens (B, n) i32, zeroed by the caller, and ntok (B,) i32
// out.  Launches the best kernel (a thread a position), then the parse
// kernel (B blocks of one warp), on `stream`; returns cudaGetLastError().
extern "C" int tpz_deflate_parse(const void* blocks, const void* lengths,
                                 const void* prev, int B, int n,
                                 int max_chain, void* tokens, void* ntok,
                                 void* best_at, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long grid =
      static_cast<long long>(B) * ((n + BEST_THREADS - 1) / BEST_THREADS);
  if (grid > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  if (grid > 0) {
    deflate_best_kernel<<<static_cast<unsigned>(grid), BEST_THREADS, 0, s>>>(
        static_cast<const uint8_t*>(blocks),
        static_cast<const int32_t*>(lengths),
        static_cast<const int32_t*>(prev), n, max_chain,
        static_cast<int32_t*>(best_at));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  deflate_parse_kernel<<<B, 32, 0, s>>>(
      static_cast<const uint8_t*>(blocks),
      static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(best_at), n,
      static_cast<int32_t*>(tokens), static_cast<int32_t*>(ntok));
  return static_cast<int>(cudaGetLastError());
}

// Mode 0 (dynamic) or 1 (fixed): tokens (B, n) i32 and ntok (B,) i32 from
// tpz_deflate_parse in, scratch SCRATCH_BYTES a row; the tables kernel,
// then the emit kernel.  Mode 2 (stored): blocks (B, n) u8 and lengths
// (B,) i32 in, the stored kernel alone.  comp (B, pitch) u8, zeroed by the
// caller (pitch at least 2n + 4096), and clens (B,) i32 out (-1 past
// 2n + 4096).  Returns cudaGetLastError().
extern "C" int tpz_deflate_emit(const void* blocks, const void* lengths,
                                const void* tokens, const void* ntok, int B,
                                int n, int mode, void* comp, int pitch,
                                void* clens, void* scratch, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 2) {
    deflate_stored_kernel<<<B, EMIT_THREADS, 0, s>>>(
        static_cast<const uint8_t*>(blocks),
        static_cast<const int32_t*>(lengths), n,
        static_cast<uint8_t*>(comp), pitch, static_cast<int32_t*>(clens));
    return static_cast<int>(cudaGetLastError());
  }
  deflate_tables_kernel<<<(B + TABLE_WARPS - 1) / TABLE_WARPS,
                          32 * TABLE_WARPS, 0, s>>>(
      static_cast<const int32_t*>(tokens), static_cast<const int32_t*>(ntok),
      B, n, mode, static_cast<uint8_t*>(comp), pitch,
      static_cast<uint8_t*>(scratch));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  deflate_emit_kernel<<<B, EMIT_THREADS, 0, s>>>(
      static_cast<const int32_t*>(tokens), static_cast<const int32_t*>(ntok),
      n, static_cast<uint8_t*>(comp), pitch, 2 * n + 4096,
      static_cast<int32_t*>(clens), static_cast<const uint8_t*>(scratch));
  return static_cast<int>(cudaGetLastError());
}
