// lz4_shared.cuh — what csrc/lz4_dense.cu and csrc/lz4_chain.cu share on
// their shared-memory routes (rows of at most 65,536 bytes, hashes of at
// most 16 bits), and csrc/deflate_encode.cu's links on theirs: a row
// staged in shared memory by one TMA bulk copy and the mbarriers that
// order it; the candidates step split over the hash's classes
// (split_row); and, for the parses over words, a row streamed
// through shared memory (RowStream) and sequences written 32 at a time
// (put_batch).  And the links past those routes, written once for the lz4
// encoders (csrc/lz4_links.cu) and deflate's (its tiled route): by tiles
// of split_row and a carry (rows past 65,536 bytes, at most 16 bits), or
// by sorting (any width, any bits).
//
// split_row is lz4_dense.cu's keyed step moved on chip and spread over a
// CTA: the candidate of p is the last earlier position with p's hash, so
// positions of different hashes never meet, and warp w of 8 takes the
// hashes h with h % 8 == w.  Each warp gathers its class's positions 32
// at a time in order; __match_any_sync groups the lanes of one hash, a
// lane's candidate is the highest earlier lane of its group, else the
// table's slot, and the group's last lane writes p there.  128 positions
// inside a run of one hash skip the queue (each takes p - 1).  The table is
// direct: 2^bits u16 slots, position + 1 (0 empty); positions stay below
// the row's limit, at most 65,534 (deflate's length - 2), as a row holds
// at most 65,536 bytes.  Both table forms are exact (a slot holds its
// hash's last position), so the step gives the keyed step's candidates.
// The key is the 4 bytes at a position (LZ4's, Key4) or, by another
// functor, its first 3 (deflate's).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace lz4s {

constexpr int STAGE_MAX = 1 << 16;    // bytes of a row the routes stage
constexpr int SHARED_MAX_LOG = 16;    // bits of hash their tables hold
constexpr int SPLIT_CLASSES = 8;      // split_row's warps a row
constexpr int MIN_MATCH = 4;
constexpr int MF_LIMIT = 12;          // no match starts from length - 12 on
constexpr int LAST_LITERALS = 5;      // nor extends into the last 5 bytes
constexpr int32_t MARKED = INT32_MIN;   // a word whose match reached the cap
constexpr uint32_t HASH_MUL = 2654435761u;
constexpr unsigned FULL = 0xFFFFFFFFu;

// CTAs of `threads` threads and `smem` bytes of dynamic shared memory that
// fit the card at once (at most B), after setting the kernel's limit.
inline cudaError_t persistent_grid(const void* kernel, int threads, int smem,
                                   int B, int* grid) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  *grid = max(1, min(B, sms * per_sm));
  return err;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Waits until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}


// One thread: the phase's arrival on `bar` with the bytes its bulk copies
// bring; a TMA bulk copy of `bytes` (a multiple of 16, both addresses
// 16-byte aligned) from global to shared memory completing on `bar`; and
// the two together.
__device__ __forceinline__ void bulk_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  bulk_expect(bar, bytes);
  bulk_copy(dst, src, bytes, bar);
}

// Stages the first len bytes of a row at `src` into `dst` (16-byte
// aligned, 16 bytes of slack past the row), by all `threads` threads from
// `tid`: with `tma` (src 16-byte aligned and the row width a multiple of
// 16, so the copy rounded up to 16 bytes stays in the row) one bulk copy
// on `bar`; else byte by byte (the caller then synchronises the threads).
// Returns whether a bulk copy was started: then every thread waits on
// `bar` before it reads the row, at the parity of the copies before it.
__device__ __forceinline__ bool stage_row(uint8_t* dst, const uint8_t* src,
                                          int len, bool tma, uint64_t* bar,
                                          int tid, int threads) {
  if (tma) {
    if (len > 0 && tid == 0)
      bulk_load(dst, src, (static_cast<unsigned>(len) + 15) & ~15u, bar);
    return len > 0;
  }
  for (int k = tid; k < len; k += threads) dst[k] = src[k];
  return false;
}

// The 4 bytes at base + q (base 4-byte aligned) as a little-endian word,
// from the aligned words that hold them (the second only when q is not
// aligned, so no word is read whose first byte lies past q + 3).  A row
// at any address is read from base = row - skew (its address mod 4) at q
// = p + skew.  The shift comes from q, and the address stays arithmetic
// on base, so a shared-memory row is read by shared-memory loads (built
// from an integer address, the loads were generic and the links 19%
// slower).
__device__ __forceinline__ uint32_t load4_at(const uint8_t* base, int q) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(base) + (q >> 2);
  const unsigned shift = (q & 3) * 8;
  return shift ? __funnelshift_r(w[0], w[1], shift) : w[0];
}

// The address of a row's byte 0 mod 4: the skew to read it by load4_at.
__device__ __forceinline__ int skew_of(const uint8_t* row) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(row) & 3);
}

// The bytes that agree from base + c and base + p (base 4-byte aligned),
// at most `most`: 4 a step, the first that differs by the lowest set byte
// of the words' xor (the C++'s match_extend).  The callers keep p + most
// 5 bytes inside the row, so every word read starts inside it.
__device__ __forceinline__ int extend_at(const uint8_t* base, int c, int p,
                                         int most) {
  for (int m = 0; m < most; m += 4) {
    const uint32_t d = load4_at(base, c + m) ^ load4_at(base, p + m);
    if (d) return min(m + ((__ffs(d) - 1) >> 3), most);
  }
  return max(most, 0);
}

// The hash of seq at `bits` bits (0..16), 0 for bits 0.
__device__ __forceinline__ uint32_t hash_bits(uint32_t seq, int bits) {
  return bits ? (seq * HASH_MUL) >> (32 - bits) : 0u;
}

// split_row's key of LZ4's hash: the 4 bytes at base + q (load4_at).
struct Key4 {
  static constexpr bool ALIGNED = true;   // read from base = row - skew
  __device__ __forceinline__ uint32_t operator()(const uint8_t* base,
                                                 int q) const {
    return load4_at(base, q);
  }
};

// A row's candidates split over the SPLIT_CLASSES warps of a CTA: warp w
// takes the positions below limit whose hash h has h % SPLIT_CLASSES ==
// w, in order, gathered 32 at a time in its queue (64 u32 entries of
// shared memory, p | h << 16), and steps through them against its own
// slots of the row's table (slot h, 2^bits u16, zeroed by the caller):
// the lanes of one hash grouped by __match_any_sync, a lane's
// candidate the position of the highest earlier lane of its group, else
// the slot, which the group's last lane then takes.  Hashes of different
// classes never meet, so the warps need no synchronisation between them,
// and each runs 1/SPLIT_CLASSES of the row's table steps; every warp reads
// all of the row's bytes to find its positions (4 steps of 32 at once,
// independent of the table), position p at row[p + skew] (row 4-byte
// aligned; load4_at).
// A scan of 128 positions whose hashes all equal that of the position
// before them lies inside a run of one hash (a byte run, as a zero page):
// each position's candidate is p - 1, so its groups are emitted at once,
// group g by warp g % SPLIT_CLASSES, and the hash's warp steps what its
// queue holds and sets the slot to the scan's last position.  A zero row
// is then one queue of 128 entries, where it put all of its 2,048 steps on
// one warp of the 8.
// The hash is of Key{}(row, p + skew): by default (Key4) the 4 bytes at p.
// emit(p, c) gets every position below limit and its candidate (-1 for
// none).
template <class Key = Key4, class Emit>
__device__ __forceinline__ void split_row(const uint8_t* row, int skew,
                                          int limit, int bits,
                                          uint16_t* table, uint32_t* queue,
                                          int warp, int lane, Emit emit) {
  const unsigned below = (1u << lane) - 1;
  const unsigned above = ~((2u << lane) - 1);
  auto step = [&](uint32_t e, bool live) {
    const int p = static_cast<int>(e & 0xFFFF);
    const uint32_t h = e >> 16;
    const unsigned lanes = __ballot_sync(FULL, live);
    unsigned group = 0;
    if (live) group = __match_any_sync(lanes, h);
    const unsigned earlier = group & below;
    const int from = __shfl_sync(FULL, p, earlier ? 31 - __clz(earlier)
                                                  : lane);
    const int c = !live ? -1 : earlier ? from
                                       : static_cast<int>(table[h]) - 1;
    __syncwarp();   // every slot read before this step writes one
    if (live && !(group & above)) table[h] = static_cast<uint16_t>(p + 1);
    __syncwarp();   // this step's writes before the next step's reads
    if (live) emit(p, c);
  };
  int count = 0;       // entries in the queue, below 32 between steps
  uint32_t last = 0;   // the hash of position first - 1
  for (int first = 0; first < limit; first += 128) {
    uint32_t entry[4];
    bool mine[4];
    bool same = first > 0 && first + 128 <= limit;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int p = first + 32 * k + lane;
      const bool live = p < limit;
      const uint32_t h = hash_bits(live ? Key{}(row, p + skew) : 0u, bits);
      entry[k] = static_cast<uint32_t>(p) | h << 16;
      mine[k] = live && (h & (SPLIT_CLASSES - 1)) ==
                            static_cast<uint32_t>(warp);
      same = same && h == last;
    }
    if (__all_sync(FULL, same)) {   // inside a run: every p takes p - 1
      if ((last & (SPLIT_CLASSES - 1)) == static_cast<uint32_t>(warp)) {
        __syncwarp();
        if (count) step(lane < count ? queue[lane] : 0u, lane < count);
        count = 0;
        if (lane == 0) table[last] = static_cast<uint16_t>(first + 128);
        __syncwarp();
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if ((((first >> 5) + k) & (SPLIT_CLASSES - 1)) == warp)
          emit(first + 32 * k + lane, first + 32 * k + lane - 1);
      continue;
    }
    last = __shfl_sync(FULL, entry[3] >> 16, 31);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned m = __ballot_sync(FULL, mine[k]);
      if (mine[k]) queue[count + __popc(m & below)] = entry[k];
      count += __popc(m);
      if (count >= 32) {
        __syncwarp();
        const uint32_t e = queue[lane];
        __syncwarp();
        if (lane + 32 < count) queue[lane] = queue[lane + 32];
        count -= 32;
        step(e, true);
      }
    }
  }
  __syncwarp();
  if (count) step(lane < count ? queue[lane] : 0u, lane < count);
}

// A parse's view of its row: the bytes and the words (an i32 a position)
// streamed through shared memory in chunks of STREAM_CHUNK positions, two
// buffers: while the parse reads chunk k, chunk k + 1 loads (one TMA bulk
// copy each of bytes and words, on the buffer's mbarrier).  The parse
// moves forward only; a jump past the loading chunk loads the new one and
// waits.  A byte before the chunk in reach (a long literal run's start) is
// read from device memory.  Without STREAM (rows or words not 16-byte
// aligned) every read goes to device memory.  Every lane of the warp makes
// every call.
constexpr int STREAM_CHUNK = 2048;

template <bool STREAM>
struct RowStream {
  const uint8_t* src;       // the row's bytes, device memory
  const int32_t* words;     // its words
  int n, limit, lane;
  uint8_t* bytes;           // 2 STREAM_CHUNK bytes of shared memory
  int32_t* wbuf;            // 2 STREAM_CHUNK words of shared memory
  uint64_t* bar;            // 2 mbarriers, initialised
  int cur, next;            // the chunk read and the one loading (-1: none)
  unsigned phases;          // bit b: the parity of buffer b's next phase

  __device__ RowStream(const uint8_t* src_, const int32_t* words_, int n_,
                       int limit_, int lane_, uint8_t* bytes_,
                       int32_t* wbuf_, uint64_t* bar_)
      : src(src_), words(words_), n(n_), limit(limit_), lane(lane_),
        bytes(bytes_), wbuf(wbuf_), bar(bar_), cur(-1), next(-1),
        phases(0) {}

  __device__ void load(int k) {
    const int b = k & 1;
    const unsigned m = min(STREAM_CHUNK, n - k * STREAM_CHUNK);
    __syncwarp();   // every lane's reads of the buffer done
    if (lane == 0) {
      bulk_expect(bar + b, 5 * m);
      bulk_copy(bytes + b * STREAM_CHUNK, src + k * STREAM_CHUNK, m, bar + b);
      bulk_copy(wbuf + b * STREAM_CHUNK, words + k * STREAM_CHUNK, 4 * m,
                bar + b);
    }
  }

  __device__ void wait(int k) {
    const int b = k & 1;
    bar_wait(bar + b, (phases >> b) & 1);
    phases ^= 1u << b;
  }

  // chunk k (not before cur) to read, and k + 1 loading
  __device__ void reach(int k) {
    if (k == cur) return;
    if (k != next) {
      if (next >= 0) wait(next);
      load(k);
    }
    wait(k);
    cur = k;
    next = -1;
    if ((k + 1) * STREAM_CHUNK < limit) {
      load(k + 1);
      next = k + 1;
    }
  }

  // every copy landed before the CTA leaves
  __device__ void finish() {
    if (STREAM && next >= 0) wait(next);
  }

  // the words of wbase .. wbase + 31 (wbase a multiple of 32), a lane
  // each, 0 from limit on
  __device__ int window(int wbase) {
    const int q = wbase + lane;
    if (!STREAM) return q < limit ? words[q] : 0;
    reach(wbase / STREAM_CHUNK);
    return q < limit ? wbuf[(cur & 1) * STREAM_CHUNK + q % STREAM_CHUNK] : 0;
  }

  __device__ uint8_t operator[](int q) const {
    if (STREAM && q / STREAM_CHUNK == cur)
      return bytes[(cur & 1) * STREAM_CHUNK + q % STREAM_CHUNK];
    return src[q];
  }
};

// A parsed sequence, held by a lane until its batch is written: its
// literals' start and count, its match's offset and length (4 or more).
struct Seq {
  int anchor, lit, off, len;
};

constexpr int SHORT_LITERALS = 16;   // a lane copies runs up to this long

// Writes a batch of `count` sequences (lane k holds the k-th; count <=
// 32) at dst + o in lane order, as LZ4 tokens, length extensions,
// literals from src (a pointer or a RowStream) and offsets, and returns o
// after them: each lane's offset by a prefix sum of the sizes, its bytes
// written by the lane, literal runs past SHORT_LITERALS by the whole warp
// one run at a time.  So the parse's chain of dependent steps carries no
// store and no literal load.
template <class Src>
__device__ __forceinline__ int put_batch(uint8_t* dst, int o, const Src& src,
                                         Seq s, int count, int lane) {
  const bool live = lane < count;
  const int ml = s.len - 4;
  const int lext = s.lit >= 15 ? (s.lit - 15) / 255 + 1 : 0;
  const int mext = ml >= 15 ? (ml - 15) / 255 + 1 : 0;
  const int size = live ? 1 + lext + s.lit + 2 + mext : 0;
  int end = size;   // inclusive prefix sum of the sizes
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(FULL, end, d);
    if (lane >= d) end += v;
  }
  const int total = __shfl_sync(FULL, end, 31);
  int q = o + end - size;
  const int lit_at = q + 1 + lext;
  if (live) {
    dst[q] = static_cast<uint8_t>(min(s.lit, 15) << 4 | min(ml, 15));
    for (int k = 0; k < lext; ++k)
      dst[q + 1 + k] =
          static_cast<uint8_t>(k < lext - 1 ? 255 : (s.lit - 15) % 255);
    if (s.lit <= SHORT_LITERALS) {
#pragma unroll 4
      for (int k = 0; k < s.lit; ++k) dst[lit_at + k] = src[s.anchor + k];
    }
    q = lit_at + s.lit;
    dst[q] = static_cast<uint8_t>(s.off & 0xFF);
    dst[q + 1] = static_cast<uint8_t>(s.off >> 8);
    for (int k = 0; k < mext; ++k)
      dst[q + 2 + k] =
          static_cast<uint8_t>(k < mext - 1 ? 255 : (ml - 15) % 255);
  }
  for (unsigned longs = __ballot_sync(FULL, live && s.lit > SHORT_LITERALS);
       longs; longs &= longs - 1) {
    const int k = __ffs(longs) - 1;
    const int from = __shfl_sync(FULL, s.anchor, k);
    const int count_k = __shfl_sync(FULL, s.lit, k);
    const int to = __shfl_sync(FULL, lit_at, k);
    for (int j = lane; j < count_k; j += 32) dst[to + j] = src[from + j];
  }
  return o + total;
}

// Bytes of split_row's queues.
constexpr int QUEUE_BYTES = 256 * SPLIT_CLASSES;

// Bytes of a direct table of 2^bits u16 slots, rounded up to 16 bytes.
__host__ __device__ __forceinline__ int table_bytes(int bits) {
  return ((2 << bits) + 15) & ~15;
}

// ---------------------------------------------------------------- links
// past the shared route.  The links of a row: for every position p below
// limit = length - TAIL, the last earlier position with p's hash (of the
// key Key{} reads there, at `bits` bits); -1 where there is none and from
// limit on.  Positions from limit on take no link and are no one's.
// split_row gives them on rows of at most STAGE_MAX bytes at hashes of at
// most SHARED_MAX_LOG bits (its u16 slots and direct table); two routes
// take the rest, by shape alone:
//   - tiled (rows past STAGE_MAX bytes, hashes of at most SHARED_MAX_LOG
//     bits): the row cut into tiles of LINK_TILE positions, each run by
//     split_row as a row of its own (positions relative to the tile, so
//     each fits the u16 slot; the keys read up to the row's limit, into
//     the next tile), a CTA a tile, so one wide row fills the card.  Each
//     tile writes out its table (the tile's last position of each hash)
//     and, for each hash, the first position that found no link inside
//     it; a carry pass, a thread a hash of a row, walks the row's tiles in
//     order with the last position seen before each and gives that first
//     position its link.  Scratch: 4 bytes x 2^bits a tile;
//   - sorted (any width, any bits: the lz4 encoders' hashes of 17-32
//     bits, whose direct table would not fit on chip): XLA's construction,
//     a stable order of a row's positions by hash, each position's link
//     the one before it in that order where the hash is the same.  Within
//     a tile of SORT_TILE positions a CTA sorts the keys h << 12 | p (u32
//     up to 20 bits of hash, u64 past) with a bitonic network, a thread's
//     keys in registers, the steps within a warp by shuffles, the rest
//     through shared memory, which gives every position but
//     each hash's first in the tile its link, and writes one entry a
//     distinct hash, h << 32 | its index in the row, with the hash's first
//     and last position in the tile.  Across tiles the same rule once more
//     on those entries: each tile's run is sorted, so rounds of pairwise
//     merges (merge path: a CTA an output chunk of MERGE_CHUNK, its split
//     by a warp's 32-way search, its part merged in shared memory) order a
//     row's entries by (h, tile), and in the last round each entry whose
//     predecessor has its hash gives its first position that entry's last
//     position.  No step's work grows with 2^bits or with how the hashes'
//     bits fall: no table of 2^bits slots, no bucket by the top bits of h;
//     a tile of one hash (a zero page) skips the network and is one entry.
//     Rows go in groups of at most SORT_GROUP positions, which bound the
//     scratch.

// The kernels below have internal linkage in each source that includes
// them, as every other kernel of the port has (its source's unnamed
// namespace).
namespace {

constexpr int LINK_TILE = 1 << 15;   // positions a tile of the tiled links
constexpr int CARRY_THREADS = 256;   // the carry's threads a block
constexpr int SORT_TILE = 1 << 12;   // positions a tile of the sorted links
constexpr int SORT_THREADS = 512;
constexpr int MERGE_CHUNK = 2048;    // entries a block of a merge round
constexpr int MERGE_THREADS = 256;
constexpr int MERGE_RUN = MERGE_CHUNK / MERGE_THREADS;   // entries a thread
                                                         // merges
constexpr long long SORT_GROUP = 1ll << 24;   // positions a group, at most

// Tiles blockIdx.x, + gridDim.x, ... of the B rows' ceil(n / LINK_TILE)
// each: split_row over the tile as over a row of the shared route, its
// links inside the tile into prev (-1 where none), then the tile's table
// (slot h: the tile's last position of hash h, + 1; 0 for none) into lasts
// and, for each hash the tile holds, the position that found no link
// inside it into firsts (a hash's first position in the tile; no other
// entry is read).  A tile past the row's limit writes -1s alone.  BITS:
// the hash's bits where fixed, else (-1) bits_arg.
template <class Key, int TAIL, int BITS>
__global__ void __launch_bounds__(32 * SPLIT_CLASSES)
links_tiled_kernel(const uint8_t* __restrict__ blocks,
                   const int32_t* __restrict__ lengths, int B, int n,
                   int bits_arg, int32_t* __restrict__ prev,
                   uint16_t* __restrict__ lasts,
                   uint16_t* __restrict__ firsts) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int THREADS = 32 * SPLIT_CLASSES;
  const int bits = BITS >= 0 ? BITS : bits_arg;
  const int slots = 1 << bits;
  uint32_t* queues = reinterpret_cast<uint32_t*>(smem);
  uint16_t* table = reinterpret_cast<uint16_t*>(smem + QUEUE_BYTES);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles = (n + LINK_TILE - 1) / LINK_TILE;
  const long long jobs = static_cast<long long>(B) * tiles;
  for (long long job = blockIdx.x; job < jobs; job += gridDim.x) {
    const int row = static_cast<int>(job / tiles);
    const int t0 = static_cast<int>(job % tiles) * LINK_TILE;
    const uint8_t* src = blocks + static_cast<size_t>(row) * n + t0;
    int32_t* out = prev + static_cast<size_t>(row) * n + t0;
    const int len = min(max(lengths[row], 0), n);
    const int limit = max(len - TAIL, 0);
    const int width = min(LINK_TILE, n - t0);
    const int live = min(max(limit - t0, 0), width);  // the tile's positions
    __syncthreads();   // the last tile's steps on the table done
    if (live)
      for (int k = tid; k < table_bytes(bits) / 16; k += THREADS)
        reinterpret_cast<int4*>(table)[k] = make_int4(0, 0, 0, 0);
    for (int p = live + tid; p < width; p += THREADS) out[p] = -1;
    if (!live) continue;
    __syncthreads();
    // an aligned key reads the tile's byte q at base[q + skew]
    const int skew = Key::ALIGNED ? skew_of(src) : 0;
    const uint8_t* base = src - skew;
    uint16_t* first = firsts + static_cast<size_t>(job) * slots;
    split_row<Key>(base, skew, live, bits, table, queues + 64 * warp, warp,
                   lane, [&](int p, int c) {
                     out[p] = c < 0 ? -1 : t0 + c;
                     if (c < 0)
                       first[hash_bits(Key{}(base, p + skew), bits)] =
                           static_cast<uint16_t>(p);
                   });
    __syncthreads();
    uint16_t* last = lasts + static_cast<size_t>(job) * slots;
    if (slots >= 8) {
      for (int k = tid; k < slots / 8; k += THREADS)
        reinterpret_cast<int4*>(last)[k] =
            reinterpret_cast<const int4*>(table)[k];
    } else {
      for (int k = tid; k < slots; k += THREADS) last[k] = table[k];
    }
  }
}

// The tiled links' carry and fix-up, a thread a hash h of a row: walks the
// row's tiles below its limit in order, carrying the last position of h
// in the tiles before; where a tile holds h, its first position of h (which
// found no link inside the tile) takes the carried one.  Tiles' entries
// are loaded 8 at a time.
template <int TAIL, int BITS>
__global__ void __launch_bounds__(CARRY_THREADS)
links_carry_kernel(const int32_t* __restrict__ lengths, int B, int n,
                   int bits_arg, int32_t* __restrict__ prev,
                   const uint16_t* __restrict__ lasts,
                   const uint16_t* __restrict__ firsts) {
  constexpr int BATCH = 8;
  const int bits = BITS >= 0 ? BITS : bits_arg;
  const size_t slots = size_t{1} << bits;
  const long long id = blockIdx.x * static_cast<long long>(CARRY_THREADS) +
                       threadIdx.x;
  const int row = static_cast<int>(id >> bits);
  const int h = static_cast<int>(id & (slots - 1));
  if (row >= B) return;
  const int tiles = (n + LINK_TILE - 1) / LINK_TILE;
  const int len = min(max(lengths[row], 0), n);
  const int limit = max(len - TAIL, 0);
  const int used = (limit + LINK_TILE - 1) / LINK_TILE;   // tiles with links
  const size_t first_job = static_cast<size_t>(row) * tiles;
  int32_t* out = prev + static_cast<size_t>(row) * n;
  int carried = -1;
  for (int base = 0; base < used; base += BATCH) {
    int last[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k)
      last[k] = base + k < used
                    ? lasts[(first_job + base + k) * slots + h] : 0;
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      if (!last[k]) continue;
      const int t0 = (base + k) * LINK_TILE;
      if (carried >= 0)
        out[t0 + firsts[(first_job + base + k) * slots + h]] = carried;
      carried = t0 + last[k] - 1;
    }
  }
}

// Bytes of launch_links_tiled's scratch for B rows of n bytes at `bits`:
// the tiles' tables, then their first positions.
inline long long links_tiled_scratch(int B, int n, int bits) {
  return 2ll * B * ((n + LINK_TILE - 1) / LINK_TILE) * (1ll << bits) *
         static_cast<long long>(sizeof(uint16_t));
}

// The tiled links: blocks (B, n) u8 and lengths (B,) i32 in, prev (B, n)
// i32 out, every entry written; bits 0..SHARED_MAX_LOG (BITS where fixed);
// scratch of links_tiled_scratch bytes.  Launches as many CTAs of
// SPLIT_CLASSES warps as fit the card at once (at most the tiles), each
// walking tiles, then the carry kernel, on `s`; returns the first error.
template <class Key, int TAIL, int BITS>
inline cudaError_t launch_links_tiled(const void* blocks, const void* lengths,
                                      int B, int n, int bits, void* prev,
                                      void* scratch, cudaStream_t s) {
  if (BITS >= 0) bits = BITS;
  if (bits < 0 || bits > SHARED_MAX_LOG) return cudaErrorInvalidValue;
  const long long tiles =
      static_cast<long long>(B) * ((n + LINK_TILE - 1) / LINK_TILE);
  const long long carry =
      ((static_cast<long long>(B) << bits) + CARRY_THREADS - 1) /
      CARRY_THREADS;
  if (tiles > 0x7FFFFFFF || carry > 0x7FFFFFFF) return cudaErrorInvalidValue;
  if (tiles == 0) return cudaSuccess;
  const int threads = 32 * SPLIT_CLASSES;
  const int smem = QUEUE_BYTES + table_bytes(bits);
  int grid = 0;
  auto kernel = links_tiled_kernel<Key, TAIL, BITS>;
  cudaError_t err = persistent_grid(reinterpret_cast<const void*>(kernel),
                                    threads, smem, static_cast<int>(tiles),
                                    &grid);
  if (err != cudaSuccess) return err;
  uint16_t* lasts = static_cast<uint16_t*>(scratch);
  uint16_t* firsts = lasts + (static_cast<size_t>(tiles) << bits);
  kernel<<<grid, threads, smem, s>>>(
      static_cast<const uint8_t*>(blocks),
      static_cast<const int32_t*>(lengths), B, n, bits,
      static_cast<int32_t*>(prev), lasts, firsts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  links_carry_kernel<TAIL, BITS>
      <<<static_cast<unsigned>(carry), CARRY_THREADS, 0, s>>>(
          static_cast<const int32_t*>(lengths), B, n, bits,
          static_cast<int32_t*>(prev), lasts, firsts);
  return cudaGetLastError();
}

// The sorted links' tile step, a CTA a tile of SORT_TILE positions
// (blockIdx.x: row, then tile) of `rows` rows: the keys h << P_BITS | p
// of the tile's positions below the row's limit (p relative to the tile;
// K: u32 where h has at most 32 - P_BITS bits, else u64) sorted in shared
// memory, a position's link the one before it where the
// hash is the same, else -1 (the merges give it); then, for each distinct
// hash d-th in the tile, ents[d] = h << 32 | (t0 + d) (t0 the tile's
// first position: the entry's index in the row's entries, whose tiles
// are SORT_TILE apart as the positions are), firsts[d] and lasts[d] its
// first and last position in the tile, and the tile's count of them.
constexpr int P_BITS = 12;   // a key's bits of position
static_assert(SORT_TILE <= 1 << P_BITS, "a tile's positions fit the key");

template <class Key, int TAIL, class K>
__global__ void __launch_bounds__(SORT_THREADS)
links_sort_tile_kernel(const uint8_t* __restrict__ blocks,
                       const int32_t* __restrict__ lengths, int n, int bits,
                       int32_t* __restrict__ prev,
                       uint64_t* __restrict__ ents,
                       uint16_t* __restrict__ firsts,
                       uint16_t* __restrict__ lasts,
                       int* __restrict__ counts) {
  constexpr int PER = SORT_TILE / SORT_THREADS;   // sorted keys a thread
  // key g at keys[g + g / PER]: a thread's PER keys side by side, and the
  // warp's accesses of its e-th keys in distinct banks
  __shared__ K keys[SORT_TILE + SORT_TILE / PER];
  auto at = [](int g) { return g + g / PER; };
  __shared__ int sums[SORT_THREADS / 32];
  // the tile's links relative to it (-1: none), written out at once
  __shared__ int16_t links[SORT_TILE];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles = (n + SORT_TILE - 1) / SORT_TILE;
  const int row = blockIdx.x / tiles;
  const int t0 = (blockIdx.x % tiles) * SORT_TILE;
  const uint8_t* src = blocks + static_cast<size_t>(row) * n;
  const int skew = Key::ALIGNED ? skew_of(src) : 0;
  const uint8_t* base = src - skew;
  int32_t* out = prev + static_cast<size_t>(row) * n + t0;
  const size_t first = static_cast<size_t>(row) * tiles * SORT_TILE + t0;
  const int len = min(max(lengths[row], 0), n);
  const int limit = max(len - TAIL, 0);
  const int width = min(SORT_TILE, n - t0);
  const int live = min(max(limit - t0, 0), width);
  for (int p = live + tid; p < width; p += SORT_THREADS) out[p] = -1;
  if (!live) {
    if (tid == 0) counts[blockIdx.x] = 0;
    return;
  }
  // the network over all SORT_TILE keys, thread t holding keys PER t ..
  // PER t + PER - 1 in registers: pairs PER or more apart within a warp
  // exchanged by shuffles, farther ones through shared memory
  K v[PER];
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const int k = tid * PER + e;
    v[e] = k < live ? static_cast<K>(hash_bits(Key{}(base, t0 + k + skew),
                                               bits)) << P_BITS |
                          static_cast<K>(k)
                    : ~K{0};
  }
  // a tile of one hash (a zero page) is in order already: no network
  const K h0 = static_cast<K>(hash_bits(Key{}(base, t0 + skew), bits));
  bool one = true;
#pragma unroll
  for (int e = 0; e < PER; ++e)
    one = one && (tid * PER + e >= live || v[e] >> P_BITS == h0);
  const int first_k = __syncthreads_and(one) ? 2 * SORT_TILE : 2;
  for (int k = first_k; k <= SORT_TILE; k <<= 1) {
    int j = k >> 1;
    if (j >= 32 * PER) {   // across warps: through shared memory
#pragma unroll
      for (int e = 0; e < PER; ++e) keys[at(tid * PER + e)] = v[e];
      for (; j >= 32 * PER; j >>= 1) {
        __syncthreads();
#pragma unroll
        for (int e = 0; e < PER; ++e) {
          const int g = tid * PER + e;
          const K o = keys[at(g ^ j)];
          const bool low = ((g & j) == 0) == ((g & k) == 0);   // the min
          v[e] = low == (o < v[e]) ? o : v[e];
        }
        __syncthreads();
#pragma unroll
        for (int e = 0; e < PER; ++e) keys[at(tid * PER + e)] = v[e];
      }
      __syncthreads();
    }
    for (; j >= PER; j >>= 1) {   // within a warp: lane ^ (j / PER)
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        const int g = tid * PER + e;
        const K o = __shfl_xor_sync(FULL, v[e], j / PER);
        const bool low = ((g & j) == 0) == ((g & k) == 0);
        v[e] = low == (o < v[e]) ? o : v[e];
      }
    }
    // within a thread: the steps from j = min(k / 2, PER / 2) down, each
    // unrolled so that v is indexed by constants (it stays in registers)
#pragma unroll
    for (int jj = PER / 2; jj > 0; jj >>= 1) {
      if (jj > j) continue;
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        if (e & jj) continue;
        const K a = v[e], b = v[e + jj];
        if ((((tid * PER + e) & k) == 0) == (b < a)) {   // out of order
          v[e] = b;
          v[e + jj] = a;
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < PER; ++e) keys[at(tid * PER + e)] = v[e];
  __syncthreads();
  // thread t takes sorted keys PER t .. PER t + PER - 1: its hashes' first
  // keys counted, an exclusive scan over the threads, then each key's
  // entry index d is the firsts up to it, less one
  const int i0 = tid * PER;
  int starts = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = i0 + j;
    starts += i < live &&
              (i == 0 || keys[at(i - 1)] >> P_BITS != keys[at(i)] >> P_BITS);
  }
  int incl = starts;
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) sums[warp] = incl;
  __syncthreads();
  int before = incl - starts;
  for (int w = 0; w < warp; ++w) before += sums[w];
  int d = before - 1;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = i0 + j;
    if (i >= live) break;
    const K key = keys[at(i)];
    const K h = key >> P_BITS;
    const int p = static_cast<int>(key & ((1 << P_BITS) - 1));
    if (i == 0 || keys[at(i - 1)] >> P_BITS != h) {
      ++d;
      ents[first + d] = static_cast<uint64_t>(h) << 32 |
                        static_cast<uint32_t>(t0 + d);
      firsts[first + d] = static_cast<uint16_t>(p);
      links[p] = -1;
    } else {
      links[p] = static_cast<int16_t>(keys[at(i - 1)] &
                                      ((1 << P_BITS) - 1));
    }
    if (i + 1 == live || keys[at(i + 1)] >> P_BITS != h)
      lasts[first + d] = static_cast<uint16_t>(p);
  }
  if (tid == SORT_THREADS - 1) counts[blockIdx.x] = d + 1;
  __syncthreads();
  for (int p = tid; p < live; p += SORT_THREADS)
    out[p] = links[p] < 0 ? -1 : t0 + links[p];
}

// The number of a's among the first d of the merge of a (la keys) and b
// (lb keys), both ascending, no key in both (merge path), by a whole warp
// (every lane calls it, all get the answer): 32 probes a step, each
// narrowing the range 32 times, so a split takes few dependent loads from
// device memory, not log2 of the run.
__device__ __forceinline__ int merge_split_warp(const uint64_t* a, int la,
                                                const uint64_t* b, int lb,
                                                int d, int lane) {
  int lo = max(0, d - lb), hi = min(d, la);   // the answer is in [lo, hi]
  while (lo < hi) {
    const int at = lo + static_cast<int>(
                            static_cast<long long>(hi - lo) * lane / 32);
    const unsigned below = __ballot_sync(FULL, a[at] < b[d - 1 - at]);
    const int c = __popc(below);   // probes below the answer: the first c
    if (c == 0) return lo;         // probe 0 is lo itself
    const int last = __shfl_sync(FULL, at, c - 1);
    hi = c < 32 ? __shfl_sync(FULL, at, c) : hi;
    lo = last + 1;
  }
  return lo;
}

// One merge round of the sorted links over `rows` rows of `tiles` tiles:
// runs of `width` tiles (a run's entries from its first tile's start,
// count cin[that tile]) merged in pairs, a CTA an output chunk of
// MERGE_CHUNK (blockIdx.x: row, pair, chunk; `chunks` a pair).  Not LAST:
// the merged run into out from the pair's first tile, its count into cout
// there.  LAST (one pair a row): each entry whose predecessor in the
// merged order has its hash gives the link prev[first] = the predecessor's
// last position.
template <bool LAST>
__global__ void __launch_bounds__(MERGE_THREADS)
links_merge_kernel(const uint64_t* __restrict__ in,
                   uint64_t* __restrict__ out, const int* __restrict__ cin,
                   int* __restrict__ cout, int tiles, int width, int chunks,
                   int n, int32_t* __restrict__ prev,
                   const uint16_t* __restrict__ firsts,
                   const uint16_t* __restrict__ lasts) {
  // the chunk's a's, then b's, and the merged chunk, entry g at g + g /
  // MERGE_RUN: a thread's run side by side, the warp's in distinct banks
  __shared__ uint64_t runs[MERGE_CHUNK + MERGE_CHUNK / MERGE_RUN];
  __shared__ uint64_t merged[MERGE_CHUNK + MERGE_CHUNK / MERGE_RUN];
  auto at = [](int g) { return g + g / MERGE_RUN; };
  __shared__ int split[2];
  const int tid = threadIdx.x;
  const int pairs = (tiles + 2 * width - 1) / (2 * width);
  const int chunk = blockIdx.x % chunks;
  const int pair = (blockIdx.x / chunks) % pairs;
  const int row = blockIdx.x / chunks / pairs;
  const int ta = 2 * width * pair, tb = ta + width;
  const int la = cin[row * tiles + ta];
  const int lb = tb < tiles ? cin[row * tiles + tb] : 0;
  const int total = la + lb;
  if (!LAST && chunk == 0 && tid == 0) cout[row * tiles + ta] = total;
  const int d0 = chunk * MERGE_CHUNK;
  if (d0 >= total) return;
  const int d1 = min(d0 + MERGE_CHUNK, total);
  const size_t rbase = static_cast<size_t>(row) * tiles * SORT_TILE;
  const uint64_t* a = in + rbase + static_cast<size_t>(ta) * SORT_TILE;
  const uint64_t* b = a + static_cast<size_t>(width) * SORT_TILE;
  if (tid < 64) {   // warp 0 splits at d0, warp 1 at d1
    const int at = merge_split_warp(a, la, b, lb, tid < 32 ? d0 : d1,
                                    tid & 31);
    if ((tid & 31) == 0) split[tid >> 5] = at;
  }
  __syncthreads();
  const int a0 = split[0], b0 = d0 - a0;
  const int na = split[1] - a0, m = d1 - d0;
  for (int k = tid; k < m; k += MERGE_THREADS)
    runs[at(k)] = k < na ? a[a0 + k] : b[b0 + k - na];
  __syncthreads();
  // this thread's diagonal: merge_split in shared memory, then its run
  const int dt = min(tid * MERGE_RUN, m), nb = m - na;
  int i = max(0, dt - nb), hi = min(dt, na);
  while (i < hi) {
    const int mid = (i + hi) >> 1;
    if (runs[at(mid)] < runs[at(na + dt - 1 - mid)])
      i = mid + 1;
    else
      hi = mid;
  }
  int j = dt - i;
  for (int k = 0; k < MERGE_RUN && dt + k < m; ++k)
    merged[at(dt + k)] =
        j >= nb || (i < na && runs[at(i)] < runs[at(na + j)])
            ? runs[at(i++)] : runs[at(na + j++)];
  __syncthreads();
  if (!LAST) {
    uint64_t* dst = out + rbase + static_cast<size_t>(ta) * SORT_TILE + d0;
    for (int k = tid; k < m; k += MERGE_THREADS) dst[k] = merged[at(k)];
  }
  for (int k = tid; LAST && k < m; k += MERGE_THREADS) {
    const uint64_t cur = merged[at(k)];
    uint64_t pre = 0;
    if (k)
      pre = merged[at(k - 1)];
    else if (a0 > 0 || b0 > 0)   // the key before the chunk: the larger
      pre = a0 > 0 && (b0 == 0 || a[a0 - 1] > b[b0 - 1]) ? a[a0 - 1]
                                                          : b[b0 - 1];
    else
      continue;
    if (pre >> 32 != cur >> 32) continue;
    const uint32_t e = static_cast<uint32_t>(cur);
    const uint32_t f = static_cast<uint32_t>(pre);
    constexpr uint32_t TILE_MASK = ~static_cast<uint32_t>(SORT_TILE - 1);
    prev[static_cast<size_t>(row) * n + (e & TILE_MASK) + firsts[rbase + e]] =
        static_cast<int32_t>((f & TILE_MASK) + lasts[rbase + f]);
  }
}

// Rows a group of the sorted links for B rows of n bytes.
inline int links_sort_group(int B, int n) {
  const long long pad =
      static_cast<long long>((n + SORT_TILE - 1) / SORT_TILE) * SORT_TILE;
  return static_cast<int>(max(1ll, min(static_cast<long long>(B),
                                       SORT_GROUP / max(pad, 1ll))));
}

// Bytes of launch_links_sorted's scratch for B rows of n bytes: for a
// group's rows, each padded to whole tiles, two buffers of 8-byte entries,
// their first and last positions (u16), and two buffers of tile counts.
inline long long links_sorted_scratch(int B, int n) {
  const long long tiles = (n + SORT_TILE - 1) / SORT_TILE;
  const long long g = links_sort_group(B, n);
  return g * tiles * (SORT_TILE * (2ll * 8 + 2 * 2) + 2 * 4);
}

// The sorted links: blocks (B, n) u8 and lengths (B,) i32 in, prev (B, n)
// i32 out, every entry written; bits 0..32; scratch of links_sorted_scratch
// bytes.  For each group of rows: the tile kernel, then
// ceil(log2(tiles)) merge rounds, on `s`; returns the first error.
template <class Key, int TAIL>
inline cudaError_t launch_links_sorted(const void* blocks,
                                       const void* lengths, int B, int n,
                                       int bits, void* prev, void* scratch,
                                       cudaStream_t s) {
  if (bits < 0 || bits > 32 || B < 0 || n < 0) return cudaErrorInvalidValue;
  if (B == 0 || n == 0) return cudaSuccess;
  const int tiles = (n + SORT_TILE - 1) / SORT_TILE;
  const long long pad = static_cast<long long>(tiles) * SORT_TILE;
  if (pad > 0x7FFFFFFF) return cudaErrorInvalidValue;
  const int group = links_sort_group(B, n);
  const size_t cells = static_cast<size_t>(group) * pad;
  uint64_t* ents[2] = {static_cast<uint64_t*>(scratch),
                       static_cast<uint64_t*>(scratch) + cells};
  uint16_t* firsts = reinterpret_cast<uint16_t*>(ents[1] + cells);
  uint16_t* lasts = firsts + cells;
  int* counts[2] = {reinterpret_cast<int*>(lasts + cells),
                    reinterpret_cast<int*>(lasts + cells) +
                        static_cast<size_t>(group) * tiles};
  int rounds = 0;
  while ((1 << rounds) < tiles) ++rounds;
  for (int r0 = 0; r0 < B; r0 += group) {
    const int rows = min(group, B - r0);
    const uint8_t* rb = static_cast<const uint8_t*>(blocks) +
                        static_cast<size_t>(r0) * n;
    const int32_t* rl = static_cast<const int32_t*>(lengths) + r0;
    int32_t* rp = static_cast<int32_t*>(prev) + static_cast<size_t>(r0) * n;
    const long long grid = static_cast<long long>(rows) * tiles;
    if (grid > 0x7FFFFFFF) return cudaErrorInvalidValue;
    if (bits <= 32 - P_BITS)   // the keys fit 32 bits
      links_sort_tile_kernel<Key, TAIL, uint32_t>
          <<<static_cast<unsigned>(grid), SORT_THREADS, 0, s>>>(
              rb, rl, n, bits, rp, ents[0], firsts, lasts, counts[0]);
    else
      links_sort_tile_kernel<Key, TAIL, uint64_t>
          <<<static_cast<unsigned>(grid), SORT_THREADS, 0, s>>>(
              rb, rl, n, bits, rp, ents[0], firsts, lasts, counts[0]);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    for (int r = 0; r < rounds; ++r) {
      const int width = 1 << r;
      const int pairs = (tiles + 2 * width - 1) / (2 * width);
      const long long per = 2ll * width * SORT_TILE;
      const int chunks = static_cast<int>((per + MERGE_CHUNK - 1) /
                                          MERGE_CHUNK);
      const long long blocks_ = static_cast<long long>(rows) * pairs * chunks;
      if (blocks_ > 0x7FFFFFFF) return cudaErrorInvalidValue;
      const int k = r & 1;
      if (r + 1 < rounds)
        links_merge_kernel<false>
            <<<static_cast<unsigned>(blocks_), MERGE_THREADS, 0, s>>>(
                ents[k], ents[k ^ 1], counts[k], counts[k ^ 1], tiles, width,
                chunks, n, rp, firsts, lasts);
      else
        links_merge_kernel<true>
            <<<static_cast<unsigned>(blocks_), MERGE_THREADS, 0, s>>>(
                ents[k], ents[k ^ 1], counts[k], counts[k ^ 1], tiles, width,
                chunks, n, rp, firsts, lasts);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

}  // namespace
}  // namespace lz4s
