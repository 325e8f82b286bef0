// lz4_shared.cuh — what csrc/lz4_dense.cu and csrc/lz4_chain.cu share on
// their shared-memory routes (rows of at most 65,536 bytes, hashes of at
// most 16 bits), and csrc/deflate_encode.cu's links on theirs: a row
// staged in shared memory by one TMA bulk copy and the mbarriers that
// order it; the candidates step split over the hash's classes
// (split_row); and, for the parses over words, a row streamed
// through shared memory (RowStream) and sequences written 32 at a time
// (put_batch).
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

}  // namespace lz4s
