// lz4_dense.cu — tpuzip's device LZ4 block ENCODER (codec "lz4" from
// compress_from_device, and compress with device_encode), in two launches
// on either of two routes, chosen by shape in kernels/lz4_dense.py.
//
// It replaces tpuzip's XLA encoder, tpuzip/codecs/lz4.py:179 `encode` (its
// candidates from `_candidates` :153, its bytes from `_serialize` :265,
// batched by `encode_batch` :320); tpuzip has no Pallas kernel for it.  The
// function (kernels/lz4_dense.py is the plain version, chip_smoke.py holds
// the two equal):
//   - candidates: for every position p < length - 12, the last earlier
//     position with the same hash, h = (seq * 2654435761) >> (32 -
//     hash_log) on its 4 bytes seq, and 0 at every position when hash_log
//     is not in 1..32 (XLA's shift by 32 or more, or by a negative count;
//     the wrapper passes 0 for those, and the shift is written by hand, as
//     x >> 32 on a u32 is undefined in C++).  Every position enters the
//     table, inside matches too.  Kept where it lies at most 65535 back and
//     its 4 bytes equal p's, else -1 (and -1 from length - 12 on);
//   - parse: at i, a candidate's match extended while the bytes agree
//     before length - 5, emitted, and the parse goes on at its end;
//     without one, at the next position with a candidate.  The last
//     literals end the stream; an empty block is the byte 0.
//
// What bounds it on this card: not bytes but chains of dependent loads.
// The candidates are a serial table walk in XLA's sort's clothing: a
// position's candidate is the table's slot as the positions before it left
// it.  The parse is a chain a sequence: the next position depends on the
// match's length, which depends on the bytes it compares.
//
// The shared route (rows of at most 65,536 bytes, at most 16 bits of
// hash: compress_from_device's 15 bits on 64 KiB blocks):
//   - words: a CTA of 8 warps a row, lz4_shared.cuh's split_row over a
//     direct table of u16 slots in shared memory (64 KiB at 15 bits), the
//     row read through L1 (3 CTAs an SM): warp w takes the positions whose
//     hash is w mod 8, so each runs an eighth of the row's table steps
//     (and 128 positions inside a run of one hash, as a zero page, skip
//     the steps: on zero rows the words took 10.9 ms without that, 2.6
//     with it).  Each candidate that passes the filter gets its match's
//     length, capped at WORD_CAP, in a word: m << 16 | distance, or
//     MARKED | distance from the cap on.  A CTA of one warp a row with its table and row in
//     shared memory (the form first planned) ran one row an SM, 8 waves
//     of a 2 ms serial chain; its 15.7 ms lost to the old 10.2 (PERF.md,
//     section 6);
//   - parse over the words, one warp a row: the next word by a ballot
//     over 32, the match's length from the word (walked from device
//     memory only where MARKED); the row's bytes and words streamed
//     through shared memory in chunks of 2,048 positions, the next
//     loading by TMA while the parse reads one (RowStream); the sequences
//     written 32 at once (put_batch), so the chain of dependent steps
//     carries no store.
//
// The keyed route (the rest), the first form's two kernels:
//   - candidates, 32 positions a warp step: lane l hashes p = base + l,
//     __match_any_sync groups the lanes that share a hash, a lane's
//     candidate is the highest earlier lane of its group, else the slot
//     read before this step's writes (by the group's first lane), and the
//     group's last lane writes the slot.  So a step is one table read and
//     one write a hash, not 32 dependent ones.  This is lz4_encode.cu's
//     probe step without the chain through matches: every position probes,
//     so no step waits on a verify;
//   - tables in device memory, one a row (a pool of fewer, walking the
//     rows, where the rows' tables would pass the wrapper's POOL_BYTES).
//     Up to DIRECT_MAX_LOG = 12 bits of hash (kernels/lz4_dense.py) a
//     table is direct, 2^bits int32 slots: 16 KiB, so 1024 rows' tables
//     stay in L2 beside the rows.  Past it a table is keyed: open
//     addressing on the full h over 2^slots_log slots of (position << 32
//     | h), twice the hashes a row can hold, so at most half full; a
//     group's first lane probes for h, its last inserts, with atomicCAS on
//     an empty slot (other groups insert other hashes in the same step).
//     tpuzip accepts any hash_log, and a direct table of 2^30 slots would
//     be 4 GiB a row; and at compress_from_device's 15 bits, 1024 direct
//     tables of 128 KiB took 58 ms on the H100, the keyed ones 6.4 (the
//     direct route lost its speed only beside both the table's writes and
//     the verify loads: either alone left it at 2.6-3.9 ms).  Both are
//     exact: a slot holds the last position of its hash.  Each row's
//     slots are salted by its index, so the rows' hot hashes (a common
//     4-gram) do not meet at one offset of every table;
//   - parse, one warp a row: the next candidate by a ballot over 32 cand
//     entries held in registers (a window reused by the sequences inside
//     it), the match extended 32 bytes a ballot, and token, literals and
//     extensions written 32 bytes a step, as lz4_encode.cu writes them
//     (its put_ext and put_literals, copied).
// The output never passes n + n/255 + 16, the row's capacity (the argument
// at the end of lz4_encode.cu's note holds for any greedy parse).

#include <cuda_runtime.h>

#include <cstdint>

#include "lz4_shared.cuh"

namespace {

using lz4s::FULL;
using lz4s::HASH_MUL;
using lz4s::LAST_LITERALS;
using lz4s::MARKED;
using lz4s::MF_LIMIT;
using lz4s::MIN_MATCH;

constexpr uint32_t SLOT_MUL = 0x9E3779B1u;   // spreads h over keyed slots
constexpr unsigned long long EMPTY = ~0ull;   // a keyed slot's empty value

__device__ __forceinline__ uint32_t load4(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (uint32_t(p[3]) << 24);
}

// The hash of seq at `bits` bits (1..32), or 0 for bits 0.
__device__ __forceinline__ uint32_t hash_of(uint32_t seq, int bits) {
  return bits ? (seq * HASH_MUL) >> (32 - bits) : 0u;
}

// A row's salt: its tables place hash h at slot h ^ salt (direct) or from
// (h ^ salt) * SLOT_MUL (keyed), so that the rows' hot hashes (a common
// 4-gram of text) do not meet at one offset of every table.
__device__ __forceinline__ uint32_t row_salt(int row) {
  return static_cast<uint32_t>(row) * SLOT_MUL;
}

// The direct table's slot of hash h of `bits` bits.
__device__ __forceinline__ uint32_t direct_slot(uint32_t h, uint32_t salt,
                                                int bits) {
  return bits ? h ^ (salt >> (32 - bits)) : 0u;
}

// The keyed table's first slot to probe for h.
__device__ __forceinline__ uint32_t keyed_slot(uint32_t h, uint32_t salt,
                                               int slots_log) {
  return ((h ^ salt) * SLOT_MUL) >> (32 - slots_log);
}

// The keyed table's last position of hash h, or -1.
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

// p becomes the keyed table's last position of hash h.  Only this lane
// writes h's slot this step; other lanes may claim empty slots at once.
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

// Rows blockIdx.x, + gridDim.x, ...; table blockIdx.x of `tables` (direct:
// 2^bits int32 slots; KEYED: 2^slots_log slots of 8 bytes).
template <bool KEYED>
__global__ void __launch_bounds__(32)
lz4_dense_candidates_kernel(const uint8_t* __restrict__ blocks,
                            const int32_t* __restrict__ lengths, int B,
                            int n, int32_t* __restrict__ cand,
                            void* __restrict__ tables, int bits,
                            int slots_log) {
  const int lane = threadIdx.x;
  const unsigned below = (1u << lane) - 1;     // lanes before this one
  const unsigned above = ~((2u << lane) - 1);  // lanes after it
  const int tlog = KEYED ? slots_log : bits;
  // 16-byte words of the table (a direct one of fewer than 4 slots: 1)
  const size_t words =
      max((size_t{1} << tlog) * (KEYED ? 8 : 4) / 16, size_t{1});
  int4* table = static_cast<int4*>(tables) + blockIdx.x * words;
  int32_t* direct = reinterpret_cast<int32_t*>(table);
  unsigned long long* keyed = reinterpret_cast<unsigned long long*>(table);
  for (int row = blockIdx.x; row < B; row += gridDim.x) {
    for (size_t k = lane; k < words; k += 32)   // every slot -1: EMPTY too
      table[k] = make_int4(-1, -1, -1, -1);
    __syncwarp();
    const uint8_t* src = blocks + static_cast<size_t>(row) * n;
    int32_t* out = cand + static_cast<size_t>(row) * n;
    const int len = min(max(lengths[row], 0), n);
    const int limit = max(len - MF_LIMIT, 0);
    const uint32_t salt = row_salt(row);
    // positions from limit on take no candidate and are no one's: a
    // candidate lies before a position below limit
    for (int base = 0; base < limit; base += 32) {
      const int p = base + lane;
      const bool live = p < limit;               // p + 3 < n: in the row
      const uint32_t seq = live ? load4(src + p) : 0;
      const uint32_t h = hash_of(seq, bits);
      const unsigned lanes = __ballot_sync(FULL, live);
      unsigned group = 0;
      if (live) group = __match_any_sync(lanes, h);
      const unsigned earlier = group & below;
      int c = -1;
      if (live)
        c = earlier ? base + 31 - __clz(earlier)
              : KEYED ? keyed_find(keyed, h, salt, slots_log)
                      : direct[direct_slot(h, salt, bits)];
      __syncwarp();   // every slot read before this step writes one
      if (live && !(group & above)) {
        if (KEYED)
          keyed_put(keyed, h, salt, p, slots_log);
        else
          direct[direct_slot(h, salt, bits)] = p;
      }
      if (live)
        out[p] = c >= 0 && p - c <= 0xFFFF && load4(src + c) == seq ? c : -1;
      __syncwarp();   // this step's writes before the next step's reads
    }
    for (int p = limit + lane; p < n; p += 32) out[p] = -1;
    __syncwarp();     // this row's table writes before the next row's reset
  }
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
// (As in lz4_encode.cu; src a pointer or lz4_shared.cuh's RowStream.)
template <class Src>
__device__ __forceinline__ int put_literals(uint8_t* dst, int o,
                                            const Src& src, int anchor,
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
lz4_dense_parse_kernel(const uint8_t* __restrict__ blocks,
                       const int32_t* __restrict__ lengths,
                       const int32_t* __restrict__ cand, int n,
                       uint8_t* __restrict__ comp, int cap,
                       int32_t* __restrict__ clens) {
  const int lane = threadIdx.x;
  const int row = blockIdx.x;
  const uint8_t* src = blocks + static_cast<size_t>(row) * n;
  const int32_t* cnd = cand + static_cast<size_t>(row) * n;
  uint8_t* dst = comp + static_cast<size_t>(row) * cap;
  const int len = min(max(lengths[row], 0), n);
  const int limit = max(len - MF_LIMIT, 0);
  const int end = len - LAST_LITERALS;
  int i = 0, anchor = 0, o = 0;
  // a window of 32 cand entries, from wbase, held a lane each
  int wbase = 0;
  int cv = lane < limit ? cnd[lane] : -1;
  while (i < limit) {
    if (i >= wbase + 32) {
      wbase = i;
      cv = wbase + lane < limit ? cnd[wbase + lane] : -1;
    }
    const unsigned hits = __ballot_sync(FULL, cv >= 0 && wbase + lane >= i);
    if (!hits) {
      i = wbase + 32;
      continue;
    }
    const int k = __ffs(hits) - 1;
    const int at = wbase + k;
    const int c = __shfl_sync(FULL, cv, k);
    // extend forward, 32 bytes a step, while the bytes agree before end
    int m = at + MIN_MATCH;
    for (int cc = c + MIN_MATCH;; m += 32, cc += 32) {
      const int q = m + lane;
      const bool stop = q >= end || src[q] != src[cc + lane];
      const unsigned hit = __ballot_sync(FULL, stop);
      if (hit) {
        m += __ffs(hit) - 1;
        break;
      }
    }
    const int ml = m - at - MIN_MATCH;
    o = put_literals(dst, o, src, anchor, at - anchor, min(ml, 15), lane);
    if (lane == 0) {
      dst[o] = static_cast<uint8_t>((at - c) & 0xFF);
      dst[o + 1] = static_cast<uint8_t>((at - c) >> 8);
    }
    o += 2;
    if (ml >= 15) o += put_ext(dst, o, ml, lane);
    i = anchor = m;
  }
  o = put_literals(dst, o, src, anchor, len - anchor, 0, lane);
  if (lane == 0) clens[row] = o;
}

// The shared route's words: a word a position p below length - 12 with a
// candidate c (filtered as above): the match's length m, from the 4 bytes
// on while the bytes agree before length - 5, capped at WORD_CAP: m << 16
// | (p - c), or MARKED | (p - c) where it reached WORD_CAP before length -
// 5; 0 where there is no candidate and from length - 12 on.  Rows
// blockIdx.x, + gridDim.x, ...: SPLIT_CLASSES warps a row on
// lz4_shared.cuh's split_row against a direct table of 2^bits u16 slots in
// shared memory, the row read through L1 (staged in shared memory beside
// the table the row took 3.21 ms against 2.38 at the serving path's shape:
// one CTA an SM against three).
constexpr int WORD_CAP = 64;

__global__ void __launch_bounds__(32 * lz4s::SPLIT_CLASSES)
lz4_dense_words_kernel(const uint8_t* __restrict__ blocks,
                       const int32_t* __restrict__ lengths, int B, int n,
                       int bits, int32_t* __restrict__ words) {
  constexpr int THREADS = 32 * lz4s::SPLIT_CLASSES;
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* queues = reinterpret_cast<uint32_t*>(smem);
  uint16_t* table = reinterpret_cast<uint16_t*>(smem + lz4s::QUEUE_BYTES);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int row = blockIdx.x; row < B; row += gridDim.x) {
    const uint8_t* src = blocks + static_cast<size_t>(row) * n;
    const int skew = lz4s::skew_of(src);
    const uint8_t* base = src - skew;   // byte q at base[q + skew]
    int32_t* out = words + static_cast<size_t>(row) * n;
    const int len = min(max(lengths[row], 0), n);
    const int limit = max(len - MF_LIMIT, 0);
    const int end = len - LAST_LITERALS;
    __syncthreads();   // the last row's steps on the table done
    for (int k = tid; k < lz4s::table_bytes(bits) / 16; k += THREADS)
      reinterpret_cast<int4*>(table)[k] = make_int4(0, 0, 0, 0);
    for (int p = limit + tid; p < n; p += THREADS) out[p] = 0;
    __syncthreads();
    lz4s::split_row(
        base, skew, limit, bits, table, queues + 64 * warp, warp, lane,
        [&](int p, int c) {
          int32_t w = 0;
          if (c >= 0 && p - c <= 0xFFFF &&
              lz4s::load4_at(base, c + skew) ==
                  lz4s::load4_at(base, p + skew)) {
            const int most = min(end - p, WORD_CAP);
            const int m = MIN_MATCH +
                          lz4s::extend_at(base, c + skew + MIN_MATCH,
                                          p + skew + MIN_MATCH,
                                          most - MIN_MATCH);
            w = (m >= WORD_CAP && WORD_CAP < end - p ? MARKED : m << 16) |
                (p - c);
          }
          out[p] = w;
        });
  }
}

// The parse over the words, one warp a row: the next position with a word
// by a ballot over a window of 32 (aligned), its match from the word, or
// extended exactly from device memory where MARKED (32 bytes a ballot);
// lz4_dense_parse_kernel's bytes, written 32 sequences at a time
// (lz4_shared.cuh's put_batch).  STREAM: the row's bytes and words reach
// it through shared memory (lz4_shared.cuh's RowStream).
template <bool STREAM>
__global__ void __launch_bounds__(32)
lz4_dense_words_parse_kernel(const uint8_t* __restrict__ blocks,
                             const int32_t* __restrict__ lengths,
                             const int32_t* __restrict__ words, int n,
                             uint8_t* __restrict__ comp, int cap,
                             int32_t* __restrict__ clens) {
  __shared__ __align__(16) uint8_t sbytes[2 * lz4s::STREAM_CHUNK];
  __shared__ __align__(16) int32_t swords[2 * lz4s::STREAM_CHUNK];
  __shared__ uint64_t sbar[2];
  const int lane = threadIdx.x;
  const int row = blockIdx.x;
  const uint8_t* src = blocks + static_cast<size_t>(row) * n;
  uint8_t* dst = comp + static_cast<size_t>(row) * cap;
  const int len = min(max(lengths[row], 0), n);
  const int limit = max(len - MF_LIMIT, 0);
  const int end = len - LAST_LITERALS;
  if (STREAM && lane == 0) {
    lz4s::bar_init(sbar, 1);
    lz4s::bar_init(sbar + 1, 1);
    lz4s::bar_init_fence();
  }
  __syncwarp();
  lz4s::RowStream<STREAM> rs(src, words + static_cast<size_t>(row) * n, n,
                             limit, lane, sbytes, swords, sbar);
  int i = 0, anchor = 0, o = 0;
  // the sequences parsed and not written yet, lane k holding the k-th;
  // written before the parse leaves their chunk, so that their literals
  // are read from shared memory
  lz4s::Seq mine{0, 0, 0, 0};
  int count = 0;
  auto flush = [&]() {
    o = lz4s::put_batch(dst, o, rs, mine, count, lane);
    count = 0;
  };
  int wbase = -32, w = 0;
  while (i < limit) {
    if (i >= wbase + 32) {
      wbase = i & ~31;
      if (STREAM && count && wbase / lz4s::STREAM_CHUNK != rs.cur) flush();
      w = rs.window(wbase);
    }
    const unsigned hits = __ballot_sync(FULL, w != 0 && wbase + lane >= i);
    if (!hits) {
      i = wbase + 32;
      continue;
    }
    const int k = __ffs(hits) - 1;
    const int at = wbase + k;
    const int word = __shfl_sync(FULL, w, k);
    const int c = at - (word & 0xFFFF);
    int m = at + (word >> 16);
    if (word < 0) {   // MARKED: the match walked exactly
      m = at + MIN_MATCH;
      for (int cc = c + MIN_MATCH;; m += 32, cc += 32) {
        const int q = m + lane;
        const bool stop = q >= end || src[q] != src[cc + lane];
        const unsigned hit = __ballot_sync(FULL, stop);
        if (hit) {
          m += __ffs(hit) - 1;
          break;
        }
      }
    }
    if (lane == count) mine = lz4s::Seq{anchor, at - anchor, at - c, m - at};
    if (++count == 32) flush();
    i = anchor = m;
  }
  if (count) flush();
  o = put_literals(dst, o, rs, anchor, len - anchor, 0, lane);
  if (lane == 0) clens[row] = o;
  rs.finish();
}

}  // namespace

// blocks (B, n) u8 and lengths (B,) i32 in; cand (B, n) i32 out, every
// entry written.  tables: ntab tables of scratch (1 <= ntab <= B), each
// 2^bits int32 (keyed 0) or 2^slots_log int64 (keyed 1, 2^slots_log at
// least twice min(n, 2^bits), 6 <= slots_log <= 31), and 16 bytes at
// least; bits 0..32, the hash's bits (0: h is 0).
// Launches ntab blocks of one warp on `stream` and returns
// cudaGetLastError().
extern "C" int tpz_lz4_dense_candidates(const void* blocks,
                                        const void* lengths, int B, int n,
                                        void* cand, void* tables, int ntab,
                                        int bits, int slots_log, int keyed,
                                        void* stream) {
  auto kernel = keyed ? lz4_dense_candidates_kernel<true>
                      : lz4_dense_candidates_kernel<false>;
  kernel<<<ntab, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(blocks),
      static_cast<const int32_t*>(lengths), B, n, static_cast<int32_t*>(cand),
      tables, bits, slots_log);
  return static_cast<int>(cudaGetLastError());
}

// blocks (B, n) u8, lengths (B,) i32 and cand (B, n) i32 from
// tpz_lz4_dense_candidates in; comp (B, cap) u8, zeroed by the caller (cap
// >= n + n/255 + 16), and clens (B,) i32 out.  Launches B blocks of one
// warp on `stream` and returns cudaGetLastError().
extern "C" int tpz_lz4_dense_parse(const void* blocks, const void* lengths,
                                   const void* cand, int B, int n,
                                   void* comp, int cap, void* clens,
                                   void* stream) {
  lz4_dense_parse_kernel<<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(blocks),
      static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(cand), n, static_cast<uint8_t*>(comp), cap,
      static_cast<int32_t*>(clens));
  return static_cast<int>(cudaGetLastError());
}

// The shared route's words (n <= 65536, bits 0..16): blocks (B, n) u8 and
// lengths (B,) i32 in, words (B, n) i32 out, every entry written.  Sets
// the kernel's dynamic shared memory, launches as many CTAs of
// SPLIT_CLASSES warps as fit the card at once (at most B), each walking
// rows, on `stream`, and returns the first CUDA error.
extern "C" int tpz_lz4_dense_words(const void* blocks, const void* lengths,
                                   int B, int n, int bits, void* words,
                                   void* stream) {
  if (n > lz4s::STAGE_MAX || bits < 0 || bits > lz4s::SHARED_MAX_LOG)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 32 * lz4s::SPLIT_CLASSES;
  const int smem = lz4s::QUEUE_BYTES + lz4s::table_bytes(bits);
  int grid = 0;
  const cudaError_t err = lz4s::persistent_grid(
      reinterpret_cast<const void*>(lz4_dense_words_kernel), threads, smem,
      B, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  lz4_dense_words_kernel<<<grid, threads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(blocks),
      static_cast<const int32_t*>(lengths), B, n, bits,
      static_cast<int32_t*>(words));
  return static_cast<int>(cudaGetLastError());
}

// blocks (B, n) u8, lengths (B,) i32 and words (B, n) i32 from
// tpz_lz4_dense_words in; comp (B, cap) u8, zeroed by the caller (cap >= n
// + n/255 + 16), and clens (B,) i32 out.  Streams each row through shared
// memory where the rows and words are 16-byte aligned.  Launches B blocks
// of one warp on `stream` and returns cudaGetLastError().
extern "C" int tpz_lz4_dense_words_parse(const void* blocks,
                                         const void* lengths,
                                         const void* words, int B, int n,
                                         void* comp, int cap, void* clens,
                                         void* stream) {
  const bool stream_rows = reinterpret_cast<uintptr_t>(blocks) % 16 == 0 &&
                           reinterpret_cast<uintptr_t>(words) % 16 == 0 &&
                           n % 16 == 0;
  auto kernel = stream_rows ? lz4_dense_words_parse_kernel<true>
                            : lz4_dense_words_parse_kernel<false>;
  kernel<<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(blocks),
      static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(words), n, static_cast<uint8_t*>(comp),
      cap, static_cast<int32_t*>(clens));
  return static_cast<int>(cudaGetLastError());
}
