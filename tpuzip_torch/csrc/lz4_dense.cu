// lz4_dense.cu — tpuzip's device LZ4 block ENCODER (codec "lz4" from
// compress_from_device, and compress with device_encode), on one of three
// routes chosen by shape in kernels/lz4_dense.py.
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
//     its 4 bytes equal p's, else none (and none from length - 12 on);
//   - parse: at i, a candidate's match extended while the bytes agree
//     before length - 5, emitted, and the parse goes on at its end;
//     without one, at the next position with a candidate.  The last
//     literals end the stream; an empty block is the byte 0.
//
// What bounds it on this card: not bytes but chains of dependent steps.
// The candidates are a serial table walk in XLA's sort's clothing: a
// position's candidate is the table's slot as the positions before it left
// it.  The parse is a chain a sequence: the next position depends on the
// match's length, which depends on the bytes it compares.
//
// Every route writes words, a word a position: each candidate that passes
// the filter gets its match's length, capped at WORD_CAP, as m << 16 |
// distance, or MARKED | distance from the cap on; then the parse over the
// words.  The words come
//   - on the shared route (rows of at most 65,536 bytes, at most 16 bits of
//     hash: compress_from_device's 15 bits on 64 KiB blocks) from one
//     kernel, a CTA of 8 warps a row, lz4_shared.cuh's split_row over a
//     direct table of u16 slots in shared memory (64 KiB at 15 bits), the
//     row read through L1 (3 CTAs an SM): warp w takes the positions whose
//     hash is w mod 8, so each runs an eighth of the row's table steps
//     (and 128 positions inside a run of one hash, as a zero page, skip
//     the steps: on zero rows the words took 10.9 ms without that, 2.6
//     with it).  A CTA of one warp a row with its table and row in shared
//     memory (the form first planned) ran one row an SM, 8 waves of a 2 ms
//     serial chain; its 15.7 ms lost to the old 10.2 (PERF.md, section 6);
//   - on the tiled and sorted routes (wider rows, or more bits) from the
//     links of csrc/lz4_links.cu (the candidates before the filter), then
//     a thread a position here: the filter and the capped extension.
// The parse over the words, one warp a row at any width: the next word by
// a ballot over 32, the match's length from the word (walked from device
// memory only where MARKED); the row's bytes and words streamed through
// shared memory in chunks of 2,048 positions, the next loading by TMA
// while the parse reads one (RowStream); the sequences written 32 at once
// (put_batch), so the chain of dependent steps carries no store.  A word's
// distance fits its 16 bits at any width, as the filter keeps only
// candidates at most 65,535 back.
// As first ported (PR 13), rows past the shared route took one warp a row:
// the candidates 32 positions a step against an open-addressing table of
// 8-byte slots in device memory, then a parse that extended every match
// from device memory (PERF.md §6, row 13).
// The output never passes n + n/255 + 16, the row's capacity (the argument
// at the end of lz4_encode.cu's note holds for any greedy parse).

#include <cuda_runtime.h>

#include <cstdint>

#include "lz4_shared.cuh"

namespace {

using lz4s::FULL;
using lz4s::LAST_LITERALS;
using lz4s::MARKED;
using lz4s::MF_LIMIT;
using lz4s::MIN_MATCH;

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

// The word of position p below length - 12 (end = length - 5) with
// candidate c, the row's byte q at base[q + skew] (lz4_shared.cuh's
// load4_at): where c passes the filter (c >= 0, at most 65,535 back, its 4
// bytes equal p's), the match's length m, from the 4 bytes on while the
// bytes agree before end, capped at WORD_CAP: m << 16 | (p - c), or
// MARKED | (p - c) where it reached WORD_CAP before end; else 0.
constexpr int WORD_CAP = 64;

__device__ __forceinline__ int32_t word_of(const uint8_t* base, int skew,
                                           int p, int c, int end) {
  if (c < 0 || p - c > 0xFFFF ||
      lz4s::load4_at(base, c + skew) != lz4s::load4_at(base, p + skew))
    return 0;
  const int most = min(end - p, WORD_CAP);
  const int m = MIN_MATCH + lz4s::extend_at(base, c + skew + MIN_MATCH,
                                            p + skew + MIN_MATCH,
                                            most - MIN_MATCH);
  return (m >= WORD_CAP && WORD_CAP < end - p ? MARKED : m << 16) | (p - c);
}

// The shared route's words: word_of every position p below length - 12 at
// its candidate, 0 from length - 12 on.  Rows blockIdx.x, + gridDim.x,
// ...: SPLIT_CLASSES warps a row on lz4_shared.cuh's split_row against a
// direct table of 2^bits u16 slots in shared memory, the row read through
// L1 (staged in shared memory beside the table the row took 3.21 ms
// against 2.38 at the serving path's shape: one CTA an SM against three).
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
        [&](int p, int c) { out[p] = word_of(base, skew, p, c, end); });
  }
}

// The words of the tiled and sorted routes, from the links (csrc/
// lz4_links.cu: the candidates before the filter), a thread a position:
// word_of at prev[p] below length - 12, 0 from it on.  Blocks of
// WORDS_THREADS positions, per_row a row.  The row is read through L1.
constexpr int WORDS_THREADS = 256;

__global__ void __launch_bounds__(WORDS_THREADS)
lz4_dense_words_links_kernel(const uint8_t* __restrict__ blocks,
                             const int32_t* __restrict__ lengths,
                             const int32_t* __restrict__ prev, int n,
                             int per_row, int32_t* __restrict__ words) {
  const int row = blockIdx.x / per_row;
  const int p = (blockIdx.x % per_row) * WORDS_THREADS + threadIdx.x;
  if (p >= n) return;
  const uint8_t* src = blocks + static_cast<size_t>(row) * n;
  const int skew = lz4s::skew_of(src);
  const int len = min(max(lengths[row], 0), n);
  const size_t at = static_cast<size_t>(row) * n + p;
  words[at] = p < len - MF_LIMIT
                  ? word_of(src - skew, skew, p, prev[at], len - LAST_LITERALS)
                  : 0;
}

// The parse over the words, one warp a row: the next position with a word
// by a ballot over a window of 32 (aligned), its match from the word, or
// extended exactly from device memory where MARKED (32 bytes a ballot);
// the parse's bytes, written 32 sequences at a time
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

// The tiled and sorted routes' words: blocks (B, n) u8, lengths (B,) i32
// and prev (B, n) i32 (the links, tpz_lz4_links_tiled or _sorted) in,
// words (B, n) i32 out, every entry written.  Launches B ceil(n /
// WORDS_THREADS) blocks on `stream` and returns cudaGetLastError().
extern "C" int tpz_lz4_dense_words_links(const void* blocks,
                                         const void* lengths,
                                         const void* prev, int B, int n,
                                         void* words, void* stream) {
  const int per_row = (n + WORDS_THREADS - 1) / WORDS_THREADS;
  const long long grid = static_cast<long long>(B) * per_row;
  if (grid > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  if (grid == 0) return static_cast<int>(cudaSuccess);
  lz4_dense_words_links_kernel<<<static_cast<unsigned>(grid), WORDS_THREADS,
                                 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(blocks),
      static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(prev), n, per_row,
      static_cast<int32_t*>(words));
  return static_cast<int>(cudaGetLastError());
}

// blocks (B, n) u8, lengths (B,) i32 and words (B, n) i32 from
// tpz_lz4_dense_words or _words_links in; comp (B, cap) u8, zeroed by the caller (cap >= n
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
