// lz4_chain.cu — tpuzip's chained LZ4 block ENCODER (codec "lz4" at
// config.codec.lz4.max_chain > 1), in three launches: links, best, parse.
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
//   - best: best(p), the longest match over the first max_chain links that
//     lie at most 65535 back (the nearest on ties), extended while the bytes
//     agree before length - 5, as a word a position: best << 16 | (p - the
//     link), 0 where there is none, or MARKED where a link's match reached
//     the cap K before length - 5.  Below K every candidate's capped length
//     is its exact one, so the walk, its cheap rejects and its stop are the
//     C++'s and the word is exact; from K on it only says best >= K;
//   - parse: at i < length - 12, best(i) under 4 makes i a literal; else
//     the match is deferred to i + 1 while best(i + 1) is longer and i + 1
//     < length - 12 (one-step lazy matching), emitted, and the parse goes on
//     at its end.  The last literals end the stream; an empty block is the
//     byte 0.
//
// What bounds it on this card: not bytes but chains of dependent loads.  A
// probe walks its chain (each link a load of prev, then the candidate's
// bytes), and the parse's next probe depends on the match it found.  The
// earlier form (a warp a row probing windows of 32 positions in device memory)
// spent 68% of a window's cycles on the links' and cheap rejects' loads
// beside the other 1023 rows, 21% on extensions, and 73% of its links on
// positions the parse skipped (tools/step_clocks.py, PERF.md).
//
// What the design does about it:
//   - links, on rows of at most 65,536 bytes at hash_log <= 16:
//     lz4_shared.cuh's split_row without the filter, a CTA of 8 warps a
//     row, the row staged in shared memory by one TMA bulk copy beside a
//     direct table of u16 slots (128 KiB at 16 bits); warp w takes the
//     positions whose hash is w mod 8, so each runs an eighth of the row's
//     table steps (one warp on the whole row took 5.22 ms at the path's
//     shape, 8 split ones 2.03; PERF.md), and 128 positions inside a run
//     of one hash skip them (zero rows 3.1 ms without that, 1.3 with it).
//     Other rows take csrc/lz4_links.cu's links (kernels/lz4_chain.py
//     calls them): by tiles of split_row and a carry past 65,536 bytes,
//     by sorting at hash_log 17-24.  As first ported they took a keyed
//     table in device memory, a warp a row (a direct table of 2^24 slots
//     would be 64 MiB a row);
//   - best does not depend on the parse, so a CTA of 1024 threads a row
//     computes it at every position, a thread a position, with the row's
//     bytes (TMA) and its links as u16 distances (p - prev[p], 0 for none
//     or past 65,535, which end a walk as none does) staged in shared
//     memory, 192 KiB at 64 KiB rows: every chain load and byte compare
//     reads shared memory.  Capping the extension at K keeps a run from
//     costing the row's length at every position (LZ4's matches are
//     unbounded); a row wider than 65,536 bytes walks device memory;
//   - parse, one warp a row over windows of 32 words: the first match by a
//     ballot, the lazy steps by shuffles.  Only a MARKED word that the
//     parse emits, or that its lazy test compares with another MARKED one,
//     is walked exactly, by the whole warp from device memory (a link at a
//     time, 32 bytes a ballot): on a zero row that is the row's first match
//     alone.  The row's bytes and words are streamed through shared memory
//     (RowStream), and the sequences written 32 at once (put_batch).
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
using lz4s::persistent_grid;

constexpr int WINDOW = 0xFFFF;              // a link further back ends a walk
// best(p) as a word (the note's), the walk of the C++'s find_best over the
// links with the extension capped at K: Links::next(c) is the link after c
// (-1 where none), a link at or past p ends the walk as one past the
// window does.

struct SharedLinks {         // u16 distances in shared memory
  const uint16_t* dist;
  __device__ __forceinline__ int next(int c) const {
    const int d = dist[c];
    return d ? c - d : -1;
  }
};

struct DeviceLinks {         // prev itself, in device memory
  const int32_t* prv;
  __device__ __forceinline__ int next(int c) const { return prv[c]; }
};

// The row's byte q is base[q + skew] (lz4_shared.cuh's load4_at).
template <int K, class Links>
__device__ __forceinline__ int32_t best_word(const uint8_t* base, int skew,
                                             Links links, int p, int lim,
                                             int max_chain) {
  const int most = min(lim - p, K);
  int best = 0, at = -1;
  int c = links.next(p);
  for (int chain = max_chain; c >= 0 && c < p && p - c <= WINDOW &&
                              chain > 0;
       --chain) {
    // cheap reject at the best
    if (base[c + skew + best] == base[p + skew + best]) {
      const int m = lz4s::extend_at(base, c + skew, p + skew, most);
      if (m > best) {
        best = m;
        at = c;
        if (m >= most) break;               // the C++'s stop, or the cap
      }
    }
    c = links.next(c);
  }
  if (best >= K && K < lim - p) return MARKED;
  return at < 0 ? 0 : best << 16 | (p - at);
}

constexpr int BEST_THREADS = 1024;
constexpr int BEST_CAP = 64;   // K: 16, 32 and 258 measured no better

// Rows blockIdx.x, + gridDim.x, ...: words[p] of every position.  STAGED
// (n <= 65536): the row's bytes (one bulk copy where tma) and its links as
// u16 distances in shared memory first.
template <bool STAGED>
__global__ void __launch_bounds__(BEST_THREADS)
lz4_chain_best_kernel(const uint8_t* __restrict__ blocks,
                      const int32_t* __restrict__ lengths,
                      const int32_t* __restrict__ prev, int B, int n,
                      int max_chain, int32_t* __restrict__ words, int tma) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  uint8_t* staged = smem + 16;
  uint16_t* dist =
      reinterpret_cast<uint16_t*>(smem + 16 + ((n + 15) & ~15) + 16);
  const int tid = threadIdx.x;
  if (STAGED && tid == 0) {
    lz4s::bar_init(bar, 1);
    lz4s::bar_init_fence();
  }
  __syncthreads();
  unsigned loads = 0;
  for (int row = blockIdx.x; row < B; row += gridDim.x) {
    const uint8_t* row_src = blocks + static_cast<size_t>(row) * n;
    const int32_t* prv = prev + static_cast<size_t>(row) * n;
    int32_t* out = words + static_cast<size_t>(row) * n;
    const int len = min(max(lengths[row], 0), n);
    const int limit = max(len - MF_LIMIT, 0);
    const int lim = len - LAST_LITERALS;
    if (STAGED) {
      __syncthreads();   // the last row's readers done
      const bool bulk =
          lz4s::stage_row(staged, row_src, len, tma, bar, tid, BEST_THREADS);
      auto to_dist = [](int c, int p) {
        return static_cast<uint16_t>(c >= 0 && c < p && p - c <= WINDOW
                                         ? p - c : 0);
      };
      if (n % 4 == 0) {
        const int4* prv4 = reinterpret_cast<const int4*>(prv);
        for (int q = tid; q < n / 4; q += BEST_THREADS) {
          const int4 v = prv4[q];
          const int p = 4 * q;
          dist[p] = to_dist(v.x, p);
          dist[p + 1] = to_dist(v.y, p + 1);
          dist[p + 2] = to_dist(v.z, p + 2);
          dist[p + 3] = to_dist(v.w, p + 3);
        }
      } else {
        for (int p = tid; p < n; p += BEST_THREADS)
          dist[p] = to_dist(prv[p], p);
      }
      if (bulk) {
        lz4s::bar_wait(bar, loads & 1);
        ++loads;
      }
      __syncthreads();
      for (int p = tid; p < n; p += BEST_THREADS)
        out[p] = p < limit ? best_word<BEST_CAP>(staged, 0, SharedLinks{dist},
                                                 p, lim, max_chain)
                           : 0;
    } else {
      const int skew = lz4s::skew_of(row_src);
      for (int p = tid; p < n; p += BEST_THREADS)
        out[p] = p < limit ? best_word<BEST_CAP>(row_src - skew, skew,
                                                 DeviceLinks{prv}, p, lim,
                                                 max_chain)
                           : 0;
    }
  }
}

// best(p) exactly and its link (-1 with best 0 where none does), walked by
// the whole warp from device memory: the C++'s find_best, its extensions 32
// bytes a ballot.  Every lane returns the same.
__device__ __forceinline__ int walk_exact(const uint8_t* src,
                                          const int32_t* prv, int p, int lim,
                                          int max_chain, int lane, int& at) {
  int best = 0;
  at = -1;
  int c = prv[p];
  for (int chain = max_chain; c >= 0 && c < p && p - c <= WINDOW &&
                              chain > 0;
       --chain) {
    if (src[c + best] == src[p + best]) {
      const int most = lim - p;
      int m = 0;
      for (;; m += 32) {
        const int q = m + lane;
        const bool stop = q >= most || src[c + q] != src[p + q];
        const unsigned hit = __ballot_sync(FULL, stop);
        if (hit) {
          m += __ffs(hit) - 1;
          break;
        }
      }
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

// STREAM: the row's bytes and words reach the parse through shared memory
// (lz4_shared.cuh's RowStream), the next chunk loading while it reads one.
template <bool STREAM>
__global__ void __launch_bounds__(32)
lz4_chain_parse_kernel(const uint8_t* __restrict__ blocks,
                       const int32_t* __restrict__ lengths,
                       const int32_t* __restrict__ prev,
                       const int32_t* __restrict__ words, int n,
                       int max_chain, uint8_t* __restrict__ comp, int cap,
                       int32_t* __restrict__ clens) {
  __shared__ __align__(16) uint8_t sbytes[2 * lz4s::STREAM_CHUNK];
  __shared__ __align__(16) int32_t swords[2 * lz4s::STREAM_CHUNK];
  __shared__ uint64_t sbar[2];
  const int lane = threadIdx.x;
  const int row = blockIdx.x;
  const uint8_t* src = blocks + static_cast<size_t>(row) * n;
  const int32_t* prv = prev + static_cast<size_t>(row) * n;
  uint8_t* dst = comp + static_cast<size_t>(row) * cap;
  const int len = min(max(lengths[row], 0), n);
  const int limit = max(len - MF_LIMIT, 0);
  const int lim = len - LAST_LITERALS;
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
  // the window: the words of wbase .. wbase + 31 (aligned), a lane each
  int wbase = -32, w = 0;
  auto window = [&](int from) {
    wbase = from & ~31;
    if (STREAM && count && wbase / lz4s::STREAM_CHUNK != rs.cur) flush();
    w = rs.window(wbase);
  };
  auto word_at = [&](int pos) {
    if (pos >= wbase + 32) window(pos);
    return __shfl_sync(FULL, w, pos - wbase);
  };
  while (i < limit) {
    if (i >= wbase + 32) window(i);
    const unsigned hits = __ballot_sync(
        FULL, (w < 0 || (w >> 16) >= MIN_MATCH) && wbase + lane >= i);
    if (!hits) {
      i = wbase + 32;
      continue;
    }
    int at = wbase + __ffs(hits) - 1;
    const int first = __shfl_sync(FULL, w, at - wbase);
    // the current match: MARKED (best >= K) or not, and exact once known
    bool marked = first < 0, exact = !marked;
    int best = marked ? 0 : first >> 16;
    int c = marked ? -1 : at - (first & 0xFFFF);
    // one-step lazy matching: defer while the next position's is longer
    while (at + 1 < limit) {
      const int next = word_at(at + 1);
      if (next >= 0) {   // below K: longer only than an unmarked best
        if (marked || (next >> 16) <= best) break;
        ++at;
        best = next >> 16;
        c = at - (next & 0xFFFF);
        continue;
      }
      if (!marked) {     // K or more against below K
        ++at;
        marked = true;
        exact = false;
        continue;
      }
      if (!exact) {      // both MARKED: both walked
        best = walk_exact(src, prv, at, lim, max_chain, lane, c);
        exact = true;
      }
      int nc;
      const int nb = walk_exact(src, prv, at + 1, lim, max_chain, lane, nc);
      if (nb <= best) break;
      ++at;
      best = nb;
      c = nc;
    }
    if (!exact) best = walk_exact(src, prv, at, lim, max_chain, lane, c);
    if (lane == count) mine = lz4s::Seq{anchor, at - anchor, at - c, best};
    if (++count == 32) flush();
    i = anchor = at + best;
  }
  if (count) flush();
  o = put_literals(dst, o, rs, anchor, len - anchor, 0, lane);
  if (lane == 0) clens[row] = o;
  rs.finish();
}

// links on the shared route (n <= 65536, bits <= 16), rows blockIdx.x, +
// gridDim.x, ...: the row staged (one bulk copy where tma) and a direct
// table of 2^bits u16 slots in shared memory, lz4_shared.cuh's split_row
// over SPLIT_CLASSES warps, no filter.
__global__ void __launch_bounds__(32 * lz4s::SPLIT_CLASSES)
lz4_chain_links_shared_kernel(const uint8_t* __restrict__ blocks,
                              const int32_t* __restrict__ lengths, int B,
                              int n, int32_t* __restrict__ prev, int bits,
                              int tma) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  constexpr int THREADS = 32 * lz4s::SPLIT_CLASSES;
  uint32_t* queues = reinterpret_cast<uint32_t*>(smem + 16);
  uint16_t* table = reinterpret_cast<uint16_t*>(smem + 16 + lz4s::QUEUE_BYTES);
  uint8_t* staged = smem + 16 + lz4s::QUEUE_BYTES + lz4s::table_bytes(bits);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    lz4s::bar_init(bar, 1);
    lz4s::bar_init_fence();
  }
  __syncthreads();
  unsigned loads = 0;
  for (int row = blockIdx.x; row < B; row += gridDim.x) {
    const uint8_t* row_src = blocks + static_cast<size_t>(row) * n;
    int32_t* out = prev + static_cast<size_t>(row) * n;
    const int len = min(max(lengths[row], 0), n);
    const int limit = max(len - MF_LIMIT, 0);
    __syncthreads();   // the last row's reads of the row and table done
    const bool bulk =
        lz4s::stage_row(staged, row_src, len, tma, bar, tid, THREADS);
    for (int k = tid; k < lz4s::table_bytes(bits) / 16; k += THREADS)
      reinterpret_cast<int4*>(table)[k] = make_int4(0, 0, 0, 0);
    for (int p = limit + tid; p < n; p += THREADS) out[p] = -1;
    if (bulk) {
      lz4s::bar_wait(bar, loads & 1);
      ++loads;
    }
    __syncthreads();
    lz4s::split_row(staged, 0, limit, bits, table, queues + 64 * warp, warp,
                    lane, [&](int p, int c) { out[p] = c; });
  }
}

}  // namespace

// links on the shared route: blocks (B, n) u8 and lengths (B,) i32 in,
// prev (B, n) i32 out, every entry written; n <= 65536, bits 4..16.  Sets
// the kernel's dynamic shared memory, launches as many CTAs of
// SPLIT_CLASSES warps as fit the card at once (at most B), each walking
// rows, on `stream`, and returns the first CUDA error.
extern "C" int tpz_lz4_chain_links_shared(const void* blocks,
                                          const void* lengths, int B, int n,
                                          void* prev, int bits,
                                          void* stream) {
  if (n > lz4s::STAGE_MAX || bits < 4 || bits > lz4s::SHARED_MAX_LOG)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tma =
      reinterpret_cast<uintptr_t>(blocks) % 16 == 0 && n % 16 == 0;
  const int threads = 32 * lz4s::SPLIT_CLASSES;
  const int smem = 16 + lz4s::QUEUE_BYTES + lz4s::table_bytes(bits) +
                   ((n + 15) & ~15) + 16;
  int grid = 0;
  const cudaError_t err = persistent_grid(
      reinterpret_cast<const void*>(lz4_chain_links_shared_kernel), threads,
      smem, B, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  lz4_chain_links_shared_kernel<<<grid, threads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(blocks),
      static_cast<const int32_t*>(lengths), B, n, static_cast<int32_t*>(prev),
      bits, tma);
  return static_cast<int>(cudaGetLastError());
}

// blocks (B, n) u8, lengths (B,) i32 and prev (B, n) i32 from the links
// in; words (B, n) i32 out, every entry written (the note's best words,
// extensions capped at BEST_CAP); max_chain >= 1.  Rows of at most 65,536
// bytes are staged in shared memory.  Launches as many CTAs of 1024
// threads as fit the card at once (at most B) on `stream` and returns the
// first CUDA error.
extern "C" int tpz_lz4_chain_best(const void* blocks, const void* lengths,
                                  const void* prev, int B, int n,
                                  int max_chain, void* words, void* stream) {
  const bool staged = n <= lz4s::STAGE_MAX;
  auto kernel = staged ? lz4_chain_best_kernel<true>
                       : lz4_chain_best_kernel<false>;
  const int tma =
      reinterpret_cast<uintptr_t>(blocks) % 16 == 0 && n % 16 == 0;
  const int smem =
      staged ? 16 + ((n + 15) & ~15) + 16 + 2 * ((n + 7) & ~7) : 0;
  int grid = 0;
  const cudaError_t err = persistent_grid(
      reinterpret_cast<const void*>(kernel), BEST_THREADS, smem, B, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, BEST_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(blocks),
      static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(prev), B, n, max_chain,
      static_cast<int32_t*>(words), tma);
  return static_cast<int>(cudaGetLastError());
}

// blocks (B, n) u8, lengths (B,) i32, prev (B, n) i32 from the links and
// words (B, n) i32 from tpz_lz4_chain_best at the same max_chain in;
// max_chain >= 1 links a walk; comp (B, cap) u8, zeroed by the caller (cap
// >= n + n/255 + 16), and clens (B,) i32 out.  Streams each row through
// shared memory where the rows and words are 16-byte aligned.  Launches B
// blocks of one warp on `stream` and returns cudaGetLastError().
extern "C" int tpz_lz4_chain_parse(const void* blocks, const void* lengths,
                                   const void* prev, const void* words,
                                   int B, int n, int max_chain, void* comp,
                                   int cap, void* clens, void* stream) {
  const bool stream_rows = reinterpret_cast<uintptr_t>(blocks) % 16 == 0 &&
                           reinterpret_cast<uintptr_t>(words) % 16 == 0 &&
                           n % 16 == 0;
  auto kernel = stream_rows ? lz4_chain_parse_kernel<true>
                            : lz4_chain_parse_kernel<false>;
  kernel<<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(blocks),
      static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(prev), static_cast<const int32_t*>(words),
      n, max_chain, static_cast<uint8_t*>(comp), cap,
      static_cast<int32_t*>(clens));
  return static_cast<int>(cudaGetLastError());
}
