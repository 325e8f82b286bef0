// lz4_encode.cu — LZ4 block ENCODER (codec "lz4"), one warp per block.
//
// tpuzip has no Pallas kernel for LZ4: off the TPU its runner encodes codec
// "lz4" with the host C++ `tpz_lz4_compress` (csrc/tpuzip_host.cpp:
// 190, called from tpuzip/dist/runner.py:967-981), which this kernel
// replaces.  Same function: the bytes of tpuzip.oracle.lz4.compress_block,
// the greedy single-probe parse.  A probe at i hashes the 4 bytes there,
// (seq * 2654435761) >> (32 - hash_log), reads the table's slot and writes
// i into it; a candidate at most 65535 back whose 4 bytes equal i's is a
// match, extended while the bytes agree up to n - 5.  The positions inside
// an accepted match are not probed, no match starts in the last 12 bytes,
// and a block under 13 bytes is all literals (an empty one is the byte 0).
//
// What bounds it on this card: not bytes but the probe chain.  Each probe
// reads the table, writes it, and reads the candidate's bytes that the slot
// names, and the next probe's table depends on whether this one matched.
// Probed one position at a time by one lane (the first design), a probe
// cost three dependent loads, with tables that at 1024 rows (256 MiB) do
// not fit the 50 MB L2.
//
// What the design does about it (kernels/lz4_coder.py is the plain
// version, the same construction at a window of 64; chip_smoke.py holds
// the two equal; PERF.md §6 has the measurements behind each choice):
//   - the warp probes up to 32 positions a step: lane l hashes i + l, and
//     __match_any_sync groups the lanes that share a hash.  A lane's
//     candidate is the highest earlier lane of its group, else the table's
//     slot read before any write of this step: what the serial chain would
//     read, as long as no earlier lane matched.  All lanes verify at once,
//     a ballot gives the first lane k that matched, and of the probed lanes
//     (up to k) the last of each group writes its position.  So a step
//     takes a match or a window of literal positions, not one position;
//   - the window is 8 positions at the row's start and after a match, and
//     32 after a window without one: on text the next match is near, and
//     lanes past it only load the memory system (in device memory, 31
//     table reads a step where text needs about 3) and lengthen
//     __match_any_sync, whose time grows with the distinct hashes;
//   - the match is extended 32 bytes a step (a ballot and the first lane
//     that differs), and the literals and length extensions are written 32
//     bytes a step;
//   - the table lives in device memory as int32, one table a CUDA block,
//     so all rows run in one wave: the wrapper gives each block one and,
//     when B tables would pass its cap on their bytes, fewer blocks than
//     rows, each walking its rows by a grid-stride loop and resetting its
//     table before each row.  A u16 table in shared memory (with the row
//     beside it) was measured with this probe and lost at 1024 x 64 KiB:
//     128 KiB of table leaves one CTA an SM, and 1024 rows ran in 8 waves.
// The output never passes the spec's bound n + n/255 + 16, the row's
// capacity: a match costs its token, 2 offset bytes and its length's
// extension, at most its own length, so only literal runs' extensions add
// bytes.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int MIN_MATCH = 4;
constexpr int MF_LIMIT = 12;
constexpr int LAST_LITERALS = 5;
constexpr uint32_t HASH_MUL = 2654435761u;
constexpr unsigned FULL = 0xFFFFFFFFu;
// Positions a step when a match is likely near: at the row's start and
// after each match (on text the next match is 1.6 positions on); a step
// that finds none goes on 32 wide.
constexpr int FIRST_WIDTH = 8;

__device__ __forceinline__ uint32_t load4(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (uint32_t(p[3]) << 24);
}

// Writes the extension bytes of a length >= 15 at dst + o, the lanes side
// by side (255 each, then the remainder); returns their count.
__device__ __forceinline__ int put_ext(uint8_t* dst, int o, int len,
                                       int lane) {
  const int rem = len - 15;
  const int cnt = rem / 255 + 1;
  for (int k = lane; k < cnt; k += 32)
    dst[o + k] = static_cast<uint8_t>(k < cnt - 1 ? 255 : rem % 255);
  return cnt;
}

// Token, literal run and its extension; the caller adds the match's part.
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

// One row's stream into dst; returns its length.  src holds the row's len
// bytes, the table's 2^hash_log slots are all -1.
__device__ __forceinline__ int encode_row(const uint8_t* src, int len,
                                          uint8_t* dst, int32_t* table,
                                          int hash_log, int lane) {
  const int limit = max(len - MF_LIMIT, 0);
  const int end = len - LAST_LITERALS;
  const unsigned upto_me = (2u << lane) - 1;   // lanes 0..lane
  int i = 0, anchor = 0, o = 0, width = FIRST_WIDTH;
  while (i < limit) {
    // probe i .. i + width - 1 (the lanes before limit)
    const int p = i + lane;
    const bool live = lane < width && p < limit;
    const uint32_t seq = live ? load4(src + p) : 0;
    const uint32_t h = live ? (seq * HASH_MUL) >> (32 - hash_log) : FULL;
    const unsigned group = __match_any_sync(FULL, h);
    const unsigned earlier = group & upto_me & ~(1u << lane);
    const int c = earlier ? i + 31 - __clz(earlier)
                          : (live ? table[h] : -1);
    const bool ok = live && c >= 0 && p - c <= 0xFFFF &&
                    load4(src + c) == seq;
    const unsigned hits = __ballot_sync(FULL, ok);
    // the probed lanes: live, up to the first match (all, without one); of
    // each hash group the last one writes its position
    const unsigned first = hits & (0u - hits);
    const unsigned probed = __ballot_sync(FULL, live) & (first | (first - 1));
    if ((probed >> lane & 1) && !(group & probed & ~upto_me))
      table[h] = p;
    __syncwarp();
    if (!hits) {
      i += width;
      width = 32;
      continue;
    }
    const int k = __ffs(hits) - 1;
    const int at = i + k;
    const int cand = __shfl_sync(FULL, c, k);
    // extend forward, 32 bytes a step, while the bytes agree before end
    int m = at + MIN_MATCH;
    for (int cc = cand + MIN_MATCH;; m += 32, cc += 32) {
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
      dst[o] = static_cast<uint8_t>((at - cand) & 0xFF);
      dst[o + 1] = static_cast<uint8_t>((at - cand) >> 8);
    }
    o += 2;
    if (ml >= 15) o += put_ext(dst, o, ml, lane);
    i = anchor = m;
    width = FIRST_WIDTH;
  }
  return put_literals(dst, o, src, anchor, len - anchor, 0, lane);
}

// Table blockIdx.x of `tables`; rows blockIdx.x, + gridDim.x, ...
__global__ void __launch_bounds__(32)
lz4_encode_kernel(const uint8_t* __restrict__ blocks,
                  const int32_t* __restrict__ lengths, int B, int n,
                  uint8_t* __restrict__ comp, int cap,
                  int32_t* __restrict__ clens, int32_t* __restrict__ tables,
                  int hash_log) {
  const int lane = threadIdx.x;
  int32_t* slot = tables + (static_cast<size_t>(blockIdx.x) << hash_log);
  for (int row = blockIdx.x; row < B; row += gridDim.x) {
    // a fresh table (the slots, 16 or more, four to a 16-byte store)
    for (int k = lane; k < (1 << hash_log) / 4; k += 32)
      reinterpret_cast<int4*>(slot)[k] = make_int4(-1, -1, -1, -1);
    __syncwarp();
    const int len = min(max(lengths[row], 0), n);
    const int o = encode_row(blocks + static_cast<size_t>(row) * n, len,
                             comp + static_cast<size_t>(row) * cap,
                             slot, hash_log, lane);
    if (lane == 0) clens[row] = o;
    __syncwarp();   // this row's table writes before the next row's reset
  }
}

}  // namespace

// blocks (B, n) u8 and lengths (B,) i32 in; comp (B, cap) u8, zeroed by the
// caller (cap >= n + n/255 + 16), and clens (B,) i32 out; tables: ntab *
// 2^hash_log int32 of scratch (1 <= ntab <= B, 4 <= hash_log <= 24).
// Launches ntab blocks of one warp on `stream` and returns
// cudaGetLastError().
extern "C" int tpz_lz4_encode(const void* blocks, const void* lengths, int B,
                              int n, void* comp, int cap, void* clens,
                              void* tables, int ntab, int hash_log,
                              void* stream) {
  lz4_encode_kernel<<<ntab, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(blocks),
      static_cast<const int32_t*>(lengths), B, n,
      static_cast<uint8_t*>(comp), cap, static_cast<int32_t*>(clens),
      static_cast<int32_t*>(tables), hash_log);
  return static_cast<int>(cudaGetLastError());
}
