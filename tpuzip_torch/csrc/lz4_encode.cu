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
// What bounds it on this card: not bytes but the probe chain, which is
// serial: a probe's table read, its write, and the read of the candidate's
// bytes that the slot names, each a dependent load from device memory.
//
// What the design does about it (simple first; kernels/lz4_coder.py is
// the plain version, chip_smoke.py holds the two equal):
//   - one warp a block, the block from blockIdx.x; lane 0 runs the probe
//     chain, and the warp joins for the rest: it extends a match 32 bytes
//     a step (a ballot and the first lane that differs) and writes the
//     literals and length extensions 32 bytes a step;
//   - the hash table (2^hash_log int32 slots, 256 KiB at the default 16:
//     more than an SM's shared memory) lives in device memory, one table a
//     CUDA block: the wrapper gives each block one and, when B tables would
//     pass its cap on their bytes, fewer blocks than rows, each walking
//     its rows by a grid-stride loop; the warp resets its table before each
//     row.  A u16 table in shared memory (positions + 1 of a 64 KiB block)
//     is a later redesign.
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

__global__ void __launch_bounds__(32)
lz4_encode_kernel(const uint8_t* __restrict__ blocks,
                  const int32_t* __restrict__ lengths, int B, int n,
                  uint8_t* __restrict__ comp, int cap,
                  int32_t* __restrict__ clens, int32_t* __restrict__ tables,
                  int hash_log) {
  const int lane = threadIdx.x;
  const int slots = 1 << hash_log;
  int32_t* table = tables + (static_cast<size_t>(blockIdx.x) << hash_log);
  for (int row = blockIdx.x; row < B; row += gridDim.x) {
    const uint8_t* src = blocks + static_cast<size_t>(row) * n;
    uint8_t* dst = comp + static_cast<size_t>(row) * cap;
    const int len = min(max(lengths[row], 0), n);
    // a fresh table (the slots, 16 or more, four to a 16-byte store)
    for (int k = lane; k < slots / 4; k += 32)
      reinterpret_cast<int4*>(table)[k] = make_int4(-1, -1, -1, -1);
    __syncwarp();
    const int limit = max(len - MF_LIMIT, 0);
    const int end = len - LAST_LITERALS;
    int i = 0, anchor = 0, o = 0;
    for (;;) {
      // lane 0: probe from i to the first verified candidate
      int cand = -1;
      if (lane == 0) {
        for (; i < limit; ++i) {
          const uint32_t seq = load4(src + i);
          const uint32_t h = (seq * HASH_MUL) >> (32 - hash_log);
          const int c = table[h];
          table[h] = i;
          if (c >= 0 && i - c <= 0xFFFF && load4(src + c) == seq) {
            cand = c;
            break;
          }
        }
      }
      i = __shfl_sync(FULL, i, 0);
      cand = __shfl_sync(FULL, cand, 0);
      if (cand < 0) break;
      // extend forward, 32 bytes a step, while the bytes agree before end
      int m = i + MIN_MATCH;
      for (int c = cand + MIN_MATCH;; m += 32, c += 32) {
        const int p = m + lane;
        const bool stop = p >= end || src[p] != src[c + lane];
        const unsigned hit = __ballot_sync(FULL, stop);
        if (hit) {
          m += __ffs(hit) - 1;
          break;
        }
      }
      const int ml = m - i - MIN_MATCH;
      o = put_literals(dst, o, src, anchor, i - anchor, min(ml, 15), lane);
      if (lane == 0) {
        dst[o] = static_cast<uint8_t>((i - cand) & 0xFF);
        dst[o + 1] = static_cast<uint8_t>((i - cand) >> 8);
      }
      o += 2;
      if (ml >= 15) o += put_ext(dst, o, ml, lane);
      i = anchor = m;
    }
    o = put_literals(dst, o, src, anchor, len - anchor, 0, lane);
    if (lane == 0) clens[row] = o;
    __syncwarp();   // lane 0's table writes before the next row's reset
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
