// rle.cu — run-length ENCODER (two forms) and DECODER (codec "rle"), each
// a block per CUDA block of 256 threads.
//
// tpuzip has no Pallas kernel for rle: off the TPU its runner encodes and
// decodes codec "rle" with the host C++ loops `tpz_rle_encode` and
// `tpz_rle_decode` (csrc/tpuzip_host.cpp:1795 and :1822, called
// from tpuzip/dist/runner.py:956-965 and :1303-1330), which these two
// kernels replace.  Same functions:
//   - encode: the bytes of tpuzip.oracle.rle.encode: a byte as it is; a run
//     of two or more as the byte twice and a count of the rest, whose
//     bytes chain by 255 without bound (not the 256-byte segments of
//     tpuzip's XLA encoder);
//   - encode in segments (rle_encode_kernel<true>, tpz_rle_encode_seg):
//     the bytes of tpuzip's XLA encoder, tpuzip/codecs/rle.py:30 `encode`,
//     which tpuzip's compress_from_device runs on the device: each run
//     cut into segments of at most 256 bytes, a segment of L >= 2 bytes
//     written as the byte twice and L - 2, one of 1 byte as the byte;
//   - decode: two equal bytes call for a count, and the pair re-arms only
//     after its count bytes; the status is the decoded length, or -1 for a
//     count past the stream or output past out_cap.  Every byte of the
//     output row is written: 0 past the decoded length, and a row with
//     status -1 is all 0.  Both forms, the C++'s and tpuzip's XLA
//     segments, decode.
//
// What bounds them on this card: bytes, where the work runs in parallel
// (encode: a byte read, at most 1.5 written; decode: a stream byte read,
// up to 255 written); written as the C++ does, one serial byte loop a
// block, whose next step waits on the byte it reads (the decoder as
// ported took 135 cycles a stream byte, its load and store the most).
//
// What the design does about it (kernels/rle_coder.py is the plain
// version, chip_smoke.py holds the two equal):
//   - the encoder needs no loop over runs: every output byte follows from
//     one input byte's place j in its run of R bytes.  The byte emits its
//     value when j is 0 or 1, a 255 when j >= 2 and (j - 2) % 255 == 254,
//     and, when it is the run's last byte and R >= 2, the count's
//     remainder (j - 1) % 255 after that (R = 2 gives b b 0, R = 256
//     b b 254, R = 257 b b 255 0; tests/test_torch_rle.py holds the rule
//     against the oracle).  In segments the rule is the same with k = j
//     mod 256 for j: the value at k 0 and 1, no 255s, and k - 1 after a
//     byte that ends a segment (k = 255, or the run's last byte) with
//     k >= 1 (R = 257 gives b b 254 b); one template flag picks the rule,
//     so the chained instance compiles as before.  So a CUDA block takes
//     a row in tiles of 4096
//     bytes, 16 a thread (one 16-byte load where the row is aligned): j
//     from a max-scan of run heads and the output offsets from a sum-scan
//     of the bytes' sizes, each within a warp by shuffles, across the
//     warps in shared memory, and carried from tile to tile.  Each byte
//     writes its 0 to 2 bytes into the tile's stream in shared memory,
//     which then goes out 32 consecutive bytes a warp's store (written
//     straight from each thread, a warp's store spread over 32 places,
//     it took twice the time);
//   - the decoder needs no loop over pairs either: a stream byte's role
//     follows from a machine of 3 states (S0 a literal with pairing
//     disarmed, S1 a literal armed by the literal before it, S2 a count
//     byte: S0 -> S1; S1 -> S2 if the byte equals the one before it, else
//     S1; S2 -> S2 on a 255, else S0), and its output from its role: a
//     literal writes itself, a count byte its value in copies of the last
//     literal before it (tests/test_torch_rle.py holds the rule against
//     tpuzip's C++ decoder, statuses included).  A CUDA block takes a row
//     in tiles of 4096 stream bytes, 16 a thread, on the encoder's
//     skeleton: each thread composes its bytes' map (the state after them
//     for each state before them), a block scan of the maps, carried from
//     tile to tile, gives each thread its state, and one more of the
//     output sizes (by sum) and of the last literal gives where each
//     byte's output goes and the pair's byte.  A tile's output of up to
//     DEC_STAGE bytes is staged in shared memory and goes out 32
//     consecutive bytes a warp's store; a longer one (long fills: a
//     constant 64 KiB row is 259 stream bytes) is written straight from
//     each thread, 16-byte stores where aligned.  Nothing is written past
//     out_cap, the tiles stop once the output passes it, and the row is
//     zeroed past the total, or whole where the status is -1.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int ENC_THREADS = 256;
constexpr int ENC_BYTES = 16;                      // a thread's bytes a tile
constexpr int ENC_TILE = ENC_THREADS * ENC_BYTES;  // a tile's bytes
constexpr unsigned FULL = 0xFFFFFFFFu;

template <bool MAX>
__device__ __forceinline__ int combine(int a, int b) {
  return MAX ? max(a, b) : a + b;
}

// Exclusive scan over the CUDA block of one int a thread, by max (MAX) or
// by sum, seeded with `carry`; `total` gets the whole block's, carry
// included.  `part` holds one int a warp; the caller syncs before its next
// use.
template <bool MAX>
__device__ __forceinline__ int block_scan(int v, int carry, int* part,
                                          int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl = combine<MAX>(incl, u);
  }
  if (lane == 31) part[warp] = incl;
  const int up = __shfl_up_sync(FULL, incl, 1);
  __syncthreads();
  int excl = carry;
  total = carry;
  for (int w = 0; w < ENC_THREADS / 32; ++w) {
    if (w < warp) excl = combine<MAX>(excl, part[w]);
    total = combine<MAX>(total, part[w]);
  }
  return lane ? combine<MAX>(excl, up) : excl;
}

// SEGMENTS picks the rule by `if constexpr`, so the chained instance is
// the source as it was before the flag, statement for statement.
template <bool SEGMENTS>
__global__ void __launch_bounds__(ENC_THREADS)
rle_encode_kernel(const uint8_t* __restrict__ blocks,
                  const int32_t* __restrict__ lengths, int n,
                  uint8_t* __restrict__ comp, int cap,
                  int32_t* __restrict__ clens) {
  __shared__ int firsts[ENC_THREADS], lasts[ENC_THREADS];
  __shared__ int heads[ENC_THREADS / 32], sizes[ENC_THREADS / 32];
  __shared__ uint8_t staged[2 * ENC_TILE];   // a tile's stream, <= 1.5x
  const int tid = threadIdx.x;
  const int row = blockIdx.x;
  const uint8_t* src = blocks + static_cast<size_t>(row) * n;
  uint8_t* dst = comp + static_cast<size_t>(row) * cap;
  const int len = min(max(lengths[row], 0), n);
  const bool aligned = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  // carried from tile to tile: the byte before it, the last run head
  // before it, and the stream bytes before it
  int prev = -1, head = 0, out = 0;
  for (int t0 = 0; t0 < len; t0 += ENC_TILE) {
    const int base = t0 + tid * ENC_BYTES;
    uint8_t x[ENC_BYTES];
    if (aligned && base + ENC_BYTES <= len) {
      const uint4 v = *reinterpret_cast<const uint4*>(src + base);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
      for (int k = 0; k < ENC_BYTES; ++k)
        x[k] = static_cast<uint8_t>(w[k / 4] >> (8 * (k % 4)));
    } else {
      for (int k = 0; k < ENC_BYTES; ++k)
        x[k] = base + k < len ? src[base + k] : 0;
    }
    firsts[tid] = x[0];
    lasts[tid] = x[ENC_BYTES - 1];
    __syncthreads();
    const int before = tid ? lasts[tid - 1] : prev;
    const int after = tid + 1 < ENC_THREADS ? firsts[tid + 1]
                      : t0 + ENC_TILE < len ? src[t0 + ENC_TILE] : -1;
    // the last run head among this thread's bytes, then scanned
    int mine = -1;
    for (int k = 0; k < ENC_BYTES; ++k) {
      const int q = base + k;
      if (q < len && x[k] != (k ? x[k - 1] : before)) mine = q;
    }
    int tile_head, tile_out;
    int run_head = block_scan<true>(mine, head, heads, tile_head);
    // each byte's place in its run, and the bytes it emits: its value at
    // places 0 and 1, a 255 at (j - 2) % 255 == 254, the count after the
    // run's last byte
    int j[ENC_BYTES], mine_out = 0;
    for (int k = 0; k < ENC_BYTES; ++k) {
      const int q = base + k;
      if (q < len && x[k] != (k ? x[k - 1] : before)) run_head = q;
      j[k] = q - run_head;
      const bool last = q + 1 == len ||
                        (k + 1 < ENC_BYTES ? x[k + 1] : after) != x[k];
      if constexpr (SEGMENTS) {
        // by j mod 256: the value at 0 and 1, that minus 1 after a
        // segment's last byte (at 255, or the run's last) past 0
        if (q < len)
          mine_out += ((j[k] & 255) <= 1) +
                      ((last || (j[k] & 255) == 255) && (j[k] & 255) >= 1);
      } else {
        if (q < len)
          mine_out += (j[k] <= 1) + (j[k] >= 2 && (j[k] - 2) % 255 == 254) +
                      (last && j[k] >= 1);
      }
    }
    int o = block_scan<false>(mine_out, 0, sizes, tile_out);
    for (int k = 0; k < ENC_BYTES; ++k) {
      const int q = base + k;
      if (q >= len) break;
      const bool last = q + 1 == len ||
                        (k + 1 < ENC_BYTES ? x[k + 1] : after) != x[k];
      if constexpr (SEGMENTS) {
        const int seg = j[k] & 255;
        if (seg <= 1) staged[o++] = x[k];
        if ((last || seg == 255) && seg >= 1)
          staged[o++] = static_cast<uint8_t>(seg - 1);
      } else {
        if (j[k] <= 1)
          staged[o++] = x[k];
        else if ((j[k] - 2) % 255 == 254)
          staged[o++] = 255;
        if (last && j[k] >= 1)
          staged[o++] = static_cast<uint8_t>((j[k] - 1) % 255);
      }
    }
    // the tile's stream out in consecutive bytes, a warp's 32 at a time
    __syncthreads();
    for (int k = tid; k < tile_out; k += ENC_THREADS) dst[out + k] = staged[k];
    prev = lasts[ENC_THREADS - 1];
    head = tile_head;
    out += tile_out;
    __syncthreads();   // the next tile's writes to shared memory wait
  }
  if (tid == 0) clens[row] = out;
}

// The decoder's states before a stream byte: S0 a literal with pairing
// disarmed, S1 a literal armed by the literal before it, S2 a count byte.
// A map holds the state after some bytes for each state before them, 2
// bits a state (S0's at bits 0-1).
constexpr int DEC_THREADS = 256;
constexpr int DEC_BYTES = 16;                       // a thread's bytes a tile
constexpr int DEC_TILE = DEC_THREADS * DEC_BYTES;   // a tile's stream bytes
constexpr int DEC_STAGE = 2 * DEC_TILE;   // a tile's output staged, at most

__device__ __forceinline__ int after(int map, int s) {
  return (map >> (2 * s)) & 3;
}

// The map of `first`, then `second`.
__device__ __forceinline__ int then(int first, int second) {
  return after(second, after(first, 0)) |
         after(second, after(first, 1)) << 2 |
         after(second, after(first, 2)) << 4;
}

// The state after byte x in state s; eq: x equals the byte before it.
__device__ __forceinline__ int step(int s, int x, bool eq) {
  return s == 0 ? 1 : s == 1 ? (eq ? 2 : 1) : (x == 255 ? 2 : 0);
}

// Each thread's state before its bytes from each thread's map, seeded with
// the state before the tile; `end` gets the state after the tile.  `part`
// holds one map a warp; the caller syncs before its next use.
__device__ __forceinline__ int scan_states(int map, int carry, int* part,
                                           int& end) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = map;
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl = then(u, incl);
  }
  if (lane == 31) part[warp] = incl;
  const int up = __shfl_up_sync(FULL, incl, 1);
  __syncthreads();
  int s = carry;
  end = carry;
  for (int w = 0; w < DEC_THREADS / 32; ++w) {
    if (w < warp) s = after(part[w], s);
    end = after(part[w], end);
  }
  return lane ? after(up, s) : s;
}

// Exclusive scans over the block of each thread's output bytes (by sum)
// and of its last literal (the last one that is not -1), seeded with the
// literal before the tile; `size` and `lit` get the whole tile's, `first`
// the literal before this thread's bytes.  The caller syncs before the
// next use of `sizes` and `lits`.
__device__ __forceinline__ int scan_out(int mine, int last, int* sizes,
                                        int* lits, int& size, int& lit,
                                        int& first) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = mine, incl_lit = last;
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(FULL, incl, d);
    const int v = __shfl_up_sync(FULL, incl_lit, d);
    if (lane >= d) {
      incl += u;
      if (incl_lit < 0) incl_lit = v;
    }
  }
  if (lane == 31) {
    sizes[warp] = incl;
    lits[warp] = incl_lit;
  }
  const int up = __shfl_up_sync(FULL, incl, 1);
  const int up_lit = __shfl_up_sync(FULL, incl_lit, 1);
  __syncthreads();
  int excl = 0;
  first = lit;
  size = 0;
  for (int w = 0; w < DEC_THREADS / 32; ++w) {
    if (w < warp) {
      excl += sizes[w];
      if (lits[w] >= 0) first = lits[w];
    }
    size += sizes[w];
    if (lits[w] >= 0) lit = lits[w];
  }
  if (lane) {
    excl += up;
    if (up_lit >= 0) first = up_lit;
  }
  return excl;
}

// dst[o, min(o + count, cap)) = v, in 16-byte stores where aligned.
__device__ __forceinline__ void fill(uint8_t* dst, long long o, int count,
                                     uint8_t v, int cap) {
  const long long end = min(o + count, static_cast<long long>(cap));
  long long p = o;
  for (; p < end && (reinterpret_cast<uintptr_t>(dst + p) & 15); ++p)
    dst[p] = v;
  const uint32_t w = v * 0x01010101u;
  for (; p + 16 <= end; p += 16)
    *reinterpret_cast<uint4*>(dst + p) = make_uint4(w, w, w, w);
  for (; p < end; ++p) dst[p] = v;
}

// dst[from, to) = 0 by the whole block, in 16-byte stores where aligned.
__device__ __forceinline__ void block_zero(uint8_t* dst, int from, int to) {
  const int tid = threadIdx.x;
  const int head = min(to, from + static_cast<int>(
      (16 - (reinterpret_cast<uintptr_t>(dst + from) & 15)) & 15));
  const int body = head + ((to - head) & ~15);
  if (from + tid < head) dst[from + tid] = 0;
  for (int k = head + 16 * tid; k < body; k += 16 * DEC_THREADS)
    *reinterpret_cast<uint4*>(dst + k) = make_uint4(0, 0, 0, 0);
  if (body + tid < to) dst[body + tid] = 0;
}

__global__ void __launch_bounds__(DEC_THREADS)
rle_decode_kernel(const uint8_t* __restrict__ comp,
                  const int32_t* __restrict__ clens, int w,
                  uint8_t* __restrict__ out, int out_cap,
                  int64_t* __restrict__ status) {
  __shared__ int maps[DEC_THREADS / 32], sizes[DEC_THREADS / 32],
      lits[DEC_THREADS / 32];
  __shared__ uint8_t staged[DEC_STAGE];
  const int tid = threadIdx.x;
  const int row = blockIdx.x;
  const uint8_t* src = comp + static_cast<size_t>(row) * w;
  uint8_t* dst = out + static_cast<size_t>(row) * out_cap;
  const int n = min(max(clens[row], 0), w);
  const bool aligned = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  // carried from tile to tile: the state before it, the last literal
  // before it, and the output bytes before it (the loop stops once they
  // pass out_cap)
  int state = 0, lit = -1;
  long long total = 0;
  for (int t0 = 0; t0 < n && total <= out_cap; t0 += DEC_TILE) {
    const int base = t0 + tid * DEC_BYTES;
    uint8_t x[DEC_BYTES];
    if (aligned && base + DEC_BYTES <= n) {
      const uint4 v = *reinterpret_cast<const uint4*>(src + base);
      const uint32_t u[4] = {v.x, v.y, v.z, v.w};
      for (int k = 0; k < DEC_BYTES; ++k)
        x[k] = static_cast<uint8_t>(u[k / 4] >> (8 * (k % 4)));
    } else {
      for (int k = 0; k < DEC_BYTES; ++k)
        x[k] = base + k < n ? src[base + k] : 0;
    }
    // the byte before this thread's first: the last one of the thread
    // before it (its lane, or its byte in device memory)
    int before = __shfl_up_sync(FULL, x[DEC_BYTES - 1], 1);
    if ((tid & 31) == 0) before = base == 0 ? -1 : base <= n ? src[base - 1]
                                                              : 0;
    // this thread's map: its bytes' states after, from each state before
    int s0 = 0, s1 = 1, s2 = 2;
    for (int k = 0; k < DEC_BYTES; ++k) {
      if (base + k >= n) break;
      const bool eq = x[k] == (k ? x[k - 1] : before);
      s0 = step(s0, x[k], eq);
      s1 = step(s1, x[k], eq);
      s2 = step(s2, x[k], eq);
    }
    int tile_state;
    const int start = scan_states(s0 | s1 << 2 | s2 << 4, state, maps,
                                  tile_state);
    // its output bytes and its last literal
    int mine = 0, last = -1;
    for (int k = 0, s = start; k < DEC_BYTES && base + k < n; ++k) {
      mine += s == 2 ? x[k] : 1;
      if (s != 2) last = x[k];
      s = step(s, x[k], x[k] == (k ? x[k - 1] : before));
    }
    int tile_size, pair;
    const int o = scan_out(mine, last, sizes, lits, tile_size, lit, pair);
    // the bytes: staged in shared memory and written out 32 consecutive
    // bytes a warp's store, or, past DEC_STAGE, written directly
    const bool stage = tile_size <= DEC_STAGE;
    long long p = stage ? o : total + o;
    for (int k = 0, s = start; k < DEC_BYTES && base + k < n; ++k) {
      if (s == 2) {
        if (stage)
          for (int j = 0; j < x[k]; ++j)
            staged[p + j] = static_cast<uint8_t>(pair);
        else
          fill(dst, p, x[k], pair, out_cap);
        p += x[k];
      } else {
        if (stage)
          staged[p] = x[k];
        else if (p < out_cap)
          dst[p] = x[k];
        pair = x[k];
        ++p;
      }
      s = step(s, x[k], x[k] == (k ? x[k - 1] : before));
    }
    if (stage) {
      __syncthreads();
      const int room = static_cast<int>(
          min(static_cast<long long>(tile_size), out_cap - total));
      for (int k = tid; k < room; k += DEC_THREADS)
        dst[total + k] = staged[k];
    }
    total += tile_size;
    state = tile_state;
    __syncthreads();   // the next tile's writes to shared memory wait
  }
  const bool bad = total > out_cap || state == 2;
  block_zero(dst, bad ? 0 : static_cast<int>(total), out_cap);
  if (tid == 0) status[row] = bad ? -1 : total;
}

}  // namespace

// blocks (B, n) u8 and lengths (B,) i32 in; comp (B, cap) u8, zeroed by the
// caller (cap >= 2n + 8, above the 1.5n + 1 an encoding can take), and
// clens (B,) i32 out.  Launches B blocks of 256 threads on `stream` and
// returns cudaGetLastError().  tpz_rle_encode writes the chained counts,
// tpz_rle_encode_seg the segments.
template <bool SEGMENTS>
static int encode(const void* blocks, const void* lengths, int B, int n,
                  void* comp, int cap, void* clens, void* stream) {
  rle_encode_kernel<SEGMENTS><<<B, ENC_THREADS, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(blocks),
      static_cast<const int32_t*>(lengths), n, static_cast<uint8_t*>(comp),
      cap, static_cast<int32_t*>(clens));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpz_rle_encode(const void* blocks, const void* lengths, int B,
                              int n, void* comp, int cap, void* clens,
                              void* stream) {
  return encode<false>(blocks, lengths, B, n, comp, cap, clens, stream);
}

extern "C" int tpz_rle_encode_seg(const void* blocks, const void* lengths,
                                  int B, int n, void* comp, int cap,
                                  void* clens, void* stream) {
  return encode<true>(blocks, lengths, B, n, comp, cap, clens, stream);
}

// comp (B, w) u8 and clens (B,) i32 (a row's stream is its first
// min(clen, w) bytes) in; out (B, out_cap) u8, every byte written, and
// status (B,) i64 out.  Launches B blocks of 256 threads on `stream` and
// returns cudaGetLastError().
extern "C" int tpz_rle_decode(const void* comp, const void* clens, int B,
                              int w, void* out, int out_cap, void* status,
                              void* stream) {
  rle_decode_kernel<<<B, DEC_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(comp), static_cast<const int32_t*>(clens),
      w, static_cast<uint8_t*>(out), out_cap,
      static_cast<int64_t*>(status));
  return static_cast<int>(cudaGetLastError());
}
