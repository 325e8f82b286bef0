// rle.cu — run-length ENCODER and DECODER (codec "rle"): the encoder a
// block per CUDA block of 256 threads, the decoder one thread per block.
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
//   - decode: two equal bytes call for a count, and the pair re-arms only
//     after its count bytes; the status is the decoded length, or -1 for a
//     count past the stream or output past out_cap.  Every byte of the
//     output row is written: 0 past the decoded length, and a row with
//     status -1 is all 0.
//
// What bounds them on this card: bytes, where the work runs in parallel
// (a byte read, at most 1.5 written); written as the C++ does, one serial
// byte loop a block, whose next step waits on the byte it reads.
//
// What the design does about it (kernels/rle_coder.py is the plain
// version, chip_smoke.py holds the two equal):
//   - the encoder needs no loop over runs: every output byte follows from
//     one input byte's place j in its run of R bytes.  The byte emits its
//     value when j is 0 or 1, a 255 when j >= 2 and (j - 2) % 255 == 254,
//     and, when it is the run's last byte and R >= 2, the count's
//     remainder (j - 1) % 255 after that (R = 2 gives b b 0, R = 256
//     b b 254, R = 257 b b 255 0; tests/test_torch_rle.py holds the rule
//     against the oracle).  So a CUDA block takes a row in tiles of 4096
//     bytes, 16 a thread (one 16-byte load where the row is aligned): j
//     from a max-scan of run heads and the output offsets from a sum-scan
//     of the bytes' sizes, each within a warp by shuffles, across the
//     warps in shared memory, and carried from tile to tile.  Each byte
//     writes its 0 to 2 bytes into the tile's stream in shared memory,
//     which then goes out 32 consecutive bytes a warp's store (written
//     straight from each thread, a warp's store spread over 32 places,
//     it took twice the time);
//   - the decoder: nothing yet.  One thread a block, each in a CUDA block
//     of its own, so no two blocks' loops share a warp and diverge.

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
      if (q < len)
        mine_out += (j[k] <= 1) + (j[k] >= 2 && (j[k] - 2) % 255 == 254) +
                    (last && j[k] >= 1);
    }
    int o = block_scan<false>(mine_out, 0, sizes, tile_out);
    for (int k = 0; k < ENC_BYTES; ++k) {
      const int q = base + k;
      if (q >= len) break;
      const bool last = q + 1 == len ||
                        (k + 1 < ENC_BYTES ? x[k + 1] : after) != x[k];
      if (j[k] <= 1)
        staged[o++] = x[k];
      else if ((j[k] - 2) % 255 == 254)
        staged[o++] = 255;
      if (last && j[k] >= 1)
        staged[o++] = static_cast<uint8_t>((j[k] - 1) % 255);
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

__global__ void __launch_bounds__(1)
rle_decode_kernel(const uint8_t* __restrict__ comp,
                  const int32_t* __restrict__ clens, int w,
                  uint8_t* __restrict__ out, int out_cap,
                  int64_t* __restrict__ status) {
  const int row = blockIdx.x;
  const uint8_t* src = comp + static_cast<size_t>(row) * w;
  uint8_t* dst = out + static_cast<size_t>(row) * out_cap;
  const int n = min(max(clens[row], 0), w);
  int i = 0, o = 0, prev = -1;
  bool bad = false;
  while (i < n && !bad) {
    const int b = src[i++];
    if (o >= out_cap) {
      bad = true;
      break;
    }
    dst[o++] = static_cast<uint8_t>(b);
    if (b != prev) {
      prev = b;
      continue;
    }
    long long extra = 0;
    for (;;) {
      if (i >= n) {
        bad = true;
        break;
      }
      const int c = src[i++];
      extra += c;
      if (c != 255) break;
    }
    if (bad || o + extra > out_cap) {
      bad = true;
      break;
    }
    for (int k = 0; k < extra; ++k) dst[o + k] = static_cast<uint8_t>(b);
    o += static_cast<int>(extra);
    prev = -1;
  }
  for (int k = bad ? 0 : o; k < out_cap; ++k) dst[k] = 0;
  status[row] = bad ? -1 : o;
}

}  // namespace

// blocks (B, n) u8 and lengths (B,) i32 in; comp (B, cap) u8, zeroed by the
// caller (cap >= 2n + 8, above the 1.5n + 1 an encoding can take), and
// clens (B,) i32 out.  Launches B blocks of 256 threads on `stream` and
// returns cudaGetLastError().
extern "C" int tpz_rle_encode(const void* blocks, const void* lengths, int B,
                              int n, void* comp, int cap, void* clens,
                              void* stream) {
  rle_encode_kernel<<<B, ENC_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(blocks),
      static_cast<const int32_t*>(lengths), n, static_cast<uint8_t*>(comp),
      cap, static_cast<int32_t*>(clens));
  return static_cast<int>(cudaGetLastError());
}

// comp (B, w) u8 and clens (B,) i32 (a row's stream is its first
// min(clen, w) bytes) in; out (B, out_cap) u8, every byte written, and
// status (B,) i64 out.  Launches B blocks of one thread on `stream` and
// returns cudaGetLastError().
extern "C" int tpz_rle_decode(const void* comp, const void* clens, int B,
                              int w, void* out, int out_cap, void* status,
                              void* stream) {
  rle_decode_kernel<<<B, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(comp), static_cast<const int32_t*>(clens),
      w, static_cast<uint8_t*>(out), out_cap,
      static_cast<int64_t*>(status));
  return static_cast<int>(cudaGetLastError());
}
