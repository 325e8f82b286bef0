// lz4_decode.cu — LZ4 block DECODER (codec "lz4"), one warp per block.
//
// tpuzip has no Pallas kernel for LZ4: off the TPU its runner decodes codec
// "lz4" with the host C++ `tpz_lz4_decompress` (tpuzip/csrc/
// tpuzip_host.cpp:252, called from tpuzip/dist/runner.py:1303-1330 with
// out_cap = block_size), which this kernel replaces.  Same function and
// status: the decoded length, or -1 for an offset of 0 or past the bytes
// decoded so far, a literal run past the stream or past out_cap, a match
// past out_cap, or a truncated offset or length extension.  A stream that
// ends right after a literal run is complete.  Unlike the C++, every byte
// of the output row is written: 0 past the decoded length, and a row with
// status -1 is all 0.
//
// What bounds it on this card: not bytes but the token chain: a sequence's
// token, its length extensions and its offset are dependent loads, and the
// next token's place follows from them.
//
// What the design does about it (simple first; kernels/lz4_coder.py is the
// plain version, chip_smoke.py holds the two equal):
//   - one warp a block, the block from blockIdx.x; every lane reads the
//     token, extension and offset bytes (one broadcast load), so the
//     control flow is warp-uniform;
//   - literals are copied 32 bytes a step, a lane a byte;
//   - a match's byte m is out[o - off + (m % off)], 32 bytes a step: the
//     periodic rule of tpuzip/codecs/lz4.py:10-13.  Every source byte lies
//     before o, so any offset, an overlapping one included, copies without
//     a dependency inside the match; __syncwarp() orders each sequence's
//     writes before the next one's reads.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int MIN_MATCH = 4;

// Adds a length's extension bytes (255 continues) read from src at i;
// false if the stream ends inside them.
__device__ __forceinline__ bool length_ext(const uint8_t* src, int n, int& i,
                                           long long& len) {
  for (;;) {
    if (i >= n) return false;
    const int b = src[i++];
    len += b;
    if (b != 255) return true;
  }
}

__global__ void __launch_bounds__(32)
lz4_decode_kernel(const uint8_t* __restrict__ comp,
                  const int32_t* __restrict__ clens, int w,
                  uint8_t* __restrict__ out, int out_cap,
                  int64_t* __restrict__ status) {
  const int lane = threadIdx.x;
  const int row = blockIdx.x;
  const uint8_t* src = comp + static_cast<size_t>(row) * w;
  uint8_t* dst = out + static_cast<size_t>(row) * out_cap;
  const int n = min(max(clens[row], 0), w);
  int i = 0, o = 0;
  bool bad = false;
  while (i < n) {
    const int token = src[i++];
    long long lit = token >> 4;
    if (lit == 15 && !length_ext(src, n, i, lit)) {
      bad = true;
      break;
    }
    if (i + lit > n || o + lit > out_cap) {
      bad = true;
      break;
    }
    for (int k = lane; k < lit; k += 32) dst[o + k] = src[i + k];
    i += static_cast<int>(lit);
    o += static_cast<int>(lit);
    if (i >= n) break;   // the last sequence: literals only
    if (i + 2 > n) {
      bad = true;
      break;
    }
    const int off = src[i] | (src[i + 1] << 8);
    i += 2;
    if (off == 0 || off > o) {
      bad = true;
      break;
    }
    long long ml = (token & 15) + MIN_MATCH;
    if ((token & 15) == 15 && !length_ext(src, n, i, ml)) {
      bad = true;
      break;
    }
    if (o + ml > out_cap) {
      bad = true;
      break;
    }
    __syncwarp();   // the bytes before o, every lane's, are written
    const int from = o - off;
    const int mlen = static_cast<int>(ml);
    if (off >= mlen) {
      for (int k = lane; k < mlen; k += 32) dst[o + k] = dst[from + k];
    } else {
      for (int k = lane; k < mlen; k += 32) dst[o + k] = dst[from + k % off];
    }
    o += mlen;
    __syncwarp();
  }
  __syncwarp();   // then zero past the output, or the whole row
  for (int k = (bad ? 0 : o) + lane; k < out_cap; k += 32) dst[k] = 0;
  if (lane == 0) status[row] = bad ? -1 : o;
}

}  // namespace

// comp (B, w) u8 and clens (B,) i32 (a row's stream is its first
// min(clen, w) bytes) in; out (B, out_cap) u8, every byte written, and
// status (B,) i64 out.  Launches B blocks of one warp on `stream` and
// returns cudaGetLastError().
extern "C" int tpz_lz4_decode(const void* comp, const void* clens, int B,
                              int w, void* out, int out_cap, void* status,
                              void* stream) {
  lz4_decode_kernel<<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(comp), static_cast<const int32_t*>(clens),
      w, static_cast<uint8_t*>(out), out_cap,
      static_cast<int64_t*>(status));
  return static_cast<int>(cudaGetLastError());
}
