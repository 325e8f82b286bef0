// rle.cu — run-length ENCODER and DECODER (codec "rle"), one thread per
// block.
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
// What bounds it on this card: not bytes but one serial byte loop a block,
// whose next step waits on the byte it reads.
//
// What the design does about it: nothing yet (simple first;
// kernels/rle_coder.py is the plain version, chip_smoke.py holds the two
// equal).  One thread a block, each in a CUDA block of its own, so no two
// blocks' loops share a warp and diverge.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void __launch_bounds__(1)
rle_encode_kernel(const uint8_t* __restrict__ blocks,
                  const int32_t* __restrict__ lengths, int n,
                  uint8_t* __restrict__ comp, int cap,
                  int32_t* __restrict__ clens) {
  const int row = blockIdx.x;
  const uint8_t* src = blocks + static_cast<size_t>(row) * n;
  uint8_t* dst = comp + static_cast<size_t>(row) * cap;
  const int len = min(max(lengths[row], 0), n);
  int i = 0, o = 0;
  while (i < len) {
    const uint8_t b = src[i];
    int run = 1;
    while (i + run < len && src[i + run] == b) ++run;
    dst[o++] = b;
    if (run > 1) {
      dst[o++] = b;
      int rem = run - 2;
      for (; rem >= 255; rem -= 255) dst[o++] = 255;
      dst[o++] = static_cast<uint8_t>(rem);
    }
    i += run;
  }
  clens[row] = o;
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
// clens (B,) i32 out.  Launches B blocks of one thread on `stream` and
// returns cudaGetLastError().
extern "C" int tpz_rle_encode(const void* blocks, const void* lengths, int B,
                              int n, void* comp, int cap, void* clens,
                              void* stream) {
  rle_encode_kernel<<<B, 1, 0, static_cast<cudaStream_t>(stream)>>>(
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
