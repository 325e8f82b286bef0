// lz4_links.cu — the links of tpuzip's two lz4 encoders past their shared
// routes: prev[p] for every position p < length - 12 of a row, the last
// earlier position whose 4 bytes hash as p's, h = (seq * 2654435761) >>
// (32 - bits), h = 0 at bits 0; -1 where there is none and from length - 12
// on.
//
// It replaces the hash chain of tpuzip's chained C++ encoder
// (tpz_lz4_compress_chained, csrc/tpuzip_host.cpp:463-568: max_chain > 1,
// bits 4..24) and the candidates of its XLA encoder before their filter
// (tpuzip/codecs/lz4.py:153 `_candidates`, a stable argsort of each row's
// hashes: compress_from_device and compress(device_encode=True), bits
// 0..32).  kernels/lz4_links.py is the plain version (XLA's construction);
// chip_smoke.py holds the two equal.  Each encoder takes its own kernel on
// rows of at most 65,536 bytes at hashes of at most 16 bits (split_row
// over a direct table in shared memory: lz4_chain.cu's links,
// lz4_dense.cu's words); these are the rest, lz4_shared.cuh's routes:
//   - tiled, rows past 65,536 bytes at hashes of at most 16 bits: tiles of
//     32 Ki positions, each by split_row against a table of 2^bits u16
//     slots in shared memory (128 KiB at 16 bits), then the carry across
//     the tiles (deflate_encode.cu's wide links take the same template
//     under deflate's 3-byte key);
//   - sorted, hashes of 17-32 bits at any width: a tile of 4,096 positions
//     sorted by (hash, position) in shared memory, then its distinct
//     hashes merged across the row's tiles.
// As first ported, both encoders took these rows one warp a row, 32
// positions a step, each step waiting on an open-addressing table of
// 8-byte slots in device memory (PERF.md §6, rows 13 and 15).

#include <cuda_runtime.h>

#include <cstdint>

#include "lz4_shared.cuh"

// The tiled route: blocks (B, n) u8 and lengths (B,) i32 in, prev (B, n)
// i32 out, every entry written; bits 0..16; scratch of
// tpz_lz4_links_tiled_scratch bytes.  Launches on `stream` and returns the
// first CUDA error.
extern "C" int tpz_lz4_links_tiled(const void* blocks, const void* lengths,
                                   int B, int n, int bits, void* prev,
                                   void* scratch, void* stream) {
  return static_cast<int>(
      lz4s::launch_links_tiled<lz4s::Key4, lz4s::MF_LIMIT, -1>(
          blocks, lengths, B, n, bits, prev, scratch,
          static_cast<cudaStream_t>(stream)));
}

extern "C" long long tpz_lz4_links_tiled_scratch(int B, int n, int bits) {
  return lz4s::links_tiled_scratch(B, n, bits);
}

// The sorted route: as the tiled one, bits 0..32; scratch of
// tpz_lz4_links_sorted_scratch bytes.
extern "C" int tpz_lz4_links_sorted(const void* blocks, const void* lengths,
                                    int B, int n, int bits, void* prev,
                                    void* scratch, void* stream) {
  return static_cast<int>(lz4s::launch_links_sorted<lz4s::Key4,
                                                    lz4s::MF_LIMIT>(
      blocks, lengths, B, n, bits, prev, scratch,
      static_cast<cudaStream_t>(stream)));
}

extern "C" long long tpz_lz4_links_sorted_scratch(int B, int n) {
  return lz4s::links_sorted_scratch(B, n);
}
