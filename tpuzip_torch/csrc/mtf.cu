// mtf.cu — move-to-front ENCODE and DECODE, one warp per stream.
//
// Replaces tpuzip/kernels/mtf_scan.py:33 `_mtf_kernel` (its pallas_call is
// in `mtf_lanes`, :82; wrapper `mtf_batch`, :95), in both directions, and
// adds the masking of the XLA scan (tpuzip/codecs/mtf.py): the output is 0
// from each stream's length on, which the TPU kernel did not write.
//
// What bounds it on this card: each stream is a serial chain — a byte's
// rank comes from the permutation the previous byte left — so a stream
// runs at the latency of a few dependent shuffles a byte, not at a byte
// or operation rate.  With the bwt codec's default 1 MiB blocks a 64 MiB
// corpus is only 64 streams, 64 warps on 132 SMs, so most of the card
// idles; more streams a block, or splitting a stream, is later work.
//
// What the design does about it: the 256-entry rank permutation never
// leaves registers (lane l holds rank_of[8l .. 8l+7]), so a step touches
// no memory.  Encode reads r with one shuffle from the lane owning sym;
// decode finds the owner of rank r with one ballot over an 8-way compare
// and one shuffle of the owner's hit mask.  The update is 8 compare-adds a
// lane.  Input is loaded 128 bytes at a time (4 a lane) and broadcast by
// shuffle; the output is gathered 4 bytes a lane and stored 128 at a time.
// Each warp is its own block, so the streams spread over all SMs.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int GROUP = 128;   // bytes a warp loads at once, 4 a lane

// v[j] for a warp-uniform j, as a chain of selects: the state stays in
// registers (a dynamic index would send it to local memory).
__device__ __forceinline__ uint32_t pick(const uint32_t (&v)[8], int j) {
  uint32_t x = v[0];
#pragma unroll
  for (int k = 1; k < 8; ++k) x = (j == k) ? v[k] : x;
  return x;
}

template <bool DECODE>
__global__ void __launch_bounds__(32)
mtf_kernel(const uint8_t* __restrict__ in, const int32_t* __restrict__ lengths,
           int N, uint8_t* __restrict__ out) {
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const uint8_t* row = in + static_cast<size_t>(b) * N;
  uint8_t* orow = out + static_cast<size_t>(b) * N;
  const int len = max(0, min(lengths[b], N));

  uint32_t rank[8];   // rank_of[8 * lane + j]
#pragma unroll
  for (int j = 0; j < 8; ++j) rank[j] = 8u * lane + j;

  for (int t0 = 0; t0 < len; t0 += GROUP) {
    uint32_t word = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = t0 + 4 * lane + k;
      if (i < len) word |= static_cast<uint32_t>(row[i]) << (8 * k);
    }
    uint32_t res = 0;   // this lane's 4 output bytes of the group
    const int steps = min(GROUP, len - t0);
    for (int j = 0; j < steps; ++j) {
      const uint32_t x = (__shfl_sync(FULL, word, j >> 2) >> (8 * (j & 3))) &
                         0xffu;
      uint32_t r, sym;
      if (DECODE) {
        r = x;
        uint32_t hit = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) hit |= (rank[k] == r ? 1u : 0u) << k;
        const int owner = __ffs(__ballot_sync(FULL, hit != 0)) - 1;
        hit = __shfl_sync(FULL, hit, owner);
        sym = 8u * owner + (__ffs(hit) - 1);
      } else {
        sym = x;
        r = __shfl_sync(FULL, pick(rank, sym & 7), sym >> 3);
      }
      // ranks below r move up one; sym (whose rank is r) moves to the front
#pragma unroll
      for (int k = 0; k < 8; ++k)
        rank[k] = (8u * lane + k == sym) ? 0u : rank[k] + (rank[k] < r);
      if (lane == (j >> 2)) res |= (DECODE ? sym : r) << (8 * (j & 3));
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = t0 + 4 * lane + k;
      if (i < len) orow[i] = static_cast<uint8_t>(res >> (8 * k));
    }
  }
  for (int i = len + lane; i < N; i += 32) orow[i] = 0;
}

}  // namespace

// in (B, N) u8 and lengths (B,) i32; out (B, N) u8, 0 from each length on.
// decode != 0 runs the inverse.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int tpz_mtf(const void* in, const void* lengths, int B, int N,
                       void* out, int decode, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const uint8_t*>(in);
  const auto* lens = static_cast<const int32_t*>(lengths);
  auto* y = static_cast<uint8_t*>(out);
  if (decode)
    mtf_kernel<true><<<B, 32, 0, s>>>(x, lens, N, y);
  else
    mtf_kernel<false><<<B, 32, 0, s>>>(x, lens, N, y);
  return static_cast<int>(cudaGetLastError());
}
