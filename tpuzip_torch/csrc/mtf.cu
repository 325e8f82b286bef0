// mtf.cu — move-to-front ENCODE and DECODE, every stream cut into chunks
// that run side by side.
//
// Replaces tpuzip/kernels/mtf_scan.py:33 `_mtf_kernel` (its pallas_call is
// in `mtf_lanes`, :82; wrapper `mtf_batch`, :95), in both directions, and
// adds the masking of the XLA scan (tpuzip/codecs/mtf.py): the output is 0
// from each stream's length on, which the TPU kernel did not write.
//
// What bounds it on this card: a stream is a serial chain — a byte's rank
// comes from the list the previous byte left.  With one warp a stream (the
// port's first kernel) the bwt codec's 64 streams of 1 MiB were 64 warps on
// 132 SMs, each at the latency of its chain: 95 ns a byte encoding, 119
// decoding (NVIDIA H100 80GB HBM3, 700 W).
//
// What the design does about it: a stream is cut into chunks of CHUNK
// bytes, and every chunk of every stream runs its chain at once (16,384
// chunk-warps at 64 x 1 MiB), in three launches a direction:
//   decode  1. each chunk's steps from the identity list: the positions
//              u_t it reads (into out) and its end list P_c in that frame.
//              Exact because a decode step moves position r to the front
//              whatever the symbols are;
//           2. one warp a row: S_0 = identity, S_{c+1}[i] = S_c[P_c[i]];
//           3. out[t] = S_c[u_t], a gather through shared memory.
//   encode  1. each chunk's symbols ordered by their last position, latest
//              first (D_c): a symbol's index there, walking back from the
//              chunk's end, 32 bytes a ballot; no serial chain;
//           2. one warp a row: a symbol of D_c takes its index, any other
//              |D_c| plus its rank in S_c less the D_c symbols ranked
//              before it (a 256-bit mask and popcounts);
//           3. each chunk's steps from its S_c.
// The scratch (B x chunks x 256 bytes) holds P_c or the indices, then S_c.
// The serial pass keeps the 256 ranks in registers, 8 a lane, packed 4 to
// a u32: a step bumps the ranks below r with the byte-SIMD compares and
// clears the moved symbol's byte.  Input is loaded 128 bytes at a time
// (4 a lane) and broadcast by shuffle; the output is gathered 4 bytes a
// lane and stored 128 at a time.  Eight chunk-warps a block, so an SM
// keeps tens of warps in flight and the step is bound by issue slots, not
// by its latency.
//
// Measured in turns (chip_smoke.py --ab; NVIDIA H100 80GB HBM3, 700 W;
// PERF.md, section 6): at 64 x 1 MiB encode 3.64 ms and decode 5.16
// against 99.61 and 124.84 for one warp a stream.  Chunks of 2 to 16 KiB
// and 4 to 16 chunk-warps a block ran within 2% of these; left out as
// slower: the one-warp kernel's step (8 unpacked ranks a lane, an 8-way
// select, 8 compare-adds) in this layout, 1.4-1.7x; hand-written SWAR
// byte compares in place of the intrinsics, 1.16x encoding.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int CHUNK = 4096;  // bytes a chunk; a multiple of GROUP
constexpr int WARPS = 8;     // chunk-warps a block
constexpr int GROUP = 128;   // bytes a warp loads at once, 4 a lane
constexpr uint32_t ONES = 0x01010101u, HIGH = 0x80808080u;

// 0x01 in each byte of a that is below r (r4: r in every byte).
__device__ __forceinline__ uint32_t below(uint32_t a, uint32_t r4) {
  return __vcmpltu4(a, r4) & ONES;
}

// 0x80 in each byte of x that is 0, and nowhere else.
__device__ __forceinline__ uint32_t zero_bytes(uint32_t x) {
  return __vcmpeq4(x, 0u) & HIGH;
}

// One step on the ranks rank_of[8 * lane + j], byte j & 3 of w[j >> 2].
// Encode takes a symbol and gives its rank; decode takes a rank and gives
// its symbol.  Then the ranks below r move up one and the symbol goes to 0.
template <bool DECODE>
__device__ __forceinline__ uint32_t step(uint32_t x, uint32_t& w0,
                                         uint32_t& w1, int lane) {
  uint32_t r, y, k0, k1;
  if (DECODE) {
    r = x;
    const uint32_t r4 = r * ONES;
    const uint32_t z0 = zero_bytes(w0 ^ r4), z1 = zero_bytes(w1 ^ r4);
    const int owner = __ffs(__ballot_sync(FULL, (z0 | z1) != 0)) - 1;
    const int at =
        (__ffsll(static_cast<long long>(
             (static_cast<unsigned long long>(z1) << 32) | z0)) - 1) >> 3;
    y = 8u * owner + __shfl_sync(FULL, at, owner);
    k0 = (z0 >> 7) * 0xffu;
    k1 = (z1 >> 7) * 0xffu;
  } else {
    y = __shfl_sync(FULL, __byte_perm(w0, w1, x & 7), x >> 3) & 0xffu;
    r = y;
    const unsigned long long kill =
        lane == static_cast<int>(x >> 3) ? 0xffull << (8 * (x & 7)) : 0ull;
    k0 = static_cast<uint32_t>(kill);
    k1 = static_cast<uint32_t>(kill >> 32);
  }
  const uint32_t r4 = r * ONES;
  w0 = (w0 + below(w0, r4)) & ~k0;
  w1 = (w1 + below(w1, r4)) & ~k1;
  return y;
}

// The identity ranks of this lane's 8 symbols.
__device__ __forceinline__ void identity(uint32_t& w0, uint32_t& w1,
                                         int lane) {
  w0 = 8u * lane * ONES + 0x03020100u;
  w1 = 8u * lane * ONES + 0x07060504u;
}

// Chunk g of the batch: row b, its bytes [t0, end) and the valid ones
// [t0, stop), stop <= t0 past the row's length.
struct Chunk {
  int b, t0, end, stop;
  __device__ __forceinline__ Chunk(int g, int nc, const int32_t* lengths,
                                   int N) {
    b = g / nc;
    t0 = (g - b * nc) * CHUNK;
    end = min(t0 + CHUNK, N);
    stop = min(end, max(0, min(lengths[b], N)));
  }
};

// Pass 1 of decode (DECODE) and pass 3 of encode: every chunk's steps,
// from the identity list (decode) or from S_c (encode).  The steps past a
// row's length run on zeros and are not stored: only the row's last valid
// chunk has them, whose end list no one reads.
template <bool DECODE>
__global__ void __launch_bounds__(32 * WARPS)
mtf_scan(const uint8_t* __restrict__ in, const int32_t* __restrict__ lengths,
         int B, int N, int nc, uint8_t* __restrict__ out,
         uint8_t* __restrict__ scratch) {
  __shared__ __align__(8) uint8_t ends[DECODE ? WARPS : 1][256];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = blockIdx.x * WARPS + warp;
  if (g >= B * nc) return;  // no block-wide barrier follows
  const Chunk k(g, nc, lengths, N);
  const uint8_t* row = in + static_cast<size_t>(k.b) * N;
  uint8_t* orow = out + static_cast<size_t>(k.b) * N;
  uint2* state = reinterpret_cast<uint2*>(scratch + static_cast<size_t>(g) *
                                          256);
  uint32_t w0, w1;
  if (DECODE) {
    identity(w0, w1, lane);
  } else if (k.t0 < k.stop) {
    const uint2 s = state[lane];
    w0 = s.x;
    w1 = s.y;
  }
  for (int t = k.t0; t < k.stop; t += GROUP) {
    uint32_t word = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = t + 4 * lane + q;
      if (i < k.stop) word |= static_cast<uint32_t>(row[i]) << (8 * q);
    }
    uint32_t res = 0;  // this lane's 4 output bytes of the group
#pragma unroll 2
    for (int j = 0; j < 32; ++j) {
      const uint32_t v = __shfl_sync(FULL, word, j);
      uint32_t o = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        o |= step<DECODE>((v >> (8 * q)) & 0xffu, w0, w1, lane) << (8 * q);
      if (lane == j) res = o;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = t + 4 * lane + q;
      if (i < k.stop) orow[i] = static_cast<uint8_t>(res >> (8 * q));
    }
  }
  for (int i = max(k.stop, k.t0) + lane; i < k.end; i += 32) orow[i] = 0;
  if (DECODE && k.t0 < k.stop) {  // the end list in the frame: P_c[rank] = u
    uint8_t* e = ends[warp];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      e[((j < 4 ? w0 : w1) >> (8 * (j & 3))) & 0xffu] =
          static_cast<uint8_t>(8 * lane + j);
    __syncwarp();
    state[lane] = reinterpret_cast<const uint2*>(e)[lane];
  }
}

// Pass 1 of encode: each symbol's index in D_c, or 0xff if the chunk lacks
// it.  Walking back from the chunk's end 32 bytes at a time, the latest of
// equal symbols in a group is its highest lane, and a symbol not met yet
// takes the count met so far plus the new ones in later lanes.  The walk
// ends once all 256 are met, so 0xff is never an index read back here; in
// pass 2 an index of 255 and a missing symbol give the same rank.
__global__ void __launch_bounds__(32 * WARPS)
mtf_last(const uint8_t* __restrict__ in, const int32_t* __restrict__ lengths,
         int B, int N, int nc, uint8_t* __restrict__ scratch) {
  __shared__ __align__(8) uint8_t index[WARPS][256];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = blockIdx.x * WARPS + warp;
  if (g >= B * nc) return;
  const Chunk k(g, nc, lengths, N);
  if (k.t0 >= k.stop) return;  // pass 2 reads no chunk past the length
  const uint8_t* row = in + static_cast<size_t>(k.b) * N;
  uint8_t* d = index[warp];
  reinterpret_cast<uint2*>(d)[lane] = make_uint2(FULL, FULL);
  __syncwarp();
  auto load = [&](int t) {  // bytes t + 4 lane .. + 3, 0 past the stop
    uint32_t word = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = t + 4 * lane + q;
      if (i < k.stop) word |= static_cast<uint32_t>(row[i]) << (8 * q);
    }
    return word;
  };
  int met = 0;
  int t = k.t0 + (k.stop - 1 - k.t0) / GROUP * GROUP;
  uint32_t next = load(t);
  for (; t >= k.t0 && met < 256; t -= GROUP) {
    const uint32_t word = next;
    if (t > k.t0) next = load(t - GROUP);
#pragma unroll
    for (int h = 3; h >= 0; --h) {  // bytes t + 32 h + lane
      const int p = t + 32 * h + lane;
      const uint32_t x =
          p < k.stop ? (__shfl_sync(FULL, word, 8 * h + (lane >> 2)) >>
                        (8 * (lane & 3))) & 0xffu
                     : 256u + lane;  // a value of its own: never a symbol
      const unsigned same = __match_any_sync(FULL, x);
      const bool fresh = p < k.stop && 31 - __clz(same) == lane &&
                         d[x] == 0xff && met < 256;
      const unsigned news = __ballot_sync(FULL, fresh);
      if (fresh) d[x] = static_cast<uint8_t>(met + __popc(news >> lane >> 1));
      met += __popc(news);
      __syncwarp();
    }
  }
  reinterpret_cast<uint2*>(scratch + static_cast<size_t>(g) * 256)[lane] =
      reinterpret_cast<const uint2*>(d)[lane];
}

// Pass 2: one warp a row walks its chunks in order, reads chunk c's
// record (P_c, or the indices) and writes S_c over it: the list (decode)
// or the ranks (encode) at the chunk's start.
template <bool DECODE>
__global__ void __launch_bounds__(32)
mtf_compose(const int32_t* __restrict__ lengths, int N, int nc,
            uint8_t* __restrict__ scratch) {
  __shared__ __align__(8) uint8_t list[256];
  __shared__ uint32_t mask[8], before[8];
  const int lane = threadIdx.x, b = blockIdx.x;
  const int len = max(0, min(lengths[b], N));
  const int chunks = (len + CHUNK - 1) / CHUNK;
  uint2* rec = reinterpret_cast<uint2*>(scratch + static_cast<size_t>(b) *
                                        nc * 256);
  uint32_t w0, w1;  // S_c: this lane's 8 bytes, 8 lane .. 8 lane + 7
  identity(w0, w1, lane);
  uint2 next = chunks > 0 ? rec[lane] : make_uint2(0, 0);
  for (int c = 0; c < chunks; ++c) {
    const uint2 p = next;
    if (c + 1 < chunks) next = rec[32 * (c + 1) + lane];
    rec[32 * c + lane] = make_uint2(w0, w1);
    if (c + 1 == chunks) break;
    uint32_t n0 = 0, n1 = 0;
    if (DECODE) {  // S_{c+1}[i] = S_c[P_c[i]]
      reinterpret_cast<uint2*>(list)[lane] = make_uint2(w0, w1);
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        n0 |= static_cast<uint32_t>(list[(p.x >> (8 * j)) & 0xffu]) << (8 * j);
        n1 |= static_cast<uint32_t>(list[(p.y >> (8 * j)) & 0xffu]) << (8 * j);
      }
      __syncwarp();
    } else {
      if (lane < 8) mask[lane] = 0;
      __syncwarp();
      int present = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t idx = ((j < 4 ? p.x : p.y) >> (8 * (j & 3))) & 0xffu;
        const uint32_t rank = ((j < 4 ? w0 : w1) >> (8 * (j & 3))) & 0xffu;
        if (idx != 0xffu) {
          atomicOr(&mask[rank >> 5], 1u << (rank & 31));
          ++present;
        }
      }
      const uint32_t dc = __reduce_add_sync(FULL, present);
      __syncwarp();
      const uint32_t bits = lane < 8 ? __popc(mask[lane]) : 0u;
      uint32_t sum = bits;  // inclusive prefix over lanes 0..7
#pragma unroll
      for (int s = 1; s < 8; s *= 2) {
        const uint32_t v = __shfl_up_sync(FULL, sum, s);
        if (lane >= s) sum += v;
      }
      if (lane < 8) before[lane] = sum - bits;
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t idx = ((j < 4 ? p.x : p.y) >> (8 * (j & 3))) & 0xffu;
        const uint32_t rank = ((j < 4 ? w0 : w1) >> (8 * (j & 3))) & 0xffu;
        const uint32_t under =
            before[rank >> 5] +
            __popc(mask[rank >> 5] & ((1u << (rank & 31)) - 1u));
        const uint32_t v = idx != 0xffu ? idx : dc + rank - under;
        if (j < 4)
          n0 |= v << (8 * j);
        else
          n1 |= v << (8 * (j - 4));
      }
      __syncwarp();
    }
    w0 = n0;
    w1 = n1;
  }
}

// Pass 3 of decode: out[t] = S_c[u_t] on the valid bytes.
__global__ void __launch_bounds__(32 * WARPS)
mtf_map(const int32_t* __restrict__ lengths, int B, int N, int nc,
        uint8_t* __restrict__ out, const uint8_t* __restrict__ scratch) {
  __shared__ __align__(8) uint8_t lists[WARPS][256];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = blockIdx.x * WARPS + warp;
  if (g >= B * nc) return;
  const Chunk k(g, nc, lengths, N);
  if (k.t0 >= k.stop) return;
  uint8_t* list = lists[warp];
  reinterpret_cast<uint2*>(list)[lane] = reinterpret_cast<const uint2*>(
      scratch + static_cast<size_t>(g) * 256)[lane];
  __syncwarp();
  uint8_t* orow = out + static_cast<size_t>(k.b) * N;
#pragma unroll 4
  for (int i = k.t0 + lane; i < k.stop; i += 32) orow[i] = list[orow[i]];
}

}  // namespace

// Bytes a chunk: the wrapper sizes the scratch by it.
extern "C" int tpz_mtf_chunk_bytes() { return CHUNK; }

// in (B, N) u8 and lengths (B,) i32; out (B, N) u8, 0 from each length on;
// scratch: B * ceil(N / CHUNK) * 256 bytes, any contents.  decode != 0
// runs the inverse.  Three launches on `stream`; returns
// cudaGetLastError().
extern "C" int tpz_mtf_chunked(const void* in, const void* lengths, int B,
                               int N, void* out, void* scratch, int decode,
                               void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const uint8_t*>(in);
  const auto* lens = static_cast<const int32_t*>(lengths);
  auto* y = static_cast<uint8_t*>(out);
  auto* w = static_cast<uint8_t*>(scratch);
  const int nc = (N + CHUNK - 1) / CHUNK;
  const int grid = (B * nc + WARPS - 1) / WARPS;
  if (decode) {
    mtf_scan<true><<<grid, 32 * WARPS, 0, s>>>(x, lens, B, N, nc, y, w);
    mtf_compose<true><<<B, 32, 0, s>>>(lens, N, nc, w);
    mtf_map<<<grid, 32 * WARPS, 0, s>>>(lens, B, N, nc, y, w);
  } else {
    mtf_last<<<grid, 32 * WARPS, 0, s>>>(x, lens, B, N, nc, w);
    mtf_compose<false><<<B, 32, 0, s>>>(lens, N, nc, w);
    mtf_scan<false><<<grid, 32 * WARPS, 0, s>>>(x, lens, B, N, nc, y, w);
  }
  return static_cast<int>(cudaGetLastError());
}
