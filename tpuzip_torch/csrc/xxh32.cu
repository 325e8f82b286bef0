// xxh32.cu — xxHash32 of each row of a batch, and the stripe update of a
// streaming xxHash32 state: the LZ4 frame's content and block checksums.
//
// tpuzip has no Pallas kernel for xxh32: it computes the frame's checksums
// on the host, in C++ (`tpz_xxh32`, `tpz_xxh32_stripes`,
// tpuzip/csrc/tpuzip_host.cpp:74-127) or in Python
// (tpuzip/oracle/xxh32.py:23 `xxh32`, :56 `Xxh32State`).  The port may not
// call them, and its frame paths hold the bytes on the card already (the
// encoder's upload, the decoder's output), so this kernel replaces them.
// The function: four lane accumulators v1..v4 from the seed over the
// row's whole 16-byte stripes, v = rotl(v + w * P2, 13) * P1 for the
// stripe's k-th little-endian word w; below 16 bytes h = seed + P5, else
// h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18); then
// h += n, the tail's 4-byte words and bytes, and the avalanche.
//
// What bounds it on this card: not bytes but each lane's chain.  A lane's
// n / 16 steps depend each on the one before, and xxh32 has no combine of
// partial hashes (Adler-32 has one), so a row is four serial chains
// whatever the kernel's shape.  The design keeps the chain's steps
// free of device-memory latency:
//   - a warp a row (xxh32_batch: a frame's content, B = 1, or its blocks'
//     checksums, B = blocks); lanes 0-3 carry the four chains in step, one
//     instruction a step for all four;
//   - the row is staged through a shared-memory ring of TILE-byte tiles by
//     cp.async, two tiles ready and two in flight, every lane of the warp
//     issuing the copies, so that a step reads a word of shared memory
//     (two aligned words funnel-shifted by the row's skew) that was loaded
//     long before, and the loads of an unrolled run of steps issue ahead
//     of the chain;
//   - the stripe entry (xxh32_stripes) is the same loop on one row, its
//     lanes' state read from and written back to device memory, so that a
//     streaming checksum carries the four states across calls; the tail
//     and the digest stay with the caller (core.checksum.Xxh32Stream).
// A step is an IMAD, a funnel-shift rotate and an IMUL on the chain,
// about a dozen cycles of dependent latency; PERF.md row 26 gives the
// chain bound beside the bandwidth bound.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr uint32_t P1 = 2654435761u;
constexpr uint32_t P2 = 2246822519u;
constexpr uint32_t P3 = 3266489917u;
constexpr uint32_t P4 = 668265263u;
constexpr uint32_t P5 = 374761393u;
constexpr int TILE = 2048;        // bytes of a staged tile
constexpr int RING = 4 * TILE;    // two tiles ready, two in flight
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// A row's bytes, staged through shared memory: tile t holds the bytes
// [t * TILE, (t + 1) * TILE) past `base`, the row's start rounded down to
// 16 bytes, in slot t % 4 of the ring; tiles lo and lo + 1 are ready,
// lo + 2 and lo + 3 in flight.  A byte past the row is never loaded.
struct Ring {
  uint8_t* ring;
  const uint8_t* base;
  int skew;       // the row's first byte's place past base
  long long n;    // the row's bytes
  long long lo;

  __device__ __forceinline__ void load(long long tile) {
    uint8_t* slot = ring + (tile & 3) * TILE;
    for (int c = threadIdx.x; c < TILE / 16; c += 32) {
      const long long g = tile * TILE + 16 * c;
      if (g < skew + n) cp_async16(slot + 16 * c, base + g);
    }
    cp_commit();
  }

  __device__ __forceinline__ void start() {
    lo = 0;
    for (int t = 0; t < 4; ++t) load(t);
    cp_wait<2>();
    __syncwarp();
  }

  // The end of the ready tiles, as a place in the row.
  __device__ __forceinline__ long long end() const {
    return (lo + 2) * TILE - skew;
  }

  // One more tile ready, the oldest dropped: every lane is done with it.
  __device__ __forceinline__ void advance() {
    __syncwarp();
    load(lo + 4);
    ++lo;
    cp_wait<2>();
    __syncwarp();
  }

  // The little-endian word at row byte p (ready), from the two aligned
  // words of the ring that hold it.
  __device__ __forceinline__ uint32_t word(long long p) const {
    const unsigned q = static_cast<unsigned>((p + skew) & (RING - 1));
    const uint32_t* w = reinterpret_cast<const uint32_t*>(ring);
    const unsigned i = q >> 2;
    return __funnelshift_r(w[i], w[(i + 1) & (RING / 4 - 1)], 8 * (q & 3));
  }

  __device__ __forceinline__ uint32_t byte(long long p) const {
    return ring[(p + skew) & (RING - 1)];
  }
};

// Lane k < 4's chain over the row's first `stripes` stripes, from v; the
// other lanes only stage.  Returns lane k's state (v unchanged past lane 3).
__device__ __forceinline__ uint32_t run_stripes(Ring& r, long long stripes,
                                                uint32_t v) {
  const int lane = threadIdx.x;
  long long s = 0;
  while (s < stripes) {
    const long long last = min(stripes, r.end() / 16);
    if (lane < 4) {
#pragma unroll 8
      for (long long t = s; t < last; ++t)
        v = rotl(v + r.word(16 * t + 4 * lane) * P2, 13) * P1;
    }
    s = last;
    if (s < stripes) r.advance();
  }
  return v;
}

// xxh32 of each row (STRIPES false), or the stripe update of one state
// (STRIPES true: row 0 is `n` bytes, n a multiple of 16, and state holds
// the four lanes in and out).
template <bool STRIPES>
__global__ void __launch_bounds__(32)
xxh32_kernel(const uint8_t* __restrict__ rows,
             const int32_t* __restrict__ lens, long long w, uint32_t seed,
             uint32_t* __restrict__ out, uint32_t* __restrict__ state,
             long long nbytes) {
  __shared__ __align__(16) uint8_t ring[RING];
  const int lane = threadIdx.x;
  const int row = blockIdx.x;
  const uint8_t* src = rows + static_cast<size_t>(row) * w;
  const long long n =
      STRIPES ? nbytes : min(static_cast<long long>(max(lens[row], 0)), w);
  const int skew = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  Ring r{ring, src - skew, skew, n, 0};
  r.start();
  const long long stripes = n / 16;
  uint32_t v;
  if (STRIPES) {
    v = lane < 4 ? state[lane] : 0u;
  } else {
    v = lane == 0 ? seed + P1 + P2
                  : lane == 1 ? seed + P2 : lane == 2 ? seed : seed - P1;
  }
  v = run_stripes(r, stripes, v);
  if (STRIPES) {
    cp_wait<0>();
    if (lane < 4) state[lane] = v;
    return;
  }
  const uint32_t v1 = __shfl_sync(FULL, v, 0), v2 = __shfl_sync(FULL, v, 1);
  const uint32_t v3 = __shfl_sync(FULL, v, 2), v4 = __shfl_sync(FULL, v, 3);
  while (r.end() < n) r.advance();   // the tail's bytes ready
  if (lane == 0) {
    uint32_t h = n >= 16 ? rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) +
                               rotl(v4, 18)
                         : seed + P5;
    h += static_cast<uint32_t>(n);
    long long p = 16 * stripes;
    for (; p + 4 <= n; p += 4) h = rotl(h + r.word(p) * P3, 17) * P4;
    for (; p < n; ++p) h = rotl(h + r.byte(p) * P5, 11) * P1;
    h ^= h >> 15;
    h *= P2;
    h ^= h >> 13;
    h *= P3;
    h ^= h >> 16;
    out[row] = h;
  }
  cp_wait<0>();
}

}  // namespace

// rows (B, w) u8 and lens (B,) i32 (a row's bytes are its first
// min(len, w)) in; out (B,) u32, each row's xxh32 at `seed`.  Launches B
// blocks of one warp on `stream` and returns cudaGetLastError().
extern "C" int tpz_xxh32_batch(const void* rows, const void* lens, int B,
                               long long w, unsigned seed, void* out,
                               void* stream) {
  xxh32_kernel<false><<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rows), static_cast<const int32_t*>(lens),
      w, seed, static_cast<uint32_t*>(out), nullptr, 0);
  return static_cast<int>(cudaGetLastError());
}

// state (4,) u32, the four lanes, updated in place over the 16-byte
// stripes of data's first 16 * nstripes bytes (tpz_xxh32_stripes); one
// block of one warp on `stream`.  Returns cudaGetLastError().
extern "C" int tpz_xxh32_stripes(void* state, const void* data,
                                 long long nstripes, void* stream) {
  xxh32_kernel<true><<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), nullptr, 0, 0,
      nullptr, static_cast<uint32_t*>(state), 16 * nstripes);
  return static_cast<int>(cudaGetLastError());
}
