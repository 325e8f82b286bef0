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
// status -1 is all 0.  Its history mode (tpz_lz4_decode_history) reads
// the blocks of a linked LZ4 frame, as tpuzip's _decompress_linked
// (tpuzip/oracle/lz4.py:265-300) does: a row starts with up to 64 KiB of
// the output before it, and its matches may reach into it.
//
// What bounds it on this card: not bytes but each row's chain of
// dependent steps.  A sequence's token, its length extensions and its
// offset are dependent loads, the next token's place follows from them,
// and a match reads bytes that the warp stored moments before.  Taken one
// sequence at a time from device memory (the kernel as ported), that was
// about 700 cycles a sequence on a row alone, of 6,900 sequences a row of
// text; taken one at a time from shared memory, still about 360 cycles of
// instructions and branches.  So the design takes a warp's worth of
// sequences at once and keeps the branches out of every per-byte loop:
//   - one warp a block, the block from blockIdx.x, so that the 1024 rows
//     of a batch of 64 KiB blocks are all resident at once (20 KiB of
//     shared memory a block); the output's home is device memory
//     (out_cap is the caller's block size);
//   - the stream is staged in shared memory in tiles of TILE bytes by
//     cp.async, two tiles ahead of the parse;
//   - a batch is up to BATCH sequences starting in the next WIN places:
//     each lane reads 4 places and, for each, where a sequence starting
//     there would end (Sequence: at most one extension byte a length, its
//     bytes ready and in the stream), with no branch; tables of 1, 2, 4,
//     8 and 16 jumps then give lane k the k-th start in 5 shuffles, and a
//     warp scan of the sequences' lengths their output starts.  A
//     sequence the batch does not take (the stream's last, one with a
//     longer extension, one past the ready bytes) is parsed alone, as the
//     kernel did before, straight into device memory;
//   - a batch's output is built in a shared-memory history of the last
//     HIST bytes written, then goes out to device memory 32 consecutive
//     bytes a warp's store.  Its matches resolve in rounds (multi-round
//     resolution, Sitaridi et al., ICPP 2016): a match is ready when its
//     source's end, start - offset + min(offset, length), lies at or
//     before the earliest pending match's start, so every byte it reads
//     is final, and the earliest is always ready.  A ready lane loads its
//     source bytes into registers by the periodic rule
//     out[o - off + (m % off)], through one pointer into the history or
//     into device memory, and then stores them; a match longer than
//     LANE_BYTES is copied by the whole warp, 32 x WARP_BYTES bytes a
//     step.  __syncwarp() orders one round's stores before the next
//     round's loads, and the batch's literals before its first round.
//   - Kept off: batches of 8 or 16 sequences (more rounds a sequence),
//     the batch's bytes read from a register window by __shfl_sync (4
//     shuffles a byte), separate shared and device paths for a match's
//     source (they run one after the other in a warp).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int MIN_MATCH = 4;
constexpr int TILE = 1024;       // stream bytes a staged tile
constexpr int RING = 4 * TILE;   // two tiles parsed from, two in flight
constexpr int WIN = 128;         // places a batch's sequences start at
constexpr int BATCH = 32;        // sequences a batch, at most
constexpr int END_MAX = 254;     // a batch's sequence ends by this place
constexpr int MATCH_MAX = 240;   // a batch's match's bytes, at most
constexpr int HIST = 16384;      // output bytes kept in shared memory
constexpr int LANE_BYTES = 18;   // a lane copies a match this long alone
constexpr int WARP_BYTES = 8;    // a lane's bytes a step of a warp's copy
constexpr int NONE = 0x7FFFFFFF;
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

// A row's stream, staged through shared memory: tile t holds the bytes
// [t * TILE, (t + 1) * TILE) past `base`, the row's start rounded down to
// 16 bytes, in slot t % 4 of the ring; tiles lo and lo + 1 are ready, lo
// + 2 and lo + 3 in flight.
struct Stream {
  uint8_t* ring;
  const uint8_t* base;
  int skew;   // the row's first byte's place past base
  int n;      // the stream's bytes
  int lo;

  __device__ __forceinline__ void load(int tile) {
    uint8_t* slot = ring + (tile & 3) * TILE;
    for (int c = threadIdx.x; c < TILE / 16; c += 32) {
      const int g = tile * TILE + 16 * c;
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

  // The end of the ready tiles, as a place in the stream.
  __device__ __forceinline__ int end() const {
    return (lo + 2) * TILE - skew;
  }

  // Byte p, which lies in the ready tiles to mean anything (any p reads
  // some byte of the ring).
  __device__ __forceinline__ int at(int p) const {
    return ring[(p + skew) & (RING - 1)];
  }

  // Makes byte p ready, dropping the oldest tile while p lies past the
  // ready ones: the caller needs no byte more than a tile before p.
  __device__ __forceinline__ void need(int p) {
    while (p >= end()) {
      __syncwarp();   // every lane is done with tile lo
      load(lo + 4);
      ++lo;
      cp_wait<2>();
      __syncwarp();
    }
  }
};

// Adds a length's extension bytes (255 continues) read from the stream at
// i; false if the stream ends inside them.
__device__ __forceinline__ bool length_ext(Stream& s, int& i,
                                           long long& len) {
  for (;;) {
    if (i >= s.n) return false;
    s.need(i);
    const int b = s.at(i++);
    len += b;
    if (b != 255) return true;
  }
}

// A row's output: every byte in device memory (dst) up to `done`, and the
// last HIST written in shared memory (hist, byte p at p % HIST) from `lo`
// on.  A batch's match writes to hist (its bytes go out to dst after the
// batch); a match parsed alone reads and writes dst (lo = NONE).
struct Out {
  uint8_t* dst;
  uint8_t* hist;
  int lo;
  int done;

  __device__ __forceinline__ uint8_t get(int p) const {
    return p >= lo ? hist[p & (HIST - 1)] : dst[p];
  }

  template <bool HIST_OUT>
  __device__ __forceinline__ void put(int p, uint8_t v) const {
    if (HIST_OUT)
      hist[p & (HIST - 1)] = v;
    else
      dst[p] = v;
  }
};

// One lane's match of ml <= LANE_BYTES bytes at o: its source bytes into
// registers, then out.  The source is one run of bytes, in hist or in
// dst, where it can be (a generic pointer, no branch a byte); else each
// byte from where it lies.
template <bool HIST_OUT>
__device__ __forceinline__ void copy_lane(const Out& out, int o, int off,
                                          int ml) {
  const int from = o - off, span = min(off, ml);
  const uint8_t* run = nullptr;
  if (from >= out.lo && (from & (HIST - 1)) + span <= HIST)
    run = out.hist + (from & (HIST - 1));
  else if (from + span <= out.done)
    run = out.dst + from;
  uint8_t v[LANE_BYTES];
  if (run && off >= ml) {
#pragma unroll
    for (int k = 0; k < LANE_BYTES; ++k)
      if (k < ml) v[k] = run[k];
  } else {
    int r = 0;
#pragma unroll
    for (int k = 0; k < LANE_BYTES; ++k) {
      if (k < ml) v[k] = run ? run[r] : out.get(from + r);
      r = r + 1 == off ? 0 : r + 1;
    }
  }
#pragma unroll
  for (int k = 0; k < LANE_BYTES; ++k)
    if (k < ml) out.put<HIST_OUT>(o + k, v[k]);
}

// A match of any length at o, by the whole warp: byte m from
// from + m % off, 32 x WARP_BYTES bytes a step, each step's loads before
// its stores.
template <bool HIST_OUT>
__device__ __forceinline__ void copy_warp(const Out& out, int o, int off,
                                          int ml) {
  const int lane = threadIdx.x;
  const int from = o - off;
  const int step = 32 % off;
  int r = lane % off;   // m % off for this lane's next byte m
  for (int m0 = 0; m0 < ml; m0 += 32 * WARP_BYTES) {
    uint8_t v[WARP_BYTES];
#pragma unroll
    for (int k = 0; k < WARP_BYTES; ++k) {
      const int m = m0 + 32 * k + lane;
      if (m < ml) v[k] = out.get(from + (off >= ml ? m : r));
      r += step;
      if (r >= off) r -= off;
    }
#pragma unroll
    for (int k = 0; k < WARP_BYTES; ++k) {
      const int m = m0 + 32 * k + lane;
      if (m < ml) out.put<HIST_OUT>(o + m, v[k]);
    }
  }
}

// The matches of a batch, lanes below cnt holding one each, in rounds.
template <bool HIST_OUT>
__device__ __forceinline__ void resolve(const Out& out, int mo, int off,
                                        int ml, int cnt) {
  bool pending = static_cast<int>(threadIdx.x) < cnt;
  __syncwarp();   // the literals, every lane's, are written
  for (;;) {
    const int first = __reduce_min_sync(FULL, pending ? mo : NONE);
    if (first == NONE) break;
    const bool ready = pending && mo - off + min(off, ml) <= first;
    if (ready && ml <= LANE_BYTES) copy_lane<HIST_OUT>(out, mo, off, ml);
    for (unsigned wide = __ballot_sync(FULL, ready && ml > LANE_BYTES);
         wide; wide &= wide - 1) {
      const int l = __ffs(wide) - 1;
      copy_warp<HIST_OUT>(out, __shfl_sync(FULL, mo, l),
                          __shfl_sync(FULL, off, l),
                          __shfl_sync(FULL, ml, l));
    }
    pending = pending && !ready;
    __syncwarp();
  }
}

// dst[from, to) = 0 by the warp, in 16-byte stores where aligned.
__device__ __forceinline__ void warp_zero(uint8_t* dst, int from, int to) {
  const int lane = threadIdx.x;
  const int head = min(to, from + static_cast<int>(
      (16 - (reinterpret_cast<uintptr_t>(dst + from) & 15)) & 15));
  const int body = head + ((to - head) & ~15);
  if (from + lane < head) dst[from + lane] = 0;
  for (int k = head + 16 * lane; k < body; k += 16 * 32)
    *reinterpret_cast<uint4*>(dst + k) = make_uint4(0, 0, 0, 0);
  if (body + lane < to) dst[body + lane] = 0;
}

// A batch's sequence at stream byte q: its lengths, each with its one
// extension byte where the nibble is 15, where its literals and offset
// lie and where it ends.  Every read is of the ring, so it is safe at any
// q; the caller decides whether the sequence is one a batch takes.
struct Sequence {
  int lit, ml, from, off_at, end;
  bool long_ext;   // an extension of more than one byte, or a match past
                   // MATCH_MAX: a batch does not take it

  __device__ __forceinline__ Sequence(const Stream& s, int q) {
    const int t = s.at(q), b1 = s.at(q + 1);
    const bool lext = t >= 0xF0, mext = (t & 15) == 15;
    lit = lext ? 15 + b1 : t >> 4;
    from = q + 1 + lext;
    off_at = from + lit;
    const int b2 = s.at(off_at + 2);
    ml = (t & 15) + MIN_MATCH + (mext ? b2 : 0);
    end = off_at + 2 + mext;
    long_ext = (lext && b1 == 255) || (mext && b2 == 255) || ml > MATCH_MAX;
  }
};

// Table t's entry for place p (t holds places 4 * lane .. 4 * lane + 3, a
// byte each), by every lane at its own p; a place past WIN is its own.
__device__ __forceinline__ int hop(unsigned t, int p) {
  const unsigned w = __shfl_sync(FULL, t, (p >> 2) & 31);
  return p < WIN ? (w >> (8 * (p & 3))) & 255 : p;
}

// HISTORY (the history mode, linked LZ4 frame blocks): each output row
// holds `pre` bytes of earlier output before the row's own, which the
// caller wrote there; the row decodes from byte pre on, its matches may
// reach back into those bytes, and its status counts its own bytes.  The
// mode is picked by `if constexpr`, so the block mode keeps its SASS.
template <bool HISTORY>
__global__ void __launch_bounds__(32)
lz4_decode_kernel(const uint8_t* __restrict__ comp,
                  const int32_t* __restrict__ clens, int w,
                  uint8_t* __restrict__ out, int out_cap,
                  int64_t* __restrict__ status, int pre) {
  __shared__ __align__(16) uint8_t ring[RING];
  __shared__ __align__(16) uint8_t hist[HIST + 16];   // and a spare byte
  const int lane = threadIdx.x;
  const int row = blockIdx.x;
  const uint8_t* src = comp + static_cast<size_t>(row) * w;
  uint8_t* dst = out + static_cast<size_t>(row) * out_cap;
  const int skew = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  Stream s{ring, src - skew, skew, min(max(clens[row], 0), w), 0};
  s.start();
  const int n = s.n;
  int o0 = 0;   // the row's first output byte
  if constexpr (HISTORY) o0 = pre;
  int i = 0, o = o0;
  int hist_lo = o0;   // the output bytes before it are not in hist
  bool bad = false;
  while (i < n) {
    // a batch: the sequences from i whose bytes lie in the stream and the
    // first END_MAX ready places, with at most one byte a length
    // extension and a match of at most MATCH_MAX bytes.  jump: for each of
    // this lane's 4 places, the place after a sequence starting there, or
    // the place itself where the batch cannot take one
    s.need(min(i + 2 * END_MAX, n - 1));
    const int lim = min(min(n, s.end()) - i, END_MAX);
    unsigned jump = 0;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int q = 4 * lane + r;
      const Sequence sq(s, i + q);
      const int e = sq.end - i;
      jump |= static_cast<unsigned>(e <= lim && !sq.long_ext ? e : q)
              << (8 * r);
    }
    // the k-th start from place 0 in lane k, by jumps of 1, 2, 4, 8 and
    // 16 sequences (each table the one before it taken twice)
    unsigned jumps[5];
    jumps[0] = jump;
#pragma unroll
    for (int l = 1; l < 5; ++l) {
      jumps[l] = 0;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        jumps[l] |= static_cast<unsigned>(hop(
                        jumps[l - 1], (jumps[l - 1] >> (8 * r)) & 255))
                    << (8 * r);
    }
    int pos = 0;
#pragma unroll
    for (int l = 0; l < 5; ++l) {
      const int p = hop(jumps[l], pos);
      if ((lane >> l) & 1) pos = p;
    }
    const int next = hop(jump, pos);
    const int count = __popc(__ballot_sync(
        FULL, pos < WIN && next != pos && lane < BATCH));
    // where the batch ends: the next start, or the sequence to parse
    // alone (stopped)
    const int p = count < 32 ? __shfl_sync(FULL, pos, count & 31)
                             : __shfl_sync(FULL, next, 31);
    const bool stopped = count < BATCH && p < WIN;
    int lit = 0, ml = 0, off = 1, from = 0;
    if (lane < count) {
      const Sequence sq(s, i + pos);
      lit = sq.lit;
      ml = sq.ml;
      from = sq.from;
      off = s.at(sq.off_at) | (s.at(sq.off_at + 1) << 8);
    }
    // each sequence's output start, by a scan of the sequences' bytes
    int incl = lit + ml;
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += u;
    }
    const int start = o + incl - lit - ml;
    const int mo = start + lit;
    if (__any_sync(FULL, lane < count && (off == 0 || off > mo ||
                                          mo + ml > out_cap))) {
      bad = true;
      break;
    }
    // the literals into hist, a byte a lane a step; a lane past its run
    // writes the spare byte after hist, so that no step branches
#pragma unroll
    for (int r = 0; r < 16; ++r)
      hist[r < lit ? (start + r) & (HIST - 1) : HIST] = s.at(from + r);
    for (int r = 16; r < lit; ++r)
      hist[(start + r) & (HIST - 1)] = s.at(from + r);
    // the matches, in hist, then the batch's bytes out to dst
    const int end = o + __shfl_sync(FULL, incl, 31);
    resolve<true>(Out{dst, hist, max(hist_lo, end - HIST), o}, mo, off, ml,
                  count);
    for (int k = o + lane; k < end; k += 32) dst[k] = hist[k & (HIST - 1)];
    o = end;
    i += p;
    if (!stopped || i >= n) continue;
    // the sequence at i, parsed alone in dst: the stream's last (literals
    // only), or one the batch does not take
    s.need(i);
    const int token = s.at(i++);
    long long run = token >> 4;
    if (run == 15 && !length_ext(s, i, run)) {
      bad = true;
      break;
    }
    if (i + run > n || o + run > out_cap) {
      bad = true;
      break;
    }
    // the literals, from the ready tiles, a tile's worth at a time
    for (int left = static_cast<int>(run); left > 0;) {
      s.need(i);
      const int part = min(left, s.end() - i);
      for (int k = lane; k < part; k += 32) dst[o + k] = s.at(i + k);
      i += part;
      o += part;
      left -= part;
    }
    hist_lo = o;
    if (i >= n) break;   // the last sequence: literals only
    if (i + 2 > n) {
      bad = true;
      break;
    }
    s.need(i + 1);
    const int offset = s.at(i) | (s.at(i + 1) << 8);
    i += 2;
    if (offset == 0 || offset > o) {
      bad = true;
      break;
    }
    long long len = (token & 15) + MIN_MATCH;
    if ((token & 15) == 15 && !length_ext(s, i, len)) {
      bad = true;
      break;
    }
    if (o + len > out_cap) {
      bad = true;
      break;
    }
    resolve<false>(Out{dst, hist, NONE, o}, o, offset,
                   static_cast<int>(len), 1);
    o += static_cast<int>(len);
    hist_lo = o;
  }
  cp_wait<0>();
  __syncwarp();   // then zero past the output, or all the row's own
  warp_zero(dst, bad ? o0 : o, out_cap);
  if (lane == 0) status[row] = bad ? -1 : o - o0;
}

template <bool HISTORY>
int launch(const void* comp, const void* clens, int B, int w, void* out,
           int out_cap, void* status, int pre, void* stream) {
  // shared memory before L1, so that 8 blocks of 20 KiB fit an SM
  const cudaError_t err = cudaFuncSetAttribute(
      lz4_decode_kernel<HISTORY>,
      cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  lz4_decode_kernel<HISTORY>
      <<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint8_t*>(comp),
          static_cast<const int32_t*>(clens), w, static_cast<uint8_t*>(out),
          out_cap, static_cast<int64_t*>(status), pre);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// comp (B, w) u8 and clens (B,) i32 (a row's stream is its first
// min(clen, w) bytes) in; out (B, out_cap) u8, every byte written, and
// status (B,) i64 out.  Launches B blocks of one warp on `stream` and
// returns cudaGetLastError().
extern "C" int tpz_lz4_decode(const void* comp, const void* clens, int B,
                              int w, void* out, int out_cap, void* status,
                              void* stream) {
  return launch<false>(comp, clens, B, w, out, out_cap, status, 0, stream);
}

// The history mode: as tpz_lz4_decode, but each out row (pitch out_cap)
// holds pre bytes of earlier output in front, written by the caller and
// left as they are; the row's own bytes follow them (every byte from pre
// on written), matches may reach back into them, and status counts the
// row's own bytes.
extern "C" int tpz_lz4_decode_history(const void* comp, const void* clens,
                                      int B, int w, void* out, int out_cap,
                                      int pre, void* status, void* stream) {
  return launch<true>(comp, clens, B, w, out, out_cap, status, pre, stream);
}
