// lz4p.cu — the lz4p codec (id 7) in both directions, one warp a row: the
// pack kernel (encode) and the decode kernel.
//
// lz4p is LZ4's parse serialised in columns (tpuzip/codecs/lz4p.py):
//   [S u32][orig u32][lit_lens u16 x S][mlens u16 x S][offsets u16 x S]
//   [literals]
// tpuzip has no Pallas kernel for it.  Off the TPU it encodes with the host
// C++ `tpz_lz4p_encode` and decodes with `tpz_lz4p_decode` (csrc/
// tpuzip_host.cpp:333, :409; tpuzip/dist/runner.py:943-955, :1314); on the
// device with XLA (tpuzip/codecs/lz4p.py:50 `encode`, :156 `decode`).
// This source replaces both (kernels/lz4p_coder.py is the plain version,
// chip_smoke.py holds the two equal):
//   - pack: an LZ4 block stream, written by lz4_encode.cu (the C++ rule,
//     the same parse as tpz_lz4p_encode's) or lz4_dense.cu (the XLA rule,
//     the same parse as tpuzip's XLA encoder's), turned into the columns.
//     With split (the C++ rule) a run over 65535 bytes is cut into pieces
//     of 65535: literal pieces with mlen 0 and offset 0, then the run's
//     rest with the match's first piece, then the match's other pieces
//     with no literals and the same offset.  Without it (the XLA rule) a
//     row with a run over 65535, which tpuzip's u16 columns would lose,
//     gets length -1 and no bytes, as does a stream that no encoder of
//     the port writes (literals past its end, or columns past the row);
//   - decode: tpz_lz4p_decode's status, 0 for an empty stream, -1 for one
//     under 8 bytes, an orig past out_cap, columns past the stream,
//     literals past the stream or orig, a match with offset 0, past the
//     output so far or past orig, or a total other than orig; else orig.
//     Bytes after the literals are allowed.  The row holds the output and
//     0 after it; a row with status -1 is all 0.
//
// What bounds it on this card: pack, the parse (an LZ4 token's place
// follows from the last sequence's lengths); decode, the matches, each of
// which reads bytes that earlier sequences wrote.  Neither comes near the
// bytes' bound.  As first ported, the pack read a sequence at a time from
// device memory, a chain of dependent loads: about 940 cycles a sequence
// over its two walks beside 1023 rows (PERF.md §6, row 16); the decode
// copied a sequence at a time, its literals and then its match from bytes
// the warp had stored moments before in device memory, with five shuffles
// and two __syncwarp a sequence: 733 cycles a sequence beside 1023 rows,
// 59% of them the matches (PERF.md §6, row 17).
//
// What the design does about it:
//   - pack: one warp a row, two walks of the stream, staged in a ring of
//     shared memory by cp.async two tiles ahead (4 KiB a row, so 1024 rows
//     are resident at once).  The first walk sums the column entries S
//     (the columns' places follow from it), the literals and the block's
//     length; the second writes the columns and the literals.  Each walk
//     parses a batch of up to 32 sequences at once, as lz4_decode.cu does:
//     each lane reads 4 places and, for each, where a sequence starting
//     there would end (at most one extension byte a length, its bytes
//     ready and in the stream), with no branch; tables of 1, 2, 4, 8 and
//     16 jumps give lane k the k-th start in 5 shuffles.  A batch writes
//     its 32 entries of each column at once and copies its literals a lane
//     a byte (each byte's sequence by a binary search over the scan of the
//     literal lengths).  A sequence the batch does not take (the stream's
//     last, one with a longer extension, one past the ready bytes; every
//     run that the C++ rule splits) is parsed alone: a lane an entry of its
//     pieces, its literals copied 32 bytes a step;
//   - decode: the columns give every sequence's output offset and literal
//     source by prefix sums, so there is no serial parse: 32 sequences a
//     step, a lane each, scanned across the warp, each batch's columns
//     loaded a batch ahead.  A first pass checks every sequence at once
//     (every fault gives -1, so their order does not matter).  The second
//     builds each batch of 32 sequences in a shared-memory history of the
//     last HIST bytes written, as lz4_decode.cu does: every literal byte
//     of the batch, a lane a byte (its sequence by a binary search over the
//     scan of the literal lengths; the batch's literals lie together in
//     the stream, its first 64 bytes loaded beside its scans), while the
//     matches of up to LANE_BYTES whose sources lie before the batch (final
//     bytes; 90% of a text row's) load theirs, stored after the literals;
//     then the other matches in rounds: a match is ready when its source's
//     end, start - offset + min(offset, length), lies at or before the
//     earliest pending match's start, so every byte it reads is final.  A
//     lane copies a match of up to LANE_BYTES alone, the warp a longer one,
//     byte k of a match at o from o - off + k % off, in the history or,
//     further back (offsets reach 65,535), in device memory, where every
//     earlier batch's bytes already are.  The batch's bytes then go out to
//     device memory.  A batch of more than HIST bytes (a long run) is built
//     the same way straight in device memory.  Kept off (PERF.md §6):
//     batches of 64 sequences, a pair a lane (2.5% faster at 212
//     registers), a round's long matches copied together, the long early
//     ones loaded beside the literals, a lane copying 32 bytes alone, one
//     branch-free load path, word stores out.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int HDR = 8;
constexpr int U16 = 0xFFFF;
constexpr int MIN_MATCH = 4;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int TILE = 1024;       // stream bytes a staged tile
constexpr int RING = 4 * TILE;   // two tiles parsed from, two in flight
constexpr int WIN = 128;         // places a batch's sequences start at
constexpr int END_MAX = 254;     // a batch's sequence ends by this place

// The extra entries a run of `len` bytes takes when split (0 unsplit).
__device__ __forceinline__ int extra_pieces(long long len, bool split) {
  return split && len > U16 ? static_cast<int>((len - 1) / U16) : 0;
}

__device__ __forceinline__ void put_u16(uint8_t* p, int v) {
  p[0] = static_cast<uint8_t>(v & 0xFF);
  p[1] = static_cast<uint8_t>((v >> 8) & 0xFF);
}

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

// The pack's ring, named here so that every access is to a fixed shared
// address.
__shared__ __align__(16) uint8_t s_ring[RING];

// A row's stream, staged through shared memory: tile t holds the bytes
// [t * TILE, (t + 1) * TILE) past `base`, the row's start rounded down to
// 16 bytes, in slot t % 4 of s_ring; tiles lo and lo + 1 are ready, lo + 2
// and lo + 3 in flight.
struct Stream {
  const uint8_t* base;
  int skew;   // the row's first byte's place past base
  int n;      // the stream's bytes
  int lo;

  __device__ __forceinline__ void load(int tile) {
    uint8_t* slot = s_ring + (tile & 3) * TILE;
    for (int c = threadIdx.x; c < TILE / 16; c += 32) {
      const int g = tile * TILE + 16 * c;
      if (g < skew + n) cp_async16(slot + 16 * c, base + g);
    }
    cp_commit();
  }

  // Stages the stream from its start (after any earlier staging's copies
  // have landed).
  __device__ __forceinline__ void start() {
    cp_wait<0>();
    __syncwarp();
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
    return s_ring[(p + skew) & (RING - 1)];
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

  // Byte p of the stream, 0 past its end (a sequence parsed alone).
  __device__ __forceinline__ int byte(int p) {
    if (p >= n) return 0;
    need(p);
    return at(p);
  }
};

// A batch's sequence at stream byte q: its lengths, each with its one
// extension byte where the nibble is 15, where its literals and offset
// lie and where it ends.  Every read is of the ring, so it is safe at any
// q; the caller decides whether the sequence is one a batch takes.
struct Sequence {
  int lit, ml, from, off_at, end;
  bool long_ext;   // an extension of more than one byte: a batch does not
                   // take it

  __device__ __forceinline__ Sequence(const Stream& s, int q) {
    const int t = s.at(q), b1 = s.at(q + 1);
    const bool lext = t >= 0xF0, mext = (t & 15) == 15;
    lit = lext ? 15 + b1 : t >> 4;
    from = q + 1 + lext;
    off_at = from + lit;
    const int b2 = s.at(off_at + 2);
    ml = (t & 15) + MIN_MATCH + (mext ? b2 : 0);
    end = off_at + 2 + mext;
    long_ext = (lext && b1 == 255) || (mext && b2 == 255);
  }
};

// Table t's entry for place p (t holds places 4 * lane .. 4 * lane + 3, a
// byte each), by every lane at its own p; a place past WIN is its own.
__device__ __forceinline__ int hop(unsigned t, int p) {
  const unsigned w = __shfl_sync(FULL, t, (p >> 2) & 31);
  return p < WIN ? (w >> (8 * (p & 3))) & 255 : p;
}

// What a walk of a row's stream sums (the first) or where it writes (the
// second): the column entries and literal bytes so far, the block's
// length, and the faults of the first walk.
struct Walk {
  long long entries, lits, orig;
  bool over, bad;
};

// One walk of the stream s (n bytes).  WRITE: the second walk, which puts
// each entry in the columns of a row of nseq entries at dst and each
// literal at dst + base + the literals before it.
template <bool WRITE>
__device__ __forceinline__ Walk walk(Stream& s, bool split, uint8_t* dst,
                                     long long nseq, long long base) {
  const int lane = threadIdx.x;
  const int n = s.n;
  Walk k{0, 0, 0, false, false};
  s.start();
  int i = 0;
  while (i < n) {
    // a batch: the sequences from i whose bytes lie in the stream and the
    // first END_MAX ready places, with at most one byte a length
    // extension.  jump: for each of this lane's 4 places, the place after
    // a sequence starting there, or the place itself where the batch
    // cannot take one
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
    const int count =
        __popc(__ballot_sync(FULL, pos < WIN && next != pos));
    // where the batch ends: the next start, or the sequence to parse
    // alone (stopped)
    const int p = count < 32 ? __shfl_sync(FULL, pos, count & 31)
                             : __shfl_sync(FULL, next, 31);
    const bool stopped = count < 32 && p < WIN;
    int lit = 0, ml = 0, from = 0, off = 0;
    if (lane < count) {
      const Sequence sq(s, i + pos);
      lit = sq.lit;
      ml = sq.ml;
      from = sq.from;
      off = s.at(sq.off_at) | (s.at(sq.off_at + 1) << 8);
    }
    // the literals before each sequence's, by a scan
    int incl = lit;
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += u;
    }
    const int batch_lits = __shfl_sync(FULL, incl, 31);
    if (WRITE) {
      // the batch's column entries, 32 of each column at once
      if (lane < count) {
        uint8_t* col = dst + HDR + 2 * (k.entries + lane);
        put_u16(col, lit);
        put_u16(col + 2 * nseq, ml);
        put_u16(col + 4 * nseq, off);
      }
      // its literals, a lane a byte: byte b belongs to the sequence of the
      // lanes whose literals end at or before it
      for (int b0 = 0; b0 < batch_lits; b0 += 32) {
        const int b = b0 + lane;
        int j = 0;
#pragma unroll
        for (int step = 16; step > 0; step >>= 1)
          if (__shfl_sync(FULL, incl, j + step - 1) <= b) j += step;
        const int at = __shfl_sync(FULL, from - (incl - lit), j) + b;
        if (b < batch_lits)
          dst[base + k.lits + b] = static_cast<uint8_t>(s.at(at));
      }
    } else {
      k.orig += __reduce_add_sync(FULL, static_cast<unsigned>(lit + ml));
    }
    k.entries += count;
    k.lits += batch_lits;
    i += p;
    if (!stopped || i >= n) continue;
    // the sequence at i, parsed alone: the stream's last (literals only),
    // or one the batch does not take.  Reads past the stream give 0.
    const int token = s.byte(i++);
    long long run = token >> 4;
    if (run == 15) {
      int b;
      do {
        b = s.byte(i++);
        run += b;
      } while (b == 255 && i < n);
    }
    const int lit_src = i;
    if (WRITE) {
      // the literals, from the ready tiles, a tile's worth at a time
      for (long long left = run; left > 0;) {
        s.need(i);
        const int part = static_cast<int>(min(left, static_cast<long long>(
                                                        s.end() - i)));
        for (int q = lane; q < part; q += 32)
          dst[base + k.lits + (i - lit_src) + q] =
              static_cast<uint8_t>(s.at(i + q));
        i += part;
        left -= part;
      }
    } else {
      i = static_cast<int>(min(lit_src + run, static_cast<long long>(n)));
      k.bad |= lit_src + run > n;
    }
    long long mlen = 0;
    int offset = 0;
    const bool last = i >= n;
    if (!last) {
      offset = s.byte(i) | (s.byte(i + 1) << 8);
      i += 2;
      mlen = (token & 15) + MIN_MATCH;
      if ((token & 15) == 15) {
        int b;
        do {
          b = s.byte(i++);
          mlen += b;
        } while (b == 255 && i < n);
      }
    }
    const int xl = extra_pieces(run, split);
    const int xm = extra_pieces(mlen, split);
    if (WRITE) {
      // a lane an entry of the sequence's pieces
      for (int j = lane; j <= xl + xm; j += 32) {
        const int mp = j - xl;   // the entry's match piece, from 0
        const int ll = j < xl ? U16 : mp == 0 ? run - U16 * xl : 0;
        const int m = mp < 0 ? 0 : mp < xm ? U16 : mlen - U16 * xm;
        uint8_t* col = dst + HDR + 2 * (k.entries + j);
        put_u16(col, ll);
        put_u16(col + 2 * nseq, m);
        put_u16(col + 4 * nseq, m > 0 ? offset : 0);
      }
    } else {
      k.over |= run > U16 || mlen > U16;
      k.orig += run + mlen;
    }
    k.entries += 1 + xl + xm;
    k.lits += run;
    if (last) break;
  }
  return k;
}

__global__ void __launch_bounds__(32)
lz4p_pack_kernel(const uint8_t* __restrict__ comp,
                 const int32_t* __restrict__ clens, int w,
                 uint8_t* __restrict__ out, int cap,
                 int32_t* __restrict__ olens, bool split) {
  const int lane = threadIdx.x;
  const int row = blockIdx.x;
  const uint8_t* src = comp + static_cast<size_t>(row) * w;
  uint8_t* dst = out + static_cast<size_t>(row) * cap;
  const int skew = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  Stream s{src - skew, skew, min(max(clens[row], 0), w), 0};
  // walk 1: the entries, the literal bytes and the block's length
  const Walk sums = walk<false>(s, split, dst, 0, 0);
  const long long nseq = sums.entries;
  const long long base = HDR + 6 * nseq;
  // a run the XLA rule cannot write; or, from no encoder of the port,
  // literals past the stream or a row past its capacity
  if ((sums.over && !split) || sums.bad || base + sums.lits > cap) {
    cp_wait<0>();
    if (lane == 0) olens[row] = -1;
    return;
  }
  if (lane < 8)
    dst[lane] = static_cast<uint8_t>(
        ((lane < 4 ? nseq : sums.orig) >> (8 * (lane & 3))) & 0xFF);
  if (lane == 0) olens[row] = static_cast<int32_t>(base + sums.lits);
  // walk 2: the column entries and the literals
  walk<true>(s, split, dst, nseq, base);
  cp_wait<0>();
}

// A warp's inclusive prefix sum of v (32 values below 2^17: an int).
__device__ __forceinline__ int warp_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// Sequence t0 + lane of a row's columns (zeros past S), with its output
// start o and literal start lp, from the carries of the sequences before
// t0; the carries move past these 32.
struct Entry {
  long long o, lp;
  int ll, ml, off;
};

// Sequence t's column entries (zeros past S), loaded a batch ahead.
struct Cols {
  int ll, ml, off;
};

__device__ __forceinline__ Cols load_cols(const uint8_t* s, long long S,
                                          long long t) {
  Cols c{0, 0, 0};
  if (t < S) {
    const uint8_t* p = s + HDR + 2 * t;
    c.ll = p[0] | (p[1] << 8);
    c.ml = p[2 * S] | (p[2 * S + 1] << 8);
    c.off = p[4 * S] | (p[4 * S + 1] << 8);
  }
  return c;
}

__device__ __forceinline__ Entry column_entry(Cols c, int lane,
                                              long long& o_carry,
                                              long long& lp_carry) {
  Entry q;
  q.ll = c.ll;
  q.ml = c.ml;
  q.off = c.off;
  const int size = warp_scan(q.ll + q.ml, lane);
  const int lit = warp_scan(q.ll, lane);
  q.o = o_carry + size - (q.ll + q.ml);
  q.lp = lp_carry + lit - q.ll;
  o_carry += __shfl_sync(FULL, size, 31);
  lp_carry += __shfl_sync(FULL, lit, 31);
  return q;
}

// The decode's output: every byte in device memory (dst) up to `done`,
// and the last HIST written in shared memory (hist, byte p at p % HIST)
// from `lo` on.  A batch writes to hist (its bytes go out to dst after
// it), or, past HIST bytes, to dst (lo = NONE).
constexpr int HIST = 16384;      // output bytes kept in shared memory
constexpr int LANE_BYTES = 18;   // a lane copies a match this long alone
constexpr int WARP_BYTES = 8;    // a lane's bytes a step of a warp's copy
constexpr int NONE = 0x7FFFFFFF;

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
// registers (load_lane), then out (store_lane).  The source is one run of
// bytes, in hist or in dst, where it can be (a generic pointer, no branch
// a byte); else each byte from where it lies.
__device__ __forceinline__ void load_lane(const Out& out, int o, int off,
                                          int ml, uint8_t (&v)[LANE_BYTES]) {
  const int from = o - off, span = min(off, ml);
  const uint8_t* run = nullptr;
  if (from >= out.lo && (from & (HIST - 1)) + span <= HIST)
    run = out.hist + (from & (HIST - 1));
  else if (from + span <= out.done)
    run = out.dst + from;
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
}

template <bool HIST_OUT>
__device__ __forceinline__ void store_lane(const Out& out, int o, int ml,
                                           const uint8_t (&v)[LANE_BYTES]) {
#pragma unroll
  for (int k = 0; k < LANE_BYTES; ++k)
    if (k < ml) out.put<HIST_OUT>(o + k, v[k]);
}

template <bool HIST_OUT>
__device__ __forceinline__ void copy_lane(const Out& out, int o, int off,
                                          int ml) {
  uint8_t v[LANE_BYTES];
  load_lane(out, o, off, ml, v);
  store_lane<HIST_OUT>(out, o, ml, v);
}

// A match of any length at o, by the whole warp: byte m from
// from + m % off, 32 x WARP_BYTES bytes a step, each step's loads before
// its stores (every byte read lies before o).
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

// The matches of a batch, a lane each where `pending`, in rounds: the
// ready ones each round (at most 32 rounds: the earliest pending match is
// always ready).  __syncwarp() orders the literals before the first
// round's loads and each round's stores before the next round's loads.
template <bool HIST_OUT>
__device__ __forceinline__ void resolve(const Out& out, int mo, int off,
                                        int ml, bool pending) {
  __syncwarp();
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

__global__ void __launch_bounds__(32)
lz4p_decode_kernel(const uint8_t* __restrict__ comp,
                   const int32_t* __restrict__ clens, int w,
                   uint8_t* __restrict__ out, int out_cap,
                   int64_t* __restrict__ status) {
  __shared__ __align__(16) uint8_t hist[HIST];
  const int lane = threadIdx.x;
  const int row = blockIdx.x;
  const uint8_t* s = comp + static_cast<size_t>(row) * w;
  uint8_t* dst = out + static_cast<size_t>(row) * out_cap;
  const int n = min(max(clens[row], 0), w);
  long long S = 0, orig = 0, st;
  if (n == 0) {
    st = 0;
  } else if (n < HDR) {
    st = -1;
  } else {
    S = s[0] | (s[1] << 8) | (s[2] << 16) | (static_cast<uint32_t>(s[3])
                                             << 24);
    orig = s[4] | (s[5] << 8) | (s[6] << 16) | (static_cast<uint32_t>(s[7])
                                                << 24);
    st = orig > out_cap || HDR + 6 * S > n ? -1 : orig;
  }
  const long long base = HDR + 6 * S;
  // pass 1: every sequence's faults, 32 at once
  long long o_carry = 0, lp_carry = 0;
  // (the columns lie in the stream only where the header passed)
  Cols next = st > 0 ? load_cols(s, S, lane) : Cols{0, 0, 0};
  for (long long t0 = 0; st > 0 && t0 < S; t0 += 32) {
    const Cols cur = next;
    next = load_cols(s, S, t0 + 32 + lane);
    const Entry q = column_entry(cur, lane, o_carry, lp_carry);
    const long long ms = q.o + q.ll;   // where the match starts
    const bool fault = t0 + lane < S &&
                       (base + q.lp + q.ll > n || ms > orig ||
                        (q.ml > 0 && (q.off == 0 || q.off > ms ||
                                      ms + q.ml > orig)));
    if (__ballot_sync(FULL, fault)) st = -1;
  }
  if (st > 0 && o_carry != orig) st = -1;
  if (lane == 0) status[row] = st;
  const long long end = st > 0 ? st : 0;
  // pass 2: each batch of 32 sequences, its literals, then its matches in
  // rounds, in hist (or, past HIST bytes, in dst), then out to dst
  o_carry = lp_carry = 0;
  int hist_lo = 0;   // the output bytes before it are not in hist
  if (end > 0) next = load_cols(s, S, lane);
  for (long long t0 = 0; end > 0 && t0 < S; t0 += 32) {
    const long long lp0 = lp_carry;
    // the batch's first 64 literal bytes, loaded beside its scans
    const uint8_t* from = s + base + lp0;
    const uint8_t lit0 = base + lp0 + lane < n ? from[lane] : 0;
    const uint8_t lit1 = base + lp0 + 32 + lane < n ? from[32 + lane] : 0;
    const Cols cur = next;
    next = load_cols(s, S, t0 + 32 + lane);
    const Entry q = column_entry(cur, lane, o_carry, lp_carry);
    // pass 1 held every output place and literal inside the row and the
    // stream, so they fit an int
    const int o0 = static_cast<int>(__shfl_sync(FULL, q.o, 0));
    const int o1 = static_cast<int>(o_carry);
    const int lits = static_cast<int>(lp_carry - lp0);
    const int lit_end = static_cast<int>(q.lp - lp0) + q.ll;   // inclusive
    // literal byte b goes to shift + b
    const int shift = static_cast<int>(q.o - (q.lp - lp0));
    const bool direct = o1 - o0 > HIST;
    const Out o{dst, hist, direct ? NONE : max(hist_lo, o1 - HIST),
                direct ? o1 : o0};
    const int mo = static_cast<int>(q.o) + q.ll;
    const bool has = t0 + lane < S && q.ml > 0;
    // the first round's short matches whose sources lie before the batch
    // (final bytes): loaded beside the literals, stored after them
    const bool early =
        has && q.ml <= LANE_BYTES && mo - q.off + min(q.off, q.ml) <= o0;
    uint8_t v[LANE_BYTES];
    if (early) load_lane(o, mo, q.off, q.ml, v);
    // the literals, a lane a byte: byte b is the sequence's whose literals
    // end first after it
    for (int b0 = 0; b0 < lits; b0 += 32) {
      const int b = b0 + lane;
      int j = 0;
#pragma unroll
      for (int step = 16; step > 0; step >>= 1)
        if (__shfl_sync(FULL, lit_end, j + step - 1) <= b) j += step;
      const int at = __shfl_sync(FULL, shift, j) + b;
      if (b < lits) {
        const uint8_t x = b0 == 0 ? lit0 : b0 == 32 ? lit1 : from[b];
        if (direct)
          o.put<false>(at, x);
        else
          o.put<true>(at, x);
      }
    }
    if (direct) {
      if (early) store_lane<false>(o, mo, q.ml, v);
      resolve<false>(o, mo, q.off, q.ml, has && !early);
      hist_lo = o1;
    } else {
      if (early) store_lane<true>(o, mo, q.ml, v);
      resolve<true>(o, mo, q.off, q.ml, has && !early);
      for (int k = o0 + lane; k < o1; k += 32) dst[k] = hist[k & (HIST - 1)];
    }
  }
  __syncwarp();   // then zero past the output, or the whole row
  warp_zero(dst, static_cast<int>(end), out_cap);
}

}  // namespace

// comp (B, w) u8 LZ4 block streams of the port's encoders and clens (B,)
// i32 in; out (B, cap) u8, zeroed by the caller (cap >= lz4p's
// encode_cap of the blocks' size), and olens (B,) i32 out; split 1 is the
// C++ rule, 0 the XLA rule.  Launches B blocks of one warp on `stream` and
// returns cudaGetLastError().
extern "C" int tpz_lz4p_pack(const void* comp, const void* clens, int B,
                             int w, void* out, int cap, void* olens,
                             int split, void* stream) {
  lz4p_pack_kernel<<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(comp), static_cast<const int32_t*>(clens),
      w, static_cast<uint8_t*>(out), cap, static_cast<int32_t*>(olens),
      split != 0);
  return static_cast<int>(cudaGetLastError());
}

// comp (B, w) u8 lz4p streams and clens (B,) i32 (read as at most w) in;
// out (B, out_cap) u8 and status (B,) i64 out, every byte written.
// Launches B blocks of one warp on `stream` and returns
// cudaGetLastError().
extern "C" int tpz_lz4p_decode(const void* comp, const void* clens, int B,
                               int w, void* out, int out_cap, void* status,
                               void* stream) {
  lz4p_decode_kernel<<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(comp), static_cast<const int32_t*>(clens),
      w, static_cast<uint8_t*>(out), out_cap,
      static_cast<int64_t*>(status));
  return static_cast<int>(cudaGetLastError());
}
