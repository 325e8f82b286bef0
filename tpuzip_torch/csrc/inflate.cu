// inflate.cu — RFC 1951 INFLATE of a batch of streams (the deflate codec's
// decoder), one warp a stream.
//
// It replaces tpuzip's host C++ `tpz_inflate` (csrc/tpuzip_host.cpp:
// 1020-1111, called from tpuzip/dist/runner.py:1255-1281 through
// native.inflate_batch_native); tpuzip has no Pallas form of it (its XLA
// symbol loop, tpuzip/codecs/deflate.py:81, is the TPU formulation).  Same
// status and bytes (kernels/deflate_coder.py is the plain version,
// chip_smoke.py holds the two equal): the decoded length, or -1 for a read
// past the stream, BTYPE 3, a stored LEN/NLEN mismatch, hlit over 286 or
// hdist over 30, an empty or oversubscribed code-length or literal table,
// a repeat with no previous length or past hlit + hdist, a code that
// decodes to no symbol, length symbol 286/287, distance symbol 30/31, a
// distance past the bytes decoded so far, or output past out_cap.  Any
// RFC 1951 stream decodes: stored, fixed and dynamic blocks in sequence.
// Two cases differ from the C++ on purpose: an empty or oversubscribed
// distance table fails the block's first match (the C++ reads its
// uninitialised root table there), and a stored block after a Huffman
// block starts at the next byte boundary, as the RFC says (the C++ drops
// the whole bytes its lookahead has buffered).  The output row holds the
// bytes decoded until the end or the fault and 0 after them (the caller
// zeroes it); an empty stream decodes to 0 bytes.  tpz_inflate_ends
// also gives each stream's end (the zlib stream reader's Adler-32 lies
// after it, tpuzip/oracle/zlib_.py:37-41).
//
// What bounds it on this card: the symbol chain.  Each symbol's place in
// the stream depends on every code before it, so a stream decodes one
// symbol at a time; the bytes moved are few.  As first ported (lane 0
// decoding from a byte-at-a-time reader, the warp copying each match
// through device memory) a symbol took about 1,300 cycles (PERF.md §6,
// row 21: the fill, the lookup, the extra bits and the match's round trip).
//
// What the design does about it: it decodes the symbols apart from the
// bytes they produce, keeps both in shared memory, and keeps the symbol
// loop short in instructions and branches (PERF.md §6, row 21: each branch on
// that chain cost about 50 cycles, more than a table's load).
//   - One warp a stream, the stream from blockIdx.x, about 26 KiB of
//     shared memory a stream, so that 1024 streams are resident at once
//     (8 an SM).  The stream is staged in a ring of tiles by cp.async, two
//     tiles ahead of the reader, 0 past its end; a batch's bytes are
//     staged before its symbols, so their loop holds no warp-wide
//     operation.  Each symbol reads the 64 bits at its bit position from
//     three aligned words of the ring (no buffer to refill).  The shared
//     arrays are named at namespace scope, so their addresses are fixed.
//   - Every lane runs the decoder in step (each load a broadcast), so no
//     symbol crosses the warp: lane k keeps the batch's k-th token, a
//     literal byte or a match (length, distance), up to 32 tokens.
//   - A table answers in one lookup: an entry holds the code's length, its
//     kind and, for a length or distance code, its base and extra-bit
//     count.  The literal/length table has a 10-bit root and the distance
//     table an 8-bit one, with subtables for longer codes in a shared pool
//     (zlib's inflate_fast layout); a prefix whose subtable the pool cannot
//     hold (only an incomplete code reaches that) is decoded by the
//     canonical walk over its lengths, 15 bits at once.  A code past the
//     root, the block's end and every fault take one branch a lookup.
//     The whole warp builds the tables: counts and ranks by
//     __match_any_sync, a lane a code filling its entries.
//   - A batch's bytes are built in a shared history of the last HIST bytes
//     written, as lz4_decode.cu builds its batches: a warp scan of the
//     tokens' lengths gives their places, the literals go in at once, and
//     the matches resolve in rounds (multi-round resolution, Sitaridi et
//     al., ICPP 2016: a match is ready when its source's end lies at or
//     before the earliest pending match's start); a source older than the
//     history is read from the output row in device memory.  The batch then
//     leaves 32 consecutive bytes a warp store.  A stored block is copied
//     from the ring straight into the output row.
//   - Kept off (PERF.md §6, row 21): a decoder warp and a copier warp a stream
//     (decoding is 85% of a token), the table build as a called function,
//     root entries holding two literals, a symbol with no branch between
//     literal and match, a 64-bit window shared by several symbols through
//     shuffles, and every match of a round copied by the whole warp (a
//     lane copies its own match of up to 18 bytes; the longer ones of a
//     round are copied together).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TILE = 512;         // stream bytes a staged tile
constexpr int RING = 4 * TILE;    // two tiles read from, two in flight
constexpr int HIST = 16384;       // output bytes kept in shared memory
constexpr int LANE_BYTES = 18;    // a lane copies a match this long alone
constexpr int LIT_ROOT = 10;      // root bits of the literal/length table
constexpr int DIST_ROOT = 8;      // and of the distance (and code-length) one
constexpr int LIT_POOL = 256;     // subtable entries of each
constexpr int DIST_POOL = 128;
constexpr int LOOKAHEAD = 256;   // stream bytes a batch's symbols read
constexpr int NONE = 0x7FFFFFFF;
constexpr unsigned FULL = 0xFFFFFFFFu;

// A table entry: value << 16 | extra << 8 | kind << 4 | code length.  A
// literal's value is its byte, a length or distance code's its base and
// extra its extra bits; a subtable link's value is its place in the pool
// and extra its index bits.
enum Kind { K_LIT, K_BASE, K_END, K_BAD, K_SUB, K_WALK };
constexpr uint32_t BAD_ENTRY = K_BAD << 4;
enum Type { T_CODES = 0, T_LIT = 1, T_DIST = 2 };

__constant__ int16_t kLenBase[29] = {3,   4,   5,   6,   7,  8,  9,  10,
                                     11,  13,  15,  17,  19, 23, 27, 31,
                                     35,  43,  51,  59,  67, 83, 99, 115,
                                     131, 163, 195, 227, 258};
__constant__ int8_t kLenEb[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                                  2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
__constant__ int32_t kDistBase[30] = {
    1,    2,    3,    4,    5,    7,     9,     13,    17,    25,
    33,   49,   65,   97,   129,  193,   257,   385,   513,   769,
    1025, 1537, 2049, 3073, 4097, 6145,  8193,  12289, 16385, 24577};
__constant__ int8_t kDistEb[30] = {0, 0, 0, 0, 1, 1, 2,  2,  3,  3,
                                   4, 4, 5, 5, 6, 6, 7,  7,  8,  8,
                                   9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
__constant__ int8_t kOrder[19] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                                  11, 4,  12, 3, 13, 2, 14, 1, 15};

__device__ __forceinline__ uint32_t entry_of(int type, int sym, int len) {
  uint32_t e = len;
  if (type == T_CODES || (type == T_LIT && sym < 256))
    e |= static_cast<uint32_t>(sym) << 16 | K_LIT << 4;
  else if (type == T_LIT && sym == 256)
    e |= K_END << 4;
  else if (type == T_LIT && sym < 286)
    e |= static_cast<uint32_t>(kLenBase[sym - 257]) << 16 |
         static_cast<uint32_t>(kLenEb[sym - 257]) << 8 | K_BASE << 4;
  else if (type == T_DIST && sym < 30)
    e |= static_cast<uint32_t>(kDistBase[sym]) << 16 |
         static_cast<uint32_t>(kDistEb[sym]) << 8 | K_BASE << 4;
  else
    e |= K_BAD << 4;   // length symbol 286/287, distance symbol 30/31
  return e;
}

// A stream's shared memory (one warp a block), named here so that every
// access is to a fixed shared address (through a pointer kept in a struct,
// each access rebuilt the shared window's address in the symbol loop).
__shared__ __align__(16) uint32_t s_ring[RING / 4];   // read as words
__shared__ __align__(16) uint8_t s_hist[HIST];
// Two tables, 0 literal/length and 1 distance (or, first in a dynamic
// block's header, the code-length code): their root entries and subtable
// pools, and the canonical code (the count, first sorted index and first
// code of each length, the symbols in code order) for the walk past a root
// entry without a subtable.
__shared__ uint32_t s_root[(1 << LIT_ROOT) + (1 << DIST_ROOT)];
__shared__ uint32_t s_pool[LIT_POOL + DIST_POOL];
__shared__ int32_t s_first[2][16];
__shared__ int16_t s_count[2][16], s_offs[2][16], s_scratch[16];
__shared__ int16_t s_sorted[288 + 32];
__shared__ uint8_t s_lens[320];   // code lengths as a header gives them

template <int ID>
struct Tab {
  static constexpr int BITS = ID ? DIST_ROOT : LIT_ROOT;
  static constexpr int ROOT_AT = ID ? 1 << LIT_ROOT : 0;
  static constexpr int POOL_AT = ID ? LIT_POOL : 0;
  static constexpr int POOL_SIZE = ID ? DIST_POOL : LIT_POOL;
  static constexpr int SORTED_AT = ID ? 288 : 0;
};

// Builds table ID, its entries of type `type`, from the n code lengths at
// ln, by the whole warp; false (the root all BAD_ENTRY) for a set with no
// code or an oversubscribed one.
template <int ID>
__device__ __forceinline__ bool build(int type, const uint8_t* ln, int n) {
  using T = Tab<ID>;
  uint32_t* root = s_root + T::ROOT_AT;
  uint32_t* pool = s_pool + T::POOL_AT;
  int16_t* sorted = s_sorted + T::SORTED_AT;
  int16_t* count = s_count[ID];
  int16_t* offs = s_offs[ID];
  int32_t* first = s_first[ID];
  int16_t* scratch = s_scratch;
  const int lane = threadIdx.x;
  const unsigned below = (1u << lane) - 1;
  if (lane < 16) scratch[lane] = 0;
  for (int j = lane; j < (1 << T::BITS); j += 32) root[j] = BAD_ENTRY;
  for (int j = lane; j < T::POOL_SIZE; j += 32) pool[j] = BAD_ENTRY;
  __syncwarp();
  for (int i = 0; i < n; i += 32) {   // codes of each length
    const int v = i + lane < n ? ln[i + lane] : 16;
    const unsigned m = __match_any_sync(FULL, v);
    if (v < 16 && lane == 31 - __clz(m)) scratch[v] += __popc(m);
    __syncwarp();
  }
  int left = 1, code = 0, at = 0;
  bool over = false;
  int my_count = 0, my_offs = 0, my_first = 0;   // lane l's length l
  for (int l = 1; l < 16; ++l) {
    const int c = scratch[l];
    left = (left << 1) - c;
    over |= left < 0;
    if (lane == l) {
      my_count = c;
      my_offs = at;
      my_first = code;
    }
    at += c;
    code = (code + c) << 1;
  }
  const int ncodes = at;
  const bool none = scratch[0] == n;
  __syncwarp();
  if (none || over) return false;
  if (lane < 16) {
    count[lane] = static_cast<int16_t>(my_count);
    offs[lane] = static_cast<int16_t>(my_offs);
    first[lane] = my_first;
    scratch[lane] = 0;
  }
  __syncwarp();
  for (int i = 0; i < n; i += 32) {   // the symbols in code order
    const int v = i + lane < n ? ln[i + lane] : 0;
    const unsigned m = __match_any_sync(FULL, v);
    if (v > 0) sorted[offs[v] + scratch[v] + __popc(m & below)] = i + lane;
    __syncwarp();
    if (v > 0 && lane == 31 - __clz(m)) scratch[v] += __popc(m);
    __syncwarp();
  }
  // codes up to the root's bits: a lane a code, each of its root entries
  const int long_at = offs[T::BITS + 1];
  for (int k = lane; k < long_at; k += 32) {
    const int sym = sorted[k];
    const int l = ln[sym];
    const uint32_t c = first[l] + (k - offs[l]);
    const uint32_t e = entry_of(type, sym, l);
    for (uint32_t j = __brev(c) >> (32 - l); j < (1u << T::BITS); j += 1u << l)
      root[j] = e;
  }
  // longer codes: the codes of one root prefix are neighbours in code
  // order, the last the longest; its lane sizes the prefix's subtable, a
  // scan places it, and its root entry links it (or, past the pool, asks
  // for the walk)
  int carry = 0;
  for (int k0 = long_at; k0 < ncodes; k0 += 32) {
    const int k = k0 + lane;
    int size = 0, p = 0, l = 0;
    if (k < ncodes) {
      l = ln[sorted[k]];
      p = (first[l] + (k - offs[l])) >> (l - T::BITS);
      bool last = k + 1 == ncodes;
      if (!last) {
        const int l2 = ln[sorted[k + 1]];
        last = ((first[l2] + (k + 1 - offs[l2])) >> (l2 - T::BITS)) != p;
      }
      size = last ? 1 << (l - T::BITS) : 0;
    }
    int incl = size;
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += u;
    }
    const int start = carry + incl - size;
    if (size)
      root[__brev(p) >> (32 - T::BITS)] =
          start + size <= T::POOL_SIZE
              ? static_cast<uint32_t>(start) << 16 |
                    static_cast<uint32_t>(l - T::BITS) << 8 | K_SUB << 4
              : static_cast<uint32_t>(K_WALK << 4);
    carry += __shfl_sync(FULL, incl, 31);
  }
  __syncwarp();
  for (int k = long_at + lane; k < ncodes; k += 32) {
    const int sym = sorted[k];
    const int l = ln[sym];
    const int c = first[l] + (k - offs[l]);
    const uint32_t r = root[__brev(c >> (l - T::BITS)) >> (32 - T::BITS)];
    if (((r >> 4) & 7) != K_SUB) continue;
    const int tail = l - T::BITS;   // the code's bits past the root
    const uint32_t e = entry_of(type, sym, l);
    for (uint32_t j = __brev(c & ((1 << tail) - 1)) >> (32 - tail);
         j < (1u << ((r >> 8) & 15)); j += 1u << tail)
      pool[(r >> 16) + j] = e;
  }
  __syncwarp();
  return true;
}

// Past a root entry e of table ID (its entries of type TYPE): the entry of
// the code that starts at bit 0 of buf, through its subtable or by the
// canonical walk; any other e as it is.
template <int ID, int TYPE>
__device__ __forceinline__ uint32_t past_root(uint32_t e,
                                              unsigned long long buf) {
  using T = Tab<ID>;
  const int kind = (e >> 4) & 7;
  if (kind == K_SUB)
    return s_pool[T::POOL_AT + (e >> 16) +
                  ((buf >> T::BITS) & ((1u << ((e >> 8) & 15)) - 1))];
  if (kind != K_WALK) return e;
  // the canonical walk: the root's bits matched no shorter code, so the
  // code is the first length whose prefix falls among its codes
  const uint32_t rev = __brev(static_cast<uint32_t>(buf)) >> 17;
  for (int l = T::BITS + 1; l < 16; ++l) {
    const uint32_t i = (rev >> (15 - l)) - s_first[ID][l];
    if (i < static_cast<uint32_t>(s_count[ID][l]))
      return entry_of(TYPE, s_sorted[T::SORTED_AT + s_offs[ID][l] + i], l);
  }
  return BAD_ENTRY;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int size) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(size)
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
// 16 bytes, 0 past the stream, in slot t % 4 of the ring; tiles lo and
// lo + 1 are ready, lo + 2 and lo + 3 in flight.
struct Stream {
  const uint8_t* base;
  int skew;   // the row's first byte's place past base
  int n;      // the stream's bytes
  int lo;

  __device__ __forceinline__ void load(int tile) {
    uint8_t* slot = reinterpret_cast<uint8_t*>(s_ring) + (tile & 3) * TILE;
    for (int c = threadIdx.x; c < TILE / 16; c += 32) {
      const int g = tile * TILE + 16 * c;
      const int size = min(max(skew + n - g, 0), 16);
      cp_async16(slot + 16 * c, size ? base + g : base, size);
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

  __device__ __forceinline__ int at(int p) const {
    return reinterpret_cast<const uint8_t*>(s_ring)[(p + skew) & (RING - 1)];
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

// The stream's bits, LSB first, read at bit `pos`: peek() gives the 64 bits
// from pos on (those past the stream 0, as the ring holds them) from three
// aligned words of the ring, funnel-shifted by pos's place in them, with
// no branch and no state but pos.
struct Bits {
  int pos;   // bits from the stream's start
  int end;   // 8 x the stream's bytes

  // The bytes pos / 8 .. pos / 8 + 11 must be staged (Stream::need).
  __device__ __forceinline__ unsigned long long peek(const Stream& s) const {
    const int q = pos + 8 * s.skew, i = q >> 5;
    const uint32_t a = s_ring[i & (RING / 4 - 1)],
                   b = s_ring[(i + 1) & (RING / 4 - 1)],
                   c = s_ring[(i + 2) & (RING / 4 - 1)];
    return static_cast<unsigned long long>(__funnelshift_r(b, c, q)) << 32 |
           __funnelshift_r(a, b, q);
  }

  // k <= 32 bits into v, staging them; false past the stream.
  __device__ __forceinline__ bool take(Stream& s, int k, int& v) {
    s.need((pos >> 3) + 11);
    if (pos + k > end) return false;
    v = static_cast<int>(peek(s) & ((1ull << k) - 1));
    pos += k;
    return true;
  }
};

// A row's output: every byte in device memory (dst) up to `done`, and the
// last HIST written in s_hist (byte p at p % HIST) from `lo` on; a batch
// writes to s_hist, its bytes go out to dst after it.
struct Out {
  uint8_t* dst;
  int lo;
  int done;

  __device__ __forceinline__ uint8_t get(int p) const {
    return p >= lo ? s_hist[p & (HIST - 1)] : dst[p];
  }
};

// One lane's match of ml <= LANE_BYTES bytes at o: its source bytes into
// registers, then into hist.  The source is one run of bytes, in hist or in
// dst, where it can be (a generic pointer, no branch a byte); else each
// byte from where it lies.
__device__ __forceinline__ void copy_lane(const Out& out, int o, int off,
                                          int ml) {
  const int from = o - off, span = min(off, ml);
  const uint8_t* run = nullptr;
  if (from >= out.lo && (from & (HIST - 1)) + span <= HIST)
    run = s_hist + (from & (HIST - 1));
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
    if (k < ml) s_hist[(o + k) & (HIST - 1)] = v[k];
}

// The batch's matches, one a pending lane, in rounds.  A round's ready
// matches read only bytes before the earliest pending match and write only
// bytes from it on: a lane copies its own match of up to LANE_BYTES, and
// the whole warp copies the longer ones together, a lane a byte (each
// byte's match by a binary search over the scan of their lengths; byte m
// of a match at o with offset off from o - off + m % off).
__device__ __forceinline__ void resolve(const Out& out, int mo, int off,
                                        int ml, bool pending) {
  const int lane = threadIdx.x;
  __syncwarp();   // the literals, every lane's, are written
  for (;;) {
    const int first = __reduce_min_sync(FULL, pending ? mo : NONE);
    if (first == NONE) break;
    const bool ready = pending && mo - off + min(off, ml) <= first;
    if (ready && ml <= LANE_BYTES) copy_lane(out, mo, off, ml);
    if (__any_sync(FULL, ready && ml > LANE_BYTES)) {
      const int len = ready && ml > LANE_BYTES ? ml : 0;
      int incl = len;
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(FULL, incl, d);
        if (lane >= d) incl += u;
      }
      const int total = __shfl_sync(FULL, incl, 31);
      const int excl = incl - len;
      for (int t0 = 0; t0 < total; t0 += 32) {
        const int t = t0 + lane;
        int j = 0;
#pragma unroll
        for (int step = 16; step > 0; step >>= 1)
          if (__shfl_sync(FULL, incl, j + step - 1) <= t) j += step;
        const int m = t - __shfl_sync(FULL, excl, j);
        const int jo = __shfl_sync(FULL, mo, j);
        const int joff = __shfl_sync(FULL, off, j);
        if (t < total)
          s_hist[(jo + m) & (HIST - 1)] =
              out.get(jo - joff + (m < joff ? m : m % joff));
      }
    }
    pending = pending && !ready;
    __syncwarp();
  }
}

// Why a batch's decoding stopped.
enum Stop { S_FULL, S_STORED, S_END, S_FAULT };

struct Inflater {
  Stream s;
  Bits r;
  int cap;
  int o;              // bytes decoded, queued tokens' included
  bool in_block;      // inside a Huffman block
  bool last;          // the block being read is the final one
  bool ended;         // the final block has ended

  // A dynamic block's header and its tables; false on a fault.
  __device__ __forceinline__ bool dynamic_tables() {
    const int lane = threadIdx.x;
    int hlit, hdist, hclen;
    if (!r.take(s, 5, hlit) || !r.take(s, 5, hdist) || !r.take(s, 4, hclen))
      return false;
    hlit += 257;
    hdist += 1;
    hclen += 4;
    if (hlit > 286 || hdist > 30) return false;
    uint8_t* cl = s_lens + 300;   // the code-length code's 19 lengths
    if (lane < 19) cl[lane] = 0;
    __syncwarp();
    for (int i = 0; i < hclen; ++i) {
      int v;
      if (!r.take(s, 3, v)) return false;
      if (lane == 0) cl[kOrder[i]] = static_cast<uint8_t>(v);
    }
    __syncwarp();
    // the code-length code in table 1: the distance table comes after it
    if (!build<1>(T_CODES, cl, 19)) return false;
    int i = 0;
    while (i < hlit + hdist) {
      s.need((r.pos >> 3) + 11);
      // the code-length code's codes (7 bits at most) all lie in the root
      const uint32_t e =
          s_root[Tab<1>::ROOT_AT + (r.peek(s) & ((1u << DIST_ROOT) - 1))];
      const int l = e & 15;
      if (((e >> 4) & 7) == K_BAD || r.pos + l > r.end) return false;
      r.pos += l;
      const int sym = e >> 16;
      if (sym < 16) {
        if (lane == 0) s_lens[i] = static_cast<uint8_t>(sym);
        ++i;
        continue;
      }
      int rep, val = 0;
      if (sym == 16) {
        if (i == 0) return false;
        __syncwarp();
        val = s_lens[i - 1];
        if (!r.take(s, 2, rep)) return false;
        rep += 3;
      } else if (sym == 17) {
        if (!r.take(s, 3, rep)) return false;
        rep += 3;
      } else {
        if (!r.take(s, 7, rep)) return false;
        rep += 11;
      }
      if (i + rep > hlit + hdist) return false;
      for (int k = lane; k < rep; k += 32)
        s_lens[i + k] = static_cast<uint8_t>(val);
      i += rep;
    }
    __syncwarp();
    if (!build<0>(T_LIT, s_lens, hlit)) return false;
    // the distance lengths to 288.., padded to 30 (read before written:
    // the two ranges may overlap)
    const int d = lane < hdist ? s_lens[hlit + lane] : 0;
    __syncwarp();
    if (lane < 30) s_lens[288 + lane] = static_cast<uint8_t>(d);
    __syncwarp();
    build<1>(T_DIST, s_lens + 288, 30);   // empty: any match fails
    return true;
  }

  __device__ __forceinline__ void fixed_tables() {
    const int lane = threadIdx.x;
    for (int i = lane; i < 288; i += 32)
      s_lens[i] = i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : 8;
    if (lane < 30) s_lens[288 + lane] = 5;
    __syncwarp();
    build<0>(T_LIT, s_lens, 288);
    build<1>(T_DIST, s_lens + 288, 30);
  }

  // Decodes up to 32 tokens, lane k keeping the k-th: ql its bytes (1 a
  // literal, 3-258 a match), qv its byte or distance.  nq: the tokens.
  // A block's symbols run in a loop with no warp-wide operation (its
  // bytes are staged before it: a batch reads at most LOOKAHEAD), so that
  // it holds no point where the warp must converge.
  __device__ __forceinline__ Stop batch(int& nq, int& ql, int& qv) {
    const int lane = threadIdx.x;
    nq = 0;
    for (;;) {
      if (!in_block) {
        if (ended) return S_END;
        int fin, btype;
        if (!r.take(s, 1, fin) || !r.take(s, 2, btype)) return S_FAULT;
        last = fin;
        if (btype == 0) return S_STORED;
        if (btype == 3) return S_FAULT;
        if (btype == 1)
          fixed_tables();
        else if (!dynamic_tables())
          return S_FAULT;
        in_block = true;
      }
      s.need((r.pos >> 3) + LOOKAHEAD);
      for (;;) {
        const unsigned long long buf = r.peek(s);
        const int left = r.end - r.pos;
        uint32_t e = s_root[buf & ((1u << LIT_ROOT) - 1)];
        // what is rare takes one branch: a code past the root, the block's
        // end, and every fault
        if (((e >> 4) & 7) >= K_END || (e & 15) > left ||
            (((e >> 4) & 7) == K_LIT && o >= cap)) {
          e = past_root<0, T_LIT>(e, buf);
          const int kind = (e >> 4) & 7;
          if (kind == K_BAD || (e & 15) > left || (kind == K_LIT && o >= cap))
            return S_FAULT;
          if (kind == K_END) {
            r.pos += e & 15;
            in_block = false;
            ended = last;
            break;
          }
        }
        const int l = e & 15;
        r.pos += l;
        if (((e >> 4) & 7) == K_LIT) {
          if (lane == nq) {
            ql = 1;
            qv = e >> 16;
          }
          ++o;
          if (++nq == 32) return S_FULL;
          continue;
        }
        // a length code, its extra bits, then the distance's: at most 48
        // of the 64 bits peeked
        const int eb = (e >> 8) & 15;
        const int mlen = (e >> 16) + static_cast<int>((buf >> l) &
                                                      ((1u << eb) - 1));
        const unsigned long long dbuf = buf >> (l + eb);
        uint32_t f = s_root[(1 << LIT_ROOT) + (dbuf & ((1u << DIST_ROOT) - 1))];
        int dl = f & 15, deb = (f >> 8) & 15;
        int d = (f >> 16) + static_cast<int>((dbuf >> dl) & ((1u << deb) - 1));
        if (((f >> 4) & 7) != K_BASE || l + eb + dl + deb > left || d > o ||
            o + mlen > cap) {
          f = past_root<1, T_DIST>(f, dbuf);
          dl = f & 15;
          deb = (f >> 8) & 15;
          d = (f >> 16) + static_cast<int>((dbuf >> dl) & ((1u << deb) - 1));
          if (((f >> 4) & 7) != K_BASE || l + eb + dl + deb > left || d > o ||
              o + mlen > cap)
            return S_FAULT;
        }
        r.pos += eb + dl + deb;
        if (lane == nq) {
          ql = mlen;
          qv = d;
        }
        o += mlen;
        if (++nq == 32) return S_FULL;
      }
    }
  }
};

// ENDS (picked by `if constexpr`, so the plain instance keeps its SASS)
// also writes each row's end: the stream bytes its blocks took, through
// the final block's last bit to the byte boundary, where the stream
// decoded; the bytes decoded before the fault where it did not (the zlib
// reader reads the Adler-32 after the stream's end, and grows its output
// where a fault came at the output's end).
template <bool ENDS>
__global__ void __launch_bounds__(32)
inflate_kernel(const uint8_t* __restrict__ streams,
               const int32_t* __restrict__ lens, int B, int w,
               uint8_t* __restrict__ out, int cap,
               long long* __restrict__ status, long long* __restrict__ ends) {
  const int lane = threadIdx.x;
  const int row = blockIdx.x;
  const uint8_t* src = streams + static_cast<size_t>(row) * w;
  uint8_t* dst = out + static_cast<size_t>(row) * cap;
  const int n = min(max(lens[row], 0), w);
  if (n == 0) {   // an empty row is an empty block
    if (lane == 0) status[row] = 0;
    if constexpr (ENDS)
      if (lane == 0) ends[row] = 0;
    return;
  }
  const int skew = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  Inflater f;
  f.s = Stream{src - skew, skew, n, 0};
  f.s.start();
  f.r = Bits{0, 8 * n};
  f.cap = cap;
  f.o = 0;
  f.in_block = f.last = f.ended = false;
  int hist_lo = 0;   // the output bytes before it are not in hist
  long long result;
  for (;;) {
    const int o0 = f.o;
    int nq, ql = 0, qv = 0;
    const Stop stop = f.batch(nq, ql, qv);
    if (nq) {
      // each token's place, by a scan of their lengths; the literals into
      // hist, the matches in rounds there, then the bytes out to dst
      int incl = ql;
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(FULL, incl, d);
        if (lane >= d) incl += u;
      }
      const int at = o0 + incl - ql;
      if (ql == 1) s_hist[at & (HIST - 1)] = static_cast<uint8_t>(qv);
      const int end = f.o;
      resolve(Out{dst, max(hist_lo, end - HIST), o0}, at, qv, ql, ql > 1);
      for (int k = o0 + lane; k < end; k += 32)
        dst[k] = s_hist[k & (HIST - 1)];
    }
    if (stop == S_FULL) continue;
    if (stop == S_END) {
      result = f.o;
      break;
    }
    if (stop == S_FAULT) {
      result = -1;
      break;
    }
    // a stored block: from the next byte boundary, LEN and NLEN, then LEN
    // bytes copied from the ring straight into dst
    Stream& s = f.s;
    int at = (f.r.pos + 7) >> 3;   // from the next byte boundary
    if (at + 4 > n) {
      result = -1;
      break;
    }
    s.need(at + 3);
    const int ln = s.at(at) | (s.at(at + 1) << 8);
    const int nln = s.at(at + 2) | (s.at(at + 3) << 8);
    at += 4;
    if (ln != (~nln & 0xFFFF) || at + ln > n || f.o + ln > cap) {
      result = -1;
      break;
    }
    for (int left = ln; left > 0;) {
      s.need(at);
      const int part = min(left, s.end() - at);
      for (int k = lane; k < part; k += 32) dst[f.o + k] = s.at(at + k);
      at += part;
      f.o += part;
      left -= part;
    }
    __syncwarp();   // the copy before a later match reads it
    hist_lo = f.o;
    f.r.pos = 8 * at;
    f.ended = f.last;
  }
  cp_wait<0>();
  if (lane == 0) status[row] = result;
  if constexpr (ENDS)
    if (lane == 0) ends[row] = result < 0 ? f.o : (f.r.pos + 7) >> 3;
}

template <bool ENDS>
int launch(const void* streams, const void* lens, int B, int w, void* out,
           int cap, void* status, void* ends, void* stream) {
  // shared memory before L1, so that 8 blocks of 26 KiB fit an SM
  const cudaError_t err = cudaFuncSetAttribute(
      inflate_kernel<ENDS>, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  inflate_kernel<ENDS><<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(streams), static_cast<const int32_t*>(lens),
      B, w, static_cast<uint8_t*>(out), cap, static_cast<long long*>(status),
      static_cast<long long*>(ends));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// streams (B, w) u8 and lens (B,) i32 (read as at most w) in; out (B, cap)
// u8, zeroed by the caller, and status (B,) i64 out.  Launches B blocks of
// one warp on `stream` and returns cudaGetLastError().
extern "C" int tpz_inflate(const void* streams, const void* lens, int B,
                           int w, void* out, int cap, void* status,
                           void* stream) {
  return launch<false>(streams, lens, B, w, out, cap, status, nullptr,
                       stream);
}

// tpz_inflate, and ends (B,) i64 out: each row's stream bytes through its
// final block's end, or, where its status is -1, the bytes it decoded
// before the fault.
extern "C" int tpz_inflate_ends(const void* streams, const void* lens, int B,
                                int w, void* out, int cap, void* status,
                                void* ends, void* stream) {
  return launch<true>(streams, lens, B, w, out, cap, status, ends, stream);
}
