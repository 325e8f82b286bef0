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
// zeroes it); an empty stream decodes to 0 bytes.
//
// What bounds it on this card: the symbol chain.  Each symbol's place in
// the stream depends on every code before it, so a stream decodes one
// symbol at a time; the bytes moved are few.
//
// What the design does about it, in this first form: lane 0 decodes the
// symbols from the canonical tables in shared memory (a 10-bit root table
// and the count/symbol walk past it, as the C++'s Huf) and writes the
// literals; the warp copies each match (byte k of a match at o with
// distance d is byte o - d + k % d, always before o) and each stored
// block.  Matches resolved in rounds in a shared history, as lz4_decode.cu
// does, are later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WARPS = 4;            // streams a block
constexpr int FAST_BITS = 10;
constexpr unsigned FULL = 0xFFFFFFFFu;

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

// LSB-first bits of one stream; a read past its end fails.
struct Reader {
  const uint8_t* p;
  int n;
  int next = 0;                 // the next byte to buffer
  unsigned long long buf = 0;   // cnt bits, the next one lowest
  int cnt = 0;
  __device__ void fill() {
    while (cnt <= 56 && next < n) {
      buf |= static_cast<unsigned long long>(p[next++]) << cnt;
      cnt += 8;
    }
  }
  __device__ bool bits(int k, int& v) {
    if (cnt < k) fill();
    if (cnt < k) return false;
    v = static_cast<int>(buf & ((1ull << k) - 1));
    buf >>= k;
    cnt -= k;
    return true;
  }
};

// Canonical decode tables (tpz_inflate's Huf): count[len], the symbols by
// (len, symbol), and a 10-bit root table of (len << 12 | symbol).
struct Huf {
  int16_t count[16];
  int16_t sym[288];
  uint16_t fast[1 << FAST_BITS];
  bool ok;
};

__device__ bool build(Huf& h, const uint8_t* lengths, int n) {
  for (int i = 0; i < 16; ++i) h.count[i] = 0;
  for (int i = 0; i < n; ++i) h.count[lengths[i]]++;
  h.ok = false;
  if (h.count[0] == n) return false;
  int left = 1;
  for (int l = 1; l < 16; ++l) {
    left = (left << 1) - h.count[l];
    if (left < 0) return false;   // oversubscribed
  }
  int16_t offs[16];
  offs[1] = 0;
  for (int l = 1; l < 15; ++l) offs[l + 1] = offs[l] + h.count[l];
  for (int i = 0; i < n; ++i)
    if (lengths[i]) h.sym[offs[lengths[i]]++] = static_cast<int16_t>(i);
  for (int j = 0; j < (1 << FAST_BITS); ++j) h.fast[j] = 0;
  int code = 0, index = 0;
  for (int l = 1; l <= FAST_BITS; ++l) {
    code <<= 1;
    for (int k = 0; k < h.count[l]; ++k, ++code, ++index) {
      const uint32_t rev = __brev(static_cast<uint32_t>(code)) >> (32 - l);
      const uint16_t entry = static_cast<uint16_t>((l << 12) | h.sym[index]);
      for (uint32_t j = rev; j < (1u << FAST_BITS); j += 1u << l)
        h.fast[j] = entry;
    }
  }
  h.ok = true;
  return true;
}

// The next symbol, or -1 (no table, no code, or past the stream).
__device__ int decode(const Huf& h, Reader& r) {
  if (!h.ok) return -1;
  if (r.cnt < FAST_BITS) r.fill();
  const uint16_t e = h.fast[r.buf & ((1u << FAST_BITS) - 1)];
  if (e) {
    const int l = e >> 12;
    if (r.cnt < l) return -1;
    r.buf >>= l;
    r.cnt -= l;
    return e & 0xFFF;
  }
  int code = 0, first = 0, index = 0;
  for (int l = 1; l < 16; ++l) {
    int b;
    if (!r.bits(1, b)) return -1;
    code |= b;
    const int c = h.count[l];
    if (code - first < c) return h.sym[index + (code - first)];
    index += c;
    first = (first + c) << 1;
    code <<= 1;
  }
  return -1;
}

struct Shared {
  Huf lit, dist;
  uint8_t lens[320];
};

// What lane 0 hands the warp.
enum Action { COPY_MATCH, COPY_STORED, DONE };

struct State {
  int block = 0;        // 0: a block header next; 1: inside a Huffman block
  bool last = false;    // the block being read is the final one
  bool ended = false;   // the final block has ended
  long long o = 0;
};

// Lane 0: run the stream until the warp has work.  Returns the action and
// fills a (match: distance; stored: source offset) and len.  status is set
// with DONE: the length, or -1.
__device__ Action step(Shared& sh, Reader& r, State& st, uint8_t* dst,
                       int cap, int& a, int& len, long long& status) {
  for (;;) {
    if (st.block == 0) {
      if (st.ended) {
        status = st.o;
        return DONE;
      }
      int fin, btype;
      if (!r.bits(1, fin) || !r.bits(2, btype)) break;
      st.last = fin;
      if (btype == 0) {
        const int drop = r.cnt & 7;   // to the byte boundary
        r.buf >>= drop;
        r.cnt -= drop;
        int at = r.next - r.cnt / 8;
        if (at + 4 > r.n) break;
        const int ln = r.p[at] | (r.p[at + 1] << 8);
        const int nln = r.p[at + 2] | (r.p[at + 3] << 8);
        if (ln != (~nln & 0xFFFF)) break;
        at += 4;
        if (at + ln > r.n || st.o + ln > cap) break;
        r.next = at + ln;
        r.buf = 0;
        r.cnt = 0;
        st.ended = fin;
        a = at;
        len = ln;
        return COPY_STORED;
      }
      if (btype == 3) break;
      if (btype == 1) {
        for (int i = 0; i < 288; ++i)
          sh.lens[i] = i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : 8;
        build(sh.lit, sh.lens, 288);
        for (int i = 0; i < 30; ++i) sh.lens[i] = 5;
        build(sh.dist, sh.lens, 30);
      } else {
        int hlit, hdist, hclen;
        if (!r.bits(5, hlit) || !r.bits(5, hdist) || !r.bits(4, hclen))
          break;
        hlit += 257;
        hdist += 1;
        hclen += 4;
        if (hlit > 286 || hdist > 30) break;
        uint8_t* cl = sh.lens + 300;   // 19 of the code-length code
        for (int i = 0; i < 19; ++i) cl[i] = 0;
        bool ok = true;
        for (int i = 0; i < hclen && ok; ++i) {
          int v;
          ok = r.bits(3, v);
          cl[kOrder[i]] = static_cast<uint8_t>(v);
        }
        Huf& clh = sh.dist;   // the distance table is built after it
        if (!ok || !build(clh, cl, 19)) break;
        int i = 0;
        while (i < hlit + hdist && ok) {
          const int s = decode(clh, r);
          if (s < 0) {
            ok = false;
            break;
          }
          if (s < 16) {
            sh.lens[i++] = static_cast<uint8_t>(s);
            continue;
          }
          int rep, val = 0;
          if (s == 16) {
            if (i == 0) {
              ok = false;
              break;
            }
            val = sh.lens[i - 1];
            ok = r.bits(2, rep);
            rep += 3;
          } else if (s == 17) {
            ok = r.bits(3, rep);
            rep += 3;
          } else {
            ok = r.bits(7, rep);
            rep += 11;
          }
          if (!ok || i + rep > hlit + hdist) {
            ok = false;
            break;
          }
          while (rep--) sh.lens[i++] = static_cast<uint8_t>(val);
        }
        if (!ok || !build(sh.lit, sh.lens, hlit)) break;
        uint8_t* dl = sh.lens + 288;   // past the literal lengths read
        for (int k = hdist - 1; k >= 0; --k) dl[k] = sh.lens[hlit + k];
        for (int k = hdist; k < 30; ++k) dl[k] = 0;
        build(sh.dist, dl, 30);   // empty: any match fails
      }
      st.block = 1;
    }
    const int s = decode(sh.lit, r);
    if (s < 0) break;
    if (s < 256) {
      if (st.o >= cap) break;
      dst[st.o++] = static_cast<uint8_t>(s);
      continue;
    }
    if (s == 256) {
      st.block = 0;
      st.ended = st.last;
      continue;
    }
    const int lc = s - 257;
    if (lc >= 29) break;
    int extra;
    const bool got_len = r.bits(kLenEb[lc], extra);
    const int mlen = kLenBase[lc] + (got_len ? extra : 0);
    const int ds = decode(sh.dist, r);
    if (ds < 0 || ds >= 30) break;
    int dextra;
    const bool got_dist = r.bits(kDistEb[ds], dextra);
    if (!got_len || !got_dist) break;
    const long long d = kDistBase[ds] + dextra;
    if (d > st.o || st.o + mlen > cap) break;
    a = static_cast<int>(d);
    len = mlen;
    return COPY_MATCH;
  }
  status = -1;
  return DONE;
}

__global__ void __launch_bounds__(32 * WARPS)
inflate_kernel(const uint8_t* __restrict__ streams,
               const int32_t* __restrict__ lens, int B, int w,
               uint8_t* __restrict__ out, int cap,
               long long* __restrict__ status) {
  __shared__ Shared sh_all[WARPS];
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= B) return;   // whole warps
  Shared& sh = sh_all[threadIdx.x / 32];
  const uint8_t* src = streams + static_cast<size_t>(row) * w;
  uint8_t* dst = out + static_cast<size_t>(row) * cap;
  const int n = min(max(lens[row], 0), w);
  if (n == 0) {   // an empty row is an empty block
    if (lane == 0) status[row] = 0;
    return;
  }
  Reader r{src, n};
  State st;
  for (;;) {
    int action = DONE, a = 0, len = 0;
    long long o = 0, done = 0;
    if (lane == 0) {
      action = step(sh, r, st, dst, cap, a, len, done);
      o = st.o;
      if (action != DONE) st.o += len;
    }
    action = __shfl_sync(FULL, action, 0);
    if (action == DONE) {
      if (lane == 0) status[row] = done;
      return;
    }
    a = __shfl_sync(FULL, a, 0);
    len = __shfl_sync(FULL, len, 0);
    o = __shfl_sync(FULL, o, 0);
    __syncwarp();   // lane 0's literals before the lanes read them
    if (action == COPY_MATCH) {
      for (int k = lane; k < len; k += 32) dst[o + k] = dst[o - a + k % a];
    } else {
      for (int k = lane; k < len; k += 32) dst[o + k] = src[a + k];
    }
    __syncwarp();   // the copy before lane 0 or a later copy reads it
  }
}

}  // namespace

// streams (B, w) u8 and lens (B,) i32 (read as at most w) in; out (B, cap)
// u8, zeroed by the caller, and status (B,) i64 out.  Launches ceil(B /
// WARPS) blocks of WARPS warps on `stream` and returns cudaGetLastError().
extern "C" int tpz_inflate(const void* streams, const void* lens, int B,
                           int w, void* out, int cap, void* status,
                           void* stream) {
  inflate_kernel<<<(B + WARPS - 1) / WARPS, 32 * WARPS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(streams), static_cast<const int32_t*>(lens),
      B, w, static_cast<uint8_t*>(out), cap,
      static_cast<long long*>(status));
  return static_cast<int>(cudaGetLastError());
}
