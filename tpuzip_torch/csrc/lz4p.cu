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
// What bounds it on this card: pack, a chain of dependent loads a sequence
// (an LZ4 token's place follows from the last sequence's lengths); decode,
// the matches, each of which reads bytes that earlier sequences wrote.
// Neither comes near the bytes' bound.
//
// What the design does about it:
//   - pack: two walks of the stream, the lanes in step (every load a
//     broadcast): the first counts the column entries S (the columns' places
//     follow from it), the second writes them, a lane an entry of a split
//     run, and copies the literals 32 bytes a step;
//   - decode: the columns give every sequence's output offset and literal
//     source by prefix sums, so there is no serial parse: 32 sequences a
//     step, a lane each, scanned across the warp.  A first pass checks
//     every sequence at once (every fault gives -1, so their order does not
//     matter); a second copies each sequence's literals and then its match
//     32 bytes a step, in order, byte k of a match at o from o - off + k %
//     off, which lies before o.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int HDR = 8;
constexpr int U16 = 0xFFFF;
constexpr int MIN_MATCH = 4;
constexpr unsigned FULL = 0xFFFFFFFFu;

// One LZ4 sequence of a well-formed stream: its literals at lit_src, and,
// unless it is the stream's last, a match of ml bytes off back; `next` is
// the next token's place.  Reads past the stream give 0.
struct Sequence {
  int lit_src, lit, ml, off, next;
  bool last;
};

__device__ __forceinline__ Sequence read_sequence(const uint8_t* s, int i,
                                                  int n) {
  auto at = [&](int k) { return k < n ? static_cast<int>(s[k]) : 0; };
  Sequence q;
  const int token = at(i++);
  q.lit = token >> 4;
  if (q.lit == 15) {
    int b;
    do {
      b = at(i++);
      q.lit += b;
    } while (b == 255 && i < n);
  }
  q.lit_src = i;
  i += q.lit;
  q.last = i >= n;
  q.ml = q.off = 0;
  if (!q.last) {
    q.off = at(i) | (at(i + 1) << 8);
    i += 2;
    q.ml = (token & 15) + MIN_MATCH;
    if ((token & 15) == 15) {
      int b;
      do {
        b = at(i++);
        q.ml += b;
      } while (b == 255 && i < n);
    }
  }
  q.next = i;
  return q;
}

// The extra entries a run of `len` bytes takes when split (0 unsplit).
__device__ __forceinline__ int extra_pieces(int len, bool split) {
  return split && len > U16 ? (len - 1) / U16 : 0;
}

__device__ __forceinline__ void put_u16(uint8_t* p, int v) {
  p[0] = static_cast<uint8_t>(v & 0xFF);
  p[1] = static_cast<uint8_t>((v >> 8) & 0xFF);
}

__global__ void __launch_bounds__(32)
lz4p_pack_kernel(const uint8_t* __restrict__ comp,
                 const int32_t* __restrict__ clens, int w,
                 uint8_t* __restrict__ out, int cap,
                 int32_t* __restrict__ olens, bool split) {
  const int lane = threadIdx.x;
  const int row = blockIdx.x;
  const uint8_t* s = comp + static_cast<size_t>(row) * w;
  uint8_t* dst = out + static_cast<size_t>(row) * cap;
  const int n = min(max(clens[row], 0), w);
  // walk 1: the entries, the literal bytes and the block's length
  long long nseq = 0, lits = 0, orig = 0;
  bool over = false, bad = false;
  for (int i = 0; i < n;) {
    const Sequence q = read_sequence(s, i, n);
    nseq += 1 + extra_pieces(q.lit, split) + extra_pieces(q.ml, split);
    over |= q.lit > U16 || q.ml > U16;
    bad |= q.lit_src + q.lit > n;
    lits += q.lit;
    orig += q.lit + q.ml;
    i = q.next;
    if (q.last) break;
  }
  const long long base = HDR + 6 * nseq;
  // a run the XLA rule cannot write; or, from no encoder of the port,
  // literals past the stream or a row past its capacity
  if ((over && !split) || bad || base + lits > cap) {
    if (lane == 0) olens[row] = -1;
    return;
  }
  if (lane < 8)
    dst[lane] = static_cast<uint8_t>(
        ((lane < 4 ? nseq : orig) >> (8 * (lane & 3))) & 0xFF);
  if (lane == 0) olens[row] = static_cast<int32_t>(base + lits);
  // walk 2: the column entries, a lane an entry of a sequence's pieces,
  // and the literals
  long long e = 0, lo = 0;
  for (int i = 0; i < n;) {
    const Sequence q = read_sequence(s, i, n);
    const int xl = extra_pieces(q.lit, split);
    const int xm = extra_pieces(q.ml, split);
    for (int j = lane; j <= xl + xm; j += 32) {
      const int mp = j - xl;   // the entry's match piece, from 0
      const int ll = j < xl ? U16 : mp == 0 ? q.lit - U16 * xl : 0;
      const int ml = mp < 0 ? 0 : mp < xm ? U16 : q.ml - U16 * xm;
      uint8_t* col = dst + HDR + 2 * (e + j);
      put_u16(col, ll);
      put_u16(col + 2 * nseq, ml);
      put_u16(col + 4 * nseq, ml > 0 ? q.off : 0);
    }
    for (int k = lane; k < q.lit; k += 32)
      dst[base + lo + k] = s[q.lit_src + k];
    e += 1 + xl + xm;
    lo += q.lit;
    i = q.next;
    if (q.last) break;
  }
}

// A warp's inclusive prefix sum of v.
__device__ __forceinline__ long long warp_scan(long long v, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const long long u = __shfl_up_sync(FULL, v, d);
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

__device__ __forceinline__ Entry column_entry(const uint8_t* s, long long S,
                                              long long t0, int lane,
                                              long long& o_carry,
                                              long long& lp_carry) {
  Entry q;
  const long long t = t0 + lane;
  q.ll = q.ml = q.off = 0;
  if (t < S) {
    const uint8_t* c = s + HDR + 2 * t;
    q.ll = c[0] | (c[1] << 8);
    q.ml = c[2 * S] | (c[2 * S + 1] << 8);
    q.off = c[4 * S] | (c[4 * S + 1] << 8);
  }
  const long long size = warp_scan(q.ll + q.ml, lane);
  const long long lit = warp_scan(q.ll, lane);
  q.o = o_carry + size - (q.ll + q.ml);
  q.lp = lp_carry + lit - q.ll;
  o_carry += __shfl_sync(FULL, size, 31);
  lp_carry += __shfl_sync(FULL, lit, 31);
  return q;
}

__global__ void __launch_bounds__(32)
lz4p_decode_kernel(const uint8_t* __restrict__ comp,
                   const int32_t* __restrict__ clens, int w,
                   uint8_t* __restrict__ out, int out_cap,
                   int64_t* __restrict__ status) {
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
  for (long long t0 = 0; st > 0 && t0 < S; t0 += 32) {
    const Entry q = column_entry(s, S, t0, lane, o_carry, lp_carry);
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
  // pass 2: literals, then the match, a sequence at a time
  o_carry = lp_carry = 0;
  for (long long t0 = 0; end > 0 && t0 < S; t0 += 32) {
    const Entry q = column_entry(s, S, t0, lane, o_carry, lp_carry);
    const int count = static_cast<int>(min(S - t0, 32LL));
    for (int j = 0; j < count; ++j) {
      const long long o = __shfl_sync(FULL, q.o, j);
      const long long lp = __shfl_sync(FULL, q.lp, j);
      const int ll = __shfl_sync(FULL, q.ll, j);
      const int ml = __shfl_sync(FULL, q.ml, j);
      const int off = __shfl_sync(FULL, q.off, j);
      for (int k = lane; k < ll; k += 32) dst[o + k] = s[base + lp + k];
      __syncwarp();   // the literals before a match that reads them
      const long long ms = o + ll;
      for (int k = lane; k < ml; k += 32)
        dst[ms + k] = dst[ms - off + (k < off ? k : k % off)];
      __syncwarp();   // this match before the next sequence's reads
    }
  }
  for (long long p = end + lane; p < out_cap; p += 32) dst[p] = 0;
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
