// wisecondorx_tpu native CRAM 3.0 reader.
//
// The reference converts CRAM through pysam/htslib (reference
// convert_tools.py:22-33).  This is a dependency-light reimplementation of
// the subset of CRAM 3.0 needed for read binning: container/slice
// structure, the compression-header encoding maps, block codecs (raw,
// gzip, bzip2, lzma via system libs; rANS-4x8 order 0/1 implemented here),
// and per-record decoding of exactly the data series the binner consumes —
// BF (BAM flags), CF (CRAM flags), RI (multi-ref slices), AP (alignment
// position, optionally delta), MQ (mapped records), NF/NP (mate position
// for the duplicate filter).  Every CRAM data series occupies its own
// value stream, so the name/sequence/quality/tag series are never even
// decompressed.
//
// Binning + filter semantics are identical to bamreader.cpp (proper pair,
// larp/larp2 consecutive-start duplicate removal, mapq >= 1) — reference
// convert_tools.py:73-105.  No FASTA is needed: sequences are not
// reconstructed.
//
// C ABI (ctypes): wcx_cram_open / wcx_cram_error / wcx_cram_nref /
// wcx_cram_ref_name / wcx_cram_ref_len / wcx_cram_count / wcx_cram_close.

#include <zlib.h>

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstdio>
#include <cstring>
#include <map>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct CramError : std::runtime_error {
  explicit CramError(const std::string& m) : std::runtime_error(m) {}
};

// ---------------------------------------------------------------- cursors

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;

  uint8_t byte() {
    if (p >= end) throw CramError("unexpected end of data");
    return *p++;
  }
  void bytes(void* out, size_t n) {
    if (p + n > end) throw CramError("unexpected end of data");
    memcpy(out, p, n);
    p += n;
  }
  void skip(size_t n) {
    if (p + n > end) throw CramError("unexpected end of data");
    p += n;
  }
  uint32_t u32le() {
    uint32_t v;
    bytes(&v, 4);
    return v;
  }
  int32_t itf8() {
    uint32_t b0 = byte();
    if (b0 < 0x80) return (int32_t)b0;
    if (b0 < 0xC0) return (int32_t)(((b0 & 0x3F) << 8) | byte());
    if (b0 < 0xE0) {
      uint32_t v = (b0 & 0x1F) << 16;
      v |= (uint32_t)byte() << 8;
      v |= byte();
      return (int32_t)v;
    }
    if (b0 < 0xF0) {
      uint32_t v = (b0 & 0x0F) << 24;
      v |= (uint32_t)byte() << 16;
      v |= (uint32_t)byte() << 8;
      v |= byte();
      return (int32_t)v;
    }
    uint32_t v = (b0 & 0x0F) << 28;
    v |= (uint32_t)byte() << 20;
    v |= (uint32_t)byte() << 12;
    v |= (uint32_t)byte() << 4;
    v |= byte() & 0x0F;
    return (int32_t)v;
  }
  int64_t ltf8() {
    uint64_t b0 = byte();
    int extra = 0;
    uint64_t v = 0;
    if (b0 < 0x80) return (int64_t)b0;
    if (b0 < 0xC0) { extra = 1; v = b0 & 0x3F; }
    else if (b0 < 0xE0) { extra = 2; v = b0 & 0x1F; }
    else if (b0 < 0xF0) { extra = 3; v = b0 & 0x0F; }
    else if (b0 < 0xF8) { extra = 4; v = b0 & 0x07; }
    else if (b0 < 0xFC) { extra = 5; v = b0 & 0x03; }
    else if (b0 < 0xFE) { extra = 6; v = b0 & 0x01; }
    else if (b0 == 0xFE) { extra = 7; v = 0; }
    else { extra = 8; v = 0; }
    for (int i = 0; i < extra; i++) v = (v << 8) | byte();
    return (int64_t)v;
  }
};

// MSB-first bit reader over the core block.
struct BitReader {
  Cursor c{nullptr, nullptr};
  uint32_t bitbuf = 0;
  int nbits = 0;

  uint32_t bits(int n) {
    uint32_t v = 0;
    while (n > 0) {
      if (nbits == 0) {
        bitbuf = c.byte();
        nbits = 8;
      }
      int take = n < nbits ? n : nbits;
      v = (v << take) | ((bitbuf >> (nbits - take)) & ((1u << take) - 1));
      nbits -= take;
      n -= take;
    }
    return v;
  }
};

// ---------------------------------------------------------------- codecs

std::vector<uint8_t> inflate_gzip(const uint8_t* in, size_t n,
                                  size_t raw_size) {
  std::vector<uint8_t> out(raw_size);
  z_stream s{};
  if (inflateInit2(&s, 15 + 32) != Z_OK) throw CramError("inflateInit2");
  s.next_in = const_cast<uint8_t*>(in);
  s.avail_in = (uInt)n;
  s.next_out = out.data();
  s.avail_out = (uInt)out.size();
  int ret = inflate(&s, Z_FINISH);
  inflateEnd(&s);
  if (ret != Z_STREAM_END && !(ret == Z_OK && s.avail_out == 0))
    throw CramError("gzip block decode failed");
  out.resize(out.size() - s.avail_out);
  return out;
}

// bzip2 / lzma blocks via the system libraries.  The image ships the
// shared objects but not bzlib.h, so the one stable-ABI entry point used
// is declared here directly.
extern "C" int BZ2_bzBuffToBuffDecompress(char* dest, unsigned* destLen,
                                          char* source, unsigned sourceLen,
                                          int small, int verbosity);

// Minimal liblzma declarations (stable ABI; avoids requiring lzma.h).
extern "C" int lzma_stream_buffer_decode(
    uint64_t* memlimit, uint32_t flags, void* allocator,
    const uint8_t* in, size_t* in_pos, size_t in_size,
    uint8_t* out, size_t* out_pos, size_t out_size);

std::vector<uint8_t> bunzip2_block(const uint8_t* in, size_t n,
                                   size_t raw_size) {
  std::vector<uint8_t> out(raw_size);
  unsigned dest_len = (unsigned)raw_size;
  int ret = BZ2_bzBuffToBuffDecompress(
      reinterpret_cast<char*>(out.data()), &dest_len,
      reinterpret_cast<char*>(const_cast<uint8_t*>(in)), (unsigned)n, 0, 0);
  if (ret != 0 || dest_len != raw_size)
    throw CramError("bzip2 block decode failed");
  return out;
}

std::vector<uint8_t> unlzma_block(const uint8_t* in, size_t n,
                                  size_t raw_size) {
  std::vector<uint8_t> out(raw_size);
  uint64_t memlimit = UINT64_MAX;
  size_t in_pos = 0, out_pos = 0;
  int ret = lzma_stream_buffer_decode(
      &memlimit, 0, nullptr, in, &in_pos, n, out.data(), &out_pos,
      raw_size);
  if (ret != 0 /* LZMA_OK */ || out_pos != raw_size)
    throw CramError("lzma block decode failed");
  return out;
}

// rANS 4x8 (CRAM 3.0 section 13): 4 interleaved byte-wise rANS states,
// 12-bit frequencies, order-0 or order-1 context.
constexpr uint32_t kRansLow = 1u << 23;
constexpr uint32_t kTotFreq = 1u << 12;

struct RansTable {
  uint16_t freq[256] = {0};
  uint16_t cum[256] = {0};
  uint8_t sym_of_slot[kTotFreq] = {0};

  void finish() {
    uint32_t c = 0;
    for (int s = 0; s < 256; s++) {
      cum[s] = (uint16_t)c;
      for (uint32_t k = 0; k < freq[s] && c + k < kTotFreq; k++)
        sym_of_slot[c + k] = (uint8_t)s;
      c += freq[s];
      if (c > kTotFreq) throw CramError("rANS frequency overflow");
    }
  }
};

uint16_t rans_read_freq(Cursor& c) {
  uint32_t f = c.byte();
  if (f >= 0x80) f = ((f & 0x7F) << 8) | c.byte();
  return (uint16_t)f;
}

// Frequency-table RLE exactly as written by htslib's rANS_static coder:
// symbols ascend; a byte equal to prev+1 right after a frequency starts an
// RLE run whose length byte follows; a 0 symbol byte terminates.
void rans_read_freqs0_exact(Cursor& c, RansTable& t) {
  int rle = 0;
  int j = c.byte();
  do {
    t.freq[j] = rans_read_freq(c);
    if (!rle && c.p < c.end && *c.p == j + 1) {
      j = c.byte();
      rle = c.byte();
    } else if (rle) {
      rle--;
      j++;
    } else {
      j = c.byte();
    }
  } while (j);
  t.finish();
}

void rans_renorm(uint32_t& r, Cursor& c) {
  while (r < kRansLow) r = (r << 8) | c.byte();
}

std::vector<uint8_t> rans_decode(const uint8_t* in, size_t n,
                                 size_t raw_size_hint) {
  Cursor c{in, in + n};
  int order = c.byte();
  (void)c.u32le();  // compressed size of payload
  uint32_t out_sz = c.u32le();
  if (raw_size_hint && out_sz != raw_size_hint)
    throw CramError("rANS size mismatch");
  std::vector<uint8_t> out(out_sz);
  if (out_sz == 0) return out;

  if (order == 0) {
    RansTable t;
    rans_read_freqs0_exact(c, t);
    uint32_t R[4];
    for (int j = 0; j < 4; j++) R[j] = c.u32le();
    for (uint32_t i = 0; i < out_sz; i++) {
      uint32_t& r = R[i & 3];
      uint32_t slot = r & (kTotFreq - 1);
      uint8_t s = t.sym_of_slot[slot];
      out[i] = s;
      r = t.freq[s] * (r >> 12) + slot - t.cum[s];
      rans_renorm(r, c);
    }
    return out;
  }
  if (order != 1) throw CramError("unknown rANS order");

  // Order-1: a table per preceding-byte context, contexts RLE-listed.
  std::vector<RansTable> tables(256);
  std::vector<bool> present(256, false);
  {
    int rle_i = 0;
    int i = c.byte();
    do {
      rans_read_freqs0_exact(c, tables[i]);
      present[i] = true;
      if (!rle_i && c.p < c.end && *c.p == i + 1) {
        i = c.byte();
        rle_i = c.byte();
      } else if (rle_i) {
        rle_i--;
        i++;
      } else {
        i = c.byte();
      }
    } while (i);
  }
  uint32_t R[4];
  for (int j = 0; j < 4; j++) R[j] = c.u32le();
  const uint32_t q = out_sz >> 2;
  uint32_t pos[4] = {0, q, 2 * q, 3 * q};
  uint8_t last[4] = {0, 0, 0, 0};
  for (uint32_t i = 0; i < q; i++) {
    for (int j = 0; j < 4; j++) {
      RansTable& t = tables[last[j]];
      uint32_t& r = R[j];
      uint32_t slot = r & (kTotFreq - 1);
      uint8_t s = t.sym_of_slot[slot];
      out[pos[j]] = s;
      r = t.freq[s] * (r >> 12) + slot - t.cum[s];
      rans_renorm(r, c);
      last[j] = s;
      pos[j]++;
    }
  }
  // Tail (out_sz not divisible by 4): state 3 continues.
  for (uint32_t i = pos[3]; i < out_sz; i++) {
    RansTable& t = tables[last[3]];
    uint32_t& r = R[3];
    uint32_t slot = r & (kTotFreq - 1);
    uint8_t s = t.sym_of_slot[slot];
    out[i] = s;
    r = t.freq[s] * (r >> 12) + slot - t.cum[s];
    rans_renorm(r, c);
    last[3] = s;
  }
  return out;
}

// ------------------------------------------------- rANS Nx16 (CRAM 3.1)
//
// CRAMcodecs "rANS Nx16" entropy coder + bit-stream transforms, the
// default block codec of CRAM 3.1 emitters: 16-bit renormalizing rANS
// with 4 or 32 interleaved states (flag 0x04), order-0/1 contexts, and
// the PACK (0x80), RLE (0x40), STRIPE (0x08) and CAT (0x20) transforms;
// NOSZ (0x10) suppresses the stored size inside STRIPE sub-streams.
// Implemented from the published specification; cross-checked against an
// independently written Python encoder (tests/cramtools.py) — the image
// has no htslib to generate golden bytes (ROADMAP.md).

constexpr uint32_t kNxLow = 1u << 15;

uint32_t uint7(Cursor& c) {
  uint32_t v = 0;
  uint8_t b;
  do {
    b = c.byte();
    v = (v << 7) | (b & 0x7F);
  } while (b & 0x80);
  return v;
}

// Used-symbol list: ascending bytes, 0-terminated (a leading 0 is a real
// symbol); x followed by x+1 starts an RLE run whose length byte follows.
std::vector<int> nx16_alphabet(Cursor& c) {
  std::vector<int> A;
  int rle = 0;
  int sym = c.byte();
  int last = sym;
  do {
    if (sym > 255)  // malformed RLE run walking past the byte alphabet
      throw CramError("rANS-Nx16 alphabet symbol out of range");
    A.push_back(sym);
    if (rle) {
      rle--;
      sym++;
    } else {
      sym = c.byte();
      if (sym == last + 1) rle = c.byte();
    }
    last = sym;
  } while (sym != 0);
  if (A.size() > 256) throw CramError("rANS-Nx16 alphabet overflow");
  return A;
}

struct NxTable {
  int shift = 12;
  uint32_t freq[256] = {0};
  uint32_t cum[256] = {0};
  std::vector<uint8_t> slot2sym;

  void finish() {
    uint32_t tot = 1u << shift;
    slot2sym.resize(tot);
    uint32_t cac = 0;
    for (int s = 0; s < 256; s++) {
      cum[s] = cac;
      for (uint32_t k = 0; k < freq[s] && cac + k < tot; k++)
        slot2sym[cac + k] = (uint8_t)s;
      cac += freq[s];
      if (cac > tot) throw CramError("rANS-Nx16 frequency overflow");
    }
  }
};

// Order-0 frequency table: alphabet, then per-symbol uint7 frequencies
// normalized to sum 1<<12.
void nx16_freqs_o0(Cursor& c, NxTable& t) {
  t.shift = 12;
  for (int s : nx16_alphabet(c)) t.freq[s] = uint7(c);
  t.finish();
}

// Raw order-0/1 Nx16 entropy decode of ``out_sz`` bytes with N states.
std::vector<uint8_t> nx16_entropy(Cursor& c, size_t out_sz, int order,
                                  int N) {
  std::vector<uint8_t> out(out_sz);
  if (out_sz == 0) return out;
  std::vector<uint32_t> R(N);

  auto step = [&](NxTable& t, uint32_t& r) -> uint8_t {
    uint32_t mask = (1u << t.shift) - 1;
    uint32_t slot = r & mask;
    uint8_t s = t.slot2sym[slot];
    r = t.freq[s] * (r >> t.shift) + slot - t.cum[s];
    if (r < kNxLow) {
      uint32_t lo = c.byte();
      lo |= (uint32_t)c.byte() << 8;  // 16-bit little-endian renorm
      r = (r << 16) | lo;
    }
    return s;
  };

  if (order == 0) {
    NxTable t;
    nx16_freqs_o0(c, t);
    for (int j = 0; j < N; j++) R[j] = c.u32le();
    for (size_t i = 0; i < out_sz; i++) out[i] = step(t, R[i % N]);
    return out;
  }

  // Order-1: optionally order-0-compressed table; shared symbol
  // alphabet; per-context rows with zero-run shortening; row sums
  // normalized to 1<<shift (12, or 10 in the "fast" profile).
  uint8_t tab_flags = c.byte();
  int shift = tab_flags >> 4;
  std::vector<uint8_t> tab_buf;
  Cursor tc{nullptr, nullptr};
  if (tab_flags & 1) {
    uint32_t u_sz = uint7(c);
    uint32_t c_sz = uint7(c);
    Cursor sub{c.p, c.p + c_sz};
    if (c.p + c_sz > c.end) throw CramError("rANS-Nx16 table overrun");
    tab_buf = nx16_entropy(sub, u_sz, 0, 4);
    c.p += c_sz;
    tc = Cursor{tab_buf.data(), tab_buf.data() + tab_buf.size()};
  } else {
    tc = c;
  }
  std::vector<int> A = nx16_alphabet(tc);
  std::vector<NxTable> tables(256);
  std::vector<bool> in_A(256, false);
  for (int i : A) {
    in_A[i] = true;
    NxTable& t = tables[i];
    t.shift = shift;
    int run = 0;
    for (int j : A) {
      if (run > 0) {
        run--;
        t.freq[j] = 0;
        continue;
      }
      uint32_t fr = uint7(tc);
      t.freq[j] = fr;
      if (fr == 0) run = tc.byte();
    }
    t.finish();
  }
  // A corrupt stream can decode a symbol outside the alphabet and use it
  // as the next context; finish() every remaining table too (all-zero
  // frequencies -> a zero-filled, correctly sized lookup) so the decode
  // step below stays in bounds and terminates with a clean cursor error
  // instead of reading past an empty slot2sym (found by mutation fuzz).
  for (int i = 0; i < 256; i++) {
    if (!in_A[i]) {
      tables[i].shift = shift;
      tables[i].finish();
    }
  }
  if (!(tab_flags & 1)) c = tc;  // advance past the in-line table

  for (int j = 0; j < N; j++) R[j] = c.u32le();
  size_t q = out_sz / N;
  std::vector<size_t> pos(N);
  std::vector<uint8_t> last(N, 0);
  for (int j = 0; j < N; j++) pos[j] = j * q;
  for (size_t i = 0; i < q; i++) {
    for (int j = 0; j < N; j++) {
      uint8_t s = step(tables[last[j]], R[j]);
      out[pos[j]++] = s;
      last[j] = s;
    }
  }
  for (size_t i = pos[N - 1]; i < out_sz; i++) {  // tail: last state
    uint8_t s = step(tables[last[N - 1]], R[N - 1]);
    out[i] = s;
    last[N - 1] = s;
  }
  return out;
}

// Full rANS-Nx16 stream: flag byte + transforms (CRAMcodecs section 3).
// ``size_hint``: expected output size (used when NOSZ suppresses the
// stored one — STRIPE sub-streams — and verified otherwise).
// ``depth`` guards against crafted STRIPE-in-STRIPE nesting: each level
// costs ~4 bytes of input but a full C++ stack frame, so unbounded
// recursion lets a small block overflow the stack; real emitters
// (htslib) emit a single STRIPE level over plain entropy sub-streams.
std::vector<uint8_t> rans_nx16_decode(const uint8_t* in, size_t n,
                                      size_t size_hint, int depth = 0) {
  Cursor c{in, in + n};
  uint8_t flags = c.byte();
  const bool f_order = flags & 0x01;
  const bool f_x32 = flags & 0x04;
  const bool f_stripe = flags & 0x08;
  const bool f_nosz = flags & 0x10;
  const bool f_cat = flags & 0x20;
  const bool f_rle = flags & 0x40;
  const bool f_pack = flags & 0x80;
  size_t len = f_nosz ? size_hint : uint7(c);
  if (!f_nosz && size_hint && len != size_hint)
    throw CramError("rANS-Nx16 size mismatch");

  if (f_stripe) {
    if (depth >= 2)
      throw CramError("rANS-Nx16 stripe nested deeper than 2 levels");
    int N = c.byte();
    if (N <= 0) throw CramError("rANS-Nx16 stripe with zero streams");
    std::vector<uint32_t> clen(N);
    for (int j = 0; j < N; j++) clen[j] = uint7(c);
    std::vector<std::vector<uint8_t>> sub(N);
    for (int j = 0; j < N; j++) {
      if (c.p + clen[j] > c.end)
        throw CramError("rANS-Nx16 stripe overrun");
      size_t sub_len = (len - j + N - 1) / N;  // count of i: i%N == j
      sub[j] = rans_nx16_decode(c.p, clen[j], sub_len, depth + 1);
      c.p += clen[j];
    }
    std::vector<uint8_t> out(len);
    for (size_t i = 0; i < len; i++) out[i] = sub[i % N][i / N];
    return out;
  }

  // Transform metadata (read order: PACK, then RLE; applied in reverse).
  std::vector<uint8_t> pack_syms;
  size_t pack_len = 0;
  if (f_pack) {
    int nsym = c.byte();
    pack_syms.resize(nsym);
    for (int i = 0; i < nsym; i++) pack_syms[i] = c.byte();
    pack_len = uint7(c);
  }
  std::vector<uint8_t> rle_meta;
  size_t rle_lit_len = 0;
  if (f_rle) {
    uint32_t meta_len = uint7(c);
    rle_lit_len = uint7(c);
    if (meta_len & 1) {
      size_t m = meta_len >> 1;
      if (c.p + m > c.end) throw CramError("rANS-Nx16 rle meta overrun");
      rle_meta.assign(c.p, c.p + m);
      c.p += m;
    } else {
      uint32_t u_meta = uint7(c);
      size_t m = meta_len >> 1;
      if (c.p + m > c.end) throw CramError("rANS-Nx16 rle meta overrun");
      Cursor sub{c.p, c.p + m};
      rle_meta = nx16_entropy(sub, u_meta, 0, 4);
      c.p += m;
    }
  }

  size_t entropy_sz = f_rle ? rle_lit_len : (f_pack ? pack_len : len);
  std::vector<uint8_t> data;
  if (f_cat) {
    if (c.p + entropy_sz > c.end) throw CramError("rANS-Nx16 cat overrun");
    data.assign(c.p, c.p + entropy_sz);
    c.p += entropy_sz;
  } else {
    data = nx16_entropy(c, entropy_sz, f_order ? 1 : 0, f_x32 ? 32 : 4);
  }

  if (f_rle) {
    // Literal stream + meta: [n run symbols (0 => 256), the symbols,
    // then per-occurrence run lengths as uint7 in literal order].
    size_t target = f_pack ? pack_len : len;
    Cursor mc{rle_meta.data(), rle_meta.data() + rle_meta.size()};
    int nrun = mc.byte();
    if (nrun == 0) nrun = 256;
    bool is_run[256] = {false};
    for (int i = 0; i < nrun; i++) is_run[mc.byte()] = true;
    std::vector<uint8_t> expanded;
    expanded.reserve(target);
    for (uint8_t b : data) {
      expanded.push_back(b);
      if (is_run[b]) {
        uint32_t run = uint7(mc);
        expanded.insert(expanded.end(), run, b);
      }
    }
    if (expanded.size() != target)
      throw CramError("rANS-Nx16 rle length mismatch");
    data = std::move(expanded);
  }

  if (f_pack) {
    size_t nsym = pack_syms.size();
    std::vector<uint8_t> unpacked(len);
    if (nsym <= 1) {
      if (nsym == 0) throw CramError("rANS-Nx16 pack without symbols");
      std::fill(unpacked.begin(), unpacked.end(), pack_syms[0]);
    } else {
      int bits = nsym <= 2 ? 1 : nsym <= 4 ? 2 : nsym <= 16 ? 4 : 0;
      if (!bits)
        throw CramError("rANS-Nx16 pack with more than 16 symbols");
      int per = 8 / bits;
      uint32_t mask = (1u << bits) - 1;
      // pack_len is attacker-controlled; the loop below indexes
      // data[i / per] for i in [0, len), so a short payload would read
      // out of bounds.  Exactly ceil(len / per) packed bytes are valid.
      if (data.size() != (len + (size_t)per - 1) / (size_t)per)
        throw CramError("rANS-Nx16 pack length mismatch");
      for (size_t i = 0; i < len; i++) {
        uint8_t byteval = data[i / per];
        uint32_t v = (byteval >> ((i % per) * bits)) & mask;
        if (v >= nsym) throw CramError("rANS-Nx16 pack symbol overflow");
        unpacked[i] = pack_syms[v];
      }
    }
    data = std::move(unpacked);
  }

  if (data.size() != len)
    throw CramError("rANS-Nx16 output length mismatch");
  return data;
}

// ---------------------------------------------------------------- blocks

struct Block {
  int method = 0;
  int content_type = 0;
  int32_t content_id = 0;
  std::vector<uint8_t> compressed;  // raw on-disk payload
  size_t raw_size = 0;

  std::vector<uint8_t> decode() const {
    switch (method) {
      case 0: return compressed;
      case 1: return inflate_gzip(compressed.data(), compressed.size(),
                                  raw_size);
      case 2: return bunzip2_block(compressed.data(), compressed.size(),
                                   raw_size);
      case 3: return unlzma_block(compressed.data(), compressed.size(),
                                  raw_size);
      case 4: return rans_decode(compressed.data(), compressed.size(),
                                 raw_size);
      case 5: return rans_nx16_decode(compressed.data(),
                                      compressed.size(), raw_size);
      // Remaining CRAM 3.1 codecs, named precisely so a failing file is
      // diagnosable.  They compress series the binner never reads (read
      // names, qualities), and blocks decode lazily — these fire only if
      // an emitter applied one to a needed integer series.
      case 6:
        throw CramError(
            "CRAM 3.1 adaptive arithmetic codec not supported (block "
            "content id " + std::to_string(content_id) + "); re-encode "
            "with rANS (samtools view --output-fmt-option archive=0)");
      case 7:
        throw CramError(
            "CRAM 3.1 fqzcomp codec not supported (block content id " +
            std::to_string(content_id) + ")");
      case 8:
        throw CramError(
            "CRAM 3.1 name-tokenizer codec not supported (block content "
            "id " + std::to_string(content_id) + ")");
      default:
        throw CramError("unsupported block compression method " +
                        std::to_string(method));
    }
  }
};

Block read_block(FILE* f) {
  Block b;
  uint8_t hdr[2];
  if (fread(hdr, 1, 2, f) != 2) throw CramError("truncated block");
  b.method = hdr[0];
  b.content_type = hdr[1];
  // Read the varint fields through a small buffered cursor.
  uint8_t buf[16];
  size_t have = fread(buf, 1, sizeof(buf), f);
  Cursor c{buf, buf + have};
  b.content_id = c.itf8();
  int32_t comp_size = c.itf8();
  b.raw_size = (size_t)c.itf8();
  size_t used = (size_t)(c.p - buf);
  // Push back over-read bytes by seeking.
  if (fseek(f, (long)used - (long)have, SEEK_CUR) != 0)
    throw CramError("seek failed");
  b.compressed.resize(comp_size);
  if (comp_size &&
      fread(b.compressed.data(), 1, comp_size, f) != (size_t)comp_size)
    throw CramError("truncated block payload");
  uint8_t crc[4];
  if (fread(crc, 1, 4, f) != 4) throw CramError("truncated block crc");
  return b;
}

// ---------------------------------------------------------------- encodings

enum SeriesCodec { kCodecNone = 0, kCodecExternal = 1, kCodecHuffman = 3,
                   kCodecBeta = 6 };

struct Encoding {
  int codec = kCodecNone;
  // EXTERNAL
  int32_t content_id = -1;
  // HUFFMAN (canonical over int alphabet)
  std::vector<int32_t> alphabet;
  std::vector<int32_t> lengths;
  std::vector<uint32_t> codes;  // canonical codes, built on first use
  // BETA
  int32_t offset = 0;
  int32_t nbits = 0;

  void parse(int codec_id, Cursor params) {
    codec = codec_id;
    switch (codec_id) {
      case kCodecExternal:
        content_id = params.itf8();
        break;
      case kCodecHuffman: {
        int32_t n = params.itf8();
        alphabet.resize(n);
        for (int32_t i = 0; i < n; i++) alphabet[i] = params.itf8();
        int32_t m = params.itf8();
        lengths.resize(m);
        for (int32_t i = 0; i < m; i++) lengths[i] = params.itf8();
        build_canonical();
        break;
      }
      case kCodecBeta:
        offset = params.itf8();
        nbits = params.itf8();
        break;
      default:
        throw CramError("unsupported data-series encoding codec " +
                        std::to_string(codec_id));
    }
  }

  void build_canonical() {
    // Canonical Huffman: sort (stable) by code length; assign
    // lexicographically increasing codes.
    size_t n = alphabet.size();
    std::vector<size_t> order(n);
    for (size_t i = 0; i < n; i++) order[i] = i;
    std::stable_sort(order.begin(), order.end(), [&](size_t a, size_t b) {
      return lengths[a] < lengths[b];
    });
    codes.assign(n, 0);
    uint32_t code = 0;
    int32_t prev_len = lengths.empty() ? 0 : lengths[order[0]];
    for (size_t k = 0; k < n; k++) {
      size_t i = order[k];
      code <<= (lengths[i] - prev_len);
      codes[i] = code;
      prev_len = lengths[i];
      code += 1;
    }
  }
};

struct ExternalStream {
  std::vector<uint8_t> data;
  Cursor c{nullptr, nullptr};
};

// Per-slice decode context: lazily decompressed external streams + the
// core bit reader.
struct SliceStreams {
  std::map<int32_t, Block>* blocks;
  std::map<int32_t, ExternalStream> open;
  BitReader core;
  bool core_init = false;
  std::vector<uint8_t> core_data;

  Cursor& external(int32_t id) {
    auto it = open.find(id);
    if (it == open.end()) {
      auto bit = blocks->find(id);
      if (bit == blocks->end())
        throw CramError("missing external block " + std::to_string(id));
      ExternalStream s;
      s.data = bit->second.decode();
      auto [jt, _] = open.emplace(id, std::move(s));
      jt->second.c = Cursor{jt->second.data.data(),
                            jt->second.data.data() + jt->second.data.size()};
      return jt->second.c;
    }
    return it->second.c;
  }

  BitReader& core_reader() {
    if (!core_init) {
      auto bit = blocks->find(-1);
      if (bit == blocks->end())
        throw CramError("core block required but absent");
      core_data = bit->second.decode();
      core.c = Cursor{core_data.data(), core_data.data() + core_data.size()};
      core_init = true;
    }
    return core;
  }

  int32_t read_int(const Encoding& e) {
    switch (e.codec) {
      case kCodecExternal:
        return external(e.content_id).itf8();
      case kCodecHuffman: {
        if (e.alphabet.size() == 1 && e.lengths[0] == 0)
          return e.alphabet[0];  // constant, zero bits
        BitReader& br = core_reader();
        uint32_t code = 0;
        int len = 0;
        for (;;) {
          code = (code << 1) | br.bits(1);
          len++;
          for (size_t i = 0; i < e.alphabet.size(); i++)
            if (e.lengths[i] == len && e.codes[i] == code)
              return e.alphabet[i];
          if (len > 31) throw CramError("bad huffman stream");
        }
      }
      case kCodecBeta:
        return (int32_t)core_reader().bits(e.nbits) - e.offset;
      default:
        throw CramError("series read from unsupported codec");
    }
  }
};

// ---------------------------------------------------------------- header

struct CompressionHeader {
  bool ap_delta = true;
  std::map<uint16_t, Encoding> series;

  static uint16_t key(const char* k) {
    return (uint16_t)(((uint8_t)k[0] << 8) | (uint8_t)k[1]);
  }

  const Encoding* find(const char* k) const {
    auto it = series.find(key(k));
    return it == series.end() ? nullptr : &it->second;
  }

  void parse(const std::vector<uint8_t>& raw) {
    Cursor c{raw.data(), raw.data() + raw.size()};
    // Preservation map.
    (void)c.itf8();  // byte size
    int32_t n = c.itf8();
    for (int32_t i = 0; i < n; i++) {
      char k0 = (char)c.byte(), k1 = (char)c.byte();
      if ((k0 == 'R' && k1 == 'N') || (k0 == 'R' && k1 == 'R')) {
        (void)c.byte();
      } else if (k0 == 'A' && k1 == 'P') {
        ap_delta = c.byte() != 0;
      } else if (k0 == 'S' && k1 == 'M') {
        c.skip(5);
      } else if (k0 == 'T' && k1 == 'D') {
        int32_t len = c.itf8();
        c.skip((size_t)len);
      } else {
        throw CramError(std::string("unknown preservation key ") + k0 + k1);
      }
    }
    // Data series encodings.
    (void)c.itf8();
    n = c.itf8();
    for (int32_t i = 0; i < n; i++) {
      uint8_t k0 = c.byte(), k1 = c.byte();
      int32_t codec_id = c.itf8();
      int32_t sz = c.itf8();
      Cursor params{c.p, c.p + sz};
      c.skip((size_t)sz);
      uint16_t k = (uint16_t)((k0 << 8) | k1);
      // Only the series the binner reads are parsed; everything else is
      // recorded as unparsed so exotic encodings elsewhere cannot fail us.
      static const uint16_t needed[] = {
          key("BF"), key("CF"), key("RI"), key("AP"), key("MQ"),
          key("NF"), key("NP"),
      };
      bool want = false;
      for (uint16_t nk : needed) want |= (k == nk);
      if (want) {
        Encoding e;
        e.parse(codec_id, params);
        series[k] = e;
      }
    }
    // Tag encoding map: skipped entirely.
  }
};

struct RefInfo {
  std::string name;
  int64_t length;
};

struct CramFile {
  FILE* f = nullptr;
  std::vector<RefInfo> refs;
  std::string error;
  long data_start = 0;

  bool open(const char* path) {
    f = fopen(path, "rb");
    if (!f) {
      error = "cannot open file";
      return false;
    }
    try {
      uint8_t def[26];
      if (fread(def, 1, 26, f) != 26) throw CramError("truncated file");
      if (memcmp(def, "CRAM", 4) != 0) throw CramError("not a CRAM file");
      if (def[4] != 3)
        throw CramError("unsupported CRAM major version " +
                        std::to_string(def[4]));
      parse_sam_header();
      data_start = ftell(f);
    } catch (const std::exception& e) {
      error = e.what();
      return false;
    }
    return true;
  }

  // Container header; returns false on clean EOF.
  struct ContainerHdr {
    int32_t length = 0;
    int32_t ref_seq_id = 0;
    int32_t start = 0, span = 0, n_records = 0, n_blocks = 0;
    std::vector<int32_t> landmarks;
  };

  bool read_container_hdr(ContainerHdr& h) {
    uint8_t lenbuf[4];
    size_t got = fread(lenbuf, 1, 4, f);
    if (got == 0) return false;  // clean EOF (no EOF container)
    if (got != 4) throw CramError("truncated container length");
    memcpy(&h.length, lenbuf, 4);
    // A crafted negative length would move container_end BEFORE the
    // current position: the outer loop's fseek would walk backwards and
    // re-parse the same bytes forever (DoS).
    if (h.length < 0) throw CramError("negative container length");
    uint8_t buf[1024];
    size_t have = fread(buf, 1, sizeof(buf), f);
    Cursor c{buf, buf + have};
    h.ref_seq_id = c.itf8();
    h.start = c.itf8();
    h.span = c.itf8();
    h.n_records = c.itf8();
    (void)c.ltf8();  // record counter
    (void)c.ltf8();  // bases
    h.n_blocks = c.itf8();
    int32_t n_land = c.itf8();
    // Landmarks are itf8 (>= 1 byte each) inside this bounded header
    // buffer; a count beyond it is corrupt and would otherwise drive a
    // multi-GB vector allocation before the cursor ever faulted.
    if (n_land < 0 || (size_t)n_land > have)
      throw CramError("implausible landmark count");
    h.landmarks.resize(n_land);
    for (int32_t i = 0; i < n_land; i++) h.landmarks[i] = c.itf8();
    c.skip(4);  // crc32
    size_t used = (size_t)(c.p - buf);
    if (fseek(f, (long)used - (long)have, SEEK_CUR) != 0)
      throw CramError("seek failed");
    return true;
  }

  void parse_sam_header() {
    ContainerHdr h;
    if (!read_container_hdr(h)) throw CramError("missing header container");
    long container_end = ftell(f) + h.length;
    Block b = read_block(f);
    if (b.content_type != 0)
      throw CramError("first block is not the SAM header");
    std::vector<uint8_t> text = b.decode();
    Cursor c{text.data(), text.data() + text.size()};
    int32_t l_text = (int32_t)c.u32le();
    std::string sam(reinterpret_cast<const char*>(c.p),
                    std::min((size_t)l_text, (size_t)(c.end - c.p)));
    // @SQ lines -> reference names/lengths, in order.
    size_t pos = 0;
    while (pos < sam.size()) {
      size_t eol = sam.find('\n', pos);
      if (eol == std::string::npos) eol = sam.size();
      std::string line = sam.substr(pos, eol - pos);
      pos = eol + 1;
      if (line.rfind("@SQ", 0) != 0) continue;
      std::string name;
      int64_t length = 0;
      size_t t = 0;
      while (t < line.size()) {
        size_t tab = line.find('\t', t);
        if (tab == std::string::npos) tab = line.size();
        std::string field = line.substr(t, tab - t);
        t = tab + 1;
        if (field.rfind("SN:", 0) == 0) name = field.substr(3);
        if (field.rfind("LN:", 0) == 0) length = atoll(field.c_str() + 3);
      }
      if (!name.empty()) refs.push_back({name, length});
    }
    if (fseek(f, container_end, SEEK_SET) != 0)
      throw CramError("seek past header container failed");
  }

  void close() {
    if (f) fclose(f);
    f = nullptr;
  }
};

// One decoded alignment record (only what the binner needs).
struct Rec {
  int32_t ref_id;
  int32_t pos;    // 0-based
  int32_t pnext;  // 0-based; -1 unknown
  uint32_t flag;
  uint32_t mapq;
};

void decode_slice(const CompressionHeader& ch, int32_t container_ref,
                  std::map<int32_t, Block>& blocks,
                  const std::vector<uint8_t>& slice_hdr_raw,
                  std::vector<Rec>& out) {
  Cursor sh{slice_hdr_raw.data(),
            slice_hdr_raw.data() + slice_hdr_raw.size()};
  int32_t ref_seq_id = sh.itf8();
  int32_t ref_start = sh.itf8();
  (void)sh.itf8();  // span
  int32_t n_records = sh.itf8();
  (void)sh.ltf8();  // record counter
  (void)sh.itf8();  // n blocks
  int32_t n_ids = sh.itf8();
  for (int32_t i = 0; i < n_ids; i++) (void)sh.itf8();
  (void)sh.itf8();  // embedded ref block id
  // md5 + optional tags ignored.

  const bool multiref = ref_seq_id == -2;
  (void)container_ref;

  const Encoding* eBF = ch.find("BF");
  const Encoding* eCF = ch.find("CF");
  const Encoding* eAP = ch.find("AP");
  const Encoding* eRI = ch.find("RI");
  const Encoding* eMQ = ch.find("MQ");
  const Encoding* eNF = ch.find("NF");
  const Encoding* eNP = ch.find("NP");
  if (!eBF || !eCF || !eAP)
    throw CramError("compression header lacks BF/CF/AP encodings");
  if (multiref && !eRI)
    throw CramError("multi-ref slice without RI encoding");

  SliceStreams ss;
  ss.blocks = &blocks;

  size_t base = out.size();
  out.resize(base + n_records);
  std::vector<int32_t> nf(n_records, -1);
  int64_t last_pos = ref_start;  // AP delta baseline (slice start)

  for (int32_t i = 0; i < n_records; i++) {
    Rec& r = out[base + i];
    r.flag = (uint32_t)ss.read_int(*eBF);
    uint32_t cf = (uint32_t)ss.read_int(*eCF);
    r.ref_id = multiref ? ss.read_int(*eRI) : ref_seq_id;
    int32_t ap = ss.read_int(*eAP);
    int64_t pos1 = ch.ap_delta ? (last_pos + ap) : ap;
    if (ch.ap_delta) last_pos = pos1;
    r.pos = (int32_t)(pos1 - 1);  // CRAM is 1-based
    r.pnext = -1;
    if (cf & 0x2) {  // detached: explicit mate position
      if (eNP) r.pnext = ss.read_int(*eNP) - 1;
    } else if (cf & 0x4) {  // mate downstream in this slice
      if (eNF) nf[i] = ss.read_int(*eNF);
    }
    r.mapq = 0;
    if (!(r.flag & 0x4) && eMQ) r.mapq = (uint32_t)ss.read_int(*eMQ);
  }
  // Resolve downstream mates (both directions, like htslib's pair fixup).
  for (int32_t i = 0; i < n_records; i++) {
    if (nf[i] < 0) continue;
    int64_t j = (int64_t)i + nf[i] + 1;
    if (j >= n_records) continue;
    out[base + i].pnext = out[base + j].pos;
    out[base + j].pnext = out[base + i].pos;
  }
}

}  // namespace

extern "C" {

enum {
  QC_MAPPED = 0,
  QC_UNMAPPED = 1,
  QC_NO_COORDINATE = 2,
  QC_FILTER_RMDUP = 3,
  QC_FILTER_MAPQ = 4,
  QC_PRE_RETRO = 5,
  QC_PAIR_FAIL = 6,
  QC_TOTAL = 7,
};

void* wcx_cram_open(const char* path) {
  auto* cram = new CramFile();
  cram->open(path);
  return cram;
}

const char* wcx_cram_error(void* handle) {
  return static_cast<CramFile*>(handle)->error.c_str();
}

int wcx_cram_nref(void* handle) {
  auto* cram = static_cast<CramFile*>(handle);
  return cram->error.empty() ? (int)cram->refs.size() : -1;
}

const char* wcx_cram_ref_name(void* handle, int i) {
  return static_cast<CramFile*>(handle)->refs[i].name.c_str();
}

int64_t wcx_cram_ref_len(void* handle, int i) {
  return static_cast<CramFile*>(handle)->refs[i].length;
}

int wcx_cram_count(void* handle, double binsize, int normdup,
                   const int32_t* slot_of_ref, int32_t** counts_ptrs,
                   const int64_t* counts_len, int64_t* qc_out) {
  auto* cram = static_cast<CramFile*>(handle);
  if (!cram->error.empty()) return -1;
  FILE* f = cram->f;
  const int n_ref = (int)cram->refs.size();

  int64_t larp = -1, larp2 = -1;
  int64_t qc[8] = {0};

  try {
    if (fseek(f, cram->data_start, SEEK_SET) != 0)
      throw CramError("seek failed");
    for (;;) {
      CramFile::ContainerHdr h;
      if (!cram->read_container_hdr(h)) break;
      if (h.ref_seq_id == -1 && h.n_records == 0 && h.n_blocks <= 1)
        break;  // EOF container
      long container_end = ftell(f) + h.length;

      // Block 1: compression header.
      Block chb = read_block(f);
      if (chb.content_type != 1)
        throw CramError("expected compression header block");
      CompressionHeader ch;
      ch.parse(chb.decode());

      std::vector<Rec> recs;
      while (ftell(f) < container_end) {
        Block sh = read_block(f);
        if (sh.content_type != 2 && sh.content_type != 3)
          throw CramError("expected slice header block");
        std::vector<uint8_t> sh_raw = sh.decode();
        // The slice's data blocks: core (type 5, keyed -1) + externals.
        Cursor c{sh_raw.data(), sh_raw.data() + sh_raw.size()};
        (void)c.itf8();  // ref id
        (void)c.itf8();  // start
        (void)c.itf8();  // span
        (void)c.itf8();  // n records
        (void)c.ltf8();  // counter
        int32_t n_blocks = c.itf8();
        std::map<int32_t, Block> blocks;
        for (int32_t i = 0; i < n_blocks; i++) {
          Block b = read_block(f);
          blocks[b.content_type == 5 ? -1 : b.content_id] = std::move(b);
        }
        decode_slice(ch, h.ref_seq_id, blocks, sh_raw, recs);
      }

      // Identical filter/bin semantics to bamreader.cpp.
      for (const Rec& r : recs) {
        qc[QC_TOTAL]++;
        if (r.flag & 0x4)
          qc[QC_UNMAPPED]++;
        else
          qc[QC_MAPPED]++;
        if (r.ref_id < 0 || r.pos < 0) qc[QC_NO_COORDINATE]++;
        if (r.ref_id < 0 || r.ref_id >= n_ref) continue;
        const int32_t slot = slot_of_ref[r.ref_id];
        if (slot < 0) continue;
        const bool paired = r.flag & 0x1;
        if (paired) {
          if (!(r.flag & 0x2)) {
            qc[QC_PAIR_FAIL]++;
            continue;
          }
          if (!normdup && larp == r.pos && larp2 == r.pnext) {
            qc[QC_FILTER_RMDUP]++;
          } else if (r.mapq >= 1) {
            const int64_t bin = (int64_t)(r.pos / binsize);
            if (bin >= 0 && bin < counts_len[slot]) counts_ptrs[slot][bin]++;
          } else {
            qc[QC_FILTER_MAPQ]++;
          }
          larp2 = r.pnext;
          qc[QC_PRE_RETRO]++;
          larp = r.pos;
        } else {
          if (!normdup && larp == r.pos) {
            qc[QC_FILTER_RMDUP]++;
          } else if (r.mapq >= 1) {
            const int64_t bin = (int64_t)(r.pos / binsize);
            if (bin >= 0 && bin < counts_len[slot]) counts_ptrs[slot][bin]++;
          } else {
            qc[QC_FILTER_MAPQ]++;
          }
          qc[QC_PRE_RETRO]++;
          larp = r.pos;
        }
      }
      if (fseek(f, container_end, SEEK_SET) != 0)
        throw CramError("container seek failed");
    }
  } catch (const std::exception& e) {
    cram->error = e.what();
    return -1;
  }
  memcpy(qc_out, qc, sizeof(qc));
  return 0;
}

void wcx_cram_close(void* handle) {
  auto* cram = static_cast<CramFile*>(handle);
  cram->close();
  delete cram;
}

// Test-only: decode one rANS-Nx16 stream directly (cross-language codec
// cross-check against the independent Python encoder in
// tests/cramtools.py).  Returns 0 on success, -1 on any decode error or
// output-length mismatch.
int wcx_rans_nx16_test(const uint8_t* in, int64_t n, uint8_t* out,
                       int64_t out_len) {
  try {
    std::vector<uint8_t> dec =
        rans_nx16_decode(in, (size_t)n, (size_t)out_len);
    if ((int64_t)dec.size() != out_len) return -1;
    memcpy(out, dec.data(), dec.size());
    return 0;
  } catch (const std::exception&) {
    return -1;
  }
}

}  // extern "C"
