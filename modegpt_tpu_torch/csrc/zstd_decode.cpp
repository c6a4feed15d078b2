// A zstd frame decoder (RFC 8878) behind a plain C interface.
//
// Host code, built with the host C++ compiler by kernels/build.py and
// loaded with ctypes by compress/zstd.py. It reads what orbax's
// tensorstore writes (zarr chunks compressed with zstd, OCDBT manifests
// and B-tree nodes), which `zstandard`-style one-shot decoders refuse
// because those frames carry no content size.
//
// Covered: zstd and skippable frames back to back; frames with or
// without a content size, a window descriptor and a content checksum
// (XXH64, checked); raw, RLE and compressed blocks; raw, RLE, Huffman
// (1 or 4 streams, weights direct or FSE-coded) and treeless literals;
// sequences with predefined, RLE, FSE-coded and repeated tables, and the
// three repeat offsets. Dictionaries are refused.
//
// Every read of the input and every write of the output is bounds
// checked: corrupt input returns an error, never reads or writes out of
// bounds.

#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Corrupt : std::runtime_error {
  using std::runtime_error::runtime_error;
};
struct NoRoom : std::runtime_error {
  using std::runtime_error::runtime_error;
};

inline void need(bool ok, const char* what) {
  if (!ok) throw Corrupt(what);
}

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

inline uint64_t load_le(const uint8_t* p, size_t avail) {
  uint64_t v = 0;
  std::memcpy(&v, p, avail >= 8 ? 8 : avail);
  return v;  // the host is little-endian (x86-64, aarch64)
}

// ---------------------------------------------------------------- bits

// A backward bitstream (FSE and Huffman payloads): the last byte holds a
// marker bit above the data; bits are read from the top down. Reads
// below the start give zeros, which the format allows at stream ends;
// `overflowed` tells when that happened.
struct BackBits {
  const uint8_t* base = nullptr;
  size_t len = 0;
  int64_t pos = 0;  // bits not yet read

  void init(const uint8_t* p, size_t n) {
    need(n > 0, "empty bitstream");
    need(p[n - 1] != 0, "bitstream without end marker");
    base = p;
    len = n;
    pos = int64_t(n - 1) * 8 + highbit(p[n - 1]);
  }
  uint32_t get(int64_t start, int n) const {
    if (n == 0) return 0;
    if (start < 0) {
      int k = n + int(start);
      return k <= 0 ? 0 : get(0, k) << (-start);
    }
    size_t byte = size_t(start >> 3);
    uint64_t v = load_le(base + byte, len - byte) >> (start & 7);
    return uint32_t(v & ((uint64_t(1) << n) - 1));
  }
  uint32_t read(int n) {
    pos -= n;
    return get(pos, n);
  }
  uint32_t peek(int n) const { return get(pos - n, n); }
  void skip(int n) { pos -= n; }
  bool overflowed() const { return pos < 0; }
};

// A forward little-endian bitstream (FSE table descriptions).
struct FwdBits {
  const uint8_t* base;
  size_t len;
  size_t bit = 0;
  uint32_t peek(int n) const {
    size_t byte = bit >> 3;
    if (byte >= len) return 0;
    uint64_t v = load_le(base + byte, len - byte) >> (bit & 7);
    return uint32_t(v & ((uint64_t(1) << n) - 1));
  }
  void skip(int n) { bit += n; }
  size_t bytes() const { return (bit + 7) >> 3; }
};

// ----------------------------------------------------------------- FSE

struct FseEntry {
  uint16_t base;
  uint8_t bits;
  uint8_t symbol;
};

struct FseTable {
  int log = 0;
  std::vector<FseEntry> t;

  // Build the decoding table from normalised counts (RFC 8878 4.1.1).
  void build(const int16_t* norm, int n_symbols, int accuracy) {
    log = accuracy;
    const uint32_t size = 1u << accuracy;
    t.assign(size, FseEntry{0, 0, 0});
    std::vector<uint32_t> next(n_symbols);
    int64_t high = int64_t(size) - 1;
    for (int s = 0; s < n_symbols; ++s) {
      if (norm[s] == -1) {
        need(high >= 0, "FSE table overfull");
        t[high--].symbol = uint8_t(s);
        next[s] = 1;
      } else {
        next[s] = uint32_t(norm[s] < 0 ? 0 : norm[s]);
      }
    }
    const uint32_t step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
    uint32_t p = 0;
    for (int s = 0; s < n_symbols; ++s) {
      for (int i = 0; i < norm[s]; ++i) {
        t[p].symbol = uint8_t(s);
        do {
          p = (p + step) & mask;
        } while (int64_t(p) > high);
      }
    }
    need(p == 0, "FSE spread did not close");
    for (uint32_t u = 0; u < size; ++u) {
      uint32_t s = t[u].symbol;
      uint32_t x = next[s]++;
      need(x > 0, "FSE state of a zero-probability symbol");
      int bits = accuracy - highbit(x);
      t[u].bits = uint8_t(bits);
      t[u].base = uint16_t((x << bits) - size);
    }
  }
  void rle(uint8_t symbol) {
    log = 0;
    t.assign(1, FseEntry{0, 0, symbol});
  }
};

// Read an FSE table description (RFC 8878 4.1.1); returns bytes used.
size_t read_fse_description(const uint8_t* p, size_t n, int max_symbol, int max_log, FseTable& out) {
  need(n > 0, "truncated FSE description");
  FwdBits br{p, n};
  int accuracy = int(br.peek(4)) + 5;
  br.skip(4);
  need(accuracy <= max_log, "FSE accuracy above the limit");
  int16_t norm[256] = {0};
  int remaining = (1 << accuracy) + 1;
  int threshold = 1 << accuracy;
  int nbits = accuracy + 1;
  int symbol = 0;
  bool previous0 = false;
  while (remaining > 1 && symbol <= max_symbol) {
    if (previous0) {
      int n0 = symbol;
      uint32_t r;
      while ((r = br.peek(2)) == 3) {
        n0 += 3;
        br.skip(2);
        need(br.bytes() <= n, "truncated FSE description");
      }
      n0 += int(r);
      br.skip(2);
      need(n0 <= max_symbol + 1, "FSE zero run past the last symbol");
      while (symbol < n0) norm[symbol++] = 0;
      if (symbol > max_symbol) break;
    }
    int max = (2 * threshold - 1) - remaining;
    int count;
    uint32_t v = br.peek(nbits);
    if (int(v & uint32_t(threshold - 1)) < max) {
      count = int(v & uint32_t(threshold - 1));
      br.skip(nbits - 1);
    } else {
      count = int(v & uint32_t(2 * threshold - 1));
      if (count >= threshold) count -= max;
      br.skip(nbits);
    }
    count -= 1;
    remaining -= count < 0 ? -count : count;
    need(remaining >= 1, "FSE counts exceed the table size");
    norm[symbol++] = int16_t(count);
    previous0 = count == 0;
    while (remaining < threshold) {
      nbits -= 1;
      threshold >>= 1;
    }
    need(br.bytes() <= n, "truncated FSE description");
  }
  need(remaining == 1, "FSE counts do not sum to the table size");
  out.build(norm, symbol, accuracy);
  return br.bytes();
}

// ------------------------------------------------------------- Huffman

struct HufTable {
  int log = 0;  // 0: no table yet
  std::vector<uint16_t> t;  // symbol << 8 | bits
};

// Read a Huffman tree description (RFC 8878 4.2.1); returns bytes used.
size_t read_huffman(const uint8_t* p, size_t n, HufTable& out) {
  need(n > 0, "truncated Huffman description");
  uint8_t weights[256];
  int count = 0;
  size_t used;
  int h = p[0];
  if (h >= 128) {
    count = h - 127;
    used = 1 + size_t((count + 1) / 2);
    need(used <= n, "truncated Huffman weights");
    for (int i = 0; i < count; ++i) {
      uint8_t b = p[1 + i / 2];
      weights[i] = (i % 2 == 0) ? (b >> 4) : (b & 15);
    }
  } else {
    used = 1 + size_t(h);
    need(used <= n && h > 0, "truncated Huffman weights");
    FseTable ft;
    size_t d = read_fse_description(p + 1, size_t(h), 255, 6, ft);
    need(d < size_t(h), "Huffman weights without a bitstream");
    BackBits br;
    br.init(p + 1 + d, size_t(h) - d);
    uint32_t s1 = br.read(ft.log), s2 = br.read(ft.log);
    auto step = [&](uint32_t& s) {
      const FseEntry& e = ft.t[s];
      need(count < 255, "too many Huffman weights");
      weights[count++] = e.symbol;
      s = e.base + br.read(e.bits);
    };
    auto emit = [&](uint32_t s) {
      need(count < 255, "too many Huffman weights");
      weights[count++] = ft.t[s].symbol;
    };
    for (;;) {
      step(s1);
      if (br.overflowed()) {
        emit(s2);
        break;
      }
      step(s2);
      if (br.overflowed()) {
        emit(s1);
        break;
      }
    }
  }
  uint32_t total = 0;
  for (int i = 0; i < count; ++i) {
    need(weights[i] <= 12, "Huffman weight above 12");
    if (weights[i]) total += 1u << (weights[i] - 1);
  }
  need(total > 0, "Huffman weights all zero");
  int log = highbit(total) + 1;
  need(log <= 12, "Huffman code longer than 12 bits");
  uint32_t rest = (1u << log) - total;
  need((rest & (rest - 1)) == 0, "Huffman weights do not close the tree");
  need(count < 256, "too many Huffman symbols");
  weights[count++] = uint8_t(highbit(rest) + 1);

  uint32_t rank[14] = {0};
  for (int i = 0; i < count; ++i) rank[weights[i]]++;
  uint32_t start = 0;
  for (int w = 1; w <= log; ++w) {
    uint32_t cur = start;
    start += rank[w] << (w - 1);
    rank[w] = cur;
  }
  need(start == (1u << log), "Huffman ranks do not fill the table");
  out.log = log;
  out.t.assign(size_t(1) << log, 0);
  for (int s = 0; s < count; ++s) {
    int w = weights[s];
    if (!w) continue;
    uint32_t len = (1u << w) >> 1;
    uint16_t e = uint16_t((s << 8) | (log + 1 - w));
    for (uint32_t u = rank[w]; u < rank[w] + len; ++u) out.t[u] = e;
    rank[w] += len;
  }
  return used;
}

// Four codes at once: one 8-byte load holds at least 56 bits below pos,
// enough for four codes of at most 12 bits. Needs pos >= 64.
inline void huffman_four_codes(BackBits& br, const uint16_t* t, int log, uint64_t mask, uint8_t* out, size_t& i) {
  int64_t b = (br.pos >> 3) - 7;
  uint64_t c;
  std::memcpy(&c, br.base + b, 8);
  int avail = int(br.pos - 8 * b);
  for (int k = 0; k < 4; ++k) {
    uint16_t e = t[(c >> (avail - log)) & mask];
    out[i++] = uint8_t(e >> 8);
    avail -= e & 0xff;
  }
  br.pos = 8 * b + avail;
}

// Finish one stream from its i-th code; it must end exactly at its start.
void huffman_finish(BackBits& br, const HufTable& h, uint8_t* out, size_t i, size_t count) {
  const uint64_t mask = (uint64_t(1) << h.log) - 1;
  const uint16_t* t = h.t.data();
  while (i + 4 <= count && br.pos >= 64) huffman_four_codes(br, t, h.log, mask, out, i);
  for (; i < count; ++i) {
    uint16_t e = t[br.peek(h.log)];
    out[i] = uint8_t(e >> 8);
    br.skip(e & 0xff);
  }
  need(br.pos == 0, "Huffman stream not consumed exactly");
}

// The four streams of a literals section side by side: four independent
// chains of table lookups keep the core busy where one would stall.
void huffman_four_streams(const HufTable& h, const uint8_t* d, const size_t* sizes, uint8_t* out, size_t q,
                          size_t regen) {
  BackBits br[4];
  size_t count[4] = {q, q, q, regen - 3 * q}, i[4] = {0, 0, 0, 0};
  uint8_t* o[4] = {out, out + q, out + 2 * q, out + 3 * q};
  for (int k = 0; k < 4; ++k) {
    br[k].init(d, sizes[k]);
    d += sizes[k];
  }
  const uint64_t mask = (uint64_t(1) << h.log) - 1;
  const uint16_t* t = h.t.data();
  for (;;) {
    bool room = true;
    for (int k = 0; k < 4; ++k) room = room && br[k].pos >= 64 && i[k] + 4 <= count[k];
    if (!room) break;
    for (int k = 0; k < 4; ++k) huffman_four_codes(br[k], t, h.log, mask, o[k], i[k]);
  }
  for (int k = 0; k < 4; ++k) huffman_finish(br[k], h, o[k], i[k], count[k]);
}

// ----------------------------------------------------------- sequences

const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

const uint32_t kLLBase[36] = {0,  1,  2,  3,  4,  5,   6,   7,   8,    9,    10,   11,
                              12, 13, 14, 15, 16, 18,  20,  22,  24,   28,   32,   40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 12,  13,  14,  15,   16,
                              17, 18, 19, 20, 21, 22, 23, 24, 25, 26,  27,  28,  29,   30,
                              31, 32, 33, 34, 35, 37, 39, 41, 43, 47,  51,  59,  67,   83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

struct FrameState {
  HufTable huf;
  FseTable ll, of, ml;
  bool have_ll = false, have_of = false, have_ml = false;
  uint64_t rep[3] = {1, 4, 8};
  std::vector<uint8_t> lit;
};

// Set one sequence table from its mode; returns bytes used.
size_t sequence_table(int mode, const uint8_t* p, size_t n, const int16_t* dflt, int n_dflt, int dflt_log,
                      int max_symbol, int max_log, FseTable& t, bool& have) {
  switch (mode) {
    case 0:
      t.build(dflt, n_dflt, dflt_log);
      have = true;
      return 0;
    case 1:
      need(n >= 1, "truncated RLE sequence table");
      need(p[0] <= max_symbol, "RLE sequence symbol out of range");
      t.rle(p[0]);
      have = true;
      return 1;
    case 2: {
      size_t used = read_fse_description(p, n, max_symbol, max_log, t);
      have = true;
      return used;
    }
    default:
      need(have, "repeated sequence table before any table");
      return 0;
  }
}

// Literals section (RFC 8878 3.1.1.3.1); returns bytes used; fills st.lit.
size_t literals(const uint8_t* p, size_t n, FrameState& st) {
  need(n >= 1, "truncated literals header");
  int type = p[0] & 3, sf = (p[0] >> 2) & 3;
  if (type < 2) {
    size_t hsize, regen;
    if ((sf & 1) == 0) {
      hsize = 1;
      regen = p[0] >> 3;
    } else if (sf == 1) {
      need(n >= 2, "truncated literals header");
      hsize = 2;
      regen = (p[0] >> 4) + (size_t(p[1]) << 4);
    } else {
      need(n >= 3, "truncated literals header");
      hsize = 3;
      regen = (p[0] >> 4) + (size_t(p[1]) << 4) + (size_t(p[2]) << 12);
    }
    st.lit.resize(regen);
    if (type == 0) {
      need(n - hsize >= regen, "truncated raw literals");
      if (regen) std::memcpy(st.lit.data(), p + hsize, regen);
      return hsize + regen;
    }
    need(n - hsize >= 1, "truncated RLE literals");
    std::memset(st.lit.data(), p[hsize], regen);
    return hsize + 1;
  }
  size_t hsize = sf < 2 ? 3 : sf == 2 ? 4 : 5;
  int bits = sf < 2 ? 10 : sf == 2 ? 14 : 18;
  bool four = sf != 0;
  need(n >= hsize, "truncated literals header");
  uint64_t h = 0;
  for (size_t i = 0; i < hsize; ++i) h |= uint64_t(p[i]) << (8 * i);
  size_t regen = size_t((h >> 4) & ((1u << bits) - 1));
  size_t csize = size_t((h >> (4 + bits)) & ((1u << bits) - 1));
  need(n - hsize >= csize, "truncated compressed literals");
  const uint8_t* c = p + hsize;
  size_t used = 0;
  if (type == 2) {
    used = read_huffman(c, csize, st.huf);
  } else {
    need(st.huf.log > 0, "treeless literals before any Huffman table");
  }
  need(used <= csize, "Huffman description past the literals");
  c += used;
  size_t rest = csize - used;
  st.lit.resize(regen);
  if (!four) {
    BackBits br;
    br.init(c, rest);
    huffman_finish(br, st.huf, st.lit.data(), 0, regen);
  } else {
    need(rest >= 6, "truncated Huffman jump table");
    size_t sizes[4] = {c[0] | (size_t(c[1]) << 8), c[2] | (size_t(c[3]) << 8), c[4] | (size_t(c[5]) << 8), 0};
    need(sizes[0] + sizes[1] + sizes[2] <= rest - 6, "Huffman jump table past the literals");
    sizes[3] = rest - 6 - sizes[0] - sizes[1] - sizes[2];
    size_t q = (regen + 3) / 4;
    need(regen >= 3 * q, "too few literals for four streams");
    huffman_four_streams(st.huf, c + 6, sizes, st.lit.data(), q, regen);
  }
  return hsize + csize;
}

// Decode one compressed block into out[pos...]; returns the new pos.
// `frame_start` bounds back-references to this frame's output.
size_t compressed_block(const uint8_t* p, size_t n, FrameState& st, uint8_t* out, size_t cap, size_t pos,
                        size_t frame_start) {
  size_t used = literals(p, n, st);
  p += used;
  n -= used;
  need(n >= 1, "truncated sequences header");
  size_t nseq;
  size_t off = 0;
  if (p[0] < 128) {
    nseq = p[0];
    off = 1;
  } else if (p[0] < 255) {
    need(n >= 2, "truncated sequences header");
    nseq = (size_t(p[0] - 128) << 8) + p[1];
    off = 2;
  } else {
    need(n >= 3, "truncated sequences header");
    nseq = p[1] + (size_t(p[2]) << 8) + 0x7F00;
    off = 3;
  }
  const uint8_t* lit = st.lit.data();
  size_t lit_left = st.lit.size();
  if (nseq == 0) {
    if (lit_left > cap - pos) throw NoRoom("output buffer too small");
    if (lit_left) std::memcpy(out + pos, lit, lit_left);
    return pos + lit_left;
  }
  need(n > off, "truncated sequences header");
  uint8_t modes = p[off++];
  need((modes & 3) == 0, "reserved bits set in the sequence modes");
  off += sequence_table(modes >> 6, p + off, n - off, kLLDefault, 36, 6, 35, 9, st.ll, st.have_ll);
  off += sequence_table((modes >> 4) & 3, p + off, n - off, kOFDefault, 29, 5, 31, 8, st.of, st.have_of);
  off += sequence_table((modes >> 2) & 3, p + off, n - off, kMLDefault, 53, 6, 52, 9, st.ml, st.have_ml);
  need(off < n, "sequences without a bitstream");
  BackBits br;
  br.init(p + off, n - off);
  uint32_t sll = br.read(st.ll.log), sof = br.read(st.of.log), sml = br.read(st.ml.log);
  uint64_t* rep = st.rep;
  for (size_t i = 0; i < nseq; ++i) {
    const FseEntry& ell = st.ll.t[sll];
    const FseEntry& eof = st.of.t[sof];
    const FseEntry& eml = st.ml.t[sml];
    int llc = ell.symbol, ofc = eof.symbol, mlc = eml.symbol;
    need(llc <= 35 && mlc <= 52 && ofc <= 31, "sequence code out of range");
    uint64_t ofv = (uint64_t(1) << ofc) + br.read(ofc);
    uint64_t ml = kMLBase[mlc] + br.read(kMLBits[mlc]);
    uint64_t ll = kLLBase[llc] + br.read(kLLBits[llc]);
    uint64_t offset;
    if (ofv > 3) {
      offset = ofv - 3;
      rep[2] = rep[1];
      rep[1] = rep[0];
      rep[0] = offset;
    } else {
      int idx = int(ofv) - 1 + (ll == 0 ? 1 : 0);
      if (idx == 0) {
        offset = rep[0];
      } else {
        offset = idx == 3 ? rep[0] - 1 : rep[idx];
        if (idx != 1) rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = offset;
      }
    }
    if (i + 1 < nseq) {
      sll = ell.base + br.read(ell.bits);
      sml = eml.base + br.read(eml.bits);
      sof = eof.base + br.read(eof.bits);
    }
    need(ll <= lit_left, "sequence takes more literals than the block has");
    if (ll + ml > cap - pos) throw NoRoom("output buffer too small");
    if (ll) std::memcpy(out + pos, lit, ll);
    lit += ll;
    lit_left -= ll;
    pos += ll;
    need(offset > 0 && offset <= pos - frame_start, "match offset before the frame's start");
    uint8_t* dst = out + pos;
    const uint8_t* src = dst - offset;
    if (offset >= ml) {
      std::memcpy(dst, src, ml);
    } else {
      for (uint64_t k = 0; k < ml; ++k) dst[k] = src[k];
    }
    pos += ml;
  }
  need(br.pos == 0, "sequence bitstream not consumed exactly");
  if (lit_left > cap - pos) throw NoRoom("output buffer too small");
  if (lit_left) std::memcpy(out + pos, lit, lit_left);
  return pos + lit_left;
}

// --------------------------------------------------------------- XXH64

const uint64_t P1 = 0x9E3779B185EBCA87ULL, P2 = 0xC2B2AE3D27D4EB4FULL, P3 = 0x165667B19E3779F9ULL,
               P4 = 0x85EBCA77C2B2AE63ULL, P5 = 0x27D4EB2F165667C5ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t round64(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }
inline uint64_t merge64(uint64_t acc, uint64_t v) { return (acc ^ round64(0, v)) * P1 + P4; }

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    while (end - p >= 32) {
      v1 = round64(v1, load_le(p, 8));
      v2 = round64(v2, load_le(p + 8, 8));
      v3 = round64(v3, load_le(p + 16, 8));
      v4 = round64(v4, load_le(p + 24, 8));
      p += 32;
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = merge64(h, v1);
    h = merge64(h, v2);
    h = merge64(h, v3);
    h = merge64(h, v4);
  } else {
    h = P5;
  }
  h += uint64_t(n);
  while (end - p >= 8) {
    h ^= round64(0, load_le(p, 8));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (end - p >= 4) {
    uint32_t w;
    std::memcpy(&w, p, 4);
    h ^= uint64_t(w) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= uint64_t(*p++) * P5;
    h = rotl(h, 11) * P1;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// --------------------------------------------------------------- frames

size_t decode_frames(const uint8_t* src, size_t n, uint8_t* out, size_t cap) {
  size_t i = 0, pos = 0;
  need(n > 0, "empty input");
  while (i < n) {
    need(n - i >= 4, "truncated frame magic");
    uint32_t magic = uint32_t(load_le(src + i, 4));
    i += 4;
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      need(n - i >= 4, "truncated skippable frame");
      uint32_t size = uint32_t(load_le(src + i, 4));
      i += 4;
      need(n - i >= size, "truncated skippable frame");
      i += size;
      continue;
    }
    need(magic == 0xFD2FB528u, "not a zstd frame");
    need(i < n, "truncated frame header");
    uint8_t fhd = src[i++];
    int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1, dict_flag = fhd & 3;
    need(((fhd >> 3) & 1) == 0, "reserved frame header bit set");
    if (!single) {
      need(i < n, "truncated window descriptor");
      ++i;
    }
    static const int dict_bytes[4] = {0, 1, 2, 4};
    need(n - i >= size_t(dict_bytes[dict_flag]), "truncated dictionary id");
    uint64_t dict = load_le(src + i, size_t(dict_bytes[dict_flag])) &
                    (dict_flag == 3 ? 0xFFFFFFFFull : (uint64_t(1) << (8 * dict_bytes[dict_flag])) - 1);
    i += size_t(dict_bytes[dict_flag]);
    need(dict == 0, "frames that need a dictionary are not supported");
    static const int fcs_bytes[4] = {0, 2, 4, 8};
    int fb = fcs_flag == 0 ? (single ? 1 : 0) : fcs_bytes[fcs_flag];
    bool has_size = fb > 0;
    uint64_t content = 0;
    if (fb) {
      need(n - i >= size_t(fb), "truncated content size");
      content = fb == 8 ? load_le(src + i, 8) : load_le(src + i, size_t(fb)) & ((uint64_t(1) << (8 * fb)) - 1);
      if (fb == 2) content += 256;
      i += size_t(fb);
    }
    size_t start = pos;
    FrameState st;
    for (;;) {
      need(n - i >= 3, "truncated block header");
      uint32_t bh = uint32_t(load_le(src + i, 3)) & 0xFFFFFF;
      i += 3;
      int last = bh & 1, type = (bh >> 1) & 3;
      size_t size = bh >> 3;
      need(type != 3, "reserved block type");
      if (type == 0) {
        need(n - i >= size, "truncated raw block");
        if (size > cap - pos) throw NoRoom("output buffer too small");
        if (size) std::memcpy(out + pos, src + i, size);
        pos += size;
        i += size;
      } else if (type == 1) {
        need(n - i >= 1, "truncated RLE block");
        if (size > cap - pos) throw NoRoom("output buffer too small");
        std::memset(out + pos, src[i], size);
        pos += size;
        i += 1;
      } else {
        need(n - i >= size, "truncated compressed block");
        need(size <= (128u << 10), "compressed block above 128 KiB");
        pos = compressed_block(src + i, size, st, out, cap, pos, start);
        i += size;
      }
      if (last) break;
    }
    if (has_size) need(pos - start == content, "frame content size does not match");
    if (checksum) {
      need(n - i >= 4, "truncated content checksum");
      uint32_t want = uint32_t(load_le(src + i, 4));
      i += 4;
      need(uint32_t(xxh64(out + start, pos - start)) == want, "content checksum mismatch");
    }
  }
  return pos;
}

void set_error(char* err, uint64_t err_cap, const char* what) {
  if (err && err_cap) std::snprintf(err, size_t(err_cap), "%s", what);
}

}  // namespace

extern "C" {

// Decode every frame of src[0, src_len) into dst[0, dst_cap). Returns the
// bytes written; -1 for corrupt or unsupported input, -2 when dst_cap is
// too small, with a message in err.
int64_t modegpt_zstd_decompress(const uint8_t* src, uint64_t src_len, uint8_t* dst, uint64_t dst_cap, char* err,
                                uint64_t err_cap) {
  try {
    return int64_t(decode_frames(src, size_t(src_len), dst, size_t(dst_cap)));
  } catch (const NoRoom& e) {
    set_error(err, err_cap, e.what());
    return -2;
  } catch (const std::exception& e) {
    set_error(err, err_cap, e.what());
    return -1;
  }
}

// XXH64 with seed 0, exposed for the tests.
uint64_t modegpt_xxh64(const uint8_t* p, uint64_t n) { return xxh64(p, size_t(n)); }
}
