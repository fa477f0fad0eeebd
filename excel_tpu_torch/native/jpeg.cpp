// Host JPEG decoder for the port's dataset readers (data/jpeg.py).
//
// It decodes what libjpeg-turbo decodes with its default parameters (the
// decode behind Pillow's Image.open(path).convert("RGB")), and gives the same
// bytes:
//   - baseline and extended-sequential Huffman (SOF0 / SOF1) and progressive
//     Huffman (SOF2: spectral selection and successive approximation), 8-bit
//     samples, 1 or 3 components, restart intervals;
//   - after the final scan every block is complete, so no block smoothing
//     (a progressive file whose scans leave coefficients 1-9 incomplete is
//     a variant it refuses);
//   - the ISLOW integer IDCT (13-bit constants, 2 extra bits in pass 1), its
//     output saturated to 0..255, as libjpeg-turbo's SIMD IDCT stores it;
//   - fancy upsampling: h2v1 (triangle filter, biases 1 / 2, >> 2), h2v2
//     (3:1 column sums, biases 8 / 7, >> 4), h1v2 (biases 1 / 2, >> 2), the
//     edge sample repeated at the left, right, top and bottom (the bottom
//     at the component's real height); box replication for other integral
//     factors and for h2v1 / h2v2 components at most 2 samples wide;
//   - YCbCr -> RGB through jdcolor.c's tables (16 fraction bits, rounding
//     by ONE_HALF), or RGB kept as it is (Adobe transform 0, or component
//     ids 'R', 'G', 'B' without JFIF / Adobe markers).
// Nothing is filled in: a truncated or corrupt stream is an error (the
// caller raises ValueError), where libjpeg would warn and decode zeros.
// The variants it does not take (Variant below) are told from the markers,
// by the same parser with the entropy-coded data skipped (the probe).
//
// C interface (ctypes; no global state, so threads may decode at once):
//   int excel_jpeg_probe(const uint8_t *data, int64_t size, int32_t *info,
//                        char *err, int err_len)
// walks the markers and writes info = {height, width, components,
// precision, variant} (variant 0: the decoder takes the file) and returns
// 0, or returns 1 with a message in err where they are malformed.
//   int excel_jpeg_decode(const uint8_t *data, int64_t size, uint8_t *out,
//                         int height, int width, int channels,
//                         char *err, int err_len)
// writes [height, width, channels] uint8 (channels 3: RGB; 1: grey) and
// returns 0, or returns 1 with a message in err.

#include <algorithm>
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

[[noreturn]] void fail(const std::string &msg) { throw Corrupt(msg); }

// What the decoder does not take, and the code the probe reports for it; a
// frame of another kind reports its SOF / DHP / EXP marker code (0xC3-0xCF,
// 0xDE, 0xDF: lossless, hierarchical, arithmetic-coded)
enum Variant {
  kTaken = 0,
  kPrecision = 1,   // other than 8-bit samples
  kComponents = 2,  // other than 1 or 3 components (CMYK / YCCK: 4)
  kDnl = 3,         // height 0: given by a DNL marker after the first scan
  kFractional = 4,  // a sampling factor that does not divide the largest
  kSmoothed = 5,    // progressive, coefficients 1-9 left incomplete
};
struct Unsupported {
  int variant;
};
[[noreturn]] void refuse(int variant) { throw Unsupported{variant}; }

// Pillow's DecompressionBombError bound (2 x Image.MAX_IMAGE_PIXELS): a
// header cannot make the decoder allocate more
constexpr int64_t kMaxPixels = 2 * (int64_t)89478485;
// libjpeg-turbo smooths a progressive file's blocks where one of their
// first SAVED_COEFS coefficients is incomplete (jdcoefct.c smoothing_ok)
constexpr int kSmoothedCoefs = 10;

// zigzag index -> natural index; 16 extra entries keep a corrupt run inside
// the block, as jpeg_natural_order does
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

struct Huffman {
  bool defined = false;
  int32_t maxcode[18];   // largest code of each length, -1 if none
  int32_t valoffset[18]; // value index = code + valoffset[length]
  uint8_t vals[256];
  uint8_t look_len[1 << kLookBits];  // 0: longer than kLookBits
  uint8_t look_val[1 << kLookBits];

  void build(const uint8_t *bits, const uint8_t *huffval, int nvals) {
    std::memcpy(vals, huffval, nvals);
    int code = 0, k = 0;
    int32_t sizes_code[256];
    uint8_t sizes[256];
    for (int l = 1; l <= 16; l++)
      for (int i = 0; i < bits[l]; i++) sizes[k++] = (uint8_t)l;
    k = 0;
    int si = nvals ? sizes[0] : 0;
    while (k < nvals) {
      while (k < nvals && sizes[k] == si) sizes_code[k++] = code++;
      if (code >= (1 << si)) fail("bad Huffman table");
      code <<= 1;
      si++;
    }
    k = 0;
    for (int l = 1; l <= 16; l++) {
      if (bits[l]) {
        valoffset[l] = k - sizes_code[k];
        k += bits[l];
        maxcode[l] = sizes_code[k - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    maxcode[17] = 0x7fffffff;
    std::memset(look_len, 0, sizeof(look_len));
    k = 0;
    for (int l = 1; l <= kLookBits; l++) {
      for (int i = 0; i < bits[l]; i++, k++) {
        int lookbits = sizes_code[k] << (kLookBits - l);
        for (int ctr = 1 << (kLookBits - l); ctr > 0; ctr--) {
          look_len[lookbits] = (uint8_t)l;
          look_val[lookbits] = huffval[k];
          lookbits++;
        }
      }
    }
    defined = true;
  }
};

// Entropy-coded bits: byte stuffing removed; at a marker or the end of the
// data zeros are fed, and consuming any of them is an error (checked at the
// end of each restart interval and scan).
struct BitReader {
  const uint8_t *p, *end;
  uint64_t buf = 0;
  int cnt = 0;            // valid bits, the low `cnt` bits of buf
  int64_t fed_zeros = 0;  // zero bits fed past the data
  bool stopped = false;   // at a marker (p points at its 0xFF) or the end

  void fill() {
    while (cnt <= 56) {
      uint32_t b = 0;
      if (!stopped) {
        if (p >= end) {
          stopped = true;
        } else if (*p == 0xFF) {
          if (p + 1 < end && p[1] == 0x00) {
            b = 0xFF;
            p += 2;
          } else {
            stopped = true;
          }
        } else {
          b = *p++;
        }
      }
      if (stopped) fed_zeros += 8;
      buf = (buf << 8) | b;
      cnt += 8;
    }
  }
  inline uint32_t peek(int n) {
    if (cnt < n) fill();
    return (uint32_t)(buf >> (cnt - n)) & ((1u << n) - 1);
  }
  inline uint32_t get(int n) {
    if (n == 0) return 0;
    uint32_t v = peek(n);
    cnt -= n;
    return v;
  }
  void check() const {
    if (fed_zeros > cnt) fail("premature end of entropy-coded data");
  }
  void reset() {
    buf = 0;
    cnt = 0;
    fed_zeros = 0;
    stopped = false;
  }
  inline int decode(const Huffman &h) {
    uint32_t look = peek(kLookBits);
    int l = h.look_len[look];
    if (l) {
      cnt -= l;
      return h.look_val[look];
    }
    l = kLookBits + 1;
    int32_t code = (int32_t)peek(l);
    while (code > h.maxcode[l]) {
      if (++l > 16) fail("corrupt Huffman code");
      code = (int32_t)peek(l);
    }
    cnt -= l;
    return h.vals[code + h.valoffset[l]];
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v + (-(1 << s) + 1) : v;
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int width = 0, height = 0;      // downsampled size in samples
  int bw = 0, bh = 0;             // blocks, padded to whole MCUs
  int real_bw = 0, real_bh = 0;   // blocks holding real samples
  int dc_tbl = 0, ac_tbl = 0;
  int pred = 0;
  bool latched = false;
  int coef_bits[64];              // progressive: Al of the last scan, -1
  int quant[64];                  // natural order
  std::vector<int16_t> coef;      // [bh][bw][64], natural order
  int16_t *block(int by, int bx) {
    return coef.data() + ((size_t)by * bw + bx) * 64;
  }
};

struct Decoder {
  const uint8_t *data;
  size_t size;
  bool probe_only = false;  // skip the entropy-coded data, allocate nothing
  size_t pos = 0;
  int width = 0, height = 0, ncomp = 0, precision = 0;
  bool progressive = false, have_frame = false;
  int max_h = 1, max_v = 1, mcux = 0, mcuy = 0;
  int restart_interval = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  std::vector<Component> comps;
  int quant[4][64];
  bool quant_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  int eobrun = 0;

  uint8_t byte() {
    if (pos >= size) fail("unexpected end of data");
    return data[pos++];
  }
  int u16() {
    int a = byte();
    return (a << 8) | byte();
  }

  int next_marker() {
    // skips anything before the next 0xFF xx (xx not 0x00), fill bytes too
    for (;;) {
      if (pos >= size) fail("unexpected end of data: no EOI marker");
      if (data[pos] != 0xFF) {
        pos++;
        continue;
      }
      while (pos < size && data[pos] == 0xFF) pos++;
      if (pos >= size) fail("unexpected end of data: no EOI marker");
      uint8_t m = data[pos++];
      if (m != 0x00) return m;
    }
  }

  void segment_bounds(size_t *seg_end) {
    int len = u16();
    if (len < 2 || pos - 2 + len > size) fail("bad marker length");
    *seg_end = pos - 2 + len;
  }

  void read_dqt() {
    size_t e;
    segment_bounds(&e);
    while (pos < e) {
      int pq_tq = byte();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) fail("bad DQT");
      for (int k = 0; k < 64; k++) {
        int q = pq ? u16() : byte();
        quant[tq][kNatural[k]] = q;
      }
      quant_defined[tq] = true;
    }
    if (pos != e) fail("bad DQT length");
  }

  void read_dht() {
    size_t e;
    segment_bounds(&e);
    while (pos < e) {
      int tc_th = byte();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail("bad DHT");
      uint8_t bits[17] = {0};
      int count = 0;
      for (int l = 1; l <= 16; l++) {
        bits[l] = byte();
        count += bits[l];
      }
      if (count > 256) fail("bad DHT");
      uint8_t vals[256];
      for (int i = 0; i < count; i++) vals[i] = byte();
      (tc ? ac[th] : dc[th]).build(bits, vals, count);
    }
    if (pos != e) fail("bad DHT length");
  }

  void read_sof(int marker) {
    if (have_frame) fail("more than one frame");
    size_t e;
    segment_bounds(&e);
    precision = byte();
    height = u16();
    width = u16();
    ncomp = byte();
    if (ncomp < 1) fail("no components");
    progressive = marker == 0xC2;
    comps.resize(ncomp);
    for (auto &c : comps) {
      c.id = byte();
      int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      std::fill(c.coef_bits, c.coef_bits + 64, -1);
    }
    if (pos != e) fail("bad SOF length");
    have_frame = true;
    if (precision != 8) refuse(kPrecision);
    if (ncomp != 1 && ncomp != 3) refuse(kComponents);
    if (height == 0) refuse(kDnl);
    if (width == 0) fail("empty image");
    for (auto &c : comps) {
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail("bad sampling factors or table");
      max_h = std::max(max_h, c.h);
      max_v = std::max(max_v, c.v);
    }
    for (auto &c : comps)
      if (max_h % c.h || max_v % c.v) refuse(kFractional);
    if ((int64_t)height * width > kMaxPixels)
      fail("JPEG of " + std::to_string(height) + " x " +
           std::to_string(width) + " pixels, more than " +
           std::to_string(kMaxPixels));
    mcux = (width + 8 * max_h - 1) / (8 * max_h);
    mcuy = (height + 8 * max_v - 1) / (8 * max_v);
    for (auto &c : comps) {
      c.width = (int)(((int64_t)width * c.h + max_h - 1) / max_h);
      c.height = (int)(((int64_t)height * c.v + max_v - 1) / max_v);
      c.real_bw = (c.width + 7) / 8;
      c.real_bh = (c.height + 7) / 8;
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      if (!probe_only) c.coef.assign((size_t)c.bw * c.bh * 64, 0);
    }
  }

  void read_app(int marker) {
    size_t e;
    segment_bounds(&e);
    size_t n = e - pos;
    const uint8_t *d = data + pos;
    if (marker == 0xE0 && n >= 14 && std::memcmp(d, "JFIF\0", 5) == 0)
      jfif = true;
    if (marker == 0xEE && n >= 12 && std::memcmp(d, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = d[11];
    }
    pos = e;
  }

  // ----------------------------------------------------------------------
  // scans
  // ----------------------------------------------------------------------

  struct Scan {
    int n = 0;
    Component *c[4];
    int ss = 0, se = 63, ah = 0, al = 0;
  };

  void decode_block_sequential(BitReader &br, Component &c, int16_t *blk) {
    const Huffman &dct = dc[c.dc_tbl], &act = ac[c.ac_tbl];
    int s = br.decode(dct);
    if (s) {
      if (s > 11) fail("bad DC coefficient size");
      s = extend((int)br.get(s), s);
    }
    c.pred += s;
    blk[0] = (int16_t)c.pred;
    for (int k = 1; k < 64; k++) {
      int rs = br.decode(act);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) fail("AC coefficient index beyond the block");
        blk[kNatural[k]] = (int16_t)extend((int)br.get(s), s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void decode_dc_first(BitReader &br, Component &c, int16_t *blk, int al) {
    int s = br.decode(dc[c.dc_tbl]);
    if (s) {
      if (s > 11) fail("bad DC coefficient size");
      s = extend((int)br.get(s), s);
    }
    c.pred += s;
    blk[0] = (int16_t)(int)((unsigned)c.pred << al);
  }

  void decode_dc_refine(BitReader &br, int16_t *blk, int al) {
    if (br.get(1)) blk[0] = (int16_t)(blk[0] | (1 << al));
  }

  void decode_ac_first(BitReader &br, Component &c, int16_t *blk,
                       const Scan &sc) {
    if (eobrun > 0) {
      eobrun--;
      return;
    }
    const Huffman &t = ac[c.ac_tbl];
    for (int k = sc.ss; k <= sc.se; k++) {
      int rs = br.decode(t);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) fail("AC coefficient index beyond the block");
        s = extend((int)br.get(s), s);
        blk[kNatural[k]] = (int16_t)(int)((unsigned)s << sc.al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += (int)br.get(r);
        eobrun--;
        break;
      }
    }
  }

  void decode_ac_refine(BitReader &br, Component &c, int16_t *blk,
                        const Scan &sc) {
    const int p1 = 1 << sc.al, m1 = -1 * (1 << sc.al);
    const Huffman &t = ac[c.ac_tbl];
    int k = sc.ss;
    if (eobrun == 0) {
      for (; k <= sc.se; k++) {
        int rs = br.decode(t);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += (int)br.get(r);
          break;
        }
        do {
          int16_t *coef = blk + kNatural[k];
          if (*coef != 0) {
            if (br.get(1) && (*coef & p1) == 0)
              *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
          } else {
            if (--r < 0) break;
          }
          k++;
        } while (k <= sc.se);
        if (s) blk[kNatural[k]] = (int16_t)s;
      }
    }
    if (eobrun > 0) {
      for (; k <= sc.se; k++) {
        int16_t *coef = blk + kNatural[k];
        if (*coef != 0 && br.get(1) && (*coef & p1) == 0)
          *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
      }
      eobrun--;
    }
  }

  void decode_block(BitReader &br, Component &c, int16_t *blk,
                    const Scan &sc) {
    if (!progressive) {
      decode_block_sequential(br, c, blk);
    } else if (sc.ss == 0) {
      if (sc.ah == 0) decode_dc_first(br, c, blk, sc.al);
      else decode_dc_refine(br, blk, sc.al);
    } else if (sc.ah == 0) {
      decode_ac_first(br, c, blk, sc);
    } else {
      decode_ac_refine(br, c, blk, sc);
    }
  }

  void restart(BitReader &br, int *expected) {
    br.check();
    br.cnt = 0;
    // the reader stopped at the marker or short of it (padding bits)
    pos = (size_t)(br.p - data);
    int m = next_marker();
    if (m != 0xD0 + *expected) fail("missing or out-of-order RST marker");
    *expected = (*expected + 1) & 7;
    br.p = data + pos;
    br.reset();
    for (auto &c : comps) c.pred = 0;
    eobrun = 0;
  }

  void read_sos() {
    if (!have_frame) fail("SOS before SOF");
    size_t e;
    segment_bounds(&e);
    Scan sc;
    sc.n = byte();
    if (sc.n < 1 || sc.n > 4 || sc.n > ncomp) fail("bad SOS");
    for (int i = 0; i < sc.n; i++) {
      int id = byte(), tbl = byte();
      Component *found = nullptr;
      for (auto &c : comps)
        if (c.id == id) found = &c;
      if (!found) fail("SOS names an unknown component");
      found->dc_tbl = tbl >> 4;
      found->ac_tbl = tbl & 15;
      if (found->dc_tbl > 3 || found->ac_tbl > 3) fail("bad SOS table");
      sc.c[i] = found;
    }
    sc.ss = byte();
    sc.se = byte();
    int a = byte();
    sc.ah = a >> 4;
    sc.al = a & 15;
    if (pos != e) fail("bad SOS length");
    if (progressive) {
      bool dc_scan = sc.ss == 0;
      if (dc_scan ? sc.se != 0 : (sc.se < sc.ss || sc.se > 63 || sc.n != 1))
        fail("bad progression parameters");
      if (sc.ah > 13 || sc.al > 13) fail("bad progression parameters");
    }
    for (int i = 0; i < sc.n; i++) {
      Component &c = *sc.c[i];
      if (!c.latched) {
        if (!quant_defined[c.tq]) fail("missing quantization table");
        std::memcpy(c.quant, quant[c.tq], sizeof(c.quant));
        c.latched = true;
      }
      bool need_dc = !progressive || (sc.ss == 0 && sc.ah == 0);
      bool need_ac = !progressive || sc.ss > 0;
      if (need_dc && !dc[c.dc_tbl].defined) fail("missing DC Huffman table");
      if (need_ac && !ac[c.ac_tbl].defined) fail("missing AC Huffman table");
      c.pred = 0;
      if (progressive)
        for (int k = sc.ss; k <= sc.se; k++) c.coef_bits[k] = sc.al;
    }
    eobrun = 0;
    if (probe_only) {
      skip_entropy_data();
      return;
    }

    BitReader br{data + pos, data + size};
    int next_rst = 0;
    int64_t mcus_done = 0;
    auto step = [&]() {
      mcus_done++;
      if (restart_interval && mcus_done % restart_interval == 0)
        return true;
      return false;
    };
    if (sc.n == 1) {
      Component &c = *sc.c[0];
      int64_t total = (int64_t)c.real_bw * c.real_bh;
      for (int by = 0; by < c.real_bh; by++)
        for (int bx = 0; bx < c.real_bw; bx++) {
          decode_block(br, c, c.block(by, bx), sc);
          if (step() && mcus_done < total) restart(br, &next_rst);
        }
    } else {
      int64_t total = (int64_t)mcux * mcuy;
      for (int my = 0; my < mcuy; my++)
        for (int mx = 0; mx < mcux; mx++) {
          for (int i = 0; i < sc.n; i++) {
            Component &c = *sc.c[i];
            for (int y = 0; y < c.v; y++)
              for (int x = 0; x < c.h; x++)
                decode_block(br, c, c.block(my * c.v + y, mx * c.h + x), sc);
          }
          if (step() && mcus_done < total) restart(br, &next_rst);
        }
    }
    br.check();
    pos = (size_t)(br.p - data);
  }

  // to the 0xFF of the first marker after the entropy-coded data (stuffed
  // zeros, fill bytes and RSTn belong to the data), or to the end
  void skip_entropy_data() {
    for (;;) {
      const void *ff = std::memchr(data + pos, 0xFF, size - pos);
      if (!ff) {
        pos = size;
        return;
      }
      pos = (size_t)((const uint8_t *)ff - data);
      if (pos + 1 >= size) return;
      uint8_t m = data[pos + 1];
      if (m == 0xFF) {
        pos += 1;
      } else if (m == 0x00 || (m >= 0xD0 && m <= 0xD7)) {
        pos += 2;
      } else {
        return;
      }
    }
  }

  // jdcoefct.c smoothing_ok: every component's DC at least partly known
  // and one of its first AC coefficients not complete
  bool would_smooth() const {
    if (!progressive) return false;
    for (auto &c : comps)
      if (c.coef_bits[0] < 0) return false;
    for (auto &c : comps)
      for (int k = 1; k < kSmoothedCoefs; k++)
        if (c.coef_bits[k] != 0) return true;
    return false;
  }

  void parse() {
    if (size < 2 || data[0] != 0xFF || data[1] != 0xD8) fail("not a JPEG");
    pos = 2;
    bool scanned = false;
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) break;                               // EOI
      if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
        read_sof(m);
      } else if ((m >= 0xC3 && m <= 0xCF && m != 0xC4 && m != 0xC8 &&
                  m != 0xCC) || m == 0xDE || m == 0xDF) {
        refuse(m);
      } else if (m == 0xC4) {
        read_dht();
      } else if (m == 0xDB) {
        read_dqt();
      } else if (m == 0xDD) {
        size_t e;
        segment_bounds(&e);
        restart_interval = u16();
        pos = e;
      } else if (m == 0xDA) {
        read_sos();
        scanned = true;
      } else if (m == 0xDC) {
        fail("DNL marker not taken");
      } else if (m >= 0xD0 && m <= 0xD7) {
        // a stray RST outside a scan: ignored, as libjpeg skips it
      } else if (m == 0x01 || m == 0xD8) {
        fail("unexpected marker");
      } else {
        read_app(m);                                   // APPn, COM, others
      }
    }
    if (!have_frame || !scanned) fail("no image data");
    if (would_smooth()) refuse(kSmoothed);
  }

  // ----------------------------------------------------------------------
  // samples
  // ----------------------------------------------------------------------

  static void idct_islow(const int16_t *in, const int *q, uint8_t *out,
                         int stride) {
    const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                  F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                  F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;
    const int CB = 13, P1 = 2;
    int ws[64];
    for (int c = 0; c < 8; c++) {
      const int16_t *i = in + c;
      const int *qq = q + c;
      int *w = ws + c;
      if (!i[8] && !i[16] && !i[24] && !i[32] && !i[40] && !i[48] &&
          !i[56]) {
        int dc = (i[0] * qq[0]) * (1 << P1);
        for (int r = 0; r < 8; r++) w[8 * r] = dc;
        continue;
      }
      int64_t z2 = i[16] * qq[16], z3 = i[48] * qq[48];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847;
      int64_t tmp3 = z1 + z2 * F0765;
      z2 = i[0] * qq[0];
      z3 = i[32] * qq[32];
      int64_t tmp0 = (z2 + z3) * (1 << CB);
      int64_t tmp1 = (z2 - z3) * (1 << CB);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = i[56] * qq[56];
      tmp1 = i[40] * qq[40];
      tmp2 = i[24] * qq[24];
      tmp3 = i[8] * qq[8];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int sh = CB - P1;
      const int64_t rnd = (int64_t)1 << (sh - 1);
      w[0] = (int)((tmp10 + tmp3 + rnd) >> sh);
      w[56] = (int)((tmp10 - tmp3 + rnd) >> sh);
      w[8] = (int)((tmp11 + tmp2 + rnd) >> sh);
      w[48] = (int)((tmp11 - tmp2 + rnd) >> sh);
      w[16] = (int)((tmp12 + tmp1 + rnd) >> sh);
      w[40] = (int)((tmp12 - tmp1 + rnd) >> sh);
      w[24] = (int)((tmp13 + tmp0 + rnd) >> sh);
      w[32] = (int)((tmp13 - tmp0 + rnd) >> sh);
    }
    auto lim = [](int64_t v) -> uint8_t {
      v += 128;
      return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
    };
    for (int r = 0; r < 8; r++) {
      const int *w = ws + 8 * r;
      uint8_t *o = out + (size_t)r * stride;
      const int sh2 = CB + P1 + 3;
      const int64_t rnd2 = (int64_t)1 << (sh2 - 1);
      if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
        uint8_t v = lim(((int64_t)w[0] + (1 << (P1 + 2))) >> (P1 + 3));
        for (int x = 0; x < 8; x++) o[x] = v;
        continue;
      }
      int64_t z2 = w[2], z3 = w[6];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847;
      int64_t tmp3 = z1 + z2 * F0765;
      int64_t tmp0 = ((int64_t)w[0] + w[4]) * (1 << CB);
      int64_t tmp1 = ((int64_t)w[0] - w[4]) * (1 << CB);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = w[7];
      tmp1 = w[5];
      tmp2 = w[3];
      tmp3 = w[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      o[0] = lim((tmp10 + tmp3 + rnd2) >> sh2);
      o[7] = lim((tmp10 - tmp3 + rnd2) >> sh2);
      o[1] = lim((tmp11 + tmp2 + rnd2) >> sh2);
      o[6] = lim((tmp11 - tmp2 + rnd2) >> sh2);
      o[2] = lim((tmp12 + tmp1 + rnd2) >> sh2);
      o[5] = lim((tmp12 - tmp1 + rnd2) >> sh2);
      o[3] = lim((tmp13 + tmp0 + rnd2) >> sh2);
      o[4] = lim((tmp13 - tmp0 + rnd2) >> sh2);
    }
  }

  // the component's samples [real_bh * 8][real_bw * 8]
  std::vector<uint8_t> samples(Component &c, int *stride) {
    *stride = c.real_bw * 8;
    std::vector<uint8_t> plane((size_t)c.real_bh * 8 * *stride);
    for (int by = 0; by < c.real_bh; by++)
      for (int bx = 0; bx < c.real_bw; bx++)
        idct_islow(c.block(by, bx), c.quant,
                   plane.data() + (size_t)by * 8 * *stride + bx * 8, *stride);
    return plane;
  }

  struct Plane {
    std::vector<uint8_t> px;
    int stride;
    const uint8_t *row(int y) const { return px.data() + (size_t)y * stride; }
  };

  // the component upsampled to full resolution, libjpeg-turbo's default
  // method for its factors: rows 0..height-1, columns 0..width-1 valid
  Plane upsample(Component &c) {
    int stride;
    std::vector<uint8_t> in = samples(c, &stride);
    const int rh = max_h / c.h, rv = max_v / c.v;
    const int cw = c.width, ch = c.height;
    if (rh == 1 && rv == 1) return {std::move(in), stride};
    Plane out{std::vector<uint8_t>((size_t)cw * rh * height), cw * rh};
    // rows beyond the component's real height repeat its last row, and
    // the row above the first is the first
    auto row = [&](int y) {
      y = y < 0 ? 0 : y >= ch ? ch - 1 : y;
      return in.data() + (size_t)y * stride;
    };
    if (rh == 2 && rv == 1 && cw > 2) {                      // h2v1 fancy
      for (int y = 0; y < height; y++) {
        const uint8_t *r = row(y);
        uint8_t *o = out.px.data() + (size_t)y * out.stride;
        o[0] = r[0];
        o[1] = (uint8_t)((r[0] * 3 + r[1] + 2) >> 2);
        for (int i = 1; i < cw - 1; i++) {
          int t = r[i] * 3;
          o[2 * i] = (uint8_t)((t + r[i - 1] + 1) >> 2);
          o[2 * i + 1] = (uint8_t)((t + r[i + 1] + 2) >> 2);
        }
        o[2 * cw - 2] = (uint8_t)((r[cw - 1] * 3 + r[cw - 2] + 1) >> 2);
        o[2 * cw - 1] = r[cw - 1];
      }
    } else if (rh == 1 && rv == 2) {                         // h1v2 fancy
      for (int y = 0; y < height; y++) {
        int i = y >> 1;
        const uint8_t *a = row(i), *b = row((y & 1) ? i + 1 : i - 1);
        int bias = (y & 1) ? 2 : 1;
        uint8_t *o = out.px.data() + (size_t)y * out.stride;
        for (int x = 0; x < cw; x++)
          o[x] = (uint8_t)((a[x] * 3 + b[x] + bias) >> 2);
      }
    } else if (rh == 2 && rv == 2 && cw > 2) {               // h2v2 fancy
      std::vector<int> sum((size_t)cw + 2);                  // [-1, cw]
      for (int y = 0; y < height; y++) {
        int i = y >> 1;
        const uint8_t *a = row(i), *b = row((y & 1) ? i + 1 : i - 1);
        for (int x = 0; x < cw; x++) sum[x + 1] = a[x] * 3 + b[x];
        sum[0] = sum[1];
        sum[cw + 1] = sum[cw];
        uint8_t *o = out.px.data() + (size_t)y * out.stride;
        for (int j = 0; j < cw; j++) {
          int t = sum[j + 1] * 3;
          o[2 * j] = (uint8_t)((t + sum[j] + 8) >> 4);
          o[2 * j + 1] = (uint8_t)((t + sum[j + 2] + 7) >> 4);
        }
      }
    } else {                                                 // box
      for (int y = 0; y < height; y++) {
        const uint8_t *r = in.data() + (size_t)(y / rv) * stride;
        uint8_t *o = out.px.data() + (size_t)y * out.stride;
        for (int x = 0; x < out.stride; x++) o[x] = r[x / rh];
      }
    }
    return out;
  }

  void output(uint8_t *out, int channels) {
    if (channels != ncomp) fail("channel count differs from the frame's");
    if (ncomp == 1) {
      Plane g = upsample(comps[0]);
      for (int y = 0; y < height; y++)
        std::memcpy(out + (size_t)y * width, g.row(y), width);
      return;
    }
    Plane p0 = upsample(comps[0]), p1 = upsample(comps[1]),
          p2 = upsample(comps[2]);
    bool rgb;
    if (jfif) rgb = false;
    else if (adobe) rgb = adobe_transform == 0;
    else rgb = comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B';
    if (rgb) {
      for (int y = 0; y < height; y++) {
        const uint8_t *r = p0.row(y), *g = p1.row(y), *b = p2.row(y);
        uint8_t *o = out + (size_t)y * width * 3;
        for (int x = 0; x < width; x++) {
          o[3 * x] = r[x];
          o[3 * x + 1] = g[x];
          o[3 * x + 2] = b[x];
        }
      }
      return;
    }
    // jdcolor.c build_ycc_rgb_table
    const int SB = 16;
    const int64_t HALF = (int64_t)1 << (SB - 1);
    auto fix = [](double x) { return (int64_t)(x * (1L << 16) + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0, x = -128; i < 256; i++, x++) {
      cr_r[i] = (int)((fix(1.40200) * x + HALF) >> SB);
      cb_b[i] = (int)((fix(1.77200) * x + HALF) >> SB);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + HALF;
    }
    auto lim = [](int v) -> uint8_t {
      return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
    };
    for (int y = 0; y < height; y++) {
      const uint8_t *py = p0.row(y), *pb = p1.row(y), *pr = p2.row(y);
      uint8_t *o = out + (size_t)y * width * 3;
      for (int x = 0; x < width; x++) {
        int l = py[x], cb = pb[x], cr = pr[x];
        o[3 * x] = lim(l + cr_r[cr]);
        o[3 * x + 1] = lim(l + (int)((cb_g[cb] + cr_g[cr]) >> SB));
        o[3 * x + 2] = lim(l + cb_b[cb]);
      }
    }
  }
};

}  // namespace

extern "C" int excel_jpeg_probe(const uint8_t *data, int64_t size,
                                int32_t *info, char *err, int err_len) {
  Decoder d;
  d.data = data;
  d.size = (size_t)size;
  d.probe_only = true;
  int variant = kTaken;
  try {
    d.parse();
  } catch (const Unsupported &u) {
    variant = u.variant;
  } catch (const std::exception &e) {
    std::snprintf(err, (size_t)err_len, "%s", e.what());
    return 1;
  }
  info[0] = d.height;
  info[1] = d.width;
  info[2] = d.ncomp;
  info[3] = d.precision;
  info[4] = variant;
  return 0;
}

extern "C" int excel_jpeg_decode(const uint8_t *data, int64_t size,
                                 uint8_t *out, int height, int width,
                                 int channels, char *err, int err_len) {
  try {
    Decoder d;
    d.data = data;
    d.size = (size_t)size;
    d.parse();
    if (d.height != height || d.width != width)
      fail("frame size differs from the header's");
    d.output(out, channels);
    return 0;
  } catch (const Unsupported &u) {
    std::snprintf(err, (size_t)err_len, "a variant it does not take (%d)",
                  u.variant);
    return 1;
  } catch (const std::exception &e) {
    std::snprintf(err, (size_t)err_len, "%s", e.what());
    return 1;
  }
}
