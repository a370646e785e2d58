// JPEG decoding and the two uint8 resizes of the visual pipeline, on the
// host, with the arithmetic of the libraries the reference calls.
//
// The decoder reproduces libjpeg-turbo's default decompression (what
// Pillow's Image.open(...).convert("RGB") and OpenCV's imread give):
// baseline, extended sequential and progressive Huffman JPEGs with 8-bit
// samples and 1 or 3 components; dequantisation and jidctint.c's
// jpeg_idct_islow (CONST_BITS 13, PASS1_BITS 2, its wrapping range limit);
// jdsample.c's fancy upsampling for h2v1, h1v2 and h2v2 (triangle filter,
// alternating biases, replicated edges) and plain replication for the other
// integral ratios; jdcolor.c's fixed-point YCbCr -> RGB tables (SCALEBITS
// 16). The colour space is chosen as jdapimin.c chooses it. The Exif
// Orientation of the first APP1 segment is read as OpenCV reads it and is
// applied on request as imread applies it.
//
// What libjpeg-turbo would only warn about (a bad Huffman code, a bogus
// progression, data before a marker, a truncated scan) is refused here, as
// is what it does not decode to 8-bit RGB (lossless, hierarchical and
// arithmetic-coded frames, 12/16-bit samples, 2 or 4 components): every
// refusal names the marker or the byte offset.
//
// The resizes: Pillow's Image.resize(..., BILINEAR) on 8-bit RGB
// (Resample.c: two passes, horizontal first, 22-bit fixed-point taps) and
// OpenCV's cv::resize(..., fx, fy, INTER_LINEAR) on CV_8UC3 (11-bit taps,
// horizontal sums in int32, the vertical pass as its SIMD lanes compute it;
// fx == fy == 0.5 goes to INTER_AREA's 2x2 average, as OpenCV routes it).
//
// Built with g++ into tim_tpu_torch/build/ by tim_tpu_torch/utils/jpeg.py;
// a plain C interface for ctypes.

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct JpegError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

std::string hex2(int v) {
  char b[8];
  snprintf(b, sizeof b, "%02X", v & 0xFF);
  return b;
}

[[noreturn]] void fail(const std::string& what, size_t offset) {
  throw JpegError(what + " at byte offset " + std::to_string(offset));
}

const int kNaturalOrder[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// ---------------------------------------------------------------------------
// Huffman tables (jdhuff.c's derived tables; a 9-bit lookahead)
// ---------------------------------------------------------------------------

constexpr int kLookBits = 9;

struct Huffman {
  bool defined = false;
  uint8_t vals[256];
  int32_t maxcode[18];   // largest code of each length, -1 if none
  int32_t valoffset[17];
  uint16_t look[1 << kLookBits];  // (length << 8) | symbol, 0 if longer
};

void build_huffman(Huffman& h, const uint8_t counts[17], const uint8_t* vals,
                   int nvals, bool is_dc, size_t offset) {
  int huffsize[257], huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; l++)
    for (int i = 0; i < counts[l]; i++) huffsize[p++] = l;
  huffsize[p] = 0;
  int code = 0, si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    if (code >= (1 << si)) fail("DHT: bad Huffman table (code overflow)", offset);
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (counts[l]) {
      h.valoffset[l] = p - huffcode[p];
      p += counts[l];
      h.maxcode[l] = huffcode[p - 1];
    } else {
      h.maxcode[l] = -1;
    }
  }
  h.valoffset[0] = 0;
  h.maxcode[0] = -1;
  h.maxcode[17] = 0x7FFFFFFF;
  memcpy(h.vals, vals, nvals);
  memset(h.look, 0, sizeof h.look);
  p = 0;
  for (int l = 1; l <= kLookBits; l++) {
    for (int i = 0; i < counts[l]; i++, p++) {
      int lookbits = huffcode[p] << (kLookBits - l);
      for (int c = 1 << (kLookBits - l); c > 0; c--)
        h.look[lookbits++] = static_cast<uint16_t>((l << 8) | vals[p]);
    }
  }
  if (is_dc)
    for (int i = 0; i < nvals; i++)
      if (vals[i] > 15) fail("DHT: DC symbol above 15", offset);
  h.defined = true;
}

// ---------------------------------------------------------------------------
// Entropy-coded segment reader
// ---------------------------------------------------------------------------

struct BitReader {
  const uint8_t* d = nullptr;
  size_t n = 0;
  size_t pos = 0;        // next byte not yet in the buffer
  uint64_t buf = 0;      // bits left-aligned
  int cnt = 0;           // bits in buf
  int phantom = 0;       // zero bits appended past the segment's end
  bool ended = false;    // a marker (or the end of the file) was reached
  size_t end_pos = 0;    // where: the marker's 0xFF, or n

  void start(const uint8_t* data, size_t size, size_t at) {
    d = data;
    n = size;
    pos = at;
    buf = 0;
    cnt = 0;
    phantom = 0;
    ended = false;
    end_pos = 0;
  }

  void fill() {
    while (cnt <= 56) {
      uint64_t b = 0;
      if (ended) {
        phantom += 8;
      } else if (pos >= n) {
        ended = true;
        end_pos = n;
        phantom += 8;
      } else if (d[pos] != 0xFF) {
        b = d[pos++];
      } else {
        size_t p = pos + 1;
        while (p < n && d[p] == 0xFF) p++;
        if (p < n && d[p] == 0) {
          b = 0xFF;
          pos = p + 1;
        } else {
          ended = true;
          end_pos = pos;
          phantom += 8;
        }
      }
      buf |= b << (56 - cnt);
      cnt += 8;
    }
  }

  int peek(int nbits) {
    if (cnt < nbits) fill();
    return static_cast<int>(buf >> (64 - nbits));
  }

  void skip(int nbits) {
    buf <<= nbits;
    cnt -= nbits;
  }

  int get(int nbits) {
    if (nbits == 0) return 0;
    int v = peek(nbits);
    skip(nbits);
    return v;
  }

  // Data ran out inside the scan: the decoder took bits past the marker.
  void check(size_t scan_offset) {
    if (cnt < phantom) {
      if (end_pos >= n)
        fail("file truncated inside the scan starting", scan_offset);
      fail("entropy-coded data ends early (marker FF" + hex2(d[end_pos + 1]) +
               " reached inside the scan starting at byte offset " +
               std::to_string(scan_offset) + ")",
           end_pos);
    }
  }

  int decode(const Huffman& h) {
    int look = peek(kLookBits);
    uint16_t e = h.look[look];
    if (e) {
      skip(e >> 8);
      return e & 0xFF;
    }
    int code = peek(16);
    for (int l = kLookBits + 1; l <= 16; l++) {
      int c = code >> (16 - l);
      if (c <= h.maxcode[l]) {
        skip(l);
        return h.vals[c + h.valoffset[l]];
      }
    }
    return -1;
  }

  // After an interval's last MCU: only the padding of the current byte may
  // remain before the marker. Returns the marker's offset.
  size_t finish(size_t scan_offset) {
    check(scan_offset);
    int real = cnt - phantom;
    if (!ended) {
      // bytes still unread past the buffer must begin with a marker
      while (!ended && real < 8 + 8) {
        fill();
        real = cnt - phantom;
      }
    }
    if (real >= 8)
      fail(std::to_string(real / 8) +
               " extraneous byte(s) of entropy-coded data before the marker",
           ended ? end_pos : pos);
    if (end_pos >= n) fail("file truncated: no marker after the scan", n);
    return end_pos;
  }
};

// ---------------------------------------------------------------------------
// The decoder
// ---------------------------------------------------------------------------

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int dw = 0, dh = 0;                    // downsampled size
  int wblocks = 0, hblocks = 0;          // blocks holding samples
  int bw = 0, bh = 0;                    // blocks allocated (MCU multiple)
  bool quant_latched = false;
  uint16_t quant[64];                    // natural order
  int coef_bits[64];                     // progressive: -1 none yet
  int16_t* coef = nullptr;               // bh * bw * 64, natural order
  uint8_t* plane = nullptr;              // (hblocks * 8) x (bw * 8)
  int pred = 0;
};

// The buffers of one decode, kept across the frames of one call:
// allocating them afresh for each frame maps and unmaps pages every time.
struct Workspace {
  std::vector<int16_t> coef[4];
  std::vector<uint8_t> plane[4];
  std::vector<uint8_t> img, row, r0, r1, r2, file;
};

enum ColorSpace { kGray, kYCbCr, kRGB };

// jdcolor.c build_ycc_rgb_table (SCALEBITS 16)
struct ColorTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
};

ColorTables make_color_tables() {
  ColorTables t;
  const int64_t half = int64_t(1) << 15;
  auto fix = [](double x) { return static_cast<int64_t>(x * 65536.0 + 0.5); };
  for (int i = 0; i < 256; i++) {
    int64_t x = i - 128;
    t.cr_r[i] = static_cast<int>((fix(1.40200) * x + half) >> 16);
    t.cb_b[i] = static_cast<int>((fix(1.77200) * x + half) >> 16);
    t.cr_g[i] = -fix(0.71414) * x;
    t.cb_g[i] = -fix(0.34414) * x + half;
  }
  return t;
}

struct Decoder {
  const uint8_t* d;
  size_t n;
  bool apply_orientation;
  Workspace* ws;                 // null: the header only, no buffers

  uint16_t qt[4][64];
  bool qt_set[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  int restart_interval = 0;
  bool saw_jfif = false, saw_adobe = false, saw_app1 = false;
  int adobe_transform = 0;
  int orientation = 1;

  bool have_frame = false, progressive = false;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  int mcux = 0, mcuy = 0;
  Component comp[4];
  int scans = 0;

  BitReader br;
  int eobrun = 0;

  Decoder(const uint8_t* data, size_t size, bool orient, Workspace* work)
      : d(data), n(size), apply_orientation(orient), ws(work) {}

  int u16(size_t at) const {
    if (at + 2 > n) fail("file truncated", n);
    return (d[at] << 8) | d[at + 1];
  }

  // --- markers -------------------------------------------------------------

  void read_dqt(size_t at, size_t len) {
    size_t p = at + 4, end = at + 2 + len;
    while (p < end) {
      int pq = d[p] >> 4, tq = d[p] & 15;
      if (pq > 1 || tq > 3) fail("DQT: bad table " + std::to_string(d[p]), p);
      p++;
      size_t need = pq ? 128 : 64;
      if (p + need > end) fail("DQT: segment too short", p);
      for (int k = 0; k < 64; k++) {
        int v = pq ? (d[p + 2 * k] << 8) | d[p + 2 * k + 1] : d[p + k];
        qt[tq][kNaturalOrder[k]] = static_cast<uint16_t>(v);
      }
      qt_set[tq] = true;
      p += need;
    }
  }

  void read_dht(size_t at, size_t len) {
    size_t p = at + 4, end = at + 2 + len;
    while (p < end) {
      if (p + 17 > end) fail("DHT: segment too short", p);
      int tc = d[p] >> 4, th = d[p] & 15;
      if (tc > 1 || th > 3) fail("DHT: bad table " + std::to_string(d[p]), p);
      uint8_t counts[17] = {0};
      int total = 0;
      for (int l = 1; l <= 16; l++) total += counts[l] = d[p + l];
      if (total > 256 || p + 17 + total > end)
        fail("DHT: bad Huffman table (symbol count)", p);
      build_huffman(tc ? ac[th] : dc[th], counts, d + p + 17, total, tc == 0,
                    p);
      p += 17 + total;
    }
  }

  void read_app(int marker, size_t at, size_t len) {
    const uint8_t* s = d + at + 4;
    size_t dl = len - 2;
    if (marker == 0xE0 && dl >= 14 && !memcmp(s, "JFIF\0", 5)) saw_jfif = true;
    if (marker == 0xEE && dl >= 12 && !memcmp(s, "Adobe", 5)) {
      saw_adobe = true;
      adobe_transform = s[11];
    }
    if (marker == 0xE1 && !saw_app1) {
      saw_app1 = true;      // OpenCV reads the first APP1 only
      if (dl > 6) orientation = exif_orientation(s + 6, dl - 6);
    }
  }

  // OpenCV's ExifReader: a TIFF header, IFD0, tag 0x0112's first 16 bits.
  static int exif_orientation(const uint8_t* t, size_t size) {
    if (size < 8) return 1;
    bool le;
    if (t[0] == 'I' && t[1] == 'I') le = true;
    else if (t[0] == 'M' && t[1] == 'M') le = false;
    else return 1;
    auto g16 = [&](size_t o) -> int {
      return le ? t[o] | (t[o + 1] << 8) : (t[o] << 8) | t[o + 1];
    };
    auto g32 = [&](size_t o) -> uint32_t {
      return le ? t[o] | (t[o + 1] << 8) | (t[o + 2] << 16) |
                      (static_cast<uint32_t>(t[o + 3]) << 24)
                : (static_cast<uint32_t>(t[o]) << 24) | (t[o + 1] << 16) |
                      (t[o + 2] << 8) | t[o + 3];
    };
    if (g16(2) != 0x2A) return 1;
    uint32_t ifd = g32(4);
    if (static_cast<size_t>(ifd) + 2 > size) return 1;
    int entries = g16(ifd);
    for (int i = 0; i < entries; i++) {
      size_t e = ifd + 2 + 12 * static_cast<size_t>(i);
      if (e + 12 > size) return 1;
      if (g16(e) == 0x0112) return g16(e + 8);
    }
    return 1;
  }

  void read_sof(int marker, size_t at, size_t len) {
    if (have_frame) fail("a second SOF marker", at);
    size_t p = at + 4;
    if (len < 8) fail("SOF: segment too short", at);
    int precision = d[p];
    if (precision != 8)
      fail("SOF" + std::to_string(marker - 0xC0) + ": " +
               std::to_string(precision) +
               "-bit samples are not decoded (8-bit only)",
           p);
    height = u16(p + 1);
    width = u16(p + 3);
    ncomp = d[p + 5];
    if (height == 0)
      fail("SOF: height 0 (a DNL marker's height is not supported)", p + 1);
    if (width == 0) fail("SOF: width 0", p + 3);
    if (ncomp == 2 || ncomp == 4 || ncomp == 0 || ncomp > 4)
      fail("SOF: " + std::to_string(ncomp) +
               " components are not decoded (1 or 3: grayscale or colour; "
               "CMYK and YCCK are not)",
           p + 5);
    if (len != 8 + 3 * static_cast<size_t>(ncomp))
      fail("SOF: bad segment length", at);
    hmax = vmax = 1;
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      const uint8_t* q = d + p + 6 + 3 * i;
      c.id = q[0];
      c.h = q[1] >> 4;
      c.v = q[1] & 15;
      c.tq = q[2];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4)
        fail("SOF: bad sampling factors", p + 7 + 3 * i);
      if (c.tq > 3) fail("SOF: bad quantisation table", p + 8 + 3 * i);
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      if (hmax % c.h || vmax % c.v)
        fail("SOF: fractional sampling ratios are not supported", at);
      c.dw = static_cast<int>((static_cast<int64_t>(width) * c.h + hmax - 1) /
                              hmax);
      c.dh = static_cast<int>((static_cast<int64_t>(height) * c.v + vmax - 1) /
                              vmax);
      c.wblocks = (c.dw + 7) / 8;
      c.hblocks = (c.dh + 7) / 8;
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      if (ws) {
        ws->coef[i].assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
        c.coef = ws->coef[i].data();
      }
      for (int k = 0; k < 64; k++) c.coef_bits[k] = -1;
    }
    progressive = marker == 0xC2;
    have_frame = true;
  }

  // --- scans ---------------------------------------------------------------

  int16_t* block(Component& c, int bx, int by) {
    return c.coef + (static_cast<size_t>(by) * c.bw + bx) * 64;
  }

  int extend(int v, int s) {
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
  }

  int huff(const Huffman& h, size_t scan_at) {
    int s = br.decode(h);
    if (s < 0) fail("bad Huffman code in the scan starting", scan_at);
    return s;
  }

  void decode_sequential(Component& c, int16_t* blk, size_t at) {
    int s = huff(dc[c.td], at);
    if (s) s = extend(br.get(s), s);
    c.pred += s;
    blk[0] = static_cast<int16_t>(c.pred);
    const Huffman& t = ac[c.ta];
    for (int k = 1; k < 64; k++) {
      int rs = huff(t, at);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) fail("AC coefficient index past 63 in the scan starting", at);
        blk[kNaturalOrder[k]] = static_cast<int16_t>(extend(br.get(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void decode_dc_first(Component& c, int16_t* blk, int al, size_t at) {
    int s = huff(dc[c.td], at);
    if (s) s = extend(br.get(s), s);
    c.pred += s;
    blk[0] = static_cast<int16_t>(static_cast<uint32_t>(c.pred) << al);
  }

  void decode_ac_first(const Huffman& t, int16_t* blk, int ss, int se, int al,
                       size_t at) {
    if (eobrun > 0) {
      eobrun--;
      return;
    }
    for (int k = ss; k <= se; k++) {
      int rs = huff(t, at);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        if (k > se) fail("AC coefficient index past the band in the scan starting", at);
        blk[kNaturalOrder[k]] = static_cast<int16_t>(
            static_cast<uint32_t>(extend(br.get(s), s)) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += br.get(r);
        eobrun--;
        break;
      }
    }
  }

  void decode_ac_refine(const Huffman& t, int16_t* blk, int ss, int se, int al,
                        size_t at) {
    int p1 = 1 << al, m1 = -1 * (1 << al);
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; k++) {
        int rs = huff(t, at);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          if (s != 1)
            fail("refinement scan: new coefficient of size " +
                     std::to_string(s) + " (bad Huffman code) in the scan starting",
                 at);
          s = br.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          break;
        }
        do {
          int16_t* coef = blk + kNaturalOrder[k];
          if (*coef != 0) {
            if (br.get(1) && (*coef & p1) == 0)
              *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : m1));
          } else if (--r < 0) {
            break;
          }
          k++;
        } while (k <= se);
        if (s) {
          if (k > se) fail("refinement past the band in the scan starting", at);
          blk[kNaturalOrder[k]] = static_cast<int16_t>(s);
        }
      }
    }
    if (eobrun > 0) {
      for (; k <= se; k++) {
        int16_t* coef = blk + kNaturalOrder[k];
        if (*coef != 0 && br.get(1) && (*coef & p1) == 0)
          *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : m1));
      }
      eobrun--;
    }
  }

  // Returns the offset of the marker that ends the scan.
  size_t read_sos(size_t at, size_t len) {
    if (!have_frame) fail("SOS before SOF", at);
    size_t p = at + 4;
    int ns = d[p];
    if (ns < 1 || ns > 4 || len != 6 + 2 * static_cast<size_t>(ns))
      fail("SOS: bad component count or length", at);
    Component* sc[4];
    for (int i = 0; i < ns; i++) {
      int cid = d[p + 1 + 2 * i], tables = d[p + 2 + 2 * i];
      Component* c = nullptr;
      for (int j = 0; j < ncomp; j++)
        if (comp[j].id == cid) c = &comp[j];
      if (!c) fail("SOS: unknown component id " + std::to_string(cid), p + 1 + 2 * i);
      for (int j = 0; j < i; j++)
        if (sc[j] == c) fail("SOS: component listed twice", p + 1 + 2 * i);
      c->td = tables >> 4;
      c->ta = tables & 15;
      if (c->td > 3 || c->ta > 3) fail("SOS: bad table selector", p + 2 + 2 * i);
      sc[i] = c;
    }
    size_t q = p + 1 + 2 * ns;
    int ss = d[q], se = d[q + 1], ah = d[q + 2] >> 4, al = d[q + 2] & 15;
    size_t scan_at = at;
    if (progressive) {
      bool bad = false;
      if (ss == 0) {
        if (se != 0) bad = true;
      } else if (ss > se || se > 63 || ns != 1) {
        bad = true;
      }
      if (ah != 0 && al != ah - 1) bad = true;
      if (al > 13) bad = true;
      if (bad) fail("SOS: bad progressive parameters", q);
      for (int i = 0; i < ns; i++) {
        int* bits = sc[i]->coef_bits;
        if (ss != 0 && bits[0] < 0)
          fail("SOS: AC scan before the component's DC scan", q);
        for (int k = ss; k <= se; k++) {
          int expected = bits[k] < 0 ? 0 : bits[k];
          if (ah != expected)
            fail("SOS: bogus progression (coefficient " + std::to_string(k) +
                     " refined out of order)",
                 q);
          bits[k] = al;
        }
      }
    } else if (ss != 0 || se != 63 || ah != 0 || al != 0) {
      fail("SOS: sequential scan with progressive parameters", q);
    }
    // tables and quantisation
    for (int i = 0; i < ns; i++) {
      Component* c = sc[i];
      if (!c->quant_latched) {
        if (!qt_set[c->tq])
          fail("no quantisation table " + std::to_string(c->tq) +
                   " for component " + std::to_string(c->id),
               at);
        memcpy(c->quant, qt[c->tq], sizeof c->quant);
        c->quant_latched = true;
      }
      bool need_dc = !progressive || (ss == 0 && ah == 0);
      bool need_ac = !progressive || ss != 0;
      if (need_dc && !dc[c->td].defined)
        fail("no DC Huffman table " + std::to_string(c->td) + " for the scan", at);
      if (need_ac && !ac[c->ta].defined)
        fail("no AC Huffman table " + std::to_string(c->ta) + " for the scan", at);
    }
    int bpm = 0;
    for (int i = 0; i < ns; i++) bpm += sc[i]->h * sc[i]->v;
    if (ns > 1 && bpm > 10)
      fail("SOS: sampling factors too large for an interleaved scan", at);

    // MCU geometry
    int mx, my;
    if (ns == 1) {
      mx = sc[0]->wblocks;
      my = sc[0]->hblocks;
    } else {
      mx = mcux;
      my = mcuy;
    }
    br.start(d, n, at + 2 + len);
    for (int i = 0; i < ns; i++) sc[i]->pred = 0;
    eobrun = 0;
    int total = mx * my, restarts = 0;
    int left = restart_interval;
    for (int m = 0; m < total; m++) {
      if (restart_interval && left == 0) {
        size_t mk = br.finish(scan_at);
        int want = 0xD0 + (restarts & 7);
        if (d[mk + 1] != want)
          fail("expected RST" + std::to_string(restarts & 7) + ", found marker FF" +
                   hex2(d[mk + 1]),
               mk);
        restarts++;
        br.start(d, n, mk + 2);
        for (int i = 0; i < ns; i++) sc[i]->pred = 0;
        eobrun = 0;
        left = restart_interval;
      }
      int mcx = m % mx, mcy = m / mx;
      for (int i = 0; i < ns; i++) {
        Component& c = *sc[i];
        int hh = ns == 1 ? 1 : c.h, vv = ns == 1 ? 1 : c.v;
        for (int y = 0; y < vv; y++) {
          for (int x = 0; x < hh; x++) {
            int16_t* blk = block(c, mcx * hh + x, mcy * vv + y);
            if (!progressive) decode_sequential(c, blk, scan_at);
            else if (ss == 0 && ah == 0) decode_dc_first(c, blk, al, scan_at);
            else if (ss == 0) {
              if (br.get(1)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
            } else if (ah == 0) decode_ac_first(ac[c.ta], blk, ss, se, al, scan_at);
            else decode_ac_refine(ac[c.ta], blk, ss, se, al, scan_at);
          }
        }
      }
      br.check(scan_at);
      if (restart_interval) left--;
    }
    scans++;
    return br.finish(scan_at);
  }

  // --- markers loop -----------------------------------------------------------

  // The whole file, or with header_only the markers before the first SOS
  // (the frame's size and the orientation), as jpeg_read_header reads them.
  void parse(bool header_only = false) {
    if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) fail("not a JPEG file (no SOI)", 0);
    size_t p = 2;
    for (;;) {
      if (p >= n) fail("file truncated: no EOI marker", n);
      if (d[p] != 0xFF)
        fail("expected a marker, found byte 0x" + hex2(d[p]), p);
      while (p + 1 < n && d[p + 1] == 0xFF) p++;
      if (p + 1 >= n) fail("file truncated: no EOI marker", n);
      int m = d[p + 1];
      size_t at = p;
      if (m == 0xD9) {
        if (!scans) fail("EOI before any scan", at);
        break;
      }
      if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) {   // parameterless
        p += 2;
        continue;
      }
      if (m == 0xD8) fail("a second SOI marker", at);
      size_t len = u16(p + 2);
      if (len < 2 || p + 2 + len > n)
        fail("marker FF" + hex2(m) + ": segment runs past the end of the file", at);
      switch (m) {
        case 0xC0: case 0xC1: case 0xC2:
          read_sof(m, at, len);
          break;
        case 0xC3: case 0xC5: case 0xC6: case 0xC7: case 0xC9: case 0xCA:
        case 0xCB: case 0xCD: case 0xCE: case 0xCF:
          fail("SOF" + std::to_string(m - 0xC0) +
                   " (lossless, hierarchical or arithmetic-coded) is not decoded",
               at);
        case 0xC8: case 0xCC:
          fail("marker FF" + hex2(m) + " (arithmetic coding / JPG) is not decoded", at);
        case 0xC4:
          read_dht(at, len);
          break;
        case 0xDB:
          read_dqt(at, len);
          break;
        case 0xDD:
          if (len != 4) fail("DRI: bad segment length", at);
          restart_interval = u16(p + 4);
          break;
        case 0xDA: {
          if (header_only && have_frame) return;
          p = read_sos(at, len);
          continue;
        }
        default:
          if (m >= 0xE0 && m <= 0xEF) read_app(m, at, len);
          else if (!(m == 0xFE || m == 0xDC || (m >= 0xF0 && m <= 0xFD)))
            fail("unknown marker FF" + hex2(m), at);
      }
      p += 2 + len;
    }
    if (progressive) {
      for (int i = 0; i < ncomp; i++)
        for (int k = 0; k < 64; k++)
          if (comp[i].coef_bits[k] != 0)
            fail("progressive scans leave coefficient " + std::to_string(k) +
                     " of component " + std::to_string(comp[i].id) +
                     " unrefined (block smoothing is not implemented)",
                 n - 2);
    }
  }

  // --- pixels ----------------------------------------------------------------

  // jidctint.c jpeg_idct_islow, with the post-IDCT range limit of
  // jdmaster.c prepare_range_limit_table (10-bit wrap, then clamp).
  static inline uint8_t limit(int64_t x) {
    int v = static_cast<int>(x) & 1023;
    if (v >= 512) v -= 1024;          // the table's wrap
    v += 128;
    return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
  }

  static void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                         int stride) {
    constexpr int CB = 13, P1 = 2;
    constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                      F0899 = 7373, F1175 = 9633, F1501 = 12299,
                      F1847 = 15137, F1961 = 16069, F2053 = 16819,
                      F2562 = 20995, F3072 = 25172;
    int ws[64];
    auto descale = [](int64_t x, int nb) -> int64_t {
      return (x + (int64_t(1) << (nb - 1))) >> nb;
    };
    for (int c = 0; c < 8; c++) {
      const int16_t* ip = in + c;
      const uint16_t* qp = q + c;
      int* w = ws + c;
      if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] &&
          !ip[56]) {
        int dcval = static_cast<int>(int64_t(ip[0]) * qp[0] * (1 << P1));
        for (int r = 0; r < 8; r++) w[8 * r] = dcval;
        continue;
      }
      int64_t z2 = int64_t(ip[16]) * qp[16], z3 = int64_t(ip[48]) * qp[48];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847;
      int64_t tmp3 = z1 + z2 * F0765;
      z2 = int64_t(ip[0]) * qp[0];
      z3 = int64_t(ip[32]) * qp[32];
      int64_t tmp0 = (z2 + z3) * (int64_t(1) << CB);
      int64_t tmp1 = (z2 - z3) * (int64_t(1) << CB);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = int64_t(ip[56]) * qp[56];
      tmp1 = int64_t(ip[40]) * qp[40];
      tmp2 = int64_t(ip[24]) * qp[24];
      tmp3 = int64_t(ip[8]) * qp[8];
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
      w[0] = static_cast<int>(descale(tmp10 + tmp3, CB - P1));
      w[56] = static_cast<int>(descale(tmp10 - tmp3, CB - P1));
      w[8] = static_cast<int>(descale(tmp11 + tmp2, CB - P1));
      w[48] = static_cast<int>(descale(tmp11 - tmp2, CB - P1));
      w[16] = static_cast<int>(descale(tmp12 + tmp1, CB - P1));
      w[40] = static_cast<int>(descale(tmp12 - tmp1, CB - P1));
      w[24] = static_cast<int>(descale(tmp13 + tmp0, CB - P1));
      w[32] = static_cast<int>(descale(tmp13 - tmp0, CB - P1));
    }
    for (int r = 0; r < 8; r++) {
      const int* w = ws + 8 * r;
      uint8_t* o = out + static_cast<size_t>(r) * stride;
      if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
        uint8_t v = limit(descale(w[0], P1 + 3));
        for (int c = 0; c < 8; c++) o[c] = v;
        continue;
      }
      int64_t z2 = w[2], z3 = w[6];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847;
      int64_t tmp3 = z1 + z2 * F0765;
      int64_t tmp0 = (int64_t(w[0]) + w[4]) * (int64_t(1) << CB);
      int64_t tmp1 = (int64_t(w[0]) - w[4]) * (int64_t(1) << CB);
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
      constexpr int S = CB + P1 + 3;
      o[0] = limit(descale(tmp10 + tmp3, S));
      o[7] = limit(descale(tmp10 - tmp3, S));
      o[1] = limit(descale(tmp11 + tmp2, S));
      o[6] = limit(descale(tmp11 - tmp2, S));
      o[2] = limit(descale(tmp12 + tmp1, S));
      o[5] = limit(descale(tmp12 - tmp1, S));
      o[3] = limit(descale(tmp13 + tmp0, S));
      o[4] = limit(descale(tmp13 - tmp0, S));
    }
  }

  void idct_all() {
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      if (!c.quant_latched)
        fail("component " + std::to_string(c.id) + " has no scan", n - 2);
      int stride = c.bw * 8;
      ws->plane[i].assign(static_cast<size_t>(stride) * c.hblocks * 8, 0);
      c.plane = ws->plane[i].data();
      for (int by = 0; by < c.hblocks; by++)
        for (int bx = 0; bx < c.wblocks; bx++)
          idct_islow(block(c, bx, by), c.quant,
                     c.plane + static_cast<size_t>(by) * 8 * stride + bx * 8,
                     stride);
    }
  }

  // One full-resolution row (width samples) of component c: jdsample.c.
  // rows: the component's sample rows; r: the output row.
  void upsample_row(const Component& c, int y, uint8_t* out) {
    const int stride = c.bw * 8;
    const int hx = hmax / c.h, vx = vmax / c.v;
    const uint8_t* plane = c.plane;
    auto row = [&](int r) {
      r = std::min(std::max(r, 0), c.dh - 1);
      return plane + static_cast<size_t>(r) * stride;
    };
    if (hx == 1 && vx == 1) {
      memcpy(out, row(y), width);
      return;
    }
    const int dw = c.dw;
    if (hx == 2 && vx == 1 && dw > 2) {          // h2v1_fancy_upsample
      const uint8_t* in = row(y);
      ws->row.resize(2 * dw);
      uint8_t* o = ws->row.data();
      int v = in[0];
      o[0] = static_cast<uint8_t>(v);
      o[1] = static_cast<uint8_t>((v * 3 + in[1] + 2) >> 2);
      for (int x = 1; x < dw - 1; x++) {
        v = in[x] * 3;
        o[2 * x] = static_cast<uint8_t>((v + in[x - 1] + 1) >> 2);
        o[2 * x + 1] = static_cast<uint8_t>((v + in[x + 1] + 2) >> 2);
      }
      v = in[dw - 1];
      o[2 * dw - 2] = static_cast<uint8_t>((v * 3 + in[dw - 2] + 1) >> 2);
      o[2 * dw - 1] = static_cast<uint8_t>(v);
      memcpy(out, o, width);
      return;
    }
    if (hx == 1 && vx == 2) {                    // h1v2_fancy_upsample
      int r = y / 2;
      const uint8_t* near = row(r);
      const uint8_t* far = row(y % 2 ? r + 1 : r - 1);
      int bias = y % 2 ? 2 : 1;
      for (int x = 0; x < width; x++)
        out[x] = static_cast<uint8_t>((near[x] * 3 + far[x] + bias) >> 2);
      return;
    }
    if (hx == 2 && vx == 2 && dw > 2) {          // h2v2_fancy_upsample
      int r = y / 2;
      const uint8_t* i0 = row(r);
      const uint8_t* i1 = row(y % 2 ? r + 1 : r - 1);
      ws->row.resize(2 * dw);
      uint8_t* o = ws->row.data();
      int thiscol = i0[0] * 3 + i1[0];
      int nextcol = i0[1] * 3 + i1[1];
      o[0] = static_cast<uint8_t>((thiscol * 4 + 8) >> 4);
      o[1] = static_cast<uint8_t>((thiscol * 3 + nextcol + 7) >> 4);
      int lastcol = thiscol;
      thiscol = nextcol;
      for (int x = 1; x < dw - 1; x++) {
        nextcol = i0[x + 1] * 3 + i1[x + 1];
        o[2 * x] = static_cast<uint8_t>((thiscol * 3 + lastcol + 8) >> 4);
        o[2 * x + 1] = static_cast<uint8_t>((thiscol * 3 + nextcol + 7) >> 4);
        lastcol = thiscol;
        thiscol = nextcol;
      }
      o[2 * dw - 2] = static_cast<uint8_t>((thiscol * 3 + lastcol + 8) >> 4);
      o[2 * dw - 1] = static_cast<uint8_t>((thiscol * 4 + 7) >> 4);
      memcpy(out, o, width);
      return;
    }
    // h2v1_upsample, h2v2_upsample, int_upsample: replication
    const uint8_t* in = plane + static_cast<size_t>(y / vx) * stride;
    for (int x = 0; x < width; x++) out[x] = in[x / hx];
  }

  ColorSpace color_space() const {
    if (ncomp == 1) return kGray;
    if (saw_jfif) return kYCbCr;
    if (saw_adobe) return adobe_transform == 0 ? kRGB : kYCbCr;
    if (comp[0].id == 1 && comp[1].id == 2 && comp[2].id == 3) return kYCbCr;
    if (comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B') return kRGB;
    return kYCbCr;
  }

  int out_height() const {
    return apply_orientation && orientation >= 5 && orientation <= 8 ? width : height;
  }
  int out_width() const {
    return apply_orientation && orientation >= 5 && orientation <= 8 ? height : width;
  }

  // RGB rows into out (height x width x 3), then the orientation.
  void render(uint8_t* out) {
    idct_all();
    static const ColorTables t = make_color_tables();
    auto clamp = [](int v) {
      return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
    };
    const bool orient = apply_orientation && orientation >= 2 && orientation <= 8;
    std::vector<uint8_t>& img = ws->img;
    uint8_t* dst = out;
    if (orient) {
      img.resize(static_cast<size_t>(width) * height * 3);
      dst = img.data();
    }
    ColorSpace cs = color_space();
    std::vector<uint8_t>&r0 = ws->r0, &r1 = ws->r1, &r2 = ws->r2;
    r0.resize(width);
    r1.resize(width);
    r2.resize(width);
    for (int y = 0; y < height; y++) {
      uint8_t* o = dst + static_cast<size_t>(y) * width * 3;
      upsample_row(comp[0], y, r0.data());
      if (cs == kGray) {
        for (int x = 0; x < width; x++) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = r0[x];
        continue;
      }
      upsample_row(comp[1], y, r1.data());
      upsample_row(comp[2], y, r2.data());
      if (cs == kRGB) {
        for (int x = 0; x < width; x++) {
          o[3 * x] = r0[x];
          o[3 * x + 1] = r1[x];
          o[3 * x + 2] = r2[x];
        }
        continue;
      }
      for (int x = 0; x < width; x++) {
        int yy = r0[x], cb = r1[x], cr = r2[x];
        o[3 * x] = clamp(yy + t.cr_r[cr]);
        o[3 * x + 1] = clamp(yy + static_cast<int>((t.cb_g[cb] + t.cr_g[cr]) >> 16));
        o[3 * x + 2] = clamp(yy + t.cb_b[cb]);
      }
    }
    if (!orient) return;
    // OpenCV's ExifTransform: out[y][x] = img[sy][sx]
    const int H = height, W = width, oh = out_height(), ow = out_width();
    for (int y = 0; y < oh; y++) {
      for (int x = 0; x < ow; x++) {
        int sy, sx;
        switch (orientation) {
          case 2: sy = y; sx = W - 1 - x; break;
          case 3: sy = H - 1 - y; sx = W - 1 - x; break;
          case 4: sy = H - 1 - y; sx = x; break;
          case 5: sy = x; sx = y; break;
          case 6: sy = H - 1 - x; sx = y; break;
          case 7: sy = H - 1 - x; sx = W - 1 - y; break;
          default: sy = x; sx = W - 1 - y; break;   // 8
        }
        const uint8_t* s = img.data() + (static_cast<size_t>(sy) * W + sx) * 3;
        uint8_t* o = out + (static_cast<size_t>(y) * ow + x) * 3;
        o[0] = s[0];
        o[1] = s[1];
        o[2] = s[2];
      }
    }
  }
};

void read_header(const uint8_t* data, size_t n, bool orient, int* h, int* w) {
  Decoder dec(data, n, orient, nullptr);
  dec.parse(true);
  *h = dec.out_height();
  *w = dec.out_width();
}

void copy_error(const std::exception& e, char* err, int errlen) {
  if (err && errlen > 0) {
    strncpy(err, e.what(), errlen - 1);
    err[errlen - 1] = 0;
  }
}

void decode_into(const uint8_t* data, size_t n, bool orient, uint8_t* out,
                 int height, int width, Workspace& ws) {
  Decoder dec(data, n, orient, &ws);
  dec.parse();
  if (dec.out_height() != height || dec.out_width() != width)
    throw JpegError("image is " + std::to_string(dec.out_height()) + "x" +
                    std::to_string(dec.out_width()) + ", expected " +
                    std::to_string(height) + "x" + std::to_string(width));
  dec.render(out);
}

bool read_file(const char* path, std::vector<uint8_t>& buf) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  buf.clear();
  uint8_t chunk[1 << 16];
  size_t got;
  while ((got = fread(chunk, 1, sizeof chunk, f)) > 0)
    buf.insert(buf.end(), chunk, chunk + got);
  bool ok = !ferror(f);
  fclose(f);
  return ok;
}

// ---------------------------------------------------------------------------
// Pillow's BILINEAR resize (Resample.c, 8 bits per channel)
// ---------------------------------------------------------------------------

constexpr int kPrecisionBits = 32 - 8 - 2;

struct PilTaps {
  int ksize;
  std::vector<int> bounds;   // (xmin, count) per output
  std::vector<int32_t> k;    // out * ksize
};

PilTaps pil_taps(int in_size, int out_size) {
  PilTaps t;
  double scale = static_cast<double>(static_cast<float>(in_size)) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = 1.0 * filterscale;
  t.ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  t.bounds.resize(2 * out_size);
  t.k.assign(static_cast<size_t>(out_size) * t.ksize, 0);
  std::vector<double> w(t.ksize);
  for (int xx = 0; xx < out_size; xx++) {
    double center = 0.0f + (xx + 0.5) * scale;
    double ww = 0.0, ss = 1.0 / filterscale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    for (int x = 0; x < xmax; x++) {
      double a = (x + xmin - center + 0.5) * ss;
      if (a < 0.0) a = -a;
      double v = a < 1.0 ? 1.0 - a : 0.0;
      w[x] = v;
      ww += v;
    }
    for (int x = 0; x < xmax; x++) {
      double v = ww != 0.0 ? w[x] / ww : w[x];
      t.k[static_cast<size_t>(xx) * t.ksize + x] = static_cast<int32_t>(
          v < 0 ? -0.5 + v * (1 << kPrecisionBits) : 0.5 + v * (1 << kPrecisionBits));
    }
    t.bounds[2 * xx] = xmin;
    t.bounds[2 * xx + 1] = xmax;
  }
  return t;
}

inline uint8_t clip8(int32_t in) {
  if (in >= (1 << kPrecisionBits << 8)) return 255;
  if (in <= 0) return 0;
  return static_cast<uint8_t>(in >> kPrecisionBits);
}

// A resize's buffers, kept across the frames of one call (see Workspace).
struct ResizeBuffers {
  std::vector<uint8_t> u8;
  std::vector<int32_t> i32;
};

void pil_resize_one(const uint8_t* in, int H, int W, uint8_t* out, int oh, int ow,
                    const PilTaps* tx, const PilTaps* ty, ResizeBuffers& buf) {
  std::vector<uint8_t>& mid = buf.u8;
  const uint8_t* src = in;
  if (tx) {
    mid.resize(static_cast<size_t>(H) * ow * 3);
    for (int y = 0; y < H; y++) {
      const uint8_t* r = in + static_cast<size_t>(y) * W * 3;
      uint8_t* o = mid.data() + static_cast<size_t>(y) * ow * 3;
      for (int xx = 0; xx < ow; xx++) {
        int xmin = tx->bounds[2 * xx], cnt = tx->bounds[2 * xx + 1];
        const int32_t* k = tx->k.data() + static_cast<size_t>(xx) * tx->ksize;
        int32_t s0 = 1 << (kPrecisionBits - 1), s1 = s0, s2 = s0;
        for (int x = 0; x < cnt; x++) {
          const uint8_t* p = r + (x + xmin) * 3;
          s0 += p[0] * k[x];
          s1 += p[1] * k[x];
          s2 += p[2] * k[x];
        }
        o[3 * xx] = clip8(s0);
        o[3 * xx + 1] = clip8(s1);
        o[3 * xx + 2] = clip8(s2);
      }
    }
    src = mid.data();
  }
  const int rw = ow * 3;
  if (!ty) {
    memcpy(out, src, static_cast<size_t>(oh) * rw);
    return;
  }
  std::vector<int32_t>& acc = buf.i32;
  acc.resize(rw);
  for (int yy = 0; yy < oh; yy++) {
    int ymin = ty->bounds[2 * yy], cnt = ty->bounds[2 * yy + 1];
    const int32_t* k = ty->k.data() + static_cast<size_t>(yy) * ty->ksize;
    std::fill(acc.begin(), acc.end(), 1 << (kPrecisionBits - 1));
    for (int y = 0; y < cnt; y++) {
      const uint8_t* r = src + static_cast<size_t>(y + ymin) * rw;
      int32_t kv = k[y];
      for (int x = 0; x < rw; x++) acc[x] += r[x] * kv;
    }
    uint8_t* o = out + static_cast<size_t>(yy) * rw;
    for (int x = 0; x < rw; x++) o[x] = clip8(acc[x]);
  }
}

// ---------------------------------------------------------------------------
// OpenCV's INTER_LINEAR on CV_8UC3 (resize.cpp)
// ---------------------------------------------------------------------------

struct CvTaps {
  std::vector<int> i0, i1;
  std::vector<int> a0, a1;
};

// clamp: the horizontal taps zero the fraction past either edge, the
// vertical ones only clip the rows they read.
CvTaps cv_taps(int in_size, int out_size, double scale, bool clamp) {
  CvTaps t;
  t.i0.resize(out_size);
  t.i1.resize(out_size);
  t.a0.resize(out_size);
  t.a1.resize(out_size);
  for (int dx = 0; dx < out_size; dx++) {
    float f = static_cast<float>((dx + 0.5) * scale - 0.5);
    int s = static_cast<int>(std::floor(f));
    f -= static_cast<float>(s);
    int s0 = s, s1 = s + 1;
    if (clamp) {
      if (s < 0) f = 0, s0 = 0, s1 = 1;
      if (s >= in_size - 1) f = 0, s0 = in_size - 1, s1 = in_size;
    }
    t.i0[dx] = std::min(std::max(s0, 0), in_size - 1);
    t.i1[dx] = std::min(std::max(s1, 0), in_size - 1);
    t.a0[dx] = static_cast<int>(std::lrint((1.f - f) * 2048));
    t.a1[dx] = static_cast<int>(std::lrint(f * 2048));
  }
  return t;
}

void cv_linear_one(const uint8_t* in, int H, int W, uint8_t* out, int oh, int ow,
                   const CvTaps& tx, const CvTaps& ty, ResizeBuffers& buf) {
  const int rw = ow * 3;
  std::vector<int32_t>& hs = buf.i32;
  hs.resize(static_cast<size_t>(H) * rw);
  for (int y = 0; y < H; y++) {
    const uint8_t* r = in + static_cast<size_t>(y) * W * 3;
    int32_t* o = hs.data() + static_cast<size_t>(y) * rw;
    for (int dx = 0; dx < ow; dx++) {
      const uint8_t* p0 = r + tx.i0[dx] * 3;
      const uint8_t* p1 = r + tx.i1[dx] * 3;
      int a0 = tx.a0[dx], a1 = tx.a1[dx];
      for (int c = 0; c < 3; c++) o[3 * dx + c] = p0[c] * a0 + p1[c] * a1;
    }
  }
  for (int dy = 0; dy < oh; dy++) {
    const int32_t* s0 = hs.data() + static_cast<size_t>(ty.i0[dy]) * rw;
    const int32_t* s1 = hs.data() + static_cast<size_t>(ty.i1[dy]) * rw;
    int b0 = ty.a0[dy], b1 = ty.a1[dy];
    uint8_t* o = out + static_cast<size_t>(dy) * rw;
    for (int x = 0; x < rw; x++) {
      int v = ((((s0[x] >> 4) * b0) >> 16) + (((s1[x] >> 4) * b1) >> 16) + 2) >> 2;
      o[x] = static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
    }
  }
}

// INTER_AREA's 2x2 path: whole blocks (s + 2) >> 2, the odd edge's partial
// blocks their mean rounded half to even.
void cv_area2_one(const uint8_t* in, int H, int W, uint8_t* out, int oh, int ow) {
  const size_t rs = static_cast<size_t>(W) * 3;
  for (int dy = 0; dy < oh; dy++) {
    int sy = 2 * dy;
    for (int dx = 0; dx < ow; dx++) {
      int sx = 2 * dx;
      for (int c = 0; c < 3; c++) {
        int v;
        if (sy + 1 < H && sx + 1 < W) {
          const uint8_t* p = in + sy * rs + sx * 3 + c;
          v = (p[0] + p[3] + p[rs] + p[rs + 3] + 2) >> 2;
        } else {
          int sum = 0, count = 0;
          for (int y = sy; y < std::min(sy + 2, H); y++)
            for (int x = sx; x < std::min(sx + 2, W); x++) {
              sum += in[y * rs + x * 3 + c];
              count++;
            }
          v = static_cast<int>(std::lrint(static_cast<float>(sum) / count));
        }
        out[(static_cast<size_t>(dy) * ow + dx) * 3 + c] =
            static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
      }
    }
  }
}

}  // namespace

extern "C" {

// 0: ok; 1: refused (err says why).
int jpeg_header(const uint8_t* data, int64_t n, int apply_orientation,
                int* height, int* width, char* err, int errlen) {
  try {
    read_header(data, static_cast<size_t>(n), apply_orientation != 0, height, width);
    return 0;
  } catch (const std::exception& e) {
    copy_error(e, err, errlen);
    return 1;
  }
}

// Decode one buffer into out (height x width x 3, the header's size).
int jpeg_decode(const uint8_t* data, int64_t n, int apply_orientation,
                uint8_t* out, int height, int width, char* err, int errlen) {
  try {
    Workspace ws;
    decode_into(data, static_cast<size_t>(n), apply_orientation != 0, out,
                height, width, ws);
    return 0;
  } catch (const std::exception& e) {
    copy_error(e, err, errlen);
    return 1;
  }
}

// Decode count files, all height x width after orientation, into out
// (count x height x width x 3). 0 ok; 1 refused, 2 unreadable: *failed is
// the first such file, err says why.
int jpeg_decode_files(const char** paths, int count, int apply_orientation,
                      uint8_t* out, int height, int width, int* failed,
                      char* err, int errlen) {
  const size_t frame = static_cast<size_t>(height) * width * 3;
  Workspace ws;
  for (int i = 0; i < count; i++) {
    *failed = i;
    if (!read_file(paths[i], ws.file)) return 2;
    try {
      decode_into(ws.file.data(), ws.file.size(), apply_orientation != 0,
                  out + frame * i, height, width, ws);
    } catch (const std::exception& e) {
      copy_error(e, err, errlen);
      return 1;
    }
  }
  return 0;
}

// Pillow's resize((ow, oh), BILINEAR) of count uint8 RGB frames.
void resize_pil_bilinear_u8(const uint8_t* in, int count, int H, int W,
                            uint8_t* out, int oh, int ow) {
  PilTaps tx, ty;
  bool hx = ow != W, vy = oh != H;
  if (hx) tx = pil_taps(W, ow);
  if (vy) ty = pil_taps(H, oh);
  const size_t fi = static_cast<size_t>(H) * W * 3, fo = static_cast<size_t>(oh) * ow * 3;
  ResizeBuffers buf;
  for (int i = 0; i < count; i++)
    pil_resize_one(in + fi * i, H, W, out + fo * i, oh, ow, hx ? &tx : nullptr,
                   vy ? &ty : nullptr, buf);
}

// cv::resize(frame, (0, 0), fx, fy, INTER_LINEAR) of count uint8 RGB frames
// into (oh, ow) = (round(H * fy), round(W * fx)).
void resize_cv2_linear_u8(const uint8_t* in, int count, int H, int W,
                          uint8_t* out, int oh, int ow, double fx, double fy) {
  const size_t fi = static_cast<size_t>(H) * W * 3, fo = static_cast<size_t>(oh) * ow * 3;
  if (oh == H && ow == W) {
    memcpy(out, in, fi * count);
    return;
  }
  double sx = 1.0 / fx, sy = 1.0 / fy;
  int ix = static_cast<int>(std::lrint(sx)), iy = static_cast<int>(std::lrint(sy));
  bool area = std::abs(sx - ix) < DBL_EPSILON && std::abs(sy - iy) < DBL_EPSILON &&
              ix == 2 && iy == 2;
  if (area) {
    for (int i = 0; i < count; i++)
      cv_area2_one(in + fi * i, H, W, out + fo * i, oh, ow);
    return;
  }
  CvTaps tx = cv_taps(W, ow, sx, true), ty = cv_taps(H, oh, sy, false);
  ResizeBuffers buf;
  for (int i = 0; i < count; i++)
    cv_linear_one(in + fi * i, H, W, out + fo * i, oh, ow, tx, ty, buf);
}

}  // extern "C"
