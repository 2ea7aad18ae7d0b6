// A JPEG decoder with no library behind it, for machines without PIL.
//
// It reproduces what PIL's np.asarray(Image.open(path)) gives on the same
// bytes with libjpeg-turbo's default decompression: the integer IDCT of
// jidctint.c (JDCT_ISLOW), fancy upsampling (jdsample.c: h2v1, h2v2, h1v2;
// box replication for every other integral ratio and for h2 ratios whose
// downsampled width is at most 2), the fixed-point YCbCr->RGB tables of
// jdcolor.c, YCCK->CMYK, the colour space libjpeg-turbo infers from the
// JFIF and Adobe markers and the component ids, and the standard Huffman
// tables of jstdhuff.c in every table slot 0-1 that no DHT filled before the
// first scan.  Pillow reads a 4-component frame as "CMYK;I" (inverted), and
// converts CMYK to RGB by its own formula (cmyk2rgb); both are done here.
//
// Decoded: baseline and extended sequential Huffman (SOF0, SOF1) with 8- or
// 16-bit quantisation tables, progressive Huffman (SOF2: DC and AC first
// and refinement scans, EOB runs), interleaved and single-component scans,
// tables redefined between scans (a component keeps the quantisation table
// of its first scan, as libjpeg latches it), restart intervals, frames of
// any size down to 1x1.  Refused, each with its own code: arithmetic
// coding, precisions other than 8 bits, lossless and hierarchical frames,
// component counts other than 1, 3 and 4 (PIL refuses them too), sampling
// ratios libjpeg cannot upsample, a progressive frame whose scans leave
// libjpeg's block smoothing something to do (it does nothing once every
// scan is complete), and truncated or corrupt data.
//
// The C ABI: jpeg_info(data, n, info) fills info = {height, width,
// channels (1, 3 or 4: PIL's L, RGB or CMYK)} and
// jpeg_decode(data, n, rgb, out, out_size) writes the uint8 [height, width,
// channels] array (3 channels with rgb set) into out.  Both return 0 or an
// error code (Err below); neither keeps any state between calls.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum Err {
  OK = 0, NOT_JPEG = 1, TRUNCATED = 2, CORRUPT = 3,
  ARITHMETIC = 10, PRECISION = 11, LOSSLESS = 12, HIERARCHICAL = 13, SAMPLING = 14,
  COMPONENTS = 15, SMOOTHING = 16, BUFFER = 20,
};

struct Fail {
  int code;
};

[[noreturn]] void fail(int code) { throw Fail{code}; }

// Zigzag index -> natural index, with the 16 guard entries of libjpeg's
// jpeg_natural_order that keep a corrupt run inside the block.
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// jstdhuff.c: the tables of the JPEG standard, Annex K.3.
const uint8_t kDcLumBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
    0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
    0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
    0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
    0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
    0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
    0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
    0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
    0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

constexpr int kLookBits = 9;

// One Huffman table with jdhuff.c's derived decoding tables: maxcode and
// valoffset per code length, and a lookahead of kLookBits bits.
struct Huff {
  bool defined = false;
  uint8_t bits[17] = {};
  uint8_t vals[256] = {};
  int32_t maxcode[18] = {};
  int32_t valoffset[18] = {};
  uint16_t look[1 << kLookBits] = {};  // (length << 8) | symbol; 0 = a longer code

  void set(const uint8_t* b, const uint8_t* v, int nvals) {
    std::memcpy(bits, b, 17);
    std::memset(vals, 0, sizeof vals);
    std::memcpy(vals, v, nvals);
    defined = true;
  }

  // jpeg_make_d_derived_tbl, with its checks.
  void derive(bool dc) {
    uint8_t size[257];
    int32_t code_of[257];
    int p = 0;
    for (int l = 1; l <= 16; l++) {
      if (p + bits[l] > 256) fail(CORRUPT);
      for (int i = 0; i < bits[l]; i++) size[p++] = (uint8_t)l;
    }
    size[p] = 0;
    int nsym = p;
    int64_t code = 0;
    int si = size[0];
    p = 0;
    while (size[p]) {
      while (size[p] == si) code_of[p++] = (int32_t)code++;
      if (code >= ((int64_t)1 << si)) fail(CORRUPT);
      code <<= 1;
      si++;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
      if (bits[l]) {
        valoffset[l] = p - code_of[p];
        p += bits[l];
        maxcode[l] = code_of[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    valoffset[17] = 0;
    maxcode[17] = 0xFFFFF;
    std::memset(look, 0, sizeof look);
    p = 0;
    for (int l = 1; l <= kLookBits; l++) {
      for (int i = 0; i < bits[l]; i++, p++) {
        int base = code_of[p] << (kLookBits - l);
        for (int j = 0; j < (1 << (kLookBits - l)); j++)
          look[base + j] = (uint16_t)((l << 8) | vals[p]);
      }
    }
    if (dc)
      for (int i = 0; i < nsym; i++)
        if (vals[i] > 15) fail(CORRUPT);
  }
};

// The bits of one entropy-coded segment, with FF00 unstuffed.  At a marker
// (or the end of the data) it feeds zero bits, as libjpeg does; consuming
// any of them means the segment was short, which is an error here.
struct Bits {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;  // MSB-aligned
  int n = 0;         // bits in acc
  int fake = 0;      // of which the last `fake` are zero padding
  int marker = 0;    // the marker that ended the segment, once met
  bool eof = false;
  bool short_data = false;

  void fill() {
    while (n <= 56) {
      unsigned c = 0;
      if (marker || eof) {
        fake += 8;
      } else if (p >= end) {
        eof = true;
        fake += 8;
      } else {
        c = *p++;
        if (c == 0xFF) {
          do {
            if (p >= end) {
              eof = true;
              break;
            }
            c = *p++;
          } while (c == 0xFF);
          if (eof) {
            c = 0;
            fake += 8;
          } else if (c == 0) {
            c = 0xFF;
          } else {
            marker = (int)c;
            c = 0;
            fake += 8;
          }
        }
      }
      acc |= (uint64_t)c << (56 - n);
      n += 8;
    }
  }
  inline void skip(int k) {
    acc <<= k;
    n -= k;
    if (n < fake) {
      short_data = true;
      fake = n;
    }
  }
  inline int get(int k) {
    if (k == 0) return 0;
    if (n < k) fill();
    int v = (int)(acc >> (64 - k));
    skip(k);
    return v;
  }
  inline int decode(const Huff& h) {
    if (n < 16) fill();
    int e = h.look[acc >> (64 - kLookBits)];
    if (e) {
      skip(e >> 8);
      return e & 0xFF;
    }
    uint32_t b16 = (uint32_t)(acc >> 48);
    for (int l = kLookBits + 1; l <= 16; l++) {
      int32_t code = (int32_t)(b16 >> (16 - l));
      if (code <= h.maxcode[l]) {
        skip(l);
        return h.vals[(code + h.valoffset[l]) & 0xFF];
      }
    }
    fail(CORRUPT);
  }
  // Restart: drop the bits left of the byte, as libjpeg's process_restart.
  void reset() {
    acc = 0;
    n = 0;
    fake = 0;
    marker = 0;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;          // blocks stored: the interleaved MCU grid's
  int wblocks = 0, hblocks = 0;  // blocks of the component's own extent
  int dw = 0, dh = 0;          // downsampled width and height
  bool latched = false;
  int16_t q[64] = {};          // natural order, as ISLOW_MULT_TYPE (short)
  std::vector<int16_t> coef;   // [bh][bw][64]
  int coef_bits[10];           // libjpeg's coef_bits of coefficients 0-9, -1 unknown
};

struct Decoder {
  const uint8_t* data;
  const uint8_t* end;
  const uint8_t* p;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  bool progressive = false, have_frame = false, saw_scan = false;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  int restart_interval = 0;
  uint16_t qt[4][64] = {};
  bool qt_defined[4] = {};
  Huff dc[4], ac[4];
  Component comp[4];

  Decoder(const uint8_t* d, int64_t n) : data(d), end(d + n), p(d) {}

  int byte() {
    if (p >= end) fail(TRUNCATED);
    return *p++;
  }
  int u16() {
    int a = byte();
    return (a << 8) | byte();
  }
  // next_marker: skip to an FF, past fill FFs, to a code that is not 0.
  int next_marker() {
    for (;;) {
      int c = byte();
      while (c != 0xFF) c = byte();
      do c = byte();
      while (c == 0xFF);
      if (c != 0) return c;
    }
  }
  const uint8_t* segment(int& len) {
    len = u16() - 2;
    if (len < 0) fail(CORRUPT);
    if (end - p < len) fail(TRUNCATED);
    const uint8_t* s = p;
    p += len;
    return s;
  }

  void read_sof(int marker) {
    int len;
    const uint8_t* s = segment(len);
    if (have_frame) fail(CORRUPT);
    if (len < 6) fail(CORRUPT);
    if (s[0] != 8) fail(PRECISION);
    height = (s[1] << 8) | s[2];
    width = (s[3] << 8) | s[4];
    ncomp = s[5];
    if (height <= 0 || width <= 0) fail(CORRUPT);
    if (ncomp != 1 && ncomp != 3 && ncomp != 4) fail(COMPONENTS);
    if (len < 6 + 3 * ncomp) fail(CORRUPT);
    progressive = marker == 0xC2;
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.id = s[6 + 3 * i];
      c.h = s[7 + 3 * i] >> 4;
      c.v = s[7 + 3 * i] & 15;
      c.tq = s[8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) fail(SAMPLING);
      if (c.tq > 3) fail(CORRUPT);
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    int mcux = (width + 8 * hmax - 1) / (8 * hmax);
    int mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.dw = (int)(((int64_t)width * c.h + hmax - 1) / hmax);
      c.dh = (int)(((int64_t)height * c.v + vmax - 1) / vmax);
      c.wblocks = (c.dw + 7) / 8;
      c.hblocks = (c.dh + 7) / 8;
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.coef.assign((size_t)c.bw * c.bh * 64, 0);
      for (int k = 0; k < 10; k++) c.coef_bits[k] = -1;
      // Every ratio must be integral (jdsample.c's JERR_FRACT_SAMPLE_NOTIMPL).
      if (hmax % c.h || vmax % c.v) fail(SAMPLING);
    }
    have_frame = true;
  }

  void read_dht() {
    int len;
    const uint8_t* s = segment(len);
    const uint8_t* e = s + len;
    while (s < e) {
      if (e - s < 17) fail(CORRUPT);
      int index = *s++;
      uint8_t bits[17] = {0};
      int count = 0;
      for (int l = 1; l <= 16; l++) count += bits[l] = *s++;
      if (count > 256 || count > e - s) fail(CORRUPT);
      bool is_ac = index & 0x10;
      index &= ~0x10;
      if (index < 0 || index > 3) fail(CORRUPT);
      (is_ac ? ac : dc)[index].set(bits, s, count);
      s += count;
    }
  }

  void read_dqt() {
    int len;
    const uint8_t* s = segment(len);
    const uint8_t* e = s + len;
    while (s < e) {
      int pq = *s >> 4, tq = *s & 15;
      s++;
      if (tq > 3 || pq > 1) fail(CORRUPT);
      if (e - s < 64 * (pq + 1)) fail(CORRUPT);
      for (int i = 0; i < 64; i++) {
        int v = pq ? (s[2 * i] << 8) | s[2 * i + 1] : s[i];
        qt[tq][kNatural[i]] = (uint16_t)v;
      }
      qt_defined[tq] = true;
      s += 64 * (pq + 1);
    }
  }

  void read_app(int marker) {
    int len;
    const uint8_t* s = segment(len);
    if (marker == 0xE0 && len >= 14 && !std::memcmp(s, "JFIF\0", 5)) jfif = true;
    if (marker == 0xEE && len >= 12 && !std::memcmp(s, "Adobe", 5)) {
      adobe = true;
      adobe_transform = s[11];
    }
  }

  // Reads up to the SOF and returns; used by jpeg_info.
  void header() {
    if (end - p < 2 || p[0] != 0xFF || p[1] != 0xD8) fail(NOT_JPEG);
    p += 2;
    while (!have_frame) dispatch(next_marker());
  }

  // One marker before, between or after the scans; false at EOI.
  bool dispatch(int m) {
    int len;
    switch (m) {
      case 0xC0: case 0xC1: case 0xC2:
        read_sof(m);
        return true;
      case 0xC3:
        fail(LOSSLESS);
      case 0xC5: case 0xC6: case 0xC7: case 0xDE: case 0xDF:
        fail(HIERARCHICAL);
      case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
        fail(ARITHMETIC);
      case 0xC4:
        read_dht();
        return true;
      case 0xDB:
        read_dqt();
        return true;
      case 0xDD: {
        const uint8_t* s = segment(len);
        if (len < 2) fail(CORRUPT);
        restart_interval = (s[0] << 8) | s[1];
        return true;
      }
      case 0xD8:
        fail(CORRUPT);  // a second SOI
      case 0xD9:
        return false;
      case 0xD0: case 0xD1: case 0xD2: case 0xD3: case 0xD4: case 0xD5: case 0xD6:
      case 0xD7: case 0x01:
        return true;  // parameterless, ignored as libjpeg does
      case 0xCC: case 0xDC: case 0xFE:
        segment(len);
        return true;
      default:
        if (m >= 0xE0 && m <= 0xEF) {
          read_app(m);
          return true;
        }
        fail(CORRUPT);
    }
  }

  void decode_all() {
    header();
    int m = next_marker();
    for (;;) {
      if (m == 0xDA) {
        m = scan();  // the marker that ended the scan's data, if it met one
        if (m == 0) m = next_marker();
        continue;
      }
      if (!dispatch(m)) break;
      m = next_marker();
    }
    if (!saw_scan) fail(CORRUPT);
    if (progressive) check_smoothing();
  }

  // jdcoefct.c's smoothing_ok: libjpeg smooths the blocks of a progressive
  // frame whose first AC coefficients are not all exact; not reproduced.
  void check_smoothing() {
    static const int pos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (int i = 0; i < ncomp; i++) {
      const Component& c = comp[i];
      if (!c.latched) return;
      for (int k : pos)
        if (c.q[k] == 0) return;
      if (c.coef_bits[0] < 0) return;
      for (int k = 1; k < 10; k++)
        if (c.coef_bits[k] != 0) useful = true;
    }
    if (useful) fail(SMOOTHING);
  }

  // One scan, from the SOS segment to the end of its data.  Returns the
  // marker that ended the data, or 0 if it must be searched for.
  int scan() {
    if (!have_frame) fail(CORRUPT);
    int len;
    const uint8_t* s = segment(len);
    if (len < 1) fail(CORRUPT);
    int ns = s[0];
    if (ns < 1 || ns > 4 || len != 4 + 2 * ns) fail(CORRUPT);
    int sc[4], td[4], ta[4];
    for (int i = 0; i < ns; i++) {
      int id = s[1 + 2 * i], ci = -1;
      for (int j = 0; j < ncomp; j++)
        if (comp[j].id == id) ci = j;
      if (ci < 0) fail(CORRUPT);
      for (int j = 0; j < i; j++)
        if (sc[j] == ci) fail(CORRUPT);
      sc[i] = ci;
      td[i] = s[2 + 2 * i] >> 4;
      ta[i] = s[2 + 2 * i] & 15;
      if (td[i] > 3 || ta[i] > 3) fail(CORRUPT);
    }
    int ss = s[1 + 2 * ns], se = s[2 + 2 * ns], ah = s[3 + 2 * ns] >> 4, al = s[3 + 2 * ns] & 15;
    if (!saw_scan) {  // jinit_huff_decoder: the standard tables fill empty slots
      if (!dc[0].defined) dc[0].set(kDcLumBits, kDcVals, 12);
      if (!dc[1].defined) dc[1].set(kDcChromBits, kDcVals, 12);
      if (!ac[0].defined) ac[0].set(kAcLumBits, kAcLumVals, 162);
      if (!ac[1].defined) ac[1].set(kAcChromBits, kAcChromVals, 162);
    }
    saw_scan = true;
    int blocks = 0;
    for (int i = 0; i < ns; i++) blocks += ns > 1 ? comp[sc[i]].h * comp[sc[i]].v : 1;
    if (blocks > 10) fail(CORRUPT);
    // latch_quant_tables: the table in force at the component's first scan.
    for (int i = 0; i < ns; i++) {
      Component& c = comp[sc[i]];
      if (c.latched) continue;
      if (!qt_defined[c.tq]) fail(CORRUPT);
      for (int k = 0; k < 64; k++) c.q[k] = (int16_t)qt[c.tq][k];
      c.latched = true;
    }
    enum { SEQ, DC_FIRST, DC_REFINE, AC_FIRST, AC_REFINE } mode = SEQ;
    if (progressive) {
      bool bad = false;
      if (ss == 0) {
        bad = se != 0;
      } else {
        bad = ss > se || se > 63 || ns != 1;
      }
      if (ah != 0 && al != ah - 1) bad = true;
      if (al > 13) bad = true;
      if (bad) fail(CORRUPT);
      mode = ss == 0 ? (ah ? DC_REFINE : DC_FIRST) : (ah ? AC_REFINE : AC_FIRST);
      for (int i = 0; i < ns; i++) {
        Component& c = comp[sc[i]];
        for (int k = ss; k <= std::min(se, 9); k++) c.coef_bits[k] = al;
      }
    }
    for (int i = 0; i < ns; i++) {
      bool need_dc = mode == SEQ || mode == DC_FIRST;
      bool need_ac = mode == SEQ || mode == AC_FIRST || mode == AC_REFINE;
      if (need_dc) {
        if (!dc[td[i]].defined) fail(CORRUPT);
        dc[td[i]].derive(true);
      }
      if (need_ac) {
        if (!ac[ta[i]].defined) fail(CORRUPT);
        ac[ta[i]].derive(false);
      }
    }

    int mcux, mcuy;
    if (ns == 1) {
      mcux = comp[sc[0]].wblocks;
      mcuy = comp[sc[0]].hblocks;
    } else {
      mcux = (width + 8 * hmax - 1) / (8 * hmax);
      mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    }
    Bits b{p, end};
    int pred[4] = {0, 0, 0, 0};
    int eobrun = 0;
    int togo = restart_interval, next_rst = 0;
    const int p1 = 1 << al, m1 = -(1 << al);
    for (int my = 0; my < mcuy; my++) {
      for (int mx = 0; mx < mcux; mx++) {
        if (restart_interval) {
          if (togo == 0) {
            if (b.short_data) fail(b.eof ? TRUNCATED : CORRUPT);
            int m = b.marker;
            if (!m) {
              p = b.p;
              m = next_marker();
              b.p = p;
            }
            if (m != 0xD0 + next_rst) fail(b.eof ? TRUNCATED : CORRUPT);
            next_rst = (next_rst + 1) & 7;
            b.reset();
            pred[0] = pred[1] = pred[2] = pred[3] = 0;
            eobrun = 0;
            togo = restart_interval;
          }
          togo--;
        }
        for (int i = 0; i < ns; i++) {
          Component& c = comp[sc[i]];
          int nh = ns > 1 ? c.h : 1, nv = ns > 1 ? c.v : 1;
          for (int by = 0; by < nv; by++) {
            for (int bx = 0; bx < nh; bx++) {
              int row = my * nv + by, col = mx * nh + bx;
              int16_t* blk = &c.coef[((size_t)row * c.bw + col) * 64];
              switch (mode) {
                case SEQ: {
                  int t = b.decode(dc[td[i]]);
                  pred[i] += t ? extend(b.get(t), t) : 0;
                  blk[0] = (int16_t)pred[i];
                  const Huff& h = ac[ta[i]];
                  for (int k = 1; k < 64; k++) {
                    int rs = b.decode(h);
                    int r = rs >> 4, sz = rs & 15;
                    if (sz) {
                      k += r;
                      blk[kNatural[k]] = (int16_t)extend(b.get(sz), sz);
                    } else {
                      if (r != 15) break;
                      k += 15;
                    }
                  }
                  break;
                }
                case DC_FIRST: {
                  int t = b.decode(dc[td[i]]);
                  pred[i] += t ? extend(b.get(t), t) : 0;
                  blk[0] = (int16_t)(pred[i] * (1 << al));
                  break;
                }
                case DC_REFINE:
                  if (b.get(1)) blk[0] = (int16_t)(blk[0] | p1);
                  break;
                case AC_FIRST: {
                  if (eobrun > 0) {
                    eobrun--;
                    break;
                  }
                  const Huff& h = ac[ta[i]];
                  for (int k = ss; k <= se; k++) {
                    int rs = b.decode(h);
                    int r = rs >> 4, sz = rs & 15;
                    if (sz) {
                      k += r;
                      blk[kNatural[k]] = (int16_t)(extend(b.get(sz), sz) * (1 << al));
                    } else if (r == 15) {
                      k += 15;
                    } else {
                      eobrun = 1 << r;
                      if (r) eobrun += b.get(r);
                      eobrun--;
                      break;
                    }
                  }
                  break;
                }
                case AC_REFINE:
                  refine_ac(b, ac[ta[i]], blk, ss, se, p1, m1, eobrun);
                  break;
              }
            }
          }
        }
      }
    }
    if (b.short_data) fail(b.eof ? TRUNCATED : CORRUPT);
    p = b.p;
    return b.marker;
  }

  // decode_mcu_AC_refine of jdphuff.c.
  static void refine_ac(Bits& b, const Huff& h, int16_t* blk, int ss, int se, int p1, int m1,
                        int& eobrun) {
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; k++) {
        int rs = b.decode(h);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = b.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += b.get(r);
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            if (b.get(1) && (*coef & p1) == 0) *coef = (int16_t)(*coef + (*coef >= 0 ? p1 : m1));
          } else if (--r < 0) {
            break;
          }
          k++;
        } while (k <= se);
        if (s) blk[kNatural[k]] = (int16_t)s;
      }
    }
    if (eobrun > 0) {
      for (; k <= se; k++) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0 && b.get(1) && (*coef & p1) == 0)
          *coef = (int16_t)(*coef + (*coef >= 0 ? p1 : m1));
      }
      eobrun--;
    }
  }
};

// jidctint.c's jpeg_idct_islow, into an 8x8 block of `out` (row stride
// `stride`), with its range-limit table.
uint8_t kIdctLimit[1024];
struct IdctLimitInit {
  IdctLimitInit() {
    for (int i = 0; i < 1024; i++) {
      int x = i < 512 ? i : i - 1024;
      kIdctLimit[i] = (uint8_t)std::clamp(x + 128, 0, 255);
    }
  }
} idct_limit_init;

constexpr int CONST_BITS = 13, PASS1_BITS = 2;
constexpr int64_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270, F0_899 = 7373,
                  F1_175 = 9633, F1_501 = 12299, F1_847 = 15137, F1_961 = 16069,
                  F2_053 = 16819, F2_562 = 20995, F3_072 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; }

void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* ip = in + c;
    const int16_t* qp = q + c;
    int* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      int dcval = (ip[0] * qp[0]) * (1 << PASS1_BITS);
      for (int r = 0; r < 8; r++) wp[8 * r] = dcval;
      continue;
    }
    int64_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * -F1_847;
    int64_t tmp3 = z1 + z2 * F0_765;
    z2 = ip[0] * qp[0];
    z3 = ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = ip[56] * qp[56];
    tmp1 = ip[40] * qp[40];
    tmp2 = ip[24] * qp[24];
    tmp3 = ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = CONST_BITS - PASS1_BITS;
    wp[0] = (int)descale(tmp10 + tmp3, n);
    wp[56] = (int)descale(tmp10 - tmp3, n);
    wp[8] = (int)descale(tmp11 + tmp2, n);
    wp[48] = (int)descale(tmp11 - tmp2, n);
    wp[16] = (int)descale(tmp12 + tmp1, n);
    wp[40] = (int)descale(tmp12 - tmp1, n);
    wp[24] = (int)descale(tmp13 + tmp0, n);
    wp[32] = (int)descale(tmp13 - tmp0, n);
  }
  for (int r = 0; r < 8; r++) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + (size_t)r * stride;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
      uint8_t v = kIdctLimit[(int)descale(wp[0], PASS1_BITS + 3) & 1023];
      std::memset(op, v, 8);
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * -F1_847;
    int64_t tmp3 = z1 + z2 * F0_765;
    int64_t tmp0 = ((int64_t)wp[0] + wp[4]) * (1 << CONST_BITS);
    int64_t tmp1 = ((int64_t)wp[0] - wp[4]) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = CONST_BITS + PASS1_BITS + 3;
    op[0] = kIdctLimit[(int)descale(tmp10 + tmp3, n) & 1023];
    op[7] = kIdctLimit[(int)descale(tmp10 - tmp3, n) & 1023];
    op[1] = kIdctLimit[(int)descale(tmp11 + tmp2, n) & 1023];
    op[6] = kIdctLimit[(int)descale(tmp11 - tmp2, n) & 1023];
    op[2] = kIdctLimit[(int)descale(tmp12 + tmp1, n) & 1023];
    op[5] = kIdctLimit[(int)descale(tmp12 - tmp1, n) & 1023];
    op[3] = kIdctLimit[(int)descale(tmp13 + tmp0, n) & 1023];
    op[4] = kIdctLimit[(int)descale(tmp13 - tmp0, n) & 1023];
  }
}

// jdcolor.c's build_ycc_rgb_table (SCALEBITS 16).
int kCrR[256], kCbB[256];
int64_t kCrG[256], kCbG[256];
struct YccInit {
  YccInit() {
    for (int i = 0; i < 256; i++) {
      int64_t x = i - 128;
      kCrR[i] = (int)((91881 * x + 32768) >> 16);
      kCbB[i] = (int)((116130 * x + 32768) >> 16);
      kCrG[i] = -46802 * x;
      kCbG[i] = -22554 * x + 32768;
    }
  }
} ycc_init;

inline uint8_t clamp8(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

// One component's samples after the IDCT, and its upsampling to full size.
struct Plane {
  const Component* c;
  std::vector<uint8_t> px;  // [bh * 8][bw * 8]
  int stride = 0;
  enum { FULL, H2V1, H1V2, H2V2, BOX } kind = FULL;
  int rh = 1, rv = 1;
  std::vector<uint8_t> row;   // one upsampled row
  std::vector<int> colsum;

  const uint8_t* at(int r) const { return px.data() + (size_t)r * stride; }

  void setup(const Component& comp, int hmax, int vmax, int width) {
    c = &comp;
    stride = comp.bw * 8;
    rh = hmax / comp.h;
    rv = vmax / comp.v;
    if (rh == 1 && rv == 1) kind = FULL;
    else if (rh == 2 && rv == 1 && comp.dw > 2) kind = H2V1;
    else if (rh == 1 && rv == 2) kind = H1V2;
    else if (rh == 2 && rv == 2 && comp.dw > 2) kind = H2V2;
    else kind = BOX;
    row.assign((size_t)std::max(width, 2 * comp.dw) + 16, 0);
    colsum.assign((size_t)comp.dw + 2, 0);
  }

  // The upsampled row y of the full-size image.
  const uint8_t* upsample(int y, int width) {
    const int dw = c->dw, dh = c->dh;
    uint8_t* out = row.data();
    switch (kind) {
      case FULL:
        return at(y);
      case H2V1: {
        const uint8_t* in = at(y);
        out[0] = in[0];
        out[1] = (uint8_t)((in[0] * 3 + in[1] + 2) >> 2);
        for (int x = 1; x < dw - 1; x++) {
          int v = in[x] * 3;
          out[2 * x] = (uint8_t)((v + in[x - 1] + 1) >> 2);
          out[2 * x + 1] = (uint8_t)((v + in[x + 1] + 2) >> 2);
        }
        int x = dw - 1;
        out[2 * x] = (uint8_t)((in[x] * 3 + in[x - 1] + 1) >> 2);
        out[2 * x + 1] = in[x];
        return out;
      }
      case H1V2: {
        int r = y >> 1;
        const uint8_t* in0 = at(r);
        const uint8_t* in1 = at((y & 1) ? std::min(r + 1, dh - 1) : std::max(r - 1, 0));
        int bias = (y & 1) ? 2 : 1;
        for (int x = 0; x < dw; x++) out[x] = (uint8_t)((in0[x] * 3 + in1[x] + bias) >> 2);
        return out;
      }
      case H2V2: {
        int r = y >> 1;
        const uint8_t* in0 = at(r);
        const uint8_t* in1 = at((y & 1) ? std::min(r + 1, dh - 1) : std::max(r - 1, 0));
        int* cs = colsum.data();
        for (int x = 0; x < dw; x++) cs[x] = in0[x] * 3 + in1[x];
        out[0] = (uint8_t)((cs[0] * 4 + 8) >> 4);
        out[1] = (uint8_t)((cs[0] * 3 + cs[1] + 7) >> 4);
        for (int x = 1; x < dw - 1; x++) {
          out[2 * x] = (uint8_t)((cs[x] * 3 + cs[x - 1] + 8) >> 4);
          out[2 * x + 1] = (uint8_t)((cs[x] * 3 + cs[x + 1] + 7) >> 4);
        }
        int x = dw - 1;
        out[2 * x] = (uint8_t)((cs[x] * 3 + cs[x - 1] + 8) >> 4);
        out[2 * x + 1] = (uint8_t)((cs[x] * 4 + 7) >> 4);
        return out;
      }
      case BOX: {
        const uint8_t* in = at(y / rv);
        for (int x = 0; x < width; x++) out[x] = in[x / rh];
        return out;
      }
    }
    return out;
  }
};

void render(Decoder& d, bool rgb, uint8_t* out) {
  const int W = d.width, H = d.height, nc = d.ncomp;
  Plane planes[4];
  for (int i = 0; i < nc; i++) {
    const Component& c = d.comp[i];
    Plane& pl = planes[i];
    pl.setup(c, d.hmax, d.vmax, W);
    pl.px.assign((size_t)c.bh * 8 * pl.stride, 0);
    for (int by = 0; by < c.hblocks; by++)
      for (int bx = 0; bx < c.wblocks; bx++)
        idct_islow(&c.coef[((size_t)by * c.bw + bx) * 64], c.q,
                   pl.px.data() + (size_t)by * 8 * pl.stride + bx * 8, pl.stride);
  }
  // libjpeg-turbo's jpeg_color_space (default_decompress_parms).
  bool ycc = false, ycck = false;
  if (nc == 3) {
    if (d.jfif) ycc = true;
    else if (d.adobe) ycc = d.adobe_transform != 0;
    else ycc = !(d.comp[0].id == 82 && d.comp[1].id == 71 && d.comp[2].id == 66);
  } else if (nc == 4) {
    ycck = d.adobe && d.adobe_transform != 0;
  }
  const int oc = rgb ? 3 : nc;
  for (int y = 0; y < H; y++) {
    const uint8_t* r[4];
    for (int i = 0; i < nc; i++) r[i] = planes[i].upsample(y, W);
    uint8_t* o = out + (size_t)y * W * oc;
    if (nc == 1) {
      if (rgb)
        for (int x = 0; x < W; x++) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = r[0][x];
      else
        std::memcpy(o, r[0], W);
    } else if (nc == 3) {
      if (ycc) {
        for (int x = 0; x < W; x++) {
          int yy = r[0][x], cb = r[1][x], cr = r[2][x];
          o[3 * x] = clamp8(yy + kCrR[cr]);
          o[3 * x + 1] = clamp8(yy + (int)((kCbG[cb] + kCrG[cr]) >> 16));
          o[3 * x + 2] = clamp8(yy + kCbB[cb]);
        }
      } else {
        for (int x = 0; x < W; x++) {
          o[3 * x] = r[0][x];
          o[3 * x + 1] = r[1][x];
          o[3 * x + 2] = r[2][x];
        }
      }
    } else {
      for (int x = 0; x < W; x++) {
        int k[4];
        if (ycck) {  // ycck_cmyk_convert
          int yy = r[0][x], cb = r[1][x], cr = r[2][x];
          k[0] = clamp8(255 - (yy + kCrR[cr]));
          k[1] = clamp8(255 - (yy + (int)((kCbG[cb] + kCrG[cr]) >> 16)));
          k[2] = clamp8(255 - (yy + kCbB[cb]));
        } else {
          k[0] = r[0][x];
          k[1] = r[1][x];
          k[2] = r[2][x];
        }
        k[3] = r[3][x];
        for (int j = 0; j < 4; j++) k[j] = 255 - k[j];  // Pillow's "CMYK;I"
        if (!rgb) {
          for (int j = 0; j < 4; j++) o[4 * x + j] = (uint8_t)k[j];
        } else {  // Pillow's cmyk2rgb
          int nk = 255 - k[3];
          for (int j = 0; j < 3; j++) {
            int t = k[j] * nk + 128;
            o[3 * x + j] = clamp8(nk - (((t >> 8) + t) >> 8));
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

int jpeg_info(const uint8_t* data, int64_t n, int32_t* info) {
  try {
    Decoder d(data, n);
    d.header();
    info[0] = d.height;
    info[1] = d.width;
    info[2] = d.ncomp;
    return OK;
  } catch (const Fail& f) {
    return f.code;
  } catch (...) {
    return CORRUPT;
  }
}

int jpeg_decode(const uint8_t* data, int64_t n, int rgb, uint8_t* out, int64_t out_size) {
  try {
    Decoder d(data, n);
    d.decode_all();
    int64_t need = (int64_t)d.height * d.width * (rgb ? 3 : d.ncomp);
    if (out_size != need) return BUFFER;
    render(d, rgb != 0, out);
    return OK;
  } catch (const Fail& f) {
    return f.code;
  } catch (...) {
    return CORRUPT;
  }
}

}  // extern "C"
