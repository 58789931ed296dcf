// The port's image codec: JPEG decode and encode, PNG unfilter, written
// here with no library beyond the C++ standard one.
//
// The JAX package reads images with cv2.imread / cv2.imdecode (libjpeg-turbo
// and libpng inside OpenCV) and writes them with cv2.imwrite.  The port
// imports no OpenCV and links no image library, so this file holds the
// arithmetic of libjpeg-turbo's default paths as OpenCV drives them:
//
//   decode  baseline and progressive Huffman JPEG (spectral selection,
//           successive approximation, restart intervals), 1, 3 or 4
//           components at any integral sampling; jidctint.c's ISLOW IDCT
//           with its range limit; jdsample.c's fancy upsampling (h2v1,
//           h1v2, h2v2 triangle filters with their alternating biases,
//           replication for other factors and for chroma 2 samples wide
//           or less); jdcolor.c's table-driven YCbCr->RGB, greyscale
//           replicated, CMYK / YCCK to RGB with OpenCV's formula.
//           Arithmetic coding, 12-bit and lossless JPEG are refused.
//   encode  what jpeg_set_defaults + jpeg_set_quality(q, TRUE) write for an
//           RGB image: JFIF APP0, the scaled standard quantisation tables,
//           4:2:0 with jcsample.c's h2v2 bias and edge replication,
//           jccolor.c's RGB->YCbCr, jfdctint.c's ISLOW FDCT, jcdctmgr.c's
//           reciprocal quantiser and the standard Huffman tables.
//   PNG     unfilter (types 0-4) and Adam7 de-interlace of the inflated
//           IDAT stream (inflated by the caller with Python's zlib), then
//           RGB8 as cv2.imdecode(IMREAD_COLOR) gives it: 16-bit samples
//           keep their high byte, grey of 1/2/4 bits scales to 8, palette
//           indices expand, alpha and tRNS are dropped, gAMA is ignored.
//
// libjpeg's warnings about corrupt data (a bad Huffman code, a marker
// inside a scan, a truncated file, a bad progression, a restart marker out
// of sequence) are errors here, as the libjpeg-backed decoder this file
// replaced made them; extraneous bytes before a marker, which lose no
// pixel, are allowed.  An incomplete progressive file, which libjpeg would
// smooth between blocks, is refused.
//
// C interface, called through ctypes (which releases the GIL); each
// returns 0, or -1 with a message in err:
//   vd_jpeg_header(data, size, &width, &height, err, err_len)
//   vd_jpeg_decode(data, size, out, width, height, err, err_len)
//   vd_jpeg_encode(rgb, width, height, quality, out, capacity, &size, err, err_len)
//   vd_png_unfilter(raw, size, width, height, bit_depth, color_type,
//                   interlace, palette, palette_len, out, err, err_len)
// and vd_png_raw_size(width, height, bit_depth, color_type, interlace), the
// inflated size of a valid header's rows (no error to report).
//
// Motion-JPEG video (the frames of an AVI that native/avi.py has indexed):
//   vd_frame_transform(rgb, ih, iw, out, h, w, letterbox, normalize, affine)
//           data/transforms.py's ValTransform on one uint8 RGB frame, bit for
//           bit: OpenCV's uint8 INTER_LINEAR resize in its integer
//           arithmetic (transforms.py _resize), the letterbox's 128 border,
//           and the ImageNet normalisation in float32, step by step
//   vd_video_open(path, offsets, sizes, indices, n, h, w, letterbox,
//                 normalize, capacity, err, err_len) -> handle or null
//           starts a thread that reads each listed frame, decodes and
//           transforms it into a ring of `capacity` frames
//   vd_video_next(handle, out, affine, &index, err, err_len)
//           blocks for the next frame: 1 and the frame, 0 at the end or
//           after vd_video_stop, -1 and the message of the frame that failed
//   vd_video_stop(handle) wakes both sides; vd_video_free(handle) joins the
//           thread and frees (never while a vd_video_next call is running).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -ffp-contract=off codec.cpp
//        -o libviddet_codec.so -pthread

#include <algorithm>
#include <array>
#include <cmath>
#include <condition_variable>
#include <mutex>
#include <new>
#include <thread>
#include <cstdarg>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct CodecError {
  std::string msg;
};

[[noreturn]] __attribute__((format(printf, 1, 2))) void fail(const char* fmt, ...) {
  char buf[256];
  va_list ap;
  va_start(ap, fmt);
  std::vsnprintf(buf, sizeof(buf), fmt, ap);
  va_end(ap);
  throw CodecError{buf};
}

// Zigzag index -> natural index, with the 16 extra entries libjpeg keeps so
// that a corrupt run past 63 lands on 63 instead of outside the block.
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// The standard Huffman tables (ITU T.81 K.3): counts per code length 1..16,
// then the symbols.
const uint8_t kDcLumBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// The standard quantisation tables (T.81 K.1, K.2), natural order.
const int kLumQuant[64] = {16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
                           14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
                           18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
                           49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kChromQuant[64] = {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
                             24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
                             99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
                             99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// jidctint.c / jfdctint.c constants (CONST_BITS 13).
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int32_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
                  FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
                  FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int32_t descale(int32_t x, int n) { return (x + (int32_t(1) << (n - 1))) >> n; }
inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

// ---------------------------------------------------------------------------
// Shared tables: the IDCT's range limit and the colour converters.
// ---------------------------------------------------------------------------

struct Tables {
  // jdmaster.c prepare_range_limit_table: idct_limit[x & 1023] for the IDCT
  // (x is the descaled output, centred on 0), and clamp of -256..511.
  uint8_t idct_limit[1024];
  uint8_t clamp_storage[256 + 256 + 256];
  const uint8_t* clamp;  // clamp[x] for x in [-256, 511]
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  int32_t rgb_ycc[8 * 256];

  Tables() {
    for (int x = 0; x < 1024; ++x) {
      int v = x < 512 ? x : x - 1024;  // the mask keeps 10 bits: sign-extend them
      idct_limit[x] = static_cast<uint8_t>(std::min(255, std::max(0, v + 128)));
    }
    for (int i = 0; i < 768; ++i) clamp_storage[i] = static_cast<uint8_t>(std::min(255, std::max(0, i - 256)));
    clamp = clamp_storage + 256;
    // jdcolor.c build_ycc_rgb_table (SCALEBITS 16).
    const int64_t one_half = int64_t(1) << 15;
    auto fix = [](double v) { return static_cast<int64_t>(v * 65536.0 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = static_cast<int32_t>(-fix(0.71414) * x);
      cb_g[i] = static_cast<int32_t>(-fix(0.34414) * x + one_half);
    }
    // jccolor.c rgb_ycc_start: R_Y, G_Y, B_Y, R_CB, G_CB, B_CB(=R_CR), G_CR, B_CR.
    const int64_t cbcr_offset = int64_t(128) << 16;
    for (int i = 0; i < 256; ++i) {
      rgb_ycc[0 * 256 + i] = static_cast<int32_t>(fix(0.29900) * i);
      rgb_ycc[1 * 256 + i] = static_cast<int32_t>(fix(0.58700) * i);
      rgb_ycc[2 * 256 + i] = static_cast<int32_t>(fix(0.11400) * i + one_half);
      rgb_ycc[3 * 256 + i] = static_cast<int32_t>(-fix(0.16874) * i);
      rgb_ycc[4 * 256 + i] = static_cast<int32_t>(-fix(0.33126) * i);
      rgb_ycc[5 * 256 + i] = static_cast<int32_t>(fix(0.50000) * i + cbcr_offset + one_half - 1);
      rgb_ycc[6 * 256 + i] = static_cast<int32_t>(-fix(0.41869) * i);
      rgb_ycc[7 * 256 + i] = static_cast<int32_t>(-fix(0.08131) * i);
    }
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

// ---------------------------------------------------------------------------
// JPEG decode
// ---------------------------------------------------------------------------

struct HuffTable {
  bool present = false;
  uint8_t bits[17] = {};  // bits[l]: codes of length l
  uint8_t vals[256] = {};
  int32_t maxcode[18];
  int32_t valoffset[17];
  uint16_t fast[512];  // 9-bit lookahead: (length << 8) | symbol, 0 when longer

  void set(const uint8_t* counts16, const uint8_t* symbols, int n, bool dc) {
    int total = 0;
    for (int l = 1; l <= 16; ++l) total += bits[l] = counts16[l - 1];
    if (total > 256 || total != n) fail("bad Huffman table");
    std::memcpy(vals, symbols, n);
    if (dc)
      for (int i = 0; i < n; ++i)
        if (vals[i] > 15) fail("bad Huffman table (DC symbol %d)", vals[i]);
    int32_t code = 0;
    int k = 0;
    std::fill(fast, fast + 512, 0);
    for (int l = 1; l <= 16; ++l) {
      // jdhuff.c: the codes of a length must fit in it, and none be all ones
      if (bits[l] && code + bits[l] >= (int32_t(1) << l)) fail("bad Huffman table (code overflow)");
      valoffset[l] = k - code;
      for (int i = 0; i < bits[l]; ++i, ++k, ++code) {
        if (l <= 9) {
          int shift = 9 - l;
          for (int j = 0; j < (1 << shift); ++j)
            fast[(code << shift) | j] = static_cast<uint16_t>((l << 8) | vals[k]);
        }
      }
      maxcode[l] = bits[l] ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    present = true;
  }
};

struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t pos;  // next byte to read; at a marker's 0xFF once one is hit
  uint64_t acc = 0;
  int nbits = 0;
  int virt = 0;  // zero bits appended past a marker
  bool marker_hit = false;

  void reset() {
    acc = 0;
    nbits = virt = 0;
    marker_hit = false;
  }

  void fill() {
    while (nbits <= 56) {
      if (marker_hit) {
        acc <<= 8;
        nbits += 8;
        virt += 8;
        continue;
      }
      if (pos >= size) fail("premature end of JPEG data (truncated file)");
      uint8_t b = data[pos];
      if (b == 0xFF) {
        size_t p = pos + 1;
        while (p < size && data[p] == 0xFF) ++p;
        if (p >= size) fail("premature end of JPEG data (truncated file)");
        if (data[p] == 0) {
          acc = (acc << 8) | 0xFF;
          nbits += 8;
          pos = p + 1;
        } else {
          marker_hit = true;  // pos stays on the marker
        }
        continue;
      }
      acc = (acc << 8) | b;
      nbits += 8;
      ++pos;
    }
  }

  inline uint32_t peek(int n) {
    if (nbits < n) fill();
    return static_cast<uint32_t>(acc >> (nbits - n)) & ((1u << n) - 1);
  }

  inline void consume(int n) {
    nbits -= n;
    if (nbits < virt) fail("corrupt JPEG data: premature end of data segment");
  }

  inline int bits(int n) {
    if (n == 0) return 0;
    uint32_t v = peek(n);
    consume(n);
    return static_cast<int>(v);
  }

  inline int decode(const HuffTable& t) {
    uint32_t look = peek(16);
    uint16_t f = t.fast[look >> 7];
    if (f) {
      consume(f >> 8);
      return f & 0xFF;
    }
    for (int l = 10; l <= 16; ++l) {
      int32_t code = static_cast<int32_t>(look >> (16 - l));
      if (code <= t.maxcode[l]) {
        consume(l);
        return t.vals[(t.valoffset[l] + code) & 0xFF];
      }
    }
    fail("corrupt JPEG data: bad Huffman code");
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }
// A corrupt file's DC differences may push the predictor past the range
// of int; libjpeg-turbo lets it wrap (jdhuff.c), and so does this.

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int dw = 0, dh = 0;    // downsampled size
  int wib = 0, hib = 0;  // width / height in blocks (unpadded)
  int bw = 0, bh = 0;    // blocks allocated, padded to whole MCUs
  bool quant_latched = false;
  uint16_t quant[64];
  int coef_bits[64];
  std::vector<int16_t> coef;
  int pred = 0;
};

enum class ColorSpace { kGray, kYCbCr, kRGB, kCMYK, kYCCK };

struct JpegDecoder {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;
  bool header_only;

  int width = 0, height = 0;
  bool have_sof = false, progressive = false, saw_scan = false;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  int max_h = 1, max_v = 1, mcus_x = 0, mcus_y = 0;
  int restart_interval = 0;
  std::vector<Component> comps;
  bool qt_present[4] = {};
  uint16_t qt[4][64];
  HuffTable dc_tables[4], ac_tables[4];

  JpegDecoder(const uint8_t* d, size_t n, bool header) : data(d), size(n), header_only(header) {
    // libjpeg-turbo installs the standard tables for files without DHT
    // (Motion-JPEG frames); a DHT segment replaces them.
    dc_tables[0].set(kDcLumBits, kDcVals, 12, true);
    dc_tables[1].set(kDcChromBits, kDcVals, 12, true);
    ac_tables[0].set(kAcLumBits, kAcLumVals, 162, false);
    ac_tables[1].set(kAcChromBits, kAcChromVals, 162, false);
  }

  int u8() {
    if (pos >= size) fail("premature end of JPEG data (truncated header)");
    return data[pos++];
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }

  // jdmarker.c next_marker: skip garbage, then 0xFF fill bytes.
  int next_marker() {
    while (true) {
      while (pos < size && data[pos] != 0xFF) ++pos;
      if (pos >= size) fail("premature end of JPEG data (no EOI marker)");
      while (pos < size && data[pos] == 0xFF) ++pos;
      if (pos >= size) fail("premature end of JPEG data (no EOI marker)");
      int m = data[pos++];
      if (m != 0) return m;
      // FF 00 outside a scan is garbage too
    }
  }

  size_t segment_end() {
    int len = u16();
    if (len < 2) fail("bad JPEG marker length %d", len);
    size_t end = pos + static_cast<size_t>(len) - 2;
    if (end > size) fail("premature end of JPEG data (truncated segment)");
    return end;
  }

  void read_dqt() {
    size_t end = segment_end();
    while (pos < end) {
      int pq_tq = u8();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq >= 4 || pq > 1) fail("bad DQT table %d", pq_tq);
      for (int i = 0; i < 64; ++i) qt[tq][kNatural[i]] = static_cast<uint16_t>(pq ? u16() : u8());
      qt_present[tq] = true;
    }
    if (pos != end) fail("bad DQT length");
  }

  void read_dht() {
    size_t end = segment_end();
    while (pos < end) {
      int index = u8();
      uint8_t counts[16];
      int total = 0;
      for (int i = 0; i < 16; ++i) total += counts[i] = static_cast<uint8_t>(u8());
      if (total > 256 || pos + total > end) fail("bad DHT segment");
      int tc = index >> 4, th = index & 15;
      if (tc > 1 || th >= 4) fail("bad DHT table index %d", index);
      (tc ? ac_tables : dc_tables)[th].set(counts, data + pos, total, tc == 0);
      pos += total;
    }
    if (pos != end) fail("bad DHT length");
  }

  void read_sof(int marker) {
    if (have_sof) fail("JPEG holds two frame headers");
    size_t end = segment_end();
    int precision = u8();
    if (precision != 8) fail("%d-bit JPEG is not supported (8-bit only)", precision);
    height = u16();
    width = u16();
    int n = u8();
    if (height <= 0 || width <= 0) fail("empty JPEG image (%dx%d)", width, height);
    if (n != 1 && n != 3 && n != 4) fail("JPEG with %d components is not supported", n);
    comps.resize(n);
    for (auto& c : comps) {
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) fail("bad JPEG sampling factors");
    }
    if (pos != end) fail("bad SOF length");
    progressive = marker == 0xC2;
    for (auto& c : comps) {
      max_h = std::max(max_h, c.h);
      max_v = std::max(max_v, c.v);
    }
    for (auto& c : comps)
      if (max_h % c.h || max_v % c.v) fail("fractional JPEG sampling is not supported");
    mcus_x = (width + 8 * max_h - 1) / (8 * max_h);
    mcus_y = (height + 8 * max_v - 1) / (8 * max_v);
    for (auto& c : comps) {
      c.dw = static_cast<int>((int64_t(width) * c.h + max_h - 1) / max_h);
      c.dh = static_cast<int>((int64_t(height) * c.v + max_v - 1) / max_v);
      c.wib = (c.dw + 7) / 8;
      c.hib = (c.dh + 7) / 8;
      c.bw = mcus_x * c.h;
      c.bh = mcus_y * c.v;
      std::fill(c.coef_bits, c.coef_bits + 64, -1);
    }
    have_sof = true;
  }

  void read_app(int marker) {
    size_t end = segment_end();
    size_t len = end - pos;
    const uint8_t* p = data + pos;
    if (marker == 0xE0 && len >= 14 && std::memcmp(p, "JFIF\0", 5) == 0) jfif = true;
    if (marker == 0xEE && len >= 12 && std::memcmp(p, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = p[11];
    }
    pos = end;
  }

  ColorSpace color_space() const {
    // jdapimin.c default_decompress_parms
    if (comps.size() == 1) return ColorSpace::kGray;
    if (comps.size() == 3) {
      if (jfif) return ColorSpace::kYCbCr;
      if (adobe) return adobe_transform == 0 ? ColorSpace::kRGB : ColorSpace::kYCbCr;
      if (comps[0].id == 82 && comps[1].id == 71 && comps[2].id == 66) return ColorSpace::kRGB;
      return ColorSpace::kYCbCr;
    }
    if (adobe) return adobe_transform == 0 ? ColorSpace::kCMYK : ColorSpace::kYCCK;
    return ColorSpace::kCMYK;
  }

  void decode_scan() {
    if (!have_sof) fail("JPEG scan before the frame header");
    size_t end = segment_end();
    int ns = u8();
    if (ns < 1 || ns > 4 || ns > static_cast<int>(comps.size())) fail("bad JPEG scan (%d components)", ns);
    Component* sc[4];
    for (int i = 0; i < ns; ++i) {
      int id = u8(), t = u8();
      Component* found = nullptr;
      for (auto& c : comps)
        if (c.id == id) found = &c;
      if (!found) fail("JPEG scan names unknown component %d", id);
      for (int j = 0; j < i; ++j)
        if (sc[j] == found) fail("JPEG scan names component %d twice", id);
      found->td = t >> 4;
      found->ta = t & 15;
      if (found->td > 3 || found->ta > 3) fail("bad JPEG scan table index");
      sc[i] = found;
    }
    int ss = u8(), se = u8(), ahl = u8();
    int ah = ahl >> 4, al = ahl & 15;
    if (pos != end) fail("bad SOS length");

    if (progressive) {
      bool bad = false;
      if (ss == 0) {
        if (se != 0) bad = true;
      } else {
        if (ss > se || se > 63 || ns != 1) bad = true;
      }
      if (ah != 0 && al != ah - 1) bad = true;
      if (al > 13) bad = true;
      if (bad) fail("invalid progressive JPEG scan (Ss=%d Se=%d Ah=%d Al=%d)", ss, se, ah, al);
      for (int i = 0; i < ns; ++i) {
        int* cb = sc[i]->coef_bits;
        if (ss != 0 && cb[0] < 0) fail("corrupt progressive JPEG: AC scan before DC");
        for (int k = ss; k <= se; ++k) {
          int expected = cb[k] < 0 ? 0 : cb[k];
          if (ah != expected) fail("corrupt progressive JPEG: bad successive approximation");
          cb[k] = al;
        }
      }
    } else if (ss != 0 || se != 63 || ah != 0 || al != 0) {
      fail("corrupt JPEG: invalid sequential scan parameters");
    }

    int blocks_in_mcu = 0;
    for (int i = 0; i < ns; ++i) {
      Component& c = *sc[i];
      if (!c.quant_latched) {
        if (!qt_present[c.tq]) fail("JPEG quantisation table %d is missing", c.tq);
        std::memcpy(c.quant, qt[c.tq], sizeof(c.quant));
        c.quant_latched = true;
      }
      if (c.coef.empty()) c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
      c.pred = 0;
      blocks_in_mcu += ns == 1 ? 1 : c.h * c.v;
      bool need_dc = !progressive || (ss == 0 && ah == 0);
      bool need_ac = !progressive || ss != 0;
      if (need_dc && !dc_tables[c.td].present) fail("JPEG Huffman table DC%d is missing", c.td);
      if (need_ac && !ac_tables[c.ta].present) fail("JPEG Huffman table AC%d is missing", c.ta);
    }
    if (blocks_in_mcu > 10) fail("bad JPEG MCU size");
    saw_scan = true;

    BitReader br{data, size, pos};
    int eobrun = 0;
    const int restart = restart_interval;
    int restarts_to_go = restart, next_rst = 0;
    const int mx = ns == 1 ? sc[0]->wib : mcus_x;
    const int my = ns == 1 ? sc[0]->hib : mcus_y;

    auto block_at = [](Component& c, int bx, int by) { return &c.coef[(static_cast<size_t>(by) * c.bw + bx) * 64]; };

    auto decode_block = [&](Component& c, int16_t* blk) {
      if (!progressive) {
        int s = br.decode(dc_tables[c.td]);
        int diff = s ? extend(br.bits(s), s) : 0;
        c.pred = static_cast<int>(static_cast<unsigned>(c.pred) + static_cast<unsigned>(diff));
        blk[0] = static_cast<int16_t>(c.pred);
        const HuffTable& ac = ac_tables[c.ta];
        for (int k = 1; k < 64; ++k) {
          int rs = br.decode(ac);
          int r = rs >> 4, sz = rs & 15;
          if (sz) {
            k += r;
            blk[kNatural[k]] = static_cast<int16_t>(extend(br.bits(sz), sz));
          } else {
            if (r != 15) break;
            k += 15;
          }
        }
        return;
      }
      if (ss == 0) {
        if (ah == 0) {
          int s = br.decode(dc_tables[c.td]);
          int diff = s ? extend(br.bits(s), s) : 0;
          c.pred = static_cast<int>(static_cast<unsigned>(c.pred) + static_cast<unsigned>(diff));
          blk[0] = static_cast<int16_t>(static_cast<uint32_t>(c.pred) << al);
        } else if (br.bits(1)) {
          blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
        }
        return;
      }
      const HuffTable& ac = ac_tables[c.ta];
      if (ah == 0) {  // AC first pass
        if (eobrun > 0) {
          --eobrun;
          return;
        }
        for (int k = ss; k <= se; ++k) {
          int rs = br.decode(ac);
          int r = rs >> 4, s = rs & 15;
          if (s) {
            k += r;
            blk[kNatural[k]] = static_cast<int16_t>(static_cast<uint32_t>(extend(br.bits(s), s)) << al);
          } else if (r == 15) {
            k += 15;
          } else {
            eobrun = 1 << r;
            if (r) eobrun += br.bits(r);
            --eobrun;
            break;
          }
        }
        return;
      }
      // AC refinement (jdphuff.c decode_mcu_AC_refine)
      const int p1 = 1 << al, m1 = -1 * (1 << al);
      int k = ss;
      if (eobrun == 0) {
        for (; k <= se; ++k) {
          int rs = br.decode(ac);
          int r = rs >> 4, s = rs & 15;
          if (s) {
            if (s != 1) fail("corrupt JPEG data: bad Huffman code");
            s = br.bits(1) ? p1 : m1;
          } else if (r != 15) {
            eobrun = 1 << r;
            if (r) eobrun += br.bits(r);
            break;
          }
          do {
            int16_t* coef = blk + kNatural[k];
            if (*coef != 0) {
              if (br.bits(1) && (*coef & p1) == 0)
                *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
            } else {
              if (--r < 0) break;
            }
            ++k;
          } while (k <= se);
          if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
        }
      }
      if (eobrun > 0) {
        for (; k <= se; ++k) {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0 && br.bits(1) && (*coef & p1) == 0)
            *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
        }
        --eobrun;
      }
    };

    for (int y = 0; y < my; ++y) {
      for (int x = 0; x < mx; ++x) {
        if (restart) {
          if (restarts_to_go == 0) {
            // jdhuff.c process_restart: drop the bit buffer, read RSTn
            pos = br.pos;
            int m = next_marker();
            if (m != 0xD0 + next_rst) fail("corrupt JPEG data: restart marker out of sequence");
            next_rst = (next_rst + 1) & 7;
            br.pos = pos;
            br.reset();
            for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
            eobrun = 0;
            restarts_to_go = restart;
          }
          --restarts_to_go;
        }
        if (ns == 1) {
          decode_block(*sc[0], block_at(*sc[0], x, y));
        } else {
          for (int i = 0; i < ns; ++i) {
            Component& c = *sc[i];
            for (int by = 0; by < c.v; ++by)
              for (int bx = 0; bx < c.h; ++bx) decode_block(c, block_at(c, x * c.h + bx, y * c.v + by));
          }
        }
      }
    }
    pos = br.pos;  // the rest of the scan's bytes are skipped by next_marker
  }

  void parse() {
    if (size < 3 || data[0] != 0xFF || data[1] != 0xD8) fail("not a JPEG file (no SOI marker)");
    pos = 2;
    while (true) {
      int m = next_marker();
      switch (m) {
        case 0xC0:
        case 0xC1:
        case 0xC2:
          read_sof(m);
          if (header_only) return;
          break;
        case 0xC3:
        case 0xC7:
        case 0xCB:
        case 0xCF:
          fail("lossless JPEG is not supported");
        case 0xC5:
        case 0xC6:
          fail("hierarchical JPEG is not supported");
        case 0xC9:
        case 0xCA:
        case 0xCC:
        case 0xCD:
        case 0xCE:
          fail("arithmetic-coded JPEG is not supported");
        case 0xC4:
          read_dht();
          break;
        case 0xDB:
          read_dqt();
          break;
        case 0xDD: {
          size_t end = segment_end();
          if (end - pos != 2) fail("bad DRI length");
          restart_interval = u16();
          break;
        }
        case 0xDA:
          decode_scan();
          break;
        case 0xD9:
          if (!have_sof || !saw_scan) fail("JPEG holds no image");
          return;
        case 0xD8:
          fail("corrupt JPEG: duplicate SOI marker");
        case 0x01:
        case 0xD0:
        case 0xD1:
        case 0xD2:
        case 0xD3:
        case 0xD4:
        case 0xD5:
        case 0xD6:
        case 0xD7:
          break;  // standalone, skipped as libjpeg skips them
        default:
          if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE || m == 0xDC) {  // APPn, COM, DNL
            read_app(m);
            break;
          }
          fail("corrupt JPEG: unknown marker 0x%02x", m);
      }
    }
  }

  // jdcoefct.c smoothing_ok: a progressive file whose first AC
  // coefficients are not all complete would be smoothed by libjpeg.
  void check_complete() const {
    if (!progressive) return;
    for (const auto& c : comps)
      for (int k = 0; k < 10; ++k)
        if (c.coef_bits[k] != 0)
          fail("incomplete progressive JPEG (libjpeg would smooth it; not supported)");
  }

  // jidctint.c jpeg_idct_islow on one block into out (stride in bytes), in
  // 64-bit intermediates as libjpeg's JLONG, so corrupt coefficients wrap
  // in the workspace instead of overflowing.
  static void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
    const uint8_t* limit = tables().idct_limit;
    int ws[64];
    for (int c = 0; c < 8; ++c) {
      const int16_t* inp = in + c;
      const uint16_t* qp = q + c;
      int* wp = ws + c;
      if (!inp[8] && !inp[16] && !inp[24] && !inp[32] && !inp[40] && !inp[48] && !inp[56]) {
        int dc = static_cast<int>(int64_t(inp[0] * qp[0]) * (1 << kPass1Bits));
        for (int r = 0; r < 8; ++r) wp[r * 8] = dc;
        continue;
      }
      int64_t z2 = inp[16] * qp[16], z3 = inp[48] * qp[48];
      int64_t z1 = (z2 + z3) * FIX_0_541196100;
      int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
      int64_t tmp3 = z1 + z2 * FIX_0_765366865;
      z2 = inp[0] * qp[0];
      z3 = inp[32] * qp[32];
      int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
      int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = inp[56] * qp[56];
      tmp1 = inp[40] * qp[40];
      tmp2 = inp[24] * qp[24];
      tmp3 = inp[8] * qp[8];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * FIX_1_175875602;
      tmp0 *= FIX_0_298631336;
      tmp1 *= FIX_2_053119869;
      tmp2 *= FIX_3_072711026;
      tmp3 *= FIX_1_501321110;
      z1 *= -FIX_0_899976223;
      z2 *= -FIX_2_562915447;
      z3 *= -FIX_1_961570560;
      z4 *= -FIX_0_390180644;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int sh = kConstBits - kPass1Bits;
      wp[0] = static_cast<int>(descale(tmp10 + tmp3, sh));
      wp[56] = static_cast<int>(descale(tmp10 - tmp3, sh));
      wp[8] = static_cast<int>(descale(tmp11 + tmp2, sh));
      wp[48] = static_cast<int>(descale(tmp11 - tmp2, sh));
      wp[16] = static_cast<int>(descale(tmp12 + tmp1, sh));
      wp[40] = static_cast<int>(descale(tmp12 - tmp1, sh));
      wp[24] = static_cast<int>(descale(tmp13 + tmp0, sh));
      wp[32] = static_cast<int>(descale(tmp13 - tmp0, sh));
    }
    const int sh = kConstBits + kPass1Bits + 3;
    for (int r = 0; r < 8; ++r) {
      const int* wp = ws + r * 8;
      uint8_t* o = out + static_cast<ptrdiff_t>(r) * stride;
      if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
        uint8_t v = limit[descale(int64_t(wp[0]), kPass1Bits + 3) & 1023];
        std::memset(o, v, 8);
        continue;
      }
      int64_t z2 = wp[2], z3 = wp[6];
      int64_t z1 = (z2 + z3) * FIX_0_541196100;
      int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
      int64_t tmp3 = z1 + z2 * FIX_0_765366865;
      int64_t tmp0 = (int64_t(wp[0]) + wp[4]) * (1 << kConstBits);
      int64_t tmp1 = (int64_t(wp[0]) - wp[4]) * (1 << kConstBits);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = wp[7];
      tmp1 = wp[5];
      tmp2 = wp[3];
      tmp3 = wp[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * FIX_1_175875602;
      tmp0 *= FIX_0_298631336;
      tmp1 *= FIX_2_053119869;
      tmp2 *= FIX_3_072711026;
      tmp3 *= FIX_1_501321110;
      z1 *= -FIX_0_899976223;
      z2 *= -FIX_2_562915447;
      z3 *= -FIX_1_961570560;
      z4 *= -FIX_0_390180644;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      o[0] = limit[descale(tmp10 + tmp3, sh) & 1023];
      o[7] = limit[descale(tmp10 - tmp3, sh) & 1023];
      o[1] = limit[descale(tmp11 + tmp2, sh) & 1023];
      o[6] = limit[descale(tmp11 - tmp2, sh) & 1023];
      o[2] = limit[descale(tmp12 + tmp1, sh) & 1023];
      o[5] = limit[descale(tmp12 - tmp1, sh) & 1023];
      o[3] = limit[descale(tmp13 + tmp0, sh) & 1023];
      o[4] = limit[descale(tmp13 - tmp0, sh) & 1023];
    }
  }

  // One component's samples, IDCT'd, then upsampled to width x height
  // (jdsample.c: fancy for h2v1, h1v2 and h2v2, replication otherwise).
  std::vector<uint8_t> component_plane(const Component& c) const {
    const int stride = c.wib * 8;
    std::vector<uint8_t> small(static_cast<size_t>(stride) * c.hib * 8);
    if (!c.coef.empty()) {
      for (int by = 0; by < c.hib; ++by)
        for (int bx = 0; bx < c.wib; ++bx)
          idct_islow(&c.coef[(static_cast<size_t>(by) * c.bw + bx) * 64], c.quant,
                     &small[(static_cast<size_t>(by) * 8) * stride + bx * 8], stride);
    } else {
      std::fill(small.begin(), small.end(), 128);  // never scanned: all-zero coefficients
    }
    const int hr = max_h / c.h, vr = max_v / c.v;
    if (hr == 1 && vr == 1 && stride == width) {
      small.resize(static_cast<size_t>(width) * height);
      return small;
    }
    std::vector<uint8_t> out(static_cast<size_t>(width) * height);
    const int dw = c.dw, dh = c.dh;
    auto row = [&](int i) { return &small[static_cast<size_t>(i) * stride]; };
    // Triangle filter across a row of column sums s (each weighted 4 in
    // all): 3 parts the nearer, 1 the farther, the edges repeated; the
    // even output's bias is b0, the odd one's b1, then >> shift.
    std::vector<int> sums(dw);
    std::vector<uint8_t> wide(2 * static_cast<size_t>(dw));
    auto filter_h = [&](int b0, int b1, int shift) {
      const int* s = sums.data();
      uint8_t* o = wide.data();
      for (int j = 0; j < dw; ++j) {
        int left = s[j > 0 ? j - 1 : 0], right = s[j + 1 < dw ? j + 1 : dw - 1];
        o[2 * j] = static_cast<uint8_t>((3 * s[j] + left + b0) >> shift);
        o[2 * j + 1] = static_cast<uint8_t>((3 * s[j] + right + b1) >> shift);
      }
    };
    for (int y = 0; y < height; ++y) {
      uint8_t* o = &out[static_cast<size_t>(y) * width];
      if (hr == 2 && vr == 1 && dw > 2) {  // h2v1_fancy_upsample
        const uint8_t* r = row(y);
        for (int j = 0; j < dw; ++j) sums[j] = r[j];
        filter_h(1, 2, 2);
        std::memcpy(o, wide.data(), width);
      } else if (hr == 1 && vr == 2) {  // h1v2_fancy_upsample
        int i = y >> 1;
        const uint8_t* near = row(i);
        const uint8_t* far = row((y & 1) ? std::min(i + 1, dh - 1) : std::max(i - 1, 0));
        int bias = (y & 1) ? 2 : 1;
        for (int x = 0; x < width; ++x) o[x] = static_cast<uint8_t>((3 * near[x] + far[x] + bias) >> 2);
      } else if (hr == 2 && vr == 2 && dw > 2) {  // h2v2_fancy_upsample
        int i = y >> 1;
        const uint8_t* near = row(i);
        const uint8_t* far = row((y & 1) ? std::min(i + 1, dh - 1) : std::max(i - 1, 0));
        for (int j = 0; j < dw; ++j) sums[j] = 3 * near[j] + far[j];
        filter_h(8, 7, 4);
        std::memcpy(o, wide.data(), width);
      } else {  // replication (int_upsample, and h2v1 / h2v2 at 2 samples or fewer)
        const uint8_t* r = row(y / vr);
        for (int x = 0; x < width; ++x) o[x] = r[x / hr];
      }
    }
    return out;
  }

  void output_rgb(uint8_t* out) const {
    check_complete();
    const Tables& t = tables();
    std::vector<std::vector<uint8_t>> planes;
    for (const auto& c : comps) planes.push_back(component_plane(c));
    const size_t n = static_cast<size_t>(width) * height;
    const uint8_t* clamp = t.clamp;
    const uint8_t* p0 = planes[0].data();
    switch (color_space()) {
      case ColorSpace::kGray:
        for (size_t i = 0; i < n; ++i) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = p0[i];
        return;
      case ColorSpace::kRGB:
        for (size_t i = 0; i < n; ++i) {
          out[3 * i] = p0[i];
          out[3 * i + 1] = planes[1][i];
          out[3 * i + 2] = planes[2][i];
        }
        return;
      case ColorSpace::kYCbCr: {
        const uint8_t *cb = planes[1].data(), *cr = planes[2].data();
        for (size_t i = 0; i < n; ++i) {
          int y = p0[i];
          out[3 * i] = clamp[y + t.cr_r[cr[i]]];
          out[3 * i + 1] = clamp[y + ((t.cb_g[cb[i]] + t.cr_g[cr[i]]) >> 16)];
          out[3 * i + 2] = clamp[y + t.cb_b[cb[i]]];
        }
        return;
      }
      case ColorSpace::kCMYK:
      case ColorSpace::kYCCK: {
        const bool ycck = color_space() == ColorSpace::kYCCK;
        for (size_t i = 0; i < n; ++i) {
          int cmy[3] = {p0[i], planes[1][i], planes[2][i]};
          if (ycck) {  // jdcolor.c ycck_cmyk_convert
            int y = cmy[0], cb = cmy[1], cr = cmy[2];
            cmy[0] = clamp[255 - (y + t.cr_r[cr])];
            cmy[1] = clamp[255 - (y + ((t.cb_g[cb] + t.cr_g[cr]) >> 16))];
            cmy[2] = clamp[255 - (y + t.cb_b[cb])];
          }
          // OpenCV's icvCvt_CMYK2BGR_8u_C4C3R, in RGB order
          int k = planes[3][i];
          for (int j = 0; j < 3; ++j) out[3 * i + j] = static_cast<uint8_t>(k - ((255 - cmy[j]) * k >> 8));
        }
        return;
      }
    }
  }
};

// ---------------------------------------------------------------------------
// JPEG encode (libjpeg-turbo defaults as OpenCV's imwrite sets them)
// ---------------------------------------------------------------------------

struct HuffCode {
  uint16_t code[256];
  uint8_t size[256];

  HuffCode(const uint8_t* bits16, const uint8_t* vals) {
    std::memset(size, 0, sizeof(size));
    int k = 0, code_v = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits16[l - 1]; ++i, ++k, ++code_v) {
        code[vals[k]] = static_cast<uint16_t>(code_v);
        size[vals[k]] = static_cast<uint8_t>(l);
      }
      code_v <<= 1;
    }
  }
};

struct ByteSink {
  uint8_t* out;
  size_t cap, n = 0;
  void byte(int b) {
    if (n >= cap) fail("JPEG output buffer too small");
    out[n++] = static_cast<uint8_t>(b);
  }
  void u16(int v) {
    byte(v >> 8);
    byte(v & 0xFF);
  }
};

struct BitWriter {
  ByteSink& sink;
  uint32_t acc = 0;
  int nbits = 0;
  void put(uint32_t bits, int n) {
    acc = (acc << n) | (bits & ((1u << n) - 1));
    nbits += n;
    while (nbits >= 8) {
      int b = static_cast<int>((acc >> (nbits - 8)) & 0xFF);
      sink.byte(b);
      if (b == 0xFF) sink.byte(0);
      nbits -= 8;
    }
  }
  void flush() {  // pad with 1-bits, as jchuff.c does
    if (nbits > 0) put(0x7F, 8 - nbits);
  }
};

// jcdctmgr.c compute_reciprocal with a 16-bit DCTELEM (the SIMD build).
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint16_t divisor) {
  int b = 0;
  while ((1u << (b + 1)) <= divisor) ++b;  // flss(divisor) - 1
  int r = 16 + b;
  uint32_t fq = static_cast<uint32_t>((uint64_t(1) << r) / divisor);
  uint32_t fr = static_cast<uint32_t>((uint64_t(1) << r) % divisor);
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2u) {
    ++c;
  } else {
    ++fq;
  }
  return {fq & 0xFFFF, c & 0xFFFF, r};
}

void fdct_islow(int* d) {
  for (int r = 0; r < 8; ++r) {
    int* p = d + r * 8;
    int32_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7], tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int32_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5], tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = (tmp10 + tmp11) * (1 << kPass1Bits);
    p[4] = (tmp10 - tmp11) * (1 << kPass1Bits);
    int32_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    p[2] = descale(z1 + tmp13 * FIX_0_765366865, kConstBits - kPass1Bits);
    p[6] = descale(z1 + tmp12 * -FIX_1_847759065, kConstBits - kPass1Bits);
    z1 = tmp4 + tmp7;
    int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[7] = descale(tmp4 + z1 + z3, kConstBits - kPass1Bits);
    p[5] = descale(tmp5 + z2 + z4, kConstBits - kPass1Bits);
    p[3] = descale(tmp6 + z2 + z3, kConstBits - kPass1Bits);
    p[1] = descale(tmp7 + z1 + z4, kConstBits - kPass1Bits);
  }
  for (int c = 0; c < 8; ++c) {
    int* p = d + c;
    int32_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56], tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int32_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40], tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = descale(tmp10 + tmp11, kPass1Bits);
    p[32] = descale(tmp10 - tmp11, kPass1Bits);
    int32_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    p[16] = descale(z1 + tmp13 * FIX_0_765366865, kConstBits + kPass1Bits);
    p[48] = descale(z1 + tmp12 * -FIX_1_847759065, kConstBits + kPass1Bits);
    z1 = tmp4 + tmp7;
    int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[56] = descale(tmp4 + z1 + z3, kConstBits + kPass1Bits);
    p[40] = descale(tmp5 + z2 + z4, kConstBits + kPass1Bits);
    p[24] = descale(tmp6 + z2 + z3, kConstBits + kPass1Bits);
    p[8] = descale(tmp7 + z1 + z4, kConstBits + kPass1Bits);
  }
}

struct JpegEncoder {
  int width, height, quality;
  uint16_t quant[2][64];  // natural order
  Divisor div[2][64];

  JpegEncoder(int w, int h, int q) : width(w), height(h), quality(q) {
    // jcparam.c jpeg_quality_scaling + jpeg_add_quant_table(force_baseline)
    q = std::min(100, std::max(1, q));
    int scale = q < 50 ? 5000 / q : 200 - q * 2;
    for (int t = 0; t < 2; ++t)
      for (int i = 0; i < 64; ++i) {
        long v = ((t ? kChromQuant : kLumQuant)[i] * static_cast<long>(scale) + 50) / 100;
        v = std::min(255L, std::max(1L, v));
        quant[t][i] = static_cast<uint16_t>(v);
        div[t][i] = reciprocal(static_cast<uint16_t>(v << 3));
      }
  }

  // One 8x8 block of a plane (already padded) -> quantised coefficients.
  void block(const uint8_t* plane, int stride, int bx, int by, int t, int16_t* out) const {
    int d[64];
    for (int r = 0; r < 8; ++r)
      for (int c = 0; c < 8; ++c) d[r * 8 + c] = plane[static_cast<size_t>(by * 8 + r) * stride + bx * 8 + c] - 128;
    fdct_islow(d);
    for (int i = 0; i < 64; ++i) {
      const Divisor& dv = div[t][i];
      int v = d[i];
      uint32_t a = static_cast<uint32_t>(v < 0 ? -v : v);
      uint32_t prod = (a + dv.corr) * dv.recip;
      int qv = static_cast<int>(static_cast<uint16_t>(prod >> dv.shift));
      out[i] = static_cast<int16_t>(v < 0 ? -qv : qv);
    }
  }

  size_t encode(const uint8_t* rgb, uint8_t* out, size_t cap) const {
    const Tables& t = tables();
    // Component geometry (jcmaster.c initial_setup), Y 2x2, Cb / Cr 1x1.
    const int y_wib = (width + 7) / 8, y_hib = (height + 7) / 8;
    const int mcus_x = (width + 15) / 16, mcus_y = (height + 15) / 16;
    // Full-size planes padded by edge replication to the iMCU grid.
    const int pw = mcus_x * 16, ph = mcus_y * 16;
    std::vector<uint8_t> Y(static_cast<size_t>(pw) * ph), Cb(Y.size()), Cr(Y.size());
    for (int y = 0; y < ph; ++y) {
      const uint8_t* row = rgb + static_cast<size_t>(std::min(y, height - 1)) * width * 3;
      for (int x = 0; x < pw; ++x) {
        const uint8_t* p = row + 3 * std::min(x, width - 1);
        int r = p[0], g = p[1], b = p[2];
        size_t i = static_cast<size_t>(y) * pw + x;
        Y[i] = static_cast<uint8_t>((t.rgb_ycc[r] + t.rgb_ycc[256 + g] + t.rgb_ycc[512 + b]) >> 16);
        Cb[i] = static_cast<uint8_t>((t.rgb_ycc[768 + r] + t.rgb_ycc[1024 + g] + t.rgb_ycc[1280 + b]) >> 16);
        Cr[i] = static_cast<uint8_t>((t.rgb_ycc[1280 + r] + t.rgb_ycc[1536 + g] + t.rgb_ycc[1792 + b]) >> 16);
      }
    }
    // jcsample.c h2v2_downsample over rows padded to an even count; the
    // downsampled rows past ceil(height / 2) repeat the last one.
    const int cw = pw / 2, ch = ph / 2, crows = (height + 1) / 2;
    std::vector<uint8_t> sub[2] = {std::vector<uint8_t>(static_cast<size_t>(cw) * ch),
                                   std::vector<uint8_t>(static_cast<size_t>(cw) * ch)};
    const std::vector<uint8_t>* full[2] = {&Cb, &Cr};
    for (int k = 0; k < 2; ++k) {
      for (int y = 0; y < ch; ++y) {
        int sy = std::min(y, crows - 1);
        const uint8_t* r0 = full[k]->data() + static_cast<size_t>(2 * sy) * pw;
        const uint8_t* r1 = full[k]->data() + static_cast<size_t>(std::min(2 * sy + 1, height - 1)) * pw;
        int bias = 1;
        for (int x = 0; x < cw; ++x) {
          sub[k][static_cast<size_t>(y) * cw + x] =
              static_cast<uint8_t>((r0[2 * x] + r0[2 * x + 1] + r1[2 * x] + r1[2 * x + 1] + bias) >> 2);
          bias ^= 3;
        }
      }
    }

    ByteSink sink{out, cap};
    static const uint8_t jfif[] = {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0x00,
                                   0x01, 0x01, 0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00};
    for (uint8_t b : jfif) sink.byte(b);
    for (int tq = 0; tq < 2; ++tq) {
      sink.u16(0xFFDB);
      sink.u16(67);
      sink.byte(tq);
      for (int i = 0; i < 64; ++i) sink.byte(quant[tq][kNatural[i]]);
    }
    sink.u16(0xFFC0);
    sink.u16(17);
    sink.byte(8);
    sink.u16(height);
    sink.u16(width);
    sink.byte(3);
    const int comp_hv[3] = {0x22, 0x11, 0x11};
    for (int c = 0; c < 3; ++c) {
      sink.byte(c + 1);
      sink.byte(comp_hv[c]);
      sink.byte(c ? 1 : 0);
    }
    auto dht = [&](int index, const uint8_t* bits16, const uint8_t* vals, int n) {
      sink.u16(0xFFC4);
      sink.u16(2 + 1 + 16 + n);
      sink.byte(index);
      for (int i = 0; i < 16; ++i) sink.byte(bits16[i]);
      for (int i = 0; i < n; ++i) sink.byte(vals[i]);
    };
    dht(0x00, kDcLumBits, kDcVals, 12);
    dht(0x10, kAcLumBits, kAcLumVals, 162);
    dht(0x01, kDcChromBits, kDcVals, 12);
    dht(0x11, kAcChromBits, kAcChromVals, 162);
    static const uint8_t sos[] = {0xFF, 0xDA, 0x00, 0x0C, 0x03, 0x01, 0x00, 0x02,
                                  0x11, 0x03, 0x11, 0x00, 0x3F, 0x00};
    for (uint8_t b : sos) sink.byte(b);

    static const HuffCode dc_lum(kDcLumBits, kDcVals), dc_chrom(kDcChromBits, kDcVals);
    static const HuffCode ac_lum(kAcLumBits, kAcLumVals), ac_chrom(kAcChromBits, kAcChromVals);
    BitWriter bw{sink};
    int last_dc[3] = {0, 0, 0};
    auto emit_block = [&](const int16_t* blk, int comp) {
      const HuffCode& dc = comp ? dc_chrom : dc_lum;
      const HuffCode& ac = comp ? ac_chrom : ac_lum;
      int temp = blk[0] - last_dc[comp];
      last_dc[comp] = blk[0];
      int temp2 = temp;
      if (temp < 0) {
        temp = -temp;
        temp2 = temp2 - 1;
      }
      int nbits = 0;
      while (temp) {
        ++nbits;
        temp >>= 1;
      }
      bw.put(dc.code[nbits], dc.size[nbits]);
      if (nbits) bw.put(static_cast<uint32_t>(temp2), nbits);
      int run = 0;
      for (int k = 1; k < 64; ++k) {
        int v = blk[kNatural[k]];
        if (v == 0) {
          ++run;
          continue;
        }
        while (run > 15) {
          bw.put(ac.code[0xF0], ac.size[0xF0]);
          run -= 16;
        }
        int a = v < 0 ? -v : v;
        int bits = v < 0 ? v - 1 : v;
        int nb = 0;
        while (a) {
          ++nb;
          a >>= 1;
        }
        int sym = (run << 4) | nb;
        bw.put(ac.code[sym], ac.size[sym]);
        bw.put(static_cast<uint32_t>(bits), nb);
        run = 0;
      }
      if (run > 0) bw.put(ac.code[0], ac.size[0]);
    };

    int16_t mcu[6][64];
    for (int my = 0; my < mcus_y; ++my) {
      for (int mx = 0; mx < mcus_x; ++mx) {
        // jccoefct.c compress_data: blocks past the component's last
        // column or row are dummies, all AC zero, DC copied from the
        // block before them in the MCU.
        for (int yi = 0; yi < 2; ++yi) {
          for (int xi = 0; xi < 2; ++xi) {
            int blkn = yi * 2 + xi;
            int bx = mx * 2 + xi, by = my * 2 + yi;
            if (by >= y_hib) {
              std::memset(mcu[blkn], 0, sizeof(mcu[blkn]));
              mcu[blkn][0] = mcu[yi * 2 - 1][0];
            } else if (bx >= y_wib) {
              std::memset(mcu[blkn], 0, sizeof(mcu[blkn]));
              mcu[blkn][0] = mcu[blkn - 1][0];
            } else {
              block(Y.data(), pw, bx, by, 0, mcu[blkn]);
            }
          }
        }
        block(sub[0].data(), cw, mx, my, 1, mcu[4]);
        block(sub[1].data(), cw, mx, my, 1, mcu[5]);
        for (int b = 0; b < 4; ++b) emit_block(mcu[b], 0);
        emit_block(mcu[4], 1);
        emit_block(mcu[5], 2);
      }
    }
    bw.flush();
    sink.u16(0xFFD9);
    return sink.n;
  }
};

// ---------------------------------------------------------------------------
// PNG unfilter, de-interlace and conversion to RGB8
// ---------------------------------------------------------------------------

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

struct PngImage {
  int width, height, depth, color;
  const uint8_t* palette;
  int palette_len;
  int channels() const {
    switch (color) {
      case 0: return 1;
      case 2: return 3;
      case 3: return 1;
      case 4: return 2;
      case 6: return 4;
    }
    fail("bad PNG colour type %d", color);
  }

  // Unfilter the rows of one (sub-)image in place; returns bytes consumed.
  size_t unfilter(uint8_t* buf, size_t avail, int w, int h) const {
    if (w == 0 || h == 0) return 0;
    const size_t rowbytes = (static_cast<size_t>(w) * channels() * depth + 7) / 8;
    const int bpp = std::max(1, channels() * depth / 8);
    const size_t need = (rowbytes + 1) * h;
    if (avail < need) fail("PNG image data is short (%zu of %zu bytes)", avail, need);
    uint8_t* prev = nullptr;
    for (int y = 0; y < h; ++y) {
      uint8_t* row = buf + y * (rowbytes + 1);
      int ft = row[0];
      uint8_t* cur = row + 1;
      for (size_t i = 0; i < rowbytes; ++i) {
        int a = i >= static_cast<size_t>(bpp) ? cur[i - bpp] : 0;
        int b = prev ? prev[i] : 0;
        int c = (prev && i >= static_cast<size_t>(bpp)) ? prev[i - bpp] : 0;
        int x = cur[i];
        switch (ft) {
          case 0: break;
          case 1: x += a; break;
          case 2: x += b; break;
          case 3: x += (a + b) >> 1; break;
          case 4: x += paeth(a, b, c); break;
          default: fail("bad PNG filter type %d", ft);
        }
        cur[i] = static_cast<uint8_t>(x);
      }
      prev = cur;
    }
    return need;
  }

  // Write pixel (px of a row of the sub-image) to out as RGB.
  void put(const uint8_t* row, int px, uint8_t* o) const {
    auto sample = [&](int idx) -> int {  // the idx-th sample of the row, 8-bit
      if (depth == 16) return row[2 * idx];
      if (depth == 8) return row[idx];
      int per = 8 / depth;
      int byte = row[idx / per];
      int shift = 8 - depth * (idx % per + 1);
      return (byte >> shift) & ((1 << depth) - 1);
    };
    const int ch = channels();
    if (color == 3) {
      int i = sample(px);
      if (i < palette_len) {
        o[0] = palette[3 * i];
        o[1] = palette[3 * i + 1];
        o[2] = palette[3 * i + 2];
      } else {
        o[0] = o[1] = o[2] = 0;
      }
      return;
    }
    if (color == 0 || color == 4) {
      int g = sample(px * ch);
      if (depth < 8) g = g * (255 / ((1 << depth) - 1));
      o[0] = o[1] = o[2] = static_cast<uint8_t>(g);
      return;
    }
    for (int j = 0; j < 3; ++j) o[j] = static_cast<uint8_t>(sample(px * ch + j));
  }

  // The passes' (x0, y0, dx, dy): Adam7's seven, or one over every pixel.
  static int passes(bool interlaced, const int (**geometry)[4]) {
    static const int adam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                                    {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};
    static const int plain[1][4] = {{0, 0, 1, 1}};
    *geometry = interlaced ? adam7 : plain;
    return interlaced ? 7 : 1;
  }

  size_t rowbytes(int w) const { return (static_cast<size_t>(w) * channels() * depth + 7) / 8; }

  // Bytes of the filtered rows: a filter byte and the packed samples a row
  // of each pass that has pixels.
  size_t raw_size(bool interlaced) const {
    const int(*g)[4];
    size_t total = 0;
    for (int p = 0, n = passes(interlaced, &g); p < n; ++p) {
      int w = width > g[p][0] ? (width - g[p][0] + g[p][2] - 1) / g[p][2] : 0;
      int h = height > g[p][1] ? (height - g[p][1] + g[p][3] - 1) / g[p][3] : 0;
      if (w && h) total += static_cast<size_t>(h) * (rowbytes(w) + 1);
    }
    return total;
  }

  void decode(uint8_t* raw, size_t size, uint8_t* out, bool interlaced) const {
    const int(*g)[4];
    size_t off = 0;
    for (int p = 0, n = passes(interlaced, &g); p < n; ++p) {
      int w = width > g[p][0] ? (width - g[p][0] + g[p][2] - 1) / g[p][2] : 0;
      int h = height > g[p][1] ? (height - g[p][1] + g[p][3] - 1) / g[p][3] : 0;
      size_t used = unfilter(raw + off, size - off, w, h);
      for (int y = 0; y < h && w; ++y) {
        const uint8_t* row = raw + off + y * (rowbytes(w) + 1) + 1;
        for (int x = 0; x < w; ++x) {
          int oy = g[p][1] + y * g[p][3], ox = g[p][0] + x * g[p][2];
          put(row, x, out + (static_cast<size_t>(oy) * width + ox) * 3);
        }
      }
      off += used;
    }
  }
};

int report(const CodecError& e, char* err, int err_len) {
  std::snprintf(err, err_len, "%s", e.msg.c_str());
  return -1;
}

}  // namespace

extern "C" {

int vd_jpeg_header(const uint8_t* data, unsigned long size, int* width, int* height, char* err,
                   int err_len) {
  try {
    JpegDecoder d(data, size, true);
    d.parse();
    if (!d.have_sof) fail("JPEG holds no frame header");
    *width = d.width;
    *height = d.height;
    return 0;
  } catch (const CodecError& e) {
    return report(e, err, err_len);
  } catch (const std::bad_alloc&) {  // an exception must not cross the C interface
    return report(CodecError{"out of memory"}, err, err_len);
  }
}

int vd_jpeg_decode(const uint8_t* data, unsigned long size, uint8_t* out, int width, int height,
                   char* err, int err_len) {
  try {
    JpegDecoder d(data, size, false);
    d.parse();
    if (d.width != width || d.height != height)
      fail("decoded size %dx%d differs from the caller's %dx%d", d.width, d.height, width, height);
    d.output_rgb(out);
    return 0;
  } catch (const CodecError& e) {
    return report(e, err, err_len);
  } catch (const std::bad_alloc&) {  // an exception must not cross the C interface
    return report(CodecError{"out of memory"}, err, err_len);
  }
}

int vd_jpeg_encode(const uint8_t* rgb, int width, int height, int quality, uint8_t* out,
                   unsigned long capacity, unsigned long* size, char* err, int err_len) {
  try {
    if (width <= 0 || height <= 0 || width > 65535 || height > 65535)
      fail("cannot encode a %dx%d JPEG", width, height);
    JpegEncoder e(width, height, quality);
    *size = e.encode(rgb, out, capacity);
    return 0;
  } catch (const CodecError& e) {
    return report(e, err, err_len);
  } catch (const std::bad_alloc&) {  // an exception must not cross the C interface
    return report(CodecError{"out of memory"}, err, err_len);
  }
}

unsigned long vd_png_raw_size(int width, int height, int bit_depth, int color_type,
                              int interlace) {
  PngImage img{width, height, bit_depth, color_type, nullptr, 0};
  return img.raw_size(interlace != 0);
}

int vd_png_unfilter(uint8_t* raw, unsigned long size, int width, int height, int bit_depth,
                    int color_type, int interlace, const uint8_t* palette, int palette_len,
                    uint8_t* out, char* err, int err_len) {
  try {
    PngImage img{width, height, bit_depth, color_type, palette, palette_len};
    img.decode(raw, size, out, interlace != 0);
    return 0;
  } catch (const CodecError& e) {
    return report(e, err, err_len);
  } catch (const std::bad_alloc&) {  // an exception must not cross the C interface
    return report(CodecError{"out of memory"}, err, err_len);
  }
}

}  // extern "C"

namespace {

// ---------------------------------------------------------------------------
// Video frames: ValTransform in C++ and a decode thread with a ring
// ---------------------------------------------------------------------------

constexpr int kCoefBits = 11;  // OpenCV's INTER_RESIZE_COEF_BITS
constexpr int32_t kOne = 1 << kCoefBits;
constexpr int kPadValue = 128;
const float kMean[3] = {0.485f, 0.456f, 0.406f};
const float kStd[3] = {0.229f, 0.224f, 0.225f};

// OpenCV's source index and float32 fraction for each destination position.
void axis_taps(int src, int dst, std::vector<int>& s, std::vector<float>& f) {
  const double scale = 1.0 / (static_cast<double>(dst) / src);
  s.resize(dst);
  f.resize(dst);
  for (int d = 0; d < dst; ++d) {
    const float fx = static_cast<float>((d + 0.5) * scale - 0.5);
    const float fl = std::floor(fx);
    s[d] = static_cast<int>(fl);
    f[d] = fx - fl;
  }
}

// rint(float32(1 - f) * 2048) and rint(f * 2048), half to even as cvRound.
void coefs(float f, int32_t& c0, int32_t& c1) {
  c0 = static_cast<int32_t>(std::nearbyint((1.0f - f) * static_cast<float>(kOne)));
  c1 = static_cast<int32_t>(std::nearbyint(f * static_cast<float>(kOne)));
}

// cv2.resize(src, (w, h), INTER_LINEAR) for uint8 RGB into rows of `stride`
// pixels, with transforms.py _resize's edge rules and vertical pass.
void resize_linear(const uint8_t* src, int ih, int iw, uint8_t* dst, int h, int w, int stride) {
  std::vector<int> sx, sy;
  std::vector<float> fx, fy;
  axis_taps(iw, w, sx, fx);
  axis_taps(ih, h, sy, fy);
  std::vector<int> col0(w), col1(w);
  std::vector<int32_t> a0(w), a1(w);
  for (int x = 0; x < w; ++x) {
    if (sx[x] < 0) {
      fx[x] = 0.0f;
      sx[x] = 0;
    }
    coefs(fx[x], a0[x], a1[x]);
    const bool single = sx[x] + 1 >= iw;
    col0[x] = std::min(sx[x], iw - 1);
    col1[x] = single ? col0[x] : col0[x] + 1;
    if (single) {
      a0[x] = kOne;
      a1[x] = 0;
    }
  }
  std::vector<int32_t> h0(static_cast<size_t>(w) * 3), h1(h0.size());
  auto horizontal = [&](int r, int32_t* out) {
    const uint8_t* row = src + static_cast<size_t>(r) * iw * 3;
    for (int x = 0; x < w; ++x) {
      const uint8_t* p = row + col0[x] * 3;
      const uint8_t* q = row + col1[x] * 3;
      for (int c = 0; c < 3; ++c) out[x * 3 + c] = (p[c] * a0[x] + q[c] * a1[x]) >> 4;
    }
  };
  for (int y = 0; y < h; ++y) {
    int32_t b0, b1;
    coefs(fy[y], b0, b1);
    horizontal(std::clamp(sy[y], 0, ih - 1), h0.data());
    horizontal(std::clamp(sy[y] + 1, 0, ih - 1), h1.data());
    uint8_t* o = dst + static_cast<size_t>(y) * stride * 3;
    for (int i = 0; i < w * 3; ++i) {
      const int32_t v = (((b0 * h0[i]) >> 16) + ((b1 * h1[i]) >> 16) + 2) >> 2;
      o[i] = static_cast<uint8_t>(std::clamp(v, 0, 255));
    }
  }
}

// ValTransform((h, w), letterbox, normalize) of one frame: `out` takes h*w*3
// uint8, or float32 when normalize; affine [sx, sy, dx, dy].
void frame_transform(const uint8_t* rgb, int ih, int iw, void* out, int h, int w, bool letterbox,
                     bool normalize, float* affine, std::vector<uint8_t>& staged) {
  uint8_t* u8 = static_cast<uint8_t*>(out);
  if (normalize) {
    staged.resize(static_cast<size_t>(h) * w * 3);
    u8 = staged.data();
  }
  if (letterbox) {
    const double s = std::min(static_cast<double>(h) / ih, static_cast<double>(w) / iw);
    const int nh = static_cast<int>(std::nearbyint(ih * s));
    const int nw = static_cast<int>(std::nearbyint(iw * s));
    const int dy = (h - nh) / 2, dx = (w - nw) / 2;
    std::memset(u8, kPadValue, static_cast<size_t>(h) * w * 3);
    resize_linear(rgb, ih, iw, u8 + (static_cast<size_t>(dy) * w + dx) * 3, nh, nw, w);
    affine[0] = affine[1] = static_cast<float>(s);
    affine[2] = static_cast<float>(dx);
    affine[3] = static_cast<float>(dy);
  } else {
    resize_linear(rgb, ih, iw, u8, h, w, w);
    affine[0] = static_cast<float>(static_cast<double>(w) / iw);
    affine[1] = static_cast<float>(static_cast<double>(h) / ih);
    affine[2] = affine[3] = 0.0f;
  }
  if (normalize) {
    float* f = static_cast<float*>(out);
    for (size_t i = 0; i < staged.size(); ++i) {
      float v = static_cast<float>(u8[i]);
      v /= 255.0f;
      v -= kMean[i % 3];
      v /= kStd[i % 3];
      f[i] = v;
    }
  }
}

constexpr long long kMaxPixels = 1LL << 30;  // native/__init__.py MAX_PIXELS

struct VideoStream {
  std::string path;
  std::vector<int64_t> offsets, sizes;
  std::vector<int32_t> indices;
  int h, w;
  bool letterbox, normalize;
  size_t frame_bytes;
  std::vector<std::vector<uint8_t>> ring;
  std::vector<std::array<float, 4>> ring_affine;
  std::vector<int32_t> ring_index;
  size_t produced = 0, consumed = 0;
  bool done = false, stopped = false;
  std::string error;
  std::mutex m;
  std::condition_variable not_full, not_empty;
  std::thread worker;

  void run() {
    std::vector<uint8_t> jpeg, rgb, staged;
    FILE* f = std::fopen(path.c_str(), "rb");
    try {
      if (!f) fail("cannot open the video");
      for (size_t i = 0; i < indices.size(); ++i) {
        {
          std::unique_lock<std::mutex> lock(m);
          not_full.wait(lock, [&] { return stopped || produced - consumed < ring.size(); });
          if (stopped) break;
        }
        try {
          jpeg.resize(static_cast<size_t>(sizes[i]));
          if (fseeko(f, static_cast<off_t>(offsets[i]), SEEK_SET) != 0 ||
              std::fread(jpeg.data(), 1, jpeg.size(), f) != jpeg.size())
            fail("cannot read %zu bytes at %lld", jpeg.size(), static_cast<long long>(offsets[i]));
          JpegDecoder d(jpeg.data(), jpeg.size(), false);
          d.parse();
          if (!d.have_sof) fail("JPEG holds no frame header");
          if (static_cast<long long>(d.width) * d.height > kMaxPixels)
            fail("%dx%d exceeds the decoder's %lld pixels", d.width, d.height, kMaxPixels);
          rgb.resize(static_cast<size_t>(d.width) * d.height * 3);
          d.output_rgb(rgb.data());
          // the slot is free: the consumer has copied it out before counting it
          const size_t slot = produced % ring.size();
          frame_transform(rgb.data(), d.height, d.width, ring[slot].data(), h, w, letterbox,
                          normalize, ring_affine[slot].data(), staged);
          ring_index[slot] = indices[i];
        } catch (const CodecError& e) {
          fail("frame %d: %s", indices[i], e.msg.c_str());
        }
        std::lock_guard<std::mutex> lock(m);
        ++produced;
        not_empty.notify_one();
      }
    } catch (const CodecError& e) {
      std::lock_guard<std::mutex> lock(m);
      error = path + ": " + e.msg;
    } catch (const std::bad_alloc&) {
      std::lock_guard<std::mutex> lock(m);
      error = path + ": out of memory";
    }
    if (f) std::fclose(f);
    std::lock_guard<std::mutex> lock(m);
    done = true;
    not_empty.notify_all();
  }

  int next(void* out, float* affine, int* index, char* err, int err_len) {
    std::unique_lock<std::mutex> lock(m);
    not_empty.wait(lock, [&] { return stopped || done || produced > consumed; });
    if (stopped) return 0;
    if (produced > consumed) {
      const size_t slot = consumed % ring.size();
      std::memcpy(out, ring[slot].data(), frame_bytes);
      std::memcpy(affine, ring_affine[slot].data(), sizeof(float) * 4);
      *index = ring_index[slot];
      ++consumed;
      not_full.notify_one();
      return 1;
    }
    if (!error.empty()) {
      std::snprintf(err, err_len, "%s", error.c_str());
      return -1;
    }
    return 0;
  }

  void stop() {
    std::lock_guard<std::mutex> lock(m);
    stopped = true;
    not_full.notify_all();
    not_empty.notify_all();
  }
};

}  // namespace

extern "C" {

int vd_frame_transform(const uint8_t* rgb, int ih, int iw, void* out, int h, int w, int letterbox,
                       int normalize, float* affine) {
  try {
    std::vector<uint8_t> staged;
    frame_transform(rgb, ih, iw, out, h, w, letterbox != 0, normalize != 0, affine, staged);
    return 0;
  } catch (const std::bad_alloc&) {
    return -1;
  }
}

void* vd_video_open(const char* path, const int64_t* offsets, const int64_t* sizes,
                    const int32_t* indices, int n, int h, int w, int letterbox, int normalize,
                    int capacity, char* err, int err_len) {
  try {
    if (n < 0 || h <= 0 || w <= 0 || capacity <= 0)
      fail("bad video stream arguments (n %d, %dx%d, capacity %d)", n, w, h, capacity);
    auto* s = new VideoStream();
    s->path = path;
    s->offsets.assign(offsets, offsets + n);
    s->sizes.assign(sizes, sizes + n);
    s->indices.assign(indices, indices + n);
    s->h = h;
    s->w = w;
    s->letterbox = letterbox != 0;
    s->normalize = normalize != 0;
    s->frame_bytes = static_cast<size_t>(h) * w * 3 * (s->normalize ? sizeof(float) : 1);
    s->ring.assign(capacity, std::vector<uint8_t>(s->frame_bytes));
    s->ring_affine.resize(capacity);
    s->ring_index.resize(capacity);
    s->worker = std::thread([s] { s->run(); });
    return s;
  } catch (const CodecError& e) {
    report(e, err, err_len);
  } catch (const std::exception& e) {
    std::snprintf(err, err_len, "cannot start the video stream: %s", e.what());
  }
  return nullptr;
}

int vd_video_next(void* handle, void* out, float* affine, int* index, char* err, int err_len) {
  return static_cast<VideoStream*>(handle)->next(out, affine, index, err, err_len);
}

void vd_video_stop(void* handle) { static_cast<VideoStream*>(handle)->stop(); }

void vd_video_free(void* handle) {
  auto* s = static_cast<VideoStream*>(handle);
  s->stop();
  if (s->worker.joinable()) s->worker.join();
  delete s;
}

}  // extern "C"
