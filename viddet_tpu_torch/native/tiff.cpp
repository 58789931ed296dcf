// TIFF's strip and tile codecs and its samples to RGB, as libtiff's
// TIFFReadRGBAStrip / TIFFReadRGBATile give them to cv2.imdecode
// (IMREAD_COLOR).  native/tiff.py reads the container and its tags,
// inflates Deflate strips with Python's zlib and decodes JPEG ones through
// codec.cpp; what the strips hold is undone and converted here.  No library
// beyond the C++ standard one.
//
//   expand   FillOrder 2 (bits reversed in each byte of the stored chunk),
//            then the chunk as stored, PackBits (tif_packbits.c: -128 a
//            no-op, a run past the chunk's size cut), or LZW (tif_lzw.c:
//            9- to 12-bit codes most significant bit first with the code
//            width growing one code early, or libtiff's old form, least
//            significant bit first and growing on time, told apart by the
//            first two bytes as LZWPreDecode tells them; the end of the
//            data taken as an end code), or CCITT (tif_fax3.c: modified
//            Huffman rows on a byte, Group 3 rows after EOLs with fill bits
//            and 1-D / 2-D tag bits, Group 4 against the row above; a black
//            run a run of 1 bits).  Bytes past the chunk's size are not
//            decoded; fewer are an error, and so is a CCITT stream libtiff
//            reports damaged.
//   samples  16-bit samples in the host's order, then horizontal
//            differencing (predictor 2) undone row by row, at 8 and 16 bits.
//   put      tif_getimage.c's put routines that OpenCV reaches, into RGB:
//            grey of 1, 8 and 16 bits (16-bit grey keeps its high byte,
//            MinIsWhite inverted); palette of 1, 4 and 8 bits through a
//            colour map already cut to 8 bits; RGB of 8 and 16 bits (16 to
//            8 by (v + 128) / 257), associated alpha dropped, unassociated
//            alpha premultiplied by (v * a + 127) / 255; CMYK as
//            (255 - c)(255 - k) / 255; YCbCr in data units of every
//            subsampling libtiff draws (1x1, 2x1, 2x2, 4x1, 4x2, 4x4, 1x2),
//            the chroma replicated over its block, through tif_color.c's
//            TIFFYCbCrToRGBInit tables (ReferenceBlackWhite, the luma
//            coefficients, its 16-bit fixed point); and the separate-plane
//            forms (RGB, grey taken as RGB without its map, CMYK, YCbCr
//            1x1); CIELab of 8 and 16 bits through tif_color.c's
//            TIFFCIELab16ToXYZ and TIFFXYZToRGB over the sRGB display.
//
// C interface (extern "C"; 0 on success, else -1 and a message in err):
//   vd_tiff_decode(data, size, offsets, counts, params, slots, colormap, ycbcr, out, err, err_len)
//     every strip or tile of a page into `out` (height x width RGB): each
//     chunk of the planes that `slots` names (plane k at offsets[k * chunks
//     + i], counts likewise; slots: the plane behind each of the put
//     routine's four plane pointers, -1 for none) expanded, its samples
//     undone and put.  params, in the order of the Param enum below; a
//     chunk's rows are chunk_h (tiles) or those left of the page (strips).
//     Deflate and JPEG chunks arrive already expanded, under compression 1.
//     colormap 3 x 256 bytes, ycbcr the luma coefficients and
//     ReferenceBlackWhite as libtiff reads them (9 floats), or for CIELab the
//     WhitePoint and whether the tag was there (3 of them).

#include <algorithm>
#include <cmath>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <new>
#include <vector>

namespace {

struct TiffError {
  char msg[256];
};

[[noreturn]] void fail(const char* fmt, ...) __attribute__((format(printf, 1, 2)));
void fail(const char* fmt, ...) {
  TiffError e;
  va_list ap;
  va_start(ap, fmt);
  std::vsnprintf(e.msg, sizeof(e.msg), fmt, ap);
  va_end(ap);
  throw e;
}

int report(const char* msg, char* err, int err_len) {
  std::snprintf(err, err_len, "%s", msg);
  return -1;
}

uint8_t reverse_bits(uint8_t b) {
  b = static_cast<uint8_t>((b & 0xF0) >> 4 | (b & 0x0F) << 4);
  b = static_cast<uint8_t>((b & 0xCC) >> 2 | (b & 0x33) << 2);
  return static_cast<uint8_t>((b & 0xAA) >> 1 | (b & 0x55) << 1);
}

// tif_lzw.c LZWDecode and LZWDecodeCompat
void lzw(const uint8_t* src, size_t size, uint8_t* out, size_t need) {
  constexpr int kClear = 256, kEnd = 257, kFirst = 258, kMaxBits = 12;
  constexpr int kTable = (1 << kMaxBits) + 1024;  // libtiff's CSIZE: a table may overrun 4096
  const bool old = size >= 2 && src[0] == 0 && (src[1] & 1);
  uint16_t prefix[kTable];
  uint8_t suffix[kTable], first_of[kTable], stack[kTable + 1];
  for (int c = 0; c < 256; ++c) suffix[c] = first_of[c] = static_cast<uint8_t>(c);
  int nbits = 9, next = kFirst, prev = -1;
  uint64_t acc = 0;
  int have = 0;
  size_t pos = 0, n = 0;
  while (n < need) {
    while (have < nbits && pos < size) {
      if (old)
        acc |= static_cast<uint64_t>(src[pos++]) << have;
      else
        acc = acc << 8 | src[pos++];
      have += 8;
    }
    if (have < nbits) break;  // not ended by an end code: the data's end is one
    int code;
    if (old) {
      code = static_cast<int>(acc & ((1u << nbits) - 1));
      acc >>= nbits;
    } else {
      code = static_cast<int>(acc >> (have - nbits) & ((1u << nbits) - 1));
    }
    have -= nbits;
    if (code == kEnd) break;
    if (code == kClear) {
      nbits = 9;
      next = kFirst;
      prev = -1;
      continue;
    }
    if (prev < 0) {  // the first code after a clear code: a byte
      if (code > kClear) fail("LZW code %d after a clear code is not a byte", code);
      out[n++] = static_cast<uint8_t>(code);
      prev = code;
      continue;
    }
    if (code > next || next >= kTable) fail("corrupted LZW table (code %d, %d entries)", code, next);
    // the new entry: the previous string and the first byte of this one
    prefix[next] = static_cast<uint16_t>(prev);
    suffix[next] = code < next ? first_of[code] : first_of[prev];
    first_of[next] = first_of[prev];
    ++next;
    // the width grows one code early (libtiff's maxcodep), or on time in the old form
    if (next > (1 << nbits) - (old ? 1 : 2) && nbits < kMaxBits) ++nbits;
    int depth = 0, c = code;
    for (; c >= 256; c = prefix[c]) stack[depth++] = suffix[c];
    stack[depth++] = static_cast<uint8_t>(c);
    while (depth > 0 && n < need) out[n++] = stack[--depth];
    prev = code;
  }
  if (n < need) fail("LZW data ends %zu bytes short of the chunk's %zu", need - n, need);
}

// tif_packbits.c PackBitsDecode
void packbits(const uint8_t* src, size_t size, uint8_t* out, size_t need) {
  size_t pos = 0, n = 0;
  while (pos < size && n < need) {
    int c = static_cast<int8_t>(src[pos++]);
    if (c == -128) continue;
    if (c < 0) {
      size_t run = static_cast<size_t>(1 - c);
      if (pos >= size) break;
      uint8_t b = src[pos++];
      if (run > need - n) run = need - n;
      std::memset(out + n, b, run);
      n += run;
    } else {
      size_t run = static_cast<size_t>(c) + 1;
      if (run > need - n) run = need - n;
      if (size - pos < run) break;
      std::memcpy(out + n, src + pos, run);
      n += run;
      pos += static_cast<size_t>(c) + 1;
    }
  }
  if (n < need) fail("PackBits data ends %zu bytes short of the chunk's %zu", need - n, need);
}

// ---------------------------------------------------------------------------
// CCITT bilevel coding (tif_fax3.c): modified Huffman (2), Group 3 (3, 1-D
// or 2-D rows after EOLs) and Group 4 (4).  Rows come out as packed bits, a
// black run 1s.

// ITU-T T.4 tables 2 and 3: the codes of runs 0-63, of the make-up runs
// 64-1728 and of the extended make-up runs 1792-2560 both colours share
const char* const kWhiteTerm[] = {
    "00110101", "000111", "0111", "1000", "1011", "1100", "1110", "1111", "10011", "10100",
    "00111", "01000", "001000", "000011", "110100", "110101", "101010", "101011", "0100111",
    "0001100", "0001000", "0010111", "0000011", "0000100", "0101000", "0101011", "0010011",
    "0100100", "0011000", "00000010", "00000011", "00011010", "00011011", "00010010", "00010011",
    "00010100", "00010101", "00010110", "00010111", "00101000", "00101001", "00101010",
    "00101011", "00101100", "00101101", "00000100", "00000101", "00001010", "00001011",
    "01010010", "01010011", "01010100", "01010101", "00100100", "00100101", "01011000",
    "01011001", "01011010", "01011011", "01001010", "01001011", "00110010", "00110011",
    "00110100",
};
const char* const kWhiteMakeUp[] = {
    "11011", "10010", "010111", "0110111", "00110110", "00110111", "01100100", "01100101",
    "01101000", "01100111", "011001100", "011001101", "011010010", "011010011", "011010100",
    "011010101", "011010110", "011010111", "011011000", "011011001", "011011010", "011011011",
    "010011000", "010011001", "010011010", "011000", "010011011",
};
const char* const kBlackTerm[] = {
    "0000110111", "010", "11", "10", "011", "0011", "0010", "00011", "000101", "000100",
    "0000100", "0000101", "0000111", "00000100", "00000111", "000011000", "0000010111",
    "0000011000", "0000001000", "00001100111", "00001101000", "00001101100", "00000110111",
    "00000101000", "00000010111", "00000011000", "000011001010", "000011001011", "000011001100",
    "000011001101", "000001101000", "000001101001", "000001101010", "000001101011",
    "000011010010", "000011010011", "000011010100", "000011010101", "000011010110",
    "000011010111", "000001101100", "000001101101", "000011011010", "000011011011",
    "000001010100", "000001010101", "000001010110", "000001010111", "000001100100",
    "000001100101", "000001010010", "000001010011", "000000100100", "000000110111",
    "000000111000", "000000100111", "000000101000", "000001011000", "000001011001",
    "000000101011", "000000101100", "000001011010", "000001100110", "000001100111",
};
const char* const kBlackMakeUp[] = {
    "0000001111", "000011001000", "000011001001", "000001011011", "000000110011", "000000110100",
    "000000110101", "0000001101100", "0000001101101", "0000001001010", "0000001001011",
    "0000001001100", "0000001001101", "0000001110010", "0000001110011", "0000001110100",
    "0000001110101", "0000001110110", "0000001110111", "0000001010010", "0000001010011",
    "0000001010100", "0000001010101", "0000001011010", "0000001011011", "0000001100100",
    "0000001100101",
};
const char* const kExtMakeUp[] = {
    "00000001000", "00000001100", "00000001101", "000000010010", "000000010011", "000000010100",
    "000000010101", "000000010110", "000000010111", "000000011100", "000000011101",
    "000000011110", "000000011111",
};

constexpr int kPeek = 13;          // the longest code, a black make-up
constexpr int kEol = -1;           // 000000000001
constexpr int kInvalid = -2;

struct RunTable {
  uint8_t len[1 << kPeek];
  int16_t run[1 << kPeek];

  RunTable(const char* const* term, const char* const* makeup) {
    std::fill(len, len + (1 << kPeek), 0);
    std::fill(run, run + (1 << kPeek), static_cast<int16_t>(kInvalid));
    for (int r = 0; r < 64; ++r) add(term[r], r);
    for (int i = 0; i < 27; ++i) add(makeup[i], 64 * (i + 1));
    for (int i = 0; i < 13; ++i) add(kExtMakeUp[i], 1792 + 64 * i);
    add("000000000001", kEol);
  }
  void add(const char* bits, int value) {
    const int n = static_cast<int>(std::strlen(bits));
    int code = 0;
    for (int i = 0; i < n; ++i) code = code << 1 | (bits[i] == '1');
    for (int rest = 0; rest < 1 << (kPeek - n); ++rest) {
      const int at = code << (kPeek - n) | rest;
      len[at] = static_cast<uint8_t>(n);
      run[at] = static_cast<int16_t>(value);
    }
  }
};

const RunTable& white_table() {
  static const RunTable t(kWhiteTerm, kWhiteMakeUp);
  return t;
}
const RunTable& black_table() {
  static const RunTable t(kBlackTerm, kBlackMakeUp);
  return t;
}

// T.4 table 4, the 2-D modes, by a 7-bit peek (tif_fax3.c's main table)
enum Mode { kPass, kHoriz, kV0, kVR, kVL, kExt, kEol2d, kBadMode };
struct ModeCode {
  uint8_t len, mode, delta;
};
ModeCode mode_code(int peek7) {
  if (peek7 & 0x40) return {1, kV0, 0};
  if ((peek7 >> 4) == 3) return {3, kVR, 1};
  if ((peek7 >> 4) == 2) return {3, kVL, 1};
  if ((peek7 >> 4) == 1) return {3, kHoriz, 0};
  if ((peek7 >> 3) == 1) return {4, kPass, 0};
  if ((peek7 >> 1) == 3) return {6, kVR, 2};
  if ((peek7 >> 1) == 2) return {6, kVL, 2};
  if (peek7 == 3) return {7, kVR, 3};
  if (peek7 == 2) return {7, kVL, 3};
  if (peek7 == 1) return {7, kExt, 0};
  return {7, kEol2d, 0};
}

// The coded bits, most significant first
struct FaxBits {
  const uint8_t* data;
  size_t size;
  uint64_t pos;  // bits consumed

  bool ended() const { return pos >= static_cast<uint64_t>(size) * 8; }
  int peek(int n) const {  // zeros past the end, as libtiff pads
    int v = 0;
    for (int i = 0; i < n; ++i) {
      const uint64_t at = pos + i;
      const int bit =
          at < static_cast<uint64_t>(size) * 8 ? data[at >> 3] >> (7 - (at & 7)) & 1 : 0;
      v = v << 1 | bit;
    }
    return v;
  }
  void skip(int n) { pos += n; }
};

struct Fax {
  FaxBits bits;
  int width, row;
  const char* scheme;
  std::vector<int> cur, ref;  // runs, white first, as tif_fax3.c keeps them
  size_t ncur = 0;

  [[noreturn]] void damaged(const char* what) {
    fail("CCITT %s data: %s at row %d", scheme, what, row);
  }
  void eof() {
    if (bits.ended()) damaged("the data ends");
  }
  // one run of a colour: make-up codes, then a terminating code
  int run(bool black) {
    const RunTable& t = black ? black_table() : white_table();
    int total = 0;
    for (;;) {
      eof();
      const int at = bits.peek(kPeek);
      const int v = t.run[at];
      if (v == kEol) damaged("an EOL inside a row");
      if (v == kInvalid) damaged(black ? "a bad black code word" : "a bad white code word");
      bits.skip(t.len[at]);
      total += v;
      if (total > (1 << 24)) damaged("a run past the row");
      if (v < 64) return total;
    }
  }
  void set(int value) {
    if (ncur >= cur.size()) damaged("too many runs");
    cur[ncur++] = value;
  }
  // tif_fax3.h EXPAND1D
  void row_1d() {
    ncur = 0;
    int a0 = 0;
    for (;;) {
      int r = run(false);
      set(r);
      a0 += r;
      if (a0 >= width) break;
      r = run(true);
      set(r);
      a0 += r;
      if (a0 >= width) break;
      if (ncur >= 2 && cur[ncur - 1] == 0 && cur[ncur - 2] == 0) ncur -= 2;
    }
    finish(a0);
  }
  // tif_fax3.h EXPAND2D against the reference runs
  void row_2d() {
    ncur = 0;
    int a0 = 0, pending = 0;
    size_t pb = 0;
    auto refrun = [&]() {
      if (pb >= ref.size()) damaged("a reference line overrun");
      return ref[pb++];
    };
    int b1 = refrun();
    auto check_b1 = [&]() {
      if (ncur != 0)
        while (b1 <= a0 && b1 < width) {
          b1 += refrun();
          b1 += refrun();
        }
    };
    auto setvalue = [&](int x) {
      set(pending + x);
      a0 += x;
      pending = 0;
    };
    while (a0 < width) {
      eof();
      const ModeCode m = mode_code(bits.peek(7));
      bits.skip(m.len);
      switch (m.mode) {
        case kPass:
          check_b1();
          b1 += refrun();
          pending += b1 - a0;
          a0 = b1;
          b1 += refrun();
          break;
        case kHoriz: {
          const bool black = ncur & 1;
          int r = run(black);
          setvalue(r);
          r = run(!black);
          setvalue(r);
          check_b1();
          break;
        }
        case kV0:
        case kVR:
          check_b1();
          setvalue(b1 - a0 + m.delta);
          b1 += refrun();
          break;
        case kVL:
          check_b1();
          if (b1 < a0 + m.delta) damaged("a vertical mode left of the row");
          setvalue(b1 - a0 - m.delta);
          if (pb == 0) damaged("a reference line underrun");
          b1 -= ref[--pb];
          break;
        case kExt:
          damaged("uncompressed mode (not decoded by libtiff either)");
        default:
          damaged("an EOL inside a row");
      }
      if (a0 < 0) damaged("a run before the row");
    }
    if (pending) setvalue(0);
    finish(a0);
  }
  void finish(int a0) {
    if (a0 != width) damaged("a row of the wrong length");
  }
  // tif_fax3.c _TIFFFax3fillruns
  void fill(uint8_t* out) const {
    std::memset(out, 0, (static_cast<size_t>(width) + 7) / 8);
    int x = 0;
    for (size_t i = 0; i < ncur && x < width; ++i) {
      const int end = std::min(width, x + cur[i]);
      if (i & 1)
        for (int k = x; k < end; ++k) out[k >> 3] |= static_cast<uint8_t>(0x80 >> (k & 7));
      x = end;
    }
  }
  void keep_reference() {  // the row becomes the next one's reference
    set(0);                // tif_fax3.c's imaginary change
    ref.assign(cur.begin(), cur.begin() + ncur);
    ref.push_back(0);
    ref.push_back(0);
  }
  // tif_fax3.h SYNC_EOL: to the end of the next EOL, fill bits included
  void sync_eol(bool& eol_seen) {
    if (!eol_seen) {
      for (;;) {
        eof();
        if (bits.peek(11) == 0) break;
        bits.skip(1);
      }
    }
    for (;;) {
      eof();
      if (bits.peek(8)) break;
      bits.skip(8);
    }
    while (bits.peek(1) == 0) bits.skip(1);
    bits.skip(1);
    eol_seen = false;
  }
};

// a CCITT chunk of `rows` rows of `width` pixels into packed rows
void fax(const uint8_t* src, size_t size, int compression, int options, int width, int rows,
         uint8_t* out, size_t need) {
  const size_t row_bytes = (static_cast<size_t>(width) + 7) / 8;
  if (width <= 0 || rows <= 0 || need < row_bytes * rows) fail("bad CCITT chunk geometry");
  const char* scheme =
      compression == 2 ? "modified Huffman" : compression == 3 ? "Group 3" : "Group 4";
  Fax f{FaxBits{src, size, 0}, width, 0, scheme, {}, {}, 0};
  f.cur.resize(2 * static_cast<size_t>(width) + 8);
  f.ref = {width, 0, 0, 0};  // an all-white line above the first row
  const bool two_d = compression == 4 || (compression == 3 && (options & 1));
  bool eol_seen = false;
  for (int y = 0; y < rows; ++y) {
    f.row = y;
    if (compression == 3) {
      f.sync_eol(eol_seen);
      bool one_d = true;
      if (two_d) {
        f.eof();
        one_d = f.bits.peek(1);
        f.bits.skip(1);
      }
      if (one_d)
        f.row_1d();
      else
        f.row_2d();
    } else if (compression == 4) {
      f.row_2d();
    } else {  // modified Huffman: rows start on a byte
      f.row_1d();
      f.bits.pos = (f.bits.pos + 7) & ~uint64_t{7};
    }
    f.fill(out + static_cast<size_t>(y) * row_bytes);
    if (two_d) f.keep_reference();
  }
}

// tif_color.c TIFFYCbCrToRGBInit and TIFFYCbCrtoRGB
struct YCbCr {
  int cr_r[256], cb_b[256], cr_g[256], cb_g[256], y[256];

  static int32_t fix(float x) { return static_cast<int32_t>(x * static_cast<float>(1L << 16) + 0.5); }
  static float clampf(float f, float lo, float hi) { return f < lo ? lo : f > hi ? hi : f; }
  static float code2v(int c, float rb, float rw, float cr) {
    const float range = (rw - rb != 0) ? (rw - rb) : 1.0f;
    return (static_cast<float>(c - static_cast<int32_t>(rb)) * cr) / range;
  }

  explicit YCbCr(const float* v) {
    for (int i = 0; i < 9; ++i)  // the caller refuses these; a cast below would be undefined
      if (!(std::fabs(v[i]) <= 16777216.0f)) fail("YCbCr value %g out of range", v[i]);
    if (v[1] == 0) fail("YCbCr green coefficient of 0");
    const float *luma = v, *ref = v + 3;
    const float f1 = 2 - 2 * luma[0];
    const int32_t d1 = fix(clampf(f1, 0.0f, 2.0f));
    const float f2 = luma[0] * f1 / luma[1];
    const int32_t d2 = -fix(clampf(f2, 0.0f, 2.0f));
    const float f3 = 2 - 2 * luma[2];
    const int32_t d3 = fix(clampf(f3, 0.0f, 2.0f));
    const float f4 = luma[2] * f3 / luma[1];
    const int32_t d4 = -fix(clampf(f4, 0.0f, 2.0f));
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      const int32_t cr = static_cast<int32_t>(
          clampf(code2v(x, ref[4] - 128.0f, ref[5] - 128.0f, 127), -128.0f * 32, 128.0f * 32));
      const int32_t cb = static_cast<int32_t>(
          clampf(code2v(x, ref[2] - 128.0f, ref[3] - 128.0f, 127), -128.0f * 32, 128.0f * 32));
      cr_r[i] = static_cast<int32_t>((static_cast<int64_t>(d1) * cr + (1 << 15)) >> 16);
      cb_b[i] = static_cast<int32_t>((static_cast<int64_t>(d3) * cb + (1 << 15)) >> 16);
      cr_g[i] = d2 * cr;
      cb_g[i] = d4 * cb + (1 << 15);
      y[i] = static_cast<int32_t>(clampf(code2v(x + 128, ref[0], ref[1], 255), -128.0f * 32, 128.0f * 32));
    }
  }

  static uint8_t clamp(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }
  void rgb(int Y, int Cb, int Cr, uint8_t* o) const {
    o[0] = clamp(y[Y] + cr_r[Cr]);
    o[1] = clamp(y[Y] + static_cast<int>((cb_g[Cb] + cr_g[Cr]) >> 16));
    o[2] = clamp(y[Y] + cb_b[Cb]);
  }
};

// tif_color.c TIFFCIELabToRGBInit over tif_getimage.c's display_sRGB, then
// TIFFCIELab16ToXYZ and TIFFXYZToRGB, in their float arithmetic; 8-bit
// samples enter as L * 257 and a, b * 256 (TIFFCIELabToXYZ)
struct CieLab {
  static constexpr int kRange = 1500;  // CIELABTORGB_TABLE_RANGE
  static constexpr float kMat[9] = {3.2410F, -1.5374F, -0.4986F, -0.9692F, 1.8760F,
                                    0.0416F,  0.0556F, -0.2040F, 1.0570F};
  static constexpr float kYC = 100.0F, kY0 = 1.0F, kGamma = 2.4F;
  static constexpr uint32_t kVrw = 255;
  float step, x0, y0, z0, table[kRange + 1];

  explicit CieLab(const float* white) {
    float wp[2] = {white[0], white[1]};
    if (white[2] == 0) {  // no WhitePoint tag: TIFFVGetFieldDefaulted's D50
      wp[0] = 96.4250F / (96.4250F + 100.0F + 82.4680F);
      wp[1] = 100.0F / (96.4250F + 100.0F + 82.4680F);
    }
    if (wp[1] == 0.0f) fail("CIELab WhitePoint of 0");
    const double gamma = 1.0 / kGamma;
    step = (kYC - kY0) / kRange;
    for (int i = 0; i <= kRange; ++i)
      table[i] = kVrw * static_cast<float>(std::pow(static_cast<double>(i) / kRange, gamma));
    y0 = 100.0F;
    x0 = wp[0] / wp[1] * y0;
    z0 = (1.0F - wp[0] - wp[1]) / wp[1] * y0;
  }

  static uint32_t rint(float r) {
    return static_cast<uint32_t>(r > 0 ? (r + 0.5) : (r - 0.5));
  }
  uint8_t channel(float v) const {
    v = v > kY0 ? v : kY0;
    v = v < kYC ? v : kYC;
    size_t i = static_cast<size_t>((v - kY0) / step);
    i = std::min(static_cast<size_t>(kRange), i);
    return static_cast<uint8_t>(std::min(rint(table[i]), kVrw));
  }
  void rgb(uint32_t l, int32_t a, int32_t b, uint8_t* o) const {
    const float L = static_cast<float>(l) * 100.0F / 65535.0F;
    float X, Y, Z, cby, tmp;
    if (L < 8.856F) {
      Y = (L * y0) / 903.292F;
      cby = 7.787F * (Y / y0) + 16.0F / 116.0F;
    } else {
      cby = (L + 16.0F) / 116.0F;
      Y = y0 * cby * cby * cby;
    }
    tmp = static_cast<float>(a) / 256.0F / 500.0F + cby;
    X = tmp < 0.2069F ? x0 * (tmp - 0.13793F) / 7.787F : x0 * tmp * tmp * tmp;
    tmp = cby - static_cast<float>(b) / 256.0F / 200.0F;
    Z = tmp < 0.2069F ? z0 * (tmp - 0.13793F) / 7.787F : z0 * tmp * tmp * tmp;
    const float* m = kMat;
    o[0] = channel(m[0] * X + m[1] * Y + m[2] * Z);
    o[1] = channel(m[3] * X + m[4] * Y + m[5] * Z);
    o[2] = channel(m[6] * X + m[7] * Y + m[8] * Z);
  }
};

enum Kind { kGrey, kPalette, kRgb, kCmyk, kYCbCr, kSeparateRgb, kSeparateCmyk, kSeparateYCbCr,
            kCieLab };
enum Alpha { kNoAlpha, kAssociated, kUnassociated };

uint8_t to8(int v) { return static_cast<uint8_t>((v + 128) / 257); }  // BuildMapBitdepth16To8
uint8_t premultiply(int v, int a) { return static_cast<uint8_t>((v * a + 127) / 255); }  // UaToAa

// A page's layout and coding, as native/tiff.py's _Layout reads them.
enum Param {
  kCompression, kReverse, kPredictor, kSwap, kBps, kSpp, kKind, kAlpha, kWidth, kHeight,
  kChunkW, kChunkH, kAcross, kDown, kTiled, kSubH, kSubV, kInvert, kPlanes, kRowBytes,
  kScanline, kStride, kT4Options, kParams
};

// rows x width pixels of one chunk (contiguous planes[0], or one plane a
// sample) into RGB at out, stride bytes a row
void put(const uint8_t* const* planes, const int* p, int width, int rows, const uint8_t* cmap,
         const YCbCr* table, const CieLab* lab, uint8_t* out, long stride) {
  const int kind = p[kKind], bps = p[kBps], spp = p[kSpp], alpha = p[kAlpha];
  const int chunk_w = p[kChunkW], sub_h = p[kSubH], sub_v = p[kSubV], invert = p[kInvert];
  if (width <= 0 || rows <= 0 || width > chunk_w) fail("bad TIFF chunk geometry");
  const size_t row_bytes = static_cast<size_t>(p[kRowBytes]);
  const int wide = bps == 16;
  auto sample = [&](const uint8_t* row, size_t i) -> int {
    return wide ? reinterpret_cast<const uint16_t*>(row)[i] : row[i];
  };
  if (kind == kYCbCr || kind == kSeparateYCbCr) {
    const YCbCr& t = *table;
    if (kind == kSeparateYCbCr) {
      for (int y = 0; y < rows; ++y) {
        uint8_t* o = out + y * stride;
        for (int x = 0; x < width; ++x)
          t.rgb(planes[0][y * row_bytes + x], planes[1][y * row_bytes + x], planes[2][y * row_bytes + x],
                o + 3 * x);
      }
      return;
    }
    const int unit = sub_h * sub_v + 2, blocks = (chunk_w + sub_h - 1) / sub_h;
    for (int y = 0; y < rows; ++y) {
      const uint8_t* units = planes[0] + static_cast<size_t>(y / sub_v) * blocks * unit;
      uint8_t* o = out + y * stride;
      for (int x = 0; x < width; ++x) {
        const uint8_t* u = units + static_cast<size_t>(x / sub_h) * unit;
        t.rgb(u[(y % sub_v) * sub_h + x % sub_h], u[unit - 2], u[unit - 1], o + 3 * x);
      }
    }
    return;
  }
  for (int y = 0; y < rows; ++y) {
    uint8_t* o = out + y * stride;
    const uint8_t* row = planes[0] + y * row_bytes;
    switch (kind) {
      case kGrey:
        for (int x = 0; x < width; ++x) {
          int v;
          if (bps == 1)
            v = (row[x >> 3] >> (7 - (x & 7)) & 1) * 255;
          else
            v = wide ? sample(row, static_cast<size_t>(x) * spp) >> 8 : row[static_cast<size_t>(x) * spp];
          if (invert) v = 255 - v;
          o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = static_cast<uint8_t>(v);
        }
        break;
      case kPalette:
        for (int x = 0; x < width; ++x) {
          int i;
          if (bps == 1)
            i = row[x >> 3] >> (7 - (x & 7)) & 1;
          else if (bps == 4)
            i = row[x >> 1] >> ((x & 1) ? 0 : 4) & 15;
          else
            i = row[static_cast<size_t>(x) * spp];
          o[3 * x] = cmap[i];
          o[3 * x + 1] = cmap[256 + i];
          o[3 * x + 2] = cmap[512 + i];
        }
        break;
      case kRgb:
        for (int x = 0; x < width; ++x) {
          const size_t at = static_cast<size_t>(x) * spp;
          int c[3];
          for (int k = 0; k < 3; ++k) c[k] = wide ? to8(sample(row, at + k)) : row[at + k];
          if (alpha == kUnassociated) {
            const int a = wide ? to8(sample(row, at + 3)) : row[at + 3];
            for (int k = 0; k < 3; ++k) c[k] = premultiply(c[k], a);
          }
          for (int k = 0; k < 3; ++k) o[3 * x + k] = static_cast<uint8_t>(c[k]);
        }
        break;
      case kCmyk:
        for (int x = 0; x < width; ++x) {
          const uint8_t* s = row + static_cast<size_t>(x) * spp;
          const int k = 255 - s[3];
          for (int j = 0; j < 3; ++j) o[3 * x + j] = static_cast<uint8_t>(k * (255 - s[j]) / 255);
        }
        break;
      case kSeparateRgb: {  // grey planes arrive as planes[0] three times
        const uint8_t* r[4];
        for (int k = 0; k < 4; ++k) r[k] = planes[k] ? planes[k] + y * row_bytes : nullptr;
        for (int x = 0; x < width; ++x) {
          int c[3];
          for (int k = 0; k < 3; ++k) c[k] = wide ? to8(sample(r[k], x)) : r[k][x];
          if (alpha == kUnassociated) {
            const int a = wide ? to8(sample(r[3], x)) : r[3][x];
            for (int k = 0; k < 3; ++k) c[k] = premultiply(c[k], a);
          }
          for (int k = 0; k < 3; ++k) o[3 * x + k] = static_cast<uint8_t>(c[k]);
        }
        break;
      }
      case kCieLab:  // putcontig8bitCIELab8 / 16: L unsigned, a and b signed
        for (int x = 0; x < width; ++x) {
          if (wide) {
            const uint16_t* s = reinterpret_cast<const uint16_t*>(row) + 3 * static_cast<size_t>(x);
            lab->rgb(s[0], static_cast<int16_t>(s[1]), static_cast<int16_t>(s[2]), o + 3 * x);
          } else {
            const uint8_t* s = row + 3 * static_cast<size_t>(x);
            lab->rgb(s[0] * 257u, static_cast<int8_t>(s[1]) * 256, static_cast<int8_t>(s[2]) * 256,
                     o + 3 * x);
          }
        }
        break;
      case kSeparateCmyk:
        for (int x = 0; x < width; ++x) {
          const int k = 255 - planes[3][y * row_bytes + x];
          for (int j = 0; j < 3; ++j)
            o[3 * x + j] = static_cast<uint8_t>(k * (255 - planes[j][y * row_bytes + x]) / 255);
        }
        break;
      default:
        fail("unknown TIFF put routine %d", kind);
    }
  }
}


// a stored chunk (compression 1, 2, 3, 4, 5 or 32773; bits reversed first
// under FillOrder 2) of `rows` rows into exactly `need` bytes
void expand(const uint8_t* src, size_t size, const int* p, int rows, uint8_t* out, size_t need) {
  const int compression = p[kCompression];
  const bool reverse = p[kReverse] != 0;
  std::vector<uint8_t> flipped;
  if (reverse) {
    flipped.resize(size);
    for (size_t i = 0; i < size; ++i) flipped[i] = reverse_bits(src[i]);
    src = flipped.data();
  }
  switch (compression) {
    case 1:
      if (size < need) fail("chunk holds %zu of its %zu bytes", size, need);
      std::memcpy(out, src, need);
      break;
    case 5:
      lzw(src, size, out, need);
      break;
    case 32773:
      packbits(src, size, out, need);
      break;
    case 2:
    case 3:
    case 4:
      fax(src, size, compression, p[kT4Options], p[kChunkW], rows, out, need);
      break;
    default:
      fail("compression %d is not expanded here", compression);
  }
}

// in place: 16-bit words swapped when `swap`, then predictor 2 undone over
// rows of row_bytes bytes, samples `stride` apart (tif_predict.c horAcc8 / 16)
void samples(uint8_t* buf, size_t size, size_t row_bytes, size_t stride, int bps, bool swap,
             int predictor) {
  if (bps == 16 && swap)
    for (size_t i = 0; i + 1 < size; i += 2) std::swap(buf[i], buf[i + 1]);
  if (predictor != 2) return;
  if (row_bytes == 0 || size % row_bytes || stride == 0) fail("predictor rows of %zu bytes", row_bytes);
  for (size_t r = 0; r < size; r += row_bytes) {
    if (bps == 8) {
      uint8_t* row = buf + r;
      for (size_t i = stride; i < row_bytes; ++i) row[i] = static_cast<uint8_t>(row[i] + row[i - stride]);
    } else {
      uint16_t* row = reinterpret_cast<uint16_t*>(buf + r);
      for (size_t i = stride; i < row_bytes / 2; ++i) row[i] = static_cast<uint16_t>(row[i] + row[i - stride]);
    }
  }
}

void decode(const uint8_t* data, size_t size, const uint64_t* offsets, const uint64_t* counts,
            const int* p, const int* slots, const uint8_t* cmap, const float* ycc, uint8_t* out) {
  const int width = p[kWidth], height = p[kHeight], chunk_w = p[kChunkW], chunk_h = p[kChunkH];
  const int across = p[kAcross], down = p[kDown], sub_v = p[kSubV];
  const size_t row_bytes = static_cast<size_t>(p[kRowBytes]);
  const bool units = p[kSubH] > 1 || sub_v > 1;  // YCbCr data units of sub_v rows
  if (width <= 0 || height <= 0 || chunk_w <= 0 || chunk_h <= 0 || across <= 0 || down <= 0)
    fail("bad TIFF geometry");
  for (int j = 0; j < 4; ++j)
    if (slots[j] >= p[kPlanes]) fail("plane %d of %d", slots[j], p[kPlanes]);
  // the rows put reads: samples of a chunk's width, or its data units
  const size_t least = units ? static_cast<size_t>((chunk_w + p[kSubH] - 1) / p[kSubH]) * (p[kSubH] * sub_v + 2)
                             : (static_cast<size_t>(chunk_w) * (p[kKind] >= kSeparateRgb ? 1 : p[kSpp]) * p[kBps] + 7) / 8;
  if (row_bytes < least) fail("chunk rows of %zu bytes where %zu are read", row_bytes, least);
  const bool ycbcr = p[kKind] == kYCbCr || p[kKind] == kSeparateYCbCr;
  const std::unique_ptr<YCbCr> table(ycbcr ? new YCbCr(ycc) : nullptr);
  const std::unique_ptr<CieLab> lab(p[kKind] == kCieLab ? new CieLab(ycc) : nullptr);
  std::vector<uint8_t> bufs[4];
  const long stride = 3L * width;
  for (int band = 0; band < down; ++band) {
    const int y0 = band * chunk_h;
    const int rows = p[kTiled] ? chunk_h : std::min(chunk_h, height - y0);
    const size_t need = units ? static_cast<size_t>((rows + sub_v - 1) / sub_v) * row_bytes
                              : static_cast<size_t>(rows) * row_bytes;
    for (int col = 0; col < across; ++col) {
      const int x0 = col * chunk_w;
      const size_t k = static_cast<size_t>(band) * across + col;
      const uint8_t* planes[4] = {};
      for (int j = 0; j < 4; ++j) {
        const int plane = slots[j];
        if (plane < 0) continue;
        bool done = false;  // a plane feeds several pointers (grey taken as RGB)
        for (int i = 0; i < j; ++i) done |= slots[i] == plane;
        std::vector<uint8_t>& buf = bufs[j];
        if (!done) {
          const size_t at = static_cast<size_t>(plane) * across * down + k;
          if (offsets[at] > size || counts[at] > size - offsets[at]) fail("chunk %zu lies past the file", k);
          buf.resize(need);
          expand(data + offsets[at], counts[at], p, rows, buf.data(), need);
          samples(buf.data(), need, static_cast<size_t>(p[kScanline]), static_cast<size_t>(p[kStride]),
                  p[kBps], p[kSwap] != 0, p[kPredictor]);
          planes[j] = buf.data();
        } else {
          for (int i = 0; i < j; ++i)
            if (slots[i] == plane) planes[j] = planes[i];
        }
      }
      put(planes, p, std::min(chunk_w, width - x0), std::min(rows, height - y0), cmap, table.get(),
          lab.get(), out + (static_cast<size_t>(y0) * width + x0) * 3, stride);
    }
  }
}

}  // namespace

extern "C" int vd_tiff_decode(const uint8_t* data, unsigned long size, const uint64_t* offsets,
                              const uint64_t* counts, const int* params, const int* slots,
                              const uint8_t* colormap, const float* ycbcr, uint8_t* out, char* err,
                              int err_len) {
  try {
    decode(data, size, offsets, counts, params, slots, colormap, ycbcr, out);
    return 0;
  } catch (const TiffError& e) {
    return report(e.msg, err, err_len);
  } catch (const std::bad_alloc&) {
    return report("out of memory", err, err_len);
  }
}
