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
//            data taken as an end code).  Bytes past the chunk's size are
//            not decoded; fewer are an error.
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
//            1x1).
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
//     ReferenceBlackWhite as libtiff reads them (9 floats).

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

enum Kind { kGrey, kPalette, kRgb, kCmyk, kYCbCr, kSeparateRgb, kSeparateCmyk, kSeparateYCbCr };
enum Alpha { kNoAlpha, kAssociated, kUnassociated };

uint8_t to8(int v) { return static_cast<uint8_t>((v + 128) / 257); }  // BuildMapBitdepth16To8
uint8_t premultiply(int v, int a) { return static_cast<uint8_t>((v * a + 127) / 255); }  // UaToAa

// A page's layout and coding, as native/tiff.py's _Layout reads them.
enum Param {
  kCompression, kReverse, kPredictor, kSwap, kBps, kSpp, kKind, kAlpha, kWidth, kHeight,
  kChunkW, kChunkH, kAcross, kDown, kTiled, kSubH, kSubV, kInvert, kPlanes, kRowBytes,
  kScanline, kStride, kParams
};

// rows x width pixels of one chunk (contiguous planes[0], or one plane a
// sample) into RGB at out, stride bytes a row
void put(const uint8_t* const* planes, const int* p, int width, int rows, const uint8_t* cmap,
         const YCbCr* table, uint8_t* out, long stride) {
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


// a stored chunk (compression 1, 5 or 32773; bits reversed first under
// FillOrder 2) into exactly `need` bytes
void expand(const uint8_t* src, size_t size, int compression, bool reverse, uint8_t* out,
            size_t need) {
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
          expand(data + offsets[at], counts[at], p[kCompression], p[kReverse] != 0, buf.data(), need);
          samples(buf.data(), need, static_cast<size_t>(p[kScanline]), static_cast<size_t>(p[kStride]),
                  p[kBps], p[kSwap] != 0, p[kPredictor]);
          planes[j] = buf.data();
        } else {
          for (int i = 0; i < j; ++i)
            if (slots[i] == plane) planes[j] = planes[i];
        }
      }
      put(planes, p, std::min(chunk_w, width - x0), std::min(rows, height - y0), cmap, table.get(),
          out + (static_cast<size_t>(y0) * width + x0) * 3, stride);
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
