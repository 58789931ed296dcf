// WebP still images (the bitstreams; native/webp.py walks the RIFF
// container), decoded as libwebp decodes them for cv2.imdecode:
//
//   lossless  the VP8L bitstream: the 5-byte header, the four transforms
//             (predictor with its 14 modes, cross-colour, subtract-green,
//             colour-indexing with 2, 4 and 16-colour pixel bundling),
//             the colour cache, meta prefix codes (the entropy image),
//             simple and normal prefix codes with their code-length code,
//             and LZ77 backward references with the 120-entry distance map.
//             Lossless is exact, so any correct decoder gives libwebp's ARGB.
//   lossy     the VP8 key frame of a `VP8 ` chunk, decoded by vd_vp8::Decoder
//             (vp8.cpp), then libwebp's own YUV -> RGB step: the "fancy"
//             upsampler (UpsampleRgbLinePair's 9-3-3-1 chroma filter, the
//             first and last rows and columns from the nearer samples only)
//             and VP8YUVToR/G/B's 14-bit fixed point, cropped to the frame's
//             width and height.
//
// The alpha channel (VP8L's own, or an ALPH chunk beside a lossy frame) is
// dropped, as cv2.imdecode(IMREAD_COLOR) drops it.  No library beyond the
// C++ standard one.
//
// C interface (extern "C"; 0 on success, else -1 and a message in err):
//   vd_vp8l_decode(data, size, width, height, rgb, &features, &modes, err, err_len)
//     a VP8L bitstream (its header included) of width x height pixels into
//     RGB; features holds the kFeature bits below, modes one bit for each
//     predictor mode used.
//   vd_webp_lossy(data, size, width, height, rgb, err, err_len)
//     a VP8 key frame of width x height pixels into RGB.

#include <algorithm>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <new>
#include <string>
#include <vector>

#include "vp8.h"

namespace {

struct Error {
  std::string msg;
};

[[noreturn]] __attribute__((format(printf, 1, 2))) void fail(const char* fmt, ...) {
  char buf[256];
  va_list ap;
  va_start(ap, fmt);
  std::vsnprintf(buf, sizeof(buf), fmt, ap);
  va_end(ap);
  throw Error{buf};
}

// What a VP8L bitstream used (the Python side names them: native.VP8L_FEATURES).
enum Feature : uint32_t {
  kPredictor = 1u << 0,
  kCrossColor = 1u << 1,
  kSubtractGreen = 1u << 2,
  kColorIndexing = 1u << 3,
  kBundle2 = 1u << 4,    // colour-indexing with 2 pixels a byte (3-16 colours)
  kBundle4 = 1u << 5,    // 4 pixels a byte (3 or 4 colours)
  kBundle8 = 1u << 6,    // 8 pixels a byte (1 or 2 colours)
  kColorCache = 1u << 7,
  kBackwardRefs = 1u << 8,
  kMetaCodes = 1u << 9,  // an entropy image of more than one prefix code group
  kSimpleCode = 1u << 10,
  kNormalCode = 1u << 11,
  kRepeatCodes = 1u << 12,    // code lengths 16-18 in a code-length code
  kMaxSymbol = 1u << 13,      // a code-length sequence cut short by max_symbol
  kCacheHits = 1u << 14,      // pixels taken from the colour cache
};

// ---------------------------------------------------------------- bits

class BitReader {
 public:
  BitReader(const uint8_t* data, size_t size) : data_(data), size_(size) { fill(); }

  uint32_t read(int n) {  // n <= 24
    if (n == 0) return 0;
    fill();
    const uint32_t v = static_cast<uint32_t>(buf_) & ((1u << n) - 1);
    buf_ >>= n;
    nbits_ -= n;
    return v;
  }
  uint32_t peek(int n) {
    fill();
    return static_cast<uint32_t>(buf_) & ((1u << n) - 1);
  }
  void skip(int n) {
    buf_ >>= n;
    nbits_ -= n;
  }
  // Fails when more bits were taken than the data holds (the rest read as 0).
  void check(const char* what) const {
    if (pos_ * 8 - static_cast<size_t>(nbits_) > size_ * 8) fail("VP8L %s is truncated", what);
  }

 private:
  void fill() {
    while (nbits_ <= 56) {
      const uint64_t byte = pos_ < size_ ? data_[pos_] : 0;  // zeros past the end
      ++pos_;
      buf_ |= byte << nbits_;
      nbits_ += 8;
    }
  }
  const uint8_t* data_;
  size_t size_;
  size_t pos_ = 0;
  uint64_t buf_ = 0;
  int nbits_ = 0;
};

// ---------------------------------------------------------------- prefix codes

constexpr int kMaxCodeLength = 15;
constexpr int kRootBits = 8;

// A canonical prefix code: codes of up to kRootBits bits straight from a
// table, longer ones by the canonical walk from kRootBits + 1 on.
struct PrefixCode {
  std::vector<uint16_t> symbols;  // by length, then by value
  int count[kMaxCodeLength + 1] = {};
  uint32_t root[1 << kRootBits];  // (symbol << 8) | length, 0 when longer
  int single = -1;                // a code of one symbol: no bits read

  void build(const std::vector<uint8_t>& lengths) {
    std::fill(std::begin(count), std::end(count), 0);
    int used = 0, last = 0;
    for (size_t s = 0; s < lengths.size(); ++s) {
      if (lengths[s]) {
        ++count[lengths[s]];
        ++used;
        last = static_cast<int>(s);
      }
    }
    if (used == 0) fail("VP8L prefix code has no symbol");
    if (used == 1) {
      single = last;
      return;
    }
    int left = 1;  // Kraft: the code must be complete
    for (int len = 1; len <= kMaxCodeLength; ++len) {
      left <<= 1;
      left -= count[len];
      if (left < 0) fail("VP8L prefix code is over-subscribed");
    }
    if (left != 0) fail("VP8L prefix code is incomplete");
    int offs[kMaxCodeLength + 2] = {};
    for (int len = 1; len <= kMaxCodeLength; ++len) offs[len + 1] = offs[len] + count[len];
    symbols.assign(used, 0);
    for (size_t s = 0; s < lengths.size(); ++s)
      if (lengths[s]) symbols[offs[lengths[s]]++] = static_cast<uint16_t>(s);
    // the root table: canonical codes are sent most significant bit first
    std::fill(std::begin(root), std::end(root), 0);
    uint32_t code = 0;
    int index = 0;
    for (int len = 1; len <= kRootBits; ++len) {
      for (int k = 0; k < count[len]; ++k, ++index, ++code) {
        uint32_t rev = 0;
        for (int b = 0; b < len; ++b) rev |= ((code >> b) & 1u) << (len - 1 - b);
        for (uint32_t fillv = rev; fillv < (1u << kRootBits); fillv += 1u << len)
          root[fillv] = (static_cast<uint32_t>(symbols[index]) << 8) | len;
      }
      code <<= 1;
    }
  }

  int read(BitReader& br) const {
    if (single >= 0) return single;
    const uint32_t e = root[br.peek(kRootBits)];
    if (e) {
      br.skip(e & 0xff);
      return static_cast<int>(e >> 8);
    }
    // canonical walk, one bit at a time
    int code = 0, first = 0, index = 0;
    for (int len = 1; len <= kMaxCodeLength; ++len) {
      code |= static_cast<int>(br.read(1));
      const int n = count[len];
      if (code - first < n) return symbols[index + code - first];
      index += n;
      first = (first + n) << 1;
      code <<= 1;
    }
    fail("VP8L prefix code: no symbol matches");
  }
};

const uint8_t kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};

// The distance map: (dx, dy) of the 120 short distance codes.
const int8_t kDistanceMap[120][2] = {
    {0, 1},  {1, 0},  {1, 1},  {-1, 1}, {0, 2},  {2, 0},  {1, 2},  {-1, 2}, {2, 1},  {-2, 1},
    {2, 2},  {-2, 2}, {0, 3},  {3, 0},  {1, 3},  {-1, 3}, {3, 1},  {-3, 1}, {2, 3},  {-2, 3},
    {3, 2},  {-3, 2}, {0, 4},  {4, 0},  {1, 4},  {-1, 4}, {4, 1},  {-4, 1}, {3, 3},  {-3, 3},
    {2, 4},  {-2, 4}, {4, 2},  {-4, 2}, {0, 5},  {3, 4},  {-3, 4}, {4, 3},  {-4, 3}, {5, 0},
    {1, 5},  {-1, 5}, {5, 1},  {-5, 1}, {2, 5},  {-2, 5}, {5, 2},  {-5, 2}, {4, 4},  {-4, 4},
    {3, 5},  {-3, 5}, {5, 3},  {-5, 3}, {0, 6},  {6, 0},  {1, 6},  {-1, 6}, {6, 1},  {-6, 1},
    {2, 6},  {-2, 6}, {6, 2},  {-6, 2}, {4, 5},  {-4, 5}, {5, 4},  {-5, 4}, {3, 6},  {-3, 6},
    {6, 3},  {-6, 3}, {0, 7},  {7, 0},  {1, 7},  {-1, 7}, {5, 5},  {-5, 5}, {7, 1},  {-7, 1},
    {4, 6},  {-4, 6}, {6, 4},  {-6, 4}, {2, 7},  {-2, 7}, {7, 2},  {-7, 2}, {3, 7},  {-3, 7},
    {7, 3},  {-7, 3}, {5, 6},  {-5, 6}, {6, 5},  {-6, 5}, {8, 0},  {4, 7},  {-4, 7}, {7, 4},
    {-7, 4}, {8, 1},  {8, 2},  {6, 6},  {-6, 6}, {8, 3},  {5, 7},  {-5, 7}, {7, 5},  {-7, 5},
    {8, 4},  {6, 7},  {-6, 7}, {7, 6},  {-7, 6}, {8, 5},  {7, 7},  {-7, 7}, {8, 6},  {8, 7}};

constexpr int kNumLiteralCodes = 256, kNumLengthCodes = 24, kNumDistanceCodes = 40;

struct Group {
  PrefixCode green, red, blue, alpha, dist;
};

enum Transform { kPredictorT = 0, kCrossColorT = 1, kSubtractGreenT = 2, kColorIndexingT = 3 };

struct TransformData {
  int type;
  int xsize;  // the width the transform's output has
  int bits;
  std::vector<uint32_t> data;  // the sub-image, or the palette (256 entries)
};

uint32_t average2(uint32_t a, uint32_t b) { return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b); }

uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

uint32_t clamp_add_subtract_full(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int v = static_cast<int>((a >> s) & 0xff) + static_cast<int>((b >> s) & 0xff) -
                  static_cast<int>((c >> s) & 0xff);
    out |= static_cast<uint32_t>(clip255(v)) << s;
  }
  return out;
}

uint32_t clamp_add_subtract_half(uint32_t a, uint32_t b) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int x = static_cast<int>((a >> s) & 0xff), y = static_cast<int>((b >> s) & 0xff);
    out |= static_cast<uint32_t>(clip255(x + (x - y) / 2)) << s;
  }
  return out;
}

uint32_t select(uint32_t top, uint32_t left, uint32_t top_left) {
  int pa_minus_pb = 0;  // sum |left - top_left| - |top - top_left|
  for (int s = 0; s < 32; s += 8) {
    const int t = static_cast<int>((top >> s) & 0xff), l = static_cast<int>((left >> s) & 0xff),
              tl = static_cast<int>((top_left >> s) & 0xff);
    pa_minus_pb += std::abs(l - tl) - std::abs(t - tl);
  }
  return pa_minus_pb <= 0 ? top : left;
}

uint32_t predict(int mode, uint32_t left, const uint32_t* top) {
  switch (mode) {
    case 1: return left;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return average2(average2(left, top[1]), top[0]);
    case 6: return average2(left, top[-1]);
    case 7: return average2(left, top[0]);
    case 8: return average2(top[-1], top[0]);
    case 9: return average2(top[0], top[1]);
    case 10: return average2(average2(left, top[-1]), average2(top[0], top[1]));
    case 11: return select(top[0], left, top[-1]);
    case 12: return clamp_add_subtract_full(left, top[0], top[-1]);
    case 13: return clamp_add_subtract_half(average2(left, top[0]), top[-1]);
    default: return 0xff000000u;  // 0, and 14 and 15 as libwebp pads them
  }
}

int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

class LosslessDecoder {
 public:
  LosslessDecoder(const uint8_t* data, size_t size) : br_(data, size) {}

  std::vector<uint32_t> decode(int width, int height) {
    // the header (signature, sizes, alpha hint, version): read by the caller too
    if (br_.read(8) != 0x2f) fail("not a VP8L bitstream (signature)");
    const int w = static_cast<int>(br_.read(14)) + 1, h = static_cast<int>(br_.read(14)) + 1;
    br_.read(1);  // alpha_is_used: a hint only
    if (br_.read(3) != 0) fail("VP8L version is not 0");
    if (w != width || h != height) fail("VP8L size %dx%d is not the container's %dx%d", w, h, width, height);
    return image_stream(width, height, true);
  }

  uint32_t features = 0, modes = 0;

 private:
  std::vector<uint32_t> image_stream(int xsize, int ysize, bool level0) {
    std::vector<TransformData> transforms;
    int width = xsize;
    if (level0) {
      uint32_t seen = 0;
      while (br_.read(1)) {
        const int type = static_cast<int>(br_.read(2));
        if (seen & (1u << type)) fail("VP8L transform %d appears twice", type);
        seen |= 1u << type;
        TransformData t{type, width, 0, {}};
        if (type == kPredictorT || type == kCrossColorT) {
          t.bits = static_cast<int>(br_.read(3)) + 2;
          t.data = image_stream(subsample(width, t.bits), subsample(ysize, t.bits), false);
          features |= type == kPredictorT ? kPredictor : kCrossColor;
        } else if (type == kColorIndexingT) {
          const int colours = static_cast<int>(br_.read(8)) + 1;
          t.bits = colours > 16 ? 0 : colours > 4 ? 1 : colours > 2 ? 2 : 3;
          std::vector<uint32_t> pal = image_stream(colours, 1, false);
          t.data.assign(256, 0);  // entries past the palette are transparent black
          t.data[0] = pal[0];
          for (int i = 1; i < colours; ++i) t.data[i] = add_pixels(pal[i], t.data[i - 1]);
          width = subsample(width, t.bits);
          features |= kColorIndexing;
          if (t.bits) features |= t.bits == 1 ? kBundle2 : t.bits == 2 ? kBundle4 : kBundle8;
        } else {
          features |= kSubtractGreen;
        }
        transforms.push_back(std::move(t));
      }
    }
    int cache_bits = 0;
    if (br_.read(1)) {
      cache_bits = static_cast<int>(br_.read(4));
      if (cache_bits < 1 || cache_bits > 11) fail("VP8L colour cache of %d bits", cache_bits);
      features |= kColorCache;
    }
    // meta prefix codes
    int meta_bits = 0, meta_w = 0;
    std::vector<uint32_t> meta;
    int groups = 1;
    if (level0 && br_.read(1)) {
      meta_bits = static_cast<int>(br_.read(3)) + 2;
      meta_w = subsample(width, meta_bits);
      meta = image_stream(meta_w, subsample(ysize, meta_bits), false);
      for (uint32_t& m : meta) {
        m = (m >> 8) & 0xffff;
        groups = std::max(groups, static_cast<int>(m) + 1);
      }
      if (groups > 1) features |= kMetaCodes;
    }
    br_.check("header");
    const int cache_size = cache_bits ? 1 << cache_bits : 0;
    std::vector<Group> codes(groups);
    for (Group& g : codes) {
      read_code(g.green, kNumLiteralCodes + kNumLengthCodes + cache_size);
      read_code(g.red, kNumLiteralCodes);
      read_code(g.blue, kNumLiteralCodes);
      read_code(g.alpha, kNumLiteralCodes);
      read_code(g.dist, kNumDistanceCodes);
    }
    br_.check("prefix codes");
    std::vector<uint32_t> pixels = decode_pixels(width, ysize, codes, meta, meta_bits, meta_w, cache_bits);
    for (auto t = transforms.rbegin(); t != transforms.rend(); ++t) pixels = inverse(*t, pixels, ysize);
    return pixels;
  }

  void read_code(PrefixCode& code, int alphabet) {
    std::vector<uint8_t> lengths(alphabet, 0);
    if (br_.read(1)) {  // simple code: one or two symbols
      features |= kSimpleCode;
      const int n = static_cast<int>(br_.read(1)) + 1;
      const int first = static_cast<int>(br_.read(br_.read(1) ? 8 : 1));
      if (first >= alphabet) fail("VP8L simple code symbol %d out of range", first);
      lengths[first] = 1;
      if (n == 2) {
        const int second = static_cast<int>(br_.read(8));
        if (second >= alphabet) fail("VP8L simple code symbol %d out of range", second);
        lengths[second] = 1;
      }
    } else {
      features |= kNormalCode;
      std::vector<uint8_t> cl_lengths(19, 0);
      const int n = static_cast<int>(br_.read(4)) + 4;
      for (int i = 0; i < n; ++i) cl_lengths[kCodeLengthOrder[i]] = static_cast<uint8_t>(br_.read(3));
      PrefixCode cl;
      cl.build(cl_lengths);
      int max_symbol = alphabet;
      if (br_.read(1)) {
        const int nbits = 2 + 2 * static_cast<int>(br_.read(3));
        max_symbol = 2 + static_cast<int>(br_.read(nbits));
        if (max_symbol > alphabet) fail("VP8L code-length count %d past the alphabet", max_symbol);
        features |= kMaxSymbol;
      }
      int prev = 8, symbol = 0;
      while (symbol < alphabet) {
        if (max_symbol-- == 0) break;
        br_.check("code lengths");
        const int len = cl.read(br_);
        if (len < 16) {
          lengths[symbol++] = static_cast<uint8_t>(len);
          if (len) prev = len;
        } else {
          features |= kRepeatCodes;
          const int slot = len - 16;
          static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
          const int repeat = static_cast<int>(br_.read(kExtra[slot])) + kOffset[slot];
          if (symbol + repeat > alphabet) fail("VP8L code-length repeat past the alphabet");
          const int v = len == 16 ? prev : 0;
          for (int k = 0; k < repeat; ++k) lengths[symbol++] = static_cast<uint8_t>(v);
        }
      }
    }
    code.build(lengths);
  }

  int copy_length(int symbol) {
    if (symbol < 4) return symbol + 1;
    const int extra = (symbol - 2) >> 1;
    const int offset = (2 + (symbol & 1)) << extra;
    return offset + static_cast<int>(br_.read(extra)) + 1;
  }

  std::vector<uint32_t> decode_pixels(int width, int height, const std::vector<Group>& codes,
                                      const std::vector<uint32_t>& meta, int meta_bits, int meta_w,
                                      int cache_bits) {
    const size_t total = static_cast<size_t>(width) * height;
    std::vector<uint32_t> out(total);
    std::vector<uint32_t> cache(cache_bits ? size_t{1} << cache_bits : 0, 0);
    const int cache_shift = 32 - cache_bits;
    size_t pos = 0, cached = 0;  // pixels up to `cached` are in the cache
    int x = 0, y = 0;
    const Group* g = &codes[0];
    const int mask = meta_bits ? (1 << meta_bits) - 1 : -1;
    auto pick = [&]() {
      if (!meta.empty()) {
        const uint32_t m = meta[static_cast<size_t>(y >> meta_bits) * meta_w + (x >> meta_bits)];
        g = &codes[m];
      }
    };
    pick();
    while (pos < total) {
      if ((x & mask) == 0) pick();
      if ((pos & 0xfff) == 0) br_.check("image data");
      const int s = g->green.read(br_);
      if (s < kNumLiteralCodes) {
        const uint32_t red = g->red.read(br_), blue = g->blue.read(br_), alpha = g->alpha.read(br_);
        out[pos++] = (alpha << 24) | (red << 16) | (static_cast<uint32_t>(s) << 8) | blue;
        if (++x >= width) {
          x = 0;
          ++y;
        }
      } else if (s < kNumLiteralCodes + kNumLengthCodes) {
        features |= kBackwardRefs;
        const int length = copy_length(s - kNumLiteralCodes);
        const int dist_symbol = g->dist.read(br_);
        const int dist_code = copy_length(dist_symbol);
        long dist;
        if (dist_code > 120) {
          dist = dist_code - 120;
        } else {
          const int8_t* d = kDistanceMap[dist_code - 1];
          dist = static_cast<long>(d[1]) * width + d[0];
          if (dist < 1) dist = 1;
        }
        if (static_cast<size_t>(dist) > pos || total - pos < static_cast<size_t>(length))
          fail("VP8L backward reference out of the image");
        for (int k = 0; k < length; ++k, ++pos) out[pos] = out[pos - dist];
        x += length;
        while (x >= width) {
          x -= width;
          ++y;
        }
        if (x & mask && !meta.empty()) pick();
      } else {
        const int key = s - (kNumLiteralCodes + kNumLengthCodes);
        if (key >= static_cast<int>(cache.size())) fail("VP8L colour cache index out of range");
        features |= kCacheHits;
        while (cached < pos) {  // the cache holds every pixel before this one
          cache[(0x1e35a7bdu * out[cached]) >> cache_shift] = out[cached];
          ++cached;
        }
        out[pos++] = cache[key];
        if (++x >= width) {
          x = 0;
          ++y;
        }
      }
      if (cache_bits) {
        while (cached < pos) {
          cache[(0x1e35a7bdu * out[cached]) >> cache_shift] = out[cached];
          ++cached;
        }
      }
    }
    br_.check("image data");
    return out;
  }

  std::vector<uint32_t> inverse(const TransformData& t, std::vector<uint32_t>& in, int height) {
    const int w = t.xsize;
    switch (t.type) {
      case kSubtractGreenT:
        for (uint32_t& p : in) {
          const uint32_t g = (p >> 8) & 0xff;
          const uint32_t rb = ((((p >> 16) & 0xff) + g) & 0xff) << 16 | (((p & 0xff) + g) & 0xff);
          p = (p & 0xff00ff00u) | rb;
        }
        return std::move(in);
      case kPredictorT: {
        const int tiles_w = subsample(w, t.bits);
        for (int y = 0; y < height; ++y) {
          uint32_t* row = in.data() + static_cast<size_t>(y) * w;
          for (int x = 0; x < w; ++x) {
            uint32_t pred;
            if (y == 0) {
              pred = x == 0 ? 0xff000000u : row[x - 1];
            } else if (x == 0) {
              pred = row[x - w];
            } else {
              const int mode = static_cast<int>(
                  (t.data[static_cast<size_t>(y >> t.bits) * tiles_w + (x >> t.bits)] >> 8) & 0xf);
              modes |= 1u << mode;
              pred = predict(mode, row[x - 1], row + x - w);
            }
            row[x] = add_pixels(row[x], pred);
          }
        }
        return std::move(in);
      }
      case kCrossColorT: {
        const int tiles_w = subsample(w, t.bits);
        for (int y = 0; y < height; ++y) {
          uint32_t* row = in.data() + static_cast<size_t>(y) * w;
          for (int x = 0; x < w; ++x) {
            const uint32_t m = t.data[static_cast<size_t>(y >> t.bits) * tiles_w + (x >> t.bits)];
            const int8_t g2r = static_cast<int8_t>(m & 0xff), g2b = static_cast<int8_t>((m >> 8) & 0xff),
                         r2b = static_cast<int8_t>((m >> 16) & 0xff);
            const uint32_t argb = row[x];
            const int8_t green = static_cast<int8_t>(argb >> 8);
            int red = static_cast<int>((argb >> 16) & 0xff), blue = static_cast<int>(argb & 0xff);
            red = (red + ((static_cast<int>(g2r) * green) >> 5)) & 0xff;
            blue += (static_cast<int>(g2b) * green) >> 5;
            blue += (static_cast<int>(r2b) * static_cast<int8_t>(red)) >> 5;
            blue &= 0xff;
            row[x] = (argb & 0xff00ff00u) | (static_cast<uint32_t>(red) << 16) | static_cast<uint32_t>(blue);
          }
        }
        return std::move(in);
      }
      default: {  // colour indexing: widen the packed rows
        const int packed_w = subsample(w, t.bits);
        const int per_byte = 1 << t.bits, pixel_bits = 8 >> t.bits, pmask = (1 << pixel_bits) - 1;
        std::vector<uint32_t> out(static_cast<size_t>(w) * height);
        for (int y = 0; y < height; ++y) {
          const uint32_t* src = in.data() + static_cast<size_t>(y) * packed_w;
          uint32_t* dst = out.data() + static_cast<size_t>(y) * w;
          for (int x = 0; x < w; ++x) {
            const uint32_t packed = (src[x >> t.bits] >> 8) & 0xff;
            const int index = (packed >> ((x & (per_byte - 1)) * pixel_bits)) & pmask;
            dst[x] = t.data[index];
          }
        }
        return out;
      }
    }
  }

  BitReader br_;
};

// ---------------------------------------------------------------- lossy RGB

// libwebp's VP8YUVToR/G/B: 14-bit coefficients, 6 fraction bits kept.
int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
int clip8(int v) { return (v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255; }

void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
  rgb[0] = static_cast<uint8_t>(clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234));
  rgb[1] = static_cast<uint8_t>(clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708));
  rgb[2] = static_cast<uint8_t>(clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685));
}

// UpsampleRgbLinePair: two output rows (bottom may be null) from the chroma
// rows above (top_*) and below (cur_*) them, u in the low and v in the
// high half of each word as libwebp packs them.
void upsample_pair(const uint8_t* top_y, const uint8_t* bottom_y, const uint8_t* top_u,
                   const uint8_t* top_v, const uint8_t* cur_u, const uint8_t* cur_v,
                   uint8_t* top_dst, uint8_t* bottom_dst, int len) {
  auto load = [](int u, int v) { return static_cast<uint32_t>(u) | (static_cast<uint32_t>(v) << 16); };
  auto emit = [](int y, uint32_t uv, uint8_t* dst) { yuv_to_rgb(y, uv & 0xff, uv >> 16, dst); };
  const int last_pair = (len - 1) >> 1;
  uint32_t tl_uv = load(top_u[0], top_v[0]), l_uv = load(cur_u[0], cur_v[0]);
  emit(top_y[0], (3 * tl_uv + l_uv + 0x00020002u) >> 2, top_dst);
  if (bottom_y) emit(bottom_y[0], (3 * l_uv + tl_uv + 0x00020002u) >> 2, bottom_dst);
  for (int x = 1; x <= last_pair; ++x) {
    const uint32_t t_uv = load(top_u[x], top_v[x]), uv = load(cur_u[x], cur_v[x]);
    const uint32_t avg = tl_uv + t_uv + l_uv + uv + 0x00080008u;
    const uint32_t diag_12 = (avg + 2 * (t_uv + l_uv)) >> 3;
    const uint32_t diag_03 = (avg + 2 * (tl_uv + uv)) >> 3;
    emit(top_y[2 * x - 1], (diag_12 + tl_uv) >> 1, top_dst + (2 * x - 1) * 3);
    emit(top_y[2 * x], (diag_03 + t_uv) >> 1, top_dst + 2 * x * 3);
    if (bottom_y) {
      emit(bottom_y[2 * x - 1], (diag_03 + l_uv) >> 1, bottom_dst + (2 * x - 1) * 3);
      emit(bottom_y[2 * x], (diag_12 + uv) >> 1, bottom_dst + 2 * x * 3);
    }
    tl_uv = t_uv;
    l_uv = uv;
  }
  if (!(len & 1)) {
    emit(top_y[len - 1], (3 * tl_uv + l_uv + 0x00020002u) >> 2, top_dst + (len - 1) * 3);
    if (bottom_y) emit(bottom_y[len - 1], (3 * l_uv + tl_uv + 0x00020002u) >> 2, bottom_dst + (len - 1) * 3);
  }
}

// libwebp's EmitFancyRGB over the whole frame: row 0 from chroma row 0
// alone, rows 2k-1 and 2k from chroma rows k-1 and k, and the last row of an
// even height from the last chroma row alone.
void fancy_rgb(const vd_vp8::Decoder& d, int width, int height, uint8_t* rgb) {
  const uint8_t *y = d.plane(0), *u = d.plane(1), *v = d.plane(2);
  const int ys = d.stride(0), uvs = d.stride(1);
  const size_t row = static_cast<size_t>(width) * 3;
  upsample_pair(y, nullptr, u, v, u, v, rgb, nullptr, width);
  int r = 1;
  for (; r + 1 < height; r += 2) {
    const int k = (r + 1) / 2;
    upsample_pair(y + static_cast<size_t>(r) * ys, y + static_cast<size_t>(r + 1) * ys,
                  u + static_cast<size_t>(k - 1) * uvs, v + static_cast<size_t>(k - 1) * uvs,
                  u + static_cast<size_t>(k) * uvs, v + static_cast<size_t>(k) * uvs, rgb + r * row,
                  rgb + (r + 1) * row, width);
  }
  if (r < height) {  // an even height: the last row
    const int k = (height - 1) / 2;
    const uint8_t* cu = u + static_cast<size_t>(k) * uvs;
    const uint8_t* cv = v + static_cast<size_t>(k) * uvs;
    upsample_pair(y + static_cast<size_t>(r) * ys, nullptr, cu, cv, cu, cv, rgb + r * row, nullptr, width);
  }
}

int report(const char* msg, char* err, int err_len) {
  std::snprintf(err, err_len, "%s", msg);
  return -1;
}

}  // namespace

extern "C" {

int vd_vp8l_decode(const uint8_t* data, unsigned long size, int width, int height, uint8_t* rgb,
                   unsigned* features, unsigned* modes, char* err, int err_len) {
  try {
    LosslessDecoder dec(data, size);
    const std::vector<uint32_t> argb = dec.decode(width, height);
    for (size_t i = 0; i < argb.size(); ++i) {
      rgb[3 * i] = static_cast<uint8_t>(argb[i] >> 16);
      rgb[3 * i + 1] = static_cast<uint8_t>(argb[i] >> 8);
      rgb[3 * i + 2] = static_cast<uint8_t>(argb[i]);
    }
    *features = dec.features;
    *modes = dec.modes;
    return 0;
  } catch (const Error& e) {
    return report(e.msg.c_str(), err, err_len);
  } catch (const std::bad_alloc&) {
    return report("out of memory", err, err_len);
  }
}

int vd_webp_lossy(const uint8_t* data, unsigned long size, int width, int height, uint8_t* rgb,
                  char* err, int err_len) {
  try {
    if (size < 3 || (data[0] & 1)) return report("the VP8 frame is not a key frame", err, err_len);
    vd_vp8::Decoder d;
    if (!d.decode(data, size)) return report("the VP8 frame is not shown", err, err_len);
    if (d.overrun()) return report("the VP8 frame reads past the end of a partition", err, err_len);
    if (d.width() != width || d.height() != height) {
      char msg[128];
      std::snprintf(msg, sizeof(msg), "VP8 frame size %dx%d is not the container's %dx%d", d.width(),
                    d.height(), width, height);
      return report(msg, err, err_len);
    }
    fancy_rgb(d, width, height, rgb);
    return 0;
  } catch (const vd_vp8::Error& e) {
    return report(e.msg.c_str(), err, err_len);
  } catch (const Error& e) {
    return report(e.msg.c_str(), err, err_len);
  } catch (const std::bad_alloc&) {
    return report("out of memory", err, err_len);
  }
}

}  // extern "C"
