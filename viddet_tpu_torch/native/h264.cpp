// The port's H.264 decoder: see h264.h.
//
// The bitstream (clause 7 of ITU-T H.264): NAL units from start codes or
// length prefixes, emulation prevention removed; sequence and picture
// parameter sets (VUI included); slice headers of I and P slices with
// reference list modification and reference picture marking; the CAVLC
// macroblock layer (9.2).  The decoding process (clause 8): picture order
// counts of the three types, reference lists and marking (sliding window,
// MMCO 1-6, gaps in frame_num), intra prediction (4x4, 16x16, chroma),
// quarter-sample luma and eighth-sample chroma inter prediction, the 4x4
// transforms with flat scaling, and the deblocking filter.
//
// Where the standard leaves the decoder a choice FFmpeg's is taken:
// pictures are shown in decode order (FFmpeg's output order equals it when
// each picture's order count is at least the previous one's since the last
// IDR or memory_management_control_operation 5, which is checked), and a
// frame inferred for a gap in frame_num is a copy of the last reference frame
// and is not shown.  Where OpenCV's reader does more than convert the planes
// (a left crop FFmpeg cannot apply exactly, which OpenCV then rescales; a
// colour description swscale colour-manages) the stream is refused.
//
// Refused, naming the tool and FFmpeg: CABAC, B, SP and SI slices, field
// coding (frame_mbs_only_flag 0), the 8x8 transform, scaling matrices,
// chroma formats other than 4:2:0, bit depths above 8, transform bypass,
// slice groups (FMO), arbitrary slice order, redundant pictures, data
// partitioning, weighted prediction and a change of picture size.

#include "h264.h"

#include <algorithm>
#include <array>
#include <cstdarg>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace vd_h264 {
namespace {

[[noreturn]] void fail(const char* fmt, ...) {
  char buf[400];
  va_list ap;
  va_start(ap, fmt);
  std::vsnprintf(buf, sizeof(buf), fmt, ap);
  va_end(ap);
  throw Error{buf};
}

[[noreturn]] void refuse(const char* what) {
  fail("%s, which the port's H.264 decoder does not decode (decoding it needs FFmpeg, which the "
       "port does not link)",
       what);
}

constexpr int kMaxMacroblocks = 139264;  // MaxFS of level 6.2 (Table A-1)
constexpr int kMaxLevel = 1 << 16;       // past any conforming 8-bit coefficient level
constexpr int64_t kMaxCoefficient = 1 << 24;

// a dequantised coefficient, bounded for a damaged stream (a conforming one
// stays within 16 bits)
inline int bounded(int64_t v) {
  return static_cast<int>(v < -kMaxCoefficient ? -kMaxCoefficient
                          : v > kMaxCoefficient ? kMaxCoefficient : v);
}

inline uint8_t clip_pixel(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }
inline int clip3(int lo, int hi, int v) { return v < lo ? lo : v > hi ? hi : v; }

// ------------------------------------------------------------------ tables

// coeff_token (Table 9-5): [table][total_coeff * 4 + trailing_ones], the
// code's length and value; tables for 0 <= nC < 2, 2 <= nC < 4, 4 <= nC < 8
// and 8 <= nC.
const uint8_t kCoeffTokenLen[4][68] = {
    {1,  0,  0,  0,  6,  2,  0,  0,  8,  6,  3,  0,  9,  8,  7,  5,  10, 9,  8,  6,  11, 10, 9,
     7,  13, 11, 10, 8,  13, 13, 11, 9,  13, 13, 13, 10, 14, 14, 13, 11, 14, 14, 14, 13, 15, 15,
     14, 14, 15, 15, 15, 14, 16, 15, 15, 15, 16, 16, 16, 15, 16, 16, 16, 16, 16, 16, 16, 16},
    {2,  0,  0,  0,  6,  2,  0,  0,  6,  5,  3,  0,  7,  6,  6,  4,  8,  6,  6,  4,  8,  7,  7,
     5,  9,  8,  8,  6,  11, 9,  9,  6,  11, 11, 11, 7,  12, 11, 11, 9,  12, 12, 12, 11, 12, 12,
     12, 11, 13, 13, 13, 12, 13, 13, 13, 13, 13, 14, 13, 13, 14, 14, 14, 13, 14, 14, 14, 14},
    {4,  0,  0,  0,  6,  4,  0,  0,  6,  5,  4,  0,  6,  5,  5,  4,  7,  5,  5,  4,  7,  5,  5,
     4,  7,  6,  6,  4,  7,  6,  6,  4,  8,  7,  7,  5,  8,  8,  7,  6,  9,  8,  8,  7,  9,  9,
     8,  8,  9,  9,  9,  8,  10, 9,  9,  9,  10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10},
    {6, 0, 0, 0, 6, 6, 0, 0, 6, 6, 6, 0, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6,
     6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6,
     6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6}};
const uint8_t kCoeffTokenBits[4][68] = {
    {1, 0, 0, 0, 5, 1, 0, 0, 7,  4,  1,  0, 7,  6,  5,  3,  7,  6,  5,  3,  7, 6,  5,
     4, 15, 6, 5, 4, 11, 14, 5,  4,  8,  10, 13, 4,  15, 14, 9,  4,  11, 10, 13, 12, 15, 14,
     9, 12, 11, 10, 13, 8, 15, 1, 9, 12, 11, 14, 13, 8,  7,  10, 9,  12, 4,  6,  5,  8},
    {3,  0,  0,  0,  11, 2,  0,  0, 7, 7, 3,  0,  7,  10, 9,  5,  7,  6, 5,  4,  4, 6, 5,
     6,  7,  6,  5,  8,  15, 6,  5, 4, 11, 14, 13, 4,  15, 10, 9, 4,  11, 14, 13, 12, 8, 10,
     9,  8,  15, 14, 13, 12, 11, 10, 9, 12, 7, 11, 6,  8,  9,  8, 10, 1,  7,  6,  5,  4},
    {15, 0,  0,  0,  15, 14, 0,  0, 11, 15, 13, 0,  8,  12, 14, 12, 15, 10, 11, 11, 11, 8,  9,
     10, 9,  14, 13, 9,  8,  10, 9, 8,  15, 14, 13, 13, 11, 14, 10, 12, 15, 10, 13, 12, 11, 14,
     9,  12, 8,  10, 13, 8,  13, 7, 9,  12, 9,  12, 11, 10, 5,  8,  7,  6,  1,  4,  3,  2},
    {3,  0,  0,  0,  0,  1,  0,  0,  4,  5,  6,  0,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18,
     19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41,
     42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63}};
// coeff_token of chroma DC (nC -1): [total_coeff * 4 + trailing_ones]
const uint8_t kChromaDcTokenLen[20] = {2, 0, 0, 0, 6, 1, 0, 0, 6, 6, 3, 0, 6, 7, 7, 6, 6, 8, 8, 7};
const uint8_t kChromaDcTokenBits[20] = {1, 0, 0, 0, 7, 1, 0, 0, 4, 6, 1, 0, 3, 3, 2, 5, 2, 3, 2, 0};
// total_zeros of 4x4 blocks (Tables 9-7, 9-8): [total_coeff - 1][total_zeros]
const uint8_t kTotalZerosLen[15][16] = {
    {1, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 9}, {3, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 6, 6, 6, 6},
    {4, 3, 3, 3, 4, 4, 3, 3, 4, 5, 5, 6, 5, 6},       {5, 3, 4, 4, 3, 3, 3, 4, 3, 4, 5, 5, 5},
    {4, 4, 4, 3, 3, 3, 3, 3, 4, 5, 4, 5},             {6, 5, 3, 3, 3, 3, 3, 3, 4, 3, 6},
    {6, 5, 3, 3, 3, 2, 3, 4, 3, 6},                   {6, 4, 5, 3, 2, 2, 3, 3, 6},
    {6, 6, 4, 2, 2, 3, 2, 5},                         {5, 5, 3, 2, 2, 2, 4},
    {4, 4, 3, 3, 1, 3},                               {4, 4, 2, 1, 3},
    {3, 3, 1, 2},                                     {2, 2, 1},
    {1, 1}};
const uint8_t kTotalZerosBits[15][16] = {
    {1, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 1}, {7, 6, 5, 4, 3, 5, 4, 3, 2, 3, 2, 3, 2, 1, 0},
    {5, 7, 6, 5, 4, 3, 4, 3, 2, 3, 2, 1, 1, 0},       {3, 7, 5, 4, 6, 5, 4, 3, 3, 2, 2, 1, 0},
    {5, 4, 3, 7, 6, 5, 4, 3, 2, 1, 1, 0},             {1, 1, 7, 6, 5, 4, 3, 2, 1, 1, 0},
    {1, 1, 5, 4, 3, 3, 2, 1, 1, 0},                   {1, 1, 1, 3, 3, 2, 2, 1, 0},
    {1, 0, 1, 3, 2, 1, 1, 1},                         {1, 0, 1, 3, 2, 1, 1},
    {0, 1, 1, 2, 1, 3},                               {0, 1, 1, 1, 1},
    {0, 1, 1, 1},                                     {0, 1, 1},
    {0, 1}};
// total_zeros of chroma DC (Table 9-9a): [total_coeff - 1][total_zeros]
const uint8_t kChromaDcZerosLen[3][4] = {{1, 2, 3, 3}, {1, 2, 2, 0}, {1, 1, 0, 0}};
const uint8_t kChromaDcZerosBits[3][4] = {{1, 1, 1, 0}, {1, 1, 0, 0}, {1, 0, 0, 0}};
// run_before (Table 9-10): [min(zeros_left, 7) - 1][run_before]
const uint8_t kRunLen[7][16] = {{1, 1},          {1, 2, 2},          {2, 2, 2, 2},
                                {2, 2, 2, 3, 3}, {2, 2, 3, 3, 3, 3}, {2, 3, 3, 3, 3, 3, 3},
                                {3, 3, 3, 3, 3, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11}};
const uint8_t kRunBits[7][16] = {{1, 0},          {1, 1, 0},          {3, 2, 1, 0},
                                 {3, 2, 1, 1, 0}, {3, 2, 3, 2, 1, 0}, {3, 0, 1, 3, 2, 5, 4},
                                 {7, 6, 5, 4, 3, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1}};

// coded_block_pattern from its me(v) code number (Table 9-4, 4:2:0)
const uint8_t kIntraCbp[48] = {47, 31, 15, 0,  23, 27, 29, 30, 7,  11, 13, 14, 39, 43, 45, 46,
                               16, 3,  5,  10, 12, 19, 21, 26, 28, 35, 37, 42, 44, 1,  2,  4,
                               8,  17, 18, 20, 24, 6,  9,  22, 25, 32, 33, 34, 36, 40, 38, 41};
const uint8_t kInterCbp[48] = {0,  16, 1,  2,  4,  8,  32, 3,  5,  10, 12, 15, 47, 7,  11, 13,
                               14, 6,  9,  31, 35, 37, 42, 44, 33, 34, 36, 40, 39, 43, 45, 46,
                               17, 18, 20, 24, 19, 21, 26, 28, 23, 27, 29, 30, 22, 25, 38, 41};

// the 4x4 zig-zag scan: raster position (y * 4 + x) of each scan index
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
// normAdjust4x4's three values for each qP % 6 (8-315)
const uint8_t kDequant[6][3] = {{10, 16, 13}, {11, 18, 14}, {13, 20, 16},
                                {14, 23, 18}, {16, 25, 20}, {18, 29, 23}};
// QPc from qPI (Table 8-15)
const uint8_t kChromaQp[52] = {0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12,
                               13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25,
                               26, 27, 28, 29, 29, 30, 31, 32, 32, 33, 34, 34, 35,
                               35, 36, 36, 37, 37, 37, 38, 38, 38, 39, 39, 39, 39};
// the deblocking filter's alpha', beta' (Table 8-16) and tC0' (Table 8-17)
const uint8_t kAlpha[52] = {0,  0,  0,  0,   0,   0,   0,   0,   0,   0,   0,   0,   0,
                            0,  0,  0,  4,   4,   5,   6,   7,   8,   9,   10,  12,  13,
                            15, 17, 20, 22,  25,  28,  32,  36,  40,  45,  50,  56,  63,
                            71, 80, 90, 101, 113, 127, 144, 162, 182, 203, 226, 255, 255};
const uint8_t kBeta[52] = {0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  2,  2,
                           2, 3, 3, 3, 3, 4, 4,  4,  6,  6,  7,  7,  8,  8,  9,  9,  10, 10,
                           11, 11, 12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17, 17, 18, 18};
const uint8_t kTc0[52][3] = {
    {0, 0, 0},   {0, 0, 0},    {0, 0, 0},    {0, 0, 0},    {0, 0, 0},    {0, 0, 0},
    {0, 0, 0},   {0, 0, 0},    {0, 0, 0},    {0, 0, 0},    {0, 0, 0},    {0, 0, 0},
    {0, 0, 0},   {0, 0, 0},    {0, 0, 0},    {0, 0, 0},    {0, 0, 0},    {0, 0, 1},
    {0, 0, 1},   {0, 0, 1},    {0, 0, 1},    {0, 1, 1},    {0, 1, 1},    {1, 1, 1},
    {1, 1, 1},   {1, 1, 1},    {1, 1, 1},    {1, 1, 2},    {1, 1, 2},    {1, 1, 2},
    {1, 1, 2},   {1, 2, 3},    {1, 2, 3},    {2, 2, 3},    {2, 2, 4},    {2, 3, 4},
    {2, 3, 4},   {3, 3, 5},    {3, 4, 6},    {3, 4, 6},    {4, 5, 7},    {4, 5, 8},
    {4, 6, 9},   {5, 7, 10},   {6, 8, 11},   {6, 8, 13},   {7, 10, 14},  {8, 11, 16},
    {9, 12, 18}, {10, 13, 20}, {11, 15, 23}, {13, 17, 25}};

// A prefix code as a lookup on the next `bits` bits: (value << 5) | length,
// 0 where no code matches.
struct Vlc {
  int bits = 0;
  std::vector<uint16_t> table;
  void add(int len, int code, int value) {
    if (!len) return;
    const int shift = bits - len;
    for (int i = 0; i < (1 << shift); ++i)
      table[static_cast<size_t>((code << shift) | i)] = static_cast<uint16_t>((value << 5) | len);
  }
  explicit Vlc(int b) : bits(b), table(static_cast<size_t>(1) << b, 0) {}
};

struct Vlcs {
  std::vector<Vlc> token, zeros, chroma_zeros, run;
  Vlc chroma_token{8};
  Vlcs() {
    for (int t = 0; t < 4; ++t) {
      token.emplace_back(16);
      for (int i = 0; i < 68; ++i) token[t].add(kCoeffTokenLen[t][i], kCoeffTokenBits[t][i], i);
    }
    for (int i = 0; i < 20; ++i) chroma_token.add(kChromaDcTokenLen[i], kChromaDcTokenBits[i], i);
    for (int t = 0; t < 15; ++t) {
      zeros.emplace_back(9);
      for (int i = 0; i < 16; ++i) zeros[t].add(kTotalZerosLen[t][i], kTotalZerosBits[t][i], i);
    }
    for (int t = 0; t < 3; ++t) {
      chroma_zeros.emplace_back(3);
      for (int i = 0; i < 4; ++i)
        chroma_zeros[t].add(kChromaDcZerosLen[t][i], kChromaDcZerosBits[t][i], i);
    }
    for (int t = 0; t < 7; ++t) {
      run.emplace_back(11);
      for (int i = 0; i < 16; ++i) run[t].add(kRunLen[t][i], kRunBits[t][i], i);
    }
  }
};

const Vlcs& vlcs() {
  static const Vlcs v;
  return v;
}

// -------------------------------------------------------------- bit reading

// An RBSP (emulation prevention removed), padded with zero bytes so a read
// past its end sees zeros; `end` is the position of its stop bit.
struct Bits {
  const uint8_t* p = nullptr;
  size_t size = 0;  // bits
  size_t pos = 0;
  size_t end = 0;
  const char* what = "";

  uint32_t peek32() const {
    const size_t b = pos >> 3;
    const uint64_t v = (uint64_t(p[b]) << 32) | (uint64_t(p[b + 1]) << 24) |
                       (uint64_t(p[b + 2]) << 16) | (uint64_t(p[b + 3]) << 8) | p[b + 4];
    return static_cast<uint32_t>(v >> (8 - (pos & 7)));
  }
  void check() const {
    if (pos > size) fail("%s runs past its end", what);
  }
  uint32_t u(int n) {
    if (!n) return 0;
    if (pos + n > size) fail("%s runs past its end", what);
    uint32_t v;
    if (n <= 25) {
      v = peek32() >> (32 - n);
    } else {
      v = (peek32() >> 16) << (n - 16);
      pos += 16;
      v |= peek32() >> (48 - n);
      pos -= 16;
    }
    pos += n;
    return v;
  }
  bool flag() { return u(1) != 0; }
  uint32_t ue() {
    const uint32_t v = peek32();
    if (!v) {
      if (pos + 32 > size) fail("%s runs past its end", what);
      fail("%s has an Exp-Golomb code longer than 32 bits", what);
    }
    const int lz = __builtin_clz(v);
    if (lz <= 15) {
      const int len = 2 * lz + 1;
      if (pos + len > size) fail("%s runs past its end", what);
      pos += len;
      return (v >> (32 - len)) - 1;
    }
    pos += lz;
    const uint64_t x = u(lz + 1);
    if (x - 1 > 0xFFFFFFFEull) fail("%s has an Exp-Golomb value out of range", what);
    return static_cast<uint32_t>(x - 1);
  }
  int se() {
    const uint32_t k = ue();
    return k & 1 ? static_cast<int>((k + 1) >> 1) : -static_cast<int>(k >> 1);
  }
  // ue(v) within [0, hi]
  int ue_max(uint32_t hi, const char* name) {
    const uint32_t v = ue();
    if (v > hi) fail("%s: %s %u is out of range (0..%u)", what, name, v, hi);
    return static_cast<int>(v);
  }
  int se_range(int lo, int hi, const char* name) {
    const int v = se();
    if (v < lo || v > hi) fail("%s: %s %d is out of range (%d..%d)", what, name, v, lo, hi);
    return v;
  }
  bool more_data() const { return pos < end; }
  int vlc(const Vlc& t, const char* name) {
    const uint32_t look = peek32() >> (32 - t.bits);
    const uint16_t e = t.table[look];
    if (!e) fail("%s: no %s matches the next bits", what, name);
    pos += e & 31;
    check();
    return e >> 5;
  }
};

struct Rbsp {
  std::vector<uint8_t> data;
  size_t length = 0;  // the bytes before the padding
  void load(const uint8_t* nal, size_t n) {
    data.clear();
    data.reserve(n + 8);
    int zeros = 0;
    for (size_t i = 0; i < n; ++i) {
      const uint8_t c = nal[i];
      if (zeros >= 2 && c == 3) {
        zeros = 0;
        continue;
      }
      zeros = c ? 0 : zeros + 1;
      data.push_back(c);
    }
    length = data.size();
  }
  Bits bits(size_t from_byte, const char* what) const {
    Bits b;
    b.p = data.data();
    b.size = length * 8;
    b.pos = from_byte * 8;
    b.what = what;
    size_t last = length;
    while (last > 0 && !data[last - 1]) --last;
    b.end = last ? (last - 1) * 8 + 7 - static_cast<size_t>(__builtin_ctz(data[last - 1])) : 0;
    return b;
  }
  void pad() { data.insert(data.end(), 8, 0); }  // so that a read may look past the end
};

// ------------------------------------------------------- parameter sets

struct Sps {
  bool valid = false;
  int id = 0, profile = 0;
  int log2_max_frame_num = 4, poc_type = 0, log2_max_poc_lsb = 4;
  bool delta_pic_order_always_zero = false;
  int offset_for_non_ref_pic = 0, offset_for_top_to_bottom_field = 0;
  std::vector<int> offset_for_ref_frame;
  int max_num_ref_frames = 0;
  bool gaps = false;
  int mb_w = 0, mb_h = 0;
  bool crop = false;
  int crop_left = 0, crop_right = 0, crop_top = 0, crop_bottom = 0;  // luma samples
  bool colour = false, full_range = false;
  int primaries = 2, transfer = 2, matrix = 2;
  bool timing = false, restriction = false;
  uint32_t num_units_in_tick = 0, time_scale = 0;
};

struct Pps {
  bool valid = false;
  int id = 0, sps_id = 0;
  bool bottom_field_pic_order = false;
  int num_ref_idx_default = 1;
  int init_qp = 26;
  int cb_offset = 0, cr_offset = 0;
  bool deblocking_control = false, constrained_intra = false;
};

void hrd_parameters(Bits& b) {
  const int count = b.ue_max(31, "cpb_cnt_minus1") + 1;
  b.u(8);
  for (int i = 0; i < count; ++i) {
    b.ue();
    b.ue();
    b.u(1);
  }
  b.u(20);
}

void parse_sps(Bits& b, Sps& s, uint64_t& feats) {
  s.profile = static_cast<int>(b.u(8));
  b.u(16);  // constraint flags, level_idc
  s.id = b.ue_max(31, "seq_parameter_set_id");
  static const int kHigh[] = {100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139, 134, 135};
  if (std::find(std::begin(kHigh), std::end(kHigh), s.profile) != std::end(kHigh)) {
    feats |= kHighProfile;
    const int chroma = b.ue_max(3, "chroma_format_idc");
    if (chroma != 1) {
      char what[80];
      std::snprintf(what, sizeof(what), "H.264 chroma format %s",
                    chroma == 0 ? "4:0:0 (monochrome)" : chroma == 2 ? "4:2:2" : "4:4:4");
      refuse(what);
    }
    const int luma_depth = b.ue_max(6, "bit_depth_luma_minus8") + 8;
    const int chroma_depth = b.ue_max(6, "bit_depth_chroma_minus8") + 8;
    if (luma_depth != 8 || chroma_depth != 8) {
      char what[80];
      std::snprintf(what, sizeof(what), "H.264 at a bit depth of %d (chroma %d), above 8",
                    luma_depth, chroma_depth);
      refuse(what);
    }
    if (b.flag()) refuse("H.264 transform bypass (qpprime_y_zero_transform_bypass_flag)");
    if (b.flag()) refuse("H.264 scaling matrices (seq_scaling_matrix_present_flag)");
  }
  s.log2_max_frame_num = b.ue_max(12, "log2_max_frame_num_minus4") + 4;
  s.poc_type = b.ue_max(2, "pic_order_cnt_type");
  s.offset_for_ref_frame.clear();
  if (s.poc_type == 0) {
    s.log2_max_poc_lsb = b.ue_max(12, "log2_max_pic_order_cnt_lsb_minus4") + 4;
  } else if (s.poc_type == 1) {
    s.delta_pic_order_always_zero = b.flag();
    s.offset_for_non_ref_pic = b.se();
    s.offset_for_top_to_bottom_field = b.se();
    const int cycle = b.ue_max(255, "num_ref_frames_in_pic_order_cnt_cycle");
    for (int i = 0; i < cycle; ++i) s.offset_for_ref_frame.push_back(b.se());
  }
  s.max_num_ref_frames = b.ue_max(16, "max_num_ref_frames");
  s.gaps = b.flag();
  s.mb_w = b.ue_max(1023, "pic_width_in_mbs_minus1") + 1;
  s.mb_h = b.ue_max(1023, "pic_height_in_map_units_minus1") + 1;
  if (!b.flag()) refuse("interlaced H.264 (frame_mbs_only_flag 0: field pictures or MBAFF)");
  b.u(1);  // direct_8x8_inference_flag
  s.crop = b.flag();
  s.crop_left = s.crop_right = s.crop_top = s.crop_bottom = 0;
  if (s.crop) {
    const uint32_t l = b.ue(), r = b.ue(), t = b.ue(), bo = b.ue();
    // as FFmpeg: crop values past the picture are ignored
    if (uint64_t(l) + r < uint64_t(s.mb_w) * 8 && uint64_t(t) + bo < uint64_t(s.mb_h) * 8) {
      s.crop_left = static_cast<int>(2 * l);
      s.crop_right = static_cast<int>(2 * r);
      s.crop_top = static_cast<int>(2 * t);
      s.crop_bottom = static_cast<int>(2 * bo);
    } else {
      s.crop = false;
    }
  }
  s.colour = s.full_range = s.timing = s.restriction = false;
  s.matrix = 2;
  s.num_units_in_tick = s.time_scale = 0;
  if (b.flag()) {  // vui_parameters_present_flag
    if (b.flag() && b.u(8) == 255) b.u(32);  // aspect ratio, extended SAR
    if (b.flag()) b.u(1);                    // overscan
    if (b.flag()) {                          // video_signal_type_present_flag
      b.u(3);
      s.full_range = b.flag();
      if (b.flag()) {
        s.colour = true;
        s.primaries = static_cast<int>(b.u(8));
        s.transfer = static_cast<int>(b.u(8));
        s.matrix = static_cast<int>(b.u(8));
      }
    }
    if (b.flag()) {  // chroma_loc_info_present_flag
      b.ue();
      b.ue();
    }
    s.timing = b.flag();
    if (s.timing) {
      s.num_units_in_tick = b.u(32);
      s.time_scale = b.u(32);
      b.u(1);
    }
    const bool nal_hrd = b.flag();
    if (nal_hrd) hrd_parameters(b);
    const bool vcl_hrd = b.flag();
    if (vcl_hrd) hrd_parameters(b);
    if (nal_hrd || vcl_hrd) b.u(1);
    b.u(1);  // pic_struct_present_flag
    s.restriction = b.flag();
    if (s.restriction) {
      b.u(1);
      for (int i = 0; i < 6; ++i) b.ue();
    }
  }
  s.valid = true;
}

void parse_pps(Bits& b, Pps& p) {
  p.id = b.ue_max(255, "pic_parameter_set_id");
  p.sps_id = b.ue_max(31, "seq_parameter_set_id");
  if (b.flag()) refuse("H.264 CABAC (entropy_coding_mode_flag 1)");
  p.bottom_field_pic_order = b.flag();
  if (b.ue_max(7, "num_slice_groups_minus1"))
    refuse("H.264 slice groups (FMO, num_slice_groups_minus1 above 0)");
  p.num_ref_idx_default = b.ue_max(31, "num_ref_idx_l0_default_active_minus1") + 1;
  b.ue_max(31, "num_ref_idx_l1_default_active_minus1");
  if (b.flag()) refuse("H.264 weighted prediction (weighted_pred_flag 1)");
  b.u(2);  // weighted_bipred_idc: B slices only, which are refused
  p.init_qp = 26 + b.se_range(-26, 25, "pic_init_qp_minus26");
  b.se_range(-26, 25, "pic_init_qs_minus26");
  p.cb_offset = b.se_range(-12, 12, "chroma_qp_index_offset");
  p.deblocking_control = b.flag();
  p.constrained_intra = b.flag();
  if (b.flag()) refuse("H.264 redundant pictures (redundant_pic_cnt_present_flag 1)");
  p.cr_offset = p.cb_offset;
  if (b.more_data()) {
    if (b.flag()) refuse("the H.264 8x8 transform (transform_8x8_mode_flag 1)");
    if (b.flag()) refuse("H.264 scaling matrices (pic_scaling_matrix_present_flag)");
    p.cr_offset = b.se_range(-12, 12, "second_chroma_qp_index_offset");
  }
  p.valid = true;
}

// ------------------------------------------------------------ slice header

struct Mmco {
  int op = 0, a = 0, b = 0;
};

struct SliceHeader {
  int nal_ref_idc = 0;
  bool idr = false;
  int first_mb = 0, type = 0;  // 0 P, 2 I
  int pps_id = 0, frame_num = 0;
  int poc_lsb = 0, delta_poc_bottom = 0, delta_poc[2] = {0, 0};
  int num_ref_idx = 1;
  std::vector<std::pair<int, int>> mods;  // (modification_of_pic_nums_idc, value)
  bool long_term_reference = false, adaptive = false;
  std::vector<Mmco> mmco;
  int qp = 26;
  int deblock = 0, alpha = 0, beta = 0;  // disable_deblocking_filter_idc, offsets (x2)
};

// ----------------------------------------------------------------- pictures

struct Picture {
  std::vector<uint8_t> px[3];
  int frame_num = 0, frame_num_wrap = 0, long_idx = -1;
  int64_t poc = 0;
  bool short_ref = false, long_ref = false;
  int id = 0;
};
using Pic = std::shared_ptr<Picture>;

enum MbKind : uint8_t { kNone = 0, kI4, kI16, kIPcm, kInter, kPSkip };

inline bool is_intra(uint8_t k) { return k == kI4 || k == kI16 || k == kIPcm; }

struct SliceParams {
  int deblock = 0, alpha = 0, beta = 0;
};

}  // namespace

struct Decoder::Impl {
  int length_size = 0;  // 0: Annex B
  Sps sps[32];
  Pps pps[256];
  Rbsp rbsp;
  uint64_t feats = 0;
  bool probing = false;

  // the stream's geometry, fixed by the first SPS activated
  int mb_w = 0, mb_h = 0, coded_w = 0, coded_h = 0;
  int out_w = 0, out_h = 0, out_x = 0, out_y = 0;
  int matrix = 2;
  bool full_range = false;
  uint32_t tick = 0, scale = 0;

  // reference pictures and order
  std::vector<Pic> refs;
  int max_long_idx = -1;  // MaxLongTermFrameIdx; -1: "no long-term frame indices"
  int prev_frame_num = 0, prev_poc_lsb = 0;
  int64_t prev_frame_num_offset = 0, prev_poc_msb = 0, frame_num_offset = 0, poc_msb = 0;
  bool started = false;    // an IDR has been seen
  bool new_period = true;  // the next picture starts an output period
  int64_t last_poc = 0;
  std::vector<Pic> pool;
  int next_id = 1;
  Pic shown;

  // the picture being decoded
  bool in_picture = false;
  SliceHeader head;  // its first slice's header
  const Sps* cur_sps = nullptr;
  const Pps* cur_pps = nullptr;
  Pic cur;
  int64_t poc = 0;
  bool mmco5 = false;
  int slice_num = 0, decoded = 0, last_mb = -1;
  std::vector<SliceParams> slice_params;
  // per macroblock
  std::vector<uint8_t> mb_kind;
  std::vector<int16_t> mb_slice;
  std::vector<int8_t> mb_qp;
  // per 4x4 block: luma total_coeff, intra 4x4 modes, motion
  int w4 = 0;
  std::vector<uint8_t> nz, nz_cb, nz_cr;  // chroma grids are 2 blocks a macroblock wide
  std::vector<int8_t> modes;
  std::vector<int8_t> ref_idx;
  std::vector<int> ref_pic;  // picture id for the deblocking filter, -1 intra
  std::vector<std::array<int16_t, 2>> mv;
  // the slice being decoded
  std::vector<Pic> list;
  int qp = 26;
  int cur_slice_num = 0;
  uint16_t done = 0;  // 4x4 blocks of the current macroblock whose motion is known

  explicit Impl(const uint8_t* config, size_t size) {
    if (!size) {
      feats |= kAnnexB;
      return;
    }
    if (config[0] == 0) {  // parameter sets with start codes (an AVI's extradata)
      feats |= kAnnexB;
      sample(config, size);
      return;
    }
    // AVCDecoderConfigurationRecord
    if (size < 7 || config[0] != 1) fail("the avcC decoder configuration is malformed");
    length_size = (config[4] & 3) + 1;
    if (length_size == 3) fail("the avcC's NAL length size is 3 bytes");
    feats |= kLengthPrefix;
    size_t at = 5;
    for (int kind = 0; kind < 2; ++kind) {
      if (at >= size) fail("the avcC decoder configuration is truncated");
      const int n = kind ? config[at] : config[at] & 31;
      ++at;
      for (int i = 0; i < n; ++i) {
        if (at + 2 > size) fail("the avcC decoder configuration is truncated");
        const size_t len = (size_t(config[at]) << 8) | config[at + 1];
        at += 2;
        if (at + len > size || !len) fail("the avcC decoder configuration is truncated");
        nal(config + at, len);
        at += len;
      }
    }
  }

  // ------------------------------------------------------------ NAL units

  void sample(const uint8_t* data, size_t size) {
    if (length_size) {
      size_t at = 0;
      while (at < size) {
        if (at + length_size > size) fail("a NAL unit length runs past the sample's end");
        size_t len = 0;
        for (int i = 0; i < length_size; ++i) len = (len << 8) | data[at + i];
        at += length_size;
        if (len > size - at) fail("a NAL unit of %zu bytes runs past the sample's end", len);
        if (len) nal(data + at, len);
        at += len;
      }
      return;
    }
    size_t i = 0, start = SIZE_MAX;
    while (i + 3 <= size) {
      if (data[i] == 0 && data[i + 1] == 0 && data[i + 2] == 1) {
        if (start != SIZE_MAX) unit(data + start, i - start);
        i += 3;
        start = i;
      } else {
        ++i;
      }
    }
    if (start == SIZE_MAX) fail("the sample holds no start code");
    unit(data + start, size - start);
  }

  void unit(const uint8_t* p, size_t n) {
    while (n && !p[n - 1]) --n;  // trailing zero bytes, and the next start code's leading zero
    if (n) nal(p, n);
  }

  void nal(const uint8_t* p, size_t n) {
    if (p[0] & 0x80) fail("a NAL unit has forbidden_zero_bit set");
    const int ref_idc = (p[0] >> 5) & 3, type = p[0] & 31;
    switch (type) {
      case 1:
      case 5:
        slice(p, n, ref_idc, type == 5);
        return;
      case 2:
      case 3:
      case 4:
        refuse("H.264 data partitioning (NAL unit types 2-4)");
      case 6:
        feats |= kSei;
        return;
      case 7:
        parameter_set(p, n, true);
        return;
      case 8:
        parameter_set(p, n, false);
        return;
      case 9:
        feats |= kAud;
        return;
      case 12:
        feats |= kFiller;
        return;
      default:  // end of sequence / stream, SPS extension, SVC and MVC units, reserved
        feats |= kOtherNal;
        return;
    }
  }

  void parameter_set(const uint8_t* p, size_t n, bool is_sps) {
    rbsp.load(p + 1, n - 1);
    rbsp.pad();
    Bits b = rbsp.bits(0, is_sps ? "a sequence parameter set" : "a picture parameter set");
    if (is_sps) {
      Sps s;
      parse_sps(b, s, feats);
      Sps& slot = sps[s.id];
      if (slot.valid || s.id) feats |= kParameterSetIds;
      if (s.timing) feats |= kTimingInfo;
      if (s.restriction) feats |= kBitstreamRestriction;
      slot = s;
    } else {
      Pps q;
      parse_pps(b, q);
      Pps& slot = pps[q.id];
      if (slot.valid || q.id) feats |= kParameterSetIds;
      slot = q;
    }
  }

  // ----------------------------------------------------------- slice header

  SliceHeader parse_header(Bits& b, int ref_idc, bool idr) {
    SliceHeader h;
    h.nal_ref_idc = ref_idc;
    h.idr = idr;
    h.first_mb = b.ue_max(kMaxMacroblocks, "first_mb_in_slice");
    const int type = b.ue_max(9, "slice_type") % 5;
    if (type == 1) refuse("H.264 B slices");
    if (type == 3) refuse("H.264 SP slices");
    if (type == 4) refuse("H.264 SI slices");
    h.type = type;
    h.pps_id = b.ue_max(255, "pic_parameter_set_id");
    const Pps& p = pps[h.pps_id];
    if (!p.valid) fail("a slice refers to picture parameter set %d, which was not sent", h.pps_id);
    const Sps& s = sps[p.sps_id];
    if (!s.valid) fail("picture parameter set %d refers to sequence parameter set %d, which was "
                       "not sent", p.id, p.sps_id);
    if (idr && type != 2) fail("an IDR picture holds a P slice");
    h.frame_num = static_cast<int>(b.u(s.log2_max_frame_num));
    if (idr) b.ue_max(65535, "idr_pic_id");
    if (s.poc_type == 0) {
      h.poc_lsb = static_cast<int>(b.u(s.log2_max_poc_lsb));
      if (p.bottom_field_pic_order) h.delta_poc_bottom = b.se();
    } else if (s.poc_type == 1 && !s.delta_pic_order_always_zero) {
      h.delta_poc[0] = b.se();
      if (p.bottom_field_pic_order) h.delta_poc[1] = b.se();
    }
    h.num_ref_idx = p.num_ref_idx_default;
    if (type == 0) {
      if (b.flag()) h.num_ref_idx = b.ue_max(15, "num_ref_idx_l0_active_minus1") + 1;
      if (h.num_ref_idx > 16) fail("num_ref_idx_l0_active_minus1 %d is above 15", h.num_ref_idx - 1);
      if (b.flag()) {  // ref_pic_list_modification_flag_l0
        for (;;) {
          const int idc = b.ue_max(3, "modification_of_pic_nums_idc");
          if (idc == 3) break;
          if (h.mods.size() > 32) fail("a reference list modification has too many entries");
          h.mods.emplace_back(idc, b.ue_max(1 << 17, "a reference list modification's value"));
        }
      }
    }
    if (ref_idc) {
      if (idr) {
        b.u(1);  // no_output_of_prior_pics_flag: pictures leave in decode order
        h.long_term_reference = b.flag();
      } else if ((h.adaptive = b.flag())) {
        for (;;) {
          Mmco m;
          m.op = b.ue_max(6, "memory_management_control_operation");
          if (!m.op) break;
          if (h.mmco.size() > 66) fail("a slice has too many memory management operations");
          if (m.op == 1 || m.op == 3) m.a = b.ue_max(1 << 17, "difference_of_pic_nums_minus1");
          if (m.op == 2) m.a = b.ue_max(1 << 17, "long_term_pic_num");
          if (m.op == 3 || m.op == 6) m.b = b.ue_max(15, "long_term_frame_idx");
          if (m.op == 4) m.a = b.ue_max(16, "max_long_term_frame_idx_plus1");
          h.mmco.push_back(m);
        }
      }
    }
    h.qp = p.init_qp + b.se();
    if (h.qp < 0 || h.qp > 51) fail("the slice QP %d is out of range", h.qp);
    if (p.deblocking_control) {
      h.deblock = b.ue_max(2, "disable_deblocking_filter_idc");
      if (h.deblock != 1) {
        h.alpha = 2 * b.se_range(-6, 6, "slice_alpha_c0_offset_div2");
        h.beta = 2 * b.se_range(-6, 6, "slice_beta_offset_div2");
      }
    }
    return h;
  }

  void slice(const uint8_t* p, size_t n, int ref_idc, bool idr) {
    rbsp.load(p + 1, n - 1);
    rbsp.pad();
    Bits b = rbsp.bits(0, "a slice");
    SliceHeader h = parse_header(b, ref_idc, idr);
    if (in_picture) {
      if (h.first_mb <= last_mb || h.first_mb == 0)
        fail(h.first_mb == 0 ? "a sample holds the slices of two pictures"
                             : "slices out of order (arbitrary slice order, or a slice sent "
                               "twice), which the port's H.264 decoder does not decode");
      if (h.pps_id != head.pps_id || h.frame_num != head.frame_num || h.idr != head.idr ||
          h.poc_lsb != head.poc_lsb || (h.nal_ref_idc != 0) != (head.nal_ref_idc != 0))
        fail("a slice's header does not match its picture's first slice");
    } else {
      start_picture(h);
    }
    if (h.type == 0) feats |= kPSlice;
    if (h.deblock == 1) feats |= kDeblockOff;
    if (h.deblock == 2) feats |= kDeblockSliceEdges;
    if (h.alpha || h.beta) feats |= kDeblockOffsets;
    if (probing) {
      last_mb = h.first_mb;
      return;
    }
    decode_slice(b, h);
  }

  // ------------------------------------------------------ pictures, order

  void activate(const SliceHeader& h) {
    cur_pps = &pps[h.pps_id];
    cur_sps = &sps[cur_pps->sps_id];
    const Sps& s = *cur_sps;
    if (s.mb_w * s.mb_h > kMaxMacroblocks)
      fail("a picture of %dx%d macroblocks exceeds the largest an H.264 level allows (%d, level "
           "6.2)", s.mb_w, s.mb_h, kMaxMacroblocks);
    if (!mb_w) {
      mb_w = s.mb_w;
      mb_h = s.mb_h;
      coded_w = 16 * mb_w;
      coded_h = 16 * mb_h;
      w4 = 4 * mb_w;
    } else if (s.mb_w != mb_w || s.mb_h != mb_h) {
      char what[160];
      std::snprintf(what, sizeof(what), "a change of H.264 picture size from %dx%d to %dx%d "
                    "macroblocks mid stream", mb_w, mb_h, s.mb_w, s.mb_h);
      refuse(what);
    }
    if (s.crop_left % 64)
      fail("a left crop of %d luma samples: FFmpeg crops the left edge only in steps of 64 "
           "(av_frame_apply_cropping keeps its planes aligned) and OpenCV's reader then scales "
           "the wider picture to the stream's width, which the port does not reproduce", s.crop_left);
    // colour descriptions whose RGB OpenCV's FFmpeg (swscale) converts with a
    // gamut, tone or matrix step of its own, or not at all
    const bool primaries_ok = s.primaries <= 7 && s.primaries != 3;
    const bool transfer_ok = s.transfer != 9 && s.transfer != 10 && s.transfer != 16 && s.transfer != 18;
    const bool matrix_ok = s.matrix <= 9 && s.matrix != 8;
    if (s.colour && !(primaries_ok && transfer_ok && matrix_ok))
      fail("an H.264 VUI colour description (primaries %d, transfer %d, matrix %d) that OpenCV's "
           "FFmpeg (swscale) converts to RGB with a gamut, tone or matrix step the port does not "
           "reproduce", s.primaries, s.transfer, s.matrix);
    out_w = coded_w - s.crop_left - s.crop_right;
    out_h = coded_h - s.crop_top - s.crop_bottom;
    out_x = s.crop_left;
    out_y = s.crop_top;
    if (s.crop) feats |= kCropping;
    matrix = s.colour ? s.matrix : 2;
    full_range = s.full_range;
    if (s.colour) feats |= kColourDescription;
    if (s.full_range) feats |= kFullRange;
    tick = s.timing ? s.num_units_in_tick : 0;
    scale = s.timing ? s.time_scale : 0;
    if (cur_pps->constrained_intra) feats |= kConstrainedIntra;
    if (cur_pps->cb_offset) feats |= kChromaQpOffset;
    if (cur_pps->cr_offset != cur_pps->cb_offset) feats |= kSecondChromaQpOffset;
    feats |= s.poc_type == 0 ? kPocType0 : s.poc_type == 1 ? kPocType1 : kPocType2;
  }

  Pic new_picture() {
    Pic p;
    for (auto& q : pool)
      if (q.use_count() == 1) {
        p = q;
        break;
      }
    if (!p) {
      p = std::make_shared<Picture>();
      p->px[0].resize(static_cast<size_t>(coded_w) * coded_h);
      p->px[1].resize(static_cast<size_t>(coded_w / 2) * (coded_h / 2));
      p->px[2].resize(static_cast<size_t>(coded_w / 2) * (coded_h / 2));
      pool.push_back(p);
    }
    p->short_ref = p->long_ref = false;
    p->long_idx = -1;
    p->id = next_id++;
    return p;
  }

  int max_frame_num() const { return 1 << cur_sps->log2_max_frame_num; }

  // FFmpeg's POC state (ff_h264_init_poc): an IDR starts it anew; it moves
  // on after each picture (the order counts after each reference picture).
  int64_t picture_order(const SliceHeader& h) {
    const Sps& s = *cur_sps;
    const int max_fn = max_frame_num();
    frame_num_offset = prev_frame_num_offset;
    if (h.frame_num < prev_frame_num) frame_num_offset += max_fn;
    if (s.poc_type == 0) {
      const int max_lsb = 1 << s.log2_max_poc_lsb;
      if (h.poc_lsb < prev_poc_lsb && prev_poc_lsb - h.poc_lsb >= max_lsb / 2)
        poc_msb = prev_poc_msb + max_lsb;
      else if (h.poc_lsb > prev_poc_lsb && h.poc_lsb - prev_poc_lsb > max_lsb / 2)
        poc_msb = prev_poc_msb - max_lsb;
      else
        poc_msb = prev_poc_msb;
      const int64_t top = poc_msb + h.poc_lsb;
      return std::min(top, top + h.delta_poc_bottom);
    }
    if (s.poc_type == 1) {
      const int cycle = static_cast<int>(s.offset_for_ref_frame.size());
      int64_t abs_frame_num = cycle ? frame_num_offset + h.frame_num : 0;
      if (!h.nal_ref_idc && abs_frame_num > 0) --abs_frame_num;
      __int128 expected = 0;  // wide: a forged stream's offsets may not fit 64 bits
      if (abs_frame_num > 0) {
        int64_t per_cycle = 0;
        for (int v : s.offset_for_ref_frame) per_cycle += v;
        const int64_t cycles = (abs_frame_num - 1) / cycle, in_cycle = (abs_frame_num - 1) % cycle;
        expected = static_cast<__int128>(cycles) * per_cycle;
        for (int i = 0; i <= in_cycle; ++i) expected += s.offset_for_ref_frame[i];
      }
      const __int128 bound = int64_t(1) << 60;
      expected = expected < -bound ? -bound : expected > bound ? bound : expected;
      if (!h.nal_ref_idc) expected += s.offset_for_non_ref_pic;
      const int64_t top = static_cast<int64_t>(expected) + h.delta_poc[0];
      const int64_t bottom = top + s.offset_for_top_to_bottom_field + h.delta_poc[1];
      return std::min(top, bottom);
    }
    const int64_t v = 2 * (frame_num_offset + h.frame_num);
    return h.nal_ref_idc ? v : v - 1;
  }

  void start_picture(const SliceHeader& h) {
    activate(h);
    const int max_fn = max_frame_num();
    if (h.idr) {
      feats |= kIdr;
      for (auto& r : refs) r->short_ref = r->long_ref = false;
      refs.clear();
      max_long_idx = -1;
      prev_frame_num = prev_frame_num_offset = 0;
      prev_poc_msb = prev_poc_lsb = 0;
      new_period = started = true;
    } else {
      if (!started) fail("the stream does not start with an IDR picture");
      if (h.type == 2) feats |= kNonIdrIntra;
      if (h.frame_num != prev_frame_num && h.frame_num != (prev_frame_num + 1) % max_fn) {
        if (!cur_sps->gaps)
          fail("frame_num jumps from %d to %d: a reference picture is missing", prev_frame_num,
               h.frame_num);
        feats |= kFrameNumGap;
        fill_gap(h.frame_num);
      }
      if (h.frame_num < prev_frame_num) feats |= kFrameNumWrap;
    }
    if (!h.nal_ref_idc) feats |= kNonRef;
    poc = picture_order(h);
    if (new_period) {
      new_period = false;
    } else if (poc < last_poc) {
      fail("picture order count %lld follows %lld: the pictures are not shown in decode order "
           "(B-frame style reordering), which the port's H.264 decoder does not follow "
           "(decoding it needs FFmpeg, which the port does not link)", static_cast<long long>(poc),
           static_cast<long long>(last_poc));
    }
    last_poc = poc;
    head = h;
    in_picture = true;
    mmco5 = false;
    for (const Mmco& m : h.mmco) mmco5 |= m.op == 5;
    last_mb = -1;
    slice_num = decoded = 0;
    if (probing) return;
    cur = new_picture();
    cur->frame_num = h.frame_num;
    cur->poc = poc;
    const size_t mbs = static_cast<size_t>(mb_w) * mb_h;
    mb_kind.assign(mbs, kNone);
    mb_slice.assign(mbs, -1);
    mb_qp.assign(mbs, 0);
    nz.assign(mbs * 16, 0);
    nz_cb.assign(mbs * 4, 0);
    nz_cr.assign(mbs * 4, 0);
    modes.assign(mbs * 16, 2);
    ref_idx.assign(mbs * 16, -1);
    ref_pic.assign(mbs * 16, -1);
    mv.assign(mbs * 16, {0, 0});
    slice_params.clear();
  }

  // Frames inferred for a gap in frame_num: each a copy of the last
  // reference frame, marked by the sliding window, never shown (FFmpeg).
  void fill_gap(int frame_num) {
    const int max_fn = max_frame_num();
    int count = (frame_num - prev_frame_num - 1 + max_fn) % max_fn;
    if (probing) {
      prev_frame_num = (frame_num - 1 + max_fn) % max_fn;
      return;
    }
    Pic last;  // every inferred frame is a copy of it (FFmpeg copies the newest short-term one)
    for (auto& r : refs)
      if (r->short_ref && (!last || r->id > last->id)) last = r;
    const int keep = std::max(cur_sps->max_num_ref_frames, 1) + 1;
    if (count > keep) {  // the sliding window would drop every short-term frame anyway
      for (auto& r : std::vector<Pic>(refs))
        if (r->short_ref) drop(r);
      prev_frame_num = (prev_frame_num + count - keep) % max_fn;
      count = keep;
    }
    for (int i = 0; i < count; ++i) {
      prev_frame_num = (prev_frame_num + 1) % max_fn;
      Pic p = new_picture();
      p->frame_num = prev_frame_num;
      if (last)
        for (int c = 0; c < 3; ++c) p->px[c] = last->px[c];
      else
        for (int c = 0; c < 3; ++c) std::fill(p->px[c].begin(), p->px[c].end(), 128);
      sliding_window(prev_frame_num);
      p->short_ref = true;
      refs.push_back(p);
    }
  }

  void finish_picture() {
    in_picture = false;
    if (!probing) {
      const int total = mb_w * mb_h;
      if (decoded != total)
        fail("the picture's slices cover %d of its %d macroblocks", decoded, total);
      deblock();
      if (head.nal_ref_idc) mark();
      shown = cur;
      cur.reset();
    }
    if (head.nal_ref_idc) {
      prev_poc_msb = poc_msb;
      prev_poc_lsb = head.poc_lsb;
    }
    prev_frame_num_offset = frame_num_offset;
    prev_frame_num = mmco5 ? 0 : head.frame_num;
    if (mmco5) new_period = true;
  }

  // ------------------------------------------------------ reference marking

  int frame_num_wrap(const Picture& p, int frame_num) const {
    return p.frame_num > frame_num ? p.frame_num - max_frame_num() : p.frame_num;
  }

  void drop(const Pic& p) {
    p->short_ref = p->long_ref = false;
    refs.erase(std::remove(refs.begin(), refs.end(), p), refs.end());
  }

  void sliding_window(int frame_num) {
    int shorts = 0;
    for (auto& r : refs) shorts += r->short_ref;
    if (shorts && static_cast<int>(refs.size()) >= std::max(cur_sps->max_num_ref_frames, 1)) {
      Pic oldest;
      for (auto& r : refs)
        if (r->short_ref &&
            (!oldest || frame_num_wrap(*r, frame_num) < frame_num_wrap(*oldest, frame_num)))
          oldest = r;
      drop(oldest);
    }
  }

  Pic short_by_pic_num(int pic_num) {
    for (auto& r : refs)
      if (r->short_ref && frame_num_wrap(*r, head.frame_num) == pic_num) return r;
    return nullptr;
  }

  Pic long_by_idx(int idx) {
    for (auto& r : refs)
      if (r->long_ref && r->long_idx == idx) return r;
    return nullptr;
  }

  void mark() {
    const int fn = head.frame_num;
    if (head.idr) {
      if (head.long_term_reference) {
        cur->long_ref = true;
        cur->long_idx = 0;
        max_long_idx = 0;
        feats |= kLongTerm;
      } else {
        cur->short_ref = true;
        max_long_idx = -1;
      }
      refs.push_back(cur);
      return;
    }
    bool current_long = false;
    if (!head.adaptive) {
      sliding_window(fn);
    } else {
      for (const Mmco& m : head.mmco) {
        feats |= kMmco1 << (m.op - 1);
        if (m.op == 1 || m.op == 3) {
          const Pic p = short_by_pic_num(fn - (m.a + 1));
          if (!p) fail("memory management operation %d names picture number %d, which is not a "
                       "short-term reference", m.op, fn - (m.a + 1));
          if (m.op == 1) {
            drop(p);
          } else {
            if (m.b > max_long_idx) fail("long_term_frame_idx %d is above the maximum", m.b);
            if (Pic q = long_by_idx(m.b)) drop(q);
            p->short_ref = false;
            p->long_ref = true;
            p->long_idx = m.b;
            feats |= kLongTerm;
          }
        } else if (m.op == 2) {
          const Pic p = long_by_idx(m.a);
          if (!p) fail("memory management operation 2 names long-term picture %d, which is not "
                       "a reference", m.a);
          drop(p);
        } else if (m.op == 4) {
          max_long_idx = m.a - 1;
          for (auto& r : std::vector<Pic>(refs))
            if (r->long_ref && r->long_idx > max_long_idx) drop(r);
        } else if (m.op == 5) {
          for (auto& r : refs) r->short_ref = r->long_ref = false;
          refs.clear();
          max_long_idx = -1;
          cur->frame_num = 0;
        } else if (m.op == 6) {
          if (m.b > max_long_idx) fail("long_term_frame_idx %d is above the maximum", m.b);
          if (Pic q = long_by_idx(m.b)) drop(q);
          cur->long_ref = true;
          cur->long_idx = m.b;
          current_long = true;
          feats |= kLongTerm;
        }
      }
    }
    if (!current_long) cur->short_ref = true;
    refs.push_back(cur);
    if (static_cast<int>(refs.size()) > std::max(cur_sps->max_num_ref_frames, 1))
      fail("%zu reference frames exceed max_num_ref_frames %d", refs.size(),
           cur_sps->max_num_ref_frames);
  }

  // ------------------------------------------------------- reference lists

  void build_list(const SliceHeader& h) {
    list.clear();
    std::vector<Pic> shorts, longs;
    for (auto& r : refs) (r->short_ref ? shorts : longs).push_back(r);
    const int fn = h.frame_num;
    std::stable_sort(shorts.begin(), shorts.end(), [&](const Pic& a, const Pic& b) {
      return frame_num_wrap(*a, fn) > frame_num_wrap(*b, fn);
    });
    std::stable_sort(longs.begin(), longs.end(),
                     [](const Pic& a, const Pic& b) { return a->long_idx < b->long_idx; });
    list = shorts;
    list.insert(list.end(), longs.begin(), longs.end());
    const size_t n = static_cast<size_t>(h.num_ref_idx);
    list.resize(n);
    if (!h.mods.empty()) feats |= kListModification;
    const int max_pic_num = max_frame_num();
    int pred = fn, index = 0;
    for (const auto& mod : h.mods) {
      if (index >= h.num_ref_idx) fail("the reference list modification runs past the list");
      Pic pic;
      if (mod.first < 2) {
        const int diff = mod.second + 1;
        if (diff > max_pic_num) fail("abs_diff_pic_num_minus1 %d is out of range", mod.second);
        int no_wrap = mod.first == 0 ? pred - diff : pred + diff;
        if (no_wrap < 0) no_wrap += max_pic_num;
        if (no_wrap >= max_pic_num) no_wrap -= max_pic_num;
        pred = no_wrap;
        const int pic_num = no_wrap > fn ? no_wrap - max_pic_num : no_wrap;
        pic = short_by_pic_num(pic_num);
        if (!pic) fail("the reference list modification names picture number %d, which is not "
                       "a short-term reference", pic_num);
      } else {
        pic = long_by_idx(mod.second);
        if (!pic) fail("the reference list modification names long-term picture %d, which is "
                       "not a reference", mod.second);
      }
      list.insert(list.begin() + index, pic);
      ++index;
      size_t k = static_cast<size_t>(index);
      for (size_t c = static_cast<size_t>(index); c < list.size(); ++c)
        if (list[c] != pic) list[k++] = list[c];
      list.resize(n);
    }
    for (auto& r : list)
      if (r && r->long_ref) feats |= kLongTerm;
  }

  // -------------------------------------------------------- slice data

  bool mb_available(int addr) const {
    return addr >= 0 && mb_slice[static_cast<size_t>(addr)] == cur_slice_num;
  }

  void decode_slice(Bits& b, const SliceHeader& h) {
    if (h.first_mb >= mb_w * mb_h) fail("first_mb_in_slice %d is past the picture", h.first_mb);
    cur_slice_num = slice_num++;
    if (cur_slice_num) feats |= kSlices;
    slice_params.push_back({h.deblock, h.alpha, h.beta});
    if (h.type == 0) build_list(h);
    qp = h.qp;
    b.what = "a slice";
    int addr = h.first_mb;
    const int total = mb_w * mb_h;
    bool more = true;
    while (more) {
      if (h.type == 0) {
        const int run = b.ue_max(static_cast<uint32_t>(total - addr), "mb_skip_run");
        for (int i = 0; i < run; ++i) skip_mb(addr++);
        if (run) {
          more = b.more_data();
          if (!more) break;
        }
      }
      if (addr >= total) fail("the slice runs past the picture's last macroblock");
      macroblock(b, h, addr++);
      more = b.more_data();
    }
    b.check();
    last_mb = addr - 1;
  }

  void begin_mb(int addr, uint8_t kind) {
    mb_kind[static_cast<size_t>(addr)] = kind;
    mb_slice[static_cast<size_t>(addr)] = static_cast<int16_t>(cur_slice_num);
    ++decoded;
  }

  // the 4x4 block grids' index of block (bx, by) of macroblock (mx, my)
  size_t blk(int mx, int my, int bx, int by) const {
    return static_cast<size_t>(my * 4 + by) * w4 + mx * 4 + bx;
  }

  // motion of the block at (bx, by) relative to the current macroblock
  // (either may be -1 or 4): false when it is not available
  bool neighbour(int mx, int my, int bx, int by, int& ref, int& x, int& y) const {
    ref = -1;
    x = y = 0;
    if (bx >= 0 && bx < 4 && by >= 0 && by < 4) {
      if (!((done >> (by * 4 + bx)) & 1)) return false;
    } else {
      if (by >= 4 || (bx >= 4 && by >= 0)) return false;
      const int ax = mx * 4 + bx, ay = my * 4 + by;
      if (ax < 0 || ay < 0 || ax >= w4) return false;
      if (!mb_available((ay >> 2) * mb_w + (ax >> 2))) return false;
    }
    const size_t i = blk(mx, my, 0, 0) + static_cast<size_t>(by) * w4 + bx;
    ref = ref_idx[i];
    x = mv[i][0];
    y = mv[i][1];
    return true;
  }

  static int median(int a, int b, int c) {
    return std::max(std::min(a, b), std::min(std::max(a, b), c));
  }

  // 8.4.1.3: shape 0 plain, 1 16x8 upper, 2 16x8 lower, 3 8x16 left, 4 8x16 right
  void predict(int mx, int my, int bx, int by, int w, int ref, int shape, int out[2]) const {
    int ra, rb, rc, ax, ay, bx_, by_, cx, cy;
    const bool has_a = neighbour(mx, my, bx - 1, by, ra, ax, ay);
    const bool has_b = neighbour(mx, my, bx, by - 1, rb, bx_, by_);
    bool has_c = neighbour(mx, my, bx + w, by - 1, rc, cx, cy);
    if (!has_c) has_c = neighbour(mx, my, bx - 1, by - 1, rc, cx, cy);
    if ((shape == 1 && rb == ref) || (shape == 2 && ra == ref) || (shape == 3 && ra == ref) ||
        (shape == 4 && rc == ref)) {
      const bool use_b = shape == 1, use_a = shape == 2 || shape == 3;
      out[0] = use_b ? bx_ : use_a ? ax : cx;
      out[1] = use_b ? by_ : use_a ? ay : cy;
      return;
    }
    if (!has_b && !has_c && has_a) {
      out[0] = ax;
      out[1] = ay;
      return;
    }
    const int match = (ra == ref) + (rb == ref) + (rc == ref);
    if (match == 1) {
      out[0] = ra == ref ? ax : rb == ref ? bx_ : cx;
      out[1] = ra == ref ? ay : rb == ref ? by_ : cy;
      return;
    }
    out[0] = median(ax, bx_, cx);
    out[1] = median(ay, by_, cy);
  }

  void set_motion(int mx, int my, int bx, int by, int w, int h, int ref, int x, int y) {
    const int pic = list[static_cast<size_t>(ref)]->id;
    for (int j = by; j < by + h; ++j)
      for (int i = bx; i < bx + w; ++i) {
        const size_t k = blk(mx, my, i, j);
        ref_idx[k] = static_cast<int8_t>(ref);
        ref_pic[k] = pic;
        mv[k] = {static_cast<int16_t>(x), static_cast<int16_t>(y)};
        done |= static_cast<uint16_t>(1u << (j * 4 + i));
      }
  }

  void skip_mb(int addr) {
    feats |= kSkip;
    const int mx = addr % mb_w, my = addr / mb_w;
    begin_mb(addr, kPSkip);
    mb_qp[static_cast<size_t>(addr)] = static_cast<int8_t>(qp);
    done = 0;
    int ra, rb, ax, ay, bx, by;
    const bool has_a = neighbour(mx, my, -1, 0, ra, ax, ay);
    const bool has_b = neighbour(mx, my, 0, -1, rb, bx, by);
    int m[2] = {0, 0};
    if (has_a && has_b && !(ra == 0 && !ax && !ay) && !(rb == 0 && !bx && !by))
      predict(mx, my, 0, 0, 4, 0, 0, m);
    if (list.empty() || !list[0]) fail("a skipped macroblock's reference picture is missing");
    set_motion(mx, my, 0, 0, 4, 4, 0, m[0], m[1]);
    inter_predict(mx, my, 0, 0, 4, 4, *list[0], m[0], m[1]);
  }

  // ------------------------------------------------------------ residual

  // nC from the total_coeff of the blocks left of and above block (bx, by)
  // of a grid `g` `gw` blocks wide and `per` blocks a macroblock
  int nc(const std::vector<uint8_t>& g, int per, int mx, int my, int bx, int by) const {
    const int gw = per * mb_w;
    auto at = [&](int x, int y, int& v) {
      if (x < 0 || y < 0) return false;
      if (x >= mx * per && y >= my * per) {  // inside the current macroblock
      } else if (!mb_available((y / per) * mb_w + x / per)) {
        return false;
      }
      v = g[static_cast<size_t>(y) * gw + x];
      return true;
    };
    int a = 0, b = 0;
    const int x = mx * per + bx, y = my * per + by;
    const bool ha = at(x - 1, y, a), hb = at(x, y - 1, b);
    if (ha && hb) return (a + b + 1) >> 1;
    return ha ? a : hb ? b : 0;
  }

  // one residual_block_cavlc: coefficients at scan positions start..start +
  // max - 1 of `out` (16 entries); returns total_coeff
  int residual_block(Bits& b, int n_c, int* out, int start, int max) {
    const Vlcs& v = vlcs();
    int token;
    if (n_c < 0)
      token = b.vlc(v.chroma_token, "chroma DC coeff_token");
    else
      token = b.vlc(v.token[n_c < 2 ? 0 : n_c < 4 ? 1 : n_c < 8 ? 2 : 3], "coeff_token");
    const int total = token >> 2, ones = token & 3;
    if (!total) return 0;
    if (total > max) fail("%s: coeff_token gives %d coefficients in a block of %d", b.what, total,
                          max);
    int level[16], run[16];
    int suffix = total > 10 && ones < 3 ? 1 : 0;
    for (int i = 0; i < total; ++i) {
      if (i < ones) {
        level[i] = b.u(1) ? -1 : 1;
        continue;
      }
      int prefix = 0;
      for (;;) {
        b.check();
        const uint32_t look = b.peek32();
        if (look) {
          const int lz = __builtin_clz(look);
          prefix += lz;
          b.pos += lz + 1;
          break;
        }
        prefix += 32;
        b.pos += 32;
        if (prefix > 64) fail("%s: a level_prefix runs on", b.what);
      }
      b.check();
      if (prefix >= 15) feats |= kLevelEscape;
      if (prefix >= 16) feats |= kLevelPrefix16;
      if (prefix > 25 + 3) fail("%s: level_prefix %d is out of range", b.what, prefix);
      int code = std::min(15, prefix) << suffix;
      if (suffix > 0 || prefix >= 14) {
        const int size = prefix == 14 && suffix == 0 ? 4 : prefix >= 15 ? prefix - 3 : suffix;
        if (size) code += static_cast<int>(b.u(size));
      }
      if (prefix >= 15 && suffix == 0) code += 15;
      if (prefix >= 16) code += (1 << (prefix - 3)) - 4096;
      if (i == ones && ones < 3) code += 2;
      level[i] = code % 2 == 0 ? (code + 2) >> 1 : (-code - 1) >> 1;
      // a conforming 8-bit stream keeps levels within 16 bits; past that the
      // stream is damaged, and the clamp keeps the arithmetic below defined
      level[i] = clip3(-kMaxLevel, kMaxLevel, level[i]);
      if (suffix == 0) suffix = 1;
      if (std::abs(level[i]) > (3 << (suffix - 1)) && suffix < 6) ++suffix;
    }
    int zeros = 0;
    if (total < max) {
      zeros = max == 4 ? b.vlc(v.chroma_zeros[total - 1], "chroma DC total_zeros")
                       : b.vlc(v.zeros[total - 1], "total_zeros");
      if (zeros > max - total) fail("%s: total_zeros %d is out of range", b.what, zeros);
    }
    for (int i = 0; i < total - 1; ++i) {
      run[i] = zeros > 0 ? b.vlc(v.run[std::min(zeros, 7) - 1], "run_before") : 0;
      if (run[i] > zeros) fail("%s: run_before %d exceeds the zeros left", b.what, run[i]);
      zeros -= run[i];
    }
    run[total - 1] = zeros;
    int pos = -1;
    for (int i = total - 1; i >= 0; --i) {
      pos += run[i] + 1;
      out[start + pos] = level[i];
    }
    return total;
  }

  // ------------------------------------------------------------ macroblock

  void macroblock(Bits& b, const SliceHeader& h, int addr) {
    const int mx = addr % mb_w, my = addr / mb_w;
    int type = b.ue_max(h.type == 0 ? 30 : 25, "mb_type");
    if (h.type == 0) {
      if (type < 5) {
        inter_mb(b, h, addr, mx, my, type);
        return;
      }
      type -= 5;
      feats |= kIntraInP;
    }
    if (type > 25) fail("mb_type %d is out of range", type);
    if (type == 25) {
      pcm_mb(b, addr, mx, my);
      return;
    }
    intra_mb(b, addr, mx, my, type);
  }

  void pcm_mb(Bits& b, int addr, int mx, int my) {
    feats |= kPcm;
    begin_mb(addr, kIPcm);
    mb_qp[static_cast<size_t>(addr)] = 0;
    b.pos = (b.pos + 7) & ~size_t(7);
    if (b.pos + 384 * 8 > b.size) fail("%s runs past its end", b.what);
    const uint8_t* p = b.p + (b.pos >> 3);
    for (int y = 0; y < 16; ++y)
      std::memcpy(&cur->px[0][static_cast<size_t>(my * 16 + y) * coded_w + mx * 16], p + y * 16, 16);
    const int cw = coded_w / 2;
    for (int c = 1; c < 3; ++c)
      for (int y = 0; y < 8; ++y)
        std::memcpy(&cur->px[c][static_cast<size_t>(my * 8 + y) * cw + mx * 8],
                    p + 256 + (c - 1) * 64 + y * 8, 8);
    b.pos += 384 * 8;
    for (int j = 0; j < 4; ++j)
      for (int i = 0; i < 4; ++i) nz[blk(mx, my, i, j)] = 16;
    for (int j = 0; j < 2; ++j)
      for (int i = 0; i < 2; ++i) {
        const size_t k = static_cast<size_t>(my * 2 + j) * (2 * mb_w) + mx * 2 + i;
        nz_cb[k] = nz_cr[k] = 16;
      }
  }

  // intra availability of the macroblock at (mx + dx, my + dy)
  bool intra_available(int mx, int my, int dx, int dy) const {
    const int x = mx + dx, y = my + dy;
    if (x < 0 || y < 0 || x >= mb_w) return false;
    const int a = y * mb_w + x;
    if (!mb_available(a)) return false;
    return !cur_pps->constrained_intra || is_intra(mb_kind[static_cast<size_t>(a)]);
  }

  void intra_mb(Bits& b, int addr, int mx, int my, int type) {
    const bool i4 = type == 0;
    feats |= i4 ? kIntra4x4 : kIntra16x16;
    begin_mb(addr, i4 ? kI4 : kI16);
    int pred_modes[16];
    if (i4) {
      for (int n = 0; n < 16; ++n) {
        const int bx = (n & 1) + ((n >> 2) & 1) * 2, by = ((n >> 1) & 1) + (n >> 3) * 2;
        const int predicted = predicted_mode(mx, my, bx, by);
        int mode;
        if (b.flag()) {
          mode = predicted;
        } else {
          const int rem = static_cast<int>(b.u(3));
          mode = rem < predicted ? rem : rem + 1;
        }
        pred_modes[n] = mode;
        modes[blk(mx, my, bx, by)] = static_cast<int8_t>(mode);
      }
    }
    const int chroma_mode = b.ue_max(3, "intra_chroma_pred_mode");
    int cbp;
    if (i4) {
      cbp = kIntraCbp[b.ue_max(47, "coded_block_pattern")];
    } else {
      const int t = type - 1;
      cbp = ((t / 4) % 3) << 4 | (t >= 12 ? 15 : 0);
    }
    residual_and_reconstruct(b, addr, mx, my, i4 ? kI4 : kI16, cbp, pred_modes,
                             i4 ? -1 : (type - 1) % 4, chroma_mode);
  }

  int predicted_mode(int mx, int my, int bx, int by) const {
    auto mode_of = [&](int x, int y, int& m) {  // false: dcPredModePredictedFlag
      if (x >= 0 && y >= 0) {
        m = modes[blk(mx, my, x, y)];
        return true;
      }
      const int dx = x < 0 ? -1 : 0, dy = y < 0 ? -1 : 0;
      const int nx = mx + dx, ny = my + dy;
      if (nx < 0 || ny < 0) return false;
      const int a = ny * mb_w + nx;
      if (!mb_available(a)) return false;
      const uint8_t k = mb_kind[static_cast<size_t>(a)];
      if (!is_intra(k) && cur_pps->constrained_intra) return false;
      m = k == kI4 ? modes[blk(nx, ny, (x + 4) & 3, (y + 4) & 3)] : 2;
      return true;
    };
    int a, b;
    if (!mode_of(bx - 1, by, a) || !mode_of(bx, by - 1, b)) return 2;
    return std::min(a, b);
  }

  void inter_mb(Bits& b, const SliceHeader& h, int addr, int mx, int my, int type) {
    begin_mb(addr, kInter);
    const int refs_n = h.num_ref_idx;
    auto read_ref = [&]() {
      if (refs_n == 1) return 0;
      const int r = refs_n == 2 ? static_cast<int>(!b.flag()) : b.ue_max(refs_n - 1, "ref_idx_l0");
      return r;
    };
    done = 0;
    // partitions: (bx, by, w, h, shape) in 4x4 blocks
    struct Part {
      int bx, by, w, h, shape, ref, mvd[2];
    };
    Part parts[16];
    int count = 0;
    if (type < 3) {
      feats |= type == 0 ? kP16x16 : type == 1 ? kP16x8 : kP8x16;
      if (type == 0) parts[count++] = {0, 0, 4, 4, 0, 0, {0, 0}};
      if (type == 1) {
        parts[count++] = {0, 0, 4, 2, 1, 0, {0, 0}};
        parts[count++] = {0, 2, 4, 2, 2, 0, {0, 0}};
      }
      if (type == 2) {
        parts[count++] = {0, 0, 2, 4, 3, 0, {0, 0}};
        parts[count++] = {2, 0, 2, 4, 4, 0, {0, 0}};
      }
      for (int i = 0; i < count; ++i) parts[i].ref = read_ref();
      for (int i = 0; i < count; ++i) {
        parts[i].mvd[0] = b.se();
        parts[i].mvd[1] = b.se();
      }
    } else {
      feats |= type == 3 ? kP8x8 : kP8x8Ref0;
      int sub[4], ref[4] = {0, 0, 0, 0};
      for (int i = 0; i < 4; ++i) sub[i] = b.ue_max(3, "sub_mb_type");
      if (type == 3)
        for (int i = 0; i < 4; ++i) ref[i] = read_ref();
      for (int i = 0; i < 4; ++i) {
        const int ox = (i & 1) * 2, oy = (i >> 1) * 2;
        static const int kParts[4] = {1, 2, 2, 4};
        if (sub[i] == 1) feats |= kSub8x4;
        if (sub[i] == 2) feats |= kSub4x8;
        if (sub[i] == 3) feats |= kSub4x4;
        for (int j = 0; j < kParts[sub[i]]; ++j) {
          Part p{ox, oy, 2, 2, 0, ref[i], {0, 0}};
          if (sub[i] == 1) {
            p.h = 1;
            p.by += j;
          } else if (sub[i] == 2) {
            p.w = 1;
            p.bx += j;
          } else if (sub[i] == 3) {
            p.w = p.h = 1;
            p.bx += j & 1;
            p.by += j >> 1;
          }
          p.mvd[0] = b.se();
          p.mvd[1] = b.se();
          parts[count++] = p;
        }
      }
    }
    for (int i = 0; i < count; ++i) {
      Part& p = parts[i];
      if (p.ref >= static_cast<int>(list.size()) || !list[static_cast<size_t>(p.ref)])
        fail("reference index %d names a missing reference picture", p.ref);
      if (p.ref > 0) feats |= kMultiRef;
      int m[2];
      predict(mx, my, p.bx, p.by, p.w, p.ref, p.shape, m);
      const int64_t x = int64_t(m[0]) + p.mvd[0], y = int64_t(m[1]) + p.mvd[1];
      if (x < -32768 || x > 32767 || y < -32768 || y > 32767)
        fail("a motion vector (%lld, %lld) is out of range", static_cast<long long>(x),
             static_cast<long long>(y));
      set_motion(mx, my, p.bx, p.by, p.w, p.h, p.ref, static_cast<int>(x), static_cast<int>(y));
    }
    for (int i = 0; i < count; ++i) {
      const Part& p = parts[i];
      const size_t k = blk(mx, my, p.bx, p.by);
      inter_predict(mx, my, p.bx, p.by, p.w, p.h, *list[static_cast<size_t>(p.ref)], mv[k][0],
                    mv[k][1]);
    }
    const int cbp = kInterCbp[b.ue_max(47, "coded_block_pattern")];
    residual_and_reconstruct(b, addr, mx, my, kInter, cbp, nullptr, -1, -1);
  }

  // mb_qp_delta, the residual blocks, then the prediction (intra) and the
  // inverse transforms into the picture
  void residual_and_reconstruct(Bits& b, int addr, int mx, int my, int kind, int cbp,
                                const int* i4modes, int i16mode, int chroma_mode) {
    const int cbp_luma = cbp & 15, cbp_chroma = cbp >> 4;
    if (cbp_chroma > 2) fail("coded_block_pattern %d is out of range", cbp);
    int luma[16][16] = {}, dc[16] = {}, cdc[2][4] = {}, cac[2][4][16] = {};
    if (cbp || kind == kI16) {
      const int delta = b.se_range(-26, 25, "mb_qp_delta");
      if (delta) feats |= kQpDelta;
      qp = (qp + delta + 52) % 52;
    }
    mb_qp[static_cast<size_t>(addr)] = static_cast<int8_t>(qp);
    if (kind == kI16) residual_block(b, nc(nz, 4, mx, my, 0, 0), dc, 0, 16);
    for (int n = 0; n < 16; ++n) {
      const int bx = (n & 1) + ((n >> 2) & 1) * 2, by = ((n >> 1) & 1) + (n >> 3) * 2;
      int total = 0;
      if (cbp_luma & (1 << (n >> 2))) {
        const int c = nc(nz, 4, mx, my, bx, by);
        total = kind == kI16 ? residual_block(b, c, luma[n], 1, 15)
                             : residual_block(b, c, luma[n], 0, 16);
      }
      nz[blk(mx, my, bx, by)] = static_cast<uint8_t>(total);
    }
    if (cbp_chroma)
      for (int c = 0; c < 2; ++c) residual_block(b, -1, cdc[c], 0, 4);
    for (int c = 0; c < 2; ++c) {
      std::vector<uint8_t>& g = c ? nz_cr : nz_cb;
      for (int n = 0; n < 4; ++n) {
        int total = 0;
        if (cbp_chroma & 2) total = residual_block(b, nc(g, 2, mx, my, n & 1, n >> 1), cac[c][n], 1, 15);
        g[static_cast<size_t>(my * 2 + (n >> 1)) * (2 * mb_w) + mx * 2 + (n & 1)] =
            static_cast<uint8_t>(total);
      }
    }
    b.check();

    // luma
    const int q6 = qp / 6, q_r = qp % 6;
    uint8_t* y_plane = cur->px[0].data();
    const int ys = coded_w;
    uint8_t* mb_y = y_plane + static_cast<size_t>(my * 16) * ys + mx * 16;
    if (kind == kI16) {
      intra16(mx, my, i16mode, mb_y, ys);
      int c[16], f[16];
      for (int i = 0; i < 16; ++i) c[kZigzag[i]] = dc[i];
      hadamard4(c, f);
      const int scale = kDequant[q_r][0] * 16;
      for (int i = 0; i < 16; ++i) {
        const int bx = i & 3, by = i >> 2;
        const int v = bounded(qp >= 36 ? int64_t(f[i]) * scale * (1 << (q6 - 6))
                                       : (int64_t(f[i]) * scale + (1 << (5 - q6))) >> (6 - q6));
        const int n = (bx & 1) + (by & 1) * 2 + (bx >> 1) * 4 + (by >> 1) * 8;
        luma[n][0] = v;  // its DC, already scaled
      }
    }
    for (int n = 0; n < 16; ++n) {
      const int bx = (n & 1) + ((n >> 2) & 1) * 2, by = ((n >> 1) & 1) + (n >> 3) * 2;
      uint8_t* dst = mb_y + (by * 4) * ys + bx * 4;
      if (kind == kI4) intra4(mx, my, bx, by, i4modes[n], dst, ys);
      int block[16];
      bool any = false;
      for (int i = 0; i < 16; ++i) {
        const int pos = kZigzag[i];
        int v = luma[n][i];
        if (i == 0 && kind == kI16) {
          block[pos] = v;
        } else {
          block[pos] = bounded(int64_t(v) * level_scale(q_r, pos) * (1 << q6));
        }
        any |= block[pos] != 0;
      }
      if (any) idct4(block, dst, ys);
    }

    // chroma
    const int cw = coded_w / 2;
    for (int c = 0; c < 2; ++c) {
      const int offset = c ? cur_pps->cr_offset : cur_pps->cb_offset;
      const int qc = kChromaQp[clip3(0, 51, qp + offset)];
      const int qc6 = qc / 6, qc_r = qc % 6;
      uint8_t* dst = cur->px[1 + c].data() + static_cast<size_t>(my * 8) * cw + mx * 8;
      if (kind != kInter) intra_chroma(mx, my, chroma_mode, dst, cw);
      const int* d = cdc[c];
      const int f[4] = {d[0] + d[1] + d[2] + d[3], d[0] - d[1] + d[2] - d[3],
                        d[0] + d[1] - d[2] - d[3], d[0] - d[1] - d[2] + d[3]};
      const int scale = kDequant[qc_r][0] * 16;
      for (int n = 0; n < 4; ++n) {
        int block[16];
        block[0] = bounded((int64_t(f[n]) * scale * (1 << qc6)) >> 5);
        bool any = block[0] != 0;
        for (int i = 1; i < 16; ++i) {
          const int pos = kZigzag[i];
          const int v = cac[c][n][i];
          block[pos] = bounded(int64_t(v) * level_scale(qc_r, pos) * (1 << qc6));
          any |= block[pos] != 0;
        }
        if (any) idct4(block, dst + (n >> 1) * 4 * cw + (n & 1) * 4, cw);
      }
    }
  }

  static int level_scale(int r, int pos) {
    const int x = pos & 3, y = pos >> 2;
    return kDequant[r][(x & 1) && (y & 1) ? 1 : !(x & 1) && !(y & 1) ? 0 : 2];
  }

  static void hadamard4(const int* c, int* f) {
    int t[16];
    for (int y = 0; y < 4; ++y) {
      const int* r = c + y * 4;
      const int a = r[0] + r[1], b = r[0] - r[1], d = r[2] + r[3], e = r[2] - r[3];
      t[y * 4 + 0] = a + d;
      t[y * 4 + 1] = a - d;
      t[y * 4 + 2] = b - e;
      t[y * 4 + 3] = b + e;
    }
    for (int x = 0; x < 4; ++x) {
      const int a = t[x] + t[4 + x], b = t[x] - t[4 + x], d = t[8 + x] + t[12 + x],
                e = t[8 + x] - t[12 + x];
      f[x] = a + d;
      f[4 + x] = a - d;
      f[8 + x] = b - e;
      f[12 + x] = b + e;
    }
  }

  // 8.5.12: the inverse 4x4 transform of `d` (raster), added to dst
  static void idct4(const int* d, uint8_t* dst, int stride) {
    int t[16];
    for (int y = 0; y < 4; ++y) {
      const int* r = d + y * 4;
      const int e = r[0] + r[2], f = r[0] - r[2], g = (r[1] >> 1) - r[3], h = r[1] + (r[3] >> 1);
      t[y * 4 + 0] = e + h;
      t[y * 4 + 1] = f + g;
      t[y * 4 + 2] = f - g;
      t[y * 4 + 3] = e - h;
    }
    for (int x = 0; x < 4; ++x) {
      const int e = t[x] + t[8 + x], f = t[x] - t[8 + x], g = (t[4 + x] >> 1) - t[12 + x],
                h = t[4 + x] + (t[12 + x] >> 1);
      const int r[4] = {e + h, f + g, f - g, e - h};
      for (int y = 0; y < 4; ++y) {
        uint8_t& p = dst[y * stride + x];
        p = clip_pixel(p + ((r[y] + 32) >> 6));
      }
    }
  }

  // ------------------------------------------------------- intra prediction

  void intra4(int mx, int my, int bx, int by, int mode, uint8_t* dst, int s) {
    const bool left = bx > 0 || intra_available(mx, my, -1, 0);
    const bool top = by > 0 || intra_available(mx, my, 0, -1);
    bool top_left;
    if (bx > 0 && by > 0)
      top_left = true;
    else if (bx > 0)
      top_left = intra_available(mx, my, 0, -1);
    else if (by > 0)
      top_left = intra_available(mx, my, -1, 0);
    else
      top_left = intra_available(mx, my, -1, -1);
    bool top_right;
    if (by == 0) {
      top_right = bx < 3 ? intra_available(mx, my, 0, -1) : intra_available(mx, my, 1, -1);
    } else if (bx == 3) {
      top_right = false;
    } else {
      auto order = [](int x, int y) { return (x >> 1) * 4 + (y >> 1) * 8 + (x & 1) + (y & 1) * 2; };
      top_right = order(bx + 1, by - 1) < order(bx, by);
    }
    int t[8], l[4], tl = 0;
    if (top) {
      for (int i = 0; i < 4; ++i) t[i] = dst[i - s];
      for (int i = 4; i < 8; ++i) t[i] = top_right ? dst[i - s] : t[3];
    }
    if (left)
      for (int i = 0; i < 4; ++i) l[i] = dst[i * s - 1];
    if (top_left) tl = dst[-s - 1];
    auto need = [&](bool ok) {
      if (!ok) fail("an intra 4x4 prediction mode %d needs samples that are not available", mode);
    };
    int p[16];
    auto T = [&](int x) { return x < 0 ? tl : t[x]; };
    auto L = [&](int y) { return y < 0 ? tl : l[y]; };
    switch (mode) {
      case 0:
        need(top);
        for (int y = 0; y < 4; ++y)
          for (int x = 0; x < 4; ++x) p[y * 4 + x] = t[x];
        break;
      case 1:
        need(left);
        for (int y = 0; y < 4; ++y)
          for (int x = 0; x < 4; ++x) p[y * 4 + x] = l[y];
        break;
      case 2: {
        int v = 128;
        if (top && left)
          v = (t[0] + t[1] + t[2] + t[3] + l[0] + l[1] + l[2] + l[3] + 4) >> 3;
        else if (left)
          v = (l[0] + l[1] + l[2] + l[3] + 2) >> 2;
        else if (top)
          v = (t[0] + t[1] + t[2] + t[3] + 2) >> 2;
        for (int i = 0; i < 16; ++i) p[i] = v;
        break;
      }
      case 3:
        need(top);
        for (int y = 0; y < 4; ++y)
          for (int x = 0; x < 4; ++x)
            p[y * 4 + x] = x == 3 && y == 3 ? (t[6] + 3 * t[7] + 2) >> 2
                                            : (t[x + y] + 2 * t[x + y + 1] + t[x + y + 2] + 2) >> 2;
        break;
      case 4:
        need(top && left && top_left);
        for (int y = 0; y < 4; ++y)
          for (int x = 0; x < 4; ++x) {
            int v;
            if (x > y)
              v = (T(x - y - 2) + 2 * T(x - y - 1) + T(x - y) + 2) >> 2;
            else if (x < y)
              v = (L(y - x - 2) + 2 * L(y - x - 1) + L(y - x) + 2) >> 2;
            else
              v = (T(0) + 2 * tl + L(0) + 2) >> 2;
            p[y * 4 + x] = v;
          }
        break;
      case 5:
        need(top && left && top_left);
        for (int y = 0; y < 4; ++y)
          for (int x = 0; x < 4; ++x) {
            const int z = 2 * x - y;
            int v;
            if (z >= 0 && !(z & 1))
              v = (T(x - (y >> 1) - 1) + T(x - (y >> 1)) + 1) >> 1;
            else if (z >= 0)
              v = (T(x - (y >> 1) - 2) + 2 * T(x - (y >> 1) - 1) + T(x - (y >> 1)) + 2) >> 2;
            else if (z == -1)
              v = (L(0) + 2 * tl + T(0) + 2) >> 2;
            else
              v = (L(y - 1) + 2 * L(y - 2) + L(y - 3) + 2) >> 2;
            p[y * 4 + x] = v;
          }
        break;
      case 6:
        need(top && left && top_left);
        for (int y = 0; y < 4; ++y)
          for (int x = 0; x < 4; ++x) {
            const int z = 2 * y - x;
            int v;
            if (z >= 0 && !(z & 1))
              v = (L(y - (x >> 1) - 1) + L(y - (x >> 1)) + 1) >> 1;
            else if (z >= 0)
              v = (L(y - (x >> 1) - 2) + 2 * L(y - (x >> 1) - 1) + L(y - (x >> 1)) + 2) >> 2;
            else if (z == -1)
              v = (L(0) + 2 * tl + T(0) + 2) >> 2;
            else
              v = (T(x - 1) + 2 * T(x - 2) + T(x - 3) + 2) >> 2;
            p[y * 4 + x] = v;
          }
        break;
      case 7:
        need(top);
        for (int y = 0; y < 4; ++y)
          for (int x = 0; x < 4; ++x) {
            const int i = x + (y >> 1);
            p[y * 4 + x] = y & 1 ? (t[i] + 2 * t[i + 1] + t[i + 2] + 2) >> 2
                                 : (t[i] + t[i + 1] + 1) >> 1;
          }
        break;
      case 8:
        need(left);
        for (int y = 0; y < 4; ++y)
          for (int x = 0; x < 4; ++x) {
            const int z = x + 2 * y;
            int v;
            if (z > 5)
              v = l[3];
            else if (z == 5)
              v = (l[2] + 3 * l[3] + 2) >> 2;
            else if (z & 1)
              v = (l[y + (x >> 1)] + 2 * l[y + (x >> 1) + 1] + l[y + (x >> 1) + 2] + 2) >> 2;
            else
              v = (l[y + (x >> 1)] + l[y + (x >> 1) + 1] + 1) >> 1;
            p[y * 4 + x] = v;
          }
        break;
      default:
        fail("intra 4x4 prediction mode %d is out of range", mode);
    }
    for (int y = 0; y < 4; ++y)
      for (int x = 0; x < 4; ++x) dst[y * s + x] = static_cast<uint8_t>(p[y * 4 + x]);
  }

  void intra16(int mx, int my, int mode, uint8_t* dst, int s) {
    const bool left = intra_available(mx, my, -1, 0), top = intra_available(mx, my, 0, -1);
    const bool top_left = intra_available(mx, my, -1, -1);
    intra_block(dst, s, 16, mode == 0 ? 0 : mode == 1 ? 1 : mode == 2 ? 2 : 3, left, top,
                top_left, "intra 16x16");
  }

  // DC (2), horizontal (1), vertical (0) or plane (3) prediction of an n x n
  // block (luma 16, chroma 8 with chroma's DC rules)
  void intra_block(uint8_t* dst, int s, int n, int mode, bool left, bool top, bool top_left,
                   const char* what) {
    auto need = [&](bool ok) {
      if (!ok) fail("an %s prediction mode needs samples that are not available", what);
    };
    if (mode == 0) {
      need(top);
      for (int y = 0; y < n; ++y) std::memcpy(dst + y * s, dst - s, n);
    } else if (mode == 1) {
      need(left);
      for (int y = 0; y < n; ++y) std::memset(dst + y * s, dst[y * s - 1], n);
    } else if (mode == 2) {
      if (n == 16) {
        int sum = 0, v = 128;
        if (top)
          for (int i = 0; i < 16; ++i) sum += dst[i - s];
        if (left)
          for (int i = 0; i < 16; ++i) sum += dst[i * s - 1];
        if (top && left)
          v = (sum + 16) >> 5;
        else if (top || left)
          v = (sum + 8) >> 4;
        for (int y = 0; y < 16; ++y) std::memset(dst + y * s, v, 16);
      } else {
        for (int by = 0; by < 2; ++by)
          for (int bx = 0; bx < 2; ++bx) {
            int st = 0, sl = 0;
            for (int i = 0; i < 4; ++i) {
              if (top) st += dst[bx * 4 + i - s];
              if (left) sl += dst[(by * 4 + i) * s - 1];
            }
            int v = 128;
            if (bx == by) {
              v = top && left ? (st + sl + 4) >> 3 : left ? (sl + 2) >> 2 : top ? (st + 2) >> 2 : 128;
            } else if (bx == 1) {
              v = top ? (st + 2) >> 2 : left ? (sl + 2) >> 2 : 128;
            } else {
              v = left ? (sl + 2) >> 2 : top ? (st + 2) >> 2 : 128;
            }
            for (int y = 0; y < 4; ++y) std::memset(dst + (by * 4 + y) * s + bx * 4, v, 4);
          }
      }
    } else {
      need(top && left && top_left);
      const int half = n / 2;
      int hh = 0, vv = 0;
      for (int i = 0; i < half; ++i) {
        hh += (i + 1) * (dst[half + i - s] - dst[half - 2 - i - s]);
        vv += (i + 1) * (dst[(half + i) * s - 1] - dst[(half - 2 - i) * s - 1]);
      }
      const int a = 16 * (dst[(n - 1) * s - 1] + dst[n - 1 - s]);
      const int b = n == 16 ? (5 * hh + 32) >> 6 : (34 * hh + 32) >> 6;
      const int c = n == 16 ? (5 * vv + 32) >> 6 : (34 * vv + 32) >> 6;
      for (int y = 0; y < n; ++y)
        for (int x = 0; x < n; ++x)
          dst[y * s + x] = clip_pixel((a + b * (x - (half - 1)) + c * (y - (half - 1)) + 16) >> 5);
    }
  }

  void intra_chroma(int mx, int my, int mode, uint8_t* dst, int s) {
    const bool left = intra_available(mx, my, -1, 0), top = intra_available(mx, my, 0, -1);
    const bool top_left = intra_available(mx, my, -1, -1);
    // intra_chroma_pred_mode: 0 DC, 1 horizontal, 2 vertical, 3 plane
    static const int kMode[4] = {2, 1, 0, 3};
    intra_block(dst, s, 8, kMode[mode], left, top, top_left, "intra chroma");
  }

  // ------------------------------------------------------- inter prediction

  void inter_predict(int mx, int my, int bx, int by, int w, int h, const Picture& ref, int vx,
                     int vy) {
    if ((vx | vy) & 3) feats |= kFractionalMv;
    const int px = mx * 16 + bx * 4, py = my * 16 + by * 4, bw = w * 4, bh = h * 4;
    // luma: a window of (bw + 5) x (bh + 5) samples, clamped to the picture
    const int x0 = px + (vx >> 2) - 2, y0 = py + (vy >> 2) - 2;
    if (x0 < 0 || y0 < 0 || x0 + bw + 5 > coded_w || y0 + bh + 5 > coded_h) feats |= kOffFrameMv;
    uint8_t win[21 * 21];
    const int ww = bw + 5;
    for (int y = 0; y < bh + 5; ++y) {
      const int sy = clip3(0, coded_h - 1, y0 + y);
      const uint8_t* row = ref.px[0].data() + static_cast<size_t>(sy) * coded_w;
      for (int x = 0; x < ww; ++x) win[y * ww + x] = row[clip3(0, coded_w - 1, x0 + x)];
    }
    uint8_t* dst = cur->px[0].data() + static_cast<size_t>(py) * coded_w + px;
    luma_mc(win, ww, vx & 3, vy & 3, bw, bh, dst, coded_w);
    // chroma: eighth-sample bilinear
    const int cw = coded_w / 2, ch = coded_h / 2;
    const int cx0 = px / 2 + (vx >> 3), cy0 = py / 2 + (vy >> 3);
    const int fx = vx & 7, fy = vy & 7;
    for (int c = 1; c < 3; ++c) {
      const uint8_t* src = ref.px[c].data();
      uint8_t* out = cur->px[c].data() + static_cast<size_t>(py / 2) * cw + px / 2;
      for (int y = 0; y < bh / 2; ++y) {
        const int ya = clip3(0, ch - 1, cy0 + y), yb = clip3(0, ch - 1, cy0 + y + 1);
        for (int x = 0; x < bw / 2; ++x) {
          const int xa = clip3(0, cw - 1, cx0 + x), xb = clip3(0, cw - 1, cx0 + x + 1);
          const int a = src[ya * cw + xa], b = src[ya * cw + xb], cc = src[yb * cw + xa],
                    d = src[yb * cw + xb];
          out[y * cw + x] = static_cast<uint8_t>(
              ((8 - fx) * (8 - fy) * a + fx * (8 - fy) * b + (8 - fx) * fy * cc + fx * fy * d + 32) >>
              6);
        }
      }
    }
  }

  static int tap(int a, int b, int c, int d, int e, int f) {
    return a - 5 * b + 20 * c + 20 * d - 5 * e + f;
  }

  // 8.4.2.2.1 on a window whose sample (2, 2) is the block's integer origin
  static void luma_mc(const uint8_t* win, int ww, int fx, int fy, int bw, int bh, uint8_t* dst,
                      int s) {
    auto G = [&](int x, int y) { return static_cast<int>(win[(y + 2) * ww + x + 2]); };
    auto b1 = [&](int x, int y) {
      return tap(G(x - 2, y), G(x - 1, y), G(x, y), G(x + 1, y), G(x + 2, y), G(x + 3, y));
    };
    auto h1 = [&](int x, int y) {
      return tap(G(x, y - 2), G(x, y - 1), G(x, y), G(x, y + 1), G(x, y + 2), G(x, y + 3));
    };
    auto half_b = [&](int x, int y) { return clip_pixel((b1(x, y) + 16) >> 5); };
    auto half_h = [&](int x, int y) { return clip_pixel((h1(x, y) + 16) >> 5); };
    auto half_j = [&](int x, int y) {
      const int j1 = tap(b1(x, y - 2), b1(x, y - 1), b1(x, y), b1(x, y + 1), b1(x, y + 2),
                         b1(x, y + 3));
      return clip_pixel((j1 + 512) >> 10);
    };
    for (int y = 0; y < bh; ++y)
      for (int x = 0; x < bw; ++x) {
        int v;
        switch (fy * 4 + fx) {
          case 0: v = G(x, y); break;
          case 1: v = (G(x, y) + half_b(x, y) + 1) >> 1; break;
          case 2: v = half_b(x, y); break;
          case 3: v = (G(x + 1, y) + half_b(x, y) + 1) >> 1; break;
          case 4: v = (G(x, y) + half_h(x, y) + 1) >> 1; break;
          case 5: v = (half_b(x, y) + half_h(x, y) + 1) >> 1; break;
          case 6: v = (half_b(x, y) + half_j(x, y) + 1) >> 1; break;
          case 7: v = (half_b(x, y) + half_h(x + 1, y) + 1) >> 1; break;
          case 8: v = half_h(x, y); break;
          case 9: v = (half_h(x, y) + half_j(x, y) + 1) >> 1; break;
          case 10: v = half_j(x, y); break;
          case 11: v = (half_j(x, y) + half_h(x + 1, y) + 1) >> 1; break;
          case 12: v = (G(x, y + 1) + half_h(x, y) + 1) >> 1; break;
          case 13: v = (half_h(x, y) + half_b(x, y + 1) + 1) >> 1; break;
          case 14: v = (half_j(x, y) + half_b(x, y + 1) + 1) >> 1; break;
          default: v = (half_b(x, y + 1) + half_h(x + 1, y) + 1) >> 1; break;
        }
        dst[y * s + x] = static_cast<uint8_t>(v);
      }
  }

  // ---------------------------------------------------------- deblocking

  int chroma_qp(int qpy, int c) const {
    const int offset = c ? cur_pps->cr_offset : cur_pps->cb_offset;
    return kChromaQp[clip3(0, 51, qpy + offset)];
  }

  // bS of the edge between blocks p and q (grid indices); `mb_edge` for a
  // macroblock edge
  int strength(int p_mb, int q_mb, size_t p, size_t q, bool mb_edge) const {
    if (is_intra(mb_kind[static_cast<size_t>(p_mb)]) || is_intra(mb_kind[static_cast<size_t>(q_mb)]))
      return mb_edge ? 4 : 3;
    if (nz[p] || nz[q]) return 2;
    if (ref_pic[p] != ref_pic[q]) return 1;
    if (std::abs(mv[p][0] - mv[q][0]) >= 4 || std::abs(mv[p][1] - mv[q][1]) >= 4) return 1;
    return 0;
  }

  // filter one line of samples across an edge: p[-k * step], q[k * step]
  static void filter_line(uint8_t* q0p, int step, int bs, int alpha, int beta, int tc0,
                          bool chroma) {
    uint8_t* pq = q0p;
    const int p0 = pq[-step], p1 = pq[-2 * step], q0 = pq[0], q1 = pq[step];
    if (!(std::abs(p0 - q0) < alpha && std::abs(p1 - p0) < beta && std::abs(q1 - q0) < beta))
      return;
    if (chroma) {
      if (bs < 4) {
        const int tc = tc0 + 1;
        const int delta = clip3(-tc, tc, (((q0 - p0) * 4) + (p1 - q1) + 4) >> 3);
        pq[-step] = clip_pixel(p0 + delta);
        pq[0] = clip_pixel(q0 - delta);
      } else {
        pq[-step] = static_cast<uint8_t>((2 * p1 + p0 + q1 + 2) >> 2);
        pq[0] = static_cast<uint8_t>((2 * q1 + q0 + p1 + 2) >> 2);
      }
      return;
    }
    const int p2 = pq[-3 * step], q2 = pq[2 * step];
    const int ap = std::abs(p2 - p0), aq = std::abs(q2 - q0);
    if (bs < 4) {
      const int tc = tc0 + (ap < beta) + (aq < beta);
      const int delta = clip3(-tc, tc, (((q0 - p0) * 4) + (p1 - q1) + 4) >> 3);
      pq[-step] = clip_pixel(p0 + delta);
      pq[0] = clip_pixel(q0 - delta);
      if (ap < beta) pq[-2 * step] = static_cast<uint8_t>(p1 + clip3(-tc0, tc0, (p2 + ((p0 + q0 + 1) >> 1) - (p1 * 2)) >> 1));
      if (aq < beta) pq[step] = static_cast<uint8_t>(q1 + clip3(-tc0, tc0, (q2 + ((p0 + q0 + 1) >> 1) - (q1 * 2)) >> 1));
      return;
    }
    const int p3 = pq[-4 * step], q3 = pq[3 * step];
    const bool strong = std::abs(p0 - q0) < ((alpha >> 2) + 2);
    if (ap < beta && strong) {
      pq[-step] = static_cast<uint8_t>((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3);
      pq[-2 * step] = static_cast<uint8_t>((p2 + p1 + p0 + q0 + 2) >> 2);
      pq[-3 * step] = static_cast<uint8_t>((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3);
    } else {
      pq[-step] = static_cast<uint8_t>((2 * p1 + p0 + q1 + 2) >> 2);
    }
    if (aq < beta && strong) {
      pq[0] = static_cast<uint8_t>((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3);
      pq[step] = static_cast<uint8_t>((p0 + q0 + q1 + q2 + 2) >> 2);
      pq[2 * step] = static_cast<uint8_t>((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3);
    } else {
      pq[0] = static_cast<uint8_t>((2 * q1 + q0 + p1 + 2) >> 2);
    }
  }

  void deblock() {
    for (int my = 0; my < mb_h; ++my)
      for (int mx = 0; mx < mb_w; ++mx) deblock_mb(mx, my);
  }

  void deblock_mb(int mx, int my) {
    const int addr = my * mb_w + mx;
    const SliceParams& sp = slice_params[static_cast<size_t>(mb_slice[static_cast<size_t>(addr)])];
    if (sp.deblock == 1) return;
    auto mb_qpy = [&](int a) {
      return mb_kind[static_cast<size_t>(a)] == kIPcm ? 0 : int(mb_qp[static_cast<size_t>(a)]);
    };
    const int qq = mb_qpy(addr);
    for (int dir = 0; dir < 2; ++dir) {  // 0: vertical edges, 1: horizontal
      for (int e = 0; e < 4; ++e) {
        int p_mb = addr;
        if (e == 0) {
          if (dir == 0 ? mx == 0 : my == 0) continue;
          p_mb = dir == 0 ? addr - 1 : addr - mb_w;
          if (sp.deblock == 2 && mb_slice[static_cast<size_t>(p_mb)] != mb_slice[static_cast<size_t>(addr)])
            continue;
        }
        int bs[4];
        bool any = false;
        for (int k = 0; k < 4; ++k) {
          const int qx = dir == 0 ? e : k, qy = dir == 0 ? k : e;
          const size_t q = blk(mx, my, qx, qy);
          const size_t p = dir == 0 ? q - 1 : q - static_cast<size_t>(w4);
          bs[k] = strength(p_mb, addr, p, q, e == 0);
          any |= bs[k] != 0;
        }
        if (!any) continue;
        const int qp_p = mb_qpy(p_mb);
        // luma
        {
          const int qav = (qp_p + qq + 1) >> 1;
          const int ia = clip3(0, 51, qav + sp.alpha), ib = clip3(0, 51, qav + sp.beta);
          const int alpha = kAlpha[ia], beta = kBeta[ib];
          uint8_t* base = cur->px[0].data() + static_cast<size_t>(my * 16) * coded_w + mx * 16;
          for (int i = 0; i < 16; ++i) {
            const int b = bs[i >> 2];
            if (!b) continue;
            const int tc0 = b < 4 ? kTc0[ia][b - 1] : 0;
            uint8_t* q0 = dir == 0 ? base + i * coded_w + e * 4 : base + (e * 4) * coded_w + i;
            filter_line(q0, dir == 0 ? 1 : coded_w, b, alpha, beta, tc0, false);
          }
        }
        // chroma: edges 0 and 2 of luma are its edges 0 and 1
        if (e & 1) continue;
        const int cw = coded_w / 2;
        for (int c = 0; c < 2; ++c) {
          const int qav = (chroma_qp(qp_p, c) + chroma_qp(qq, c) + 1) >> 1;
          const int ia = clip3(0, 51, qav + sp.alpha), ib = clip3(0, 51, qav + sp.beta);
          const int alpha = kAlpha[ia], beta = kBeta[ib];
          uint8_t* base = cur->px[1 + c].data() + static_cast<size_t>(my * 8) * cw + mx * 8;
          for (int i = 0; i < 8; ++i) {
            const int b = bs[i >> 1];
            if (!b) continue;
            const int tc0 = b < 4 ? kTc0[ia][b - 1] : 0;
            uint8_t* q0 = dir == 0 ? base + i * cw + (e / 2) * 4 : base + ((e / 2) * 4) * cw + i;
            filter_line(q0, dir == 0 ? 1 : cw, b, alpha, beta, tc0, true);
          }
        }
      }
    }
  }
};

Decoder::Decoder(const uint8_t* config, size_t size) : impl_(new Impl(config, size)) {}
Decoder::~Decoder() = default;

bool Decoder::decode(const uint8_t* data, size_t size) {
  Impl& d = *impl_;
  if (d.probing) fail("a decoder that probes does not decode");
  if (!size) fail("an empty sample");
  d.sample(data, size);
  if (!d.in_picture) return false;
  d.finish_picture();
  return true;
}

bool Decoder::probe(const uint8_t* data, size_t size) {
  Impl& d = *impl_;
  if (!d.probing && (d.shown || d.in_picture)) fail("a decoder that decodes does not probe");
  d.probing = true;
  if (!size) fail("an empty sample");
  d.sample(data, size);
  if (!d.in_picture) return false;
  d.finish_picture();
  return true;
}

int Decoder::width() const { return impl_->out_w; }
int Decoder::height() const { return impl_->out_h; }
const uint8_t* Decoder::plane(int c) const {
  const Impl& d = *impl_;
  if (!d.shown) return nullptr;
  const int s = c ? d.coded_w / 2 : d.coded_w;
  const int x = c ? d.out_x / 2 : d.out_x, y = c ? d.out_y / 2 : d.out_y;
  return d.shown->px[c].data() + static_cast<size_t>(y) * s + x;
}
int Decoder::stride(int c) const { return c ? impl_->coded_w / 2 : impl_->coded_w; }
uint64_t Decoder::features() const { return impl_->feats; }
int Decoder::matrix() const { return impl_->matrix; }
bool Decoder::full_range() const { return impl_->full_range; }
uint32_t Decoder::num_units_in_tick() const { return impl_->tick; }
uint32_t Decoder::time_scale() const { return impl_->scale; }

}  // namespace vd_h264
