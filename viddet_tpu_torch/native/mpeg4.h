// MPEG-4 Part 2 (ISO/IEC 14496-2) pieces that the port's decoder
// (codec.cpp) and encoder (mpeg4enc.cpp) share, so that the encoder's
// reconstruction loop is the decoder's arithmetic and cannot drift from
// it: the standard's prefix-code tables (the encoder builds its code
// tables from them), the escapes' run / level limits, the DC scaler,
// libavcodec's 8-bit simple_idct, the macroblock-aligned planes, and the
// half-sample motion compensation with its edge rule.  The decoder alone
// uses libavcodec's XviD IDCT and the quarter-sample motion compensation
// (McRules), which the encoder never writes.
#pragma once

#include <algorithm>
#include <array>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

namespace vd_mpeg4 {

// H.263 Table 8 (I-VOPs): cbpc 0-3, with dquant 4-7, stuffing 8.
inline constexpr uint16_t kIntraMcbpc[9][2] = {{1, 1}, {1, 3}, {2, 3}, {3, 3}, {1, 4},
                                    {1, 6}, {2, 6}, {3, 6}, {1, 9}};
// H.263 Table 7 (P-VOPs), symbols: chroma cbp in bits 0-1, intra 4,
// dquant 8, four vectors 16; stuffing 20.
inline constexpr uint16_t kInterMcbpc[21][2] = {
    {1, 1}, {3, 4}, {2, 4}, {5, 6},  // inter
    {3, 5}, {4, 8}, {3, 8}, {3, 7},  // intra
    {3, 3}, {7, 7}, {6, 7}, {5, 9},  // inter + dquant
    {4, 6}, {4, 9}, {3, 9}, {2, 9},  // intra + dquant
    {2, 3}, {5, 7}, {4, 7}, {5, 8},  // inter, four vectors
    {1, 9}};                         // stuffing
// H.263 Table 13, by the intra CBPY value (an inter MB's is inverted).
inline constexpr uint16_t kCbpy[16][2] = {{3, 4}, {5, 5}, {4, 5},  {9, 4},  {3, 5}, {7, 4},
                                          {2, 6}, {11, 4}, {2, 5}, {3, 6},  {5, 4}, {10, 4},
                                          {4, 4}, {8, 4}, {6, 4},  {3, 2}};
// H.263 Table 14: |motion vector difference code| 0..32, a sign bit after.
inline constexpr uint16_t kMvd[33][2] = {
    {1, 1},  {1, 2},  {1, 3},  {1, 4},  {3, 6},  {5, 7},  {4, 7},  {3, 7},  {11, 9},
    {10, 9}, {9, 9},  {17, 10}, {16, 10}, {15, 10}, {14, 10}, {13, 10}, {12, 10}, {11, 10},
    {10, 10}, {9, 10}, {8, 10}, {7, 10}, {6, 10}, {5, 10}, {4, 10}, {7, 11}, {6, 11},
    {5, 11}, {4, 11}, {3, 11}, {2, 11}, {3, 12}, {2, 12}};
// 14496-2 Tables B-13 / B-14: dct_dc_size_luminance / _chrominance 0..12.
inline constexpr uint16_t kDcLum[13][2] = {{3, 3}, {3, 2}, {2, 2}, {2, 3}, {1, 3}, {1, 4}, {1, 5},
                                {1, 6}, {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}};
inline constexpr uint16_t kDcChrom[13][2] = {{3, 2}, {2, 2}, {1, 2}, {1, 3}, {1, 4}, {1, 5}, {1, 6},
                                  {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}, {1, 12}};

// TCOEF: 102 (last, run, level) codes, then the escape; the intra table's
// codes from 67 on and the inter table's from 58 on have last = 1.
// 14496-2 Table B-17 (H.263 Table 16): inter blocks.
inline constexpr uint16_t kInterTcoef[103][2] = {
    {0x2, 2},   {0xf, 4},   {0x15, 6},  {0x17, 7},  {0x1f, 8},  {0x25, 9},  {0x24, 9},
    {0x21, 10}, {0x20, 10}, {0x7, 11},  {0x6, 11},  {0x20, 11}, {0x6, 3},   {0x14, 6},
    {0x1e, 8},  {0xf, 10},  {0x21, 11}, {0x50, 12}, {0xe, 4},   {0x1d, 8},  {0xe, 10},
    {0x51, 12}, {0xd, 5},   {0x23, 9},  {0xd, 10},  {0xc, 5},   {0x22, 9},  {0x52, 12},
    {0xb, 5},   {0xc, 10},  {0x53, 12}, {0x13, 6},  {0xb, 10},  {0x54, 12}, {0x12, 6},
    {0xa, 10},  {0x11, 6},  {0x9, 10},  {0x10, 6},  {0x8, 10},  {0x16, 7},  {0x55, 12},
    {0x15, 7},  {0x14, 7},  {0x1c, 8},  {0x1b, 8},  {0x21, 9},  {0x20, 9},  {0x1f, 9},
    {0x1e, 9},  {0x1d, 9},  {0x1c, 9},  {0x1b, 9},  {0x1a, 9},  {0x22, 11}, {0x23, 11},
    {0x56, 12}, {0x57, 12}, {0x7, 4},   {0x19, 9},  {0x5, 11},  {0xf, 6},   {0x4, 11},
    {0xe, 6},   {0xd, 6},   {0xc, 6},   {0x13, 7},  {0x12, 7},  {0x11, 7},  {0x10, 7},
    {0x1a, 8},  {0x19, 8},  {0x18, 8},  {0x17, 8},  {0x16, 8},  {0x15, 8},  {0x14, 8},
    {0x13, 8},  {0x18, 9},  {0x17, 9},  {0x16, 9},  {0x15, 9},  {0x14, 9},  {0x13, 9},
    {0x12, 9},  {0x11, 9},  {0x7, 10},  {0x6, 10},  {0x5, 10},  {0x4, 10},  {0x24, 11},
    {0x25, 11}, {0x26, 11}, {0x27, 11}, {0x58, 12}, {0x59, 12}, {0x5a, 12}, {0x5b, 12},
    {0x5c, 12}, {0x5d, 12}, {0x5e, 12}, {0x5f, 12}, {0x3, 7}};
inline constexpr int8_t kInterRun[102] = {
    0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  1,  1,  1,  1,  1,  1,  2,  2,  2,
    2,  3,  3,  3,  4,  4,  4,  5,  5,  5,  6,  6,  6,  7,  7,  8,  8,  9,  9,  10, 10,
    11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 0,  0,  0,  1,  1,
    2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22,
    23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40};
inline constexpr int8_t kInterLevel[102] = {
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 1, 2, 3, 4, 5, 6, 1, 2, 3, 4, 1, 2, 3, 1,
    2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 2, 3, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};
// 14496-2 Table B-16: intra blocks.
inline constexpr uint16_t kIntraTcoef[103][2] = {
    {0x2, 2},   {0x6, 3},   {0xf, 4},   {0xd, 5},   {0xc, 5},   {0x15, 6},  {0x13, 6},
    {0x12, 6},  {0x17, 7},  {0x1f, 8},  {0x1e, 8},  {0x1d, 8},  {0x25, 9},  {0x24, 9},
    {0x23, 9},  {0x21, 9},  {0x21, 10}, {0x20, 10}, {0xf, 10},  {0xe, 10},  {0x7, 11},
    {0x6, 11},  {0x20, 11}, {0x21, 11}, {0x50, 12}, {0x51, 12}, {0x52, 12}, {0xe, 4},
    {0x14, 6},  {0x16, 7},  {0x1c, 8},  {0x20, 9},  {0x1f, 9},  {0xd, 10},  {0x22, 11},
    {0x53, 12}, {0x55, 12}, {0xb, 5},   {0x15, 7},  {0x1e, 9},  {0xc, 10},  {0x56, 12},
    {0x11, 6},  {0x1b, 8},  {0x1d, 9},  {0xb, 10},  {0x10, 6},  {0x22, 9},  {0xa, 10},
    {0xd, 6},   {0x1c, 9},  {0x8, 10},  {0x12, 7},  {0x1b, 9},  {0x54, 12}, {0x14, 7},
    {0x1a, 9},  {0x57, 12}, {0x19, 8},  {0x9, 10},  {0x18, 8},  {0x23, 11}, {0x17, 8},
    {0x19, 9},  {0x18, 9},  {0x7, 10},  {0x58, 12}, {0x7, 4},   {0xc, 6},   {0x16, 8},
    {0x17, 9},  {0x6, 10},  {0x5, 11},  {0x4, 11},  {0x59, 12}, {0xf, 6},   {0x16, 9},
    {0x5, 10},  {0xe, 6},   {0x4, 10},  {0x11, 7},  {0x24, 11}, {0x10, 7},  {0x25, 11},
    {0x13, 7},  {0x5a, 12}, {0x15, 8},  {0x5b, 12}, {0x14, 8},  {0x13, 8},  {0x1a, 8},
    {0x15, 9},  {0x14, 9},  {0x13, 9},  {0x12, 9},  {0x11, 9},  {0x26, 11}, {0x27, 11},
    {0x5c, 12}, {0x5d, 12}, {0x5e, 12}, {0x5f, 12}, {0x3, 7}};
inline constexpr int8_t kIntraRun[102] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  0,  0,  0,
    0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 3, 3,  3,  3,  4,  4,  4,  5,  5,  5,
    6, 6, 6, 7, 7, 7, 8, 8, 9, 9, 10, 11, 12, 13, 14, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1,
    2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20};
inline constexpr int8_t kIntraLevel[102] = {
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26,
    27, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 1, 2, 3, 4, 5, 1, 2, 3, 4, 1, 2, 3, 1, 2, 3,
    1, 2, 3, 1, 2, 3, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 2, 3, 4, 5, 6, 7, 8, 1, 2, 3,
    1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};
inline constexpr int kEscape = 102;
inline constexpr int kLastFrom[2] = {67, 58};  // intra, inter

inline constexpr uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33, 40, 48,
    41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23,
    30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
inline constexpr uint8_t kAltHorizontal[64] = {
    0,  1,  2,  3,  8,  9,  16, 17, 10, 11, 4,  5,  6,  7,  15, 14, 13, 12, 19, 18, 24, 25,
    32, 33, 26, 27, 20, 21, 22, 23, 28, 29, 30, 31, 34, 35, 40, 41, 48, 49, 42, 43, 36, 37,
    38, 39, 44, 45, 46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54, 55, 60, 61, 62, 63};
inline constexpr uint8_t kAltVertical[64] = {
    0,  8,  16, 24, 1,  9,  2,  10, 17, 25, 32, 40, 48, 56, 57, 49, 41, 33, 26, 18, 3,  11,
    4,  12, 19, 27, 34, 42, 50, 58, 35, 43, 51, 59, 20, 28, 5,  13, 6,  14, 21, 29, 36, 44,
    52, 60, 37, 45, 53, 61, 22, 30, 7,  15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63};

// Per table (intra 0, inter 1) and last: the largest level of each run and
// the longest run of each level, which the first and second escapes add.
struct RunLevelLimits {
  int8_t max_level[2][2][64] = {}, max_run[2][2][64] = {};
  RunLevelLimits() {
    const int8_t* runs[2] = {kIntraRun, kInterRun};
    const int8_t* levels[2] = {kIntraLevel, kInterLevel};
    for (int t = 0; t < 2; ++t)
      for (int i = 0; i < kEscape; ++i) {
        const int last = i >= kLastFrom[t], run = runs[t][i], level = levels[t][i];
        max_level[t][last][run] = std::max<int8_t>(max_level[t][last][run], level);
        max_run[t][last][level] = std::max<int8_t>(max_run[t][last][level], run);
      }
  }
};

// The DC scaler of block n (0-3 luma, 4-5 chroma) at quantiser q.
inline int dc_scale(int q, int n) {
  if (n < 4) return q < 5 ? 8 : q < 9 ? 2 * q : q < 25 ? q + 8 : 2 * q - 16;
  return q < 5 ? 8 : q < 25 ? (q + 13) / 2 : q - 6;
}

// libavcodec's simple_idct for 8-bit output (simple_idct_template.c).
inline constexpr int kW1 = 22725, kW2 = 21407, kW3 = 19266, kW4 = 16383, kW5 = 12873, kW6 = 8867,
              kW7 = 4520;
inline constexpr int kRowShift = 11, kColShift = 20;

inline void simple_idct_row(int16_t* row) {
  bool ac = false;
  for (int i = 1; i < 8; ++i) ac |= row[i] != 0;
  if (!ac) {  // DC only: every output is row[0] << 3, kept to 16 bits
    const int16_t v = static_cast<int16_t>(static_cast<uint16_t>(row[0] * 8));
    for (int i = 0; i < 8; ++i) row[i] = v;
    return;
  }
  int a0 = kW4 * row[0] + (1 << (kRowShift - 1)), a1 = a0, a2 = a0, a3 = a0;
  a0 += kW2 * row[2];
  a1 += kW6 * row[2];
  a2 -= kW6 * row[2];
  a3 -= kW2 * row[2];
  int b0 = kW1 * row[1] + kW3 * row[3];
  int b1 = kW3 * row[1] - kW7 * row[3];
  int b2 = kW5 * row[1] - kW1 * row[3];
  int b3 = kW7 * row[1] - kW5 * row[3];
  a0 += kW4 * row[4] + kW6 * row[6];
  a1 += -kW4 * row[4] - kW2 * row[6];
  a2 += -kW4 * row[4] + kW2 * row[6];
  a3 += kW4 * row[4] - kW6 * row[6];
  b0 += kW5 * row[5] + kW7 * row[7];
  b1 += -kW1 * row[5] - kW5 * row[7];
  b2 += kW7 * row[5] + kW3 * row[7];
  b3 += kW3 * row[5] - kW1 * row[7];
  row[0] = static_cast<int16_t>((a0 + b0) >> kRowShift);
  row[7] = static_cast<int16_t>((a0 - b0) >> kRowShift);
  row[1] = static_cast<int16_t>((a1 + b1) >> kRowShift);
  row[6] = static_cast<int16_t>((a1 - b1) >> kRowShift);
  row[2] = static_cast<int16_t>((a2 + b2) >> kRowShift);
  row[5] = static_cast<int16_t>((a2 - b2) >> kRowShift);
  row[3] = static_cast<int16_t>((a3 + b3) >> kRowShift);
  row[4] = static_cast<int16_t>((a3 - b3) >> kRowShift);
}

// The column pass: out[k] for k = 0..7 down column `col`.
inline void simple_idct_col(const int16_t* col, int out[8]) {
  int a0 = kW4 * (col[0] + ((1 << (kColShift - 1)) / kW4)), a1 = a0, a2 = a0, a3 = a0;
  a0 += kW2 * col[16];
  a1 += kW6 * col[16];
  a2 -= kW6 * col[16];
  a3 -= kW2 * col[16];
  int b0 = kW1 * col[8] + kW3 * col[24];
  int b1 = kW3 * col[8] - kW7 * col[24];
  int b2 = kW5 * col[8] - kW1 * col[24];
  int b3 = kW7 * col[8] - kW5 * col[24];
  a0 += kW4 * col[32];
  a1 -= kW4 * col[32];
  a2 -= kW4 * col[32];
  a3 += kW4 * col[32];
  b0 += kW5 * col[40];
  b1 -= kW1 * col[40];
  b2 += kW7 * col[40];
  b3 += kW3 * col[40];
  a0 += kW6 * col[48];
  a1 -= kW2 * col[48];
  a2 += kW2 * col[48];
  a3 -= kW6 * col[48];
  b0 += kW7 * col[56];
  b1 -= kW5 * col[56];
  b2 += kW3 * col[56];
  b3 -= kW1 * col[56];
  out[0] = (a0 + b0) >> kColShift;
  out[1] = (a1 + b1) >> kColShift;
  out[2] = (a2 + b2) >> kColShift;
  out[3] = (a3 + b3) >> kColShift;
  out[4] = (a3 - b3) >> kColShift;
  out[5] = (a2 - b2) >> kColShift;
  out[6] = (a1 - b1) >> kColShift;
  out[7] = (a0 - b0) >> kColShift;
}

inline uint8_t clip_pixel(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }

// IDCT of `block` (natural order), then written (add = false) or added to
// the prediction in `dst` (add = true), clipped to 0..255.
inline void simple_idct(int16_t* block, uint8_t* dst, ptrdiff_t stride, bool add) {
  for (int r = 0; r < 8; ++r) simple_idct_row(block + 8 * r);
  int out[8];
  for (int c = 0; c < 8; ++c) {
    simple_idct_col(block + c, out);
    for (int k = 0; k < 8; ++k) {
      uint8_t& d = dst[k * stride + c];
      d = clip_pixel(add ? d + out[k] : out[k]);
    }
  }
}

// libavcodec's XviD IDCT (xvididct.c, the C form of its SSE2 code, which
// x86 runs): rows with per-row tables and rounders into 11 fractional
// bits, columns through tangents at 16 bits (pmulhw's floor) and a shift
// of 6.  Its DC-only and zero-row shortcuts equal the general formulas,
// so they are not taken apart here; rows 1 and 2 of zeros still come out
// as 1s (their rounders), as there.
inline constexpr int kXvidTab[4][7] = {{22725, 21407, 19266, 16384, 12873, 8867, 4520},
                                       {31521, 29692, 26722, 22725, 17855, 12299, 6270},
                                       {29692, 27969, 25172, 21407, 16819, 11585, 5906},
                                       {26722, 25172, 22654, 19266, 15137, 10426, 5315}};
inline constexpr int kXvidRowTab[8] = {0, 1, 2, 3, 0, 3, 2, 1};
inline constexpr int kXvidRowRnd[8] = {65536, 3597, 2260, 1203, 0, 120, 512, 512};

inline int16_t saturate16(int v) {  // packssdw
  return static_cast<int16_t>(v < -32768 ? -32768 : v > 32767 ? 32767 : v);
}

inline void xvid_idct_row(int16_t* in, const int* c, int rnd) {
  const int k = c[3] * in[0] + rnd;
  const int a0 = k + c[1] * in[2] + c[3] * in[4] + c[5] * in[6];
  const int a1 = k + c[5] * in[2] - c[3] * in[4] - c[1] * in[6];
  const int a2 = k - c[5] * in[2] - c[3] * in[4] + c[1] * in[6];
  const int a3 = k - c[1] * in[2] + c[3] * in[4] - c[5] * in[6];
  const int b0 = c[0] * in[1] + c[2] * in[3] + c[4] * in[5] + c[6] * in[7];
  const int b1 = c[2] * in[1] - c[6] * in[3] - c[0] * in[5] - c[4] * in[7];
  const int b2 = c[4] * in[1] - c[0] * in[3] + c[6] * in[5] + c[2] * in[7];
  const int b3 = c[6] * in[1] - c[4] * in[3] + c[2] * in[5] - c[0] * in[7];
  in[0] = saturate16((a0 + b0) >> 11);
  in[1] = saturate16((a1 + b1) >> 11);
  in[2] = saturate16((a2 + b2) >> 11);
  in[3] = saturate16((a3 + b3) >> 11);
  in[4] = saturate16((a3 - b3) >> 11);
  in[5] = saturate16((a2 - b2) >> 11);
  in[6] = saturate16((a1 - b1) >> 11);
  in[7] = saturate16((a0 - b0) >> 11);
}

// (c * x) >> 16 in 32 bits, as xvididct.c's MULT
inline int xvid_mult(int c, int x) {
  return static_cast<int>(static_cast<uint32_t>(c) * static_cast<uint32_t>(x)) >> 16;
}

inline void xvid_idct_col(const int16_t* in, int out[8]) {
  constexpr int kTan1 = 0x32EC, kTan2 = 0x6A0A, kTan3 = 0xAB0E, kSqrt2 = 0x5A82;
  // odd part
  int m0 = xvid_mult(kTan1, in[56]) + in[8];
  int m1 = xvid_mult(kTan1, in[8]) - in[56];
  int m2 = xvid_mult(kTan3, in[40]) + in[24];
  int m3 = xvid_mult(kTan3, in[24]) - in[40];
  const int m7 = m0 + m2, m4 = m1 - m3;
  m0 -= m2;
  m1 += m3;
  const int m6 = 2 * xvid_mult(kSqrt2, m0 + m1), m5 = 2 * xvid_mult(kSqrt2, m0 - m1);
  // even part
  const int e3 = xvid_mult(kTan2, in[48]) + in[16], e2 = xvid_mult(kTan2, in[16]) - in[48];
  const int e0 = in[0] + in[32], e1 = in[0] - in[32];
  const int t0 = e0 + e3, t3 = e0 - e3, t1 = e1 + e2, t2 = e1 - e2;
  out[0] = static_cast<int16_t>((t0 + m7) >> 6);
  out[7] = static_cast<int16_t>((t0 - m7) >> 6);
  out[3] = static_cast<int16_t>((t3 + m4) >> 6);
  out[4] = static_cast<int16_t>((t3 - m4) >> 6);
  out[1] = static_cast<int16_t>((t1 + m6) >> 6);
  out[6] = static_cast<int16_t>((t1 - m6) >> 6);
  out[2] = static_cast<int16_t>((t2 + m5) >> 6);
  out[5] = static_cast<int16_t>((t2 - m5) >> 6);
}

// The XviD IDCT of `block` (natural order), written or added to `dst` as
// simple_idct does it.
inline void xvid_idct(int16_t* block, uint8_t* dst, ptrdiff_t stride, bool add) {
  for (int r = 0; r < 8; ++r) xvid_idct_row(block + 8 * r, kXvidTab[kXvidRowTab[r]], kXvidRowRnd[r]);
  int out[8];
  for (int c = 0; c < 8; ++c) {
    xvid_idct_col(block + c, out);
    for (int k = 0; k < 8; ++k) {
      uint8_t& d = dst[k * stride + c];
      d = clip_pixel(add ? d + out[k] : out[k]);
    }
  }
}

// One 8-bit plane with a stride of whole macroblocks.
struct Plane {
  int w = 0, h = 0;  // the allocated (macroblock-aligned) size
  std::vector<uint8_t> px;
  void reset(int width, int height) {
    w = width;
    h = height;
    px.assign(static_cast<size_t>(w) * h, 0);
  }
  uint8_t* at(int x, int y) { return px.data() + static_cast<size_t>(y) * w + x; }
};

struct Picture {
  Plane y, u, v;
};

// The width x height picture of `p` into planes y (width x height), u and
// v ((width / 2) x (height / 2)).
inline void copy_planes(const Picture& p, int width, int height, uint8_t* y, uint8_t* u,
                        uint8_t* v) {
  for (int r = 0; r < height; ++r)
    std::memcpy(y + static_cast<size_t>(r) * width,
                p.y.px.data() + static_cast<size_t>(r) * p.y.w, width);
  const int cw = width / 2;
  for (int r = 0; r < height / 2; ++r) {
    std::memcpy(u + static_cast<size_t>(r) * cw, p.u.px.data() + static_cast<size_t>(r) * p.u.w,
                cw);
    std::memcpy(v + static_cast<size_t>(r) * cw, p.v.px.data() + static_cast<size_t>(r) * p.v.w,
                cw);
  }
}

// The median of three, as H.263's vector prediction takes it.
inline int mid(int a, int b, int c) { return std::max(std::min(a, b), std::min(std::max(a, b), c)); }

// The half-sample average of a w x h block at integer (x, y) + (fx, fy)
// half samples of `src`, whose samples outside [0, ew) x [0, eh) repeat
// the edge: (a + b + 1 - rounding) >> 1 and (a + b + c + d + 2 -
// rounding) >> 2, rounding being the P-VOP's vop_rounding_type (0 in a
// B-VOP).  Except as libavcodec's x86 hpeldsp computes it when not asked
// for bit exactness: an 8-wide block (a 4MV luma block, chroma) under
// rounding 1 with a half sample in one direction takes pavgb of b and
// a - 1 (saturated), a being the left sample, or the sample of the odd
// row; that is (a + b) >> 1 except where a is 0.  With `avg` (a B-VOP's
// backward half of an average) the prediction is averaged into `dst`,
// (d + p + 1) >> 1.
inline void average(uint8_t* dst, ptrdiff_t ds, const Plane& src, int ew, int eh, int x,
                    int y, int fx, int fy, int w, int h, int rnd, bool avg) {
  const int bw = w + fx, bh = h + fy;
  const uint8_t* base;
  ptrdiff_t bs;
  uint8_t buf[17 * 17];
  if (x >= 0 && y >= 0 && x + bw <= ew && y + bh <= eh) {  // inside: read the plane
    base = src.px.data() + static_cast<size_t>(y) * src.w + x;
    bs = src.w;
  } else {  // the samples outside repeat the edge
    for (int r = 0; r < bh; ++r) {
      const int sy = std::min(std::max(y + r, 0), eh - 1);
      const uint8_t* row = src.px.data() + static_cast<size_t>(sy) * src.w;
      for (int c = 0; c < bw; ++c) buf[r * 17 + c] = row[std::min(std::max(x + c, 0), ew - 1)];
    }
    base = buf;
    bs = 17;
  }
  const bool pavgb = rnd && w == 8 && fx != fy;
  const ptrdiff_t step = fx ? 1 : bs;  // the second sample of a one-direction half sample
  for (int r = 0; r < h; ++r) {
    const uint8_t* p = base + r * bs;
    uint8_t* d = dst + r * ds;
    for (int c = 0; c < w; ++c, ++p) {
      int a = p[0], v;
      if (fx && fy) {
        v = (a + p[1] + p[bs] + p[bs + 1] + 2 - rnd) >> 2;
      } else if (pavgb) {
        int b = p[step];
        if (fx || (r & 1))
          a = std::max(a - 1, 0);
        else
          b = std::max(b - 1, 0);
        v = (a + b + 1) >> 1;
      } else if (fx || fy) {
        v = (a + p[step] + 1 - rnd) >> 1;
      } else {
        v = a;
      }
      d[c] = static_cast<uint8_t>(avg ? (d[c] + v + 1) >> 1 : v);
    }
  }
}

// The (n + 1) x (n + 1) samples at (x, y) of `src` that a quarter-sample
// n x n block reads, those outside [0, ew) x [0, eh) repeating the edge
// (libavcodec's emulated_edge_mc); a pointer into the plane where none is.
inline const uint8_t* qpel_source(const Plane& src, int ew, int eh, int x, int y, int n,
                                  uint8_t* buf, ptrdiff_t& stride) {
  if (x >= 0 && y >= 0 && x + n + 1 <= ew && y + n + 1 <= eh) {
    stride = src.w;
    return src.px.data() + static_cast<size_t>(y) * src.w + x;
  }
  for (int r = 0; r <= n; ++r) {
    const uint8_t* row = src.px.data() + static_cast<size_t>(std::min(std::max(y + r, 0), eh - 1)) * src.w;
    for (int c = 0; c <= n; ++c) buf[r * 17 + c] = row[std::min(std::max(x + c, 0), ew - 1)];
  }
  stride = 17;
  return buf;
}

// 14496-2's quarter-sample lowpass (7.6.2.1) as libavcodec's qpeldsp
// computes it: n outputs from the n + 1 samples s[0], s[step], ..., each of
// the 8 taps (-1, 3, -6, 20, 20, -6, 3, -1) beyond either end mirrored back
// into them, then (v + 16) >> 5, or (v + 15) >> 5 with no_rnd, clipped.
inline void qpel_lowpass(uint8_t* out, ptrdiff_t ostep, const uint8_t* s, ptrdiff_t step, int n,
                         int no_rnd) {
  int e[16 + 8];  // s[-3 .. n + 3], mirrored
  for (int j = -3; j <= n + 3; ++j) e[j + 3] = s[(j < 0 ? -1 - j : j > n ? 2 * n + 1 - j : j) * step];
  for (int i = 0; i < n; ++i) {
    const int* p = e + i + 3;
    const int v = 20 * (p[0] + p[1]) - 6 * (p[-1] + p[2]) + 3 * (p[-2] + p[3]) - (p[-3] + p[4]);
    out[i * ostep] = clip_pixel((v + 16 - no_rnd) >> 5);
  }
}

// The n x n prediction at quarter position (qx, qy) from the (n + 1)^2
// samples at `s`, as libavcodec's put[_no_rnd]_qpel{8,16}_mcXY: the
// horizontal half samples (n + 1 rows, averaged with the integer ones for
// a quarter in x), their vertical lowpass, and the average of the two
// nearest; a half position in one direction alone is that lowpass. Every
// average is (a + b + 1 - no_rnd) >> 1.  `old` gives the _old_c forms
// libavcodec keeps for its own early encoders (FF_BUG_STD_QPEL): at a
// quarter in both directions, or a quarter in x and a half in y, the
// vertical half samples of the integer ones join the average, (a + b + c +
// d + 2 - no_rnd) >> 2.
inline void qpel_predict(uint8_t* dst, ptrdiff_t ds, const uint8_t* s, ptrdiff_t ss, int n,
                         int qx, int qy, int no_rnd, bool old) {
  uint8_t h[17 * 17], hv[16 * 16], vv[16 * 16];
  auto avg2 = [&](int a, int b) { return static_cast<uint8_t>((a + b + 1 - no_rnd) >> 1); };
  auto vertical = [&](uint8_t* out, ptrdiff_t os, const uint8_t* in, ptrdiff_t is) {
    for (int c = 0; c < n; ++c) qpel_lowpass(out + c, os, in + c, is, n, no_rnd);
  };
  auto horizontal = [&](uint8_t* out, ptrdiff_t os, int rows) {
    for (int r = 0; r < rows; ++r) qpel_lowpass(out + r * os, 1, s + r * ss, 1, n, no_rnd);
  };
  if (!qy) {
    if (!qx) {
      for (int r = 0; r < n; ++r) std::memcpy(dst + r * ds, s + r * ss, n);
      return;
    }
    horizontal(h, 17, n);
    for (int r = 0; r < n; ++r)
      for (int c = 0; c < n; ++c)
        dst[r * ds + c] = qx == 2 ? h[r * 17 + c] : avg2(h[r * 17 + c], s[r * ss + c + (qx == 3)]);
    return;
  }
  if (!qx) {
    vertical(vv, 16, s, ss);
    for (int r = 0; r < n; ++r)
      for (int c = 0; c < n; ++c)
        dst[r * ds + c] = qy == 2 ? vv[r * 16 + c] : avg2(vv[r * 16 + c], s[(r + (qy == 3)) * ss + c]);
    return;
  }
  horizontal(h, 17, n + 1);
  if (old && qx != 2) {  // the _old_c forms: 11, 31, 13, 33, 12, 32
    const int dx = qx == 3;
    vertical(vv, 16, s + dx, ss);
    vertical(hv, 16, h, 17);
    for (int r = 0; r < n; ++r)
      for (int c = 0; c < n; ++c) {
        uint8_t& d = dst[r * ds + c];
        if (qy == 2) {
          d = avg2(vv[r * 16 + c], hv[r * 16 + c]);
        } else {
          const int dy = qy == 3;
          d = static_cast<uint8_t>((s[(r + dy) * ss + c + dx] + h[(r + dy) * 17 + c] + vv[r * 16 + c] +
                                    hv[r * 16 + c] + 2 - no_rnd) >> 2);
        }
      }
    return;
  }
  if (qx != 2)  // the horizontal quarter samples, n + 1 rows
    for (int r = 0; r <= n; ++r)
      for (int c = 0; c < n; ++c) h[r * 17 + c] = avg2(h[r * 17 + c], s[r * ss + c + (qx == 3)]);
  if (qy == 2) {
    vertical(dst, ds, h, 17);
    return;
  }
  vertical(hv, 16, h, 17);
  for (int r = 0; r < n; ++r)
    for (int c = 0; c < n; ++c)
      dst[r * ds + c] = avg2(h[(r + (qy == 3)) * 17 + c], hv[r * 16 + c]);
}

// A quarter-sample n x n block at integer (x, y) + (qx, qy) quarters of
// `src` into `dst`, or averaged into it with `avg`: (d + p + 1) >> 1.
inline void qpel_block(uint8_t* dst, ptrdiff_t ds, const Plane& src, int ew, int eh, int x, int y,
                       int qx, int qy, int n, int rnd, bool avg, bool old) {
  uint8_t buf[17 * 17], pred[16 * 16];
  ptrdiff_t ss;
  const uint8_t* s = qpel_source(src, ew, eh, x, y, n, buf, ss);
  if (!avg) {
    qpel_predict(dst, ds, s, ss, n, qx, qy, rnd, old);
    return;
  }
  qpel_predict(pred, 16, s, ss, n, qx, qy, rnd, old);
  for (int r = 0; r < n; ++r)
    for (int c = 0; c < n; ++c) dst[r * ds + c] = static_cast<uint8_t>((dst[r * ds + c] + pred[r * 16 + c] + 1) >> 1);
}

// How a stream's motion compensation reads a reference picture: its edge
// (libavcodec's h_edge_pos / v_edge_pos: the macroblock-aligned size, or
// the picture's own under FF_BUG_EDGE), and for quarter-sample vectors the
// chroma rule (0 the standard's, 1 FF_BUG_QPEL_CHROMA, 2
// FF_BUG_QPEL_CHROMA2) and the old luma forms (FF_BUG_STD_QPEL).
struct McRules {
  int ew = 0, eh = 0;
  bool qpel = false;
  int qpel_chroma = 0;
  bool old_qpel = false;
};

// Macroblock (mb_x, mb_y) of `cur` predicted from `src` by one vector or
// four (libavcodec's mpeg_motion / qpel_motion, hpel_motion / the quarter
// form of its apply_8x8, and chroma_4mv_motion), in a picture of width x
// height.  A one-vector macroblock's chroma repeats the edge only where
// its luma block did (libavcodec decides both on the luma vector) and else
// reads the plane as it lies, past the edge of FF_BUG_EDGE too.
inline void motion(Picture& cur, const Picture& src, int mb_x, int mb_y, int width, int height,
                   const McRules& rules, const std::array<int16_t, 2>* v, bool four, int rnd,
                   bool avg) {
  uint8_t* dy = cur.y.at(mb_x * 16, mb_y * 16);
  const ptrdiff_t ys = cur.y.w, cs = cur.u.w;
  uint8_t* du = cur.u.at(mb_x * 8, mb_y * 8);
  uint8_t* dv = cur.v.at(mb_x * 8, mb_y * 8);
  const int ew = rules.ew, eh = rules.eh;
  auto beyond = [](int at, int limit) {
    return static_cast<unsigned>(at) >= static_cast<unsigned>(std::max(limit, 0));
  };
  int cmx, cmy;  // chroma vector, half samples
  if (!four) {
    const int mx = v[0][0], my = v[0][1];
    int sx, sy, cx, cy;
    bool emu;
    if (rules.qpel) {
      sx = mb_x * 16 + (mx >> 2);
      sy = mb_y * 16 + (my >> 2);
      qpel_block(dy, ys, src.y, ew, eh, sx, sy, mx & 3, my & 3, 16, rnd, avg, rules.old_qpel);
      emu = beyond(sx, ew - (mx & 3) - 15) || beyond(sy, eh - (my & 3) - 15);
      static const int kRtab[8] = {0, 0, 1, 1, 0, 0, 0, 1};
      if (rules.qpel_chroma == 2) {
        cmx = (mx >> 1) + kRtab[mx & 7];
        cmy = (my >> 1) + kRtab[my & 7];
      } else if (rules.qpel_chroma == 1) {
        cmx = (mx >> 1) | (mx & 1);
        cmy = (my >> 1) | (my & 1);
      } else {
        cmx = mx / 2;
        cmy = my / 2;
      }
      cmx = (cmx >> 1) | (cmx & 1);
      cmy = (cmy >> 1) | (cmy & 1);
      cx = mb_x * 8 + (cmx >> 1);
      cy = mb_y * 8 + (cmy >> 1);
    } else {
      sx = mb_x * 16 + (mx >> 1);
      sy = mb_y * 16 + (my >> 1);
      average(dy, ys, src.y, ew, eh, sx, sy, mx & 1, my & 1, 16, 16, rnd, avg);
      emu = beyond(sx, ew - (mx & 1) - 15) || beyond(sy, eh - (my & 1) - 15);
      // libavcodec's mpeg_motion for H.263: the chroma position is the luma
      // one halved; a half sample where the luma vector is not a multiple of 4
      cmx = (mx & 1) | ((mx & 2) >> 1);
      cmy = (my & 1) | ((my & 2) >> 1);
      cx = sx >> 1;
      cy = sy >> 1;
    }
    const int cw = emu ? ew >> 1 : src.u.w, ch = emu ? eh >> 1 : src.u.h;
    average(du, cs, src.u, cw, ch, cx, cy, cmx & 1, cmy & 1, 8, 8, rnd, avg);
    average(dv, cs, src.v, cw, ch, cx, cy, cmx & 1, cmy & 1, 8, 8, rnd, avg);
    return;
  }
  int sumx = 0, sumy = 0;
  for (int n = 0; n < 4; ++n) {
    const int mx = v[n][0], my = v[n][1];
    uint8_t* d = dy + (n >> 1) * 8 * ys + (n & 1) * 8;
    const int shift = rules.qpel ? 2 : 1, frac = rules.qpel ? 3 : 1;
    int x = mb_x * 16 + (n & 1) * 8 + (mx >> shift), y = mb_y * 16 + (n >> 1) * 8 + (my >> shift);
    int fx = 0, fy = 0;
    x = std::min(std::max(x, -16), width);
    if (x != width) fx = mx & frac;
    y = std::min(std::max(y, -16), height);
    if (y != height) fy = my & frac;
    if (rules.qpel) {
      qpel_block(d, ys, src.y, ew, eh, x, y, fx, fy, 8, rnd, avg, rules.old_qpel);
      sumx += mx / 2;  // libavcodec's chroma of four quarter-sample vectors
      sumy += my / 2;
    } else {
      average(d, ys, src.y, ew, eh, x, y, fx, fy, 8, 8, rnd, avg);
      sumx += mx;
      sumy += my;
    }
  }
  // the H.263 chroma rounding of the four vectors' sum
  static const uint8_t kRound[16] = {0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2};
  cmx = kRound[sumx & 15] + ((sumx >> 3) & ~1);
  cmy = kRound[sumy & 15] + ((sumy >> 3) & ~1);
  int fx = cmx & 1, fy = cmy & 1;
  const int cx = std::min(std::max(mb_x * 8 + (cmx >> 1), -8), width >> 1);
  if (cx == (width >> 1)) fx = 0;
  const int cy = std::min(std::max(mb_y * 8 + (cmy >> 1), -8), height >> 1);
  if (cy == (height >> 1)) fy = 0;
  average(du, cs, src.u, ew >> 1, eh >> 1, cx, cy, fx, fy, 8, 8, rnd, avg);
  average(dv, cs, src.v, ew >> 1, eh >> 1, cx, cy, fx, fy, 8, 8, rnd, avg);
}

// Half-sample prediction with the macroblock-aligned edge of a picture of
// mb_w x mb_h macroblocks (what the encoder reconstructs).
inline void motion(Picture& cur, const Picture& src, int mb_x, int mb_y, int mb_w, int mb_h,
                   int width, int height, const std::array<int16_t, 2>* v, bool four, int rnd,
                   bool avg) {
  McRules rules;
  rules.ew = mb_w * 16;
  rules.eh = mb_h * 16;
  motion(cur, src, mb_x, mb_y, width, height, rules, v, four, rnd, avg);
}

}  // namespace vd_mpeg4
