// The port's MPEG-4 Part 2 (ISO/IEC 14496-2) Simple Profile encoder: what
// the JAX package writes through cv2.VideoWriter_fourcc("mp4v") (FFmpeg's
// mpeg4 encoder), written here with no library beyond the C++ standard one.
//
// The stream: VOS, VO and VOL headers (rectangular, 8-bit, progressive,
// H.263 quantisation, no resync markers, data partitioning or user data),
// then one VOP a frame: an I-VOP every kGop frames (OpenCV's gop_size for
// its FFmpeg writer), P-VOPs between them with vop_rounding_type 0.  Each
// P macroblock takes one vector (a full-sample search from the predicted
// and the neighbours' vectors, then half-sample refinement; f_code 1, the
// search's range) and is not coded where the vector is zero and its
// residual quantises to zero.  Intra blocks code their DC with the DC VLC
// and prediction as 14496-2 requires, and no AC prediction.  The
// quantiser is fixed (kQuant).
//
// The reconstruction is the decoder's arithmetic (mpeg4.h: the H.263
// inverse quantiser, libavcodec's simple_idct, the half-sample motion
// compensation and its edge rule over the macroblock-aligned picture), so
// what a decoder shows equals the encoder's reconstruction bit for bit.
//
// Colour: RGB -> yuv420p in BT.601 limited range (8-bit fixed point, each
// chroma sample from the mean of its 2x2 pixels); a width or height that
// is not a multiple of 16 is padded to whole macroblocks by repeating the
// edge.  The size must be even (the caller crops an odd one, as OpenCV's
// writer does).
//
// C interface, called through ctypes (which releases the GIL):
//   vd_mpeg4enc_open(width, height, fps_num, fps_den, err, err_len) -> handle
//           or null: frames of fps_num / fps_den a second (the VOL's
//           vop_time_increment_resolution is fps_num, each frame fps_den
//           ticks)
//   vd_mpeg4enc_config(handle, out, capacity) -> the VOS / VO / VOL bytes'
//           size, written to out when they fit
//   vd_mpeg4enc_encode(handle, rgb, out, capacity, &size, &key, err, err_len)
//           encodes one width x height x 3 RGB frame into one VOP: 0, or -1
//           with a message
//   vd_mpeg4enc_planes(handle, y, u, v) the reconstruction of the last
//           frame: y width x height, u and v (width / 2) x (height / 2)
//   vd_mpeg4enc_free(handle)

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdarg>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <new>
#include <string>
#include <vector>

#include "mpeg4.h"

namespace {

using namespace vd_mpeg4;

constexpr int kGop = 12;   // an I-VOP every 12 frames
constexpr int kQuant = 3;  // vop_quant of every VOP
constexpr int kRange = 15;  // the full-sample search: +-15 samples, f_code 1
constexpr int kSteps = 8;   // small-diamond steps from the best start
constexpr int kPad = 48;    // the search plane's border: range, block and half sample

struct EncodeError {
  std::string msg;
};

[[noreturn]] __attribute__((format(printf, 1, 2))) void fail(const char* fmt, ...) {
  char buf[256];
  va_list ap;
  va_start(ap, fmt);
  std::vsnprintf(buf, sizeof(buf), fmt, ap);
  va_end(ap);
  throw EncodeError{buf};
}

// Big-endian bit writer.
struct BitWriter {
  std::vector<uint8_t> out;
  uint64_t acc = 0;
  int n = 0;  // bits in acc not yet written, < 8 between calls
  void put(uint32_t v, int bits) {
    if (!bits) return;
    acc = (acc << bits) | (v & ((uint64_t(1) << bits) - 1));
    n += bits;
    while (n >= 8) {
      n -= 8;
      out.push_back(static_cast<uint8_t>(acc >> n));
    }
  }
  void code(const uint16_t (&c)[2]) { put(c[0], c[1]); }
  // next_start_code(): a 0, then 1s up to the byte boundary
  void stuffing() {
    put(0, 1);
    while (n) put(1, 1);
  }
  void start_code(uint8_t code) {
    put(0x000001, 24);
    put(code, 8);
  }
};

// The encoder's side of the TCOEF tables: the symbol of (last, run, level),
// built from mpeg4.h's prefix-code tables, -1 where there is none.
struct CodeTables : RunLevelLimits {
  int16_t symbol[2][2][64][32];  // [intra 0 / inter 1][last][run][level]
  CodeTables() {
    std::memset(symbol, 0xFF, sizeof(symbol));
    const int8_t* runs[2] = {kIntraRun, kInterRun};
    const int8_t* levels[2] = {kIntraLevel, kInterLevel};
    for (int t = 0; t < 2; ++t)
      for (int i = 0; i < kEscape; ++i)
        symbol[t][i >= kLastFrom[t]][runs[t][i]][levels[t][i]] = static_cast<int16_t>(i);
  }
  int find(int t, int last, int run, int level) const {
    return run < 64 && level < 32 ? symbol[t][last][run][level] : -1;
  }
};

const CodeTables& code_tables() {
  static const CodeTables t;
  return t;
}

// The forward DCT: libjpeg's jfdctflt.c (Arai, Agui and Nakajima's
// algorithm in float), its outputs rescaled to the orthonormal DCT's,
// whose DC is 8 times the block's mean, the scaling simple_idct inverts.
struct Dct {
  float scale[64];
  Dct() {
    static const double kAan[8] = {1.0, 1.387039845, 1.306562965, 1.175875602,
                                   1.0, 0.785694958, 0.541196100, 0.275899379};
    for (int k = 0; k < 8; ++k)
      for (int l = 0; l < 8; ++l)
        scale[k * 8 + l] = static_cast<float>(1.0 / (8 * kAan[k] * kAan[l]));
  }
  static void pass(float* d, int step) {  // one 8-point AAN DCT over d[0], d[step], ...
    const float tmp0 = d[0] + d[7 * step], tmp7 = d[0] - d[7 * step];
    const float tmp1 = d[step] + d[6 * step], tmp6 = d[step] - d[6 * step];
    const float tmp2 = d[2 * step] + d[5 * step], tmp5 = d[2 * step] - d[5 * step];
    const float tmp3 = d[3 * step] + d[4 * step], tmp4 = d[3 * step] - d[4 * step];
    float tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    d[0] = tmp10 + tmp11;
    d[4 * step] = tmp10 - tmp11;
    const float z1 = (tmp12 + tmp13) * 0.707106781f;
    d[2 * step] = tmp13 + z1;
    d[6 * step] = tmp13 - z1;
    tmp10 = tmp4 + tmp5;
    tmp11 = tmp5 + tmp6;
    tmp12 = tmp6 + tmp7;
    const float z5 = (tmp10 - tmp12) * 0.382683433f;
    const float z2 = 0.541196100f * tmp10 + z5, z4 = 1.306562965f * tmp12 + z5;
    const float z3 = tmp11 * 0.707106781f;
    const float z11 = tmp7 + z3, z13 = tmp7 - z3;
    d[5 * step] = z13 + z2;
    d[3 * step] = z13 - z2;
    d[step] = z11 + z4;
    d[7 * step] = z11 - z4;
  }
  void forward(const int* in, float* out) const {  // in, out: 64 in raster order
    for (int i = 0; i < 64; ++i) out[i] = static_cast<float>(in[i]);
    for (int r = 0; r < 8; ++r) pass(out + 8 * r, 1);
    for (int c = 0; c < 8; ++c) pass(out + c, 8);
    for (int i = 0; i < 64; ++i) out[i] *= scale[i];
  }
};

const Dct& dct() {
  static const Dct d;
  return d;
}

inline int round_int(float v) { return static_cast<int>(std::lround(v)); }

struct Encoder {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  int resolution = 1, step = 1, time_bits = 1;  // vop_time_increment_resolution, ticks a frame
  int64_t frames = 0, last_seconds = 0;
  Picture src, cur, ref;  // the frame, its reconstruction, the reference
  std::vector<uint8_t> config;
  // the decoder's prediction state (codec.cpp Mpeg4Decoder): DC predictors
  // and luma block vectors on grids with a border row above and a border
  // column on either side
  int bstride = 0, cstride = 0;
  std::vector<int16_t> dc[3];
  std::vector<std::array<int16_t, 2>> mv;
  std::vector<std::array<int16_t, 2>> last_mv;  // each macroblock's vector in the last P-VOP
  int mb_x = 0, mb_y = 0;
  // the reference's luma with a border of kPad repeated samples, for the search
  std::vector<uint8_t> search;
  int sstride = 0;
  BitWriter bits;
  const CodeTables& t = code_tables();

  Encoder(int w, int h, int fps_num, int fps_den) {
    if (w < 2 || h < 2 || (w & 1) || (h & 1) || w > 8190 || h > 8190)
      fail("cannot encode a %dx%d video: the size must be even, from 2x2 to 8190x8190", w, h);
    if (fps_num < 1 || fps_num > 65535 || fps_den < 1)
      fail("frame rate %d/%d: vop_time_increment_resolution must be 1..65535", fps_num, fps_den);
    width = w;
    height = h;
    mb_w = (w + 15) / 16;
    mb_h = (h + 15) / 16;
    resolution = fps_num;
    step = fps_den;
    while ((1 << time_bits) < resolution) ++time_bits;
    for (Picture* p : {&src, &cur, &ref}) {
      p->y.reset(mb_w * 16, mb_h * 16);
      p->u.reset(mb_w * 8, mb_h * 8);
      p->v.reset(mb_w * 8, mb_h * 8);
    }
    bstride = 2 * mb_w + 2;
    cstride = mb_w + 2;
    dc[0].assign(static_cast<size_t>(2 * mb_h + 1) * bstride, 1024);
    dc[1].assign(static_cast<size_t>(mb_h + 1) * cstride, 1024);
    dc[2].assign(static_cast<size_t>(mb_h + 1) * cstride, 1024);
    mv.assign(static_cast<size_t>(2 * mb_h + 1) * bstride, {0, 0});
    last_mv.assign(static_cast<size_t>(mb_w) * mb_h, {0, 0});
    sstride = mb_w * 16 + 2 * kPad;
    search.assign(static_cast<size_t>(sstride) * (mb_h * 16 + 2 * kPad), 0);
    write_headers();
  }

  // -- headers ----------------------------------------------------------------

  // The simple profile's level by the macroblocks a VOP holds.
  int profile_and_level() const {
    const int mbs = mb_w * mb_h;
    return mbs <= 99 ? 0x01 : mbs <= 396 ? 0x03 : mbs <= 1200 ? 0x04 : mbs <= 1620 ? 0x05 : 0x06;
  }

  void write_headers() {
    BitWriter b;
    b.start_code(0xB0);  // visual_object_sequence
    b.put(profile_and_level(), 8);
    b.start_code(0xB5);  // visual_object
    b.put(0, 1);         // is_visual_object_identifier
    b.put(1, 4);         // visual_object_type: video
    b.put(0, 1);         // video_signal_type
    b.stuffing();
    b.start_code(0x00);  // video_object 0
    b.start_code(0x20);  // video_object_layer 0
    b.put(0, 1);         // random_accessible_vol
    b.put(1, 8);         // video_object_type_indication: simple object
    b.put(0, 1);         // is_object_layer_identifier
    b.put(1, 4);         // aspect_ratio_info: square pixels
    b.put(1, 1);         // vol_control_parameters
    b.put(1, 2);         //   chroma_format 4:2:0
    b.put(1, 1);         //   low_delay: no B-VOPs
    b.put(0, 1);         //   vbv_parameters
    b.put(0, 2);         // video_object_layer_shape: rectangular
    b.put(1, 1);
    b.put(resolution, 16);  // vop_time_increment_resolution
    b.put(1, 1);
    b.put(0, 1);  // fixed_vop_rate
    b.put(1, 1);
    b.put(width, 13);
    b.put(1, 1);
    b.put(height, 13);
    b.put(1, 1);
    b.put(0, 1);  // interlaced
    b.put(1, 1);  // obmc_disable
    b.put(0, 1);  // sprite_enable
    b.put(0, 1);  // not_8_bit
    b.put(0, 1);  // quant_type: H.263
    b.put(1, 1);  // complexity_estimation_disable
    b.put(1, 1);  // resync_marker_disable
    b.put(0, 1);  // data_partitioned
    b.put(0, 1);  // scalability
    b.stuffing();
    config = b.out;
  }

  // -- colour -----------------------------------------------------------------

  // RGB -> yuv420p (BT.601, limited range) into `src`, the padding
  // repeating the last column and row.
  void convert(const uint8_t* rgb) {
    const int cw = width / 2, ch = height / 2;
    for (int y = 0; y < height; ++y) {
      const uint8_t* p = rgb + static_cast<size_t>(y) * width * 3;
      uint8_t* dy = src.y.at(0, y);
      for (int x = 0; x < width; ++x, p += 3)
        dy[x] = static_cast<uint8_t>((66 * p[0] + 129 * p[1] + 25 * p[2] + 4224) >> 8);
    }
    for (int y = 0; y < ch; ++y) {
      const uint8_t* p0 = rgb + static_cast<size_t>(2 * y) * width * 3;
      const uint8_t* p1 = p0 + static_cast<size_t>(width) * 3;
      uint8_t* du = src.u.at(0, y);
      uint8_t* dv = src.v.at(0, y);
      for (int x = 0; x < cw; ++x, p0 += 6, p1 += 6) {
        const int r = p0[0] + p0[3] + p1[0] + p1[3], g = p0[1] + p0[4] + p1[1] + p1[4],
                  b = p0[2] + p0[5] + p1[2] + p1[5];
        du[x] = clip_pixel((-38 * r - 74 * g + 112 * b + (128 << 10) + 512) >> 10);
        dv[x] = clip_pixel((112 * r - 94 * g - 18 * b + (128 << 10) + 512) >> 10);
      }
    }
    pad(src.y, width, height);
    pad(src.u, cw, ch);
    pad(src.v, cw, ch);
  }

  static void pad(Plane& p, int w, int h) {
    for (int y = 0; y < h; ++y) {
      uint8_t* row = p.at(0, y);
      std::fill(row + w, row + p.w, row[w - 1]);
    }
    for (int y = h; y < p.h; ++y) std::memcpy(p.at(0, y), p.at(0, h - 1), p.w);
  }

  // -- VOP --------------------------------------------------------------------

  bool encode(const uint8_t* rgb, std::vector<uint8_t>& out) {
    convert(rgb);
    const bool key = frames % kGop == 0;
    bits = BitWriter();
    bits.start_code(0xB6);
    bits.put(key ? 0 : 1, 2);  // vop_coding_type
    const int64_t time = frames * step, seconds = time / resolution;
    for (int64_t s = last_seconds; s < seconds; ++s) bits.put(1, 1);  // modulo_time_base
    bits.put(0, 1);
    last_seconds = seconds;
    bits.put(1, 1);
    bits.put(static_cast<uint32_t>(time % resolution), time_bits);
    bits.put(1, 1);
    bits.put(1, 1);  // vop_coded
    if (!key) bits.put(0, 1);  // vop_rounding_type
    bits.put(0, 3);            // intra_dc_vlc_thr: the DC VLC at every quantiser
    bits.put(kQuant, 5);
    if (!key) {
      bits.put(1, 3);  // vop_fcode_forward
      fill_search();
    }
    for (mb_y = 0; mb_y < mb_h; ++mb_y)
      for (mb_x = 0; mb_x < mb_w; ++mb_x) {
        if (key)
          intra_macroblock();
        else
          inter_macroblock();
      }
    bits.stuffing();
    std::swap(ref, cur);
    ++frames;
    out.swap(bits.out);
    return key;
  }

  // grid positions, as the decoder's
  size_t bpos(int n) const {
    return static_cast<size_t>(2 * mb_y + (n >> 1) + 1) * bstride + 2 * mb_x + (n & 1) + 1;
  }
  size_t cpos() const { return static_cast<size_t>(mb_y + 1) * cstride + mb_x + 1; }

  // block n (0-3 luma, 4 U, 5 V) of the current macroblock in plane set p
  static void locate(Picture& p, int n, int mx, int my, uint8_t*& at, ptrdiff_t& stride) {
    if (n < 4) {
      at = p.y.at(mx * 16 + (n & 1) * 8, my * 16 + (n >> 1) * 8);
      stride = p.y.w;
    } else {
      Plane& c = n == 4 ? p.u : p.v;
      at = c.at(mx * 8, my * 8);
      stride = c.w;
    }
  }

  // Quantise the 8x8 `coef` (raster order) from zigzag position `from`:
  // H.263's levels for qmul 2q, the nearest reconstruction kept to the
  // third escape's range.  Returns whether any level is not zero.
  static bool quantise(const float* coef, int from, int* level) {
    const int qmul = 2 * kQuant, qadd = (kQuant - 1) | 1;
    const int most = (2047 - qadd) / qmul;
    bool any = false;
    for (int i = 0; i < 64; ++i) level[i] = 0;
    for (int i = from; i < 64; ++i) {
      const int pos = kZigzag[i];
      const float a = std::fabs(coef[pos]);
      int l = static_cast<int>(a / qmul);
      if (l > most) l = most;
      if (l) {
        level[pos] = coef[pos] < 0 ? -l : l;
        any = true;
      }
    }
    return any;
  }

  // H.263 inverse quantisation of the AC levels, as the decoder does it
  static void dequantise(const int* level, int from, int16_t* block) {
    const int qmul = 2 * kQuant, qadd = (kQuant - 1) | 1;
    for (int i = from; i < 64; ++i) {
      const int pos = kZigzag[i], l = level[pos];
      if (l) block[pos] = static_cast<int16_t>(l < 0 ? l * qmul - qadd : l * qmul + qadd);
    }
  }

  // The (last, run, level) events of `level` in zigzag order from `from`.
  void coefficients(const int* level, int from, int table) {
    int last_pos = -1;
    for (int i = 63; i >= from; --i)
      if (level[kZigzag[i]]) {
        last_pos = i;
        break;
      }
    int run = 0;
    for (int i = from; i <= last_pos; ++i) {
      const int l = level[kZigzag[i]];
      if (!l) {
        ++run;
        continue;
      }
      event(table, i == last_pos, run, l);
      run = 0;
    }
  }

  // One TCOEF event: its code, else the first, second or third escape.
  void event(int table, bool last, int run, int level) {
    const uint16_t(*codes)[2] = table ? kInterTcoef : kIntraTcoef;
    const int a = std::abs(level), sign = level < 0;
    int s = t.find(table, last, run, a);
    if (s >= 0) {
      bits.code(codes[s]);
      bits.put(sign, 1);
      return;
    }
    const int most = t.max_level[table][last][run < 64 ? run : 63];
    if (run < 64 && most && a > most && (s = t.find(table, last, run, a - most)) >= 0) {
      bits.code(codes[kEscape]);
      bits.put(0, 1);
      bits.code(codes[s]);
      bits.put(sign, 1);
      return;
    }
    if (a < 64) {
      const int shift = run - t.max_run[table][last][a] - 1;
      if (shift >= 0 && (s = t.find(table, last, shift, a)) >= 0) {
        bits.code(codes[kEscape]);
        bits.put(2, 2);
        bits.code(codes[s]);
        bits.put(sign, 1);
        return;
      }
    }
    bits.code(codes[kEscape]);
    bits.put(3, 2);
    bits.put(last, 1);
    bits.put(run, 6);
    bits.put(1, 1);
    bits.put(static_cast<uint32_t>(level) & 0xFFF, 12);
    bits.put(1, 1);
  }

  // The decoder's ff_mpeg4_pred_dc for a VOP of one video packet: the
  // predicted DC level (store_dc keeps the scaled DC for the blocks after).
  int dc_prediction(int n, int scale) const {
    const std::vector<int16_t>& d = n < 4 ? dc[0] : dc[n - 3];
    const int stride = n < 4 ? bstride : cstride;
    const size_t at = n < 4 ? bpos(n) : cpos();
    int a = d[at - 1], bb = d[at - 1 - stride], c = d[at - stride];
    if (mb_y == 0 && n != 3) {  // the packet's first row
      if (n != 2) bb = c = 1024;
      if (n != 1 && mb_x == 0) bb = a = 1024;
    }
    if (mb_x == 0 && mb_y == 1 && (n == 0 || n == 4 || n == 5)) bb = 1024;
    const int pred = std::abs(a - bb) < std::abs(bb - c) ? c : a;
    return (pred + (scale >> 1)) / scale;
  }

  void store_dc(int n, int level, int scale) {
    std::vector<int16_t>& d = n < 4 ? dc[0] : dc[n - 3];
    int stored = level * scale;
    if (stored & ~2047) stored = stored < 0 ? 0 : 2047;
    d[n < 4 ? bpos(n) : cpos()] = static_cast<int16_t>(stored);
  }

  void intra_macroblock() {
    int level[6][64];
    int dc_level[6];
    int cbp = 0;
    for (int n = 0; n < 6; ++n) {
      uint8_t* s;
      ptrdiff_t ss;
      locate(src, n, mb_x, mb_y, s, ss);
      int px[64];
      for (int r = 0; r < 8; ++r)
        for (int c = 0; c < 8; ++c) px[r * 8 + c] = s[r * ss + c];
      float coef[64];
      dct().forward(px, coef);
      const int scale = dc_scale(kQuant, n);
      dc_level[n] = std::min(std::max(round_int(coef[0] / scale), 0), 2047 / scale);
      if (quantise(coef, 1, level[n])) cbp |= 32 >> n;
    }
    for (int i = 0; i < 4; ++i) mv[bpos(i)] = {0, 0};
    bits.code(kIntraMcbpc[cbp & 3]);
    bits.put(0, 1);  // ac_pred_flag
    bits.code(kCbpy[cbp >> 2]);
    for (int n = 0; n < 6; ++n) {
      const int scale = dc_scale(kQuant, n);
      const int diff = dc_level[n] - dc_prediction(n, scale);
      store_dc(n, dc_level[n], scale);
      const int a = std::abs(diff);
      int size = 0;
      while ((1 << size) <= a) ++size;
      bits.code(n < 4 ? kDcLum[size] : kDcChrom[size]);
      if (size) bits.put(static_cast<uint32_t>(diff > 0 ? diff : diff + (1 << size) - 1), size);
      if (size > 8) bits.put(1, 1);
      if (cbp & (32 >> n)) coefficients(level[n], 1, 0);
      int16_t block[64] = {};
      block[0] = static_cast<int16_t>(dc_level[n] * scale);
      dequantise(level[n], 1, block);
      uint8_t* d;
      ptrdiff_t ds;
      locate(cur, n, mb_x, mb_y, d, ds);
      simple_idct(block, d, ds, false);
    }
  }

  // -- P macroblocks ------------------------------------------------------------

  void fill_search() {
    const Plane& y = ref.y;
    for (int r = 0; r < y.h + 2 * kPad; ++r) {
      const int sy = std::min(std::max(r - kPad, 0), y.h - 1);
      const uint8_t* row = y.px.data() + static_cast<size_t>(sy) * y.w;
      uint8_t* out = search.data() + static_cast<size_t>(r) * sstride;
      std::memset(out, row[0], kPad);
      std::memcpy(out + kPad, row, y.w);
      std::memset(out + kPad + y.w, row[y.w - 1], kPad);
    }
  }

  // SAD of the current source macroblock against the reference at the
  // half-sample vector (vx, vy), rounding type 0; stops once past `bound`.
  int sad(int vx, int vy, int bound = 1 << 30) const {
    const int x = mb_x * 16 + (vx >> 1) + kPad, y = mb_y * 16 + (vy >> 1) + kPad;
    const int fx = vx & 1, fy = vy & 1;
    const uint8_t* p = search.data() + static_cast<size_t>(y) * sstride + x;
    const uint8_t* s = src.y.px.data() + static_cast<size_t>(mb_y * 16) * src.y.w + mb_x * 16;
    const ptrdiff_t ps = sstride, ss = src.y.w;
    int total = 0;
    for (int r = 0; r < 16 && total <= bound; ++r, p += ps, s += ss) {
      if (fx && fy) {
        for (int c = 0; c < 16; ++c)
          total += std::abs(((p[c] + p[c + 1] + p[c + ps] + p[c + ps + 1] + 2) >> 2) - s[c]);
      } else if (fx || fy) {
        const uint8_t* q = p + (fx ? 1 : ps);
        for (int c = 0; c < 16; ++c) total += std::abs(((p[c] + q[c] + 1) >> 1) - s[c]);
      } else {
        for (int c = 0; c < 16; ++c) total += std::abs(p[c] - s[c]);
      }
    }
    return total;
  }

  // The vector of the current macroblock, half samples within f_code 1's
  // [-32, 31]: the best full-sample start of the zero, predicted and
  // neighbouring vectors, up to kSteps small-diamond steps within +-kRange,
  // then the best of the eight half-sample neighbours.
  std::array<int16_t, 2> search_vector(int px, int py) const {
    const int lo = -2 * kRange, hi = 2 * kRange;
    auto clampv = [&](int v) { return std::min(std::max(v, lo), hi) & ~1; };
    int bx = 0, by = 0, best = sad(0, 0) - 64;  // a slight preference for the zero vector
    auto consider = [&](int vx, int vy) {
      vx = clampv(vx);
      vy = clampv(vy);
      const int s = sad(vx, vy, best);
      if (s < best) {
        best = s;
        bx = vx;
        by = vy;
      }
    };
    consider(px, py);
    const size_t mb = static_cast<size_t>(mb_y) * mb_w + mb_x;
    consider(last_mv[mb][0], last_mv[mb][1]);
    if (mb_x) consider(mv[bpos(0) - 1][0], mv[bpos(0) - 1][1]);
    if (mb_y) consider(mv[bpos(0) - bstride][0], mv[bpos(0) - bstride][1]);
    for (int step = 0; step < kSteps; ++step) {
      const int cx = bx, cy = by;
      static const int kDiamond[4][2] = {{-2, 0}, {2, 0}, {0, -2}, {0, 2}};
      for (const auto& d : kDiamond)
        if (cx + d[0] >= lo && cx + d[0] <= hi && cy + d[1] >= lo && cy + d[1] <= hi)
          consider(cx + d[0], cy + d[1]);
      if (bx == cx && by == cy) break;
    }
    const int cx = bx, cy = by;
    for (int dy = -1; dy <= 1; ++dy)
      for (int dx = -1; dx <= 1; ++dx) {
        if (!dx && !dy) continue;
        const int vx = cx + dx, vy = cy + dy;
        if (vx < -32 || vx > 31 || vy < -32 || vy > 31) continue;
        const int s = sad(vx, vy, best);
        if (s < best) {
          best = s;
          bx = vx;
          by = vy;
        }
      }
    return {static_cast<int16_t>(bx), static_cast<int16_t>(by)};
  }

  // The decoder's ff_h263_pred_motion for one vector, in a VOP of one
  // video packet.
  void predict_mv(int& px, int& py) const {
    const size_t at = bpos(0);
    const auto& A = mv[at - 1];
    if (mb_y == 0) {
      px = mb_x ? A[0] : 0;
      py = mb_x ? A[1] : 0;
      return;
    }
    const auto& B = mv[at - bstride];
    const auto& C = mv[at + 2 - bstride];
    px = mid(A[0], B[0], C[0]);
    py = mid(A[1], B[1], C[1]);
  }

  // A vector difference, wrapped into f_code 1's range (the decoder wraps
  // the sum back).
  void put_mvd(int d) {
    d = ((d + 32) & 63) - 32;
    if (!d) {
      bits.code(kMvd[0]);
      return;
    }
    bits.code(kMvd[std::abs(d)]);
    bits.put(d < 0, 1);
  }

  void inter_macroblock() {
    int px, py;
    predict_mv(px, py);
    const std::array<int16_t, 2> v = search_vector(px, py);
    motion(cur, ref, mb_x, mb_y, mb_w, mb_h, width, height, &v, false, 0, false);
    int level[6][64];
    int cbp = 0;
    for (int n = 0; n < 6; ++n) {
      uint8_t *s, *p;
      ptrdiff_t ss, ps;
      locate(src, n, mb_x, mb_y, s, ss);
      locate(cur, n, mb_x, mb_y, p, ps);
      int residual[64];
      for (int r = 0; r < 8; ++r)
        for (int c = 0; c < 8; ++c) residual[r * 8 + c] = s[r * ss + c] - p[r * ps + c];
      float coef[64];
      dct().forward(residual, coef);
      if (quantise(coef, 0, level[n])) cbp |= 32 >> n;
    }
    const size_t mb = static_cast<size_t>(mb_y) * mb_w + mb_x;
    last_mv[mb] = v;
    for (int n = 0; n < 4; ++n) mv[bpos(n)] = v;
    // an inter macroblock leaves no intra predictors behind
    for (int n = 0; n < 4; ++n) dc[0][bpos(n)] = 1024;
    dc[1][cpos()] = dc[2][cpos()] = 1024;
    if (!cbp && !v[0] && !v[1]) {
      bits.put(1, 1);  // not_coded: the reference, unmoved
      return;
    }
    bits.put(0, 1);
    bits.code(kInterMcbpc[cbp & 3]);
    bits.code(kCbpy[(cbp >> 2) ^ 15]);
    put_mvd(v[0] - px);
    put_mvd(v[1] - py);
    for (int n = 0; n < 6; ++n) {
      if (!(cbp & (32 >> n))) continue;
      coefficients(level[n], 0, 1);
      int16_t block[64] = {};
      dequantise(level[n], 0, block);
      uint8_t* d;
      ptrdiff_t ds;
      locate(cur, n, mb_x, mb_y, d, ds);
      simple_idct(block, d, ds, true);
    }
  }
};

int report(const EncodeError& e, char* err, int err_len) {
  std::snprintf(err, err_len, "%s", e.msg.c_str());
  return -1;
}

}  // namespace

extern "C" {

void* vd_mpeg4enc_open(int width, int height, int fps_num, int fps_den, char* err, int err_len) {
  try {
    return new Encoder(width, height, fps_num, fps_den);
  } catch (const EncodeError& e) {
    report(e, err, err_len);
  } catch (const std::bad_alloc&) {
    std::snprintf(err, err_len, "out of memory");
  }
  return nullptr;
}

unsigned long vd_mpeg4enc_config(void* handle, uint8_t* out, unsigned long capacity) {
  const auto& config = static_cast<Encoder*>(handle)->config;
  if (config.size() <= capacity) std::memcpy(out, config.data(), config.size());
  return config.size();
}

int vd_mpeg4enc_encode(void* handle, const uint8_t* rgb, uint8_t* out, unsigned long capacity,
                       unsigned long* size, int* key, char* err, int err_len) {
  auto* e = static_cast<Encoder*>(handle);
  try {
    std::vector<uint8_t> vop;
    *key = e->encode(rgb, vop);
    if (vop.size() > capacity)
      fail("the VOP takes %zu bytes, more than the %lu given", vop.size(), capacity);
    std::memcpy(out, vop.data(), vop.size());
    *size = vop.size();
    return 0;
  } catch (const EncodeError& x) {
    return report(x, err, err_len);
  } catch (const std::bad_alloc&) {
    std::snprintf(err, err_len, "out of memory");
    return -1;
  }
}

void vd_mpeg4enc_planes(void* handle, uint8_t* y, uint8_t* u, uint8_t* v) {
  auto* e = static_cast<Encoder*>(handle);
  copy_planes(e->ref, e->width, e->height, y, u, v);
}

void vd_mpeg4enc_free(void* handle) { delete static_cast<Encoder*>(handle); }

}  // extern "C"
