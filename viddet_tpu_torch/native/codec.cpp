// The port's image and video codec: JPEG decode and encode, PNG unfilter,
// MPEG-4 Part 2 decode, written here with no library beyond the C++
// standard one.
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
//   vd_jpeg_decode_as(data, size, out, width, height, space, components, err, err_len)
//     as vd_jpeg_decode, with the colour space the caller names rather
//     than the one the markers give (a TIFF's JPEG strips and tiles, whose
//     conversion libtiff picks), of exactly `components` components: 1
//     YCbCr -> RGB, 3 components whose chroma is not subsampled against
//     the frame; 5 the components as they are, interleaved, every one at
//     1x1 sampling.
//   vd_jpeg_encode(rgb, width, height, quality, out, capacity, &size, err, err_len)
//   vd_png_unfilter(raw, size, width, height, bit_depth, color_type,
//                   interlace, palette, palette_len, out, err, err_len)
// and vd_png_raw_size(width, height, bit_depth, color_type, interlace), the
// inflated size of a valid header's rows (no error to report).
//
// MPEG-4 Part 2 video (the samples of an MP4 / QuickTime, AVI or Matroska
// file that native/mp4.py, avi.py or mkv.py has indexed): Simple and
// Advanced Simple Profile (I-, P- and B-VOPs, MPEG quantisation,
// quarter-sample vectors, and the encoder workarounds libavcodec keys on
// user data and the fourcc) as libavcodec's decoder gives them (see the
// section's comment), then yuv420p -> RGB as swscale's x86 converter gives
// it for BT.601 limited range, so a frame equals what cv2.VideoCapture's
// FFmpeg backend returns.
//   vd_mpeg4_open(config, size, fourcc, &width, &height, err, err_len) ->
//           handle or null; reads the VOS / VO / VOL headers and user data
//           of the decoder configuration (fourcc: the container's tag, or
//           ""); a feature the decoder does not have (S-VOPs, interlace,
//           data partitioning, reversible VLC, NEWPRED, reduced resolution,
//           scalability, not_8_bit, non-rectangular shape) raises naming it
//   vd_mpeg4_decode(handle, sample, size, rgb, err, err_len)
//           decodes the sample's VOP (a non-coded one repeats the picture
//           before it) and, with rgb, writes the picture as RGB
//   vd_mpeg4_planes(handle, y, u, v) copies out the last picture's planes
//   vd_mpeg4_info(handle, out) what it read of the encoder (7 ints)
//   vd_mpeg4_free(handle)
//
// VP8 video (a WebM / Matroska track that native/mkv.py has indexed) is
// decoded by vp8.cpp (vd_vp8::Decoder); its frames go through the same
// yuv420p -> RGB step:
//   vd_vp8_open() -> handle
//   vd_vp8_decode(handle, frame, size, err, err_len)
//           decodes one frame: 1 when it is shown, 0 for a hidden frame
//           (an alt-ref), -1 and a message for a frame that fails
//   vd_vp8_size(handle, &width, &height), vd_vp8_features(handle)
//   vd_vp8_rgb(handle, rgb) the frame shown last as RGB
//   vd_vp8_planes(handle, y, u, v) and its planes, width x height and
//           two of ((width + 1) / 2) x ((height + 1) / 2)
//   vd_vp8_free(handle)
//
// VP9 video (a WebM / Matroska or MP4 track, profile 0) is decoded by vp9.cpp
// (vd_vp9::Decoder) through the same step, with the same calls:
//   vd_vp9_open(), vd_vp9_decode(handle, sample, size, err, err_len) (a
//           sample may be a superframe of several frames: 1 when it shows
//           one), vd_vp9_size, vd_vp9_features, vd_vp9_rgb, vd_vp9_planes,
//           vd_vp9_free
//
// H.264 video (I, P and B pictures, CAVLC or CABAC: an MP4 / Matroska track configured
// by its avcC, or Annex B samples of an AVI) is decoded by h264.cpp
// (vd_h264::Decoder) through the same step, with the VUI's colour space and
// range; pictures leave in FFmpeg's output order:
//   vd_h264_open(config, size, err, err_len) -> handle or null (config: an
//           avcC; for Annex B, parameter sets with start codes or nothing)
//   vd_h264_decode(handle, sample, size, err, err_len): 1 when a picture is
//           shown, 0 when none is, -1 and a message
//   vd_h264_flush(handle): at the end, 1 while a waiting picture is shown
//   vd_h264_probe(handle, sample, size, err, err_len) parameter sets and
//           slice headers only, for the refusals before any frame: 1 when
//           the sample holds a picture
//   vd_h264_set_reorder(handle, depth) the reorder depth to start from;
//           vd_h264_reorder(handle) after probing: the depth FFmpeg's stream
//           probe leaves
//   vd_h264_size, vd_h264_features (two words of 64 bits), vd_h264_info (matrix, full
//           range, num_units_in_tick, time_scale), vd_h264_contexts (the
//           CABAC contexts used, vd_h264::kContexts flags), vd_h264_rgb,
//           vd_h264_planes, vd_h264_free
//
// Video frames (of a Motion-JPEG AVI, MP4 or Matroska file, or of an MPEG-4,
// VP8, VP9 or H.264 stream):
//   vd_frame_transform(rgb, ih, iw, out, h, w, letterbox, normalize, affine)
//           data/transforms.py's ValTransform on one uint8 RGB frame, bit for
//           bit: OpenCV's uint8 INTER_LINEAR resize in its integer
//           arithmetic (transforms.py _resize), the letterbox's 128 border,
//           and the ImageNet normalisation in float32, step by step
//   vd_video_open(path, codec, config, config_size, fourcc, reorder, offsets,
//                 sizes, samples, indices, n, h, w, letterbox, normalize,
//                 capacity, err, err_len) -> handle or null
//           starts a thread that decodes frames `indices` (ascending) of the
//           file's `samples` samples and transforms each into a ring of
//           `capacity` frames: codec 0 reads and decodes only the kept
//           JPEGs; codec 1 (MPEG-4, configured by `config`), codec 2 (VP8),
//           codec 3 (VP9) and codec 4 (H.264, `config` its avcC or empty,
//           starting from reorder depth `reorder`) decode every sample up to
//           the last kept one in order, since each inter frame needs the
//           pictures before it
//   vd_video_next(handle, out, affine, &index, err, err_len)
//           blocks for the next frame: 1 and the frame, 0 at the end or
//           after vd_video_stop, -1 and the message of the frame that failed
//   vd_video_stop(handle) wakes both sides; vd_video_free(handle) joins the
//           thread and frees (never while a vd_video_next call is running).
//
// MPEG-4 Part 2 encoding (what utils/video.py VideoWriter writes) is
// mpeg4enc.cpp's (vd_mpeg4enc_*); it and the decoder here share mpeg4.h.
//
// Build: each of codec.cpp, vp8.cpp, vp9.cpp, h264.cpp, mpeg4enc.cpp, webp.cpp
//        and gif.cpp compiled with
//        g++ -O3 -fPIC -std=c++17 -ffp-contract=off -c, then linked with
//        g++ -shared ... -o libviddet_codec.so -pthread (native/__init__.py)

#include <algorithm>
#include <array>
#include <cmath>
#include <condition_variable>
#include <memory>
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

#include "mpeg4.h"
#include "vp8.h"
#include "vp9.h"
#include "h264.h"

namespace {

using namespace vd_mpeg4;

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

enum class ColorSpace { kGray, kYCbCr, kRGB, kCMYK, kYCCK, kRaw };

struct JpegDecoder {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;
  bool header_only;

  int width = 0, height = 0;
  bool have_sof = false, progressive = false, saw_scan = false;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  int forced_space = -1;  // a ColorSpace the caller names, else the markers' (-1)
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
    if (forced_space >= 0) return static_cast<ColorSpace>(forced_space);
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
      case ColorSpace::kRaw: {
        const size_t nc = planes.size();
        for (size_t c = 0; c < nc; ++c)
          for (size_t i = 0; i < n; ++i) out[nc * i + c] = planes[c][i];
        return;
      }
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

int vd_jpeg_decode_as(const uint8_t* data, unsigned long size, uint8_t* out, int width, int height,
                      int space, int components, char* err, int err_len) {
  try {
    if (space != static_cast<int>(ColorSpace::kYCbCr) && space != static_cast<int>(ColorSpace::kRaw))
      fail("JPEG colour space %d is not one a caller may name", space);
    JpegDecoder d(data, size, false);
    d.forced_space = space;
    d.parse();
    if (d.width != width || d.height != height)
      fail("decoded size %dx%d differs from the caller's %dx%d", d.width, d.height, width, height);
    // tif_jpeg.c JPEGPreDecode's checks of the sampling factors
    const bool ycbcr = space == static_cast<int>(ColorSpace::kYCbCr);
    if (static_cast<int>(d.comps.size()) != components || (ycbcr && components != 3))
      fail("JPEG of %d components where %d are wanted", static_cast<int>(d.comps.size()), components);
    for (size_t c = ycbcr ? 1 : 0; c < d.comps.size(); ++c)
      if (d.comps[c].h != 1 || d.comps[c].v != 1)
        fail("JPEG component %d sampled %dx%d", static_cast<int>(c), d.comps[c].h, d.comps[c].v);
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

// ---------------------------------------------------------------------------
// MPEG-4 Part 2 (ISO/IEC 14496-2) Simple and Advanced Simple Profile video
// (B-VOPs, MPEG quantisation and quarter-sample vectors; not interlace or
// GMC), as libavcodec's mpeg4 decoder reconstructs it and shows it
// (display order).  The tables are the standard's (mpeg4.h: H.263 Tables
// 7, 8, 13, 14 and 16; 14496-2 Tables B-13, B-14 and B-16; here the default
// matrices); the arithmetic follows libavcodec where the standard leaves it
// open: the 8-bit simple_idct with its DC-only row shortcut, DC and AC
// prediction with its slice-edge rules, motion-vector prediction (zeroing
// a vector in place at a packet's start) and the H.263 chroma rounding,
// unrestricted vectors replicating the edge of the macroblock-aligned
// picture (libavcodec's h_edge_pos / v_edge_pos), the H.263 inverse
// quantiser with the third escape's clip, its MPEG inverse quantiser,
// direct mode's scaled vectors, the x86 half-sample averages libavcodec
// takes by default (mpeg4.h average) and qpeldsp's quarter-sample filter
// (mpeg4.h qpel_predict).  Like libavcodec it reads the encoder and its
// build from user data (XviD, DivX, Lavc) and the fourcc, and from them
// takes the XviD IDCT, the picture's own edge, unclipped DC predictors, the
// early encoders' quarter-sample chroma and luma, and 16x16 direct mode
// (Mpeg4Decoder::workaround).

// Big-endian bit reader over [p, p + n); reads past the end give zeros and
// `over()` tells.
struct Mpeg4Bits {
  const uint8_t* p = nullptr;
  size_t n = 0, pos = 0;
  Mpeg4Bits(const uint8_t* data, size_t size) : p(data), n(size) {}
  uint64_t window() const {
    const size_t byte = pos >> 3;
    uint64_t v = 0;
    if (byte + 8 <= n) {
      std::memcpy(&v, p + byte, 8);
      v = __builtin_bswap64(v);
    } else {
      for (size_t i = 0; i < 8; ++i) v = (v << 8) | (byte + i < n ? p[byte + i] : 0);
    }
    return v << (pos & 7);
  }
  uint32_t peek(int bits) const { return static_cast<uint32_t>(window() >> (64 - bits)); }
  uint32_t get(int bits) {
    const uint32_t v = peek(bits);
    pos += bits;
    return v;
  }
  int get1() { return static_cast<int>(get(1)); }
  int sget(int bits) {  // two's complement
    const int v = static_cast<int>(get(bits));
    return v >= (1 << (bits - 1)) ? v - (1 << bits) : v;
  }
  void skip(size_t bits) { pos += bits; }
  bool over() const { return pos > n * 8; }
  size_t left() const { return pos >= n * 8 ? 0 : n * 8 - pos; }
};

// A prefix code as one lookup table of 2^bits entries.
struct Vlc {
  int bits = 0;
  std::vector<int16_t> sym;
  std::vector<uint8_t> len;
  // codes[i] = {code, length}; symbol i
  Vlc(int width, const uint16_t (*codes)[2], int n)
      : bits(width), sym(size_t(1) << width, -1), len(size_t(1) << width, 0) {
    for (int i = 0; i < n; ++i) {
      const int l = codes[i][1];
      if (!l) continue;
      const uint32_t first = uint32_t(codes[i][0]) << (width - l);
      for (uint32_t j = first; j < first + (1u << (width - l)); ++j) {
        sym[j] = static_cast<int16_t>(i);
        len[j] = static_cast<uint8_t>(l);
      }
    }
  }
  int read(Mpeg4Bits& b) const {  // the symbol, or -1 for a code not in the table
    const uint32_t i = b.peek(bits);
    if (!len[i]) return -1;
    b.skip(len[i]);
    return sym[i];
  }
};


// The prefix codes of mpeg4.h's tables as lookup tables, and the escapes'
// run / level limits.
struct Mpeg4Tables : RunLevelLimits {
  Vlc intra_mcbpc{9, kIntraMcbpc, 9}, inter_mcbpc{9, kInterMcbpc, 21}, cbpy{6, kCbpy, 16},
      mvd{12, kMvd, 33}, dc_lum{11, kDcLum, 13}, dc_chrom{12, kDcChrom, 13},
      intra{12, kIntraTcoef, 103}, inter{12, kInterTcoef, 103};
};

const Mpeg4Tables& mpeg4_tables() {
  static const Mpeg4Tables t;
  return t;
}


// 14496-2's default quantiser matrices (libavcodec's
// ff_mpeg4_default_intra_matrix / _non_intra_matrix), in raster order.
const uint8_t kDefaultIntraMatrix[64] = {
    8,  17, 18, 19, 21, 23, 25, 27, 17, 18, 19, 21, 23, 25, 27, 28, 20, 21, 22, 23, 24, 26,
    28, 30, 21, 22, 23, 24, 26, 28, 30, 32, 22, 23, 24, 26, 28, 30, 32, 35, 23, 24, 26, 28,
    30, 32, 35, 38, 25, 26, 28, 30, 32, 35, 38, 41, 27, 28, 30, 32, 35, 38, 41, 45};
const uint8_t kDefaultInterMatrix[64] = {
    16, 17, 18, 19, 20, 21, 22, 23, 17, 18, 19, 20, 21, 22, 23, 24, 18, 19, 20, 21, 22, 23,
    24, 25, 19, 20, 21, 22, 23, 24, 26, 27, 20, 21, 22, 23, 25, 26, 27, 28, 21, 22, 23, 24,
    26, 27, 28, 30, 22, 23, 24, 26, 27, 28, 30, 31, 23, 24, 25, 27, 28, 30, 31, 33};

constexpr int kSimpleVo = 1, kAdvancedSimpleVo = 17;  // video_object_type_indication

// libavcodec's workaround_bugs flags that change what the decoder computes
// (Mpeg4Decoder::workaround)
constexpr unsigned kBugEdge = 1, kBugDcClip = 2, kBugQpelChroma = 4, kBugQpelChroma2 = 8,
                   kBugStdQpel = 16;

struct Mpeg4Decoder {
  // VOL
  bool have_vol = false;
  int width = 0, height = 0, mb_w = 0, mb_h = 0, time_bits = 1, resolution = 1, vo_type = 0;
  bool vol_control = false;  // the VOL carried vol_control_parameters
  bool low_delay = true;     // no B-VOPs: each picture is shown as it is decoded
  bool mpeg_quant = false;   // quant_type 1, with these matrices (raster order)
  uint8_t intra_matrix[64] = {}, inter_matrix[64] = {};
  // time, kept as libavcodec's decode_vop_header keeps it: the seconds of
  // the newest I/P-VOP (or GOV) and of the one before, the newest I/P-VOP's
  // time in ticks, and direct mode's TRD (pp_time) and TRB (pb_time)
  int64_t time_base = 0, last_time_base = 0, last_non_b_time = 0;
  uint16_t pp_time = 0, pb_time = 0;
  int pictures = 0;  // coded VOP headers read (libavcodec's picture_number)
  bool quarter = false;  // quarter_sample: vectors in quarter samples
  // who wrote the stream, as libavcodec's decode_user_data reads it from
  // user data (-1 unknown), and the container's fourcc (upper case)
  int xvid_build = -1, divx_version = -1, divx_build = -1, lavc_build = -1;
  uint32_t codec_tag = 0;
  // what libavcodec's ff_mpeg4_workaround_bugs derives from them (kBug*),
  // the XviD IDCT, and the edge of FF_BUG_EDGE once a VOP header saw it
  unsigned bugs = 0;
  bool xvid_idct = false, picture_edge = false;
  // VOP
  int vop_type = 0, rounding = 0, qscale = 1, fcode = 1, bcode = 1, dc_threshold = 99;
  // the two newest reference (I/P) pictures, `ref` the newer; `cur` is the
  // picture being decoded, and after a B-VOP the B picture
  Picture cur, ref, past;
  int refs = 0;                    // reference pictures decoded
  bool held = false;               // `ref` is not yet shown (display order)
  const Picture* shown = nullptr;  // the picture shown last
  // `ref`'s macroblocks, for the B-VOPs after it: not coded, four vectors
  std::vector<uint8_t> ref_skip, ref_four;
  int last_mv[2][2] = {};  // B-VOP vector predictors: forward, backward
  // prediction state; luma blocks on a (2 mb_h + 1) x (2 mb_w + 2) grid, chroma
  // on (mb_h + 1) x (mb_w + 2), each with a border row above and a border
  // column on either side
  int bstride = 0, cstride = 0;
  std::vector<int16_t> dc[3];                   // scaled DC predictors
  std::vector<std::array<int16_t, 16>> ac[3];   // [1..7] left column, [9..15] top row
  std::vector<std::array<int16_t, 2>> mv;       // `ref`'s luma block vectors, half samples
  std::vector<int8_t> mb_q;                     // each macroblock's qscale
  // the current video packet's first macroblock, and whether the macroblock
  // being decoded lies in the packet's first row of macroblocks
  int resync_x = 0, resync_y = 0;
  bool first_line = true;
  int mb_x = 0, mb_y = 0;

  const Mpeg4Tables& t = mpeg4_tables();

  // A decoder for a stream the container tags `tag` (its fourcc: an AVI's,
  // a VfW Matroska track's, "mp4v"; or empty), which libavcodec reads in
  // upper case.
  explicit Mpeg4Decoder(const char* tag = "") {
    for (int i = 0; i < 4 && tag && tag[i]; ++i) {
      const uint8_t c = static_cast<uint8_t>(tag[i]);
      codec_tag |= uint32_t(c >= 'a' && c <= 'z' ? c - 'a' + 'A' : c) << (8 * i);
    }
  }

  // -- headers --------------------------------------------------------------

  static size_t next_start(const uint8_t* d, size_t n, size_t from) {
    for (size_t i = from; i + 3 <= n; ++i)
      if (d[i] == 0 && d[i + 1] == 0 && d[i + 2] == 1) return i;
    return n;
  }

  // Walk the start codes of `data`: VOL and GOV headers are read, a VOP
  // decoded.  Returns -1 without a VOP, else whether a picture is ready to
  // show (`shown`).
  int feed(const uint8_t* data, size_t n, bool allow_vop) {
    int ready = -1;
    for (size_t i = next_start(data, n, 0); i + 4 <= n;) {
      const uint8_t code = data[i + 3];
      const size_t body = i + 4, end = next_start(data, n, body);
      Mpeg4Bits b(data + body, end - body);
      if (code >= 0x20 && code <= 0x2F) {
        parse_vol(b);
      } else if (code == 0xB2 && ready < 0) {
        parse_user_data(data + body, n - body);
      } else if (code == 0xB3) {
        parse_gov(b);
      } else if (code == 0xB6) {
        if (!allow_vop) fail("the decoder configuration holds a VOP");
        if (ready >= 0)
          fail("the sample holds more than one VOP (packed B-frames, which the port unpacks "
               "only in AVI)");
        if (!have_vol) fail("a VOP before any video object layer header");
        ready = decode_vop(b);
      }
      // the others (VOS, VO, ...) carry nothing the decoder needs
      i = end;
    }
    return ready;
  }

  // libavcodec's decode_user_data: up to 255 bytes, to where 23 zero bits
  // start (the next start code), read with sscanf as there; the forms its
  // encoder, XviD and DivX write name the encoder and its build.
  void parse_user_data(const uint8_t* d, size_t n) {
    char buf[256];
    size_t i = 0;
    auto at = [&](size_t k) { return k < n ? d[k] : 0; };
    for (; i < 255 && i < n; ++i) {
      if (!at(i) && !at(i + 1) && !(at(i + 2) & 0xFE)) break;
      buf[i] = static_cast<char>(d[i]);
    }
    buf[i] = 0;
    int ver = 0, ver2 = 0, ver3 = 0, build = 0;
    char last = 0;
    int e = std::sscanf(buf, "DivX%dBuild%d%c", &ver, &build, &last);
    if (e < 2) e = std::sscanf(buf, "DivX%db%d%c", &ver, &build, &last);
    if (e >= 2) {
      divx_version = ver;
      divx_build = build;
    }
    e = std::sscanf(buf, "FFmpe%*[^b]b%d", &build) + 3;
    if (e != 4)
      e = std::sscanf(buf, "FFmpeg v%d.%d.%d / libavcodec build: %d", &ver, &ver2, &ver3, &build);
    if (e != 4) {
      e = std::sscanf(buf, "Lavc%d.%d.%d", &ver, &ver2, &ver3) + 1;
      if (e > 1) build = ((ver & 0xFF) << 16) + ((ver2 & 0xFF) << 8) + (ver3 & 0xFF);
    }
    if (e != 4 && !std::strcmp(buf, "ffmpeg")) lavc_build = 4600;
    if (e == 4) lavc_build = build;
    if (std::sscanf(buf, "XviD%d", &build) == 1) xvid_build = build;
  }

  static constexpr uint32_t fourcc(const char (&c)[5]) {
    return uint32_t(uint8_t(c[0])) | uint32_t(uint8_t(c[1])) << 8 | uint32_t(uint8_t(c[2])) << 16 |
           uint32_t(uint8_t(c[3])) << 24;
  }

  // libavcodec's ff_mpeg4_workaround_bugs (FF_BUG_AUTODETECT), run after
  // each coded VOP header: the encoder the fourcc implies where user data
  // named none, then the bugs of its build (they accumulate) and, once an
  // XviD build is known, the XviD IDCT.  Comparisons libavcodec makes
  // unsigned let -1 (unknown) through none of them.  Not followed: the
  // padding score (it only moves resync detection in damaged streams),
  // FF_BUG_IEDGE (Lavc 55.x builds, interlaced chroma in one buffer),
  // FF_BUG_HPEL_CHROMA and FF_BUG_XVID_ILACE (field vectors; interlace is
  // refused) and FF_BUG_UMP4 (a fourcc the readers do not take).
  void workaround() {
    const bool named = xvid_build != -1 || divx_version != -1 || lavc_build != -1;
    if (!named && (codec_tag == fourcc("XVID") || codec_tag == fourcc("XVIX") ||
                   codec_tag == fourcc("RMP4") || codec_tag == fourcc("ZMP4") ||
                   codec_tag == fourcc("SIPP")))
      xvid_build = 0;
    if (xvid_build == -1 && divx_version == -1 && lavc_build == -1 &&
        codec_tag == fourcc("DIVX") && vo_type == 0 && !vol_control)
      divx_version = 400;  // DivX 4
    if (xvid_build >= 0 && divx_version >= 0) divx_version = divx_build = -1;
    const unsigned xvid = static_cast<unsigned>(xvid_build);
    const unsigned lavc = static_cast<unsigned>(lavc_build);
    const unsigned divx = static_cast<unsigned>(divx_version);
    if (divx_version >= 500 && divx_build < 1814) bugs |= kBugQpelChroma;
    if (divx_version > 502 && divx_build < 1814) bugs |= kBugQpelChroma2;
    if (xvid <= 1) bugs |= kBugQpelChroma;
    if (xvid <= 12) bugs |= kBugEdge;
    if (xvid <= 32) bugs |= kBugDcClip;
    if (lavc < 4653) bugs |= kBugStdQpel;
    if (lavc < 4670) bugs |= kBugEdge;
    if (lavc <= 4712) bugs |= kBugDcClip;
    if (divx < 500) bugs |= kBugEdge;
    if (xvid_build >= 0) xvid_idct = true;
  }

  // The current VOP's motion compensation rules.
  McRules rules() const {
    McRules r;
    r.ew = picture_edge ? width : mb_w * 16;
    r.eh = picture_edge ? height : mb_h * 16;
    r.qpel = quarter;
    r.qpel_chroma = bugs & kBugQpelChroma2 ? 2 : bugs & kBugQpelChroma ? 1 : 0;
    r.old_qpel = bugs & kBugStdQpel;
    return r;
  }

  void idct(int16_t* block, uint8_t* dst, ptrdiff_t stride, bool add) const {
    if (xvid_idct)
      vd_mpeg4::xvid_idct(block, dst, stride, add);
    else
      simple_idct(block, dst, stride, add);
  }

  // Decode one sample; whether a picture is ready to show, in display order.
  bool decode(const uint8_t* data, size_t n) {
    const int ready = feed(data, n, true);
    if (ready < 0) fail("the sample holds no VOP");
    return ready;
  }

  // At the end of the stream: the reference picture still held, if any.
  bool flush() {
    if (!held) return false;
    held = false;
    shown = &ref;
    return true;
  }

  // load_intra_quant_mat / load_nonintra_quant_mat: up to 64 values in
  // zigzag order; a 0 ends them and the last value fills the rest.
  void load_matrix(Mpeg4Bits& b, uint8_t* m) {
    int i = 0, last = 0;
    for (; i < 64; ++i) {
      if (b.left() < 8) fail("the quantisation matrix is truncated");
      const int v = static_cast<int>(b.get(8));
      if (!v) break;
      last = v;
      m[kZigzag[i]] = static_cast<uint8_t>(v);
    }
    for (; i < 64; ++i) m[kZigzag[i]] = static_cast<uint8_t>(last);
  }

  void parse_vol(Mpeg4Bits& b) {
    b.skip(1);  // random_accessible_vol
    vo_type = static_cast<int>(b.get(8));
    int verid = 1;
    if (b.get1()) {  // is_object_layer_identifier
      verid = static_cast<int>(b.get(4));
      b.skip(3);
    }
    if (b.get(4) == 15) b.skip(16);  // aspect_ratio_info, extended PAR
    vol_control = b.get1();
    if (vol_control) {
      const int chroma = static_cast<int>(b.get(2));
      if (chroma != 1) fail("chroma format %d is not 4:2:0", chroma);
      low_delay = b.get1();
      if (b.get1())  // vbv_parameters
        b.skip(15 + 1 + 15 + 1 + 15 + 1 + 3 + 11 + 1 + 15 + 1);
    } else if (!pictures) {  // libavcodec's default, set before the first picture only
      low_delay = vo_type == kSimpleVo || vo_type == kAdvancedSimpleVo;
    }
    const int shape = static_cast<int>(b.get(2));
    if (shape != 0)
      fail("non-rectangular shape (video_object_layer_shape %d) is not decoded", shape);
    b.skip(1);
    const int res = static_cast<int>(b.get(16));
    if (!res) fail("vop_time_increment_resolution is 0");
    b.skip(1);
    time_bits = 1;
    while ((1 << time_bits) < res) ++time_bits;
    if (b.get1()) b.skip(time_bits);  // fixed_vop_rate, fixed_vop_time_increment
    b.skip(1);
    const int w = static_cast<int>(b.get(13));
    b.skip(1);
    const int h = static_cast<int>(b.get(13));
    b.skip(1);
    if (b.get1()) fail("interlaced video is not decoded");
    b.skip(1);  // obmc_disable
    const int sprite = static_cast<int>(verid == 1 ? b.get(1) : b.get(2));
    if (sprite) fail("sprites and global motion compensation (sprite_enable %d) are not decoded",
                     sprite);
    if (b.get1()) fail("video of other than 8 bits (not_8_bit) is not decoded");
    const bool mpeg = b.get1();  // quant_type
    if (mpeg) {
      std::memcpy(intra_matrix, kDefaultIntraMatrix, 64);
      std::memcpy(inter_matrix, kDefaultInterMatrix, 64);
      if (b.get1()) load_matrix(b, intra_matrix);
      if (b.get1()) load_matrix(b, inter_matrix);
    }
    const bool qpel = verid != 1 && b.get1();
    if (!b.get1()) fail("complexity estimation headers are not decoded");
    b.skip(1);  // resync_marker_disable: video packets are found either way
    if (b.get1()) {
      const int rvlc = b.get1();
      fail("data partitioning%s is not decoded", rvlc ? " with reversible VLC" : "");
    }
    if (verid != 1) {
      if (b.get1()) fail("NEWPRED is not decoded");
      if (b.get1()) fail("reduced-resolution VOPs are not decoded");
    }
    if (b.get1()) fail("scalable video (scalability) is not decoded");
    if (b.over()) fail("the video object layer header is truncated");
    if (w <= 0 || h <= 0) fail("bad video object layer size %dx%d", w, h);
    if (have_vol && (w != width || h != height))
      fail("the video object layer changes size from %dx%d to %dx%d", width, height, w, h);
    if (!have_vol) allocate(w, h);
    have_vol = true;
    resolution = res;
    mpeg_quant = mpeg;
    quarter = qpel;
  }

  // group_of_vop: the seconds of its time code become the time base (a GOV
  // header of zeros is ignored, as libavcodec ignores it)
  void parse_gov(Mpeg4Bits& b) {
    if (!b.peek(23)) return;
    const int hours = static_cast<int>(b.get(5)), minutes = static_cast<int>(b.get(6));
    b.skip(1);
    const int seconds = static_cast<int>(b.get(6));
    time_base = seconds + 60 * (minutes + 60 * hours);
  }

  void allocate(int w, int h) {
    if (static_cast<long long>(w) * h > kMaxPixels)
      fail("%dx%d exceeds the decoder's %lld pixels", w, h, kMaxPixels);
    width = w;
    height = h;
    mb_w = (w + 15) / 16;
    mb_h = (h + 15) / 16;
    for (Picture* p : {&cur, &ref, &past}) {
      p->y.reset(mb_w * 16, mb_h * 16);
      p->u.reset(mb_w * 8, mb_h * 8);
      p->v.reset(mb_w * 8, mb_h * 8);
    }
    bstride = 2 * mb_w + 2;
    cstride = mb_w + 2;
    const size_t bn = static_cast<size_t>(2 * mb_h + 1) * bstride;
    const size_t cn = static_cast<size_t>(mb_h + 1) * cstride;
    dc[0].assign(bn, 1024);
    dc[1].assign(cn, 1024);
    dc[2].assign(cn, 1024);
    ac[0].assign(bn, {});
    ac[1].assign(cn, {});
    ac[2].assign(cn, {});
    mv.assign(bn, {0, 0});
    mb_q.assign(static_cast<size_t>(mb_w) * mb_h, 1);
    ref_skip.assign(static_cast<size_t>(mb_w) * mb_h, 0);
    ref_four.assign(static_cast<size_t>(mb_w) * mb_h, 0);
  }

  // -- VOP ------------------------------------------------------------------

  // Decode a VOP; whether a picture is ready to show.  Display order is
  // libavcodec's: unless low_delay, a reference picture is held until the
  // next one (or the end) arrives, and a B-VOP's picture is shown at once.
  bool decode_vop(Mpeg4Bits& b) {
    static const char kType[] = "IPBS";
    const int type = static_cast<int>(b.get(2));
    if (type == 3) fail("S-VOPs (sprites, global motion compensation) are not decoded");
    if (type == 2 && low_delay && !vol_control) low_delay = false;  // libavcodec's repair
    int incr = 0;
    while (b.get1()) {  // modulo_time_base
      if (b.over()) fail("the VOP header is truncated");
      ++incr;
    }
    b.skip(1);
    const int64_t increment = b.get(time_bits);
    b.skip(1);
    if (type != 2) {
      last_time_base = time_base;
      time_base += incr;
      const int64_t time = time_base * resolution + increment;
      pp_time = static_cast<uint16_t>(time - last_non_b_time);
      last_non_b_time = time;
    } else {
      const int64_t time = (last_time_base + incr) * resolution + increment;
      pb_time = static_cast<uint16_t>(pp_time - (last_non_b_time - time));
      // out of order: libavcodec drops the B-VOP
      if (pp_time <= pb_time || !pb_time) return false;
    }
    if (!b.get1()) return not_coded(type);  // vop_coded 0
    rounding = type == 1 ? b.get1() : 0;
    dc_threshold = kDcThreshold[b.get(3)];
    qscale = static_cast<int>(b.get(5));
    if (!qscale) fail("vop_quant is 0");
    fcode = bcode = 1;
    if (type != 0) {
      fcode = static_cast<int>(b.get(3));
      if (!fcode) fail("vop_fcode_forward is 0");
    }
    if (type == 2) {
      bcode = static_cast<int>(b.get(3));
      if (!bcode) fail("vop_fcode_backward is 0");
    }
    if (type == 1 && !refs) fail("a P-VOP before any I-VOP");
    if (b.over()) fail("the VOP header is truncated");
    // libavcodec's divx4 rule
    if (!vo_type && !vol_control && divx_version == -1 && !pictures) low_delay = true;
    if (bugs & kBugEdge) picture_edge = true;  // the header reads the bugs found so far
    ++pictures;
    workaround();
    if (type == 2 && refs < 2) return false;  // libavcodec drops a B-VOP before two references
    vop_type = type;
    resync_x = resync_y = 0;
    first_line = true;
    for (mb_y = 0; mb_y < mb_h; ++mb_y) {
      for (mb_x = 0; mb_x < mb_w; ++mb_x) {
        const size_t mb = static_cast<size_t>(mb_y) * mb_w + mb_x;
        // a B-VOP's macroblock whose co-located one was not coded takes no
        // bits, so a packet may start after it
        if ((mb_x || mb_y) && resync_ahead(b) &&
            !(type == 2 && ref_skip[mb] && packet_mb(b) > static_cast<int>(mb)))
          video_packet(b);
        if (resync_x == mb_x && resync_y + 1 == mb_y) first_line = false;
        try {
          if (type == 2)
            b_macroblock(b, ref_skip[mb]);
          else
            macroblock(b);
        } catch (const CodecError& e) {
          fail("%c-VOP macroblock (%d, %d): %s", kType[type], mb_x, mb_y, e.msg.c_str());
        }
        if (b.over())
          fail("%c-VOP macroblock (%d, %d): the VOP is truncated", kType[type], mb_x, mb_y);
      }
    }
    if (type == 2) {  // never a reference
      shown = &cur;
      return true;
    }
    std::swap(past, ref);  // the new picture is the newer reference
    std::swap(ref, cur);
    ++refs;
    return show_reference();
  }

  // A new reference picture in `ref`: shown at once under low_delay, else
  // the one before it is shown now and it is held.
  bool show_reference() {
    if (low_delay) {
      shown = &ref;
      return true;
    }
    if (held) {
      shown = &past;
      return true;
    }
    held = true;
    return false;
  }

  // vop_coded 0.  A non-coded I- or P-VOP is the newest reference again:
  // it repeats it (shown as the next reference), and for the B-VOPs after
  // it each of its macroblocks counts as not coded.  A non-coded B-VOP
  // repeats the picture shown before it.  (libavcodec shows nothing for
  // either.)
  bool not_coded(int type) {
    if (!refs) fail("a non-coded VOP before any picture");
    if (type == 2) return shown != nullptr;
    past = ref;
    std::fill(ref_skip.begin(), ref_skip.end(), 1);
    std::fill(ref_four.begin(), ref_four.end(), 0);
    std::fill(mv.begin(), mv.end(), std::array<int16_t, 2>{0, 0});
    ++refs;
    return show_reference();
  }

  static constexpr int kDcThreshold[8] = {99, 13, 15, 17, 19, 21, 23, 0};

  // the zero bits of a resync marker: 14496-2's, libavcodec's
  // ff_mpeg4_get_video_packet_prefix_length
  int packet_prefix() const {
    return vop_type == 0 ? 16 : vop_type == 1 ? 15 + fcode : 15 + std::max({fcode, bcode, 2});
  }

  int packet_number_bits() const {
    int bits = 1;
    while ((1 << bits) < mb_w * mb_h) ++bits;
    return bits;
  }

  // Whether stuffing to the next byte and a resync marker come next.
  bool resync_ahead(const Mpeg4Bits& b) const {
    const int pad = 8 - static_cast<int>(b.pos & 7);  // 1..8 bits of 0111...
    if (b.left() < static_cast<size_t>(pad + packet_prefix() + 1)) return false;
    if (b.peek(pad) != (1u << (pad - 1)) - 1) return false;
    Mpeg4Bits c = b;
    c.skip(pad);
    if (c.peek(packet_prefix() + 1) != 1) return false;
    return true;
  }

  // The first macroblock of the video packet ahead (after resync_ahead).
  int packet_mb(const Mpeg4Bits& b) const {
    Mpeg4Bits c = b;
    c.skip(8 - (c.pos & 7));
    c.skip(packet_prefix() + 1);
    return static_cast<int>(c.get(packet_number_bits()));
  }

  void video_packet(Mpeg4Bits& b) {
    b.skip(8 - (b.pos & 7));
    b.skip(packet_prefix() + 1);
    const int mb = static_cast<int>(b.get(packet_number_bits()));
    if (mb != mb_y * mb_w + mb_x)
      fail("a video packet starts at macroblock %d, expected %d", mb, mb_y * mb_w + mb_x);
    const int q = static_cast<int>(b.get(5));
    if (q) qscale = q;
    if (b.get1()) {  // header_extension_code
      while (b.get1()) {
        if (b.over()) fail("the video packet header is truncated");
      }
      b.skip(1 + time_bits + 1 + 2 + 3);  // time, marker, coding type, intra_dc_vlc_thr
      if (vop_type != 0) b.skip(3);       // vop_fcode_forward
      if (vop_type == 2) b.skip(3);       // vop_fcode_backward
    }
    if (b.over()) fail("the video packet header is truncated");
    resync_x = mb_x;
    resync_y = mb_y;
    first_line = true;
    std::memset(last_mv, 0, sizeof(last_mv));
    // forget the AC predictors the packet may not use (libavcodec's
    // ff_mpeg4_clean_buffers): from the block above-left of this
    // macroblock through the blocks left of it, in raster order
    const size_t from = static_cast<size_t>(2 * mb_y) * bstride + 2 * mb_x;
    for (size_t i = from, n = 0; n < static_cast<size_t>(2 * bstride) + 1 && i < ac[0].size();
         ++i, ++n)
      ac[0][i] = {};
    const size_t cfrom = static_cast<size_t>(mb_y) * cstride + mb_x;
    for (int p = 1; p < 3; ++p)
      for (size_t i = cfrom, n = 0; n < static_cast<size_t>(cstride) + 1 && i < ac[p].size();
           ++i, ++n)
        ac[p][i] = {};
  }

  // grid positions: luma block n (0..3) of the current macroblock, and its
  // chroma entry
  size_t bpos(int n) const {
    return static_cast<size_t>(2 * mb_y + (n >> 1) + 1) * bstride + 2 * mb_x + (n & 1) + 1;
  }
  size_t cpos() const { return static_cast<size_t>(mb_y + 1) * cstride + mb_x + 1; }
  size_t mb_index() const { return static_cast<size_t>(mb_y) * mb_w + mb_x; }

  void set_qscale(int q) { qscale = q < 1 ? 1 : q > 31 ? 31 : q; }
  int dc_scale(int n) const { return vd_mpeg4::dc_scale(qscale, n); }

  void macroblock(Mpeg4Bits& b) {
    static const int kDquant[4] = {-1, -2, 1, 2};
    int cbpc;
    bool intra, dquant, four = false;
    ref_skip[mb_index()] = ref_four[mb_index()] = 0;
    if (vop_type == 1) {
      do {
        if (b.get1()) {  // not_coded: the reference, unmoved
          skipped();
          return;
        }
        cbpc = t.inter_mcbpc.read(b);
        if (cbpc < 0) fail("bad mcbpc code");
      } while (cbpc == 20);
      intra = cbpc & 4;
      dquant = cbpc & 8;
      four = cbpc & 16;
    } else {
      do {
        cbpc = t.intra_mcbpc.read(b);
        if (cbpc < 0) fail("bad mcbpc code");
      } while (cbpc == 8);
      intra = true;
      dquant = cbpc & 4;
    }
    if (intra) {
      const bool ac_pred = b.get1();
      const int cbpy = t.cbpy.read(b);
      if (cbpy < 0) fail("bad cbpy code");
      const int cbp = (cbpc & 3) | (cbpy << 2);
      const bool dc_vlc = qscale < dc_threshold;
      if (dquant) set_qscale(qscale + kDquant[b.get(2)]);
      intra_macroblock(b, cbp, ac_pred, dc_vlc);
      return;
    }
    const int cbpy = t.cbpy.read(b);
    if (cbpy < 0) fail("bad cbpy code");
    const int cbp = (cbpc & 3) | ((cbpy ^ 15) << 2);
    if (dquant) set_qscale(qscale + kDquant[b.get(2)]);
    std::array<int16_t, 2> v[4];
    if (!four) {
      int px, py;
      predict_mv(0, px, py);
      v[0] = {static_cast<int16_t>(read_mv(b, px, fcode)), 0};
      v[0][1] = static_cast<int16_t>(read_mv(b, py, fcode));
      for (int n = 0; n < 4; ++n) mv[bpos(n)] = v[0];
    } else {
      for (int n = 0; n < 4; ++n) {
        int px, py;
        predict_mv(n, px, py);
        v[n][0] = static_cast<int16_t>(read_mv(b, px, fcode));
        v[n][1] = static_cast<int16_t>(read_mv(b, py, fcode));
        mv[bpos(n)] = v[n];
      }
      ref_four[mb_index()] = 1;
    }
    clear_intra();
    predict(ref, v, four, rounding, false);
    texture(b, cbp);
  }

  // The inter blocks of `cbp`, added to the prediction in `cur`.
  void texture(Mpeg4Bits& b, int cbp) {
    int16_t block[64];
    for (int n = 0; n < 6; ++n) {
      if (!(cbp & (32 >> n))) continue;
      std::memset(block, 0, sizeof(block));
      inter_block(b, block);
      uint8_t* dst;
      ptrdiff_t stride;
      target(n, dst, stride);
      idct(block, dst, stride, true);
    }
  }

  void target(int n, uint8_t*& dst, ptrdiff_t& stride) {
    if (n < 4) {
      dst = cur.y.at(mb_x * 16 + (n & 1) * 8, mb_y * 16 + (n >> 1) * 8);
      stride = cur.y.w;
    } else {
      Plane& p = n == 4 ? cur.u : cur.v;
      dst = p.at(mb_x * 8, mb_y * 8);
      stride = p.w;
    }
  }

  void skipped() {
    for (int n = 0; n < 4; ++n) mv[bpos(n)] = {0, 0};
    ref_skip[mb_index()] = 1;
    clear_intra();
    std::array<int16_t, 2> v[4] = {};
    predict(ref, v, false, rounding, false);
  }

  // an inter macroblock leaves no intra predictors behind
  void clear_intra() {
    for (int n = 0; n < 4; ++n) {
      dc[0][bpos(n)] = 1024;
      ac[0][bpos(n)] = {};
    }
    for (int p = 1; p < 3; ++p) {
      dc[p][cpos()] = 1024;
      ac[p][cpos()] = {};
    }
    mb_q[mb_index()] = static_cast<int8_t>(qscale);
  }

  // -- B-VOP macroblocks (libavcodec's mpeg4_decode_mb for B pictures) ------

  // modb, mb_type, cbpb, dbquant and the vectors; then forward prediction
  // from `past`, backward from `ref`, or their average, and the texture.
  // `skip`: the co-located macroblock of `ref` was not coded, so this one
  // takes no bits and is `past` unmoved.
  void b_macroblock(Mpeg4Bits& b, bool skip) {
    if (!mb_x) std::memset(last_mv, 0, sizeof(last_mv));  // each row starts from zero
    std::array<int16_t, 2> fv[4] = {}, bv[4] = {};
    bool forward = true, backward = false, four = false;
    int cbp = 0;
    if (!skip) {
      int type = 0;  // mb_type: 0 direct, 1 interpolate, 2 backward, 3 forward
      int dx = 0, dy = 0;
      if (!b.get1()) {  // modb 1: direct, with no delta vector and no texture
        const bool no_texture = b.get1();
        while (type < 4 && !b.get1()) ++type;
        if (type == 4) fail("bad mb_type code");
        if (!no_texture) cbp = static_cast<int>(b.get(6));
        if (type && cbp && b.get1()) set_qscale(qscale + (b.get1() ? 2 : -2));
        forward = type == 1 || type == 3;
        backward = type == 1 || type == 2;
        if (forward) coded_vector(b, 0, fcode, fv);
        if (backward) coded_vector(b, 1, bcode, bv);
        if (!type) {
          dx = read_mv(b, 0, 1);
          dy = read_mv(b, 0, 1);
        }
      }
      if (!type) {
        direct(dx, dy, fv, bv, four);
        forward = backward = true;
      }
    }
    if (forward) predict(past, fv, four, 0, false);
    if (backward) predict(ref, bv, four, 0, forward);
    texture(b, cbp);
  }

  // One coded vector from the row's predictor (0 forward, 1 backward).
  void coded_vector(Mpeg4Bits& b, int dir, int code, std::array<int16_t, 2>* v) {
    for (int c = 0; c < 2; ++c) last_mv[dir][c] = read_mv(b, last_mv[dir][c], code);
    for (int n = 0; n < 4; ++n)
      v[n] = {static_cast<int16_t>(last_mv[dir][0]), static_cast<int16_t>(last_mv[dir][1])};
  }

  // Direct mode (libavcodec's ff_mpeg4_set_direct_mv): the co-located
  // vectors of `ref` scaled by TRB / TRD, plus the delta; four vectors when
  // the co-located macroblock had four.
  void direct(int dx, int dy, std::array<int16_t, 2>* fv, std::array<int16_t, 2>* bv,
              bool& four) {
    four = ref_four[mb_index()];
    // quarter-sample direct mode predicts four 8x8 blocks from the one
    // vector too (libavcodec skips that under FF_BUG_DIRECT_BLOCKSIZE only
    // where the caller set it: it tests avctx->workaround_bugs, which the
    // detection never writes)
    const bool split = !four && quarter;
    const int trb = pb_time, trd = pp_time;
    for (int n = 0; n < (four ? 4 : 1); ++n) {
      const std::array<int16_t, 2>& p = mv[bpos(n)];
      for (int c = 0; c < 2; ++c) {
        const int d = c ? dy : dx, f = p[c] * trb / trd + d;
        fv[n][c] = static_cast<int16_t>(f);
        bv[n][c] = static_cast<int16_t>(d ? f - p[c] : p[c] * (trb - trd) / trd);
      }
    }
    for (int n = four ? 4 : 1; n < 4; ++n) {
      fv[n] = fv[0];
      bv[n] = bv[0];
    }
    four = four || split;
  }

  // libavcodec's ff_h263_pred_motion, with its first-row rules
  void predict_mv(int n, int& px, int& py) {
    const size_t at = bpos(n);
    std::array<int16_t, 2>& A = mv[at - 1];
    static const int kOff[4] = {2, 1, 1, -1};
    if (first_line && n < 3) {
      if (n == 0) {
        if (mb_x == resync_x) {
          px = py = 0;
        } else if (mb_x + 1 == resync_x) {
          const auto& C = mv[at + kOff[0] - bstride];
          if (mb_x == 0) {
            px = C[0];
            py = C[1];
          } else {
            px = mid(A[0], 0, C[0]);
            py = mid(A[1], 0, C[1]);
          }
        } else {
          px = A[0];
          py = A[1];
        }
      } else if (n == 1) {
        if (mb_x + 1 == resync_x) {
          const auto& C = mv[at + kOff[1] - bstride];
          px = mid(A[0], 0, C[0]);
          py = mid(A[1], 0, C[1]);
        } else {
          px = A[0];
          py = A[1];
        }
      } else {
        // at a packet's first macroblock libavcodec zeroes A, the left
        // macroblock's block 3, in place: later predictions and the
        // B-VOPs' direct mode see the zero
        if (mb_x == resync_x) mv[at - 1] = {0, 0};
        const auto& B = mv[at - bstride];
        const auto& C = mv[at + kOff[2] - bstride];
        px = mid(A[0], B[0], C[0]);
        py = mid(A[1], B[1], C[1]);
      }
      return;
    }
    const auto& B = mv[at - bstride];
    const auto& C = mv[at + kOff[n] - bstride];
    px = mid(A[0], B[0], C[0]);
    py = mid(A[1], B[1], C[1]);
  }

  // the current macroblock of `cur` predicted from `src` (mpeg4.h motion)
  void predict(const Picture& src, const std::array<int16_t, 2>* v, bool four, int rnd,
               bool avg) {
    motion(cur, src, mb_x, mb_y, width, height, rules(), v, four, rnd, avg);
  }

  int read_mv(Mpeg4Bits& b, int pred, int code_f) {
    const int code = t.mvd.read(b);
    if (code < 0) fail("bad motion vector code");
    if (!code) return pred;
    const bool negative = b.get1();
    const int shift = code_f - 1;
    int v = code;
    if (shift) v = (((v - 1) << shift) | static_cast<int>(b.get(shift))) + 1;
    v = pred + (negative ? -v : v);
    const int bits = 5 + code_f;  // wrap into the f_code's range
    v &= (1 << bits) - 1;
    return v >= (1 << (bits - 1)) ? v - (1 << bits) : v;
  }

  // -- texture --------------------------------------------------------------

  // (last, run, level) of one TCOEF symbol with its escapes; `level` signed
  // and, for inter blocks, dequantised (qmul, qadd); returns last.
  bool coefficient(Mpeg4Bits& b, bool intra, int qmul, int qadd, int& run, int& level) {
    const Vlc& vlc = intra ? t.intra : t.inter;
    const int table = intra ? 0 : 1;
    const int last_from = kLastFrom[table];
    const int8_t* runs = intra ? kIntraRun : kInterRun;
    const int8_t* levels = intra ? kIntraLevel : kInterLevel;
    int s = vlc.read(b);
    if (s < 0) fail("bad TCOEF code");
    if (s != kEscape) {
      run = runs[s];
      const int l = levels[s] * qmul + qadd;
      level = b.get1() ? -l : l;
      return s >= last_from;
    }
    if (!b.get1()) {  // first escape: level + max_level
      s = vlc.read(b);
      if (s < 0 || s == kEscape) fail("bad TCOEF code after the first escape");
      const bool last = s >= last_from;
      run = runs[s];
      const int l = (levels[s] + t.max_level[table][last][run]) * qmul + qadd;
      level = b.get1() ? -l : l;
      return last;
    }
    if (!b.get1()) {  // second escape: run + max_run + 1
      s = vlc.read(b);
      if (s < 0 || s == kEscape) fail("bad TCOEF code after the second escape");
      const bool last = s >= last_from;
      run = runs[s] + t.max_run[table][last][levels[s]] + 1;
      const int l = levels[s] * qmul + qadd;
      level = b.get1() ? -l : l;
      return last;
    }
    // third escape: fixed length
    const bool last = b.get1();
    run = static_cast<int>(b.get(6));
    b.skip(1);
    int l = b.sget(12);
    b.skip(1);
    if (l > 0)
      l = l * qmul + qadd;
    else if (l < 0)
      l = l * qmul - qadd;
    if (l < -2048 || l > 2047) l = l < 0 ? -2048 : 2047;
    level = l;
    return last;
  }

  // coefficients from position `i` on, in `scan` order; returns the last
  // position written
  void coefficients(Mpeg4Bits& b, int16_t* block, const uint8_t* scan, int i, bool intra,
                    int qmul, int qadd) {
    for (;;) {
      int run, level;
      const bool last = coefficient(b, intra, qmul, qadd, run, level);
      i += run;
      if (i > (last ? 63 : 62)) fail("coefficients run past the end of the block");
      block[scan[i]] = static_cast<int16_t>(level);
      if (last) return;
      ++i;
      if (b.over()) fail("the block is truncated");
    }
  }

  // An inter block, dequantised: H.263's qmul / qadd while the levels are
  // read, or MPEG's matrix after them, as libavcodec's
  // dct_unquantize_mpeg2_inter does it, with its mismatch control (the
  // least significant bit of coefficient 63 flipped when the levels' sum
  // is even).
  void inter_block(Mpeg4Bits& b, int16_t* block) {
    if (!mpeg_quant) {
      coefficients(b, block, kZigzag, 0, false, qscale << 1, (qscale - 1) | 1);
      return;
    }
    coefficients(b, block, kZigzag, 0, false, 1, 0);
    int sum = -1;
    for (int i = 0; i < 64; ++i) {
      const int l = block[i];
      if (!l) continue;
      const int m = ((2 * std::abs(l) + 1) * qscale * inter_matrix[i]) >> 4;
      const int v = l < 0 ? -m : m;
      block[i] = static_cast<int16_t>(v);
      sum += v;
    }
    block[63] = static_cast<int16_t>(block[63] ^ (sum & 1));
  }

  // libavcodec's ff_mpeg4_pred_dc: the prediction direction (0 left, 1 top)
  // and the predicted, unscaled DC; stores the scaled DC for later blocks
  int predict_dc(int n, int level, int& dir) {
    const int scale = dc_scale(n);
    std::vector<int16_t>& d = n < 4 ? dc[0] : dc[n - 3];
    const int stride = n < 4 ? bstride : cstride;
    const size_t at = n < 4 ? bpos(n) : cpos();
    int a = d[at - 1], bb = d[at - 1 - stride], c = d[at - stride];
    if (first_line && n != 3) {
      if (n != 2) bb = c = 1024;
      if (n != 1 && mb_x == resync_x) bb = a = 1024;
    }
    if (mb_x == resync_x && mb_y == resync_y + 1 && (n == 0 || n == 4 || n == 5)) bb = 1024;
    int pred;
    if (std::abs(a - bb) < std::abs(bb - c)) {
      pred = c;
      dir = 1;
    } else {
      pred = a;
      dir = 0;
    }
    pred = (pred + (scale >> 1)) / scale;
    level += pred;
    int stored = level * scale;  // clipped to 2047 unless FF_BUG_DC_CLIP
    if (stored & ~2047) stored = stored < 0 ? 0 : bugs & kBugDcClip ? stored : 2047;
    d[at] = static_cast<int16_t>(stored);
    return level;
  }

  // libavcodec's ff_mpeg4_pred_ac: add the left column or top row of the
  // neighbour (rescaled to this qscale), then keep this block's own
  static int rounded_div(int a, int b) { return (a >= 0 ? a + (b >> 1) : a - (b >> 1)) / b; }
  void predict_ac(int n, int16_t* block, int dir, bool ac_pred) {
    std::vector<std::array<int16_t, 16>>& a = n < 4 ? ac[0] : ac[n - 3];
    const int stride = n < 4 ? bstride : cstride;
    const size_t at = n < 4 ? bpos(n) : cpos();
    if (ac_pred) {
      if (dir == 0) {
        const auto& left = a[at - 1];
        const int q = mb_x ? mb_q[static_cast<size_t>(mb_y) * mb_w + mb_x - 1] : qscale;
        const bool same = mb_x == 0 || q == qscale || n == 1 || n == 3;
        for (int i = 1; i < 8; ++i)
          block[i << 3] = static_cast<int16_t>(
              block[i << 3] + (same ? left[i] : rounded_div(left[i] * q, qscale)));
      } else {
        const auto& top = a[at - stride];
        const int q = mb_y ? mb_q[static_cast<size_t>(mb_y - 1) * mb_w + mb_x] : qscale;
        const bool same = mb_y == 0 || q == qscale || n == 2 || n == 3;
        for (int i = 1; i < 8; ++i)
          block[i] = static_cast<int16_t>(
              block[i] + (same ? top[i + 8] : rounded_div(top[i + 8] * q, qscale)));
      }
    }
    for (int i = 1; i < 8; ++i) {
      a[at][i] = block[i << 3];
      a[at][i + 8] = block[i];
    }
  }

  void intra_macroblock(Mpeg4Bits& b, int cbp, bool ac_pred, bool dc_vlc) {
    for (int n = 0; n < 4; ++n) mv[bpos(n)] = {0, 0};
    mb_q[static_cast<size_t>(mb_y) * mb_w + mb_x] = static_cast<int8_t>(qscale);
    int16_t block[64];
    for (int n = 0; n < 6; ++n) {
      std::memset(block, 0, sizeof(block));
      const bool coded = cbp & (32 >> n);
      int dir = 0;
      if (dc_vlc) {
        const int size = (n < 4 ? t.dc_lum : t.dc_chrom).read(b);
        if (size < 0 || size > 9) fail("bad DC size code");
        int diff = 0;
        if (size) {
          const int v = static_cast<int>(b.get(size));
          diff = v >> (size - 1) ? v : v - (1 << size) + 1;
          if (size > 8) b.skip(1);  // marker
        }
        block[0] = static_cast<int16_t>(predict_dc(n, diff, dir));
      } else {
        predict_dc(n, 0, dir);  // the direction only; the DC comes with the AC
      }
      if (coded) {
        const uint8_t* scan = !ac_pred ? kZigzag : dir == 0 ? kAltVertical : kAltHorizontal;
        coefficients(b, block, scan, dc_vlc ? 1 : 0, true, 1, 0);
      }
      if (!dc_vlc) block[0] = static_cast<int16_t>(predict_dc(n, block[0], dir));
      predict_ac(n, block, dir, ac_pred);
      // the inverse quantiser: H.263's (libavcodec's
      // dct_unquantize_h263_intra), or MPEG's with the intra matrix and no
      // mismatch control (its dct_unquantize_mpeg2_intra when not asked
      // for bit exactness)
      block[0] = static_cast<int16_t>(block[0] * dc_scale(n));
      if (mpeg_quant) {
        for (int i = 1; i < 64; ++i) {
          const int l = block[i];
          if (!l) continue;
          const int m = (2 * std::abs(l) * qscale * intra_matrix[i]) >> 4;
          block[i] = static_cast<int16_t>(l < 0 ? -m : m);
        }
      } else {
        const int qmul = qscale << 1, qadd = (qscale - 1) | 1;
        for (int i = 1; i < 64; ++i) {
          const int l = block[i];
          if (l) block[i] = static_cast<int16_t>(l < 0 ? l * qmul - qadd : l * qmul + qadd);
        }
      }
      uint8_t* dst;
      ptrdiff_t stride;
      target(n, dst, stride);
      idct(block, dst, stride, false);
    }
  }

};

// swscale's x86 yuv2rgb coefficients (luma scale, chroma terms, luma
// offset), as sws_setColorspaceDetails sets them; BT.601 limited range unless
// a stream signals otherwise.
struct YuvCoeffs {
  int y = 9539, vr = 13075, ub = 16525, ug = -3209, vg = -6660, y_off = 128;
};

// The coefficients for a colour space (an AVColorSpace value: an H.264
// VUI's matrix_coefficients as they stand, a VP9 header's color_space
// mapped by vp9_color_space) and range, as OpenCV's reader hands them to
// swscale: sws_getCoefficients' table (ff_yuv2rgb_coeffs), whose default is
// BT.601, then sws_setColorspaceDetails' fixed point.
YuvCoeffs swscale_coeffs(int colorspace, bool full_range) {
  static const int64_t kTable[11][4] = {
      {104597, 132201, 25675, 53279},  // 0: RGB / no sequence display extension
      {117489, 138438, 13975, 34925},  // 1: BT.709
      {104597, 132201, 25675, 53279},  // 2: unspecified
      {104597, 132201, 25675, 53279},  // 3: reserved
      {104448, 132798, 24759, 53109},  // 4: FCC
      {104597, 132201, 25675, 53279},  // 5: BT.470 B/G
      {104597, 132201, 25675, 53279},  // 6: SMPTE 170M
      {117579, 136230, 16907, 35559},  // 7: SMPTE 240M
      {104597, 132201, 25675, 53279},  // 8: YCgCo, which swscale takes as its default
      {110013, 140363, 12277, 42626},  // 9: BT.2020 non-constant luminance
      {110013, 140363, 12277, 42626}}; // 10: BT.2020 constant luminance
  const int64_t* t = kTable[colorspace >= 0 && colorspace <= 10 ? colorspace : 5];
  int64_t crv = t[0], cbu = t[1], cgu = -t[2], cgv = -t[3], cy = 1 << 16, oy = 0;
  if (!full_range) {
    cy = (cy * 255) / 219;
    oy = 16 << 16;
  } else {
    crv = (crv * 224) / 255;
    cbu = (cbu * 224) / 255;
    cgu = (cgu * 224) / 255;
    cgv = (cgv * 224) / 255;
  }
  auto round16 = [](int64_t f) {
    const int64_t r = (f + (1 << 15)) >> 16;
    return static_cast<int>(r < -0x7FFF ? -0x8000 : r > 0x7FFF ? 0x7FFF : r);
  };
  YuvCoeffs k;
  k.y = round16(cy * (1 << 13));
  k.vr = round16(crv * (1 << 13));
  k.ub = round16(cbu * (1 << 13));
  k.ug = round16(cgu * (1 << 13));
  k.vg = round16(cgv * (1 << 13));
  k.y_off = round16(oy * (1 << 3));
  return k;
}

// A VP9 header's color_space (0 unknown, 1 BT.601, 2 BT.709, 3 SMPTE 170,
// 4 SMPTE 240, 5 BT.2020, 6 reserved, 7 sRGB) as FFmpeg's VP9 decoder maps
// it to an AVColorSpace.
int vp9_color_space(int color_space) {
  static const int kSpace[8] = {2, 5, 1, 6, 7, 9, 3, 0};
  return color_space >= 0 && color_space < 8 ? kSpace[color_space] : 2;
}

// yuv420p -> RGB as swscale's x86 unscaled converter does it (the yuv2rgb
// SIMD path OpenCV's FFmpeg reader takes): 16-bit fixed point with pmulhw's
// floor, saturated to 0..255.
void yuv420_to_rgb(const uint8_t* py, int y_stride, const uint8_t* pu, const uint8_t* pv,
                   int c_stride, int width, int height, uint8_t* rgb,
                   const YuvCoeffs& k = YuvCoeffs()) {
  const int kY = k.y, kVr = k.vr, kUb = k.ub, kUg = k.ug, kVg = k.vg, kYOff = k.y_off;
  for (int y = 0; y < height; ++y) {
    const uint8_t* ys = py + static_cast<size_t>(y) * y_stride;
    const uint8_t* us = pu + static_cast<size_t>(y >> 1) * c_stride;
    const uint8_t* vs = pv + static_cast<size_t>(y >> 1) * c_stride;
    uint8_t* out = rgb + static_cast<size_t>(y) * width * 3;
    for (int x = 0; x < width; ++x) {
      const int u = us[x >> 1] * 8 - 1024, v = vs[x >> 1] * 8 - 1024;
      const int l = ((ys[x] * 8 - kYOff) * kY) >> 16;
      const int r = l + ((v * kVr) >> 16);
      const int g = l + (((u * kUg) >> 16) + ((v * kVg) >> 16));
      const int b = l + ((u * kUb) >> 16);
      out[3 * x] = clip_pixel(r);
      out[3 * x + 1] = clip_pixel(g);
      out[3 * x + 2] = clip_pixel(b);
    }
  }
}

void yuv420_to_rgb(const Picture& p, int width, int height, uint8_t* rgb) {
  yuv420_to_rgb(p.y.px.data(), p.y.w, p.u.px.data(), p.v.px.data(), p.u.w, width, height, rgb);
}

void vp8_to_rgb(const vd_vp8::Decoder& d, uint8_t* rgb) {
  yuv420_to_rgb(d.plane(0), d.stride(0), d.plane(1), d.plane(2), d.stride(1), d.width(),
                d.height(), rgb);
}

void h264_to_rgb(const vd_h264::Decoder& d, uint8_t* rgb) {
  yuv420_to_rgb(d.plane(0), d.stride(0), d.plane(1), d.plane(2), d.stride(1), d.width(),
                d.height(), rgb, swscale_coeffs(d.matrix(), d.full_range()));
}

void vp9_to_rgb(const vd_vp9::Decoder& d, uint8_t* rgb) {
  yuv420_to_rgb(d.plane(0), d.stride(0), d.plane(1), d.plane(2), d.stride(1), d.width(),
                d.height(), rgb, swscale_coeffs(vp9_color_space(d.color_space()), d.full_range()));
}


struct VideoStream {
  std::string path;
  std::vector<int64_t> offsets, sizes;  // every sample of the file
  std::vector<int32_t> indices;         // the frames kept, ascending
  int codec = 0;                        // 0 JPEG, 1 MPEG-4 Part 2 (configured by `config`), 2 VP8, 3 VP9, 4 H.264 (an avcC `config`, or none for Annex B)
  std::vector<uint8_t> config;
  std::string fourcc;                   // MPEG-4's container tag
  int reorder = 0;                      // H.264's reorder depth to start from
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

  // Wait for a free slot of the ring; false once stopped.
  bool wait_slot() {
    std::unique_lock<std::mutex> lock(m);
    not_full.wait(lock, [&] { return stopped || produced - consumed < ring.size(); });
    return !stopped;
  }

  // Transform `rgb` into the next slot (free: the consumer copies a slot out
  // before counting it) and publish it as frame `index`.
  void put(const uint8_t* rgb, int ih, int iw, int32_t index, std::vector<uint8_t>& staged) {
    const size_t slot = produced % ring.size();
    frame_transform(rgb, ih, iw, ring[slot].data(), h, w, letterbox, normalize,
                    ring_affine[slot].data(), staged);
    ring_index[slot] = index;
    std::lock_guard<std::mutex> lock(m);
    ++produced;
    not_empty.notify_one();
  }

  void run() {
    std::vector<uint8_t> sample, rgb, staged;
    FILE* f = std::fopen(path.c_str(), "rb");
    auto read = [&](size_t k) {
      sample.resize(static_cast<size_t>(sizes[k]));
      if (fseeko(f, static_cast<off_t>(offsets[k]), SEEK_SET) != 0 ||
          std::fread(sample.data(), 1, sample.size(), f) != sample.size())
        fail("cannot read %zu bytes at %lld", sample.size(), static_cast<long long>(offsets[k]));
    };
    try {
      if (!f) fail("cannot open the video");
      if (codec == 1)
        run_mpeg4(read, sample, rgb, staged);
      else if (codec == 2)
        run_vp8(read, sample, rgb, staged);
      else if (codec == 3)
        run_vp9(read, sample, rgb, staged);
      else if (codec == 4)
        run_h264(read, sample, rgb, staged);
      else
        run_jpeg(read, sample, rgb, staged);
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

  // Motion-JPEG: only the kept frames are read and decoded.
  template <typename Read>
  void run_jpeg(Read& read, std::vector<uint8_t>& sample, std::vector<uint8_t>& rgb,
                std::vector<uint8_t>& staged) {
    for (const int32_t frame : indices) {
      if (!wait_slot()) return;
      try {
        read(frame);
        JpegDecoder d(sample.data(), sample.size(), false);
        d.parse();
        if (!d.have_sof) fail("JPEG holds no frame header");
        if (static_cast<long long>(d.width) * d.height > kMaxPixels)
          fail("%dx%d exceeds the decoder's %lld pixels", d.width, d.height, kMaxPixels);
        rgb.resize(static_cast<size_t>(d.width) * d.height * 3);
        d.output_rgb(rgb.data());
        put(rgb.data(), d.height, d.width, frame, staged);
      } catch (const CodecError& e) {
        fail("frame %d: %s", frame, e.msg.c_str());
      }
    }
  }

  // MPEG-4 Part 2: every sample is decoded in order (then the held
  // picture flushed); the pictures come out in display order, and those
  // whose display index is kept are converted and transformed.
  template <typename Read>
  void run_mpeg4(Read& read, std::vector<uint8_t>& sample, std::vector<uint8_t>& rgb,
                 std::vector<uint8_t>& staged) {
    Mpeg4Decoder d(fourcc.c_str());
    d.feed(config.data(), config.size(), false);
    if (!d.have_vol) fail("the decoder configuration holds no video object layer header");
    rgb.resize(static_cast<size_t>(d.width) * d.height * 3);
    int32_t display = 0;  // the display index of the next picture shown
    size_t kept = 0;      // indices[kept] is the next frame to keep
    for (size_t k = 0; k <= offsets.size() && kept < indices.size(); ++k) {
      bool ready;
      try {
        if (k < offsets.size()) {
          read(k);
          ready = d.decode(sample.data(), sample.size());
        } else {
          ready = d.flush();
        }
      } catch (const CodecError& e) {
        fail("frame %zu: %s", k, e.msg.c_str());
      }
      if (!ready || display++ != indices[kept]) continue;
      if (!wait_slot()) return;
      yuv420_to_rgb(*d.shown, d.width, d.height, rgb.data());
      put(rgb.data(), d.height, d.width, indices[kept++], staged);
    }
  }

  // VP8, VP9 and H.264: every sample is decoded in order (then, at the end,
  // the pictures `flush` still gives); the pictures shown count in display
  // order (a hidden VP8 / VP9 frame, or a sample completing no picture, takes
  // no index), and those kept are converted and transformed.
  template <typename Read, typename Decoder, typename Error, typename ToRgb, typename Flush>
  void run_frames(Read& read, std::vector<uint8_t>& sample, std::vector<uint8_t>& rgb,
                  std::vector<uint8_t>& staged, Decoder& d, ToRgb to_rgb, Flush flush) {
    int32_t display = 0;
    size_t kept = 0;
    for (size_t k = 0; kept < indices.size(); ++k) {
      bool shown;
      try {
        if (k < offsets.size()) {
          read(k);
          shown = d.decode(sample.data(), sample.size());
        } else if (!(shown = flush(d))) {
          return;
        }
      } catch (const Error& e) {
        fail("frame %zu: %s", k, e.msg.c_str());
      } catch (const CodecError& e) {
        fail("frame %zu: %s", k, e.msg.c_str());
      }
      if (!shown || display++ != indices[kept]) continue;
      if (!wait_slot()) return;
      rgb.resize(static_cast<size_t>(d.width()) * d.height() * 3);
      to_rgb(d, rgb.data());
      put(rgb.data(), d.height(), d.width(), indices[kept++], staged);
    }
  }

  template <typename Read>
  void run_vp8(Read& read, std::vector<uint8_t>& sample, std::vector<uint8_t>& rgb,
               std::vector<uint8_t>& staged) {
    vd_vp8::Decoder d;
    run_frames<Read, vd_vp8::Decoder, vd_vp8::Error>(read, sample, rgb, staged, d, vp8_to_rgb,
                                                     [](vd_vp8::Decoder&) { return false; });
  }

  template <typename Read>
  void run_vp9(Read& read, std::vector<uint8_t>& sample, std::vector<uint8_t>& rgb,
               std::vector<uint8_t>& staged) {
    vd_vp9::Decoder d;
    run_frames<Read, vd_vp9::Decoder, vd_vp9::Error>(read, sample, rgb, staged, d, vp9_to_rgb,
                                                     [](vd_vp9::Decoder&) { return false; });
  }

  // H.264: the decoder starts from the container's and stream probe's
  // reorder depth, and the pictures still waiting leave at the end
  template <typename Read>
  void run_h264(Read& read, std::vector<uint8_t>& sample, std::vector<uint8_t>& rgb,
                std::vector<uint8_t>& staged) {
    std::unique_ptr<vd_h264::Decoder> d;
    try {
      d.reset(new vd_h264::Decoder(config.data(), config.size()));
    } catch (const vd_h264::Error& e) {
      fail("the decoder configuration: %s", e.msg.c_str());
    }
    d->set_reorder(reorder);
    run_frames<Read, vd_h264::Decoder, vd_h264::Error>(
        read, sample, rgb, staged, *d, h264_to_rgb, [](vd_h264::Decoder& h) { return h.flush(); });
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


void* vd_mpeg4_open(const uint8_t* config, unsigned long size, const char* fourcc, int* width,
                    int* height, char* err, int err_len) {
  Mpeg4Decoder* d = nullptr;
  try {
    d = new Mpeg4Decoder(fourcc);
    d->feed(config, size, false);
    if (!d->have_vol) fail("the decoder configuration holds no video object layer header");
    *width = d->width;
    *height = d->height;
    return d;
  } catch (const CodecError& e) {
    report(e, err, err_len);
  } catch (const std::bad_alloc&) {
    std::snprintf(err, err_len, "out of memory");
  }
  delete d;
  return nullptr;
}

// Decode one sample: 1 when a picture is ready to show (in display order;
// with `rgb`, written there, width x height x 3), 0 when none is, -1 on an
// error.
int vd_mpeg4_decode(void* handle, const uint8_t* data, unsigned long size, uint8_t* rgb,
                    char* err, int err_len) {
  auto* d = static_cast<Mpeg4Decoder*>(handle);
  try {
    if (!d->decode(data, size)) return 0;
    if (rgb) yuv420_to_rgb(*d->shown, d->width, d->height, rgb);
    return 1;
  } catch (const CodecError& e) {
    return report(e, err, err_len);
  } catch (const std::bad_alloc&) {
    std::snprintf(err, err_len, "out of memory");
    return -1;
  }
}

// At the end of the stream: 1 and the held picture (into `rgb` if given),
// or 0 when no picture is held.
int vd_mpeg4_flush(void* handle, uint8_t* rgb) {
  auto* d = static_cast<Mpeg4Decoder*>(handle);
  if (!d->flush()) return 0;
  if (rgb) yuv420_to_rgb(*d->shown, d->width, d->height, rgb);
  return 1;
}

// The planes of the picture shown last: y width x height, u and v
// (width/2) x (height/2).
void vd_mpeg4_planes(void* handle, uint8_t* y, uint8_t* u, uint8_t* v) {
  auto* d = static_cast<Mpeg4Decoder*>(handle);
  if (d->shown) copy_planes(*d->shown, d->width, d->height, y, u, v);
}

// What the decoder has read of the stream so far, into 7 ints:
// quarter_sample, the XviD build, the DivX version and build, the
// libavcodec build (-1 where unknown), the workaround bits (kBug*) and
// whether the XviD IDCT is in use.
void vd_mpeg4_info(void* handle, int* out) {
  const auto* d = static_cast<const Mpeg4Decoder*>(handle);
  const int info[7] = {d->quarter,     d->xvid_build,          d->divx_version, d->divx_build,
                       d->lavc_build, static_cast<int>(d->bugs), d->xvid_idct};
  std::memcpy(out, info, sizeof(info));
}

void vd_mpeg4_free(void* handle) { delete static_cast<Mpeg4Decoder*>(handle); }

void* vd_vp8_open() {
  try {
    return new vd_vp8::Decoder();
  } catch (const std::bad_alloc&) {
    return nullptr;
  }
}

int vd_vp8_decode(void* handle, const uint8_t* data, unsigned long size, char* err, int err_len) {
  try {
    return static_cast<vd_vp8::Decoder*>(handle)->decode(data, size) ? 1 : 0;
  } catch (const vd_vp8::Error& e) {
    std::snprintf(err, err_len, "%s", e.msg.c_str());
  } catch (const std::bad_alloc&) {
    std::snprintf(err, err_len, "out of memory");
  }
  return -1;
}

void vd_vp8_size(void* handle, int* width, int* height) {
  const auto* d = static_cast<vd_vp8::Decoder*>(handle);
  *width = d->width();
  *height = d->height();
}

unsigned vd_vp8_features(void* handle) { return static_cast<vd_vp8::Decoder*>(handle)->features(); }

// The frame shown last, as RGB (width x height x 3); 0, or -1 before any.
int vd_vp8_rgb(void* handle, uint8_t* rgb) {
  const auto* d = static_cast<vd_vp8::Decoder*>(handle);
  if (!d->plane(0)) return -1;
  vp8_to_rgb(*d, rgb);
  return 0;
}

int vd_vp8_planes(void* handle, uint8_t* y, uint8_t* u, uint8_t* v) {
  const auto* d = static_cast<vd_vp8::Decoder*>(handle);
  if (!d->plane(0)) return -1;
  const int w = d->width(), h = d->height(), cw = (w + 1) / 2, ch = (h + 1) / 2;
  for (int r = 0; r < h; ++r)
    std::memcpy(y + static_cast<size_t>(r) * w, d->plane(0) + static_cast<size_t>(r) * d->stride(0), w);
  for (int r = 0; r < ch; ++r) {
    std::memcpy(u + static_cast<size_t>(r) * cw, d->plane(1) + static_cast<size_t>(r) * d->stride(1), cw);
    std::memcpy(v + static_cast<size_t>(r) * cw, d->plane(2) + static_cast<size_t>(r) * d->stride(2), cw);
  }
  return 0;
}

void vd_vp8_free(void* handle) { delete static_cast<vd_vp8::Decoder*>(handle); }

void* vd_vp9_open() {
  try {
    return new vd_vp9::Decoder();
  } catch (const std::bad_alloc&) {
    return nullptr;
  }
}

int vd_vp9_decode(void* handle, const uint8_t* data, unsigned long size, char* err, int err_len) {
  try {
    return static_cast<vd_vp9::Decoder*>(handle)->decode(data, size) ? 1 : 0;
  } catch (const vd_vp9::Error& e) {
    std::snprintf(err, err_len, "%s", e.msg.c_str());
  } catch (const std::bad_alloc&) {
    std::snprintf(err, err_len, "out of memory");
  }
  return -1;
}

void vd_vp9_size(void* handle, int* width, int* height) {
  const auto* d = static_cast<vd_vp9::Decoder*>(handle);
  *width = d->width();
  *height = d->height();
}

unsigned vd_vp9_features(void* handle) { return static_cast<vd_vp9::Decoder*>(handle)->features(); }

// The frame shown last, as RGB (width x height x 3); 0, or -1 before any.
int vd_vp9_rgb(void* handle, uint8_t* rgb) {
  const auto* d = static_cast<vd_vp9::Decoder*>(handle);
  if (!d->plane(0)) return -1;
  vp9_to_rgb(*d, rgb);
  return 0;
}

int vd_vp9_planes(void* handle, uint8_t* y, uint8_t* u, uint8_t* v) {
  const auto* d = static_cast<vd_vp9::Decoder*>(handle);
  if (!d->plane(0)) return -1;
  const int w = d->width(), h = d->height(), cw = (w + 1) / 2, ch = (h + 1) / 2;
  for (int r = 0; r < h; ++r)
    std::memcpy(y + static_cast<size_t>(r) * w, d->plane(0) + static_cast<size_t>(r) * d->stride(0), w);
  for (int r = 0; r < ch; ++r) {
    std::memcpy(u + static_cast<size_t>(r) * cw, d->plane(1) + static_cast<size_t>(r) * d->stride(1), cw);
    std::memcpy(v + static_cast<size_t>(r) * cw, d->plane(2) + static_cast<size_t>(r) * d->stride(2), cw);
  }
  return 0;
}

void vd_vp9_free(void* handle) { delete static_cast<vd_vp9::Decoder*>(handle); }

void* vd_h264_open(const uint8_t* config, unsigned long size, char* err, int err_len) {
  try {
    return new vd_h264::Decoder(config, size);
  } catch (const vd_h264::Error& e) {
    std::snprintf(err, err_len, "%s", e.msg.c_str());
  } catch (const std::bad_alloc&) {
    std::snprintf(err, err_len, "out of memory");
  }
  return nullptr;
}

int vd_h264_decode(void* handle, const uint8_t* data, unsigned long size, char* err, int err_len) {
  try {
    return static_cast<vd_h264::Decoder*>(handle)->decode(data, size) ? 1 : 0;
  } catch (const vd_h264::Error& e) {
    std::snprintf(err, err_len, "%s", e.msg.c_str());
  } catch (const std::bad_alloc&) {
    std::snprintf(err, err_len, "out of memory");
  }
  return -1;
}

int vd_h264_probe(void* handle, const uint8_t* data, unsigned long size, char* err, int err_len) {
  try {
    return static_cast<vd_h264::Decoder*>(handle)->probe(data, size) ? 1 : 0;
  } catch (const vd_h264::Error& e) {
    std::snprintf(err, err_len, "%s", e.msg.c_str());
  } catch (const std::bad_alloc&) {
    std::snprintf(err, err_len, "out of memory");
  }
  return -1;
}

void vd_h264_size(void* handle, int* width, int* height) {
  const auto* d = static_cast<vd_h264::Decoder*>(handle);
  *width = d->width();
  *height = d->height();
}

void vd_h264_features(void* handle, unsigned long long* out) {
  const auto* d = static_cast<vd_h264::Decoder*>(handle);
  out[0] = d->features();
  out[1] = d->features2();
}

int vd_h264_flush(void* handle) { return static_cast<vd_h264::Decoder*>(handle)->flush() ? 1 : 0; }

void vd_h264_set_reorder(void* handle, int depth) {
  static_cast<vd_h264::Decoder*>(handle)->set_reorder(depth);
}

int vd_h264_reorder(void* handle) { return static_cast<vd_h264::Decoder*>(handle)->probed_reorder(); }

// matrix_coefficients, full range, num_units_in_tick, time_scale
void vd_h264_info(void* handle, unsigned* out) {
  const auto* d = static_cast<vd_h264::Decoder*>(handle);
  out[0] = static_cast<unsigned>(d->matrix());
  out[1] = d->full_range();
  out[2] = d->num_units_in_tick();
  out[3] = d->time_scale();
}

void vd_h264_contexts(void* handle, uint8_t* out) {
  static_cast<vd_h264::Decoder*>(handle)->contexts(out);
}

// The picture shown last, as RGB (width x height x 3); 0, or -1 before any.
int vd_h264_rgb(void* handle, uint8_t* rgb) {
  const auto* d = static_cast<vd_h264::Decoder*>(handle);
  if (!d->plane(0)) return -1;
  h264_to_rgb(*d, rgb);
  return 0;
}

int vd_h264_planes(void* handle, uint8_t* y, uint8_t* u, uint8_t* v) {
  const auto* d = static_cast<vd_h264::Decoder*>(handle);
  if (!d->plane(0)) return -1;
  const int w = d->width(), h = d->height(), cw = (w + 1) / 2, ch = (h + 1) / 2;
  for (int r = 0; r < h; ++r)
    std::memcpy(y + static_cast<size_t>(r) * w, d->plane(0) + static_cast<size_t>(r) * d->stride(0), w);
  for (int r = 0; r < ch; ++r) {
    std::memcpy(u + static_cast<size_t>(r) * cw, d->plane(1) + static_cast<size_t>(r) * d->stride(1), cw);
    std::memcpy(v + static_cast<size_t>(r) * cw, d->plane(2) + static_cast<size_t>(r) * d->stride(2), cw);
  }
  return 0;
}

void vd_h264_free(void* handle) { delete static_cast<vd_h264::Decoder*>(handle); }

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

void* vd_video_open(const char* path, int codec, const uint8_t* config, unsigned long config_size,
                    const char* fourcc, int reorder, const int64_t* offsets, const int64_t* sizes,
                    int samples,
                    const int32_t* indices, int n, int h, int w, int letterbox, int normalize,
                    int capacity, char* err, int err_len) {
  try {
    if (n < 0 || samples < 0 || h <= 0 || w <= 0 || capacity <= 0 || codec < 0 || codec > 4)
      fail("bad video stream arguments (codec %d, %d of %d frames, %dx%d, capacity %d)", codec,
           n, samples, w, h, capacity);
    for (int i = 0; i < n; ++i)
      if (indices[i] < 0 || indices[i] >= samples || (i && indices[i] <= indices[i - 1]))
        fail("frame index %d is out of order or not in the file's %d", indices[i], samples);
    auto* s = new VideoStream();
    s->path = path;
    s->codec = codec;
    s->config.assign(config, config + config_size);
    s->fourcc = fourcc ? fourcc : "";
    s->reorder = reorder;
    s->offsets.assign(offsets, offsets + samples);
    s->sizes.assign(sizes, sizes + samples);
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
