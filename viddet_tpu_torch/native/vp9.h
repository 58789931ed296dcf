// The port's VP9 decoder (vp9.cpp): profile 0 (8-bit 4:2:0) as the VP9
// Bitstream & Decoding Process Specification defines it, which is bit for
// bit the reference decoder's (libvpx) and so FFmpeg's.  No library beyond
// the C++ standard one.
#pragma once

#include <cstddef>
#include <cstdint>
#include <memory>
#include <string>

namespace vd_vp9 {

// A frame the decoder cannot decode (a truncated frame, a bad header, an
// inter frame before any key frame, a profile or feature it refuses, ...):
// thrown by Decoder::decode.
struct Error {
  std::string msg;
};

// What the frames decoded so far used (Decoder::features), so a test can
// show that a stream exercises what it claims to.
enum Feature : uint32_t {
  kKeyFrame = 1u << 0,
  kInterFrame = 1u << 1,
  kHiddenFrame = 1u << 2,         // show_frame 0 (an alt-ref frame)
  kSuperframe = 1u << 3,          // a sample holding more than one frame
  kShowExisting = 1u << 4,        // show_existing_frame
  kIntraOnly = 1u << 5,           // an intra-only frame
  kCompound = 1u << 6,            // blocks predicted from two references
  kSub8x8 = 1u << 7,              // blocks smaller than 8x8
  kTiles = 1u << 8,               // more than one tile column
  kTileRows = 1u << 9,            // more than one tile row
  kLossless = 1u << 10,           // the Walsh-Hadamard transform
  kSegmentation = 1u << 11,       // segmentation enabled
  kSegmentTemporal = 1u << 12,    // a segment map predicted from the previous one
  kAltQ = 1u << 13,               // a per-segment quantiser
  kAltLf = 1u << 14,              // a per-segment loop filter level
  kSegmentRef = 1u << 15,         // the segment reference feature
  kSegmentSkip = 1u << 16,        // the segment skip feature
  kSwitchable = 1u << 17,         // a per-block interpolation filter
  kSmoothFilter = 1u << 18,       // the smooth 8-tap filter
  kSharpFilter = 1u << 19,        // the sharp 8-tap filter
  kBilinear = 1u << 20,           // the bilinear filter
  kAdaptation = 1u << 21,         // backward probability adaptation
  kErrorResilient = 1u << 22,     // error_resilient_mode
  kFrameParallel = 1u << 23,      // frame_parallel_decoding_mode
  kPrevFrameMvs = 1u << 24,       // motion vector candidates from the previous frame
  kHighPrecisionMv = 1u << 25,    // eighth-sample motion vectors
  kTx32 = 1u << 26,               // 32x32 transforms
  kFilterDeltas = 1u << 27,       // reference / mode loop filter deltas
  kSharpness = 1u << 28,          // a loop filter sharpness above 0
  kOffFrameMv = 1u << 29,         // a prediction reaching past the frame's edge
  kIntraInInter = 1u << 30,       // intra blocks in inter frames
  kColorInfo = 1u << 31,          // a colour space other than unknown or full range
};

class Decoder {
 public:
  Decoder();
  ~Decoder();
  Decoder(const Decoder&) = delete;
  Decoder& operator=(const Decoder&) = delete;

  // Decode one sample (one frame, or a superframe of several).  True when
  // it shows a frame; a hidden frame still updates the references.
  // Throws Error; the decoder's state is then undefined.
  bool decode(const uint8_t* data, size_t size);

  // The frame size (0 before the first frame).
  int width() const;
  int height() const;
  // The planes of the frame shown last: c 0 is Y, 1 U, 2 V; null before
  // the first shown frame.
  const uint8_t* plane(int c) const;
  int stride(int c) const;
  uint32_t features() const;
  // The colour space the frames' header signals (color_space: 0 unknown, 1
  // BT.601, 2 BT.709, 3 SMPTE 170, 4 SMPTE 240, 5 BT.2020, 6 reserved) and
  // whether their range is full (color_range 1), as the last key frame set
  // them (an intra-only frame of profile 0 sets BT.601 and limited range).
  int color_space() const;
  bool full_range() const;

 private:
  struct Impl;
  std::unique_ptr<Impl> impl_;
};

}  // namespace vd_vp9
