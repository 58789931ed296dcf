// The port's VP8 decoder (vp8.cpp): RFC 6386 as FFmpeg's vp8 decoder
// gives it, which is bit for bit the reference decoder's (libvpx).  No
// library beyond the C++ standard one.
#pragma once

#include <cstddef>
#include <cstdint>
#include <memory>
#include <string>

namespace vd_vp8 {

// A frame the decoder cannot decode (a truncated partition, a bad size, an
// inter frame before any key frame, ...): thrown by Decoder::decode.
struct Error {
  std::string msg;
};

// What the frames decoded so far used (Decoder::features), so a test can
// show that a stream exercises what it claims to.
enum Feature : uint32_t {
  kKeyFrame = 1u << 0,
  kInterFrame = 1u << 1,
  kHiddenFrame = 1u << 2,        // show_frame 0 (an alt-ref frame)
  kBPred = 1u << 3,              // B_PRED macroblocks
  kSplitMv = 1u << 4,            // SPLITMV macroblocks
  kSegmentation = 1u << 5,       // segmentation enabled
  kSegmentMapUpdate = 1u << 6,   // a segment map coded in the frame
  kTokenPartitions = 1u << 7,    // more than one token partition
  kGoldenRef = 1u << 8,          // macroblocks predicted from the golden frame
  kAltrefRef = 1u << 9,          // ... from the alt-ref frame
  kOffFrameMv = 1u << 10,        // a prediction block reaching past the frame's edge
  kBilinear = 1u << 11,          // versions 1-3: bilinear sub-pixel filters
  kFullPixel = 1u << 12,         // version 3: full-pixel chroma vectors
  kSimpleFilter = 1u << 13,      // the simple loop filter
  kSharpness = 1u << 14,         // a loop filter sharpness above 0
  kFilterDeltas = 1u << 15,      // reference / mode loop filter deltas
  kNoEntropyRefresh = 1u << 16,  // refresh_entropy_probs 0 (probabilities restored)
  kIntraInInter = 1u << 17,      // intra macroblocks in inter frames
  kNewMv = 1u << 18,             // NEWMV macroblocks
  kBufferCopy = 1u << 19,        // golden / alt-ref copied from another buffer
  kSignBias = 1u << 20,          // a golden or alt-ref sign bias of 1
};

class Decoder {
 public:
  Decoder();
  ~Decoder();
  Decoder(const Decoder&) = delete;
  Decoder& operator=(const Decoder&) = delete;

  // Decode one frame (one container sample).  True when the frame is to
  // be shown; a hidden frame (an alt-ref) still updates the references.
  // Throws Error; the decoder's state is then undefined.
  bool decode(const uint8_t* data, size_t size);

  // The frame size of the key frames (0 before the first).
  int width() const;
  int height() const;
  // The planes of the frame shown last: c 0 is Y, 1 U, 2 V, each with
  // the stride of whole macroblocks; null before the first shown frame.
  const uint8_t* plane(int c) const;
  int stride(int c) const;
  uint32_t features() const;
  // Whether the last frame read past the end of its first partition, of a
  // token partition a macroblock row uses, or had an empty last token
  // partition: libvpx and FFmpeg read zeros there, libwebp refuses the frame.
  bool overrun() const;

 private:
  struct Impl;
  std::unique_ptr<Impl> impl_;
};

}  // namespace vd_vp8
