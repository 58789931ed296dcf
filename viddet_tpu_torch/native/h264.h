// The port's H.264 decoder (h264.cpp): I, P and B pictures, CAVLC or CABAC,
// progressive, 8-bit 4:2:0, the 4x4 and 8x8 transforms (intra 8x8 prediction
// included), scaling matrices, direct prediction and weighted prediction, as
// ITU-T H.264 (ISO/IEC 14496-10) defines them, which is bit for bit FFmpeg's
// on the planes, and pictures given out in FFmpeg's order.  Constrained
// Baseline, Baseline without FMO, ASO or redundant pictures, and Main and High
// streams without interlace.  No library beyond the C++ standard one.
#pragma once

#include <cstddef>
#include <cstdint>
#include <memory>
#include <string>

namespace vd_h264 {

// A sample the decoder cannot decode (a truncated slice, a bad header, a
// reference that is missing, a tool it refuses, ...): thrown by
// Decoder::decode and Decoder::probe.
struct Error {
  std::string msg;
};

// What the pictures decoded so far used (Decoder::features), so a test can
// show that a stream exercises what it claims to.
enum Feature : uint64_t {
  kIdr = 1ull << 0,              // an IDR picture
  kNonIdrIntra = 1ull << 1,      // an I picture that is not an IDR
  kPSlice = 1ull << 2,           // P slices
  kIntra4x4 = 1ull << 3,         // Intra_4x4 macroblocks
  kIntra16x16 = 1ull << 4,       // Intra_16x16 macroblocks
  kPcm = 1ull << 5,              // I_PCM macroblocks
  kP16x16 = 1ull << 6,           // P_L0_16x16
  kP16x8 = 1ull << 7,            // P_L0_L0_16x8
  kP8x16 = 1ull << 8,            // P_L0_L0_8x16
  kP8x8 = 1ull << 9,             // P_8x8
  kP8x8Ref0 = 1ull << 10,        // P_8x8ref0
  kSub8x4 = 1ull << 11,          // 8x4 sub-macroblock partitions
  kSub4x8 = 1ull << 12,          // 4x8
  kSub4x4 = 1ull << 13,          // 4x4
  kSkip = 1ull << 14,            // P_Skip macroblocks
  kIntraInP = 1ull << 15,        // intra macroblocks in P slices
  kMultiRef = 1ull << 16,        // a reference index above 0
  kListModification = 1ull << 17,  // ref_pic_list_modification
  kLongTerm = 1ull << 18,        // long-term references
  kMmco1 = 1ull << 19,           // memory_management_control_operation 1 .. 6
  kMmco2 = 1ull << 20,
  kMmco3 = 1ull << 21,
  kMmco4 = 1ull << 22,
  kMmco5 = 1ull << 23,
  kMmco6 = 1ull << 24,
  kNonRef = 1ull << 25,          // pictures with nal_ref_idc 0
  kPocType0 = 1ull << 26,        // pic_order_cnt_type 0, 1, 2
  kPocType1 = 1ull << 27,
  kPocType2 = 1ull << 28,
  kFrameNumWrap = 1ull << 29,    // frame_num wrapping past MaxFrameNum
  kFrameNumGap = 1ull << 30,     // a gap in frame_num (gaps_in_frame_num_allowed_flag)
  kSlices = 1ull << 31,          // several slices a picture
  kDeblockOff = 1ull << 32,      // disable_deblocking_filter_idc 1
  kDeblockSliceEdges = 1ull << 33,  // disable_deblocking_filter_idc 2
  kDeblockOffsets = 1ull << 34,  // slice alpha / beta offsets
  kConstrainedIntra = 1ull << 35,  // constrained_intra_pred_flag
  kCropping = 1ull << 36,        // frame cropping
  kColourDescription = 1ull << 37,  // a VUI colour description
  kFullRange = 1ull << 38,       // video_full_range_flag
  kHighProfile = 1ull << 39,     // an SPS of profile_idc 100 or above
  kAud = 1ull << 40,             // access unit delimiters
  kSei = 1ull << 41,             // SEI
  kFiller = 1ull << 42,          // filler data
  kOtherNal = 1ull << 43,        // end of sequence / stream, SVC / MVC units, skipped
  kLevelEscape = 1ull << 44,     // a level_prefix of 15 or more
  kOffFrameMv = 1ull << 45,      // a prediction reaching past the picture's edge
  kChromaQpOffset = 1ull << 46,  // chroma_qp_index_offset other than 0
  kSecondChromaQpOffset = 1ull << 47,  // a Cr offset other than the Cb one
  kAnnexB = 1ull << 48,          // start codes
  kLengthPrefix = 1ull << 49,    // length-prefixed NAL units (avcC)
  kTimingInfo = 1ull << 50,      // VUI timing info
  kBitstreamRestriction = 1ull << 51,  // VUI bitstream_restriction
  kParameterSetIds = 1ull << 52,  // a parameter set id above 0, or a set sent again
  kQpDelta = 1ull << 53,         // mb_qp_delta other than 0
  kFractionalMv = 1ull << 54,    // quarter-sample motion vectors
  kLevelPrefix16 = 1ull << 55,   // a level_prefix of 16 or more (High profiles)
  kCabac = 1ull << 56,           // CABAC slices (entropy_coding_mode_flag 1)
  kTransform8x8 = 1ull << 57,    // macroblocks with transform_size_8x8_flag 1
  kIntra8x8 = 1ull << 58,        // I_NxN macroblocks with the 8x8 transform (Intra_8x8)
  kScalingSps = 1ull << 59,      // scaling matrices in the sequence parameter set
  kScalingPps = 1ull << 60,      // scaling matrices in the picture parameter set
  kScalingDefault = 1ull << 61,  // a default scaling list (useDefaultScalingMatrixFlag or rule A)
  kPcmCabac = 1ull << 62,        // I_PCM in a CABAC slice (the engine initialised after it)
  kScalingFallback = 1ull << 63,  // a scaling list taken from another by fall-back rule A or B
};

// More of what the pictures decoded so far used (Decoder::features2).
enum Feature2 : uint64_t {
  kBSlice = 1ull << 0,            // B slices
  kB8x8 = 1ull << 1,              // B_8x8
  kSpatialDirect = 1ull << 2,     // direct_spatial_mv_pred_flag 1
  kTemporalDirect = 1ull << 3,    // direct_spatial_mv_pred_flag 0
  kExplicitWeights = 1ull << 4,   // a pred_weight_table other than the defaults
  kImplicitWeights = 1ull << 5,   // weighted_bipred_idc 2
  kReferenceB = 1ull << 6,        // B pictures with nal_ref_idc other than 0
  kReordered = 1ull << 7,         // a picture shown before one decoded earlier
  kBiPred = 1ull << 8,            // bi-predicted partitions
  kBSkip = 1ull << 9,             // B_Skip
  kDirect16x16 = 1ull << 10,      // B_Direct_16x16
  kDirect8x8 = 1ull << 11,        // B_Direct_8x8 sub-macroblocks
  kDirect4x4 = 1ull << 12,        // direct prediction without direct_8x8_inference_flag
  kListModification1 = 1ull << 13,  // ref_pic_list_modification of list 1
  kIntraInB = 1ull << 14,         // intra macroblocks in B slices
  kDropped = 1ull << 15,          // a picture FFmpeg does not show (its order count too low)
};

// The CABAC context variables a frame-coded I / P / B 4:2:0 stream can use:
// ctxIdx below kContexts (9.3.1.1).
constexpr int kContexts = 460;

class Decoder {
 public:
  // `config` is an avcC (AVCDecoderConfigurationRecord): its length size
  // and parameter sets; or parameter sets with start codes, or nothing, for
  // an Annex B stream.  Throws Error.
  Decoder(const uint8_t* config, size_t size);
  ~Decoder();
  Decoder(const Decoder&) = delete;
  Decoder& operator=(const Decoder&) = delete;

  // Decode one sample (an access unit).  True when a picture is shown, the
  // one FFmpeg gives out then (h264_select_output_frame): pictures wait while
  // the reorder depth needs and leave by picture order count, a picture
  // whose order count falls below the last shown is not shown, and the
  // depth grows with the order counts seen unless the SPS's VUI states it
  // (bitstream_restriction).  A sample of parameter sets or SEI alone shows
  // nothing.  Throws Error; the decoder's state is then undefined.
  bool decode(const uint8_t* data, size_t size);

  // At the end of the stream: true while a picture is left to show (the
  // next, by order count), false when none is.
  bool flush();

  // Parse a sample's parameter sets and slice headers without decoding a
  // macroblock, refusing what decode would refuse for them; true when the
  // sample holds a picture.  A decoder that probes does not decode.
  bool probe(const uint8_t* data, size_t size);

  // The reorder depth (FFmpeg's has_b_frames) to start from: what the
  // container (an MP4's composition offsets) and FFmpeg's stream probe set
  // before the first sample.  After probing the samples, probed_reorder is
  // the depth FFmpeg's avformat_find_stream_info leaves, which a decoder
  // of the stream then starts from.
  void set_reorder(int frames);
  int probed_reorder() const;

  // The picture size after cropping, as FFmpeg crops it (0 before the first
  // sequence parameter set).
  int width() const;
  int height() const;
  // The planes of the picture shown last: c 0 is Y, 1 Cb, 2 Cr; null before
  // the first picture.
  const uint8_t* plane(int c) const;
  int stride(int c) const;
  uint64_t features() const;
  uint64_t features2() const;
  // The VUI's matrix_coefficients (2, unspecified, without a colour
  // description) and video_full_range_flag of the active sequence
  // parameter set.
  int matrix() const;
  bool full_range() const;
  // The active SPS's VUI timing: num_units_in_tick and time_scale (0 without
  // timing info).
  uint32_t num_units_in_tick() const;
  uint32_t time_scale() const;
  // Which CABAC context variables (ctxIdx 0 .. kContexts - 1) the decoder
  // has read a bin with since it was made: `out` takes kContexts flags.
  void contexts(uint8_t* out) const;

 private:
  struct Impl;
  std::unique_ptr<Impl> impl_;
};

}  // namespace vd_h264
