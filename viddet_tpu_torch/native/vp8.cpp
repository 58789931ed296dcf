// VP8 video (RFC 6386), decoded as FFmpeg's vp8 decoder decodes it, which
// is bit for bit what the reference decoder (libvpx) gives: the frames of
// a WebM / Matroska V_VP8 track, which native/mkv.py indexes.
//
//   stream    the frame tag (key frame, version, show_frame, first partition
//             size), a key frame's start code and 14-bit size (its two
//             scaling bits are read and not applied: the frame comes out at
//             its coded size, as FFmpeg outputs it), colour space and
//             clamping type (read; reconstruction always clamps), the boolean
//             entropy decoder, segmentation (map with its tree
//             probabilities, per-segment quantiser and loop filter level,
//             absolute or delta, the map kept from frame to frame when not
//             updated), the loop filter header (type, level, sharpness,
//             reference and mode deltas), 1, 2, 4 or 8 token partitions,
//             the quantiser index with its five deltas, golden / alt-ref
//             refresh, buffer copies and sign biases, refresh_entropy_probs
//             (the probabilities saved and restored around a frame),
//             refresh_last, coefficient probability updates and
//             mb_no_coeff_skip.
//   modes     key-frame modes with the contextual B_PRED sub-mode
//             probabilities; inter-frame intra modes with the frame's
//             probabilities; reference frame, the near-vector search with
//             its sign-bias inversion and clamping, nearest / near / zero /
//             new vectors and split vectors (16x8, 8x16, 8x8, 4x4) with
//             their left / above contexts.
//   residual  coefficient tokens with their above / left contexts and the
//             skip flag's context reset, dequantisation (y2 DC x2, y2 AC
//             x155/100 at least 8, chroma DC at most 132), the inverse WHT
//             and IDCT in 16-bit intermediates.
//   predict   16x16 and chroma DC / V / H / TM and B_PRED's ten sub-modes
//             from the unfiltered frame, with the reference decoder's edge:
//             127 above the frame, 129 left of it, DC from the available
//             sides only, and the above-right of a macroblock's right
//             column taken from the macroblock above-right (from the last
//             pixel of the row above in the last column, 127 in the first
//             row); inter prediction with the six-tap filters (version 0)
//             or the bilinear ones (versions 1-3), full-pixel chroma in
//             version 3, chroma vectors averaged over four luma vectors in
//             4x4 splits, and pixels beyond the macroblock-aligned frame
//             replicated from its edge as far as a vector reaches.
//   filter    the normal loop filter (macroblock and sub-block edges,
//             interior and edge limits, high edge variance threshold by
//             frame type) and the simple one, per-macroblock levels from
//             the segment and the deltas; a macroblock without coefficients
//             that is neither B_PRED nor split skips its inner edges.
//
// Hidden frames (show_frame 0) are decoded and update the references but are
// not shown.  The references are released or copied as the header says,
// after the frame, from the buffers before it.

#include "vp8.h"

#include <algorithm>
#include <array>
#include <cstdarg>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace vd_vp8 {
namespace {

[[noreturn]] __attribute__((format(printf, 1, 2))) void fail(const char* fmt, ...) {
  char buf[256];
  va_list ap;
  va_start(ap, fmt);
  std::vsnprintf(buf, sizeof(buf), fmt, ap);
  va_end(ap);
  throw Error{buf};
}

// ---------------------------------------------------------------- tables

// The RFC's default and update probabilities, key-frame B_PRED sub-mode
// probabilities, motion vector probabilities and quantiser steps.
const uint8_t kCoefDefault[4][8][3][11] = {
   {{{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
    {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
    {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
   {{253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128},
    {189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128},
    {106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128}},
   {{1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128},
    {181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128},
    {78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128}},
   {{1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128},
    {184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128},
    {77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128}},
   {{1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128},
    {170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128},
    {37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128}},
   {{1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128},
    {207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128},
    {102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128}},
   {{1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128},
    {177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128},
    {80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128}},
   {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
    {246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
    {255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}}},
  {{{198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62},
    {131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1},
    {68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128}},
   {{1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128},
    {184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128},
    {81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128}},
   {{1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128},
    {99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128},
    {23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128}},
   {{1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128},
    {109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128},
    {44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128}},
   {{1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128},
    {94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128},
    {22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128}},
   {{1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128},
    {124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128},
    {35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128}},
   {{1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128},
    {121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128},
    {45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128}},
   {{1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128},
    {203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128},
    {137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128}}},
  {{{253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128},
    {175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128},
    {73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128}},
   {{1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128},
    {239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128},
    {155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128}},
   {{1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128},
    {201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128},
    {69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128}},
   {{1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128},
    {223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128},
    {141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128}},
   {{1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128},
    {190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128},
    {149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
   {{1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128},
    {247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128},
    {240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
   {{1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128},
    {213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128},
    {55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
   {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
    {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
    {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}}},
  {{{202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255},
    {126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128},
    {61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128}},
   {{1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128},
    {166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128},
    {39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128}},
   {{1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128},
    {124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128},
    {24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128}},
   {{1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128},
    {149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128},
    {28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128}},
   {{1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128},
    {123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128},
    {20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128}},
   {{1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128},
    {168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128},
    {47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128}},
   {{1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128},
    {141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128},
    {42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128}},
   {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
    {244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
    {238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}}}};
const uint8_t kCoefUpdate[4][8][3][11] = {{{{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255},
    {249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255},
    {234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
    {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255},
    {239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
    {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
    {251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
    {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
    {251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
    {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255},
    {250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255},
    {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}},
  {{{217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255},
    {234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255}},
   {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
    {238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
    {249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
    {252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
    {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
    {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}},
  {{{186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255},
    {234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255},
    {251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255}},
   {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
    {236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
    {251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255}},
   {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
    {254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
    {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}},
  {{{248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255},
    {248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
    {246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
    {252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255}},
   {{255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255},
    {248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
    {253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
    {245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
    {253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255},
    {252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
    {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
    {255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255},
    {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}}};
const uint8_t kKfBmodeProb[10][10][9] = {{{231, 120, 48, 89, 115, 113, 120, 152, 112},
   {152, 179, 64, 126, 170, 118, 46, 70, 95},
   {175, 69, 143, 80, 85, 82, 72, 155, 103},
   {56, 58, 10, 171, 218, 189, 17, 13, 152},
   {144, 71, 10, 38, 171, 213, 144, 34, 26},
   {114, 26, 17, 163, 44, 195, 21, 10, 173},
   {121, 24, 80, 195, 26, 62, 44, 64, 85},
   {170, 46, 55, 19, 136, 160, 33, 206, 71},
   {63, 20, 8, 114, 114, 208, 12, 9, 226},
   {81, 40, 11, 96, 182, 84, 29, 16, 36}},
  {{134, 183, 89, 137, 98, 101, 106, 165, 148},
   {72, 187, 100, 130, 157, 111, 32, 75, 80},
   {66, 102, 167, 99, 74, 62, 40, 234, 128},
   {41, 53, 9, 178, 241, 141, 26, 8, 107},
   {104, 79, 12, 27, 217, 255, 87, 17, 7},
   {74, 43, 26, 146, 73, 166, 49, 23, 157},
   {65, 38, 105, 160, 51, 52, 31, 115, 128},
   {87, 68, 71, 44, 114, 51, 15, 186, 23},
   {47, 41, 14, 110, 182, 183, 21, 17, 194},
   {66, 45, 25, 102, 197, 189, 23, 18, 22}},
  {{88, 88, 147, 150, 42, 46, 45, 196, 205},
   {43, 97, 183, 117, 85, 38, 35, 179, 61},
   {39, 53, 200, 87, 26, 21, 43, 232, 171},
   {56, 34, 51, 104, 114, 102, 29, 93, 77},
   {107, 54, 32, 26, 51, 1, 81, 43, 31},
   {39, 28, 85, 171, 58, 165, 90, 98, 64},
   {34, 22, 116, 206, 23, 34, 43, 166, 73},
   {68, 25, 106, 22, 64, 171, 36, 225, 114},
   {34, 19, 21, 102, 132, 188, 16, 76, 124},
   {62, 18, 78, 95, 85, 57, 50, 48, 51}},
  {{193, 101, 35, 159, 215, 111, 89, 46, 111},
   {60, 148, 31, 172, 219, 228, 21, 18, 111},
   {112, 113, 77, 85, 179, 255, 38, 120, 114},
   {40, 42, 1, 196, 245, 209, 10, 25, 109},
   {100, 80, 8, 43, 154, 1, 51, 26, 71},
   {88, 43, 29, 140, 166, 213, 37, 43, 154},
   {61, 63, 30, 155, 67, 45, 68, 1, 209},
   {142, 78, 78, 16, 255, 128, 34, 197, 171},
   {41, 40, 5, 102, 211, 183, 4, 1, 221},
   {51, 50, 17, 168, 209, 192, 23, 25, 82}},
  {{125, 98, 42, 88, 104, 85, 117, 175, 82},
   {95, 84, 53, 89, 128, 100, 113, 101, 45},
   {75, 79, 123, 47, 51, 128, 81, 171, 1},
   {57, 17, 5, 71, 102, 57, 53, 41, 49},
   {115, 21, 2, 10, 102, 255, 166, 23, 6},
   {38, 33, 13, 121, 57, 73, 26, 1, 85},
   {41, 10, 67, 138, 77, 110, 90, 47, 114},
   {101, 29, 16, 10, 85, 128, 101, 196, 26},
   {57, 18, 10, 102, 102, 213, 34, 20, 43},
   {117, 20, 15, 36, 163, 128, 68, 1, 26}},
  {{138, 31, 36, 171, 27, 166, 38, 44, 229},
   {67, 87, 58, 169, 82, 115, 26, 59, 179},
   {63, 59, 90, 180, 59, 166, 93, 73, 154},
   {40, 40, 21, 116, 143, 209, 34, 39, 175},
   {57, 46, 22, 24, 128, 1, 54, 17, 37},
   {47, 15, 16, 183, 34, 223, 49, 45, 183},
   {46, 17, 33, 183, 6, 98, 15, 32, 183},
   {65, 32, 73, 115, 28, 128, 23, 128, 205},
   {40, 3, 9, 115, 51, 192, 18, 6, 223},
   {87, 37, 9, 115, 59, 77, 64, 21, 47}},
  {{104, 55, 44, 218, 9, 54, 53, 130, 226},
   {64, 90, 70, 205, 40, 41, 23, 26, 57},
   {54, 57, 112, 184, 5, 41, 38, 166, 213},
   {30, 34, 26, 133, 152, 116, 10, 32, 134},
   {75, 32, 12, 51, 192, 255, 160, 43, 51},
   {39, 19, 53, 221, 26, 114, 32, 73, 255},
   {31, 9, 65, 234, 2, 15, 1, 118, 73},
   {88, 31, 35, 67, 102, 85, 55, 186, 85},
   {56, 21, 23, 111, 59, 205, 45, 37, 192},
   {55, 38, 70, 124, 73, 102, 1, 34, 98}},
  {{102, 61, 71, 37, 34, 53, 31, 243, 192},
   {69, 60, 71, 38, 73, 119, 28, 222, 37},
   {68, 45, 128, 34, 1, 47, 11, 245, 171},
   {62, 17, 19, 70, 146, 85, 55, 62, 70},
   {75, 15, 9, 9, 64, 255, 184, 119, 16},
   {37, 43, 37, 154, 100, 163, 85, 160, 1},
   {63, 9, 92, 136, 28, 64, 32, 201, 85},
   {86, 6, 28, 5, 64, 255, 25, 248, 1},
   {56, 8, 17, 132, 137, 255, 55, 116, 128},
   {58, 15, 20, 82, 135, 57, 26, 121, 40}},
  {{164, 50, 31, 137, 154, 133, 25, 35, 218},
   {51, 103, 44, 131, 131, 123, 31, 6, 158},
   {86, 40, 64, 135, 148, 224, 45, 183, 128},
   {22, 26, 17, 131, 240, 154, 14, 1, 209},
   {83, 12, 13, 54, 192, 255, 68, 47, 28},
   {45, 16, 21, 91, 64, 222, 7, 1, 197},
   {56, 21, 39, 155, 60, 138, 23, 102, 213},
   {85, 26, 85, 85, 128, 128, 32, 146, 171},
   {18, 11, 7, 63, 144, 171, 4, 4, 246},
   {35, 27, 10, 146, 174, 171, 12, 26, 128}},
  {{190, 80, 35, 99, 180, 80, 126, 54, 45},
   {85, 126, 47, 87, 176, 51, 41, 20, 32},
   {101, 75, 128, 139, 118, 146, 116, 128, 85},
   {56, 41, 15, 176, 236, 85, 37, 9, 62},
   {146, 36, 19, 30, 171, 255, 97, 27, 20},
   {71, 30, 17, 119, 118, 255, 17, 18, 138},
   {101, 38, 60, 138, 55, 70, 43, 26, 142},
   {138, 45, 61, 62, 219, 1, 81, 188, 64},
   {32, 41, 20, 117, 151, 142, 20, 21, 163},
   {112, 19, 12, 61, 195, 128, 48, 4, 24}}};
const uint8_t kMvDefault[2][19] = {
    {162, 128, 225, 146, 172, 147, 214, 39, 156, 128, 129, 132, 75, 145, 178, 206, 239, 254, 254},
    {164, 128, 204, 170, 119, 235, 140, 230, 228, 128, 130, 130, 74, 148, 180, 203, 236, 254, 254}};
const uint8_t kMvUpdate[2][19] = {
    {237, 246, 253, 253, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 250, 250, 252, 254, 254},
    {231, 243, 245, 253, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 251, 251, 254, 254,
     254}};
const uint8_t kDcQ[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157};
const uint16_t kAcQ[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284};

const uint8_t kKfYmodeProb[4] = {145, 156, 163, 128};
const uint8_t kKfUvModeProb[3] = {142, 114, 183};
const uint8_t kYmodeProbDefault[4] = {112, 86, 140, 37};
const uint8_t kUvModeProbDefault[3] = {162, 101, 204};
const uint8_t kBmodeProbInter[9] = {120, 90, 79, 133, 87, 85, 80, 111, 151};
const uint8_t kModeContexts[6][4] = {{7, 1, 1, 143},     {14, 18, 14, 107}, {135, 64, 57, 68},
                                     {60, 56, 128, 65},  {159, 134, 128, 34}, {234, 188, 128, 28}};
const uint8_t kSplitProb[3] = {110, 111, 150};
const uint8_t kSubMvProb[5][3] = {{147, 136, 18}, {106, 145, 1}, {179, 121, 1}, {223, 1, 34},
                                  {208, 1, 1}};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCatProbs[4] = {kCat3, kCat4, kCat5, kCat6};
const int16_t kSixtap[8][6] = {{0, 0, 128, 0, 0, 0},     {0, -6, 123, 12, -1, 0},
                              {2, -11, 108, 36, -8, 1}, {0, -9, 93, 50, -6, 0},
                              {3, -16, 77, 77, -16, 3}, {0, -6, 50, 93, -9, 0},
                              {1, -8, 36, 108, -11, 2}, {0, -1, 12, 123, -6, 0}};
// the partition of each 4x4 luma block, by split type, and each
// partition's first block
const uint8_t kSplits[5][16] = {{0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1},
                                {0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1},
                                {0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3},
                                {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
                                {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}};
const uint8_t kSplitFirst[4][16] = {{0, 8},
                                    {0, 2},
                                    {0, 2, 8, 10},
                                    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15}};
const int kSplitCount[4] = {2, 2, 4, 16};

// Macroblock modes: the intra ones, then the inter ones (nearest, near and
// new are one mode to the loop filter's deltas, as in FFmpeg).
enum Mode : uint8_t { DC_PRED, V_PRED, H_PRED, TM_PRED, B_PRED, ZERO_MV, MV_PRED, SPLIT_MV };
enum SubMode : uint8_t {
  B_DC_PRED, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_LD_PRED,
  B_RD_PRED, B_VR_PRED, B_VL_PRED, B_HD_PRED, B_HU_PRED
};
enum Split : uint8_t { kSplit16x8, kSplit8x16, kSplit8x8, kSplit4x4, kSplitNone };
enum Ref : uint8_t { kIntra, kLast, kGolden, kAltref };

const int8_t kKfYmodeTree[8] = {-B_PRED, 2, 4, 6, -DC_PRED, -V_PRED, -H_PRED, -TM_PRED};
const int8_t kYmodeTree[8] = {-DC_PRED, 2, 4, 6, -V_PRED, -H_PRED, -TM_PRED, -B_PRED};
const int8_t kUvModeTree[6] = {-DC_PRED, 2, -V_PRED, 4, -H_PRED, -TM_PRED};
const int8_t kBmodeTree[18] = {-B_DC_PRED, 2, -B_TM_PRED, 4, -B_VE_PRED, 6, 8, 12, -B_HE_PRED,
                               10, -B_RD_PRED, -B_VR_PRED, -B_LD_PRED, 14, -B_VL_PRED, 16,
                               -B_HD_PRED, -B_HU_PRED};
const int8_t kSmallMvTree[14] = {2, 8, 4, 6, -0, -1, -2, -3, 10, 12, -4, -5, -6, -7};

inline uint8_t clip8(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }
inline int clip_s8(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }

// ---------------------------------------------------------------- entropy decoder

// RFC 6386 section 7's boolean decoder; past the end of its data it reads
// zeros, as the reference decoder does.
class BoolDecoder {
 public:
  void init(const uint8_t* data, size_t size) {
    pos_ = data;
    end_ = data + size;
    value_ = 0;
    count_ = -8;
    range_ = 255;
    bits_ = 8 * static_cast<uint64_t>(size);
    shifts_ = 0;
    overrun_ = size == 0;
    fill();
  }

  // Whether a read needed bits past the end of the data (libwebp's eof_: a
  // read with fewer than 8 unread bits left; an empty partition from the start).
  bool overrun() const { return overrun_; }
  bool size_zero() const { return bits_ == 0; }

  int read(int prob) {
    if (shifts_ + 8 > bits_) overrun_ = true;
    const uint32_t split = 1 + (((range_ - 1) * static_cast<uint32_t>(prob)) >> 8);
    if (count_ < 0) fill();
    const uint64_t big = static_cast<uint64_t>(split) << 56;
    int bit;
    if (value_ >= big) {
      range_ -= split;
      value_ -= big;
      bit = 1;
    } else {
      range_ = split;
      bit = 0;
    }
    const int shift = __builtin_clz(range_) - 24;
    range_ <<= shift;
    value_ <<= shift;
    count_ -= shift;
    shifts_ += shift;
    return bit;
  }

  int bit() { return read(128); }

  int literal(int bits) {
    int v = 0;
    while (bits--) v = (v << 1) | bit();
    return v;
  }

  // A magnitude of `bits` bits and a sign, each behind a flag (0 without).
  int signed_literal(int bits) {
    if (!bit()) return 0;
    const int v = literal(bits);
    return bit() ? -v : v;
  }

  int tree(const int8_t* t, const uint8_t* probs) {
    int i = 0;
    while ((i = t[i + read(probs[i >> 1])]) > 0) {
    }
    return -i;
  }

 private:
  void fill() {
    int shift = 64 - 8 - (count_ + 8);
    while (shift >= 0) {
      if (pos_ >= end_) {
        count_ += 0x4000;  // zeros from here on
        return;
      }
      count_ += 8;
      value_ |= static_cast<uint64_t>(*pos_++) << shift;
      shift -= 8;
    }
  }

  const uint8_t* pos_ = nullptr;
  const uint8_t* end_ = nullptr;
  uint64_t value_ = 0;
  int count_ = 0;
  uint32_t range_ = 255;
  uint64_t bits_ = 0, shifts_ = 0;  // the data's bits, and the bits read so far
  bool overrun_ = false;
};

// ---------------------------------------------------------------- state

struct Mv {
  int16_t x = 0, y = 0;  // quarter samples
  bool operator==(const Mv& o) const { return x == o.x && y == o.y; }
  bool operator!=(const Mv& o) const { return !(*this == o); }
  bool zero() const { return !x && !y; }
};

struct MbInfo {
  uint8_t mode = DC_PRED, uv_mode = DC_PRED, ref = kIntra, segment = 0;
  uint8_t skip = 0, split = kSplitNone;
  Mv mv;
  Mv bmv[16];          // the vector of each partition (bmv[0] when not split)
  uint8_t bmodes[16];  // B_PRED sub-modes
};

struct Probs {
  uint8_t coef[4][8][3][11];
  uint8_t ymode[4];
  uint8_t uv_mode[3];
  uint8_t mv[2][19];
};

struct Quant {
  int y_dc, y_ac, y2_dc, y2_ac, uv_dc, uv_ac;
};

struct Frame {
  int w = 0, h = 0;  // macroblock-aligned luma size
  std::vector<uint8_t> y, u, v;
  void reset(int width, int height) {
    w = width;
    h = height;
    y.assign(static_cast<size_t>(w) * h, 0);
    u.assign(static_cast<size_t>(w / 2) * (h / 2), 0);
    v.assign(static_cast<size_t>(w / 2) * (h / 2), 0);
  }
};

struct LoopFilterMb {
  uint8_t level, interior, inner;
};

// ---------------------------------------------------------------- pixel kernels

inline int avg2(int a, int b) { return (a + b + 1) >> 1; }
inline int avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }

// One 4x4 sub-block prediction into `d` (stride `s`), whose above row
// (with the above-right four after it) and left column are those of the
// same buffer: d[-s + i], d[i * s - 1], d[-s - 1].
void predict4(uint8_t* d, int s, int mode) {
  const uint8_t* a = d - s;
  const int p = a[-1];
  const int l[4] = {d[-1], d[s - 1], d[2 * s - 1], d[3 * s - 1]};
  const int e[9] = {l[3], l[2], l[1], l[0], p, a[0], a[1], a[2], a[3]};  // edge, bottom-left up
  uint8_t b[4][4];
  switch (mode) {
    case B_DC_PRED: {
      int v = 4;
      for (int i = 0; i < 4; ++i) v += a[i] + l[i];
      std::memset(b, v >> 3, sizeof(b));
      break;
    }
    case B_TM_PRED:
      for (int r = 0; r < 4; ++r)
        for (int c = 0; c < 4; ++c) b[r][c] = clip8(l[r] + a[c] - p);
      break;
    case B_VE_PRED:
      for (int c = 0; c < 4; ++c) {
        const uint8_t v = static_cast<uint8_t>(avg3(c ? a[c - 1] : p, a[c], a[c + 1]));
        for (int r = 0; r < 4; ++r) b[r][c] = v;
      }
      break;
    case B_HE_PRED: {
      const int v[4] = {avg3(p, l[0], l[1]), avg3(l[0], l[1], l[2]), avg3(l[1], l[2], l[3]),
                        avg3(l[2], l[3], l[3])};
      for (int r = 0; r < 4; ++r) std::memset(b[r], v[r], 4);
      break;
    }
    case B_LD_PRED:
      for (int r = 0; r < 4; ++r)
        for (int c = 0; c < 4; ++c) {
          const int i = r + c;
          b[r][c] = static_cast<uint8_t>(i == 6 ? avg3(a[6], a[7], a[7])
                                                : avg3(a[i], a[i + 1], a[i + 2]));
        }
      break;
    case B_RD_PRED:
      for (int r = 0; r < 4; ++r)
        for (int c = 0; c < 4; ++c) {
          const int i = 4 - r + c;
          b[r][c] = static_cast<uint8_t>(avg3(e[i - 1], e[i], e[i + 1]));
        }
      break;
    case B_VR_PRED:
      b[3][0] = avg3(e[1], e[2], e[3]);
      b[2][0] = avg3(e[2], e[3], e[4]);
      b[3][1] = b[1][0] = avg3(e[3], e[4], e[5]);
      b[2][1] = b[0][0] = avg2(e[4], e[5]);
      b[3][2] = b[1][1] = avg3(e[4], e[5], e[6]);
      b[2][2] = b[0][1] = avg2(e[5], e[6]);
      b[3][3] = b[1][2] = avg3(e[5], e[6], e[7]);
      b[2][3] = b[0][2] = avg2(e[6], e[7]);
      b[1][3] = avg3(e[6], e[7], e[8]);
      b[0][3] = avg2(e[7], e[8]);
      break;
    case B_VL_PRED:
      b[0][0] = avg2(a[0], a[1]);
      b[1][0] = avg3(a[0], a[1], a[2]);
      b[2][0] = b[0][1] = avg2(a[1], a[2]);
      b[1][1] = b[3][0] = avg3(a[1], a[2], a[3]);
      b[2][1] = b[0][2] = avg2(a[2], a[3]);
      b[3][1] = b[1][2] = avg3(a[2], a[3], a[4]);
      b[2][2] = b[0][3] = avg2(a[3], a[4]);
      b[3][2] = b[1][3] = avg3(a[3], a[4], a[5]);
      b[2][3] = avg3(a[4], a[5], a[6]);
      b[3][3] = avg3(a[5], a[6], a[7]);
      break;
    case B_HD_PRED:
      b[3][0] = avg2(e[0], e[1]);
      b[3][1] = avg3(e[0], e[1], e[2]);
      b[2][0] = b[3][2] = avg2(e[1], e[2]);
      b[2][1] = b[3][3] = avg3(e[1], e[2], e[3]);
      b[2][2] = b[1][0] = avg2(e[2], e[3]);
      b[2][3] = b[1][1] = avg3(e[2], e[3], e[4]);
      b[1][2] = b[0][0] = avg2(e[3], e[4]);
      b[1][3] = b[0][1] = avg3(e[3], e[4], e[5]);
      b[0][2] = avg3(e[4], e[5], e[6]);
      b[0][3] = avg3(e[5], e[6], e[7]);
      break;
    default:  // B_HU_PRED
      b[0][0] = avg2(l[0], l[1]);
      b[0][1] = avg3(l[0], l[1], l[2]);
      b[0][2] = b[1][0] = avg2(l[1], l[2]);
      b[0][3] = b[1][1] = avg3(l[1], l[2], l[3]);
      b[1][2] = b[2][0] = avg2(l[2], l[3]);
      b[1][3] = b[2][1] = avg3(l[2], l[3], l[3]);
      b[2][2] = b[2][3] = b[3][0] = b[3][1] = b[3][2] = b[3][3] = static_cast<uint8_t>(l[3]);
      break;
  }
  for (int r = 0; r < 4; ++r) std::memcpy(d + r * s, b[r], 4);
}

// A whole-block (16x16 luma or 8x8 chroma) prediction into `d`, whose
// above row, left column and corner are those of the same buffer; DC uses
// only the sides that lie in the frame.
void predict_block(uint8_t* d, int s, int n, int mode, bool have_above, bool have_left) {
  const uint8_t* a = d - s;
  switch (mode) {
    case DC_PRED: {
      int sum = 0, shift = n == 16 ? 3 : 2;
      if (have_above)
        for (int i = 0; i < n; ++i) sum += a[i];
      if (have_left)
        for (int i = 0; i < n; ++i) sum += d[i * s - 1];
      const int v = have_above && have_left ? (sum + n) >> (shift + 2)
                    : have_above || have_left ? (sum + n / 2) >> (shift + 1)
                                              : 128;
      for (int r = 0; r < n; ++r) std::memset(d + r * s, v, n);
      break;
    }
    case V_PRED:
      for (int r = 0; r < n; ++r) std::memcpy(d + r * s, a, n);
      break;
    case H_PRED:
      for (int r = 0; r < n; ++r) std::memset(d + r * s, d[r * s - 1], n);
      break;
    default: {  // TM_PRED
      const int p = a[-1];
      for (int r = 0; r < n; ++r) {
        const int l = d[r * s - 1] - p;
        for (int c = 0; c < n; ++c) d[r * s + c] = clip8(l + a[c]);
      }
      break;
    }
  }
}

// The inverse transforms, in 16-bit intermediates as FFmpeg's vp8dsp.
inline int mul_20091(int a) { return ((a * 20091) >> 16) + a; }
inline int mul_35468(int a) { return (a * 35468) >> 16; }

void idct_add(uint8_t* d, int s, const int16_t* in) {
  int16_t tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int t0 = in[i] + in[8 + i], t1 = in[i] - in[8 + i];
    const int t2 = mul_35468(in[4 + i]) - mul_20091(in[12 + i]);
    const int t3 = mul_20091(in[4 + i]) + mul_35468(in[12 + i]);
    tmp[i * 4 + 0] = static_cast<int16_t>(t0 + t3);
    tmp[i * 4 + 1] = static_cast<int16_t>(t1 + t2);
    tmp[i * 4 + 2] = static_cast<int16_t>(t1 - t2);
    tmp[i * 4 + 3] = static_cast<int16_t>(t0 - t3);
  }
  for (int i = 0; i < 4; ++i) {
    const int t0 = tmp[i] + tmp[8 + i], t1 = tmp[i] - tmp[8 + i];
    const int t2 = mul_35468(tmp[4 + i]) - mul_20091(tmp[12 + i]);
    const int t3 = mul_20091(tmp[4 + i]) + mul_35468(tmp[12 + i]);
    uint8_t* r = d + i * s;
    r[0] = clip8(r[0] + ((t0 + t3 + 4) >> 3));
    r[1] = clip8(r[1] + ((t1 + t2 + 4) >> 3));
    r[2] = clip8(r[2] + ((t1 - t2 + 4) >> 3));
    r[3] = clip8(r[3] + ((t0 - t3 + 4) >> 3));
  }
}

// The residual of one 4x4 block: the DC-only shortcut where every AC
// coefficient is 0, where it equals the whole transform.
void add_residual(uint8_t* d, int s, const int16_t* c) {
  bool ac = false;
  for (int i = 1; i < 16 && !ac; ++i) ac = c[i] != 0;
  if (ac) {
    idct_add(d, s, c);
  } else if (c[0]) {
    const int dc = (c[0] + 4) >> 3;
    for (int r = 0; r < 4; ++r)
      for (int k = 0; k < 4; ++k) d[r * s + k] = clip8(d[r * s + k] + dc);
  }
}

// The inverse Walsh-Hadamard transform of the Y2 block into the DC of the
// 16 luma blocks.
void inverse_wht(int16_t* dc, int16_t (*blocks)[16]) {
  for (int i = 0; i < 4; ++i) {
    const int t0 = dc[i] + dc[12 + i], t1 = dc[4 + i] + dc[8 + i];
    const int t2 = dc[4 + i] - dc[8 + i], t3 = dc[i] - dc[12 + i];
    dc[i] = static_cast<int16_t>(t0 + t1);
    dc[4 + i] = static_cast<int16_t>(t3 + t2);
    dc[8 + i] = static_cast<int16_t>(t0 - t1);
    dc[12 + i] = static_cast<int16_t>(t3 - t2);
  }
  for (int i = 0; i < 4; ++i) {
    const int t0 = dc[i * 4] + dc[i * 4 + 3] + 3, t1 = dc[i * 4 + 1] + dc[i * 4 + 2];
    const int t2 = dc[i * 4 + 1] - dc[i * 4 + 2], t3 = dc[i * 4] - dc[i * 4 + 3] + 3;
    blocks[i * 4 + 0][0] = static_cast<int16_t>((t0 + t1) >> 3);
    blocks[i * 4 + 1][0] = static_cast<int16_t>((t3 + t2) >> 3);
    blocks[i * 4 + 2][0] = static_cast<int16_t>((t0 - t1) >> 3);
    blocks[i * 4 + 3][0] = static_cast<int16_t>((t3 - t2) >> 3);
  }
}

// Sub-pixel interpolation of a bw x bh block whose whole-sample top-left is
// src (stride ss; the filter reaches two samples before and three after),
// at fractions mx, my in eighths: six-tap or bilinear, separable, the
// first pass (horizontal) rounded and clamped to 8 bits.
void interpolate(const uint8_t* src, int ss, uint8_t* d, int ds, int bw, int bh, int mx, int my,
                 bool bilinear) {
  uint8_t tmp[(16 + 5) * 16];
  if (bilinear) {
    const uint8_t* s = src;
    int ts = ss;
    if (mx) {
      for (int r = 0; r < bh + (my ? 1 : 0); ++r)
        for (int c = 0; c < bw; ++c)
          tmp[r * 16 + c] = static_cast<uint8_t>(
              (src[r * ss + c] * (8 - mx) + src[r * ss + c + 1] * mx + 4) >> 3);
      s = tmp;
      ts = 16;
    }
    for (int r = 0; r < bh; ++r)
      for (int c = 0; c < bw; ++c)
        d[r * ds + c] = my ? static_cast<uint8_t>((s[r * ts + c] * (8 - my) +
                                                   s[(r + 1) * ts + c] * my + 4) >> 3)
                           : s[r * ts + c];
    return;
  }
  const int16_t* fx = kSixtap[mx];
  const int16_t* fy = kSixtap[my];
  const uint8_t* s = src;
  int ts = ss;
  if (mx) {
    const int r0 = my ? -2 : 0, r1 = my ? bh + 3 : bh;
    for (int r = r0; r < r1; ++r) {
      const uint8_t* p = src + r * ss;
      for (int c = 0; c < bw; ++c)
        tmp[(r + 2) * 16 + c] = clip8((fx[0] * p[c - 2] + fx[1] * p[c - 1] + fx[2] * p[c] +
                                       fx[3] * p[c + 1] + fx[4] * p[c + 2] + fx[5] * p[c + 3] +
                                       64) >> 7);
    }
    s = tmp + 2 * 16;
    ts = 16;
  }
  for (int r = 0; r < bh; ++r)
    for (int c = 0; c < bw; ++c) {
      const uint8_t* p = s + r * ts + c;
      d[r * ds + c] = my ? clip8((fy[0] * p[-2 * ts] + fy[1] * p[-ts] + fy[2] * p[0] +
                                  fy[3] * p[ts] + fy[4] * p[2 * ts] + fy[5] * p[3 * ts] + 64) >>
                                 7)
                         : p[0];
    }
}

// The loop filters (RFC 6386 section 15, in FFmpeg's form), across the
// edge before p[0], p[k * step] being the k-th sample beyond it.
inline bool simple_limit(const uint8_t* p, int step, int e) {
  return 2 * std::abs(p[-step] - p[0]) + (std::abs(p[-2 * step] - p[step]) >> 1) <= e;
}

inline bool normal_limit(const uint8_t* p, int step, int e, int i) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  return simple_limit(p, step, e) && std::abs(p3 - p2) <= i && std::abs(p2 - p1) <= i &&
         std::abs(p1 - p0) <= i && std::abs(q3 - q2) <= i && std::abs(q2 - q1) <= i &&
         std::abs(q1 - q0) <= i;
}

inline bool high_edge_variance(const uint8_t* p, int step, int t) {
  return std::abs(p[-2 * step] - p[-step]) > t || std::abs(p[step] - p[0]) > t;
}

inline void filter_common(uint8_t* p, int step, bool outer_taps) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  int a = 3 * (q0 - p0);
  if (outer_taps) a += clip_s8(p1 - q1);
  a = clip_s8(a);
  const int f1 = std::min(a + 4, 127) >> 3;
  const int f2 = std::min(a + 3, 127) >> 3;
  p[-step] = clip8(p0 + f2);
  p[0] = clip8(q0 - f1);
  if (!outer_taps) {
    a = (f1 + 1) >> 1;
    p[-2 * step] = clip8(p1 + a);
    p[step] = clip8(q1 - a);
  }
}

inline void filter_mb_edge(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int w = clip_s8(clip_s8(p1 - q1) + 3 * (q0 - p0));
  const int a0 = (27 * w + 63) >> 7, a1 = (18 * w + 63) >> 7, a2 = (9 * w + 63) >> 7;
  p[-3 * step] = clip8(p2 + a2);
  p[-2 * step] = clip8(p1 + a1);
  p[-step] = clip8(p0 + a0);
  p[0] = clip8(q0 - a0);
  p[step] = clip8(q1 - a1);
  p[2 * step] = clip8(q2 - a2);
}

// `n` samples along an edge (stride `along`), filtered across it (`step`).
void edge_normal(uint8_t* p, int step, int along, int n, int e, int i, int hev, bool mb_edge) {
  for (int k = 0; k < n; ++k, p += along) {
    if (!normal_limit(p, step, e, i)) continue;
    if (high_edge_variance(p, step, hev))
      filter_common(p, step, true);
    else if (mb_edge)
      filter_mb_edge(p, step);
    else
      filter_common(p, step, false);
  }
}

void edge_simple(uint8_t* p, int step, int along, int e) {
  for (int k = 0; k < 16; ++k, p += along)
    if (simple_limit(p, step, e)) filter_common(p, step, true);
}

// ---------------------------------------------------------------- the decoder

}  // namespace

struct Decoder::Impl {
  int width = 0, height = 0, mb_cols = 0, mb_rows = 0;
  uint32_t features = 0;
  std::shared_ptr<Frame> ref[4];  // kLast, kGolden, kAltref (ref[kIntra] unused)
  std::shared_ptr<Frame> shown, cur;
  std::vector<std::shared_ptr<Frame>> pool;

  Probs probs, saved;
  // segmentation
  bool seg_enabled = false, seg_update_map = false, seg_absolute = false;
  int seg_quant[4] = {}, seg_level[4] = {};
  uint8_t seg_probs[3] = {255, 255, 255};
  std::vector<uint8_t> seg_map;
  // loop filter
  bool lf_deltas = false, simple_filter = false;
  int lf_level = 0, sharpness = 0;
  int lf_ref_delta[4] = {}, lf_mode_delta[4] = {};  // B_PRED, ZERO_MV, MV_PRED, SPLIT_MV
  // frame header
  bool key = false;
  int version = 0;
  Quant quant[4];
  int sign_bias[4] = {};
  int prob_skip = 0, prob_intra = 0, prob_last = 0, prob_golden = 0;
  bool skip_coded = false, refresh_last = false, refresh_entropy = false;
  int golden_source = 0, altref_source = 0;  // 0 this frame, else the buffer before it
  int partitions = 1;
  BoolDecoder tokens[8];
  bool overrun = false;  // the last frame read past the end of a partition

  std::vector<MbInfo> mbs;  // (mb_rows + 1) x (mb_cols + 1), a zero border above and left
  std::vector<uint8_t> intra_top;                   // key frames: sub-modes above, 4 a column
  std::vector<std::array<uint8_t, 9>> above_nz;     // coefficient contexts, a macroblock column
  std::vector<LoopFilterMb> lf;

  MbInfo& mb(int x, int y) { return mbs[static_cast<size_t>(y + 1) * (mb_cols + 1) + x + 1]; }

  void reset_probs() {
    std::memcpy(probs.coef, kCoefDefault, sizeof(probs.coef));
    std::memcpy(probs.ymode, kYmodeProbDefault, sizeof(probs.ymode));
    std::memcpy(probs.uv_mode, kUvModeProbDefault, sizeof(probs.uv_mode));
    std::memcpy(probs.mv, kMvDefault, sizeof(probs.mv));
  }

  std::shared_ptr<Frame> new_frame() {
    for (auto& f : pool)
      if (f.use_count() == 1) return f;
    pool.push_back(std::make_shared<Frame>());
    pool.back()->reset(mb_cols * 16, mb_rows * 16);
    return pool.back();
  }

  void set_size(int w, int h) {
    width = w;
    height = h;
    mb_cols = (w + 15) / 16;
    mb_rows = (h + 15) / 16;
    mbs.assign(static_cast<size_t>(mb_rows + 1) * (mb_cols + 1), MbInfo());
    seg_map.assign(static_cast<size_t>(mb_rows) * mb_cols, 0);
    intra_top.assign(static_cast<size_t>(mb_cols) * 4, B_DC_PRED);
    above_nz.assign(mb_cols, {});
    lf.assign(static_cast<size_t>(mb_rows) * mb_cols, LoopFilterMb());
  }

  bool decode(const uint8_t* data, size_t size);
  void read_header(BoolDecoder& bd, const uint8_t* rest, size_t rest_size);
  void read_modes(BoolDecoder& bd);
  void read_mb_modes(BoolDecoder& bd, MbInfo& m, int x, int y);
  void read_inter_modes(BoolDecoder& bd, MbInfo& m, int x, int y);
  int read_split(BoolDecoder& bd, MbInfo& m, int x, int y);
  void decode_row(int y);
  int read_coefficients(BoolDecoder& bd, int16_t (*c)[16], uint8_t* above, uint8_t* left,
                        const Quant& q, bool has_y2);
  int read_block(BoolDecoder& bd, int16_t* out, int type, int i, int ctx, int dcq, int acq);
  void predict_intra(const MbInfo& m, int x, int y, int16_t (*c)[16]);
  void predict_inter(const MbInfo& m, int x, int y);
  void mc(const std::vector<uint8_t>& plane, int pw, int ph, uint8_t* d, int ds, int x, int y,
          int mx, int my, int bw, int bh);
  void loop_filter();
};

bool Decoder::Impl::decode(const uint8_t* data, size_t size) {
  if (size < 3) fail("a frame of %zu bytes is shorter than its frame tag", size);
  const uint32_t tag = data[0] | data[1] << 8 | data[2] << 16;
  key = !(tag & 1);
  version = (tag >> 1) & 7;
  const bool show = (tag >> 4) & 1;
  const size_t first_size = tag >> 5;
  data += 3;
  size -= 3;
  if (version > 3) fail("VP8 version %d is not defined (0 to 3 are)", version);
  if (key) {
    if (size < 7) fail("a key frame of %zu bytes is shorter than its header", size + 3);
    if (data[0] != 0x9d || data[1] != 0x01 || data[2] != 0x2a)
      fail("a key frame without the start code 9d 01 2a");
    const int w = (data[3] | data[4] << 8) & 0x3fff, h = (data[5] | data[6] << 8) & 0x3fff;
    if (!w || !h) fail("a key frame of size %dx%d", w, h);
    if (width && (w != width || h != height))
      fail("the frame size changes from %dx%d to %dx%d", width, height, w, h);
    if (!width) set_size(w, h);
    data += 7;
    size -= 7;
    reset_probs();
    seg_enabled = seg_absolute = false;
    std::memset(seg_quant, 0, sizeof(seg_quant));
    std::memset(seg_level, 0, sizeof(seg_level));
    std::memset(lf_ref_delta, 0, sizeof(lf_ref_delta));
    std::memset(lf_mode_delta, 0, sizeof(lf_mode_delta));
    features |= kKeyFrame;
  } else {
    if (!ref[kLast]) fail("an inter frame before the first key frame");
    features |= kInterFrame;
  }
  if (!show) features |= kHiddenFrame;
  if (first_size > size)
    fail("the first partition (%zu bytes) runs past the end of the frame (%zu bytes left)",
         first_size, size);
  BoolDecoder bd;
  bd.init(data, first_size);
  read_header(bd, data + first_size, size - first_size);

  cur = new_frame();
  read_modes(bd);
  for (auto& a : above_nz) a.fill(0);
  for (int y = 0; y < mb_rows; ++y) decode_row(y);
  if (lf_level) loop_filter();
  overrun = bd.overrun() || tokens[partitions - 1].size_zero();
  for (int i = 0; i < std::min(partitions, mb_rows); ++i) overrun = overrun || tokens[i].overrun();

  // the references, from the buffers before this frame
  std::shared_ptr<Frame> old[4] = {cur, ref[kLast], ref[kGolden], ref[kAltref]};
  ref[kAltref] = old[altref_source];
  ref[kGolden] = old[golden_source];
  if (refresh_last) ref[kLast] = cur;
  if (!refresh_entropy) probs = saved;
  if (show) shown = cur;
  cur.reset();
  return show;
}

void Decoder::Impl::read_header(BoolDecoder& bd, const uint8_t* rest, size_t rest_size) {
  if (key) {
    bd.bit();  // colour space
    bd.bit();  // clamping type: reconstruction clamps either way
  }
  seg_enabled = bd.bit();
  seg_update_map = false;
  if (seg_enabled) {
    features |= kSegmentation;
    seg_update_map = bd.bit();
    if (bd.bit()) {  // update the segment data
      seg_absolute = bd.bit();
      for (int& q : seg_quant) q = bd.signed_literal(7);
      for (int& l : seg_level) l = bd.signed_literal(6);
    }
    if (seg_update_map) {
      features |= kSegmentMapUpdate;
      for (uint8_t& p : seg_probs) p = static_cast<uint8_t>(bd.bit() ? bd.literal(8) : 255);
    }
  }
  simple_filter = bd.bit();
  lf_level = bd.literal(6);
  sharpness = bd.literal(3);
  if (simple_filter) features |= kSimpleFilter;
  if (sharpness) features |= kSharpness;
  lf_deltas = bd.bit();
  if (lf_deltas) {
    features |= kFilterDeltas;
    if (bd.bit()) {
      for (int* delta : {lf_ref_delta, lf_mode_delta})
        for (int i = 0; i < 4; ++i)
          if (bd.bit()) {
            const int v = bd.literal(6);
            delta[i] = bd.bit() ? -v : v;
          }
    }
  }

  partitions = 1 << bd.literal(2);
  if (partitions > 1) features |= kTokenPartitions;
  const size_t table = 3 * static_cast<size_t>(partitions - 1);
  if (rest_size < table)
    fail("the sizes of %d token partitions run past the end of the frame", partitions);
  const uint8_t* p = rest + table;
  size_t left = rest_size - table;
  for (int i = 0; i + 1 < partitions; ++i) {
    const size_t n = rest[3 * i] | rest[3 * i + 1] << 8 | rest[3 * i + 2] << 16;
    if (n > left)
      fail("token partition %d (%zu bytes) runs past the end of the frame (%zu bytes left)", i,
           n, left);
    tokens[i].init(p, n);
    p += n;
    left -= n;
  }
  tokens[partitions - 1].init(p, left);

  const int q = bd.literal(7);
  int delta[5];
  for (int& d : delta) d = bd.signed_literal(4);  // y dc, y2 dc, y2 ac, uv dc, uv ac
  auto index = [](int v) { return v < 0 ? 0 : v > 127 ? 127 : v; };
  for (int i = 0; i < 4; ++i) {
    int base = q;
    if (seg_enabled) base = seg_absolute ? seg_quant[i] : seg_quant[i] + q;
    Quant& t = quant[i];
    t.y_dc = kDcQ[index(base + delta[0])];
    t.y_ac = kAcQ[index(base)];
    t.y2_dc = kDcQ[index(base + delta[1])] * 2;
    t.y2_ac = std::max(kAcQ[index(base + delta[2])] * 101581 >> 16, 8);  // x155/100
    t.uv_dc = std::min<int>(kDcQ[index(base + delta[3])], 132);
    t.uv_ac = kAcQ[index(base + delta[4])];
  }

  golden_source = altref_source = 0;
  if (!key) {
    const bool refresh_golden = bd.bit(), refresh_altref = bd.bit();
    golden_source = kGolden;
    altref_source = kAltref;
    if (refresh_golden) {
      golden_source = 0;
    } else if (const int c = bd.literal(2)) {  // copy the last frame (1) or the alt-ref (2)
      golden_source = c == 1 ? kLast : c == 2 ? kAltref : kGolden;
      features |= kBufferCopy;
    }
    if (refresh_altref) {
      altref_source = 0;
    } else if (const int c = bd.literal(2)) {  // the last frame (1) or the golden (2)
      altref_source = c == 1 ? kLast : c == 2 ? kGolden : kAltref;
      features |= kBufferCopy;
    }
    sign_bias[kGolden] = bd.bit();
    sign_bias[kAltref] = bd.bit();
    if (sign_bias[kGolden] || sign_bias[kAltref]) features |= kSignBias;
  }
  refresh_entropy = bd.bit();
  if (!refresh_entropy) {
    saved = probs;
    features |= kNoEntropyRefresh;
  }
  refresh_last = key || bd.bit();
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 8; ++j)
      for (int k = 0; k < 3; ++k)
        for (int l = 0; l < 11; ++l)
          if (bd.read(kCoefUpdate[i][j][k][l]))
            probs.coef[i][j][k][l] = static_cast<uint8_t>(bd.literal(8));
  skip_coded = bd.bit();
  prob_skip = skip_coded ? bd.literal(8) : 0;
  if (!key) {
    prob_intra = bd.literal(8);
    prob_last = bd.literal(8);
    prob_golden = bd.literal(8);
    if (bd.bit())
      for (uint8_t& v : probs.ymode) v = static_cast<uint8_t>(bd.literal(8));
    if (bd.bit())
      for (uint8_t& v : probs.uv_mode) v = static_cast<uint8_t>(bd.literal(8));
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 19; ++j)
        if (bd.read(kMvUpdate[i][j])) {
          const int v = bd.literal(7) << 1;
          probs.mv[i][j] = static_cast<uint8_t>(v ? v : 1);
        }
  }
}

int read_mv_component(BoolDecoder& bd, const uint8_t* p) {
  int a = 0;
  if (bd.read(p[0])) {  // long form: bits 0-2, then 9 down to 4, then bit 3
    for (int i = 0; i < 3; ++i) a += bd.read(p[9 + i]) << i;
    for (int i = 9; i > 3; --i) a += bd.read(p[9 + i]) << i;
    if (!(a & 0xFFF0) || bd.read(p[12])) a += 8;
  } else {
    a = bd.tree(kSmallMvTree, p + 2);
  }
  return a && bd.read(p[1]) ? -a : a;
}

void Decoder::Impl::read_modes(BoolDecoder& bd) {
  std::fill(intra_top.begin(), intra_top.end(), static_cast<uint8_t>(B_DC_PRED));
  static const uint8_t kImplied[4] = {B_DC_PRED, B_VE_PRED, B_HE_PRED, B_TM_PRED};
  for (int y = 0; y < mb_rows; ++y) {
    uint8_t left[4] = {B_DC_PRED, B_DC_PRED, B_DC_PRED, B_DC_PRED};
    for (int x = 0; x < mb_cols; ++x) {
      MbInfo& m = mb(x, y);
      uint8_t& segment = seg_map[static_cast<size_t>(y) * mb_cols + x];
      if (seg_update_map) {
        const int b = bd.read(seg_probs[0]);
        segment = static_cast<uint8_t>(bd.read(seg_probs[1 + b]) + 2 * b);
      }
      m.segment = segment;
      m.skip = static_cast<uint8_t>(skip_coded ? bd.read(prob_skip) : 0);
      if (!key && bd.read(prob_intra)) {
        m.ref = bd.read(prob_last) ? (bd.read(prob_golden) ? kAltref : kGolden) : kLast;
        if (m.ref == kGolden) features |= kGoldenRef;
        if (m.ref == kAltref) features |= kAltrefRef;
        read_inter_modes(bd, m, x, y);
        continue;
      }
      m.ref = kIntra;
      m.split = kSplitNone;
      m.mv = Mv();
      m.bmv[0] = Mv();
      if (key) {
        m.mode = static_cast<uint8_t>(bd.tree(kKfYmodeTree, kKfYmodeProb));
        if (m.mode == B_PRED) {
          for (int i = 0; i < 16; ++i) {
            uint8_t& above = intra_top[x * 4 + (i & 3)];
            uint8_t& l = left[i >> 2];
            above = l = m.bmodes[i] =
                static_cast<uint8_t>(bd.tree(kBmodeTree, kKfBmodeProb[above][l]));
          }
        } else {
          std::memset(&intra_top[x * 4], kImplied[m.mode], 4);
          std::memset(left, kImplied[m.mode], 4);
        }
        m.uv_mode = static_cast<uint8_t>(bd.tree(kUvModeTree, kKfUvModeProb));
      } else {
        features |= kIntraInInter;
        m.mode = static_cast<uint8_t>(bd.tree(kYmodeTree, probs.ymode));
        if (m.mode == B_PRED)
          for (uint8_t& b : m.bmodes)
            b = static_cast<uint8_t>(bd.tree(kBmodeTree, kBmodeProbInter));
        m.uv_mode = static_cast<uint8_t>(bd.tree(kUvModeTree, probs.uv_mode));
      }
      if (m.mode == B_PRED) features |= kBPred;
    }
  }
}

// The near-vector search of RFC 6386 section 16.3 in FFmpeg's form (the
// macroblocks above, left and above-left, vectors of another sign bias
// inverted), then the mode tree and the vector.
void Decoder::Impl::read_inter_modes(BoolDecoder& bd, MbInfo& m, int x, int y) {
  const MbInfo* edge[3] = {&mb(x, y - 1), &mb(x - 1, y), &mb(x - 1, y - 1)};
  Mv near[4];
  int cnt[4] = {0, 0, 0, 0}, idx = 0;
  for (int n = 0; n < 3; ++n) {
    const MbInfo& e = *edge[n];
    if (e.ref == kIntra) continue;
    const int weight = n == 2 ? 1 : 2;
    Mv v = e.mv;
    if (v.zero()) {
      cnt[0] += weight;
      continue;
    }
    if (sign_bias[e.ref] != sign_bias[m.ref]) {
      v.x = static_cast<int16_t>(-v.x);
      v.y = static_cast<int16_t>(-v.y);
    }
    if (!n || v != near[idx]) near[++idx] = v;
    cnt[idx] += weight;
  }
  auto clamp = [&](Mv v) {
    const int x0 = -64 * (x + 1), x1 = 64 * (mb_cols - x);
    const int y0 = -64 * (y + 1), y1 = 64 * (mb_rows - y);
    v.x = static_cast<int16_t>(std::min(std::max<int>(v.x, x0), x1));
    v.y = static_cast<int16_t>(std::min(std::max<int>(v.y, y0), y1));
    return v;
  };
  m.split = kSplitNone;
  if (!bd.read(kModeContexts[cnt[0]][0])) {
    m.mode = ZERO_MV;
    m.mv = m.bmv[0] = Mv();
    return;
  }
  m.mode = MV_PRED;
  if (cnt[3] && near[1] == near[3]) cnt[1] += 1;  // above and above-left agree
  if (cnt[2] > cnt[1]) {
    std::swap(cnt[1], cnt[2]);
    std::swap(near[1], near[2]);
  }
  if (!bd.read(kModeContexts[cnt[1]][1])) {  // nearest
    m.mv = m.bmv[0] = clamp(near[1]);
    return;
  }
  if (!bd.read(kModeContexts[cnt[2]][2])) {  // near
    m.mv = m.bmv[0] = clamp(near[2]);
    return;
  }
  m.mv = clamp(near[cnt[1] >= cnt[0] ? 1 : 0]);  // the best vector
  const int splits = (edge[1]->mode == SPLIT_MV) * 2 + (edge[0]->mode == SPLIT_MV) * 2 +
                     (edge[2]->mode == SPLIT_MV);
  if (bd.read(kModeContexts[splits][3])) {
    m.mode = SPLIT_MV;
    features |= kSplitMv;
    m.mv = m.bmv[read_split(bd, m, x, y) - 1];
    return;
  }
  features |= kNewMv;
  m.mv.y = static_cast<int16_t>(m.mv.y + read_mv_component(bd, probs.mv[0]));
  m.mv.x = static_cast<int16_t>(m.mv.x + read_mv_component(bd, probs.mv[1]));
  m.bmv[0] = m.mv;
}

// Split vectors: the partitioning, then each partition's vector as the one
// left of its first block, above it, zero or new (added to the best vector
// in m.mv).  Returns the number of partitions.
int Decoder::Impl::read_split(BoolDecoder& bd, MbInfo& m, int x, int y) {
  const MbInfo& left = mb(x - 1, y);
  const MbInfo& top = mb(x, y - 1);
  int part = kSplit4x4;
  if (bd.read(kSplitProb[0]))
    part = bd.read(kSplitProb[1]) ? kSplit16x8 + bd.read(kSplitProb[2]) : kSplit8x8;
  const uint8_t* map = kSplits[part];
  const Mv best = m.mv;
  m.split = static_cast<uint8_t>(part);
  for (int n = 0; n < kSplitCount[part]; ++n) {
    const int k = kSplitFirst[part][n];
    const Mv l = (k & 3) ? m.bmv[map[k - 1]] : left.bmv[kSplits[left.split][k + 3]];
    const Mv a = k > 3 ? m.bmv[map[k - 4]] : top.bmv[kSplits[top.split][k + 12]];
    const uint8_t* p = l == a ? kSubMvProb[l.zero() ? 4 : 3]
                       : a.zero() ? kSubMvProb[2]
                                  : kSubMvProb[l.zero() ? 1 : 0];
    Mv& v = m.bmv[n];
    if (!bd.read(p[0])) {
      v = l;
    } else if (!bd.read(p[1])) {
      v = a;
    } else if (!bd.read(p[2])) {
      v = Mv();
    } else {
      v.y = static_cast<int16_t>(best.y + read_mv_component(bd, probs.mv[0]));
      v.x = static_cast<int16_t>(best.x + read_mv_component(bd, probs.mv[1]));
    }
  }
  return kSplitCount[part];
}

// One block's tokens (RFC 6386 section 13), dequantised into `out` in
// raster order; returns the position after the last token (0: none).
int Decoder::Impl::read_block(BoolDecoder& bd, int16_t* out, int type, int i, int ctx, int dcq,
                              int acq) {
  const uint8_t* p = probs.coef[type][kBands[i]][ctx];
  if (!bd.read(p[0])) return 0;  // end of block
  while (true) {
    if (!bd.read(p[1])) {  // a zero: the next token cannot be the end
      if (++i == 16) return 16;
      p = probs.coef[type][kBands[i]][0];
      continue;
    }
    int v, next = 2;
    if (!bd.read(p[2])) {
      v = 1;
      next = 1;
    } else if (!bd.read(p[3])) {
      v = bd.read(p[4]) ? 3 + bd.read(p[5]) : 2;
    } else if (!bd.read(p[6])) {
      if (!bd.read(p[7])) {
        v = 5 + bd.read(159);
      } else {
        v = 7 + 2 * bd.read(165);
        v += bd.read(145);
      }
    } else {
      const int a = bd.read(p[8]);
      const int cat = 2 * a + bd.read(p[9 + a]);
      v = 0;
      for (const uint8_t* q = kCatProbs[cat]; *q; ++q) v = 2 * v + bd.read(*q);
      v += 3 + (8 << cat);
    }
    if (bd.bit()) v = -v;
    out[kZigzag[i]] = static_cast<int16_t>(v * (i ? acq : dcq));
    if (++i == 16) return 16;
    p = probs.coef[type][kBands[i]][next];
    if (!bd.read(p[0])) return i;
  }
}

// A macroblock's coefficients: Y2 (when it has one, then the luma blocks
// start at their first AC coefficient), 16 luma, 4 U and 4 V blocks.
// Contexts: above / left [0..3] luma, [4..5] U, [6..7] V, [8] Y2.  Returns
// the sum of the blocks' token counts (0: no coefficients coded).
int Decoder::Impl::read_coefficients(BoolDecoder& bd, int16_t (*c)[16], uint8_t* above,
                                     uint8_t* left, const Quant& q, bool has_y2) {
  int total = 0, first = 0, type = 3;
  if (has_y2) {
    const int n = read_block(bd, c[24], 1, 0, above[8] + left[8], q.y2_dc, q.y2_ac);
    above[8] = left[8] = n > 0;
    total += n;
    if (n) inverse_wht(c[24], c);
    first = 1;
    type = 0;
  }
  for (int i = 0; i < 16; ++i) {
    const int bx = i & 3, by = i >> 2;
    const int n = read_block(bd, c[i], type, first, above[bx] + left[by], q.y_dc, q.y_ac);
    above[bx] = left[by] = n > 0;
    total += n;
  }
  for (int i = 0; i < 8; ++i) {
    const int ctx = i < 4 ? 4 : 6, bx = i & 1, by = (i >> 1) & 1;
    const int n =
        read_block(bd, c[16 + i], 2, 0, above[ctx + bx] + left[ctx + by], q.uv_dc, q.uv_ac);
    above[ctx + bx] = left[ctx + by] = n > 0;
    total += n;
  }
  return total;
}

void Decoder::Impl::predict_intra(const MbInfo& m, int x, int y, int16_t (*c)[16]) {
  Frame& f = *cur;
  // A workspace with the macroblock's edges: row 0 the corner, the 16 samples
  // above and the 4 above-right; column 0 the 16 to the left.
  constexpr int S = 21;
  uint8_t ws[17 * S];
  const int ys = f.w;
  uint8_t* fy = f.y.data() + static_cast<size_t>(y) * 16 * ys + x * 16;
  if (!y) {
    std::memset(ws, 127, S);
  } else {
    const uint8_t* above = fy - ys;
    ws[0] = x ? above[-1] : 129;
    std::memcpy(ws + 1, above, 16);
    if (x + 1 < mb_cols)
      std::memcpy(ws + 17, above + 16, 4);
    else
      std::memset(ws + 17, above[15], 4);
  }
  for (int r = 0; r < 16; ++r) ws[(r + 1) * S] = x ? fy[r * ys - 1] : 129;
  uint8_t* d = ws + S + 1;
  if (m.mode == B_PRED) {
    // the right column's sub-blocks below the first take the macroblock's above-right
    for (int r = 4; r <= 12; r += 4) std::memcpy(ws + r * S + 17, ws + 17, 4);
    for (int i = 0; i < 16; ++i) {
      uint8_t* b = d + (i >> 2) * 4 * S + (i & 3) * 4;
      predict4(b, S, m.bmodes[i]);
      add_residual(b, S, c[i]);
    }
  } else {
    predict_block(d, S, 16, m.mode, y > 0, x > 0);
    for (int i = 0; i < 16; ++i) add_residual(d + (i >> 2) * 4 * S + (i & 3) * 4, S, c[i]);
  }
  for (int r = 0; r < 16; ++r) std::memcpy(fy + r * ys, d + r * S, 16);

  const int cs = f.w / 2;
  for (int p = 0; p < 2; ++p) {
    constexpr int T = 9;
    uint8_t cw[9 * T];
    uint8_t* fc = (p ? f.v : f.u).data() + static_cast<size_t>(y) * 8 * cs + x * 8;
    if (!y) {
      std::memset(cw, 127, T);
    } else {
      cw[0] = x ? fc[-cs - 1] : 129;
      std::memcpy(cw + 1, fc - cs, 8);
    }
    for (int r = 0; r < 8; ++r) cw[(r + 1) * T] = x ? fc[r * cs - 1] : 129;
    uint8_t* dc = cw + T + 1;
    predict_block(dc, T, 8, m.uv_mode, y > 0, x > 0);
    for (int i = 0; i < 4; ++i)
      add_residual(dc + (i >> 1) * 4 * T + (i & 1) * 4, T, c[16 + 4 * p + i]);
    for (int r = 0; r < 8; ++r) std::memcpy(fc + r * cs, dc + r * T, 8);
  }
}

// A bw x bh block of `plane` (pw x ph, macroblock-aligned) at whole sample
// (x, y) and fraction (mx, my) eighths into d; samples beyond the plane
// repeat its edge.
void Decoder::Impl::mc(const std::vector<uint8_t>& plane, int pw, int ph, uint8_t* d, int ds,
                       int x, int y, int mx, int my, int bw, int bh) {
  const bool bilinear = version != 0;
  if (x - 2 >= 0 && y - 2 >= 0 && x + bw + 3 <= pw && y + bh + 3 <= ph) {
    interpolate(plane.data() + static_cast<size_t>(y) * pw + x, pw, d, ds, bw, bh, mx, my,
                bilinear);
    return;
  }
  if (x < 0 || y < 0 || x + bw > pw || y + bh > ph) features |= kOffFrameMv;
  constexpr int W = 16 + 5;
  uint8_t win[W * W];
  for (int r = 0; r < bh + 5; ++r) {
    const int sy = std::min(std::max(y - 2 + r, 0), ph - 1);
    const uint8_t* row = plane.data() + static_cast<size_t>(sy) * pw;
    for (int k = 0; k < bw + 5; ++k) win[r * W + k] = row[std::min(std::max(x - 2 + k, 0), pw - 1)];
  }
  interpolate(win + 2 * W + 2, W, d, ds, bw, bh, mx, my, bilinear);
}

void Decoder::Impl::predict_inter(const MbInfo& m, int x, int y) {
  const Frame& r = *ref[m.ref];
  Frame& f = *cur;
  const int ys = f.w, cs = f.w / 2;
  uint8_t* dy = f.y.data() + static_cast<size_t>(y) * 16 * ys + x * 16;
  uint8_t* du = f.u.data() + static_cast<size_t>(y) * 8 * cs + x * 8;
  uint8_t* dv = f.v.data() + static_cast<size_t>(y) * 8 * cs + x * 8;
  // luma vectors are in quarter samples; a chroma vector is in eighths
  auto luma = [&](int bx, int by, int bw, int bh, Mv v) {
    mc(r.y, f.w, f.h, dy + by * ys + bx, ys, x * 16 + bx + (v.x >> 2), y * 16 + by + (v.y >> 2),
       (v.x * 2) & 7, (v.y * 2) & 7, bw, bh);
  };
  auto chroma = [&](int bx, int by, int bw, int bh, int vx, int vy) {
    if (version == 3) {  // full-pixel chroma
      vx &= ~7;
      vy &= ~7;
    }
    const int px = x * 8 + bx + (vx >> 3), py = y * 8 + by + (vy >> 3);
    mc(r.u, cs, f.h / 2, du + by * cs + bx, cs, px, py, vx & 7, vy & 7, bw, bh);
    mc(r.v, cs, f.h / 2, dv + by * cs + bx, cs, px, py, vx & 7, vy & 7, bw, bh);
  };
  switch (m.split) {
    case kSplitNone:
      luma(0, 0, 16, 16, m.mv);
      chroma(0, 0, 8, 8, m.mv.x, m.mv.y);
      break;
    case kSplit16x8:
    case kSplit8x16:
      for (int n = 0; n < 2; ++n) {
        const int bx = m.split == kSplit8x16 ? 8 * n : 0, by = m.split == kSplit16x8 ? 8 * n : 0;
        const int bw = m.split == kSplit8x16 ? 8 : 16, bh = m.split == kSplit16x8 ? 8 : 16;
        luma(bx, by, bw, bh, m.bmv[n]);
        chroma(bx / 2, by / 2, bw / 2, bh / 2, m.bmv[n].x, m.bmv[n].y);
      }
      break;
    case kSplit8x8:
      for (int n = 0; n < 4; ++n) {
        const int bx = (n & 1) * 8, by = (n >> 1) * 8;
        luma(bx, by, 8, 8, m.bmv[n]);
        chroma(bx / 2, by / 2, 4, 4, m.bmv[n].x, m.bmv[n].y);
      }
      break;
    default:  // 4x4: each chroma block's vector the rounded mean of its four luma blocks'
      for (int k = 0; k < 16; ++k) luma((k & 3) * 4, (k >> 2) * 4, 4, 4, m.bmv[k]);
      for (int k = 0; k < 4; ++k) {
        const int b = (k >> 1) * 8 + (k & 1) * 2;
        const int sx = m.bmv[b].x + m.bmv[b + 1].x + m.bmv[b + 4].x + m.bmv[b + 5].x;
        const int sy = m.bmv[b].y + m.bmv[b + 1].y + m.bmv[b + 4].y + m.bmv[b + 5].y;
        chroma((k & 1) * 4, (k >> 1) * 4, 4, 4, (sx + 2 - (sx < 0)) >> 2, (sy + 2 - (sy < 0)) >> 2);
      }
      break;
  }
}

void Decoder::Impl::decode_row(int y) {
  BoolDecoder& bd = tokens[y & (partitions - 1)];
  uint8_t left[9] = {};
  Frame& f = *cur;
  const int ys = f.w, cs = f.w / 2;
  for (int x = 0; x < mb_cols; ++x) {
    const MbInfo& m = mb(x, y);
    int16_t c[25][16];
    std::memset(c, 0, sizeof(c));
    const bool has_y2 = m.mode != B_PRED && m.mode != SPLIT_MV;
    uint8_t* above = above_nz[x].data();
    int total = 0;
    if (!m.skip) {
      total = read_coefficients(bd, c, above, left, quant[m.segment], has_y2);
    } else {  // no coefficients: the contexts are cleared, Y2's only where it has one
      std::memset(above, 0, 8);
      std::memset(left, 0, 8);
      if (has_y2) above[8] = left[8] = 0;
    }
    if (m.ref == kIntra) {
      predict_intra(m, x, y, c);
    } else {
      predict_inter(m, x, y);
      uint8_t* dy = f.y.data() + static_cast<size_t>(y) * 16 * ys + x * 16;
      for (int i = 0; i < 16; ++i) add_residual(dy + (i >> 2) * 4 * ys + (i & 3) * 4, ys, c[i]);
      for (int p = 0; p < 2; ++p) {
        uint8_t* dc = (p ? f.v : f.u).data() + static_cast<size_t>(y) * 8 * cs + x * 8;
        for (int i = 0; i < 4; ++i)
          add_residual(dc + (i >> 1) * 4 * cs + (i & 1) * 4, cs, c[16 + 4 * p + i]);
      }
    }
    int level = lf_level;
    if (seg_enabled) level = seg_absolute ? seg_level[m.segment] : seg_level[m.segment] + lf_level;
    if (lf_deltas) {
      level += lf_ref_delta[m.ref];
      if (m.mode >= B_PRED) level += lf_mode_delta[m.mode - B_PRED];
    }
    level = std::min(std::max(level, 0), 63);
    int interior = level;
    if (sharpness) {
      interior >>= (sharpness + 3) >> 2;
      interior = std::min(interior, 9 - sharpness);
    }
    lf[static_cast<size_t>(y) * mb_cols + x] = {
        static_cast<uint8_t>(level), static_cast<uint8_t>(std::max(interior, 1)),
        static_cast<uint8_t>((!m.skip && total) || m.mode == B_PRED || m.mode == SPLIT_MV)};
  }
}

void Decoder::Impl::loop_filter() {
  Frame& f = *cur;
  const int ys = f.w, cs = f.w / 2;
  for (int y = 0; y < mb_rows; ++y)
    for (int x = 0; x < mb_cols; ++x) {
      const LoopFilterMb& l = lf[static_cast<size_t>(y) * mb_cols + x];
      if (!l.level) continue;
      const int sub = 2 * l.level + l.interior, edge = sub + 4, in = l.interior;
      uint8_t* py = f.y.data() + static_cast<size_t>(y) * 16 * ys + x * 16;
      if (simple_filter) {
        if (x) edge_simple(py, 1, ys, edge);
        if (l.inner)
          for (int k = 4; k < 16; k += 4) edge_simple(py + k, 1, ys, sub);
        if (y) edge_simple(py, ys, 1, edge);
        if (l.inner)
          for (int k = 4; k < 16; k += 4) edge_simple(py + k * ys, ys, 1, sub);
        continue;
      }
      const int hev = key ? (l.level >= 40 ? 2 : l.level >= 15 ? 1 : 0)
                          : (l.level >= 40 ? 3 : l.level >= 20 ? 2 : l.level >= 15 ? 1 : 0);
      uint8_t* pc[2] = {f.u.data() + static_cast<size_t>(y) * 8 * cs + x * 8,
                        f.v.data() + static_cast<size_t>(y) * 8 * cs + x * 8};
      if (x) {
        edge_normal(py, 1, ys, 16, edge, in, hev, true);
        for (uint8_t* p : pc) edge_normal(p, 1, cs, 8, edge, in, hev, true);
      }
      if (l.inner) {
        for (int k = 4; k < 16; k += 4) edge_normal(py + k, 1, ys, 16, sub, in, hev, false);
        for (uint8_t* p : pc) edge_normal(p + 4, 1, cs, 8, sub, in, hev, false);
      }
      if (y) {
        edge_normal(py, ys, 1, 16, edge, in, hev, true);
        for (uint8_t* p : pc) edge_normal(p, cs, 1, 8, edge, in, hev, true);
      }
      if (l.inner) {
        for (int k = 4; k < 16; k += 4) edge_normal(py + k * ys, ys, 1, 16, sub, in, hev, false);
        for (uint8_t* p : pc) edge_normal(p + 4 * cs, cs, 1, 8, sub, in, hev, false);
      }
    }
}

Decoder::Decoder() : impl_(new Impl()) {}
Decoder::~Decoder() = default;

bool Decoder::decode(const uint8_t* data, size_t size) {
  const bool show = impl_->decode(data, size);
  if (impl_->version) impl_->features |= kBilinear;
  if (impl_->version == 3) impl_->features |= kFullPixel;
  return show;
}

int Decoder::width() const { return impl_->width; }
int Decoder::height() const { return impl_->height; }

const uint8_t* Decoder::plane(int c) const {
  const Frame* f = impl_->shown.get();
  if (!f) return nullptr;
  return (c == 0 ? f->y : c == 1 ? f->u : f->v).data();
}

int Decoder::stride(int c) const { return c == 0 ? impl_->mb_cols * 16 : impl_->mb_cols * 8; }

uint32_t Decoder::features() const { return impl_->features; }

bool Decoder::overrun() const { return impl_->overrun; }

}  // namespace vd_vp8
