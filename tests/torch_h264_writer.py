"""The tests' own H.264 bitstream writer (Python and numpy; Annex B or
length-prefixed NAL units out).  Nothing in the port imports it.

The wheel's libavcodec has an H.264 decoder and no H.264 encoder, so the
tests write their streams here and hold the port's decoder to OpenCV's
FFmpeg on them.  The writer covers what the port decodes: CAVLC I and P
slices, progressive 8-bit 4:2:0, 4x4 transforms, and every slice, reference
and NAL feature of the decoder, plus the fields of what it refuses (CABAC,
B slices, interlace, ...) so that a test can write a refused stream.

``Writer(width, height, seed, **options)`` keeps the sequence's state (the
decoded picture buffer as the standard marks it, frame_num, picture order
counts) and writes one access unit a call:

* ``random_picture(...)``: seeded, legal decisions for every syntax element
  the decoder reads: macroblock types and sub-types, intra modes whose
  samples are available, vectors (some off the picture), reference indices,
  skip runs, QP deltas across 0-51, coefficients that reach the level
  escapes; slices, deblocking parameters, reference list modification and
  memory management operations as asked.
* ``encode_picture(rgb, ...)``: a plain encoder: intra 16x16 or 4x4 chosen
  by SAD, P_L0_16x16 from a small full-sample search, P_Skip, a quantised
  4x4 residual, its references the planes the port's decoder gives back.

The macroblock layer mirrors the decoder's neighbour rules (availability
across slices, nC, the predicted intra mode, the vector predictors): a
mismatch makes FFmpeg and the port disagree, which the tests then see.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

# --------------------------------------------------------------- the tables
# the standard's VLC tables (9.2), as (length, code) by index

COEFF_TOKEN_LEN = [
    [1, 0, 0, 0, 6, 2, 0, 0, 8, 6, 3, 0, 9, 8, 7, 5, 10, 9, 8, 6, 11, 10, 9, 7, 13, 11, 10, 8,
     13, 13, 11, 9, 13, 13, 13, 10, 14, 14, 13, 11, 14, 14, 14, 13, 15, 15, 14, 14, 15, 15, 15,
     14, 16, 15, 15, 15, 16, 16, 16, 15, 16, 16, 16, 16, 16, 16, 16, 16],
    [2, 0, 0, 0, 6, 2, 0, 0, 6, 5, 3, 0, 7, 6, 6, 4, 8, 6, 6, 4, 8, 7, 7, 5, 9, 8, 8, 6, 11, 9,
     9, 6, 11, 11, 11, 7, 12, 11, 11, 9, 12, 12, 12, 11, 12, 12, 12, 11, 13, 13, 13, 12, 13, 13,
     13, 13, 13, 14, 13, 13, 14, 14, 14, 13, 14, 14, 14, 14],
    [4, 0, 0, 0, 6, 4, 0, 0, 6, 5, 4, 0, 6, 5, 5, 4, 7, 5, 5, 4, 7, 5, 5, 4, 7, 6, 6, 4, 7, 6, 6,
     4, 8, 7, 7, 5, 8, 8, 7, 6, 9, 8, 8, 7, 9, 9, 8, 8, 9, 9, 9, 8, 10, 9, 9, 9, 10, 10, 10, 10,
     10, 10, 10, 10, 10, 10, 10, 10],
    [6, 0, 0, 0] + [6, 6, 0, 0] + [6, 6, 6, 0] + [6] * 56]
COEFF_TOKEN_BITS = [
    [1, 0, 0, 0, 5, 1, 0, 0, 7, 4, 1, 0, 7, 6, 5, 3, 7, 6, 5, 3, 7, 6, 5, 4, 15, 6, 5, 4, 11, 14,
     5, 4, 8, 10, 13, 4, 15, 14, 9, 4, 11, 10, 13, 12, 15, 14, 9, 12, 11, 10, 13, 8, 15, 1, 9, 12,
     11, 14, 13, 8, 7, 10, 9, 12, 4, 6, 5, 8],
    [3, 0, 0, 0, 11, 2, 0, 0, 7, 7, 3, 0, 7, 10, 9, 5, 7, 6, 5, 4, 4, 6, 5, 6, 7, 6, 5, 8, 15, 6,
     5, 4, 11, 14, 13, 4, 15, 10, 9, 4, 11, 14, 13, 12, 8, 10, 9, 8, 15, 14, 13, 12, 11, 10, 9,
     12, 7, 11, 6, 8, 9, 8, 10, 1, 7, 6, 5, 4],
    [15, 0, 0, 0, 15, 14, 0, 0, 11, 15, 13, 0, 8, 12, 14, 12, 15, 10, 11, 11, 11, 8, 9, 10, 9, 14,
     13, 9, 8, 10, 9, 8, 15, 14, 13, 13, 11, 14, 10, 12, 15, 10, 13, 12, 11, 14, 9, 12, 8, 10, 13,
     8, 13, 7, 9, 12, 9, 12, 11, 10, 5, 8, 7, 6, 1, 4, 3, 2],
    [3, 0, 0, 0, 0, 1, 0, 0, 4, 5, 6, 0] + list(range(8, 64))]
CHROMA_DC_TOKEN_LEN = [2, 0, 0, 0, 6, 1, 0, 0, 6, 6, 3, 0, 6, 7, 7, 6, 6, 8, 8, 7]
CHROMA_DC_TOKEN_BITS = [1, 0, 0, 0, 7, 1, 0, 0, 4, 6, 1, 0, 3, 3, 2, 5, 2, 3, 2, 0]
TOTAL_ZEROS_LEN = [
    [1, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 9], [3, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 6, 6, 6, 6],
    [4, 3, 3, 3, 4, 4, 3, 3, 4, 5, 5, 6, 5, 6], [5, 3, 4, 4, 3, 3, 3, 4, 3, 4, 5, 5, 5],
    [4, 4, 4, 3, 3, 3, 3, 3, 4, 5, 4, 5], [6, 5, 3, 3, 3, 3, 3, 3, 4, 3, 6],
    [6, 5, 3, 3, 3, 2, 3, 4, 3, 6], [6, 4, 5, 3, 2, 2, 3, 3, 6], [6, 6, 4, 2, 2, 3, 2, 5],
    [5, 5, 3, 2, 2, 2, 4], [4, 4, 3, 3, 1, 3], [4, 4, 2, 1, 3], [3, 3, 1, 2], [2, 2, 1], [1, 1]]
TOTAL_ZEROS_BITS = [
    [1, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 1], [7, 6, 5, 4, 3, 5, 4, 3, 2, 3, 2, 3, 2, 1, 0],
    [5, 7, 6, 5, 4, 3, 4, 3, 2, 3, 2, 1, 1, 0], [3, 7, 5, 4, 6, 5, 4, 3, 3, 2, 2, 1, 0],
    [5, 4, 3, 7, 6, 5, 4, 3, 2, 1, 1, 0], [1, 1, 7, 6, 5, 4, 3, 2, 1, 1, 0],
    [1, 1, 5, 4, 3, 3, 2, 1, 1, 0], [1, 1, 1, 3, 3, 2, 2, 1, 0], [1, 0, 1, 3, 2, 1, 1, 1],
    [1, 0, 1, 3, 2, 1, 1], [0, 1, 1, 2, 1, 3], [0, 1, 1, 1, 1], [0, 1, 1, 1], [0, 1, 1], [0, 1]]
CHROMA_DC_ZEROS_LEN = [[1, 2, 3, 3], [1, 2, 2], [1, 1]]
CHROMA_DC_ZEROS_BITS = [[1, 1, 1, 0], [1, 1, 0], [1, 0]]
RUN_LEN = [[1, 1], [1, 2, 2], [2, 2, 2, 2], [2, 2, 2, 3, 3], [2, 2, 3, 3, 3, 3],
           [2, 3, 3, 3, 3, 3, 3], [3, 3, 3, 3, 3, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11]]
RUN_BITS = [[1, 0], [1, 1, 0], [3, 2, 1, 0], [3, 2, 1, 1, 0], [3, 2, 3, 2, 1, 0],
            [3, 0, 1, 3, 2, 5, 4], [7, 6, 5, 4, 3, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1]]
INTRA_CBP = [47, 31, 15, 0, 23, 27, 29, 30, 7, 11, 13, 14, 39, 43, 45, 46, 16, 3, 5, 10, 12, 19,
             21, 26, 28, 35, 37, 42, 44, 1, 2, 4, 8, 17, 18, 20, 24, 6, 9, 22, 25, 32, 33, 34, 36,
             40, 38, 41]
INTER_CBP = [0, 16, 1, 2, 4, 8, 32, 3, 5, 10, 12, 15, 47, 7, 11, 13, 14, 6, 9, 31, 35, 37, 42, 44,
             33, 34, 36, 40, 39, 43, 45, 46, 17, 18, 20, 24, 19, 21, 26, 28, 23, 27, 29, 30, 22,
             25, 38, 41]
INTRA_CBP_CODE = {cbp: i for i, cbp in enumerate(INTRA_CBP)}
INTER_CBP_CODE = {cbp: i for i, cbp in enumerate(INTER_CBP)}
ZIGZAG = [0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15]  # raster position of each index
DEQUANT = [[10, 16, 13], [11, 18, 14], [13, 20, 16], [14, 23, 18], [16, 25, 20], [18, 29, 23]]
QUANT = [[13107, 5243, 8066], [11916, 4660, 7490], [10082, 4194, 6554], [9362, 3647, 5825],
         [8192, 3355, 5243], [7282, 2893, 4559]]
CHROMA_QP = list(range(30)) + [29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36, 37, 37, 37, 38, 38,
                               38, 39, 39, 39, 39]
HIGH_PROFILES = (100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139, 134, 135)
# the 4x4 blocks of a macroblock in decoding order: (x, y) in blocks
BLOCKS = [((n & 1) + ((n >> 2) & 1) * 2, ((n >> 1) & 1) + (n >> 3) * 2) for n in range(16)]


def pos_class(pos: int) -> int:
    x, y = pos & 3, pos >> 2
    return 1 if (x & 1) and (y & 1) else 0 if not (x & 1) and not (y & 1) else 2


def block_order(x: int, y: int) -> int:
    return (x >> 1) * 4 + (y >> 1) * 8 + (x & 1) + (y & 1) * 2


# ------------------------------------------------------------------- bits


class Bits:
    def __init__(self):
        self.parts: List[str] = []
        self.n = 0

    def u(self, n: int, v: int) -> "Bits":
        if n:
            assert 0 <= v < (1 << n), (n, v)
            self.parts.append(format(v, f"0{n}b"))
            self.n += n
        return self

    def ue(self, v: int) -> "Bits":
        assert v >= 0
        v += 1
        return self.u(2 * v.bit_length() - 1, v)

    def se(self, v: int) -> "Bits":
        return self.ue(2 * v - 1 if v > 0 else -2 * v)

    def te(self, rng: int, v: int) -> "Bits":
        if rng == 1:
            return self.u(1, 1 - v)
        return self.ue(v) if rng > 1 else self

    def align(self) -> "Bits":
        return self.u((8 - self.n % 8) % 8, 0)

    def trailing(self) -> "Bits":
        return self.u(1, 1).align()

    def raw(self, data: bytes) -> "Bits":
        assert self.n % 8 == 0
        for c in data:
            self.u(8, c)
        return self

    def bytes(self) -> bytes:
        s = "".join(self.parts)
        assert len(s) % 8 == 0
        return int(s, 2).to_bytes(len(s) // 8, "big") if s else b""


def escape(rbsp: bytes) -> bytes:
    """Emulation prevention: a 0x03 after two zero bytes before a byte <= 3."""
    out, zeros = bytearray(), 0
    for c in rbsp:
        if zeros >= 2 and c <= 3:
            out.append(3)
            zeros = 0
        out.append(c)
        zeros = zeros + 1 if c == 0 else 0
    return bytes(out)


def nal_unit(ref_idc: int, kind: int, rbsp: bytes) -> bytes:
    return bytes([(ref_idc << 5) | kind]) + escape(rbsp)


def annexb(units: Sequence[bytes]) -> bytes:
    return b"".join(b"\x00\x00\x00\x01" + u for u in units)


def length_prefixed(units: Sequence[bytes], size: int = 4) -> bytes:
    return b"".join(len(u).to_bytes(size, "big") + u for u in units)


def avcc(sps_units: Sequence[bytes], pps_units: Sequence[bytes], length_size: int = 4) -> bytes:
    """An AVCDecoderConfigurationRecord holding the given SPS / PPS NAL
    units (with the High profiles' tail)."""
    first = sps_units[0] if sps_units else bytes([0x67, 66, 0, 30])
    out = bytes([1, first[1], first[2], first[3], 0xFC | (length_size - 1),
                 0xE0 | len(sps_units)])
    out += b"".join(struct.pack(">H", len(u)) + u for u in sps_units)
    out += bytes([len(pps_units)]) + b"".join(struct.pack(">H", len(u)) + u for u in pps_units)
    if first[1] in HIGH_PROFILES:
        out += bytes([0xFC | 1, 0xF8, 0xF8, 0])
    return out


# --------------------------------------------------------- parameter sets


@dataclasses.dataclass
class Sps:
    id: int = 0
    profile: int = 66
    level: int = 30
    mb_w: int = 4
    mb_h: int = 3
    log2_max_frame_num: int = 4
    poc_type: int = 2
    log2_max_poc_lsb: int = 6
    delta_pic_order_always_zero: int = 1
    offset_for_non_ref_pic: int = 1
    offset_for_top_to_bottom_field: int = 0
    offset_for_ref_frame: Tuple[int, ...] = (2,)
    max_num_ref_frames: int = 1
    gaps: int = 0
    crop: Optional[Tuple[int, int, int, int]] = None  # left, right, top, bottom in crop units
    full_range: Optional[int] = None  # a video signal type when set
    colour: Optional[Tuple[int, int, int]] = None  # primaries, transfer, matrix
    timing: Optional[Tuple[int, int]] = None  # num_units_in_tick, time_scale
    restriction: Optional[int] = None  # max_num_reorder_frames
    # the fields of what the decoder refuses
    chroma_format: int = 1
    bit_depth: int = 8
    bypass: int = 0
    scaling: int = 0
    frame_mbs_only: int = 1

    def rbsp(self) -> bytes:
        b = Bits().u(8, self.profile).u(8, 0).u(8, self.level).ue(self.id)
        if self.profile in HIGH_PROFILES:
            b.ue(self.chroma_format)
            if self.chroma_format == 3:
                b.u(1, 0)
            b.ue(self.bit_depth - 8).ue(self.bit_depth - 8).u(1, self.bypass).u(1, self.scaling)
            if self.scaling:
                for _ in range(8):
                    b.u(1, 0)
        b.ue(self.log2_max_frame_num - 4).ue(self.poc_type)
        if self.poc_type == 0:
            b.ue(self.log2_max_poc_lsb - 4)
        elif self.poc_type == 1:
            b.u(1, self.delta_pic_order_always_zero).se(self.offset_for_non_ref_pic)
            b.se(self.offset_for_top_to_bottom_field).ue(len(self.offset_for_ref_frame))
            for v in self.offset_for_ref_frame:
                b.se(v)
        b.ue(self.max_num_ref_frames).u(1, self.gaps).ue(self.mb_w - 1).ue(self.mb_h - 1)
        b.u(1, self.frame_mbs_only)
        if not self.frame_mbs_only:
            b.u(1, 0)
        b.u(1, 1)  # direct_8x8_inference_flag
        b.u(1, self.crop is not None)
        if self.crop is not None:
            for v in self.crop:
                b.ue(v)
        vui = any(v is not None for v in (self.full_range, self.colour, self.timing,
                                          self.restriction))
        b.u(1, vui)
        if vui:
            b.u(1, 0).u(1, 0)  # no aspect ratio, no overscan
            signal = self.full_range is not None or self.colour is not None
            b.u(1, signal)
            if signal:
                b.u(3, 5).u(1, self.full_range or 0).u(1, self.colour is not None)
                if self.colour is not None:
                    for v in self.colour:
                        b.u(8, v)
            b.u(1, 0)  # chroma location
            b.u(1, self.timing is not None)
            if self.timing is not None:
                b.u(32, self.timing[0]).u(32, self.timing[1]).u(1, 1)
            b.u(1, 0).u(1, 0).u(1, 0)  # no HRD, pic_struct_present_flag 0
            b.u(1, self.restriction is not None)
            if self.restriction is not None:
                b.u(1, 1).ue(2).ue(1).ue(16).ue(16).ue(self.restriction)
                b.ue(max(self.restriction, self.max_num_ref_frames))
        return b.trailing().bytes()

    def nal(self) -> bytes:
        return nal_unit(3, 7, self.rbsp())

    @property
    def max_frame_num(self) -> int:
        return 1 << self.log2_max_frame_num


@dataclasses.dataclass
class Pps:
    id: int = 0
    sps_id: int = 0
    num_ref_idx_default: int = 1
    init_qp: int = 26
    cb_offset: int = 0
    cr_offset: Optional[int] = None  # a second offset (the High profiles' PPS tail) when set
    deblocking_control: int = 1
    constrained_intra: int = 0
    bottom_field_pic_order: int = 0
    # the fields of what the decoder refuses
    cabac: int = 0
    slice_groups: int = 1
    weighted_pred: int = 0
    redundant: int = 0
    transform_8x8: int = 0
    scaling: int = 0

    def rbsp(self) -> bytes:
        b = Bits().ue(self.id).ue(self.sps_id).u(1, self.cabac).u(1, self.bottom_field_pic_order)
        b.ue(self.slice_groups - 1)
        if self.slice_groups > 1:
            b.ue(0)  # slice_group_map_type 0 (interleaved)
            for _ in range(self.slice_groups):
                b.ue(0)
        b.ue(self.num_ref_idx_default - 1).ue(0).u(1, self.weighted_pred).u(2, 0)
        b.se(self.init_qp - 26).se(0).se(self.cb_offset)
        b.u(1, self.deblocking_control).u(1, self.constrained_intra).u(1, self.redundant)
        if self.cr_offset is not None or self.transform_8x8 or self.scaling:
            b.u(1, self.transform_8x8).u(1, self.scaling)
            if self.scaling:
                for _ in range(6 + 2 * self.transform_8x8):
                    b.u(1, 0)
            b.se(self.cb_offset if self.cr_offset is None else self.cr_offset)
        return b.trailing().bytes()

    def nal(self) -> bytes:
        return nal_unit(3, 8, self.rbsp())


def aud(kind: int = 1) -> bytes:
    return nal_unit(0, 9, Bits().u(3, kind).trailing().bytes())


def sei(payload: bytes = b"viddet-tests") -> bytes:
    """user_data_unregistered: a UUID and ``payload``."""
    body = bytes(range(16)) + payload
    return nal_unit(0, 6, bytes([5, len(body)]) + body + b"\x80")


def filler(n: int = 6) -> bytes:
    return nal_unit(0, 12, b"\xff" * n + b"\x80")


def cabac_track(width: int = 64, height: int = 48) -> Tuple[bytes, List[bytes]]:
    """An H.264 track the port refuses: an avcC whose PPS selects CABAC
    (entropy_coding_mode_flag 1), and three placeholder samples (the
    refusal comes before any is read)."""
    sps = Sps(profile=77, mb_w=(width + 15) // 16, mb_h=(height + 15) // 16)
    return avcc([sps.nal()], [Pps(cabac=1).nal()]), [b"\0\0\0\x05\x65\x88\x80\x10\x00"] * 3


# ------------------------------------------------------------ the writer

I4, I16, PCM, INTER, SKIP = "I4", "I16", "PCM", "P", "SKIP"


@dataclasses.dataclass
class Ref:
    """A reference frame as the writer tracks it (and its planes, for the
    plain encoder)."""
    frame_num: int
    long_idx: int = -1  # -1: short-term
    key: int = 0  # identity
    planes: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None


class Writer:
    """An H.264 sequence: ``sps`` and ``pps`` (lists: every set of the
    stream, the first of each active unless a picture names another), the
    decoded picture buffer and the order state.  Each ``*_picture`` call
    returns the access unit's NAL units (without start codes or lengths)."""

    def __init__(self, width: int, height: int, seed: int = 0, sps: Optional[Sps] = None,
                 pps: Optional[Pps] = None):
        self.rng = np.random.default_rng(seed)
        mb_w, mb_h = (width + 15) // 16, (height + 15) // 16
        self.sps = [sps or Sps()]
        self.sps[0].mb_w, self.sps[0].mb_h = mb_w, mb_h
        self.pps = [pps or Pps()]
        self.mb_w, self.mb_h = mb_w, mb_h
        self.refs: List[Ref] = []
        self.max_long_idx = -1
        self.frame_num = 0  # of the next picture
        self.poc_count = 0  # pictures since the order restarted
        self.pictures = 0
        self.next_key = 1

    # ----------------------------------------------------------- headers

    def sps_for(self, pps: Pps) -> Sps:
        return next(s for s in self.sps if s.id == pps.sps_id)

    def parameter_sets(self) -> List[bytes]:
        return [s.nal() for s in self.sps] + [p.nal() for p in self.pps]

    def frame_num_wrap(self, r: Ref, frame_num: int, sps: Sps) -> int:
        return r.frame_num - sps.max_frame_num if r.frame_num > frame_num else r.frame_num

    def initial_list(self, frame_num: int, sps: Sps) -> List[Ref]:
        shorts = sorted((r for r in self.refs if r.long_idx < 0),
                        key=lambda r: -self.frame_num_wrap(r, frame_num, sps))
        longs = sorted((r for r in self.refs if r.long_idx >= 0), key=lambda r: r.long_idx)
        return shorts + longs

    def modifications(self, order: Sequence[Ref], frame_num: int, sps: Sps
                      ) -> Tuple[List[Tuple[int, int]], List[Ref]]:
        """The commands that put ``order`` at the head of the list, and the
        list they give."""
        max_pic = sps.max_frame_num
        pred, mods = frame_num, []
        for r in order:
            if r.long_idx >= 0:
                mods.append((2, r.long_idx))
                continue
            pic = self.frame_num_wrap(r, frame_num, sps)
            no_wrap = pic + max_pic if pic < 0 else pic
            if self.rng.random() < 0.5:
                diff = (pred - no_wrap) % max_pic or max_pic
                mods.append((0, diff - 1))
            else:
                diff = (no_wrap - pred) % max_pic or max_pic
                mods.append((1, diff - 1))
            pred = no_wrap
        return mods

    def slice_header(self, b: Bits, *, idr: bool, ref_idc: int, first_mb: int, slice_type: int,
                     pps: Pps, sps: Sps, frame_num: int, idr_pic_id: int, poc: dict,
                     num_ref_idx: Optional[int], mods: Sequence[Tuple[int, int]],
                     marking: dict, qp: int, deblock: Tuple[int, int, int]) -> None:
        b.ue(first_mb).ue(slice_type).ue(pps.id).u(sps.log2_max_frame_num, frame_num)
        if idr:
            b.ue(idr_pic_id)
        if sps.poc_type == 0:
            b.u(sps.log2_max_poc_lsb, poc["lsb"])
            if pps.bottom_field_pic_order:
                b.se(poc.get("bottom", 0))
        elif sps.poc_type == 1 and not sps.delta_pic_order_always_zero:
            b.se(poc.get("delta", 0))
            if pps.bottom_field_pic_order:
                b.se(0)
        if slice_type % 5 in (0, 1, 3):
            b.u(1, num_ref_idx is not None)
            if num_ref_idx is not None:
                b.ue(num_ref_idx - 1)
            if slice_type % 5 == 1:
                b.u(1, 0)  # direct_spatial... never reached: B slices are refused before
            b.u(1, bool(mods))
            for idc, v in mods:
                b.ue(idc).ue(v)
            if mods:
                b.ue(3)
        if ref_idc:
            if idr:
                b.u(1, 0).u(1, marking.get("long", 0))
            else:
                ops = marking.get("mmco")
                b.u(1, ops is not None)
                for op in ops or ():
                    b.ue(op[0])
                    for v in op[1:]:
                        b.ue(v)
                if ops is not None:
                    b.ue(0)
        b.se(qp - pps.init_qp)
        if pps.deblocking_control:
            b.ue(deblock[0])
            if deblock[0] != 1:
                b.se(deblock[1]).se(deblock[2])

    # ------------------------------------------------------- the pictures

    def _picture(self, *, kind: str, ref_idc: int, pps: Pps, slices: Sequence[int],
                 qps: Sequence[int], deblocks: Sequence[Tuple[int, int, int]],
                 num_ref_idx: Optional[int], order: Sequence[Ref], marking: dict,
                 mb_source, poc: Optional[dict] = None) -> Tuple[List[bytes], dict]:
        sps = self.sps_for(pps)
        idr = kind == "IDR"
        max_fn = sps.max_frame_num
        if idr:
            self.refs, self.max_long_idx = [], -1
            self.frame_num = self.poc_count = 0
        frame_num = self.frame_num
        poc = dict(poc or self.next_poc(sps))
        ref_list: List[Ref] = []
        mods: List[Tuple[int, int]] = []
        if kind == "P":
            n = num_ref_idx or pps.num_ref_idx_default
            base = self.initial_list(frame_num, sps)
            if order:
                mods = self.modifications(order, frame_num, sps)
                rest = [r for r in base if all(r is not o for o in order)]
                ref_list = (list(order) + rest)[:n]
            else:
                ref_list = base[:n]
        state = PictureState(self, pps, sps, ref_list)
        state.n_active = (num_ref_idx or pps.num_ref_idx_default) if kind == "P" else 0
        units = []
        starts = list(slices) + [self.mb_w * self.mb_h]
        for s, first in enumerate(slices):
            b = Bits()
            slice_type = {"IDR": 7, "I": 7, "P": 5}[kind] if s == 0 else {"IDR": 2, "I": 2,
                                                                           "P": 0}[kind]
            self.slice_header(b, idr=idr, ref_idc=ref_idc, first_mb=first,
                              slice_type=slice_type, pps=pps, sps=sps, frame_num=frame_num,
                              idr_pic_id=self.pictures % 65536, poc=poc,
                              num_ref_idx=num_ref_idx if kind == "P" else None, mods=mods,
                              marking=marking, qp=qps[s], deblock=deblocks[s])
            state.slice_data(b, s, first, starts[s + 1], kind == "P", qps[s], mb_source)
            units.append(nal_unit(ref_idc, 5 if idr else 1, b.trailing().bytes()))
        info = {"frame_num": frame_num, "poc": poc, "state": state}
        self.after_picture(sps, idr, ref_idc, marking, frame_num, state)
        return units, info

    def skip_frame_nums(self, sps: Sps, gap: int) -> None:
        """Leave ``gap`` frame_num values out: the decoder infers a frame for
        each, marked by the sliding window."""
        assert sps.gaps
        for _ in range(gap):
            self.sliding_window(sps, self.frame_num)
            self.refs.append(Ref(self.frame_num, key=self.new_key()))
            self.frame_num = (self.frame_num + 1) % sps.max_frame_num

    def mmco(self, *ops: int, pps: Optional[Pps] = None) -> list:
        """Memory management operations of the kinds ``ops`` (1-6, in
        order) that are valid for the next reference picture, choosing their
        pictures and indices at random, then MMCO 1 / 2 as needed so that the
        buffer keeps within max_num_ref_frames."""
        sps = self.sps_for(pps or self.pps[0])
        rng, fn = self.rng, self.frame_num
        refs = [[r.key, r.long_idx, self.frame_num_wrap(r, fn, sps)] for r in self.refs]
        max_long, out = self.max_long_idx, []
        for op in ops:
            shorts = [r for r in refs if r[1] < 0]
            longs = [r for r in refs if r[1] >= 0]
            if op == 1 and shorts:
                r = shorts[int(rng.integers(len(shorts)))]
                out.append((1, fn - r[2] - 1))
                refs.remove(r)
            elif op == 2 and longs:
                r = longs[int(rng.integers(len(longs)))]
                out.append((2, r[1]))
                refs.remove(r)
            elif op == 3 and shorts and max_long >= 0:
                r, idx = shorts[int(rng.integers(len(shorts)))], int(rng.integers(0, max_long + 1))
                out.append((3, fn - r[2] - 1, idx))
                refs = [q for q in refs if q[1] != idx]
                r[1] = idx
            elif op == 4:
                v = int(rng.integers(1, 4))
                out.append((4, v))
                max_long = v - 1
                refs = [q for q in refs if q[1] <= max_long]
            elif op == 5:
                out.append((5,))
                refs, max_long = [], -1
            elif op == 6 and max_long >= 0:
                idx = int(rng.integers(0, max_long + 1))
                out.append((6, idx))
                refs = [q for q in refs if q[1] != idx]
        while len(refs) + 1 > max(sps.max_num_ref_frames, 1):
            shorts = [r for r in refs if r[1] < 0]
            r = shorts[0] if shorts else refs[0]
            out.append((1, fn - r[2] - 1) if r[1] < 0 else (2, r[1]))
            refs.remove(r)
        return out

    def new_key(self) -> int:
        self.next_key += 1
        return self.next_key

    def next_poc(self, sps: Sps) -> dict:
        if sps.poc_type == 0:
            return {"lsb": (2 * self.poc_count) % (1 << sps.log2_max_poc_lsb)}
        return {}

    def sliding_window(self, sps: Sps, frame_num: int) -> None:
        shorts = [r for r in self.refs if r.long_idx < 0]
        if shorts and len(self.refs) >= max(sps.max_num_ref_frames, 1):
            oldest = min(shorts, key=lambda r: self.frame_num_wrap(r, frame_num, sps))
            self.refs.remove(oldest)

    def after_picture(self, sps: Sps, idr: bool, ref_idc: int, marking: dict, frame_num: int,
                      state: "PictureState") -> None:
        self.pictures += 1
        self.poc_count += 1
        if not ref_idc:
            return
        cur = Ref(frame_num, key=self.new_key(), planes=state.recon)
        ops = marking.get("mmco")
        if idr:
            if marking.get("long"):
                cur.long_idx, self.max_long_idx = 0, 0
            self.refs = [cur]
        elif ops is None:
            self.sliding_window(sps, frame_num)
            self.refs.append(cur)
        else:
            for op in ops:
                if op[0] in (1, 3):
                    pic = frame_num - (op[1] + 1)
                    r = next(r for r in self.refs if r.long_idx < 0
                             and self.frame_num_wrap(r, frame_num, sps) == pic)
                    if op[0] == 1:
                        self.refs.remove(r)
                    else:
                        self.refs = [q for q in self.refs if q.long_idx != op[2]]
                        r.long_idx = op[2]
                elif op[0] == 2:
                    self.refs = [q for q in self.refs if q.long_idx != op[1]]
                elif op[0] == 4:
                    self.max_long_idx = op[1] - 1
                    self.refs = [q for q in self.refs if q.long_idx <= self.max_long_idx]
                elif op[0] == 5:
                    self.refs, self.max_long_idx = [], -1
                    cur.frame_num = 0
                    frame_num = 0
                    self.poc_count = 1  # the next picture's order count follows 0
                elif op[0] == 6:
                    self.refs = [q for q in self.refs if q.long_idx != op[1]]
                    cur.long_idx = op[1]
            self.refs.append(cur)
            assert len(self.refs) <= max(sps.max_num_ref_frames, 1), "too many references"
        self.frame_num = (cur.frame_num + 1) % sps.max_frame_num

    # --------------------------------------------------- random pictures

    def random_picture(self, kind: str = "P", *, ref_idc: int = 1, pps: Optional[Pps] = None,
                       slices: int = 1, qp: Optional[int] = None, deblock: Optional[str] = None,
                       num_ref_idx: Optional[int] = None, modify: bool = False,
                       mmco: Optional[list] = None, long_term: bool = False,
                       mb_kinds: Sequence[str] = (I4, I16, INTER, SKIP), pcm: float = 0.0,
                       sub_partitions: bool = True, off_frame: float = 0.1,
                       qp_range: Tuple[int, int] = (0, 51), escapes: bool = True,
                       gap: int = 0, poc: Optional[dict] = None,
                       coeff_density: float = 0.5) -> Tuple[List[bytes], dict]:
        """One access unit of seeded legal syntax; ``deblock`` None, "off",
        "slices" or "offsets" sets each slice's disable_deblocking_filter_idc
        and offsets; ``modify`` reorders the list at random."""
        rng = self.rng
        pps = pps or self.pps[0]
        sps = self.sps_for(pps)
        if kind == "IDR":
            ref_idc = max(ref_idc, 1)
        total = self.mb_w * self.mb_h
        cuts = sorted(set(rng.choice(np.arange(1, total), size=min(slices - 1, total - 1),
                                     replace=False).tolist())) if slices > 1 else []
        firsts = [0] + cuts
        qps = [int(rng.integers(*qp_range, endpoint=True)) if qp is None else qp
               for _ in firsts]
        deblocks = []
        for _ in firsts:
            if deblock is None:
                deblocks.append((0, 0, 0))
            elif deblock == "off":
                deblocks.append((int(rng.choice([0, 1])), 0, 0))
            elif deblock == "slices":
                deblocks.append((int(rng.choice([0, 2])), 0, 0))
            else:
                deblocks.append((int(rng.choice([0, 2])), int(rng.integers(-6, 7)),
                                 int(rng.integers(-6, 7))))
        if gap:
            self.skip_frame_nums(sps, gap)
        order: List[Ref] = []
        if kind == "P" and modify:
            candidates = list(self.refs)
            rng.shuffle(candidates)
            order = candidates[: int(rng.integers(1, len(candidates) + 1))]
        marking = {"long": int(long_term)} if kind == "IDR" else (
            {"mmco": mmco} if mmco is not None else {})
        source = RandomMbs(rng, mb_kinds=mb_kinds, pcm=pcm, sub_partitions=sub_partitions,
                           off_frame=off_frame, qp_range=qp_range, escapes=escapes,
                           density=coeff_density, high=sps.profile in HIGH_PROFILES)
        return self._picture(kind=kind, ref_idc=ref_idc, pps=pps, slices=firsts, qps=qps,
                             deblocks=deblocks, num_ref_idx=num_ref_idx, order=order,
                             marking=marking, mb_source=source, poc=poc)

    # ---------------------------------------------------- plain encoding

    def encode_picture(self, rgb: np.ndarray, kind: str = "P", *, qp: int = 28, slices: int = 1,
                       search: int = 4) -> Tuple[List[bytes], dict]:
        """One access unit coding ``rgb`` (H x W x 3 uint8, the writer's
        size); a P picture predicts from the last reference, whose planes
        the caller sets with ``set_reference_planes`` (the decoder's)."""
        pps = self.pps[0]
        y, u, v = rgb_to_yuv420(rgb, 16 * self.mb_w, 16 * self.mb_h)
        total = self.mb_w * self.mb_h
        firsts = [i * total // slices for i in range(slices)]
        source = PlainMbs((y, u, v), qp, search)
        return self._picture(kind=kind, ref_idc=1, pps=pps, slices=firsts, qps=[qp] * slices,
                             deblocks=[(0, 0, 0)] * slices, num_ref_idx=1, order=(),
                             marking={}, mb_source=source)

    def set_reference_planes(self, planes: Tuple[np.ndarray, np.ndarray, np.ndarray]) -> None:
        """The decoded (deblocked, uncropped) planes of the last reference."""
        latest = max(self.refs, key=lambda r: r.key)
        latest.planes = planes


# ------------------------------------------------ the macroblock layer


def rgb_to_yuv420(rgb: np.ndarray, width: int, height: int):
    """BT.601 limited range, the picture padded to ``width`` x ``height`` by
    repeating its edge."""
    f = rgb.astype(np.float64)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = 16 + 0.257 * r + 0.504 * g + 0.098 * b
    cb = 128 - 0.148 * r - 0.291 * g + 0.439 * b
    cr = 128 + 0.439 * r - 0.368 * g - 0.071 * b
    h, w = y.shape
    pad = ((0, height - h), (0, width - w))
    y = np.pad(y, pad, mode="edge")
    cb = np.pad(cb, pad, mode="edge")
    cr = np.pad(cr, pad, mode="edge")
    sub = lambda p: p.reshape(height // 2, 2, width // 2, 2).mean(axis=(1, 3))  # noqa: E731
    to8 = lambda p: np.clip(np.round(p), 0, 255).astype(np.int32)  # noqa: E731
    return to8(y), to8(sub(cb)), to8(sub(cr))


class PictureState:
    """The neighbour state of one picture as the decoder keeps it, and the
    macroblock layer's writing."""

    def __init__(self, writer: Writer, pps: Pps, sps: Sps, ref_list: List[Ref]):
        self.w = writer
        self.pps, self.sps, self.list = pps, sps, ref_list
        mb_w, mb_h = writer.mb_w, writer.mb_h
        self.mb_w, self.mb_h = mb_w, mb_h
        self.kind = [None] * (mb_w * mb_h)
        self.slice = [-1] * (mb_w * mb_h)
        self.nz = np.zeros((4 * mb_h, 4 * mb_w), np.int32)
        self.nz_c = [np.zeros((2 * mb_h, 2 * mb_w), np.int32) for _ in range(2)]
        self.modes = np.full((4 * mb_h, 4 * mb_w), 2, np.int32)
        self.ref = np.full((4 * mb_h, 4 * mb_w), -1, np.int32)
        self.mv = np.zeros((4 * mb_h, 4 * mb_w, 2), np.int32)
        self.cur_slice = 0
        self.done = 0
        self.recon = (np.zeros((16 * mb_h, 16 * mb_w), np.int32),
                      np.zeros((8 * mb_h, 8 * mb_w), np.int32),
                      np.zeros((8 * mb_h, 8 * mb_w), np.int32))

    # ------------------------------------------------------ availability

    def available(self, addr: int) -> bool:
        return addr >= 0 and self.slice[addr] == self.cur_slice

    def mb_at(self, mx: int, my: int, dx: int, dy: int) -> int:
        x, y = mx + dx, my + dy
        if x < 0 or y < 0 or x >= self.mb_w:
            return -1
        return y * self.mb_w + x

    def intra_available(self, mx: int, my: int, dx: int, dy: int) -> bool:
        a = self.mb_at(mx, my, dx, dy)
        if a < 0 or not self.available(a):
            return False
        return not self.pps.constrained_intra or self.kind[a] in (I4, I16, PCM)

    def i4_available(self, mx, my, bx, by):
        """(left, top, top-left, top-right) of an intra 4x4 block."""
        left = bx > 0 or self.intra_available(mx, my, -1, 0)
        top = by > 0 or self.intra_available(mx, my, 0, -1)
        if bx > 0 and by > 0:
            top_left = True
        elif bx > 0:
            top_left = self.intra_available(mx, my, 0, -1)
        elif by > 0:
            top_left = self.intra_available(mx, my, -1, 0)
        else:
            top_left = self.intra_available(mx, my, -1, -1)
        if by == 0:
            top_right = self.intra_available(mx, my, 0 if bx < 3 else 1, -1)
        elif bx == 3:
            top_right = False
        else:
            top_right = block_order(bx + 1, by - 1) < block_order(bx, by)
        return left, top, top_left, top_right

    def predicted_mode(self, mx, my, bx, by) -> int:
        def mode_of(x, y):
            if x >= 0 and y >= 0:
                return self.modes[my * 4 + y, mx * 4 + x]
            a = self.mb_at(mx, my, -1 if x < 0 else 0, -1 if y < 0 else 0)
            if a < 0 or not self.available(a):
                return None
            if self.kind[a] not in (I4, I16, PCM) and self.pps.constrained_intra:
                return None
            if self.kind[a] != I4:
                return 2
            return self.modes[my * 4 + y, mx * 4 + x]
        a, b = mode_of(bx - 1, by), mode_of(bx, by - 1)
        return 2 if a is None or b is None else int(min(a, b))

    def nc(self, grid: np.ndarray, per: int, mx, my, bx, by) -> int:
        def at(x, y):
            if x < 0 or y < 0:
                return None
            if not (x >= mx * per and y >= my * per):
                if not self.available((y // per) * self.mb_w + x // per):
                    return None
            return int(grid[y, x])
        x, y = mx * per + bx, my * per + by
        a, b = at(x - 1, y), at(x, y - 1)
        if a is not None and b is not None:
            return (a + b + 1) >> 1
        return a if a is not None else b if b is not None else 0

    def neighbour(self, mx, my, bx, by):
        """(available, ref, mv) of the 4x4 block at (bx, by) relative to the
        macroblock."""
        if 0 <= bx < 4 and 0 <= by < 4:
            if not (self.done >> (by * 4 + bx)) & 1:
                return False, -1, (0, 0)
        else:
            if by >= 4 or (bx >= 4 and by >= 0):
                return False, -1, (0, 0)
            ax, ay = mx * 4 + bx, my * 4 + by
            if ax < 0 or ay < 0 or ax >= 4 * self.mb_w:
                return False, -1, (0, 0)
            if not self.available((ay >> 2) * self.mb_w + (ax >> 2)):
                return False, -1, (0, 0)
        y, x = my * 4 + by, mx * 4 + bx
        return True, int(self.ref[y, x]), (int(self.mv[y, x, 0]), int(self.mv[y, x, 1]))

    def predict(self, mx, my, bx, by, w, ref, shape):
        ha, ra, ma = self.neighbour(mx, my, bx - 1, by)
        hb, rb, mb = self.neighbour(mx, my, bx, by - 1)
        hc, rc, mc = self.neighbour(mx, my, bx + w, by - 1)
        if not hc:
            hc, rc, mc = self.neighbour(mx, my, bx - 1, by - 1)
        if shape == 1 and rb == ref:
            return mb
        if shape in (2, 3) and ra == ref:
            return ma
        if shape == 4 and rc == ref:
            return mc
        if not hb and not hc and ha:
            return ma
        match = [r == ref for r in (ra, rb, rc)]
        if sum(match) == 1:
            return (ma, mb, mc)[match.index(True)]
        return (sorted((ma[0], mb[0], mc[0]))[1], sorted((ma[1], mb[1], mc[1]))[1])

    def skip_mv(self, mx, my):
        ha, ra, ma = self.neighbour(mx, my, -1, 0)
        hb, rb, mb = self.neighbour(mx, my, 0, -1)
        if not ha or not hb or (ra == 0 and ma == (0, 0)) or (rb == 0 and mb == (0, 0)):
            return (0, 0)
        return self.predict(mx, my, 0, 0, 4, 0, 0)

    def set_motion(self, mx, my, bx, by, w, h, ref, mv):
        self.ref[my * 4 + by:my * 4 + by + h, mx * 4 + bx:mx * 4 + bx + w] = ref
        self.mv[my * 4 + by:my * 4 + by + h, mx * 4 + bx:mx * 4 + bx + w] = mv
        for j in range(by, by + h):
            for i in range(bx, bx + w):
                self.done |= 1 << (j * 4 + i)

    # ----------------------------------------------------------- writing

    def slice_data(self, b: Bits, s: int, first: int, end: int, p_slice: bool, qp: int,
                   source) -> None:
        self.cur_slice = s
        self.qp = qp
        run = 0
        for addr in range(first, end):
            mx, my = addr % self.mb_w, addr // self.mb_w
            self.done = 0
            mb = source.decide(self, mx, my, p_slice)
            if mb["kind"] == SKIP:
                self.slice[addr], self.kind[addr] = s, SKIP
                mv = self.skip_mv(mx, my)
                self.set_motion(mx, my, 0, 0, 4, 4, 0, mv)
                source.skipped(self, mx, my, mv)
                run += 1
                continue
            if p_slice:
                b.ue(run)
                run = 0
            self.macroblock(b, addr, mx, my, mb, p_slice)
        if run:
            b.ue(run)

    def macroblock(self, b: Bits, addr: int, mx: int, my: int, mb: dict, p_slice: bool):
        self.slice[addr], self.kind[addr] = self.cur_slice, mb["kind"]
        kind = mb["kind"]
        offset = 5 if p_slice else 0
        if kind == PCM:
            b.ue(offset + 25).align()
            b.raw(bytes(mb["samples"]))
            self.nz[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 16
            for g in self.nz_c:
                g[my * 2:my * 2 + 2, mx * 2:mx * 2 + 2] = 16
            return
        if kind == I4:
            b.ue(offset + 0)
            for n, (bx, by) in enumerate(BLOCKS):
                mode = mb["modes"][n]
                pred = self.predicted_mode(mx, my, bx, by)
                if mode == pred:
                    b.u(1, 1)
                else:
                    b.u(1, 0).u(3, mode if mode < pred else mode - 1)
                self.modes[my * 4 + by, mx * 4 + bx] = mode
            b.ue(mb["chroma_mode"])
            b.ue(INTRA_CBP_CODE[mb["cbp"]])
        elif kind == I16:
            cbp = mb["cbp"]
            b.ue(offset + 1 + mb["mode"] + 4 * (cbp >> 4) + (12 if cbp & 15 else 0))
            b.ue(mb["chroma_mode"])
        else:
            self.inter(b, mx, my, mb)
            b.ue(INTER_CBP_CODE[mb["cbp"]])
        self.residual(b, mx, my, mb)

    def inter(self, b: Bits, mx: int, my: int, mb: dict) -> None:
        t = mb["type"]
        b.ue(t)
        n_ref = self.n_active
        parts = mb["parts"]  # (bx, by, w, h, shape, ref, mv) in decoding order
        if t < 3:
            for p in parts:
                b.te(n_ref - 1, p[5])
        else:
            for s in mb["subs"]:
                b.ue(s)
            if t == 3:
                for i in range(4):
                    b.te(n_ref - 1, mb["sub_refs"][i])
        for bx, by, w, h, shape, ref, mv in parts:
            pred = self.predict(mx, my, bx, by, w, ref, shape)
            b.se(mv[0] - pred[0]).se(mv[1] - pred[1])
            self.set_motion(mx, my, bx, by, w, h, ref, mv)

    def residual(self, b: Bits, mx: int, my: int, mb: dict) -> None:
        kind, cbp = mb["kind"], mb["cbp"]
        if cbp or kind == I16:
            b.se(mb["qp_delta"])
        luma = mb["luma"]  # 16 blocks in decoding order, coefficients in scan order
        if kind == I16:
            self.block(b, self.nc(self.nz, 4, mx, my, 0, 0), mb["dc"], 16)
        for n, (bx, by) in enumerate(BLOCKS):
            total = 0
            if cbp & (1 << (n >> 2)):
                nc = self.nc(self.nz, 4, mx, my, bx, by)
                total = self.block(b, nc, luma[n][1:] if kind == I16 else luma[n],
                                   15 if kind == I16 else 16)
            self.nz[my * 4 + by, mx * 4 + bx] = total
        if cbp >> 4:
            for c in range(2):
                self.block(b, -1, mb["cdc"][c], 4)
        for c in range(2):
            for n in range(4):
                total = 0
                if cbp >> 4 == 2:
                    total = self.block(b, self.nc(self.nz_c[c], 2, mx, my, n & 1, n >> 1),
                                       mb["cac"][c][n][1:], 15)
                self.nz_c[c][my * 2 + (n >> 1), mx * 2 + (n & 1)] = total

    def block(self, b: Bits, nc: int, coeffs: Sequence[int], max_coeff: int) -> int:
        """residual_block_cavlc of ``coeffs`` (scan order, ``max_coeff`` of
        them); returns total_coeff."""
        coeffs = [int(c) for c in coeffs[:max_coeff]]
        nonzero = [i for i, c in enumerate(coeffs) if c]
        total = len(nonzero)
        levels = [coeffs[i] for i in reversed(nonzero)]  # highest frequency first
        ones = 0
        for v in levels:
            if abs(v) != 1 or ones == 3:
                break
            ones += 1
        k = total * 4 + ones
        if nc < 0:
            b.u(CHROMA_DC_TOKEN_LEN[k], CHROMA_DC_TOKEN_BITS[k])
        else:
            t = 0 if nc < 2 else 1 if nc < 4 else 2 if nc < 8 else 3
            b.u(COEFF_TOKEN_LEN[t][k], COEFF_TOKEN_BITS[t][k])
        if not total:
            return 0
        for v in levels[:ones]:
            b.u(1, v < 0)
        suffix = 1 if total > 10 and ones < 3 else 0
        for i in range(ones, total):
            v = levels[i]
            code = 2 * v - 2 if v > 0 else -2 * v - 1
            if i == ones and ones < 3:
                code -= 2
            if code < 0:
                raise ValueError("a level that trailing_ones should have taken")
            if suffix == 0:
                if code < 14:
                    b.u(code + 1, 1)
                elif code < 30:
                    b.u(15, 1).u(4, code - 14)
                elif code - 30 < 4096:
                    b.u(16, 1).u(12, code - 30)
                else:
                    self.escape16(b, code, 0)
            else:
                if code < (15 << suffix):
                    b.u((code >> suffix) + 1, 1).u(suffix, code & ((1 << suffix) - 1))
                elif code - (15 << suffix) < 4096:
                    b.u(16, 1).u(12, code - (15 << suffix))
                else:
                    self.escape16(b, code, suffix)
            if suffix == 0:
                suffix = 1
            if abs(v) > (3 << (suffix - 1)) and suffix < 6:
                suffix += 1
        if total < max_coeff:
            zeros = nonzero[-1] + 1 - total
            if max_coeff == 4:
                b.u(CHROMA_DC_ZEROS_LEN[total - 1][zeros], CHROMA_DC_ZEROS_BITS[total - 1][zeros])
            else:
                b.u(TOTAL_ZEROS_LEN[total - 1][zeros], TOTAL_ZEROS_BITS[total - 1][zeros])
        else:
            zeros = 0
        positions = list(reversed(nonzero))
        for i in range(total - 1):
            if zeros <= 0:
                break
            run = positions[i] - positions[i + 1] - 1
            t = min(zeros, 7) - 1
            b.u(RUN_LEN[t][run], RUN_BITS[t][run])
            zeros -= run
        return total

    @staticmethod
    def escape16(b: Bits, code: int, suffix: int) -> None:
        """level_prefix 16: levelCode = (15 << suffix) (+ 15 when suffix is
        0) + 4096 + a 13-bit level_suffix."""
        value = code - (15 << suffix) - (15 if suffix == 0 else 0) - 4096
        assert 0 <= value < 8192, code
        b.u(17, 1).u(13, value)


# ------------------------------------------------------- random decisions


def random_levels(rng, n: int, density: float, qp: int, escapes: bool, high: bool,
                  dc: bool = False) -> List[int]:
    """``n`` coefficients in scan order whose dequantised values stay well
    inside 16 bits, the standard's bound on a conforming stream, which
    FFmpeg's int16 blocks rely on."""
    out = [0] * n
    if rng.random() > density:
        return out
    largest = DEQUANT[qp % 6][1] << (qp // 6)
    budget = max(1, (2000 if dc else 16000) // largest)  # the sum of |level|
    count = int(rng.integers(1, min(n, budget) + 1))
    left = budget
    for k, i in enumerate(sorted(rng.choice(n, size=count, replace=False).tolist())):
        most = left - (count - k - 1)
        v = 1 if rng.random() < 0.5 else int(rng.integers(1, min(most, 40) + 1))
        if escapes and most >= 16 and rng.random() < 0.2:
            v = int(rng.integers(16, min(most, 300) + 1))
        left -= v
        out[i] = v if rng.random() < 0.5 else -v
    if high and escapes and not dc and qp <= 3 and rng.random() < 0.1:
        # a level_prefix of 16: one DC level past 2063, 20,000 or so dequantised
        out = [0] * n
        out[0] = int(rng.choice([-1, 1]) * rng.integers(2070, 2080))
    return out


class RandomMbs:
    def __init__(self, rng, mb_kinds, pcm, sub_partitions, off_frame, qp_range, escapes,
                 density, high):
        self.rng = rng
        self.mb_kinds, self.pcm, self.sub = list(mb_kinds), pcm, sub_partitions
        self.off_frame, self.qp_range, self.escapes = off_frame, qp_range, escapes
        self.density, self.high = density, high

    def skipped(self, state, mx, my, mv):
        pass

    def decide(self, state: PictureState, mx: int, my: int, p_slice: bool) -> dict:
        rng = self.rng
        kinds = [k for k in self.mb_kinds if p_slice or k in (I4, I16)]
        if p_slice and not state.list:
            kinds = [k for k in kinds if k in (I4, I16)]
        if rng.random() < self.pcm:
            return {"kind": PCM, "samples": rng.integers(0, 256, 384).tolist()}
        kind = kinds[int(rng.integers(len(kinds)))]
        if kind == SKIP:
            return {"kind": SKIP}
        mb = {"kind": kind}
        if kind == I4:
            modes = []
            saved = state.modes.copy()
            for n, (bx, by) in enumerate(BLOCKS):
                left, top, top_left, _ = state.i4_available(mx, my, bx, by)
                ok = [1 if left else None, 2, 0 if top else None, 3 if top else None,
                      7 if top else None, 8 if left else None,
                      4 if top and left and top_left else None,
                      5 if top and left and top_left else None,
                      6 if top and left and top_left else None]
                ok = [m for m in ok if m is not None]
                pred = state.predicted_mode(mx, my, bx, by)
                mode = pred if pred in ok and rng.random() < 0.3 else int(rng.choice(ok))
                modes.append(mode)
                state.modes[my * 4 + by, mx * 4 + bx] = mode
            state.modes[:] = saved
            mb["modes"] = modes
            mb["cbp"] = int(rng.integers(0, 48))
        elif kind == I16:
            left = state.intra_available(mx, my, -1, 0)
            top = state.intra_available(mx, my, 0, -1)
            top_left = state.intra_available(mx, my, -1, -1)
            ok = [2] + ([0] if top else []) + ([1] if left else []) + (
                [3] if top and left and top_left else [])
            mb["mode"] = int(rng.choice(ok))
            mb["cbp"] = int(rng.integers(0, 3)) << 4 | int(rng.choice([0, 15]))
        else:
            self.inter(state, mx, my, mb)
            mb["cbp"] = int(rng.integers(0, 48))
        if kind in (I4, I16, INTER):
            left = state.intra_available(mx, my, -1, 0)
            top = state.intra_available(mx, my, 0, -1)
            top_left = state.intra_available(mx, my, -1, -1)
            ok = [0] + ([1] if left else []) + ([2] if top else []) + (
                [3] if top and left and top_left else [])
            mb["chroma_mode"] = int(rng.choice(ok))
        lo, hi = self.qp_range
        target = int(rng.integers(lo, hi + 1)) if rng.random() < 0.5 else state.qp
        delta = max(-26, min(25, target - state.qp))
        if mb["cbp"] or kind == I16:
            mb["qp_delta"] = delta
            state.qp = (state.qp + delta) % 52
        qp = state.qp
        qc = CHROMA_QP[max(0, min(51, qp + state.pps.cb_offset))]
        qc2 = CHROMA_QP[max(0, min(51, qp + (state.pps.cr_offset if state.pps.cr_offset
                                               is not None else state.pps.cb_offset)))]
        r = lambda n, q, dc=False: random_levels(rng, n, self.density, q, self.escapes,  # noqa
                                                 self.high, dc)
        mb["luma"] = [r(16, qp) for _ in range(16)]
        if kind == I16:
            mb["dc"] = r(16, qp, True)
            for blk in mb["luma"]:
                blk[0] = 0
        mb["cdc"] = [r(4, qc, True), r(4, qc2, True)]
        mb["cac"] = [[[0] + r(15, q) for _ in range(4)] for q in (qc, qc2)]
        return mb

    def inter(self, state: PictureState, mx: int, my: int, mb: dict) -> None:
        rng = self.rng
        n_ref = len([r for r in state.list if r is not None])
        t = int(rng.integers(0, 5 if self.sub else 3))
        mb["type"] = t
        w4 = 4 * state.mb_w

        def vector(bx, by):
            if rng.random() < self.off_frame:
                x = int(rng.integers(-4 * (16 * mx + 80), 4 * (16 * (state.mb_w - mx) + 80)))
                y = int(rng.integers(-4 * (16 * my + 80), 4 * (16 * (state.mb_h - my) + 80)))
                return (x, y)
            ox = int(state.mv[my * 4 + min(by, 3), (mx * 4 + bx - 1) % w4, 0])
            oy = int(state.mv[my * 4 + min(by, 3), (mx * 4 + bx - 1) % w4, 1])
            x = max(-4 * (16 * mx + 40), min(4 * (16 * (state.mb_w - mx) + 24),
                                              ox + int(rng.integers(-20, 21))))
            y = max(-4 * (16 * my + 40), min(4 * (16 * (state.mb_h - my) + 24),
                                              oy + int(rng.integers(-20, 21))))
            return (x, y)

        ref = lambda: int(rng.integers(0, n_ref))  # noqa: E731
        if t == 0:
            mb["parts"] = [(0, 0, 4, 4, 0, ref(), vector(0, 0))]
        elif t == 1:
            mb["parts"] = [(0, 0, 4, 2, 1, ref(), vector(0, 0)), (0, 2, 4, 2, 2, ref(),
                                                                    vector(0, 2))]
        elif t == 2:
            mb["parts"] = [(0, 0, 2, 4, 3, ref(), vector(0, 0)), (2, 0, 2, 4, 4, ref(),
                                                                    vector(2, 0))]
        else:
            subs = [int(rng.integers(0, 4)) for _ in range(4)]
            refs = [ref() if t == 3 else 0 for _ in range(4)]
            parts = []
            for i in range(4):
                ox, oy = (i & 1) * 2, (i >> 1) * 2
                if subs[i] == 0:
                    shapes = [(ox, oy, 2, 2)]
                elif subs[i] == 1:
                    shapes = [(ox, oy, 2, 1), (ox, oy + 1, 2, 1)]
                elif subs[i] == 2:
                    shapes = [(ox, oy, 1, 2), (ox + 1, oy, 1, 2)]
                else:
                    shapes = [(ox + (j & 1), oy + (j >> 1), 1, 1) for j in range(4)]
                for bx, by, w, h in shapes:
                    parts.append((bx, by, w, h, 0, refs[i], vector(bx, by)))
            mb["subs"], mb["sub_refs"], mb["parts"] = subs, refs, parts


# ------------------------------------------------------- plain decisions


def forward4(r: np.ndarray) -> np.ndarray:
    c = np.array([[1, 1, 1, 1], [2, 1, -1, -2], [1, -1, -1, 1], [1, -2, 2, -1]], np.int64)
    return c @ r.astype(np.int64) @ c.T


def quantise(w: np.ndarray, qp: int, intra: bool, skip_dc: bool = False) -> List[int]:
    """A 4x4 block's levels in scan order."""
    qbits = 15 + qp // 6
    f = (1 << qbits) // (3 if intra else 6)
    out = []
    for i, pos in enumerate(ZIGZAG):
        if skip_dc and i == 0:
            out.append(0)
            continue
        v = int(w[pos >> 2, pos & 3])
        q = (abs(v) * QUANT[qp % 6][pos_class(pos)] + f) >> qbits
        out.append(min(q, 2000) * (1 if v >= 0 else -1))
    return out


def dequant_idct(levels: Sequence[int], qp: int, dc: Optional[int] = None) -> np.ndarray:
    """The decoder's residual of one block (8.5.12), ``dc`` its scaled DC
    when it came from a DC transform."""
    d = np.zeros(16, np.int64)
    for i, pos in enumerate(ZIGZAG):
        if i == 0 and dc is not None:
            d[pos] = dc
        else:
            d[pos] = levels[i] * DEQUANT[qp % 6][pos_class(pos)] * (1 << (qp // 6))
    d = d.reshape(4, 4)
    t = np.zeros((4, 4), np.int64)
    for y in range(4):
        r = d[y]
        e, f, g, h = r[0] + r[2], r[0] - r[2], (r[1] >> 1) - r[3], r[1] + (r[3] >> 1)
        t[y] = [e + h, f + g, f - g, e - h]
    out = np.zeros((4, 4), np.int64)
    for x in range(4):
        c = t[:, x]
        e, f, g, h = c[0] + c[2], c[0] - c[2], (c[1] >> 1) - c[3], c[1] + (c[3] >> 1)
        out[:, x] = [e + h, f + g, f - g, e - h]
    return (out + 32) >> 6


def hadamard(c: np.ndarray) -> np.ndarray:
    h = np.array([[1, 1, 1, 1], [1, 1, -1, -1], [1, -1, -1, 1], [1, -1, 1, -1]], np.int64)
    return h @ c @ h


def intra16_pred(rec: np.ndarray, x0: int, y0: int, mode: int, left: bool, top: bool,
                 n: int = 16) -> np.ndarray:
    if mode == 0:
        return np.tile(rec[y0 - 1, x0:x0 + n], (n, 1))
    if mode == 1:
        return np.tile(rec[y0:y0 + n, x0 - 1:x0], (1, n))
    if mode == 2:
        s, k = 0, 0
        if top:
            s, k = s + int(rec[y0 - 1, x0:x0 + n].sum()), k + 1
        if left:
            s, k = s + int(rec[y0:y0 + n, x0 - 1].sum()), k + 1
        v = 128 if not k else (s + (n * k) // 2) // (n * k)
        return np.full((n, n), v, np.int64)
    half = n // 2
    hh = sum((i + 1) * (int(rec[y0 - 1, x0 + half + i]) - int(rec[y0 - 1, x0 + half - 2 - i]))
             for i in range(half))
    vv = sum((i + 1) * (int(rec[y0 + half + i, x0 - 1]) - int(rec[y0 + half - 2 - i, x0 - 1]))
             for i in range(half))
    a = 16 * (int(rec[y0 + n - 1, x0 - 1]) + int(rec[y0 - 1, x0 + n - 1]))
    b = (5 * hh + 32) >> 6
    c = (5 * vv + 32) >> 6
    ys, xs = np.mgrid[0:n, 0:n]
    return np.clip((a + b * (xs - 7) + c * (ys - 7) + 16) >> 5, 0, 255)


def intra4_pred(t: List[int], l: List[int], tl: int, mode: int) -> np.ndarray:
    """The nine intra 4x4 predictions (8.3.1.2) from the top row (8 samples,
    top-right included), the left column and the top-left sample."""
    p = np.zeros((4, 4), np.int64)
    T = lambda x: tl if x < 0 else t[x]  # noqa: E731
    L = lambda y: tl if y < 0 else l[y]  # noqa: E731
    for y in range(4):
        for x in range(4):
            if mode == 0:
                v = t[x]
            elif mode == 1:
                v = l[y]
            elif mode == 3:
                v = (t[6] + 3 * t[7] + 2) >> 2 if x == y == 3 else (
                    t[x + y] + 2 * t[x + y + 1] + t[x + y + 2] + 2) >> 2
            elif mode == 4:
                v = ((T(x - y - 2) + 2 * T(x - y - 1) + T(x - y) + 2) >> 2 if x > y else
                     (L(y - x - 2) + 2 * L(y - x - 1) + L(y - x) + 2) >> 2 if x < y else
                     (T(0) + 2 * tl + L(0) + 2) >> 2)
            elif mode == 5:
                z = 2 * x - y
                v = ((T(x - (y >> 1) - 1) + T(x - (y >> 1)) + 1) >> 1 if z >= 0 and z % 2 == 0
                     else (T(x - (y >> 1) - 2) + 2 * T(x - (y >> 1) - 1) + T(x - (y >> 1)) + 2)
                     >> 2 if z >= 0 else (L(0) + 2 * tl + T(0) + 2) >> 2 if z == -1 else
                     (L(y - 1) + 2 * L(y - 2) + L(y - 3) + 2) >> 2)
            elif mode == 6:
                z = 2 * y - x
                v = ((L(y - (x >> 1) - 1) + L(y - (x >> 1)) + 1) >> 1 if z >= 0 and z % 2 == 0
                     else (L(y - (x >> 1) - 2) + 2 * L(y - (x >> 1) - 1) + L(y - (x >> 1)) + 2)
                     >> 2 if z >= 0 else (L(0) + 2 * tl + T(0) + 2) >> 2 if z == -1 else
                     (T(x - 1) + 2 * T(x - 2) + T(x - 3) + 2) >> 2)
            elif mode == 7:
                i = x + (y >> 1)
                v = (t[i] + 2 * t[i + 1] + t[i + 2] + 2) >> 2 if y & 1 else (t[i] + t[i + 1] + 1) >> 1
            else:
                z = x + 2 * y
                v = (l[3] if z > 5 else (l[2] + 3 * l[3] + 2) >> 2 if z == 5 else
                     (l[y + (x >> 1)] + 2 * l[y + (x >> 1) + 1] + l[y + (x >> 1) + 2] + 2) >> 2
                     if z & 1 else (l[y + (x >> 1)] + l[y + (x >> 1) + 1] + 1) >> 1)
            p[y, x] = v
    return p


class PlainMbs:
    """Intra 16x16 / 4x4 by SAD, P_L0_16x16 from a full-sample search,
    P_Skip, a quantised residual; the reconstruction kept in the picture
    state (before the loop filter, as intra prediction reads it)."""

    def __init__(self, planes, qp: int, search: int):
        self.src = planes
        self.qp = qp
        self.search = search

    def skipped(self, state, mx, my, mv):
        pred = self.inter_pred(state, mx, my, mv)
        for c in range(3):
            n = 16 if c == 0 else 8
            state.recon[c][my * n:my * n + n, mx * n:mx * n + n] = pred[c]

    def inter_pred(self, state, mx, my, mv):
        ref = state.list[0].planes
        out = []
        for c in range(3):
            n = 16 if c == 0 else 8
            plane = ref[c].astype(np.int64)
            h, w = plane.shape
            if c == 0:
                ys = np.clip(np.arange(n) + my * 16 + (mv[1] >> 2), 0, h - 1)
                xs = np.clip(np.arange(n) + mx * 16 + (mv[0] >> 2), 0, w - 1)
                out.append(plane[np.ix_(ys, xs)])
                continue
            fx, fy = mv[0] & 7, mv[1] & 7
            y0 = np.arange(n) + my * 8 + (mv[1] >> 3)
            x0 = np.arange(n) + mx * 8 + (mv[0] >> 3)
            ya, yb = np.clip(y0, 0, h - 1), np.clip(y0 + 1, 0, h - 1)
            xa, xb = np.clip(x0, 0, w - 1), np.clip(x0 + 1, 0, w - 1)
            a, b_ = plane[np.ix_(ya, xa)], plane[np.ix_(ya, xb)]
            c_, d = plane[np.ix_(yb, xa)], plane[np.ix_(yb, xb)]
            out.append(((8 - fx) * (8 - fy) * a + fx * (8 - fy) * b_ + (8 - fx) * fy * c_
                        + fx * fy * d + 32) >> 6)
        return out

    def decide(self, state: PictureState, mx: int, my: int, p_slice: bool) -> dict:
        qp = self.qp
        y0, x0 = my * 16, mx * 16
        src = self.src[0][y0:y0 + 16, x0:x0 + 16].astype(np.int64)
        rec = state.recon[0]
        left = state.intra_available(mx, my, -1, 0)
        top = state.intra_available(mx, my, 0, -1)
        top_left = state.intra_available(mx, my, -1, -1)
        best = None
        for mode in [2] + ([0] if top else []) + ([1] if left else []) + (
                [3] if top and left and top_left else []):
            pred = intra16_pred(rec, x0, y0, mode, left, top)
            sad = int(np.abs(src - pred).sum())
            if best is None or sad < best[0]:
                best = (sad, "I16", mode, pred)
        inter = None
        if p_slice and state.list and state.list[0].planes is not None:
            ref = state.list[0].planes[0].astype(np.int64)
            h, w = ref.shape
            for dy in range(-self.search, self.search + 1):
                for dx in range(-self.search, self.search + 1):
                    ys = np.clip(np.arange(16) + y0 + dy, 0, h - 1)
                    xs = np.clip(np.arange(16) + x0 + dx, 0, w - 1)
                    sad = int(np.abs(src - ref[np.ix_(ys, xs)]).sum()) + 4 * (abs(dx) + abs(dy))
                    if inter is None or sad < inter[0]:
                        inter = (sad, (4 * dx, 4 * dy))
        if inter is not None and inter[0] <= best[0] + 256:
            return self.code_inter(state, mx, my, inter[1])
        return self.code_intra(state, mx, my, best[2], left, top, top_left, src)

    def chroma(self, state, mx, my, preds, intra: bool, mb: dict) -> int:
        """Code both chroma blocks against ``preds``; returns cbp's chroma
        part and writes the reconstruction."""
        qp = self.qp
        cbp_c = 0
        mb["cdc"], mb["cac"] = [], []
        recs = []
        for c in range(2):
            qc = CHROMA_QP[max(0, min(51, qp + state.pps.cb_offset))]
            src = self.src[1 + c][my * 8:my * 8 + 8, mx * 8:mx * 8 + 8].astype(np.int64)
            res = src - preds[c]
            ws = [forward4(res[(n >> 1) * 4:(n >> 1) * 4 + 4, (n & 1) * 4:(n & 1) * 4 + 4])
                  for n in range(4)]
            dcs = np.array([[ws[0][0, 0], ws[1][0, 0]], [ws[2][0, 0], ws[3][0, 0]]], np.int64)
            f = np.array([[1, 1], [1, -1]]) @ dcs @ np.array([[1, 1], [1, -1]])
            qbits = 16 + qc // 6
            mf = QUANT[qc % 6][0]
            dc_levels = [int(np.sign(v) * min(2000, (abs(int(v)) * mf + ((1 << qbits) // 3))
                                              >> qbits)) for v in f.reshape(-1)]
            acs = [[0] + quantise(w, qc, intra, skip_dc=True)[1:] for w in ws]
            if any(dc_levels):
                cbp_c = max(cbp_c, 1)
            if any(any(a) for a in acs):
                cbp_c = 2
            mb["cdc"].append(dc_levels)
            mb["cac"].append(acs)
        for c in range(2):
            qc = CHROMA_QP[max(0, min(51, qp + state.pps.cb_offset))]
            d = mb["cdc"][c] if cbp_c else [0] * 4
            ff = [d[0] + d[1] + d[2] + d[3], d[0] - d[1] + d[2] - d[3],
                  d[0] + d[1] - d[2] - d[3], d[0] - d[1] - d[2] + d[3]]
            scale = DEQUANT[qc % 6][0] * 16
            rec = preds[c].copy()
            for n in range(4):
                dc = (ff[n] * scale * (1 << (qc // 6))) >> 5
                ac = mb["cac"][c][n] if cbp_c == 2 else [0] * 16
                r = dequant_idct(ac, qc, dc)
                sl = (slice((n >> 1) * 4, (n >> 1) * 4 + 4), slice((n & 1) * 4, (n & 1) * 4 + 4))
                rec[sl] = np.clip(rec[sl] + r, 0, 255)
            recs.append(rec)
        for c in range(2):
            state.recon[1 + c][my * 8:my * 8 + 8, mx * 8:mx * 8 + 8] = recs[c]
        return cbp_c

    def code_inter(self, state, mx, my, mv) -> dict:
        qp = self.qp
        preds = self.inter_pred(state, mx, my, mv)
        src = self.src[0][my * 16:my * 16 + 16, mx * 16:mx * 16 + 16].astype(np.int64)
        res = src - preds[0]
        luma, cbp = [], 0
        rec = preds[0].copy()
        for n, (bx, by) in enumerate(BLOCKS):
            levels = quantise(forward4(res[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4]), qp, False)
            luma.append(levels)
            if any(levels):
                cbp |= 1 << (n >> 2)
        for n, (bx, by) in enumerate(BLOCKS):
            if cbp & (1 << (n >> 2)):
                rec[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = np.clip(
                    rec[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] + dequant_idct(luma[n], qp), 0, 255)
        mb = {"kind": INTER, "type": 0, "parts": [(0, 0, 4, 4, 0, 0, mv)], "luma": luma,
              "qp_delta": 0}
        cbp |= self.chroma(state, mx, my, preds[1:], False, mb) << 4
        if cbp == 0 and tuple(mv) == tuple(state.skip_mv(mx, my)):
            state.recon[0][my * 16:my * 16 + 16, mx * 16:mx * 16 + 16] = rec
            return {"kind": SKIP}
        mb["cbp"] = cbp
        state.recon[0][my * 16:my * 16 + 16, mx * 16:mx * 16 + 16] = rec
        return mb

    def chroma_dc_pred(self, state, mx, my, c):
        left = state.intra_available(mx, my, -1, 0)
        top = state.intra_available(mx, my, 0, -1)
        rec = state.recon[1 + c]
        x0, y0 = mx * 8, my * 8
        out = np.zeros((8, 8), np.int64)
        for by in range(2):
            for bx in range(2):
                st = int(rec[y0 - 1, x0 + bx * 4:x0 + bx * 4 + 4].sum()) if top else 0
                sl = int(rec[y0 + by * 4:y0 + by * 4 + 4, x0 - 1].sum()) if left else 0
                if bx == by:
                    v = ((st + sl + 4) >> 3 if top and left else (sl + 2) >> 2 if left else
                         (st + 2) >> 2 if top else 128)
                elif bx == 1:
                    v = (st + 2) >> 2 if top else (sl + 2) >> 2 if left else 128
                else:
                    v = (sl + 2) >> 2 if left else (st + 2) >> 2 if top else 128
                out[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = v
        return out

    def code_intra(self, state, mx, my, mode16, left, top, top_left, src) -> dict:
        qp = self.qp
        rec = state.recon[0]
        x0, y0 = mx * 16, my * 16
        # intra 16x16
        pred = intra16_pred(rec, x0, y0, mode16, left, top)
        res = src - pred
        ws = [forward4(res[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4]) for bx, by in BLOCKS]
        dcs = np.zeros((4, 4), np.int64)
        for n, (bx, by) in enumerate(BLOCKS):
            dcs[by, bx] = ws[n][0, 0]
        f = hadamard(dcs) // 2
        qbits = 16 + qp // 6
        dc_levels = [0] * 16
        for i, pos in enumerate(ZIGZAG):
            v = int(f[pos >> 2, pos & 3])
            dc_levels[i] = int(np.sign(v)) * min(2000, (abs(v) * QUANT[qp % 6][0]
                                                        + ((1 << qbits) // 3)) >> qbits)
        acs = [[0] + quantise(w, qp, True, skip_dc=True)[1:] for w in ws]
        c = np.zeros((4, 4), np.int64)
        for i, pos in enumerate(ZIGZAG):
            c[pos >> 2, pos & 3] = dc_levels[i]
        ff = hadamard(c)
        scale = DEQUANT[qp % 6][0] * 16
        q6 = qp // 6
        rec16 = pred.copy()
        ac_any = any(any(a) for a in acs)
        for n, (bx, by) in enumerate(BLOCKS):
            v = int(ff[by, bx])
            dc = v * scale * (1 << (q6 - 6)) if qp >= 36 else (v * scale + (1 << (5 - q6))) >> (6 - q6)
            r = dequant_idct(acs[n] if ac_any else [0] * 16, qp, dc)
            rec16[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = np.clip(
                rec16[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] + r, 0, 255)
        sad16 = int(np.abs(src - rec16).sum())
        # intra 4x4, block by block on its own reconstruction
        saved = rec[y0:y0 + 16, x0:x0 + 16].copy()
        saved_modes = state.modes.copy()
        modes, luma4, cbp4 = [], [], 0
        for n, (bx, by) in enumerate(BLOCKS):
            lft, tp, tl_ok, tr = state.i4_available(mx, my, bx, by)
            px, py = x0 + bx * 4, y0 + by * 4
            t = [int(v) for v in rec[py - 1, px:px + 4]] if tp else [128] * 4
            t += ([int(v) for v in rec[py - 1, px + 4:px + 8]] if tp and tr else [t[3]] * 4)
            lcol = [int(v) for v in rec[py:py + 4, px - 1]] if lft else [128] * 4
            tl = int(rec[py - 1, px - 1]) if tl_ok else 128
            ok = [2] + ([0, 3, 7] if tp else []) + ([1, 8] if lft else []) + (
                [4, 5, 6] if tp and lft and tl_ok else [])
            blk = src[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4]
            best = None
            for m in ok:
                if m == 2:
                    s = (sum(t[:4]) if tp else 0) + (sum(lcol) if lft else 0)
                    k = (4 if tp else 0) + (4 if lft else 0)
                    p = np.full((4, 4), 128 if not k else (s + k // 2) // k, np.int64)
                else:
                    p = intra4_pred(t, lcol, tl, m)
                sad = int(np.abs(blk - p).sum())
                if best is None or sad < best[0]:
                    best = (sad, m, p)
            _, m, p = best
            levels = quantise(forward4(blk - p), qp, True)
            modes.append(m)
            state.modes[my * 4 + by, mx * 4 + bx] = m
            luma4.append(levels)
            if any(levels):
                cbp4 |= 1 << (n >> 2)
            r = dequant_idct(levels, qp) if any(levels) else 0
            rec[py:py + 4, px:px + 4] = np.clip(p + r, 0, 255)
        sad4 = int(np.abs(src - rec[y0:y0 + 16, x0:x0 + 16]).sum()) + 16
        if sad16 <= sad4:
            rec[y0:y0 + 16, x0:x0 + 16] = rec16
            state.modes[:] = saved_modes
            mb = {"kind": I16, "mode": mode16, "dc": dc_levels,
                  "luma": [[0] + a[1:] for a in acs], "qp_delta": 0, "chroma_mode": 0}
            cbp = 15 if ac_any else 0
        else:
            # the 4x4 path's luma went wrong only if its blocks' cbp drops a
            # block whose levels were used: recompute with the coded cbp
            rec[y0:y0 + 16, x0:x0 + 16] = saved
            state.modes[:] = saved_modes
            mb = {"kind": I4, "modes": modes, "luma": luma4, "qp_delta": 0, "chroma_mode": 0}
            cbp = cbp4
            self.redo4(state, mx, my, modes, luma4, cbp4)
        preds = [self.chroma_dc_pred(state, mx, my, c) for c in range(2)]
        cbp |= self.chroma(state, mx, my, preds, True, mb) << 4
        mb["cbp"] = cbp
        return mb

    def redo4(self, state, mx, my, modes, luma4, cbp4):
        """The intra 4x4 reconstruction as the decoder makes it (a block whose
        8x8 has no coded block keeps its prediction)."""
        qp = self.qp
        rec = state.recon[0]
        x0, y0 = mx * 16, my * 16
        for n, (bx, by) in enumerate(BLOCKS):
            lft, tp, tl_ok, tr = state.i4_available(mx, my, bx, by)
            px, py = x0 + bx * 4, y0 + by * 4
            t = [int(v) for v in rec[py - 1, px:px + 4]] if tp else [128] * 4
            t += ([int(v) for v in rec[py - 1, px + 4:px + 8]] if tp and tr else [t[3]] * 4)
            lcol = [int(v) for v in rec[py:py + 4, px - 1]] if lft else [128] * 4
            tl = int(rec[py - 1, px - 1]) if tl_ok else 128
            m = modes[n]
            if m == 2:
                s = (sum(t[:4]) if tp else 0) + (sum(lcol) if lft else 0)
                k = (4 if tp else 0) + (4 if lft else 0)
                p = np.full((4, 4), 128 if not k else (s + k // 2) // k, np.int64)
            else:
                p = intra4_pred(t, lcol, tl, m)
            r = dequant_idct(luma4[n], qp) if cbp4 & (1 << (n >> 2)) else 0
            rec[py:py + 4, px:px + 4] = np.clip(p + r, 0, 255)
