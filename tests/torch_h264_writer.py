"""The tests' own H.264 bitstream writer (Python and numpy; Annex B or
length-prefixed NAL units out).  Nothing in the port imports it.

The wheel's libavcodec has an H.264 decoder and no H.264 encoder, so the
tests write their streams here and hold the port's decoder to OpenCV's
FFmpeg on them.  The writer covers what the port decodes: I, P and B slices
in CAVLC or CABAC (the arithmetic encoder of 9.3.4 with its terminate and
flush procedures, every binarisation and context selection), progressive
8-bit 4:2:0, the 4x4 and 8x8 transforms with intra 8x8 prediction, SPS / PPS
scaling lists (the default-list escape and absent lists included), spatial
and temporal direct prediction (derived as the decoder derives it, for the
vector predictors after it), explicit and implicit weighted prediction,
every slice, reference and NAL feature of the decoder, plus the fields of
what it refuses (interlace, 10-bit, ...) so that a test can write a refused
stream.  The CABAC tables (the contexts' (m, n) pairs, rangeTabLPS,
transIdxLPS and the 8x8 blocks' context increments) are read from the
decoder's source: a wrong entry shows against OpenCV.

``Writer(width, height, seed, **options)`` keeps the sequence's state (the
decoded picture buffer as the standard marks it, frame_num, picture order
counts) and writes one access unit a call:

* ``random_picture(...)``: seeded, legal decisions for every syntax element
  the decoder reads: macroblock types and sub-types, intra modes whose
  samples are available, vectors (some off the picture), reference indices,
  skip runs, QP deltas across 0-51, coefficients that reach the level
  escapes; slices, deblocking parameters, reference list modification and
  memory management operations as asked.
* ``encode_picture(rgb, ...)``: a plain encoder: intra 16x16, 4x4 or (with
  the PPS's 8x8 transform) 8x8 chosen by SAD, P_L0_16x16 from a small
  full-sample search, P_Skip, in B pictures B_Skip / B_Direct_16x16 (where
  the direct vectors are whole samples) and B_L0 / L1 / Bi_16x16, a
  quantised residual (8x8 transform for inter macroblocks when the PPS
  allows it; the active scaling lists), its references the planes the
  port's decoder gives back.

The macroblock layer mirrors the decoder's neighbour rules (availability
across slices, nC, the predicted intra mode, the vector predictors): a
mismatch makes FFmpeg and the port disagree, which the tests then see.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import re
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


ZIGZAG8 = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34,
           27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37,
           44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]
DEQUANT8 = [[20, 18, 32, 19, 25, 24], [22, 19, 35, 21, 28, 26], [26, 23, 42, 24, 33, 31],
            [28, 25, 45, 26, 35, 33], [32, 28, 51, 30, 40, 38], [36, 32, 58, 34, 46, 43]]
# the default scaling lists (Tables 7-3, 7-4) in scan order
DEFAULT4 = [[6, 13, 13, 20, 20, 20, 28, 28, 28, 28, 32, 32, 32, 37, 37, 42],
            [10, 14, 14, 20, 20, 20, 24, 24, 24, 24, 27, 27, 27, 30, 30, 34]]
DEFAULT8 = [[6, 10, 10, 13, 11, 13, 16, 16, 16, 16, 18, 18, 18, 18, 18, 23, 23, 23, 23, 23, 23,
             25, 25, 25, 25, 25, 25, 25, 27, 27, 27, 27, 27, 27, 27, 27, 29, 29, 29, 29, 29, 29,
             29, 31, 31, 31, 31, 31, 31, 33, 33, 33, 33, 33, 36, 36, 36, 36, 38, 38, 38, 40, 40,
             42],
            [9, 13, 13, 15, 13, 15, 17, 17, 17, 17, 19, 19, 19, 19, 19, 21, 21, 21, 21, 21, 21,
             22, 22, 22, 22, 22, 22, 22, 24, 24, 24, 24, 24, 24, 24, 24, 25, 25, 25, 25, 25, 25,
             25, 27, 27, 27, 27, 27, 27, 28, 28, 28, 28, 28, 30, 30, 30, 30, 32, 32, 32, 33, 33,
             35]]


def _decoder_table(name: str) -> List[int]:
    """The integers of the decoder's table ``name`` (``native/h264.cpp``)."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "viddet_tpu_torch", "native", "h264.cpp")
    with open(path) as f:
        src = f.read()
    body = re.search(name + r"\[[^=]*=\s*\{(.*?)\};", src, re.S).group(1)
    return [int(v) for v in re.findall(r"-?\d+", re.sub(r"//[^\n]*", "", body))]


CABAC_INIT = np.array(_decoder_table("kCabacInit"), np.int64).reshape(4, 460, 2)
RANGE_LPS = np.array(_decoder_table("kRangeLps"), np.int64).reshape(64, 4).tolist()
TRANS_LPS = _decoder_table("kTransLps")
SIG8X8 = _decoder_table("kSig8x8")
LAST8X8 = _decoder_table("kLast8x8")
CBF_CAT, SIG_CAT, ABS_CAT = [0, 4, 8, 12, 16, 0], [0, 15, 29, 44, 47, 0], [0, 10, 20, 30, 39, 0]
# the contexts (ctxIdx) frame-coded I / P / B 4:2:0 reaches: mb_type I, P and B, mb_skip_flag
# of P and B, sub_mb_type of P and B, mvd, ref_idx, mb_qp_delta, the intra modes,
# coded_block_pattern, coded_block_flag, the significance maps and levels of ctxBlockCat 0-4,
# transform_size_8x8_flag, ctxBlockCat 5
REACHABLE_CONTEXTS = (list(range(3, 70)) + list(range(73, 276)) + list(range(399, 436)))


# Table 7-14's B mb_types 1-21: (shape 0 16x16, 1 16x8, 2 8x16; the first and
# second partition's lists, bit 0 list 0, bit 1 list 1)
B_TYPES = [None, (0, 1, 0), (0, 2, 0), (0, 3, 0), (1, 1, 1), (2, 1, 1), (1, 2, 2), (2, 2, 2),
           (1, 1, 2), (2, 1, 2), (1, 2, 1), (2, 2, 1), (1, 1, 3), (2, 1, 3), (1, 2, 3), (2, 2, 3),
           (1, 3, 1), (2, 3, 1), (1, 3, 2), (2, 3, 2), (1, 3, 3), (2, 3, 3)]
# Table 7-18's B sub_mb_types: (lists, 0 8x8 / 1 8x4 / 2 4x8 / 3 4x4); 0 is B_Direct_8x8
B_SUBS = [(0, 0), (1, 0), (2, 0), (3, 0), (1, 1), (1, 2), (2, 1), (2, 2), (3, 1), (3, 2), (1, 3),
          (2, 3), (3, 3)]
SUB_PARTS = {t: (1, 2, 2, 4)[B_SUBS[t][1]] for t in range(1, 13)}


def random_weights(rng, counts: Sequence[int], denoms: Optional[Tuple[int, int]] = None) -> dict:
    """A pred_weight_table for lists of ``counts`` entries: denominators
    0-6 (or ``denoms``), some entries left at their defaults, weights within
    [-64, 64] and offsets across [-128, 127], so that any two weights add up
    to what a B slice allows (at a denominator of 7, at most 127: every
    entry is sent, its weight at most 63)."""
    ld, cd = denoms or (int(rng.integers(0, 7)), int(rng.integers(0, 7)))

    def entry(denom, sent=False):
        if denom == 7:
            return (int(rng.integers(-64, 64)), int(rng.integers(-128, 128)))
        if not sent and rng.random() < 0.25:
            return None
        w = (int(rng.integers(-64, 65)) if rng.random() < 0.25 else
             max(-64, min(64, (1 << denom) + int(rng.integers(-(1 << denom) // 2 - 1,
                                                                (1 << denom) // 2 + 2)))))
        o = int(rng.integers(-128, 128)) if rng.random() < 0.25 else int(rng.integers(-12, 13))
        return (w, o)
    lists = []
    for n in counts:
        rows = []
        for _ in range(n):
            chroma = (None if cd < 7 and rng.random() < 0.3 else
                      (entry(cd, True), entry(cd, True)))
            rows.append((entry(ld), chroma))
        lists.append(rows)
    return {"luma_denom": ld, "chroma_denom": cd, "lists": lists}


def implicit_weight(state, r0: int, r1: int) -> int:
    """8.4.2.3.1's w0 of list 0 entry ``r0`` with list 1 entry ``r1``."""
    a, b = state.lists[0][r0], state.lists[1][r1]
    if a.long_idx >= 0 or b.long_idx >= 0:
        return 32
    td = max(-128, min(127, b.poc - a.poc))
    if not td:
        return 32
    tb = max(-128, min(127, state.poc - a.poc))
    tx = int((16384 + abs(td) // 2) / td)
    scale = (tb * tx + 32) >> 8
    return 64 - scale if -64 <= scale <= 128 else 32


def plain_weights(lists: int) -> dict:
    """The plain encoder's pred_weight_table (one entry a list): list 0
    slightly brighter, list 1 slightly darker, chroma weighted too."""
    rows = [[((33, 2), ((31, -1), (33, 1)))], [((31, -2), ((33, 1), (31, -1)))]]
    return {"luma_denom": 5, "chroma_denom": 5, "lists": rows[:lists]}


def write_weights(b: Bits, w: dict) -> None:
    """pred_weight_table() (7.3.3.2) of ``random_weights``' form."""
    b.ue(w["luma_denom"]).ue(w["chroma_denom"])
    for rows in w["lists"]:
        for luma, chroma in rows:
            b.u(1, luma is not None)
            if luma is not None:
                b.se(luma[0]).se(luma[1])
            b.u(1, chroma is not None)
            if chroma is not None:
                for cw, co in chroma:
                    b.se(cw).se(co)


def wrap16(v: int) -> int:
    """``v`` as an int16 holds it (FFmpeg's motion vectors)."""
    return ((v + 32768) & 0xFFFF) - 32768


def pos_class8(pos: int) -> int:
    x, y = pos & 7, pos >> 3
    if x % 4 == 0 and y % 4 == 0:
        return 0
    if x % 2 == 1 and y % 2 == 1:
        return 1
    if x % 4 == 2 and y % 4 == 2:
        return 2
    if (x % 4 == 0 and y % 2 == 1) or (x % 2 == 1 and y % 4 == 0):
        return 3
    if (x % 4 == 0 and y % 4 == 2) or (x % 4 == 2 and y % 4 == 0):
        return 4
    return 5


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


def scaling_list(b: Bits, entry, n: int) -> None:
    """scaling_list() of ``entry``: "default" (the useDefaultScalingMatrixFlag
    escape) or ``n`` values 1-255 in scan order, a repeated tail sent as the
    nextScale 0 escape."""
    if entry == "default":
        b.se(-8)
        return
    vals = [int(v) for v in entry]
    assert len(vals) == n and all(1 <= v <= 255 for v in vals), vals
    k = n
    while k > 1 and vals[k - 1] == vals[k - 2]:
        k -= 1
    last = 8
    for v in vals[:k]:
        b.se((v - last + 128) % 256 - 128)
        last = v
    if k < n:
        b.se((0 - last + 128) % 256 - 128)


def resolve_scaling(sps: "Sps", pps: "Pps"):
    """The active scaling lists, raster order, as the decoder derives them:
    ((6, 16) 4x4: Intra Y, Cb, Cr, Inter Y, Cb, Cr; (2, 64) 8x8: Intra Y,
    Inter Y), fall-back rule A without SPS lists, B with."""
    def raster(entry, n, default):
        scan = ZIGZAG if n == 16 else ZIGZAG8
        vals = default if entry == "default" else entry
        out = [0] * n
        for j, v in enumerate(vals):
            out[scan[j]] = int(v)
        return out

    flat = lambda n: [16] * n  # noqa: E731
    s4, s8 = [flat(16) for _ in range(6)], [flat(64) for _ in range(2)]
    high = sps.profile in HIGH_PROFILES
    if high and sps.scaling:
        lists = sps.lists or [None] * 8
        for i in range(8):
            n, default = (16, DEFAULT4[i // 3]) if i < 6 else (64, DEFAULT8[i - 6])
            e = lists[i]
            if e is not None:
                val = raster(e, n, default)
            elif i % 3 == 0 or i >= 6:
                val = raster(default, n, default)
            else:
                val = list(s4[i - 1])
            (s4 if i < 6 else s8)[i if i < 6 else i - 6] = val
    p4, p8 = [list(v) for v in s4], [list(v) for v in s8]
    if pps.scaling:
        lists = pps.lists or [None] * 8
        for i in range(6 + 2 * pps.transform_8x8):
            n, default = (16, DEFAULT4[i // 3]) if i < 6 else (64, DEFAULT8[i - 6])
            e = lists[i] if i < len(lists) else None
            if e is not None:
                val = raster(e, n, default)
            elif i % 3 and i < 6:
                val = list(p4[i - 1])
            elif high and sps.scaling:
                val = list(s4[i] if i < 6 else s8[i - 6])
            else:
                val = raster(default, n, default)
            (p4 if i < 6 else p8)[i if i < 6 else i - 6] = val
    return p4, p8


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
    # seq_scaling_matrix_present_flag, and its 8 lists (None: absent,
    # "default", or values in scan order); no lists: all 8 absent
    scaling: int = 0
    lists: Optional[list] = None
    direct_8x8_inference: int = 1
    # the fields of what the decoder refuses
    chroma_format: int = 1
    bit_depth: int = 8
    bypass: int = 0
    frame_mbs_only: int = 1

    def rbsp(self) -> bytes:
        b = Bits().u(8, self.profile).u(8, 0).u(8, self.level).ue(self.id)
        if self.profile in HIGH_PROFILES:
            b.ue(self.chroma_format)
            if self.chroma_format == 3:
                b.u(1, 0)
            b.ue(self.bit_depth - 8).ue(self.bit_depth - 8).u(1, self.bypass).u(1, self.scaling)
            if self.scaling:
                for i in range(8):
                    entry = self.lists[i] if self.lists else None
                    b.u(1, entry is not None)
                    if entry is not None:
                        scaling_list(b, entry, 16 if i < 6 else 64)
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
        b.u(1, self.direct_8x8_inference)
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
    num_ref_idx_l1_default: int = 1
    weighted_pred: int = 0
    weighted_bipred: int = 0  # weighted_bipred_idc: 0 default, 1 explicit, 2 implicit
    init_qp: int = 26
    cb_offset: int = 0
    cr_offset: Optional[int] = None  # a second offset (the High profiles' PPS tail) when set
    deblocking_control: int = 1
    constrained_intra: int = 0
    bottom_field_pic_order: int = 0
    cabac: int = 0
    transform_8x8: int = 0
    # pic_scaling_matrix_present_flag and its lists (as the SPS's; 6, or 8
    # with the 8x8 transform)
    scaling: int = 0
    lists: Optional[list] = None
    # the fields of what the decoder refuses
    slice_groups: int = 1
    redundant: int = 0

    def rbsp(self) -> bytes:
        b = Bits().ue(self.id).ue(self.sps_id).u(1, self.cabac).u(1, self.bottom_field_pic_order)
        b.ue(self.slice_groups - 1)
        if self.slice_groups > 1:
            b.ue(0)  # slice_group_map_type 0 (interleaved)
            for _ in range(self.slice_groups):
                b.ue(0)
        b.ue(self.num_ref_idx_default - 1).ue(self.num_ref_idx_l1_default - 1)
        b.u(1, self.weighted_pred).u(2, self.weighted_bipred)
        b.se(self.init_qp - 26).se(0).se(self.cb_offset)
        b.u(1, self.deblocking_control).u(1, self.constrained_intra).u(1, self.redundant)
        if self.cr_offset is not None or self.transform_8x8 or self.scaling:
            b.u(1, self.transform_8x8).u(1, self.scaling)
            if self.scaling:
                for i in range(6 + 2 * self.transform_8x8):
                    entry = self.lists[i] if self.lists and i < len(self.lists) else None
                    b.u(1, entry is not None)
                    if entry is not None:
                        scaling_list(b, entry, 16 if i < 6 else 64)
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


def high10_track(width: int = 64, height: int = 48) -> Tuple[bytes, List[bytes]]:
    """An H.264 track the port refuses: an avcC whose SPS is High 10
    (bit_depth_luma_minus8 2), and three placeholder samples (the refusal
    comes before any is read)."""
    sps = Sps(profile=110, bit_depth=10, mb_w=(width + 15) // 16, mb_h=(height + 15) // 16)
    return avcc([sps.nal()], [Pps().nal()]), [b"\0\0\0\x05\x65\x88\x80\x10\x00"] * 3


# ------------------------------------------------------------------ CABAC


class CabacEncoder:
    """The arithmetic encoding engine (9.3.4.2) writing into ``bits``, its
    context variables initialised from ``qp`` and ``idc`` (-1: the I
    table; 0-2: cabac_init_idc)."""

    def __init__(self, bits: Bits, qp: int, idc: int):
        self.b = bits
        q = max(0, min(51, qp))
        pre = np.clip(((CABAC_INIT[idc + 1, :, 0] * q) >> 4) + CABAC_INIT[idc + 1, :, 1], 1, 126)
        self.state = np.where(pre <= 63, (63 - pre) << 1, ((pre - 64) << 1) | 1).tolist()
        self.restart()

    def restart(self) -> None:
        self.low, self.range, self.outstanding, self.first = 0, 510, 0, True

    def put(self, bit: int) -> None:
        if self.first:
            self.first = False
        else:
            self.b.u(1, bit)
        if self.outstanding:
            self.b.u(self.outstanding, (1 << self.outstanding) - 1 if not bit else 0)
            self.outstanding = 0

    def renorm(self) -> None:
        while self.range < 256:
            if self.low < 256:
                self.put(0)
            elif self.low >= 512:
                self.low -= 512
                self.put(1)
            else:
                self.low -= 256
                self.outstanding += 1
            self.range <<= 1
            self.low <<= 1

    def decision(self, ctx: int, bin_: int) -> None:
        s = self.state[ctx]
        st, mps = s >> 1, s & 1
        lps = RANGE_LPS[st][(self.range >> 6) & 3]
        self.range -= lps
        if bin_ != mps:
            self.low += self.range
            self.range = lps
            if st == 0:
                mps = 1 - mps
            st = TRANS_LPS[st]
        else:
            st = min(st + 1, 62)
        self.state[ctx] = st << 1 | mps
        if self.range < 256:
            self.renorm()

    def bypass(self, bin_: int) -> None:
        self.low <<= 1
        if bin_:
            self.low += self.range
        if self.low >= 1024:
            self.put(1)
            self.low -= 1024
        elif self.low < 512:
            self.put(0)
        else:
            self.low -= 512
            self.outstanding += 1

    def bypass_eg(self, value: int, k: int) -> None:
        """The k-th order Exp-Golomb suffix of UEGk in bypass bins."""
        while value >= (1 << k):
            self.bypass(1)
            value -= 1 << k
            k += 1
        self.bypass(0)
        while k:
            k -= 1
            self.bypass((value >> k) & 1)

    def terminate(self, bin_: int) -> None:
        self.range -= 2
        if bin_:
            self.low += self.range
            self.range = 2  # EncodeFlush: its last bit is the rbsp_stop_one_bit
            self.renorm()
            self.put((self.low >> 9) & 1)
            self.b.u(2, ((self.low >> 7) & 3) | 1)
        else:
            self.renorm()


# ------------------------------------------------------------ the writer

I4, I8, I16, PCM, INTER, SKIP = "I4", "I8", "I16", "PCM", "P", "SKIP"
# shapes of a macroblock's motion (the decoder's Shape): what a B picture's
# direct prediction reads of its co-located macroblock
S16X16, S16X8, S8X16, S8X8 = 0, 1, 2, 3


@dataclasses.dataclass
class Ref:
    """A reference frame as the writer tracks it: its order count, its
    planes for the plain encoder, and the motion a B picture's direct
    prediction reads when it is the co-located picture (per list the 4x4
    blocks' vectors and reference indices, per macroblock intra and shape,
    the frame_num of each entry of its last slice's lists)."""
    frame_num: int
    long_idx: int = -1  # -1: short-term
    key: int = 0  # identity
    planes: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
    poc: Optional[int] = None
    motion: Optional[dict] = None


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
        # the decoder's order count state (8.2.1): the last reference
        # picture's msb and lsb, the last picture's FrameNumOffset and frame_num
        self.prev_msb = self.prev_lsb = self.prev_offset = self.prev_frame_num = 0

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

    def order_count(self, sps: Sps, poc: dict, frame_num: int, ref_idc: int, idr: bool,
                    mmco5: bool) -> Optional[int]:
        """The picture's order count as the decoder derives it (types 0 and
        2; None for type 1), and the state moved on."""
        if idr:
            self.prev_msb = self.prev_lsb = self.prev_offset = self.prev_frame_num = 0
        offset = self.prev_offset + (sps.max_frame_num if frame_num < self.prev_frame_num else 0)
        value, msb = None, self.prev_msb
        if sps.poc_type == 0:
            lsb, top = poc["lsb"], 1 << sps.log2_max_poc_lsb
            if lsb < self.prev_lsb and self.prev_lsb - lsb >= top // 2:
                msb = self.prev_msb + top
            elif lsb > self.prev_lsb and lsb - self.prev_lsb > top // 2:
                msb = self.prev_msb - top
            value = msb + lsb
        elif sps.poc_type == 2:
            value = 2 * (offset + frame_num) - (0 if ref_idc else 1)
        if ref_idc:
            self.prev_msb, self.prev_lsb = msb, poc.get("lsb", 0)
        self.prev_offset, self.prev_frame_num = offset, 0 if mmco5 else frame_num
        return value

    def b_lists(self, poc: int) -> Tuple[List[Ref], List[Ref]]:
        """A B slice's initial lists: short-term pictures by order count
        (list 0 those at most ``poc`` nearest first, then those after; list 1
        the other way round), long-term ones after; list 1's first two
        swapped when the lists are equal."""
        shorts = [r for r in self.refs if r.long_idx < 0]
        longs = sorted((r for r in self.refs if r.long_idx >= 0), key=lambda r: r.long_idx)
        before = sorted((r for r in shorts if r.poc <= poc), key=lambda r: -r.poc)
        after = sorted((r for r in shorts if r.poc > poc), key=lambda r: r.poc)
        l0, l1 = before + after + longs, after + before + longs
        if len(l1) > 1 and all(a is b for a, b in zip(l0, l1)):
            l1[0], l1[1] = l1[1], l1[0]
        return l0, l1

    def slice_header(self, b: Bits, *, idr: bool, ref_idc: int, first_mb: int, slice_type: int,
                     pps: Pps, sps: Sps, frame_num: int, idr_pic_id: int, poc: dict,
                     num_ref_idx, mods, marking: dict, qp: int, deblock: Tuple[int, int, int],
                     cabac_init_idc: int = 0, direct_spatial: int = 1,
                     weights: Optional[dict] = None) -> None:
        """``num_ref_idx``: None (the PPS's), an int (list 0), or a pair (B);
        ``mods``: list 0's modifications, or a pair of lists (B)."""
        kind = slice_type % 5
        if kind == 1:
            mods = list(mods) if mods else [[], []]
            counts = num_ref_idx
        else:
            mods, counts = [mods], (num_ref_idx,)
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
        if kind == 1:
            b.u(1, direct_spatial)
        if kind in (0, 1, 3):
            b.u(1, counts is not None and counts[0] is not None)
            if counts is not None and counts[0] is not None:
                for n in counts:
                    b.ue(n - 1)
            for lm in mods:
                b.u(1, bool(lm))
                for idc, v in lm:
                    b.ue(idc).ue(v)
                if lm:
                    b.ue(3)
        if weights is not None:
            write_weights(b, weights)
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
        if pps.cabac and slice_type % 5 != 2:
            b.ue(cabac_init_idc)
        b.se(qp - pps.init_qp)
        if pps.deblocking_control:
            b.ue(deblock[0])
            if deblock[0] != 1:
                b.se(deblock[1]).se(deblock[2])

    # ------------------------------------------------------- the pictures

    def _picture(self, *, kind: str, ref_idc: int, pps: Pps, slices: Sequence[int],
                 qps: Sequence[int], deblocks: Sequence[Tuple[int, int, int]],
                 num_ref_idx, order, marking: dict, mb_source, poc: Optional[dict] = None,
                 idcs: Optional[Sequence[int]] = None, direct_spatial: int = 1,
                 weights: Optional[dict] = None) -> Tuple[List[bytes], dict]:
        """One access unit of ``kind`` "IDR", "I", "P" or "B": for B,
        ``num_ref_idx`` and ``order`` are pairs (each list's)."""
        sps = self.sps_for(pps)
        idr = kind == "IDR"
        if idr:
            self.refs, self.max_long_idx = [], -1
            self.frame_num = self.poc_count = 0
        frame_num = self.frame_num
        poc = dict(poc or self.next_poc(sps))
        mmco5 = any(op[0] == 5 for op in marking.get("mmco") or ())
        value = self.order_count(sps, poc, frame_num, ref_idc, idr, mmco5)
        lists: List[List[Ref]] = [[], []]
        mods: list = [[], []]
        counts = [0, 0]
        if kind in ("P", "B"):
            assert kind == "P" or value is not None, "B pictures need order counts of type 0 or 2"
            pairs = list(num_ref_idx) if kind == "B" else [num_ref_idx]
            orders = list(order) if kind == "B" else [order]
            base = self.b_lists(value) if kind == "B" else [self.initial_list(frame_num, sps)]
            for l in range(len(base)):
                n = pairs[l] or (pps.num_ref_idx_l1_default if l else pps.num_ref_idx_default)
                counts[l] = n
                orders[l] = list(orders[l])[:n]
                if orders[l]:
                    mods[l] = self.modifications(orders[l], frame_num, sps)
                    rest = [r for r in base[l] if all(r is not o for o in orders[l])]
                    lists[l] = (list(orders[l]) + rest)[:n]
                else:
                    lists[l] = base[l][:n]
        state = PictureState(self, pps, sps, lists[0], lists[1] if kind == "B" else None)
        state.n_active = counts[0]
        state.n_active1 = counts[1]
        state.spatial = bool(direct_spatial)
        state.poc = value
        if kind == "B":
            state.prepare_direct()
        state.weights = weights
        units = []
        starts = list(slices) + [self.mb_w * self.mb_h]
        types = {"IDR": 2, "I": 2, "P": 0, "B": 1}
        for s, first in enumerate(slices):
            b = Bits()
            slice_type = types[kind] + (5 if s == 0 else 0)
            self.slice_header(b, idr=idr, ref_idc=ref_idc, first_mb=first,
                              slice_type=slice_type, pps=pps, sps=sps, frame_num=frame_num,
                              idr_pic_id=self.pictures % 65536, poc=poc,
                              num_ref_idx=(tuple(num_ref_idx) if kind == "B" and num_ref_idx[0]
                                           else num_ref_idx if kind == "P" else None),
                              mods=mods if kind == "B" else mods[0],
                              marking=marking, qp=qps[s], deblock=deblocks[s],
                              cabac_init_idc=idcs[s] if idcs else 0,
                              direct_spatial=direct_spatial, weights=weights)
            state.slice_data(b, s, first, starts[s + 1], types[kind], qps[s], mb_source,
                             idcs[s] if idcs else 0)
            # CABAC's flush writes the stop bit
            units.append(nal_unit(ref_idc, 5 if idr else 1,
                                  (b.align() if pps.cabac else b.trailing()).bytes()))
        info = {"frame_num": frame_num, "poc": poc, "state": state, "order_count": value}
        self.after_picture(sps, idr, ref_idc, marking, frame_num, state)
        return units, info

    def skip_frame_nums(self, sps: Sps, gap: int) -> None:
        """Leave ``gap`` frame_num values out: the decoder infers a frame for
        each, marked by the sliding window."""
        assert sps.gaps
        for _ in range(gap):
            self.sliding_window(sps, self.frame_num)
            self.refs.append(Ref(self.frame_num, key=self.new_key()))
            self.prev_frame_num = self.frame_num
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
        cur = Ref(frame_num, key=self.new_key(), planes=state.recon, poc=state.poc,
                  motion=state.motion())
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
                       coeff_density: float = 0.5, cabac_init_idc: Optional[int] = None,
                       transform_8x8: float = 0.5, direct_spatial: int = 1,
                       weights: Optional[dict] = None) -> Tuple[List[bytes], dict]:
        """One access unit of seeded legal syntax; ``deblock`` None, "off",
        "slices" or "offsets" sets each slice's disable_deblocking_filter_idc
        and offsets; ``modify`` reorders the list (B: each list) at random.
        With the PPS's 8x8 transform, ``transform_8x8`` is the share of I_NxN
        macroblocks that are I_8x8 and of inter macroblocks with
        transform_size_8x8_flag (where allowed); each CABAC P or B slice takes
        ``cabac_init_idc``, or one at random.  A B picture (``kind`` "B",
        order count ``poc``) takes ``num_ref_idx`` as a pair and
        ``direct_spatial``; where the PPS sends a pred_weight_table, it is
        ``weights``, or one at random (``random_weights``)."""
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
        order: list = []
        if kind == "P" and modify:
            candidates = list(self.refs)
            rng.shuffle(candidates)
            order = candidates[: int(rng.integers(1, len(candidates) + 1))]
        if kind == "B":
            order = [[], []]
            for l in range(2):
                if modify and rng.random() < 0.7:
                    candidates = list(self.refs)
                    rng.shuffle(candidates)
                    order[l] = candidates[: int(rng.integers(1, len(candidates) + 1))]
            num_ref_idx = tuple(num_ref_idx) if num_ref_idx else (None, None)
            n0, n1 = pps.num_ref_idx_default, pps.num_ref_idx_l1_default
            if not num_ref_idx[0] and max(n0, n1) > len(self.refs):
                # no more entries than references: FFmpeg fills the rest with a default
                # picture and forgets its order counts, which the decoder does not model
                num_ref_idx = (min(n0, len(self.refs)), min(n1, len(self.refs)))
        if weights is None and ((pps.weighted_pred and kind == "P") or
                                (pps.weighted_bipred == 1 and kind == "B")):
            counts = ((num_ref_idx[0] or pps.num_ref_idx_default,
                       num_ref_idx[1] or pps.num_ref_idx_l1_default) if kind == "B"
                      else (num_ref_idx or pps.num_ref_idx_default,))
            weights = random_weights(rng, counts)
        marking = {"long": int(long_term)} if kind == "IDR" else (
            {"mmco": mmco} if mmco is not None else {})
        source = RandomMbs(rng, mb_kinds=mb_kinds, pcm=pcm, sub_partitions=sub_partitions,
                           off_frame=off_frame, qp_range=qp_range, escapes=escapes,
                           density=coeff_density, high=sps.profile in HIGH_PROFILES,
                           t8=transform_8x8)
        idcs = [int(rng.integers(0, 3)) if cabac_init_idc is None else cabac_init_idc
                for _ in firsts]
        return self._picture(kind=kind, ref_idc=ref_idc, pps=pps, slices=firsts, qps=qps,
                             deblocks=deblocks, num_ref_idx=num_ref_idx, order=order,
                             marking=marking, mb_source=source, poc=poc, idcs=idcs,
                             direct_spatial=direct_spatial, weights=weights)

    # ---------------------------------------------------- plain encoding

    def encode_picture(self, rgb: np.ndarray, kind: str = "P", *, qp: int = 28, slices: int = 1,
                       search: int = 4, pps: Optional[Pps] = None, poc: Optional[dict] = None,
                       ref_idc: int = 1, direct_spatial: int = 1) -> Tuple[List[bytes], dict]:
        """One access unit coding ``rgb`` (H x W x 3 uint8, the writer's
        size); a P picture predicts from the last reference, a B picture
        (order count ``poc``) from the nearest before and after it, each
        reference's planes set by the caller with ``set_reference_planes``
        (the decoder's).  Where ``pps`` sends a pred_weight_table, it is
        ``plain_weights``'."""
        pps = pps or self.pps[0]
        y, u, v = rgb_to_yuv420(rgb, 16 * self.mb_w, 16 * self.mb_h)
        total = self.mb_w * self.mb_h
        firsts = [i * total // slices for i in range(slices)]
        source = PlainMbs((y, u, v), qp, search)
        weights = None
        if (pps.weighted_pred and kind == "P") or (pps.weighted_bipred == 1 and kind == "B"):
            weights = plain_weights(2 if kind == "B" else 1)
        return self._picture(kind=kind, ref_idc=ref_idc, pps=pps, slices=firsts,
                             qps=[qp] * slices, deblocks=[(0, 0, 0)] * slices,
                             num_ref_idx=(1, 1) if kind == "B" else 1,
                             order=([], []) if kind == "B" else (), marking={},
                             mb_source=source, poc=poc, direct_spatial=direct_spatial,
                             weights=weights)

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

    def __init__(self, writer: Writer, pps: Pps, sps: Sps, ref_list: List[Ref],
                 list1: Optional[List[Ref]] = None):
        self.w = writer
        self.pps, self.sps, self.list = pps, sps, ref_list
        self.lists = [ref_list, list1 or []]
        self.b_slice = list1 is not None
        mb_w, mb_h = writer.mb_w, writer.mb_h
        self.mb_w, self.mb_h = mb_w, mb_h
        self.kind = [None] * (mb_w * mb_h)
        self.slice = [-1] * (mb_w * mb_h)
        self.nz = np.zeros((4 * mb_h, 4 * mb_w), np.int32)
        self.nz_c = [np.zeros((2 * mb_h, 2 * mb_w), np.int32) for _ in range(2)]
        self.modes = np.full((4 * mb_h, 4 * mb_w), 2, np.int32)
        # per list and 4x4 block: reference index (-1 where the list does not
        # predict) and vector; per 4x4 block whether it is direct; per
        # macroblock B_Skip / B_Direct_16x16 and the motion's shape
        self.refs = [np.full((4 * mb_h, 4 * mb_w), -1, np.int32) for _ in range(2)]
        self.mvs = [np.zeros((4 * mb_h, 4 * mb_w, 2), np.int32) for _ in range(2)]
        self.ref, self.mv = self.refs[0], self.mvs[0]
        self.direct = np.zeros((4 * mb_h, 4 * mb_w), bool)
        self.mb_direct = [False] * (mb_w * mb_h)
        self.shape = [S16X16] * (mb_w * mb_h)
        # what CABAC's contexts read: per macroblock transform_size_8x8_flag,
        # coded_block_pattern (I_PCM 0x2F), intra_chroma_pred_mode, the DC
        # blocks' coded_block_flag; per list and 4x4 block |mvd| (capped at 64)
        self.t8 = [0] * (mb_w * mb_h)
        self.cbp = [0] * (mb_w * mb_h)
        self.cmode = [0] * (mb_w * mb_h)
        self.dcf = [0] * (mb_w * mb_h)
        self.mvds = [np.zeros((4 * mb_h, 4 * mb_w, 2), np.int32) for _ in range(2)]
        self.mvd = self.mvds[0]
        self.cab: Optional[CabacEncoder] = None
        self.last_dqp = False
        self.w4, self.w8 = resolve_scaling(sps, pps)
        self.cur_slice = 0
        self.done = [0, 0]  # per list, the current macroblock's 4x4 blocks whose motion is known
        self.recon = (np.zeros((16 * mb_h, 16 * mb_w), np.int32),
                      np.zeros((8 * mb_h, 8 * mb_w), np.int32),
                      np.zeros((8 * mb_h, 8 * mb_w), np.int32))
        self.spatial, self.poc, self.weights = True, None, None
        self.n_active = self.n_active1 = 0

    def motion(self) -> dict:
        """What a later B picture reads of this one as its co-located picture."""
        return {"mv": [m.copy() for m in self.mvs], "ref": [r.copy() for r in self.refs],
                "intra": [k in (I4, I8, I16, PCM) for k in self.kind], "shape": list(self.shape),
                "lists": [[r.frame_num for r in self.lists[0]],
                          [r.frame_num for r in self.lists[1]] if self.b_slice else []]}

    def prepare_direct(self) -> None:
        """The temporal direct prediction's DistScaleFactor by list 0 index
        and map of the co-located picture's indices to list 0."""
        col = self.lists[1][0]
        self.dist_scale, self.map_col = [], [[0] * 16, [0] * 16]
        for r in self.lists[0]:
            td = max(-128, min(127, col.poc - r.poc))
            if td == 0 or r.long_idx >= 0:
                self.dist_scale.append(256)
                continue
            tb = max(-128, min(127, self.poc - r.poc))
            tx = int((16384 + abs(td) // 2) / td)
            self.dist_scale.append(max(-1024, min(1023, (tb * tx + 32) >> 6)))
        keys = col.motion["lists"] if col.motion else [[], []]
        for l in range(2):
            for old, fn in enumerate(keys[l][:16]):
                for j, r in enumerate(self.lists[0]):
                    if r.frame_num == fn:
                        self.map_col[l][old] = j
                        break

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
        return not self.pps.constrained_intra or self.kind[a] in (I4, I8, I16, PCM)

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

    def i8_available(self, mx, my, n):
        """(left, top, top-left, top-right) of intra 8x8 block ``n``."""
        left = bool(n & 1) or self.intra_available(mx, my, -1, 0)
        top = bool(n & 2) or self.intra_available(mx, my, 0, -1)
        top_left = n == 3 or self.intra_available(mx, my, 0 if n == 1 else -1,
                                                  0 if n == 2 else -1)
        top_right = n == 2 or (n == 0 and self.intra_available(mx, my, 0, -1)) or (
            n == 1 and self.intra_available(mx, my, 1, -1))
        return left, top, top_left, top_right

    def predicted_mode(self, mx, my, bx, by) -> int:
        def mode_of(x, y):
            if x >= 0 and y >= 0:
                return self.modes[my * 4 + y, mx * 4 + x]
            a = self.mb_at(mx, my, -1 if x < 0 else 0, -1 if y < 0 else 0)
            if a < 0 or not self.available(a):
                return None
            if self.kind[a] not in (I4, I8, I16, PCM) and self.pps.constrained_intra:
                return None
            if self.kind[a] not in (I4, I8):
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

    def neighbour(self, mx, my, bx, by, l=0):
        """(available, ref, mv) of list ``l``'s 4x4 block at (bx, by)
        relative to the macroblock."""
        if 0 <= bx < 4 and 0 <= by < 4:
            if not (self.done[l] >> (by * 4 + bx)) & 1:
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
        return True, int(self.refs[l][y, x]), (int(self.mvs[l][y, x, 0]),
                                               int(self.mvs[l][y, x, 1]))

    def predict(self, mx, my, bx, by, w, ref, shape, l=0):
        ha, ra, ma = self.neighbour(mx, my, bx - 1, by, l)
        hb, rb, mb = self.neighbour(mx, my, bx, by - 1, l)
        hc, rc, mc = self.neighbour(mx, my, bx + w, by - 1, l)
        if not hc:
            hc, rc, mc = self.neighbour(mx, my, bx - 1, by - 1, l)
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

    def set_motion(self, mx, my, bx, by, w, h, ref, mv, l=0):
        self.refs[l][my * 4 + by:my * 4 + by + h, mx * 4 + bx:mx * 4 + bx + w] = ref
        self.mvs[l][my * 4 + by:my * 4 + by + h, mx * 4 + bx:mx * 4 + bx + w] = mv
        for j in range(by, by + h):
            for i in range(bx, bx + w):
                self.done[l] |= 1 << (j * 4 + i)

    def direct_motion(self, mx, my, mask, whole):
        """8.4.1.2 as the decoder derives it: the direct motion of the 8x8
        blocks ``mask`` into the grids; the macroblock's shape when
        ``whole`` (B_Skip, B_Direct_16x16)."""
        col = self.lists[1][0]
        at = my * self.mb_w + mx
        motion = col.motion
        col_intra = motion is None or motion["intra"][at]
        col_shape = S16X16 if motion is None else motion["shape"][at]
        inference = self.sps.direct_8x8_inference

        def col_block(x, y):
            if inference:
                x, y = (0 if x < 2 else 3), (0 if y < 2 else 3)
            return my * 4 + y, mx * 4 + x
        ref = [[0] * 16, [0] * 16]
        vec = [[(0, 0)] * 16, [(0, 0)] * 16]
        zero = [False] * 16
        if self.spatial:
            r, pm = [-1, -1], [(0, 0), (0, 0)]
            for l in range(2):
                _, ra, ma = self.neighbour(mx, my, -1, 0, l)
                _, rb, mb = self.neighbour(mx, my, 0, -1, l)
                hc, rc, mc = self.neighbour(mx, my, 4, -1, l)
                if not hc:
                    _, rc, mc = self.neighbour(mx, my, -1, -1, l)
                cand = [v for v in (ra, rb, rc) if v >= 0]
                if not cand:
                    continue
                r[l] = min(cand)
                match = (ra == r[l]) + (rb == r[l]) + (rc == r[l])
                if match > 1:
                    pm[l] = (sorted((ma[0], mb[0], mc[0]))[1], sorted((ma[1], mb[1], mc[1]))[1])
                else:
                    pm[l] = ma if ra == r[l] else mb if rb == r[l] else mc
            if r[0] < 0 and r[1] < 0:
                r = [0, 0]
            still = pm[0] == (0, 0) and pm[1] == (0, 0)
            col_ok = not col_intra and col.long_idx < 0
            for k in range(16):
                for l in range(2):
                    ref[l][k], vec[l][k] = r[l], pm[l]
                if not col_ok or (whole and still):
                    continue
                c = col_block(k & 3, k >> 2)
                c0, c1 = int(motion["ref"][0][c]), int(motion["ref"][1][c])
                if c0 != 0 and not (c0 < 0 and c1 == 0):
                    continue
                cm = motion["mv"][0 if c0 == 0 else 1][c]
                if abs(int(cm[0])) > 1 or abs(int(cm[1])) > 1:
                    continue
                zero[k] = True
                for l in range(2):
                    if r[l] == 0:
                        vec[l][k] = (0, 0)
            if whole and still:
                self.write_direct(mx, my, 15, ref, vec)
                self.shape[at] = S16X16
                return
        else:
            for k in range(16):
                c = col_block(k & 3, k >> 2)
                if col_intra:
                    continue
                l = 0 if motion["ref"][0][c] >= 0 else 1
                cr = max(0, min(15, int(motion["ref"][l][c])))
                cm = (int(motion["mv"][l][c][0]), int(motion["mv"][l][c][1]))
                r0 = self.map_col[l][cr]
                scale = self.dist_scale[r0]
                x, y = (scale * cm[0] + 128) >> 8, (scale * cm[1] + 128) >> 8
                ref[0][k] = r0
                vec[0][k] = (wrap16(x), wrap16(y))
                vec[1][k] = (wrap16(x - cm[0]), wrap16(y - cm[1]))
        self.write_direct(mx, my, mask, ref, vec)
        if whole:
            n = sum(zero)
            if col_intra or col_shape == S16X16 or (self.spatial and n in (0, 16)):
                self.shape[at] = S16X16
            elif col_shape in (S16X8, S8X16):
                self.shape[at] = col_shape
            else:
                self.shape[at] = S8X8

    def write_direct(self, mx, my, mask, ref, vec):
        for k in range(16):
            x, y = k & 3, k >> 2
            if not (mask >> ((y >> 1) * 2 + (x >> 1))) & 1:
                continue
            for l in range(2):
                self.refs[l][my * 4 + y, mx * 4 + x] = ref[l][k]
                self.mvs[l][my * 4 + y, mx * 4 + x] = vec[l][k]
            self.direct[my * 4 + y, mx * 4 + x] = True

    # ----------------------------------------------------------- writing

    def mb_a(self, addr: int) -> int:
        return addr - 1 if addr % self.mb_w and self.available(addr - 1) else -1

    def mb_b(self, addr: int) -> int:
        return addr - self.mb_w if addr >= self.mb_w and self.available(addr - self.mb_w) else -1

    def near(self, mx, my, x, y):
        """The grid (row, column) of the 4x4 block at (x, y) relative to the
        macroblock, or None when its macroblock is not available."""
        if x < 0 or y < 0:
            nx, ny = mx - (x < 0), my - (y < 0)
            if nx < 0 or ny < 0 or not self.available(ny * self.mb_w + nx):
                return None
        return my * 4 + y, mx * 4 + x

    def slice_data(self, b: Bits, s: int, first: int, end: int, kind: int, qp: int,
                   source, idc: int = 0) -> None:
        """Slice ``s``'s macroblocks ``first`` to ``end`` - 1 in a slice of
        ``kind`` (0 P, 1 B, 2 I)."""
        self.cur_slice = s
        self.qp = qp
        inter = kind != 2
        if self.pps.cabac:
            while b.n % 8:
                b.u(1, 1)  # cabac_alignment_one_bit
            self.cab = CabacEncoder(b, qp, idc if inter else -1)
            self.last_dqp = False
            for addr in range(first, end):
                mx, my = addr % self.mb_w, addr // self.mb_w
                self.done = [0, 0]
                mb = source.decide(self, mx, my, inter)
                skip = mb["kind"] == SKIP
                if inter:
                    a, c = self.mb_a(addr), self.mb_b(addr)
                    inc = (a >= 0 and self.kind[a] != SKIP) + (c >= 0 and self.kind[c] != SKIP)
                    self.cab.decision((24 if self.b_slice else 11) + inc, skip)
                if skip:
                    self.skip(s, addr, mx, my, source)
                    self.last_dqp = False
                else:
                    self.macroblock(b, addr, mx, my, mb, inter)
                self.cab.terminate(int(addr == end - 1))  # end_of_slice_flag
            self.cab = None
            return
        run = 0
        for addr in range(first, end):
            mx, my = addr % self.mb_w, addr // self.mb_w
            self.done = [0, 0]
            mb = source.decide(self, mx, my, inter)
            if mb["kind"] == SKIP:
                self.skip(s, addr, mx, my, source)
                run += 1
                continue
            if inter:
                b.ue(run)
                run = 0
            self.macroblock(b, addr, mx, my, mb, inter)
        if run:
            b.ue(run)

    def skip(self, s, addr, mx, my, source) -> None:
        self.slice[addr], self.kind[addr] = s, SKIP
        if self.b_slice:
            self.mb_direct[addr] = True
            self.direct_motion(mx, my, 15, True)
            source.skipped(self, mx, my, None)
            return
        mv = self.skip_mv(mx, my)
        self.set_motion(mx, my, 0, 0, 4, 4, 0, mv)
        source.skipped(self, mx, my, mv)

    # the syntax elements, in CAVLC or CABAC

    def mb_type(self, b: Bits, addr: int, inter: bool, code: int) -> None:
        """mb_type ``code`` as ue(v) numbers it (P slices: intra from 5; B
        slices: intra from 23)."""
        if not self.cab:
            b.ue(code)
            return
        cab = self.cab
        if inter and self.b_slice:
            a, c = self.mb_a(addr), self.mb_b(addr)
            inc = (a >= 0 and not self.mb_direct[a]) + (c >= 0 and not self.mb_direct[c])
            cab.decision(27 + inc, int(code != 0))
            if code == 0:
                return
            if code in (1, 2):
                cab.decision(30, 0)
                cab.decision(32, code - 1)
                return
            cab.decision(30, 1)
            if code >= 23:
                bits, extra = 13, None
            elif code == 11:
                bits, extra = 14, None
            elif code == 22:
                bits, extra = 15, None
            elif code <= 10:
                bits, extra = code - 3, None
            else:
                bits, extra = (code + 4) >> 1, (code + 4) & 1
            for i, ctx in enumerate((31, 32, 32, 32)):
                cab.decision(ctx, (bits >> (3 - i)) & 1)
            if extra is not None:
                cab.decision(32, extra)
            if code >= 23:
                self.intra_type(32, 0, code - 23)
            return
        if inter:
            if code < 5:
                cab.decision(14, 0)
                cab.decision(15, code in (1, 2))
                cab.decision(17 if code in (1, 2) else 16, code in (1, 3))
                return
            cab.decision(14, 1)
            self.intra_type(17, 0, code - 5)
            return
        a, c = self.mb_a(addr), self.mb_b(addr)
        cond = lambda n: n >= 0 and self.kind[n] not in (I4, I8)  # noqa: E731
        self.intra_type(3, cond(a) + cond(c), code)

    def intra_type(self, off: int, inc: int, t: int) -> None:
        cab, i_slice = self.cab, off == 3
        cab.decision(off + inc, t != 0)
        if t == 0:
            return
        cab.terminate(int(t == 25))
        if t == 25:
            return
        pred, chroma, luma = (t - 1) % 4, ((t - 1) // 4) % 3, (t - 1) // 12
        cab.decision(off + (3 if i_slice else 1), luma)
        cab.decision(off + (4 if i_slice else 2), chroma != 0)
        if chroma:
            cab.decision(off + (5 if i_slice else 2), chroma == 2)
        cab.decision(off + (6 if i_slice else 3), pred >> 1)
        cab.decision(off + (7 if i_slice else 3), pred & 1)

    def transform_flag(self, b: Bits, addr: int, flag: bool) -> None:
        if not self.cab:
            b.u(1, int(flag))
            return
        a, c = self.mb_a(addr), self.mb_b(addr)
        self.cab.decision(399 + (a >= 0 and self.t8[a]) + (c >= 0 and self.t8[c]), int(flag))

    def intra_mode(self, b: Bits, mode: int, pred: int) -> None:
        rem = mode if mode < pred else mode - 1
        if not self.cab:
            if mode == pred:
                b.u(1, 1)
            else:
                b.u(1, 0).u(3, rem)
            return
        self.cab.decision(68, int(mode == pred))
        if mode != pred:
            for k in range(3):
                self.cab.decision(69, (rem >> k) & 1)

    def chroma_mode(self, b: Bits, addr: int, mode: int) -> None:
        if not self.cab:
            b.ue(mode)
            return
        a, c = self.mb_a(addr), self.mb_b(addr)
        inc = (a >= 0 and self.cmode[a] != 0) + (c >= 0 and self.cmode[c] != 0)
        self.cab.decision(64 + inc, mode > 0)
        for k in range(1, min(mode, 3) + (mode < 3)):
            self.cab.decision(67, int(k < mode))

    def coded_block_pattern(self, b: Bits, addr: int, cbp: int, intra: bool) -> None:
        if not self.cab:
            b.ue((INTRA_CBP_CODE if intra else INTER_CBP_CODE)[cbp])
            return
        a, c = self.mb_a(addr), self.mb_b(addr)
        pa = self.cbp[a] if a >= 0 else -1
        pb = self.cbp[c] if c >= 0 else -1
        for b8 in range(4):
            left = (cbp >> (b8 - 1)) & 1 if b8 & 1 else 1 if pa < 0 else (pa >> (b8 + 1)) & 1
            top = (cbp >> (b8 - 2)) & 1 if b8 & 2 else 1 if pb < 0 else (pb >> (b8 + 2)) & 1
            self.cab.decision(73 + (not left) + 2 * (not top), (cbp >> b8) & 1)
        ca, cc, chroma = (pa >> 4 if pa >= 0 else 0), (pb >> 4 if pb >= 0 else 0), cbp >> 4
        self.cab.decision(77 + (ca > 0) + 2 * (cc > 0), int(chroma > 0))
        if chroma:
            self.cab.decision(81 + (ca == 2) + 2 * (cc == 2), int(chroma == 2))

    def qp_delta(self, b: Bits, delta: int) -> None:
        if not self.cab:
            b.se(delta)
        else:
            k = 2 * delta - 1 if delta > 0 else -2 * delta
            self.cab.decision(60 + self.last_dqp, int(k > 0))
            for i in range(1, k + 1):
                self.cab.decision(62 if i == 1 else 63, int(i < k))
        self.last_dqp = delta != 0

    def sub_type(self, b: Bits, t: int) -> None:
        if not self.cab:
            b.ue(t)
            return
        cab = self.cab
        if self.b_slice:
            cab.decision(36, int(t != 0))
            if t == 0:
                return
            if t in (1, 2):
                cab.decision(37, 0)
                cab.decision(39, t - 1)
                return
            cab.decision(37, 1)
            cab.decision(38, int(t >= 7))
            if t >= 7:
                cab.decision(39, int(t >= 11))
                if t >= 11:
                    cab.decision(39, t - 11)
                    return
            v = t - (7 if t >= 7 else 3)
            cab.decision(39, v >> 1)
            cab.decision(39, v & 1)
            return
        cab.decision(21, int(t == 0))
        if t:
            cab.decision(22, int(t != 1))
            if t != 1:
                cab.decision(23, int(t == 2))

    def ref_index(self, b: Bits, n_ref: int, mx, my, bx, by, ref: int, l: int = 0) -> None:
        if n_ref <= 1:
            return
        if not self.cab:
            b.te(n_ref - 1, ref)
            return

        def cond(x, y):
            k = self.near(mx, my, x, y)
            return int(k is not None and self.refs[l][k] > 0
                       and not (self.b_slice and self.direct[k]))
        self.cab.decision(54 + cond(bx - 1, by) + 2 * cond(bx, by - 1), int(ref > 0))
        for i in range(1, ref + 1):
            self.cab.decision(58 if i == 1 else 59, int(i < ref))

    def mvd_component(self, b: Bits, comp: int, mx, my, bx, by, v: int, l: int = 0) -> None:
        if not self.cab:
            b.se(v)
            return

        def near(x, y):
            k = self.near(mx, my, x, y)
            return 0 if k is None else int(self.mvds[l][k[0], k[1], comp])
        total, base, a = near(bx - 1, by) + near(bx, by - 1), 47 if comp else 40, abs(v)
        cab = self.cab
        cab.decision(base + (0 if total < 3 else 2 if total > 32 else 1), int(a > 0))
        if not a:
            return
        for k in range(1, min(a, 9)):
            cab.decision(base + (k + 2 if k < 4 else 6), 1)
        if a < 9:
            cab.decision(base + (a + 2 if a < 4 else 6), 0)
        else:
            cab.bypass_eg(a - 9, 3)
        cab.bypass(int(v < 0))

    def cbf_inc_dc(self, addr: int, bit: int, intra: bool) -> int:
        def cond(n):
            if n < 0:
                return int(intra)
            return int(self.kind[n] == PCM or (self.dcf[n] >> bit) & 1)
        return cond(self.mb_a(addr)) + 2 * cond(self.mb_b(addr))

    def cbf_inc(self, grid, per: int, mx, my, bx, by, intra: bool) -> int:
        def cond(x, y):
            n = my * self.mb_w + mx
            if x < 0 or y < 0:
                nx, ny = mx - (x < 0), my - (y < 0)
                if nx < 0 or ny < 0 or not self.available(ny * self.mb_w + nx):
                    return int(intra)
                n = ny * self.mb_w + nx
            return int(self.kind[n] == PCM or grid[my * per + y, mx * per + x] != 0)
        return cond(bx - 1, by) + 2 * cond(bx, by - 1)

    def cabac_block(self, cat: int, inc: int, coeffs: Sequence[int], max_coeff: int) -> int:
        """residual_block_cabac of ``coeffs`` (scan order) in ctxBlockCat
        ``cat``; returns how many are not 0."""
        cab = self.cab
        coeffs = [int(c) for c in coeffs[:max_coeff]]
        nonzero = [i for i, c in enumerate(coeffs) if c]
        if cat != 5:
            cab.decision(85 + CBF_CAT[cat] + inc, int(bool(nonzero)))
            if not nonzero:
                return 0
        assert nonzero, "an 8x8 block with its coded_block_pattern bit needs a coefficient"
        sig = 402 if cat == 5 else 105 + SIG_CAT[cat]
        last = 417 if cat == 5 else 166 + SIG_CAT[cat]
        level = 426 if cat == 5 else 227 + ABS_CAT[cat]
        end = nonzero[-1]
        for i in range(max_coeff - 1):
            k = SIG8X8[i] if cat == 5 else min(i, 2) if cat == 3 else i
            cab.decision(sig + k, int(coeffs[i] != 0))
            if coeffs[i]:
                k = LAST8X8[i] if cat == 5 else min(i, 2) if cat == 3 else i
                cab.decision(last + k, int(i == end))
                if i == end:
                    break
        eq1 = gt1 = 0
        for i in reversed(nonzero):
            v = abs(coeffs[i]) - 1
            cab.decision(level + (0 if gt1 else min(4, 1 + eq1)), int(v > 0))
            if v:
                ctx = level + 5 + min(4 - (cat == 3), gt1)
                for _ in range(1, min(v, 14)):
                    cab.decision(ctx, 1)
                if v < 14:
                    cab.decision(ctx, 0)
                else:
                    cab.bypass_eg(v - 14, 0)
                gt1 += 1
            else:
                eq1 += 1
            cab.bypass(int(coeffs[i] < 0))
        return len(nonzero)

    # the macroblock layer

    def t8_allowed(self, mb: dict) -> bool:
        """Whether transform_size_8x8_flag may follow an inter macroblock's
        coded_block_pattern: no sub-partition below 8x8, and direct
        prediction only with direct_8x8_inference_flag."""
        if not self.pps.transform_8x8:
            return False
        if "btype" not in mb:
            return not any(mb.get("subs", ()))
        inference = bool(self.sps.direct_8x8_inference)
        if mb["btype"] == 0:
            return inference
        if mb["btype"] == 22:
            return all(t <= 3 for t in mb["subs"]) and (inference or 0 not in mb["subs"])
        return True

    def macroblock(self, b: Bits, addr: int, mx: int, my: int, mb: dict, inter: bool):
        self.slice[addr], self.kind[addr] = self.cur_slice, mb["kind"]
        kind = mb["kind"]
        offset = (23 if self.b_slice else 5) if inter else 0
        if kind == PCM:
            self.mb_type(b, addr, inter, offset + 25)
            b.align()
            b.raw(bytes(mb["samples"]))
            if self.cab:
                self.cab.restart()
            self.nz[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 16
            for g in self.nz_c:
                g[my * 2:my * 2 + 2, mx * 2:mx * 2 + 2] = 16
            self.cbp[addr], self.dcf[addr], self.last_dqp = 0x2F, 7, False
            return
        if kind in (I4, I8):
            self.mb_type(b, addr, inter, offset + 0)
            if self.pps.transform_8x8:
                self.transform_flag(b, addr, kind == I8)
            self.t8[addr] = int(kind == I8)
            blocks = BLOCKS if kind == I4 else [((n & 1) * 2, (n >> 1) * 2) for n in range(4)]
            size = 1 if kind == I4 else 2
            for n, (bx, by) in enumerate(blocks):
                mode = mb["modes"][n]
                self.intra_mode(b, mode, self.predicted_mode(mx, my, bx, by))
                self.modes[my * 4 + by:my * 4 + by + size, mx * 4 + bx:mx * 4 + bx + size] = mode
            self.chroma_mode(b, addr, mb["chroma_mode"])
            self.coded_block_pattern(b, addr, mb["cbp"], True)
        elif kind == I16:
            cbp = mb["cbp"]
            self.mb_type(b, addr, inter,
                         offset + 1 + mb["mode"] + 4 * (cbp >> 4) + (12 if cbp & 15 else 0))
            self.chroma_mode(b, addr, mb["chroma_mode"])
        else:
            if self.b_slice:
                self.inter_b(b, addr, mx, my, mb)
            else:
                self.inter(b, addr, mx, my, mb)
            self.coded_block_pattern(b, addr, mb["cbp"], False)
            if (mb["cbp"] & 15) and self.t8_allowed(mb):
                self.transform_flag(b, addr, bool(mb.get("t8")))
                self.t8[addr] = int(bool(mb.get("t8")))
        self.cbp[addr] = mb["cbp"]
        if kind != INTER:
            self.cmode[addr] = mb["chroma_mode"]
        self.residual(b, mx, my, mb)

    def inter(self, b: Bits, addr: int, mx: int, my: int, mb: dict) -> None:
        t = mb["type"]
        self.mb_type(b, addr, True, t)
        self.shape[addr] = (S16X16, S16X8, S8X16, S8X8, S8X8)[t]
        n_ref = self.n_active
        parts = mb["parts"]  # (bx, by, w, h, shape, ref, mv) in decoding order
        if t < 3:
            for p in parts:
                self.ref_index(b, n_ref, mx, my, p[0], p[1], p[5])
                bx, by, w, h = p[:4]
                self.ref[my * 4 + by:my * 4 + by + h, mx * 4 + bx:mx * 4 + bx + w] = p[5]
        else:
            for s in mb["subs"]:
                self.sub_type(b, s)
            if t == 3:
                for i in range(4):
                    bx, by = (i & 1) * 2, (i >> 1) * 2
                    self.ref_index(b, n_ref, mx, my, bx, by, mb["sub_refs"][i])
                    self.ref[my * 4 + by:my * 4 + by + 2, mx * 4 + bx:mx * 4 + bx + 2] = \
                        mb["sub_refs"][i]
        for bx, by, w, h, shape, ref, mv in parts:
            self.part_motion(b, mx, my, (bx, by, w, h, shape, 1, (ref, -1), (mv, (0, 0))), 0)

    def part_motion(self, b: Bits, mx: int, my: int, part, l: int) -> None:
        """A partition's mvd_lX (where list ``l`` predicts it) and motion;
        ``part`` is (bx, by, w, h, shape, lists, (ref0, ref1), (mv0, mv1))."""
        bx, by, w, h, shape, use, refs, mvs = part
        d = (0, 0)
        if (use >> l) & 1:
            pred = self.predict(mx, my, bx, by, w, refs[l], shape, l)
            d = (mvs[l][0] - pred[0], mvs[l][1] - pred[1])
            self.mvd_component(b, 0, mx, my, bx, by, d[0], l)
            self.mvd_component(b, 1, mx, my, bx, by, d[1], l)
        self.mvds[l][my * 4 + by:my * 4 + by + h, mx * 4 + bx:mx * 4 + bx + w] = (
            min(abs(d[0]), 64), min(abs(d[1]), 64))
        if (use >> l) & 1:
            self.set_motion(mx, my, bx, by, w, h, refs[l], mvs[l], l)
        else:
            self.set_motion(mx, my, bx, by, w, h, -1, (0, 0), l)

    def inter_b(self, b: Bits, addr: int, mx: int, my: int, mb: dict) -> None:
        """A B macroblock: ``btype`` 0 (B_Direct_16x16), 1-21, 22 (B_8x8,
        ``subs`` its sub_mb_types); ``parts`` as ``part_motion`` takes them,
        in decoding order."""
        t = mb["btype"]
        self.mb_type(b, addr, True, t)
        counts = (self.n_active, self.n_active1)
        if t == 0:
            self.mb_direct[addr] = True
            self.direct_motion(mx, my, 15, True)
            return
        parts = mb["parts"]
        if t == 22:
            self.shape[addr] = S8X8
            for st in mb["subs"]:
                self.sub_type(b, st)
            direct = [st == 0 for st in mb["subs"]]
            mask = sum(1 << i for i in range(4) if direct[i])
            if mask:
                self.direct_motion(mx, my, mask, False)
            for l in range(2):
                for i in range(4):
                    if direct[i]:
                        continue
                    bx, by = (i & 1) * 2, (i >> 1) * 2
                    use, ref = mb["sub_use"][i], mb["sub_refs"][l][i]
                    if (use >> l) & 1:
                        self.ref_index(b, counts[l], mx, my, bx, by, ref, l)
                    self.refs[l][my * 4 + by:my * 4 + by + 2, mx * 4 + bx:mx * 4 + bx + 2] = (
                        ref if (use >> l) & 1 else -1)
            for l in range(2):
                k = 0
                for i in range(4):
                    if direct[i]:
                        for j in range(4):
                            self.done[l] |= 1 << (((i >> 1) * 2 + (j >> 1)) * 4 + (i & 1) * 2
                                                  + (j & 1))
                        continue
                    for _ in range(SUB_PARTS[mb["subs"][i]]):
                        self.part_motion(b, mx, my, parts[k], l)
                        k += 1
            return
        self.shape[addr] = (S16X16, S16X8, S8X16)[B_TYPES[t][0]]
        for l in range(2):
            for bx, by, w, h, shape, use, refs, mvs in parts:
                if (use >> l) & 1:
                    self.ref_index(b, counts[l], mx, my, bx, by, refs[l], l)
                self.refs[l][my * 4 + by:my * 4 + by + h, mx * 4 + bx:mx * 4 + bx + w] = (
                    refs[l] if (use >> l) & 1 else -1)
        for l in range(2):
            for part in parts:
                self.part_motion(b, mx, my, part, l)

    def residual(self, b: Bits, mx: int, my: int, mb: dict) -> None:
        kind, cbp = mb["kind"], mb["cbp"]
        addr, intra, cab = my * self.mb_w + mx, kind != INTER, self.cab
        if cbp or kind == I16:
            self.qp_delta(b, mb["qp_delta"])
        else:
            self.last_dqp = False
        t8 = self.t8[addr]
        dcf = 0
        if kind == I16:
            if cab:
                dcf |= int(self.cabac_block(0, self.cbf_inc_dc(addr, 0, True), mb["dc"], 16) > 0)
            else:
                self.block(b, self.nc(self.nz, 4, mx, my, 0, 0), mb["dc"], 16)
        luma = mb.get("luma")  # 16 blocks in decoding order, coefficients in scan order
        for i8 in range(4):
            coded = (cbp >> i8) & 1
            count8 = 0
            if t8 and coded and cab:
                count8 = self.cabac_block(5, 0, mb["luma8"][i8], 64)
            for i4 in range(4):
                n = i8 * 4 + i4
                bx, by = BLOCKS[n]
                total = count8
                if coded and not cab:
                    nc = self.nc(self.nz, 4, mx, my, bx, by)
                    if t8:
                        total = self.block(b, nc, mb["luma8"][i8][i4::4], 16)
                    else:
                        total = self.block(b, nc, luma[n][1:] if kind == I16 else luma[n],
                                           15 if kind == I16 else 16)
                elif coded and not t8:
                    inc = self.cbf_inc(self.nz, 4, mx, my, bx, by, intra)
                    total = (self.cabac_block(1, inc, luma[n][1:], 15) if kind == I16
                             else self.cabac_block(2, inc, luma[n], 16))
                self.nz[my * 4 + by, mx * 4 + bx] = total
        if cbp >> 4:
            for c in range(2):
                if cab:
                    inc = self.cbf_inc_dc(addr, 1 + c, intra)
                    dcf |= int(self.cabac_block(3, inc, mb["cdc"][c], 4) > 0) << (1 + c)
                else:
                    self.block(b, -1, mb["cdc"][c], 4)
        self.dcf[addr] = dcf
        for c in range(2):
            for n in range(4):
                total = 0
                if cbp >> 4 == 2:
                    if cab:
                        inc = self.cbf_inc(self.nz_c[c], 2, mx, my, n & 1, n >> 1, intra)
                        total = self.cabac_block(4, inc, mb["cac"][c][n][1:], 15)
                    else:
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


def random_levels(rng, n: int, density: float, largest: int, escapes: bool, prefix16: bool,
                  budget: int) -> List[int]:
    """``n`` coefficients in scan order whose dequantised values (at most
    ``largest`` a level) add up to at most ``budget``, so that they stay well
    inside 16 bits, the standard's bound on a conforming stream, which
    FFmpeg's int16 blocks rely on (a ``prefix16`` block: one DC level past
    2063, a level_prefix of 16 in CAVLC, when the scales are flat)."""
    out = [0] * n
    if rng.random() > density:
        return out
    budget = max(1, budget // largest)  # the sum of |level|
    count = int(rng.integers(1, min(n, budget) + 1))
    left = budget
    for k, i in enumerate(sorted(rng.choice(n, size=count, replace=False).tolist())):
        most = left - (count - k - 1)
        v = 1 if rng.random() < 0.5 else int(rng.integers(1, min(most, 40) + 1))
        if escapes and most >= 16 and rng.random() < 0.2:
            v = int(rng.integers(16, min(most, 300) + 1))
        left -= v
        out[i] = v if rng.random() < 0.5 else -v
    if n == 4 and budget >= 8 and rng.random() < 0.2:  # a chroma DC block of levels above 1
        out = [int(rng.choice([-1, 1]) * rng.integers(2, min(budget // 4, 20) + 1))
               for _ in range(4)]
    if prefix16 and rng.random() < 0.1:
        out = [0] * n
        out[0] = int(rng.choice([-1, 1]) * rng.integers(2070, 2080))
    return out


class RandomMbs:
    def __init__(self, rng, mb_kinds, pcm, sub_partitions, off_frame, qp_range, escapes,
                 density, high, t8=0.5):
        self.rng = rng
        self.mb_kinds, self.pcm, self.sub = list(mb_kinds), pcm, sub_partitions
        self.off_frame, self.qp_range, self.escapes = off_frame, qp_range, escapes
        self.density, self.high, self.t8 = density, high, t8

    def skipped(self, state, mx, my, mv):
        pass

    @staticmethod
    def intra_modes(rng, avail, pred):
        left, top, top_left = avail[:3]
        ok = [1 if left else None, 2, 0 if top else None, 3 if top else None,
              7 if top else None, 8 if left else None,
              4 if top and left and top_left else None,
              5 if top and left and top_left else None,
              6 if top and left and top_left else None]
        ok = [m for m in ok if m is not None]
        return pred if pred in ok and rng.random() < 0.3 else int(rng.choice(ok))

    def decide(self, state: PictureState, mx: int, my: int, p_slice: bool) -> dict:
        rng = self.rng
        kinds = [k for k in self.mb_kinds if p_slice or k in (I4, I16)]
        if p_slice and not state.list:
            kinds = [k for k in kinds if k in (I4, I16)]
        kinds = kinds or [I4, I16]
        if rng.random() < self.pcm:
            return {"kind": PCM, "samples": rng.integers(0, 256, 384).tolist()}
        kind = kinds[int(rng.integers(len(kinds)))]
        if kind == SKIP:
            return {"kind": SKIP}
        if kind == I4 and state.pps.transform_8x8 and rng.random() < self.t8:
            kind = I8
        mb = {"kind": kind}
        if kind in (I4, I8):
            modes = []
            saved = state.modes.copy()
            if kind == I4:
                for n, (bx, by) in enumerate(BLOCKS):
                    mode = self.intra_modes(rng, state.i4_available(mx, my, bx, by),
                                            state.predicted_mode(mx, my, bx, by))
                    modes.append(mode)
                    state.modes[my * 4 + by, mx * 4 + bx] = mode
            else:
                for n in range(4):
                    bx, by = (n & 1) * 2, (n >> 1) * 2
                    mode = self.intra_modes(rng, state.i8_available(mx, my, n),
                                            state.predicted_mode(mx, my, bx, by))
                    modes.append(mode)
                    state.modes[my * 4 + by:my * 4 + by + 2, mx * 4 + bx:mx * 4 + bx + 2] = mode
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
            if state.b_slice:
                self.inter_b(state, mx, my, mb)
            else:
                self.inter(state, mx, my, mb)
            mb["cbp"] = int(rng.integers(0, 48))
            mb["t8"] = bool(mb["cbp"] & 15 and state.t8_allowed(mb) and rng.random() < self.t8)
        if kind != INTER:
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
        intra = kind != INTER
        qcs = [CHROMA_QP[max(0, min(51, qp + state.pps.cb_offset))],
               CHROMA_QP[max(0, min(51, qp + (state.pps.cr_offset if state.pps.cr_offset
                                               is not None else state.pps.cb_offset)))]]

        def levels(n, q, lists, dc=False):
            wmax = max(max(w) for w in lists)
            largest = (DEQUANT[q % 6][1] << (q // 6)) * wmax // 16
            flat = wmax == 16
            # a level_prefix of 16 only in a luma block's DC: past 20,000 dequantised at an
            # AC position, FFmpeg's inverse transform leaves the standard's arithmetic
            return random_levels(rng, n, self.density, max(1, largest), self.escapes,
                                 self.high and self.escapes and n == 16 and not dc and flat
                                 and q <= 3, 2000 if dc else 16000)

        luma_list = [state.w4[0 if intra else 3]]
        if kind == I8 or mb.get("t8"):
            w8 = state.w8[0 if intra else 1]
            largest = max(1, (max(DEQUANT8[qp % 6]) << (qp // 6)) * max(w8) // 64)
            mb["luma8"] = []
            for i8 in range(4):
                blk = random_levels(rng, 64, self.density, largest, self.escapes, False, 12000)
                if state.pps.cabac and (mb["cbp"] >> i8) & 1 and not any(blk):
                    blk[int(rng.integers(0, 64))] = 1  # a coded 8x8 block has a coefficient
                mb["luma8"].append(blk)
        else:
            mb["luma"] = [levels(16, qp, luma_list) for _ in range(16)]
        if kind == I16:
            mb["dc"] = levels(16, qp, luma_list, True)
            for blk in mb["luma"]:
                blk[0] = 0
        lists = [[state.w4[(1 if intra else 4) + c]] for c in range(2)]
        mb["cdc"] = [levels(4, qcs[c], lists[c], True) for c in range(2)]
        mb["cac"] = [[[0] + levels(15, qcs[c], lists[c]) for _ in range(4)] for c in range(2)]
        return mb

    def vector(self, state: PictureState, mx: int, my: int, bx: int, by: int, l: int = 0):
        """A vector near the one left of block (bx, by) in list ``l``, or one
        reaching off the picture."""
        rng, w4 = self.rng, 4 * state.mb_w
        if rng.random() < self.off_frame:
            x = int(rng.integers(-4 * (16 * mx + 80), 4 * (16 * (state.mb_w - mx) + 80)))
            y = int(rng.integers(-4 * (16 * my + 80), 4 * (16 * (state.mb_h - my) + 80)))
            return (x, y)
        mv = state.mvs[l]
        ox = int(mv[my * 4 + min(by, 3), (mx * 4 + bx - 1) % w4, 0])
        oy = int(mv[my * 4 + min(by, 3), (mx * 4 + bx - 1) % w4, 1])
        x = max(-4 * (16 * mx + 40), min(4 * (16 * (state.mb_w - mx) + 24),
                                          ox + int(rng.integers(-20, 21))))
        y = max(-4 * (16 * my + 40), min(4 * (16 * (state.mb_h - my) + 24),
                                          oy + int(rng.integers(-20, 21))))
        return (x, y)

    def inter_b(self, state: PictureState, mx: int, my: int, mb: dict) -> None:
        """A random B macroblock: B_Direct_16x16, a two-partition type or
        B_8x8 (direct sub-macroblocks among the rest)."""
        rng = self.rng
        n = (len(state.lists[0]), len(state.lists[1]))
        roll = rng.random()
        t = 0 if roll < 0.15 else 22 if roll < 0.35 and self.sub else int(rng.integers(1, 22))
        mb["btype"] = t
        mb["parts"] = []
        if t == 0:
            return

        def part(bx, by, w, h, shape, use, refs):
            mvs = tuple(self.vector(state, mx, my, bx, by, l) if (use >> l) & 1 else (0, 0)
                        for l in range(2))
            return (bx, by, w, h, shape, use, tuple(refs), mvs)
        ref = lambda l: int(rng.integers(0, n[l]))  # noqa: E731
        if t == 22:
            subs = [0 if rng.random() < 0.25 else int(rng.integers(1, 13)) for _ in range(4)]
            use = [B_SUBS[st][0] for st in subs]
            refs = [[ref(l) if (use[i] >> l) & 1 else -1 for i in range(4)] for l in range(2)]
            for i, st in enumerate(subs):
                if st == 0:
                    continue
                ox, oy, form = (i & 1) * 2, (i >> 1) * 2, B_SUBS[st][1]
                r = (refs[0][i], refs[1][i])
                if form == 0:
                    shapes = [(ox, oy, 2, 2)]
                elif form == 1:
                    shapes = [(ox, oy, 2, 1), (ox, oy + 1, 2, 1)]
                elif form == 2:
                    shapes = [(ox, oy, 1, 2), (ox + 1, oy, 1, 2)]
                else:
                    shapes = [(ox + (j & 1), oy + (j >> 1), 1, 1) for j in range(4)]
                for bx, by, w, h in shapes:
                    mb["parts"].append(part(bx, by, w, h, 0, use[i], r))
            mb["subs"], mb["sub_use"], mb["sub_refs"] = subs, use, refs
            return
        shape, u0, u1 = B_TYPES[t]
        uses = (u0,) if shape == 0 else (u0, u1)
        rects = {0: [(0, 0, 4, 4, 0)], 1: [(0, 0, 4, 2, 1), (0, 2, 4, 2, 2)],
                 2: [(0, 0, 2, 4, 3), (2, 0, 2, 4, 4)]}[shape]
        for (bx, by, w, h, sh), use in zip(rects, uses):
            mb["parts"].append(part(bx, by, w, h, sh, use,
                                    [ref(l) if (use >> l) & 1 else -1 for l in range(2)]))

    def inter(self, state: PictureState, mx: int, my: int, mb: dict) -> None:
        rng = self.rng
        n_ref = len([r for r in state.list if r is not None])
        # P_8x8ref0 has no CABAC binarisation
        t = int(rng.integers(0, (4 if state.pps.cabac else 5) if self.sub else 3))
        mb["type"] = t
        vector = functools.partial(self.vector, state, mx, my)

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


def quantise(w: np.ndarray, qp: int, intra: bool, skip_dc: bool = False,
             weights: Optional[Sequence[int]] = None) -> List[int]:
    """A 4x4 block's levels in scan order (``weights``: the scaling list in
    raster order, flat 16 when None)."""
    qbits = 15 + qp // 6
    f = (1 << qbits) // (3 if intra else 6)
    out = []
    for i, pos in enumerate(ZIGZAG):
        if skip_dc and i == 0:
            out.append(0)
            continue
        v = int(w[pos >> 2, pos & 3])
        scale = QUANT[qp % 6][pos_class(pos)]
        if weights is not None:
            scale = scale * 16 // weights[pos]
        q = (abs(v) * scale + f) >> qbits
        out.append(min(q, 2000) * (1 if v >= 0 else -1))
    return out


def dequant4(level: int, scale: int, q6: int) -> int:
    """8.5.12.1: a level scaled by LevelScale4x4 ``scale``."""
    v = level * scale
    return v << (q6 - 4) if q6 >= 4 else (v + (1 << (3 - q6))) >> (4 - q6)


def dequant_idct(levels: Sequence[int], qp: int, dc: Optional[int] = None,
                 weights: Optional[Sequence[int]] = None) -> np.ndarray:
    """The decoder's residual of one block (8.5.12), ``dc`` its scaled DC
    when it came from a DC transform."""
    d = np.zeros(16, np.int64)
    for i, pos in enumerate(ZIGZAG):
        if i == 0 and dc is not None:
            d[pos] = dc
        else:
            w = 16 if weights is None else weights[pos]
            d[pos] = dequant4(int(levels[i]), w * DEQUANT[qp % 6][pos_class(pos)], qp // 6)
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


def idct8_1d(v):
    """8.5.13's one-dimensional transform of the 8 entries ``v`` (ints or
    numpy arrays; floats give the transform without its shifts' rounding)."""
    half = (lambda x: x / 2) if isinstance(v[0], float) else (lambda x: x >> 1)  # noqa: E731
    quarter = (lambda x: x / 4) if isinstance(v[0], float) else (lambda x: x >> 2)  # noqa: E731
    a0, a4 = v[0] + v[4], v[0] - v[4]
    a2, a6 = half(v[2]) - v[6], v[2] + half(v[6])
    b0, b2, b4, b6 = a0 + a6, a4 + a2, a4 - a2, a0 - a6
    a1 = -v[3] + v[5] - v[7] - half(v[7])
    a3 = v[1] + v[7] - v[3] - half(v[3])
    a5 = -v[1] + v[7] + v[5] + half(v[5])
    a7 = v[3] + v[5] + v[1] + half(v[1])
    b1, b7, b3, b5 = a1 + quarter(a7), a7 - quarter(a1), a3 + quarter(a5), quarter(a3) - a5
    return [b0 + b7, b2 + b5, b4 + b3, b6 + b1, b6 - b1, b4 - b3, b2 - b5, b0 - b7]


# the inverse 8x8 transform as a matrix (without its rounding): residual ~
# M8 @ d @ M8.T / 64, so the forward step is its inverse
M8 = np.array([idct8_1d([float(i == k) for i in range(8)]) for k in range(8)]).T
M8_INV = np.linalg.inv(M8)


def dequant_idct8(levels: Sequence[int], qp: int, weights: Sequence[int]) -> np.ndarray:
    """The decoder's residual of one 8x8 block (8.5.13), ``levels`` in scan
    order, ``weights`` the scaling list in raster order."""
    d = np.zeros(64, np.int64)
    q6, r = qp // 6, qp % 6
    for i, pos in enumerate(ZIGZAG8):
        v = int(levels[i]) * weights[pos] * DEQUANT8[r][pos_class8(pos)]
        d[pos] = v << (q6 - 6) if q6 >= 6 else (v + (1 << (5 - q6))) >> (6 - q6)
    d = d.reshape(8, 8)
    rows = np.array(idct8_1d([d[:, k] for k in range(8)])).T  # each row transformed
    out = np.array(idct8_1d([rows[k] for k in range(8)]))  # then each column
    return (out + 32) >> 6


def quantise8(res: np.ndarray, qp: int, intra: bool, weights: Sequence[int]) -> List[int]:
    """An 8x8 residual's levels in scan order (a dead-zone quantiser of the
    coefficients the decoder's transform maps back to ``res``)."""
    x = 64 * (M8_INV @ res.astype(np.float64) @ M8_INV.T)
    q6, r = qp // 6, qp % 6
    out = []
    for pos in ZIGZAG8:
        step = weights[pos] * DEQUANT8[r][pos_class8(pos)] * 2.0 ** q6 / 64
        v = x[pos >> 3, pos & 7] / step
        q = int(abs(v) + (1 / 3 if intra else 1 / 6))
        out.append(min(q, 2000) * (1 if v >= 0 else -1))
    return out


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
                v = ((t[i] + 2 * t[i + 1] + t[i + 2] + 2) >> 2 if y & 1
                     else (t[i] + t[i + 1] + 1) >> 1)
            else:
                z = x + 2 * y
                v = (l[3] if z > 5 else (l[2] + 3 * l[3] + 2) >> 2 if z == 5 else
                     (l[y + (x >> 1)] + 2 * l[y + (x >> 1) + 1] + l[y + (x >> 1) + 2] + 2) >> 2
                     if z & 1 else (l[y + (x >> 1)] + l[y + (x >> 1) + 1] + 1) >> 1)
            p[y, x] = v
    return p


def intra8_pred(rec: np.ndarray, x0: int, y0: int, avail, mode: int) -> np.ndarray:
    """Intra 8x8 prediction (8.3.2.2) of the block at (x0, y0) of ``rec``
    from its filtered reference samples; ``avail`` (left, top, top-left,
    top-right)."""
    left, top, top_left, top_right = avail
    p = [int(rec[y0 - 1, x0 + (i if i < 8 or top_right else 7)]) for i in range(16)] if top else []
    q = [int(rec[y0 + i, x0 - 1]) for i in range(8)] if left else []
    corner = int(rec[y0 - 1, x0 - 1]) if top_left else 0
    t, l, tl = [0] * 16, [0] * 8, 0
    if top:
        t[0] = ((corner if top_left else p[0]) + 2 * p[0] + p[1] + 2) >> 2
        for i in range(1, 15):
            t[i] = (p[i - 1] + 2 * p[i] + p[i + 1] + 2) >> 2
        t[15] = (p[14] + 3 * p[15] + 2) >> 2
    if left:
        l[0] = ((corner if top_left else q[0]) + 2 * q[0] + q[1] + 2) >> 2
        for i in range(1, 7):
            l[i] = (q[i - 1] + 2 * q[i] + q[i + 1] + 2) >> 2
        l[7] = (q[6] + 3 * q[7] + 2) >> 2
    if top_left:
        tl = ((p[0] + 2 * corner + q[0] + 2) >> 2 if top and left else
              (3 * corner + p[0] + 2) >> 2 if top else (3 * corner + q[0] + 2) >> 2 if left
              else corner)
    T = lambda x: tl if x < 0 else t[x]  # noqa: E731
    L = lambda y: tl if y < 0 else l[y]  # noqa: E731
    out = np.zeros((8, 8), np.int64)
    if mode == 2:
        dc = ((sum(t[:8]) + sum(l) + 8) >> 4 if top and left else (sum(l) + 4) >> 3 if left
              else (sum(t[:8]) + 4) >> 3 if top else 128)
        out[:] = dc
        return out
    for y in range(8):
        for x in range(8):
            if mode == 0:
                v = t[x]
            elif mode == 1:
                v = l[y]
            elif mode == 3:
                v = ((t[14] + 3 * t[15] + 2) >> 2 if x == 7 and y == 7 else
                     (t[x + y] + 2 * t[x + y + 1] + t[x + y + 2] + 2) >> 2)
            elif mode == 4:
                v = ((T(x - y - 2) + 2 * T(x - y - 1) + T(x - y) + 2) >> 2 if x > y else
                     (L(y - x - 2) + 2 * L(y - x - 1) + L(y - x) + 2) >> 2 if x < y else
                     (T(0) + 2 * tl + L(0) + 2) >> 2)
            elif mode == 5:
                z, i = 2 * x - y, x - (y >> 1)
                v = ((T(i - 1) + T(i) + 1) >> 1 if z >= 0 and z % 2 == 0 else
                     (T(i - 2) + 2 * T(i - 1) + T(i) + 2) >> 2 if z >= 0 else
                     (L(0) + 2 * tl + T(0) + 2) >> 2 if z == -1 else
                     (L(y - 2 * x - 1) + 2 * L(y - 2 * x - 2) + L(y - 2 * x - 3) + 2) >> 2)
            elif mode == 6:
                z, i = 2 * y - x, y - (x >> 1)
                v = ((L(i - 1) + L(i) + 1) >> 1 if z >= 0 and z % 2 == 0 else
                     (L(i - 2) + 2 * L(i - 1) + L(i) + 2) >> 2 if z >= 0 else
                     (L(0) + 2 * tl + T(0) + 2) >> 2 if z == -1 else
                     (T(x - 2 * y - 1) + 2 * T(x - 2 * y - 2) + T(x - 2 * y - 3) + 2) >> 2)
            elif mode == 7:
                i = x + (y >> 1)
                v = ((t[i] + 2 * t[i + 1] + t[i + 2] + 2) >> 2 if y & 1
                     else (t[i] + t[i + 1] + 1) >> 1)
            else:
                z, i = x + 2 * y, y + (x >> 1)
                v = (l[7] if z > 13 else (l[6] + 3 * l[7] + 2) >> 2 if z == 13 else
                     (l[i] + 2 * l[i + 1] + l[i + 2] + 2) >> 2 if z & 1 else
                     (l[i] + l[i + 1] + 1) >> 1)
            out[y, x] = v
    return out


class PlainMbs:
    """Intra 16x16 / 4x4 / 8x8 by SAD, P_L0_16x16 from a full-sample search,
    P_Skip, a quantised residual (the 8x8 transform for inter macroblocks
    when the PPS allows it) under the active scaling lists; the
    reconstruction kept in the picture state (before the loop filter, as
    intra prediction reads it)."""

    def __init__(self, planes, qp: int, search: int):
        self.src = planes
        self.qp = qp
        self.range = search

    def skipped(self, state, mx, my, mv):
        pred = (self.direct_pred(state, mx, my) if mv is None else
                self.weighted(state, [0, -1], [self.inter_pred(state, mx, my, mv), None]))
        for c in range(3):
            n = 16 if c == 0 else 8
            state.recon[c][my * n:my * n + n, mx * n:mx * n + n] = pred[c]

    def inter_pred(self, state, mx, my, mv, ref=None):
        """The prediction of macroblock (mx, my) from ``ref``'s planes (list
        0's first by default) with the full-sample vector ``mv``."""
        ref = ref if ref is not None else state.list[0].planes
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

    def weighted(self, state, refs, preds):
        """8.4.2.3 on the planes of each list's prediction (None where a list
        does not predict): the average, or the PPS's explicit or implicit
        weights."""
        explicit = state.weights
        if preds[0] is not None and preds[1] is not None:
            if explicit is not None:
                out = []
                for c in range(3):
                    d = explicit["chroma_denom" if c else "luma_denom"]
                    (w0, o0), (w1, o1) = (self.weight(explicit, l, refs[l], c) for l in range(2))
                    out.append(np.clip(((preds[0][c] * w0 + preds[1][c] * w1 + (1 << d))
                                        >> (d + 1)) + ((o0 + o1 + 1) >> 1), 0, 255))
                return out
            if state.pps.weighted_bipred == 2:
                w0 = implicit_weight(state, refs[0], refs[1])
                return [np.clip((a * w0 + b * (64 - w0) + 32) >> 6, 0, 255)
                        for a, b in zip(*preds)]
            return [(a + b + 1) >> 1 for a, b in zip(*preds)]
        l = 0 if preds[0] is not None else 1
        if explicit is None:
            return preds[l]
        out = []
        for c in range(3):
            d = explicit["chroma_denom" if c else "luma_denom"]
            w, o = self.weight(explicit, l, refs[l], c)
            rounding = 1 << (d - 1) if d else 0
            out.append(np.clip(((preds[l][c] * w + rounding) >> d) + o, 0, 255))
        return out

    @staticmethod
    def weight(table, l, ref, c):
        """(weight, offset) of list ``l``'s entry ``ref``, component ``c``."""
        luma, chroma = table["lists"][l][ref]
        entry = luma if c == 0 else (chroma[c - 1] if chroma is not None else None)
        d = table["chroma_denom" if c else "luma_denom"]
        return entry if entry is not None else (1 << d, 0)

    def direct_pred(self, state, mx, my):
        """The prediction of a direct macroblock from the motion grids (its
        vectors full-sample)."""
        out = [np.zeros((16, 16), np.int64), np.zeros((8, 8), np.int64),
               np.zeros((8, 8), np.int64)]
        made = {}
        for k in range(16):
            bx, by = k & 3, k >> 2
            gy, gx = my * 4 + by, mx * 4 + bx
            refs = tuple(int(state.refs[l][gy, gx]) for l in range(2))
            mvs = tuple(tuple(int(v) for v in state.mvs[l][gy, gx]) for l in range(2))
            if (refs, mvs) not in made:
                preds = [None if refs[l] < 0 else
                         self.inter_pred(state, mx, my, mvs[l], state.lists[l][refs[l]].planes)
                         for l in range(2)]
                made[refs, mvs] = self.weighted(state, list(refs), preds)
            pred = made[refs, mvs]
            out[0][by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = pred[0][by * 4:by * 4 + 4,
                                                                   bx * 4:bx * 4 + 4]
            for c in (1, 2):
                out[c][by * 2:by * 2 + 2, bx * 2:bx * 2 + 2] = pred[c][by * 2:by * 2 + 2,
                                                                       bx * 2:bx * 2 + 2]
        return out

    def search(self, state, mx, my, planes, src):
        """The full-sample vector within the search range whose block is
        nearest ``src``, and its SAD."""
        ref = planes[0].astype(np.int64)
        h, w = ref.shape
        y0, x0, best = my * 16, mx * 16, None
        for dy in range(-self.range, self.range + 1):
            for dx in range(-self.range, self.range + 1):
                ys = np.clip(np.arange(16) + y0 + dy, 0, h - 1)
                xs = np.clip(np.arange(16) + x0 + dx, 0, w - 1)
                sad = int(np.abs(src - ref[np.ix_(ys, xs)]).sum()) + 4 * (abs(dx) + abs(dy))
                if best is None or sad < best[0]:
                    best = (sad, (4 * dx, 4 * dy))
        return best

    def decide_b(self, state, mx, my, src, intra_best, left, top, top_left):
        """B_Skip / B_Direct_16x16 where the direct vectors are whole
        samples, else B_L0 / L1 / Bi_16x16 from a search in each list's
        first picture, or intra, by SAD."""
        addr = my * state.mb_w + mx
        cands = []
        state.direct_motion(mx, my, 15, True)
        whole = all(not (int(v) & 3) for l in range(2)
                    for v in state.mvs[l][my * 4:my * 4 + 4, mx * 4:mx * 4 + 4].reshape(-1))
        if whole:
            pred = self.direct_pred(state, mx, my)
            cands.append((int(np.abs(src - pred[0]).sum()) - 64, 0, pred, None))
        state.direct[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = False
        found = [self.search(state, mx, my, state.lists[l][0].planes, src) for l in range(2)]
        for t, use in ((1, (1, 0)), (2, (0, 1)), (3, (1, 1))):
            refs = [0 if use[l] else -1 for l in range(2)]
            mvs = [found[l][1] if use[l] else (0, 0) for l in range(2)]
            preds = [self.inter_pred(state, mx, my, mvs[l], state.lists[l][0].planes)
                     if use[l] else None for l in range(2)]
            pred = self.weighted(state, refs, preds)
            cands.append((int(np.abs(src - pred[0]).sum()) + 32 * (t == 3), t, pred,
                          (refs, mvs)))
        sad, t, pred, motion = min(cands, key=lambda c: c[0])
        if sad > intra_best[0] + 256:
            return self.code_intra(state, mx, my, intra_best[2], left, top, top_left, src)
        if t == 0:
            mb = {"kind": INTER, "btype": 0, "parts": []}
        else:
            refs, mvs = motion
            mb = {"kind": INTER, "btype": t,
                  "parts": [(0, 0, 4, 4, 0, t, tuple(refs), tuple(mvs))]}
        mb = self.code_inter(state, mx, my, None, mb, pred)
        if t == 0 and mb["cbp"] == 0:
            return {"kind": SKIP}
        state.mb_direct[addr] = False
        return mb

    def decide(self, state: PictureState, mx: int, my: int, p_slice: bool) -> dict:
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
        if state.b_slice:
            return self.decide_b(state, mx, my, src, best, left, top, top_left)
        inter = None
        if p_slice and state.list and state.list[0].planes is not None:
            ref = state.list[0].planes[0].astype(np.int64)
            h, w = ref.shape
            for dy in range(-self.range, self.range + 1):
                for dx in range(-self.range, self.range + 1):
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
            wts = state.w4[(1 if intra else 4) + c]
            src = self.src[1 + c][my * 8:my * 8 + 8, mx * 8:mx * 8 + 8].astype(np.int64)
            res = src - preds[c]
            ws = [forward4(res[(n >> 1) * 4:(n >> 1) * 4 + 4, (n & 1) * 4:(n & 1) * 4 + 4])
                  for n in range(4)]
            dcs = np.array([[ws[0][0, 0], ws[1][0, 0]], [ws[2][0, 0], ws[3][0, 0]]], np.int64)
            f = np.array([[1, 1], [1, -1]]) @ dcs @ np.array([[1, 1], [1, -1]])
            qbits = 16 + qc // 6
            mf = QUANT[qc % 6][0] * 16 // wts[0]
            dc_levels = [int(np.sign(v) * min(2000, (abs(int(v)) * mf + ((1 << qbits) // 3))
                                              >> qbits)) for v in f.reshape(-1)]
            acs = [[0] + quantise(w, qc, intra, skip_dc=True, weights=wts)[1:] for w in ws]
            if any(dc_levels):
                cbp_c = max(cbp_c, 1)
            if any(any(a) for a in acs):
                cbp_c = 2
            mb["cdc"].append(dc_levels)
            mb["cac"].append(acs)
        for c in range(2):
            qc = CHROMA_QP[max(0, min(51, qp + state.pps.cb_offset))]
            wts = state.w4[(1 if intra else 4) + c]
            d = mb["cdc"][c] if cbp_c else [0] * 4
            ff = [d[0] + d[1] + d[2] + d[3], d[0] - d[1] + d[2] - d[3],
                  d[0] + d[1] - d[2] - d[3], d[0] - d[1] - d[2] + d[3]]
            scale = DEQUANT[qc % 6][0] * wts[0]
            rec = preds[c].copy()
            for n in range(4):
                dc = (ff[n] * scale * (1 << (qc // 6))) >> 5
                ac = mb["cac"][c][n] if cbp_c == 2 else [0] * 16
                r = dequant_idct(ac, qc, dc, wts)
                sl = (slice((n >> 1) * 4, (n >> 1) * 4 + 4), slice((n & 1) * 4, (n & 1) * 4 + 4))
                rec[sl] = np.clip(rec[sl] + r, 0, 255)
            recs.append(rec)
        for c in range(2):
            state.recon[1 + c][my * 8:my * 8 + 8, mx * 8:mx * 8 + 8] = recs[c]
        return cbp_c

    def code_inter(self, state, mx, my, mv, mb=None, preds=None) -> dict:
        """A P_L0_16x16 macroblock of vector ``mv`` (or ``mb`` over
        ``preds``), its residual quantised; P_Skip where it can be."""
        qp = self.qp
        if preds is None:
            preds = self.weighted(state, [0, -1], [self.inter_pred(state, mx, my, mv), None])
        src = self.src[0][my * 16:my * 16 + 16, mx * 16:mx * 16 + 16].astype(np.int64)
        res = src - preds[0]
        cbp = 0
        rec = preds[0].copy()
        mb = mb or {"kind": INTER, "type": 0, "parts": [(0, 0, 4, 4, 0, 0, mv)]}
        mb["qp_delta"] = 0
        if state.t8_allowed(mb):
            w8 = state.w8[1]
            mb["luma8"], mb["t8"] = [], True
            for i8 in range(4):
                y8, x8 = (i8 >> 1) * 8, (i8 & 1) * 8
                sl = (slice(y8, y8 + 8), slice(x8, x8 + 8))
                levels = quantise8(res[sl], qp, False, w8)
                mb["luma8"].append(levels)
                if any(levels):
                    cbp |= 1 << i8
                    rec[sl] = np.clip(rec[sl] + dequant_idct8(levels, qp, w8), 0, 255)
        else:
            wts = state.w4[3]
            luma = []
            for n, (bx, by) in enumerate(BLOCKS):
                levels = quantise(forward4(res[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4]), qp, False,
                                  weights=wts)
                luma.append(levels)
                if any(levels):
                    cbp |= 1 << (n >> 2)
            for n, (bx, by) in enumerate(BLOCKS):
                if cbp & (1 << (n >> 2)):
                    rec[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = np.clip(
                        rec[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4]
                        + dequant_idct(luma[n], qp, weights=wts), 0, 255)
            mb["luma"] = luma
        cbp |= self.chroma(state, mx, my, preds[1:], False, mb) << 4
        state.recon[0][my * 16:my * 16 + 16, mx * 16:mx * 16 + 16] = rec
        mb["cbp"] = cbp
        if mv is not None and cbp == 0 and tuple(mv) == tuple(state.skip_mv(mx, my)):
            return {"kind": SKIP}
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
        wts = state.w4[0]
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
            dc_levels[i] = int(np.sign(v)) * min(2000, (abs(v) * QUANT[qp % 6][0] * 16 // wts[0]
                                                        + ((1 << qbits) // 3)) >> qbits)
        acs = [[0] + quantise(w, qp, True, skip_dc=True, weights=wts)[1:] for w in ws]
        c = np.zeros((4, 4), np.int64)
        for i, pos in enumerate(ZIGZAG):
            c[pos >> 2, pos & 3] = dc_levels[i]
        ff = hadamard(c)
        scale = DEQUANT[qp % 6][0] * wts[0]
        q6 = qp // 6
        rec16 = pred.copy()
        ac_any = any(any(a) for a in acs)
        for n, (bx, by) in enumerate(BLOCKS):
            v = int(ff[by, bx])
            dc = (v * scale * (1 << (q6 - 6)) if qp >= 36
                  else (v * scale + (1 << (5 - q6))) >> (6 - q6))
            r = dequant_idct(acs[n] if ac_any else [0] * 16, qp, dc, wts)
            rec16[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = np.clip(
                rec16[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] + r, 0, 255)
        sad16 = int(np.abs(src - rec16).sum())
        # intra 4x4 and 8x8, block by block on their own reconstruction
        saved = rec[y0:y0 + 16, x0:x0 + 16].copy()
        saved_modes = state.modes.copy()
        modes, luma4, cbp4 = self.try4(state, mx, my, src)
        sad4 = int(np.abs(src - rec[y0:y0 + 16, x0:x0 + 16]).sum()) + 16
        rec[y0:y0 + 16, x0:x0 + 16] = saved
        state.modes[:] = saved_modes
        sad8 = None
        if state.pps.transform_8x8:
            modes8, luma8, cbp8, rec8 = self.try8(state, mx, my, src)
            sad8 = int(np.abs(src - rec8).sum()) + 8
            rec[y0:y0 + 16, x0:x0 + 16] = saved
            state.modes[:] = saved_modes
        if sad8 is not None and sad8 < min(sad16, sad4):
            rec[y0:y0 + 16, x0:x0 + 16] = rec8
            mb = {"kind": I8, "modes": modes8, "luma8": luma8, "qp_delta": 0, "chroma_mode": 0}
            cbp = cbp8
        elif sad16 <= sad4:
            rec[y0:y0 + 16, x0:x0 + 16] = rec16
            mb = {"kind": I16, "mode": mode16, "dc": dc_levels,
                  "luma": [[0] + a[1:] for a in acs], "qp_delta": 0, "chroma_mode": 0}
            cbp = 15 if ac_any else 0
        else:
            mb = {"kind": I4, "modes": modes, "luma": luma4, "qp_delta": 0, "chroma_mode": 0}
            cbp = cbp4
            self.redo4(state, mx, my, modes, luma4, cbp4)
        preds = [self.chroma_dc_pred(state, mx, my, c) for c in range(2)]
        cbp |= self.chroma(state, mx, my, preds, True, mb) << 4
        mb["cbp"] = cbp
        return mb

    def try4(self, state, mx, my, src):
        qp, rec, wts = self.qp, state.recon[0], state.w4[0]
        x0, y0 = mx * 16, my * 16
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
            levels = quantise(forward4(blk - p), qp, True, weights=wts)
            modes.append(m)
            state.modes[my * 4 + by, mx * 4 + bx] = m
            luma4.append(levels)
            if any(levels):
                cbp4 |= 1 << (n >> 2)
            r = dequant_idct(levels, qp, weights=wts) if any(levels) else 0
            rec[py:py + 4, px:px + 4] = np.clip(p + r, 0, 255)
        return modes, luma4, cbp4

    def try8(self, state, mx, my, src):
        """Intra 8x8: each block's mode by SAD, on the blocks before it;
        returns (modes, levels, cbp, reconstruction)."""
        qp, rec, w8 = self.qp, state.recon[0], state.w8[0]
        x0, y0 = mx * 16, my * 16
        modes, luma8, cbp = [], [], 0
        for n in range(4):
            bx, by = (n & 1) * 8, (n >> 1) * 8
            avail = state.i8_available(mx, my, n)
            lft, tp, tl_ok, _ = avail
            ok = [2] + ([0, 3, 7] if tp else []) + ([1, 8] if lft else []) + (
                [4, 5, 6] if tp and lft and tl_ok else [])
            blk = src[by:by + 8, bx:bx + 8]
            best = None
            for m in ok:
                p = intra8_pred(rec, x0 + bx, y0 + by, avail, m)
                sad = int(np.abs(blk - p).sum())
                if best is None or sad < best[0]:
                    best = (sad, m, p)
            _, m, p = best
            levels = quantise8(blk - p, qp, True, w8)
            modes.append(m)
            y4, x4 = my * 4 + by // 4, mx * 4 + bx // 4
            state.modes[y4:y4 + 2, x4:x4 + 2] = m
            luma8.append(levels)
            r = 0
            if any(levels):
                cbp |= 1 << n
                r = dequant_idct8(levels, qp, w8)
            rec[y0 + by:y0 + by + 8, x0 + bx:x0 + bx + 8] = np.clip(p + r, 0, 255)
        return modes, luma8, cbp, rec[y0:y0 + 16, x0:x0 + 16].copy()

    def redo4(self, state, mx, my, modes, luma4, cbp4):
        """The intra 4x4 reconstruction as the decoder makes it (a block whose
        8x8 has no coded block keeps its prediction)."""
        qp, wts = self.qp, state.w4[0]
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
            r = dequant_idct(luma4[n], qp, weights=wts) if cbp4 & (1 << (n >> 2)) else 0
            rec[py:py + 4, px:px + 4] = np.clip(p + r, 0, 255)
