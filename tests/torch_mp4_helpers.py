"""Helpers for the MP4 / MPEG-4 tests: a small ISO BMFF writer (so a test
can lay out the box tree itself: another codec's sample entry, an edit
list, ``moov`` first, 64-bit or to-the-end ``mdat`` sizes, ``stz2``,
``co64``, several samples a chunk), an MPEG-4 Part 2 VOL header writer for
the decoder's refusals, and OpenCV's three views of a video: the decoded
frames, the decoded Y plane (``CAP_PROP_CONVERT_RGB`` 0) and the raw
packets (``CAP_PROP_FORMAT`` -1)."""

from __future__ import annotations

import os
import struct
from typing import List, Optional, Sequence, Tuple

import cv2

from viddet_tpu_torch.native.mp4 import read_index


def box(kind: bytes, payload: bytes, large: bool = False) -> bytes:
    if large:
        return struct.pack(">I4sQ", 1, kind, 16 + len(payload)) + payload
    return struct.pack(">I4s", 8 + len(payload), kind) + payload


def full_box(kind: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return box(kind, struct.pack(">I", (version << 24) | flags) + payload)


def descriptor(tag: int, payload: bytes) -> bytes:
    n = len(payload)  # the four-byte size form, as FFmpeg writes it
    return bytes([tag, 0x80 | (n >> 21) & 0x7F, 0x80 | (n >> 14) & 0x7F,
                  0x80 | (n >> 7) & 0x7F, n & 0x7F]) + payload


def sample_entry(kind: bytes, width: int, height: int, config: bytes = b"",
                 object_type: int = 0x20) -> bytes:
    visual = (bytes(6) + struct.pack(">H", 1) + bytes(16) + struct.pack(">HH", width, height)
              + struct.pack(">II", 0x480000, 0x480000) + bytes(4) + struct.pack(">H", 1)
              + bytes(32) + struct.pack(">Hh", 24, -1))
    children = b""
    if kind == b"mp4v":
        dcd = (bytes([object_type, 0x11]) + bytes(3) + struct.pack(">II", 0, 0)
               + descriptor(5, config))
        es = struct.pack(">HB", 1, 0) + descriptor(4, dcd) + descriptor(6, b"\x02")
        children = full_box(b"esds", 0, 0, descriptor(3, es))
    elif kind == b"vp09":  # config: the vpcC payload; by default profile 0, 8-bit 4:2:0
        children = full_box(b"vpcC", 1, 0, config or bytes([0, 10, 0x82, 1, 1, 1, 0, 0]))
    elif kind in (b"avc1", b"avc3"):
        children = box(b"avcC", bytes([1, 0x64, 0, 0x1F, 0xFF, 0xE0, 0]))
    elif kind in (b"hvc1", b"hev1"):
        children = box(b"hvcC", bytes(23))
    return box(kind, visual + children)


def write_mp4(path: str, samples: Sequence[bytes], width: int, height: int, *,
              kind: bytes = b"mp4v", config: bytes = b"", object_type: int = 0x20,
              timescale: int = 12800, deltas: Optional[Sequence[int]] = None,
              moov_first: bool = False, large_mdat: bool = False, mdat_to_end: bool = False,
              per_chunk: int = 1, co64: bool = False, stz2: bool = False,
              edits: Optional[List[Tuple[int, int, int]]] = None, mdhd_version: int = 0,
              keyframes: Optional[Sequence[int]] = None, brand: bytes = b"isom",
              ctts: Optional[Sequence[int]] = None, ctts_version: int = 0) -> str:
    """An MP4 (or, with ``brand`` b"qt  ", a QuickTime file) of one video
    track holding ``samples``; ``edits`` are (segment duration in the
    movie's 1000 ticks a second, media time, rate) entries; ``deltas`` the
    stts durations (512 each by default); ``ctts`` each sample's
    composition offset (a ``ctts`` box of ``ctts_version``; version 1
    offsets may be negative)."""
    n = len(samples)
    deltas = list(deltas) if deltas is not None else [512] * n
    duration = sum(deltas)
    movie = duration * 1000 // timescale

    def moov(offsets) -> bytes:
        mvhd = full_box(b"mvhd", 0, 0, struct.pack(">IIII", 0, 0, 1000, movie)
                        + struct.pack(">IH", 0x10000, 0x100) + bytes(10)
                        + struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
                        + bytes(24) + struct.pack(">I", 2))
        tkhd = full_box(b"tkhd", 0, 3, struct.pack(">IIIII", 0, 0, 1, 0, movie) + bytes(8)
                        + struct.pack(">hhhH", 0, 0, 0, 0)
                        + struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
                        + struct.pack(">II", width << 16, height << 16))
        edts = b""
        if edits is not None:
            edts = box(b"edts", full_box(b"elst", 0, 0, struct.pack(">I", len(edits)) + b"".join(
                struct.pack(">IihH", d, t, r, 0) for d, t, r in edits)))
        if mdhd_version:
            mdhd = full_box(b"mdhd", 1, 0, struct.pack(">QQIQHH", 0, 0, timescale, duration,
                                                        0x55C4, 0))
        else:
            mdhd = full_box(b"mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0, timescale, duration,
                                                        0x55C4, 0))
        hdlr = full_box(b"hdlr", 0, 0, bytes(4) + b"vide" + bytes(12) + b"VideoHandler\0")
        runs = []
        for d in deltas:
            if runs and runs[-1][1] == d:
                runs[-1][0] += 1
            else:
                runs.append([1, d])
        stts = full_box(b"stts", 0, 0, struct.pack(">I", len(runs)) + b"".join(
            struct.pack(">II", c, d) for c, d in runs))
        if ctts is not None:
            offset_runs = []
            for c in ctts:
                if offset_runs and offset_runs[-1][1] == c:
                    offset_runs[-1][0] += 1
                else:
                    offset_runs.append([1, c])
            stts += full_box(b"ctts", ctts_version, 0, struct.pack(">I", len(offset_runs))
                             + b"".join(struct.pack(">Ii" if ctts_version else ">II", c, d)
                                        for c, d in offset_runs))
        chunks = [list(range(i, min(i + per_chunk, n))) for i in range(0, n, per_chunk)]
        stsc_runs = []
        for c, members in enumerate(chunks):
            if not stsc_runs or stsc_runs[-1][1] != len(members):
                stsc_runs.append((c + 1, len(members)))
        stsc = full_box(b"stsc", 0, 0, struct.pack(">I", len(stsc_runs)) + b"".join(
            struct.pack(">III", f, c, 1) for f, c in stsc_runs))
        sizes = [len(s) for s in samples]
        if stz2:
            stsz = full_box(b"stz2", 0, 0, bytes(3) + bytes([16]) + struct.pack(">I", n)
                            + struct.pack(f">{n}H", *sizes))
        elif len(set(sizes)) == 1:
            stsz = full_box(b"stsz", 0, 0, struct.pack(">II", sizes[0], n))
        else:
            stsz = full_box(b"stsz", 0, 0, struct.pack(">II", 0, n)
                            + struct.pack(f">{n}I", *sizes))
        starts = [offsets[m[0]] for m in chunks]
        if co64:
            stco = full_box(b"co64", 0, 0, struct.pack(f">I{len(starts)}Q", len(starts), *starts))
        else:
            stco = full_box(b"stco", 0, 0, struct.pack(f">I{len(starts)}I", len(starts), *starts))
        stss = b""
        if keyframes is not None:
            stss = full_box(b"stss", 0, 0, struct.pack(f">I{len(keyframes)}I", len(keyframes),
                                                      *(k + 1 for k in keyframes)))
        stsd = full_box(b"stsd", 0, 0, struct.pack(">I", 1)
                        + sample_entry(kind, width, height, config, object_type))
        stbl = box(b"stbl", stsd + stts + stss + stsc + stsz + stco)
        dinf = box(b"dinf", full_box(b"dref", 0, 0, struct.pack(">I", 1)
                                     + full_box(b"url ", 0, 1, b"")))
        minf = box(b"minf", full_box(b"vmhd", 0, 1, bytes(8)) + dinf + stbl)
        trak = box(b"trak", tkhd + edts + box(b"mdia", mdhd + hdlr + minf))
        return box(b"moov", mvhd + trak)

    ftyp = box(b"ftyp", brand + struct.pack(">I", 0x200) + brand + b"mp41")
    payload = b"".join(samples)
    mdat_head = 16 if large_mdat else 8
    placeholder = moov([0] * n)
    mdat_at = len(ftyp) + (len(placeholder) if moov_first else 0)
    offsets, at = [], mdat_at + mdat_head
    for s in samples:
        offsets.append(at)
        at += len(s)
    if mdat_to_end:
        mdat = struct.pack(">I4s", 0, b"mdat") + payload
    else:
        mdat = box(b"mdat", payload, large=large_mdat)
    tree = moov(offsets)
    assert len(tree) == len(placeholder)
    with open(path, "wb") as f:
        f.write(ftyp + (tree + mdat if moov_first else mdat + tree))
    return path


def h264_mp4(path: str) -> str:
    """An MP4 whose one video track is H.264 (an ``avc1`` sample entry),
    made without an encoder: three samples of a few bytes each."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    return write_mp4(path, [b"\0\0\0\x05\x65\x88\x80\x10\x00"] * 3, 64, 48, kind=b"avc1")


def remux(src: str, dst: str, **kw) -> str:
    """The samples of ``src`` (an MP4 the port indexes) in a file laid out
    by ``write_mp4``."""
    index = read_index(src)
    with open(src, "rb") as f:
        data = f.read()
    samples = [data[o:o + s] for o, s in zip(index.offsets.tolist(), index.sizes.tolist())]
    kw.setdefault("config", index.config)
    kw.setdefault("kind", b"jpeg" if index.codec == "jpeg" else b"mp4v")
    return write_mp4(dst, samples, index.width, index.height, **kw)


def avi_chunk(cid: bytes, payload: bytes) -> bytes:
    return cid + struct.pack("<I", len(payload)) + payload + b"\0" * (len(payload) & 1)


def avi_list(kind: bytes, payload: bytes) -> bytes:
    return b"LIST" + struct.pack("<I", 4 + len(payload)) + kind + payload


def write_avi(path: str, chunks: Sequence[bytes], width: int, height: int, *,
              fourcc: bytes = b"XVID", rate: int = 25, scale: int = 1,
              extradata: bytes = b"") -> str:
    """An AVI 1.0 file with an ``idx1`` of one video stream whose ``00dc``
    chunks are ``chunks`` as given (MPEG-4 VOPs, packed or not; an empty
    one is a dropped frame); ``extradata`` follows the BITMAPINFOHEADER in
    ``strf``.  A chunk holding an I-VOP is a key frame."""
    n = len(chunks)
    biggest = max(len(c) for c in chunks)
    avih = struct.pack("<14I", 1000000 * scale // rate, 0, 0, 0x10, n, 0, 1, biggest, width,
                       height, 0, 0, 0, 0)
    strh = struct.pack("<4s4sIHHIIIIIIIIHHHH", b"vids", fourcc, 0, 0, 0, 0, scale, rate, 0, n,
                       biggest, 0xFFFFFFFF, 0, 0, 0, width, height)
    strf = struct.pack("<IiiHH4sIiiII", 40 + len(extradata), width, height, 1, 24, fourcc,
                       width * height * 3, 0, 0, 0, 0) + extradata
    hdrl = avi_list(b"hdrl", avi_chunk(b"avih", avih) + avi_list(
        b"strl", avi_chunk(b"strh", strh) + avi_chunk(b"strf", strf)))
    movi, index, at = b"", b"", 4
    for c in chunks:
        vop = c.find(b"\x00\x00\x01\xb6")
        key = 0x10 if vop >= 0 and c[vop + 4] >> 6 == 0 else 0
        index += struct.pack("<4sIII", b"00dc", key, at, len(c))
        movi += avi_chunk(b"00dc", c)
        at += 8 + len(c) + (len(c) & 1)
    body = b"AVI " + hdrl + avi_list(b"movi", movi) + avi_chunk(b"idx1", index)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)
    return path


def non_coded_vop(time_bits: int, increment: int = 0) -> bytes:
    """A non-coded P-VOP (vop_coded 0): the placeholder of packed B-frames."""
    bits = (BitWriter().put(1, 2).put(0, 1).put(1, 1).put(increment, time_bits).put(1, 1)
            .put(0, 1))
    return b"\x00\x00\x01\xb6" + bits.stuffed()


def pack_bframes(packets: Sequence[bytes], types: str, time_bits: int) -> List[bytes]:
    """DivX's packed B-frames: each I- or P-VOP followed in decode order by
    one B-VOP shares its chunk with it, and a placeholder non-coded VOP
    fills the B-VOP's place, so that a chunk is a frame in display order."""
    out, i = [], 0
    while i < len(packets):
        if types[i] != "B" and i + 1 < len(packets) and types[i + 1] == "B":
            out += [packets[i] + packets[i + 1], non_coded_vop(time_bits)]
            i += 2
        else:
            out.append(packets[i])
            i += 1
    return out


class BitWriter:
    def __init__(self):
        self.bits: List[int] = []

    def put(self, value: int, n: int) -> "BitWriter":
        self.bits += [(value >> (n - 1 - i)) & 1 for i in range(n)]
        return self

    def stuffed(self) -> bytes:
        """The bits, then MPEG-4 stuffing (a 0, then 1s) to the next byte."""
        bits = self.bits + [0] + [1] * ((7 - len(self.bits)) % 8)
        return bytes(int("".join(map(str, bits[i:i + 8])), 2) for i in range(0, len(bits), 8))


def vol_config(width: int, height: int, *, shape: int = 0, interlaced: int = 0,
               sprite: int = 0, quant_type: int = 0, quarter_sample: int = 0,
               data_partitioned: int = 0, reversible_vlc: int = 0, not_8_bit: int = 0,
               newpred: int = 0, reduced_resolution: int = 0, scalability: int = 0,
               matrices: Tuple[Optional[Sequence[int]], Optional[Sequence[int]]] = (None, None),
               ) -> bytes:
    """VOS, VO and a version-2 VOL header (so quarter_sample is coded) with
    the given flags: the decoder configuration of an ``esds``.  With
    ``quant_type``, ``matrices`` are the (intra, inter) values to load, in
    zigzag order as the header carries them (a 0 ends a shorter list), or
    None for the default matrix."""
    b = BitWriter()
    b.put(0, 1).put(1, 8).put(1, 1).put(2, 4).put(1, 3)  # random access, type, verid 2
    b.put(1, 4).put(0, 1)  # square pixels, no vol_control_parameters
    b.put(shape, 2).put(1, 1).put(25, 16).put(1, 1).put(0, 1)  # 25 ticks a second
    if shape == 0:
        b.put(1, 1).put(width, 13).put(1, 1).put(height, 13).put(1, 1)
    b.put(interlaced, 1).put(1, 1).put(sprite, 2).put(not_8_bit, 1)  # obmc_disable
    b.put(quant_type, 1)
    if quant_type:
        for matrix in matrices:
            b.put(matrix is not None, 1)
            for v in matrix or ():
                b.put(v, 8)
    b.put(quarter_sample, 1).put(1, 1).put(1, 1)  # complexity estimation off, no resync
    b.put(data_partitioned, 1)
    if data_partitioned:
        b.put(reversible_vlc, 1)
    b.put(newpred, 1).put(reduced_resolution, 1).put(scalability, 1)
    return (b"\x00\x00\x01\xb0\x01\x00\x00\x01\xb5\x09\x00\x00\x01\x00\x00\x00\x01\x20"
            + b.stuffed())


def cv2_views(path: str, view: str) -> list:
    """``view`` "bgr": frames as ``cv2.VideoCapture`` (FFmpeg) decodes them;
    "y": the decoded Y planes; "packets": the raw packets' bytes."""
    params = {"bgr": [], "y": [cv2.CAP_PROP_CONVERT_RGB, 0],
              "packets": [cv2.CAP_PROP_FORMAT, -1]}[view]
    cap = cv2.VideoCapture(path, cv2.CAP_FFMPEG, params)
    assert cap.isOpened(), path
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        out.append(frame.tobytes() if view == "packets" else frame)
    cap.release()
    return out
