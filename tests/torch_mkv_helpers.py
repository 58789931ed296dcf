"""Helpers for the Matroska / WebM, VP8 and VP9 tests: an EBML writer that
lays out a Matroska file's elements as a test asks (unknown-size segments
and clusters, each lacing type, ``BlockGroup``s, audio blocks between the
video's, a second video track, content encodings, other codecs), VP8 and
VP9 streams from the libvpx encoders inside the opencv-python wheel's
libavcodec, and the planes a stream is encoded from."""

from __future__ import annotations

import struct
from typing import Optional, Sequence

import cv2
import numpy as np

from tests.fixtures.make_mp4_fixture import Lavc, moving_scene

UNKNOWN_SIZE = b"\x01\xff\xff\xff\xff\xff\xff\xff"


def size_vint(n: int) -> bytes:
    """An EBML size in the fewest bytes (all ones is reserved)."""
    for length in range(1, 9):
        if n < (1 << (7 * length)) - 1:
            return ((1 << (7 * length)) | n).to_bytes(length, "big")
    raise ValueError(n)


def el(eid: int, payload: bytes, unknown: bool = False) -> bytes:
    head = eid.to_bytes((eid.bit_length() + 7) // 8, "big")
    return head + (UNKNOWN_SIZE if unknown else size_vint(len(payload))) + payload


def uint_el(eid: int, v: int) -> bytes:
    return el(eid, v.to_bytes(max(1, (v.bit_length() + 7) // 8), "big"))


def str_el(eid: int, s: str) -> bytes:
    return el(eid, s.encode())


def ebml_header(doc_type: str = "webm", read_version: int = 2) -> bytes:
    return el(0x1A45DFA3, uint_el(0x4286, 1) + uint_el(0x42F7, 1) + uint_el(0x42F2, 4)
              + uint_el(0x42F3, 8) + str_el(0x4282, doc_type) + uint_el(0x4287, 4)
              + uint_el(0x4285, read_version))


def track_entry(number: int, codec: str, width: int = 0, height: int = 0, kind: int = 1,
                private: bytes = b"", default_duration: Optional[int] = None,
                encoding: Optional[bytes] = None) -> bytes:
    body = (uint_el(0xD7, number) + uint_el(0x73C5, number) + uint_el(0x83, kind)
            + str_el(0x86, codec))
    if private:
        body += el(0x63A2, private)
    if default_duration:
        body += uint_el(0x23E383, default_duration)
    if kind == 1:
        body += el(0xE0, uint_el(0xB0, width) + uint_el(0xBA, height))
    else:
        body += el(0xE1, el(0xB5, struct.pack(">d", 48000.0)) + uint_el(0x9F, 2))
    if encoding is not None:
        body += el(0x6D80, el(0x6240, encoding))
    return el(0xAE, body)


def header_stripping(prefix: bytes) -> bytes:
    """A ContentEncoding of header stripping (ContentCompAlgo 3)."""
    return uint_el(0x5033, 0) + el(0x5034, uint_el(0x4254, 3) + el(0x4255, prefix))


def encryption() -> bytes:
    return uint_el(0x5033, 1) + el(0x5035, uint_el(0x47E1, 5))


def lace(frames: Sequence[bytes], kind: str) -> bytes:
    """The lacing header and frames of one block (kind xiph, ebml or fixed)."""
    head = bytes([len(frames) - 1])
    if kind == "xiph":
        for f in frames[:-1]:
            head += b"\xff" * (len(f) // 255) + bytes([len(f) % 255])
    elif kind == "ebml":
        head += size_vint(len(frames[0]))
        for a, b in zip(frames, frames[1:-1]):
            d = len(b) - len(a)
            for length in range(1, 9):
                bias = (1 << (7 * length - 1)) - 1
                if -bias <= d <= bias:
                    head += ((1 << (7 * length)) | (d + bias)).to_bytes(length, "big")
                    break
    elif kind == "fixed":
        assert len({len(f) for f in frames}) == 1
    return head + b"".join(frames)


LACING_BITS = {None: 0, "xiph": 2, "fixed": 4, "ebml": 6}


def block(track: int, time: int, frames: Sequence[bytes], lacing=None, key=True,
          simple: bool = True) -> bytes:
    flags = LACING_BITS[lacing] | (0x80 if key and simple else 0)
    body = size_vint(track) + struct.pack(">hB", time, flags)
    body += lace(frames, lacing) if lacing else frames[0]
    if simple:
        return el(0xA3, body)
    return el(0xA0, el(0xA1, body) + uint_el(0x9B, 40))  # BlockGroup: Block, BlockDuration


def write_mkv(path: str, frames: Sequence[bytes], width: int, height: int, *,
              codec: str = "V_VP8", doc_type: str = "webm", private: bytes = b"",
              default_duration: Optional[int] = 40_000_000, times: Optional[Sequence[int]] = None,
              unknown_sizes: bool = False, lacing: Optional[str] = None, per_block: int = 1,
              block_groups: bool = False, audio: bool = False, first_track: Optional[bytes] = None,
              second_video: Optional[Sequence[bytes]] = None, encoding: Optional[bytes] = None,
              read_version: int = 2, per_cluster: int = 8, extras: bool = True,
              scale: int = 1_000_000, duration: Optional[float] = None, kind: int = 1) -> str:
    """A Matroska / WebM file of one video track (number 1) holding
    ``frames``: ``times`` each frame's timestamp in ticks of ``scale`` ns
    (40 ms apart by default), ``per_block`` frames a block laced by
    ``lacing``, SimpleBlocks or BlockGroups, ``per_cluster`` frames a
    cluster; ``audio`` puts an Opus track's blocks between the video's,
    ``first_track`` a track entry before the video's, ``second_video`` a
    second video track (number 3) with its own frames; ``extras`` adds a
    SeekHead, Void and CRC-32 elements, Cues and Tags, which a reader
    skips; ``kind`` 2 makes track 1 an audio track."""
    n = len(frames)
    times = list(times) if times is not None else [i * 40_000_000 // scale for i in range(n)]
    info = (uint_el(0x2AD7B1, scale) + str_el(0x4D80, "viddet-tests")
            + str_el(0x5741, "viddet-tests"))
    total = duration if duration is not None else (times[-1] + 40_000_000 // scale if n else 0)
    info += el(0x4489, struct.pack(">d", float(total)))
    tracks = first_track or b""
    tracks += track_entry(1, codec, width, height, kind=kind, private=private,
                          default_duration=default_duration, encoding=encoding)
    if audio:
        head = b"OpusHead" + struct.pack("<BBHIhB", 1, 2, 312, 48000, 0, 0)
        tracks += track_entry(2, "A_OPUS", kind=2, private=head)
    if second_video is not None:
        tracks += track_entry(3, "V_VP8", width, height, default_duration=default_duration)
    body = b""
    if extras:
        body += el(0x114D9B74, el(0x4DBB, el(0x53AB, b"\x15\x49\xa9\x66") + uint_el(0x53AC, 0)))
        body += el(0xEC, bytes(16))
    body += el(0x1549A966, info) + el(0x1654AE6B, tracks)
    for c in range(0, n, per_cluster):
        base = times[c]
        content = uint_el(0xE7, base)
        if extras:
            content += el(0xBF, b"\0\0\0\0")
        for i in range(c, min(c + per_cluster, n), per_block):
            group = frames[i:min(i + per_block, c + per_cluster, n)]
            content += block(1, times[i] - base, group, lacing if len(group) > 1 else None,
                             key=i == 0, simple=not block_groups)
            if audio:
                content += block(2, times[i] - base, [bytes([0xFC, 0xFF, 0xFE]) * 7])
            if second_video is not None and i < len(second_video):
                content += block(3, times[i] - base, [second_video[i]])
        body += el(0x1F43B675, content, unknown=unknown_sizes)
    if extras:
        point = uint_el(0xB3, 0) + el(0xB7, uint_el(0xF7, 1) + uint_el(0xF1, 0))
        body += el(0x1C53BB6B, el(0xBB, point))
        body += el(0x1254C367, el(0x7373, el(0x63C0, b"") + el(0x67C8, str_el(0x45A3, "TITLE")
                                                            + str_el(0x4487, "test"))))
    data = ebml_header(doc_type, read_version) + el(0x18538067, body, unknown=unknown_sizes)
    with open(path, "wb") as f:
        f.write(data)
    return path


def other_codec_mkv(path: str, codec: str, doc_type: str = "matroska") -> str:
    """A Matroska file of three frames of ``codec`` (a codec the port does
    not decode: its frames are not read), its directory made."""
    import os

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    return write_mkv(path, [b"\x82\x49\x83\x42\x00\x10"] * 3, 64, 48, codec=codec,
                     doc_type=doc_type)


def vp9_mkv(path: str) -> str:
    """A Matroska / WebM file (by its extension) of a VP9 profile 1 (4:4:4)
    track, which the port refuses: three frames at 64x48, its directory
    made."""
    import os

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    packets, _ = vp9_packets(moving_scene(3, 64, 48, seed=2), {"profile": 1, "b": 200000},
                             pix_fmt="yuv444p")
    return write_mkv(path, packets, 64, 48, codec="V_VP9",
                     doc_type="webm" if path.endswith(".webm") else "matroska")


def yuv420(bgr: np.ndarray):
    """(Y, U, V) planes of a BGR frame of any size, chroma the rounded mean
    of each 2x2 (edges repeated)."""
    h, w = bgr.shape[:2]
    yuv = cv2.cvtColor(bgr, cv2.COLOR_BGR2YUV)
    p = np.pad(yuv, ((0, h & 1), (0, w & 1), (0, 0)), mode="edge").astype(np.uint16)
    c = ((p[0::2, 0::2] + p[1::2, 0::2] + p[0::2, 1::2] + p[1::2, 1::2] + 2) // 4).astype(np.uint8)
    return (np.ascontiguousarray(yuv[..., 0]), np.ascontiguousarray(c[..., 1]),
            np.ascontiguousarray(c[..., 2]))


def vp8_packets(frames, options: dict, two_pass: bool = False):
    """BGR ``frames`` through libavcodec's libvpx (VP8) encoder: (packets,
    each one's presentation time in frames; a hidden alt-ref frame takes
    the time of the frame shown after it).  With ``two_pass`` a first pass
    gathers the statistics the second needs for alt-ref frames
    (``auto-alt-ref``)."""
    h, w = frames[0].shape[:2]
    planes = [yuv420(f) for f in frames]
    lavc = Lavc()
    lavc.avutil.av_log_set_level(16)  # errors only: libvpx's queue warns of alt-ref timestamps
    if two_pass:
        lavc.encode(planes, w, h, {**options, "flags": "+pass1"}, encoder="libvpx")
        options = {**options, "flags": "+pass2"}
    packets = lavc.encode(planes, w, h, options, encoder="libvpx", stats=lavc.stats if two_pass
                          else b"")
    return packets, list(lavc.pts)


def vp9_packets(frames, options: dict, two_pass: bool = False, pix_fmt: str = "yuv420p"):
    """BGR ``frames`` through libavcodec's libvpx-vp9 encoder, as
    ``vp8_packets``: (packets, each one's presentation time in frames).  A
    packet is a frame or a superframe (hidden alt-ref frames before the one
    shown).  ``pix_fmt`` "yuv444p" (with ``profile`` 1) writes 4:4:4."""
    h, w = frames[0].shape[:2]
    if pix_fmt == "yuv444p":
        planes = [tuple(np.ascontiguousarray(p) for p in cv2.split(cv2.cvtColor(f, cv2.COLOR_BGR2YUV)))
                  for f in frames]
    else:
        planes = [yuv420(f) for f in frames]
    lavc = Lavc()
    lavc.avutil.av_log_set_level(16)
    if two_pass:
        lavc.encode(planes, w, h, {**options, "flags": "+pass1"}, encoder="libvpx-vp9",
                    pix_fmt=pix_fmt)
        options = {**options, "flags": "+pass2"}
    packets = lavc.encode(planes, w, h, options, encoder="libvpx-vp9",
                          stats=lavc.stats if two_pass else b"", pix_fmt=pix_fmt)
    return packets, list(lavc.pts)


def vp9_webm(path: str, frames, options: dict, two_pass: bool = False, **layout) -> str:
    """``frames`` encoded by ``vp9_packets`` into a WebM by ``write_mkv``,
    each sample at its presentation time (40 ms a frame)."""
    h, w = frames[0].shape[:2]
    packets, pts = vp9_packets(frames, options, two_pass)
    return write_mkv(path, packets, w, h, codec="V_VP9", times=[p * 40 for p in pts], **layout)


def vp8_webm(path: str, frames, options: dict, two_pass: bool = False, **layout) -> str:
    """``frames`` encoded by ``vp8_packets`` into a WebM by ``write_mkv``,
    each frame at its presentation time (40 ms a frame)."""
    h, w = frames[0].shape[:2]
    packets, pts = vp8_packets(frames, options, two_pass)
    return write_mkv(path, packets, w, h, times=[p * 40 for p in pts], **layout)
