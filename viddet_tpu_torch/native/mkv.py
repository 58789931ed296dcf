"""Matroska and WebM video, read without FFmpeg.

The counterpart of ``native/mp4.py`` for Matroska (``.mkv``) and WebM
(``.webm``) files: ``read_index`` walks the EBML tree and gives the first
video track's geometry, rate and each frame's place in the file;
``MkvReader`` hands out the frames and decodes them.

The walk reads the EBML header (DocType ``matroska`` or ``webm``, a
DocTypeReadVersion up to 4, EBML read version 1), then the first
``Segment``, of known size or of unknown size (to the end of the file).
In it: ``Info`` (``TimestampScale``), ``Tracks`` and every ``Cluster``,
again of known or unknown size: an element of unknown size ends where an
element of its parent's level begins, as a live writer (a browser's
MediaRecorder) leaves its clusters.  ``SeekHead``, ``Cues``, ``Tags``,
``Chapters``, ``Attachments``, ``Void`` and ``CRC-32`` are skipped.  The
track is the first ``TrackEntry`` of ``TrackType`` 1 (video), as OpenCV
takes the first video stream; its frames are the ``SimpleBlock``s and the
``BlockGroup`` / ``Block``s of its track number, each laced frame (Xiph,
EBML or fixed-size lacing) one frame.  Other tracks' blocks (the Opus or
Vorbis audio of a WebM) are skipped.

The codecs:

* ``V_VP8``: decoded by the port's VP8 decoder (``vp8.cpp``,
  ``native.Vp8Decoder``).  A frame with show_frame 0 (an alt-ref frame) is
  decoded and not shown, as FFmpeg shows it; ``frame_count`` counts the
  shown frames.
* ``V_VP9``: decoded by the port's VP9 decoder (``vp9.cpp``,
  ``native.Vp9Decoder``), profile 0 (8-bit 4:2:0).  A block is one sample:
  a frame, or a superframe of hidden frames and the one shown;
  ``frame_count`` counts the shown frames (a ``show_existing_frame`` one
  too).  ``check_vp9`` reads every frame's uncompressed header and refuses,
  before a frame is decoded, a track that does not start with a key frame,
  another profile and a change of frame size.
* ``V_MPEG4/ISO/AVC``: H.264, its ``CodecPrivate`` an avcC, decoded by the
  port's H.264 decoder (``h264.cpp``, ``native.H264Decoder``), I, P and B
  pictures, CAVLC or CABAC; ``native.mp4.check_h264`` reads the parameter
  sets and every frame's slice headers, refuses what the decoder does not
  decode before a frame is decoded, and gives the reorder depth FFmpeg's
  stream probe leaves.  With B-frames the blocks' timestamps are out of
  decoding order; the rate estimated from them takes their span, which
  does not depend on it.  The size is the SPS's, cropped as FFmpeg crops
  it.
* ``V_MPEG4/ISO/SP``, ``/ASP`` and ``/AP``: MPEG-4 Part 2, configured by the
  track's ``CodecPrivate`` (its VOS / VOL headers; without one, the
  headers at the head of the first frame), for ``native.Mpeg4Decoder``.
* ``V_MJPEG``: one JPEG a frame, for ``native.decode_jpeg``.
* ``V_MS/VFW/FOURCC``: the ``CodecPrivate`` BITMAPINFOHEADER's
  compression, read as ``native/avi.py`` reads it (MPEG-4 Part 2 fourccs
  with packed B-frames unpacked, Motion-JPEG).

Any other codec (AV1, HEVC, Theora, ...) raises ValueError
naming it: decoding it needs FFmpeg, which the port does not link.  So does
a ``ContentEncoding`` (compression, header stripping included, or
encryption), a track whose frames do not start with a key frame, a VP8
key frame whose size is not the track's or changes, an element that runs
past the end of its parent, a file cut inside its header, ``Info`` or
``Tracks``, and a file that is not Matroska.  All of it raises in
``read_index``, before a frame is decoded.

A file cut short (a recording whose writer stopped, or a download that
did) is read to its last whole block, as FFmpeg's demuxer reads it: a
segment or cluster of known size that the end of the file cuts, an
unknown-size cluster whose last block runs past it, or an element header
cut in two all end the walk there, and the frames are those of the blocks
before.

``frame_count`` is what OpenCV reports (``CAP_PROP_FRAME_COUNT``): the
segment's ``Duration`` (``Info``) times ``fps``, rounded, where there is
one, else the frames shown.  For a cut file it is the count before the
cut, as OpenCV's; the frames read are the whole ones.

``fps`` is what FFmpeg's demuxer (and so ``cv2.CAP_PROP_FPS``) reports:
with ``DefaultDuration``, 1e9 over it reduced as ``av_reduce`` reduces it
(to terms of at most 30000); without it, for H.264 with VUI timing info, one
over the packet duration FFmpeg's parser derives from it (``h264_fps``);
otherwise the frames' mean rate from their
timestamps, snapped as ``avformat_find_stream_info`` snaps an estimate to
a standard rate within 1% (ROADMAP Queue 3 holds where FFmpeg's estimate,
from the first frames only, differs).
"""

from __future__ import annotations

import dataclasses
import math
import mmap
import os
import struct
from typing import Iterator, List, Optional, Tuple

import numpy as np

from viddet_tpu_torch.native.avi import (BITMAPINFOHEADER, JPEG_FOURCCS, MPEG4_FOURCCS,
                                         unpack_bframes)
from viddet_tpu_torch.native.mp4 import VOP_START, check_decoder_config, check_h264, check_vops

EBML, SEGMENT, CLUSTER = 0x1A45DFA3, 0x18538067, 0x1F43B675
INFO, TRACKS, TRACK_ENTRY = 0x1549A966, 0x1654AE6B, 0xAE
SIMPLE_BLOCK, BLOCK_GROUP, BLOCK = 0xA3, 0xA0, 0xA1
CLUSTER_TIMESTAMP = 0xE7
# the elements a Segment holds: one of them ends a Cluster of unknown size
SEGMENT_CHILDREN = {0x114D9B74, INFO, TRACKS, CLUSTER, 0x1C53BB6B, 0x1941A469, 0x1043A770,
                    0x1254C367, 0xEC, 0xBF}
DOC_TYPES = ("matroska", "webm")
READ_VERSION = 4  # the highest DocTypeReadVersion read
MPEG4_CODECS = ("V_MPEG4/ISO/SP", "V_MPEG4/ISO/ASP", "V_MPEG4/ISO/AP")
# codecs the port does not decode, by name
REFUSED = {
    "V_AV1": "AV1", "V_MPEGH/ISO/HEVC": "HEVC",
    "V_THEORA": "Theora", "V_MPEG1": "MPEG-1 video", "V_MPEG2": "MPEG-2 video",
    "V_MS/VFW/FOURCC": "a VfW codec", "V_UNCOMPRESSED": "uncompressed video",
    "V_PRORES": "ProRes", "V_FFV1": "FFV1", "V_REAL/RV40": "RealVideo",
}
UNKNOWN = -1  # an element size of all ones


@dataclasses.dataclass
class MkvIndex:
    """What ``read_index`` finds: the video track's geometry, codec and
    rate, and each frame as (file offset, size) in decode order."""

    path: str
    width: int
    height: int
    codec: str  # "vp8", "vp9", "h264", "mpeg4" or "jpeg"
    config: bytes  # the MPEG-4 decoder configuration (VOS / VOL), H.264's avcC; b"" otherwise
    fps: float
    offsets: np.ndarray  # int64
    sizes: np.ndarray  # int64
    shown: int  # the frames shown that lie wholly in the file: VP8's hidden frames are not
    stated: int  # the frame count OpenCV reports: Duration x fps where Info has a Duration
    fourcc: str = ""  # a V_MS/VFW/FOURCC track's compression (FFmpeg's MPEG-4 decoder reads it)
    reorder: int = 0  # H.264: the reorder depth FFmpeg's decoder starts from (its stream probe's)

    @property
    def frame_count(self) -> int:
        return self.stated


def read_index(path: str) -> MkvIndex:
    """Walk the Matroska / WebM file at ``path``; see the module's
    docstring.  Raises ValueError for a file that is not one, has no video
    track, holds a codec or an encoding the port does not read, or whose
    frames do not lie inside the file."""
    path = str(path)
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        if size < 4:
            raise ValueError(f"{path}: not a Matroska / WebM file ({size} bytes)")
        with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as data:
            return _Walk(path, data, size).run()


def reduce_fraction(num: int, den: int, limit: int) -> Tuple[int, int]:
    """``av_reduce``: num / den as the nearest fraction whose terms are at
    most ``limit`` (continued fractions, the last step rounded as FFmpeg
    rounds it)."""
    g = math.gcd(num, den)
    if g:
        num, den = num // g, den // g
    a0, a1 = (0, 1), (1, 0)
    if num <= limit and den <= limit:
        return num, den
    while den:
        x = num // den
        next_den = num - den * x
        a2 = (x * a1[0] + a0[0], x * a1[1] + a0[1])
        if a2[0] > limit or a2[1] > limit:
            if a1[0]:
                x = (limit - a0[0]) // a1[0]
            if a1[1]:
                x = min(x, (limit - a0[1]) // a1[1])
            if den * (2 * x * a1[1] + a0[1]) > num * a1[1]:
                a1 = (x * a1[0] + a0[0], x * a1[1] + a0[1])
            break
        a0, a1 = a1, a2
        num, den = den, next_den
    return a1


def standard_rates() -> List[int]:
    """FFmpeg's ``get_std_framerate`` values, in units of 1 / (12 * 1001) Hz."""
    rates = [(i + 1) * 1001 for i in range(30 * 12)]
    rates += [(i + 31) * 1001 * 12 for i in range(30)]
    rates += [r * 1001 * 12 for r in (80, 120, 240)]
    rates += [r * 1000 * 12 for r in (24, 30, 60, 12, 15, 48)]
    return rates


def estimate_fps(timestamps_ns: np.ndarray) -> float:
    """The frames' mean rate (frames - 1 over the span of their
    timestamps), reduced to terms of at most 60000 and snapped to the
    nearest standard rate within 1%, as ``avformat_find_stream_info``
    rounds its estimate; 0 for fewer than two distinct timestamps."""
    if len(timestamps_ns) < 2:
        return 0.0
    span = int(timestamps_ns.max() - timestamps_ns.min())
    if span <= 0:
        return 0.0
    return snapped_rate((len(timestamps_ns) - 1) * 10**9, span)


def h264_fps(info: dict, scale: int) -> float:
    """The rate FFmpeg estimates for an H.264 track without
    DefaultDuration from its SPS timing (``H264Decoder.info``): its parser
    gives each packet a duration of 2 * num_units_in_tick / time_scale
    seconds, rounded down to ticks of ``scale`` ns (none when the frame rate
    reaches 1000, or the duration rounds to 0), and the rate is one over it,
    snapped as ``estimate_fps`` snaps; 0 without timing info."""
    tick, time_scale = info["num_units_in_tick"], info["time_scale"]
    if not tick or not time_scale or 2 * tick * 1000 <= time_scale:
        return 0.0
    duration = (10**9 * 2 * tick) // (time_scale * scale)
    if not duration:
        return 0.0
    return snapped_rate(10**9, duration * scale)


def snapped_rate(num: int, den: int) -> float:
    """num / den frames a second reduced to terms of at most 60000, then the
    nearest standard rate within 1% (``avformat_find_stream_info``)."""
    num, den = reduce_fraction(num, den, 60000)
    fps = num / den
    best, best_error = 0, 0.01
    for rate in standard_rates():
        error = abs(fps / (rate / (12 * 1001)) - 1)
        if error < best_error:
            best, best_error = rate, error
    if best:
        num, den = reduce_fraction(best, 12 * 1001, 2**31 - 1)
        fps = num / den
    return fps


def vp8_frame_size(data, offset: int, size: int) -> Optional[Tuple[int, int]]:
    """The (width, height) of a VP8 key frame, None for an inter frame or a
    frame too short to tell."""
    if size < 10 or data[offset] & 1:
        return None
    head = bytes(data[offset + 3 : offset + 10])
    if head[:3] != b"\x9d\x01\x2a":
        return (0, 0)
    w, h = struct.unpack_from("<HH", head, 3)
    return w & 0x3FFF, h & 0x3FFF


class _Bits:
    """Bits of a VP9 uncompressed header, most significant first."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def read(self, n: int = 1) -> int:
        v = 0
        for _ in range(n):
            if self.pos >= 8 * len(self.data):
                raise EOFError
            v = (v << 1) | (self.data[self.pos >> 3] >> (7 - (self.pos & 7))) & 1
            self.pos += 1
        return v


def vp9_superframe(data, offset: int, size: int) -> List[Tuple[int, int]]:
    """(offset, size) of the frames of the VP9 sample at data[offset:offset +
    size]: those a superframe index at its end lists (the marker byte
    0b110xxxxx at both ends of the index), else the sample itself."""
    marker = data[offset + size - 1] if size else 0
    if marker & 0xE0 == 0xC0:
        frames, mag = (marker & 7) + 1, ((marker >> 3) & 3) + 1
        index = 2 + mag * frames
        if size >= index and data[offset + size - index] == marker:
            out, at, p = [], offset, offset + size - index + 1
            for _ in range(frames):
                n = int.from_bytes(data[p : p + mag], "little")
                p += mag
                if n:
                    out.append((at, n))
                at += n
            return out
    return [(offset, size)]


VP9_SYNC = 0x498342


def vp9_header(frame: bytes):
    """(kind, shows, size) of a VP9 frame from its uncompressed header: kind
    "key", "intra-only", "inter" or "existing" (show_existing_frame); the
    size (width, height) where the header codes one.  Raises ValueError for
    a profile other than 0 and EOFError for a header cut short."""
    b = _Bits(frame)
    if b.read(2) != 2:
        raise EOFError  # not a frame marker: the decoder names it
    profile = b.read() | b.read() << 1
    if profile == 3:
        profile += b.read()
    if profile:
        raise ValueError(f"VP9 profile {profile} (a bit depth above 8 or chroma other than "
                         "4:2:0)")
    if b.read():
        return "existing", True, None
    key, show, error_res = b.read() == 0, b.read(), b.read()
    if key:
        if b.read(24) != VP9_SYNC:
            raise EOFError
        if b.read(3) == 7:  # sRGB colour: 4:4:4, never profile 0
            raise ValueError("a VP9 sRGB (4:4:4) frame")
        b.read()
        return "key", bool(show), (b.read(16) + 1, b.read(16) + 1)
    intra_only = b.read() if not show else 0
    if not error_res:
        b.read(2)
    if intra_only:
        if b.read(24) != VP9_SYNC:
            raise EOFError
        b.read(8)
        return "intra-only", bool(show), (b.read(16) + 1, b.read(16) + 1)
    b.read(8 + 3 * 4)
    for _ in range(3):
        if b.read():  # the size of a reference
            return "inter", bool(show), None
    return "inter", bool(show), (b.read(16) + 1, b.read(16) + 1)


def check_vp9(data, offsets: np.ndarray, sizes: np.ndarray, width: int, height: int,
              fail) -> Tuple[int, int, int]:
    """Refuse a VP9 track that does not start with a key frame, is not
    profile 0 (8-bit 4:2:0), or whose frame size is not the track's (when it
    states one) or changes (the sizes its headers code); returns (samples
    that show a frame, width, height)."""
    shown, size = 0, None
    for i, (offset, n) in enumerate(zip(offsets.tolist(), sizes.tolist())):
        sample_shows = False
        for at, length in vp9_superframe(data, offset, n):
            try:
                kind, show, coded = vp9_header(bytes(data[at : at + min(length, 64)]))
            except EOFError:
                if size is None:
                    fail(f"VP9 frame {i} at offset {offset} has a bad or truncated header")
                continue  # the decoder names it, after the frames before it
            except ValueError as e:
                fail(f"{e} in frame {i}, which the port does not decode; decoding it needs "
                     "FFmpeg, which the port does not link")
            if size is None and kind != "key":
                fail("the VP9 track does not start with a key frame")
            sample_shows |= show
            if coded is None:
                continue
            if size is None:
                size = coded
                if (width, height) not in ((0, 0), size):
                    fail(f"the VP9 frames are {size[0]}x{size[1]}, the track says "
                         f"{width}x{height}")
            elif coded != size:
                fail(f"VP9 frame {i} changes the frame size from {size[0]}x{size[1]} to "
                     f"{coded[0]}x{coded[1]}, which the port does not follow (FFmpeg does; "
                     "the port does not link it)")
        shown += sample_shows
    if size is None:
        fail("the VP9 track has no key frame")
    return shown, size[0], size[1]


@dataclasses.dataclass
class _Track:
    number: int = 0
    kind: int = 0
    codec_id: str = ""
    private: bytes = b""
    default_duration: int = 0
    width: int = 0
    height: int = 0
    encoded: bool = False


class _Walk:
    def __init__(self, path: str, data, size: int):
        self.path, self.data, self.size = path, data, size
        self.scale = 1_000_000  # TimestampScale, ns a tick
        self.duration = 0.0  # Info's Duration, in ticks; 0 without one
        self.cut = False  # the end of the file cut the walk short
        self.tracks: List[_Track] = []
        self.blocks: List[Tuple[int, int, int, int]] = []  # (track, block payload, end, time)

    def fail(self, what: str):
        raise ValueError(f"{self.path}: {what}")

    def vint(self, pos: int, end: int, what: str, is_id: bool = False) -> Tuple[int, int]:
        """An EBML variable-length integer at ``pos``: (value, length); a
        size of all ones is UNKNOWN; an ID keeps its marker bits."""
        if pos >= end:
            self.fail(f"{what} is truncated at offset {pos}")
        first = self.data[pos]
        length = 8 - first.bit_length() + 1 if first else 9
        if length > (4 if is_id else 8) or pos + length > end:
            self.fail(f"{what} at offset {pos} is malformed or truncated")
        raw = int.from_bytes(self.data[pos : pos + length], "big")
        if is_id:
            return raw, length
        value = raw & ((1 << (7 * length)) - 1)
        return (UNKNOWN if value == (1 << (7 * length)) - 1 else value), length

    def element(self, pos: int, end: int, where: str) -> Tuple[int, int, int]:
        """(id, payload start, payload size) of the element at ``pos``."""
        eid, n = self.vint(pos, end, f"an element ID in {where}", is_id=True)
        size, m = self.vint(pos + n, end, f"the size of element 0x{eid:X} in {where}")
        return eid, pos + n + m, size

    def children(self, start: int, end: int, where: str) -> Iterator[Tuple[int, int, int]]:
        """(id, payload start, payload end) of each element in [start, end),
        each of known size and inside its parent."""
        pos = start
        while pos < end:
            eid, body, size = self.element(pos, end, where)
            if size == UNKNOWN:
                self.fail(f"element 0x{eid:X} in {where} has an unknown size")
            if body + size > end:
                self.fail(f"element 0x{eid:X} in {where} is truncated (it ends at {body + size}, "
                          f"past {end})")
            yield eid, body, body + size
            pos = body + size

    def uint(self, start: int, end: int) -> int:
        return int.from_bytes(self.data[start:end], "big") if end > start else 0

    def string(self, start: int, end: int) -> str:
        return bytes(self.data[start:end]).split(b"\0", 1)[0].decode("latin-1")

    def run(self) -> MkvIndex:
        eid, body, size = self.element(0, self.size, "the file")
        if eid != EBML:
            self.fail("not a Matroska / WebM file (no EBML header)")
        if size == UNKNOWN or body + size > self.size:
            self.fail("the EBML header is truncated")
        self.header(body, body + size)
        pos = body + size
        while pos < self.size:
            eid, body, size = self.element(pos, self.size, "the file")
            end = self.size if size == UNKNOWN else body + size
            if eid == SEGMENT:
                self.cut = end > self.size  # a recording cut short: read what is whole
                self.segment(body, min(end, self.size))
                return self.index()
            if size == UNKNOWN or end > self.size:
                self.fail(f"top-level element 0x{eid:X} is truncated")
            pos = end
        self.fail("has no segment")

    def header(self, start: int, end: int) -> None:
        doc_type, read_version, ebml_read = "matroska", 1, 1
        for eid, s, e in self.children(start, end, "the EBML header"):
            if eid == 0x4282:
                doc_type = self.string(s, e)
            elif eid == 0x4285:
                read_version = self.uint(s, e)
            elif eid == 0x42F7:
                ebml_read = self.uint(s, e)
        if doc_type not in DOC_TYPES:
            self.fail(f"its DocType is {doc_type!r}, not Matroska or WebM")
        if ebml_read != 1 or read_version > READ_VERSION:
            self.fail(f"it needs a {doc_type} reader of version {read_version} (EBML read "
                      f"version {ebml_read}); the port reads versions up to {READ_VERSION}")

    def header_cut(self, pos: int) -> bool:
        """Whether the end of the file cuts the element header (ID and
        size) at ``pos`` in two."""
        first = self.data[pos]
        length = 8 - first.bit_length() + 1 if first else 9
        if length > 4 or pos + length >= self.size:
            return pos + min(length, 4) >= self.size
        size_first = self.data[pos + length]
        size_length = 8 - size_first.bit_length() + 1 if size_first else 9
        return pos + length + min(size_length, 8) > self.size

    def segment(self, start: int, end: int) -> None:
        pos = start
        while pos < end:
            if end == self.size and self.header_cut(pos):
                self.cut = True
                return
            eid, body, size = self.element(pos, end, "the segment")
            if eid in (EBML, SEGMENT):  # a second segment: the first is read
                return
            if size == UNKNOWN:
                if eid != CLUSTER:
                    self.fail(f"element 0x{eid:X} in the segment has an unknown size")
                pos = self.cluster(body, end, unknown=True)
                continue
            stop = body + size
            if stop > end:
                if stop > self.size and eid not in (INFO, TRACKS):  # cut by the end of the file
                    self.cut = True
                    if eid == CLUSTER:
                        self.cluster(body, self.size, unknown=False)
                    return
                what = "a cluster" if eid == CLUSTER else f"element 0x{eid:X}"
                self.fail(f"{what} at offset {pos} is truncated (it ends at {stop}, past {end})")
            if eid == INFO:
                for cid, s, e in self.children(body, stop, "Info"):
                    if cid == 0x2AD7B1:
                        self.scale = self.uint(s, e) or 1_000_000
                    elif cid == 0x4489 and e - s in (4, 8):
                        self.duration = struct.unpack_from(">f" if e - s == 4 else ">d",
                                                           self.data, s)[0]
            elif eid == TRACKS:
                for cid, s, e in self.children(body, stop, "Tracks"):
                    if cid == TRACK_ENTRY:
                        self.tracks.append(self.track(s, e))
            elif eid == CLUSTER:
                self.cluster(body, stop, unknown=False)
            pos = stop

    def track(self, start: int, end: int) -> _Track:
        t = _Track()
        for eid, s, e in self.children(start, end, "a TrackEntry"):
            if eid == 0xD7:
                t.number = self.uint(s, e)
            elif eid == 0x83:
                t.kind = self.uint(s, e)
            elif eid == 0x86:
                t.codec_id = self.string(s, e)
            elif eid == 0x63A2:
                t.private = bytes(self.data[s:e])
            elif eid == 0x23E383:
                t.default_duration = self.uint(s, e)
            elif eid == 0x6D80:  # ContentEncodings
                t.encoded = any(True for _ in self.children(s, e, "ContentEncodings"))
            elif eid == 0xE0:
                for vid, vs, ve in self.children(s, e, "Video"):
                    if vid == 0xB0:
                        t.width = self.uint(vs, ve)
                    elif vid == 0xBA:
                        t.height = self.uint(vs, ve)
        return t

    def cluster(self, start: int, end: int, unknown: bool) -> int:
        """Read a cluster's blocks; returns where it ends (for one of
        unknown size, at the first element of the segment's level)."""
        pos, time = start, 0
        while pos < end:
            if end == self.size and self.header_cut(pos):
                self.cut = True
                return end
            eid, body, size = self.element(pos, end, "a cluster")
            if unknown and (eid in SEGMENT_CHILDREN - {0xEC, 0xBF} or eid in (EBML, SEGMENT)):
                return pos
            if size == UNKNOWN:
                self.fail(f"element 0x{eid:X} in a cluster has an unknown size")
            stop = body + size
            if stop > self.size:  # cut by the end of the file: the blocks before are whole
                self.cut = True
                return self.size
            if stop > end:
                self.fail(f"element 0x{eid:X} at offset {pos} runs past the end of its cluster")
            if eid == CLUSTER_TIMESTAMP:
                time = self.uint(body, stop)
            elif eid == SIMPLE_BLOCK:
                self.block(body, stop, time)
            elif eid == BLOCK_GROUP:
                for gid, s, e in self.children(body, stop, "a BlockGroup"):
                    if gid == BLOCK:
                        self.block(s, e, time)
            pos = stop
        return end

    def block(self, start: int, end: int, cluster_time: int) -> None:
        track, n = self.vint(start, end, "a block's track number")
        if start + n + 3 > end:
            self.fail(f"the block at offset {start} is truncated")
        (relative,) = struct.unpack_from(">h", self.data, start + n)
        self.blocks.append((track, start + n, end, (cluster_time + relative) * self.scale))

    def laced(self, start: int, end: int) -> List[Tuple[int, int]]:
        """The (offset, size) of each frame of a block whose timecode and
        flags start at ``start``."""
        flags = self.data[start + 2]
        pos, lacing = start + 3, (flags >> 1) & 3
        if not lacing:
            return [(pos, end - pos)]
        if pos >= end:
            self.fail(f"the laced block at offset {start} is truncated")
        count = self.data[pos] + 1
        pos += 1
        sizes: List[int] = []
        if lacing == 1:  # Xiph: each size a run of 255s and a last byte
            for _ in range(count - 1):
                n = 0
                while True:
                    if pos >= end:
                        self.fail(f"the Xiph lacing of the block at offset {start} is truncated")
                    b = self.data[pos]
                    pos += 1
                    n += b
                    if b < 255:
                        break
                sizes.append(n)
        elif lacing == 3:  # EBML: the first size, then signed differences
            if count > 1:
                n, k = self.vint(pos, end, "an EBML lace size")
                pos += k
                sizes.append(n)
                for _ in range(count - 2):
                    d, k = self.vint(pos, end, "an EBML lace size")
                    d -= (1 << (7 * k - 1)) - 1
                    pos += k
                    n += d
                    sizes.append(n)
        else:  # fixed size
            if (end - pos) % count:
                self.fail(f"the fixed-size lacing of the block at offset {start} does not divide "
                          f"its {end - pos} bytes into {count} frames")
            sizes = [(end - pos) // count] * (count - 1)
        last = end - pos - sum(sizes)
        if any(s < 0 for s in sizes) or last < 0:
            self.fail(f"the lace sizes of the block at offset {start} run past its end")
        frames = []
        for s in sizes + [last]:
            frames.append((pos, s))
            pos += s
        return frames

    def index(self) -> MkvIndex:
        video = next((t for t in self.tracks if t.kind == 1), None)
        if video is None:
            self.fail("has no video track")
        if video.encoded:
            self.fail(f"the video track has a ContentEncoding (compression, header stripping or "
                      f"encryption), which the port does not read")
        codec, config, fourcc = self.codec(video)
        frames, times = [], []
        for track, start, end, time in self.blocks:
            if track == video.number:
                for frame in self.laced(start, end):
                    frames.append(frame)
                    times.append(time)
        if not frames:
            self.fail("the video track has no frames")
        width, height = video.width, video.height
        shown = len(frames)
        if codec == "mpeg4":
            if fourcc:
                frames = unpack_bframes(self.data, frames)
            if not config:  # the headers before the first frame's VOP
                offset, size = frames[0]
                at = self.data.find(VOP_START, offset, offset + size)
                config = bytes(self.data[offset:at if at >= 0 else offset + size])
            shown = len(frames)
        offsets = np.array([o for o, _ in frames], np.int64)
        sizes = np.array([s for _, s in frames], np.int64)
        if codec == "mpeg4":
            check_vops(self.data, offsets, sizes, self.fail)
        elif codec == "vp8":
            shown, width, height = self.check_vp8(offsets, sizes, width, height)
        elif codec == "vp9":
            shown, width, height = check_vp9(self.data, offsets, sizes, width, height, self.fail)
        reorder = 0
        if codec == "h264":
            width, height, info, reorder = check_h264(self.data, offsets, sizes, config,
                                                      self.path, self.fail)
        if video.default_duration:
            num, den = reduce_fraction(10**9, video.default_duration, 30000)
            fps = num / den
        else:
            fps = h264_fps(info, self.scale) if codec == "h264" else 0.0
            fps = fps or estimate_fps(np.array(times, np.int64))
        stated = shown
        if self.duration > 0 and fps > 0:  # OpenCV: floor(seconds * fps + 0.5), whole µs
            seconds = int(self.duration * self.scale / 1000) / 1e6
            stated = int(math.floor(seconds * fps + 0.5)) or shown
        return MkvIndex(self.path, width, height, codec, config, fps, offsets, sizes, shown,
                        stated, fourcc, reorder)

    def codec(self, track: _Track) -> Tuple[str, bytes, str]:
        """(codec, decoder configuration, VfW fourcc or "") of the track."""
        cid = track.codec_id
        if cid == "V_VP8":
            return "vp8", b"", ""
        if cid == "V_VP9":
            return "vp9", b"", ""
        if cid == "V_MPEG4/ISO/AVC":
            if not track.private:
                self.fail("the H.264 track has no CodecPrivate (its avcC decoder configuration)")
            return "h264", track.private, ""
        if cid in MPEG4_CODECS:
            return "mpeg4", track.private, ""
        if cid == "V_MJPEG":
            return "jpeg", b"", ""
        if cid == "V_MS/VFW/FOURCC" and len(track.private) >= BITMAPINFOHEADER:
            fourcc = track.private[16:20].decode("latin-1")
            if fourcc.upper() in MPEG4_FOURCCS:
                return "mpeg4", track.private[BITMAPINFOHEADER:], fourcc
            if fourcc.upper() in JPEG_FOURCCS:
                return "jpeg", b"", fourcc
            self.fail(f"the video track is {cid} with the fourcc {fourcc!r}, which the port does "
                      "not decode; decoding it needs FFmpeg, which the port does not link")
        name = REFUSED.get(cid, "a codec the port does not read")
        self.fail(f"the video track's codec is {cid!r} ({name}); decoding it needs FFmpeg, which "
                  "the port does not link (it reads H.264, VP8, VP9, MPEG-4 Part 2 and "
                  "Motion-JPEG)")

    def check_vp8(self, offsets: np.ndarray, sizes: np.ndarray, width: int,
                  height: int) -> Tuple[int, int, int]:
        """Refuse a VP8 track that does not start with a key frame or whose
        key frames' size is not the track's (or changes); returns (frames
        shown, width, height)."""
        shown, size = 0, None
        for i, (offset, n) in enumerate(zip(offsets.tolist(), sizes.tolist())):
            if n < 3:
                self.fail(f"VP8 frame {i} at offset {offset} is {n} bytes, shorter than its tag")
            shown += (self.data[offset] >> 4) & 1
            key = vp8_frame_size(self.data, offset, n)
            if i == 0 and key is None:
                self.fail("the VP8 track does not start with a key frame")
            if key is None:
                continue
            if 0 in key:
                self.fail(f"VP8 key frame {i} at offset {offset} has a bad header or size {key}")
            if size is None:
                size = key
                if (width, height) not in ((0, 0), key):
                    self.fail(f"the VP8 key frames are {key[0]}x{key[1]}, the track says "
                              f"{width}x{height}")
            elif key != size:
                self.fail(f"VP8 key frame {i} changes the frame size from {size[0]}x{size[1]} "
                          f"to {key[0]}x{key[1]}, which the port does not follow")
        return shown, size[0], size[1]


class MkvReader:
    """The video frames of a Matroska / WebM file, by index, and their
    pictures decoded in order (``frames``)."""

    def __init__(self, path: str):
        self.index = read_index(path)
        if self.index.codec == "mpeg4":  # the VOL's refusals, before any frame is decoded
            check_decoder_config(self.index)
        self._file = open(path, "rb")

    def __len__(self) -> int:
        return self.index.shown

    def sample(self, i: int) -> bytes:
        self._file.seek(int(self.index.offsets[i]))
        return self._file.read(int(self.index.sizes[i]))

    def frames(self, every: int = 1) -> Iterator[Tuple[int, np.ndarray]]:
        """(index, RGB frame) of every ``every``-th shown frame in display
        order.  VP8, VP9, H.264 and MPEG-4 streams are decoded whole, each inter
        frame needing the ones before it; a JPEG frame skipped by ``every``
        is not decoded."""
        from viddet_tpu_torch.native import (decode_jpeg, h264_frames, mpeg4_frames, vp8_frames,
                                             vp9_frames)

        index = self.index
        samples = (self.sample(i) for i in range(len(index.offsets)))
        if index.codec == "jpeg":
            for i in range(0, len(index.offsets), every):
                yield i, decode_jpeg(self.sample(i), f"{index.path} frame {i}")
        elif index.codec == "mpeg4":
            yield from mpeg4_frames(index.config, samples, index.path, every, index.fourcc)
        elif index.codec == "vp9":
            yield from vp9_frames(samples, index.path, every)
        elif index.codec == "h264":
            yield from h264_frames(index.config, samples, index.path, every, index.reorder)
        else:
            yield from vp8_frames(samples, index.path, every)

    def close(self) -> None:
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
