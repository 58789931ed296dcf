"""MP4 and QuickTime video, read without FFmpeg.

The counterpart of ``native/avi.py`` for ISO base media files (``.mp4``)
and QuickTime movies (``.mov``): ``read_index`` walks the box tree and
gives the first video track's geometry, rate and each sample's place in
the file; ``Mp4Reader`` hands out the samples and decodes them.

The walk takes the top-level boxes in any order (``moov`` before or
after ``mdat``), 64-bit box sizes and a size of 0 ("to the end of the
file").  In ``moov`` it reads ``mvhd``, then each ``trak`` (``tkhd``,
``edts`` / ``elst``, ``mdia`` with ``mdhd``, ``hdlr`` and ``minf`` /
``stbl``) and takes the first track whose handler is ``vide``.  From
``stbl`` it reads ``stsd`` (the sample entry), ``stts``, ``ctts``
(versions 0 and 1), ``stsc``, ``stsz`` or ``stz2``, ``stco`` or ``co64``
and ``stss``.

These sample entries are read:

* ``mp4v`` whose ``esds`` decoder configuration has object type 0x20:
  MPEG-4 Part 2 video, decoded by the port's own decoder in
  ``codec.cpp`` (``native.Mpeg4Decoder``).  The configuration is the
  ``DecoderSpecificInfo`` bytes (the VOS, VO and VOL headers).  Each
  sample is one VOP, in decode order.  With B-VOPs, display order differs:
  the decoder holds each I- or P-VOP's picture until the next one arrives
  and shows a B-VOP's at once, so frame ``k`` is the ``k``-th picture it
  shows (``ctts`` gives the same order; it is read for the edit list).
* ``jpeg``: one baseline JPEG per sample, for ``native.decode_jpeg``.
* ``avc1`` and ``avc3`` with their ``avcC`` configuration (its NAL length
  size and parameter sets; ``avc3`` may send them in band too): H.264,
  decoded by the port's H.264 decoder (``h264.cpp``, ``native.H264Decoder``):
  I, P and B pictures, CAVLC or CABAC, progressive 8-bit 4:2:0.
  ``check_h264`` reads the parameter sets and every sample's slice headers
  and refuses what that decoder does not decode (SP / SI slices, interlace,
  ...) before a frame is decoded.  With B-frames, ``ctts`` gives each sample
  a composition offset: FFmpeg's demuxer starts the decoder's reorder depth
  at the largest number of earlier samples any sample is shown before
  (``composition_delay``, as ``mov_estimate_video_delay``), and its stream
  probe may raise it (``check_h264``).  The size is the SPS's, cropped as
  FFmpeg crops it, which is what OpenCV reports.
* ``vp09`` with its ``vpcC`` configuration: VP9, decoded by the port's VP9
  decoder (``vp9.cpp``, ``native.Vp9Decoder``).  Profile 0 (8-bit 4:2:0) is
  read; the ``vpcC`` box's profile, bit depth and chroma subsampling and
  each frame's uncompressed header (``native.mkv.check_vp9``) refuse the
  rest before a frame is decoded.  A sample is a frame or a superframe.

Any other codec raises ValueError naming it (HEVC, AV1 and the rest need
FFmpeg, which the port does not link), as does an edit
list other than the identity or the shift an MP4 muxer writes with
B-frames (one entry, rate 1, whose media time is the first sample's
composition offset), an S-VOP or a stream that does not start with an
I-VOP, a sample table that does not add up, and a file cut before or
inside its ``moov``.  All of it raises in ``read_index``, before a frame
is decoded.

A file cut inside its ``mdat`` (``moov`` first, as a recorder that
reserves it writes, and the end lost) is read to its last whole sample:
the samples that run past the end of the file are dropped from the index,
as FFmpeg's demuxer drops them.  ``frame_count`` is still the sample
table's count, which OpenCV reports (``CAP_PROP_FRAME_COUNT``); ``shown``
is the frames that can be read.  Where the cut falls inside a sample,
FFmpeg decodes that sample's head and shows a concealed picture; the port
ends before it (ROADMAP Queue 3).

``fps`` is what FFmpeg's demuxer (and so ``cv2.CAP_PROP_FPS``) reports:
the media timescale times the number of samples in ``stts`` over the sum
of their durations; for a constant rate, the timescale over the one
delta.
"""

from __future__ import annotations

import dataclasses
import mmap
import os
import struct
from typing import Iterator, List, Optional, Tuple

import numpy as np

MPEG4_VISUAL = 0x20  # objectTypeIndication of MPEG-4 Part 2 video
# sample entries that need a decoder the port does not have, by name
REFUSED = {
    b"hvc1": "HEVC (hvc1)", b"hev1": "HEVC (hev1)", b"av01": "AV1 (av01)",
    b"mjpa": "Motion-JPEG format A (mjpa)", b"mjpb": "Motion-JPEG format B (mjpb)",
}
VOP_START = b"\x00\x00\x01\xb6"
VOP_TYPES = "IPBS"  # vop_coding_type 0..3


@dataclasses.dataclass
class Mp4Index:
    """What ``read_index`` finds: the video track's geometry, codec and
    rate, and each sample as (file offset, size) in decode order."""

    path: str
    width: int
    height: int
    codec: str  # "mpeg4", "vp9", "h264" or "jpeg"
    config: bytes  # the MPEG-4 decoder configuration (VOS / VO / VOL), H.264's avcC; else b""
    fps: float
    offsets: np.ndarray  # int64, the samples that lie wholly in the file
    sizes: np.ndarray  # int64
    keyframes: Optional[np.ndarray]  # sample numbers from stss (0-based); None: every sample
    stated: int  # the sample table's count, which OpenCV reports for a cut file too
    fourcc: str = ""  # "mp4v" for MPEG-4 Part 2 (the codec tag FFmpeg's decoder reads)
    reorder: int = 0  # H.264: the reorder depth FFmpeg's decoder starts from

    @property
    def frame_count(self) -> int:
        return self.stated

    @property
    def shown(self) -> int:
        """The frames that can be read."""
        return len(self.offsets)


def read_index(path: str) -> Mp4Index:
    """Walk the MP4 / QuickTime file at ``path``; see the module's
    docstring.  Raises ValueError for a file that is not one, has no video
    track, holds a codec or an edit list the port does not read, or whose
    samples do not lie inside the file."""
    path = str(path)
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        if size < 8:
            raise ValueError(f"{path}: not an MP4 / QuickTime file ({size} bytes)")
        with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as data:
            return _Walk(path, data, size).run()


def check_vops(data, offsets: np.ndarray, sizes: np.ndarray, fail) -> None:
    """Refuse, before anything is decoded, an MPEG-4 stream with a sample
    that holds no VOP or an S-VOP, or whose first VOP is not an I-VOP:
    ``fail(message)`` raises."""
    for i, (offset, size) in enumerate(zip(offsets.tolist(), sizes.tolist())):
        at = data.find(VOP_START, offset, offset + size)
        if at < 0 or at + 4 >= offset + size:
            fail(f"frame {i} at offset {offset} holds no VOP")
        kind = data[at + 4] >> 6
        if kind == 3:
            fail(f"frame {i} at offset {offset} is an S-VOP (sprite / global motion "
                 "compensation), which the port's MPEG-4 decoder does not decode")
        if i == 0 and kind != 0:
            fail(f"frame 0 at offset {offset} is a {VOP_TYPES[kind]}-VOP: the stream does not "
                 "start with an I-VOP")


def check_h264(data, offsets: np.ndarray, sizes: np.ndarray, config: bytes, path: str,
               fail, reorder: int = 0) -> Tuple[int, int, dict, int]:
    """Read the parameter sets of ``config`` (an avcC; for Annex B samples,
    parameter sets with start codes or b"") and every sample's parameter sets
    and slice headers without decoding a macroblock: what the port's H.264
    decoder refuses (SP / SI slices, interlace, FMO, a change of size, ...)
    raises here, before any frame is decoded, as does a sample holding no
    picture.  Returns the pictures' width and height as FFmpeg crops them,
    the SPS's VUI (``H264Decoder.info``) and the reorder depth FFmpeg's
    decoder starts from: ``reorder`` (the container's), raised as
    ``avformat_find_stream_info``'s decoding of the first pictures raises
    it."""
    from viddet_tpu_torch.native import H264Decoder

    probe = H264Decoder(config, path, reorder)
    view = np.frombuffer(data, np.uint8)
    try:
        base = view.ctypes.data
        for i, (offset, size) in enumerate(zip(offsets.tolist(), sizes.tolist())):
            if not probe.probe(base + offset, size, f"{path} frame {i}"):
                fail(f"frame {i} at offset {offset} holds no H.264 picture (parameter sets or "
                     "SEI alone)")
        width, height = probe.size
        return width, height, probe.info, probe.probed_reorder
    finally:
        del view
        probe.close()


def check_decoder_config(index) -> None:
    """Open and close a decoder on ``index.config`` (an ``Mp4Index`` or an
    AVI's index): a VOL feature the decoder does not have raises
    ValueError here, as does a VOL whose size is not the container's."""
    from viddet_tpu_torch.native import Mpeg4Decoder

    decoder = Mpeg4Decoder(index.config, index.path, index.fourcc)
    decoder.close()
    if (decoder.width, decoder.height) != (index.width, index.height):
        raise ValueError(f"{index.path}: the video object layer is {decoder.width}x"
                         f"{decoder.height}, the container says {index.width}x{index.height}")


def _descriptor(data: bytes, pos: int) -> Tuple[int, int, int]:
    """An MPEG-4 descriptor's (tag, payload start, payload end); its size
    takes up to four bytes of seven bits each."""
    tag, pos, length = data[pos], pos + 1, 0
    for _ in range(4):
        b = data[pos]
        pos += 1
        length = (length << 7) | (b & 0x7F)
        if not b & 0x80:
            break
    return tag, pos, pos + length


class _Walk:
    def __init__(self, path: str, data, size: int):
        self.path, self.data, self.size = path, data, size

    def fail(self, what: str):
        raise ValueError(f"{self.path}: {what}")

    def boxes(self, pos: int, end: int, where: str) -> Iterator[Tuple[bytes, int, int]]:
        """(type, payload start, payload end) of each box in [pos, end)."""
        while pos + 8 <= end:
            length, kind = struct.unpack_from(">I4s", self.data, pos)
            head = 8
            if length == 1:
                if pos + 16 > end:
                    self.fail(f"box {kind!r} in {where} is truncated")
                (length,) = struct.unpack_from(">Q", self.data, pos + 8)
                head = 16
            elif length == 0:  # to the end of the enclosing box (the file, at the top)
                length = end - pos
            if length < head:
                self.fail(f"box {kind!r} in {where} has a bad size {length}")
            stop = pos + length
            if stop > end:
                if where != "the file" or kind != b"mdat":
                    self.fail(f"box '{kind.decode('latin-1')}' in {where} is truncated "
                              f"(it ends at {stop}, past {end})")
                stop = end  # a cut mdat: its samples are checked one by one
            yield kind, pos + head, stop
            pos = stop

    def child(self, start: int, end: int, kind: bytes, where: str) -> Tuple[int, int]:
        for k, s, e in self.boxes(start, end, where):
            if k == kind:
                return s, e
        self.fail(f"{where} has no {kind.decode('latin-1')!r} box")

    def full(self, start: int, end: int, need: int, kind: str) -> int:
        """A full box's version, after checking it holds ``need`` bytes."""
        if end - start < need:
            self.fail(f"box {kind!r} is truncated ({end - start} bytes)")
        return self.data[start]

    def run(self) -> Mp4Index:
        moov = None
        for kind, start, end in self.boxes(0, self.size, "the file"):
            if kind == b"moov" and moov is None:
                moov = (start, end)
        if moov is None:
            self.fail("not an MP4 / QuickTime file with a movie header (no 'moov' box)")
        movie_scale = 0
        for kind, start, end in self.boxes(*moov, "moov"):
            if kind == b"mvhd":
                version = self.full(start, end, 24, "mvhd")
                movie_scale = struct.unpack_from(">I", self.data, start + (20 if version else 12))[0]
            elif kind == b"trak":
                track = self.track(start, end, movie_scale)
                if track is not None:
                    return track
        self.fail("has no video track")

    def track(self, start: int, end: int, movie_scale: int) -> Optional[Mp4Index]:
        mdia = self.child(start, end, b"mdia", "trak")
        hdlr = self.child(*mdia, b"hdlr", "mdia")
        self.full(*hdlr, 12, "hdlr")
        if self.data[hdlr[0] + 8 : hdlr[0] + 12] != b"vide":
            return None
        mdhd = self.child(*mdia, b"mdhd", "mdia")
        version = self.full(*mdhd, 24, "mdhd")
        timescale, media_duration = struct.unpack_from(
            ">IQ" if version else ">II", self.data, mdhd[0] + (20 if version else 12))
        if not timescale:
            self.fail("the video track's 'mdhd' has a timescale of 0")
        minf = self.child(*mdia, b"minf", "mdia")
        stbl = self.child(*minf, b"stbl", "minf")
        tables = {k: (s, e) for k, s, e in self.boxes(*stbl, "stbl")}
        if b"stsd" not in tables:
            self.fail("the video track has no sample description ('stsd')")
        width, height, codec, config = self.sample_entry(*tables[b"stsd"])
        sizes = self.sample_sizes(tables)
        offsets = self.sample_offsets(tables, sizes)
        count, duration = self.time_to_sample(tables)
        fps = timescale * count / duration if duration else 0.0
        first_offset = self.first_composition_offset(tables)
        for kind, s, e in self.boxes(start, end, "trak"):
            if kind == b"edts":
                self.edit_list(s, e, movie_scale, timescale, media_duration, first_offset)
        stated = len(offsets)
        bad = np.nonzero(offsets + sizes > self.size)[0]
        if len(bad):  # a cut mdat: the samples before the first cut one
            if not bad[0]:
                self.fail(f"frame 0 at offset {int(offsets[0])} ({int(sizes[0])} bytes) runs past "
                          f"the end of the file ({self.size} bytes): the 'mdat' box is truncated "
                          "before its first whole frame")
            offsets, sizes = offsets[: int(bad[0])], sizes[: int(bad[0])]
        reorder = 0
        if codec == "mpeg4":
            check_vops(self.data, offsets, sizes, self.fail)
        elif codec == "h264":
            width, height, _, reorder = check_h264(self.data, offsets, sizes, config, self.path,
                                                   self.fail, self.composition_delay(tables))
        elif codec == "vp9":
            from viddet_tpu_torch.native.mkv import check_vp9

            check_vp9(self.data, offsets, sizes, width, height, self.fail)
        keyframes = None
        if b"stss" in tables:
            s, e = tables[b"stss"]
            self.full(s, e, 8, "stss")
            (n,) = struct.unpack_from(">I", self.data, s + 4)
            if 8 + 4 * n > e - s:
                self.fail("box 'stss' is truncated")
            keyframes = np.frombuffer(self.data, ">u4", n, s + 8).astype(np.int64) - 1
        return Mp4Index(self.path, width, height, codec, config, fps, offsets, sizes, keyframes,
                        stated, "mp4v" if codec == "mpeg4" else "", reorder)

    def edit_list(self, start: int, end: int, movie_scale: int, timescale: int,
                  media_duration: int, first_offset: int) -> None:
        """Accept no edit list, or one entry of rate 1 covering the media to
        within one movie tick whose media time is the first sample's
        composition offset: 0, the identity, without ``ctts``; with it, the
        shift an MP4 muxer writes for B-frames, so that the first picture
        shown starts the movie."""
        for kind, s, e in self.boxes(start, end, "edts"):
            if kind != b"elst":
                continue
            version = self.full(s, e, 8, "elst")
            (n,) = struct.unpack_from(">I", self.data, s + 4)
            form, step = (">QqhH", 20) if version else (">IihH", 12)
            if 8 + n * step > e - s:
                self.fail("box 'elst' is truncated")
            entries = [struct.unpack_from(form, self.data, s + 8 + i * step) for i in range(n)]
            if not entries:
                continue
            seg, media_time, rate, frac = entries[0]
            short = (movie_scale and
                     (seg + 1) * timescale < media_duration * movie_scale)
            if (len(entries) != 1 or media_time != first_offset or (rate, frac) != (1, 0)
                    or short):
                self.fail(f"the video track has an edit list the port does not apply "
                          f"({n} entries, first: duration {seg}, media time {media_time}, "
                          f"rate {rate + frac / 65536:g}); only the identity edit or the shift by "
                          f"the first composition offset ({first_offset}) is read")

    def composition_delay(self, tables) -> int:
        """FFmpeg's mov_estimate_video_delay for an H.264 track with ``ctts``:
        the most samples, among the 16 before, that a sample is shown
        before (its composition time, decode time plus offset, below theirs);
        0 without ``ctts``."""
        if b"ctts" not in tables:
            return 0
        s, e = tables[b"ctts"]
        self.full(s, e, 8, "ctts")
        (n,) = struct.unpack_from(">I", self.data, s + 4)
        if 8 + 8 * n > e - s:
            self.fail("box 'ctts' is truncated")
        runs = np.frombuffer(self.data, ">i4", 2 * n, s + 8).reshape(n, 2).astype(np.int64)
        offsets = np.repeat(runs[:, 1], np.maximum(runs[:, 0], 0))
        st, et = tables[b"stts"]
        (m,) = struct.unpack_from(">I", self.data, st + 4)
        deltas = np.frombuffer(self.data, ">u4", 2 * m, st + 8).reshape(m, 2).astype(np.int64)
        dts = np.concatenate([[0], np.cumsum(np.repeat(deltas[:, 1], deltas[:, 0]))])
        count = min(len(offsets), len(dts))
        pts = (dts[:count] + offsets[:count]).tolist()
        window: List[int] = []
        delay = 0
        for t in pts:  # FFmpeg's buffer of the last 17 times, kept sorted by swaps
            window.append(t)
            del window[:-17]
            j = len(window) - 1
            while j > 0 and window[j] < window[j - 1]:
                window[j], window[j - 1] = window[j - 1], window[j]
                j -= 1
            delay = max(delay, len(window) - 1 - j)
        return delay

    def first_composition_offset(self, tables) -> int:
        """The first sample's composition offset from ``ctts`` (version 0
        or 1; 0 without one)."""
        if b"ctts" not in tables:
            return 0
        s, e = tables[b"ctts"]
        version = self.full(s, e, 8, "ctts")
        (n,) = struct.unpack_from(">I", self.data, s + 4)
        if 8 + 8 * n > e - s:
            self.fail("box 'ctts' is truncated")
        if not n:
            return 0
        return struct.unpack_from(">i" if version else ">I", self.data, s + 12)[0]

    def sample_entry(self, start: int, end: int) -> Tuple[int, int, str, bytes]:
        self.full(start, end, 16, "stsd")
        (n,) = struct.unpack_from(">I", self.data, start + 4)
        if n < 1:
            self.fail("the video track's 'stsd' holds no sample entry")
        pos = start + 8
        length, kind = struct.unpack_from(">I4s", self.data, pos)
        if length < 86 or pos + length > end:
            self.fail(f"the video sample entry {kind!r} is truncated")
        width, height = struct.unpack_from(">HH", self.data, pos + 32)
        name = kind.decode("latin-1")
        if kind == b"jpeg":
            return width, height, "jpeg", b""
        if kind == b"vp09":
            self.vp9_config(*self.child(pos + 86, pos + length, b"vpcC", "the 'vp09' sample entry"))
            return width, height, "vp9", b""
        if kind in (b"avc1", b"avc3"):
            start, stop = self.child(pos + 86, pos + length, b"avcC",
                                     f"the {name!r} sample entry")
            return width, height, "h264", bytes(self.data[start:stop])
        if kind in REFUSED:
            self.fail(f"the video is {REFUSED[kind]}; decoding it needs FFmpeg, which the port "
                      "does not link (it reads H.264, MPEG-4 Part 2, VP9 and Motion-JPEG)")
        if kind != b"mp4v":
            self.fail(f"the video codec {name!r} is not one the port reads; decoding it needs "
                      "FFmpeg, which the port does not link (it reads H.264, MPEG-4 Part 2, VP9 "
                      "and Motion-JPEG)")
        esds = self.child(pos + 86, pos + length, b"esds", "the 'mp4v' sample entry")
        object_type, config = self.decoder_config(*esds)
        if object_type != MPEG4_VISUAL:
            self.fail(f"the 'mp4v' track's object type is 0x{object_type:02x}, not MPEG-4 Part 2 "
                      f"video (0x{MPEG4_VISUAL:02x}); decoding it needs FFmpeg, which the port "
                      "does not link")
        return width, height, "mpeg4", config

    def vp9_config(self, start: int, end: int) -> None:
        """Refuse a ``vpcC`` (VP codec configuration) of another profile than
        0, a bit depth other than 8 or chroma other than 4:2:0."""
        version = self.full(start, end, 8, "vpcC")
        profile, _level, packed = struct.unpack_from(">BBB", self.data, start + 4)
        depth = packed >> 4
        # version 1: depth (4 bits), chroma (3), full range (1); version 0:
        # depth and colour space (4 bits each), then chroma (4 bits)
        chroma = (packed >> 1) & 7 if version else self.data[start + 7] >> 4
        if profile != 0 or depth != 8 or chroma > 1:
            self.fail(f"the video is VP9 profile {profile}, {depth}-bit, chroma subsampling "
                      f"{chroma} (4:2:0 is 0 or 1); the port decodes profile 0 (8-bit 4:2:0) "
                      "only: decoding it needs FFmpeg, which the port does not link")

    def decoder_config(self, start: int, end: int) -> Tuple[int, bytes]:
        """(objectTypeIndication, DecoderSpecificInfo bytes) of an ``esds``."""
        data = bytes(self.data[start + 4 : end])  # past version and flags
        try:
            tag, pos, stop = _descriptor(data, 0)
            if tag != 0x03:
                self.fail(f"'esds' does not start with an ES descriptor (tag {tag})")
            flags = data[pos + 2]
            pos += 3
            if flags & 0x80:  # streamDependenceFlag
                pos += 2
            if flags & 0x40:  # URL_Flag
                pos += 1 + data[pos]
            if flags & 0x20:  # OCRstreamFlag
                pos += 2
            tag, pos, stop = _descriptor(data, pos)
            if tag != 0x04:
                self.fail(f"'esds' has no decoder configuration descriptor (tag {tag})")
            object_type = data[pos]
            pos += 13
            config = b""
            while pos < stop:
                tag, body, pos = _descriptor(data, pos)
                if pos > len(data):
                    raise IndexError
                if tag == 0x05:
                    config = data[body:pos]
        except IndexError:
            self.fail("box 'esds' is truncated")
        return object_type, config

    def sample_sizes(self, tables) -> np.ndarray:
        if b"stsz" in tables:
            s, e = tables[b"stsz"]
            self.full(s, e, 12, "stsz")
            fixed, n = struct.unpack_from(">II", self.data, s + 4)
            if fixed:
                return np.full(n, fixed, np.int64)
            if 12 + 4 * n > e - s:
                self.fail(f"box 'stsz' is truncated ({n} samples in {e - s} bytes)")
            return np.frombuffer(self.data, ">u4", n, s + 12).astype(np.int64)
        if b"stz2" in tables:
            s, e = tables[b"stz2"]
            self.full(s, e, 12, "stz2")
            bits = self.data[s + 7]
            (n,) = struct.unpack_from(">I", self.data, s + 8)
            if bits not in (4, 8, 16) or 12 + (n * bits + 7) // 8 > e - s:
                self.fail(f"box 'stz2' is malformed ({n} samples of {bits} bits)")
            if bits == 4:
                packed = np.frombuffer(self.data, np.uint8, (n + 1) // 2, s + 12)
                return np.stack([packed >> 4, packed & 15], 1).reshape(-1)[:n].astype(np.int64)
            return np.frombuffer(self.data, ">u1" if bits == 8 else ">u2", n,
                                 s + 12).astype(np.int64)
        self.fail("the video track has no sample sizes ('stsz' or 'stz2')")

    def sample_offsets(self, tables, sizes: np.ndarray) -> np.ndarray:
        if b"stco" in tables or b"co64" in tables:
            kind = b"stco" if b"stco" in tables else b"co64"
            s, e = tables[kind]
            self.full(s, e, 8, kind.decode())
            (n,) = struct.unpack_from(">I", self.data, s + 4)
            step = 4 if kind == b"stco" else 8
            if 8 + step * n > e - s:
                self.fail(f"box {kind.decode()!r} is truncated ({n} chunks in {e - s} bytes)")
            chunks = np.frombuffer(self.data, ">u4" if step == 4 else ">u8", n,
                                   s + 8).astype(np.int64)
        else:
            self.fail("the video track has no chunk offsets ('stco' or 'co64')")
        if b"stsc" not in tables:
            self.fail("the video track has no sample-to-chunk table ('stsc')")
        s, e = tables[b"stsc"]
        self.full(s, e, 8, "stsc")
        (n,) = struct.unpack_from(">I", self.data, s + 4)
        if 8 + 12 * n > e - s:
            self.fail("box 'stsc' is truncated")
        runs = np.frombuffer(self.data, ">u4", 3 * n, s + 8).reshape(n, 3).astype(np.int64)
        per_chunk = np.zeros(len(chunks), np.int64)
        for i, (first, count, _) in enumerate(runs):
            last = runs[i + 1][0] - 1 if i + 1 < n else len(chunks)
            if first < 1 or last < first - 1 or last > len(chunks):
                self.fail(f"box 'stsc' entry {i} names chunks {first}..{last} of {len(chunks)}")
            per_chunk[first - 1 : last] = count
        if per_chunk.sum() != len(sizes):
            self.fail(f"the chunks hold {int(per_chunk.sum())} samples, 'stsz' lists "
                      f"{len(sizes)}")
        chunk_of = np.repeat(np.arange(len(chunks)), per_chunk)
        starts = np.cumsum(sizes) - sizes  # each sample's bytes before it, over all chunks
        first = np.cumsum(per_chunk) - per_chunk  # each chunk's first sample
        return chunks[chunk_of] + starts - starts[first[chunk_of]]

    def time_to_sample(self, tables) -> Tuple[int, int]:
        """(samples, total duration) from ``stts``."""
        if b"stts" not in tables:
            self.fail("the video track has no time-to-sample table ('stts')")
        s, e = tables[b"stts"]
        self.full(s, e, 8, "stts")
        (n,) = struct.unpack_from(">I", self.data, s + 4)
        if 8 + 8 * n > e - s:
            self.fail("box 'stts' is truncated")
        runs = np.frombuffer(self.data, ">u4", 2 * n, s + 8).reshape(n, 2).astype(np.int64)
        return int(runs[:, 0].sum()), int((runs[:, 0] * runs[:, 1]).sum())


class Mp4Reader:
    """The video samples of an MP4 / QuickTime file, by index, and their
    frames decoded in order (``frames``)."""

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
        """(index, RGB frame) of every ``every``-th frame in display order.
        An MPEG-4 stream is decoded whole, since each P- and B-VOP needs the
        pictures before it; a JPEG frame skipped by ``every`` is not
        decoded."""
        from viddet_tpu_torch.native import decode_jpeg, h264_frames, mpeg4_frames, vp9_frames

        index = self.index
        if index.codec == "jpeg":
            for i in range(0, len(self), every):
                yield i, decode_jpeg(self.sample(i), f"{index.path} frame {i}")
            return
        if index.codec == "vp9":
            yield from vp9_frames((self.sample(i) for i in range(len(self))), index.path, every)
            return
        if index.codec == "h264":
            yield from h264_frames(index.config, (self.sample(i) for i in range(len(self))),
                                   index.path, every, index.reorder)
            return
        yield from mpeg4_frames(index.config, (self.sample(i) for i in range(len(self))),
                                index.path, every, index.fourcc)

    def close(self) -> None:
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# -------------------------------------------------------------------- writing

MOVIE_TIMESCALE = 1000  # mvhd's, as FFmpeg's muxer writes it
CHUNK_BYTES = 1 << 20  # a chunk holds samples up to this many bytes
BRANDS = {False: (b"isom", 0x200, (b"isom", b"iso2", b"mp41")), True: (b"qt  ", 0x200, (b"qt  ",))}
IDENTITY = (0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)  # the unit matrix


def _box(kind: bytes, *payload: bytes) -> bytes:
    body = b"".join(payload)
    return struct.pack(">I4s", 8 + len(body), kind) + body


def _full(kind: bytes, version: int, flags: int, *payload: bytes) -> bytes:
    return _box(kind, struct.pack(">I", (version << 24) | flags), *payload)


def _put_descriptor(tag: int, payload: bytes) -> bytes:
    n = len(payload)  # the four-byte size form, as FFmpeg writes it
    return bytes([tag, 0x80 | (n >> 21) & 0x7F, 0x80 | (n >> 14) & 0x7F,
                  0x80 | (n >> 7) & 0x7F, n & 0x7F]) + payload


class Mp4Writer:
    """Write one MPEG-4 Part 2 video track as FFmpeg's ``mov`` muxer writes
    it without faststart: ``ftyp`` (``isom``, or QuickTime's ``qt  `` when
    ``quicktime``), a placeholder box, ``mdat`` (its size patched at
    ``close``, in the 64-bit form past 4 GiB), then ``moov`` with ``mvhd``
    and one ``trak`` (``tkhd``, ``mdia`` with ``mdhd``, ``hdlr`` ``vide``
    and ``minf``: ``vmhd``, ``dinf``, ``stbl``).  ``stbl`` holds ``stsd``
    (an ``mp4v`` sample entry whose ``esds`` carries object type 0x20 and
    ``config``, the VOS / VO / VOL headers), ``stts``, ``stss`` (the key
    samples), ``stsc``, ``stsz`` and ``stco``, or ``co64`` once a chunk
    lies past 4 GiB.  ``rate`` is (num, den): frames of den / num seconds;
    the media timescale is num, doubled up to at least 10000 as FFmpeg's
    muxer takes it.  ``write_sample(data, key)`` appends one VOP."""

    def __init__(self, path: str, width: int, height: int, rate: Tuple[int, int],
                 config: bytes, quicktime: bool = False):
        self.path, self.width, self.height = str(path), int(width), int(height)
        self.config, self.quicktime = bytes(config), quicktime
        num, den = rate
        self.timescale, self.delta = num, den
        while self.timescale < 10000:
            self.timescale, self.delta = 2 * self.timescale, 2 * self.delta
        self.sizes: List[int] = []
        self.keys: List[int] = []
        self.chunks: List[List[int]] = []  # [offset, samples, bytes]
        self._f = open(self.path, "wb")
        major, minor, compatible = BRANDS[quicktime]
        self._f.write(_box(b"ftyp", major, struct.pack(">I", minor), *compatible))
        self._mdat = self._f.tell()  # the placeholder, then the mdat header
        self._f.write(_box(b"wide" if quicktime else b"free"))
        self._f.write(struct.pack(">I4s", 8, b"mdat"))

    def write_sample(self, data: bytes, key: bool) -> None:
        at = self._f.tell()
        chunk = self.chunks[-1] if self.chunks else None
        if chunk is None or chunk[2] + len(data) > CHUNK_BYTES:
            self.chunks.append([at, 0, 0])
            chunk = self.chunks[-1]
        chunk[1] += 1
        chunk[2] += len(data)
        self._f.write(data)
        if key:
            self.keys.append(len(self.sizes) + 1)
        self.sizes.append(len(data))

    def _moov(self) -> bytes:
        n = len(self.sizes)
        media = n * self.delta
        movie = -(-media * MOVIE_TIMESCALE // self.timescale)  # rounded up, as FFmpeg
        mvhd = _full(b"mvhd", 0, 0, struct.pack(">IIII", 0, 0, MOVIE_TIMESCALE, movie),
                     struct.pack(">IH", 0x10000, 0x100), bytes(10), struct.pack(">9I", *IDENTITY),
                     bytes(24), struct.pack(">I", 2))
        tkhd = _full(b"tkhd", 0, 3, struct.pack(">IIIII", 0, 0, 1, 0, movie), bytes(8),
                     struct.pack(">hhhH", 0, 0, 0, 0), struct.pack(">9I", *IDENTITY),
                     struct.pack(">II", self.width << 16, self.height << 16))
        language = 0x7FFF if self.quicktime else 0x55C4  # "und"
        mdhd = _full(b"mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0, self.timescale, media,
                                                language, 0))
        name = b"\x0cVideoHandler" if self.quicktime else b"VideoHandler\0"
        hdlr = _full(b"hdlr", 0, 0, b"mhlr" if self.quicktime else bytes(4), b"vide", bytes(12),
                     name)
        vmhd = _full(b"vmhd", 0, 1, bytes(8))
        dinf = _box(b"dinf", _full(b"dref", 0, 0, struct.pack(">I", 1), _full(b"url ", 0, 1)))
        decoder = (bytes([MPEG4_VISUAL, 0x11]) + bytes(3)
                   + struct.pack(">II", 0, 0) + _put_descriptor(5, self.config))
        es = struct.pack(">HB", 1, 0) + _put_descriptor(4, decoder) + _put_descriptor(6, b"\x02")
        entry = _box(b"mp4v", bytes(6), struct.pack(">H", 1), bytes(16),
                     struct.pack(">HHII", self.width, self.height, 0x480000, 0x480000), bytes(4),
                     struct.pack(">H", 1), bytes(32), struct.pack(">Hh", 24, -1),
                     _full(b"esds", 0, 0, _put_descriptor(3, es)))
        stsd = _full(b"stsd", 0, 0, struct.pack(">I", 1), entry)
        stts = _full(b"stts", 0, 0, struct.pack(">III", 1, n, self.delta) if n else
                     struct.pack(">I", 0))
        stss = _full(b"stss", 0, 0, struct.pack(f">I{len(self.keys)}I", len(self.keys),
                                                *self.keys))
        runs: List[Tuple[int, int]] = []  # (first chunk, samples a chunk)
        for i, (_, count, _) in enumerate(self.chunks):
            if not runs or runs[-1][1] != count:
                runs.append((i + 1, count))
        stsc = _full(b"stsc", 0, 0, struct.pack(">I", len(runs)),
                     *(struct.pack(">III", first, count, 1) for first, count in runs))
        stsz = _full(b"stsz", 0, 0, struct.pack(f">II{n}I", 0, n, *self.sizes))
        offsets = [c[0] for c in self.chunks]
        wide = any(o >= 1 << 32 for o in offsets)
        stco = _full(b"co64" if wide else b"stco", 0, 0,
                     struct.pack(f">I{len(offsets)}{'Q' if wide else 'I'}", len(offsets),
                                 *offsets))
        stbl = _box(b"stbl", stsd, stts, stss, stsc, stsz, stco)
        minf = _box(b"minf", vmhd, dinf, stbl)
        return _box(b"moov", mvhd, _box(b"trak", tkhd, _box(b"mdia", mdhd, hdlr, minf)))

    def close(self) -> None:
        if self._f.closed:
            return
        try:
            end = self._f.tell()
            payload = end - self._mdat - 16
            self._f.seek(self._mdat)
            if payload + 8 < 1 << 32:
                self._f.seek(self._mdat + 8)
                self._f.write(struct.pack(">I", payload + 8))
            else:  # the placeholder becomes the 64-bit size
                self._f.write(struct.pack(">I4sQ", 1, b"mdat", payload + 16))
            self._f.seek(end)
            self._f.write(self._moov())
        finally:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
