"""AVI files read and written without FFmpeg: Motion-JPEG and MPEG-4 Part 2
video in and out.

Each frame of a Motion-JPEG AVI is a whole JPEG, so the port's codec
(``native.decode_jpeg`` / ``native.encode_jpeg``) does the pixels and this
module only walks and writes the RIFF tree.  An MPEG-4 Part 2 stream (the
``XVID``, ``DIVX``, ``FMP4``, ... fourccs OpenCV and FFmpeg write) goes to
the port's MPEG-4 decoder (``native.Mpeg4Decoder``), configured by the
``strf`` extradata after the BITMAPINFOHEADER, or where there is none by
the VOS / VOL headers at the head of the first frame, and told the
``strf`` compression, as FFmpeg's decoder is told its codec tag: an
``XVID`` or ``DIVX`` stream without user data is decoded as early XviD's
or DivX 4's (``AviIndex.fourcc``).  Packed B-frames (a
P-VOP and the B-VOP shown before it in one chunk, then a placeholder
chunk, as DivX and XviD write them) are unpacked as FFmpeg's
``mpeg4_unpack_bframes`` filter unpacks them: the B-VOP's bytes take the
place of the next chunk that holds one VOP, and a chunk that holds none
is dropped.  The frames are then the samples in decode order, and the
decoder gives them out in display order.

Reading (``read_index``) walks ``hdrl`` (``avih``; per stream ``strl``
with ``strh`` and a ``strf`` BITMAPINFOHEADER), then every ``movi`` list in
file order, the OpenDML continuation segments (``RIFF 'AVIX'``) included,
and descends into ``LIST 'rec '``; headers are read from the first segment
only.  The frames are the first video stream's
``##dc`` / ``##db`` chunks in file order; ``JUNK``, index chunks
(``idx1``, ``indx``, ``ix##``) and other streams' chunks are skipped, and
an empty chunk (a writer's dropped frame) is not a frame.  ``idx1`` is
not read: a file cut short by a crash, its sizes never patched, reads up
to its last whole frame.  A video stream whose compression is neither
raises ValueError naming it: decoding it needs FFmpeg, which the port does
not link.

Writing (``AviWriter``) gives AVI 1.0 with an ``idx1`` index, of
Motion-JPEG frames or, with ``codec="mpeg4"``, of the MPEG-4 Part 2
samples ``utils.video.VideoWriter`` encodes (the ``mp4v`` fourcc OpenCV's
``mp4v`` writer puts in an AVI, key frames flagged); past
``segment_bytes`` (1 GiB, as FFmpeg's muxer) a file continues in OpenDML
``AVIX`` segments, each ``movi`` list with its ``ix00`` index and the
header's ``indx`` super index pointing at them (see ``AviWriter`` for the
header copy each segment also carries for OpenCV's reader).  The frame rate is stored
as the rational ``dwRate / dwScale``.
"""

from __future__ import annotations

import dataclasses
import mmap
import os
import struct
from fractions import Fraction
from typing import Iterator, List, Tuple

import numpy as np

from viddet_tpu_torch.native.mp4 import VOP_START, check_decoder_config, check_vops

JPEG_FOURCCS = ("MJPG", "JPEG")  # the compressions read, compared in upper case
MPEG4_FOURCCS = ("XVID", "DIVX", "DX50", "FMP4", "MP4V", "M4S2")  # MPEG-4 Part 2
BITMAPINFOHEADER = 40  # bytes; a strf's extradata follows
QUALITY = 95  # the JPEG quality of written frames, OpenCV's MJPEG writer's
SEGMENT_BYTES = 1 << 30
MASTER_INDEX_ENTRIES = 256  # super-index slots reserved in the header (FFmpeg's count)
AVIF_HASINDEX, AVIF_ISINTERLEAVED, AVIF_TRUSTCKTYPE = 0x10, 0x100, 0x800
AVIIF_KEYFRAME = 0x10


@dataclasses.dataclass
class AviIndex:
    """What ``read_index`` finds: the first video stream's geometry, codec
    and rate, and each frame's sample as (file offset, size): a JPEG, or an
    MPEG-4 VOP in decode order."""

    path: str
    width: int
    height: int
    rate: int
    scale: int
    offsets: np.ndarray  # int64, file offset of each frame's data
    sizes: np.ndarray  # int64
    truncated: bool  # the walk met a chunk cut short by the end of the file
    codec: str = "jpeg"  # or "mpeg4" (``native.VideoStream``'s codec)
    config: bytes = b""  # the MPEG-4 decoder configuration (VOS / VO / VOL)
    fourcc: str = ""  # the strf compression, which FFmpeg's MPEG-4 decoder reads too

    @property
    def fps(self) -> float:
        return self.rate / self.scale if self.scale else 0.0

    @property
    def frame_count(self) -> int:
        return len(self.offsets)

    @property
    def shown(self) -> int:
        """The frames that can be read (an AVI's count is these)."""
        return len(self.offsets)


def read_index(path: str) -> AviIndex:
    """Walk the AVI at ``path``; see the module's docstring.  Raises
    ValueError for a file that is not an AVI, has no video stream, or
    whose video is neither Motion-JPEG nor MPEG-4 Part 2, and for an
    MPEG-4 stream with an S-VOP or that does not start with an I-VOP."""
    path = str(path)
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        if size < 12:
            raise ValueError(f"{path}: not an AVI file ({size} bytes)")
        with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as data:
            return _Walk(path, data, size).run()


def unpack_bframes(data, frames: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """MPEG-4 frames (offset, size) as FFmpeg's ``mpeg4_unpack_bframes``
    leaves them: a frame with two or more VOPs keeps its first and hands
    the rest on to the next frame that holds exactly one VOP (the
    placeholder), whose bytes it replaces; a frame with no VOP is
    dropped."""
    out, packed = [], None
    for offset, size in frames:
        end = offset + size
        first = data.find(VOP_START, offset, end)
        second = data.find(VOP_START, first + 4, end) if first >= 0 else -1
        if second >= 0:
            packed = (second, end - second)  # a second one unpaired is dropped, as there
            out.append((offset, second - offset))
        elif first >= 0 and packed is not None:
            out.append(packed)
            packed = None
        elif first >= 0:
            out.append((offset, size))
    return out


class _Walk:
    def __init__(self, path: str, data, size: int):
        self.path, self.data, self.size = path, data, size
        self.streams: List[Tuple[bytes, Tuple]] = []  # (fccType, (dwScale, dwRate))
        self.strf: dict = {}  # stream number -> its strf payload
        self.tags: Tuple[bytes, ...] = ()
        self.frames: List[Tuple[int, int]] = []
        self.truncated = False

    def run(self) -> AviIndex:
        pos = 0
        while pos + 12 <= self.size and not self.truncated:
            cid, length, kind = struct.unpack_from("<4sI4s", self.data, pos)
            if cid != b"RIFF" or kind != (b"AVI " if pos == 0 else b"AVIX"):
                if pos == 0:
                    raise ValueError(f"{self.path}: not an AVI file (starts {cid!r} {kind!r})")
                break  # trailing bytes that are not a segment
            end = self._end(pos, length, self.size)
            self._list(pos + 12, end, in_movi=False, headers=pos == 0)
            pos = end + (length & 1)
        if not self.tags:
            raise ValueError(f"{self.path}: AVI has no video stream")
        video = next(i for i, (kind, _) in enumerate(self.streams) if kind == b"vids")
        strh = self.streams[video][1]
        strf = self.strf.get(video, b"")
        if len(strf) < 20:
            raise ValueError(f"{self.path}: video stream {video} has no BITMAPINFOHEADER")
        _, width, height, _, _, compression = struct.unpack_from("<IiiHH4s", strf)
        fourcc = compression.decode("latin-1")
        if fourcc.upper() in JPEG_FOURCCS:
            codec, config, frames = "jpeg", b"", self.frames
        elif fourcc.upper() in MPEG4_FOURCCS:
            codec, frames = "mpeg4", unpack_bframes(self.data, self.frames)
            config = strf[BITMAPINFOHEADER:]
            if not config and frames:  # the headers before the first frame's VOP
                offset, size = frames[0]
                at = self.data.find(VOP_START, offset, offset + size)
                config = bytes(self.data[offset:at if at >= 0 else offset + size])
        else:
            raise ValueError(f"{self.path}: the video stream is {fourcc!r}, not Motion-JPEG or "
                             f"MPEG-4 Part 2; decoding it needs FFmpeg, which the port does "
                             f"not link")
        offsets = np.array([o for o, _ in frames], np.int64)
        sizes = np.array([s for _, s in frames], np.int64)
        if codec == "mpeg4":
            check_vops(self.data, offsets, sizes, self.fail)
        return AviIndex(self.path, width, abs(height), strh[1], strh[0], offsets, sizes,
                        self.truncated, codec, config, fourcc)

    def fail(self, what: str):
        raise ValueError(f"{self.path}: {what}")

    def _end(self, pos: int, length: int, parent_end: int) -> int:
        """A list's end; a size never patched (0) or past its parent runs to
        the parent's end, as after a crash."""
        end = pos + 8 + length
        return parent_end if length == 0 or end > parent_end else end

    def _list(self, pos: int, end: int, in_movi: bool, headers: bool) -> None:
        data = self.data
        while pos + 8 <= end and not self.truncated:
            cid, length = struct.unpack_from("<4sI", data, pos)
            if cid in (b"LIST", b"RIFF"):
                if pos + 12 > end:
                    break
                kind = data[pos + 8 : pos + 12]
                child_end = self._end(pos, length, end)
                if kind in (b"hdrl", b"strl") and headers:
                    self._list(pos + 12, child_end, False, True)
                elif kind in (b"movi", b"rec "):
                    self._list(pos + 12, child_end, True, False)
                pos = child_end + (length & 1)
                continue
            body = pos + 8
            if body + length > end:
                self.truncated = in_movi or body + length > self.size
                return
            if cid == b"strh" and length >= 36:
                kind = data[body : body + 4]
                scale, rate = struct.unpack_from("<II", data, body + 20)
                self.streams.append((kind, (scale, rate)))
                if kind == b"vids" and not self.tags:
                    n = len(self.streams) - 1
                    self.tags = (b"%02ddc" % n, b"%02ddb" % n)
            elif cid == b"strf" and self.streams:
                self.strf[len(self.streams) - 1] = bytes(data[body : body + length])
            elif in_movi and cid in self.tags and length:
                self.frames.append((body, length))
            pos = body + length + (length & 1)


class AviReader:
    """The video samples of an AVI by index (a JPEG, or an MPEG-4 VOP in
    decode order), and its frames decoded (``frames``)."""

    def __init__(self, path: str):
        self.index = read_index(path)
        if self.index.codec == "mpeg4":  # the VOL's refusals, before any frame is decoded
            check_decoder_config(self.index)
        self._file = open(path, "rb")

    def __len__(self) -> int:
        return self.index.frame_count

    def sample(self, i: int) -> bytes:
        self._file.seek(int(self.index.offsets[i]))
        return self._file.read(int(self.index.sizes[i]))

    def __iter__(self) -> Iterator[bytes]:
        for i in range(len(self)):
            yield self.sample(i)

    def frames(self, every: int = 1) -> Iterator[Tuple[int, np.ndarray]]:
        """(index, RGB frame) of every ``every``-th frame in display order.
        A JPEG frame skipped by ``every`` is not decoded; an MPEG-4 stream
        is decoded whole."""
        from viddet_tpu_torch.native import decode_jpeg, mpeg4_frames

        index = self.index
        if index.codec == "mpeg4":
            yield from mpeg4_frames(index.config, (self.sample(i) for i in range(len(self))),
                                    index.path, every, index.fourcc)
            return
        for i in range(0, len(self), every):
            yield i, decode_jpeg(self.sample(i), f"{index.path} frame {i}")

    def close(self) -> None:
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def fps_ratio(fps) -> Tuple[int, int]:
    """(dwRate, dwScale) for a frame rate: the nearest fraction with a scale
    up to 1001, so 25 is 25 / 1, 29.97 is 30000 / 1001 and 25 / 3 stays
    exact."""
    r = Fraction(fps).limit_denominator(1001)
    if r <= 0:
        raise ValueError(f"frame rate must be positive, got {fps}")
    return r.numerator, r.denominator


def _chunk(cid: bytes, payload: bytes) -> bytes:
    return cid + struct.pack("<I", len(payload)) + payload + b"\0" * (len(payload) & 1)


def _list(kind: bytes, payload: bytes) -> bytes:
    return b"LIST" + struct.pack("<I", 4 + len(payload)) + kind + payload


WRITTEN = {"jpeg": b"MJPG", "mpeg4": b"mp4v"}  # the fourcc of each codec written


class AviWriter:
    """Write an AVI: Motion-JPEG, where ``write(rgb)`` encodes a frame at
    ``QUALITY`` and ``write_jpeg(data)`` stores JPEG bytes as they are, or
    with ``codec="mpeg4"`` MPEG-4 Part 2, where ``write_sample(data, key)``
    stores one VOP (an I-VOP's sample carrying the VOS / VOL headers before
    it, as OpenCV's writer puts them in an AVI) under the fourcc ``mp4v``
    (never ``XVID`` or ``DIVX``: FFmpeg takes those, without user data, for
    XviD's or DivX's streams and changes its IDCT or rules), its
    ``AVIIF_KEYFRAME`` flag and ``ix00`` key bit set by ``key``.
    ``close()`` writes the indexes and the final counts.

    ``segment_bytes`` is the most a RIFF segment holds before the next frame
    opens an OpenDML ``AVIX`` segment.  Beside its ``ix00``, each ``AVIX``
    segment carries a short copy of the header list (``avih``, ``strl``)
    and an ``idx1`` of its own frames: OpenDML readers (FFmpeg) skip both,
    and OpenCV's built-in MJPEG reader, which reads each RIFF segment as an
    AVI 1.0 file of its own, needs both to see the segment's frames."""

    def __init__(self, path: str, width: int, height: int, fps,
                 segment_bytes: int = SEGMENT_BYTES, codec: str = "jpeg"):
        if not 0 < width < 65536 or not 0 < height < 65536:
            raise ValueError(f"cannot write a {width}x{height} video")
        if codec not in WRITTEN:
            raise ValueError(f"AviWriter writes jpeg or mpeg4, not {codec!r}")
        self.path, self.width, self.height = str(path), int(width), int(height)
        self.codec, self.fourcc = codec, WRITTEN[codec]
        self.rate, self.scale = fps_ratio(fps)
        self.segment_bytes = int(segment_bytes)
        self._f = open(self.path, "wb")
        self._segments: List[dict] = []  # riff / movi size positions, frames (offset, size)
        self._total = 0
        self._max_chunk = 0
        self._open_segment()

    def _tell(self) -> int:
        return self._f.tell()

    def _start(self, cid: bytes, kind: bytes) -> int:
        """A list with its size left 0 (a reader takes 0 as "to the end of
        the file" until ``close``); returns the size field's position."""
        self._f.write(cid)
        at = self._tell()
        self._f.write(struct.pack("<I", 0) + kind)
        return at

    def _end(self, at: int) -> None:
        end = self._tell()
        self._f.seek(at)
        self._f.write(struct.pack("<I", end - at - 4))
        self._f.seek(end)

    def _hdrl(self, first: bool) -> bytes:
        """The header list; the first segment's also holds the super index
        (or a JUNK chunk of its size in an AVI 1.0 file) and ``odml``."""
        frames0 = len(self._segments[0]["frames"]) if self._segments else 0
        avih = struct.pack("<14I", round(1e6 * self.scale / self.rate), 0, 0,
                           AVIF_HASINDEX | AVIF_ISINTERLEAVED | AVIF_TRUSTCKTYPE, frames0, 0,
                           1, self._max_chunk, self.width, self.height, 0, 0, 0, 0)
        strh = struct.pack("<4s4sIHHIIIIIIIIHHHH", b"vids", self.fourcc, 0, 0, 0, 0, self.scale,
                           self.rate, 0, self._total, self._max_chunk, 0xFFFFFFFF, 0, 0, 0,
                           self.width, self.height)
        strf = struct.pack("<IiiHH4sIiiII", 40, self.width, self.height, 1, 24, self.fourcc,
                           self.width * self.height * 3, 0, 0, 0, 0)
        strl = _chunk(b"strh", strh) + _chunk(b"strf", strf)
        if not first:
            return _list(b"hdrl", _chunk(b"avih", avih) + _list(b"strl", strl))
        indexed = [s for s in self._segments if "ix" in s]
        indx = struct.pack("<HBBI4sIII", 4, 0, 0, len(indexed), b"00dc", 0, 0, 0) + b"".join(
            struct.pack("<QII", s["ix"], s["ix_size"], len(s["frames"])) for s in indexed)
        indx += bytes(24 + 16 * MASTER_INDEX_ENTRIES - len(indx))
        strl += _chunk(b"indx" if indexed else b"JUNK", indx)
        dmlh = struct.pack("<I", self._total) + bytes(244)
        return _list(b"hdrl", _chunk(b"avih", avih) + _list(b"strl", strl)
                     + _list(b"odml", _chunk(b"dmlh", dmlh)))

    def _open_segment(self) -> None:
        first = not self._segments
        riff = self._start(b"RIFF", b"AVI " if first else b"AVIX")
        hdrl = self._tell()
        self._f.write(self._hdrl(first))
        movi = self._start(b"LIST", b"movi")
        self._segments.append({"riff": riff, "hdrl": hdrl, "movi": movi, "frames": []})

    def _close_segment(self, odml: bool) -> None:
        """End the open segment: its ``ix00`` when the file is OpenDML, the
        ``movi`` list, then its ``idx1``."""
        seg = self._segments[-1]
        base = seg["movi"] + 4  # the 'movi' fourcc: idx1 and ix00 offsets count from it
        if odml:
            seg["ix"] = self._tell()
            self._f.write(b"ix00" + struct.pack("<IHBBI4sQI", 24 + 8 * len(seg["frames"]), 2, 0,
                                                1, len(seg["frames"]), b"00dc", base, 0))
            # bit 31 of a size marks a frame that is not a key frame
            self._f.write(b"".join(struct.pack("<II", o - base, n | (0 if key else 1 << 31))
                                   for o, n, key in seg["frames"]))
            seg["ix_size"] = self._tell() - seg["ix"]
        self._end(seg["movi"])
        self._f.write(_chunk(b"idx1", b"".join(
            struct.pack("<4sIII", b"00dc", AVIIF_KEYFRAME if key else 0, o - 8 - base, n)
            for o, n, key in seg["frames"])))
        self._end(seg["riff"])

    def write_jpeg(self, data: bytes) -> None:
        if self.codec != "jpeg":
            raise ValueError(f"{self.path}: an MPEG-4 AVI takes write_sample, not JPEG frames")
        self._store(data, True)

    def write_sample(self, data: bytes, key: bool) -> None:
        """Store one MPEG-4 sample (a VOP, an I-VOP's with the headers)."""
        if self.codec != "mpeg4":
            raise ValueError(f"{self.path}: a Motion-JPEG AVI takes JPEG frames, not samples")
        self._store(data, key)

    def _store(self, data: bytes, key: bool) -> None:
        seg = self._segments[-1]
        chunk = 8 + len(data) + (len(data) & 1)
        if seg["frames"] and self._tell() + chunk - seg["riff"] > self.segment_bytes:
            if len(self._segments) == MASTER_INDEX_ENTRIES:
                raise ValueError(f"{self.path}: more than {MASTER_INDEX_ENTRIES} segments")
            self._close_segment(odml=True)
            self._open_segment()
            seg = self._segments[-1]
        seg["frames"].append((self._tell() + 8, len(data), key))
        self._f.write(_chunk(b"00dc", data))
        self._total += 1
        self._max_chunk = max(self._max_chunk, len(data))

    def write(self, rgb: np.ndarray) -> None:
        from viddet_tpu_torch.native import encode_jpeg

        if rgb.shape[:2] != (self.height, self.width):
            raise ValueError(f"frame of {rgb.shape[1]}x{rgb.shape[0]} in a "
                             f"{self.width}x{self.height} video")
        self.write_jpeg(encode_jpeg(rgb, QUALITY))

    def close(self) -> None:
        if self._f.closed:
            return
        try:
            self._close_segment(odml=len(self._segments) > 1)
            for i, seg in enumerate(self._segments):  # the final counts and indexes
                self._f.seek(seg["hdrl"])
                self._f.write(self._hdrl(first=i == 0))
        finally:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
