"""Video helpers (counterpart of ``viddet_tpu/utils/video.py``): probing,
frame iteration and extraction, and the annotated-video writer.

The JAX package reads and writes video through OpenCV's FFmpeg backend.
The port links no FFmpeg.  It reads

* AVI files (``native.avi``) holding Motion-JPEG, each frame a JPEG for
  the port's codec, so a frame equals what ``cv2.VideoCapture(path,
  cv2.CAP_OPENCV_MJPEG)`` returns and what ``cv2.imdecode`` gives for the
  frame's bytes; or MPEG-4 Part 2 (``XVID``, ``DIVX``, ``DX50``, ``FMP4``,
  ``MP4V``, ``M4S2``, packed B-frames unpacked);
* MP4 and QuickTime files (``.mp4``, ``.mov``; ``native.mp4``) holding
  MPEG-4 Part 2, VP9 (``vp09``) or Motion-JPEG (``jpeg`` samples);
* Matroska and WebM files (``.mkv``, ``.webm``; ``native.mkv``) holding
  VP8, VP9, MPEG-4 Part 2 or Motion-JPEG (``V_MJPEG``, or a VfW fourcc the
  AVI reader reads).

VP8 (every version and feature of RFC 6386) is decoded by the port's own
decoder (``native.Vp8Decoder``), VP9 profile 0 (8-bit 4:2:0) by another
(``native.Vp9Decoder``) and MPEG-4 Part 2 (Simple and Advanced
Simple Profile: B-VOPs, MPEG quantisation, quarter-sample vectors, and
the XviD IDCT and encoder workarounds FFmpeg keys on user data and the
fourcc; not interlace or global motion compensation) by another
(``native.Mpeg4Decoder``), each to what ``cv2.VideoCapture``'s FFmpeg
backend returns, frames in display order.

Another container, another codec (VP9 profiles 1-3, AV1, H.264, HEVC, ...), a
Matroska ContentEncoding and a webcam index raise ValueError, naming what
is missing.

``VideoWriter`` writes what the JAX package's writer (``cv2.VideoWriter``
with the ``mp4v`` fourcc) writes: MPEG-4 Part 2 from the port's own
encoder (``native.Mpeg4Encoder``), in the container the extension names:
``.mp4`` and ``.mov`` (``native.mp4.Mp4Writer``, the QuickTime brand for
``.mov``) and ``.avi`` (``native.avi.AviWriter``, fourcc ``mp4v``).  The
frame rate is stored as OpenCV stores it, so OpenCV reads back the fps it
reads from JAX's file, and an odd width or height loses its last column or
row, as OpenCV's writer truncates it.  Any other extension raises
ValueError before anything is written; nothing falls back to another
codec or container.
"""

from __future__ import annotations

import math
import os
from fractions import Fraction
from typing import Iterator, Tuple

import numpy as np

from viddet_tpu_torch.native import Mpeg4Encoder, encode_jpeg, encode_png
from viddet_tpu_torch.native.avi import AviReader, AviWriter
from viddet_tpu_torch.native.mkv import MkvReader
from viddet_tpu_torch.native.mp4 import Mp4Reader, Mp4Writer

WRITES = (".mp4", ".mov", ".avi")  # the containers the port writes, MPEG-4 Part 2 in each
CONTAINERS = {".mkv": "Matroska (.mkv)", ".webm": "WebM (.webm)"}  # read, not written
READERS = {".avi": AviReader, ".mp4": Mp4Reader, ".mov": Mp4Reader, ".mkv": MkvReader,
           ".webm": MkvReader}
READS = ("MPEG-4 Part 2 or Motion-JPEG video in .avi files, MPEG-4 Part 2, VP9 or Motion-JPEG "
         "video in .mp4 and .mov files, and VP8, VP9, MPEG-4 Part 2 or Motion-JPEG video in "
         ".mkv and .webm files")


def check_source(source) -> None:
    """Raise ValueError unless ``source`` names a file in a container the
    port can read (AVI, MP4 / QuickTime, Matroska / WebM): a webcam index
    needs capture support (V4L2), and another container needs FFmpeg.
    Nothing is opened."""
    if isinstance(source, int):
        raise ValueError(f"webcam {source}: the port has no video capture support (V4L2); "
                         f"it reads {READS} only")
    ext = os.path.splitext(str(source))[1].lower()
    if ext not in READERS:
        raise ValueError(f"{source}: reading a {ext or 'extensionless'} video needs FFmpeg, "
                         f"which the port does not link; it reads {READS} only")


def check_output(path) -> None:
    """Raise ValueError unless ``path`` names an ``.mp4``, ``.mov`` or
    ``.avi``, the containers the port writes."""
    ext = os.path.splitext(str(path))[1].lower()
    if ext not in WRITES:
        what = CONTAINERS.get(ext, ext or "extensionless")
        raise ValueError(f"{path}: the port does not write {what} files; it writes MPEG-4 Part 2 "
                         "video in .mp4, .mov and .avi files (another container needs FFmpeg, "
                         "which the port does not link)")


def writer_rate(fps) -> Tuple[int, int]:
    """(num, den): the frame rate as OpenCV's FFmpeg writer stores it, a
    decimal fraction within 0.001 of ``fps`` (29.97 for 30000/1001), its
    common factors removed as FFmpeg's encoder removes them; num is the
    VOL's vop_time_increment_resolution, den the ticks a frame."""
    fps = float(fps)
    if not fps > 0 or math.isinf(fps):
        raise ValueError(f"frame rate must be positive, got {fps}")
    num, den = int(fps + 0.5), 1
    while abs(num / den - fps) > 0.001:
        den *= 10
        num = int(fps * den + 0.5)
    g = math.gcd(num, den)
    num, den = num // g, den // g
    if num > 65535:
        raise ValueError(f"frame rate {fps}: {num}/{den} needs a vop_time_increment_resolution "
                         "above MPEG-4's 65535")
    return num, den


def open_video(source):
    """The reader of ``source`` by its container (``check_source`` first):
    ``AviReader``, ``Mp4Reader`` or ``MkvReader``, each with ``index`` (fps,
    frame_count, width, height, codec), ``len`` and ``frames(every)``.  A codec or
    feature the port does not decode raises ValueError here."""
    check_source(source)
    if not os.path.exists(str(source)):
        raise FileNotFoundError(f"cannot open video: {source}")
    return READERS[os.path.splitext(str(source))[1].lower()](str(source))


def check_readable(source) -> None:
    """``check_source``, then the file's index and decoder configuration
    read and closed: a missing file, a codec or feature the port does not
    decode and a truncated file raise here, before anything is written."""
    check_source(source)
    with open_video(source):
        pass


def probe_video(path: str) -> dict:
    """fps / frame count / resolution of a video file."""
    with open_video(path) as video:
        index = video.index
    return {"fps": index.fps, "frame_count": index.frame_count, "width": index.width,
            "height": index.height}


def iterate_frames(path: str, every: int = 1, rgb: bool = True
                   ) -> Iterator[Tuple[int, np.ndarray]]:
    """Yield (frame_index, frame) of every ``every``-th frame in display
    order, RGB, or BGR (as OpenCV returns it) when ``rgb`` is False.  JPEG
    frames skipped by ``every`` are not decoded; an MPEG-4, VP8 or VP9 stream is
    decoded whole, each inter frame needing the pictures before it."""
    with open_video(path) as video:
        for idx, frame in video.frames(every):
            yield idx, frame if rgb else np.ascontiguousarray(frame[..., ::-1])


def extract_frames(video_path: str, out_dir: str, every: int = 1, ext: str = "jpg",
                   quality: int = 95) -> int:
    """Video -> numbered frame images ``{idx:08d}.{ext}`` (``jpg``: the bytes
    ``cv2.imwrite`` writes at ``quality``; ``png``: lossless); returns the
    number written."""
    if ext not in ("jpg", "png"):
        raise ValueError(f"extract_frames writes jpg or png, not {ext!r}")
    count = 0
    with open_video(video_path) as video:  # a file the port cannot read raises first
        os.makedirs(out_dir, exist_ok=True)
        for idx, frame in video.frames(every):
            data = encode_jpeg(frame, quality) if ext == "jpg" else encode_png(frame)
            with open(os.path.join(out_dir, f"{idx:08d}.{ext}"), "wb") as f:
                f.write(data)
            count += 1
    return count


class VideoWriter:
    """Annotated-video writer: RGB frames in, MPEG-4 Part 2 out, in the
    ``.mp4``, ``.mov`` or ``.avi`` that ``path`` names (see the module's
    docstring).  ``size`` is (width, height); an odd one is truncated to
    even, as OpenCV's writer truncates it.  A frame of another size, a
    container the port does not write and a failed encode raise
    ValueError."""

    def __init__(self, path: str, fps, size: Tuple[int, int]):
        check_output(path)
        self.size = (int(size[0]), int(size[1]))
        width, height = self.size[0] & ~1, self.size[1] & ~1
        if width < 2 or height < 2:
            raise ValueError(f"{path}: cannot write a {size[0]}x{size[1]} video")
        num, den = writer_rate(fps)
        # the encoder first: a build failure or a size it refuses raises before a file is made
        self._encoder = Mpeg4Encoder(width, height, num, den, name=str(path))
        self._crop = (height, width)
        ext = os.path.splitext(str(path))[1].lower()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        if ext == ".avi":
            self._in_band = self._encoder.config  # OpenCV's AVI carries the headers in-band
            self._writer = AviWriter(path, width, height, Fraction(num, den), codec="mpeg4")
        else:
            self._in_band = b""
            self._writer = Mp4Writer(path, width, height, (num, den), self._encoder.config,
                                     quicktime=ext == ".mov")

    def write(self, frame_rgb: np.ndarray) -> None:
        if frame_rgb.shape[:2] != (self.size[1], self.size[0]):
            raise ValueError(f"frame of {frame_rgb.shape[1]}x{frame_rgb.shape[0]} in a "
                             f"{self.size[0]}x{self.size[1]} video")
        vop, key = self._encoder.encode(frame_rgb[: self._crop[0], : self._crop[1]])
        self._writer.write_sample(self._in_band + vop if key else vop, key)

    def planes(self):
        """The (Y, U, V) planes that a decoder shows for the frame written
        last: the encoder's reconstruction."""
        return self._encoder.planes()

    def close(self) -> None:
        try:
            self._writer.close()
        finally:
            self._encoder.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
