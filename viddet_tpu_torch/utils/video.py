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
  MPEG-4 Part 2 or Motion-JPEG (``jpeg`` samples);
* Matroska and WebM files (``.mkv``, ``.webm``; ``native.mkv``) holding
  VP8, MPEG-4 Part 2 or Motion-JPEG (``V_MJPEG``, or a VfW fourcc the
  AVI reader reads).

VP8 (every version and feature of RFC 6386) is decoded by the port's own
decoder (``native.Vp8Decoder``) and MPEG-4 Part 2 (Simple and Advanced
Simple Profile: B-VOPs, MPEG quantisation; not quarter-sample, interlace
or global motion compensation) by another (``native.Mpeg4Decoder``), each
to what ``cv2.VideoCapture``'s FFmpeg backend returns, frames in display
order.

Another container, another codec (VP9, AV1, H.264, HEVC, ...), a
Matroska ContentEncoding and a webcam index raise ValueError, naming what
is missing.  ``VideoWriter`` writes Motion-JPEG ``.avi`` only.
"""

from __future__ import annotations

import os
from typing import Iterator, Tuple

import numpy as np

from viddet_tpu_torch.native import encode_jpeg, encode_png
from viddet_tpu_torch.native.avi import AviReader, AviWriter
from viddet_tpu_torch.native.mkv import MkvReader
from viddet_tpu_torch.native.mp4 import Mp4Reader

VIDEO_EXT = ".avi"  # the container the port writes
READERS = {".avi": AviReader, ".mp4": Mp4Reader, ".mov": Mp4Reader, ".mkv": MkvReader,
           ".webm": MkvReader}
READS = ("MPEG-4 Part 2 or Motion-JPEG video in .avi, .mp4 and .mov files, and VP8, MPEG-4 "
         "Part 2 or Motion-JPEG video in .mkv and .webm files")


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
    """Raise ValueError unless ``path`` names an ``.avi``, the one container
    the port writes."""
    if os.path.splitext(str(path))[1].lower() != VIDEO_EXT:
        raise ValueError(f"{path}: the port writes Motion-JPEG .avi files only; writing "
                         "anything else needs FFmpeg, which the port does not link")


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
    frames skipped by ``every`` are not decoded; an MPEG-4 or VP8 stream is
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
    """Annotated-video writer: RGB frames in, a Motion-JPEG ``.avi`` out
    (JPEG quality 95).  ``size`` is (width, height)."""

    def __init__(self, path: str, fps, size: Tuple[int, int]):
        check_output(path)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._writer = AviWriter(path, size[0], size[1], fps)

    def write(self, frame_rgb: np.ndarray) -> None:
        self._writer.write(frame_rgb)

    def close(self) -> None:
        self._writer.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
