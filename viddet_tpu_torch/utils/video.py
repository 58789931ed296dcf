"""Video helpers (counterpart of ``viddet_tpu/utils/video.py``): probing,
frame iteration and extraction, and the annotated-video writer.

The JAX package reads and writes video through OpenCV's FFmpeg backend.
The port links no FFmpeg: it reads and writes Motion-JPEG AVI files
(``native.avi``), each frame a JPEG for the port's codec, so a frame it
reads equals what ``cv2.VideoCapture(path, cv2.CAP_OPENCV_MJPEG)`` returns
and what ``cv2.imdecode`` gives for the frame's bytes.  Any other
container (``.mp4``, ``.mov``, ``.mkv``, ``.webm``), a non-JPEG stream in
an ``.avi`` and a webcam index raise ValueError, naming what is missing.
``VideoWriter`` writes ``.avi`` only.
"""

from __future__ import annotations

import os
from typing import Iterator, Tuple

import numpy as np

from viddet_tpu_torch.native import decode_jpeg, encode_jpeg, encode_png
from viddet_tpu_torch.native.avi import AviReader, AviWriter

VIDEO_EXT = ".avi"


def check_source(source) -> None:
    """Raise ValueError unless ``source`` names a file the port can read: a
    webcam index needs capture support (V4L2), and a container other than
    AVI needs FFmpeg.  Nothing is opened."""
    if isinstance(source, int):
        raise ValueError(f"webcam {source}: the port has no video capture support (V4L2); "
                         "it reads Motion-JPEG .avi files only")
    ext = os.path.splitext(str(source))[1].lower()
    if ext != VIDEO_EXT:
        raise ValueError(f"{source}: reading a {ext or 'extensionless'} video needs FFmpeg, "
                         "which the port does not link; it reads Motion-JPEG .avi files only")


def check_output(path) -> None:
    """Raise ValueError unless ``path`` names an ``.avi``, the one container
    the port writes."""
    if os.path.splitext(str(path))[1].lower() != VIDEO_EXT:
        raise ValueError(f"{path}: writing anything but a Motion-JPEG .avi needs FFmpeg, "
                         "which the port does not link")


def open_video(source) -> AviReader:
    """The frames of ``source`` as JPEG bytes (``check_source`` first)."""
    check_source(source)
    if not os.path.exists(str(source)):
        raise FileNotFoundError(f"cannot open video: {source}")
    return AviReader(str(source))


def probe_video(path: str) -> dict:
    """fps / frame count / resolution of a video file."""
    with open_video(path) as video:
        index = video.index
    return {"fps": index.fps, "frame_count": index.frame_count, "width": index.width,
            "height": index.height}


def iterate_frames(path: str, every: int = 1, rgb: bool = True
                   ) -> Iterator[Tuple[int, np.ndarray]]:
    """Yield (frame_index, frame) of every ``every``-th frame, RGB, or BGR
    (as OpenCV returns it) when ``rgb`` is False.  Frames skipped by
    ``every`` are not decoded."""
    with open_video(path) as video:
        for idx in range(0, len(video), every):
            frame = decode_jpeg(video.jpeg(idx), f"{path} frame {idx}")
            yield idx, frame if rgb else np.ascontiguousarray(frame[..., ::-1])


def extract_frames(video_path: str, out_dir: str, every: int = 1, ext: str = "jpg",
                   quality: int = 95) -> int:
    """Video -> numbered frame images ``{idx:08d}.{ext}`` (``jpg``: the bytes
    ``cv2.imwrite`` writes at ``quality``; ``png``: lossless); returns the
    number written."""
    if ext not in ("jpg", "png"):
        raise ValueError(f"extract_frames writes jpg or png, not {ext!r}")
    os.makedirs(out_dir, exist_ok=True)
    count = 0
    for idx, frame in iterate_frames(video_path, every=every):
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
