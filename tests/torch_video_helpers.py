"""Helpers for the tests of the port's video output (``VideoWriter``, the
MPEG-4 Part 2 encoder and the MP4 / AVI muxers): seeded drawn frames, the
PSNR, OpenCV's view of a file's properties, and the checks each drawn
``_det.mp4`` passes."""

from __future__ import annotations

import os
import tempfile
from typing import Optional, Sequence

import cv2
import numpy as np

from tests.fixtures.make_mp4_fixture import moving_scene
from tests.torch_mp4_helpers import cv2_views
from viddet_tpu_torch.utils.image import draw_detections
from viddet_tpu_torch.utils.video import VideoWriter, iterate_frames

NAMES = ["person", "car", "dog"]


def drawn_frames(n: int, w: int, h: int, seed: int = 0) -> list:
    """``n`` RGB frames of ``moving_scene`` with five seeded labelled boxes
    drawn on each by ``draw_detections``, as a drawn run's frames look."""
    rng = np.random.default_rng(seed)
    out = []
    for frame in moving_scene(n, w, h, seed):
        x0, y0 = rng.uniform(0, 0.6 * w, 5), rng.uniform(0, 0.6 * h, 5)
        boxes = np.stack([x0, y0, x0 + rng.uniform(8, 0.4 * w, 5),
                          y0 + rng.uniform(8, 0.4 * h, 5)], 1)
        out.append(draw_detections(np.ascontiguousarray(frame[..., ::-1]), boxes,
                                   rng.integers(0, 3, 5), rng.uniform(0.3, 1.0, 5), NAMES, 0.0))
    return out


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 99.0 if mse == 0 else float(10 * np.log10(255.0**2 / mse))


def cv2_props(path: str):
    """(frame count, width, height, fps) as ``cv2.VideoCapture``'s FFmpeg
    backend, what JAX's ``probe_video`` reads, reports them."""
    cap = cv2.VideoCapture(path, cv2.CAP_FFMPEG)
    assert cap.isOpened(), path
    props = (int(cap.get(cv2.CAP_PROP_FRAME_COUNT)), int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
             int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)), cap.get(cv2.CAP_PROP_FPS))
    cap.release()
    return props


def cv2_write(path: str, frames: Sequence[np.ndarray], fps) -> str:
    """RGB frames through JAX's writer: ``cv2.VideoWriter`` with ``mp4v``."""
    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), float(fps), (w, h))
    assert writer.isOpened(), path
    for f in frames:
        writer.write(np.ascontiguousarray(f[..., ::-1]))
    writer.release()
    return path


def assert_drawn_video(path: str, drawn: Optional[Sequence[np.ndarray]], fps,
                       jax_path: Optional[str] = None) -> None:
    """A drawn output of the port: the bytes a fresh ``VideoWriter`` writes
    from the drawn frames (when given), cv2's frames equal to the port's
    own decoder's, one a drawn frame, and cv2's frame count, size and fps
    those of JAX's file of the same run (when given)."""
    got = [f for _, f in iterate_frames(path)]
    want = cv2_views(path, "bgr")
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w[..., ::-1])
    if drawn is not None:
        assert len(got) == len(drawn)
        h, w = drawn[0].shape[:2]
        with tempfile.TemporaryDirectory() as tmp:
            fresh = os.path.join(tmp, os.path.basename(path))
            with VideoWriter(fresh, fps, (w, h)) as writer:
                for f in drawn:
                    writer.write(f)
            assert open(fresh, "rb").read() == open(path, "rb").read()
    if jax_path is not None:
        assert cv2_props(path) == cv2_props(jax_path)
