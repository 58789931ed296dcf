"""Streaming video detection (counterpart of ``viddet_tpu/infer/stream.py``):
the frame sources, the pipelined ``stream_detect`` loop and
``stream_detect_video``.

  source:  any iterator of (idx, rgb, x, affine), x the transformed frame:
           ``FrameSource`` (a Python decode thread) or ``NativeFrameSource``
           (a C++ one) over a Motion-JPEG or MPEG-4 Part 2 AVI, MP4 /
           QuickTime or Matroska file, or a VP8 or VP9 WebM / Matroska one
           (VP9 in MP4 too)
  submit:  batch the frames -> one pinned copy to the device -> predictor
  drain:   the previous batch's (ids, scores, boxes) -> host

CUDA launches return at once, so keeping one batch in flight while the
previous one drains overlaps the host's work on batch N+1 (assembling it,
pinning it, launching its forward pass and tail) with the device's work on
batch N.  ``.cpu()`` on a result is the one sync point.  The overlap holds
only while the predictor itself never waits for the device: the port's
YOLOv3 tail on the card reads no value back to the host (no ``.item()``,
no size that depends on the data) before its outputs are copied.

The JAX sources read through OpenCV (``cv2.VideoCapture``) and FFmpeg
(``viddet_tpu/native/decode.cpp``).  The port's read what
``utils/video.py`` reads, with the port's own demuxers and decoders: a
webcam index, another container or a codec or feature the port does not
decode raises ValueError before any thread starts.  Both sources give the same ``x`` and
``affine`` bit for bit: ``NativeFrameSource`` runs ``ValTransform`` in C++
(``native.frame_transform``), where JAX's native source resizes with a
float bilinear of its own.  ``stream_detect_video`` takes the native
source whenever it draws nothing and reads a path, with no fallback: a
failure raises.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Callable, Iterator, List, Sequence, Tuple

import numpy as np

from viddet_tpu_torch.core.platform import resolve_device
from viddet_tpu_torch.data.transforms import invert_affine_to_boxes
from viddet_tpu_torch.infer.service import to_device_batch
from viddet_tpu_torch.native import VideoStream
from viddet_tpu_torch.utils.image import draw_detections
from viddet_tpu_torch.utils.video import VideoWriter, open_video


def stop_aware_put(q: "queue.Queue", item, stop: threading.Event) -> bool:
    """Blocking put that gives up once ``stop`` is set.

    An abandoned consumer must not strand a producer thread on a full
    queue forever.  Returns False when the item was dropped."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.2)
            return True
        except queue.Full:
            continue
    return False


class _Failed:
    """A decode thread's error, queued for the consumer to raise."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class FrameSource:
    """Decodes a video's frames on a Python thread (the codec releases the
    GIL) and transforms them with ``transform`` (a ``ValTransform``) into a
    bounded queue; yields (idx, rgb, x, affine) of every ``every``-th frame.
    A frame that fails to decode raises in the consumer after the frames
    before it.  ``close()`` stops the thread and ends a blocked consumer."""

    def __init__(self, path, transform, every: int = 1, queue_size: int = 64):
        self._video = open_video(path)
        index = self._video.index
        self.fps, self.width, self.height = index.fps or 30.0, index.width, index.height
        self._transform, self._every = transform, every
        self._q: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for idx, rgb in self._video.frames(self._every):
                if self._stop.is_set():
                    break
                x, _, affine = self._transform(rgb)
                if not self._put((idx, rgb, x, affine)):
                    break
        except Exception as exc:  # noqa: BLE001 -- raised in the consumer
            self._put(_Failed(exc))
        finally:
            self._video.close()
            self._put(None)

    def _put(self, item) -> bool:
        return stop_aware_put(self._q, item, self._stop)

    def __iter__(self):
        # get() with a bounded timeout, so close() ends a blocked consumer
        # even when the decode thread can no longer enqueue its None
        while True:
            try:
                item = self._q.get(timeout=0.2)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            if item is None:
                return
            if isinstance(item, _Failed):
                raise item.exc
            yield item

    def close(self):
        self._stop.set()


class NativeFrameSource:
    """Reads, decodes and transforms a video's frames on a C++ thread
    (``native.VideoStream``, the GIL released) into a ring of
    ``queue_size`` frames.  Yields (idx, None, x, affine): the original
    frame is not kept, so this is the source for runs that draw nothing.
    ``x`` and ``affine`` equal ``FrameSource``'s with
    ``ValTransform(size, letterbox_resize, normalize)``, bit for bit."""

    def __init__(self, path, size: Tuple[int, int], every: int = 1,
                 letterbox_resize: bool = True, queue_size: int = 64, normalize: bool = True):
        with open_video(path) as video:
            index = video.index
        self.fps, self.width, self.height = index.fps or 30.0, index.width, index.height
        keep = np.arange(0, index.shown, every)  # the whole frames of a cut file
        self._stream = VideoStream(str(path), index.offsets, index.sizes, keep, size,
                                   letterbox_resize, normalize, queue_size, codec=index.codec,
                                   config=index.config, fourcc=index.fourcc)

    def __iter__(self):
        for idx, x, affine in self._stream:
            yield idx, None, x, affine

    def close(self):
        self._stream.close()


def stream_detect(
    source: Iterator,
    infer: Callable,
    batch_size: int,
    input_shape: Tuple[int, int],
    device=None,
) -> Iterator[Tuple[int, np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Continuously-batched detection over a frame iterator.

    ``infer``: ``(images on device) -> (ids, scores, boxes)``
    (``cli.common.make_predictor``); ``device``: where it runs, ``cuda:0``
    unless the caller says.  A short last batch is padded with zero frames
    to ``batch_size``, so every batch has one shape.

    Yields (frame_idx, orig_frame, affine, ids, scores, boxes) per frame,
    in order, with one batch kept in flight on the device.
    """
    device = resolve_device(device)
    h, w = input_shape
    pending: List = []  # (meta list, device result)

    def submit(metas):
        batch = np.stack([m[2] for m in metas])
        if batch.shape[1:3] != (h, w):
            raise ValueError(f"frames of {batch.shape[1:3]} do not match input_shape {(h, w)}")
        pending.append((metas, infer(to_device_batch(batch, batch_size, device))))

    def drain():
        metas, result = pending.pop(0)
        ids, scores, boxes = (r.cpu().numpy() for r in result)  # sync point
        for i, (idx, rgb, _x, affine) in enumerate(metas):
            yield idx, rgb, affine, ids[i], scores[i], boxes[i]

    batch_metas: List = []
    for item in source:
        batch_metas.append(item)
        if len(batch_metas) == batch_size:
            submit(batch_metas)
            batch_metas = []
            if len(pending) >= 2:  # keep 1 in flight, drain the older
                yield from drain()
    if batch_metas:
        submit(batch_metas)
    while pending:
        yield from drain()


def detection_line(idx: int, name: str, score, box) -> str:
    """One line of ``{stem}_det.txt``: frame index, class, score, box in the
    original frame's coordinates (JAX's format)."""
    return (f"{idx} {name} {score:.4f} "
            f"{box[0]:.1f} {box[1]:.1f} {box[2]:.1f} {box[3]:.1f}\n")


def video_source(path, transform, every: int, draw: bool):
    """``NativeFrameSource`` when nothing is drawn and ``path`` is a path,
    else ``FrameSource``; either raises on a source it cannot read."""
    if not draw and isinstance(path, (str, os.PathLike)):
        return NativeFrameSource(path, transform.size, every=every,
                                 letterbox_resize=transform.letterbox_resize,
                                 normalize=transform.normalize)
    return FrameSource(path, transform, every=every)


def stream_detect_video(
    path,
    infer: Callable,
    transform,
    class_names: Sequence[str],
    *,
    output_dir: str,
    thresh: float = 0.5,
    batch_size: int = 8,
    every: int = 1,
    draw: bool = True,
    save_detections: bool = False,
    logger=None,
    device=None,
) -> dict:
    """A video -> ``{stem}_det.mp4`` of annotated frames at ``fps / every``
    (``draw``) and ``{stem}_det.txt`` of detections at or above ``thresh``
    (``save_detections``).  ``infer`` and ``device`` as ``stream_detect``
    takes them.  Returns {frames, seconds, fps}."""
    source = video_source(path, transform, every, draw)
    stem = os.path.splitext(os.path.basename(str(path)))[0]
    writer = det_file = None
    t0 = time.perf_counter()
    n = 0
    try:
        os.makedirs(output_dir, exist_ok=True)
        if draw:
            writer = VideoWriter(os.path.join(output_dir, f"{stem}_det.mp4"),
                                 source.fps / every, (source.width, source.height))
        if save_detections:
            det_file = open(os.path.join(output_dir, f"{stem}_det.txt"), "w")
        for idx, rgb, affine, ids, scores, boxes in stream_detect(
                iter(source), infer, batch_size, transform.size, device=device):
            restored = invert_affine_to_boxes(boxes, affine)
            if det_file is not None:
                det_file.write("".join(
                    detection_line(idx, class_names[int(cid)], s, rb)
                    for cid, s, rb in zip(ids, scores, restored) if cid >= 0 and s >= thresh))
            if writer is not None:
                writer.write(draw_detections(rgb, restored, ids, scores, class_names, thresh))
            n += 1
    finally:
        source.close()
        if writer is not None:
            writer.close()
        if det_file is not None:
            det_file.close()
    dt = time.perf_counter() - t0
    stats = {"frames": n, "seconds": dt, "fps": n / dt if dt > 0 else 0.0}
    if logger:
        logger.info("video %s: %d frames in %.2fs (%.1f fps end-to-end)", stem, n, dt,
                    stats["fps"])
    return stats
