"""Pipelined detection over a frame iterator (counterpart of the loop half of
``viddet_tpu/infer/stream.py``: ``stop_aware_put`` and ``stream_detect``).

  source:  any iterator of (idx, rgb, x, affine), x the transformed frame
  submit:  batch the frames -> one pinned copy to the device -> predictor
  drain:   the previous batch's (ids, scores, boxes) -> host

CUDA launches return at once, so keeping one batch in flight while the
previous one drains overlaps the host's work on batch N+1 (assembling it,
pinning it, launching its forward pass and tail) with the device's work on
batch N.  ``.cpu()`` on a result is the one sync point.  The overlap holds
only while the predictor itself never waits for the device: the port's
YOLOv3 tail on the card reads no value back to the host (no ``.item()``,
no size that depends on the data) before its outputs are copied.

The video sources (``FrameSource`` and ``NativeFrameSource``, on OpenCV and
FFmpeg) and ``stream_detect_video`` wait for the port's video reader.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, List, Tuple

import numpy as np

from viddet_tpu_torch.core.platform import resolve_device
from viddet_tpu_torch.infer.service import to_device_batch


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
