"""Continuously-batched detection service (counterpart of
``viddet_tpu/infer/service.py:43-268``).

  caller threads:  detect(rgb) -> enqueue (slot, image) -> wait on slot
  batcher thread:  collect up to ``batch_size`` requests (bounded by a
                   ``flush_ms`` deadline) -> pad -> ONE fixed-shape
                   forward + tail -> distribute per-request results

The batch crosses to the device as one pinned-memory copy with
``non_blocking=True``; up to ``max_in_flight`` batches are queued on the
device so host work on batch N+1 overlaps device work on batch N.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from viddet_tpu_torch.core.platform import resolve_device
from viddet_tpu_torch.data.transforms import invert_affine_to_boxes


class _Slot:
    """One pending request: the caller blocks on ``done`` until filled."""

    __slots__ = ("done", "result", "error", "t_enqueue")

    def __init__(self):
        self.done = threading.Event()
        self.t_enqueue = time.perf_counter()
        self.result: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
        self.error: Optional[BaseException] = None


class DetectionService:
    """Batches concurrent ``detect()`` calls onto one device program.

    Args:
      infer: ``(images (batch_size, H, W, 3) on ``device``) -> (ids, scores,
        boxes)`` (``cli.common.make_predictor``).
      transform: ``ValTransform``: (rgb) -> (x, _, affine); its ``size``
        fixes (H, W).
      batch_size: device batch; also the most requests fused per dispatch.
      flush_ms: longest wait to fill a batch once it holds one request.
      max_in_flight: batches queued on the device (2 = double-buffered).
      device: where ``infer`` runs; ``cuda:0`` unless the caller says.
    """

    def __init__(self, infer: Callable, transform, batch_size: int = 8,
                 flush_ms: float = 5.0, max_in_flight: int = 2, device=None):
        self._infer = infer
        self._transform = transform
        self._device = resolve_device(device)
        self._batch_size = int(batch_size)
        self._flush_s = float(flush_ms) / 1e3
        self._max_in_flight = max(1, int(max_in_flight))
        h, w = transform.size
        # uint8 when the transform leaves normalization to the device
        self._dtype = np.float32 if getattr(transform, "normalize", True) else np.uint8
        self._pad = np.zeros((h, w, 3), self._dtype)
        self._q: "queue.Queue" = queue.Queue(maxsize=4 * self._batch_size)
        self._stop = threading.Event()
        self._served = 0
        self._lat_ms = deque(maxlen=128)  # first request enqueued -> settled, per batch
        self._fill = deque(maxlen=128)  # requests per dispatched batch
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # ---- caller side ----------------------------------------------------

    def detect(self, rgb: np.ndarray, timeout: Optional[float] = None):
        """Detect on one RGB uint8 image; blocks until its batch completes.

        Returns (ids, scores, boxes) with boxes in ORIGINAL image
        coordinates, padded rows id=-1.  Thread-safe.  Raises TimeoutError
        when the queue is full or the result misses the deadline;
        ``timeout`` bounds the whole call.
        """
        if self._stop.is_set():
            raise RuntimeError("DetectionService is closed")
        x, _, affine = self._transform(rgb)
        slot = _Slot()
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            self._q.put((slot, np.asarray(x, self._dtype), affine), timeout=timeout)
        except queue.Full:
            raise TimeoutError("detection service overloaded (request queue full)") from None
        # Wait in bounded ticks so a close() racing this enqueue cannot
        # strand the caller.
        while True:
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                raise TimeoutError("detection request timed out")
            tick = 0.5 if remaining is None else min(0.5, remaining)
            if slot.done.wait(tick):
                break
            if self._stop.is_set() and not self._thread.is_alive():
                raise RuntimeError("DetectionService closed while waiting")
        if slot.error is not None:
            raise slot.error
        return slot.result

    @property
    def served(self) -> int:
        return self._served

    def stats(self) -> dict:
        """Batch latency percentiles and mean batch fill over the last
        <= 128 batches.  A batch's latency runs from the enqueue of its
        first request to its results on the host: queueing, the flush
        wait, the host's launch of the forward pass and tail, the device
        work and the copy back."""
        lat, fill = list(self._lat_ms), list(self._fill)
        out = {"requests_served": self._served, "batches": len(lat)}
        if lat and fill:
            out["batch_latency_ms_p50"] = float(np.percentile(lat, 50))
            out["batch_latency_ms_p95"] = float(np.percentile(lat, 95))
            out["mean_batch_fill"] = float(np.mean(fill))
        return out

    def close(self):
        self._stop.set()
        try:  # wake the batcher if it is blocked on an empty queue
            self._q.put_nowait(None)
        except queue.Full:
            pass
        self._thread.join(timeout=5.0)
        self._fail_queued()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---- batcher thread --------------------------------------------------

    def _fail_queued(self):
        """Fail every request still in the queue."""
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return
            if item is not None:
                item[0].error = RuntimeError("service closed")
                item[0].done.set()

    def _collect(self, block: bool) -> List:
        """Take the first request (blocking only when nothing is in
        flight), then fill up to batch_size within the flush deadline."""
        try:
            first = self._q.get(timeout=0.2) if block else self._q.get_nowait()
        except queue.Empty:
            return []
        if first is None:
            return []
        items = [first]
        deadline = time.perf_counter() + self._flush_s
        while len(items) < self._batch_size:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                break
            items.append(nxt)
        return items

    def _dispatch(self, items: List):
        batch = np.stack([x for _, x, _ in items])
        if len(items) < self._batch_size:
            pad = np.broadcast_to(self._pad, (self._batch_size - len(items),) + self._pad.shape)
            batch = np.concatenate([batch, pad])
        host = torch.from_numpy(batch)
        if self._device.type == "cuda":
            host = host.pin_memory()
        return self._infer(host.to(self._device, non_blocking=True))  # async on CUDA

    def _settle(self, items: List, result):
        """Sync one in-flight batch and fill its slots.  Never raises: a
        device failure goes to every still-waiting caller."""
        try:
            ids, scores, boxes = (r.cpu().numpy() for r in result)  # sync point
            for i, (slot, _x, affine) in enumerate(items):
                slot.result = (ids[i], scores[i], invert_affine_to_boxes(boxes[i], affine))
                slot.done.set()
            self._served += len(items)
        except Exception as exc:  # noqa: BLE001 -- forwarded to the callers
            for slot, _x, _a in items:
                if not slot.done.is_set():
                    slot.error = exc
                    slot.done.set()

    def _run(self):
        pending: List[Tuple[List, object]] = []
        while not self._stop.is_set():
            # block for traffic only when nothing is in flight
            items = self._collect(block=not pending)
            if items:
                try:
                    pending.append((items, self._dispatch(items)))
                except Exception as exc:  # noqa: BLE001 -- forwarded to the callers
                    for slot, _x, _a in items:
                        slot.error = exc
                        slot.done.set()
                    continue
            # drain at once when the queue went idle, else past the depth
            while pending and (len(pending) >= self._max_in_flight or not items):
                p_items, p_result = pending.pop(0)
                self._settle(p_items, p_result)
                self._fill.append(len(p_items))
                self._lat_ms.append((time.perf_counter() - p_items[0][0].t_enqueue) * 1e3)
        # shutdown: fail callers still enqueued, settle batches in flight
        self._fail_queued()
        for items, result in pending:
            self._settle(items, result)
