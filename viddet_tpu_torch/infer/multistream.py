"""Multi-stream continuously-batched detection with temporal clip assembly
(counterpart of the loop half of ``viddet_tpu/infer/multistream.py``).

* **N sources -> one batch assembler.**  Each source runs on its own
  feeder thread into a shared ready queue; the submit loop fills
  fixed-size device batches with items from any stream, so one slow or
  ended stream never starves the card.  Batches drain in submit order,
  which keeps each stream's frames in order.
* **Per-stream k-frame windows.**  Temporal models take (B, k, H, W, 3)
  clips and predict the centre frame; ``ClipBuffer`` keeps a stream's last
  k frames and emits a clip every ``stride`` frames once the window is
  full.  k = 1 passes frames through.
* **Partial-batch flush on a deadline.**  A live source may not fill a
  batch promptly; ``flush_ms`` after a batch's first item, the partial
  batch is padded and submitted.  Ended sources always flush.

Every batch is padded to ``batch_size`` (and a clip to k frames), so the
device sees one shape.  ``stream_detect_videos`` runs N video files
through it, any mix of Motion-JPEG AVI and MPEG-4 Part 2 or Motion-JPEG
MP4 / QuickTime (``open_sources``: the C++ ``NativeFrameSource`` when
nothing is drawn, else ``FrameSource``; no fallback between them).
"""

from __future__ import annotations

import os
import queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from viddet_tpu_torch.core.platform import resolve_device
from viddet_tpu_torch.data.transforms import invert_affine_to_boxes
from viddet_tpu_torch.infer.service import to_device_batch
from viddet_tpu_torch.infer.stream import detection_line, stop_aware_put, video_source
from viddet_tpu_torch.utils.image import draw_detections
from viddet_tpu_torch.utils.video import VideoWriter


@dataclass
class StreamItem:
    """One ready unit of work: a frame (k=1) or a key-frame clip."""

    stream: str
    frame_idx: int  # index of the KEY frame within its stream
    rgb: Optional[np.ndarray]  # original key frame (None when not kept)
    x: np.ndarray  # (H, W, 3) frame or (k, H, W, 3) clip, preprocessed
    affine: np.ndarray  # letterbox affine of the key frame


class ClipBuffer:
    """Per-stream sliding window turning frames into key-frame clips.

    The VID dataset's window semantics (``data/imgnetvid.py``: ``window`` /
    ``stride``): a clip is the last ``k`` frames and its prediction target
    is the centre frame (index ``k // 2`` from the oldest), as
    ``models/temporal.py`` predicts it.  One clip per ``stride`` pushed
    frames once the window is full, so stride 1 yields a detection for
    every frame after a (k - 1 - k//2)-frame lead-in delay.
    """

    def __init__(self, stream: str, k: int, stride: int = 1):
        if k < 1 or stride < 1:
            raise ValueError(f"k and stride must be >= 1, got {k}, {stride}")
        self.stream = stream
        self.k = k
        self.stride = stride
        self._frames: List[Tuple[int, Optional[np.ndarray], np.ndarray, np.ndarray]] = []
        self._pushed = 0

    def push(self, idx, rgb, x, affine) -> List[StreamItem]:
        """Add one frame; return the clips it completes (0 or 1)."""
        self._frames.append((idx, rgb, x, affine))
        if len(self._frames) > self.k:
            self._frames.pop(0)
        self._pushed += 1
        if len(self._frames) < self.k or (self._pushed - self.k) % self.stride:
            return []
        key = self._frames[self.k // 2]
        # k = 1 passes the frame through unwrapped: single-frame models take
        # (B, H, W, 3), not (B, 1, H, W, 3)
        clip = key[2] if self.k == 1 else np.stack([f[2] for f in self._frames])
        return [StreamItem(self.stream, key[0], key[1], clip, key[3])]

    def flush(self) -> List[StreamItem]:
        """End of stream: push copies of the final frame until the last real
        frame has served as a key, so the stream's tail (the k-1-k//2
        frames past the final key) still gets detections.  The (k-1)//2
        lead-in frames at the stream's start are never keys, as in the VID
        dataset's windows."""
        if self.k == 1 or self._pushed == 0:
            return []
        out: List[StreamItem] = []
        last = self._frames[-1]
        for _ in range(self.k + self.stride):
            emitted = self.push(last[0], last[1], last[2], last[3])
            out.extend(emitted)
            if emitted and emitted[-1].frame_idx >= last[0]:
                break
        return out


@dataclass
class _SourceState:
    feeder: threading.Thread
    done: bool = False


@dataclass
class _StreamError:
    """A feeder thread's failure, forwarded; the consumer raises it."""

    stream: str
    exc: BaseException


def _put(out_q: "queue.Queue", item, stop: threading.Event) -> bool:
    return stop_aware_put(out_q, item, stop)


def _feeder(name: str, source, buf: ClipBuffer, out_q: "queue.Queue", stop: threading.Event):
    """Feeder thread: drain one source through its clip buffer.

    A decode or transform error is forwarded to the consumer, which raises
    it, rather than ending the stream early as if it were complete."""
    try:
        try:
            for idx, rgb, x, affine in source:
                for item in buf.push(idx, rgb, x, affine):
                    _put(out_q, item, stop)
                if stop.is_set():
                    break
            if not stop.is_set():
                for item in buf.flush():
                    _put(out_q, item, stop)
        except Exception as exc:  # noqa: BLE001 -- forwarded, not swallowed
            _put(out_q, _StreamError(name, exc), stop)
    finally:
        _put(out_q, name, stop)  # end-of-stream sentinel (a str, not a StreamItem)


def stream_detect_multi(
    sources: Dict[str, Iterator],
    infer: Callable,
    batch_size: int,
    input_shape: Tuple[int, int],
    *,
    k: int = 1,
    stride: int = 1,
    flush_ms: float = 200.0,
    max_in_flight: int = 2,
    device=None,
) -> Iterator[Tuple[str, int, Optional[np.ndarray], np.ndarray, np.ndarray, np.ndarray,
                    np.ndarray]]:
    """Continuously-batched detection over N frame sources.

    Args:
      sources: name -> iterator of (idx, rgb, x, affine).
      infer: ``(batch on device) -> (ids, scores, boxes)``
        (``cli.common.make_predictor``), batch (B, H, W, 3) for k = 1 or
        (B, k, H, W, 3) clips.
      k, stride: temporal window (1 = single-frame model).
      flush_ms: longest wait for a full batch, from its first item, while
        any stream is live; the partial batch is then padded and submitted.
      max_in_flight: device batches kept in flight.
      device: where ``infer`` runs; ``cuda:0`` unless the caller says.

    Yields (stream, frame_idx, rgb, affine, ids, scores, boxes): globally in
    batch-completion order, per stream in frame order.
    """
    device = resolve_device(device)
    h, w = input_shape
    ready: "queue.Queue" = queue.Queue(maxsize=4 * batch_size)
    stop = threading.Event()
    states: Dict[str, _SourceState] = {}
    for name, src in sources.items():
        buf = ClipBuffer(name, k, stride)
        t = threading.Thread(target=_feeder, args=(name, src, buf, ready, stop), daemon=True)
        states[name] = _SourceState(feeder=t)
        t.start()

    pending: List[Tuple[List[StreamItem], object]] = []

    def submit(items: List[StreamItem]):
        batch = np.stack([it.x for it in items])
        if batch.shape[-3:-1] != (h, w):
            raise ValueError(f"frames of {batch.shape[-3:-1]} do not match input_shape {(h, w)}")
        pending.append((items, infer(to_device_batch(batch, batch_size, device))))

    def drain():
        items, result = pending.pop(0)
        ids, scores, boxes = (r.cpu().numpy() for r in result)  # sync point
        for i, it in enumerate(items):
            yield it.stream, it.frame_idx, it.rgb, it.affine, ids[i], scores[i], boxes[i]

    live = len(states)
    batch_items: List[StreamItem] = []
    # The flush deadline is anchored to the FIRST item of the partial batch:
    # a per-get timeout would restart with every frame, so a source faster
    # than 1000 / flush_ms frames a second would never flush and the
    # latency bound would fall back to the full-batch wait.
    batch_deadline = 0.0
    try:
        while live > 0 or batch_items:
            if batch_items:
                wait = batch_deadline - time.monotonic()
            else:
                wait = flush_ms / 1e3 if live else 0.01
            item = None
            if wait > 0:
                try:
                    item = ready.get(timeout=wait)
                except queue.Empty:
                    item = None
            if isinstance(item, _StreamError):
                raise RuntimeError(f"stream '{item.stream}' failed during decode") from item.exc
            if isinstance(item, str):  # end-of-stream sentinel
                states[item].done = True
                live -= 1
                continue
            if item is not None:
                if not batch_items:
                    batch_deadline = time.monotonic() + flush_ms / 1e3
                batch_items.append(item)
            if batch_items and (len(batch_items) == batch_size or item is None or live == 0):
                submit(batch_items)
                batch_items = []
                if len(pending) >= max_in_flight:
                    yield from drain()
            elif item is None and pending:
                # The queue went idle with nothing to submit: hand over the
                # finished results now rather than at the next submit (a
                # stalled live source would otherwise hold them back, as
                # DetectionService's idle drain also prevents).
                yield from drain()
        while pending:
            yield from drain()
    finally:
        stop.set()


def open_sources(paths: Sequence, transform, *, every: int = 1, prefer_native: bool = True,
                 need_rgb: bool = True) -> Dict[str, Iterator]:
    """name -> frame source for each video path: ``NativeFrameSource`` when
    ``prefer_native`` and not ``need_rgb``, else ``FrameSource``.  Names are
    the basenames, deduplicated with ``#i`` suffixes so one file can be
    streamed twice.  A source that cannot be read raises here, after the
    ones opened before it are closed."""
    sources: Dict[str, Iterator] = {}
    try:
        for i, path in enumerate(paths):
            name = os.path.basename(str(path))
            if name in sources:
                name = f"{name}#{i}"
            sources[name] = video_source(path, transform, every,
                                         draw=need_rgb or not prefer_native)
    except BaseException:
        for src in sources.values():
            src.close()
        raise
    return sources


def stream_detect_videos(
    paths: Sequence,
    infer: Callable,
    transform,
    class_names: Sequence[str],
    *,
    output_dir: str,
    thresh: float = 0.5,
    batch_size: int = 8,
    every: int = 1,
    k: int = 1,
    stride: int = 1,
    flush_ms: float = 200.0,
    draw: bool = True,
    save_detections: bool = False,
    logger=None,
    device=None,
) -> dict:
    """N videos -> per-stream ``{stem}_det.mp4`` / ``{stem}_det.txt`` through
    one shared batch (``stream_detect_multi``; k > 1 for a temporal model).
    ``flush_ms`` bounds how long a partial batch waits.  Returns {frames,
    seconds, fps, per_stream}."""
    sources = open_sources(paths, transform, every=every, prefer_native=True, need_rgb=draw)
    writers: Dict[str, VideoWriter] = {}
    det_files: Dict[str, object] = {}
    per_stream = {name: 0 for name in sources}
    t0 = time.perf_counter()
    try:
        os.makedirs(output_dir, exist_ok=True)
        for name, src in sources.items():
            # 'a.avi#1' must not collapse onto the stem of 'a.avi' (splitext
            # would take the '#1' with the extension): keep the tag
            base, _, tag = name.partition("#")
            stem = os.path.splitext(base)[0] + (f"_{tag}" if tag else "")
            if draw:
                writers[name] = VideoWriter(os.path.join(output_dir, f"{stem}_det.mp4"),
                                            src.fps / every, (src.width, src.height))
            if save_detections:
                det_files[name] = open(os.path.join(output_dir, f"{stem}_det.txt"), "w")
        for name, idx, rgb, affine, ids, scores, boxes in stream_detect_multi(
                {n: iter(s) for n, s in sources.items()}, infer, batch_size, transform.size,
                k=k, stride=stride, flush_ms=flush_ms, device=device):
            restored = invert_affine_to_boxes(boxes, affine)
            df = det_files.get(name)
            if df is not None:
                df.write("".join(
                    detection_line(idx, class_names[int(cid)], s, rb)
                    for cid, s, rb in zip(ids, scores, restored) if cid >= 0 and s >= thresh))
            wr = writers.get(name)
            if wr is not None and rgb is not None:
                wr.write(draw_detections(rgb, restored, ids, scores, class_names, thresh))
            per_stream[name] += 1
    finally:
        for wr in writers.values():
            wr.close()
        for df in det_files.values():
            df.close()
        for src in sources.values():
            src.close()
    dt = time.perf_counter() - t0
    n = sum(per_stream.values())
    stats = {"frames": n, "seconds": dt, "fps": n / dt if dt > 0 else 0.0,
             "per_stream": per_stream}
    if logger:
        logger.info("%d stream(s): %d frames in %.2fs (%.1f fps aggregate)", len(sources), n, dt,
                    stats["fps"])
    return stats
