"""Batching and prefetching data loader (copy of
``viddet_tpu/data/loader.py``, numpy only).

Images are stacked and labels padded to a static count of boxes with -1,
so every batch has one shape (and the card one cuDNN algorithm choice).

Prefetching: worker threads decode and transform whole batches ahead of
the consumer, which receives them in order.  The port's JPEG decoder
(``native``) is called through ``ctypes`` and the resize runs in torch
int32 arithmetic; both release the GIL, so threads decode in parallel.

Multi-scale training: pass ``sizes=[(320,320)...(608,608)]`` and the loader
draws the target size every ``size_interval`` batches from that fixed
bucket list.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

MAX_GT_BOXES = 100  # static padded GT count; VOC/COCO images rarely exceed it


def pad_label(label: np.ndarray, max_boxes: int = MAX_GT_BOXES) -> np.ndarray:
    """(M, 6) -> (max_boxes, 6), -1 padded; overflow boxes dropped.

    Overflow is NOT silent at the loader level: DetectionLoader counts dropped
    boxes per epoch (``dropped_boxes``) and the train CLIs log the total, with
    ``--max-gt-boxes`` to raise the static pad for crowded datasets.
    """
    out = -np.ones((max_boxes, label.shape[1] if label.size else 6), np.float32)
    m = min(len(label), max_boxes)
    if m:
        out[:m] = label[:m]
    return out


class DetectionLoader:
    """Iterates (images (B,H,W,3) f32, boxes (B,M,4), ids (B,M), extra...).

    Args:
      dataset: DetectionDataset.
      transform: callable(image, label, rng) -> (image, label) for training,
        or callable(image, label) -> (image, label, affine) for eval.
      batch_size: global batch size.
      train: shuffling + rng-driven transform + drop_last.
      sizes: list of (h, w) buckets; a size is drawn per `size_interval`
        batches (train only; eval uses transform's fixed size).
      num_workers: prefetch threads (0 = synchronous).
      seed: RNG seed for shuffling + augmentation.
    """

    def __init__(
        self,
        dataset,
        transform,
        batch_size: int,
        train: bool = False,
        sizes: Optional[Sequence[Tuple[int, int]]] = None,
        size_interval: int = 10,
        num_workers: int = 4,
        seed: int = 0,
        max_boxes: int = MAX_GT_BOXES,
        shard: Optional[Tuple[int, int]] = None,
    ):
        if shard is not None:
            index, count = shard
            if not (0 <= index < count):
                raise ValueError(f"shard index {index} not in [0, {count})")
        self.dataset = dataset
        self.transform = transform
        self.batch_size = batch_size
        self.train = train
        self.sizes = list(sizes) if sizes else None
        self.size_interval = size_interval
        self.num_workers = num_workers
        self.seed = seed
        self.max_boxes = max_boxes
        self.shard = shard
        self._epoch = 0
        # GT boxes dropped by the static pad this epoch (reset per __iter__);
        # incremented under _count_lock from worker threads.
        self.dropped_boxes = 0
        self._count_lock = threading.Lock()

    def __len__(self) -> int:
        n = self._shard_len(len(self.dataset))
        if self.train:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _shard_len(self, n: int) -> int:
        """Per-shard sample count.  Training shards are truncated to the
        COMMON floor so every host steps the same number of batches (a
        divergent count would deadlock the collectives); eval shards keep
        their strided slice (counts may differ by one)."""
        if self.shard is None:
            return n
        index, count = self.shard
        return n // count if self.train else len(range(index, n, count))

    def _sample(self, idx: int, rng: np.random.Generator, size):
        image, label = self.dataset[idx]
        if self.train:
            transform = self.transform
            if size is not None and size != transform.size:
                # per-call copy: workers run concurrently with different
                # multi-scale bucket sizes, so the shared transform must
                # never be mutated
                import dataclasses as _dc

                transform = _dc.replace(transform, size=size)
            image, label = transform(image, label, rng)
            affine = None
        else:
            image, label, affine = self.transform(image, label)
        if len(label) > self.max_boxes:
            with self._count_lock:
                self.dropped_boxes += len(label) - self.max_boxes
        return image, pad_label(label, self.max_boxes), affine, idx

    def __iter__(self) -> Iterator:
        epoch = self._epoch
        self._epoch += 1
        self.dropped_boxes = 0
        n = len(self.dataset)
        order = np.arange(n)
        # The master rng is shard-INDEPENDENT: every host draws the same
        # permutation (and the same multi-scale size schedule below), then
        # takes its own disjoint strided slice — SPMD multi-host data
        # loading without any cross-host communication.
        master = np.random.default_rng((self.seed, epoch))
        if self.train:
            master.shuffle(order)
        if self.shard is not None:
            order = order[self.shard[0] :: self.shard[1]]
            order = order[: self._shard_len(n)]
        if self.train:
            order = order[: len(self) * self.batch_size]

        # Per-batch target size (train multi-scale).
        num_batches = len(self)
        batch_sizes: List = [None] * num_batches
        if self.train and self.sizes:
            current = self.sizes[int(master.integers(len(self.sizes)))]
            for b in range(num_batches):
                if b % self.size_interval == 0:
                    current = self.sizes[int(master.integers(len(self.sizes)))]
                batch_sizes[b] = current

        def assemble(results):
            images = np.stack([r[0] for r in results])
            labels = np.stack([r[1] for r in results])
            boxes = labels[:, :, :4]
            ids = labels[:, :, 4].astype(np.int32)
            difficult = labels[:, :, 5] if labels.shape[2] > 5 else None
            affines = (
                np.stack([r[2] for r in results]) if results[0][2] is not None else None
            )
            idxs = np.asarray([r[3] for r in results])
            return images, boxes, ids, difficult, affines, idxs

        if self.num_workers <= 0:
            for b in range(num_batches):
                chunk = order[b * self.batch_size : (b + 1) * self.batch_size]
                rngs = [np.random.default_rng((self.seed, epoch, int(i))) for i in chunk]
                yield assemble(
                    [self._sample(int(i), r, batch_sizes[b]) for i, r in zip(chunk, rngs)]
                )
            return

        # Threaded prefetch: workers fill per-batch slots; ordered delivery.
        # The bounded token queue caps how far ahead workers run (and hence
        # how many assembled batches sit in `pending`).
        out_q: "queue.Queue" = queue.Queue(maxsize=self.num_workers * 2)
        task_q: "queue.Queue" = queue.Queue()
        for b in range(num_batches):
            task_q.put(b)

        results_lock = threading.Lock()
        pending = {}  # b -> (batch | None, exc | None)
        stop = threading.Event()

        def worker():
            while not stop.is_set():
                try:
                    b = task_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    chunk = order[b * self.batch_size : (b + 1) * self.batch_size]
                    rngs = [
                        np.random.default_rng((self.seed, epoch, int(i))) for i in chunk
                    ]
                    batch = assemble(
                        [
                            self._sample(int(i), r, batch_sizes[b])
                            for i, r in zip(chunk, rngs)
                        ]
                    )
                    item = (batch, None)
                except BaseException as exc:
                    # Propagate instead of dying silently: a corrupt image or
                    # missing file must surface in the consumer, not hang it.
                    item = (None, exc)
                with results_lock:
                    pending[b] = item
                # Bounded put with a stop check so an abandoned iterator
                # (e.g. eval --max-images breaking out early) never leaves a
                # worker blocked forever on a full queue.
                while not stop.is_set():
                    try:
                        out_q.put(b, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        threads = [
            threading.Thread(target=worker, daemon=True)
            for _ in range(min(self.num_workers, num_batches))
        ]
        for t in threads:
            t.start()

        delivered = 0
        next_batch = 0
        try:
            while delivered < num_batches:
                out_q.get()
                while True:
                    with results_lock:
                        item = pending.pop(next_batch, None)
                    if item is None:
                        break
                    batch, exc = item
                    if exc is not None:
                        raise RuntimeError(
                            f"loader worker failed on batch {next_batch}"
                        ) from exc
                    yield batch
                    delivered += 1
                    next_batch += 1
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=2.0)
