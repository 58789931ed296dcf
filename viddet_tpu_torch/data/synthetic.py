"""Synthetic detection dataset: coloured rectangles on noise backgrounds
(copy of ``viddet_tpu/data/synthetic.py``, the same seeded streams and
palette, so both packages draw the same frames and labels)."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from viddet_tpu_torch.data.base import DetectionDataset

_PALETTE = np.array(
    [[220, 40, 40], [40, 220, 40], [40, 40, 220], [220, 220, 40],
     [220, 40, 220], [40, 220, 220], [240, 140, 20], [140, 20, 240]],
    np.uint8,
)


class SyntheticDetection(DetectionDataset):
    """``num_images`` images of ``size`` px with 1-3 class-colored boxes."""

    def __init__(
        self,
        num_images: int = 16,
        size: int = 128,
        num_classes: int = 4,
        max_objects: int = 3,
        seed: int = 0,
    ):
        assert num_classes <= len(_PALETTE)
        self.classes = tuple(f"class{i}" for i in range(num_classes))
        self.wn_classes = tuple(f"n{90000000 + i}" for i in range(num_classes))
        self._n = num_images
        self._size = size
        self._num_classes = num_classes
        self._max_objects = max_objects
        self._seed = seed

    def __len__(self):
        return self._n

    def _rng(self, idx: int) -> np.random.Generator:
        return np.random.default_rng((self._seed, idx))

    def label(self, idx: int) -> np.ndarray:
        rng = self._rng(idx)
        s = self._size
        n_obj = int(rng.integers(1, self._max_objects + 1))
        rows = []
        for _ in range(n_obj):
            cls = int(rng.integers(self._num_classes))
            w = int(rng.integers(s // 6, s // 2))
            h = int(rng.integers(s // 6, s // 2))
            x1 = int(rng.integers(0, s - w))
            y1 = int(rng.integers(0, s - h))
            rows.append([x1, y1, x1 + w, y1 + h, cls, 0])
        return np.asarray(rows, np.float32)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        label = self.label(idx)
        rng = np.random.default_rng((self._seed, idx, 1))  # background noise
        img = rng.integers(90, 130, size=(self._size, self._size, 3)).astype(np.uint8)
        # redraw boxes deterministically from the label
        for x1, y1, x2, y2, cls, _d in label.astype(int):
            img[y1:y2, x1:x2] = _PALETTE[cls]
        return img, label
