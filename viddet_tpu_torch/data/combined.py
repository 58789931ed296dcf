"""Cross-dataset combination by WordNet-id class union (copy of
``viddet_tpu/data/combined.py``): concatenates datasets and remaps each
child's class ids into the union, so VOC "dog" (n02084071) and VID "dog"
land in the same output class."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from viddet_tpu_torch.data.base import DetectionDataset


class CombinedDetection(DetectionDataset):
    def __init__(self, datasets: Sequence[DetectionDataset]):
        assert datasets, "need at least one dataset"
        self._datasets = list(datasets)

        # Union classes in first-seen order, keyed by wnid.
        union: List[Tuple[str, str]] = []  # (wnid, display name)
        seen = {}
        for ds in self._datasets:
            assert len(ds.wn_classes) == len(ds.classes), (
                f"{type(ds).__name__} must expose wn_classes aligned with classes"
            )
            if any(not w for w in ds.wn_classes):
                # empty wnids would all key to one union class, silently
                # remapping every label of this child to class 0
                raise ValueError(
                    f"{type(ds).__name__} has empty wn_classes entries — "
                    "combination is keyed by wnid and needs them unique"
                )
            for wnid, name in zip(ds.wn_classes, ds.classes):
                if wnid not in seen:
                    seen[wnid] = len(union)
                    union.append((wnid, name))
        self.wn_classes = tuple(w for w, _ in union)
        self.classes = tuple(n for _, n in union)

        # Per-child contiguous remap: child class id -> union class id.
        self._remaps = [
            np.asarray([seen[w] for w in ds.wn_classes], np.int64)
            for ds in self._datasets
        ]
        self._offsets = np.cumsum([0] + [len(ds) for ds in self._datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def _locate(self, idx: int) -> Tuple[int, int]:
        if idx < 0 or idx >= len(self):
            raise IndexError(idx)
        child = int(np.searchsorted(self._offsets, idx, side="right") - 1)
        return child, idx - int(self._offsets[child])

    def _remap_label(self, child: int, label: np.ndarray) -> np.ndarray:
        label = label.copy()
        if len(label):
            ids = label[:, 4].astype(np.int64)
            valid = ids >= 0
            label[valid, 4] = self._remaps[child][ids[valid]].astype(np.float32)
        return label

    def label(self, idx: int) -> np.ndarray:
        child, local = self._locate(idx)
        return self._remap_label(child, self._datasets[child].label(local))

    def __getitem__(self, idx: int):
        child, local = self._locate(idx)
        image, label = self._datasets[child][local]
        return image, self._remap_label(child, label)
