"""MS-COCO detection dataset, a pure-JSON parser (copy of
``viddet_tpu/data/coco.py``): the 80-class contiguous id mapping, xywh to
xyxy, crowd boxes carried in the ``difficult`` column, and each
annotation's ``area`` kept for the evaluator's size bins.

Expected layout:  root/annotations/instances_<split>.json
                  root/<split>/*.jpg"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np

from viddet_tpu_torch.data.base import DetectionDataset, imread_rgb
from viddet_tpu_torch.data.names import COCO_CLASSES


class COCODetection(DetectionDataset):
    classes = COCO_CLASSES

    def __init__(self, root: str, split: str = "val2017", min_object_area: float = 0.0,
                 skip_empty: bool = True, use_crowd: bool = True):
        self._root = root
        self._split = split
        ann_path = os.path.join(root, "annotations", f"instances_{split}.json")
        with open(ann_path) as f:
            data = json.load(f)

        cats = sorted(data["categories"], key=lambda c: c["id"])
        self._cat_to_contig: Dict[int, int] = {c["id"]: i for i, c in enumerate(cats)}
        self.classes = tuple(c["name"] for c in cats)
        self._contig_to_cat = {i: cid for cid, i in self._cat_to_contig.items()}

        images = {im["id"]: im for im in data["images"]}
        anns_by_image: Dict[int, List] = {}
        for ann in data["annotations"]:
            anns_by_image.setdefault(ann["image_id"], []).append(ann)

        self._items: List[Tuple[int, str, np.ndarray, np.ndarray]] = []
        for img_id, im in sorted(images.items()):
            rows = []
            areas = []
            for ann in anns_by_image.get(img_id, []):
                if ann.get("ignore", 0):
                    continue
                crowd = int(ann.get("iscrowd", 0))
                if crowd and not use_crowd:
                    continue
                x, y, w, h = ann["bbox"]
                if w * h < min_object_area or w <= 0 or h <= 0:
                    continue
                # clip to image bounds as the reference stack does
                x1 = max(0.0, x)
                y1 = max(0.0, y)
                x2 = min(float(im["width"]), x + w)
                y2 = min(float(im["height"]), y + h)
                if x2 <= x1 or y2 <= y1:
                    continue
                rows.append(
                    [x1, y1, x2, y2, self._cat_to_contig[ann["category_id"]], crowd]
                )
                # official S/M/L bins use the annotation's (segmentation)
                # area, which differs from bbox area on real COCO; keep it
                # as an eval sidecar (bbox-area fallback when absent)
                areas.append(float(ann.get("area", w * h)))
            if not rows and skip_empty:
                continue
            label = np.asarray(rows, np.float32) if rows else np.zeros((0, 6), np.float32)
            area_arr = np.asarray(areas, np.float64) if areas else np.zeros((0,), np.float64)
            self._items.append((img_id, im["file_name"], label, area_arr))

    def __len__(self):
        return len(self._items)

    def image_id(self, idx: int) -> int:
        return self._items[idx][0]

    def contiguous_to_category_id(self, contig: int) -> int:
        return self._contig_to_cat[int(contig)]

    def image_path(self, idx: int) -> str:
        return os.path.join(self._root, self._split, self._items[idx][1])

    def label(self, idx: int) -> np.ndarray:
        return self._items[idx][2]

    def gt_areas(self, idx: int) -> np.ndarray:
        """Per-annotation COCO ``area`` (segmentation area), aligned with
        ``label(idx)`` rows — the official S/M/L eval bins use this."""
        return self._items[idx][3]

    def __getitem__(self, idx: int):
        return imread_rgb(self.image_path(idx)), self.label(idx)
