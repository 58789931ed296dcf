"""Pascal VOC detection dataset (copy of ``viddet_tpu/data/voc.py``): parses
``Annotations/*.xml`` and ``ImageSets/Main/<split>.txt``; labels are
``[x1, y1, x2, y2, class_id, difficult]`` with VOC's 1-based pixels made
0-based.  Images are read with ``data.base.imread_rgb``.

Expected directory layout (standard VOCdevkit):
  root/VOC2007/{Annotations,ImageSets/Main,JPEGImages}"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import List, Sequence, Tuple

import numpy as np

from viddet_tpu_torch.data.base import DetectionDataset, imread_rgb
from viddet_tpu_torch.data.names import VOC_CLASSES, VOC_WN_IDS


class VOCDetection(DetectionDataset):
    classes = VOC_CLASSES
    wn_classes = VOC_WN_IDS

    def __init__(
        self,
        root: str,
        splits: Sequence[Tuple[str, str]] = (("2007", "trainval"), ("2012", "trainval")),
        keep_difficult: bool = True,
    ):
        self._root = root
        self._keep_difficult = keep_difficult
        self._items: List[Tuple[str, str]] = []  # (year_dir, image_id)
        self._index = {name: i for i, name in enumerate(self.classes)}
        for year, split in splits:
            year_dir = os.path.join(root, f"VOC{year}")
            list_file = os.path.join(year_dir, "ImageSets", "Main", f"{split}.txt")
            with open(list_file) as f:
                for line in f:
                    image_id = line.strip().split()[0]
                    if image_id:
                        self._items.append((year_dir, image_id))
        self._label_cache: dict = {}

    def __len__(self) -> int:
        return len(self._items)

    def image_path(self, idx: int) -> str:
        year_dir, image_id = self._items[idx]
        return os.path.join(year_dir, "JPEGImages", f"{image_id}.jpg")

    def label(self, idx: int) -> np.ndarray:
        if idx in self._label_cache:
            return self._label_cache[idx]
        year_dir, image_id = self._items[idx]
        xml_path = os.path.join(year_dir, "Annotations", f"{image_id}.xml")
        rows = []
        root = ET.parse(xml_path).getroot()
        for obj in root.iter("object"):
            name = obj.find("name").text.strip().lower()
            if name not in self._index:
                continue
            difficult = int((obj.find("difficult").text or "0")) if obj.find("difficult") is not None else 0
            if difficult and not self._keep_difficult:
                continue
            bb = obj.find("bndbox")
            # VOC pixel indices are 1-based; convert to 0-based coordinates.
            x1 = float(bb.find("xmin").text) - 1
            y1 = float(bb.find("ymin").text) - 1
            x2 = float(bb.find("xmax").text) - 1
            y2 = float(bb.find("ymax").text) - 1
            rows.append([x1, y1, x2, y2, self._index[name], difficult])
        label = np.asarray(rows, np.float32) if rows else np.zeros((0, 6), np.float32)
        self._label_cache[idx] = label
        return label

    def __getitem__(self, idx: int):
        return imread_rgb(self.image_path(idx)), self.label(idx)
