"""ImageNet-DET detection dataset, VOC-style XML keyed by WordNet id (copy
of ``viddet_tpu/data/imgnetdet.py``), optionally restricted to the 30
ImageNet-VID classes.  The full class list comes from a devkit
``map_det.txt`` when present, else from the annotations' wnids, sorted.

Expected layout (standard ILSVRC2015):
  root/Annotations/DET/<split>/**/*.xml
  root/Data/DET/<split>/**/*.JPEG"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import List, Tuple

import numpy as np

from viddet_tpu_torch.data.base import DetectionDataset, imread_rgb
from viddet_tpu_torch.data.names import VID_WN_IDS, VID_CLASSES


class ImageNetDetection(DetectionDataset):
    def __init__(
        self,
        root: str,
        split: str = "train",
        vid_classes_only: bool = False,
        allow_empty: bool = False,
    ):
        self._root = root
        self._split = split
        ann_root = os.path.join(root, "Annotations", "DET", split)
        if not os.path.isdir(ann_root):
            raise FileNotFoundError(ann_root)

        xml_paths: List[str] = []
        for dirpath, _dirs, files in sorted(os.walk(ann_root)):
            xml_paths.extend(
                os.path.join(dirpath, f) for f in sorted(files) if f.endswith(".xml")
            )

        if vid_classes_only:
            wnids = list(VID_WN_IDS)
            names = list(VID_CLASSES)
        else:
            wnids = self._discover_wnids(root, xml_paths)
            names = wnids  # display = wnid unless a mapping file names them
            map_file = os.path.join(root, "devkit", "data", "map_det.txt")
            if os.path.exists(map_file):
                mapping = {}
                with open(map_file) as f:
                    for line in f:
                        parts = line.split()
                        if len(parts) >= 2:
                            mapping[parts[0]] = parts[-1]
                names = [mapping.get(w, w) for w in wnids]
        self.wn_classes = tuple(wnids)
        self.classes = tuple(names)
        self._index = {w: i for i, w in enumerate(wnids)}

        self._items: List[Tuple[str, np.ndarray]] = []
        for xml_path in xml_paths:
            label = self._parse(xml_path)
            if len(label) == 0 and not allow_empty:
                continue
            rel = os.path.relpath(xml_path, ann_root)[:-4]
            self._items.append((rel, label))

    @staticmethod
    def _discover_wnids(root: str, xml_paths: List[str]) -> List[str]:
        cache = os.path.join(root, ".viddet_tpu_det_classes.txt")
        if os.path.exists(cache):
            with open(cache) as f:
                return [l.strip() for l in f if l.strip()]
        wnids = set()
        for p in xml_paths:
            for obj in ET.parse(p).getroot().iter("object"):
                wnids.add(obj.find("name").text.strip())
        wnids = sorted(wnids)
        try:
            with open(cache, "w") as f:
                f.write("\n".join(wnids))
        except OSError:
            pass
        return wnids

    def _parse(self, xml_path: str) -> np.ndarray:
        rows = []
        for obj in ET.parse(xml_path).getroot().iter("object"):
            wnid = obj.find("name").text.strip()
            if wnid not in self._index:
                continue
            bb = obj.find("bndbox")
            rows.append([
                float(bb.find("xmin").text), float(bb.find("ymin").text),
                float(bb.find("xmax").text), float(bb.find("ymax").text),
                self._index[wnid], 0,
            ])
        return np.asarray(rows, np.float32) if rows else np.zeros((0, 6), np.float32)

    def __len__(self):
        return len(self._items)

    def image_path(self, idx: int) -> str:
        rel = self._items[idx][0]
        base = os.path.join(self._root, "Data", "DET", self._split, rel)
        for ext in (".JPEG", ".jpg", ".jpeg", ".png"):
            if os.path.exists(base + ext):
                return base + ext
        return base + ".JPEG"

    def label(self, idx: int) -> np.ndarray:
        return self._items[idx][1]

    def __getitem__(self, idx: int):
        return imread_rgb(self.image_path(idx)), self.label(idx)
