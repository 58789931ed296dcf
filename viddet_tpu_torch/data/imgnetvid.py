"""ImageNet-VID detection dataset with temporal sampling (copy of
``viddet_tpu/data/imgnetvid.py``): per-frame VOC-style XML with
``trackid`` (label column 6, for the motion-IoU metric), 30 classes, and
the knobs

* ``every_n``         keep every nth frame of each snippet;
* ``frames_fraction`` keep an evenly spaced fraction of each snippet;
* ``window`` / ``stride`` items become ``[window, H, W, 3]`` clips (frames
  ``t, t+stride, ...``) labelled on the key (centre) frame;
* ``allow_empty``     keep frames with no boxes.

Expected layout (standard ILSVRC2015):
  root/Annotations/VID/<split>/<snippet...>/NNNNNN.xml
  root/Data/VID/<split>/<snippet...>/NNNNNN.JPEG"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

import numpy as np

from viddet_tpu_torch.data.base import DetectionDataset, imread_rgb
from viddet_tpu_torch.data.names import VID_CLASSES, VID_WN_IDS


class ImageNetVidDetection(DetectionDataset):
    classes = VID_CLASSES
    wn_classes = VID_WN_IDS

    def __init__(
        self,
        root: str,
        split: str = "val",
        every_n: int = 1,
        frames_fraction: Optional[float] = None,
        window: int = 1,
        stride: int = 1,
        allow_empty: bool = False,
        cache_labels: bool = True,
    ):
        self._root = root
        self._split = split
        self._window = window
        self._stride = stride
        self._index = {wn: i for i, wn in enumerate(self.wn_classes)}
        ann_root = os.path.join(root, "Annotations", "VID", split)
        if not os.path.isdir(ann_root):
            raise FileNotFoundError(ann_root)

        # snippet -> ordered frame stems
        self._snippets: List[Tuple[str, List[str]]] = []
        for dirpath, dirnames, filenames in sorted(os.walk(ann_root)):
            frames = sorted(f[:-4] for f in filenames if f.endswith(".xml"))
            if not frames:
                continue
            rel = os.path.relpath(dirpath, ann_root)
            if every_n > 1:
                frames = frames[::every_n]
            if frames_fraction is not None and 0 < frames_fraction < 1:
                keep = max(1, int(round(len(frames) * frames_fraction)))
                idxs = np.linspace(0, len(frames) - 1, keep).round().astype(int)
                frames = [frames[i] for i in sorted(set(idxs.tolist()))]
            self._snippets.append((rel, frames))

        self._label_cache: Dict[Tuple[str, str], np.ndarray] = {} if cache_labels else None

        # items: (snippet_idx, key_frame_pos)
        self._items: List[Tuple[int, int]] = []
        half = (window - 1) // 2 * stride
        for si, (rel, frames) in enumerate(self._snippets):
            lo = half
            hi = len(frames) - ((window - 1) * stride - half)
            for pos in range(lo, max(hi, lo if window == 1 else 0)):
                if window > 1 and (pos - half < 0 or pos - half + (window - 1) * stride >= len(frames)):
                    continue
                if not allow_empty:
                    label = self._load_label(rel, frames[pos])
                    if len(label) == 0:
                        continue
                self._items.append((si, pos))

    # ------------------------------------------------------------------

    def _ann_path(self, rel: str, stem: str) -> str:
        return os.path.join(self._root, "Annotations", "VID", self._split, rel, f"{stem}.xml")

    def _img_path(self, rel: str, stem: str) -> str:
        base = os.path.join(self._root, "Data", "VID", self._split, rel, stem)
        for ext in (".JPEG", ".jpg", ".jpeg", ".png"):
            if os.path.exists(base + ext):
                return base + ext
        return base + ".JPEG"

    def _load_label(self, rel: str, stem: str) -> np.ndarray:
        key = (rel, stem)
        if self._label_cache is not None and key in self._label_cache:
            return self._label_cache[key]
        rows = []
        tree = ET.parse(self._ann_path(rel, stem))
        for obj in tree.getroot().iter("object"):
            wnid = obj.find("name").text.strip()
            if wnid not in self._index:
                continue
            trackid = int(obj.find("trackid").text) if obj.find("trackid") is not None else -1
            bb = obj.find("bndbox")
            rows.append([
                float(bb.find("xmin").text), float(bb.find("ymin").text),
                float(bb.find("xmax").text), float(bb.find("ymax").text),
                self._index[wnid], 0, trackid,
            ])
        label = np.asarray(rows, np.float32) if rows else np.zeros((0, 7), np.float32)
        if self._label_cache is not None:
            self._label_cache[key] = label
        return label

    # ------------------------------------------------------------------

    def __len__(self):
        return len(self._items)

    @property
    def num_snippets(self) -> int:
        return len(self._snippets)

    def frame_key(self, idx: int) -> Tuple[str, str]:
        """(snippet_rel_path, frame_stem) of the item's key frame."""
        si, pos = self._items[idx]
        rel, frames = self._snippets[si]
        return rel, frames[pos]

    def snippet_and_position(self, idx: int) -> Tuple[int, int]:
        return self._items[idx]

    def label(self, idx: int) -> np.ndarray:
        rel, stem = self.frame_key(idx)
        return self._load_label(rel, stem)

    def snippet_labels(self, snippet_idx: int) -> List[np.ndarray]:
        """All frame labels of a snippet (for motion-IoU evaluation)."""
        rel, frames = self._snippets[snippet_idx]
        return [self._load_label(rel, s) for s in frames]

    def __getitem__(self, idx: int):
        si, pos = self._items[idx]
        rel, frames = self._snippets[si]
        label = self._load_label(rel, frames[pos])
        if self._window == 1:
            return imread_rgb(self._img_path(rel, frames[pos])), label
        half = (self._window - 1) // 2 * self._stride
        clip_positions = [
            pos - half + k * self._stride for k in range(self._window)
        ]
        clip = np.stack(
            [imread_rgb(self._img_path(rel, frames[p])) for p in clip_positions]
        )
        return clip, label
