"""Dataset base API (counterpart of ``viddet_tpu/data/base.py``).

``__getitem__ -> (image uint8 HWC RGB, label float32 (M, 6))`` with label
columns ``[x1, y1, x2, y2, class_id, difficult]`` and no padding (the
loader pads to a static count with -1).  Every dataset also exposes
``classes`` (display names) and ``wn_classes`` (WordNet ids, for
cross-dataset combination).

Images are read with the port's codec (``native``: JPEG, PNG and BMP) and
turned upright by their EXIF orientation, which together equal the JAX
package's ``cv2.imread(path, IMREAD_COLOR)`` and BGR-to-RGB swap bit for
bit.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from viddet_tpu_torch.native import PNG_SIGNATURE, decode_bmp, decode_jpeg, decode_png
from viddet_tpu_torch.utils.image import apply_orientation, exif_orientation_of


class DetectionDataset:
    classes: Sequence[str] = ()
    wn_classes: Sequence[str] = ()

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    @property
    def num_classes(self) -> int:
        return len(self.classes)

    def statistics(self) -> dict:
        """Images and boxes per class."""
        per_class_boxes = np.zeros(self.num_classes, np.int64)
        per_class_images = np.zeros(self.num_classes, np.int64)
        total_boxes = 0
        for i in range(len(self)):
            label = self.label(i)
            ids = label[:, 4].astype(int)
            ids = ids[ids >= 0]
            total_boxes += len(ids)
            for c in np.unique(ids):
                per_class_images[c] += 1
            np.add.at(per_class_boxes, ids, 1)
        return {
            "images": len(self),
            "boxes": int(total_boxes),
            "boxes_per_class": {
                self.classes[c]: int(per_class_boxes[c]) for c in range(self.num_classes)
            },
            "images_per_class": {
                self.classes[c]: int(per_class_images[c]) for c in range(self.num_classes)
            },
        }

    # Subclasses should override `label(idx)` if labels are cheaper than
    # decoding the image; default decodes both.
    def label(self, idx: int) -> np.ndarray:
        return self[idx][1]


def decode_rgb(data: bytes, name: str) -> np.ndarray:
    """JPEG, PNG or BMP bytes (told apart by their magic bytes) -> upright
    (H, W, 3) uint8 RGB; raises ValueError for bytes it cannot decode
    (``name`` says which)."""
    if data[:2] == b"\xff\xd8":
        return apply_orientation(decode_jpeg(data, name), exif_orientation_of(data))
    if data[:8] == PNG_SIGNATURE:
        return decode_png(data, name)
    if data[:2] == b"BM":
        return decode_bmp(data, name)
    raise ValueError(f"{name}: not a JPEG, PNG or BMP image")


def imread_rgb(path: str) -> np.ndarray:
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as exc:
        raise FileNotFoundError(f"failed to read image: {path}") from exc
    return decode_rgb(data, path)
