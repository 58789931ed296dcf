"""Dataset base API (counterpart of ``viddet_tpu/data/base.py``).

``__getitem__ -> (image uint8 HWC RGB, label float32 (M, 6))`` with label
columns ``[x1, y1, x2, y2, class_id, difficult]`` and no padding (the
loader pads to a static count with -1).  Every dataset also exposes
``classes`` (display names) and ``wn_classes`` (WordNet ids, for
cross-dataset combination).

Images are read with the port's codec (``native``: JPEG, PNG, BMP, WebP,
GIF, PNM / PAM, TIFF, Sun raster, PFM and Radiance HDR) and turned upright
by their EXIF orientation (JPEG, PNG ``eXIf``, WebP ``EXIF``, a TIFF's
Orientation tag), which together equal the JAX package's
``cv2.imread(path, IMREAD_COLOR)`` and BGR-to-RGB swap bit for bit (for a
TIFF of orientation 5-8, ``cv2.imdecode``'s picture: OpenCV 5's ``imread``
returns nothing there).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from viddet_tpu_torch.native import PNG_SIGNATURE, decode_bmp, decode_jpeg, decode_png
from viddet_tpu_torch.native.gif import GIF_SIGNATURES, decode_gif
from viddet_tpu_torch.native.pnm import decode_pnm
from viddet_tpu_torch.native.stills import (
    HDR_SIGNATURES, SUN_SIGNATURE, decode_hdr, decode_pfm, decode_sunras, is_pfm,
)
from viddet_tpu_torch.native.tiff import TIFF_SIGNATURES, decode_tiff
from viddet_tpu_torch.native.webp import decode_webp
from viddet_tpu_torch.utils.image import apply_orientation, exif_orientation_of

# Formats cv2 reads that the port does not, by their magic bytes: a file of
# one of them raises naming it rather than as unknown bytes.
UNREAD_FORMATS = (
    ("AVIF", lambda d: d[4:8] == b"ftyp" and d[8:12] in (b"avif", b"avis")),
    ("JPEG 2000", lambda d: d[:12] == b"\0\0\0\x0cjP  \r\n\x87\n" or d[:4] == b"\xff\x4f\xff\x51"),
)


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
    """JPEG, PNG, BMP, WebP, GIF, PNM / PAM, TIFF, Sun raster, PFM or
    Radiance HDR bytes (told apart by their magic bytes, as
    ``cv2.imdecode`` tells them apart) -> upright (H, W, 3)
    uint8 RGB; raises ValueError for bytes it cannot decode (``name`` says
    which), naming the format of a file cv2 reads and the port does not."""
    if data[:2] == b"\xff\xd8":
        return apply_orientation(decode_jpeg(data, name), exif_orientation_of(data))
    if data[:8] == PNG_SIGNATURE:
        return decode_png(data, name)
    if data[:2] == b"BM":
        return decode_bmp(data, name)
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return decode_webp(data, name)
    if data[:6] in GIF_SIGNATURES:
        return decode_gif(data, name)
    if len(data) > 2 and data[0] == ord("P") and data[1] in b"1234567" and data[2:3].isspace():
        return decode_pnm(data, name)
    if data[:4] in TIFF_SIGNATURES:
        return decode_tiff(data, name)
    if data[:4] == SUN_SIGNATURE:
        return decode_sunras(data, name)
    if is_pfm(data):
        return decode_pfm(data, name)
    if data.startswith(HDR_SIGNATURES):
        return decode_hdr(data, name)
    for kind, matches in UNREAD_FORMATS:
        if matches(data):
            raise ValueError(f"{name}: {kind} images are not decoded by the port")
    raise ValueError(f"{name}: not a JPEG, PNG, BMP, WebP, GIF or PNM image, nor a TIFF, Sun "
                     f"raster, PFM or Radiance HDR one")


def imread_rgb(path: str) -> np.ndarray:
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as exc:
        raise FileNotFoundError(f"failed to read image: {path}") from exc
    return decode_rgb(data, path)
