"""Host-side inference transform (copy of the ``viddet_tpu/data/transforms.py``
pieces the serving path uses).

The JAX package resizes with OpenCV; the port resizes with
``torch.nn.functional.interpolate(mode="bilinear", align_corners=False,
antialias=False)``, which samples at the same half-pixel centres as
``cv2.INTER_LINEAR``.  OpenCV interpolates uint8 in fixed point, so the two
can differ by one uint8 level.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize(image: np.ndarray) -> np.ndarray:
    """uint8 HWC RGB -> float32 normalized by ImageNet stats."""
    out = image.astype(np.float32)
    out /= 255.0
    out -= IMAGENET_MEAN
    out /= IMAGENET_STD
    return out


def _resize(image: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bilinear uint8 HWC resize, rounded back to uint8."""
    x = torch.from_numpy(np.ascontiguousarray(image)).permute(2, 0, 1)[None]
    y = F.interpolate(
        x.float(), size=(h, w), mode="bilinear", align_corners=False,
        antialias=False,
    )
    y = y.round_().clamp_(0, 255).to(torch.uint8)
    return y[0].permute(1, 2, 0).contiguous().numpy()


def resize_plain(
    image: np.ndarray, size: Tuple[int, int]
) -> Tuple[np.ndarray, np.ndarray]:
    """Squash-resize to (h, w). Returns (image, affine [sx, sy, 0, 0])."""
    h, w = size
    resized = _resize(image, h, w)
    sx = w / image.shape[1]
    sy = h / image.shape[0]
    return resized, np.array([sx, sy, 0.0, 0.0], np.float32)


def letterbox(
    image: np.ndarray, size: Tuple[int, int], pad_value: int = 128
) -> Tuple[np.ndarray, np.ndarray]:
    """Aspect-preserving resize + centred pad to (h, w).

    Returns (image, affine [s, s, dx, dy]) with ``out = in * s + (dx, dy)``.
    """
    h, w = size
    ih, iw = image.shape[:2]
    s = min(h / ih, w / iw)
    nh, nw = int(round(ih * s)), int(round(iw * s))
    out = np.full((h, w, image.shape[2]), pad_value, image.dtype)
    dy, dx = (h - nh) // 2, (w - nw) // 2
    out[dy : dy + nh, dx : dx + nw] = _resize(image, nh, nw)
    return out, np.array([s, s, dx, dy], np.float32)


def apply_affine_to_boxes(boxes: np.ndarray, affine: np.ndarray) -> np.ndarray:
    """Apply [sx, sy, dx, dy] to corner boxes (padding rows of -1 preserved)."""
    out = boxes.copy()
    valid = (boxes[:, :4] >= 0).all(axis=1)
    sx, sy, dx, dy = affine
    out[valid, 0] = boxes[valid, 0] * sx + dx
    out[valid, 1] = boxes[valid, 1] * sy + dy
    out[valid, 2] = boxes[valid, 2] * sx + dx
    out[valid, 3] = boxes[valid, 3] * sy + dy
    return out


def invert_affine_to_boxes(boxes: np.ndarray, affine: np.ndarray) -> np.ndarray:
    """Map network-input-coordinate boxes back to original image coords."""
    sx, sy, dx, dy = affine
    out = boxes.copy()
    out[..., 0] = (boxes[..., 0] - dx) / sx
    out[..., 1] = (boxes[..., 1] - dy) / sy
    out[..., 2] = (boxes[..., 2] - dx) / sx
    out[..., 3] = (boxes[..., 3] - dy) / sy
    return out


@dataclasses.dataclass
class ValTransform:
    """Deterministic eval/inference transform: resize + normalize.

    ``normalize=False`` returns the resized uint8 image; ``make_predictor``
    then normalizes it on the device (a quarter of the host->device bytes).
    """

    size: Tuple[int, int]
    letterbox_resize: bool = False
    normalize: bool = True

    def __call__(self, image: np.ndarray, label: Optional[np.ndarray] = None):
        if self.letterbox_resize:
            image, affine = letterbox(image, self.size)
        else:
            image, affine = resize_plain(image, self.size)
        if label is not None:
            label = apply_affine_to_boxes(label, affine)
        return (normalize(image) if self.normalize else image), label, affine
