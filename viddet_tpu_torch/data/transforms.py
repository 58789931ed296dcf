"""Host-side inference transform (copy of the ``viddet_tpu/data/transforms.py``
pieces the serving path uses).

The JAX package resizes with ``cv2.resize(..., INTER_LINEAR)``; the port
imports no OpenCV and reproduces that uint8 resize bit for bit in integer
arithmetic (``_resize``): 11-bit fixed-point coefficients, OpenCV's
horizontal pass and its SIMD vertical pass, with OpenCV's edge rules.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize(image: np.ndarray) -> np.ndarray:
    """uint8 HWC RGB -> float32 normalized by ImageNet stats."""
    out = image.astype(np.float32)
    out /= 255.0
    out -= IMAGENET_MEAN
    out /= IMAGENET_STD
    return out


_COEF_BITS = 11  # OpenCV's INTER_RESIZE_COEF_BITS
_ONE = 1 << _COEF_BITS


def _axis_taps(src: int, dst: int):
    """OpenCV's INTER_LINEAR source index and fraction per destination
    position: ``fx = float32((d + 0.5) * scale - 0.5)`` with ``scale`` the
    double ``1 / (dst / src)``, ``s = floor(fx)``, ``fx = float32(fx - s)``."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    f = (f - s).astype(np.float32)
    return s.astype(np.int64), f


def _coefs(f: np.ndarray):
    """The two 11-bit weights of fractions ``f``: ``rint(float32(1 - f) *
    2048)`` and ``rint(f * 2048)``, rounding half to even as cvRound does."""
    one = np.float32(_ONE)
    c0 = np.rint((np.float32(1) - f).astype(np.float32) * one).astype(np.int32)
    c1 = np.rint(f * one).astype(np.int32)
    return c0, c1


def _resize(image: np.ndarray, h: int, w: int) -> np.ndarray:
    """``cv2.resize(image, (w, h), interpolation=cv2.INTER_LINEAR)`` for a
    uint8 HWC image, bit for bit, in int32 torch arithmetic on the host.

    Columns: a column whose left tap falls before the image takes fraction
    0 at column 0; one whose right tap falls past the last column is a
    single tap ``p[s] * 2048`` (``s`` clamped to the last column).  Others
    sum ``a0 * p[s] + a1 * p[s + 1]``.  Rows: the two source rows are
    clamped into the image, but the fraction is kept at both edges.  The
    vertical pass is OpenCV's SIMD one for every element:
    ``((b0 * (S0 >> 4)) >> 16) + ((b1 * (S1 >> 4)) >> 16) + 2 >> 2``; each
    product stays below 2**31 (2048 * 32767).
    """
    ih, iw = image.shape[:2]
    sx, fx = _axis_taps(iw, w)
    left = sx < 0
    fx[left], sx[left] = 0.0, 0
    a0, a1 = _coefs(fx)
    single = sx + 1 >= iw
    sx = np.minimum(sx, iw - 1)
    a0[single], a1[single] = _ONE, 0
    sx1 = np.where(single, sx, sx + 1)

    sy, fy = _axis_taps(ih, h)
    b0, b1 = _coefs(fy)
    r0, r1 = np.clip(sy, 0, ih - 1), np.clip(sy + 1, 0, ih - 1)

    p = torch.from_numpy(np.ascontiguousarray(image))
    cols0, cols1 = torch.from_numpy(sx), torch.from_numpy(sx1)
    ca0, ca1 = torch.from_numpy(a0)[:, None], torch.from_numpy(a1)[:, None]

    def horizontal(rows: np.ndarray) -> torch.Tensor:
        x = p[torch.from_numpy(rows)].to(torch.int32)  # (h, iw, c)
        return (x[:, cols0] * ca0 + x[:, cols1] * ca1) >> 4  # (h, w, c)

    t0 = (torch.from_numpy(b0)[:, None, None] * horizontal(r0)) >> 16
    t1 = (torch.from_numpy(b1)[:, None, None] * horizontal(r1)) >> 16
    out = (t0 + t1 + 2) >> 2
    return out.clamp_(0, 255).to(torch.uint8).numpy()


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
