"""Host-side image and label transforms (counterpart of
``viddet_tpu/data/transforms.py``): the inference resize and letterbox, and
the training augmentations (colour distortion, expand, constrained crop,
flip) with ``TrainTransform``.

The JAX package runs them through OpenCV; the port imports no OpenCV and
reproduces each OpenCV call it needs bit for bit:

* ``cv2.resize(..., INTER_LINEAR)`` on uint8 in integer arithmetic
  (``_resize``): 11-bit fixed-point coefficients, OpenCV's horizontal pass
  and its SIMD vertical pass, with OpenCV's edge rules;
* ``cv2.cvtColor`` RGB -> HSV and back on uint8 (``rgb_to_hsv``,
  ``hsv_to_rgb``), ``cv2.LUT`` (indexing) and ``cv2.copyMakeBorder``
  (slab fills).

All randomness flows through an explicit ``numpy.random.Generator``, in
the JAX package's draw order, so one seed gives one sample in both.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

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


# ---------------------------------------------------------------------------
# OpenCV's uint8 HSV conversions (hue in [0, 180))
# ---------------------------------------------------------------------------

_HSV_SHIFT = 12
_DIV = np.arange(1, 256, dtype=np.float64)
# saturate_cast<int>(double) rounds half to even, as np.rint
_SDIV = np.concatenate([[0], np.rint((255 << _HSV_SHIFT) / _DIV)]).astype(np.int32)
_HDIV = np.concatenate([[0], np.rint((180 << _HSV_SHIFT) / (6.0 * _DIV))]).astype(np.int32)
# (b, g, r) entries of the four-value table per hue sector
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])
_HSV_SIMD_PIXELS = 32  # pixels an iteration of OpenCV's HSV -> RGB vector loop takes


def rgb_to_hsv(image: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(image, cv2.COLOR_RGB2HSV)`` for uint8 (..., 3),
    bit for bit: OpenCV's integer arithmetic with its 12-bit division
    tables."""
    r, g, b = (image[..., i].astype(np.int32) for i in range(3))
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], axis=-1).astype(np.uint8)


def _fma32(a: np.ndarray, b: np.ndarray, c) -> np.ndarray:
    """float32 ``a * b + c`` with one rounding (the product is exact in
    float64)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def hsv_to_rgb(image: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(image, cv2.COLOR_HSV2RGB)`` for uint8 (H, W, 3) with
    hue in [0, 180), bit for bit as OpenCV 5.0 computes it on an x86 CPU
    with AVX2: s and v scaled by 1/255 and the sector's four values in
    float32, ``1 - s*h`` and ``1 - s*(1-h)`` each fused into one rounding;
    then times 255, truncated in the vector loop (the first
    ``32 * (W // 32)`` pixels of each row) and rounded half to even in the
    scalar loop (the rest of the row)."""
    f32 = np.float32
    h = image[..., 0].astype(f32) * (f32(6.0) / f32(180.0))
    s = image[..., 1].astype(f32) * f32(1.0 / 255.0)
    v = image[..., 2].astype(f32) * f32(1.0 / 255.0)
    sector = np.trunc(h)
    h = h - sector
    one = f32(1.0)
    table = np.stack([v, v * (one - s), v * _fma32(-s, h, one),
                      v * _fma32(-s, one - h, one)], axis=-1)
    pick = _SECTORS[sector.astype(np.int64)]
    rgb = np.take_along_axis(table, pick[..., ::-1], axis=-1) * f32(255.0)
    vector = np.arange(image.shape[-2]) < image.shape[-2] // _HSV_SIMD_PIXELS * _HSV_SIMD_PIXELS
    rgb = np.where(vector[:, None], np.trunc(rgb), np.rint(rgb))
    return np.clip(rgb, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Random augmentations (training); the draw order is the JAX package's
# ---------------------------------------------------------------------------


def random_color_distort(
    image: np.ndarray,
    rng: np.random.Generator,
    brightness_delta: int = 32,
    contrast_range: Tuple[float, float] = (0.5, 1.5),
    saturation_range: Tuple[float, float] = (0.5, 1.5),
    hue_delta: int = 18,
) -> np.ndarray:
    """Photometric distortions, uint8 in and out: brightness and contrast
    as one 256-entry LUT, then saturation and hue as LUTs on the HSV
    channels (the RGB -> HSV -> RGB round trip only when one of them
    fires)."""
    b = c = None
    if rng.random() < 0.5:
        b = rng.uniform(-brightness_delta, brightness_delta)
    if rng.random() < 0.5:
        c = rng.uniform(*contrast_range)
    if b is not None or c is not None:
        lut = np.arange(256, dtype=np.float32)
        if b is not None:
            lut = lut + np.float32(b)
        if c is not None:
            lut = lut * np.float32(c)
        image = np.clip(lut, 0, 255).astype(np.uint8)[image]
    k = d = None
    if rng.random() < 0.5:
        k = rng.uniform(*saturation_range)
    if rng.random() < 0.5:
        d = rng.uniform(-hue_delta, hue_delta)
    if k is not None or d is not None:
        hsv = rgb_to_hsv(image)
        if k is not None:
            s_lut = np.clip(np.arange(256, dtype=np.float32) * np.float32(k), 0, 255)
            hsv[..., 1] = s_lut.astype(np.uint8)[hsv[..., 1]]
        if d is not None:
            # uint8 HSV hue lives in [0, 180); inputs never exceed 179
            h_lut = (np.arange(256, dtype=np.float32) + np.float32(d)) % 180
            hsv[..., 0] = h_lut.astype(np.uint8)[hsv[..., 0]]
        image = hsv_to_rgb(hsv)
    return image


def random_expand(
    image: np.ndarray,
    boxes: np.ndarray,
    rng: np.random.Generator,
    max_ratio: float = 4.0,
    fill: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Place the image on a larger mean-filled canvas (zoom-out), writing
    the border only, as ``cv2.copyMakeBorder`` does."""
    if max_ratio <= 1.0 or rng.random() < 0.5:
        return image, boxes
    h, w, c = image.shape
    ratio = rng.uniform(1.0, max_ratio)
    oh, ow = int(h * ratio), int(w * ratio)
    off_y = int(rng.uniform(0, oh - h))
    off_x = int(rng.uniform(0, ow - w))
    if fill is None:
        fill = (IMAGENET_MEAN * 255.0).astype(image.dtype)
    # copyMakeBorder's value: saturate_cast, i.e. rounded half to even and clipped
    value = np.clip(np.rint(np.broadcast_to(np.asarray(fill, np.float64), (c,))),
                    0, 255).astype(image.dtype)
    canvas = np.empty((oh, ow, c), image.dtype)
    canvas[:off_y] = value
    canvas[off_y + h:] = value
    canvas[off_y:off_y + h, :off_x] = value
    canvas[off_y:off_y + h, off_x + w:] = value
    canvas[off_y:off_y + h, off_x:off_x + w] = image
    return canvas, apply_affine_to_boxes(boxes, np.array([1, 1, off_x, off_y], np.float32))


def random_crop_with_constraints(
    image: np.ndarray,
    boxes: np.ndarray,
    rng: np.random.Generator,
    min_scale: float = 0.3,
    max_aspect_ratio: float = 2.0,
    constraints: Sequence = ((0.1,), (0.3,), (0.5,), (0.7,), (0.9,), (None,)),
    max_trial: int = 50,
) -> Tuple[np.ndarray, np.ndarray]:
    """SSD-style random crop: a crop must reach a minimum IoU with every
    ground-truth box; boxes whose centres fall outside it are dropped (set
    to -1).  Per constraint all ``max_trial`` scales, aspect ratios and
    offsets are drawn at once and the first passing trial wins."""
    h, w = image.shape[:2]
    valid = boxes[:, 4] >= 0 if boxes.shape[1] > 4 else (boxes[:, :4] >= 0).all(1)
    if not valid.any():
        return image, boxes
    gt = boxes[valid, :4]
    area_g = (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1])
    candidates = []
    for (min_iou,) in constraints:
        scale = rng.uniform(min_scale, 1.0, size=max_trial)
        ar = rng.uniform(np.maximum(1.0 / max_aspect_ratio, scale * scale),
                         np.minimum(max_aspect_ratio, 1.0 / (scale * scale)))
        ch = (h * scale / np.sqrt(ar)).astype(np.int64)
        cw = (w * scale * np.sqrt(ar)).astype(np.int64)
        cy = np.where(ch < h,
                      (rng.uniform(0.0, 1.0, size=max_trial) * (h - ch)).astype(np.int64), 0)
        cx = np.where(cw < w,
                      (rng.uniform(0.0, 1.0, size=max_trial) * (w - cw)).astype(np.int64), 0)
        crops = np.stack([cx, cy, cx + cw, cy + ch], axis=1).astype(np.float32)
        if min_iou is None:
            candidates.append(crops[0])
            continue
        ix1 = np.maximum(gt[:, 0], crops[:, 0:1])
        iy1 = np.maximum(gt[:, 1], crops[:, 1:2])
        ix2 = np.minimum(gt[:, 2], crops[:, 2:3])
        iy2 = np.minimum(gt[:, 3], crops[:, 3:4])
        inter = np.maximum(ix2 - ix1, 0) * np.maximum(iy2 - iy1, 0)  # (n, G)
        area_c = (cw * ch).astype(np.float32)[:, None]
        iou = inter / np.maximum(area_g + area_c - inter, 1e-12)
        ok = iou.min(axis=1) >= min_iou
        first = int(np.argmax(ok))
        if ok[first]:
            candidates.append(crops[first])
    if not candidates:
        return image, boxes
    crop = candidates[int(rng.integers(len(candidates)))]
    cx1, cy1, cx2, cy2 = crop.astype(int)
    new_boxes = boxes.copy()
    centers = 0.5 * (boxes[:, :2] + boxes[:, 2:4])
    keep = (valid & (centers[:, 0] >= cx1) & (centers[:, 0] < cx2)
            & (centers[:, 1] >= cy1) & (centers[:, 1] < cy2))
    new_boxes[~keep] = -1.0
    if keep.any():
        nb = new_boxes[keep]
        nb[:, 0] = np.clip(nb[:, 0] - cx1, 0, cx2 - cx1)
        nb[:, 1] = np.clip(nb[:, 1] - cy1, 0, cy2 - cy1)
        nb[:, 2] = np.clip(nb[:, 2] - cx1, 0, cx2 - cx1)
        nb[:, 3] = np.clip(nb[:, 3] - cy1, 0, cy2 - cy1)
        new_boxes[keep] = nb
    return image[cy1:cy2, cx1:cx2], new_boxes


def random_hflip(
    image: np.ndarray, boxes: np.ndarray, rng: np.random.Generator
) -> Tuple[np.ndarray, np.ndarray]:
    if rng.random() < 0.5:
        return image, boxes
    w = image.shape[1]
    out = boxes.copy()
    valid = (boxes[:, :4] >= 0).all(axis=1)
    out[valid, 0] = w - boxes[valid, 2]
    out[valid, 2] = w - boxes[valid, 0]
    return np.ascontiguousarray(image[:, ::-1]), out


@dataclasses.dataclass
class TrainTransform:
    """The YOLOv3 training transform: colour distortion, expand, crop,
    resize, flip, normalize.  ``normalize=False`` keeps the sample uint8;
    the train step then normalizes the batch on the device
    (``train/loop.py``), a quarter of the host->device bytes."""

    size: Tuple[int, int]  # (h, w)
    letterbox_resize: bool = False
    normalize: bool = True

    def __call__(self, image: np.ndarray, label: np.ndarray, rng: np.random.Generator):
        """image uint8 HWC RGB, label (M, 6) [x1 y1 x2 y2 cls difficult] ->
        (image float32 normalized, or uint8, and the transformed label)."""
        image = random_color_distort(image, rng)
        image, label = random_expand(image, label, rng)
        image, label = random_crop_with_constraints(image, label, rng)
        if self.letterbox_resize:
            image, affine = letterbox(image, self.size)
        else:
            image, affine = resize_plain(image, self.size)
        label = apply_affine_to_boxes(label, affine)
        image, label = random_hflip(image, label, rng)
        return (normalize(image) if self.normalize else image), label


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
