"""Image helpers (counterpart of ``viddet_tpu/utils/image.py``): per-class
colours and box drawing, the EXIF orientation of JPEG images (on bytes as
well as on a path) and of PNG ``eXIf`` and WebP ``EXIF`` payloads, with the
flips and transposes that turn a decoded raster upright, and ``imwrite`` /
``imencode_jpeg`` through the port's codec.

``cv2.imread`` and ``cv2.imdecode`` apply the orientation; the port's
JPEG decoder, as libjpeg, returns the raster as stored.  Without OpenCV
there is no Hershey font: labels are drawn in the 5x7 bitmap font below,
so drawings equal OpenCV's in their rectangles and colours, not in their
text.
"""

from __future__ import annotations

import colorsys
import os
import struct
from typing import Optional, Sequence

import numpy as np

from viddet_tpu_torch.native import encode_jpeg as imencode_jpeg  # cv2.imwrite's JPEG bytes
from viddet_tpu_torch.native import encode_png


# 5x7 glyphs of ASCII 32..126, five columns each, bit 0 the top row.
_FONT = bytes.fromhex(
    "0000000000" "00005f0000" "0007000700" "147f147f14" "242a7f2a12" "2313086462"
    "3649552250" "0005030000" "001c224100" "0041221c00" "082a1c2a08" "08083e0808"
    "0050300000" "0808080808" "0060600000" "2010080402" "3e5149453e" "00427f4000"
    "4261514946" "2141454b31" "1814127f10" "2745454539" "3c4a494930" "0171090503"
    "3649494936" "064949291e" "0036360000" "0056360000" "0814224100" "1414141414"
    "0041221408" "0201510906" "3249794136" "7e1111117e" "7f49494936" "3e41414122"
    "7f4141221c" "7f49494941" "7f09090101" "3e41415132" "7f0808087f" "00417f4100"
    "2040413f01" "7f08142241" "7f40404040" "7f0204027f" "7f0408107f" "3e4141413e"
    "7f09090906" "3e4151215e" "7f09192946" "4649494931" "01017f0101" "3f4040403f"
    "1f2040201f" "7f2018207f" "6314081463" "0304780403" "6151494543" "00007f4141"
    "0204081020" "41417f0000" "0402010204" "4040404040" "0001020400" "2054545478"
    "7f48444438" "3844444420" "384444487f" "3854545418" "087e090102" "081454543c"
    "7f08040478" "00447d4000" "2040443d00" "007f102844" "00417f4000" "7c04180478"
    "7c08040478" "3844444438" "7c14141408" "081414187c" "7c08040408" "4854545420"
    "043f444020" "3c4040207c" "1c2040201c" "3c4030403c" "4428102844" "0c5050503c"
    "4464544c44" "0008364100" "00007f0000" "0041360800" "0804081008"
)
GLYPH_W, GLYPH_H = 5, 7


def class_colors(num_classes: int) -> np.ndarray:
    """Deterministic visually-distinct colours, one per class, in the JAX
    package's channel order (``viddet_tpu/utils/image.py``: BGR triples,
    drawn as they are into the RGB frame)."""
    colors = []
    for i in range(max(num_classes, 1)):
        h = (i * 0.618033988749895) % 1.0
        r, g, b = colorsys.hsv_to_rgb(h, 0.8, 0.95)
        colors.append((int(b * 255), int(g * 255), int(r * 255)))
    return np.asarray(colors, np.int32)


def _fill(image: np.ndarray, x1: int, y1: int, x2: int, y2: int, color) -> None:
    """Fill the inclusive box [x1, x2] x [y1, y2], clipped to the image."""
    h, w = image.shape[:2]
    xa, xb, ya, yb = max(x1, 0), min(x2, w - 1), max(y1, 0), min(y2, h - 1)
    if xa <= xb and ya <= yb:
        image[ya : yb + 1, xa : xb + 1] = color


def draw_rectangle(image: np.ndarray, x1: int, y1: int, x2: int, y2: int, color) -> None:
    """A 2-px stroke around the integer corners, the pixels
    ``cv2.rectangle(image, (x1, y1), (x2, y2), color, 2)`` sets: each edge a
    3-px band centred on it, the band's four outer corner pixels left out."""
    x1, x2 = min(x1, x2), max(x1, x2)
    y1, y2 = min(y1, y2), max(y1, y2)
    for y in (y1, y2):
        _fill(image, x1, y - 1, x2, y + 1, color)
    for x in (x1, x2):
        _fill(image, x - 1, y1, x + 1, y2, color)


def text_size(text: str) -> tuple:
    """(width, height) of ``text`` in the bitmap font, one column between glyphs."""
    return max(len(text) * (GLYPH_W + 1) - 1, 0), GLYPH_H


def draw_text(image: np.ndarray, text: str, x: int, baseline: int, color) -> None:
    """``text`` in the bitmap font, its bottom row on ``baseline``."""
    h, w = image.shape[:2]
    top = baseline - GLYPH_H + 1
    for k, ch in enumerate(text):
        code = ord(ch) if 32 <= ord(ch) <= 126 else ord("?")
        cols = _FONT[(code - 32) * GLYPH_W : (code - 31) * GLYPH_W]
        for cx, bits in enumerate(cols):
            px = x + k * (GLYPH_W + 1) + cx
            if not 0 <= px < w:
                continue
            for cy in range(GLYPH_H):
                if bits >> cy & 1 and 0 <= top + cy < h:
                    image[top + cy, px] = color


def draw_detections(
    image: np.ndarray,
    boxes: np.ndarray,
    ids: np.ndarray,
    scores: np.ndarray,
    class_names: Optional[Sequence[str]] = None,
    thresh: float = 0.5,
) -> np.ndarray:
    """Draw detections on an RGB uint8 image (returns a copy), as the JAX
    package does: per detection at or above ``thresh`` a 2-px rectangle in
    its class colour, a filled label box above its top-left corner and the
    label ``"{name} {score:.2f}"`` in white.

    boxes (K, 4) corner coords in image pixels; ids/scores (K,); padding -1.
    """
    out = image.copy()
    num_classes = len(class_names) if class_names else int(max(ids.max(), 0)) + 1
    colors = class_colors(num_classes)
    for box, cid, score in zip(boxes, ids, scores):
        if cid < 0 or score < thresh:
            continue
        cid = int(cid)
        color = tuple(int(c) for c in colors[cid % len(colors)])
        x1, y1, x2, y2 = (int(round(v)) for v in box)
        draw_rectangle(out, x1, y1, x2, y2, color)
        name = class_names[cid] if class_names and cid < len(class_names) else str(cid)
        label = f"{name} {score:.2f}"
        tw, th = text_size(label)
        _fill(out, x1, y1 - th - 6, x1 + tw + 2, y1, color)
        draw_text(out, label, x1 + 1, y1 - 4, (255, 255, 255))
    return out


def exif_orientation(path: str, max_scan: int = 65536) -> int:
    """EXIF Orientation tag (1..8) of a JPEG file, or 1 when absent.  Pure
    header scan: no decode, one bounded read."""
    try:
        with open(path, "rb") as f:
            head = f.read(max_scan)
    except OSError:
        return 1
    return exif_orientation_of(head)


def exif_orientation_of(head: bytes) -> int:
    """EXIF Orientation tag (1..8) in the leading bytes of a JPEG, or in a
    bare TIFF-header EXIF payload (a PNG ``eXIf`` or WebP ``EXIF`` chunk,
    ``II`` or ``MM``), or 1."""
    if head[:2] in (b"II", b"MM"):
        return tiff_orientation(head)
    if not head.startswith(b"\xff\xd8"):
        return 1
    i = 2
    while i + 4 <= len(head):
        if head[i] != 0xFF:
            break
        marker = head[i + 1]
        if marker == 0x01 or 0xD0 <= marker <= 0xD9:
            i += 2  # standalone markers carry no length
            continue
        seg_len = int.from_bytes(head[i + 2 : i + 4], "big")
        if seg_len < 2:
            break
        if marker == 0xE1 and head[i + 4 : i + 10] == b"Exif\x00\x00":
            return tiff_orientation(head[i + 10 : i + 2 + seg_len])
        if marker == 0xDA:  # start of scan: no EXIF past image data
            break
        i += 2 + seg_len
    return 1


def tiff_orientation(tiff: bytes) -> int:
    """The Orientation tag (1..8) of the first IFD of an EXIF payload that
    starts with its TIFF header (``II`` or ``MM``, 42, the IFD's offset), or
    1 when the payload is malformed or holds none."""
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    endian = "<" if tiff[:2] == b"II" else ">"
    try:
        if struct.unpack_from(endian + "H", tiff, 2)[0] != 42:
            return 1
        ifd = struct.unpack_from(endian + "I", tiff, 4)[0]
        count = struct.unpack_from(endian + "H", tiff, ifd)[0]
        for k in range(count):
            off = ifd + 2 + k * 12
            tag = struct.unpack_from(endian + "H", tiff, off)[0]
            if tag == 0x0112:
                val = struct.unpack_from(endian + "H", tiff, off + 8)[0]
                return val if 1 <= val <= 8 else 1
    except struct.error:
        return 1
    return 1


def apply_orientation(image: np.ndarray, orientation: int) -> np.ndarray:
    """Turn an (H, W, C) raster upright for EXIF ``orientation``, as
    OpenCV's ``ApplyExifOrientation`` does: 2 mirrors left-right, 3 turns
    half round, 4 mirrors top-bottom; 5 to 8 transpose first, then 6
    mirrors left-right, 7 turns half round and 8 mirrors top-bottom."""
    if orientation >= 5:
        image = image.transpose(1, 0, 2)
    flip = {2: (slice(None), slice(None, None, -1)), 3: (slice(None, None, -1),) * 2,
            4: (slice(None, None, -1),), 6: (slice(None), slice(None, None, -1)),
            7: (slice(None, None, -1),) * 2, 8: (slice(None, None, -1),)}.get(orientation)
    if flip is not None:
        image = image[flip]
    return np.ascontiguousarray(image)


def imwrite(path: str, rgb: np.ndarray, quality: int = 95) -> None:
    """Write an (H, W, 3) uint8 RGB image as JPEG (``.jpg``, ``.jpeg``) or
    PNG (``.png``), chosen by the extension as ``cv2.imwrite`` chooses."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".jpg", ".jpeg"):
        data = imencode_jpeg(rgb, quality)
    elif ext == ".png":
        data = encode_png(rgb)
    else:
        raise ValueError(f"{path}: imwrite writes .jpg, .jpeg or .png, not the extension {ext!r}")
    with open(path, "wb") as f:
        f.write(data)
