"""EXIF orientation of JPEG images (copy of ``exif_orientation`` in
``viddet_tpu/utils/image.py``, on bytes as well as on a path), and the
flips and transposes that turn a decoded raster upright.

``cv2.imread`` and ``cv2.imdecode`` apply the orientation; libjpeg, and so
the port's decoder, return the raster as stored.  The drawing helpers of
the JAX module wait for the video and serving surfaces.
"""

from __future__ import annotations

import struct

import numpy as np


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
    """EXIF Orientation tag (1..8) in the leading bytes of a JPEG, or 1."""
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
            tiff = head[i + 10 : i + 2 + seg_len]
            if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
                return 1
            endian = "<" if tiff[:2] == b"II" else ">"
            try:
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
        if marker == 0xDA:  # start of scan: no EXIF past image data
            break
        i += 2 + seg_len
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
