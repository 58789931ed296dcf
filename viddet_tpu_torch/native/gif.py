"""GIF still images as ``cv2.imdecode(buf, IMREAD_COLOR)`` gives them with
OpenCV 5's own GIF decoder: the first frame, composited as that decoder
composites it.  The blocks are read here, the LZW codes by ``gif.cpp`` in
the port's codec library.

What the decoder does, and so this module:

* the canvas is the logical screen, filled with the global colour table's
  background entry (black when the file has no global table; a background
  index past the table is refused);
* the first image is drawn at its offset (it must lie inside the screen),
  its transparent index (the last graphic control extension before it)
  leaving the canvas as it is, interlaced rows put back in order;
* its colours come from the global table with the local table written over
  its first entries; an index past the larger of the two tables is
  refused, and with neither table index i is grey i, index 1 white;
* the LZW stream must give exactly the image's pixels (the codes after its
  end code are not read);
* every block up to the trailer must be whole: extensions, graphic control
  extensions of 4 bytes with their terminator, and the later images, whose
  pixels are not decoded.

The port's GIF writer (``utils/gif.py``) is a separate module.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

GIF_SIGNATURES = (b"GIF87a", b"GIF89a")


def _default_table() -> np.ndarray:
    table = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
    table[1] = 255
    return table


class _Reader:
    def __init__(self, data: bytes, name: str):
        self.data, self.name, self.pos = data, name, 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(f"{self.name}: GIF is truncated (at byte {self.pos})")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def sub_blocks(self) -> list:
        blocks = []
        while True:
            n = self.byte()
            if not n:
                return blocks
            blocks.append(self.take(n))


def _interlaced_rows(h: int) -> np.ndarray:
    return np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8), np.arange(2, h, 4),
                           np.arange(1, h, 2)])


def _lzw(data: bytes, min_code_size: int, count: int, name: str) -> np.ndarray:
    from viddet_tpu_torch.native import _ERR_LEN, _message, library

    out = np.empty(count, np.uint8)
    got = ctypes.c_ulong()
    err = ctypes.create_string_buffer(_ERR_LEN)
    if library().vd_gif_lzw(data, len(data), min_code_size, out.ctypes.data, count,
                            ctypes.byref(got), err, _ERR_LEN):
        raise ValueError(f"{name}: GIF image data: {_message(err)}")
    if got.value != count:
        raise ValueError(f"{name}: GIF image data holds {got.value} pixels, not {count}")
    return out


def decode_gif(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """GIF bytes -> (H, W, 3) uint8 RGB of the first frame on the logical
    screen, as ``cv2.imdecode`` (IMREAD_COLOR) and a BGR-to-RGB swap give
    it.  Raises ValueError for a truncated or corrupt file."""
    from viddet_tpu_torch.native import _check_size

    r = _Reader(data, name)
    if r.take(6) not in GIF_SIGNATURES:
        raise ValueError(f"{name}: not a GIF (GIF87a or GIF89a)")
    width, height, flags, background, _ = struct.unpack("<HHBBB", r.take(7))
    if not width or not height:
        raise ValueError(f"{name}: GIF screen of size {width}x{height}")
    _check_size(name, width, height)
    table = _default_table()
    global_size, fill = 0, np.zeros(3, np.uint8)
    if flags & 0x80:
        global_size = 2 << (flags & 7)
        table[:global_size] = np.frombuffer(r.take(3 * global_size), np.uint8).reshape(-1, 3)
        if background >= global_size:
            raise ValueError(f"{name}: GIF background index {background} is past the "
                             f"{global_size}-entry colour table")
        fill = table[background].copy()
    transparent, image = None, None
    while True:
        kind = r.byte()
        if kind == 0x3B:  # trailer
            break
        if kind == 0x21:  # extension
            label = r.byte()
            if label == 0xF9:  # graphic control
                size = r.byte()
                if size != 4:
                    raise ValueError(f"{name}: GIF graphic control extension of {size} bytes")
                packed, _, index, terminator = struct.unpack("<BHBB", r.take(5))
                if terminator:
                    raise ValueError(f"{name}: GIF graphic control extension is not terminated")
                if image is None:
                    transparent = index if packed & 1 else None
            else:
                r.sub_blocks()
            continue
        if kind != 0x2C:
            raise ValueError(f"{name}: unknown GIF block 0x{kind:02x} at byte {r.pos - 1}")
        x, y, w, h, packed = struct.unpack("<HHHHB", r.take(9))
        local = r.take(3 * (2 << (packed & 7))) if packed & 0x80 else None
        min_code_size = r.byte()
        blocks = r.sub_blocks()
        if image is not None:
            continue  # later frames: the blocks only
        if x + w > width or y + h > height:
            raise ValueError(f"{name}: GIF image {w}x{h}+{x}+{y} leaves the {width}x{height} "
                             f"screen")
        indices = _lzw(b"".join(blocks), min_code_size, w * h, name).reshape(h, w)
        if packed & 0x40:
            rows = np.empty_like(indices)
            rows[_interlaced_rows(h)] = indices
            indices = rows
        limit = 256
        if local is not None or global_size:
            limit = max(global_size, len(local) // 3 if local is not None else 0)
            if local is not None:
                table[: len(local) // 3] = np.frombuffer(local, np.uint8).reshape(-1, 3)
        if h and w and int(indices.max()) >= limit:
            raise ValueError(f"{name}: GIF colour index {int(indices.max())} is past the "
                             f"{limit}-entry colour table")
        image = (x, y, indices, transparent)
    if image is None:
        raise ValueError(f"{name}: GIF holds no image")
    x, y, indices, transparent = image
    h, w = indices.shape
    canvas = np.empty((height, width, 3), np.uint8)
    canvas[:] = fill
    region = canvas[y : y + h, x : x + w]
    drawn = indices != transparent if transparent is not None else slice(None)
    region[drawn] = table[indices[drawn]]
    return canvas
