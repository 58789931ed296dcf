"""Sun raster, PFM and Radiance HDR still images as ``cv2.imdecode(buf,
IMREAD_COLOR)`` gives them with OpenCV 5's own decoders (``grfmt_sunras``,
``grfmt_pfm``, ``grfmt_hdr`` with its ``rgbe`` reader).  Numpy only.

Sun raster (``59 a6 6a 95``): a big-endian 32-byte header (width and height
above 0, depth 1, 8, 24 or 32), then a colour map (type 1, RGB planes of at
most ``3 << depth`` bytes, depths 1 and 8 only; entries past it black) or
none (type 0, length 0; depths 1 and 8 read as grey, 1 white), then rows
padded to an even number of bytes.  Only the old and standard types (0 and
1) are read: OpenCV 5 returns nothing for the RLE (2) and RGB (3) types and
any other.  24-bit pixels are stored B, G, R and 32-bit ones X, B, G, R.

PFM (``PF`` colour, ``Pf`` grey, then a line break): width, height and scale
each ended by one whitespace byte and read as ``atoi`` / ``atof`` read them;
a scale below 0 means little-endian floats, 0 or above big-endian; rows
bottom-up; every value multiplied by ``1 / |scale|`` (a scale of 0 is
refused) and then converted as below; a ``Pf`` image's grey goes into all
three channels.

Radiance HDR (``#?RADIANCE`` / ``#?RGBE``): header lines read as
``fgets`` with a 128-byte buffer reads them, up to a blank one, of which one
must be ``FORMAT=32-bit_rle_rgbe``; then ``-Y height +X width`` as
``sscanf`` reads it (the other orientations are refused, as OpenCV refuses
them); then scanlines, each new-style RLE (``2 2`` and the width, then the
four channels as runs and literals) or, from the first that is not, every
pixel flat.  ``rgbe2float`` gives ``m * 2^(e - 136)`` in float32 (0 where
``e`` is 0), then ``255 * f`` in float32 is converted as below.

The float-to-uint8 step is OpenCV's ``saturate_cast<uchar>``: the value
rounded half to even, clamped to [0, 255], and 0 for NaN and for any value
that overflows a 32-bit integer (x86's ``cvtps2dq`` answer).
"""

from __future__ import annotations

import re
import struct

import numpy as np

SUN_SIGNATURE = b"\x59\xa6\x6a\x95"
HDR_SIGNATURES = (b"#?RADIANCE", b"#?RGBE")


def is_pfm(data: bytes) -> bool:
    return data[:2] in (b"PF", b"Pf") and data[2:3].isspace()


def to_uint8(values: np.ndarray) -> np.ndarray:
    """float32 -> uint8 as OpenCV's ``convertTo`` to 8 bits converts it."""
    r = np.rint(values.astype(np.float32))
    with np.errstate(invalid="ignore"):
        overflow = np.isnan(r) | (r >= np.float32(2 ** 31)) | (r < np.float32(-(2 ** 31)))
    return np.where(overflow, 0, np.clip(np.nan_to_num(r), 0, 255)).astype(np.uint8)


# ---------------------------------------------------------------- Sun raster


def decode_sunras(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """Sun raster bytes -> (H, W, 3) uint8 RGB."""
    from viddet_tpu_torch.native import _check_size

    if len(data) < 32 or data[:4] != SUN_SIGNATURE:
        raise ValueError(f"{name}: Sun raster is truncated or not one")
    width, height, depth, _, kind, map_type, map_length = struct.unpack_from(">7i", data, 4)
    if width <= 0 or height <= 0 or depth not in (1, 8, 24, 32):
        raise ValueError(f"{name}: Sun raster of {width}x{height}, depth {depth}")
    _check_size(name, width, height)
    if kind not in (0, 1):
        what = {2: "RLE", 3: "RGB"}.get(kind, str(kind))
        raise ValueError(f"{name}: Sun raster of type {what} is not decoded by the port "
                         f"(nor by OpenCV 5)")
    colours = 1 << depth if depth <= 8 else 0
    if map_type == 0 and map_length == 0:
        palette = None
    elif map_type == 1 and 0 < map_length <= 3 * colours:
        entries = map_length // 3
        if 32 + map_length > len(data):
            raise ValueError(f"{name}: Sun raster colour map is truncated")
        planes = np.frombuffer(data, np.uint8, 3 * entries, 32).reshape(3, entries)
        palette = np.zeros((colours, 3), np.uint8)
        palette[:entries] = planes.T
    else:
        raise ValueError(f"{name}: Sun raster colour map of type {map_type}, {map_length} "
                         f"bytes, at depth {depth}")
    pitch = ((width * depth + 7) // 8 + 1) & ~1
    start = 32 + map_length
    if start + height * pitch > len(data):
        raise ValueError(f"{name}: Sun raster pixels are truncated")
    rows = np.frombuffer(data, np.uint8, height * pitch, start).reshape(height, pitch)
    if depth >= 24:
        step = depth // 8
        pixels = rows[:, : width * step].reshape(height, width, step)
        return np.ascontiguousarray(pixels[..., [step - 1, step - 2, step - 3]])  # B, G, R
    if depth == 1:
        indices = np.unpackbits(rows, axis=1)[:, :width]
    else:
        indices = rows[:, :width]
    if palette is None:
        grey = indices * np.uint8(255) if depth == 1 else indices
        return np.repeat(grey[..., None], 3, 2)
    return palette[indices]


# ----------------------------------------------------------------------- PFM

_DECIMAL = re.compile(rb"[+-]?(?:\d+\.?\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?)")
_HEX = re.compile(rb"[+-]?0[xX](?:[0-9a-fA-F]+\.?[0-9a-fA-F]*|\.[0-9a-fA-F]+)(?:[pP][+-]?\d+)?")
_SPECIAL = re.compile(rb"[+-]?(?:inf(?:inity)?|nan)", re.IGNORECASE)
_SPACE = b" \t\n\v\f\r"


def _token(data: bytes, pos: int, name: str):
    """``read_number``'s token: the bytes up to one whitespace byte (which
    it consumes), each below 128, at most 2048 of them."""
    end = pos
    while end < len(data) and end - pos < 2048 and data[end] not in _SPACE:
        if data[end] >= 128:
            raise ValueError(f"{name}: PFM header byte {data[end]} is not ASCII")
        end += 1
    if end >= len(data):
        raise ValueError(f"{name}: PFM header is truncated")
    token = data[pos:end].split(b"\0")[0]
    return token, end + (1 if end - pos < 2048 else 0)


def _atoi(token: bytes) -> int:
    m = re.match(rb"[+-]?\d+", token)
    return int(m.group()) if m else 0


def _atof(token: bytes) -> float:
    for pattern in (_HEX, _SPECIAL, _DECIMAL):
        m = pattern.match(token)
        if m:
            text = m.group().decode()
            return float.fromhex(text) if pattern is _HEX else float(text)
    return 0.0


def decode_pfm(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """PFM bytes -> (H, W, 3) uint8 RGB."""
    from viddet_tpu_torch.native import _check_size

    if not is_pfm(data):
        raise ValueError(f"{name}: not a PFM (PF or Pf)")
    if data[2] != ord("\n"):
        raise ValueError(f"{name}: PFM magic is not followed by a line break")
    channels = 3 if data[1] == ord("F") else 1
    token, pos = _token(data, 3, name)
    width = _atoi(token)
    token, pos = _token(data, pos, name)
    height = _atoi(token)
    token, pos = _token(data, pos, name)
    scale = _atof(token)
    if width <= 0 or height <= 0 or width >= 1 << 31 or height >= 1 << 31:
        raise ValueError(f"{name}: PFM of {width}x{height}")
    _check_size(name, width, height)
    if not abs(scale) > 0:  # CV_Assert(fabs(m_scale_factor) > 0.0f), NaN included
        raise ValueError(f"{name}: PFM scale {scale}")
    count = width * height * channels
    if pos + 4 * count > len(data):
        raise ValueError(f"{name}: PFM samples are truncated")
    order = "<" if scale < 0 else ">"
    values = np.frombuffer(data, order + "f4", count, pos).reshape(height, width, channels)
    with np.errstate(over="ignore"):
        values = values[::-1] * np.float32(1.0 / abs(scale))
    image = to_uint8(values)
    return np.ascontiguousarray(np.repeat(image, 3, 2) if channels == 1 else image)


# ------------------------------------------------------------- Radiance HDR

_SIZE_LINE = re.compile(rb"-Y\s*([+-]?\d+)\s*\+X\s*([+-]?\d+)")


def _fgets(data: bytes, pos: int):
    """What ``fgets(buf, 128, fp)`` reads at ``pos``: up to and including a
    line break, at most 127 bytes; None at the end of the data."""
    if pos >= len(data):
        return None, pos
    end = data.find(b"\n", pos, pos + 127)
    end = min(pos + 127, len(data)) if end < 0 else end + 1
    return data[pos:end], end


def _rgbe_to_rgb(rgbe: np.ndarray) -> np.ndarray:
    """(..., 4) RGBE bytes -> uint8 RGB: ``rgbe2float`` then ``255 * f``."""
    e = rgbe[..., 3].astype(np.int64)
    f = np.where(e > 0, np.ldexp(np.float32(1), e - 136).astype(np.float32), np.float32(0))
    values = rgbe[..., :3].astype(np.float32) * f.astype(np.float32)[..., None]
    with np.errstate(over="ignore"):
        return to_uint8(values * np.float32(255))


def _rle_scanline(data: bytes, pos: int, width: int, name: str):
    """One new-style RLE scanline's four channels (its 4-byte head read) ->
    ((width, 4) RGBE, position after it)."""
    out = np.empty((4, width), np.uint8)
    for c in range(4):
        x = 0
        while x < width:
            if pos + 2 > len(data):
                raise ValueError(f"{name}: Radiance HDR scanline is truncated")
            count, value = data[pos], data[pos + 1]
            pos += 2
            if count > 128:
                count -= 128
                if count > width - x:
                    raise ValueError(f"{name}: Radiance HDR run past its scanline")
                out[c, x : x + count] = value
            else:
                if count == 0 or count > width - x or pos + count - 1 > len(data):
                    raise ValueError(f"{name}: Radiance HDR bad scanline data")
                out[c, x] = value
                out[c, x + 1 : x + count] = np.frombuffer(data, np.uint8, count - 1, pos)
                pos += count - 1
            x += count
    return out.T, pos


def decode_hdr(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """Radiance HDR bytes -> (H, W, 3) uint8 RGB."""
    from viddet_tpu_torch.native import _check_size

    if not data.startswith(HDR_SIGNATURES):
        raise ValueError(f"{name}: not a Radiance HDR (#?RADIANCE or #?RGBE)")
    _, pos = _fgets(data, 0)  # the program type
    has_format = False
    while True:
        line, pos = _fgets(data, pos)
        if line is None:
            raise ValueError(f"{name}: Radiance HDR header is truncated")
        if line[:1] == b"\n":  # a blank line ends the header (one starting with NUL does not)
            if not has_format:
                raise ValueError(f"{name}: Radiance HDR names no FORMAT=32-bit_rle_rgbe")
            break
        if line.split(b"\0")[0] == b"FORMAT=32-bit_rle_rgbe\n":  # strcmp
            has_format = True
    line, pos = _fgets(data, pos)
    m = _SIZE_LINE.match(line.split(b"\0")[0] if line else b"")
    if m is None:
        raise ValueError(f"{name}: Radiance HDR size line is not -Y height +X width "
                         f"(the other orientations are not decoded)")
    height, width = int(m.group(1)), int(m.group(2))
    if not 0 < width < 1 << 31 or not 0 < height < 1 << 31:
        raise ValueError(f"{name}: Radiance HDR of {width}x{height}")
    _check_size(name, width, height)
    rgbe = np.empty((height, width, 4), np.uint8)
    flat_from = 0
    if 8 <= width <= 0x7FFF:  # run-length encoding is allowed
        flat_from = None
        for y in range(height):
            head = data[pos : pos + 4]
            if len(head) < 4:
                raise ValueError(f"{name}: Radiance HDR scanline is truncated")
            if head[0] != 2 or head[1] != 2 or head[2] & 0x80:
                flat_from = y  # not run-length encoded: every pixel from here flat
                break
            if head[2] << 8 | head[3] != width:
                raise ValueError(f"{name}: Radiance HDR scanline of the wrong width")
            rgbe[y], pos = _rle_scanline(data, pos + 4, width, name)
    if flat_from is not None:
        count = (height - flat_from) * width * 4
        if pos + count > len(data):
            raise ValueError(f"{name}: Radiance HDR pixels are truncated")
        rgbe[flat_from:] = np.frombuffer(data, np.uint8, count, pos).reshape(-1, width, 4)
    return _rgbe_to_rgb(rgbe)
