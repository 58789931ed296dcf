"""PNM (P1-P6) and PAM (P7) images as ``cv2.imdecode(buf, IMREAD_COLOR)``
gives them: OpenCV's PxM and PAM decoders followed by ``imdecode``'s
conversion to three 8-bit channels, quirks included.

PxM (P1-P6):

* numbers are read as OpenCV's ``ReadNumber`` reads them: spaces and ``#``
  comments (to a line break) skipped, anything else refused, and the byte
  after each number taken as its terminator, whatever it is (a binary
  raster starts right after the maxval's);
* ASCII samples (P1 one digit each, with no terminator; P2 / P3 numbers,
  the last of which needs a byte after it too) are clamped to the maxval and, up to a maxval of 255,
  scaled by ``v * 255 // maxval``; binary 8-bit samples are taken as they
  are, whatever the maxval;
* samples of a maxval above 255 keep their high byte (``v >> 8``);
* bitmaps (P1, P4) give black for 1 and white for 0.

PAM (P7):

* the header is ``WIDTH``, ``HEIGHT``, ``DEPTH``, ``MAXVAL``, an optional
  ``TUPLTYPE`` and ``ENDHDR`` lines, in any order, with ``#`` comments; a
  tuple type must fit the depth, and without one depth 1 and 3 (maxval up
  to 255) are grey and RGB;
* a maxval of 1 reads each row's bytes as packed bits, most significant
  first, 1 white, whatever the tuple type and depth;
* three channels are copied as they are into OpenCV's BGR image, so the
  RGB that comes out has R and B swapped; one channel is grey.

Where OpenCV's PAM decoder leaves pixels it never writes (two and four
channels, which it converts only partly, and 16-bit grey), its result is
whatever memory held; here alpha is dropped, a grey-alpha pixel gives its
grey and an RGB-alpha pixel its RGB.
"""

from __future__ import annotations

import re

import numpy as np

_SEPARATOR = rb"(?:\s|#[^\n\r]*[\n\r])*"
_NUMBER = re.compile(_SEPARATOR + rb"(\d+)")
_SAMPLE = re.compile(_SEPARATOR + rb"(\d+)\D")  # a number and the byte that ends it, any byte
_DIGIT = re.compile(_SEPARATOR + rb"(\d)")
_INT_MAX = (1 << 31) - 1


def _read_number(data: bytes, pos: int, name: str):
    """(value, position after its terminator) of ``ReadNumber``."""
    m = _NUMBER.match(data, pos)
    if m is None:
        raise ValueError(f"{name}: PNM header holds no number at byte {pos}")
    if m.end() >= len(data):
        raise ValueError(f"{name}: PNM is truncated after byte {m.end()}")
    value = int(m.group(1))
    if value > _INT_MAX:
        raise ValueError(f"{name}: PNM number {value} is too large")
    return value, m.end() + 1


def _ascii_samples(data: bytes, pos: int, count: int, bitmap: bool, name: str) -> np.ndarray:
    pattern = _DIGIT if bitmap else _SAMPLE
    if count > len(data) - pos:  # a byte at least per sample: refuse before allocating
        raise ValueError(f"{name}: PNM holds fewer bytes than its {count} samples")
    out = np.empty(count, np.int64)
    k = 0
    for m in pattern.finditer(data, pos):
        if m.start() != pos or k == count:  # a byte that is no number, or all read
            break
        value = int(m.group(1))
        if value > _INT_MAX:
            raise ValueError(f"{name}: PNM sample {value} is too large")
        out[k] = value
        k += 1
        pos = m.end()
    if k < count:
        raise ValueError(f"{name}: PNM holds {k} of its {count} samples")
    return out


def _gray_or_rgb(samples: np.ndarray, height: int, width: int, channels: int) -> np.ndarray:
    image = samples.astype(np.uint8).reshape(height, width, channels)
    return np.repeat(image, 3, 2) if channels == 1 else image


def _binary(data: bytes, pos: int, height: int, width: int, channels: int, wide: bool,
            name: str) -> np.ndarray:
    count = height * width * channels
    size = count * (2 if wide else 1)
    if pos + size > len(data):
        raise ValueError(f"{name}: PNM raster is truncated")
    if wide:
        return np.frombuffer(data, ">u2", count, pos) >> 8
    return np.frombuffer(data, np.uint8, count, pos)


def _bits(data: bytes, pos: int, height: int, width: int, row_bytes: int, one: int,
          name: str) -> np.ndarray:
    """Rows of packed bits, most significant first: 1 -> ``one``."""
    if pos + height * row_bytes > len(data):
        raise ValueError(f"{name}: PNM raster is truncated")
    rows = np.frombuffer(data, np.uint8, height * row_bytes, pos).reshape(height, row_bytes)
    bits = np.unpackbits(rows, axis=1)[:, :width]
    value = np.where(bits == 1, one, 255 - one).astype(np.uint8)
    return np.repeat(value[..., None], 3, 2)


def decode_pxm(data: bytes, name: str) -> np.ndarray:
    """P1-P6 bytes -> (H, W, 3) uint8 RGB."""
    from viddet_tpu_torch.native import _check_size

    kind = data[1] - ord("0")
    bitmap, channels = kind in (1, 4), 3 if kind in (3, 6) else 1
    width, pos = _read_number(data, 2, name)
    height, pos = _read_number(data, pos, name)
    maxval = 1
    if not bitmap:
        maxval, pos = _read_number(data, pos, name)
    if width <= 0 or height <= 0 or not 0 < maxval < 1 << 16:
        raise ValueError(f"{name}: bad PNM header ({width}x{height}, maxval {maxval})")
    _check_size(name, width, height)
    if kind == 4:
        return _bits(data, pos, height, width, (width + 7) // 8, 0, name)
    if kind == 1:
        bits = _ascii_samples(data, pos, height * width, True, name) != 0
        return _gray_or_rgb(np.where(bits, 0, 255), height, width, 1)
    count = height * width * channels
    if kind in (2, 3):
        samples = np.minimum(_ascii_samples(data, pos, count, False, name), maxval)
        samples = samples >> 8 if maxval > 255 else samples * 255 // maxval
    else:
        samples = _binary(data, pos, height, width, channels, maxval > 255, name)
    return _gray_or_rgb(samples, height, width, channels)


_PAM_FIELDS = (b"ENDHDR", b"HEIGHT", b"WIDTH", b"DEPTH", b"MAXVAL", b"TUPLTYPE")
_TUPLE_DEPTHS = {b"BLACKANDWHITE": 1, b"GRAYSCALE": 1, b"GRAYSCALE_ALPHA": 2, b"RGB": 3,
                 b"RGB_ALPHA": 4}
_SPACE = b" \t\n\v\f\r"


def _pam_header(data: bytes, name: str):
    """({field: value}, raster offset) of a P7 header, read line by line as
    OpenCV's ``ReadPAMHeaderLine`` reads it."""
    if len(data) < 3 or data[2] not in b"\n\r":
        raise ValueError(f"{name}: PAM magic is not followed by a line break")
    pos, fields = 3, {}

    def byte(i: int) -> int:
        if i >= len(data):
            raise ValueError(f"{name}: PAM header is truncated")
        return data[i]

    while True:
        while byte(pos) in _SPACE:
            pos += 1
        if data[pos] == ord("#"):  # a comment, to the line break
            while byte(pos) not in b"\n\r":
                pos += 1
            pos += 1
            continue
        start = pos
        while byte(pos) not in _SPACE:
            pos += 1
        ident = data[start:pos]
        pos += 1  # the space after it
        if ident not in _PAM_FIELDS:
            raise ValueError(f"{name}: unknown PAM header field {ident[:16]!r}")
        if ident == b"ENDHDR":
            return fields, pos
        while byte(pos) in _SPACE:
            pos += 1
        start = pos
        while byte(pos) not in b"\n\r":
            pos += 1
        value = data[start:pos].rstrip(_SPACE)
        pos += 1
        if ident == b"TUPLTYPE":
            if value not in _TUPLE_DEPTHS:
                raise ValueError(f"{name}: unknown PAM tuple type {value[:24]!r}")
            fields[ident] = value
        elif ident in fields or not re.fullmatch(rb"[+-]?\d+", value):
            raise ValueError(f"{name}: bad PAM header field {ident.decode()} {value[:16]!r}")
        else:
            fields[ident] = int(value)


def decode_pam(data: bytes, name: str) -> np.ndarray:
    """P7 bytes -> (H, W, 3) uint8 RGB."""
    from viddet_tpu_torch.native import _check_size

    fields, pos = _pam_header(data, name)
    missing = [f.decode() for f in _PAM_FIELDS[1:5] if f not in fields]
    if missing:
        raise ValueError(f"{name}: PAM header lacks {', '.join(missing)}")
    width, height = fields[b"WIDTH"], fields[b"HEIGHT"]
    depth, maxval = fields[b"DEPTH"], fields[b"MAXVAL"]
    if width <= 0 or height <= 0 or not 1 <= depth <= 4 or not 0 < maxval < 1 << 16:
        raise ValueError(f"{name}: bad PAM header ({width}x{height}, depth {depth}, "
                         f"maxval {maxval})")
    tuple_type = fields.get(b"TUPLTYPE")
    if tuple_type is not None:
        if _TUPLE_DEPTHS[tuple_type] != depth:
            raise ValueError(f"{name}: PAM tuple type {tuple_type[:24]!r} with depth {depth}")
    elif depth not in (1, 3) or maxval > 255:
        raise ValueError(f"{name}: PAM of depth {depth}, maxval {maxval} names no tuple type")
    _check_size(name, width, height)
    if maxval == 1:
        return _bits(data, pos, height, width, width * depth, 255, name)
    samples = _binary(data, pos, height, width, depth, maxval > 255, name)
    image = samples.astype(np.uint8).reshape(height, width, depth)
    if depth == 3:
        return np.ascontiguousarray(image[..., ::-1])  # copied as they are into BGR
    if depth == 4:
        return np.ascontiguousarray(image[..., :3])
    return np.repeat(image[..., :1], 3, 2)


def decode_pnm(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """PNM or PAM bytes (``P1``-``P7``) -> (H, W, 3) uint8 RGB, as
    ``cv2.imdecode`` (IMREAD_COLOR) and a BGR-to-RGB swap give it.  Raises
    ValueError for a truncated or corrupt file."""
    if len(data) < 2 or data[0] != ord("P") or data[1] not in b"1234567":
        raise ValueError(f"{name}: not a PNM (P1-P7) image")
    return decode_pam(data, name) if data[1] == ord("7") else decode_pxm(data, name)
